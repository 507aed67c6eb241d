// One fractional shift along an axis and its VJP, hand-written for Hopper
// (sm_90a), bound to Python through a plain C interface.
//
// Replaces the Pallas TPU kernel of livae_tpu/ops/pallas/shear.py:
//   shear_{rows,cols}_fwd <- _shift_kernel (shear.py:38-72, launched by
//                            _fractional_shift_fwd_impl at :93)
//   shear_{rows,cols}_bwd <- the custom VJP's _bwd (shear.py:124-137), which
//                            launches _shift_kernel twice (-delta for dx,
//                            floor(delta) for d delta); here one fused launch
//                            gives both.
//
// What they compute. x is [B, H, W] (bf16 or f32). axis 2 shifts along W with one
// delta per row (delta [B, H]); axis 1 shifts along H with one delta per column
// (delta [B, W]). With n the length of the shifted axis, k = floor(d) and
// f = d - k:  out[i] = (1-f) x[(i+k) mod n] + f x[(i+k+1) mod n], in f32, cast
// once to the I/O type. The lerp rounds each product and the sum on its own
// (lerp.cuh), so the forward is bit-identical to the plain PyTorch version
// (livae_tpu_torch/ops/shear.py, fractional_shift_reference).
//
// The backward follows the JAX VJP formula, so that it can be bit-equal to
// fractional_shift_vjp_reference:
//   dx      = the shift of g by -delta (k' = floor(-d), f' = -d - k');
//   d delta = sum over the shifted axis of T(x[i+k+1] - x[i+k]) . g[i], with the
//             difference rounded to the I/O type T first, as JAX rounds g1 - g0
//             (both kernel outputs in x's dtype) before its f32 product.
// The sums run in a fixed order (per-lane serial sums, then a fixed shuffle tree
// for axis 2 or the row slots' partials in order for axis 1): no atomics, and
// the same result on every run. Only the order differs from torch's sum. The
// dx-free backward (a template flag; x needs no gradient) skips dx's lerp and
// store and gives d delta's bits.
//
// Bound on the H100 (3.35 TB/s): about 4 FLOP per element against 4 (bf16) or 8
// (f32) bytes of I/O, so every kernel is bound by memory. At B = 512, 256 x 256
// the forward reads x and writes out, 128 MiB in bf16 (about 40 us) and 256 MiB
// in f32 (80 us, the per-shear rotation's dtype); the backward reads x and g and
// writes dx, 192 / 384 MiB (60 / 120 us); the deltas add 0.5 MiB each.
//
// Design: one tile per block, staged in shared memory. A block copies its tile
// of x (and g) from device memory into shared memory with 16-byte cp.async
// copies, coalesced, all in flight at once, and gathers from there: the
// gather's cost does not depend on the shifts, and no access to device memory
// is scattered. The launch plan (ops/shear.py, launch_plan) sizes the tile; the
// entry points check it.
//
//   axis 2 (rows): a tile is R consecutive rows (b, y), one contiguous span of
//     R W elements (about 16 KB of x). One warp per row: lane c computes
//     columns c, c + 32, ..., so the warp's reads of the staged row fall in
//     consecutive banks whatever the shift (the wrap is an index mod W) and its
//     stores are one coalesced row segment. The backward's dx is the same
//     gather on g's row at -delta; d delta sums the same warp's products, then
//     a shuffle tree.
//   axis 1 (columns): a tile is a strip of w columns (64, 32, 16 or 8; the
//     strips of x and g within 64 KB) by all H rows of one sample, kept [H][w]
//     in shared memory.
//     Thread i is column c = i mod w of row slot i / w; a warp's lanes are
//     consecutive columns of one row, so their reads of rows (y + k_c) mod H
//     fall in distinct banks whatever the shifts (f32; in bf16 two columns may
//     share a bank), and each strip row is written back coalesced. d delta:
//     each thread sums its rows serially, then the row slots' partials are
//     added in order through shared memory.
//   16-byte copies only where the address is aligned: a span's head and tail
//   (axis 2), or a strip whose rows do not start on 16 bytes (axis 1), take
//   scalar loads.
// Tried on the card and slower (PERF.md, section 6): 16-byte chunks of outputs per
// thread with 16-byte stores (the chunk's reads conflict four ways in shared
// memory), and a persistent grid walking the tiles with two buffers, so that
// the next tile's copy overlaps this tile's work (the blocks resident on an SM
// already overlap it).
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, [512, 256, 256],
// shifts of real rotations; axis 2 / axis 1): f32 forward 0.097 / 0.100 ms (83 /
// 80 % of the bound), backward 0.143 / 0.153 ms (84 / 79 %); bf16 forward 0.062 /
// 0.067 ms (65 / 60 %), backward 0.095 / 0.115 ms (64 / 53 %). Random shifts take
// the same time within 6 %. A copy_ of the f32 forward's 256 MiB takes 0.094 ms.
//
// The direct variants (the first design: one block per row for the forward, a warp
// per row or a thread per column for the backward, gathering in device memory)
// serve shapes whose tile does not fit 227 KB of shared memory: rows longer than
// about 29,000 f32 elements, or columns taller than about 3,600 f32 rows (the
// backward, x and g strips of 8 columns). Offsets are 64-bit; the only limit is
// B * H (and B * W) below 2^31.

#include <cstdint>

#include "lerp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr size_t kSmemMax = 232448;  // shared memory one block may use on sm_90

// f32 value of T(a - b): the difference rounded to the I/O type first.
__device__ __forceinline__ float diff_io(float a, float b, const float*) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float diff_io(float a, float b, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(__fsub_rn(a, b)));
}

// ---------------------------------------------------------------------------
// Staging: cp.async copies of 16 bytes that the thread does not wait for, then
// one wait for all of them before the block reads the tile.

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// The block's copies have landed and every thread sees them.
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// p's distance past a 16-byte boundary, in elements.
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) % 16 / sizeof(T));
}

// Stage n contiguous elements of src into dst[off + e], off = misalign(src), so
// that the 16-byte-aligned body goes by cp.async and lands aligned; the head and
// tail (fewer than 16 bytes each) take scalar loads.
template <typename T>
__device__ void stage_span(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  const int off = misalign(src);
  const int head = min(n, (V - off) % V);
  const int body = (n - head) / V;
  const int edge = n - body * V;  // head + tail
  for (int i = threadIdx.x; i < body; i += kThreads) {
    cp_async16(dst + off + head + i * V, src + head + i * V);
  }
  for (int i = threadIdx.x; i < edge; i += kThreads) {
    const int e = i < head ? i : i + body * V;
    dst[off + e] = src[e];
  }
}

// Stage a strip of H rows of `width` (<= w) elements, row y at src + y W, into
// dst[y w + c]: 16-byte cp.async pieces where every row start is aligned (w is
// a whole number of 16-byte pieces), scalar loads for the rest.
template <typename T>
__device__ void stage_strip(T* dst, const T* src, int H, int W, int w, int width) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = misalign(src) == 0 && W % V == 0;
  const int nv = vec ? width / V : 0;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < H * nv; i += kThreads) {
    const int y = i / nv;
    const int j = (i - y * nv) * V;
    cp_async16(dst + y * w + j, src + static_cast<long>(y) * W + j);
  }
  const int rest = width - nv * V;
  for (int i = threadIdx.x; i < H * rest; i += kThreads) {
    const int y = i / rest;
    const int j = nv * V + i - y * rest;
    dst[y * w + j] = src[static_cast<long>(y) * W + j];
  }
}

// ---------------------------------------------------------------------------
// Axis 2: block t stages rows [t R, min(rows, (t + 1) R)) of the flattened
// [B H, W] array; x's span, then (backward) g's at `stride` elements.

// A staged row s shifted by d into o: lane c takes columns c, c + 32, ...
template <typename T>
__device__ __forceinline__ void shift_row(const T* s, float d, int W, T* o, int lane) {
  int k;
  float f;
  split_shift(d, W, &k, &f);
  for (int c = lane; c < W; c += 32) {
    const int i0 = wrap_up(c + k, W);
    const int i1 = wrap_up(i0 + 1, W);
    store_f(o, c, lerp_rn(load_f(s, i0), load_f(s, i1), f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    shear_rows_fwd(const T* __restrict__ x, const float* __restrict__ delta, T* __restrict__ out,
                   int rows, int W, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s = reinterpret_cast<T*>(smem);
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, rows - row0);
  const long e0 = static_cast<long>(row0) * W;
  stage_span(s, x + e0, nrows * W);
  staged();
  s += misalign(x + e0);
  for (int r = threadIdx.x >> 5; r < nrows; r += kWarps) {
    shift_row(s + r * W, delta[row0 + r], W, out + e0 + static_cast<long>(r) * W,
              threadIdx.x & 31);
  }
}

template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads)
    shear_rows_bwd(const T* __restrict__ x, const float* __restrict__ delta,
                   const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ ddelta,
                   int rows, int W, int R, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, rows - row0);
  const long e0 = static_cast<long>(row0) * W;
  T* sx = reinterpret_cast<T*>(smem);
  T* sg = sx + stride;
  stage_span(sx, x + e0, nrows * W);
  stage_span(sg, g + e0, nrows * W);
  staged();
  sx += misalign(x + e0);
  sg += misalign(g + e0);
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nrows; r += kWarps) {
    const float d = delta[row0 + r];
    const T* xr = sx + r * W;
    const T* gr = sg + r * W;
    if (kDx) shift_row(gr, -d, W, dx + e0 + static_cast<long>(r) * W, lane);
    int k;
    float f;
    split_shift(d, W, &k, &f);
    float acc = 0.0f;
    for (int c = lane; c < W; c += 32) {
      const int i0 = wrap_up(c + k, W);
      const int i1 = wrap_up(i0 + 1, W);
      acc += diff_io(load_f(xr, i1), load_f(xr, i0), x) * load_f(gr, c);
    }
    acc = warp_sum(acc);
    if (lane == 0) ddelta[row0 + r] = acc;
  }
}

// ---------------------------------------------------------------------------
// Axis 1: block t stages sample t / S, columns [c0, c0 + width) with c0 =
// (t mod S) w, S = ceil(W / w); x's strip, then (backward) g's at `stride`
// elements. Thread i is column c = i mod w of row slot i / w; the row slots
// take rows slot, slot + kThreads / w, ...

struct Strip {
  long base;  // offset of element (b, 0, c0)
  long col;   // index of (b, c0) in delta
  int width;
};

__device__ __forceinline__ Strip strip_of(int H, int W, int w) {
  const int S = (W + w - 1) / w;
  const int b = blockIdx.x / S;
  const int c0 = (blockIdx.x - b * S) * w;
  return {static_cast<long>(b) * H * W + c0, static_cast<long>(b) * W + c0, min(w, W - c0)};
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    shear_cols_fwd(const T* __restrict__ x, const float* __restrict__ delta, T* __restrict__ out,
                   int H, int W, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const T* s = reinterpret_cast<const T*>(smem);
  const Strip st = strip_of(H, W, w);
  stage_strip(reinterpret_cast<T*>(smem), x + st.base, H, W, w, st.width);
  staged();
  const int c = threadIdx.x % w;
  if (c >= st.width) return;
  int k;
  float f;
  split_shift(delta[st.col + c], H, &k, &f);
  T* o = out + st.base + c;
#pragma unroll 4
  for (int y = threadIdx.x / w; y < H; y += kThreads / w) {
    const int i0 = wrap_up(y + k, H);
    const int i1 = wrap_up(i0 + 1, H);
    store_f(o, static_cast<long>(y) * W,
            lerp_rn(load_f(s, i0 * w + c), load_f(s, i1 * w + c), f));
  }
}

// The row slots' d delta partials follow g's strip.
template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads)
    shear_cols_bwd(const T* __restrict__ x, const float* __restrict__ delta,
                   const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ ddelta,
                   int H, int W, int w, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sx = reinterpret_cast<T*>(smem);
  T* sg = sx + stride;
  float* part = reinterpret_cast<float*>(sg + stride);
  const Strip st = strip_of(H, W, w);
  stage_strip(sx, x + st.base, H, W, w, st.width);
  stage_strip(sg, g + st.base, H, W, w, st.width);
  staged();
  const int c = threadIdx.x % w;
  float acc = 0.0f;
  if (c < st.width) {
    const float d = delta[st.col + c];
    int k, kn;
    float f, fn;
    split_shift(d, H, &k, &f);
    split_shift(-d, H, &kn, &fn);
    T* o = dx + st.base + c;
#pragma unroll 2
    for (int y = threadIdx.x / w; y < H; y += kThreads / w) {
      const int i0 = wrap_up(y + k, H);
      const int i1 = wrap_up(i0 + 1, H);
      acc += diff_io(load_f(sx, i1 * w + c), load_f(sx, i0 * w + c), x) * load_f(sg, y * w + c);
      if (kDx) {
        const int j0 = wrap_up(y + kn, H);
        const int j1 = wrap_up(j0 + 1, H);
        store_f(o, static_cast<long>(y) * W,
                lerp_rn(load_f(sg, j0 * w + c), load_f(sg, j1 * w + c), fn));
      }
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < st.width) {  // thread i = slot w + c, so here c = i
    float sum = 0.0f;
    for (int p = 0; p < kThreads / w; ++p) sum += part[p * w + threadIdx.x];
    ddelta[st.col + threadIdx.x] = sum;
  }
}

// ---------------------------------------------------------------------------
// The direct variants, for tiles that do not fit shared memory: gathers in
// device memory.

// One block per row (b, y); its threads stride along the row.
template <typename T, int kAxis>
__global__ void __launch_bounds__(kThreads)
    shear_direct_fwd(const T* __restrict__ x, const float* __restrict__ delta,
                     T* __restrict__ out, int H, int W) {
  const unsigned bh = blockIdx.x;  // b * H + y
  const unsigned b = bh / H;
  const int y = static_cast<int>(bh - b * H);
  const T* xs = x + static_cast<long>(b) * H * W;
  T* os = out + static_cast<long>(bh) * W;
  if (kAxis == 2) {
    int k;
    float f;
    split_shift(delta[bh], W, &k, &f);
    const long row = static_cast<long>(y) * W;
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      const int i0 = wrap_up(c + k, W);
      const int i1 = wrap_up(i0 + 1, W);
      store_f(os, c, lerp_rn(load_f(xs, row + i0), load_f(xs, row + i1), f));
    }
  } else {
    const float* ds = delta + static_cast<long>(b) * W;
    for (int c = threadIdx.x; c < W; c += blockDim.x) {
      int k;
      float f;
      split_shift(ds[c], H, &k, &f);
      const int r0 = wrap_up(y + k, H);
      const int r1 = wrap_up(r0 + 1, H);
      store_f(os, c, lerp_rn(load_f(xs, static_cast<long>(r0) * W + c),
                             load_f(xs, static_cast<long>(r1) * W + c), f));
    }
  }
}

// axis 2: one warp per row (b, y); delta and ddelta are [B * H].
template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads)
    shear_direct_bwd_rows(const T* __restrict__ x, const float* __restrict__ delta,
                          const T* __restrict__ g, T* __restrict__ dx,
                          float* __restrict__ ddelta, int W, long rows) {
  const long row = (static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  int k, kn;
  float f, fn;
  split_shift(delta[row], W, &k, &f);
  split_shift(-delta[row], W, &kn, &fn);
  const long base = row * W;
  float acc = 0.0f;
  for (int c = lane; c < W; c += 32) {
    const int i0 = wrap_up(c + k, W);
    const int i1 = wrap_up(i0 + 1, W);
    acc += diff_io(load_f(x, base + i1), load_f(x, base + i0), x) * load_f(g, base + c);
    if (kDx) {
      const int j0 = wrap_up(c + kn, W);
      const int j1 = wrap_up(j0 + 1, W);
      store_f(dx, base + c, lerp_rn(load_f(g, base + j0), load_f(g, base + j1), fn));
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) ddelta[row] = acc;
}

// axis 1: one thread per column (b, c); delta and ddelta are [B * W].
template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads)
    shear_direct_bwd_cols(const T* __restrict__ x, const float* __restrict__ delta,
                          const T* __restrict__ g, T* __restrict__ dx,
                          float* __restrict__ ddelta, int H, int W, long cols) {
  const long col = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= cols) return;
  const long b = col / W;
  const long off = b * H * W + (col - b * W);  // element (b, 0, c)
  int k, kn;
  float f, fn;
  split_shift(delta[col], H, &k, &f);
  split_shift(-delta[col], H, &kn, &fn);
  float acc = 0.0f;
  for (int y = 0; y < H; ++y) {
    const int r0 = wrap_up(y + k, H);
    const int r1 = wrap_up(r0 + 1, H);
    const long at = off + static_cast<long>(y) * W;
    acc += diff_io(load_f(x, off + static_cast<long>(r1) * W),
                   load_f(x, off + static_cast<long>(r0) * W), x) *
           load_f(g, at);
    if (kDx) {
      const int j0 = wrap_up(y + kn, H);
      const int j1 = wrap_up(j0 + 1, H);
      store_f(dx, at,
              lerp_rn(load_f(g, off + static_cast<long>(j0) * W),
                      load_f(g, off + static_cast<long>(j1) * W), fn));
    }
  }
  ddelta[col] = acc;
}

// ---------------------------------------------------------------------------
// Host side: the plan check and the launches.

bool valid(int B, int H, int W, int axis) {
  const long limit = 2147483647L;  // rows, columns and blocks are counted in int
  return B >= 1 && H >= 1 && W >= 1 && (axis == 1 || axis == 2) &&
         static_cast<long>(B) * H <= limit && static_cast<long>(B) * W <= limit;
}

// Bytes of one staged tile of one tensor (ops/shear.py, _tile_bytes): axis 2 a
// span of `tile` rows plus its 16-byte misalignment, axis 1 a strip [H][tile];
// rounded up to 16 bytes.
size_t tile_bytes(int axis, int H, int W, int tile, size_t elem) {
  const size_t n = axis == 2 ? (static_cast<size_t>(tile) * W + 16 / elem) * elem
                             : static_cast<size_t>(H) * tile * elem;
  return (n + 15) / 16 * 16;
}

// The shared memory of a plan (ops/shear.py, _smem): x's tile (and g's), and for
// the axis-1 backward the row slots' partials.
size_t plan_smem(int axis, int backward, int H, int W, int tile, size_t elem) {
  return (backward ? 2 : 1) * tile_bytes(axis, H, W, tile, elem) +
         (axis == 1 && backward ? 4 * kThreads : 0);
}

// tile == 0 is the direct variant (no shared memory); otherwise a tile of `tile`
// rows (axis 2) or a strip of `tile` columns, a power of two from 8 to kThreads
// (axis 1), with exactly the shared memory the layout needs.
bool plan_ok(int B, int H, int W, int axis, int backward, int tile, long smem, size_t elem) {
  if (!valid(B, H, W, axis) || smem < 0) return false;
  if (tile == 0) return smem == 0;
  if (axis == 1 ? (tile < 8 || tile > kThreads || (tile & (tile - 1)) != 0)
                : (tile < 1 || tile > B * H))
    return false;
  const size_t want = plan_smem(axis, backward, H, W, tile, elem);
  return static_cast<size_t>(smem) == want && want <= kSmemMax;
}

// One block per tile, with `smem` bytes of dynamic shared memory (above 48 KB a
// kernel must first be allowed that much).
template <typename Kernel, typename... Args>
int launch_tiled(Kernel kernel, long ntiles, size_t smem, cudaStream_t s, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(ntiles), kThreads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, kThreads, smem);
  return static_cast<int>(err);
}

unsigned blocks_for(long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

// Elements from x's staged tile to g's.
int stride_of(int axis, int H, int W, int tile, size_t elem) {
  return static_cast<int>(tile_bytes(axis, H, W, tile, elem) / elem);
}

long tiles_of(int axis, int B, int H, int W, int tile) {
  return axis == 2 ? (static_cast<long>(B) * H + tile - 1) / tile
                   : static_cast<long>(B) * ((W + tile - 1) / tile);
}

template <typename T>
int fwd_typed(const void* x, const float* d, void* out, int B, int H, int W, int axis, int tile,
              size_t smem, cudaStream_t s) {
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  const int rows = B * H;
  if (tile == 0) {
    const int threads = 32 * (W >= kThreads ? kWarps : (W + 31) / 32);  // whole warps
    if (axis == 2) {
      shear_direct_fwd<T, 2><<<static_cast<unsigned>(rows), threads, 0, s>>>(xi, d, o, H, W);
    } else {
      shear_direct_fwd<T, 1><<<static_cast<unsigned>(rows), threads, 0, s>>>(xi, d, o, H, W);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const long n = tiles_of(axis, B, H, W, tile);
  return axis == 2 ? launch_tiled(shear_rows_fwd<T>, n, smem, s, xi, d, o, rows, W, tile)
                   : launch_tiled(shear_cols_fwd<T>, n, smem, s, xi, d, o, H, W, tile);
}

template <typename T, bool kDx>
int bwd_typed(const void* x, const float* d, const void* g, void* dx, float* dd, int B, int H,
              int W, int axis, int tile, size_t smem, cudaStream_t s) {
  const T* xi = static_cast<const T*>(x);
  const T* gi = static_cast<const T*>(g);
  T* dxo = static_cast<T*>(dx);
  const int rows = B * H;
  if (tile == 0) {
    if (axis == 2) {
      shear_direct_bwd_rows<T, kDx><<<blocks_for(static_cast<long>(rows) * 32), kThreads, 0, s>>>(
          xi, d, gi, dxo, dd, W, rows);
    } else {
      const long cols = static_cast<long>(B) * W;
      shear_direct_bwd_cols<T, kDx><<<blocks_for(cols), kThreads, 0, s>>>(xi, d, gi, dxo, dd, H,
                                                                          W, cols);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const long n = tiles_of(axis, B, H, W, tile);
  const int stride = stride_of(axis, H, W, tile, sizeof(T));
  return axis == 2 ? launch_tiled(shear_rows_bwd<T, kDx>, n, smem, s, xi, d, gi, dxo, dd, rows, W,
                                  tile, stride)
                   : launch_tiled(shear_cols_bwd<T, kDx>, n, smem, s, xi, d, gi, dxo, dd, H, W,
                                  tile, stride);
}

template <typename T>
int occupancy_typed(int axis, int backward, size_t smem, int* out) {
  if (axis == 2) {
    return backward ? blocks_per_sm(shear_rows_bwd<T, true>, smem, out)
                    : blocks_per_sm(shear_rows_fwd<T>, smem, out);
  }
  return backward ? blocks_per_sm(shear_cols_bwd<T, true>, smem, out)
                  : blocks_per_sm(shear_cols_fwd<T>, smem, out);
}

}  // namespace

extern "C" {

// out = the shift of x [B, H, W] by delta along `axis`, by the plan (tile, smem)
// of ops/shear.py's launch_plan. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan the kernels cannot take.
int livae_shear_fwd(const void* x, const void* delta, void* out, int B, int H, int W, int axis,
                    int is_bf16, int tile, long smem, void* stream) {
  const size_t elem = is_bf16 ? 2 : 4;
  if (!plan_ok(B, H, W, axis, 0, tile, smem, elem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(delta);
  const size_t z = static_cast<size_t>(smem);
  return is_bf16 ? fwd_typed<__nv_bfloat16>(x, d, out, B, H, W, axis, tile, z, s)
                 : fwd_typed<float>(x, d, out, B, H, W, axis, tile, z, s);
}

// dx (like x) and ddelta (f32, like delta) for the cotangent g (like x), by the
// plan as livae_shear_fwd. dx may be null: the dx-free variant then runs, with
// the same ddelta bit for bit.
int livae_shear_bwd(const void* x, const void* delta, const void* g, void* dx, void* ddelta,
                    int B, int H, int W, int axis, int is_bf16, int tile, long smem,
                    void* stream) {
  const size_t elem = is_bf16 ? 2 : 4;
  if (!plan_ok(B, H, W, axis, 1, tile, smem, elem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(delta);
  float* dd = static_cast<float*>(ddelta);
  const size_t z = static_cast<size_t>(smem);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return dx ? bwd_typed<T, true>(x, d, g, dx, dd, B, H, W, axis, tile, z, s)
              : bwd_typed<T, false>(x, d, g, dx, dd, B, H, W, axis, tile, z, s);
  }
  return dx ? bwd_typed<float, true>(x, d, g, dx, dd, B, H, W, axis, tile, z, s)
            : bwd_typed<float, false>(x, d, g, dx, dd, B, H, W, axis, tile, z, s);
}

// How many blocks of the tiled kernel (`backward` 0: forward, 1: backward with
// dx) with `smem` bytes of shared memory fit on one SM, into *out. Returns the
// CUDA error.
int livae_shear_blocks_per_sm(int axis, int backward, int is_bf16, long smem, int* out) {
  if (smem < 0 || (axis != 1 && axis != 2)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t z = static_cast<size_t>(smem);
  return is_bf16 ? occupancy_typed<__nv_bfloat16>(axis, backward, z, out)
                 : occupancy_typed<float>(axis, backward, z, out);
}

}  // extern "C"
