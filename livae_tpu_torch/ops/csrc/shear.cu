// One fractional shift along an axis and its VJP, hand-written for Hopper
// (sm_90a), bound to Python through a plain C interface.
//
// Replaces the Pallas TPU kernel of livae_tpu/ops/pallas/shear.py:
//   shear_fwd_kernel <- _shift_kernel (shear.py:38-72, launched by
//                       _fractional_shift_fwd_impl at :93)
//   shear_bwd_*      <- the custom VJP's _bwd (shear.py:124-137), which launches
//                       _shift_kernel twice (-delta for dx, floor(delta) for
//                       d delta); here one fused launch gives both.
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
// The sums run in a fixed order (per-lane serial sums and a fixed shuffle tree
// for axis 2, one serial loop per column for axis 1): no atomics, and the same
// result on every run. Only the order differs from torch's sum.
//
// Bound on the H100 (3.35 TB/s): about 4 FLOP per element against 4 (bf16) or 8
// (f32) bytes of I/O, so both kernels are bound by memory. At B = 512, 256 x 256,
// bf16, the forward must read x and write out, 128 MiB (about 40 us); the
// backward reads x and g and writes dx, 192 MiB (about 60 us); the deltas add
// 0.5 MiB each.
//
// Design, simple first. The forward runs one thread per output element, one
// block per row (b, y), W fastest: for axis 2 neighbouring threads read
// neighbouring addresses except at the wrap-around; for axis 1 each column has
// its own row offset, and the smooth deltas of a rotation keep the reads of a
// warp near-coalesced. A block of up to 256 threads strides along its row, so
// no thread divides a 64-bit index. The backward runs one warp per row for
// axis 2 (the lanes stride along the row and reduce with shuffles) and one
// thread per column for axis 1 (a thread walks its column; neighbouring
// threads are neighbouring columns, so each step of the loop is one coalesced
// row access). Every element of dx is written by the
// thread that reads its g, so dx and d delta come from one pass. Offsets are
// 64-bit; the only limit is B * H (and B * W) below 2^31, the grid's size.

#include "lerp.cuh"

namespace {

constexpr int kThreads = 256;

// f32 value of T(a - b): the difference rounded to the I/O type first.
__device__ __forceinline__ float diff_io(float a, float b, const float*) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float diff_io(float a, float b, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(__fsub_rn(a, b)));
}

// One block per row (b, y); its threads stride along the row.
template <typename T, int kAxis>
__global__ void __launch_bounds__(kThreads)
    shear_fwd_kernel(const T* __restrict__ x, const float* __restrict__ delta,
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
    shear_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ delta,
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
    const int j0 = wrap_up(c + kn, W);
    const int j1 = wrap_up(j0 + 1, W);
    store_f(dx, base + c, lerp_rn(load_f(g, base + j0), load_f(g, base + j1), fn));
  }
  acc = warp_sum(acc);
  if (lane == 0) ddelta[row] = acc;
}

// axis 1: one thread per column (b, c); delta and ddelta are [B * W].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    shear_bwd_cols_kernel(const T* __restrict__ x, const float* __restrict__ delta,
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
    const int j0 = wrap_up(y + kn, H);
    const int j1 = wrap_up(j0 + 1, H);
    store_f(dx, at,
            lerp_rn(load_f(g, off + static_cast<long>(j0) * W),
                    load_f(g, off + static_cast<long>(j1) * W), fn));
  }
  ddelta[col] = acc;
}

bool valid(int B, int H, int W, int axis) {
  const long limit = 2147483647L;  // blocks of a 1-D grid, and rows or columns
  return B >= 1 && H >= 1 && W >= 1 && (axis == 1 || axis == 2) &&
         static_cast<long>(B) * H <= limit && static_cast<long>(B) * W <= limit;
}

unsigned blocks_for(long threads) {
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <typename T>
void launch_fwd(const void* x, const float* delta, void* out, int B, int H, int W, int axis,
                cudaStream_t s) {
  const unsigned rows = static_cast<unsigned>(B) * H;
  const int threads = 32 * (W >= kThreads ? kThreads / 32 : (W + 31) / 32);  // whole warps
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (axis == 2) {
    shear_fwd_kernel<T, 2><<<rows, threads, 0, s>>>(xi, delta, o, H, W);
  } else {
    shear_fwd_kernel<T, 1><<<rows, threads, 0, s>>>(xi, delta, o, H, W);
  }
}

template <typename T>
void launch_bwd(const void* x, const float* delta, const void* g, void* dx, float* ddelta,
                int B, int H, int W, int axis, cudaStream_t s) {
  const T* xi = static_cast<const T*>(x);
  const T* gi = static_cast<const T*>(g);
  T* dxo = static_cast<T*>(dx);
  if (axis == 2) {
    const long rows = static_cast<long>(B) * H;
    shear_bwd_rows_kernel<T><<<blocks_for(rows * 32), kThreads, 0, s>>>(xi, delta, gi, dxo,
                                                                        ddelta, W, rows);
  } else {
    const long cols = static_cast<long>(B) * W;
    shear_bwd_cols_kernel<T><<<blocks_for(cols), kThreads, 0, s>>>(xi, delta, gi, dxo, ddelta,
                                                                   H, W, cols);
  }
}

}  // namespace

extern "C" {

// out = the shift of x [B, H, W] by delta along `axis`. Returns cudaGetLastError().
int livae_shear_fwd(const void* x, const void* delta, void* out, int B, int H, int W, int axis,
                    int is_bf16, void* stream) {
  if (!valid(B, H, W, axis)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(delta);
  if (is_bf16) {
    launch_fwd<__nv_bfloat16>(x, d, out, B, H, W, axis, s);
  } else {
    launch_fwd<float>(x, d, out, B, H, W, axis, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx (like x) and ddelta (f32, like delta) for the cotangent g (like x).
// Returns cudaGetLastError().
int livae_shear_bwd(const void* x, const void* delta, const void* g, void* dx, void* ddelta,
                    int B, int H, int W, int axis, int is_bf16, void* stream) {
  if (!valid(B, H, W, axis)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(delta);
  float* dd = static_cast<float*>(ddelta);
  if (is_bf16) {
    launch_bwd<__nv_bfloat16>(x, d, g, dx, dd, B, H, W, axis, s);
  } else {
    launch_bwd<float>(x, d, g, dx, dd, B, H, W, axis, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
