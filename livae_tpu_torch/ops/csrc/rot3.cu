// Fused 3-shear rotation y = Sx(d_row) . Sy(d_col) . Sx(d_row) . x and its VJP,
// hand-written for Hopper (sm_90a), bound to Python through a plain C interface.
//
// Replaces the Pallas TPU kernels of livae_tpu/ops/pallas/rot3.py:
//   rot3_fwd_kernel <- _rot3_fwd_kernel (rot3.py:88-95, launched by _rot3_fwd_impl at :194)
//   rot3_bwd_kernel <- _rot3_bwd_kernel (rot3.py:98-141, launched by _rot3_bwd_impl at :221)
//
// What they compute. x is [B, P, P] (bf16 or f32), d_row and d_col are [B, P] f32.
// Each S is a mod-P lerp shift out[i] = (1-f) in[(i+k) mod P] + f in[(i+k+1) mod P]
// with k = floor(d), f = d - k, and d constant along the shifted axis: Sx shifts
// along W with one d_row per row, Sy along H with one d_col per column. All three
// stages stay in f32; the output is cast once to the I/O type. Every lerp rounds
// each product and the sum on its own (no FMA contraction, lerp.cuh), so the
// forward and dx are bit-identical to the plain PyTorch version (livae_tpu_torch/ops/rot3.py,
// rot3_reference) and to torch autograd through it.
//
// The backward recomputes a = Sx(x) and b = Sy(a), then runs the three adjoint
// shifts in reverse order. The adjoint of a lerp shift by d, written with the
// forward's own k and f, is in[j] = (1-f) g[(j-k) mod P] + f g[(j-k-1) mod P]
// (the lerp shift by -d). The delta cotangents use the direct formula
//   dd = sum over the shifted axis of g_out . (in[i+k+1] - in[i+k]),
// which holds at f == 0 too: ddr sums stages 1 and 3 along W, ddc sums stage 2
// along H. Each sample's reductions run inside the block that owns it, in a fixed
// order (per-lane serial sums, then a fixed shuffle tree): no atomics, and the
// result does not change from run to run.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores): about
// 4 FLOP per element per stage against 2-4 bytes of I/O per element, so both
// kernels are bound by memory. At B=512, P=256, bf16 I/O the forward must move
// 64 MiB in and 64 MiB out (about 40 us); the backward reads x and g and writes
// dx, about 192 MiB (about 60 us).
//
// Design, simple first: one block per sample. A 256^2 f32 canvas is 256 KiB,
// more than the 227 KB of shared memory a block can use, and stage 2 reads whole
// columns of stage 1's output, so stage 1 (and in the backward each full-canvas
// intermediate) goes to a per-sample f32 scratch canvas in device memory that the
// wrapper allocates; the block synchronises between the stages. Row-local stages
// run one warp per row with the row in shared memory, so the forward writes one
// scratch canvas, not two. Each shift is a direct indexed read: the TPU's
// butterfly of rolls is not needed here. The scratch traffic (one f32 canvas
// written and read in the forward, three in the backward) is what keeps these
// kernels above their bound; shared-memory tiling, a 2-CTA cluster or a smaller
// canvas are the next steps.

#include "lerp.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 768;  // keeps the dynamic shared memory under 48 KB

// k = floor(d) mod P and f = d - floor(d) for the sample's rows and columns.
__device__ void load_shifts(const float* d_row, const float* d_col, int P, int* kr,
                            float* fr, int* kc, float* fc) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    split_shift(d_row[i], P, kr + i, fr + i);
    split_shift(d_col[i], P, kc + i, fc + i);
  }
}

// a = Sx(d_row) x, one warp per row.
template <typename T>
__device__ void shift_rows(const T* xs, float* a, const int* kr, const float* fr, int P) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int y = warp; y < P; y += kWarps) {
    const long base = static_cast<long>(y) * P;
    const int k = kr[y];
    const float f = fr[y];
    for (int c = lane; c < P; c += 32) {
      const int i0 = wrap_up(c + k, P);
      const int i1 = wrap_up(i0 + 1, P);
      a[base + c] = lerp_rn(load_f(xs, base + i0), load_f(xs, base + i1), f);
    }
  }
}

// row[c] = (Sy(d_col) a)[y, c] for one row y, computed by one warp.
__device__ __forceinline__ void column_shift_row(const float* a, float* row, const int* kc,
                                                 const float* fc, int y, int P, int lane) {
  for (int c = lane; c < P; c += 32) {
    const int r0 = wrap_up(y + kc[c], P);
    const int r1 = wrap_up(r0 + 1, P);
    row[c] = lerp_rn(a[static_cast<long>(r0) * P + c], a[static_cast<long>(r1) * P + c], fc[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rot3_fwd_kernel(const T* __restrict__ x, const float* __restrict__ d_row,
                    const float* __restrict__ d_col, T* __restrict__ out, float* scratch, int P) {
  extern __shared__ float smem[];
  int* kr = reinterpret_cast<int*>(smem);
  float* fr = smem + P;
  int* kc = reinterpret_cast<int*>(smem + 2 * P);
  float* fc = smem + 3 * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* row = smem + (4 + warp) * P;

  const long b = blockIdx.x;
  const long PP = static_cast<long>(P) * P;
  const T* xs = x + b * PP;
  T* os = out + b * PP;
  float* a = scratch + b * PP;

  load_shifts(d_row + b * P, d_col + b * P, P, kr, fr, kc, fc);
  __syncthreads();
  shift_rows(xs, a, kr, fr, P);  // stage 1
  __syncthreads();

  // stages 2 and 3: the warp builds row y of b = Sy(a) in shared memory, then
  // shifts it along W into the output
  for (int y = warp; y < P; y += kWarps) {
    column_shift_row(a, row, kc, fc, y, P, lane);
    __syncwarp();
    const long base = static_cast<long>(y) * P;
    const int k = kr[y];
    const float f = fr[y];
    for (int c = lane; c < P; c += 32) {
      const int i0 = wrap_up(c + k, P);
      const int i1 = wrap_up(i0 + 1, P);
      store_f(os, base + c, lerp_rn(row[i0], row[i1], f));
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rot3_bwd_kernel(const T* __restrict__ x, const float* __restrict__ d_row,
                    const float* __restrict__ d_col, const T* __restrict__ g,
                    T* __restrict__ dx, float* __restrict__ ddr, float* __restrict__ ddc,
                    float* scratch, int P) {
  extern __shared__ float smem[];
  int* kr = reinterpret_cast<int*>(smem);
  float* fr = smem + P;
  int* kc = reinterpret_cast<int*>(smem + 2 * P);
  float* fc = smem + 3 * P;
  float* ddr3 = smem + 4 * P;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* row = smem + (5 + warp) * P;

  const long b = blockIdx.x;
  const long PP = static_cast<long>(P) * P;
  const T* xs = x + b * PP;
  const T* gs = g + b * PP;
  T* dxs = dx + b * PP;
  float* a = scratch + 3 * b * PP;  // a = Sx(x)
  float* gb = a + PP;               // cotangent of b = Sy(a)
  float* ga = gb + PP;              // cotangent of a

  load_shifts(d_row + b * P, d_col + b * P, P, kr, fr, kc, fc);
  __syncthreads();
  shift_rows(xs, a, kr, fr, P);
  __syncthreads();

  // stage 3 (y = Sx(b)): gb = adjoint shift of g; ddr3 = sum_c g (b[i1] - b[i0])
  for (int y = warp; y < P; y += kWarps) {
    column_shift_row(a, row, kc, fc, y, P, lane);  // row y of b
    __syncwarp();
    const long base = static_cast<long>(y) * P;
    const int k = kr[y];
    const float f = fr[y];
    float acc = 0.0f;
    for (int c = lane; c < P; c += 32) {
      const int i0 = wrap_up(c + k, P);
      const int i1 = wrap_up(i0 + 1, P);
      acc += load_f(gs, base + c) * (row[i1] - row[i0]);
      const int j0 = wrap_down(c - k, P);
      const int j1 = wrap_down(j0 - 1, P);
      gb[base + c] = lerp_rn(load_f(gs, base + j0), load_f(gs, base + j1), f);
    }
    acc = warp_sum(acc);
    if (lane == 0) ddr3[y] = acc;
    __syncwarp();
  }
  __syncthreads();

  // stage 2 (b = Sy(a)), one thread per column: ga = adjoint shift of gb along H;
  // ddc = sum_y gb (a[r1] - a[r0])
  for (int c = threadIdx.x; c < P; c += blockDim.x) {
    const int k = kc[c];
    const float f = fc[c];
    float acc = 0.0f;
    for (int y = 0; y < P; ++y) {
      const int r0 = wrap_up(y + k, P);
      const int r1 = wrap_up(r0 + 1, P);
      acc += gb[static_cast<long>(y) * P + c] *
             (a[static_cast<long>(r1) * P + c] - a[static_cast<long>(r0) * P + c]);
      const int j0 = wrap_down(y - k, P);
      const int j1 = wrap_down(j0 - 1, P);
      ga[static_cast<long>(y) * P + c] =
          lerp_rn(gb[static_cast<long>(j0) * P + c], gb[static_cast<long>(j1) * P + c], f);
    }
    ddc[b * P + c] = acc;
  }
  __syncthreads();

  // stage 1 (a = Sx(x)): dx = adjoint shift of ga; ddr = ddr3 + sum_c ga (x[i1] - x[i0])
  for (int y = warp; y < P; y += kWarps) {
    const long base = static_cast<long>(y) * P;
    const int k = kr[y];
    const float f = fr[y];
    float acc = 0.0f;
    for (int c = lane; c < P; c += 32) {
      const int i0 = wrap_up(c + k, P);
      const int i1 = wrap_up(i0 + 1, P);
      acc += ga[base + c] * (load_f(xs, base + i1) - load_f(xs, base + i0));
      const int j0 = wrap_down(c - k, P);
      const int j1 = wrap_down(j0 - 1, P);
      store_f(dxs, base + c, lerp_rn(ga[base + j0], ga[base + j1], f));
    }
    acc = warp_sum(acc);
    if (lane == 0) ddr[b * P + y] = ddr3[y] + acc;
  }
}

}  // namespace

extern "C" {

// Scratch: B * P * P floats. Returns cudaGetLastError() after the launch.
int livae_rot3_fwd(const void* x, const void* d_row, const void* d_col, void* out,
                   void* scratch, int B, int P, int is_bf16, void* stream) {
  if (B < 1 || P < 2 || P > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(4 + kWarps) * P * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dr = static_cast<const float*>(d_row);
  const float* dc = static_cast<const float*>(d_col);
  float* sc = static_cast<float*>(scratch);
  if (is_bf16) {
    rot3_fwd_kernel<__nv_bfloat16><<<B, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), dr, dc, static_cast<__nv_bfloat16*>(out), sc, P);
  } else {
    rot3_fwd_kernel<float><<<B, kThreads, smem, s>>>(static_cast<const float*>(x), dr, dc,
                                                     static_cast<float*>(out), sc, P);
  }
  return static_cast<int>(cudaGetLastError());
}

// Scratch: 3 * B * P * P floats. Returns cudaGetLastError() after the launch.
int livae_rot3_bwd(const void* x, const void* d_row, const void* d_col, const void* g,
                   void* dx, void* ddr, void* ddc, void* scratch, int B, int P, int is_bf16,
                   void* stream) {
  if (B < 1 || P < 2 || P > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(5 + kWarps) * P * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dr = static_cast<const float*>(d_row);
  const float* dc = static_cast<const float*>(d_col);
  float* o_ddr = static_cast<float*>(ddr);
  float* o_ddc = static_cast<float*>(ddc);
  float* sc = static_cast<float*>(scratch);
  if (is_bf16) {
    rot3_bwd_kernel<__nv_bfloat16><<<B, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), dr, dc, static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dx), o_ddr, o_ddc, sc, P);
  } else {
    rot3_bwd_kernel<float><<<B, kThreads, smem, s>>>(
        static_cast<const float*>(x), dr, dc, static_cast<const float*>(g),
        static_cast<float*>(dx), o_ddr, o_ddc, sc, P);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
