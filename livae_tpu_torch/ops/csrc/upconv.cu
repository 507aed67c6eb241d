// The epilogues of the half-resolution decoder stage and STN block, hand-written
// for Hopper (sm_90a), bound to Python through a plain C interface
// (livae_tpu_torch/ops/upconv.py).
//
// They are the GPU form of livae_tpu/ops/upconv.py, which the JAX package leaves
// to XLA (no Pallas kernel):
//   upconv_fwd / upconv_bwd   <- fused_upsample_reflect_conv (upconv.py:124-194):
//     everything after the phase convolution (which cuDNN computes here, as XLA
//     does there): depth-to-space, bias, the four edge lines' corrections and
//     the four corner terms (upconv.py:150-176), and the decoder's ReLU; and
//     the adjoint of that.
//   phasemax_fwd / phasemax_bwd <- fused_conv5_relu_maxpool (upconv.py:299) and
//     its custom VJP (_routed_pmax, upconv.py:226-260; _crp_bwd, :285-296):
//     relu(y + b), the max over the four phase groups, and the cotangent routed
//     to the first maximal phase.
//
// upconv_fwd. y [B, 4C, H, W] is the phase convolution (channel (p*2+q)*C + c),
// qr [B, 6C, 2, W] and qc [B, 6C, H, 2] the edge lines projected on the taps
// (channel (k*3 + a)*C + c; qr's line k = 0 is the top line 0.25 (x[1] - x[0])
// under tap row 0, k = 1 the bottom line 0.25 (x[H-2] - x[H-1]) under tap row 2,
// each under tap column a; qc the left and right columns alike). One thread per
// output element out[b, c, 2i+p, 2j+q] = y[b, (p,q,c), i, j] + (on an outer
// line) the exact 1-D operator of the other axis on the projected line:
// sum_a U(P_a)[refl(J + a - 1)], U the 2x bilinear upsample with clamped edges,
// refl the reflection into [0, 2n); at the four corners less the term both
// sides count; + bias. Each correction is rounded to the I/O type and added, and
// the sum rounded, in JAX's order (rows, columns, corners, then the bias): in
// bf16 that matches the JAX package's rounding more often than one rounding of
// the exact sum. The arithmetic is that of upconv_epilogue_reference, operation
// for operation in f32 with no FMA contraction: the result is bit-equal to the
// plain version.
//
// upconv_bwd. One launch, three groups of planes: g_y (the cotangent gathered
// back to phase space, masked by the ReLU where the saved output is given), and
// g_qr, g_qc (each projected-line entry sums the few output cotangents whose
// line operator reads it, at most six, and the corner terms).
//
// phasemax_fwd. y [B, 4C, h, w], one thread per output element: the four
// phases' relu(round(y + b)) (the sum rounded to the I/O type, as the plain
// version adds in it), their max, and the first maximal phase in the order
// (0,0), (0,1), (1,0), (1,1) as a uint8, or 255 where the max is not above 0
// (relu's gradient is 0 there). phasemax_bwd: one thread per g_y element, g on
// the winning phase, 0 elsewhere. Both are bit-equal to the plain versions.
//
// A bias of [L, C] serves L groups of B / L consecutive samples (lane_rows):
// the stacked trials fold K lanes, each with its own weights, into one batch.
//
// Bound on the H100: a few f32 operations per element against 4 (bf16) or 8
// (f32) bytes of I/O, so every kernel is bound by memory. upconv_fwd reads y
// and writes out (the same count), plus the small qr, qc and bias; at batch 512
// in bf16 the decoder's four stages move 67, 134, 268 and 34 MB. phasemax_fwd
// reads 4 elements per output and writes one and a byte. The design is the
// simple one: each thread takes 4 elements a block-width apart, consecutive
// threads on consecutive outputs (stores coalesced; loads in two interleaved
// runs for upconv_fwd). At 2 bytes an element, index arithmetic costs as much
// as the memory traffic and one element a thread keeps too few bytes in
// flight: the first version (one element a thread, 64-bit divisions, the outer
// lines' pixels among the interior ones, whose warps then waited on the
// corrections' chain of loads) reached 7-11 % of the bound for upconv_fwd and
// 17 % for phasemax_bwd (chip_smoke.py, H100 80GB HBM3, 700 W). So the
// divisions are multiplies and shifts, upconv_fwd gives the outer lines'
// pixels a range of threads of their own, and a thread's 4 elements load
// together.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Elements a thread takes, kThreads apart: their loads are in flight together
// (at 2-3 bytes an element, one a thread leaves the memory system idle).
constexpr int kItems = 4;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
// v rounded to the I/O type and back
__device__ __forceinline__ float rounded(float v, const float*) { return v; }
__device__ __forceinline__ float rounded(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One projected edge line: P(a, m) = base[a * a_stride + m * m_stride], m < n.
template <typename T>
struct Line {
  const T* base;
  size_t a_stride;
  size_t m_stride;
  int n;
  __device__ float at(int a, int m) const { return ld(base, a * a_stride + m * m_stride); }
};

// The reflection of K into [0, 2n) (ReflectionPad2d(1) of the upsampled line).
__device__ __forceinline__ int refl(int K, int n) {
  return K < 0 ? 1 : (K > 2 * n - 1 ? 2 * n - 2 : K);
}

// The two upsample taps of position K: m = K / 2 (weight 0.75) and its neighbour
// towards K (weight 0.25), clamped into [0, n).
__device__ __forceinline__ void taps(int K, int n, int& m, int& m2) {
  m = K >> 1;
  m2 = (K & 1) ? min(m + 1, n - 1) : max(m - 1, 0);
}

// sum_a U(P_a)[refl(J + a - 1)], in the plain version's order.
template <typename T>
__device__ float line_op(const Line<T>& L, int J) {
  float s = 0.f;
  for (int a = 0; a < 3; ++a) {
    int m, m2;
    taps(refl(J + a - 1, L.n), L.n, m, m2);
    const float u = __fadd_rn(__fmul_rn(0.75f, L.at(a, m)), __fmul_rn(0.25f, L.at(a, m2)));
    s = a == 0 ? u : __fadd_rn(s, u);
  }
  return s;
}

// d line_op(J) / d P(a, m).
__device__ __forceinline__ float line_coef(int J, int a, int m, int n) {
  int k, k2;
  taps(refl(J + a - 1, n), n, k, k2);
  return (k == m ? 0.75f : 0.f) + (k2 == m ? 0.25f : 0.f);
}

// 0.25 (P(a, j1) - P(a, j0)): a corner term.
template <typename T>
__device__ __forceinline__ float corner(const Line<T>& L, int a, int j1, int j0) {
  return __fmul_rn(0.25f, __fsub_rn(L.at(a, j1), L.at(a, j0)));
}

// Every kernel indexes one flat range of elements (the entry points refuse 2^31
// or more) and finds an element's place by divisions by the shape's extents. A 32-bit
// division by a runtime divisor costs a few dozen instructions, as many as the
// rest of a thread's work, so each divisor comes with its multiply-and-shift
// form, made once on the host (FastDiv, the method of PyTorch's IntDivider).
struct FastDiv {
  unsigned d, m, s;
  __device__ __forceinline__ unsigned div(unsigned n) const {  // n / d for n < 2^31
    return (__umulhi(n, m) + n) >> s;
  }
};

FastDiv fast_div(unsigned d) {
  unsigned s = 0;
  while ((1u << s) < d) ++s;
  const unsigned long long one = 1;
  return {d, static_cast<unsigned>(((one << 32) * ((one << s) - d)) / d + 1), s};
}

// The extents of an upconv launch: B, C, H, W and their divisors.
struct UpShape {
  int B, C, H, W, lane_rows;
  FastDiv C1, C3, C4, C6, lane, W1, W2i, ni, ne, hw, len_r, len_c;
};

UpShape up_shape(int B, int C, int H, int W, int lane_rows) {
  const int H2 = 2 * H, W2 = 2 * W;
  return {B, C, H, W, lane_rows, fast_div(C), fast_div(3 * C), fast_div(4 * C),
          fast_div(6 * C), fast_div(lane_rows), fast_div(W), fast_div(W2 - 2),
          fast_div((H2 - 2) * (W2 - 2)), fast_div(2 * W2 + 2 * (H2 - 2)), fast_div(H * W),
          fast_div(2 * W), fast_div(2 * H)};
}

// The output pixel of thread idx: first every plane's interior pixels, row by
// row, then every plane's outer lines (row 0, row 2H-1, then column 0 and
// column 2W-1 without their ends), so that a warp of interior pixels never
// waits on an outer pixel's corrections. False past the end.
__device__ __forceinline__ bool fwd_pixel(unsigned idx, const UpShape& u, int& plane, int& I,
                                          int& J) {
  const int H2 = 2 * u.H, W2 = 2 * u.W;
  const unsigned planes = static_cast<unsigned>(u.B) * u.C;
  const unsigned n_in = planes * u.ni.d;
  if (idx < n_in) {
    plane = u.ni.div(idx);
    const unsigned r = idx - plane * u.ni.d;
    const int row = u.W2i.div(r);
    I = 1 + row;
    J = 1 + static_cast<int>(r - row * u.W2i.d);
    return true;
  }
  idx -= n_in;
  if (idx >= planes * u.ne.d) return false;
  plane = u.ne.div(idx);
  int e = static_cast<int>(idx - plane * u.ne.d);
  if (e < W2) {
    I = 0, J = e;
  } else if ((e -= W2) < W2) {
    I = H2 - 1, J = e;
  } else if ((e -= W2) < H2 - 2) {
    I = 1 + e, J = 0;
  } else {
    I = 1 + e - (H2 - 2), J = W2 - 1;
  }
  return true;
}

template <typename T>
__device__ __forceinline__ void upconv_fwd_item(unsigned idx, const T* __restrict__ y,
                                                const T* __restrict__ qr,
                                                const T* __restrict__ qc,
                                                const T* __restrict__ bias, T* __restrict__ out,
                                                const UpShape& u, int relu) {
  const int C = u.C, H = u.H, W = u.W, H2 = 2 * H, W2 = 2 * W;
  int plane, I, J;
  if (!fwd_pixel(idx, u, plane, I, J)) return;
  const int b = u.C1.div(plane), c = plane - b * C;
  const int ph = (I & 1) * 2 + (J & 1);
  const size_t hw = static_cast<size_t>(H) * W;
  float v = ld(y, (static_cast<size_t>(b) * 4 + ph) * C * hw + c * hw + (I >> 1) * W + (J >> 1));
  if (I == 0 || I == H2 - 1 || J == 0 || J == W2 - 1) {
    const size_t q0 = static_cast<size_t>(b) * 6 * C + c;  // channel (k=0, a=0, c)
    const Line<T> top{qr + (q0 * 2 + 0) * W, static_cast<size_t>(C) * 2 * W, 1, W};
    const Line<T> bot{qr + ((q0 + 3 * C) * 2 + 1) * W, static_cast<size_t>(C) * 2 * W, 1, W};
    const Line<T> left{qc + q0 * H * 2 + 0, static_cast<size_t>(C) * H * 2, 2, H};
    const Line<T> right{qc + (q0 + 3 * C) * H * 2 + 1, static_cast<size_t>(C) * H * 2, 2, H};
    // JAX's order: the rows' corrections, the columns', the corner terms; each
    // rounded to the I/O type, added, and the sum rounded
    if (I == 0) v = rounded(__fadd_rn(v, rounded(line_op(top, J), y)), y);
    if (I == H2 - 1) v = rounded(__fadd_rn(v, rounded(line_op(bot, J), y)), y);
    if (J == 0) v = rounded(__fadd_rn(v, rounded(line_op(left, I), y)), y);
    if (J == W2 - 1) v = rounded(__fadd_rn(v, rounded(line_op(right, I), y)), y);
    if ((I == 0 || I == H2 - 1) && (J == 0 || J == W2 - 1)) {
      const Line<T>& L = I == 0 ? top : bot;
      const float cr = J == 0 ? corner(L, 0, 1, 0) : corner(L, 2, W - 2, W - 1);
      v = rounded(__fsub_rn(v, rounded(cr, y)), y);
    }
  }
  v = __fadd_rn(v, ld(bias, static_cast<size_t>(u.lane.div(b)) * C + c));
  if (relu && v < 0.f) v = 0.f;
  st(out, (static_cast<size_t>(plane) * H2 + I) * W2 + J, v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upconv_fwd(const T* __restrict__ y, const T* __restrict__ qr, const T* __restrict__ qc,
           const T* __restrict__ bias, T* __restrict__ out, UpShape u, int relu) {
  const unsigned base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    upconv_fwd_item(base + it * kThreads, y, qr, qc, bias, out, u, relu);
  }
}

// The output cotangent at pixel (I, J) of the plane starting at gp, masked by
// the ReLU where out is given.
template <typename T>
__device__ __forceinline__ float g_pre(const T* g, const T* out, size_t gp, int W2, int I,
                                       int J) {
  const size_t k = gp + static_cast<size_t>(I) * W2 + J;
  const float v = ld(g, k);
  return (out != nullptr && !(ld(out, k) > 0.f)) ? 0.f : v;
}

// Three ranges of threads: g_y [B, 4C, H, W], then g_qr [B, 6C, 2, W] (the lines
// k = 0, 1 of channel (k, a, c)), then g_qc [B, 6C, H, 2].
template <typename T>
__device__ __forceinline__ void upconv_bwd_item(unsigned idx, const T* __restrict__ g,
                                                const T* __restrict__ out, T* __restrict__ gy,
                                                T* __restrict__ gqr, T* __restrict__ gqc,
                                                const UpShape& u) {
  const int C = u.C, H = u.H, W = u.W, H2 = 2 * H, W2 = 2 * W;
  const unsigned n_y = static_cast<unsigned>(u.B) * 4 * C * H * W;
  const unsigned n_r = static_cast<unsigned>(u.B) * 6 * C * 2 * W;
  const unsigned n_c = static_cast<unsigned>(u.B) * 6 * C * 2 * H;
  if (idx < n_y) {
    const unsigned plane = u.hw.div(idx), p = idx - plane * u.hw.d;
    const unsigned b = u.C4.div(plane), r = plane - b * u.C4.d;
    const unsigned ph = u.C1.div(r), c = r - ph * C;
    const unsigned i = u.W1.div(p), j = p - i * W;
    const size_t gp = (static_cast<size_t>(b) * C + c) * H2 * W2;
    st(gy, idx, g_pre(g, out, gp, W2, 2 * i + (ph >> 1), 2 * j + (ph & 1)));
    return;
  }
  idx -= n_y;
  const bool rows = idx < n_r;  // else g_qc
  if (!rows) idx -= n_r;
  if (!rows && idx >= n_c) return;
  const FastDiv& len = rows ? u.len_r : u.len_c;
  const unsigned plane = len.div(idx), p = idx - plane * len.d;
  const unsigned b = u.C6.div(plane), ch = plane - b * u.C6.d;
  const unsigned k = u.C3.div(ch), rest = ch - k * u.C3.d;
  const int a = u.C1.div(rest), c = rest - a * C;
  const size_t gp = (static_cast<size_t>(b) * C + c) * H2 * W2;
  float s = 0.f;
  if (rows) {  // entry (line, j) of channel (k, a, c)
    const int line = p >= static_cast<unsigned>(W), j = p - line * W;
    if (line == static_cast<int>(k)) {
      const int I = k ? H2 - 1 : 0;
      for (int J = max(2 * j - 2, 0); J <= min(2 * j + 3, W2 - 1); ++J) {
        const float cf = line_coef(J, a, j, W);
        if (cf != 0.f) s += cf * g_pre(g, out, gp, W2, I, J);
      }
      // the corner terms 0.25 (P(0, 1) - P(0, 0)) and 0.25 (P(2, W-2) - P(2, W-1)),
      // subtracted at the line's first and last output
      if (a == 0 && j <= 1) s += (j == 0 ? 0.25f : -0.25f) * g_pre(g, out, gp, W2, I, 0);
      if (a == 2 && j >= W - 2) {
        s += (j == W - 1 ? 0.25f : -0.25f) * g_pre(g, out, gp, W2, I, W2 - 1);
      }
    }
    st(gqr, idx, s);
  } else {  // entry (i, line)
    const int i = p >> 1, line = p & 1;
    if (line == static_cast<int>(k)) {
      const int J = k ? W2 - 1 : 0;
      for (int I = max(2 * i - 2, 0); I <= min(2 * i + 3, H2 - 1); ++I) {
        const float cf = line_coef(I, a, i, H);
        if (cf != 0.f) s += cf * g_pre(g, out, gp, W2, I, J);
      }
    }
    st(gqc, idx, s);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upconv_bwd(const T* __restrict__ g, const T* __restrict__ out, T* __restrict__ gy,
           T* __restrict__ gqr, T* __restrict__ gqc, UpShape u) {
  const unsigned base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    upconv_bwd_item(base + it * kThreads, g, out, gy, gqr, gqc, u);
  }
}

// The extents of a phase-max launch.
struct PmaxShape {
  int B, C;
  FastDiv C1, C4, hw, lane;
};

PmaxShape pmax_shape(int B, int C, int hw, int lane_rows) {
  return {B, C, fast_div(C), fast_div(4 * C), fast_div(hw), fast_div(lane_rows)};
}

template <typename T>
__device__ __forceinline__ void phasemax_fwd_item(unsigned idx, const T* __restrict__ y,
                                                  const T* __restrict__ bias, T* __restrict__ out,
                                                  uint8_t* __restrict__ win, const PmaxShape& u) {
  const unsigned hw = u.hw.d;
  if (idx >= static_cast<unsigned>(u.B) * u.C * hw) return;
  const unsigned plane = u.hw.div(idx), p = idx - plane * hw;  // plane b * C + c
  const unsigned b = u.C1.div(plane), c = plane - b * u.C;
  const float bv = ld(bias, static_cast<size_t>(u.lane.div(b)) * u.C + c);
  const size_t base = (static_cast<size_t>(b) * 4 * u.C + c) * hw + p;
  const size_t step = static_cast<size_t>(u.C) * hw;
  float v[4];
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    const float s = rounded(__fadd_rn(ld(y, base + ph * step), bv), y);
    v[ph] = s < 0.f ? 0.f : s;
  }
  const float m01 = fmaxf(v[0], v[1]), m23 = fmaxf(v[2], v[3]);
  const bool left = m01 >= m23;  // ties go to the earlier phase
  const int first = left ? (v[0] >= v[1] ? 0 : 1) : (v[2] >= v[3] ? 2 : 3);
  const float m = left ? m01 : m23;
  win[idx] = m > 0.f ? static_cast<uint8_t>(first) : static_cast<uint8_t>(255);
  st(out, idx, m);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
phasemax_fwd(const T* __restrict__ y, const T* __restrict__ bias, T* __restrict__ out,
             uint8_t* __restrict__ win, PmaxShape u) {
  const unsigned base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    phasemax_fwd_item(base + it * kThreads, y, bias, out, win, u);
  }
}

template <typename T>
__device__ __forceinline__ void phasemax_bwd_item(unsigned idx, const T* __restrict__ g,
                                                  const uint8_t* __restrict__ win,
                                                  T* __restrict__ gy, const PmaxShape& u) {
  const unsigned hw = u.hw.d;
  if (idx >= static_cast<unsigned>(u.B) * 4 * u.C * hw) return;
  const unsigned plane = u.hw.div(idx), p = idx - plane * hw;  // (b * 4 + ph) * C + c
  const unsigned b = u.C4.div(plane), r = plane - b * u.C4.d;
  const unsigned ph = u.C1.div(r), c = r - ph * u.C;
  const size_t o = (static_cast<size_t>(b) * u.C + c) * hw + p;
  st(gy, idx, win[o] == ph ? ld(g, o) : 0.f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
phasemax_bwd(const T* __restrict__ g, const uint8_t* __restrict__ win, T* __restrict__ gy,
             PmaxShape u) {
  const unsigned base = blockIdx.x * (kThreads * kItems) + threadIdx.x;
#pragma unroll
  for (int it = 0; it < kItems; ++it) phasemax_bwd_item(base + it * kThreads, g, win, gy, u);
}

// Blocks for n elements, or 0 where n is not a positive count below 2^31.
unsigned blocks(long long n) {
  const long long per = kThreads * kItems;
  return n <= 0 || n > 2147483647LL ? 0u : static_cast<unsigned>((n + per - 1) / per);
}

}  // namespace

extern "C" {

// out [B, C, 2H, 2W] of y [B, 4C, H, W], qr [B, 6C, 2, W], qc [B, 6C, H, 2] and
// bias [B / lane_rows, C], all of one type; relu != 0 applies the ReLU. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape the
// kernel does not take.
int livae_upconv_fwd(const void* y, const void* qr, const void* qc, const void* bias, void* out,
                     int B, int C, int H, int W, int lane_rows, int relu, int is_bf16,
                     void* stream) {
  const unsigned nb = blocks(4LL * B * C * H * W);
  if (B <= 0 || C <= 0 || H < 2 || W < 2 || lane_rows <= 0 || B % lane_rows || nb == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const UpShape u = up_shape(B, C, H, W, lane_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    upconv_fwd<T><<<nb, kThreads, 0, s>>>(
        static_cast<const T*>(y), static_cast<const T*>(qr), static_cast<const T*>(qc),
        static_cast<const T*>(bias), static_cast<T*>(out), u, relu);
  } else {
    upconv_fwd<float><<<nb, kThreads, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(qr),
        static_cast<const float*>(qc), static_cast<const float*>(bias),
        static_cast<float*>(out), u, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

// g_y [B, 4C, H, W], g_qr [B, 6C, 2, W] and g_qc [B, 6C, H, 2] of the cotangent
// g [B, C, 2H, 2W]; out (the forward's output, like g) masks the ReLU, or null.
int livae_upconv_bwd(const void* g, const void* out, void* gy, void* gqr, void* gqc, int B, int C,
                     int H, int W, int is_bf16, void* stream) {
  const unsigned nb = blocks(4LL * B * C * H * W + 12LL * B * C * (H + W));
  if (B <= 0 || C <= 0 || H < 2 || W < 2 || nb == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const UpShape u = up_shape(B, C, H, W, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    upconv_bwd<T><<<nb, kThreads, 0, s>>>(
        static_cast<const T*>(g), static_cast<const T*>(out), static_cast<T*>(gy),
        static_cast<T*>(gqr), static_cast<T*>(gqc), u);
  } else {
    upconv_bwd<float><<<nb, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(out), static_cast<float*>(gy),
        static_cast<float*>(gqr), static_cast<float*>(gqc), u);
  }
  return static_cast<int>(cudaGetLastError());
}

// out [B, C, h, w] (like y) and win [B, C, h, w] (uint8) of y [B, 4C, h, w] and
// bias [B / lane_rows, C].
int livae_phasemax_fwd(const void* y, const void* bias, void* out, void* win, int B, int C, int h,
                       int w, int lane_rows, int is_bf16, void* stream) {
  const unsigned nb = blocks(static_cast<long long>(B) * C * h * w);
  if (B <= 0 || C <= 0 || h <= 0 || w <= 0 || lane_rows <= 0 || B % lane_rows || nb == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PmaxShape u = pmax_shape(B, C, h * w, lane_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* wn = static_cast<uint8_t*>(win);
  if (is_bf16) {
    using T = __nv_bfloat16;
    phasemax_fwd<T><<<nb, kThreads, 0, s>>>(static_cast<const T*>(y),
                                            static_cast<const T*>(bias), static_cast<T*>(out),
                                            wn, u);
  } else {
    phasemax_fwd<float><<<nb, kThreads, 0, s>>>(
        static_cast<const float*>(y), static_cast<const float*>(bias), static_cast<float*>(out),
        wn, u);
  }
  return static_cast<int>(cudaGetLastError());
}

// g_y [B, 4C, h, w] of the cotangent g [B, C, h, w] and the winner map.
int livae_phasemax_bwd(const void* g, const void* win, void* gy, int B, int C, int h, int w,
                       int is_bf16, void* stream) {
  const unsigned nb = blocks(4LL * B * C * h * w);
  if (B <= 0 || C <= 0 || h <= 0 || w <= 0 || nb == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PmaxShape u = pmax_shape(B, C, h * w, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* wn = static_cast<const uint8_t*>(win);
  if (is_bf16) {
    using T = __nv_bfloat16;
    phasemax_bwd<T><<<nb, kThreads, 0, s>>>(static_cast<const T*>(g), wn, static_cast<T*>(gy), u);
  } else {
    phasemax_bwd<float><<<nb, kThreads, 0, s>>>(static_cast<const float*>(g), wn,
                                                static_cast<float*>(gy), u);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
