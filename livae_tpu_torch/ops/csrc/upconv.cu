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
// each under tap column a; qc the left and right columns alike). Each output
// element out[b, c, 2i+p, 2j+q] = y[b, (p,q,c), i, j] + (on an outer line) the
// exact 1-D operator of the other axis on the projected line:
// sum_a U(P_a)[refl(J + a - 1)], U the 2x bilinear upsample with clamped edges,
// refl the reflection into [0, 2n); at the four corners less the term both
// sides count; + bias. Each correction is rounded to the I/O type and added, and
// the sum rounded, in JAX's order (rows, columns, corners, then the bias): in
// bf16 that matches the JAX package's rounding more often than one rounding of
// the exact sum. The arithmetic is that of upconv_epilogue_reference, operation
// for operation in f32 with no FMA contraction: the result is bit-equal to the
// plain version.
//
// A thread of upconv_fwd writes a run of R consecutive outputs along one output
// row 2i+p, columns J0 .. J0+R-1 (the launch plan, ops/upconv.launch_plan, picks
// R). The vector variants take 16, 32 or 64 bytes of outputs (8 to 32 bf16, 4
// to 16 f32): R / 2 values from each of the phase planes (p, 0) and (p, 1) of
// row i in loads of 8 or 16 bytes, interleaved in registers, the bias once,
// 16-byte stores. They need 2W a multiple of R, y aligned to its loads and out
// to 16 bytes; the scalar variant (R = 1) takes any width and alignment. The
// threads fall in two ranges. First every plane's rows 0 and 2H-1, whose every
// element takes the row correction (and at the ends the column and corner
// terms), in runs of at most 16 bytes: a range of their own, so that the other
// warps do not wait on them, and the first, so that their longer work starts
// early and no tail of them is left when the rest is done. The plan takes the
// longest run that still gives the launch enough blocks to fill the card
// several times over. Then every plane's rows 1 .. 2H-2, run by run, so
// that a warp covers whole output rows and reads each sector of y's rows once
// (a row's first and last run add the one column correction of their outer
// element).
//
// upconv_bwd <- the backward of fused_upsample_reflect_conv (upconv.py:124),
// which XLA derives there: g_y [B, 4C, H, W] (the cotangent g [B, C, 2H, 2W]
// gathered back to phase space, masked by the ReLU where the saved output is
// given: g's bits where out > 0, else +0), and g_qr [B, 6C, 2, W], g_qc
// [B, 6C, H, 2] (each projected-line entry sums the few masked cotangents of
// its line that the line operator reads it for, at most six, and the corner
// terms; the other side's line of each channel is written as zeros, which the
// edge convolutions' backward reads). A block owns P whole output planes
// (b, c) (the launch plan picks P, so that a block holds about one run a
// thread; one plane at the larger maps, whose threads loop over its rows).
// Its threads take runs of R consecutive elements of one output row 2i+p in
// 16-byte loads of g (and of out where the stage has a ReLU), consecutive
// threads on consecutive runs so that a warp reads whole rows once; each
// masks its run in registers and writes its R / 2 even columns to row i of
// phase plane (p, 0) and its odd ones to (p, 1), in stores of 8 or 16 bytes,
// the index arithmetic paid once per run. Meanwhile the block keeps each
// plane's masked rows 0 and 2H-1 and columns 0 and 2W-1 in shared memory, in
// f32 (16 (H + W) bytes a plane); after one barrier a thread takes one
// position of one outer line for one tap and writes its entry of g_qr or g_qc
// from there (line_adjoint: the adjoint of line_op in closed form, and the
// corner terms), and a zero to the other line's same place. So g and out
// are read once, and no column is walked down in device memory. The vector
// variant needs 2W a multiple of R, g and out 16-byte aligned, g_y aligned to
// its stores and g_qc to two elements (its pairs); the scalar variant (R = 1,
// one element at a time) takes any width and alignment. g_y is bit-equal to the
// plain version, g_qr and g_qc within one rounding.
//
// phasemax_fwd. y [B, 4C, h, w], one thread per output element: the four
// phases' relu(round(y + b)) (the sum rounded to the I/O type, as the plain
// version adds in it), their max, and the first maximal phase in the order
// (0,0), (0,1), (1,0), (1,1) as a uint8, or 255 where the max is not above 0
// (relu's gradient is 0 there). phasemax_bwd routes the cotangent g [B, C, h, w]
// to the winning phase of g_y [B, 4C, h, w], 0 to the others: a thread takes V
// consecutive elements of g (16 bytes: 8 bf16, 4 f32; V = 1 in the scalar
// variant) and their V winner bytes, and writes V elements to each of the four
// phase planes, so g and win are read once and each of the four stores is
// coalesced across the warp. The vector variant needs h*w a multiple of V, g and
// g_y 16-byte and win V-byte aligned. It copies g's bits, as torch.where does.
// Both are bit-equal to the plain versions.
//
// A bias of [L, C] serves L groups of B / L consecutive samples (lane_rows):
// the stacked trials fold K lanes, each with its own weights, into one batch.
//
// Bound on the H100: a few f32 operations per element against 4 (bf16) or 8
// (f32) bytes of I/O, so every kernel is bound by memory. upconv_fwd reads y
// and writes out (the same count), plus the small qr, qc and bias; at batch 512
// in bf16 the decoder's four stages move 80, 147, 281 and 34 MB. upconv_bwd
// reads g and (stages 0-2) out and writes g_y (the same count) and the whole of
// g_qr and g_qc: 126, 226, 428 and 35 MB, 0.2434 ms a decoder backward at 3.35
// TB/s. phasemax_fwd reads 4 elements per output and writes one and a byte.
// phasemax_fwd is the simple design: each thread takes 4 elements a
// block-width apart, consecutive threads on consecutive outputs, divisions as
// multiplies and shifts. With 2-byte accesses one element at a time that design
// reached 13-18 % of the bound for upconv_fwd, 20.5 % for upconv_bwd and 23 %
// for phasemax_bwd (chip_smoke.py, H100 80GB HBM3, 700 W): a warp's access
// moved 64 bytes, every element paid its own index arithmetic, phasemax_bwd
// read g and win once per phase, and upconv_bwd read g at stride 2, each
// sector once for each of its two phase planes, and walked the outer columns
// down in device memory for g_qc. So those three
// move 16 to 64 bytes a thread in 16-byte accesses and pay the index
// arithmetic once per run: upconv_fwd 65 %, upconv_bwd 86 % with a warm L2
// and 81-83 % with the last stage's 35 MB cold, as in a train step (0.2829 to
// 0.2840 ms a decoder backward, from 1.18: its outer lines from shared memory,
// one tap of one position a thread) and phasemax_bwd 87 % of the bound at
// batch 512 (the same script and card).

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// A block's most shared memory on the H100 (227 KB)
constexpr int kMaxSmem = 232448;
// upconv_fwd's blocks per SM: at most 48 registers a thread, which the runs of
// 32 bytes need to keep 1280 threads' loads in flight (measured on the H100)
constexpr int kFwdBlocks = 5;
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

// A type's bits, and their conversions to and from f32: a bf16 is the top half
// of the f32 of the same value; the way back rounds to nearest even.
template <typename T>
struct Io;
template <>
struct Io<float> {
  using Bits = uint32_t;
  static __device__ __forceinline__ float f(Bits b) { return __uint_as_float(b); }
  static __device__ __forceinline__ Bits bits(float v) { return __float_as_uint(v); }
};
template <>
struct Io<__nv_bfloat16> {
  using Bits = uint16_t;
  static __device__ __forceinline__ float f(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ __forceinline__ Bits bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// N consecutive elements as one aligned access: 8 or 16 bytes in the vector
// variants.
template <typename B, int N>
struct alignas(sizeof(B) * N) Pack {
  B v[N];
};

// The runs of an upconv_fwd launch whose rows 1 .. 2H-2 take runs of R outputs:
// rows 0 and 2H-1 take runs of at most 16 bytes (row_run), whose corrections
// cost a register for each output.
template <typename T>
__host__ __device__ constexpr int row_run(int R) {
  return R < static_cast<int>(16 / sizeof(T)) ? R : static_cast<int>(16 / sizeof(T));
}

// The extents of an upconv_fwd launch: the two ranges' thread counts and the
// divisors that map a thread to its run.
struct FwdShape {
  int C, H, W;
  unsigned n_row, n_mid;
  // runs per row of rows 0 and 2H-1 (nrr) and of rows 1 .. 2H-2 (nr)
  FastDiv C1, lane, nrr, row_plane, nr, mid_plane;
};

FwdShape fwd_shape(int B, int C, int H, int W, int lane_rows, int R, int RR) {
  const unsigned nr = 2 * W / R, nrr = 2 * W / RR, rows = 2 * H - 2;
  const unsigned planes = static_cast<unsigned>(B) * C;
  return {C, H, W, planes * 2 * nrr, planes * rows * nr, fast_div(C), fast_div(lane_rows),
          fast_div(nrr), fast_div(2 * nrr), fast_div(nr), fast_div(rows * nr)};
}

// s[k] = line_op(L, J0 + k) for the R outputs of a run of row 0 or 2H-1 (J0 and
// R even). The u_a of K = J0 - 1 .. J0 + R (the three taps' positions of the
// run) come from one window of each projected line, P_a[J0/2 - 2 .. J0/2 + R/2 +
// 1], its ends clamped into [0, n) as `taps` clamps the neighbour; K = -1 and
// K = 2n reflect to 1 and 2n - 2 as `refl` does. The operations of line_op on
// the same values, so the same bits, from a third of its loads.
template <typename T, int R>
__device__ __forceinline__ void row_line_ops(const Line<T>& L, int J0, float (&s)[R]) {
  const int w0 = J0 / 2 - 2, n = L.n;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float P[R / 2 + 4];
#pragma unroll
    for (int t = 0; t < R / 2 + 4; ++t) P[t] = L.at(a, min(max(w0 + t, 0), n - 1));
    float u[R + 2];  // u[i]: K = J0 - 1 + i
#pragma unroll
    for (int i = 0; i < R + 2; ++i) {
      // the window's slots of K >> 1 and of its neighbour (K odd: the next)
      const int m = (i + 3) / 2, m2 = i % 2 == 0 ? m + 1 : m - 1;
      u[i] = __fadd_rn(__fmul_rn(0.75f, P[m]), __fmul_rn(0.25f, P[m2]));
    }
    if (J0 == 0) u[0] = u[2];
    if (J0 + R == 2 * n) u[R + 1] = u[R - 1];
#pragma unroll
    for (int k = 0; k < R; ++k) s[k] = a == 0 ? u[k] : __fadd_rn(s[k], u[k + a]);
  }
}

// kInterior: a run of rows 1 .. 2H-2 that touches no outer column; kEnd: one
// that does; kRow: a run of row 0 or 2H-1.
enum RunKind { kInterior, kEnd, kRow };

// The run of R outputs at row I, columns J0 .. J0+R-1 of plane b * C + c; ROW:
// a run of row 0 or 2H-1 (kind kRow), else of rows 1 .. 2H-2.
template <typename T, int R, bool ROW>
__device__ __forceinline__ void upconv_fwd_run(RunKind kind, int plane, int I, int J0,
                                               const T* __restrict__ y,
                                               const T* __restrict__ qr,
                                               const T* __restrict__ qc,
                                               const T* __restrict__ bias, T* __restrict__ out,
                                               const FwdShape& u, int relu) {
  using B = typename Io<T>::Bits;
  const int C = u.C, H = u.H, W = u.W, H2 = 2 * H, W2 = 2 * W;
  const int b = u.C1.div(plane), c = plane - b * C;
  const size_t hw = static_cast<size_t>(H) * W, step = C * hw;
  // row i of phase plane (p, 0); that of (p, 1) is `step` further
  const B* row = reinterpret_cast<const B*>(y) + (static_cast<size_t>(b) * 4 + 2 * (I & 1)) * step +
                 c * hw + static_cast<size_t>(I >> 1) * W;
  constexpr int S = 16 / sizeof(B);  // elements of one 16-byte access
  float v[R];
  if constexpr (R == 1) {
    v[0] = Io<T>::f(row[(J0 & 1) * step + (J0 >> 1)]);
  } else {
    // the run's R / 2 values of each phase plane, in loads of at most 16 bytes
    constexpr int L = R / 2 < S ? R / 2 : S;
    Pack<B, L> even[R / 2 / L], odd[R / 2 / L];
#pragma unroll
    for (int h = 0; h < R / 2 / L; ++h) {
      even[h] = *reinterpret_cast<const Pack<B, L>*>(row + J0 / 2 + h * L);
      odd[h] = *reinterpret_cast<const Pack<B, L>*>(row + step + J0 / 2 + h * L);
    }
#pragma unroll
    for (int k = 0; k < R / 2; ++k) {
      v[2 * k] = Io<T>::f(even[k / L].v[k % L]);
      v[2 * k + 1] = Io<T>::f(odd[k / L].v[k % L]);
    }
  }
  if (kind != kInterior) {
    const size_t q0 = static_cast<size_t>(b) * 6 * C + c;  // channel (k=0, a=0, c)
    const Line<T> top{qr + (q0 * 2 + 0) * W, static_cast<size_t>(C) * 2 * W, 1, W};
    const Line<T> bot{qr + ((q0 + 3 * C) * 2 + 1) * W, static_cast<size_t>(C) * 2 * W, 1, W};
    const Line<T> left{qc + q0 * H * 2 + 0, static_cast<size_t>(C) * H * 2, 2, H};
    const Line<T> right{qc + (q0 + 3 * C) * H * 2 + 1, static_cast<size_t>(C) * H * 2, 2, H};
    const Line<T> L = I == 0 ? top : bot;
    const bool first = J0 == 0, last = J0 + R == W2;
    // JAX's order: the rows' corrections, the columns', the corner terms; each
    // rounded to the I/O type, added, and the sum rounded
    if constexpr (ROW) {
      float s[R];
      if constexpr (R == 1) {
        s[0] = line_op(L, J0);
      } else {
        row_line_ops<T, R>(L, J0, s);
      }
#pragma unroll
      for (int k = 0; k < R; ++k) v[k] = rounded(__fadd_rn(v[k], rounded(s[k], y)), y);
    }
    if (first) v[0] = rounded(__fadd_rn(v[0], rounded(line_op(left, I), y)), y);
    if (last) v[R - 1] = rounded(__fadd_rn(v[R - 1], rounded(line_op(right, I), y)), y);
    if (ROW && first) v[0] = rounded(__fsub_rn(v[0], rounded(corner(L, 0, 1, 0), y)), y);
    if (ROW && last) {
      v[R - 1] = rounded(__fsub_rn(v[R - 1], rounded(corner(L, 2, W - 2, W - 1), y)), y);
    }
  }
  const float bv = ld(bias, static_cast<size_t>(u.lane.div(b)) * C + c);
  B* dst = reinterpret_cast<B*>(out) + (static_cast<size_t>(plane) * H2 + I) * W2 + J0;
  constexpr int N = R < S ? R : S;  // elements of one store
#pragma unroll
  for (int h = 0; h < R / N; ++h) {
    Pack<B, N> o;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = __fadd_rn(v[h * N + k], bv);
      if (relu && s < 0.f) s = 0.f;
      o.v[k] = Io<T>::bits(s);
    }
    *reinterpret_cast<Pack<B, N>*>(dst + h * N) = o;
  }
}

// One run per thread, in two ranges: every plane's rows 0 and 2H-1, in runs of
// row_run(R); then every plane's rows 1 .. 2H-2, row by row, in runs of R.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
upconv_fwd(const T* __restrict__ y, const T* __restrict__ qr, const T* __restrict__ qc,
           const T* __restrict__ bias, T* __restrict__ out, FwdShape u, int relu) {
  constexpr int RR = row_run<T>(R);
  unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < u.n_row) {
    const int nrr = u.nrr.d, plane = u.row_plane.div(idx);
    const int r = static_cast<int>(idx - plane * u.row_plane.d);
    const int I = r < nrr ? 0 : 2 * u.H - 1, run = r < nrr ? r : r - nrr;
    upconv_fwd_run<T, RR, true>(kRow, plane, I, run * RR, y, qr, qc, bias, out, u, relu);
  } else if ((idx -= u.n_row) < u.n_mid) {
    const int nr = u.nr.d, plane = u.mid_plane.div(idx);
    const unsigned r = idx - plane * u.mid_plane.d;
    const int row = u.nr.div(r), run = static_cast<int>(r - row * nr);
    const RunKind kind = run == 0 || run == nr - 1 ? kEnd : kInterior;
    upconv_fwd_run<T, R, false>(kind, plane, 1 + row, run * R, y, qr, qc, bias, out, u, relu);
  }
}

// The extents of an upconv_bwd launch whose threads take runs of R elements of
// g and whose blocks own `planes` consecutive output planes (b * C + c) each:
// the runs of a block's planes (n_runs; runs_plane a plane's, nr a row's) and
// the items of their outer lines (n_qr of g_qr, n_qc of g_qc; an item is one
// position m of one channel (k, a) of one plane: qr_ch the items of a channel
// over the block's planes, qr_m those of one plane).
struct BwdShape {
  int C, H, W;
  unsigned planes, n_planes, n_runs, n_qr, n_qc;
  FastDiv C1, nr, runs_plane, qr_ch, qr_m, qc_ch, qc_m;
};

BwdShape bwd_shape(int B, int C, int H, int W, int R, int planes) {
  const unsigned nr = 2 * W / R, P = planes;
  return {C, H, W, P, static_cast<unsigned>(B) * C, P * 2 * H * nr, 6 * P * W, 6 * P * H,
          fast_div(C), fast_div(nr), fast_div(2 * H * nr), fast_div(P * W), fast_div(W),
          fast_div(P * H), fast_div(H)};
}

// The f32 values of a block's shared memory for one plane: its masked rows 0
// and 2H-1 (2W each), then its columns 0 and 2W-1 (2H each).
__host__ __device__ constexpr int plane_lines(int H, int W) { return 4 * (H + W); }

// The R elements of g at src, as bits, masked by the ReLU where msk (out at
// the same place) is given: g's bits where out > 0, else +0, as torch.where.
template <typename T, int R>
__device__ __forceinline__ void masked_run(const typename Io<T>::Bits* src,
                                           const typename Io<T>::Bits* msk,
                                           typename Io<T>::Bits (&v)[R]) {
  using B = typename Io<T>::Bits;
  if constexpr (R == 1) {
    v[0] = src[0];
    if (msk != nullptr && !(Io<T>::f(msk[0]) > 0.f)) v[0] = 0;
  } else {
    constexpr int S = 16 / sizeof(B), N = R / S;  // elements of one load, loads
    Pack<B, S> gv[N], ov[N];
#pragma unroll
    for (int h = 0; h < N; ++h) gv[h] = reinterpret_cast<const Pack<B, S>*>(src)[h];
    if (msk != nullptr) {
#pragma unroll
      for (int h = 0; h < N; ++h) ov[h] = reinterpret_cast<const Pack<B, S>*>(msk)[h];
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      v[k] = gv[k / S].v[k % S];
      if (msk != nullptr && !(Io<T>::f(ov[k / S].v[k % S]) > 0.f)) v[k] = 0;
    }
  }
}

// The adjoint of line_op on a masked line x (2n values) at m < n for tap a:
// sum_J d line_op(J) / d P(a, m) x[J]. Tap a reads U_a at K = refl(J + a - 1),
// so h[K], the sum of the x[J] that read K, is x[K + 1 - a], plus x[0] at K = 1
// for a = 0 (refl(-1)) and x[2n-1] at K = 2n-2 for a = 2 (refl(2n)); and
// U(P)[K] reads P(m) with weight 0.75 at K = 2m and 2m+1, 0.25 at K = 2m-1 and
// 2m+2, and 0.25 more at K = 0 (m = 0) and 2n-1 (m = n-1), where `taps` clamps
// the neighbour. Summed in f32: within one rounding of the I/O type of the
// plain version's sums, which autograd takes in another order.
__device__ __forceinline__ float line_adjoint(const float* x, int a, int m, int n) {
  const auto h = [&](int K) {
    const int J = K + 1 - a;
    float v = J >= 0 && J < 2 * n ? x[J] : 0.f;
    if (a == 0 && K == 1) v += x[0];
    if (a == 2 && K == 2 * n - 2) v += x[2 * n - 1];
    return v;
  };
  return 0.75f * (h(2 * m) + h(2 * m + 1)) +
         0.25f * (h(max(2 * m - 1, 0)) + h(min(2 * m + 2, 2 * n - 1)));
}

// Block x owns the planes x P .. x P + P - 1. First its threads take the runs of
// those planes, row by row: g (masked) to the two phase planes of g_y, and the
// outer lines to shared memory. Then, after one barrier, the planes' g_qr items
// channel by channel (k, a), then their g_qc items, each channel's items of the
// block's planes consecutive in memory.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
upconv_bwd(const T* __restrict__ g, const T* __restrict__ out, T* __restrict__ gy,
           T* __restrict__ gqr, T* __restrict__ gqc, BwdShape u) {
  using B = typename Io<T>::Bits;
  constexpr int S = 16 / sizeof(B);  // elements of a 16-byte access
  extern __shared__ float lines[];
  const int C = u.C, H = u.H, W = u.W, H2 = 2 * H, W2 = 2 * W, L = plane_lines(H, W);
  const size_t hw = static_cast<size_t>(H) * W;
  const unsigned p0 = blockIdx.x * u.planes;
  const B* gb = reinterpret_cast<const B*>(g);
  const B* ob = reinterpret_cast<const B*>(out);
  for (unsigned r = threadIdx.x; r < u.n_runs; r += blockDim.x) {
    const unsigned pl = u.runs_plane.div(r), rr = r - pl * u.runs_plane.d;
    const unsigned plane = p0 + pl;
    if (plane >= u.n_planes) break;  // the last block's missing planes
    const int I = u.nr.div(rr), J0 = static_cast<int>(rr - I * u.nr.d) * R;
    const size_t at = (static_cast<size_t>(plane) * H2 + I) * W2 + J0;
    B v[R];
    masked_run<T, R>(gb + at, ob == nullptr ? nullptr : ob + at, v);
    const unsigned b = u.C1.div(plane), c = plane - b * C;
    // row I >> 1 of phase plane (I & 1, 0); that of (I & 1, 1) is C hw further
    B* dst = reinterpret_cast<B*>(gy) + ((static_cast<size_t>(b) * 4 + 2 * (I & 1)) * C + c) * hw +
             static_cast<size_t>(I >> 1) * W;
    if constexpr (R == 1) {
      dst[(J0 & 1) * C * hw + (J0 >> 1)] = v[0];
    } else {
      constexpr int N = R / 2 < S ? R / 2 : S;  // elements of one store
#pragma unroll
      for (int h = 0; h < R / 2 / N; ++h) {
        Pack<B, N> even, odd;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          even.v[k] = v[2 * (h * N + k)];
          odd.v[k] = v[2 * (h * N + k) + 1];
        }
        *reinterpret_cast<Pack<B, N>*>(dst + J0 / 2 + h * N) = even;
        *reinterpret_cast<Pack<B, N>*>(dst + C * hw + J0 / 2 + h * N) = odd;
      }
    }
    float* ln = lines + pl * L;
    if (I == 0 || I == H2 - 1) {
      float* row = ln + (I == 0 ? 0 : W2);
#pragma unroll
      for (int k = 0; k < R; ++k) row[J0 + k] = Io<T>::f(v[k]);
    }
    if (J0 == 0) ln[2 * W2 + I] = Io<T>::f(v[0]);
    if (J0 + R == W2) ln[2 * W2 + H2 + I] = Io<T>::f(v[R - 1]);
  }
  __syncthreads();
  // The outer lines' adjoint: an item is position m of line k of one plane for
  // tap a, written to channel (k, a, c) with a zero at the same place of that
  // channel's other line: g_qr's rows (m < W), then g_qc's columns (m < H),
  // channel by channel over the block's planes, m fastest, so that a warp's
  // stores are consecutive.
  for (unsigned q = threadIdx.x; q < u.n_qr + u.n_qc; q += blockDim.x) {
    const bool rows = q < u.n_qr;
    const unsigned e = rows ? q : q - u.n_qr;
    // copies: a reference into the parameters would copy them to local memory
    const FastDiv cd = rows ? u.qr_ch : u.qc_ch, md = rows ? u.qr_m : u.qc_m;
    const unsigned ch = cd.div(e), rest = e - ch * cd.d, pl = md.div(rest), plane = p0 + pl;
    if (plane >= u.n_planes) continue;
    const int n = rows ? W : H, m = static_cast<int>(rest - pl * md.d);
    const int k = ch >= 3, a = static_cast<int>(ch) - 3 * k;
    const float* x = lines + pl * L + (rows ? k * W2 : 2 * W2 + k * H2);
    float t = line_adjoint(x, a, m, n);
    const unsigned b = u.C1.div(plane), c = plane - b * C;
    B* dst = reinterpret_cast<B*>(rows ? gqr : gqc) +
             ((static_cast<size_t>(b) * 6 + ch) * C + c) * (2 * n);
    if (rows) {  // [2, W]: entry (line, m)
      // the corner terms 0.25 (P(0, 1) - P(0, 0)) and 0.25 (P(2, W-2) - P(2, W-1)),
      // which the line's first and last outputs subtract
      if (a == 0 && m <= 1) t += (m == 0 ? 0.25f : -0.25f) * x[0];
      if (a == 2 && m >= W - 2) t += (m == W - 1 ? 0.25f : -0.25f) * x[W2 - 1];
      dst[k * W + m] = Io<T>::bits(t);
      dst[(1 - k) * W + m] = 0;
    } else {  // [H, 2]: entry (m, line), as a pair
      const B v = Io<T>::bits(t);
      Pack<B, 2> o;
      o.v[0] = k ? B(0) : v;
      o.v[1] = k ? v : B(0);
      if constexpr (R == 1) {
        dst[2 * m] = o.v[0];
        dst[2 * m + 1] = o.v[1];
      } else {
        *reinterpret_cast<Pack<B, 2>*>(dst + 2 * m) = o;
      }
    }
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

// V consecutive elements of g per thread: thread t takes g[t V .. t V + V - 1]
// (one plane's, h*w being a multiple of V) and writes them to the four phases.
template <typename B, int V>
__global__ void __launch_bounds__(kThreads)
phasemax_bwd(const B* __restrict__ g, const uint8_t* __restrict__ win, B* __restrict__ gy,
             PmaxShape u, unsigned n) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  const unsigned o = t * V, hw = u.hw.d;
  const unsigned plane = u.hw.div(o), p = o - plane * hw;  // plane b * C + c
  const unsigned b = u.C1.div(plane), c = plane - b * u.C;
  const size_t step = static_cast<size_t>(u.C) * hw;
  B* dst = gy + (static_cast<size_t>(b) * 4 * u.C + c) * hw + p;
  const Pack<B, V> gv = *reinterpret_cast<const Pack<B, V>*>(g + o);
  const Pack<uint8_t, V> wv = *reinterpret_cast<const Pack<uint8_t, V>*>(win + o);
#pragma unroll
  for (int ph = 0; ph < 4; ++ph) {
    Pack<B, V> r;
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = wv.v[k] == ph ? gv.v[k] : B(0);
    *reinterpret_cast<Pack<B, V>*>(dst + ph * step) = r;
  }
}

// Blocks for n elements, or 0 where n is not a positive count below 2^31.
unsigned blocks(long long n) {
  const long long per = kThreads * kItems;
  return n <= 0 || n > 2147483647LL ? 0u : static_cast<unsigned>((n + per - 1) / per);
}

// A plan's launch shape fits a kernel: a whole number of warps, at most
// kThreads a block, and exactly the blocks that `threads` need.
bool fits(long long threads_needed, int threads, int nblocks) {
  return threads_needed > 0 && threads > 0 && threads <= kThreads && threads % 32 == 0 &&
         nblocks == (threads_needed + threads - 1) / threads;
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The upconv_fwd instance of T with runs of R outputs.
template <typename T>
void (*fwd_kernel(int R))(const T*, const T*, const T*, const T*, T*, FwdShape, int) {
  constexpr int S = 16 / sizeof(T);  // outputs of 16 bytes
  return R == 1 ? upconv_fwd<T, 1>
         : R == S ? upconv_fwd<T, S> : R == 2 * S ? upconv_fwd<T, 2 * S> : upconv_fwd<T, 4 * S>;
}

// The upconv_bwd instance of T with runs of R elements of g.
template <typename T>
void (*bwd_kernel(int R))(const T*, const T*, T*, T*, T*, BwdShape) {
  constexpr int S = 16 / sizeof(T);  // elements of 16 bytes
  return R == 1 ? upconv_bwd<T, 1> : R == S ? upconv_bwd<T, S> : upconv_bwd<T, 2 * S>;
}

// Launches bwd_kernel<T>(R), first raising its dynamic shared memory limit
// where the plan asks for more than the default 48 KB.
template <typename T>
int launch_bwd(int R, const void* g, const void* out, void* gy, void* gqr, void* gqc,
               const BwdShape& u, int threads, int nblocks, int smem, cudaStream_t s) {
  const auto kernel = bwd_kernel<T>(R);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<nblocks, threads, smem, s>>>(static_cast<const T*>(g), static_cast<const T*>(out),
                                        static_cast<T*>(gy), static_cast<T*>(gqr),
                                        static_cast<T*>(gqc), u);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out [B, C, 2H, 2W] of y [B, 4C, H, W], qr [B, 6C, 2, W], qc [B, 6C, H, 2] and
// bias [B / lane_rows, C], all of one type; relu != 0 applies the ReLU. The
// launch plan gives `elems` (the outputs of a thread's run: 1, or 16, 32 or 64
// bytes' worth in the vector variant), `threads` per block and `nblocks`.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape or a plan the kernel does not take.
int livae_upconv_fwd(const void* y, const void* qr, const void* qc, const void* bias, void* out,
                     int B, int C, int H, int W, int lane_rows, int relu, int is_bf16, int elems,
                     int threads, int nblocks, void* stream) {
  const int elem = is_bf16 ? 2 : 4, vec = 16 / elem;
  if (B <= 0 || C <= 0 || H < 2 || W < 2 || lane_rows <= 0 || B % lane_rows ||
      blocks(4LL * B * C * H * W) == 0 ||
      (elems != 1 && elems != vec && elems != 2 * vec && elems != 4 * vec) ||
      (elems > 1 &&
       ((2 * W) % elems || !aligned(y, std::min(elems / 2 * elem, 16)) || !aligned(out, 16))) ||
      !fits(1LL * B * C * (2 * (2 * W / std::min(elems, vec)) + (2 * H - 2) * (2 * W / elems)),
            threads, nblocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdShape u = fwd_shape(B, C, H, W, lane_rows, elems, std::min(elems, vec));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    const auto kernel = fwd_kernel<T>(elems);
    kernel<<<nblocks, threads, 0, s>>>(static_cast<const T*>(y), static_cast<const T*>(qr),
                                       static_cast<const T*>(qc), static_cast<const T*>(bias),
                                       static_cast<T*>(out), u, relu);
  } else {
    using T = float;
    const auto kernel = fwd_kernel<T>(elems);
    kernel<<<nblocks, threads, 0, s>>>(static_cast<const T*>(y), static_cast<const T*>(qr),
                                       static_cast<const T*>(qc), static_cast<const T*>(bias),
                                       static_cast<T*>(out), u, relu);
  }
  return static_cast<int>(cudaGetLastError());
}

// g_y [B, 4C, H, W], g_qr [B, 6C, 2, W] and g_qc [B, 6C, H, 2] of the cotangent
// g [B, C, 2H, 2W]; out (the forward's output, like g) masks the ReLU, or null.
// The launch plan gives `elems` (the elements of g in a thread's run: 1, or 16
// or 32 bytes' worth in the vector variant), `planes` per block, `threads`,
// `nblocks` (ceil(B C / planes)) and `smem` (at least 16 (H + W) bytes a plane,
// at most 227 KB). cudaErrorInvalidValue for a shape or a plan the kernel does
// not take: the B C planes must stay below 2^31, the range of the plane index
// that FastDiv divides by C (the shared memory limit keeps a block's runs and
// line items there too; element offsets are size_t).
int livae_upconv_bwd(const void* g, const void* out, void* gy, void* gqr, void* gqc, int B, int C,
                     int H, int W, int is_bf16, int elems, int planes, int threads, int nblocks,
                     int smem, void* stream) {
  const int elem = is_bf16 ? 2 : 4, vec = 16 / elem;
  if (B <= 0 || C <= 0 || H < 2 || W < 2 || 1LL * B * C > 2147483647LL ||
      (elems != 1 && elems != vec && elems != 2 * vec) ||
      (elems > 1 && ((2 * W) % elems || !aligned(g, 16) || (out != nullptr && !aligned(out, 16)) ||
                     !aligned(gy, std::min(elems / 2 * elem, 16)) || !aligned(gqc, 2 * elem))) ||
      planes <= 0 || threads <= 0 || threads > kThreads || threads % 32 ||
      nblocks != (1LL * B * C + planes - 1) / planes ||
      smem < 16LL * planes * (static_cast<long long>(H) + W) || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdShape u = bwd_shape(B, C, H, W, elems, planes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bwd<__nv_bfloat16>(elems, g, out, gy, gqr, gqc, u, threads, nblocks,
                                             smem, s)
                 : launch_bwd<float>(elems, g, out, gy, gqr, gqc, u, threads, nblocks, smem, s);
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

// g_y [B, 4C, h, w] of the cotangent g [B, C, h, w] and the winner map; `elems`
// (elements of g a thread takes: 1, or 16 bytes' worth in the vector variant),
// `threads` and `nblocks` from the launch plan.
int livae_phasemax_bwd(const void* g, const void* win, void* gy, int B, int C, int h, int w,
                       int is_bf16, int elems, int threads, int nblocks, void* stream) {
  const int vec = is_bf16 ? 8 : 4;
  const long long n = static_cast<long long>(B) * C * h * w;
  if (B <= 0 || C <= 0 || h <= 0 || w <= 0 || blocks(4 * n) == 0 ||
      (elems != 1 && elems != vec) ||
      (elems > 1 && ((h * w) % elems || !aligned(g, 16) || !aligned(gy, 16) ||
                     !aligned(win, elems))) ||
      !fits(n / elems, threads, nblocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PmaxShape u = pmax_shape(B, C, h * w, 1);
  const unsigned nt = static_cast<unsigned>(n / elems);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* wn = static_cast<const uint8_t*>(win);
  if (is_bf16) {
    using Bits = uint16_t;
    const auto kernel = elems == 1 ? phasemax_bwd<Bits, 1> : phasemax_bwd<Bits, 8>;
    kernel<<<nblocks, threads, 0, s>>>(static_cast<const Bits*>(g), wn, static_cast<Bits*>(gy), u,
                                       nt);
  } else {
    using Bits = uint32_t;
    const auto kernel = elems == 1 ? phasemax_bwd<Bits, 1> : phasemax_bwd<Bits, 4>;
    kernel<<<nblocks, threads, 0, s>>>(static_cast<const Bits*>(g), wn, static_cast<Bits*>(gy), u,
                                       nt);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
