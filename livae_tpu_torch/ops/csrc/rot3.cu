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
// along H. Every sum runs in a fixed order (per-lane serial sums, a fixed shuffle
// tree, warps in order, then cluster ranks in order): no atomics, and the result
// does not change from run to run.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores): about
// 4 FLOP per element per stage against 2-4 bytes of I/O per element, so both
// kernels are bound by memory. At B=512, P=256, bf16 I/O the forward must move
// 64 MiB in and 64 MiB out (128 MiB, about 40 us); the backward reads x and g
// and writes dx (192 MiB, about 60 us).
//
// Design: one thread-block cluster per sample, every f32 intermediate in the
// cluster's distributed shared memory. A 256^2 f32 canvas is 256 KiB, more than
// one block's 227 KB, and the column stage (Sy) reads whole columns, so a
// single block would have to spill each full-canvas intermediate to device
// memory (a block per sample did: about 384 MiB of scratch traffic in the
// forward and 1.6 GiB in the backward at the shape above). Here the N blocks
// of a cluster (N = 1, 2, 4 or 8, from launch_plan in ops/rot3.py: 4 for the
// forward and 8 for the backward at P = 256) each own a contiguous band of R
// rows and hold that band of each intermediate in their own shared memory. Only x, g, the
// deltas and the outputs touch device memory: what the bound counts.
//
// The column stage is an exchange between the blocks. A block's row of a =
// Sx(x) is needed by other blocks' rows of b, so each a[r, c] is stored where
// the column shift will read it: s[y, c] = a[(y + kc[c]) mod P, c], into
// whichever block owns row y (a table of P row pointers, made with
// map_shared_rank; the block's own rows by their local address). After a
// cluster.sync() each block reads only its own band: b[y, c] = lerp(s[y, c],
// s[y + 1, c], fc[c]), with s[y1] the first row of the next block. Pushing
// (stores) rather than pulling (loads) keeps the network's latency off the
// critical path. With P a multiple of 32, a warp's 32 stores s[y(c), c] over
// consecutive c fall in 32 different banks, whatever the rows y(c). The backward's adjoint column shift works the same way with
// u[y, c] = gb[(y - kc[c]) mod P, c]. cluster.sync() separates the phases; a
// barrier without the fence starts the kernel and a last one keeps every block
// resident until no other block reads its shared memory.
//
//   forward  phase 1: a = Sx(x) for the band, pushed as s;  phase 2: b row =
//            lerp(s[y], s[y+1]), then out row = Sx(b row).
//   backward phase 1: as the forward;  phase 2: from g's row, gb = adjoint Sx
//            of g pushed as u, ddr3 (below), and the ddc partial
//            gb (s[y+1] - s[y]);  phase 3: ga row = lerp(u[y], u[y-1]), dx row
//            = adjoint Sx of ga (skipped by the dx-free variant), ddr = ddr3 +
//            the stage-1 term; ddc = the ranks' partials summed in rank order.
// Rows of x and g are read with 16-byte loads, a group of rows per warp in
// flight, and each phase's first group is issued before the cluster.sync()
// that precedes the phase.
//
// Shared memory per block, R = the band's rows, W = warps per block:
//   forward  8P + 4 (4P + R P + W P) bytes;
//   backward 8P + 4 (5P + R + 2 R P + 2 W P) bytes.
// kMaxP = 432 is about the largest canvas whose backward fits a cluster of 8
// in 227 KB per block; larger canvases take the per-shear path (ops/shear.py).
//
// Measured (chip_smoke.py and diag_rot3.py in one run, NVIDIA H100 80GB HBM3 at
// 700 W, bf16 [512, 256, 256], shifts of real rotations): forward 0.160 ms (25 %
// of its bound) at a cluster of 4, backward 0.350 ms (17 %) at 8; the one-block-
// per-sample design took 0.281 / 0.777 ms in the same run. The cluster's network
// is not what bounds them: with every access kept local they run 6 % and 17 %
// faster. Each block's two forward phases take about 7 us each for its 16 K
// elements (diag_rot3's timeline), with 80 and 89 KB of shared memory and 72 and
// 123 registers leaving about 16 warps per SM: the work inside the SM per element.

#include <cooperative_groups.h>

#include <cstdint>

#include "lerp.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxP = 432;
constexpr int kCols = (kMaxP + 31) / 32;  // columns a lane owns in a row, at most
// Canvases up to kSmallP (the main path's 256) run an instance with fewer
// columns per lane, which keeps its per-lane arrays in fewer registers.
constexpr int kSmallP = 256;
constexpr int kSmallCols = kSmallP / 32;

size_t fwd_smem(int P, int R) {
  return 8 * static_cast<size_t>(P) +
         4 * (4 * static_cast<size_t>(P) + static_cast<size_t>(R) * P +
              static_cast<size_t>(kWarps) * P);
}

size_t bwd_smem(int P, int R) {
  return 8 * static_cast<size_t>(P) +
         4 * (5 * static_cast<size_t>(P) + R + 2 * static_cast<size_t>(R) * P +
              2 * static_cast<size_t>(kWarps) * P);
}

// The part of the shared memory every block of both kernels starts with: a
// pointer to each row of the cluster's band array (rows[r] lies in the shared
// memory of block r / R), then k = floor(d) mod P and f = d - floor(d) for the
// sample's rows (kr, fr) and columns (kc, fc).
struct Tables {
  float** rows;
  int* kr;
  float* fr;
  int* kc;
  float* fc;
  float* end;
};

__device__ Tables tables(unsigned char* smem, int P) {
  Tables t;
  t.rows = reinterpret_cast<float**>(smem);
  t.kr = reinterpret_cast<int*>(t.rows + P);
  t.fr = reinterpret_cast<float*>(t.kr + P);
  t.kc = reinterpret_cast<int*>(t.fr + P);
  t.fc = reinterpret_cast<float*>(t.kc + P);
  t.end = t.fc + P;
  return t;
}

__device__ void load_tables(cg::cluster_group& cluster, const Tables& t, float* band,
                            const float* d_row, const float* d_col, int P, int R) {
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    split_shift(d_row[i], P, t.kr + i, t.fr + i);
    split_shift(d_col[i], P, t.kc + i, t.fc + i);
    // the block's own rows by their local address, so that their accesses stay
    // on the shared-memory path of the SM and off the cluster's network
    const int owner = i / R;
    float* home = owner == static_cast<int>(cluster.block_rank()) ? band
                                                                 : cluster.map_shared_rank(band, owner);
    t.rows[i] = home + static_cast<long>(i - owner * R) * P;
  }
}

// A cluster barrier without a release fence: it keeps the blocks in step (every
// block has started; no block moves on or leaves while another still reads its
// shared memory) but orders no memory accesses itself. cluster.sync() fences at
// GPU scope first, which waits for the block's outstanding stores to device
// memory; it stays where one block's shared-memory stores must be seen by
// another. Before this barrier a block's reads of another block's shared
// memory are complete: their values have been used by then.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\tbarrier.cluster.wait.aligned;" ::: "memory");
}

// Rows of x or g reach a warp in groups: the warp issues the loads of kGroup
// rows (16 bytes a lane per load) before it uses the first, so enough bytes are
// in flight to cover the latency of device memory. Each row is then unpacked to
// f32 into the warp's row buffer. Where P * sizeof(T) is not a multiple of 16,
// or a base is not 16-byte aligned, a row is read one element a lane at a time.
__device__ __forceinline__ void unpack(const uint4& v, const float*, float* dst) {
  reinterpret_cast<float4*>(dst)[0] = *reinterpret_cast<const float4*>(&v);
}
__device__ __forceinline__ void unpack(const uint4& v, const __nv_bfloat16*, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 p0 = __bfloat1622float2(h[0]), p1 = __bfloat1622float2(h[1]);
  const float2 p2 = __bfloat1622float2(h[2]), p3 = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(p0.x, p0.y, p1.x, p1.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(p2.x, p2.y, p3.x, p3.y);
}

// A group of kGroup rows of src in registers: rows y, y + kWarps, ... (< y1).
template <typename T, int kC>
struct Group {
  static constexpr int kPer = 16 / sizeof(T);             // elements per load
  static constexpr int kChunks = (kC + kPer - 1) / kPer;  // loads per lane per row
  static constexpr int kGroup = 8 / kChunks;              // rows in flight per warp
  uint4 v[kGroup][kChunks];

  __device__ __forceinline__ void load(const T* src, int y, int y1, int P, int lane) {
    const int chunks = P / kPer;
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const uint4* s = reinterpret_cast<const uint4*>(src + static_cast<long>(y + g * kWarps) * P);
#pragma unroll
      for (int j = 0; j < kChunks; ++j) {
        const int ch = lane + 32 * j;
        if (y + g * kWarps < y1 && ch < chunks) v[g][j] = __ldg(s + ch);
      }
    }
  }
};

// Calls body(y) for the warp's rows y = y0 + warp, y0 + warp + kWarps, ... < y1,
// with row[] holding src's row y in f32 during the call. With 16-byte loads
// (vec), `grp` must hold the warp's first group already: the caller issues
// those loads early (grp.load(src, y0 + warp, ...)), before the cluster.sync()
// that precedes the phase, so that their latency overlaps the wait.
template <typename T, int kC, typename Body>
__device__ __forceinline__ void for_rows(const T* src, float* row, int P, int y0, int y1,
                                         int warp, int lane, bool vec, Group<T, kC>& grp,
                                         Body body) {
  if (vec) {
    using L = Group<T, kC>;
    const int chunks = P / L::kPer;
    for (int y = y0 + warp; y < y1; y += kWarps * L::kGroup) {
      if (y != y0 + warp) grp.load(src, y, y1, P, lane);
#pragma unroll
      for (int g = 0; g < L::kGroup; ++g) {
        if (y + g * kWarps >= y1) break;
#pragma unroll
        for (int j = 0; j < L::kChunks; ++j) {
          const int ch = lane + 32 * j;
          if (ch < chunks) unpack(grp.v[g][j], src, row + ch * L::kPer);
        }
        __syncwarp();
        body(y + g * kWarps);
        __syncwarp();
      }
    }
  } else {
    for (int y = y0 + warp; y < y1; y += kWarps) {
      const long base = static_cast<long>(y) * P;
      float v[kC];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int c = lane + 32 * j;
        if (c < P) v[j] = load_f(src, base + c);
      }
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        const int c = lane + 32 * j;
        if (c < P) row[c] = v[j];
      }
      __syncwarp();
      body(y);
      __syncwarp();
    }
  }
}

// Phase 1 of both kernels, for row r of the band: a[r] = Sx(d_row) x[r] from x's
// row in row[], each a[r, c] stored to row (r - kc[c]) mod P of the cluster's
// band array, where the column shift reads it: s[y, c] = a[(y + kc[c]) mod P, c].
// The store goes to whichever block owns that row.
__device__ __forceinline__ void shift_push_row(const Tables& t, const float* row, int r, int P,
                                               int lane) {
  const int k = t.kr[r];
  const float f = t.fr[r];
  for (int c = lane; c < P; c += 32) {
    const int i0 = wrap_up(c + k, P);
    const int i1 = wrap_up(i0 + 1, P);
    t.rows[wrap_down(r - t.kc[c], P)][c] = lerp_rn(row[i0], row[i1], f);
  }
}

template <typename T, int kC>
__global__ void __launch_bounds__(kThreads)
    rot3_fwd_kernel(const T* __restrict__ x, const float* __restrict__ d_row,
                    const float* __restrict__ d_col, T* __restrict__ out, int P, int R, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long b = blockIdx.x / cluster.num_blocks();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tables t = tables(smem, P);
  float* band = t.end;  // [R, P]: rows y0..y1-1 of s[y, c] = a[(y + kc[c]) mod P, c]
  float* row = band + static_cast<long>(R) * P + warp * P;  // [P] per warp
  const int y0 = rank * R, y1 = min(P, y0 + R);
  const long PP = static_cast<long>(P) * P;

  const T* xs = x + b * PP;
  Group<T, kC> grp;
  if (vec) grp.load(xs, y0 + warp, y1, P, lane);
  load_tables(cluster, t, band, d_row + b * P, d_col + b * P, P, R);
  __syncthreads();  // the tables are written
  cluster_barrier();  // every block of the cluster runs before any stores to it

  // phase 1: a = Sx(x) for the band's rows, each value stored where the column
  // shift will read it
  for_rows(xs, row, P, y0, y1, warp, lane, vec, grp,
           [&](int r) { shift_push_row(t, row, r, P, lane); });
  cluster.sync();

  // phase 2: row y of b = Sy(a) = lerp(s[y], s[y + 1]) into the row buffer (s[y1]
  // lies in the next block), then out[y] = Sx(b row)
  T* os = out + b * PP;
  for (int y = y0 + warp; y < y1; y += kWarps) {
    const float* s0 = band + static_cast<long>(y - y0) * P;
    const float* s1 = y + 1 < y1 ? s0 + P : t.rows[wrap_up(y + 1, P)];
    for (int c = lane; c < P; c += 32) row[c] = lerp_rn(s0[c], s1[c], t.fc[c]);
    __syncwarp();
    const long base = static_cast<long>(y) * P;
    const int k = t.kr[y];
    const float f = t.fr[y];
    for (int c = lane; c < P; c += 32) {
      const int i0 = wrap_up(c + k, P);
      const int i1 = wrap_up(i0 + 1, P);
      store_f(os, base + c, lerp_rn(row[i0], row[i1], f));
    }
    __syncwarp();
  }
  cluster_barrier();  // no block leaves while another still reads its band
}

// The ddr terms use the direct formula summed by parts: for a row shift by
// (k, f) with input v and output cotangent w,
//   sum_c w[c] (v[c+k+1] - v[c+k]) = sum_c v[c] (w[c-k-1] - w[c-k])  (indices mod P),
// so each lane needs only its own v[c] and the two values of w that the adjoint
// lerp at c reads anyway.
template <typename T, bool kDx, int kC>
__global__ void __launch_bounds__(kThreads, 2)
    rot3_bwd_kernel(const T* __restrict__ x, const float* __restrict__ d_row,
                    const float* __restrict__ d_col, const T* __restrict__ g,
                    T* __restrict__ dx, float* __restrict__ ddr, float* __restrict__ ddc,
                    int P, int R, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nranks = static_cast<int>(cluster.num_blocks());
  const long b = blockIdx.x / nranks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Tables t = tables(smem, P);
  float* ddc_part = t.end;  // [P]: this block's share of ddc
  float* band_s = ddc_part + P;  // [R, P]: s[y, c] = a[(y + kc[c]) mod P, c]
  float* band_u = band_s + static_cast<long>(R) * P;  // [R, P]: u[y, c] = gb[(y - kc[c]) mod P, c]
  const long u_off = static_cast<long>(R) * P;  // t.rows[y] + u_off: row y of u
  float* rows_a = band_u + static_cast<long>(R) * P;  // [W, P]: a row buffer per warp
  float* row_a = rows_a + warp * P;
  float* row_b = rows_a + (kWarps + warp) * P;  // a second one per warp
  float* ddr3 = rows_a + 2 * kWarps * P;        // [R]: stage 3's ddr, per band row
  const int y0 = rank * R, y1 = min(P, y0 + R);
  const long PP = static_cast<long>(P) * P;

  const T* xs = x + b * PP;
  const T* gs = g + b * PP;
  Group<T, kC> grp;
  if (vec) grp.load(xs, y0 + warp, y1, P, lane);
  load_tables(cluster, t, band_s, d_row + b * P, d_col + b * P, P, R);
  __syncthreads();  // the tables are written
  cluster_barrier();  // every block of the cluster runs before any stores to it

  // phase 1: a = Sx(x) for the band's rows, stored where the column shift reads it
  for_rows(xs, row_b, P, y0, y1, warp, lane, vec, grp,
           [&](int r) { shift_push_row(t, row_b, r, P, lane); });
  if (vec) grp.load(gs, y0 + warp, y1, P, lane);
  cluster.sync();

  // phase 2, stages 3 and 2 of the forward, for the band's rows; row_b holds g's
  // row. b[c] = lerp(s[y, c], s[y + 1, c]); gb = adjoint Sx of g, stored where the
  // adjoint column shift reads it; ddr3 = sum b (g[c-k-1] - g[c-k]); the ddc
  // partial sums gb (a[r1] - a[r0]) = gb (s[y + 1] - s[y]).
  float dc[kC];  // the lane's columns' share of ddc, over the warp's rows
#pragma unroll
  for (int j = 0; j < kC; ++j) dc[j] = 0.0f;
  for_rows(gs, row_b, P, y0, y1, warp, lane, vec, grp, [&](int y) {
    const int k = t.kr[y];
    const float f = t.fr[y];
    const float* s0 = band_s + static_cast<long>(y - y0) * P;
    const float* s1 = y + 1 < y1 ? s0 + P : t.rows[wrap_up(y + 1, P)];
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const int c = lane + 32 * j;
      if (c < P) {
        const float a0 = s0[c], a1 = s1[c];
        const int j0 = wrap_down(c - k, P);
        const int j1 = wrap_down(j0 - 1, P);
        const float g0 = row_b[j0], g1 = row_b[j1];
        const float gb = lerp_rn(g0, g1, f);
        acc += lerp_rn(a0, a1, t.fc[c]) * (g1 - g0);  // b[y, c] (g[c-k-1] - g[c-k])
        dc[j] += gb * (a1 - a0);
        t.rows[wrap_up(y + t.kc[c], P)][u_off + c] = gb;  // u[y + kc[c], c] = gb[y, c]
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) ddr3[y - y0] = acc;
  });
  // the block's ddc partial: the warps' sums added in warp order
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    const int c = lane + 32 * j;
    if (c < P) row_a[c] = dc[j];
  }
  if (vec) grp.load(xs, y0 + warp, y1, P, lane);
  __syncthreads();
  for (int c = threadIdx.x; c < P; c += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += rows_a[w * P + c];
    ddc_part[c] = s;
  }
  cluster.sync();

  // ddc for the block's band of columns: the ranks' partials added in rank order
  for (int c = y0 + threadIdx.x; c < y1; c += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < nranks; ++q) s += cluster.map_shared_rank(ddc_part, q)[c];
    ddc[b * P + c] = s;
  }

  // phase 3, stage 1 of the forward; row_b holds x's row. ga row = adjoint Sy of
  // gb = lerp(u[y], u[y - 1]) (u[y0 - 1] lies in the previous block), dx row =
  // adjoint Sx of ga, ddr = ddr3 + sum x (ga[c-k-1] - ga[c-k])
  T* dxs = dx + b * PP;
  for_rows(xs, row_b, P, y0, y1, warp, lane, vec, grp, [&](int y) {
    const float* u0 = band_u + static_cast<long>(y - y0) * P;
    const float* u1 = y > y0 ? u0 - P : t.rows[wrap_down(y - 1, P)] + u_off;
    for (int c = lane; c < P; c += 32) row_a[c] = lerp_rn(u0[c], u1[c], t.fc[c]);
    __syncwarp();
    const long base = static_cast<long>(y) * P;
    const int k = t.kr[y];
    const float f = t.fr[y];
    float acc = 0.0f;
    for (int c = lane; c < P; c += 32) {
      const int j0 = wrap_down(c - k, P);
      const int j1 = wrap_down(j0 - 1, P);
      const float ga0 = row_a[j0], ga1 = row_a[j1];
      acc += row_b[c] * (ga1 - ga0);
      if (kDx) store_f(dxs, base + c, lerp_rn(ga0, ga1, f));
    }
    acc = warp_sum(acc);
    if (lane == 0) ddr[b * P + y] = ddr3[y - y0] + acc;
  });
  cluster_barrier();  // no block leaves while another still reads its u or ddc_part
}

// The launch checks shared by both entry points: N a portable cluster size, the
// bands of R rows cover 0..P-1 with none empty, and `smem` is the layout's size.
bool plan_ok(int B, int P, int N, int R, size_t smem, size_t want) {
  return B >= 1 && P >= 2 && P <= kMaxP && (N == 1 || N == 2 || N == 4 || N == 8) &&
         R >= 1 && static_cast<long>(N) * R >= P && static_cast<long>(N - 1) * R < P &&
         smem == want && smem <= 232448;
}

// A launch of `blocks` blocks in clusters of N, with `smem` bytes of dynamic
// shared memory (above 48 KB a kernel must first be allowed that much).
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int blocks, int N, size_t smem, cudaStream_t s,
                           cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = N;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(blocks));
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int B, int N, size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(kernel, B * N, N, smem, s, &attr, &cfg);
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename Kernel>
int active_clusters(Kernel kernel, int N, size_t smem, int* out) {
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = cluster_config(kernel, N, N, smem, nullptr, &attr, &cfg);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  return static_cast<int>(err);
}

// The 16-byte row loads need whole 16-byte rows and 16-byte-aligned bases.
bool vec_ok(int P, size_t elem, const void* a, const void* b) {
  return (static_cast<size_t>(P) * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T>
int fwd_typed(const void* x, const float* dr, const float* dc, void* out, int B, int P, int N,
              int R, size_t smem, cudaStream_t s, int vec) {
  const T* xs = static_cast<const T*>(x);
  T* os = static_cast<T*>(out);
  return P <= kSmallP
             ? launch(rot3_fwd_kernel<T, kSmallCols>, B, N, smem, s, xs, dr, dc, os, P, R, vec)
             : launch(rot3_fwd_kernel<T, kCols>, B, N, smem, s, xs, dr, dc, os, P, R, vec);
}

template <typename T, bool kDx>
int bwd_typed(const void* x, const float* dr, const float* dc, const void* g, void* dx,
              float* ddr, float* ddc, int B, int P, int N, int R, size_t smem, cudaStream_t s,
              int vec) {
  const T* xs = static_cast<const T*>(x);
  const T* gs = static_cast<const T*>(g);
  T* dxs = static_cast<T*>(dx);
  return P <= kSmallP ? launch(rot3_bwd_kernel<T, kDx, kSmallCols>, B, N, smem, s, xs, dr, dc,
                               gs, dxs, ddr, ddc, P, R, vec)
                      : launch(rot3_bwd_kernel<T, kDx, kCols>, B, N, smem, s, xs, dr, dc, gs,
                               dxs, ddr, ddc, P, R, vec);
}

}  // namespace

extern "C" {

// One cluster of N blocks per sample, each owning R rows, with `smem` bytes of
// dynamic shared memory (ops/rot3.py, launch_plan). Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a plan the kernel cannot take.
int livae_rot3_fwd(const void* x, const void* d_row, const void* d_col, void* out, int B, int P,
                   int N, int R, long smem, int is_bf16, void* stream) {
  if (smem < 0 || !plan_ok(B, P, N, R, static_cast<size_t>(smem), fwd_smem(P, R)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dr = static_cast<const float*>(d_row);
  const float* dc = static_cast<const float*>(d_col);
  const int vec = vec_ok(P, is_bf16 ? 2 : 4, x, x);
  return is_bf16 ? fwd_typed<__nv_bfloat16>(x, dr, dc, out, B, P, N, R, smem, s, vec)
                 : fwd_typed<float>(x, dr, dc, out, B, P, N, R, smem, s, vec);
}

// As livae_rot3_fwd. dx may be null: the dx-free variant then runs, with the
// same ddr and ddc bit for bit.
int livae_rot3_bwd(const void* x, const void* d_row, const void* d_col, const void* g, void* dx,
                   void* ddr, void* ddc, int B, int P, int N, int R, long smem, int is_bf16,
                   void* stream) {
  if (smem < 0 || !plan_ok(B, P, N, R, static_cast<size_t>(smem), bwd_smem(P, R)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dr = static_cast<const float*>(d_row);
  const float* dc = static_cast<const float*>(d_col);
  float* o_ddr = static_cast<float*>(ddr);
  float* o_ddc = static_cast<float*>(ddc);
  const int vec = vec_ok(P, is_bf16 ? 2 : 4, x, g);
  const size_t z = smem;
  if (is_bf16) {
    return dx ? bwd_typed<__nv_bfloat16, true>(x, dr, dc, g, dx, o_ddr, o_ddc, B, P, N, R, z, s, vec)
              : bwd_typed<__nv_bfloat16, false>(x, dr, dc, g, dx, o_ddr, o_ddc, B, P, N, R, z, s, vec);
  }
  return dx ? bwd_typed<float, true>(x, dr, dc, g, dx, o_ddr, o_ddc, B, P, N, R, z, s, vec)
            : bwd_typed<float, false>(x, dr, dc, g, dx, o_ddr, o_ddc, B, P, N, R, z, s, vec);
}

// How many clusters of the bf16 kernel for canvas P (`backward` 0: forward, 1:
// backward with dx) fit on the card at once for this plan, into *out. Returns
// the CUDA error.
int livae_rot3_active_clusters(int backward, int P, int N, long smem, int* out) {
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  using T = __nv_bfloat16;
  if (backward) {
    return P <= kSmallP ? active_clusters(rot3_bwd_kernel<T, true, kSmallCols>, N, smem, out)
                        : active_clusters(rot3_bwd_kernel<T, true, kCols>, N, smem, out);
  }
  return P <= kSmallP ? active_clusters(rot3_fwd_kernel<T, kSmallCols>, N, smem, out)
                      : active_clusters(rot3_fwd_kernel<T, kCols>, N, smem, out);
}

}  // extern "C"
