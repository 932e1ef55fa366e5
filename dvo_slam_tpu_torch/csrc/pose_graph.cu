// Levenberg-Marquardt over a padded SE(3) pose graph for Hopper (sm_90a):
// one launch of one thread-block cluster runs one whole dense
// models/pose_graph.py::optimize call, every LM step on the card.
//
// What it replaces. There is no Pallas kernel here: the JAX package runs
// dvo_slam_tpu/models/pose_graph.py::optimize as one jax.jit whose
// lax.while_loop (line 463) XLA compiles to one device program. This kernel
// stands in for that loop and its body (lines 419-455): per-edge residuals
// and Jacobians (_build_blocks), the dense 6M x 6M system (_build_system), a
// damped Cholesky and its two triangular solves, the non-finite step zeroed,
// exp(delta) on the active vertices, the robust chi2 of the new poses, the
// accept test, the lambda clip and the stop flag; before the loop the
// adaptive GNC start, after it the final chi2 and per-edge weights at the
// base Cauchy width (line 466). Its plain version is the host loop
// models/pose_graph.py::optimize_reference, whose arithmetic it repeats in
// the same precision: residuals, weights and blocks in f32, the edge
// Jacobian in f64 (the small-angle coefficients of Jl^{-1} cancel in f32),
// the factorization in f32. Sums of a step's chi2 run in f64, rounded to
// f32.
//
// What bounds it on this card: not bytes or flops (a solve at M = 32 reads
// ~25 KB of graph and plans, and a step does ~2.6 MFLOP: < 0.1 us at 67
// TFLOP/s) but serial latency: the n = 6M pivots of the factorization, the
// n steps of the backward solve, and every barrier between their phases (a
// cluster barrier past M = 32). The first version paid a barrier per
// column (a cluster barrier and a column copy past M = 32), walked the sum
// plans per element of H (and vertex 0's block held every padded edge
// slot's zeros) and ran the solves in one warp; its own phase stamps put
// 44-92 % of a step in the factorization, 6-27 % in the solves and 12-28 %
// in the assembly, 1-4 % in the edge pass. This design pays a barrier per
// panel of NB columns and keeps a panel's pivots inside one warp:
//
// Layout. One cluster of C CTAs of 512 threads per solve, M <= 128 vertices
// (n = 6M <= 768); one CTA up to M = 32, past that the fewest CTAs (a power
// of two, at most 16: non-portable past 8) that hold at most kMaxColumns
// columns each and fit. The lower triangle of the damped system, with -g
// appended as row n, is cut into P = ceil(n / NB) panels of NB = 16
// columns, dealt block-cyclically: panel p
// lives on CTA p mod C as rows [p NB, n] of NB + 1 floats (the odd row
// stride keeps a warp's column reads free of bank conflicts; the last float
// of a diagonal-block row holds 1 / L_ii). Beside them: in a cluster, a
// copy of the panel being applied; the right-hand side (rank 0's is the
// backward solve's home, every CTA's its copy of delta); two copies of the
// poses; and, on one CTA where they fit, the per-edge blocks
// (dvo_pose_graph_plan; models/pose_graph.py::kernel_plan mirrors it).
// Every CTA keeps the poses and takes every decision; the edges are split
// over the CTAs.
//
// Per LM step:
// - Edge pass, two stages. (A) a thread per edge: residual, chi2, weight
//   and the f64 Jacobian's 18 distinct entries into the edge's slot; (B)
//   seven lanes of a warp per edge, four edges a warp: lane q < 6 forms
//   column q of P = Jj^T (w info) Jj (whence Hii = Hjj = P, Hij = -P), lane
//   6 forms gj (gi = -gj), over the slot. The f64 chain stays one lane per
//   edge: its 3x3 products have no lane-level parallelism that a shuffle
//   would not cost more than it saves, and the edge pass was 1-4 % of a
//   step.
// - Assembly per 6x6 block: the host lists the non-empty blocks of the
//   lower triangle by column vertex, over the unmasked edges (a masked
//   edge's blocks are exact zeros); a warp per (panel, block) sums the
//   block's contributions for the panel's columns, in the host plan's
//   order, loading eight at a time.
// - Right-looking panel Cholesky with a lookahead of one panel. Per panel:
//   one warp factors the NB x NB diagonal block in registers (a lane holds
//   a row; pivots go by __shfl_sync, the square roots wait until the end,
//   no branch); all warps of the owner solve the rows below against it (a
//   row a thread; row n gives the forward substitution's y for free); every
//   CTA applies the panel to its own later panels as a rank-NB update of
//   4x4 register tiles in f32 FMA on the CUDA cores (no tensor cores: TF32
//   breaks SE(3) chains, and f64 would not be the reference's arithmetic).
//   The owner of the next panel updates that panel first and factors it
//   (on one CTA warp 0 factors while the other warps update the rest). One
//   CTA: three barriers a panel. A cluster: one cluster barrier a panel,
//   split into its arrive and wait: the owner publishes the factored panel
//   to global memory (L2) and arrives, every CTA copies the rows it needs
//   from there after the wait (fifteen CTAs pulling one panel over
//   distributed shared memory took ~7 us a panel at M = 128) and reads the
//   owner's pivot flag, so a failed pivot stops every CTA at the same
//   panel.
// - Blocked backward solve, one barrier (a cluster barrier) a panel: the
//   owner sums the block's columns against the x below (a warp a column,
//   fixed shuffle tree), then one warp solves the block in registers. The
//   right-hand side lives on rank 0.
// - exp(delta) a thread a vertex; the trial chi2 a thread an edge.
//
// Determinism. No float atomics: every sum into a slot of g or a block of H
// runs over that slot's contributions in increasing index order, from the
// host-built CSR plans (the order of models/pose_graph.py::_plan), and
// every reduction over edges is a fixed per-thread order, a fixed
// xor-shuffle tree and a fixed warp and rank order. Two launches on the
// same inputs give the same bits.
//
// The device functions this kernel shares with csrc/pose_graph_grid.cu (the
// grid kernel that takes every other CUDA solve) live in
// csrc/pose_graph_common.cuh: the SE(3) helpers, an edge's residual, chi2
// and Jacobian, the edge pass's stages, the dense plan's contributions, the
// LM rules, the CTA reductions and the one-warp diagonal-block Cholesky.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "pose_graph_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVertices = 128;
constexpr int kSingleCta = 32;                   // one CTA up to this M
constexpr int kMaxColumns = 96;                  // columns a CTA of a cluster holds
// Columns per panel. 32 was timed beside it on every graph phase 5f runs:
// as fast at M = 32 and 64 (within 1-3 %), 14 % slower at M = 16 (a
// 32-wide block's pivot chain costs more than the barriers it saves), and
// past ~100 vertices its layout does not fit.
constexpr int NB = 16;
constexpr int LD = NB + 1;                       // a panel row's floats
constexpr int kMaxCluster = 16;                  // non-portable past 8
constexpr size_t kSmemBudget = 230400;           // dynamic bytes a CTA may ask
constexpr int kErrNoActiveCluster = 100001;      // as csrc/linearize.cu's

struct Params {
  const float* poses;   // (M, 4, 4)
  const float* Z;       // (E, 4, 4) measurements
  const float* info;    // (E, 6, 6)
  const float* mask;    // (E,) 1 or 0
  const int* edge_i;    // (E,)
  const int* edge_j;    // (E,)
  const int* v_off;     // (M + 1,) vertex plan: 2E contributions
  const int* v_idx;     // (2E,) [gi of edge e | gj of edge e]
  const int* d_idx;     // (4E + M,) dense plan, coded (contribution())
  const int* b_off;     // (M + 1,) non-empty lower blocks by column vertex
  const int* b_list;    // (K, 4): row vertex a, column vertex b, d_idx range
                        // (16-byte aligned)
  int M, E, nv, iterations, use_robust, gnc_adaptive, C, staged;
  float cauchy_c, gnc_init;
  double cauchy_c64, gnc_decay;
  size_t panel_floats;  // rank 0's panels (the most any CTA holds)
  float* scratch;       // (E, kEdgeFloats) unless staged in shared memory
  float* bcast;         // C > 1: every panel once, rows [p NB, n), for the copies
  float* poses_out;     // (M, 4, 4)
  float* chi2_out;      // ()
  float* weights_out;   // (E,)
  float* stats_out;     // (iterations, 4) per step: chi2, chi2_new, |delta|, accept
  int* steps_out;       // ()
  long long* timing;    // null, or (4 + 7 iterations,): phase stamps
};

// The phase-timing buffer, when the caller passes one: %globaltimer (ns)
// and clock64 at the start ([0], [1]) and the end ([2], [3]) of the
// launch, and per LM step k, clock64 at [4 + 7k + j]: j = 0 the step's
// start, then the ends of its edge pass, the assembly of g and H, the
// factorization, the solves, exp(delta) and the trial chi2 with the
// decisions. Thread 0 of rank 0 writes them, each after a barrier.
__device__ __forceinline__ void stamp(const Params& p, int rank, int slot) {
  if (p.timing != nullptr && rank == 0 && threadIdx.x == 0) p.timing[slot] = clock64();
}

// ------------------------------------------------------------ the layout

// Floats of CTA `rank`'s panels: p = rank, rank + C, ... as rows
// [p NB, n] of LD floats (row n carries the right-hand side).
size_t panel_floats(int n, int C, int rank) {
  size_t s = 0;
  for (int p = rank; p * NB < n; p += C) s += (size_t)(n + 1 - p * NB) * LD;
  return s;
}

// Dynamic shared memory per CTA without the per-edge blocks: rank 0's
// panels (the most any CTA holds), in a cluster the copy of one panel (n
// rows of LD), the right-hand side, two pose copies.
size_t layout_bytes(int M, int C) {
  const int n = 6 * M;
  return 4 * (panel_floats(n, C, 0) + (C > 1 ? (size_t)n * LD : 0) + n +
              32 * (size_t)M);
}

// CTAs per solve: one up to kSingleCta vertices; past that the fewest (a
// power of two from kMinCluster up to kMaxCluster) that hold at most
// kMaxColumns columns each (ceil(P / C) panels) and whose layout fits
// kSmemBudget (every M up to kMaxVertices has one); 0 past the limit.
constexpr int kMinCluster = 4;
static_assert(((6 * (kSingleCta + 1) + NB - 1) / NB + 1) / 2 * NB > kMaxColumns,
              "past kSingleCta two CTAs never hold the panels: clusters start at 4");
int cluster_for(int M) {
  if (M < 1 || M > kMaxVertices) return 0;
  if (M <= kSingleCta) return 1;
  const int P = (6 * M + NB - 1) / NB;
  for (int C = kMinCluster; C <= kMaxCluster; C *= 2)
    if ((P + C - 1) / C * NB <= kMaxColumns && layout_bytes(M, C) <= kSmemBudget) return C;
  return 0;
}

// Global scratch floats: the per-edge blocks, and in a cluster the
// broadcast buffer of every panel (as one CTA would hold them all).
size_t scratch_floats(int M, int E, int C) {
  return (size_t)kEdgeFloats * E + (C > 1 ? panel_floats(6 * M, 1, 0) : 0);
}

// One CTA stages the per-edge blocks in shared memory where they fit: a
// step took 54.5 / 106.1 us at M = 16 / 32 (E = 64) staged and 57.0 /
// 109.2 from global scratch (tests/torch_graph_kernel_ab.py, H100 80GB
// HBM3 at 700 W).
bool staged_for(int M, int E, int C) {
  return C == 1 && layout_bytes(M, 1) + 4 * (size_t)kEdgeFloats * E <= kSmemBudget;
}

size_t shared_bytes(int M, int E, int C) {
  return layout_bytes(M, C) + (staged_for(M, E, C) ? 4 * (size_t)kEdgeFloats * E : 0);
}

// Offset (floats) of local panel q (panel q C + rank) in a CTA's panels.
__device__ __forceinline__ size_t panel_offset(int q, int rank, int C, int n) {
  return (size_t)LD *
         ((size_t)q * (n + 1) - (size_t)NB * ((size_t)C * q * (q - 1) / 2 + (size_t)rank * q));
}

// Cluster-wide reductions: each CTA reduces its share, thread 0 puts it in
// `slot` (one slot per reduction of a step, so no slot is rewritten while
// another CTA may still read it), and after one cluster barrier every thread
// reads the C slots in rank order: every CTA holds the same bits.
__device__ double cluster_sum(double v, double* red, double* slot, int C) {
  v = block_sum<kWarps>(v, red);
  if (C == 1) return v;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  double s = 0.0;
  for (int r = 0; r < C; ++r) s += *cluster.map_shared_rank(slot, r);
  return s;
}

__device__ float cluster_max(float v, float* red, float* slot, int C) {
  v = block_max<kWarps>(v, red);
  if (C == 1) return v;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  float s = *cluster.map_shared_rank(slot, 0);
  for (int r = 1; r < C; ++r) s = nan_max(*cluster.map_shared_rank(slot, r), s);
  return s;
}

// ------------------------------------------------------ the panel Cholesky

// Cluster barrier halves: arrive (release this thread's writes) and wait
// (acquire every thread's), so that a CTA can work between the two.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The rows of a panel below its w x w diagonal block (rows w..rows-1 of A;
// row n, the right-hand side, is among them, so the forward substitution
// L y = b rides along: y is row n of L) against the factored block, a row
// a thread in registers: L21 = A21 L11^{-T}, column by column as the
// column factorization scales and updates them. Only the last panel is
// ragged (w < NB), and then row n is its only row below.
template <bool kRagged>
__device__ void solve_rows(float* A, int w, int rows) {
  for (int i = w + (int)threadIdx.x; i < rows; i += kThreads) {
    float x[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) x[c] = (!kRagged || c < w) ? A[i * LD + c] : 0.f;
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      if (!kRagged || c < w) {
        x[c] *= A[c * LD + NB];
#pragma unroll
        for (int j = c + 1; j < NB; ++j)
          if (!kRagged || j < w) x[j] -= x[c] * A[j * LD + c];
      }
    }
#pragma unroll
    for (int c = 0; c < NB; ++c)
      if (!kRagged || c < w) A[i * LD + c] = x[c];
  }
}

__device__ void solve_panel(float* A, int w, int rows) {
  if (w == NB) solve_rows<false>(A, NB, rows);
  else solve_rows<true>(A, w, rows);
}

// This CTA's local panels q0 <= q < q1 (all right of panel pp), updated by
// pp's columns: A[R][c] -= sum_m L[R][m] L[c][m] for every row R from the
// panel's first column on, row n included, a 4x4 register tile a thread;
// vt: the calling thread's index among the nt threads taking part (rows
// and columns past the end clamped on load and not stored). L: panel pp's rows from k0, row stride NB + 1 (the owner's own
// panel or this CTA's copy of it); only the last panel is ragged, so L has
// NB columns.
__device__ void update_trailing(float* panels, const float* L, int pp, int q0, int q1, int n,
                                int rank, int C, int vt, int nt) {
  const int k0 = pp * NB;
  int total = 0;
  for (int q = q0; q < q1; ++q) {
    const int c0 = (q * C + rank) * NB;
    total += ((n + 4 - c0) / 4) * ((min(NB, n - c0) + 3) / 4);
  }
  for (int t = vt; t < total; t += nt) {
    int q = q0, u = t, c0 = 0, wc = 0, nct = 0;
    for (;; ++q) {
      c0 = (q * C + rank) * NB;
      wc = min(NB, n - c0);
      nct = (wc + 3) / 4;
      const int cnt = ((n + 4 - c0) / 4) * nct;
      if (u < cnt) break;
      u -= cnt;
    }
    const int R0 = c0 + 4 * (u / nct), j0 = 4 * (u % nct);
    float* A = panels + panel_offset(q, rank, C, n);
    const float* La[4];
    const float* Lb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      La[i] = L + (size_t)(min(R0 + i, n) - k0) * LD;
      Lb[i] = L + (size_t)(c0 + min(j0 + i, wc - 1) - k0) * LD;
    }
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = A[(size_t)(min(R0 + i, n) - c0) * LD + min(j0 + j, wc - 1)];
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = La[i][m];
        b[i] = Lb[i][m];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] -= a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (R0 + i <= n && j0 + j < wc) A[(size_t)(R0 + i - c0) * LD + j0 + j] = acc[i][j];
  }
}

// Factors panel pp on its owner: warp 0 its diagonal block, then every
// thread the rows below; `*fail` (shared) set for every thread to read.
__device__ void factor_panel(float* A, int pp, int n, int* fail) {
  const int k0 = pp * NB;
  if (threadIdx.x < 32) {
    const bool f = factor_diag<NB, LD>(A, min(NB, n - k0));
    if (threadIdx.x == 0) *fail = f ? 0 : 1;
  }
  __syncthreads();
  if (!*fail) solve_panel(A, min(NB, n - k0), n + 1 - k0);
  __syncthreads();
}

// Offset (floats) of panel pp's rows in the global broadcast buffer, which
// holds every panel as rows [p NB, n] of NB + 1 floats, in panel order.
__device__ __forceinline__ size_t bcast_offset(int pp, int n) {
  return (size_t)LD * ((size_t)pp * (n + 1) - (size_t)NB * pp * (pp - 1) / 2);
}

// The owner's factored panel pp, rows below its diagonal block (the rows
// other CTAs read), to its place in the global broadcast buffer.
__device__ void publish_panel(const float* A, float* bcast, int pp, int n) {
  const int k0 = pp * NB;
  float* dst = bcast + bcast_offset(pp, n);
  for (int i = NB * LD + (int)threadIdx.x; i < (n + 1 - k0) * LD; i += kThreads) dst[i] = A[i];
}

// -------------------------------------------------------- blocked solves

// Backward block of L^T x = y on the owner of panel pp (A: its rows from
// k0, w columns): the sums
// s_c = sum_{R below} L[R][c] x_R (a warp a column, lanes over R, a fixed
// shuffle tree; x below is final, read from `home` or, copied first, from
// `xloc`), then warp 0 solves the diagonal block in registers (lane j holds
// column j of L11 and y_j - s_j; x_c goes to the lanes above by a shuffle,
// with no branch)
// and writes x to `home`.
__device__ void backward_block(const float* A, float* home, float* xloc, float* sums, int k0,
                               int w, int n, bool copy) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int below = k0 + w;
  const float* x = home;
  if (copy) {
    for (int i = below + (int)threadIdx.x; i < n; i += kThreads) xloc[i] = home[i];
    __syncthreads();
    x = xloc;
  }
  for (int c = warp; c < w; c += kWarps) {
    float s = 0.f;
    for (int R = below + lane; R < n; R += 32) s += A[(size_t)(R - k0) * LD + c] * x[R];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) sums[c] = s;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float col[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) col[c] = (c < w && c > lane) ? A[c * LD + lane] : 0.f;
    const float inv = lane < w ? A[lane * LD + NB] : 0.f;
    float z = lane < w ? home[k0 + lane] - sums[lane] : 0.f;
#pragma unroll
    for (int c = NB - 1; c >= 0; --c) {  // no branch: past w, z, inv, col are 0
      const float xc = __shfl_sync(kFull, z * inv, c);
      z = lane < c ? fmaf(-col[c], xc, z) : lane == c ? xc : z;
    }
    if (lane < w) home[k0 + lane] = z;
  }
}

// ------------------------------------------------------------ the kernel

// One launch = one solve: a cluster of C CTAs (C = 1 up to M = 32). Every
// CTA keeps the poses and takes every decision; the edges are split over
// the CTAs in contiguous ranges, and panel p of the system lives on CTA
// p mod C.
__global__ void __launch_bounds__(kThreads, 1) pose_graph_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ double red[kWarps];
  __shared__ float redf[kWarps];
  __shared__ double s_sum[3];  // this CTA's share: step, trial and final chi2
  __shared__ float s_max;      // this CTA's share of the adaptive start
  __shared__ float s_step;
  __shared__ int s_fail;       // the pivot flag of the panel this CTA factored last
  __shared__ float s_vec[NB];  // the sums of a backward block
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C, rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int M = p.M, E = p.E, n = 6 * M, P = (n + NB - 1) / NB;
  float* panels = smem;                       // this CTA's panels
  float* buf = panels + p.panel_floats;       // C > 1: a copy of the panel applied
  float* rhs = buf + (C > 1 ? (size_t)n * LD : 0);  // y, then delta (rank 0: home)
  float* pose = rhs + n;                      // (M, 16) current poses
  float* trial = pose + 16 * M;
  float* blk = p.staged ? trial + 16 * M : p.scratch;  // (E, 42) per-edge slots
  float* home = C > 1 ? cluster.map_shared_rank(rhs, 0) : rhs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Ec = (E + C - 1) / C, e_lo = min(E, rank * Ec), e_hi = min(E, e_lo + Ec);
  size_t own_floats = 0;
  for (int pp = rank; pp < P; pp += C) own_floats += (size_t)(n + 1 - pp * NB) * LD;
  auto own_panel = [&](int pp) { return panels + panel_offset(pp / C, rank, C, n); };

  for (int q = tid; q < 16 * M; q += kThreads) pose[q] = p.poses[q];
  __syncthreads();
  if (p.timing != nullptr && rank == 0 && tid == 0) {
    p.timing[0] = (long long)global_ns();
    p.timing[1] = clock64();
  }

  // Adaptive GNC start: anneal0 = max(gnc_init, sqrt(max(max chi2, 1)) / c).
  float anneal0 = p.gnc_init;
  if (p.gnc_adaptive) {
    float mx = -INFINITY;
    for (int e = e_lo + tid; e < e_hi; e += kThreads) {
      float r[6];
      mx = nan_max(mx, edge_chi2(pose + 16 * p.edge_i[e], pose + 16 * p.edge_j[e],
                                 p.Z + 16 * e, p.info + 36 * e, r) * p.mask[e]);
    }
    mx = cluster_max(mx, redf, &s_max, C);
    anneal0 = adaptive_anneal0(mx, p.cauchy_c, anneal0);
  }

  float lam = 1e-6f;
  int k = 0;
  while (k < p.iterations) {
    const float anneal = anneal_at(anneal0, p.gnc_decay, k);
    const float c_eff = p.cauchy_c * anneal;
    const float c2 = c_eff * c_eff;
    stamp(p, rank, 4 + 7 * k);

    // Edge pass: stage A a thread an edge, stage B seven lanes an edge; the
    // barriers of the sum publish the slots to every CTA.
    double part = 0.0;
    for (int e = e_lo + tid; e < e_hi; e += kThreads)
      part += edge_stage_a(p, pose, e, c2, blk + (size_t)kEdgeFloats * e);
    __syncthreads();
    for (int g = warp; 4 * g < e_hi - e_lo; g += kWarps) {
      const int e = e_lo + 4 * g + (lane >> 3), q = lane & 7;
      edge_stage_b(p, e, q, e < e_hi && q < 7, blk + (size_t)kEdgeFloats * e);
    }
    const float chi2 = (float)cluster_sum(part, red, &s_sum[0], C);
    stamp(p, rank, 4 + 7 * k + 1);

    // This CTA's panels: the damped lower triangle H + lam diag(H) +
    // jitter I, a warp per (panel, block) item, a lane per element in the
    // panel's columns and the lower triangle (a diagonal block's 21 in one
    // pass); row n: -g, a thread per column.
    for (size_t i = tid; i < own_floats; i += kThreads) panels[i] = 0.f;
    __syncthreads();
    for (int pp = rank; pp < P; pp += C) {
      const int c0 = pp * NB;
      float* A = own_panel(pp) + (size_t)(n - c0) * LD;
      for (int q = c0 + tid; q < min(n, c0 + NB); q += kThreads) {
        const int v = q / 6, r = q - 6 * v;
        A[q - c0] = -vertex_gradient(p, blk, v, r);
      }
    }
    {
      int items = 0;
      for (int pp = rank; pp < P; pp += C)
        items += __ldg(p.b_off + (min(n, pp * NB + NB) - 1) / 6 + 1) -
                 __ldg(p.b_off + pp * NB / 6);
      for (int t = warp; t < items; t += kWarps) {
        int pp = rank, u = t;
        for (;; pp += C) {
          const int lo = __ldg(p.b_off + pp * NB / 6);
          const int cnt = __ldg(p.b_off + (min(n, pp * NB + NB) - 1) / 6 + 1) - lo;
          if (u < cnt) {
            u += lo;
            break;
          }
          u -= cnt;
        }
        const int c0 = pp * NB, c1 = min(n, c0 + NB);
        const int4 it = __ldg(reinterpret_cast<const int4*>(p.b_list) + u);
        const int a = it.x, b = it.y;
        float* A = own_panel(pp);
        for (int el = lane; el < (a == b ? 21 : 36); el += 32) {
          int r, c;
          if (a == b) {  // the lower triangle's el-th element, row by row
            r = 0;
            while ((r + 1) * (r + 2) / 2 <= el) ++r;
            c = el - r * (r + 1) / 2;
          } else {
            r = el / 6;
            c = el - 6 * r;
          }
          const int R = 6 * a + r, Cg = 6 * b + c;
          if (Cg < c0 || Cg >= c1) continue;
          const float h = block_element(p, blk, p.d_idx + it.z, it.w - it.z, r, c);
          A[(size_t)(R - c0) * LD + Cg - c0] = R == Cg ? (h + lam * h) + kJitter : h;
        }
      }
    }
    __syncthreads();
    stamp(p, rank, 4 + 7 * k + 2);

    // The panel factorization, right-looking with a lookahead of one
    // panel: the owner of panel pp + 1 first applies panel pp to it and
    // factors it, then applies pp to the rest of its panels (on one CTA
    // warp 0 factors while the other warps update). In a cluster a
    // factored panel goes to global memory (L2) once and every CTA copies
    // the rows it needs from there, between one cluster barrier's arrive
    // and its wait per panel; a failed pivot stops every CTA at the same
    // panel (each reads the owner's flag after the panel's barrier).
    bool ok = true;
    if (rank == 0) {
      factor_panel(panels, 0, n, &s_fail);
      if (C > 1) publish_panel(panels, p.bcast, 0, n);
    }
    if (C > 1) cluster_arrive();
    for (int pp = 0; pp < P; ++pp) {
      const int k0 = pp * NB, owner = pp % C, nx = pp + 1;
      if (C > 1) cluster_wait(); else __syncthreads();
      if (C > 1 ? *cluster.map_shared_rank(&s_fail, owner) : s_fail) {
        ok = false;
        break;
      }
      const int q0 = rank > pp ? 0 : (pp - rank) / C + 1;  // this CTA's panels after pp
      const int q1 = (P - 1 - rank) / C + 1;
      const int first = (q0 * C + rank) * NB;  // their first column
      const float* L = own_panel(pp);
      if (rank != owner && first < n) {  // rows [first, n] of pp, from L2
        const float* src = p.bcast + bcast_offset(pp, n) + (size_t)(first - k0) * LD;
        float* dst = buf + (size_t)(first - k0) * LD;
        const int count = (n + 1 - first) * LD;
        for (int i = tid; i < count; i += 8 * kThreads) {
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = i + j * kThreads < count ? __ldcg(src + i + j * kThreads) : 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (i + j * kThreads < count) dst[i + j * kThreads] = v[j];
        }
        __syncthreads();
        L = buf;
      }
      if (nx < P && nx % C == rank) {  // the lookahead: panel nx is q0
        update_trailing(panels, L, pp, q0, q0 + 1, n, rank, C, tid, kThreads);
        __syncthreads();
        float* A = own_panel(nx);
        if (C == 1) {
          // Warp 0 has its scheduler to itself (warps 4, 8 and 12, which
          // share it, wait): the pivot chain is latency, and the update's
          // warps would take its instruction slots.
          if (warp == 0) {
            const bool f = factor_diag<NB, LD>(A, min(NB, n - nx * NB));
            if (lane == 0) s_fail = f ? 0 : 1;
          } else if (warp % 4) {
            update_trailing(panels, L, pp, q0 + 1, q1, n, rank, C,
                            (warp - warp / 4 - 1) * 32 + lane, kThreads / 4 * 3);
          }
          __syncthreads();
          if (!s_fail) solve_panel(A, min(NB, n - nx * NB), n + 1 - nx * NB);
        } else {
          factor_panel(A, nx, n, &s_fail);
          publish_panel(A, p.bcast, nx, n);
          cluster_arrive();
          update_trailing(panels, L, pp, q0 + 1, q1, n, rank, C, tid, kThreads);
        }
      } else {
        if (C > 1 && nx < P) cluster_arrive();
        update_trailing(panels, L, pp, q0, q1, n, rank, C, tid, kThreads);
      }
      __syncthreads();
    }
    __syncthreads();
    stamp(p, rank, 4 + 7 * k + 3);

    // y = L^{-1} (-g) is row n of the factored panels: each CTA puts its
    // columns' y at home on rank 0; then the blocked backward solve on the
    // panels' owners. A failed factorization or a non-finite step gives
    // delta = 0.
    if (ok) {
      for (int pp = rank; pp < P; pp += C) {
        const int c0 = pp * NB;
        const float* A = own_panel(pp) + (size_t)(n - c0) * LD;
        for (int q = c0 + tid; q < min(n, c0 + NB); q += kThreads) home[q] = A[q - c0];
      }
      if (C > 1) cluster.sync(); else __syncthreads();
      for (int pp = P - 1; pp >= 0; --pp) {
        if (pp % C == rank)
          backward_block(own_panel(pp), home, rhs, s_vec, pp * NB, min(NB, n - pp * NB), n,
                         rank != 0);
        if (C > 1) cluster.sync(); else __syncthreads();
      }
      if (rank != 0)
        for (int i = tid; i < n; i += kThreads) rhs[i] = home[i];
      if (C > 1) cluster.sync();  // rank 0's delta is read before rank 0 zeroes it
    }
    __syncthreads();
    if (warp == 0) {
      bool bad = !ok;
      for (int i = lane; i < n; i += 32) bad |= !isfinite(rhs[i]);
      bad = __any_sync(kFull, bad);
      double ss = 0.0;
      for (int i = lane; i < n; i += 32) {
        if (bad) rhs[i] = 0.f;
        ss += (double)rhs[i] * rhs[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(kFull, ss, o);
      if (lane == 0) s_step = (float)sqrt(ss);
    }
    __syncthreads();
    stamp(p, rank, 4 + 7 * k + 4);

    // exp(delta) on the active vertices (every CTA, the same bits).
    if (tid < M) {
      float* T = trial + 16 * tid;
      const float* T0 = pose + 16 * tid;
      if (tid < p.nv) {
        float D[16];
        exp_se3(rhs + 6 * tid, D);
        mm4(D, T0, T);
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q) T[q] = T0[q];
      }
    }
    __syncthreads();
    stamp(p, rank, 4 + 7 * k + 5);

    // chi2 at the trial poses (residuals only).
    part = 0.0;
    for (int e = e_lo + tid; e < e_hi; e += kThreads) {
      float r[6];
      const float c = edge_chi2(trial + 16 * p.edge_i[e], trial + 16 * p.edge_j[e],
                                p.Z + 16 * e, p.info + 36 * e, r);
      const float w_e = robust_weight(p, c, c2) * p.mask[e];
      part += (double)(w_e * c);
    }
    const float chi2_new = (float)cluster_sum(part, red, &s_sum[1], C);

    const LmStep lm = lm_step(chi2, chi2_new, lam, s_step, anneal);
    const bool accept = lm.accept, done = lm.done;
    if (accept)
      for (int q = tid; q < 16 * M; q += kThreads) pose[q] = trial[q];
    lam = lm.lam;
    if (rank == 0 && tid == 0) {
      float* st = p.stats_out + 4 * k;
      st[0] = chi2;
      st[1] = chi2_new;
      st[2] = s_step;
      st[3] = accept ? 1.f : 0.f;
    }
    __syncthreads();
    stamp(p, rank, 4 + 7 * k + 6);
    ++k;
    if (done) break;
  }

  // Final chi2 and per-edge weights at the base Cauchy width.
  const float c2 = (float)(p.cauchy_c64 * p.cauchy_c64);
  double part = 0.0;
  for (int e = e_lo + tid; e < e_hi; e += kThreads) {
    float r[6];
    const float c = edge_chi2(pose + 16 * p.edge_i[e], pose + 16 * p.edge_j[e],
                              p.Z + 16 * e, p.info + 36 * e, r);
    const float w_e = robust_weight(p, c, c2) * p.mask[e];
    p.weights_out[e] = w_e;
    part += (double)(w_e * c);
  }
  const float chi2 = (float)cluster_sum(part, red, &s_sum[2], C);
  if (rank == 0) {
    for (int q = tid; q < 16 * M; q += kThreads) p.poses_out[q] = pose[q];
    for (int q = 4 * k + tid; q < 4 * p.iterations; q += kThreads) p.stats_out[q] = 0.f;
    if (tid == 0) {
      *p.chi2_out = chi2;
      *p.steps_out = k;
      if (p.timing != nullptr) {
        p.timing[2] = (long long)global_ns();
        p.timing[3] = clock64();
      }
    }
  }
  if (C > 1) cluster.sync();  // no CTA leaves while another may read its share
}

// Per device, once: the kernel's dynamic shared memory and non-portable
// cluster attributes; per (device, C, bytes), once:
// cudaOccupancyMaxActiveClusters (0 means the launch could never run).
struct Prepared {
  int dev, C;
  size_t dyn;
};
std::mutex g_mutex;
std::vector<Prepared> g_prepared;

int prepare(int dev, cudaLaunchConfig_t* cfg, int C) {
  std::lock_guard<std::mutex> lock(g_mutex);
  bool attributes = false;
  for (const Prepared& q : g_prepared) {
    if (q.dev != dev) continue;
    attributes = true;
    if (q.C == C && q.dyn == cfg->dynamicSmemBytes) return 0;
  }
  cudaError_t e = cudaSuccess;
  if (!attributes) {
    e = cudaFuncSetAttribute(pose_graph_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBudget);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(pose_graph_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  int clusters = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&clusters, pose_graph_kernel, cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return kErrNoActiveCluster;
  g_prepared.push_back({dev, C, cfg->dynamicSmemBytes});
  return 0;
}

}  // namespace

// What a solve over M vertices and E edge slots uses: out[0] the largest M
// the kernel takes, out[1] CTAs per cluster (0 past the limit), out[2]
// threads per CTA, out[3] dynamic shared memory bytes per CTA (0 past the
// limit), out[4] the panel width, out[5] 1 where the per-edge blocks are
// staged in shared memory, out[6] the global scratch floats the launch
// needs. Returns 0.
extern "C" int dvo_pose_graph_plan(int M, int E, int* out) {
  const int C = cluster_for(M);
  out[0] = kMaxVertices;
  out[1] = C;
  out[2] = kThreads;
  out[3] = C ? (int)shared_bytes(M, E, C) : 0;
  out[4] = NB;
  out[5] = C ? (int)staged_for(M, E, C) : 0;
  out[6] = C ? (int)scratch_floats(M, E, C) : 0;
  return 0;
}

// One dense LM solve (models/pose_graph.py::optimize_reference's
// semantics) in one launch of one cluster on `stream`, no host sync.
// Inputs as Params; scratch: the plan's out[6] floats; timing: null, or
// 4 + 7 iterations int64 (phase stamps).
// Outputs: poses_out (M, 4, 4), chi2_out, weights_out (E,), stats_out
// (iterations, 4: each step's chi2, trial chi2, step norm and accept flag,
// zero past the last step) and steps_out (the LM steps run). Returns a
// CUDA error code (0: launched).
extern "C" int dvo_pose_graph(
    const float* poses, const float* Z, const float* info, const float* mask,
    const int* edge_i, const int* edge_j, const int* v_off, const int* v_idx,
    const int* d_idx, const int* b_off, const int* b_list, int M, int E, int nv,
    int iterations, int use_robust, double cauchy_c, double gnc_init, double gnc_decay,
    int gnc_adaptive, float* scratch, float* poses_out, float* chi2_out,
    float* weights_out, float* stats_out, int* steps_out, long long* timing, void* stream) {
  const int C = cluster_for(M);
  if (C == 0 || E < 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.poses = poses; p.Z = Z; p.info = info; p.mask = mask;
  p.edge_i = edge_i; p.edge_j = edge_j; p.v_off = v_off; p.v_idx = v_idx;
  p.d_idx = d_idx; p.b_off = b_off; p.b_list = b_list;
  p.M = M; p.E = E; p.nv = nv; p.iterations = iterations; p.C = C;
  p.staged = staged_for(M, E, C) ? 1 : 0;
  p.use_robust = use_robust; p.gnc_adaptive = gnc_adaptive;
  p.cauchy_c = (float)cauchy_c; p.gnc_init = (float)gnc_init;
  p.cauchy_c64 = cauchy_c; p.gnc_decay = gnc_decay;
  p.panel_floats = panel_floats(6 * M, C, 0);
  p.scratch = scratch;
  p.bcast = C > 1 ? scratch + (size_t)kEdgeFloats * E : nullptr;
  p.poses_out = poses_out; p.chi2_out = chi2_out;
  p.weights_out = weights_out; p.stats_out = stats_out; p.steps_out = steps_out;
  p.timing = timing;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = shared_bytes(M, E, C);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int prepared = prepare(dev, &cfg, C);
  if (prepared) return prepared;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, pose_graph_kernel, p);
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}
