// Levenberg-Marquardt over a padded SE(3) pose graph for Hopper (sm_90a):
// one cooperative launch of one CTA a streaming multiprocessor runs one
// whole models/pose_graph.py::optimize call, every LM step on the card, for
// any vertex count and for both solvers: the route of every CUDA solve that
// csrc/pose_graph.cu (a dense solve of at most 128 vertices in one cluster)
// does not take.
//
// What it replaces. There is no Pallas kernel here: the JAX package runs
// dvo_slam_tpu/models/pose_graph.py::optimize as one jax.jit whose
// lax.while_loop over the LM steps (line 463, body 419-455) XLA compiles
// into one device program, with the block-Jacobi CG's own while_loop
// (_solve_cg, lines 260-311, loop at 307) inside it. This kernel stands in
// for both loops: the adaptive GNC start, the anneal, the per-edge blocks,
// then either the dense damped 6M x 6M system, factored and solved, or the
// preconditioned CG over the per-edge blocks, the non-finite step zeroed,
// exp(delta) on the active vertices, the trial chi2, the accept test, the
// lambda clip and the stop flag; after the loop the final chi2 and weights
// at the base Cauchy width. Its plain version is the host loop
// models/pose_graph.py::optimize_reference (cuSOLVER's Cholesky, torch's
// CG), which reads its stop flag back once an LM step and its CG stop test
// once a CG iteration; this kernel reads nothing back. The device
// functions it shares with csrc/pose_graph.cu live in
// csrc/pose_graph_common.cuh, so an edge's residual, chi2, Jacobian and
// blocks, the plans' sums and the LM rules are the same instructions on
// both kernels' routes.
//
// What bounds it on this card. Dense: the factorization, n^3 / 3 f32
// operations a step at n = 6M (1.2 / 9.7 / 77 / 1 208 GFLOP at M = 256 /
// 512 / 1 024 / 2 560: 18 us / 0.14 / 1.15 / 18 ms at the card's 67 TFLOP/s
// f32 rate, in f32 FMA on the CUDA cores: TF32 would break SE(3) chains and
// the JAX package factors the f32 system); the lower triangle is 4.7 / 18.9
// / 75.5 / 472 MB, L2-resident up to M = 512. Below ~1 000 vertices the
// serial chain bounds it instead: a grid barrier (~1-2 us) and a diagonal
// block's 32 pivots on one warp per 32 columns, twice, and the backward
// solve's barrier per 32 columns. CG: an iteration reads ~108 f32 an edge
// and 36 a vertex (1.6 MB on the 2 560-vertex ring of chip_smoke.py, L2
// resident), so its floor is its two grid barriers, not bytes.
//
// Design. One CTA of 256 threads a streaming multiprocessor (G CTAs, the
// caller's count, all co-resident: the launch is cooperative and refused
// otherwise); a grid barrier of our own (a counter and a generation word,
// release / acquire at gpu scope), so the build needs no relocatable device
// code. Every CTA keeps the scalars of the loop (chi2, lambda, the anneal,
// the CG scalars) and takes every decision from the same bits: each sum over
// the grid is a fixed-order sum of per-CTA partials in fixed slots, read by
// every CTA after a barrier. The edges are split over the CTAs in
// contiguous ranges and the per-edge blocks (edge_stage_a / _b, as on the
// cluster kernel) go to global scratch; the poses live in global memory as
// two buffers, the current and the trial, swapped on accept.
// - Dense. The damped lower triangle, -g appended as one more row of tiles
//   (its row 0; rows past it zero), is stored in 32 x 32 tiles, tile (I, J)
//   with J <= I at (I (I + 1) / 2 + J) tiles, padded to a multiple of 32
//   with identity rows. Assembly: a CTA a tile zeroes it and sums its
//   elements over the host's block list (the plan's order, no float
//   atomics). Right-looking blocked Cholesky, per column of tiles k: every
//   CTA factors the diagonal tile in one warp in registers (the same
//   branch-free routine as the cluster kernel's, so every CTA reads the same
//   pivot flag), a warp a tile solves the rows below (a lane a row; the -g
//   row gives y, the forward substitution); a grid barrier; the trailing
//   update in units of 4 x 4 tiles (128 x 128), each thread an 8 x 8
//   register tile over the column's 32 values staged in shared memory (the
//   products summed from zero and subtracted from C once, as a GEMM does);
//   a grid barrier. The backward solve: per tile column from the last, every
//   CTA solves x_k in one warp, and the owner of each earlier y_J
//   subtracts L_kJ^T x_k; a grid barrier.
// - CG (any M): a thread a vertex builds its damped block-diagonal 6 x 6,
//   factors and inverts it (the preconditioner), sums its gradient over the
//   vertex plan and starts r = b = -g, z = p = M^-1 r. Per iteration: the
//   matvec a thread a vertex over its incident edges in the vertex plan's
//   order (Hii = Hjj = P, Hij = -P from the edge slots), p' = z + beta p
//   formed on the fly for the neighbours (two p buffers, so no barrier for
//   the update), p.Ap; a barrier; x, r, z and r.z, r.r; a barrier. The
//   test k < 4M and rr > tol^2 |b|^2 runs on every CTA from the same bits:
//   two grid barriers an iteration and nothing on the host.
//
// Determinism. No float atomics: every sum into a slot of g, of H or of a
// matvec runs over the host plan's contributions in increasing index order,
// every reduction over edges or vertices is a fixed per-thread order, a
// fixed shuffle tree, a fixed warp order and a fixed CTA order. Two launches
// on the same inputs and CTA count give the same bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "pose_graph_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int T = 32;                    // tile width
constexpr int TLD = T + 1;               // the diagonal tile's row stride in shared memory
constexpr int kUnit = 4;                 // the trailing update's unit, in tiles a side
constexpr int kUnitRows = kUnit * T;     // 128
constexpr int kStageLD = kUnitRows + 4;  // a staged column row's floats (16-B aligned)
constexpr int kErrNotCoResident = 100002;  // as csrc/linearize.cu's dvo_error_string
constexpr int kDense = 0, kCg = 1;
// Reduction slots: G doubles each.
constexpr int kSlotMax = 0, kSlotChi2 = 1, kSlotTrial = 2, kSlotFinal = 3, kSlotPAp = 4,
              kSlotRz = 5, kSlotRr = 6, kSlotBb = 7, kSlots = 8;
// Dynamic shared memory: the diagonal tile and the two staged columns.
constexpr size_t kSmemFloats = (size_t)T * TLD + 2 * (size_t)T * kStageLD;

struct Layout {  // offsets in floats into the scratch buffer
  size_t red, blk, pose_a, pose_b, tiles, invd, x, minv, damp, r, z, p0, p1, ap, total;
  int Pt;        // dense: tiles a side (ceil(6M / 32)); 0 for CG
};

size_t up4(size_t x) { return (x + 3) & ~(size_t)3; }

// Tiles of the dense layout: the lower triangle of Pt x Pt tiles and the
// right-hand side's row of Pt tiles.
__host__ __device__ size_t dense_tiles(int Pt) { return (size_t)Pt * (Pt + 1) / 2 + Pt; }

Layout layout(int M, int E, int solver, int G) {
  Layout L = {};
  size_t at = 0;
  auto take = [&](size_t n) { const size_t o = at; at = up4(at + n); return o; };
  L.red = take(2 * (size_t)kSlots * G);
  L.blk = take((size_t)kEdgeFloats * E);
  L.pose_a = take(16 * (size_t)M);
  L.pose_b = take(16 * (size_t)M);
  if (solver == kDense) {
    L.Pt = (6 * M + T - 1) / T;
    L.tiles = take(dense_tiles(L.Pt) * T * T);
    L.invd = take((size_t)T * L.Pt);
    L.x = take((size_t)T * L.Pt);
  } else {
    L.minv = take(36 * (size_t)M);
    L.damp = take(6 * (size_t)M);
    L.x = take(6 * (size_t)M);
    L.r = take(6 * (size_t)M);
    L.z = take(6 * (size_t)M);
    L.p0 = take(6 * (size_t)M);
    L.p1 = take(6 * (size_t)M);
    L.ap = take(6 * (size_t)M);
  }
  L.total = at;
  return L;
}

struct GridParams {
  const float* poses;   // (M, 4, 4)
  const float* Z;       // (E, 4, 4) measurements
  const float* info;    // (E, 6, 6)
  const float* mask;    // (E,) 1 or 0
  const int* edge_i;    // (E,)
  const int* edge_j;    // (E,)
  const int* v_off;     // (M + 1,) vertex plan: 2E contributions
  const int* v_idx;     // [gi of edge e | gj of edge e]
  const int* d_idx;     // dense: the dense plan, coded (contribution())
  const int* b_off;     // dense: (M + 1,) non-empty lower blocks by column vertex
  const int* b_list;    // dense: (K, 4) row vertex a, column vertex b, d_idx range
  int M, E, nv, iterations, use_robust, gnc_adaptive, solver, G, n, Pt;
  float cauchy_c, gnc_init;
  double cauchy_c64, gnc_decay;
  double* red;          // kSlots x G per-CTA partials
  float* blk;           // (E, kEdgeFloats) per-edge slots
  float* pose_a;        // (M, 16): the current poses, then swapped with
  float* pose_b;        // (M, 16): the trial poses
  float* tiles;         // dense: the tiles, rows 0..Pt (Pt: -g, then y)
  float* invd;          // dense: (32 Pt,) 1 / L_ii
  float* x;             // the step (32 Pt dense, 6M CG)
  float *minv, *damp, *r, *z, *p0, *p1, *ap;  // CG, per vertex: 36, 6, 6 ...
  unsigned* bar;        // the grid barrier: arrivals, generation (zeroed)
  float* poses_out;     // (M, 4, 4)
  float* chi2_out;      // ()
  float* weights_out;   // (E,)
  float* stats_out;     // (iterations, 4) per step: chi2, chi2_new, |delta|, accept
  int* steps_out;       // ()
  long long* timing;    // null, or (4 + 8 iterations,): phase stamps, CG iterations
};

// ------------------------------------------------------------ the grid

__device__ __forceinline__ unsigned ld_acquire(const unsigned* a) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(a) : "memory");
  return v;
}

__device__ __forceinline__ unsigned add_acq_rel(unsigned* a, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(a), "r"(v) : "memory");
  return old;
}

__device__ __forceinline__ void st_release(unsigned* a, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" :: "l"(a), "r"(v) : "memory");
}

// Every CTA of the (co-resident) grid waits here until all have arrived;
// the writes of every thread before it are visible to every thread after
// it. Thread 0 reads the generation before it arrives (it cannot move until
// this CTA has arrived), the last arrival resets the count and releases the
// next generation. A wait past 2^35 cycles (~20 s; no phase of a solve
// comes near) traps: a launch whose CTAs took different branches fails
// with an error instead of holding the card.
__device__ void grid_sync(unsigned* bar, unsigned G) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    __threadfence();
    if (add_acq_rel(bar, 1u) == G - 1) {
      bar[0] = 0u;
      st_release(bar + 1, gen + 1);
    } else {
      const long long t0 = clock64();
      while (ld_acquire(bar + 1) == gen)
        if (clock64() - t0 > (1LL << 35)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// Thread 0 of CTA 0 writes clock64 to timing[slot] (after a barrier).
__device__ __forceinline__ void stamp(const GridParams& p, int slot) {
  if (p.timing != nullptr && blockIdx.x == 0 && threadIdx.x == 0) p.timing[slot] = clock64();
}

// The sum of slot array `s`'s G partials in a fixed order, on every
// thread of every CTA alike: lane l of warp 0 sums slots l, l + 32, ... in
// order, then a fixed xor-shuffle tree; `bc` (shared) passes it on.
__device__ double grid_sum(const GridParams& p, int s, double* bc) {
  if (threadIdx.x < 32) {
    const double* slots = p.red + (size_t)s * p.G;
    double v = 0.0;
    for (int c = threadIdx.x; c < p.G; c += 32) v += __ldcg(slots + c);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    if (threadIdx.x == 0) *bc = v;
  }
  __syncthreads();
  const double v = *bc;
  __syncthreads();
  return v;
}

// This CTA's partial of slot array `s` (thread 0 writes it).
__device__ __forceinline__ void put_slot(const GridParams& p, int s, double v) {
  if (threadIdx.x == 0) p.red[(size_t)s * p.G + blockIdx.x] = v;
}

// ------------------------------------------------------------ the edges

// Edge pass of this CTA's edges [e_lo, e_hi) at poses `pose`, robust at c2:
// stage A a thread an edge, stage B seven lanes of a warp an edge, four
// edges a warp (as the cluster kernel's). Returns this CTA's share of the
// robust chi2 (on every thread).
__device__ double edge_pass(const GridParams& p, const float* pose, int e_lo, int e_hi,
                            float c2, double* red) {
  double part = 0.0;
  for (int e = e_lo + (int)threadIdx.x; e < e_hi; e += kThreads)
    part += edge_stage_a(p, pose, e, c2, p.blk + (size_t)kEdgeFloats * e);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int g = warp; 4 * g < e_hi - e_lo; g += kWarps) {
    const int e = e_lo + 4 * g + (lane >> 3), q = lane & 7;
    edge_stage_b(p, e, q, e < e_hi && q < 7, p.blk + (size_t)kEdgeFloats * e);
  }
  return block_sum<kWarps>(part, red);
}

// This CTA's share of the robust chi2 at poses `pose` (residuals only);
// with `weights`, each edge's weight is written there too.
__device__ double chi2_pass(const GridParams& p, const float* pose, int e_lo, int e_hi,
                            float c2, float* weights, double* red) {
  double part = 0.0;
  for (int e = e_lo + (int)threadIdx.x; e < e_hi; e += kThreads) {
    float r[6];
    const float c = edge_chi2(pose + 16 * p.edge_i[e], pose + 16 * p.edge_j[e], p.Z + 16 * e,
                              p.info + 36 * e, r);
    const float w_e = robust_weight(p, c, c2) * p.mask[e];
    if (weights != nullptr) weights[e] = w_e;
    part += (double)(w_e * c);
  }
  return block_sum<kWarps>(part, red);
}

// ------------------------------------------------------------ the dense system

__device__ __forceinline__ float* tile_at(const GridParams& p, int I, int J) {
  return p.tiles + ((size_t)I * (I + 1) / 2 + J) * (T * T);
}

// Tile (I, J) of the damped system (I < Pt) or of the right-hand side's
// row (I == Pt: row 0 is -g, the rest zero), written by this CTA alone:
// zeroed (identity on padded rows), then every non-empty 6 x 6 block of the
// lower triangle that meets it (the host's block list, by column vertex
// then row vertex) summed in the plan's order, a warp a block.
__device__ void assemble_tile(const GridParams& p, int I, int J, float lam) {
  float* A = tile_at(p, I, J);
  const int n = p.n, tid = threadIdx.x;
  for (int q = tid; q < T * T; q += kThreads) {
    const int R = I * T + q / T, Cg = J * T + q % T;
    A[q] = (I < p.Pt && R == Cg && R >= n) ? 1.f : 0.f;
  }
  __syncthreads();
  if (I == p.Pt) {  // -g for columns [32 J, 32 J + 32)
    if (tid < T && J * T + tid < n) {
      const int q = J * T + tid, v = q / 6;
      A[tid] = -vertex_gradient(p, p.blk, v, q - 6 * v);
    }
    return;
  }
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = I * T, r1 = min(n, r0 + T), c0 = J * T, c1 = min(n, c0 + T);
  if (r0 >= n || c0 >= n) return;
  // Blocks (a, b) with column vertex b in [c0 / 6, (c1 - 1) / 6] and row
  // vertex a in [r0 / 6, (r1 - 1) / 6], a >= b: a warp a block.
  const int a_lo = r0 / 6, a_hi = (r1 - 1) / 6, b_lo = c0 / 6, b_hi = (c1 - 1) / 6;
  int item = 0;
  for (int b = b_lo; b <= b_hi; ++b) {
    int lo = __ldg(p.b_off + b), hi = __ldg(p.b_off + b + 1);
    // The first block of column b whose row vertex is >= max(a_lo, b).
    const int a_min = max(a_lo, b);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(p.b_list + 4 * mid) < a_min) lo = mid + 1;
      else hi = mid;
    }
    for (int u = lo; u < __ldg(p.b_off + b + 1); ++u) {
      const int4 it = __ldg(reinterpret_cast<const int4*>(p.b_list) + u);
      if (it.x > a_hi) break;
      if (item++ % kWarps != warp) continue;
      const int a = it.x;
      for (int el = lane; el < 36; el += 32) {
        const int r = el / 6, c = el - 6 * (el / 6);
        const int R = 6 * a + r, Cg = 6 * b + c;
        if (R < r0 || R >= r1 || Cg < c0 || Cg >= c1 || Cg > R) continue;
        const float h = block_element(p, p.blk, p.d_idx + it.z, it.w - it.z, r, c);
        A[(R - r0) * T + Cg - c0] = R == Cg ? (h + lam * h) + kJitter : h;
      }
    }
  }
}

// Solves the 32 rows of tile A (rows below the diagonal tile, L_kk in `Ld`
// with 1 / L_ii in each row's last float) against L_kk^T, a lane a row in
// registers: L_Ik = A_Ik L_kk^-T, column by column (as the cluster kernel's
// solve_rows). `rows`: the rows to solve (1 for the right-hand side's tile).
__device__ void solve_tile_rows(float* A, const float* Ld, int rows) {
  const int lane = threadIdx.x & 31;
  if (lane >= rows) return;
  float x[T];
  float4* row = reinterpret_cast<float4*>(A + lane * T);
#pragma unroll
  for (int q = 0; q < T / 4; ++q) {
    const float4 v = __ldcg(row + q);
    x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < T; ++c) {
    x[c] *= Ld[c * TLD + T];
#pragma unroll
    for (int j = c + 1; j < T; ++j) x[j] -= x[c] * Ld[j * TLD + c];
  }
#pragma unroll
  for (int q = 0; q < T / 4; ++q)
    row[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// Stages rows [32 I0, 32 (I0 + 4)) of tile column k (tiles (I, k), I <=
// I1; rows past I1 zero) into S as S[m][row] (column value m of a row).
__device__ void stage_column(const GridParams& p, float* S, int I0, int I1, int k) {
  for (int q = threadIdx.x; q < kUnitRows * T / 4; q += kThreads) {
    const int row = q / (T / 4), m = 4 * (q % (T / 4)), I = I0 + row / T;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (I <= I1) v = __ldcg(reinterpret_cast<const float4*>(tile_at(p, I, k) + (row % T) * T + m));
    S[m * kStageLD + row] = v.x;
    S[(m + 1) * kStageLD + row] = v.y;
    S[(m + 2) * kStageLD + row] = v.z;
    S[(m + 3) * kStageLD + row] = v.w;
  }
}

// The trailing update of tile column k: A_IJ -= L_Ik L_Jk^T for k < J <= I,
// I <= Pt (the right-hand side's row included), J < Pt; units of 4 x 4
// tiles dealt round-robin over the CTAs, each thread an 8 x 8 register tile
// (inside one tile) over the 32 staged values, f32 FMA.
__device__ void trailing_update(const GridParams& p, int k, float* As, float* Bs) {
  const int Pt = p.Pt, rows = Pt - k, cols = Pt - k - 1;
  if (cols <= 0) return;
  const int Ur = (rows + kUnit - 1) / kUnit, Uc = (cols + kUnit - 1) / kUnit;
  const int units = Ur * (Ur + 1) / 2;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int w = blockIdx.x; w < units; w += p.G) {
    int u = (int)((sqrtf(8.f * w + 1.f) - 1.f) * 0.5f);
    while (u * (u + 1) / 2 > w) --u;
    while ((u + 1) * (u + 2) / 2 <= w) ++u;
    const int v = w - u * (u + 1) / 2;
    if (v >= Uc) continue;
    const int I0 = k + 1 + kUnit * u, J0 = k + 1 + kUnit * v;
    __syncthreads();  // the previous unit's reads of As / Bs are done
    stage_column(p, As, I0, Pt, k);
    stage_column(p, Bs, J0, Pt - 1, k);
    __syncthreads();
    const int I = I0 + ty / 4, J = J0 + tx / 4;
    if (I > Pt || J > Pt - 1 || J > I) continue;
    float* C = tile_at(p, I, J) + (ty % 4) * 8 * T + (tx % 4) * 8;
    // The 32 products summed from zero, then subtracted from C once (as a
    // GEMM does): a chain started at C rounds every product at C's
    // magnitude, and that put the first step of the 1 024- and 2 560-vertex
    // rings 3e-3 and 8e-3 from the f64 solve (cuSOLVER: 1.6e-3, 2.7e-4).
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int m = 0; m < T; ++m) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + m * kStageLD + ty * 8);
      const float4 a1 = *reinterpret_cast<const float4*>(As + m * kStageLD + ty * 8 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + m * kStageLD + tx * 8);
      const float4 b1 = *reinterpret_cast<const float4*>(Bs + m * kStageLD + tx * 8 + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float4* row = reinterpret_cast<float4*>(C + i * T);
      const float4 c0 = __ldcg(row), c1 = __ldcg(row + 1);
      row[0] = make_float4(c0.x - acc[i][0], c0.y - acc[i][1], c0.z - acc[i][2],
                           c0.w - acc[i][3]);
      row[1] = make_float4(c1.x - acc[i][4], c1.y - acc[i][5], c1.z - acc[i][6],
                           c1.w - acc[i][7]);
    }
  }
}

// The dense step: assemble, factor, solve. Writes the step to p.x (32 Pt
// floats) and returns false where a pivot failed (every CTA alike).
__device__ bool dense_step(const GridParams& p, float lam, float* smem, int* s_fail, float* s_vec,
                           int step) {
  const int Pt = p.Pt, G = p.G, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* Ld = smem;
  float* As = smem + T * TLD;
  float* Bs = As + T * kStageLD;
  const size_t ntiles = dense_tiles(Pt);
  for (size_t t = blockIdx.x; t < ntiles; t += G) {
    // Storage order: row I's tiles (I, 0..I) at I (I + 1) / 2.
    int I = (int)((sqrtf(8.f * (float)t + 1.f) - 1.f) * 0.5f);
    while ((size_t)I * (I + 1) / 2 > t) --I;
    while ((size_t)(I + 1) * (I + 2) / 2 <= t) ++I;
    const int J = (int)(t - (size_t)I * (I + 1) / 2);
    __syncthreads();
    assemble_tile(p, I, J, lam);
  }
  grid_sync(p.bar, G);
  stamp(p, 4 + 8 * step + 2);

  bool ok = true;
  for (int k = 0; k < Pt; ++k) {
    // The diagonal tile, factored by warp 0 of every CTA from the same bits.
    const float* D = tile_at(p, k, k);
    for (int q = tid; q < T * T; q += kThreads) Ld[(q / T) * TLD + q % T] = __ldcg(D + q);
    __syncthreads();
    if (warp == 0) {
      const bool f = factor_diag<T, TLD>(Ld, T);
      if (lane == 0) *s_fail = f ? 0 : 1;
    }
    __syncthreads();
    if (*s_fail) {
      ok = false;
      break;
    }
    // The rows below: tile (I, k), I = k + 1 .. Pt, a warp a tile.
    for (int t = blockIdx.x + G * warp; t < Pt - k; t += G * kWarps) {
      const int I = k + 1 + t;
      solve_tile_rows(tile_at(p, I, k), Ld, I == Pt ? 1 : T);
    }
    grid_sync(p.bar, G);
    // Every CTA has read tile (k, k): its owner stores L_kk and 1 / L_ii
    // (the backward solve's), beside the trailing update, which does not
    // touch it.
    if (blockIdx.x == k % G) {
      float* Dw = tile_at(p, k, k);
      for (int q = tid; q < T * T; q += kThreads) Dw[q] = Ld[(q / T) * TLD + q % T];
      if (tid < T) p.invd[k * T + tid] = Ld[tid * TLD + T];
    }
    if (k + 1 < Pt) trailing_update(p, k, As, Bs);
    grid_sync(p.bar, G);
  }
  stamp(p, 4 + 8 * step + 3);
  if (!ok) return false;

  // Backward: L^T x = y, y the right-hand side's row. Per tile column k from
  // the last: every CTA solves x_k in warp 0 (lane j holds column j of
  // L_kk); the owner of y_J (J < k; CTA J mod G, a warp a tile) subtracts
  // L_kJ^T x_k.
  float* y = tile_at(p, Pt, 0);  // y_J at y + J T T (row 0 of tile (Pt, J))
  for (int k = Pt - 1; k >= 0; --k) {
    if (warp == 0) {
      const float* L = tile_at(p, k, k);
      float col[T];
#pragma unroll
      for (int c = 0; c < T; ++c) col[c] = c > lane ? __ldcg(L + c * T + lane) : 0.f;
      const float inv = __ldcg(p.invd + k * T + lane);
      float z = __ldcg(y + (size_t)k * T * T + lane);
#pragma unroll
      for (int c = T - 1; c >= 0; --c) {
        const float xc = __shfl_sync(kFull, z * inv, c);
        z = lane < c ? fmaf(-col[c], xc, z) : lane == c ? xc : z;
      }
      s_vec[lane] = z;
      if (blockIdx.x == k % G) p.x[k * T + lane] = z;
    }
    __syncthreads();
    for (int J = blockIdx.x + G * warp; J < k; J += G * kWarps) {
      const float* L = tile_at(p, k, J);
      float s = 0.f;
#pragma unroll 8
      for (int r = 0; r < T; ++r) s += __ldcg(L + r * T + lane) * s_vec[r];
      float* yj = y + (size_t)J * T * T + lane;
      *yj = __ldcg(yj) - s;
    }
    if (k > 0) grid_sync(p.bar, G);
    else __syncthreads();
  }
  return true;
}

// ------------------------------------------------------------ CG

// The CG vector p of vertex u at iteration `it`: the setup's p at it = 0,
// else z_u + beta p_u of the previous buffer (formed alike by every reader).
__device__ __forceinline__ void cg_p(const GridParams& p, int it, float beta, int u, float* out) {
  const float* prev = (it & 1) ? p.p0 : p.p1;  // it - 1's buffer
  if (it == 0) {
#pragma unroll
    for (int a = 0; a < 6; ++a) out[a] = __ldcg(p.p0 + 6 * u + a);
    return;
  }
#pragma unroll
  for (int a = 0; a < 6; ++a)
    out[a] = __fmaf_rn(beta, __ldcg(prev + 6 * u + a), __ldcg(p.z + 6 * u + a));
}

// 6 x 6 row-major symmetric A: its Cholesky and the inverse A^-1 (the
// plain cholesky_solve(I, L)); a pivot <= 0 gives NaN, as cho_factor's.
__device__ void inverse6(const float* A, float* inv) {
  float L[36];
#pragma unroll
  for (int q = 0; q < 36; ++q) L[q] = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = A[6 * j + j];
#pragma unroll
    for (int m = 0; m < j; ++m) d -= L[6 * j + m] * L[6 * j + m];
    const float l = sqrtf(d);  // NaN if d < 0
    L[6 * j + j] = d > 0.f ? l : __int_as_float(0x7fc00000);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = A[6 * i + j];
#pragma unroll
      for (int m = 0; m < j; ++m) s -= L[6 * i + m] * L[6 * j + m];
      L[6 * i + j] = s / L[6 * j + j];
    }
  }
  // Columns of A^-1: solve L y = e_c, then L^T x = y.
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float y[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float s = i == c ? 1.f : 0.f;
#pragma unroll
      for (int m = 0; m < i; ++m) s -= L[6 * i + m] * y[m];
      y[i] = s / L[6 * i + i];
    }
#pragma unroll
    for (int i = 5; i >= 0; --i) {
      float s = y[i];
#pragma unroll
      for (int m = i + 1; m < 6; ++m) s -= L[6 * m + i] * inv[6 * m + c];
      inv[6 * i + c] = s / L[6 * i + i];
    }
  }
}

// (H + damp) p at vertex v: its incident contributions in the vertex
// plan's order (as edge u's source: P p_i - P p_j; as edge u - E's target:
// -P^T p_i + P p_j; the two products summed apart, as the plain y = H_a x_i
// + H_b x_j), then extra p_v, then damp_v p_v.
__device__ void cg_matvec(const GridParams& p, int it, float beta, int v, float* y) {
  const int E = p.E;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int u0 = __ldg(p.v_off + v), u1 = __ldg(p.v_off + v + 1);
  for (int u = u0; u < u1; ++u) {
    const int ci = __ldg(p.v_idx + u), e = ci < E ? ci : ci - E;
    const float* P = p.blk + (size_t)kEdgeFloats * e;
    float xi[6], xj[6];
    cg_p(p, it, beta, p.edge_i[e], xi);
    cg_p(p, it, beta, p.edge_j[e], xj);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float s1 = 0.f, s2 = 0.f;
      if (ci < E) {  // yi = Hii xi + Hij xj
#pragma unroll
        for (int c = 0; c < 6; ++c) s1 += __ldcg(P + 6 * a + c) * xi[c];
#pragma unroll
        for (int c = 0; c < 6; ++c) s2 += -__ldcg(P + 6 * a + c) * xj[c];
      } else {  // yj = Hij^T xi + Hjj xj
#pragma unroll
        for (int c = 0; c < 6; ++c) s1 += -__ldcg(P + 6 * c + a) * xi[c];
#pragma unroll
        for (int c = 0; c < 6; ++c) s2 += __ldcg(P + 6 * a + c) * xj[c];
      }
      acc[a] += s1 + s2;
    }
  }
  float pv[6];
  cg_p(p, it, beta, v, pv);
  const float extra = (v >= p.nv ? 1.f : 0.f) + (v == 0 ? kGaugeWeight : 0.f);
#pragma unroll
  for (int a = 0; a < 6; ++a) y[a] = (acc[a] + extra * pv[a]) + __ldcg(p.damp + 6 * v + a) * pv[a];
}

// The CG step (the JAX package's _solve_cg, maxiter 4M, tol 1e-6) into
// p.x (6M floats). Returns the iterations run (every CTA alike).
__device__ int cg_step(const GridParams& p, float lam, double* red, double* bc, int step) {
  const int M = p.M, G = p.G, E = p.E;
  const int gid = blockIdx.x * kThreads + threadIdx.x, nthreads = G * kThreads;
  double rz_part = 0.0, rr_part = 0.0, bb_part = 0.0;
  for (int v = gid; v < M; v += nthreads) {
    float D[36];
    const float extra = (v >= p.nv ? 1.f : 0.f) + (v == 0 ? kGaugeWeight : 0.f);
#pragma unroll
    for (int q = 0; q < 36; ++q) D[q] = 0.f;
    const int u0 = __ldg(p.v_off + v), u1 = __ldg(p.v_off + v + 1);
    for (int u = u0; u < u1; ++u) {
      const int ci = __ldg(p.v_idx + u), e = ci < E ? ci : ci - E;
      const float* P = p.blk + (size_t)kEdgeFloats * e;
#pragma unroll
      for (int q = 0; q < 36; ++q) D[q] += __ldcg(P + q);  // Hii = Hjj = P
    }
    float Dd[36], Mi[36], dmp[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      D[7 * a] += extra;
      dmp[a] = lam * D[7 * a] + kJitter;
    }
#pragma unroll
    for (int q = 0; q < 36; ++q) Dd[q] = q % 7 == 0 ? D[q] + dmp[q / 7] : D[q];
    inverse6(Dd, Mi);
    float b[6], zz[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) b[a] = -vertex_gradient(p, p.blk, v, a);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 6; ++c) s += Mi[6 * a + c] * b[c];
      zz[a] = s;
    }
#pragma unroll
    for (int q = 0; q < 36; ++q) p.minv[36 * v + q] = Mi[q];
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      p.damp[6 * v + a] = dmp[a];
      p.x[6 * v + a] = 0.f;
      p.r[6 * v + a] = b[a];
      p.z[6 * v + a] = zz[a];
      p.p0[6 * v + a] = zz[a];
      rz_part += (double)(b[a] * zz[a]);
      rr_part += (double)(b[a] * b[a]);
    }
  }
  bb_part = rr_part;
  put_slot(p, kSlotRz, block_sum<kWarps>(rz_part, red));
  put_slot(p, kSlotRr, block_sum<kWarps>(rr_part, red));
  put_slot(p, kSlotBb, block_sum<kWarps>(bb_part, red));
  grid_sync(p.bar, G);
  float rz = (float)grid_sum(p, kSlotRz, bc);
  float rr = (float)grid_sum(p, kSlotRr, bc);
  const float bnorm2 = fmaxf((float)grid_sum(p, kSlotBb, bc), 1e-30f);
  stamp(p, 4 + 8 * step + 2);

  int it = 0;
  float beta = 0.f;
  const float tol2 = 1e-12f;
  while (it < 4 * M && rr > tol2 * bnorm2) {
    // Ap, and p' = z + beta p stored for this CTA's vertices.
    float* pcur = (it & 1) ? p.p1 : p.p0;
    double pap_part = 0.0;
    for (int v = gid; v < M; v += nthreads) {
      float y[6], pv[6];
      cg_matvec(p, it, beta, v, y);
      cg_p(p, it, beta, v, pv);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        if (it > 0) pcur[6 * v + a] = pv[a];
        p.ap[6 * v + a] = y[a];
        pap_part += (double)(pv[a] * y[a]);
      }
    }
    put_slot(p, kSlotPAp, block_sum<kWarps>(pap_part, red));
    grid_sync(p.bar, G);
    const float pap = (float)grid_sum(p, kSlotPAp, bc);
    const float alpha = pap > 0.f ? rz / pap : 0.f;
    double rz_new_part = 0.0, rr_new_part = 0.0;
    for (int v = gid; v < M; v += nthreads) {
      float rv[6], zv[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        p.x[6 * v + a] += alpha * pcur[6 * v + a];
        rv[a] = p.r[6 * v + a] - alpha * p.ap[6 * v + a];
        p.r[6 * v + a] = rv[a];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < 6; ++c) s += p.minv[36 * v + 6 * a + c] * rv[c];
        zv[a] = s;
        p.z[6 * v + a] = s;
        rz_new_part += (double)(rv[a] * zv[a]);
        rr_new_part += (double)(rv[a] * rv[a]);
      }
    }
    put_slot(p, kSlotRz, block_sum<kWarps>(rz_new_part, red));
    put_slot(p, kSlotRr, block_sum<kWarps>(rr_new_part, red));
    grid_sync(p.bar, G);
    const float rz_new = (float)grid_sum(p, kSlotRz, bc);
    beta = rz > 0.f ? rz_new / rz : 0.f;
    rz = rz_new;
    rr = (float)grid_sum(p, kSlotRr, bc);
    ++it;
  }
  stamp(p, 4 + 8 * step + 3);
  return it;
}

// ------------------------------------------------------------ the kernel

__global__ void __launch_bounds__(kThreads, 1) pose_graph_grid_kernel(GridParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double red[kWarps];
  __shared__ float redf[kWarps];
  __shared__ double bc;
  __shared__ int s_fail;
  __shared__ float s_vec[T];
  const int G = p.G, M = p.M, E = p.E, tid = threadIdx.x;
  const int gid = blockIdx.x * kThreads + tid, nthreads = G * kThreads;
  const int Ec = (E + G - 1) / G, e_lo = min(E, (int)blockIdx.x * Ec), e_hi = min(E, e_lo + Ec);
  float* cur = p.pose_a;
  float* trial = p.pose_b;

  for (int q = gid; q < 16 * M; q += nthreads) cur[q] = p.poses[q];
  if (p.timing != nullptr && blockIdx.x == 0 && tid == 0) {
    p.timing[0] = (long long)global_ns();
    p.timing[1] = clock64();
  }
  grid_sync(p.bar, G);

  // Adaptive GNC start: anneal0 = max(gnc_init, sqrt(max(max chi2, 1)) / c).
  float anneal0 = p.gnc_init;
  if (p.gnc_adaptive) {
    float mx = -INFINITY;
    for (int e = e_lo + tid; e < e_hi; e += kThreads) {
      float r[6];
      mx = nan_max(mx, edge_chi2(cur + 16 * p.edge_i[e], cur + 16 * p.edge_j[e], p.Z + 16 * e,
                                 p.info + 36 * e, r) * p.mask[e]);
    }
    mx = block_max<kWarps>(mx, redf);
    put_slot(p, kSlotMax, (double)mx);
    grid_sync(p.bar, G);
    if (tid == 0) {  // rank order, as the cluster kernel's cluster_max
      const double* s = p.red + (size_t)kSlotMax * G;
      float m = (float)__ldcg(s);
      for (int c = 1; c < G; ++c) m = nan_max((float)__ldcg(s + c), m);
      redf[0] = m;
    }
    __syncthreads();
    anneal0 = adaptive_anneal0(redf[0], p.cauchy_c, anneal0);
    __syncthreads();
  }

  float lam = 1e-6f;
  int k = 0;
  while (k < p.iterations) {
    const float anneal = anneal_at(anneal0, p.gnc_decay, k);
    const float c_eff = p.cauchy_c * anneal;
    const float c2 = c_eff * c_eff;
    stamp(p, 4 + 8 * k);

    put_slot(p, kSlotChi2, edge_pass(p, cur, e_lo, e_hi, c2, red));
    grid_sync(p.bar, G);
    const float chi2 = (float)grid_sum(p, kSlotChi2, &bc);
    stamp(p, 4 + 8 * k + 1);

    // The step: dense (the factorization's pivot flag) or CG.
    bool bad = false;
    const int n = 6 * M;
    int its = 0;
    if (p.solver == kDense) bad = !dense_step(p, lam, smem, &s_fail, s_vec, k);
    else its = cg_step(p, lam, red, &bc, k);
    if (p.timing != nullptr && blockIdx.x == 0 && tid == 0) p.timing[4 + 8 * k + 7] = its;
    grid_sync(p.bar, G);  // every element of the step written
    // The non-finite step zeroed, its norm: every CTA over all of x alike.
    double ss = 0.0;
    bool nonfinite = false;
    if (!bad)
      for (int i = tid; i < n; i += kThreads) {
        const float d = __ldcg(p.x + i);
        nonfinite |= !isfinite(d);
        ss += (double)d * d;
      }
    const bool any_nonfinite = __syncthreads_or(nonfinite);
    bad = bad || any_nonfinite;
    ss = block_sum<kWarps>(ss, red);
    const float step = bad ? 0.f : (float)sqrt(ss);
    stamp(p, 4 + 8 * k + 4);

    // exp(delta) on the active vertices into the trial buffer.
    for (int v = gid; v < M; v += nthreads) {
      float* Tt = trial + 16 * v;
      const float* T0 = cur + 16 * v;
      if (v < p.nv) {
        float d[6], D[16];
#pragma unroll
        for (int a = 0; a < 6; ++a) d[a] = bad ? 0.f : __ldcg(p.x + 6 * v + a);
        exp_se3(d, D);
        mm4(D, T0, Tt);
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q) Tt[q] = T0[q];
      }
    }
    grid_sync(p.bar, G);
    stamp(p, 4 + 8 * k + 5);

    put_slot(p, kSlotTrial, chi2_pass(p, trial, e_lo, e_hi, c2, nullptr, red));
    grid_sync(p.bar, G);
    const float chi2_new = (float)grid_sum(p, kSlotTrial, &bc);
    const LmStep lm = lm_step(chi2, chi2_new, lam, step, anneal);
    if (lm.accept) {
      float* t = cur;
      cur = trial;
      trial = t;
    }
    lam = lm.lam;
    if (blockIdx.x == 0 && tid == 0) {
      float* st = p.stats_out + 4 * k;
      st[0] = chi2;
      st[1] = chi2_new;
      st[2] = step;
      st[3] = lm.accept ? 1.f : 0.f;
    }
    stamp(p, 4 + 8 * k + 6);
    ++k;
    if (lm.done) break;
  }

  // Final chi2 and per-edge weights at the base Cauchy width.
  const float c2 = (float)(p.cauchy_c64 * p.cauchy_c64);
  put_slot(p, kSlotFinal, chi2_pass(p, cur, e_lo, e_hi, c2, p.weights_out, red));
  for (int q = gid; q < 16 * M; q += nthreads) p.poses_out[q] = cur[q];
  grid_sync(p.bar, G);
  const float chi2 = (float)grid_sum(p, kSlotFinal, &bc);
  if (blockIdx.x == 0) {
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
}

// Per device, once: cooperative launch support and the blocks of this
// kernel an SM holds at kThreads threads and kSmemFloats floats.
struct Prepared {
  int dev, resident;
};
std::mutex g_mutex;
std::vector<Prepared> g_prepared;

int resident_ctas(int dev, int* out) {
  std::lock_guard<std::mutex> lock(g_mutex);
  for (const Prepared& q : g_prepared)
    if (q.dev == dev) {
      *out = q.resident;
      return 0;
    }
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pose_graph_grid_kernel, kThreads,
                                                      kSmemFloats * sizeof(float));
  if (e != cudaSuccess) return (int)e;
  const int resident = coop ? per_sm * sms : 0;
  g_prepared.push_back({dev, resident});
  *out = resident;
  return 0;
}

}  // namespace

// What a grid solve over M vertices, E edge slots, `solver` (0 dense, 1 CG)
// and `ctas` CTAs uses: out[0] CTAs, out[1] threads a CTA, out[2] dynamic
// shared memory bytes a CTA, out[3] the tile width, out[4] tiles a side of
// the dense system (0 for CG), out[5] the global scratch floats, out[6] the
// barrier's words (zeroed by the caller). Returns 0, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int dvo_pose_graph_grid_plan(int M, int E, int solver, int ctas, long long* out) {
  if (M < 1 || E < 0 || ctas < 1 || (solver != kDense && solver != kCg))
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(M, E, solver, ctas);
  out[0] = ctas;
  out[1] = kThreads;
  out[2] = (long long)(kSmemFloats * sizeof(float));
  out[3] = T;
  out[4] = L.Pt;
  out[5] = (long long)L.total;
  out[6] = 2;
  return 0;
}

// One LM solve (models/pose_graph.py::optimize_reference's semantics, dense
// or CG) in one cooperative launch of `ctas` CTAs on `stream`, no host
// sync. Inputs as GridParams (the dense plan's d_idx, b_off and b_list may
// be null for CG); scratch: the plan's out[5] floats; bar: 2 zeroed
// words; timing: null, or 4 + 8 iterations int64 (phase stamps; slot 7 of
// a step its CG iterations). Outputs as dvo_pose_graph's. Returns a CUDA
// error code (0: launched; kErrNotCoResident where the card cannot hold the
// grid at once).
extern "C" int dvo_pose_graph_grid(
    const float* poses, const float* Z, const float* info, const float* mask,
    const int* edge_i, const int* edge_j, const int* v_off, const int* v_idx,
    const int* d_idx, const int* b_off, const int* b_list, int M, int E, int nv,
    int iterations, int use_robust, double cauchy_c, double gnc_init, double gnc_decay,
    int gnc_adaptive, int solver, int ctas, float* scratch, unsigned* bar, float* poses_out,
    float* chi2_out, float* weights_out, float* stats_out, int* steps_out, long long* timing,
    void* stream) {
  if (M < 1 || E < 0 || iterations < 0 || ctas < 1 || (solver != kDense && solver != kCg) ||
      (solver == kDense && (d_idx == nullptr || b_off == nullptr || b_list == nullptr)))
    return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  const int prepared = resident_ctas(dev, &resident);
  if (prepared) return prepared;
  if (resident < ctas) return kErrNotCoResident;
  const Layout L = layout(M, E, solver, ctas);
  GridParams p = {};
  p.poses = poses; p.Z = Z; p.info = info; p.mask = mask;
  p.edge_i = edge_i; p.edge_j = edge_j; p.v_off = v_off; p.v_idx = v_idx;
  p.d_idx = d_idx; p.b_off = b_off; p.b_list = b_list;
  p.M = M; p.E = E; p.nv = nv; p.iterations = iterations; p.use_robust = use_robust;
  p.gnc_adaptive = gnc_adaptive; p.solver = solver; p.G = ctas; p.n = 6 * M; p.Pt = L.Pt;
  p.cauchy_c = (float)cauchy_c; p.gnc_init = (float)gnc_init;
  p.cauchy_c64 = cauchy_c; p.gnc_decay = gnc_decay;
  p.red = reinterpret_cast<double*>(scratch + L.red);
  p.blk = scratch + L.blk;
  p.pose_a = scratch + L.pose_a;
  p.pose_b = scratch + L.pose_b;
  p.x = scratch + L.x;
  if (solver == kDense) {
    p.tiles = scratch + L.tiles;
    p.invd = scratch + L.invd;
  } else {
    p.minv = scratch + L.minv; p.damp = scratch + L.damp; p.r = scratch + L.r;
    p.z = scratch + L.z; p.p0 = scratch + L.p0; p.p1 = scratch + L.p1; p.ap = scratch + L.ap;
  }
  p.bar = bar;
  p.poses_out = poses_out; p.chi2_out = chi2_out; p.weights_out = weights_out;
  p.stats_out = stats_out; p.steps_out = steps_out; p.timing = timing;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemFloats * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, pose_graph_grid_kernel, p);
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}
