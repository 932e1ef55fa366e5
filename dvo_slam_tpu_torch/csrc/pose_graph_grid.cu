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
// What bounds it on this card. Dense: the factorization, at most n^3 / 3
// f32 operations a step at n = 6M (1.2 / 9.7 / 77 / 1 208 GFLOP at M = 256
// / 512 / 1 024 / 2 560 if every tile filled in: 18 us / 0.14 / 1.15 / 18
// ms at the card's 67 TFLOP/s f32 rate, in f32 FMA on the CUDA cores: TF32
// would break SE(3) chains and the JAX package factors the f32 system), and
// the chain of the diagonal tiles: one 32-column tile a link, each link a
// diagonal factor in one warp and the row solves below it, a dependency the
// whole card waits on. A pose graph fills in only part of its factor
// (chip_smoke.py's two-lap rings: 34-39 % of the tiles, 11-14 % of the
// dense count's tile products), so the work this kernel must do is the
// fill's, not n^3 / 3. CG: an iteration reads
// ~108 f32 an edge and 36 a vertex (1.6 MB on the 2 560-vertex ring of
// chip_smoke.py, L2 resident), so its floor is its two grid barriers and
// the latency of one round of loads, not bytes.
//
// Design. One CTA of 256 threads a streaming multiprocessor (G CTAs, the
// caller's count, all co-resident: the launch is cooperative and refused
// otherwise), one instantiation a solver so that each has the registers of
// its own path; a grid barrier of our own (a counter and a generation
// word, release / acquire at gpu scope: an acquire load also invalidates
// the SM's L1, so no fence is needed), so the build needs no relocatable
// device code. Every CTA keeps the scalars of the loop (chi2, lambda, the
// anneal, the CG scalars) and takes every decision from the same bits:
// each sum over the grid is a fixed-order sum of per-CTA partials in fixed
// slots, read by every CTA after a barrier. The edges are split over the
// CTAs in contiguous ranges and the per-edge blocks (edge_stage_a / _b, as
// on the cluster kernel) go to global scratch; the poses live in global
// memory as two buffers, the current and the trial, swapped on accept.
// - Dense. The damped lower triangle, -g appended as one more row of tiles
//   (its row 0; rows past it zero), is stored in 32 x 32 tiles, tile (I, J)
//   with J <= I at (I (I + 1) / 2 + J) tiles, padded to a multiple of 32
//   with identity rows. The host computes the tile-level symbolic fill of
//   the factor (models/pose_graph.py::grid_pattern): only its nonzero tiles
//   are assembled, updated, solved and read, in units of 2 x 2 tiles, each
//   unit owned by one CTA for the whole step (the host's unit list, by unit
//   column then row, dealt round-robin). No grid barrier inside the
//   factorization: tile column j is final when its count col_done[j]
//   reaches the units that hold its nonzero tiles (flags released and
//   acquired as the barrier's). A CTA walks the panels k (tile columns) in
//   order. First the units that hold column k + 1 (the look-ahead): panel k
//   applied to them after col_done[k], then the column finished: the owner
//   of the diagonal tile factors it in one warp (factor_tile: a row a lane,
//   each pivot's column broadcast through shared memory) and publishes it
//   with a release flag, or publishes the failed pivot; every other owner
//   of the column, its rows loaded before it waits, loads the tile (every
//   load in flight at once) and solves its tiles, a warp a tile (a lane a
//   row; the -g row gives y, the forward substitution). Then panel k on
//   the CTA's other units it reaches, A_IJ -= L_Ik L_Jk^T over the unit's
//   nonzero pairs, each thread a 4 x 4 register tile over the 32 staged
//   values, the products summed from zero and subtracted from C once (as a
//   GEMM does), each unit's staged columns loaded while the unit before it
//   multiplies. A column whose rows need no earlier panel waits for none,
//   so the chain runs only through the columns that depend on each other.
//   One grid barrier after the factorization, after which every CTA reads
//   the pivot flag from the same bits. The backward solve, by flags too:
//   the owner of y_J (CTA J mod G) waits for each x_I (I > J, L_IJ nonzero;
//   the warps take those I in turn, each L_IJ loaded before its wait), sums
//   L_IJ^T x_I per warp, then solves x_J in warp 0 and publishes it.
// - CG (any M): a thread a vertex builds its damped block-diagonal 6 x 6,
//   factors and inverts it (the preconditioner), sums its gradient over the
//   vertex plan and starts r = b = -g, z = p = M^-1 r; it keeps its
//   vertex's preconditioner, x and r in registers for the whole solve.
//   Per iteration: the matvec by a group of lanes a vertex (a warp where
//   the card has a warp a vertex, fewer lanes past that), the lanes taking
//   the vertex's incident edges in the vertex plan's order with every load
//   of an edge in flight (each lane's first edge block kept in registers;
//   Hii = Hjj = P, Hij = -P from the edge slots), the group's partials
//   summed by a fixed xor-shuffle tree; p' = z + beta p formed on the fly
//   for the neighbours (two p buffers, so no barrier for the update), p.Ap;
//   a barrier; x, r, z and r.z, r.r; a barrier. The test k < 4M and rr >
//   tol^2 |b|^2 runs on every CTA from the same bits: two grid barriers an
//   iteration and nothing on the host. Vertex v lives on CTA v mod G in
//   every phase.
//
// Determinism. No float atomics: every sum into a slot of g, of H or of a
// matvec runs over the host plan's contributions in increasing index order,
// every tile of the factor is updated by its unit's owner in panel order,
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
constexpr int kUnit = 2;                 // a unit of the factor, in tiles a side
constexpr int kUnitRows = kUnit * T;     // 64
constexpr int kStageLD = kUnitRows + 4;  // a staged column row's floats (16-B aligned)
constexpr int kErrNotCoResident = 100002;  // as csrc/linearize.cu's dvo_error_string
constexpr int kDense = 0, kCg = 1;
// Why a step came out zero (zeroed_out): used, a failed pivot, not finite.
constexpr int kStepUsed = 0, kPivotFailed = 1, kNotFinite = 2;
// Reduction slots: G doubles each.
constexpr int kSlotMax = 0, kSlotChi2 = 1, kSlotTrial = 2, kSlotFinal = 3, kSlotPAp = 4,
              kSlotRz = 5, kSlotRr = 6, kSlotBb = 7, kSlots = 8;
// Dynamic shared memory: the diagonal tile, its factor's column broadcast
// (two buffers of 32) and a unit's two staged columns.
constexpr size_t kSmemFloats = (size_t)T * TLD + 2 * T + 2 * (size_t)T * kStageLD;

struct Layout {  // offsets in floats into the scratch buffer
  size_t red, blk, pose_a, pose_b, tiles, invd, x, flags, minv, damp, r, z, p0, p1, ap, total;
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
    L.flags = take(3 * (size_t)L.Pt + 1);  // col_done, diag_ready, x_ready; the pivot flag
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
  const unsigned* fill; // dense: (Pt + 1, fill_words) bits: tile (I, J) of the factor nonzero
  const int* units;     // dense: (n_units,) U << 16 | W, by W then U
  const int* col_units; // dense: (Pt,) units holding a nonzero tile of column j
  int M, E, nv, iterations, use_robust, gnc_adaptive, G, n, Pt, fill_words, n_units;
  float cauchy_c, gnc_init;
  double cauchy_c64, gnc_decay;
  double* red;          // kSlots x G per-CTA partials
  float* blk;           // (E, kEdgeFloats) per-edge slots
  float* pose_a;        // (M, 16): the current poses, then swapped with
  float* pose_b;        // (M, 16): the trial poses
  float* tiles;         // dense: the tiles, rows 0..Pt (Pt: -g, then y)
  float* invd;          // dense: (32 Pt,) 1 / L_ii
  float* x;             // the step (32 Pt dense, 6M CG)
  unsigned* flags;      // dense: col_done (Pt), diag_ready (Pt), x_ready (Pt), pivot flag
  float *minv, *damp, *r, *z, *p0, *p1, *ap;  // CG, per vertex: 36, 6, 6 ...
  unsigned* bar;        // the grid barrier: arrivals, generation (zeroed)
  float* poses_out;     // (M, 4, 4)
  float* chi2_out;      // ()
  float* weights_out;   // (E,)
  float* stats_out;     // (iterations, 4) per step: chi2, chi2_new, |delta|, accept
  int* steps_out;       // ()
  int* zeroed_out;      // (iterations,) per step: kStepUsed, kPivotFailed or kNotFinite
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

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* a) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(a) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* a, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" :: "l"(a), "r"(v) : "memory");
}

// Every CTA of the (co-resident) grid waits here until all have arrived;
// the writes of every thread before it are visible to every thread after
// it. Thread 0 reads the generation before it arrives (it cannot move until
// this CTA has arrived), the last arrival resets the count and releases the
// next generation. The CTA barrier orders its threads' writes before thread
// 0's release (the arrival) and thread 0's acquire before their reads, so
// no fence is needed (as for every flag of this kernel). A wait past 2^35
// cycles (~20 s; no phase of a solve comes near) traps: a launch whose CTAs
// took different branches fails with an error instead of holding the card.
__device__ void grid_sync(unsigned* bar, unsigned G) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    if (add_acq_rel(bar, 1u) == G - 1) {
      bar[0] = 0u;
      st_release(bar + 1, gen + 1);
    } else {
      const long long t0 = clock64();
      while (ld_acquire(bar + 1) == gen)
        if (clock64() - t0 > (1LL << 35)) __trap();
    }
  }
  __syncthreads();
}

// Thread 0 waits until *flag >= want or a pivot has failed (*fstat != 0);
// every thread of the CTA gets whether *flag == want (false: a failed pivot,
// in this column or another). The writes released before the flag are
// visible to every thread after it. Each poll reads the pivot flag
// (relaxed) and then the flag (acquire), so both loads fly together. A
// wait past ~20 s traps, as grid_sync's.
__device__ bool wait_flag(const unsigned* flag, unsigned want, const unsigned* fstat) {
  int ok = 0;
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (true) {
      const unsigned failed = ld_relaxed(fstat), f = ld_acquire(flag);
      if (f >= want || failed != 0u) {
        ok = f == want;
        break;
      }
      if (clock64() - t0 > (1LL << 35)) __trap();
    }
  }
  return __syncthreads_or(ok) != 0;
}

// After every thread's writes: thread 0 adds v to *flag, released.
__device__ void release_add(unsigned* flag, unsigned v) {
  __syncthreads();
  if (threadIdx.x == 0) add_acq_rel(flag, v);
}

// Thread 0 of CTA 0 writes clock64 to timing[slot] (after a barrier).
__device__ __forceinline__ void stamp(const GridParams& p, int slot) {
  if (p.timing != nullptr && blockIdx.x == 0 && threadIdx.x == 0) p.timing[slot] = clock64();
}

// The sums of slot arrays s0 and s1 (s1 < 0: s0 alone), each of G partials
// in a fixed order, on every thread of every CTA alike: lane l of warp 0
// sums slots l, l + 32, ... in order, then a fixed xor-shuffle tree; `bc`
// (shared, two doubles) passes them on.
__device__ void grid_sum(const GridParams& p, int s0, int s1, double* bc, double* a, double* b) {
  if (threadIdx.x < 32) {
    const double* x0 = p.red + (size_t)s0 * p.G;
    const double* x1 = p.red + (size_t)(s1 < 0 ? s0 : s1) * p.G;
    double v0 = 0.0, v1 = 0.0;
    for (int c = threadIdx.x; c < p.G; c += 32) {
      v0 += __ldcg(x0 + c);
      v1 += __ldcg(x1 + c);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v0 += __shfl_xor_sync(kFull, v0, o);
      v1 += __shfl_xor_sync(kFull, v1, o);
    }
    if (threadIdx.x == 0) {
      bc[0] = v0;
      bc[1] = v1;
    }
  }
  __syncthreads();
  *a = bc[0];
  if (b != nullptr) *b = bc[1];
  __syncthreads();
}

__device__ double grid_sum(const GridParams& p, int s, double* bc) {
  double v;
  grid_sum(p, s, -1, bc, &v, nullptr);
  return v;
}

// block_sum of two values at once (each in block_sum's order).
__device__ void block_sum2(double* a, double* b, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double u = *a, v = *b;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    u += __shfl_xor_sync(kFull, u, o);
    v += __shfl_xor_sync(kFull, v, o);
  }
  if (lane == 0) {
    red[warp] = u;
    red[kWarps + warp] = v;
  }
  __syncthreads();
  double su = 0.0, sv = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    su += red[w];
    sv += red[kWarps + w];
  }
  __syncthreads();
  *a = su;
  *b = sv;
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

// Whether tile (I, J) of the factor (I == Pt: the right-hand side's row) is
// nonzero in the host's symbolic fill; false outside J <= I <= Pt, J < Pt.
__device__ __forceinline__ bool nz(const GridParams& p, int I, int J) {
  if (J < 0 || J > I || I > p.Pt || J >= p.Pt) return false;
  return (__ldg(p.fill + (size_t)I * p.fill_words + (J >> 5)) >> (J & 31)) & 1u;
}

// The tile rows 2U + r (bit r, r = 0, 1) of unit row U at or below row lo
// whose tile in column k is nonzero (a row past the factor's, none).
__device__ __forceinline__ unsigned rows_at(const GridParams& p, int U, int k, int lo) {
  return (2 * U >= lo && nz(p, 2 * U, k) ? 1u : 0u) |
         (2 * U + 1 >= lo && nz(p, 2 * U + 1, k) ? 2u : 0u);
}

// Tile (I, J) of the damped system (I < Pt) or of the right-hand side's
// row (I == Pt: row 0 is -g, the rest zero), written by this CTA alone (not
// inlined: it runs once a tile, before the factorization, and its
// registers stay out of the factorization's):
// zeroed (identity on padded rows), then every non-empty 6 x 6 block of the
// lower triangle that meets it (the host's block list, by column vertex
// then row vertex) summed in the plan's order, a warp a block.
__device__ __noinline__ void assemble_tile(const GridParams& p, int I, int J, float lam) {
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

// Factors the 32 x 32 tile A (lower part; row stride TLD in shared memory)
// in the calling warp: lane i holds row i in registers, and column k goes
// to every lane through `cb` (64 floats of shared memory, two buffers
// taken in turn) read back four values a load. The same LDL as the cluster
// kernel's factor_diag, with the same operations in the same order for
// every element of the lower triangle (so the same bits): pivot k from the
// column, A_ij -= (A_ik / d_k) A_jk for j > k, the square roots and the
// scaling L_ij = A_ij / sqrt(d_j) after the last pivot, 1 / L_jj in each
// row's float 32. The upper triangle takes updates no one reads (no
// select), and the column's shared-memory broadcast replaces 31 shuffles
// a pivot. Returns false where a pivot is <= 0 (every lane alike), and
// then leaves A as it was.
__device__ bool factor_tile(float* A, float* cb) {
  const int lane = threadIdx.x & 31;
  float a[T], d[T];
#pragma unroll
  for (int j = 0; j < T; ++j) a[j] = j <= lane ? A[lane * TLD + j] : 0.f;
  bool bad = false;
#pragma unroll
  for (int k = 0; k < T; ++k) {
    float* c = cb + (k & 1) * T;
    c[lane] = a[k];
    __syncwarp();
    const float dk = c[k];
    bad |= !(dk > 0.f);
    d[k] = dk;
    const float u = a[k] * recip(dk);
#pragma unroll
    for (int q = (k + 1) / 4; q < T / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(c)[q];
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (4 * q + e > k) a[4 * q + e] = fmaf(-u, w[e], a[4 * q + e]);
    }
  }
  if (!bad) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float inv = rsqrt_nr(d[j]), sq = d[j] * inv;
      if (j < lane) A[lane * TLD + j] = a[j] * inv;
      if (j == lane) {
        A[lane * TLD + j] = sq;
        A[lane * TLD + T] = inv;
      }
    }
  }
  __syncwarp();
  return !bad;
}

// Row `lane` of tile A into x (a lane a row).
__device__ __forceinline__ void load_row(const float* A, float (&x)[T]) {
  const float4* row = reinterpret_cast<const float4*>(A + (threadIdx.x & 31) * T);
#pragma unroll
  for (int q = 0; q < T / 4; ++q) {
    const float4 v = __ldcg(row + q);
    x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
  }
}

// Solves a row x of a tile below the diagonal tile (L_kk in `Ld` with
// 1 / L_ii in each row's float 32) against L_kk^T in registers: L_Ik =
// A_Ik L_kk^-T, column by column (as the cluster kernel's solve_rows), and
// stores it as row `lane` of tile A.
__device__ __forceinline__ void solve_row(float* A, const float* Ld, float (&x)[T]) {
#pragma unroll
  for (int c = 0; c < T; ++c) {
    x[c] *= Ld[c * TLD + T];
#pragma unroll
    for (int j = c + 1; j < T; ++j) x[j] -= x[c] * Ld[j * TLD + c];
  }
  float4* row = reinterpret_cast<float4*>(A + (threadIdx.x & 31) * T);
#pragma unroll
  for (int q = 0; q < T / 4; ++q)
    row[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
}

// This thread's two float4 of the tiles (2 V + r, k) of unit row V whose
// bit r is set in `rows` (zeros for the others): 64 rows of 32 values.
__device__ __forceinline__ void stage_load(const GridParams& p, int V, int k, unsigned rows,
                                           float4 (&v)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = threadIdx.x + h * kThreads, row = q / (T / 4), m = 4 * (q % (T / 4));
    v[h] = make_float4(0.f, 0.f, 0.f, 0.f);
    if ((rows >> (row / T)) & 1u)
      v[h] = __ldcg(reinterpret_cast<const float4*>(tile_at(p, 2 * V + row / T, k) +
                                                    (row % T) * T + m));
  }
}

// stage_load's values into S as S[m][row] (column value m of a row).
__device__ __forceinline__ void stage_store(float* S, const float4 (&v)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = threadIdx.x + h * kThreads, row = q / (T / 4), m = 4 * (q % (T / 4));
    S[m * kStageLD + row] = v[h].x;
    S[(m + 1) * kStageLD + row] = v[h].y;
    S[(m + 2) * kStageLD + row] = v[h].z;
    S[(m + 3) * kStageLD + row] = v[h].w;
  }
}

// One unit's update by one panel, split in two so that the next unit's
// staged columns fly while this one multiplies: unit_load starts their
// loads into registers; unit_apply loads C's values (their latency under
// the staging and the products), stages the columns, multiplies and writes
// C.
struct UnitLoad {
  float4 va[2], vb[2];
  int U, W;
  unsigned rm, cm;
};

__device__ __forceinline__ bool unit_on(const UnitLoad& u, int* I, int* J) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16, r = ty / 8, c = tx / 8;
  *I = 2 * u.U + r;
  *J = 2 * u.W + c;
  return ((u.rm >> r) & (u.cm >> c) & 1u) && *J <= *I;
}

__device__ __forceinline__ float* unit_c(const GridParams& p, int I, int J) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  return tile_at(p, I, J) + (ty % 8) * 4 * T + (tx % 8) * 4;
}

__device__ __forceinline__ void unit_load(const GridParams& p, int U, int W, int k, unsigned rm,
                                          unsigned cm, UnitLoad& u) {
  u.U = U;
  u.W = W;
  u.rm = rm;
  u.cm = cm;
  stage_load(p, U, k, rm, u.va);
  stage_load(p, W, k, cm, u.vb);
}

// Panel k applied to unit u (loaded by unit_load): A_IJ -= L_Ik L_Jk^T for
// the unit's rows I in `rm` and columns J in `cm` (both below k and nonzero
// in column k), J <= I: each thread a 4 x 4 register tile (inside one tile)
// over the 32 staged values, f32 FMA. Diagonal tile (k + 1, k + 1), the
// next to be factored, goes to Ld as well (row stride TLD) where the unit
// holds it.
__device__ __forceinline__ void unit_apply(const GridParams& p, int k, const UnitLoad& u,
                                           float* As, float* Bs, float* Ld) {
  int I, J;
  const bool on = unit_on(u, &I, &J);
  float* C = unit_c(p, on ? I : 0, on ? J : 0);
  float4 c4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (on) c4[i] = __ldcg(reinterpret_cast<const float4*>(C + i * T));
  __syncthreads();  // the last reads of As / Bs are done
  stage_store(As, u.va);
  stage_store(Bs, u.vb);
  __syncthreads();
  if (!on) return;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // The 32 products summed from zero, then subtracted from C once (as a
  // GEMM does): a chain started at C rounds every product at C's
  // magnitude, and that put the first step of the 1 024- and 2 560-vertex
  // rings 3e-3 and 8e-3 from the f64 solve (cuSOLVER: 1.6e-3, 2.7e-4).
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int m = 0; m < T; ++m) {
    const float4 a4 = *reinterpret_cast<const float4*>(As + m * kStageLD + ty * 4);
    const float4 b4 = *reinterpret_cast<const float4*>(Bs + m * kStageLD + tx * 4);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
  const bool diag = I == J && I == k + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = make_float4(c4[i].x - acc[i][0], c4[i].y - acc[i][1], c4[i].z - acc[i][2],
                                 c4[i].w - acc[i][3]);
    *reinterpret_cast<float4*>(C + i * T) = v;
    if (diag) {
      float* d = Ld + ((ty % 8) * 4 + i) * TLD + (tx % 8) * 4;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    }
  }
}

// Column j of unit (U, j / 2), every earlier panel applied to it: where the
// unit holds the diagonal tile, warp 0 factors it (factor_tile) and the CTA
// publishes it (diag_ready[j] = 1; a failed pivot sets the pivot flag and
// diag_ready[j] = 2), else the CTA waits for it and loads it (a float4 a
// thread and 1 / L_ii, in flight together); then the unit's nonzero tiles
// below the diagonal are solved, a warp a tile (their rows loaded before
// the wait), and the unit is counted in col_done[j]. `ld_holds`: Ld
// already holds the updated diagonal tile (unit_update put it there).
// False on a failed pivot, here or elsewhere.
__device__ bool unit_column(const GridParams& p, int U, int j, float* Ld, float* cb,
                            bool ld_holds) {
  const unsigned rm = rows_at(p, U, j, j);
  if (rm == 0u) return true;
  unsigned* diag_ready = p.flags + p.Pt + j;
  unsigned* fstat = p.flags + 3 * p.Pt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = tid / (T / 4), col = 4 * (tid % (T / 4));  // a float4 of a tile a thread
  __syncthreads();  // the unit's update is written
  const int I = 2 * U + warp;
  const bool solves = warp < 2 && ((rm >> warp) & 1u) && I > j && (I < p.Pt || lane == 0);
  float x[T];
  if (solves) load_row(tile_at(p, I, j), x);
  float* D = tile_at(p, j, j);
  if (2 * U == (j & ~1)) {  // the unit holds the diagonal tile
    if (!ld_holds) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(D + row * T + col));
      float* d = Ld + row * TLD + col;
      d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
      __syncthreads();
    }
    bool f = true;
    if (warp == 0) f = factor_tile(Ld, cb);
    if (__syncthreads_or(warp == 0 && !f)) {
      if (tid == 0) {
        st_release(fstat, 1u);
        st_release(diag_ready, 2u);
      }
      return false;
    }
    const float* d = Ld + row * TLD + col;
    *reinterpret_cast<float4*>(D + row * T + col) = make_float4(d[0], d[1], d[2], d[3]);
    if (tid < T) p.invd[j * T + tid] = Ld[tid * TLD + T];
    release_add(diag_ready, 1u);
  } else {
    if (!wait_flag(diag_ready, 1u, fstat)) return false;
    const float4 v = __ldcg(reinterpret_cast<const float4*>(D + row * T + col));
    const float inv = tid < T ? __ldcg(p.invd + j * T + tid) : 0.f;
    float* d = Ld + row * TLD + col;
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    if (tid < T) Ld[tid * TLD + T] = inv;
    __syncthreads();
  }
  if (solves) solve_row(tile_at(p, I, j), Ld, x);
  release_add(p.flags + j, 1u);
  return true;
}

// The rows (bits 0, 1) of unit row U below row k whose tile in column k is
// nonzero; the columns, the same for unit column W without column Pt; and
// whether panel k reaches the unit (a tile J <= I with both L_Ik and L_Jk
// nonzero).
__device__ __forceinline__ bool panel_reaches(const GridParams& p, int U, int W, int k,
                                              unsigned* rm, unsigned* cm) {
  *rm = rows_at(p, U, k, k + 1);
  *cm = rows_at(p, W, k, k + 1) & (2 * W + 1 >= p.Pt ? 1u : 3u);
  return U > W ? (*rm != 0u && *cm != 0u)
               : (((*rm & 1u) && (*cm & 1u)) || ((*rm & 2u) && *cm != 0u));
}

// The next of this CTA's units from list index i on that panel k reaches
// (n_units if none), with its rows and columns.
__device__ __forceinline__ int next_reached(const GridParams& p, int i, int k, unsigned* rm,
                                           unsigned* cm) {
  for (; i < p.n_units; i += p.G) {
    const int code = __ldg(p.units + i);
    if (panel_reaches(p, code >> 16, code & 0xffff, k, rm, cm)) return i;
  }
  return p.n_units;
}

// The blocked Cholesky of the assembled tiles, right-looking over the
// panels k (tile columns), each CTA on its units (the host's list, i =
// blockIdx.x, + G, ...) in list order: first the units that hold column
// k + 1 (panel k applied after col_done[k], then the column finished:
// the look-ahead), then panel k applied to the CTA's other units it
// reaches, each unit's loads in flight while the one before it multiplies.
// Stops at a failed pivot (the pivot flag, read by the caller after a
// barrier).
__device__ void dense_factor(const GridParams& p, float* smem) {
  const int Pt = p.Pt, G = p.G;
  float* Ld = smem;
  float* cb = Ld + T * TLD;
  float* As = cb + 2 * T;
  float* Bs = As + T * kStageLD;
  const unsigned* fstat = p.flags + 3 * Pt;
  int first = blockIdx.x;
  for (int k = -1; k + 1 < Pt; ++k) {
    // Units whose columns are all <= k are finished.
    while (first < p.n_units && 2 * (__ldg(p.units + first) & 0xffff) + 1 <= k) first += G;
    if (first >= p.n_units) return;
    bool waited = k < 0;
    int i = first;
    // The units that hold column k + 1 come first in the list.
    for (; i < p.n_units; i += G) {
      const int code = __ldg(p.units + i), U = code >> 16, W = code & 0xffff;
      if (W != (k + 1) / 2) break;
      bool ld_holds = false;
      unsigned rm, cm;
      if (k >= 0 && panel_reaches(p, U, W, k, &rm, &cm)) {
        if (!waited) {
          if (!wait_flag(p.flags + k, (unsigned)__ldg(p.col_units + k), fstat)) return;
          waited = true;
        }
        UnitLoad u;
        unit_load(p, U, W, k, rm, cm, u);
        unit_apply(p, k, u, As, Bs, Ld);
        ld_holds = U == W && ((rm >> ((k + 1) & 1)) & (cm >> ((k + 1) & 1)) & 1u);
      }
      if (!unit_column(p, U, k + 1, Ld, cb, ld_holds)) return;
    }
    if (k < 0) continue;
    // Panel k on the rest, pipelined.
    unsigned rm, cm;
    i = next_reached(p, i, k, &rm, &cm);
    if (i >= p.n_units) continue;
    if (!waited && !wait_flag(p.flags + k, (unsigned)__ldg(p.col_units + k), fstat)) return;
    UnitLoad cur, nxt;
    int code = __ldg(p.units + i);
    unit_load(p, code >> 16, code & 0xffff, k, rm, cm, cur);
    while (i < p.n_units) {
      const int j = next_reached(p, i + G, k, &rm, &cm);
      if (j < p.n_units) {
        code = __ldg(p.units + j);
        unit_load(p, code >> 16, code & 0xffff, k, rm, cm, nxt);
      }
      unit_apply(p, k, cur, As, Bs, Ld);
      cur = nxt;
      i = j;
    }
  }
}

// Backward: L^T x = y, y the right-hand side's row after the factorization
// (the forward substitution). CTA J mod G owns x_J and takes its J from the
// last down: each warp sums L_IJ^T x_I over its share of the nonzero tiles
// (I, J), I > J (the warps take them in turn from the last), loading L_IJ
// before it waits for x_I; warp 0 subtracts the warps' sums from y_J in
// warp order, solves x_J against L_JJ^T (lane j holds column j) and
// publishes it (x_ready[J]).
__device__ void dense_backward(const GridParams& p, float* smem) {
  const int Pt = p.Pt, G = p.G, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if ((int)blockIdx.x >= Pt) return;
  float* part = smem + T * TLD + 2 * T;  // kWarps x 32 partial sums
  unsigned* x_ready = p.flags + 2 * Pt;
  const float* y = tile_at(p, Pt, 0);  // y_J at y + J T T (row 0 of tile (Pt, J))
  for (int J = blockIdx.x + G * ((Pt - 1 - (int)blockIdx.x) / G); J >= 0; J -= G) {
    float s = 0.f;
    int cnt = 0;
    for (int I = Pt - 1; I > J; --I) {
      if (!nz(p, I, J) || (cnt++ % kWarps) != warp) continue;
      const float* L = tile_at(p, I, J);
      float l[T];
#pragma unroll
      for (int r = 0; r < T; ++r) l[r] = __ldcg(L + r * T + lane);
      if (lane == 0) {
        const long long t0 = clock64();
        while (ld_acquire(x_ready + I) == 0u)
          if (clock64() - t0 > (1LL << 35)) __trap();
      }
      __syncwarp();
      const float xv = __ldcg(p.x + I * T + lane);
      float t = 0.f;
#pragma unroll
      for (int r = 0; r < T; ++r) t += l[r] * __shfl_sync(kFull, xv, r);
      s += t;
    }
    part[warp * T + lane] = s;
    __syncthreads();
    if (warp == 0) {
      const float* L = tile_at(p, J, J);
      float col[T];
#pragma unroll
      for (int c = 0; c < T; ++c) col[c] = c > lane ? __ldcg(L + c * T + lane) : 0.f;
      const float inv = __ldcg(p.invd + J * T + lane);
      float z = __ldcg(y + (size_t)J * T * T + lane);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) z -= part[w * T + lane];
#pragma unroll
      for (int c = T - 1; c >= 0; --c) {
        const float xc = __shfl_sync(kFull, z * inv, c);
        z = lane < c ? fmaf(-col[c], xc, z) : lane == c ? xc : z;
      }
      p.x[J * T + lane] = z;
      __syncwarp();
      if (lane == 0) st_release(x_ready + J, 1u);
    }
    __syncthreads();  // `part` is read
  }
}

// The dense step: assemble, factor, solve. Writes the step to p.x (32 Pt
// floats) and returns false where a pivot failed (every CTA alike).
__device__ bool dense_step(const GridParams& p, float lam, float* smem, int step) {
  const int G = p.G;
  const int gid = blockIdx.x * kThreads + threadIdx.x, nthreads = G * kThreads;
  for (int q = gid; q < 3 * p.Pt + 1; q += nthreads) p.flags[q] = 0u;
  // Each unit's nonzero tiles, by its owner.
  for (int i = blockIdx.x; i < p.n_units; i += G) {
    const int code = __ldg(p.units + i), U = code >> 16, W = code & 0xffff;
    for (int t = 0; t < 4; ++t) {
      const int I = 2 * U + t / 2, J = 2 * W + t % 2;
      if (!nz(p, I, J)) continue;
      __syncthreads();
      assemble_tile(p, I, J, lam);
    }
  }
  grid_sync(p.bar, G);
  stamp(p, 4 + 8 * step + 2);
  dense_factor(p, smem);
  grid_sync(p.bar, G);
  stamp(p, 4 + 8 * step + 3);
  if (__ldcg(p.flags + 3 * p.Pt) != 0u) return false;
  dense_backward(p, smem);
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

// Lanes a vertex in the CG matvec: the widest power of two, up to a warp,
// at which the grid's groups hold every vertex at once (one lane past that,
// each lane then walking several vertices).
__device__ __forceinline__ int cg_lanes(const GridParams& p) {
  int L = 32;
  while (L > 1 && (long long)p.G * (kThreads / L) < p.M) L >>= 1;
  return L;
}

// Contribution ci of the vertex plan (edge e's source if ci < E: P p_i -
// P p_j; its target else: -P^T p_i + P p_j; the two products summed apart,
// as the plain y = H_a x_i + H_b x_j) added to acc, P the edge's block.
__device__ __forceinline__ void cg_contribution(const GridParams& p, int it, float beta, int ci,
                                                int vi, int vj, const float (&P)[36],
                                                float (&acc)[6]) {
  float xi[6], xj[6];
  cg_p(p, it, beta, vi, xi);
  cg_p(p, it, beta, vj, xj);
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s1 = 0.f, s2 = 0.f;
    if (ci < p.E) {  // yi = Hii xi + Hij xj
#pragma unroll
      for (int c = 0; c < 6; ++c) s1 += P[6 * a + c] * xi[c];
#pragma unroll
      for (int c = 0; c < 6; ++c) s2 += -P[6 * a + c] * xj[c];
    } else {  // yj = Hij^T xi + Hjj xj
#pragma unroll
      for (int c = 0; c < 6; ++c) s1 += -P[6 * c + a] * xi[c];
#pragma unroll
      for (int c = 0; c < 6; ++c) s2 += P[6 * a + c] * xj[c];
    }
    acc[a] += s1 + s2;
  }
}

// Contribution u of the vertex plan: its code, its edge's vertices and block.
struct CgEdge {
  int ci, vi, vj;
  float P[36];
};

__device__ __forceinline__ void cg_edge(const GridParams& p, int u, CgEdge& ce) {
  ce.ci = __ldg(p.v_idx + u);
  const int e = ce.ci < p.E ? ce.ci : ce.ci - p.E;
  ce.vi = __ldg(p.edge_i + e);
  ce.vj = __ldg(p.edge_j + e);
  const float* P = p.blk + (size_t)kEdgeFloats * e;
#pragma unroll
  for (int q = 0; q < 36; ++q) ce.P[q] = __ldcg(P + q);
}

// (H + damp) p on this CTA's vertices, a group of L lanes a vertex (vertex
// base + blockIdx.x + G g for group g of the CTA, base = 0, G kThreads / L,
// ...): lane s of the group takes the vertex plan's contributions u0 + s,
// u0 + s + L, ..., summed in that order, every load of a contribution in
// flight; `first` holds the lane's first contribution of the first round
// (loaded once a CG solve: the blocks do not change within it; u = -1:
// none). The group's sums combine by a fixed xor-shuffle tree, and its
// lane 0 adds extra p_v and damp_v p_v, stores Ap_v and (past iteration 0)
// p_v into pcur. Returns this thread's share of p . Ap.
__device__ __forceinline__ double cg_matvec(const GridParams& p, int it, float beta, float* pcur,
                            const CgEdge& first) {
  const int L = cg_lanes(p), g = threadIdx.x / L, s = threadIdx.x % L;
  const int groups = p.G * (kThreads / L);
  double pap = 0.0;
  for (int base = 0; base < p.M; base += groups) {
    const int v = base + (int)blockIdx.x + p.G * g;
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (v < p.M) {
      const int u1 = __ldg(p.v_off + v + 1);
      int u = __ldg(p.v_off + v) + s;
      if (base == 0 && u < u1) {
        cg_contribution(p, it, beta, first.ci, first.vi, first.vj, first.P, acc);
        u += L;
      }
      for (; u < u1; u += L) {
        CgEdge ce;
        cg_edge(p, u, ce);
        cg_contribution(p, it, beta, ce.ci, ce.vi, ce.vj, ce.P, acc);
      }
    }
    for (int o = L / 2; o > 0; o >>= 1)
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[a] += __shfl_xor_sync(kFull, acc[a], o);
    if (v < p.M && s == 0) {
      float pv[6];
      cg_p(p, it, beta, v, pv);
      const float extra = (v >= p.nv ? 1.f : 0.f) + (v == 0 ? kGaugeWeight : 0.f);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float y = (acc[a] + extra * pv[a]) + __ldcg(p.damp + 6 * v + a) * pv[a];
        if (it > 0) pcur[6 * v + a] = pv[a];
        p.ap[6 * v + a] = y;
        pap += (double)(pv[a] * y);
      }
    }
  }
  return pap;
}

// One vertex's x += alpha p, r -= alpha Ap, z = M^-1 r (stored) and its
// shares of r.z and r.r; Mi, x and r in the caller's registers.
__device__ __forceinline__ void cg_vertex(const GridParams& p, int v, float alpha,
                                          const float* pcur, const float (&Mi)[36],
                                          float (&xv)[6], float (&rv)[6], double* rz,
                                          double* rr) {
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    xv[a] += alpha * __ldcg(pcur + 6 * v + a);
    rv[a] = rv[a] - alpha * __ldcg(p.ap + 6 * v + a);
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < 6; ++c) s += Mi[6 * a + c] * rv[c];
    p.z[6 * v + a] = s;
    *rz += (double)(rv[a] * s);
    *rr += (double)(rv[a] * rv[a]);
  }
}

// The CG step (the JAX package's _solve_cg, maxiter 4M, tol 1e-6) into
// p.x (6M floats). Vertex v lives on CTA v mod G: thread t of the CTA
// takes vertices blockIdx.x + G t, + G kThreads, ..., and keeps its first
// one's preconditioner, x and r in registers for the whole solve. Returns
// the iterations run (every CTA alike).
__device__ int cg_step(const GridParams& p, float lam, double* red, double* bc, int step) {
  const int M = p.M, G = p.G, E = p.E;
  const int v0 = blockIdx.x + G * threadIdx.x, vstep = G * kThreads;
  float Mi0[36], x0[6], r0[6];
  double rz_part = 0.0, rr_part = 0.0;
  for (int v = v0; v < M; v += vstep) {
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
    if (v == v0) {
#pragma unroll
      for (int q = 0; q < 36; ++q) Mi0[q] = Mi[q];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      p.damp[6 * v + a] = dmp[a];
      p.x[6 * v + a] = 0.f;
      p.r[6 * v + a] = b[a];
      p.z[6 * v + a] = zz[a];
      p.p0[6 * v + a] = zz[a];
      if (v == v0) {
        x0[a] = 0.f;
        r0[a] = b[a];
      }
      rz_part += (double)(b[a] * zz[a]);
      rr_part += (double)(b[a] * b[a]);
    }
  }
  // This lane's first contribution of the matvec's first round.
  CgEdge first;
  {
    const int L = cg_lanes(p), v = blockIdx.x + G * (threadIdx.x / L);
    if (v < M) {
      const int u = __ldg(p.v_off + v) + (int)threadIdx.x % L;
      if (u < __ldg(p.v_off + v + 1)) cg_edge(p, u, first);
    }
  }
  double bb_part = rr_part;
  block_sum2(&rz_part, &rr_part, red);
  put_slot(p, kSlotRz, rz_part);
  put_slot(p, kSlotRr, rr_part);
  put_slot(p, kSlotBb, block_sum<kWarps>(bb_part, red));
  grid_sync(p.bar, G);
  double rz64, rr64, bb64;
  grid_sum(p, kSlotRz, kSlotRr, bc, &rz64, &rr64);
  bb64 = grid_sum(p, kSlotBb, bc);
  float rz = (float)rz64, rr = (float)rr64;
  const float bnorm2 = fmaxf((float)bb64, 1e-30f);
  stamp(p, 4 + 8 * step + 2);

  int it = 0;
  float beta = 0.f;
  const float tol2 = 1e-12f;
  while (it < 4 * M && rr > tol2 * bnorm2) {
    // Ap, and p' = z + beta p stored for this CTA's vertices.
    float* pcur = (it & 1) ? p.p1 : p.p0;
    put_slot(p, kSlotPAp, block_sum<kWarps>(cg_matvec(p, it, beta, pcur, first), red));
    grid_sync(p.bar, G);
    const float pap = (float)grid_sum(p, kSlotPAp, bc);
    const float alpha = pap > 0.f ? rz / pap : 0.f;
    double rz_new_part = 0.0, rr_new_part = 0.0;
    if (v0 < M) cg_vertex(p, v0, alpha, pcur, Mi0, x0, r0, &rz_new_part, &rr_new_part);
    for (int v = v0 + vstep; v < M; v += vstep) {
      float Mi[36], xv[6], rv[6];
#pragma unroll
      for (int q = 0; q < 36; ++q) Mi[q] = __ldcg(p.minv + 36 * v + q);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        xv[a] = __ldcg(p.x + 6 * v + a);
        rv[a] = __ldcg(p.r + 6 * v + a);
      }
      cg_vertex(p, v, alpha, pcur, Mi, xv, rv, &rz_new_part, &rr_new_part);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        p.x[6 * v + a] = xv[a];
        p.r[6 * v + a] = rv[a];
      }
    }
    block_sum2(&rz_new_part, &rr_new_part, red);
    put_slot(p, kSlotRz, rz_new_part);
    put_slot(p, kSlotRr, rr_new_part);
    grid_sync(p.bar, G);
    double rz_new64, rr_new64;
    grid_sum(p, kSlotRz, kSlotRr, bc, &rz_new64, &rr_new64);
    const float rz_new = (float)rz_new64;
    beta = rz > 0.f ? rz_new / rz : 0.f;
    rz = rz_new;
    rr = (float)rr_new64;
    ++it;
  }
  if (v0 < M)
#pragma unroll
    for (int a = 0; a < 6; ++a) p.x[6 * v0 + a] = x0[a];
  stamp(p, 4 + 8 * step + 3);
  return it;
}

// ------------------------------------------------------------ the kernel

// One instantiation a solver (kDense, kCg), so that each has the
// registers of its own path.
template <int kSolver>
__global__ void __launch_bounds__(kThreads, 1) pose_graph_grid_kernel(GridParams p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double red[2 * kWarps];
  __shared__ float redf[kWarps];
  __shared__ double bc[2];
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
    const float chi2 = (float)grid_sum(p, kSlotChi2, bc);
    stamp(p, 4 + 8 * k + 1);

    // The step: dense (the factorization's pivot flag) or CG.
    int why = kStepUsed;
    const int n = 6 * M;
    int its = 0;
    if constexpr (kSolver == kDense) {
      if (!dense_step(p, lam, smem, k)) why = kPivotFailed;
    } else {
      its = cg_step(p, lam, red, bc, k);
    }
    if (p.timing != nullptr && blockIdx.x == 0 && tid == 0) p.timing[4 + 8 * k + 7] = its;
    grid_sync(p.bar, G);  // every element of the step written
    // The non-finite step zeroed, its norm: every CTA over all of x alike.
    double ss = 0.0;
    bool nonfinite = false;
    if (why == kStepUsed)
      for (int i = tid; i < n; i += kThreads) {
        const float d = __ldcg(p.x + i);
        nonfinite |= !isfinite(d);
        ss += (double)d * d;
      }
    if (__syncthreads_or(nonfinite) && why == kStepUsed) why = kNotFinite;
    const bool bad = why != kStepUsed;
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
    const float chi2_new = (float)grid_sum(p, kSlotTrial, bc);
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
      p.zeroed_out[k] = why;
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
  const float chi2 = (float)grid_sum(p, kSlotFinal, bc);
  if (blockIdx.x == 0) {
    for (int q = 4 * k + tid; q < 4 * p.iterations; q += kThreads) p.stats_out[q] = 0.f;
    for (int q = k + tid; q < p.iterations; q += kThreads) p.zeroed_out[q] = kStepUsed;
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

// Per device and solver, once: cooperative launch support and the blocks
// of the solver's kernel an SM holds at kThreads threads and kSmemFloats
// floats.
struct Prepared {
  int dev, solver, resident;
};
std::mutex g_mutex;
std::vector<Prepared> g_prepared;

int resident_ctas(int dev, int solver, int* out) {
  std::lock_guard<std::mutex> lock(g_mutex);
  for (const Prepared& q : g_prepared)
    if (q.dev == dev && q.solver == solver) {
      *out = q.resident;
      return 0;
    }
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, solver == kDense ? pose_graph_grid_kernel<kDense> : pose_graph_grid_kernel<kCg>,
        kThreads, kSmemFloats * sizeof(float));
  if (e != cudaSuccess) return (int)e;
  const int resident = coop ? per_sm * sms : 0;
  g_prepared.push_back({dev, solver, resident});
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
// sync. Inputs as GridParams (the dense plan's d_idx, b_off and b_list and
// the fill pattern's fill, units and col_units may be null for CG);
// scratch: the plan's out[5] floats; bar: 2 zeroed words; timing: null, or
// 4 + 8 iterations int64 (phase stamps; slot 7 of a step its CG
// iterations). Outputs as dvo_pose_graph's, and zeroed_out: per step why it
// was zeroed (0 used, 1 a failed pivot, 2 not finite; 0 past the last
// step). Returns a CUDA error code (0: launched; kErrNotCoResident where
// the card cannot hold the grid at once).
extern "C" int dvo_pose_graph_grid(
    const float* poses, const float* Z, const float* info, const float* mask,
    const int* edge_i, const int* edge_j, const int* v_off, const int* v_idx,
    const int* d_idx, const int* b_off, const int* b_list, const unsigned* fill,
    const int* units, const int* col_units, int n_units, int M, int E, int nv,
    int iterations, int use_robust, double cauchy_c, double gnc_init, double gnc_decay,
    int gnc_adaptive, int solver, int ctas, float* scratch, unsigned* bar, float* poses_out,
    float* chi2_out, float* weights_out, float* stats_out, int* steps_out, int* zeroed_out,
    long long* timing, void* stream) {
  if (M < 1 || E < 0 || iterations < 0 || ctas < 1 || (solver != kDense && solver != kCg) ||
      (solver == kDense && (d_idx == nullptr || b_off == nullptr || b_list == nullptr ||
                            fill == nullptr || units == nullptr || col_units == nullptr ||
                            n_units < 1)))
    return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int resident = 0;
  const int prepared = resident_ctas(dev, solver, &resident);
  if (prepared) return prepared;
  if (resident < ctas) return kErrNotCoResident;
  const Layout L = layout(M, E, solver, ctas);
  GridParams p = {};
  p.poses = poses; p.Z = Z; p.info = info; p.mask = mask;
  p.edge_i = edge_i; p.edge_j = edge_j; p.v_off = v_off; p.v_idx = v_idx;
  p.d_idx = d_idx; p.b_off = b_off; p.b_list = b_list;
  p.fill = fill; p.units = units; p.col_units = col_units; p.n_units = n_units;
  p.M = M; p.E = E; p.nv = nv; p.iterations = iterations; p.use_robust = use_robust;
  p.gnc_adaptive = gnc_adaptive; p.G = ctas; p.n = 6 * M; p.Pt = L.Pt;
  p.fill_words = (L.Pt + 31) / 32;
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
    p.flags = reinterpret_cast<unsigned*>(scratch + L.flags);
  } else {
    p.minv = scratch + L.minv; p.damp = scratch + L.damp; p.r = scratch + L.r;
    p.z = scratch + L.z; p.p0 = scratch + L.p0; p.p1 = scratch + L.p1; p.ap = scratch + L.ap;
  }
  p.bar = bar;
  p.poses_out = poses_out; p.chi2_out = chi2_out; p.weights_out = weights_out;
  p.stats_out = stats_out; p.steps_out = steps_out; p.zeroed_out = zeroed_out;
  p.timing = timing;
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
  const cudaError_t launched =
      solver == kDense ? cudaLaunchKernelEx(&cfg, pose_graph_grid_kernel<kDense>, p)
                       : cudaLaunchKernelEx(&cfg, pose_graph_grid_kernel<kCg>, p);
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}
