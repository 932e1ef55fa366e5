// IRLS linearization and the per-level IRLS loop for Hopper (sm_90a): one
// kernel body, launched as thread-block clusters, in two modes.
//
// What it replaces. The residual pass holds the bilinear gather of the TPU
// kernel dvo_slam_tpu/ops/pallas/sampler.py::sample_slab (line 226,
// pl.pallas_call at line 413): the sample is taken inside the pass and never
// leaves registers. The rest stands in for what XLA fused on the TPU in
// dvo_slam_tpu/ops/linearize.py:281-539 (warp, sample, bivariate residual,
// t-distribution Sigma fixed point, weights, analytic Jacobian, weighted 6x6
// normal equations) and, in mode (b), for the per-level lax.while_loop of
// dvo_slam_tpu/models/dense_tracker.py:147-296 (accept / revert, LM damping,
// 6x6 solve, exp(delta) T, stop test). The plain PyTorch versions are
// ops/linearize.py::linearize_batched_reference (mode a) and the host loop
// models/dense_tracker.py::_track_level over it (mode b). Both cover every
// scale estimator and influence function of the tracker's config: the
// t-distribution branch (both gradient sources, use_depth on and off, the
// Sigma warm start) and the branch of dvo_slam_tpu/ops/linearize.py:452-482
// (the unit, normal and MAD scales, each influence function, or no
// weighting), and mode (b) runs the motion prior (mu > 0) as
// dvo_slam_tpu/models/dense_tracker.py:192-204 and :283-288 do.
//
//   (a) linearize_kernel: one linearization per batch row at the row's pose
//       T, written as the 53-float Linearization vector (kOut*), and the
//       per-point rI, rZ and valid of the residual pass.
//   (b) track_level_kernel: a pyramid level's whole IRLS loop per batch row,
//       up to max_iterations linearizations and solves in one launch;
//       writes the level's pose, the last accepted linearization (the
//       tracker's 50-float record, kBest*), the per-iteration statistics,
//       the level's count of selected points, the iteration count and the
//       termination code, into the level's slot of one output buffer of
//       all tracked levels (row strides from the caller), and the track
//       result's log-likelihood, pose entropy and valid ratio from its
//       accepted record (what models/dense_tracker.py's eager assembly
//       computes from the finest level's).
//   (c) split_stage_kernel: mode (b)'s loop cut at its cross-rank
//       reductions, for the pixel route (parallel/sharded.py: a row's
//       reference rows split over the ranks of a process group, each rank
//       launching over its band at image row row0, the JAX package's
//       shard_map over dvo_slam_tpu/models/dense_tracker.py's loop with
//       its psums at dvo_slam_tpu/ops/linearize.py:399, :416-445). A
//       launch cannot wait on another process, so each stage writes its
//       rows' partial sums to a (B, kSplitSums) f64 buffer that the caller
//       all-reduces over the group before the next stage reads the totals;
//       the decisions (irls_step_warp) run on the card from those totals, the
//       same bits on every rank. On the t-distribution no launch waits on
//       another CTA, so its stages run on plain CTAs, the last of which
//       (an integer ticket) sums the row's partial sums; the others keep
//       clusters. See split_stage_kernel.
//
// Each kernel is two instantiations: <false> for the t-distribution (the
// default config), <true> for every other scale estimator and for no
// weighting, so that the default's passes carry no estimator branch.
//
// The reference points. Either read from RefData's (B, N) arrays
// (ops/linearize.py::prepare_reference, the plain versions' route), or
// computed in the residual pass from the reference level's (6, H, W) slab
// itself, or from a pixel band's (6, ref_H, W) rows at image row row0 in
// the split mode (the slab route: row b's slab
// by one of up to 32 row pointers in the parameters, by a row pointer the
// launch reads from a table in device memory (the chunked keyframe
// scan's, whose keyframe entry csrc/keyframe_scan.cu chooses on the
// card), or by a stride): back-projection, the selection (finite depth,
// the gradient thresholds through hypotf as torch.hypot calls it, the
// isfinite folds) and the reference gradients, in prepare_reference's
// order with the _rn intrinsics, so both routes give the same bits. That
// removes the front's 16 eager ops a tracked level and its (B, N) copies;
// the dvo_slam_tpu counterpart is dvo_slam_tpu/ops/linearize.py::
// prepare_reference (:77), which XLA fused into the frame's program.
//
// Compaction on the slab route (kCompact; budget > 0, N = budget slots;
// ops/linearize.py::compact_reference, dvo_slam_tpu/ops/linearize.py::
// compact_reference :163 with its slot map _muldiv_floor :138). Before
// the first residual pass each launch builds its rows' slot tables
// (select_slots): CTA r of the row's cluster counts the selected pixels
// of its band of the slab (the selection bits above), the CTAs exchange
// the counts through distributed shared memory (one cluster barrier),
// and warp ballots over each warp's sub-band of the CTA's band give each
// selected pixel its rank q in row-major order. Its slot is q while
// count <= budget, else floor(q budget / count) in 64-bit integers
// (slot_of: exact, so JAX's split int32 map wherever its n < 2^19 assert
// holds); only the first pixel of a slot writes it (q == 0 or floor((q -
// 1) budget / count) differs), as JAX's scatter, so each slot has one
// writer and no atomics are needed. The writer stores its pixel index
// into the slot's owner CTA's table (map_shared_rank; a global (B,
// budget) table where the plan puts it there), and one more cluster
// barrier publishes it. Slots from
// min(count, budget) on are unselected and skipped (the plain version
// replicates the last filled point there, unselected: the same sums and
// residual outputs). Every pass then takes slot j's point from pixel
// slot[j] of the slab. Nothing is carried from one launch to the next.
//
// Layout. One cluster of C CTAs per batch row (grid (C, B), cluster (C, 1,
// 1); C from ops/linearize.py::cluster_size, up to 16, which is a
// non-portable cluster size). CTA r owns points [r P, (r + 1) P), P =
// ceil(N / C), for the whole launch. The residual pass keeps each point's
// rI, rZ, valid and its 7 Jacobian inputs (X, Y, Z and four gradients; 37 B)
// in dynamic shared memory, and the Sigma steps and the normal equations
// read them from there (4 800 points, 178 KB per CTA at 320x240 with C =
// 16). Where P * 37 B does not fit beside the static shared memory (levels
// past 640x480's level 1), nothing is kept and every pass recomputes the
// point from the reference data and the L2-resident slab (the same bits).
//
// Reductions. Warp shuffles, one shared-memory pass per CTA, then every CTA
// reads all C CTAs' sums through distributed shared memory in rank order
// after one cluster barrier (double-buffered, so one barrier per
// reduction). Every CTA thus holds the same sums, and thread 0 of every CTA
// computes the same next state (Sigma, or the whole IRLS step) from them:
// the pose and the stop flag need no broadcast, and every CTA takes the same
// number of barriers. Sums run in f64 from the per-point f32 products on, in
// a fixed order: the same inputs give the same bits every run, and a row's
// bits do not depend on B.
//
// The robust scale off the t-distribution (ops/robust.py). unit: none.
// normal: one reduction of the sums of rI and rZ for the means, then one
// of the squared deviations from them (two passes, as robust.scale_normal;
// the one-pass E[r^2] - mean^2 cancels). The means' sums are not carried in
// the residual pass's moments, which every other estimator reduces too. mad: the
// element robust.scale_mad reads from its sort, index min(n / 2, n - 1) of
// the sorted |r| over the n valid points, for rI and rZ, found by a radix
// select over the f32 bits of |r| (non-negative floats order as unsigned
// integers): kDigitPasses passes of kDigitBits bits, high digit first; in
// each pass every CTA counts its points that match the digits chosen so
// far into a shared-memory histogram of the next digit (integer atomics),
// thread t of every CTA sums bin t over the cluster's CTAs through
// distributed shared memory, and every CTA scans the sums and picks the
// same digit. One cluster barrier a pass (the histograms alternate
// between two buffers, as cluster_sum's sums): a MAD linearization takes
// 4 cluster barriers more than a unit one, a normal one 2 more. The
// element is the plain version's bit for bit.
//
// The residual arithmetic (warp, projection, sample, rI, rZ) uses the _rn
// intrinsics in the plain version's order, so nvcc contracts nothing into
// FMAs and rI, rZ and the valid mask equal the plain version's bit for bit.
// The solve (f32 Cholesky in one thread) and exp do not match cuSOLVER's or
// PyTorch's bits; the tests hold them to stated tolerances.
//
// What bounds it on this card: at B = 1 one cluster uses 16 of the 132 SMs,
// and each IRLS iteration is 7 cluster reductions and a few hundred scalar
// flops in one thread; the bytes an iteration needs (17 B of reference point
// per point and the slab, ~3.15 MB at level 1, ~0.94 us at 3.35 TB/s) are
// far below that. The design removes the host from the loop (one launch per
// level instead of 7 launches, ~130 eager ops and a host sync per
// iteration); larger batches fill the card with more clusters.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr float kEps = 1e-12f;     // ops/linearize.py _EPS
constexpr float kJitter = 1e-8f;   // ops/least_squares.py _JITTER
constexpr int kMomentSums = 5;     // rI^2, rI rZ, rZ^2, valid, selected
constexpr int kScaleSums = 3;      // weighted moments of one Sigma step
constexpr int kNormalSums = 29;    // A (upper, 21), b (6), err_raw, log1p_sum
constexpr int kPointFloats = 9;    // rI, rZ, X, Y, Z, gix, giy, gzx, gzy
constexpr int kPointBytes = 4 * kPointFloats + 1;  // and valid
// The Linearization vector of mode (a) (ops/linearize.py reads the same
// offsets).
// kOutMad: the MAD scale's two selected elements, |rI| and |rZ| before the
// 1.4826 factor (+inf with no valid point; 0 for the other estimators).
constexpr int kOutA = 0, kOutB = 36, kOutErrMean = 42, kOutN = 43,
              kOutNRaw = 44, kOutSigma = 45, kOutLog1p = 49, kOutErrRaw = 50,
              kOutMad = 51, kOutSize = 53;
// Scale estimators and influence functions (ops/linearize.py _ESTIMATORS,
// _INFLUENCES); kEstNone: use_weighting off.
constexpr int kEstTdist = 0, kEstUnit = 1, kEstNormal = 2, kEstMad = 3, kEstNone = 4;
constexpr int kInfUnit = 0, kInfHuber = 1, kInfTukey = 2, kInfTdist = 3;
constexpr float kMadFactor = 1.4826f;  // ops/robust.py scale_mad
// The MAD radix select: digits of the 31 bits of |r| (the sign bit is 0),
// a histogram of 2 x kBins bins a pass (rI's, then rZ's), one bin a thread.
constexpr int kDigitBits = 8, kDigitPasses = 4, kBins = 1 << kDigitBits;
static_assert(kDigitBits * kDigitPasses >= 31, "the digits cover |r|'s bits");
static_assert(2 * kBins == kThreads, "thread t sums bin t across the ranks");
// The tracker's record of the last accepted linearization
// (models/dense_tracker.py _flat).
constexpr int kBestA = 0, kBestB = 36, kBestErr = 42, kBestErrRaw = 43,
              kBestSigma = 44, kBestNRaw = 48, kBestLog1p = 49, kBestSize = 50;
// Mode (b)'s row: pose (16), the log-likelihood of the level's record
// (right after the pose, so that one view holds both), record (50), then
// the statistics (5, max_iterations): valid, error, delta_norm, accepted
// (0 or 1) and zeros (the TPU sampler's window misses), then kExtraSize
// floats at kLevelStats + 5 max_iterations: the level's selected count,
// entropy and valid ratio.
constexpr int kLevelT = 0, kLevelLoglik = 16, kLevelBest = 17, kLevelStats = 67,
              kStatPlanes = 5;
constexpr int kExtraSelected = 0, kExtraEntropy = 1, kExtraRatio = 2, kExtraSize = 3;
// Reference slabs by row pointer (SlamConfig.validation_batch_max), and
// where the slab route finds row b's slab: at a stride from the first, in
// a table of row pointers among the parameters, or in a table of row
// pointers in device memory (ops/linearize.py _TABLE_*).
constexpr int kMaxRefRows = 32;
constexpr int kTableStride = 0, kTableParams = 1, kTableDevice = 2;
// Termination codes (models/dense_tracker.py TERM_*).
constexpr int kTermIterations = 0, kTermIncrement = 1, kTermErrorIncreased = 2,
              kTermTooFew = 3;
// Returned when no cluster of the asked size fits on an SM group of the card.
constexpr int kErrNoActiveCluster = 100001;
// The split mode (ops/linearize.py _SPLIT_*, _SUM_*): a row's stage sums
// (kNormalSums, or the moments or a Sigma step's in the first columns),
// then its valid and selected counts, its done flag (0 or 1) and the Sigma
// steps its iteration takes; the state's floats a row; the stage code of
// the level's last launch.
constexpr int kSumValid = 29, kSumSelected = 30, kSumDone = 31, kSumSteps = 32,
              kSplitSums = 33;
constexpr int kSplitStateWords = 112;
constexpr int kSplitTicketWord = 10;  // SplitState's ticket, a word of its row
constexpr int kStageFinish = 1024;
// The split mode's t-distribution launches: threads a CTA (no cluster), at
// most kMaxSplitCtas CTAs a row, each CTA's partial sums kPartialStride
// doubles apart.
constexpr int kSplitThreads = 256;
constexpr int kMaxSplitCtas = 256;
constexpr int kPartialStride = 32;
static_assert(kPartialStride >= kNormalSums, "a CTA's partial sums fit their slot");
static_assert(kSplitThreads % 32 == 0 && kThreads % kSplitThreads == 0, "whole warps");
// The split mode's phase-timing buffer (ops/linearize.py
// split_timing_buffer / split_phase_times): %globaltimer (ns) at the start
// [0] and end [1] of row 0's first CTA; clock64 at its start [2], with the
// carry loaded [3], the decision taken [4], the pass done [5], its sums
// reduced [6] (the CTA's and, on clusters, the cluster's; the
// t-distribution: into its partial slot, and its ticket taken), the
// row's sums in place [7] (clusters: past the barrier; the
// t-distribution: the last CTA's sum of the partials, nothing where this
// CTA is not the last) and with the sums and the carry written [8].
constexpr int kSplitTimingSlots = 9;
static_assert(kSumValid >= kNormalSums, "the counts follow the normal equations' sums");

struct Params {
  // Reference points (B, N), ops/linearize.py::RefData.
  const float* px;
  const float* py;
  const float* pz;
  const float* i1;
  const uint8_t* selected;
  const float* rgix;  // reference gradients; null unless gradient_source
  const float* rgiy;  // is "reference" (rgzx, rgzy: also null without
  const float* rgzx;  // depth)
  const float* rgzy;
  // The slab route: row b's (6, H, W) reference slab is ref_rows[b]
  // (ref_table kTableParams), ref_dev[b] (kTableDevice: a table in device
  // memory, read by the launch itself) or ref_rows[0] + b * ref_stride
  // floats (kTableStride); a null ref_rows[0] and ref_dev read the arrays
  // above. igt, dgt: the gradient thresholds of the selection
  // (cfg.intensity_grad_threshold, depth_grad_threshold).
  const float* ref_rows[kMaxRefRows];
  const float* const* ref_dev;
  int64_t ref_stride;
  int ref_table;
  float igt, dgt;
  // Compaction on the slab route: the slot count (0: the full grid) and,
  // where the plan keeps the slot tables out of shared memory, a (B,
  // budget) int32 table in device memory.
  int budget;
  int* slots;
  // The reference slab's rows (H, or a pixel band's) and the image row of
  // its first (a pixel band's offset, ops/linearize.py::prepare_reference's
  // row_offset; 0 otherwise).
  int ref_H, row0;
  int N;
  const float* slab;    // (6, H, W) current pyramid level of row 0
  int64_t slab_stride;  // floats from one row's slab to the next (0: shared)
  int H, W;
  const float* K;           // (4,) fx, fy, cx, cy, shared by every row
  const float* T;           // (B, 4, 4) row-major: the pose (a), T_init (b)
  int64_t T_stride;         // floats from one row's T to the next
  const float* sigma_init;  // (B, 2, 2) or null; mode (a) with warm only
  int use_depth, ref_grad, warm;
  float nu, floor_ii, floor_zz;
  int scale_iters, warm_iters;
  // The scale estimator and influence function (kEst*, kInf*), their
  // parameters, and the scale floors min_intensity_sigma, min_depth_sigma.
  int estimator, influence;
  float huber_k, tukey_b, min_si, min_sz;
  // Mode (b): the IRLS loop.
  int max_iterations;
  float precision, lm_init, lm_up, lm_down, lm_max;
  float mu;  // the motion prior's weight (0: none)
  // Mode (b): lgamma((nu + 2) / 2) - lgamma(nu / 2) - log(nu pi), for the
  // log-likelihood.
  double loglik_const;
  // Points per CTA, whether they are kept in shared memory, and whether
  // compaction's slot table is (at byte slot_at of the dynamic shared
  // memory).
  int P, stored, slots_shared;
  int64_t slot_at;
  // Outputs. (a): out (B, 53), rI / rZ / valid (B, N). (b): row b's
  // kLevelStats + 5 * max_iterations + kExtraSize floats at out + b *
  // out_stride, its iterations and termination at out_i + b * out_i_stride.
  float* out;
  int* out_i;
  int64_t out_stride, out_i_stride;
  float* rI;
  float* rZ;
  uint8_t* valid;
  // The split mode: the rows' state ((B, kSplitStateWords) floats), their
  // stage sums ((B, kSplitSums) f64: the totals of the launch before on
  // entry, this launch's partial sums on exit), the stage code (0, a Sigma
  // step 1..split_steps, split_steps + 1 the normal equations, or
  // kStageFinish) and the caller's iteration.
  float* split_state;
  double* split_sums;
  int split_stage, split_steps, split_iter;
  // The split mode's points, kept in device memory from stage 0 to the
  // stages after it: per CTA the shared-memory layout of Points (at a
  // stride of points_bytes(P)).
  uint8_t* split_points;
  // The split mode's phase stamps (kSplitTiming* slots; null on the main
  // path), written by row 0's rank-0 CTA.
  long long* split_timing;
};

// Bytes of one CTA's kept points (P floats of each of kPointFloats planes,
// then P valid flags), rounded up to 16.
__host__ __device__ __forceinline__ int64_t points_bytes(int P) {
  return ((int64_t)kPointBytes * P + 15) & ~(int64_t)15;
}

// One batch row's reference points (or reference slab) and current slab.
struct Row {
  const float *px, *py, *pz, *i1, *rgix, *rgiy, *rgzx, *rgzy;
  const uint8_t* selected;
  const float* ref;  // the slab route's reference slab, else null
  const float* slab;
};

__device__ __forceinline__ Row row_of(const Params& p, int b) {
  const int64_t o = (int64_t)b * p.N;
  Row r;
  r.px = p.px + o;
  r.py = p.py + o;
  r.pz = p.pz + o;
  r.i1 = p.i1 + o;
  r.selected = p.selected + o;
  r.rgix = p.rgix ? p.rgix + o : nullptr;
  r.rgiy = p.rgiy ? p.rgiy + o : nullptr;
  r.rgzx = p.rgzx ? p.rgzx + o : nullptr;
  r.rgzy = p.rgzy ? p.rgzy + o : nullptr;
  r.ref = p.ref_table == kTableDevice   ? p.ref_dev[b]
          : p.ref_table == kTableParams ? p.ref_rows[b]
          : (p.ref_rows[0] ? p.ref_rows[0] + b * p.ref_stride : nullptr);
  r.slab = p.slab + b * p.slab_stride;
  return r;
}

// Per-CTA state. Every CTA of a cluster holds the same values: thread 0 of
// each computes them from the same cluster sums.
struct Shared {
  double warp[kNormalSums * kWarps];  // per-warp sums of one reduction
  double part[2][32];  // this CTA's sums of the current reduction (2 buffers)
  double tot[32];      // the cluster's sums
  float T[16];         // the pose the next linearization is taken at
  float Tbest[16];     // mode (b): the pose of the last accepted one
  float Tinit[16];     // mode (b): the level's initial pose (the prior's)
  unsigned hist[2][2 * kBins];  // MAD: this CTA's digit counts (2 buffers)
  unsigned scan[kWarps];        // MAD: each warp's inclusive bin sums
  unsigned digit[2], below[2];  // MAD: the pass's digit, the points under it
  float best[kBestSize];
  float lin[kOutSize];  // the last linearization
  float a, bq, c, n, n_raw;  // Sigma entries, valid count floored and raw
  float n_sel;               // selected reference points
  float lam;
  int n_fp, done, term;
  // Compaction: each warp's selected pixels, this CTA's count and the
  // counts of the ranks before it, the row's count, and its filled slots
  // min(count, budget).
  unsigned sel_warp[kWarps];
  int sel_count, sel_off, sel_total, n_fill;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// ops/linearize.py::warp's guard: 1 / Z with |Z| < 1e-8 moved to +-1e-8,
// keeping its sign (a point behind the camera is never flipped forward).
__device__ __forceinline__ float guarded_inv(float Z) {
  const float Zg = (fabsf(Z) < 1e-8f) ? (Z < 0.f ? -1e-8f : 1e-8f) : Z;
  return __frcp_rn(Zg);
}

struct Point {
  float X, Y, Z, gix, giy, gzx, gzy, rI, rZ;
  bool valid, selected;
};

// Reference point i: from RefData's arrays, or from the reference slab in
// the order of ops/linearize.py::prepare_reference (the reference gradients
// only with ref_grad, the depth ones only with use_depth too).
struct RefPoint {
  float px, py, pz, i1, gix, giy, gzx, gzy;
  bool selected;
};

__device__ __forceinline__ float finite_or0(float x) { return isfinite(x) ? x : 0.f; }

// prepare_reference's selection of a pixel from its depth z, intensity
// gradient (ix, iy) and depth gradient (zx, zy): the gradients are read
// only where a threshold or the reference-gradient fold needs them.
__device__ __forceinline__ bool selection(const Params& p, float z, float ix, float iy,
                                          float zx, float zy) {
  bool sel = isfinite(z);
  if (p.igt > 0.f) sel = sel && (hypotf(ix, iy) >= p.igt);
  if (p.dgt > 0.f) {
    const float gz = hypotf(zx, zy);
    sel = sel && isfinite(gz) && (gz >= p.dgt);
  }
  if (p.ref_grad && p.use_depth) sel = sel && isfinite(zx) && isfinite(zy);
  return sel;
}

// A pixel's six reference planes on the slab route (ref_point's loads).
struct RefRaw {
  float z, ix, iy, zx, zy, i1;
};

__device__ __forceinline__ RefRaw ref_raw(const Params& p, const Row& r, int i) {
  const int64_t plane = (int64_t)p.ref_H * p.W;
  const float* s = r.ref + i;
  RefRaw w;
  w.z = __ldg(s + plane);
  w.ix = __ldg(s + 2 * plane);
  w.iy = __ldg(s + 3 * plane);
  w.zx = __ldg(s + 4 * plane);
  w.zy = __ldg(s + 5 * plane);
  w.i1 = __ldg(s);
  return w;
}

// Reference pixel i of the slab route from its planes (ref_point's
// arithmetic after its loads).
__device__ __forceinline__ RefPoint ref_point_of(const Params& p, const RefRaw& w, int i) {
  RefPoint q;
  q.gix = q.giy = q.gzx = q.gzy = 0.f;
  const bool sel = selection(p, w.z, w.ix, w.iy, w.zx, w.zy);
  if (p.ref_grad) {
    q.gix = finite_or0(w.ix);
    q.giy = finite_or0(w.iy);
    if (p.use_depth) {
      q.gzx = finite_or0(w.zx);
      q.gzy = finite_or0(w.zy);
    }
  }
  const float zs = sel ? w.z : 1.f;
  const int v = i / p.W, u = i - v * p.W;
  q.px = mul(__fdiv_rn(sub((float)u, __ldg(p.K + 2)), __ldg(p.K + 0)), zs);
  q.py = mul(__fdiv_rn(sub((float)(v + p.row0), __ldg(p.K + 3)), __ldg(p.K + 1)), zs);
  q.pz = zs;
  q.i1 = w.i1;
  q.selected = sel;
  return q;
}

__device__ __forceinline__ RefPoint ref_point(const Params& p, const Row& r, int i) {
  if (!r.ref) {
    RefPoint q;
    q.gix = q.giy = q.gzx = q.gzy = 0.f;
    q.px = __ldg(r.px + i);
    q.py = __ldg(r.py + i);
    q.pz = __ldg(r.pz + i);
    q.i1 = __ldg(r.i1 + i);
    q.selected = r.selected[i];
    if (p.ref_grad) {
      q.gix = __ldg(r.rgix + i);
      q.giy = __ldg(r.rgiy + i);
      if (p.use_depth) {
        q.gzx = __ldg(r.rgzx + i);
        q.gzy = __ldg(r.rgzy + i);
      }
    }
    return q;
  }
  return ref_point_of(p, ref_raw(p, r, i), i);
}

// Warp, project, sample and residual of reference point rp at pose T, in
// the order of ops/linearize.py::residuals_reference (and ops/sampler.py's
// plain sample).
__device__ __forceinline__ Point residual_of(const Params& p, const Row& r, const float* T,
                                             const RefPoint& rp) {
  const float px = rp.px, py = rp.py, pz = rp.pz;
  Point q;
  q.X = add(add(add(mul(T[0], px), mul(T[1], py)), mul(T[2], pz)), T[3]);
  q.Y = add(add(add(mul(T[4], px), mul(T[5], py)), mul(T[6], pz)), T[7]);
  q.Z = add(add(add(mul(T[8], px), mul(T[9], py)), mul(T[10], pz)), T[11]);
  const float zi = guarded_inv(q.Z);
  const float u = add(mul(mul(__ldg(p.K + 0), q.X), zi), __ldg(p.K + 2));
  const float v = add(mul(mul(__ldg(p.K + 1), q.Y), zi), __ldg(p.K + 3));

  // Bilinear sample, as csrc/sampler.cu: clamp in float before the cast (a
  // NaN coordinate clamps to 0 and is flagged out of bounds).
  const int W = p.W, H = p.H;
  const float u0f = floorf(u), v0f = floorf(v);
  const float wmax = (float)(W - 2), hmax = (float)(H - 2);
  const bool inb = (u0f >= 0.f) && (v0f >= 0.f) && (u0f <= wmax) && (v0f <= hmax);
  const float x0f = (u0f >= 0.f) ? fminf(u0f, wmax) : 0.f;
  const float y0f = (v0f >= 0.f) ? fminf(v0f, hmax) : 0.f;
  const float fu = sub(u, x0f), fv = sub(v, y0f);
  const int64_t plane = (int64_t)H * W;
  const int n_smp = p.ref_grad ? (p.use_depth ? 2 : 1) : 6;
  float s[6];
  const float* c0 = r.slab + (int64_t)y0f * W + (int64_t)x0f;
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) {
    if (ch < n_smp) {
      const float* cp = c0 + ch * plane;
      const float s00 = __ldg(cp), s01 = __ldg(cp + 1);
      const float s10 = __ldg(cp + W), s11 = __ldg(cp + W + 1);
      const float top = add(s00, mul(fu, sub(s01, s00)));
      const float bot = add(s10, mul(fu, sub(s11, s10)));
      s[ch] = add(top, mul(fv, sub(bot, top)));
    } else {
      s[ch] = 0.f;
    }
  }
  const float i2 = s[0];
  const float z2 = (p.use_depth || !p.ref_grad) ? s[1] : 0.f;
  if (p.ref_grad) {
    q.gix = rp.gix;
    q.giy = rp.giy;
    q.gzx = rp.gzx;
    q.gzy = rp.gzy;
  } else {
    q.gix = s[2];
    q.giy = s[3];
    q.gzx = s[4];
    q.gzy = s[5];
  }
  const float rI = sub(i2, rp.i1);
  const float rZ = sub(z2, q.Z);
  q.selected = rp.selected;
  bool valid = rp.selected && inb && (q.Z > 1e-6f) && isfinite(rI);
  if (p.use_depth) valid = valid && isfinite(rZ) && isfinite(q.gzx) && isfinite(q.gzy);
  q.valid = valid;
  q.rI = valid ? rI : 0.f;
  q.rZ = (valid && p.use_depth) ? rZ : 0.f;
  return q;
}

// The residual of reference point i.
__device__ __forceinline__ Point residual(const Params& p, const Row& r, const float* T, int i) {
  return residual_of(p, r, T, ref_point(p, r, i));
}

// The CTA's slice of points in shared memory, structure of arrays, and
// under compaction its slot table (slot j's pixel; in shared memory or in
// the global table).
struct Points {
  float* f;  // kPointFloats planes of P floats
  uint8_t* valid;
  int* slot;
  int P;
  __device__ float& at(int plane, int j) const { return f[plane * P + j]; }
};

// The reference pixel of this CTA's point j: base + j on the full grid;
// under compaction slot j's pixel, or -1 for a slot past the row's filled
// ones (no point).
template <bool kCompact>
__device__ __forceinline__ int pixel_of(const Shared& sh, const Points& s, int base, int j) {
  if (!kCompact) return base + j;
  return base + j < sh.n_fill ? s.slot[j] : -1;
}

// A slot without a point: unselected and not valid, rI = rZ = 0 (the
// plain version's unselected replicas give the same outputs and sums).
__device__ __forceinline__ Point no_point() {
  Point q;
  q.X = q.Y = q.Z = q.gix = q.giy = q.gzx = q.gzy = q.rI = q.rZ = 0.f;
  q.valid = q.selected = false;
  return q;
}

// The residual of pixel i at pose T, or no point (i < 0, compaction only).
template <bool kCompact>
__device__ __forceinline__ Point residual_at(const Params& p, const Row& r, const float* T,
                                             int i) {
  if (kCompact && i < 0) return no_point();
  return residual(p, r, T, i);
}

__device__ __forceinline__ void store_point(const Points& s, int j, const Point& q) {
  s.at(0, j) = q.rI;
  s.at(1, j) = q.rZ;
  s.at(2, j) = q.X;
  s.at(3, j) = q.Y;
  s.at(4, j) = q.Z;
  s.at(5, j) = q.gix;
  s.at(6, j) = q.giy;
  s.at(7, j) = q.gzx;
  s.at(8, j) = q.gzy;
  s.valid[j] = q.valid;
}

// Point j of this CTA (its points start at base): from shared memory, or
// recomputed where nothing is kept (`full`: the Jacobian inputs too).
template <bool full, bool kCompact>
__device__ __forceinline__ Point load_point(const Params& p, const Row& r,
                                            const Shared& sh, const Points& s,
                                            int base, int j) {
  if (!p.stored) return residual_at<kCompact>(p, r, sh.T, pixel_of<kCompact>(sh, s, base, j));
  Point q;
  q.selected = false;  // read by the residual pass only
  q.rI = s.at(0, j);
  q.rZ = s.at(1, j);
  q.valid = s.valid[j];
  if (full) {
    q.X = s.at(2, j);
    q.Y = s.at(3, j);
    q.Z = s.at(4, j);
    q.gix = s.at(5, j);
    q.giy = s.at(6, j);
    q.gzx = s.at(7, j);
    q.gzy = s.at(8, j);
  }
  return q;
}

// The cluster's sums of M per-thread values, into sh.tot in every CTA, in a
// fixed order: warp shuffles, the warps in order, then the CTAs in rank
// order through distributed shared memory. One cluster barrier: the two
// part buffers alternate, so a CTA writes a buffer again only after the
// next reduction's barrier, which every CTA passes after reading it.
template <int M>
__device__ __forceinline__ void cluster_sum(double (&v)[M], Shared& sh,
                                            int& parity, int C) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    double x = v[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) sh.warp[m * kWarps + warp] = x;
  }
  __syncthreads();
  double* mine = sh.part[parity];
  if (threadIdx.x < M) {
    double x = sh.warp[threadIdx.x * kWarps];
    for (int w = 1; w < kWarps; ++w) x += sh.warp[threadIdx.x * kWarps + w];
    mine[threadIdx.x] = x;
  }
  cluster.sync();
  if (threadIdx.x < M) {
    double x = *cluster.map_shared_rank(mine + threadIdx.x, 0);
    for (int r = 1; r < C; ++r) x += *cluster.map_shared_rank(mine + threadIdx.x, r);
    sh.tot[threadIdx.x] = x;
  }
  __syncthreads();
  parity ^= 1;
}

// Sigma's precision entries, in the plain version's order.
struct Precision {
  float det, p00, p01, p11;
};

__device__ __forceinline__ Precision precision(float a, float bq, float c) {
  Precision r;
  r.det = fmaxf(sub(mul(a, c), mul(bq, bq)), kEps);
  r.p00 = __fdiv_rn(c, r.det);
  r.p01 = __fdiv_rn(-bq, r.det);
  r.p11 = __fdiv_rn(a, r.det);
  return r;
}

// maha and the t-distribution weight of one valid point:
// w = (nu + 2) / (nu + maha), as reciprocal-then-scale like PyTorch's
// scalar / tensor.
__device__ __forceinline__ void tdist_weight(const Precision& P, float nu, float rI,
                                             float rZ, float* maha, float* w) {
  const float sII = mul(rI, rI), sIZ = mul(rI, rZ), sZZ = mul(rZ, rZ);
  *maha = add(add(mul(P.p00, sII), mul(mul(2.f, P.p01), sIZ)), mul(P.p11, sZZ));
  *w = mul(__frcp_rn(add(*maha, nu)), nu + 2.f);
}

// torch.clamp(x, min=lo): NaN stays NaN (fmaxf would drop it).
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// maha and the weight of one valid point off the t-distribution
// (ops/linearize.py::linearize_reference's other branch): maha = rI^2 / a +
// rZ^2 / c and w = influence(sqrt(maha)), or 1 unweighted; scalar / tensor
// as reciprocal-then-scale, as there.
__device__ __forceinline__ void point_weight(const Params& p, const Precision& P, float rI,
                                             float rZ, float* maha, float* w) {
  *maha = add(mul(P.p00, mul(rI, rI)), mul(P.p11, mul(rZ, rZ)));
  if (p.estimator == kEstNone) {
    *w = 1.f;
    return;
  }
  const float x = __fsqrt_rn(*maha);
  if (p.influence == kInfHuber) {
    const float ax = fabsf(x);
    *w = ax <= p.huber_k ? 1.f : mul(__frcp_rn(clamp_min(ax, kEps)), p.huber_k);
  } else if (p.influence == kInfTukey) {
    const float xb = __fdiv_rn(x, p.tukey_b);
    const float t = sub(1.f, mul(xb, xb));
    *w = fabsf(x) <= p.tukey_b ? mul(t, t) : 0.f;
  } else if (p.influence == kInfTdist) {
    *w = mul(__frcp_rn(add(p.nu, mul(x, x))), add(p.nu, 1.f));
  } else {
    *w = 1.f;
  }
}

// The MAD scale's element for rI and rZ (see the header): the k-th
// smallest |r| over the row's `count` valid points, k = min(count / 2,
// count - 1), by a radix select; count > 0, the same in every CTA. Every
// CTA ends with the same sh.lin[kOutMad + c].
template <bool kCompact>
__device__ void mad_select(const Params& p, const Row& r, Shared& sh, const Points& s,
                           int base, int n_mine, int count) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, ch = t / kBins;
  const unsigned k = (unsigned)min(count / 2, count - 1);
  unsigned prefix[2] = {0u, 0u}, rank[2] = {k, k}, mask = 0u;
  for (int pass = 0; pass < kDigitPasses; ++pass) {
    const int shift = kDigitBits * (kDigitPasses - 1 - pass);
    unsigned* hist = sh.hist[pass & 1];
    hist[t] = 0u;
    __syncthreads();
    for (int j = threadIdx.x; j < n_mine; j += kThreads) {
      const Point q = load_point<false, kCompact>(p, r, sh, s, base, j);
      if (!q.valid) continue;
      const unsigned bI = __float_as_uint(q.rI) & 0x7fffffffu;
      const unsigned bZ = __float_as_uint(q.rZ) & 0x7fffffffu;
      if ((bI & mask) == prefix[0]) atomicAdd(hist + ((bI >> shift) & (kBins - 1)), 1u);
      if ((bZ & mask) == prefix[1])
        atomicAdd(hist + kBins + ((bZ >> shift) & (kBins - 1)), 1u);
    }
    // Every CTA's counts are in place past the barrier (release /
    // acquire); a buffer is written again two passes on, after the next
    // barrier, which every CTA passes only once it has read this one.
    cluster.sync();
    unsigned v = 0u;
    for (int q = 0; q < C; ++q) v += *cluster.map_shared_rank(hist + t, q);
    // The inclusive sum of this channel's bins up to bin t.
    unsigned incl = v;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) sh.scan[warp] = incl;
    __syncthreads();
    for (int w = ch * (kBins / 32); w < warp; ++w) incl += sh.scan[w];
    const unsigned excl = incl - v, want = rank[ch];
    if (excl <= want && want < incl) {
      sh.digit[ch] = t & (kBins - 1);
      sh.below[ch] = excl;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      prefix[c] |= sh.digit[c] << shift;
      rank[c] -= sh.below[c];
    }
    mask |= (unsigned)(kBins - 1) << shift;
    // sh.scan, digit and below are written again only past the next
    // pass's barriers, which every thread reaches after reading them.
  }
  if (threadIdx.x == 0) {
    sh.lin[kOutMad] = __uint_as_float(prefix[0]);
    sh.lin[kOutMad + 1] = __uint_as_float(prefix[1]);
  }
  __syncthreads();
}

// The robust scale off the t-distribution (ops/linearize.py::
// linearize_reference's other branch, ops/robust.py): Sigma = diag(a, c)
// into sh.a, sh.bq = 0, sh.c, with s_i, s_z clamped to the floors
// (weighted), or a = c = 1 (unweighted). After the residual pass.
template <bool kCompact>
__device__ void robust_scale(const Params& p, const Row& r, Shared& sh, const Points& s,
                             int base, int n_mine, int& parity, int C) {
  float si = 1.f, sz = 1.f;
  if (p.estimator == kEstNormal) {
    // scale_normal: the masked mean, then the masked mean of the squared
    // deviations from it (a second pass), sqrt(var + 1e-12).
    const float n = sh.n;
    double m[2] = {0.0, 0.0};
    for (int j = threadIdx.x; j < n_mine; j += kThreads) {
      const Point q = load_point<false, kCompact>(p, r, sh, s, base, j);
      if (q.valid) {
        m[0] += (double)q.rI;
        m[1] += (double)q.rZ;
      }
    }
    cluster_sum<2>(m, sh, parity, C);
    const float mean_i = __fdiv_rn((float)sh.tot[0], n);
    const float mean_z = __fdiv_rn((float)sh.tot[1], n);
    m[0] = m[1] = 0.0;
    for (int j = threadIdx.x; j < n_mine; j += kThreads) {
      const Point q = load_point<false, kCompact>(p, r, sh, s, base, j);
      if (q.valid) {
        const float di = sub(q.rI, mean_i), dz = sub(q.rZ, mean_z);
        m[0] += (double)mul(di, di);
        m[1] += (double)mul(dz, dz);
      }
    }
    cluster_sum<2>(m, sh, parity, C);
    si = __fsqrt_rn(add(__fdiv_rn((float)sh.tot[0], n), 1e-12f));
    sz = __fsqrt_rn(add(__fdiv_rn((float)sh.tot[1], n), 1e-12f));
  } else if (p.estimator == kEstMad) {
    // scale_mad: 1.4826 x the selected element, 1 where it is not finite
    // (no valid point).
    const int count = (int)sh.n_raw;
    if (count > 0) {
      mad_select<kCompact>(p, r, sh, s, base, n_mine, count);
    } else if (threadIdx.x == 0) {
      sh.lin[kOutMad] = sh.lin[kOutMad + 1] = __int_as_float(0x7f800000);
    }
    __syncthreads();
    const float ei = sh.lin[kOutMad], ez = sh.lin[kOutMad + 1];
    si = mul(kMadFactor, isfinite(ei) ? ei : 1.f);
    sz = mul(kMadFactor, isfinite(ez) ? ez : 1.f);
  }
  if (p.estimator != kEstNone) {
    si = clamp_min(si, p.min_si);
    sz = clamp_min(sz, p.min_sz);
  }
  if (threadIdx.x == 0) {
    sh.a = mul(si, si);
    sh.bq = 0.f;
    sh.c = mul(sz, sz);
  }
  __syncthreads();
}

// The linearization's passes (linearize_row runs them in one launch, the
// split mode one stage launch each). The cluster's sums land in sh.tot;
// the thread-0 steps read sums from `tot` (sh.tot, or the all-reduced sums
// of the split mode's stage buffer).

// Residual pass: every point of this CTA's slice at sh.T (kept in shared
// memory where the plan keeps points; mode (a) writes rI, rZ and valid
// out), and the residual moments: sh.tot[0..4] = the sums of rI^2, rI rZ,
// rZ^2, the valid and the selected points.
template <bool kCompact>
__device__ __forceinline__ void residual_pass(const Params& p, const Row& r, Shared& sh,
                                              const Points& s, int b, int base, int n_mine,
                                              int& parity, int C, bool residuals) {
  const int64_t row0 = (int64_t)b * p.N;
  double m[kMomentSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int j = threadIdx.x; j < n_mine; j += kThreads) {
    const int i = base + j;
    const Point q = residual_at<kCompact>(p, r, sh.T, pixel_of<kCompact>(sh, s, base, j));
    if (p.stored) store_point(s, j, q);
    if (residuals) {
      p.rI[row0 + i] = q.rI;
      p.rZ[row0 + i] = q.rZ;
      p.valid[row0 + i] = q.valid;
    }
    if (q.valid) {
      m[0] += (double)mul(q.rI, q.rI);
      m[1] += (double)mul(q.rI, q.rZ);
      m[2] += (double)mul(q.rZ, q.rZ);
      m[3] += 1.0;
    }
    if (q.selected) m[4] += 1.0;
  }
  cluster_sum<kMomentSums>(m, sh, parity, C);
}

// Thread 0: the valid counts (sh.n_raw, sh.n floored at 1) and Sigma's
// seed from the moment sums sII, sIZ, sZZ and the valid count: the moment
// estimate, or `seed` (2, 2) when `warm` and finite (the t-distribution
// only); sh.n_fp the Sigma steps to take.
__device__ __forceinline__ void seed_sigma(const Params& p, Shared& sh, double sII, double sIZ,
                                           double sZZ, double valid, bool tdist, bool warm,
                                           const float* seed) {
  const float n_raw = (float)valid;
  const float n = fmaxf(n_raw, 1.f);
  float a = add(__fdiv_rn((float)sII, n), p.floor_ii);
  float bq = __fdiv_rn((float)sIZ, n);
  float c = add(__fdiv_rn((float)sZZ, n), p.floor_zz);
  int n_fp = tdist ? p.scale_iters : 0;
  if (tdist && warm) {
    // Warm start from the previous Sigma when it is finite
    // (dvo_slam_tpu/ops/linearize.py:422-431 decides it with jnp.where).
    const float s00 = seed[0], s01 = seed[1], s10 = seed[2], s11 = seed[3];
    if (isfinite(s00) && isfinite(s01) && isfinite(s10) && isfinite(s11)) {
      a = fmaxf(s00, p.floor_ii);
      bq = s01;
      c = fmaxf(s11, p.floor_zz);
      n_fp = p.warm_iters;
    }
  }
  sh.a = a;
  sh.bq = bq;
  sh.c = c;
  sh.n = n;
  sh.n_raw = n_raw;
  sh.n_fp = n_fp;
}

// One Sigma step's weighted moments under the current Sigma, in sh.tot[0..2].
template <bool kCompact>
__device__ __forceinline__ void sigma_pass(const Params& p, const Row& r, Shared& sh,
                                           const Points& s, int base, int n_mine, int& parity,
                                           int C) {
  const Precision P = precision(sh.a, sh.bq, sh.c);
  double m[kScaleSums] = {0.0, 0.0, 0.0};
  for (int j = threadIdx.x; j < n_mine; j += kThreads) {
    const Point q = load_point<false, kCompact>(p, r, sh, s, base, j);
    if (q.valid) {
      float maha, w;
      tdist_weight(P, p.nu, q.rI, q.rZ, &maha, &w);
      m[0] += (double)mul(w, mul(q.rI, q.rI));
      m[1] += (double)mul(w, mul(q.rI, q.rZ));
      m[2] += (double)mul(w, mul(q.rZ, q.rZ));
    }
  }
  cluster_sum<kScaleSums>(m, sh, parity, C);
}

// Thread 0: Sigma from one step's weighted moment sums.
__device__ __forceinline__ void sigma_update(const Params& p, Shared& sh, const double* tot) {
  sh.a = add(__fdiv_rn((float)tot[0], sh.n), p.floor_ii);
  sh.bq = __fdiv_rn((float)tot[1], sh.n);
  sh.c = add(__fdiv_rn((float)tot[2], sh.n), p.floor_zz);
}

// The precision the weights and the normal equations take: Sigma's inverse,
// or off the t-distribution diag(1 / a, 1 / c) with det = a c.
__device__ __forceinline__ Precision lin_precision(const Shared& sh, bool tdist) {
  Precision P;
  if (tdist) {
    P = precision(sh.a, sh.bq, sh.c);
  } else {
    P.det = fmaxf(mul(sh.a, sh.c), kEps);
    P.p00 = __frcp_rn(sh.a);
    P.p01 = 0.f;
    P.p11 = __frcp_rn(sh.c);
  }
  return P;
}

// Thread 0: the Linearization vector sh.lin from the normal equations' sums
// `tot` (A's upper triangle, b, err_raw, log1p_sum) at precision P, with
// Sigma and the valid counts in sh.
__device__ __forceinline__ void finish_lin(const Params& p, Shared& sh, const double* tot,
                                           const Precision& P, bool tdist) {
  float* o = sh.lin;
  int e = 0;
  for (int j = 0; j < 6; ++j) {
    for (int k = j; k < 6; ++k, ++e) {
      o[kOutA + 6 * j + k] = (float)tot[e];
      o[kOutA + 6 * k + j] = (float)tot[e];
    }
  }
  for (int k = 0; k < 6; ++k) o[kOutB + k] = (float)tot[21 + k];
  const float log1p_sum = (float)tot[28];
  const float err_raw = (float)tot[27];
  if (tdist) {
    o[kOutErrMean] =
        add(0.5f * logf(P.det), __fdiv_rn((p.nu + 2.f) * 0.5f * log1p_sum, sh.n));
  } else if (p.estimator == kEstNone) {
    o[kOutErrMean] = __fdiv_rn(err_raw, sh.n);
  } else {
    o[kOutErrMean] = add(__fdiv_rn(err_raw, sh.n), logf(P.det));
  }
  o[kOutN] = sh.n;
  o[kOutNRaw] = sh.n_raw;
  o[kOutSigma + 0] = sh.a;
  o[kOutSigma + 1] = sh.bq;
  o[kOutSigma + 2] = sh.bq;
  o[kOutSigma + 3] = sh.c;
  o[kOutLog1p] = log1p_sum;
  o[kOutErrRaw] = err_raw;
}

// Weights, Jacobian and the normal equations' sums at precision P
// (ops/linearize.py::normal_equations_reference), in sh.tot[0..28].
template <bool kCompact, bool tdist>
__device__ __forceinline__ void normal_sums(const Params& p, const Row& r, const Shared& sh,
                                            const Points& s, int base, int n_mine,
                                            const Precision& P, double (&acc)[kNormalSums],
                                            int nt = kThreads) {
  const float p01 = p.use_depth ? P.p01 : 0.f;
  const float p11 = p.use_depth ? P.p11 : 0.f;
  const float fx = __ldg(p.K + 0), fy = __ldg(p.K + 1);
  for (int j = threadIdx.x; j < n_mine; j += nt) {
    const Point q = load_point<true, kCompact>(p, r, sh, s, base, j);
    if (!q.valid) continue;
    float maha, w;
    if (tdist)
      tdist_weight(P, p.nu, q.rI, q.rZ, &maha, &w);
    else
      point_weight(p, P, q.rI, q.rZ, &maha, &w);
    const float X = q.X, Y = q.Y, Z = q.Z, zi = guarded_inv(q.Z);
    const float A_ = fx * zi, B_ = fy * zi;
    const float C_ = -fx * X * zi * zi, D_ = -fy * Y * zi * zi;
    const float Ju[6] = {A_, 0.f, C_, C_ * Y, A_ * Z - C_ * X, -A_ * Y};
    const float Jv[6] = {0.f, B_, D_, -B_ * Z + D_ * Y, -D_ * X, B_ * X};
    const float Jg3[6] = {0.f, 0.f, 1.f, Y, -X, 0.f};
    float JI[6], JZ[6], GI[6], GZ[6];
    const float wI = w * P.p00, wX = w * p01, wZ = w * p11;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      JI[k] = q.gix * Ju[k] + q.giy * Jv[k];
      JZ[k] = p.use_depth ? q.gzx * Ju[k] + q.gzy * Jv[k] - Jg3[k] : 0.f;
      GI[k] = wI * JI[k] + wX * JZ[k];
      GZ[k] = wX * JI[k] + wZ * JZ[k];
    }
    int e = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int k = a; k < 6; ++k) acc[e++] += (double)(JI[a] * GI[k] + JZ[a] * GZ[k]);
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[21 + k] += (double)(GI[k] * q.rI + GZ[k] * q.rZ);
    acc[27] += (double)(w * maha);
    acc[28] += (double)log1pf(maha * (1.f / p.nu));
  }
}

template <bool kCompact, bool tdist>
__device__ __forceinline__ void normal_pass(const Params& p, const Row& r, Shared& sh,
                                            const Points& s, int base, int n_mine,
                                            int& parity, int C, const Precision& P) {
  double acc[kNormalSums];
#pragma unroll
  for (int k = 0; k < kNormalSums; ++k) acc[k] = 0.0;
  normal_sums<kCompact, tdist>(p, r, sh, s, base, n_mine, P, acc);
  cluster_sum<kNormalSums>(acc, sh, parity, C);
}

// One linearization of this cluster's batch row at sh.T: the residual pass,
// the robust scale (the Sigma fixed point, or robust_scale off the
// t-distribution: kRobust, the instantiation the launch picks for every
// other estimator, so that the t-distribution's code has no estimator
// branch) and the normal equations. Every CTA ends with the same sh.lin. `seed` (2, 2) warm-starts
// Sigma when `warm` and finite (the t-distribution only). Mode (a) passes
// `residuals` to write rI, rZ and valid out.
template <bool kRobust, bool kCompact>
__device__ void linearize_row(const Params& p, const Row& r, Shared& sh,
                              const Points& s, int b, int rank, int C,
                              int& parity, bool warm, const float* seed,
                              bool residuals) {
  const int base = rank * p.P;
  const int n_mine = max(0, min(p.P, p.N - base));
  constexpr bool tdist = !kRobust;

  residual_pass<kCompact>(p, r, sh, s, b, base, n_mine, parity, C, residuals);
  if (threadIdx.x == 0) {
    sh.n_sel = (float)sh.tot[4];
    seed_sigma(p, sh, sh.tot[0], sh.tot[1], sh.tot[2], sh.tot[3], tdist, warm, seed);
    if (p.estimator != kEstMad) sh.lin[kOutMad] = sh.lin[kOutMad + 1] = 0.f;
  }
  __syncthreads();

  // Sigma fixed point: the weighted moments under the current Sigma.
  for (int step = 0; step < sh.n_fp; ++step) {
    sigma_pass<kCompact>(p, r, sh, s, base, n_mine, parity, C);
    if (threadIdx.x == 0) sigma_update(p, sh, sh.tot);
    __syncthreads();
  }
  if (!tdist) robust_scale<kCompact>(p, r, sh, s, base, n_mine, parity, C);

  const Precision P = lin_precision(sh, tdist);
  normal_pass<kCompact, tdist>(p, r, sh, s, base, n_mine, parity, C, P);
  if (threadIdx.x == 0) finish_lin(p, sh, sh.tot, P, tdist);
  __syncthreads();
}

// ops/least_squares.py::solve for one system: A dx = -b with the damping
// A + lam diag(A) + 1e-8 I, Jacobi scaling and an f32 Cholesky. A matrix
// that is not positive definite gives NaN (LAPACK potrf's test: a pivot
// that is not > 0).
__device__ void solve6(const float* A, const float* b, float lam, float* dx) {
  float M[36], s[6], y[6];
  for (int k = 0; k < 36; ++k) M[k] = A[k];
  for (int i = 0; i < 6; ++i) {
    const float d = A[7 * i];
    M[7 * i] = add(add(d, mul(lam, d)), kJitter);
  }
  for (int i = 0; i < 6; ++i) {
    const float d = M[7 * i];
    s[i] = __frcp_rn(__fsqrt_rn(d < kJitter ? kJitter : d));  // clamp keeps NaN
  }
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j) M[6 * i + j] = mul(mul(M[6 * i + j], s[i]), s[j]);
  bool ok = true;
  for (int j = 0; j < 6; ++j) {
    float d = M[7 * j];
    for (int k = 0; k < j; ++k) d = sub(d, mul(M[6 * j + k], M[6 * j + k]));
    ok = ok && (d > 0.f);
    M[7 * j] = __fsqrt_rn(d);
    for (int i = j + 1; i < 6; ++i) {
      float v = M[6 * i + j];
      for (int k = 0; k < j; ++k) v = sub(v, mul(M[6 * i + k], M[6 * j + k]));
      M[6 * i + j] = __fdiv_rn(v, M[7 * j]);
    }
  }
  for (int i = 0; i < 6; ++i) {  // L y = -s b
    float v = -mul(b[i], s[i]);
    for (int k = 0; k < i; ++k) v = sub(v, mul(M[6 * i + k], y[k]));
    y[i] = __fdiv_rn(v, M[7 * i]);
  }
  for (int i = 5; i >= 0; --i) {  // L^T x = y, x into y
    float v = y[i];
    for (int k = i + 1; k < 6; ++k) v = sub(v, mul(M[6 * k + i], y[k]));
    y[i] = __fdiv_rn(v, M[7 * i]);
  }
  for (int i = 0; i < 6; ++i) dx[i] = ok ? mul(y[i], s[i]) : __int_as_float(0x7fc00000);
}

// ops/se3.py::exp with its Taylor branches: (6,) twist (v, w) -> (4, 4).
__device__ void se3_exp(const float* xi, float* E) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = add(add(mul(w0, w0), mul(w1, w1)), mul(w2, w2));
  const bool small = th2 < 1e-8f;
  const float ss = small ? 1.f : th2;
  const float st = sqrtf(ss);
  const float sn = sinf(st);
  const float a = small ? 1.f - th2 / 6.f : sn / st;
  const float bb = small ? 0.5f - th2 / 24.f : (1.f - cosf(st)) / ss;
  const float c = small ? 1.f / 6.f - th2 / 120.f : (st - sn) / (ss * st);
  const float Wm[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = Wm[3 * i] * Wm[j] + Wm[3 * i + 1] * Wm[3 + j] +
                      Wm[3 * i + 2] * Wm[6 + j];
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      E[4 * i + j] = eye + a * Wm[3 * i + j] + bb * W2[3 * i + j];
      t += (eye + bb * Wm[3 * i + j] + c * W2[3 * i + j]) * xi[j];
    }
    E[4 * i + 3] = t;
  }
  E[12] = 0.f;
  E[13] = 0.f;
  E[14] = 0.f;
  E[15] = 1.f;
}

// torch.clamp(x, lo, hi), NaN kept.
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ops/se3.py::log (with log_so3 and its branches as there): (4, 4) -> the
// (6,) twist (v, w), in f32.
__device__ void se3_log(const float* T, float* xi) {
  const float trace = add(add(T[0], T[5]), T[10]);
  const float u = clamp2(mul(sub(3.f, trace), 0.5f), 0.f, 2.f);  // 1 - cos
  const bool small_u = u < 1e-6f;
  const float us = small_u ? 1.f : u;
  const float theta_r = acosf(sub(1.f, us));
  const float sin_r = sqrtf(mul(us, sub(2.f, us)));
  const float tss = add(mul(2.f, u), __fdiv_rn(mul(u, u), 3.f));
  const float factor =
      small_u ? add(add(0.5f, __fdiv_rn(tss, 12.f)), __fdiv_rn(mul(mul(7.f, tss), tss), 720.f))
              : __fdiv_rn(theta_r, mul(2.f, sin_r));
  const float w[3] = {mul(factor, sub(T[9], T[6])), mul(factor, sub(T[2], T[8])),
                      mul(factor, sub(T[4], T[1]))};
  const float th2 = add(add(mul(w[0], w[0]), mul(w[1], w[1])), mul(w[2], w[2]));
  const bool small = th2 < 1e-8f;
  const float th = sqrtf(th2 < 1e-12f ? 1.f : th2);
  // V^-1 = I - W / 2 + coef W^2, coef = 1 / t^2 - (1 + cos t) / (2 t sin t)
  const float coef = small ? add(1.f / 12.f, __fdiv_rn(th2, 720.f))
                           : sub(__frcp_rn(th2), __fdiv_rn(add(1.f, cosf(th)),
                                                           mul(mul(2.f, th), sinf(th))));
  const float Wm[9] = {0.f, -w[2], w[1], w[2], 0.f, -w[0], -w[1], w[0], 0.f};
  for (int i = 0; i < 3; ++i) {
    float v = 0.f;
    for (int j = 0; j < 3; ++j) {
      const float w2 = Wm[3 * i] * Wm[j] + Wm[3 * i + 1] * Wm[3 + j] + Wm[3 * i + 2] * Wm[6 + j];
      const float vij = (i == j ? 1.f : 0.f) - 0.5f * Wm[3 * i + j] + coef * w2;
      v += vij * T[4 * j + 3];
    }
    xi[i] = v;
    xi[3 + i] = w[i];
  }
}

// The motion prior's twist log(Tbase T_init^-1) (models/dense_tracker.py's
// xi_prior), with T_init^-1 = [R^T, -R^T t].
__device__ void prior_twist(const float* Tbase, const float* Tinit, float* xi) {
  float inv[16], P[16];
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
    for (int j = 0; j < 3; ++j) {
      inv[4 * i + j] = Tinit[4 * j + i];
      t += Tinit[4 * j + i] * Tinit[4 * j + 3];
    }
    inv[4 * i + 3] = -t;
  }
  inv[12] = inv[13] = inv[14] = 0.f;
  inv[15] = 1.f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      P[4 * i + j] = Tbase[4 * i] * inv[j] + Tbase[4 * i + 1] * inv[4 + j] +
                     Tbase[4 * i + 2] * inv[8 + j] + Tbase[4 * i + 3] * inv[12 + j];
  se3_log(P, xi);
}

// One IRLS step of models/dense_tracker.py::_track_level for this row, from
// sh.lin (the linearization at sh.T), in thread 0. Writes iteration k's
// statistics when `stats` is set (rank 0). With mu > 0 the solve takes the
// motion prior, A + mu I and b + mu log(Tbase T_init^-1); the carried
// record stays the pure data term (dvo_slam_tpu/models/dense_tracker.py:
// 193-198: else each rejection would stack another mu I).
__device__ void irls_step(const Params& p, Shared& sh, int k, float* stats) {
  const float* lin = sh.lin;
  float* best = sh.best;
  // Accept when the error did not increase (always at k = 0; NaN rejects).
  const bool accept = (k == 0) || (lin[kOutErrMean] <= best[kBestErr]);
  float Tbase[16];
  if (accept) {
    for (int i = 0; i < 16; ++i) Tbase[i] = sh.T[i];
    for (int i = 0; i < 42; ++i) best[kBestA + i] = lin[kOutA + i];  // A, b
    best[kBestErr] = lin[kOutErrMean];
    best[kBestErrRaw] = lin[kOutErrRaw];
    for (int i = 0; i < 4; ++i) best[kBestSigma + i] = lin[kOutSigma + i];
    best[kBestNRaw] = lin[kOutNRaw];
    best[kBestLog1p] = lin[kOutLog1p];
  } else {
    for (int i = 0; i < 16; ++i) Tbase[i] = sh.Tbest[i];
  }
  float lam = sh.lam;
  bool rejected_stop = false;
  if (p.lm_init > 0.f) {
    lam = accept ? fmaxf(mul(lam, p.lm_down), 1e-12f) : fminf(mul(lam, p.lm_up), p.lm_max);
  } else {
    rejected_stop = !accept;  // pure GN: an error increase reverts and stops
  }
  float delta[6];
  if (p.mu > 0.f) {
    float A[36], g[6], xi[6];
    prior_twist(Tbase, sh.Tinit, xi);
    for (int i = 0; i < 36; ++i) A[i] = best[kBestA + i];
    for (int i = 0; i < 6; ++i) {
      A[7 * i] = add(A[7 * i], p.mu);
      g[i] = add(best[kBestB + i], mul(p.mu, xi[i]));
    }
    solve6(A, g, lam, delta);
  } else {
    solve6(best + kBestA, best + kBestB, lam, delta);
  }
  bool finite = true;
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(delta[i]);
  float sq = 0.f;
  for (int i = 0; i < 6; ++i) {
    if (!finite) delta[i] = 0.f;
    sq += delta[i] * delta[i];
  }
  const float delta_norm = sqrtf(sq);
  float E[16];
  se3_exp(delta, E);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      sh.T[4 * i + j] = E[4 * i] * Tbase[j] + E[4 * i + 1] * Tbase[4 + j] +
                        E[4 * i + 2] * Tbase[8 + j] + E[4 * i + 3] * Tbase[12 + j];
  for (int i = 0; i < 16; ++i) sh.Tbest[i] = Tbase[i];
  const bool converged = delta_norm < p.precision;
  const bool too_few = best[kBestNRaw] < 6.f;
  if (stats) {
    const int M = p.max_iterations;
    stats[k] = lin[kOutNRaw];
    stats[M + k] = lin[kOutErrMean];
    stats[2 * M + k] = delta_norm;
    stats[3 * M + k] = accept ? 1.f : 0.f;
  }
  // The stop test and its reason; the first matching reason wins.
  sh.term = rejected_stop ? kTermErrorIncreased
            : too_few     ? kTermTooFew
            : converged   ? kTermIncrement
                          : kTermIterations;
  sh.done = rejected_stop || converged || too_few;
  sh.lam = lam;
}

// log|det A| of a 6x6 matrix: LU with partial pivoting in f64 (-inf where
// a pivot is 0, NaN where A is not finite).
__device__ double logabsdet6(const float* A) {
  double M[36];
  bool finite = true;
  for (int k = 0; k < 36; ++k) {
    M[k] = (double)A[k];
    finite = finite && isfinite(A[k]);
  }
  if (!finite) return __longlong_as_double(0x7ff8000000000000ll);
  double logdet = 0.0;
  for (int j = 0; j < 6; ++j) {
    int piv = j;
    for (int i = j + 1; i < 6; ++i)
      if (fabs(M[6 * i + j]) > fabs(M[6 * piv + j])) piv = i;
    if (M[6 * piv + j] == 0.0) return -INFINITY;
    if (piv != j)
      for (int k = 0; k < 6; ++k) {
        const double t = M[6 * j + k];
        M[6 * j + k] = M[6 * piv + k];
        M[6 * piv + k] = t;
      }
    const double d = M[7 * j];
    logdet += log(fabs(d));
    for (int i = j + 1; i < 6; ++i) {
      const double f = M[6 * i + j] / d;
      for (int k = j + 1; k < 6; ++k) M[6 * i + k] -= f * M[6 * j + k];
    }
  }
  return logdet;
}

// The selected count and the track result's fields the eager assembly
// derives from the finest level's accepted record
// (models/dense_tracker.py), here for each level's: the bivariate t
// log-likelihood (ops/linearize.py::tdist_loglik), the pose entropy
// 0.5 (6 ln(2 pi e) - ln|det A|) (dense_tracker.pose_entropy) and the
// valid ratio n_raw / max(selected, 1). In f64 from the f32 record; the
// tests hold them to the eager f32 values within stated tolerances.
__device__ void track_result(const Params& p, const float* best, float n_sel,
                             float* loglik, float* extra) {
  const float n_raw = best[kBestNRaw];
  extra[kExtraSelected] = n_sel;
  const double det = fmax((double)sub(mul(best[kBestSigma], best[kBestSigma + 3]),
                                      mul(best[kBestSigma + 1], best[kBestSigma + 2])),
                          (double)kEps);
  const double log_norm = p.loglik_const - 0.5 * log(det);
  *loglik = (float)((double)fmaxf(n_raw, 1.f) * log_norm -
                    0.5 * ((double)p.nu + 2.0) * (double)best[kBestLog1p]);
  const double two_pi_e = 17.079468445347132;  // 2 pi e
  extra[kExtraEntropy] = (float)(0.5 * (6.0 * log(two_pi_e) - logabsdet6(best + kBestA)));
  extra[kExtraRatio] = __fdiv_rn(n_raw, fmaxf(n_sel, 1.f));
}

// Row b's CTA `rank`'s points (kept in shared memory or not) and its slot
// table (compaction only: in shared memory after the points, or its rows
// of the global table; null on the full grid).
__device__ __forceinline__ Points points_of(const Params& p, float4* dyn, int b, int rank) {
  Points s;
  s.f = reinterpret_cast<float*>(dyn);
  s.P = p.P;
  s.valid = reinterpret_cast<uint8_t*>(s.f + kPointFloats * p.P);
  s.slot = p.slots_shared ? reinterpret_cast<int*>(reinterpret_cast<char*>(dyn) + p.slot_at)
           : p.slots      ? p.slots + (int64_t)b * p.budget + (int64_t)rank * p.P
                          : nullptr;
  return s;
}

// Whether pixel i of a reference slab is selected: ref_point's bits,
// reading only the planes the selection needs.
__device__ __forceinline__ bool selected_pixel(const Params& p, const float* ref,
                                               int64_t plane, int i) {
  const float* s = ref + i;
  const float z = __ldg(s + plane);
  float ix = 0.f, iy = 0.f, zx = 0.f, zy = 0.f;
  if (p.igt > 0.f) {
    ix = __ldg(s + 2 * plane);
    iy = __ldg(s + 3 * plane);
  }
  if (p.dgt > 0.f || (p.ref_grad && p.use_depth)) {
    zx = __ldg(s + 4 * plane);
    zy = __ldg(s + 5 * plane);
  }
  return selection(p, z, ix, iy, zx, zy);
}

// Compaction's slot map (dvo_slam_tpu/ops/linearize.py::_muldiv_floor's
// floor(q budget / count), exact): a double quotient, within one of the
// true one while q budget < 2^62, corrected by the 64-bit remainder. The
// remainder also gives JAX's first-writer test: floor((q - 1) budget /
// count) differs from the slot exactly where it is below budget (budget <
// count).
__device__ __forceinline__ int slot_of(int q, int64_t budget, int64_t count, bool* first) {
  const int64_t num = (int64_t)q * budget;
  int64_t slot = (int64_t)((double)num / (double)count);
  int64_t rem = num - slot * count;
  if (rem < 0) {
    --slot;
    rem += count;
  } else if (rem >= count) {
    ++slot;
    rem -= count;
  }
  *first = rem < budget;
  return (int)slot;
}

// Compaction's slot tables of this cluster's row (the header's
// "Compaction on the slab route"): after it every CTA's s.slot[j] holds
// the pixel of its slot j for each slot below sh.n_fill, the row's count
// of filled slots. CTA r takes band r of the slab's pixels, warp w of it
// sub-band w, in chunks of 32 pixels: the first pass counts the selected
// pixels (no warp sync inside its loop, so the loads of several chunks
// are in flight) and keeps each lane's bit of its first kKeptChunks
// chunks in a register, the CTAs exchange their counts (one cluster
// barrier), and the second pass ranks from those bits by a warp ballot a
// chunk (reading the slab again only past them), with no block barrier
// in either loop. Two cluster barriers, the same in every CTA.
__device__ void select_slots(const Params& p, const Row& r, Shared& sh, const Points& s,
                             int b, int rank, int C) {
  constexpr int kKeptChunks = 64;  // bits of a uint64_t
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t plane = (int64_t)p.ref_H * p.W;
  const int64_t band = (plane + C - 1) / C;
  const int lo = (int)min((int64_t)rank * band, plane);
  const int hi = (int)min((int64_t)lo + band, plane);
  const int sub = (hi - lo + kWarps - 1) / kWarps;
  const int wlo = min(lo + warp * sub, hi), whi = min(wlo + sub, hi);
  // This warp's count of selected pixels, this CTA's, then every CTA's.
  uint64_t bits = 0;
  int n = 0;
#pragma unroll 4
  for (int c0 = wlo, c = 0; c0 < whi; c0 += 32, ++c) {
    const int i = c0 + lane;
    const bool sel = i < whi && selected_pixel(p, r.ref, plane, i);
    if (sel && c < kKeptChunks) bits |= 1ull << c;
    n += sel;
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if (lane == 0) sh.sel_warp[warp] = (unsigned)n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += (int)sh.sel_warp[w];
    sh.sel_count = t;
  }
  cluster.sync();  // every CTA's count in place (written once a launch)
  if (warp == 0) {
    // Lane q reads CTA q's count: one round of remote reads, not C.
    const int m = lane < C ? *cluster.map_shared_rank(&sh.sel_count, lane) : 0;
    const int off = __reduce_add_sync(0xffffffffu, lane < rank ? m : 0);
    const int total = __reduce_add_sync(0xffffffffu, m);
    if (lane == 0) {
      sh.sel_off = off;
      sh.sel_total = total;
      sh.n_fill = min(total, p.budget);
    }
  }
  __syncthreads();
  // Ranks in row-major order: the ranks before this CTA and before this
  // warp, then a chunk's ballot; each slot's first writer stores its pixel
  // in the owner's table.
  const int64_t count = sh.sel_total, budget = p.budget;
  int done = sh.sel_off;  // selected pixels before this warp's chunk
  for (int w = 0; w < warp; ++w) done += (int)sh.sel_warp[w];
  for (int c0 = wlo, c = 0; c0 < whi; c0 += 32, ++c) {
    const int i = c0 + lane;
    const bool sel = c < kKeptChunks ? ((bits >> c) & 1ull) != 0
                                     : (i < whi && selected_pixel(p, r.ref, plane, i));
    const unsigned bal = __ballot_sync(0xffffffffu, sel);
    if (sel) {
      const int q = done + __popc(bal & ((1u << lane) - 1u));
      bool first = true;
      const int slot = count > budget ? slot_of(q, budget, count, &first) : q;
      if (first) {
        if (p.slots_shared) {
          const int owner = slot / p.P;
          cluster.map_shared_rank(s.slot, owner)[slot - owner * p.P] = i;
        } else {
          p.slots[(int64_t)b * p.budget + slot] = i;
        }
      }
    }
    done += __popc(bal);
  }
  cluster.sync();  // every filled slot's pixel in its owner's table
}

template <bool kRobust, bool kCompact>
__global__ void __launch_bounds__(kThreads, 1) linearize_kernel(Params p) {
  extern __shared__ float4 dyn_smem[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const Row r = row_of(p, b);
  const Points s = points_of(p, dyn_smem, b, rank);
  if (threadIdx.x < 16) sh.T[threadIdx.x] = p.T[b * p.T_stride + threadIdx.x];
  __syncthreads();
  if (kCompact) select_slots(p, r, sh, s, b, rank, C);
  int parity = 0;
  linearize_row<kRobust, kCompact>(p, r, sh, s, b, rank, C, parity, p.warm != 0,
                                   p.warm ? p.sigma_init + 4 * b : nullptr, true);
  if (rank == 0 && threadIdx.x < kOutSize)
    p.out[(int64_t)b * kOutSize + threadIdx.x] = sh.lin[threadIdx.x];
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// Mode (b)'s write-out of row b's level after k iterations (rank 0's CTA,
// every thread): the pose, the record, the statistics (those past the last
// iteration zero, the window misses too), the iteration count and the
// termination code, and the track result's fields from the record.
__device__ __forceinline__ void write_level_row(const Params& p, const Shared& sh, int b, int k,
                                                float* o) {
  const int M = p.max_iterations;
  if (threadIdx.x < 16) o[kLevelT + threadIdx.x] = sh.Tbest[threadIdx.x];
  if (threadIdx.x < kBestSize) o[kLevelBest + threadIdx.x] = sh.best[threadIdx.x];
  for (int q = threadIdx.x; q < kStatPlanes * M; q += blockDim.x)
    if (q >= 4 * M || q % M >= k) o[kLevelStats + q] = 0.f;
  float* extra = o + kLevelStats + kStatPlanes * M;
  if (threadIdx.x == 0) {
    p.out_i[b * p.out_i_stride] = k;
    p.out_i[b * p.out_i_stride + 1] = sh.term;
    track_result(p, sh.best, sh.n_sel, o + kLevelLoglik, extra);
  }
}

template <bool kRobust, bool kCompact>
__global__ void __launch_bounds__(kThreads, 1) track_level_kernel(Params p) {
  // cudaTriggerProgrammaticLaunchCompletion(): a launch after this one
  // made with programmatic stream serialization (the chunked scan's step,
  // csrc/keyframe_scan.cu, after the finest level) may start now and waits
  // for this launch's end in griddepcontrol.wait before it reads what this
  // launch writes. No other launch of the port is programmatic, and a
  // plain launch after this one still waits for its end.
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ float4 dyn_smem[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const Row r = row_of(p, b);
  const Points s = points_of(p, dyn_smem, b, rank);
  const int M = p.max_iterations;
  float* o = p.out + b * p.out_stride;
  if (threadIdx.x < 16) {
    sh.T[threadIdx.x] = p.T[b * p.T_stride + threadIdx.x];
    sh.Tbest[threadIdx.x] = p.T[b * p.T_stride + threadIdx.x];
    sh.Tinit[threadIdx.x] = p.T[b * p.T_stride + threadIdx.x];
  }
  if (threadIdx.x < kBestSize) sh.best[threadIdx.x] = 0.f;
  if (threadIdx.x == 0) {
    sh.lam = p.lm_init > 0.f ? p.lm_init : 0.f;
    sh.done = 0;
    sh.term = kTermIterations;
  }
  __syncthreads();
  if (kCompact) select_slots(p, r, sh, s, b, rank, C);
  int parity = 0, k = 0;
  // Bounded by max_iterations whatever the stop flag says; every CTA reads
  // the same flag (computed from the same sums), so all take the same
  // number of barriers.
  while (k < M) {
    linearize_row<kRobust, kCompact>(p, r, sh, s, b, rank, C, parity,
                                     k > 0 && p.warm_iters > 0, sh.best + kBestSigma, false);
    if (threadIdx.x == 0) irls_step(p, sh, k, rank == 0 ? o + kLevelStats : nullptr);
    __syncthreads();
    ++k;
    if (sh.done) break;
  }
  // The record leaves the level as the posterior information A + mu I,
  // added once, here: the carry above stays the data term (irls_step),
  // and what reads the record after the launch (the entropy below,
  // models/dense_tracker.py::level_result, the scan step's row head in
  // csrc/keyframe_scan.cu) takes it as it is, so nothing adds it again.
  if (p.mu > 0.f && threadIdx.x == 0)
    for (int i = 0; i < 6; ++i) sh.best[kBestA + 7 * i] = add(sh.best[kBestA + 7 * i], p.mu);
  __syncthreads();
  if (rank == 0) write_level_row(p, sh, b, k, o);
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// The split mode (the pixel route: a row's reference points split over the
// ranks of a process group, each rank's launches over its band). One IRLS
// iteration is a fixed sequence of stage launches, each ending where the
// JAX package psums; the caller all-reduces the stage buffer `split_sums`
// ((B, kSplitSums) f64: every row's partial sums over this rank's points)
// over the group between launches, so each launch reads the totals of the
// one before. The t-distribution: stage 0 the residual pass (the moments,
// valid and selected counts), stages 1..steps one Sigma step each, stage
// steps + 1 the normal equations: 2 + steps collectives an iteration. Off
// it stage 0 is the whole linearization, the scale per rank as the JAX
// package takes it (no psum in its scale functions): one collective.
// Stage 0 of iteration k > 0 first takes iteration k - 1's decision (the
// IRLS step on the all-reduced totals); kStageFinish takes the last
// iteration's. The carry lives in SplitState, one per row, between
// launches; stage 0's residual pass keeps each point (rI, rZ, valid and
// the Jacobian's inputs) in device memory for the stages after it, a row's
// points as planes of N (split_points_of: any grid reads them), and the
// slot tables of compaction live in the global (B, budget) table
// (select_slots in the level's first launch).
//
// What bounds it on this card. A stage moves little: a Sigma step reads 9
// of a kept point's 37 bytes (2 400 points, ~22 KB, at level 3), stage 0
// writes the 37. Its time is fixed costs, which the phase stamps
// (split_stamp) split. Launched as clusters of cluster_size(N) CTAs of
// 512 threads (one CTA an SM), as the first design of this mode did, a
// Sigma step at level 3 spent ~5 us outside its CTAs (the cluster
// launch), 1.5 us in its cluster reduction, 0.65 us in a second cluster
// barrier and ~0.5 us each loading and storing the whole carry; stage 0
// 3.8 us on the decision in one thread; and at level 1, B = 8 eight
// clusters of 16 CTAs did not fit on the card at once (events 45.5 us
// against the CTA's 21.8). What is left after the design below: a launch
// behind another kernel costs ~4.8 us before any CTA runs (an empty
// kernel timed alone), the decision ~2.6 us, a reduction's partial sums
// and ticket ~1.2-3.4 us, and stage 0's pass at level 1, B = 8 ~1.3x its
// bytes' time. The design:
// - The t-distribution's launches (kRobust false) need no cluster: nothing
//   inside a launch waits on another CTA's sum. A grid of split_ctas
//   plain CTAs of kSplitThreads a row (ops/linearize.py split_ctas: a
//   point a thread while two CTAs an SM hold the batch in one wave), each
//   CTA's sums reduced by shuffle trees into its partial slot
//   (split_partial), and the CTA that finishes last (an integer ticket in
//   the carry, reset by it) sums the row's partials in a fixed order
//   (split_totals) and writes the stage buffer and the carry. No float
//   atomics. Only compaction's first launch, whose select_slots exchanges
//   counts through distributed shared memory, runs as a cluster
//   (cluster_size(N) CTAs of kThreads).
// - A launch loads, and its last CTA stores, only the carry its stage
//   reads and changes: a Sigma step or the normal equations the scale
//   fields (SplitState's first block; each thread its own copy, with
//   Sigma computed in registers, so no barrier comes before the pass),
//   stage 0 and the finish all of it.
// - Stage 0's decision runs on one warp in registers (irls_step_warp: the
//   system's rows in lanes 0-5, each pivot's reciprocal square root
//   multiplied in where solve6 divides: the solve took 2.5 of the
//   decision's 4.2 us with solve6's divisions).
// - The residual and Sigma passes take two points a thread at once (their
//   loads in flight together), the first two's loaded ahead (stage 0's
//   reference planes before the decision, a Sigma step's kept points
//   before the carry); stores stay coalesced (planes of N). A Sigma step
//   at level 3 on one CTA of 512 threads (8 points a thread, no ticket)
//   took as long as on the grid (8.53-8.91 against 8.94 us), and levels
//   2 and 1 lost 0.1-1.1 us on it: one grid serves every stage.
// The other estimators (kRobust) keep the cluster grid: stage 0 is the
// whole linearization, whose robust scale reduces inside the launch (MAD's
// select, the normal scale's means), on clusters, with the same
// decision on warp 0 (split_robust).
struct SplitState {
  // The scale carry, which every stage reads.
  float a, bq, c, n, n_raw, n_sel;
  int k, done, n_fp, n_fill;
  unsigned ticket;  // CTAs of the running launch past their partial sums
  // The decision's carry (stage 0 and the finish).
  float lam;
  int term;
  float T[16], Tbest[16], Tinit[16];
  float best[kBestSize];
};
static_assert(sizeof(SplitState) <= 4 * kSplitStateWords, "the state fits its row");
static_assert(offsetof(SplitState, ticket) == 4 * kSplitTicketWord, "the ticket's word");
static_assert(offsetof(SplitState, Tinit) == offsetof(SplitState, T) + 128 &&
                  offsetof(Shared, Tinit) == offsetof(Shared, T) + 128,
              "the poses are 48 floats in a row");

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A phase stamp of the split mode: clock64 into slot `slot` by row 0's
// first CTA, every thread of which first meets here (a uniform branch:
// timing is null or not for the whole launch).
__device__ __forceinline__ void split_stamp(const Params& p, int slot) {
  if (p.split_timing == nullptr || blockIdx.x != 0 || blockIdx.y != 0) return;
  __syncthreads();
  if (threadIdx.x == 0) p.split_timing[slot] = clock64();
}

// Bytes of one row of the split mode's buffer: its kept points (planes of
// N floats, then N valid flags, rounded up to 16), then its CTAs' partial
// sums (kMaxSplitCtas slots of kPartialStride doubles).
__host__ __device__ __forceinline__ int64_t split_row_bytes(int N) {
  return points_bytes(N) + (int64_t)kMaxSplitCtas * kPartialStride * 8;
}

// The points of row b from its point `base` on (a CTA's first), in the
// row's planes, and its slot table from the same slot.
__device__ __forceinline__ Points split_points_of(const Params& p, int b, int base) {
  uint8_t* row = p.split_points + (int64_t)b * split_row_bytes(p.N);
  Points s;
  s.f = reinterpret_cast<float*>(row) + base;
  s.P = p.N;
  s.valid = row + (int64_t)4 * kPointFloats * p.N + base;
  s.slot = p.slots ? p.slots + (int64_t)b * p.budget + base : nullptr;
  return s;
}

// The carry into sh from row b's SplitState: the scalars by thread 0, the
// poses and the record a load a thread, every load issued at once.
__device__ __forceinline__ void load_carry(const SplitState* st, Shared& sh, int& k_row) {
  const int t = threadIdx.x;
  if (t == 0) {
    const float a = st->a, bq = st->bq, c = st->c, n = st->n, n_raw = st->n_raw,
                n_sel = st->n_sel, lam = st->lam;
    const int k = st->k, done = st->done, n_fp = st->n_fp, n_fill = st->n_fill,
              term = st->term;
    sh.a = a;
    sh.bq = bq;
    sh.c = c;
    sh.n = n;
    sh.n_raw = n_raw;
    sh.n_sel = n_sel;
    sh.lam = lam;
    k_row = k;
    sh.done = done;
    sh.n_fp = n_fp;
    sh.n_fill = n_fill;
    sh.term = term;
  }
  // SplitState's T, Tbest, Tinit and Shared's are 48 floats in a row each.
  if (t < 48) (&sh.T[0])[t] = (&st->T[0])[t];
  else if (t < 48 + kBestSize) sh.best[t - 48] = st->best[t - 48];
}

// The carry from sh into row b's SplitState (the last CTA), as load_carry
// reads it; the ticket goes back to 0.
__device__ __forceinline__ void store_carry(SplitState* st, const Shared& sh, int k_row) {
  const int t = threadIdx.x;
  if (t == 0) {
    st->a = sh.a;
    st->bq = sh.bq;
    st->c = sh.c;
    st->n = sh.n;
    st->n_raw = sh.n_raw;
    st->n_sel = sh.n_sel;
    st->lam = sh.lam;
    st->k = k_row;
    st->done = sh.done;
    st->n_fp = sh.n_fp;
    st->n_fill = sh.n_fill;
    st->term = sh.term;
    st->ticket = 0u;  // for the next launch
  }
  if (t < 48) (&st->T[0])[t] = (&sh.T[0])[t];
  else if (t < 48 + kBestSize) st->best[t - 48] = sh.best[t - 48];
}

// The level's initial carry (stage 0 of iteration 0), as track_level_kernel
// starts a row.
__device__ __forceinline__ void init_carry(const Params& p, Shared& sh, int b, int& k_row) {
  const int t = threadIdx.x;
  if (t < 16) sh.T[t] = sh.Tbest[t] = sh.Tinit[t] = p.T[b * p.T_stride + t];
  if (t < kBestSize) sh.best[t] = 0.f;
  if (t == 0) {
    sh.lam = p.lm_init > 0.f ? p.lm_init : 0.f;
    sh.a = sh.bq = sh.c = sh.n = sh.n_raw = sh.n_sel = 0.f;
    sh.done = 0;
    sh.term = kTermIterations;
    sh.n_fp = 0;
    sh.n_fill = 0;
    k_row = 0;
  }
}

// A warp's M sums of its lanes' values (M <= 32), lane m ending with sum m,
// by a fixed tree: eight values at a time, a transposing butterfly over
// each group of 8 lanes (at each of its 3 steps a lane keeps half of its
// values and adds its partner's copy of that half), then two steps over
// the groups: 9 shuffles for 8 values, not 40, and 8 values in registers.
template <int M>
__device__ __forceinline__ double warp_sums(const double (&v)[M], int lane) {
  static_assert(M <= 32, "a sum a lane");
  double out = 0.0;
#pragma unroll
  for (int g = 0; g < (M + 7) / 8; ++g) {
    double x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = 8 * g + i < M ? v[8 * g + i] : 0.0;
#pragma unroll
    for (int s = 4; s >= 1; s >>= 1) {
      const bool upper = (lane & s) != 0;
#pragma unroll
      for (int i = 0; i < s; ++i) {
        const double send = upper ? x[i] : x[i + s];
        const double keep = upper ? x[i + s] : x[i];
        x[i] = keep + __shfl_xor_sync(0xffffffffu, send, s);
      }
    }
    // Lane l holds value 8 g + (l & 7) over its group; then over the groups.
    double y = x[0];
    y += __shfl_xor_sync(0xffffffffu, y, 8);
    y += __shfl_xor_sync(0xffffffffu, y, 16);
    if ((lane >> 3) == g) out = y;
  }
  return out;
}

// This CTA's sums of M per-thread values into its partial slot of the row
// (warp_sums, then warp 0 adds the warps' sums in order), and its ticket
// (the carry's count of the launch's CTAs past this point, taken by warp
// 0 after its partial sums are visible on the card). Returns, in every
// thread, whether this CTA is the last to take one: it alone goes on to
// split_totals (and store_carry writes the ticket back to 0). A row's
// only CTA writes its sums into sh.tot itself, takes no ticket and needs
// no split_totals.
template <int M>
__device__ bool split_partial(double (&v)[M], Shared& sh, double* partials, unsigned* ticket,
                              int& last) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nw = blockDim.x >> 5;
  const double x = warp_sums<M>(v, lane);
  if (lane < M) sh.warp[lane * kWarps + warp] = x;
  __syncthreads();
  if (gridDim.x == 1) {
    // The row's only CTA: its sums are the totals (into sh.tot).
    if (warp == 0 && lane < M) {
      double y = sh.warp[lane * kWarps];
      for (int w = 1; w < nw; ++w) y += sh.warp[lane * kWarps + w];
      sh.tot[lane] = y;
    }
    __syncthreads();
    return true;
  }
  if (warp == 0) {
    if (lane < M) {
      double y = sh.warp[lane * kWarps];
      for (int w = 1; w < nw; ++w) y += sh.warp[lane * kWarps + w];
      partials[(int64_t)blockIdx.x * kPartialStride + lane] = y;
    }
    __threadfence();
    __syncwarp();
    if (lane == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1u;
  }
  __syncthreads();
  return last != 0;
}

// A CTA with no sums to add (a stopped row, the finish, a step the row
// does not take): with more than one CTA it takes its ticket all the same,
// so that the CTA that writes the row's sums and carry (the last) does so
// only after every CTA of the launch has read them. A row's only CTA
// writes.
__device__ bool split_arrive(unsigned* ticket, int& last) {
  if (gridDim.x == 1) return true;
  __syncthreads();  // this CTA's threads have read the carry and the sums
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1u;
  }
  __syncthreads();
  return last != 0;
}

// The last CTA (of more than one): the row's totals over the launch's
// CTAs' partial sums into tot, in a fixed order (sum m's lane l adds CTAs
// l, l + 32, ... in turn, then a shuffle tree over the lanes): the same
// inputs give the same bits every run. A warp's sums m = warp + i nw are
// loaded together. No float atomics.
template <int M>
__device__ void split_totals(const double* partials, double* tot) {
  constexpr int kEach = (M + kSplitThreads / 32 - 1) / (kSplitThreads / 32);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int G = gridDim.x;
  __threadfence();
  double x[kEach];
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    const int m = warp + i * nw;
    x[i] = m < M && lane < G ? __ldcg(partials + (int64_t)lane * kPartialStride + m) : 0.0;
  }
  for (int r = lane + 32; r < G; r += 32) {
#pragma unroll
    for (int i = 0; i < kEach; ++i) {
      const int m = warp + i * nw;
      if (m < M) x[i] += __ldcg(partials + (int64_t)r * kPartialStride + m);
    }
  }
#pragma unroll
  for (int i = 0; i < kEach; ++i) {
    double y = x[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) y += __shfl_down_sync(0xffffffffu, y, off);
    const int m = warp + i * nw;
    if (lane == 0 && m < M) tot[m] = y;
  }
  __syncthreads();
}

// Row i's entry c of a lane's registers, for the lane's own row: a chain
// of selects over the static indices (an index into the array itself would
// put it in local memory).
__device__ __forceinline__ float at6(const float (&r)[6], int c) {
  float x = r[0];
#pragma unroll
  for (int q = 1; q < 6; ++q) x = (q == c) ? r[q] : x;
  return x;
}

// solve6 on one warp: the same damping, Jacobi scaling and Cholesky
// (NaN where a pivot is not > 0), with each pivot's reciprocal square
// root (__frsqrt_rn) multiplied in where solve6 divides, so the chain of
// dependent steps is shorter (a different rounding: within f32 rounding of
// solve6's). Lane i < 6 holds row i of the (scaled, then factored) system
// in registers; the pivots and the substitutions' values pass by
// shuffles. A (6, 6) and g (6,) in shared memory; every lane ends with dx.
__device__ __forceinline__ void solve6_warp(const float* A, const float* g, float lam,
                                            float (&dx)[6]) {
  const unsigned full = 0xffffffffu;
  const int i = threadIdx.x & 31;
  float r[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) r[c] = i < 6 ? A[6 * i + c] : 0.f;
#pragma unroll
  for (int c = 0; c < 6; ++c)
    if (c == i) r[c] = add(add(r[c], mul(lam, r[c])), kJitter);
  const float d0 = at6(r, i);
  const float si = __frcp_rn(__fsqrt_rn(d0 < kJitter ? kJitter : d0));  // clamp keeps NaN
  float s[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) s[c] = __shfl_sync(full, si, c);
#pragma unroll
  for (int c = 0; c < 6; ++c) r[c] = mul(mul(r[c], si), s[c]);
  bool ok = true;
  float inv[6];  // 1 / L[j][j]
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float piv = 0.f;
    if (i == j) {
      float d = r[j];
#pragma unroll
      for (int k = 0; k < j; ++k) d = sub(d, mul(r[k], r[k]));
      ok = d > 0.f;
      piv = __frsqrt_rn(d);
    }
    inv[j] = __shfl_sync(full, piv, j);
    float lj[6];
#pragma unroll
    for (int k = 0; k < j; ++k) lj[k] = __shfl_sync(full, r[k], j);
    if (i > j) {
      float v = r[j];
#pragma unroll
      for (int k = 0; k < j; ++k) v = sub(v, mul(r[k], lj[k]));
      r[j] = mul(v, inv[j]);
    }
  }
  ok = __all_sync(full, i >= 6 || ok);
  const float gi = i < 6 ? g[i] : 0.f;
  float y[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) {  // L y = -s b, row q on lane q
    float v = 0.f;
    if (i == q) {
      v = -mul(gi, si);
#pragma unroll
      for (int k = 0; k < q; ++k) v = sub(v, mul(r[k], y[k]));
      v = mul(v, inv[q]);
    }
    y[q] = __shfl_sync(full, v, q);
  }
#pragma unroll
  for (int q = 5; q >= 0; --q) {  // L^T x = y, x into y, on every lane
    float v = y[q];
#pragma unroll
    for (int k = q + 1; k < 6; ++k) v = sub(v, mul(__shfl_sync(full, r[q], k), y[k]));
    y[q] = mul(v, inv[q]);
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) dx[c] = ok ? mul(y[c], s[c]) : __int_as_float(0x7fc00000);
}

// Scratch of one warp's decision: the pose it starts from and the system.
struct DecideScratch {
  float Tbase[16];
  float A[36], g[6];
};

// finish_lin on one warp: A and b by lanes, the scalars on lane 0 (the
// same expressions).
__device__ __forceinline__ void finish_lin_warp(const Params& p, Shared& sh, const double* tot,
                                                const Precision& P) {
  const int lane = threadIdx.x & 31;
  float* o = sh.lin;
  if (lane < 21) {
    int j = 0, e = lane;
    while (e >= 6 - j) {
      e -= 6 - j;
      ++j;
    }
    const int k = j + e;
    o[kOutA + 6 * j + k] = (float)tot[lane];
    o[kOutA + 6 * k + j] = (float)tot[lane];
  } else if (lane < 27) {
    o[kOutB + lane - 21] = (float)tot[lane];
  } else if (lane == 27) {
    const float log1p_sum = (float)tot[28];
    o[kOutErrMean] = add(0.5f * logf(P.det), __fdiv_rn((p.nu + 2.f) * 0.5f * log1p_sum, sh.n));
    o[kOutN] = sh.n;
    o[kOutNRaw] = sh.n_raw;
    o[kOutSigma + 0] = sh.a;
    o[kOutSigma + 1] = sh.bq;
    o[kOutSigma + 2] = sh.bq;
    o[kOutSigma + 3] = sh.c;
    o[kOutLog1p] = log1p_sum;
    o[kOutErrRaw] = (float)tot[27];
  }
  __syncwarp();
}

// irls_step on one warp (every lane of warp 0 calls it): its operations in
// its order, the copies and the pose product spread over the lanes, the
// solve by solve6_warp.
__device__ __forceinline__ void irls_step_warp(const Params& p, Shared& sh, DecideScratch& ds,
                                               int k, float* stats) {
  const int lane = threadIdx.x & 31;
  const float* lin = sh.lin;
  float* best = sh.best;
  const bool accept = (k == 0) || (lin[kOutErrMean] <= best[kBestErr]);
  if (lane < 16) ds.Tbase[lane] = accept ? sh.T[lane] : sh.Tbest[lane];
  __syncwarp();
  if (accept) {
    for (int i = lane; i < 42; i += 32) best[kBestA + i] = lin[kOutA + i];  // A, b
    if (lane < 4) best[kBestSigma + lane] = lin[kOutSigma + lane];
    if (lane == 4) best[kBestErr] = lin[kOutErrMean];
    if (lane == 5) best[kBestErrRaw] = lin[kOutErrRaw];
    if (lane == 6) best[kBestNRaw] = lin[kOutNRaw];
    if (lane == 7) best[kBestLog1p] = lin[kOutLog1p];
  }
  __syncwarp();
  float lam = sh.lam;
  bool rejected_stop = false;
  if (p.lm_init > 0.f) {
    lam = accept ? fmaxf(mul(lam, p.lm_down), 1e-12f) : fminf(mul(lam, p.lm_up), p.lm_max);
  } else {
    rejected_stop = !accept;
  }
  // The system: the record's A and b, with the motion prior A + mu I and
  // b + mu log(Tbase T_init^-1).
  for (int i = lane; i < 42; i += 32) {
    if (i < 36) ds.A[i] = best[kBestA + i];
    else ds.g[i - 36] = best[kBestB + i - 36];
  }
  __syncwarp();
  if (p.mu > 0.f) {
    if (lane == 0) {
      float xi[6];
      prior_twist(ds.Tbase, sh.Tinit, xi);
      for (int i = 0; i < 6; ++i) {
        ds.A[7 * i] = add(ds.A[7 * i], p.mu);
        ds.g[i] = add(ds.g[i], mul(p.mu, xi[i]));
      }
    }
    __syncwarp();
  }
  float delta[6];
  solve6_warp(ds.A, ds.g, lam, delta);
  bool finite = true;
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(delta[i]);
  float sq = 0.f;
  for (int i = 0; i < 6; ++i) {
    if (!finite) delta[i] = 0.f;
    sq += delta[i] * delta[i];
  }
  const float delta_norm = sqrtf(sq);
  float E[16];
  se3_exp(delta, E);
  const float* Tb = ds.Tbase;
  if (lane < 16) {
    const int i = lane >> 2, j = lane & 3;
    sh.T[4 * i + j] = E[4 * i] * Tb[j] + E[4 * i + 1] * Tb[4 + j] + E[4 * i + 2] * Tb[8 + j] +
                      E[4 * i + 3] * Tb[12 + j];
    sh.Tbest[lane] = Tb[lane];
  }
  if (lane == 0) {
    const bool converged = delta_norm < p.precision;
    const bool too_few = best[kBestNRaw] < 6.f;
    if (stats) {
      const int M = p.max_iterations;
      stats[k] = lin[kOutNRaw];
      stats[M + k] = lin[kOutErrMean];
      stats[2 * M + k] = delta_norm;
      stats[3 * M + k] = accept ? 1.f : 0.f;
    }
    sh.term = rejected_stop ? kTermErrorIncreased
              : too_few     ? kTermTooFew
              : converged   ? kTermIncrement
                            : kTermIterations;
    sh.done = rejected_stop || converged || too_few;
    sh.lam = lam;
  }
  __syncwarp();
}

// The residual of pixel i (no point for i < 0 under compaction) from its
// reference planes `w` where `have`, else loaded here.
template <bool kCompact>
__device__ __forceinline__ Point split_point(const Params& p, const Row& r, const float* T, int i,
                                             const RefRaw& w, bool have) {
  if (kCompact && i < 0) return no_point();
  return residual_of(p, r, T, ref_point_of(p, have ? w : ref_raw(p, r, i), i));
}

// The reference planes of a thread's first two points (j0 = the thread,
// j0 + the block's threads, as split_residuals takes them), loaded ahead.
template <bool kCompact>
__device__ __forceinline__ void split_prefetch(const Params& p, const Row& r, const Shared& sh,
                                               const Points& s, int base, int n_mine,
                                               RefRaw (&pre)[2]) {
  const int j0 = threadIdx.x, j1 = j0 + (int)blockDim.x;
  if (j0 >= n_mine) return;
  const int i0 = pixel_of<kCompact>(sh, s, base, j0);
  const int i1 = pixel_of<kCompact>(sh, s, base, j1 < n_mine ? j1 : j0);
  if (!kCompact || i0 >= 0) pre[0] = ref_raw(p, r, i0);
  if (!kCompact || i1 >= 0) pre[1] = ref_raw(p, r, i1);
}

// The residual pass of the split mode: every point of this CTA's slice at
// sh.T, kept in the row's planes, and its moments (residual_moments'),
// two points a thread at once; the first two's reference planes from
// `pre` where `have` (split_prefetch, before the decision).
template <bool kCompact>
__device__ __forceinline__ void split_residuals(const Params& p, const Row& r, Shared& sh,
                                                const Points& s, int base, int n_mine,
                                                const RefRaw (&pre)[2], bool have,
                                                double (&m)[kMomentSums]) {
  const int nt = blockDim.x;
  for (int j0 = threadIdx.x; j0 < n_mine; j0 += 2 * nt) {
    const int j1 = j0 + nt;
    const bool two = j1 < n_mine;
    const bool use = have && j0 == (int)threadIdx.x;
    const Point q0 =
        split_point<kCompact>(p, r, sh.T, pixel_of<kCompact>(sh, s, base, j0), pre[0], use);
    const Point q1 = split_point<kCompact>(
        p, r, sh.T, pixel_of<kCompact>(sh, s, base, two ? j1 : j0), pre[1], use);
    store_point(s, j0, q0);
    if (two) store_point(s, j1, q1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const Point& q = h ? q1 : q0;
      if (h && !two) break;
      if (q.valid) {
        m[0] += (double)mul(q.rI, q.rI);
        m[1] += (double)mul(q.rI, q.rZ);
        m[2] += (double)mul(q.rZ, q.rZ);
        m[3] += 1.0;
      }
      if (q.selected) m[4] += 1.0;
    }
  }
}

// A thread's first two kept points of a Sigma step (j0 and j0 + the
// block's threads), loaded before the launch's carry so that the two
// loads' latencies overlap.
struct SigmaPair {
  float rI[2], rZ[2];
  bool valid[2];
};

__device__ __forceinline__ SigmaPair sigma_pair(const Points& s, int j0, int n_mine) {
  SigmaPair q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = j0 + h * (int)blockDim.x;
    q.rI[h] = q.rZ[h] = 0.f;
    q.valid[h] = false;
    if (j < n_mine) {
      q.rI[h] = s.at(0, j);
      q.rZ[h] = s.at(1, j);
      q.valid[h] = s.valid[j] != 0;
    }
  }
  return q;
}

// One Sigma step's weighted moments (sigma_moments'), two kept points a
// thread at once, the first two from `first` (sigma_pair).
__device__ __forceinline__ void split_sigma(const Params& p, const Precision& P, const Points& s,
                                            int n_mine, const SigmaPair& first,
                                            double (&m)[kScaleSums]) {
  const int nt = blockDim.x;
  for (int j0 = threadIdx.x; j0 < n_mine; j0 += 2 * nt) {
    const SigmaPair q = j0 == (int)threadIdx.x ? first : sigma_pair(s, j0, n_mine);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (q.valid[h]) {
        float maha, w;
        tdist_weight(P, p.nu, q.rI[h], q.rZ[h], &maha, &w);
        m[0] += (double)mul(w, mul(q.rI[h], q.rI[h]));
        m[1] += (double)mul(w, mul(q.rI[h], q.rZ[h]));
        m[2] += (double)mul(w, mul(q.rZ[h], q.rZ[h]));
      }
    }
  }
}

// A t-distribution stage launch's row pointers and this CTA's slice.
struct SplitRow {
  SplitState* st;
  double* sums;
  double* partials;
  float* out;
  int base, n_mine;
};

__device__ __forceinline__ SplitRow split_row(const Params& p, int b) {
  SplitRow w;
  w.st = reinterpret_cast<SplitState*>(p.split_state + (int64_t)b * kSplitStateWords);
  w.sums = p.split_sums + (int64_t)b * kSplitSums;
  w.partials = reinterpret_cast<double*>(p.split_points + (int64_t)b * split_row_bytes(p.N) +
                                         points_bytes(p.N));
  w.out = p.out + b * p.out_stride;
  w.base = blockIdx.x * p.P;
  w.n_mine = max(0, min(p.P, p.N - w.base));
  return w;
}

// The t-distribution's Sigma steps (stage 1..steps) and normal equations
// (steps + 1) on plain CTAs. Each thread loads the scale carry and the
// stage before's totals itself (broadcast loads, issued with its first
// kept points') and computes Sigma from them in registers (seed_sigma's
// and sigma_update's arithmetic): no barrier before the pass. The row's
// sums by split_partial and split_totals; the last CTA writes them and the
// scale fields it changed.
template <bool kCompact>
__device__ void split_scale(const Params& p, Shared& sh, int& last) {
  const int b = blockIdx.y, t = threadIdx.x;
  const int stage = p.split_stage, steps = p.split_steps;
  const Row r = row_of(p, b);
  const SplitRow w = split_row(p, b);
  const Points s = split_points_of(p, b, w.base);
  const SplitState* st = w.st;
  SigmaPair pair = {};
  if (stage <= steps) pair = sigma_pair(s, t, w.n_mine);
  float a = st->a, bq = st->bq, c = st->c, n = st->n, n_raw = st->n_raw, n_sel = st->n_sel;
  int n_fp = st->n_fp;
  const int done = st->done, k_row = st->k;
  if (!done && stage == 1) {
    // The moment seed (seed_sigma), warm from the carried Sigma where set.
    const double s0 = w.sums[0], s1 = w.sums[1], s2 = w.sums[2];
    n_raw = (float)w.sums[kSumValid];
    n_sel = (float)w.sums[kSumSelected];
    n = fmaxf(n_raw, 1.f);
    a = add(__fdiv_rn((float)s0, n), p.floor_ii);
    bq = __fdiv_rn((float)s1, n);
    c = add(__fdiv_rn((float)s2, n), p.floor_zz);
    n_fp = p.scale_iters;
    if (k_row > 0 && p.warm_iters > 0) {
      const float s00 = st->best[kBestSigma], s01 = st->best[kBestSigma + 1],
                  s10 = st->best[kBestSigma + 2], s11 = st->best[kBestSigma + 3];
      if (isfinite(s00) && isfinite(s01) && isfinite(s10) && isfinite(s11)) {
        a = fmaxf(s00, p.floor_ii);
        bq = s01;
        c = fmaxf(s11, p.floor_zz);
        n_fp = p.warm_iters;
      }
    }
  } else if (!done && stage - 1 <= n_fp) {
    // sigma_update from the step before's weighted moments.
    const double s0 = w.sums[0], s1 = w.sums[1], s2 = w.sums[2];
    a = add(__fdiv_rn((float)s0, n), p.floor_ii);
    bq = __fdiv_rn((float)s1, n);
    c = add(__fdiv_rn((float)s2, n), p.floor_zz);
  }
  split_stamp(p, 3);
  split_stamp(p, 4);
  const Precision P = precision(a, bq, c);
  const bool step = !done && stage <= steps && stage <= n_fp;
  const bool normal = !done && stage == steps + 1;
  bool is_last;
  if (step) {
    double m[kScaleSums] = {0.0, 0.0, 0.0};
    split_sigma(p, P, s, w.n_mine, pair, m);
    split_stamp(p, 5);
    is_last = split_partial<kScaleSums>(m, sh, w.partials, &w.st->ticket, last);
    split_stamp(p, 6);
    if (is_last && gridDim.x > 1) split_totals<kScaleSums>(w.partials, sh.tot);
  } else if (normal) {
    double acc[kNormalSums];
#pragma unroll
    for (int k = 0; k < kNormalSums; ++k) acc[k] = 0.0;
    normal_sums<kCompact, true>(p, r, sh, s, w.base, w.n_mine, P, acc, blockDim.x);
    split_stamp(p, 5);
    is_last = split_partial<kNormalSums>(acc, sh, w.partials, &w.st->ticket, last);
    split_stamp(p, 6);
    if (is_last && gridDim.x > 1) split_totals<kNormalSums>(w.partials, sh.tot);
  } else {
    // Nothing to sum (a stopped row, a step it does not take).
    split_stamp(p, 5);
    is_last = split_arrive(&w.st->ticket, last);
    split_stamp(p, 6);
  }
  split_stamp(p, 7);
  if (!is_last) return;
  if (t < kSplitSums) {
    double v = 0.0;
    if (step) v = t < kScaleSums ? sh.tot[t] : 0.0;
    if (normal) v = t < kNormalSums ? sh.tot[t] : 0.0;
    if (t == kSumDone) v = done ? 1.0 : 0.0;
    if (t == kSumSteps) v = done ? 0.0 : (double)n_fp;
    w.sums[t] = v;
  }
  if (t == 0) {
    w.st->a = a;
    w.st->bq = bq;
    w.st->c = c;
    w.st->n = n;
    w.st->n_raw = n_raw;
    w.st->n_sel = n_sel;
    w.st->n_fp = n_fp;
    w.st->ticket = 0u;  // for the next launch
  }
}

// The t-distribution's stage 0 (the residual pass; from iteration 1 on
// first the decision of the iteration before, on warp 0) and the finish
// (the last decision and the write-out) on plain CTAs, or, for
// compaction's first launch, on a cluster (select_slots); the row's sums
// by split_partial and split_totals.
template <bool kCompact>
__device__ void split_tdist(const Params& p, Shared& sh, DecideScratch& ds, double* tot_in,
                            int& k_row, int& decided, int& last) {
  const int b = blockIdx.y, t = threadIdx.x;
  const int stage = p.split_stage;
  const bool first = stage == 0 && p.split_iter == 0;
  const Row r = row_of(p, b);
  const SplitRow w = split_row(p, b);
  const Points s = split_points_of(p, b, w.base);
  SplitState* st = w.st;

  // The carry: the level's initial state, or all of it; and the
  // all-reduced totals of the normal equations.
  if (first) init_carry(p, sh, b, k_row);
  else load_carry(st, sh, k_row);
  if (!first && t < kSplitSums) tot_in[t] = w.sums[t];
  if (t == 0) decided = 0;
  __syncthreads();
  split_stamp(p, 3);
  if (first && kCompact) select_slots(p, r, sh, s, b, blockIdx.x, (int)gridDim.x);
  // The reference planes of this thread's first points, in flight while
  // warp 0 takes the decision.
  RefRaw pre[2] = {};
  const bool have = !first && !sh.done;
  if (have) split_prefetch<kCompact>(p, r, sh, s, w.base, w.n_mine, pre);

  if (!first) {
    if (!sh.done && t < 32) {
      finish_lin_warp(p, sh, tot_in, lin_precision(sh, true));
      irls_step_warp(p, sh, ds, k_row, blockIdx.x == 0 ? w.out + kLevelStats : nullptr);
      if (t == 0) {
        ++k_row;
        decided = 1;
      }
    }
    __syncthreads();
  }
  split_stamp(p, 4);

  // This launch's pass over the CTA's points, for a live row, and the
  // row's sums.
  const bool live = !sh.done && stage != kStageFinish;
  bool is_last;
  if (live) {
    if (t == 0) {
      // The Sigma steps this iteration takes (seed_sigma's rule), for the
      // caller to launch.
      const float* seed = sh.best + kBestSigma;
      const bool warm = k_row > 0 && p.warm_iters > 0 && isfinite(seed[0]) &&
                        isfinite(seed[1]) && isfinite(seed[2]) && isfinite(seed[3]);
      sh.n_fp = warm ? p.warm_iters : p.scale_iters;
    }
    double m[kMomentSums] = {0.0, 0.0, 0.0, 0.0, 0.0};
    split_residuals<kCompact>(p, r, sh, s, w.base, w.n_mine, pre, have, m);
    split_stamp(p, 5);
    is_last = split_partial<kMomentSums>(m, sh, w.partials, &st->ticket, last);
    split_stamp(p, 6);
    if (is_last && gridDim.x > 1) split_totals<kMomentSums>(w.partials, sh.tot);
  } else {
    // Nothing to sum (a stopped row, the finish).
    split_stamp(p, 5);
    is_last = split_arrive(&st->ticket, last);
    split_stamp(p, 6);
  }
  split_stamp(p, 7);
  if (!is_last) return;

  // The last CTA: the stage's sums (the moments, valid and selected
  // counts; zeros elsewhere), the carry, and the row's write-out where the
  // decision stopped it or at the finish.
  if (t < kSplitSums) {
    double v = 0.0;
    if (live)
      v = t < 3 ? sh.tot[t] : t == kSumValid ? sh.tot[3] : t == kSumSelected ? sh.tot[4] : 0.0;
    if (t == kSumDone) v = sh.done ? 1.0 : 0.0;
    if (t == kSumSteps) v = live ? (double)sh.n_fp : 0.0;
    w.sums[t] = v;
  }
  store_carry(st, sh, k_row);
  if (decided && (sh.done || stage == kStageFinish)) {
    __syncthreads();  // the carry is stored before the record takes the prior
    if (p.mu > 0.f && t == 0)
      for (int i = 0; i < 6; ++i) sh.best[kBestA + 7 * i] = add(sh.best[kBestA + 7 * i], p.mu);
    __syncthreads();
    write_level_row(p, sh, b, k_row, w.out);
  }
}

// Every other estimator's stage launch: clusters of
// cluster_size(N) CTAs; stage 0 the whole linearization (linearize_row,
// its reductions inside the launch), the decision on warp 0 as the
// t-distribution's (finish_lin in lane 0, then irls_step_warp), rank 0
// writes the sums and the carry after a cluster barrier.
template <bool kCompact>
__device__ void split_robust(const Params& p, Shared& sh, DecideScratch& ds, double* tot_in,
                             int& k_row, int& decided) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int b = blockIdx.y, t = threadIdx.x;
  const int stage = p.split_stage;
  const bool first = stage == 0 && p.split_iter == 0;
  const Row r = row_of(p, b);
  const int base = rank * p.P;
  const Points s = split_points_of(p, b, base);
  SplitState* st = reinterpret_cast<SplitState*>(p.split_state + (int64_t)b * kSplitStateWords);
  double* sums = p.split_sums + (int64_t)b * kSplitSums;
  float* o = p.out + b * p.out_stride;

  if (first) init_carry(p, sh, b, k_row);
  else load_carry(st, sh, k_row);
  if (!first && t < kSplitSums) tot_in[t] = sums[t];
  if (t == 0) decided = 0;
  __syncthreads();
  split_stamp(p, 3);
  if (first && kCompact) select_slots(p, r, sh, s, b, rank, C);

  // The decision of the iteration before (every CTA, from the same totals;
  // the counts come with stage 0's sums, Sigma is this rank's own).
  if (!first) {
    if (!sh.done && t < 32) {
      if (t == 0) {
        sh.n_raw = (float)tot_in[kSumValid];
        sh.n = fmaxf(sh.n_raw, 1.f);
        sh.n_sel = (float)tot_in[kSumSelected];
        finish_lin(p, sh, tot_in, lin_precision(sh, false), false);
      }
      __syncwarp();
      irls_step_warp(p, sh, ds, k_row, rank == 0 ? o + kLevelStats : nullptr);
      if (t == 0) {
        ++k_row;
        decided = 1;
      }
    }
    __syncthreads();
  }
  split_stamp(p, 4);

  const bool live = !sh.done && stage != kStageFinish;
  int parity = 0;
  if (live) linearize_row<true, kCompact>(p, r, sh, s, b, rank, C, parity, false, nullptr, false);
  split_stamp(p, 5);
  split_stamp(p, 6);
  cluster.sync();  // every CTA has read the buffers rank 0 writes below
  split_stamp(p, 7);
  if (rank != 0) return;
  if (t < kSplitSums) {
    double v = 0.0;
    if (live)
      v = t < kNormalSums ? sh.tot[t]
          : t == kSumValid ? (double)sh.n_raw
          : t == kSumSelected ? (double)sh.n_sel : 0.0;
    if (t == kSumDone) v = sh.done ? 1.0 : 0.0;
    if (t == kSumSteps) v = live ? (double)sh.n_fp : 0.0;
    sums[t] = v;
  }
  store_carry(st, sh, k_row);
  // A row leaves the level as its decision stops it, or at the finish:
  // mode (b)'s write-out (the posterior A + mu I into the row only).
  if (decided && (sh.done || stage == kStageFinish)) {
    __syncthreads();  // the carry is stored before the record takes the prior
    if (p.mu > 0.f && t == 0)
      for (int i = 0; i < 6; ++i) sh.best[kBestA + 7 * i] = add(sh.best[kBestA + 7 * i], p.mu);
    __syncthreads();
    write_level_row(p, sh, b, k_row, o);
  }
}

template <bool kRobust, bool kCompact>
__global__ void __launch_bounds__(kThreads, 1) split_stage_kernel(Params p) {
  __shared__ Shared sh;
  __shared__ double tot_in[kSplitSums];  // the all-reduced sums of the launch before
  __shared__ DecideScratch ds;
  __shared__ int k_row, decided, last;
  const int t = threadIdx.x;
  const bool stamped = p.split_timing != nullptr && blockIdx.x == 0 && blockIdx.y == 0;
  if (stamped && t == 0) {
    p.split_timing[0] = (long long)global_ns();
    p.split_timing[2] = clock64();
  }
  if constexpr (kRobust) {
    split_robust<kCompact>(p, sh, ds, tot_in, k_row, decided);
  } else if (p.split_stage >= 1 && p.split_stage <= p.split_steps + 1) {
    split_scale<kCompact>(p, sh, last);
  } else {
    split_tdist<kCompact>(p, sh, ds, tot_in, k_row, decided, last);
  }
  if (stamped) {
    __syncthreads();
    if (t == 0) {
      p.split_timing[8] = clock64();
      p.split_timing[1] = (long long)global_ns();
    }
  }
}

struct Plan {
  int P, stored, slots_shared;
  size_t dyn, slot_at;
};

// The points per CTA and whether they fit in shared memory beside the
// kernel's static shared memory; under compaction (`compact`) whether the
// CTA's slot table (P int32) fits there too, after them (else it goes to
// the global table).
int plan_of(const void* kernel, int N, int C, int compact, Plan* plan) {
  int dev, optin;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  plan->P = (N + C - 1) / C;
  const size_t all = (size_t)points_bytes(plan->P);
  plan->stored = attr.sharedSizeBytes + all <= (size_t)optin;
  plan->dyn = plan->stored ? all : 0;
  const size_t slots = ((size_t)sizeof(int) * plan->P + 15) & ~(size_t)15;
  plan->slots_shared = compact && attr.sharedSizeBytes + plan->dyn + slots <= (size_t)optin;
  plan->slot_at = plan->dyn;
  if (plan->slots_shared) plan->dyn += slots;
  return 0;
}

// Per (device, kernel): the attributes a cluster of up to 16 CTAs with up
// to the card's opt-in shared memory needs; per (device, kernel, C, bytes):
// cudaOccupancyMaxActiveClusters, checked once (0 means the launch could
// never run).
struct Prepared {
  int dev;
  const void* kernel;
  int C;
  size_t dyn;
};
std::mutex g_mutex;
std::vector<Prepared> g_prepared;

template <typename Kernel>
int prepare(Kernel kernel, int C, size_t dyn, cudaLaunchConfig_t* cfg) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(g_mutex);
  for (const Prepared& q : g_prepared)
    if (q.dev == dev && q.kernel == (const void*)kernel && q.C == C && q.dyn == dyn) return 0;
  int optin;
  cudaFuncAttributes attr;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, (const void*)kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)attr.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int clusters = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
  if (e != cudaSuccess) return (int)e;
  if (clusters < 1) return kErrNoActiveCluster;
  g_prepared.push_back({dev, (const void*)kernel, C, dyn});
  return 0;
}

// One launch of C CTAs a row of `threads` for B rows, as clusters of C
// (`cluster`; the kernel prepared for them first) or as plain CTAs.
template <typename Kernel>
int launch_grid(Kernel kernel, Params& p, int B, int C, int threads, size_t dyn, bool cluster,
                void* stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = cluster ? attr : nullptr;
  cfg.numAttrs = cluster ? 1 : 0;
  if (cluster) {
    const int e = prepare(kernel, C, dyn, &cfg);
    if (e) return e;
  }
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, p);
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

template <typename Kernel>
int launch(Kernel kernel, Params& p, int B, int C, void* stream) {
  if (C < 1 || C > kMaxCluster || B < 1 || p.N < 1) return (int)cudaErrorInvalidValue;
  Plan plan;
  int e = plan_of((const void*)kernel, p.N, C, p.budget > 0, &plan);
  if (e) return e;
  // A slot table the plan keeps out of shared memory needs the global one.
  if (p.budget > 0 && !plan.slots_shared && !p.slots) return (int)cudaErrorInvalidValue;
  p.P = plan.P;
  p.stored = plan.stored;
  p.slots_shared = plan.slots_shared;
  p.slot_at = (int64_t)plan.slot_at;
  return launch_grid(kernel, p, B, C, kThreads, plan.dyn, true, stream);
}

// A split-mode launch: C CTAs a row of `threads`, as a cluster of C (C <=
// kMaxCluster) or as plain CTAs. The split mode keeps its points in device
// memory (split_points) and compaction's slot tables in the global table,
// both from the level's first launch on: nothing in shared memory across
// launches; each CTA takes P = ceil(N / C) points.
template <typename Kernel>
int launch_split(Kernel kernel, Params& p, int B, int C, int threads, bool cluster,
                 void* stream) {
  if (C < 1 || C > (cluster ? kMaxCluster : kMaxSplitCtas) || B < 1 || p.N < 1)
    return (int)cudaErrorInvalidValue;
  p.P = (p.N + C - 1) / C;
  p.stored = 1;
  p.slots_shared = 0;
  p.slot_at = 0;
  return launch_grid(kernel, p, B, C, threads, 0, cluster, stream);
}

Params params(const float* px, const float* py, const float* pz, const float* i1,
              const uint8_t* selected, const float* rgix, const float* rgiy,
              const float* rgzx, const float* rgzy, const float* const* ref_rows,
              int64_t ref_stride, int ref_table, float igt, float dgt, int budget,
              int* slots, int B, int N,
              const float* slab, int64_t slab_stride, int H, int W, const float* K,
              const float* T, int64_t T_stride, int use_depth, int ref_grad, float nu,
              float floor_ii, float floor_zz, int scale_iters, int warm_iters,
              int estimator, int influence, float huber_k, float tukey_b, float min_si,
              float min_sz) {
  Params p = {};
  p.px = px; p.py = py; p.pz = pz; p.i1 = i1; p.selected = selected;
  p.rgix = rgix; p.rgiy = rgiy; p.rgzx = rgzx; p.rgzy = rgzy;
  if (ref_rows && ref_table == kTableDevice) {
    p.ref_dev = ref_rows;  // a device address: never read on the host
  } else if (ref_rows) {
    const int n = ref_table == kTableParams ? (B < kMaxRefRows ? B : kMaxRefRows) : 1;
    for (int b = 0; b < n; ++b) p.ref_rows[b] = ref_rows[b];
  }
  p.ref_stride = ref_stride; p.ref_table = ref_table; p.igt = igt; p.dgt = dgt;
  p.budget = budget; p.slots = slots;
  p.N = N; p.slab = slab; p.slab_stride = slab_stride; p.H = H; p.W = W;
  p.ref_H = H;
  p.K = K; p.T = T; p.T_stride = T_stride;
  p.use_depth = use_depth; p.ref_grad = ref_grad;
  p.nu = nu; p.floor_ii = floor_ii; p.floor_zz = floor_zz;
  p.scale_iters = scale_iters; p.warm_iters = warm_iters;
  p.estimator = estimator; p.influence = influence;
  p.huber_k = huber_k; p.tukey_b = tukey_b; p.min_si = min_si; p.min_sz = min_sz;
  return p;
}

// The estimator and influence codes are ones the kernel has.
bool codes_ok(int estimator, int influence) {
  return estimator >= kEstTdist && estimator <= kEstNone && influence >= kInfUnit &&
         influence <= kInfTdist;
}

// The reference arguments are valid: the arrays, or a slab route whose
// points are the slab's pixels or, under compaction, its budget slots (a
// table among the parameters for at most kMaxRefRows rows; a device table
// is not read here).
bool refs_ok(const float* const* ref_rows, int ref_table, int budget, int B, int N, int H,
             int W) {
  if (!ref_rows) return budget == 0;
  if (ref_table < kTableStride || ref_table > kTableDevice || budget < 0 ||
      N != (budget > 0 ? budget : H * W))
    return false;
  if (ref_table == kTableDevice) return true;
  return ref_rows[0] && (ref_table != kTableParams || B <= kMaxRefRows);
}

}  // namespace

// What a launch over N points with clusters of C CTAs uses (`compact`:
// N compaction slots on the slab route): out[0] points per CTA, out[1] 1
// if they are kept in shared memory, out[2] dynamic shared memory bytes
// per CTA, out[3] 1 if compaction's slot table is in shared memory (0:
// the launch needs the global one). Returns a CUDA error code (0: none).
extern "C" int dvo_level_plan(int N, int C, int compact, int* out) {
  Plan plan;
  const int e = plan_of(compact ? (const void*)track_level_kernel<false, true>
                                : (const void*)track_level_kernel<false, false>,
                        N, C, compact, &plan);
  out[0] = plan.P;
  out[1] = plan.stored;
  out[2] = (int)plan.dyn;
  out[3] = plan.slots_shared;
  return e;
}

// The message of a code the entry points return.
extern "C" const char* dvo_error_string(int code) {
  if (code == kErrNoActiveCluster)
    return "no cluster of this size fits on the card "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  if (code == 100002)  // csrc/pose_graph_grid.cu's kErrNotCoResident
    return "the card cannot hold the cooperative grid's CTAs at once "
           "(no cooperative launch, or too few resident CTAs an SM)";
  return cudaGetErrorString((cudaError_t)code);
}

// Mode (a): B linearizations, one per batch row, in one launch of clusters
// of C CTAs on `stream`, no host sync. The reference points (px..rgzy) are
// (B, N); or, where ref_rows is not null, the slab route: row b's (6, H, W)
// reference slab is ref_rows[b] (ref_table kTableParams, B <= 32; or
// kTableDevice, ref_rows then a device array of B pointers) or ref_rows[0]
// + b * ref_stride floats (kTableStride), its H W pixels the N points,
// selected with the gradient thresholds igt and dgt; with budget > 0 the
// selected pixels compacted to N = budget slots (slots: a (B, budget)
// int32 scratch where dvo_level_plan's out[3] is 0, else unread). Row b's
// current slab starts at slab + b *
// slab_stride floats; T is (B, 4, 4), sigma_init (B, 2, 2) (read only with
// warm, and with the t-distribution). Reference gradients (rgix..rgzy) are
// read only with ref_grad (rgzx, rgzy only with use_depth too). estimator,
// influence: kEst*, kInf* codes, with huber_k, tukey_b and the scale floors
// min_si, min_sz. out: (B, 53) floats, each row laid out as the kOut*
// offsets; rI, rZ, valid: (B, N), the residual pass's values. Returns a
// CUDA error code (0: launched).
extern "C" int dvo_linearize(
    int B, const float* px, const float* py, const float* pz, const float* i1,
    const uint8_t* selected, const float* rgix, const float* rgiy,
    const float* rgzx, const float* rgzy, const float* const* ref_rows,
    int64_t ref_stride, int ref_table, float igt, float dgt, int budget, int* slots, int N,
    const float* slab, int64_t slab_stride, int H, int W, const float* K,
    const float* T, int use_depth, int ref_grad, float nu, float floor_ii,
    float floor_zz, int scale_iters, int warm_iters, int estimator, int influence,
    float huber_k, float tukey_b, float min_si, float min_sz, const float* sigma_init,
    int warm, int C, float* out, float* rI, float* rZ, uint8_t* valid,
    void* stream) {
  if (!refs_ok(ref_rows, ref_table, budget, B, N, H, W) || !codes_ok(estimator, influence))
    return (int)cudaErrorInvalidValue;
  Params p = params(px, py, pz, i1, selected, rgix, rgiy, rgzx, rgzy, ref_rows,
                    ref_stride, ref_table, igt, dgt, budget, slots, B, N, slab,
                    slab_stride, H, W, K, T, 16, use_depth, ref_grad, nu, floor_ii, floor_zz,
                    scale_iters, warm_iters, estimator, influence, huber_k, tukey_b,
                    min_si, min_sz);
  p.sigma_init = sigma_init;
  p.warm = warm;
  p.out = out;
  p.rI = rI;
  p.rZ = rZ;
  p.valid = valid;
  const bool tdist = estimator == kEstTdist;
  return launch(budget > 0 ? (tdist ? linearize_kernel<false, true> : linearize_kernel<true, true>)
                           : (tdist ? linearize_kernel<false, false>
                                    : linearize_kernel<true, false>),
                p, B, C, stream);
}

// Mode (b): one pyramid level's IRLS loop for B rows in one launch, from
// T_init (row b's at T_init + b * T_stride floats; the other inputs,
// compaction's budget and slots too, as dvo_linearize's). LM when lm_init > 0, else Gauss-Newton with rollback;
// the Sigma warm start from the last accepted Sigma after the first
// iteration when warm_iters > 0 (the t-distribution); the motion prior
// when mu > 0, its record the posterior A + mu I. out: row b's 67 + 5 *
// max_iterations + 3
// floats at out + b * out_stride, as the kLevel* and kExtra* offsets
// (loglik_const as Params');
// out_i: row b's iterations and termination code at out_i + b *
// out_i_stride. Returns a CUDA error code (0: launched).
extern "C" int dvo_track_level(
    int B, const float* px, const float* py, const float* pz, const float* i1,
    const uint8_t* selected, const float* rgix, const float* rgiy,
    const float* rgzx, const float* rgzy, const float* const* ref_rows,
    int64_t ref_stride, int ref_table, float igt, float dgt, int budget, int* slots, int N,
    const float* slab, int64_t slab_stride, int H, int W, const float* K,
    const float* T_init, int64_t T_stride, int use_depth, int ref_grad, float nu,
    float floor_ii, float floor_zz, int scale_iters, int warm_iters, int estimator,
    int influence, float huber_k, float tukey_b, float min_si, float min_sz,
    int max_iterations, float precision, float lm_init, float lm_up, float lm_down,
    float lm_max, float mu, int C, float* out, int64_t out_stride, int* out_i,
    int64_t out_i_stride, double loglik_const, void* stream) {
  if (max_iterations < 1 || !refs_ok(ref_rows, ref_table, budget, B, N, H, W) ||
      !codes_ok(estimator, influence) || !(mu >= 0.f))
    return (int)cudaErrorInvalidValue;
  Params p = params(px, py, pz, i1, selected, rgix, rgiy, rgzx, rgzy, ref_rows,
                    ref_stride, ref_table, igt, dgt, budget, slots, B, N, slab,
                    slab_stride, H, W, K, T_init, T_stride, use_depth, ref_grad, nu, floor_ii,
                    floor_zz, scale_iters, warm_iters, estimator, influence, huber_k,
                    tukey_b, min_si, min_sz);
  p.max_iterations = max_iterations;
  p.precision = precision;
  p.lm_init = lm_init;
  p.lm_up = lm_up;
  p.lm_down = lm_down;
  p.lm_max = lm_max;
  p.mu = mu;
  p.out = out;
  p.out_stride = out_stride;
  p.out_i = out_i;
  p.out_i_stride = out_i_stride;
  p.loglik_const = loglik_const;
  const bool tdist = estimator == kEstTdist;
  return launch(budget > 0 ? (tdist ? track_level_kernel<false, true>
                                    : track_level_kernel<true, true>)
                           : (tdist ? track_level_kernel<false, false>
                                    : track_level_kernel<true, false>),
                p, B, C, stream);
}

// The split mode: one stage launch of a pyramid level's IRLS loop for B
// rows over this rank's band of the reference (see split_stage_kernel),
// on `stream`, no host sync. The inputs as dvo_track_level's, the
// reference on the slab route only (ref_rows: row b's (6, ref_H, W) band
// of reference rows starting at image row row0; N its ref_H W pixels, or
// its budget slots, slots then the (B, budget) table the level's launches
// share); the current slabs (6, H, W) whole. state: (B, kSplitStateWords)
// floats (zeroed before the level's first launch: the ticket), sums (B,
// kSplitSums) doubles and points (B split_row_bytes(N) bytes), kept by the
// caller from the level's first launch (stage 0 at iter 0) to its last.
// C: the cluster size (the other estimators' launches, compaction's first
// launch); ctas: the t-distribution's plain CTAs a row (at most
// kMaxSplitCtas). timing: null, or kSplitTimingSlots int64 (the phase
// stamps); stage: 0, 1..steps (the t-distribution's Sigma steps), steps +
// 1 (its normal equations) or kStageFinish. out, out_i: mode (b)'s rows,
// written as each row leaves the level. Returns a CUDA error code (0:
// launched).
extern "C" int dvo_track_level_split(
    int B, const float* px, const float* py, const float* pz, const float* i1,
    const uint8_t* selected, const float* rgix, const float* rgiy,
    const float* rgzx, const float* rgzy, const float* const* ref_rows,
    int64_t ref_stride, int ref_table, float igt, float dgt, int budget, int* slots, int N,
    const float* slab, int64_t slab_stride, int H, int W, const float* K,
    const float* T_init, int64_t T_stride, int use_depth, int ref_grad, float nu,
    float floor_ii, float floor_zz, int scale_iters, int warm_iters, int estimator,
    int influence, float huber_k, float tukey_b, float min_si, float min_sz,
    int max_iterations, float precision, float lm_init, float lm_up, float lm_down,
    float lm_max, float mu, int C, float* out, int64_t out_stride, int* out_i,
    int64_t out_i_stride, double loglik_const, int ref_H, int row0, float* state,
    double* sums, uint8_t* points, int ctas, long long* timing, int stage, int steps, int iter,
    void* stream) {
  const bool tdist = estimator == kEstTdist;
  const bool stage_ok = stage == kStageFinish || stage == 0 ||
                        (tdist && stage >= 1 && stage <= steps + 1);
  if (max_iterations < 1 || !ref_rows || ref_H < 1 || row0 < 0 ||
      !refs_ok(ref_rows, ref_table, budget, B, N, ref_H, W) || !codes_ok(estimator, influence) ||
      !(mu >= 0.f) || !state || !sums || !points || steps < 0 || steps + 1 >= kStageFinish ||
      !stage_ok || ctas < 1 || ctas > kMaxSplitCtas ||
      iter < 0 || (budget > 0 && !slots))
    return (int)cudaErrorInvalidValue;
  Params p = params(px, py, pz, i1, selected, rgix, rgiy, rgzx, rgzy, ref_rows,
                    ref_stride, ref_table, igt, dgt, budget, slots, B, N, slab,
                    slab_stride, H, W, K, T_init, T_stride, use_depth, ref_grad, nu, floor_ii,
                    floor_zz, scale_iters, warm_iters, estimator, influence, huber_k,
                    tukey_b, min_si, min_sz);
  p.ref_H = ref_H;
  p.row0 = row0;
  p.max_iterations = max_iterations;
  p.precision = precision;
  p.lm_init = lm_init;
  p.lm_up = lm_up;
  p.lm_down = lm_down;
  p.lm_max = lm_max;
  p.mu = mu;
  p.out = out;
  p.out_stride = out_stride;
  p.out_i = out_i;
  p.out_i_stride = out_i_stride;
  p.loglik_const = loglik_const;
  p.split_state = state;
  p.split_sums = sums;
  p.split_stage = stage;
  p.split_steps = steps;
  p.split_iter = iter;
  p.split_points = points;
  p.split_timing = timing;
  if (!tdist)
    return launch_split(budget > 0 ? split_stage_kernel<true, true> : split_stage_kernel<true, false>,
                        p, B, C, kThreads, true, stream);
  // The t-distribution: plain CTAs, but compaction's first launch (its
  // slot tables, select_slots, on a cluster of C) and the finish (one CTA
  // a row: no pass).
  if (budget > 0 && stage == 0 && iter == 0)
    return launch_split(split_stage_kernel<false, true>, p, B, C, kThreads, true, stream);
  auto kernel = budget > 0 ? split_stage_kernel<false, true> : split_stage_kernel<false, false>;
  return launch_split(kernel, p, B, stage == kStageFinish ? 1 : ctas, kSplitThreads, false,
                      stream);
}
