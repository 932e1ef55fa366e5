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
// models/dense_tracker.py::_track_level over it (mode b). Both cover the
// t-distribution branch (both gradient sources, use_depth on and off, the
// Sigma warm start); mode (b) without the motion prior (mu == 0).
//
//   (a) linearize_kernel: one linearization per batch row at the row's pose
//       T, written as the 51-float Linearization vector (kOut*), and the
//       per-point rI, rZ and valid of the residual pass.
//   (b) track_level_kernel: a pyramid level's whole IRLS loop per batch row,
//       up to max_iterations linearizations and solves in one launch;
//       writes the level's pose, the last accepted linearization (the
//       tracker's 50-float record, kBest*), the per-iteration statistics,
//       the iteration count and the termination code.
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
constexpr int kMomentSums = 4;     // rI^2, rI rZ, rZ^2, valid count
constexpr int kScaleSums = 3;      // weighted moments of one Sigma step
constexpr int kNormalSums = 29;    // A (upper, 21), b (6), err_raw, log1p_sum
constexpr int kPointFloats = 9;    // rI, rZ, X, Y, Z, gix, giy, gzx, gzy
constexpr int kPointBytes = 4 * kPointFloats + 1;  // and valid
// The Linearization vector of mode (a) (ops/linearize.py reads the same
// offsets).
constexpr int kOutA = 0, kOutB = 36, kOutErrMean = 42, kOutN = 43,
              kOutNRaw = 44, kOutSigma = 45, kOutLog1p = 49, kOutErrRaw = 50,
              kOutSize = 51;
// The tracker's record of the last accepted linearization
// (models/dense_tracker.py _flat).
constexpr int kBestA = 0, kBestB = 36, kBestErr = 42, kBestErrRaw = 43,
              kBestSigma = 44, kBestNRaw = 48, kBestLog1p = 49, kBestSize = 50;
// Mode (b)'s row: pose (16), record (50), then the statistics (4,
// max_iterations): valid, error, delta_norm, accepted (0 or 1).
constexpr int kLevelT = 0, kLevelBest = 16, kLevelStats = 66;
// Termination codes (models/dense_tracker.py TERM_*).
constexpr int kTermIterations = 0, kTermIncrement = 1, kTermErrorIncreased = 2,
              kTermTooFew = 3;
// Returned when no cluster of the asked size fits on an SM group of the card.
constexpr int kErrNoActiveCluster = 100001;

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
  int N;
  const float* slab;    // (6, H, W) current pyramid level of row 0
  int64_t slab_stride;  // floats from one row's slab to the next (0: shared)
  int H, W;
  const float* K;           // (4,) fx, fy, cx, cy, shared by every row
  const float* T;           // (B, 4, 4) row-major: the pose (a), T_init (b)
  const float* sigma_init;  // (B, 2, 2) or null; mode (a) with warm only
  int use_depth, ref_grad, warm;
  float nu, floor_ii, floor_zz;
  int scale_iters, warm_iters;
  // Mode (b): the IRLS loop.
  int max_iterations;
  float precision, lm_init, lm_up, lm_down, lm_max;
  // Points per CTA, and whether they are kept in shared memory.
  int P, stored;
  // Outputs. (a): out (B, 51), rI / rZ / valid (B, N). (b): out (B,
  // kLevelStats + 4 * max_iterations), out_i (B, 2) iterations and
  // termination.
  float* out;
  int* out_i;
  float* rI;
  float* rZ;
  uint8_t* valid;
};

// One batch row's reference points and current slab.
struct Row {
  const float *px, *py, *pz, *i1, *rgix, *rgiy, *rgzx, *rgzy;
  const uint8_t* selected;
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
  float best[kBestSize];
  float lin[kOutSize];  // the last linearization
  float a, bq, c, n, n_raw;  // Sigma entries, valid count floored and raw
  float lam;
  int n_fp, done, term;
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
  bool valid;
};

// Warp, project, sample and residual of reference point i at pose T, in the
// order of ops/linearize.py::residuals_reference (and ops/sampler.py's plain
// sample).
__device__ __forceinline__ Point residual(const Params& p, const Row& r,
                                          const float* T, int i) {
  const float px = __ldg(r.px + i), py = __ldg(r.py + i), pz = __ldg(r.pz + i);
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
    q.gix = __ldg(r.rgix + i);
    q.giy = __ldg(r.rgiy + i);
    q.gzx = p.use_depth ? __ldg(r.rgzx + i) : 0.f;
    q.gzy = p.use_depth ? __ldg(r.rgzy + i) : 0.f;
  } else {
    q.gix = s[2];
    q.giy = s[3];
    q.gzx = s[4];
    q.gzy = s[5];
  }
  const float rI = sub(i2, __ldg(r.i1 + i));
  const float rZ = sub(z2, q.Z);
  bool valid = r.selected[i] && inb && (q.Z > 1e-6f) && isfinite(rI);
  if (p.use_depth) valid = valid && isfinite(rZ) && isfinite(q.gzx) && isfinite(q.gzy);
  q.valid = valid;
  q.rI = valid ? rI : 0.f;
  q.rZ = (valid && p.use_depth) ? rZ : 0.f;
  return q;
}

// The CTA's slice of points in shared memory, structure of arrays.
struct Points {
  float* f;  // kPointFloats planes of P floats
  uint8_t* valid;
  int P;
  __device__ float& at(int plane, int j) const { return f[plane * P + j]; }
};

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

// Point j of this CTA (reference point i): from shared memory, or
// recomputed where nothing is kept (`full`: the Jacobian inputs too).
template <bool full>
__device__ __forceinline__ Point load_point(const Params& p, const Row& r,
                                            const Shared& sh, const Points& s,
                                            int j, int i) {
  if (!p.stored) return residual(p, r, sh.T, i);
  Point q;
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

// One linearization of this cluster's batch row at sh.T: the residual pass,
// the Sigma fixed point and the normal equations. Every CTA ends with the
// same sh.lin. `seed` (2, 2) warm-starts Sigma when `warm` and finite. Mode
// (a) passes `residuals` to write rI, rZ and valid out.
__device__ void linearize_row(const Params& p, const Row& r, Shared& sh,
                              const Points& s, int b, int rank, int C,
                              int& parity, bool warm, const float* seed,
                              bool residuals) {
  const int base = rank * p.P;
  const int n_mine = max(0, min(p.P, p.N - base));
  const int64_t row0 = (int64_t)b * p.N;

  // Residual pass: every point of the slice, and the residual moments.
  {
    double m[kMomentSums] = {0.0, 0.0, 0.0, 0.0};
    for (int j = threadIdx.x; j < n_mine; j += kThreads) {
      const int i = base + j;
      const Point q = residual(p, r, sh.T, i);
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
    }
    cluster_sum<kMomentSums>(m, sh, parity, C);
    if (threadIdx.x == 0) {
      const float n_raw = (float)sh.tot[3];
      const float n = fmaxf(n_raw, 1.f);
      float a = add(__fdiv_rn((float)sh.tot[0], n), p.floor_ii);
      float bq = __fdiv_rn((float)sh.tot[1], n);
      float c = add(__fdiv_rn((float)sh.tot[2], n), p.floor_zz);
      int n_fp = p.scale_iters;
      if (warm) {
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
    __syncthreads();
  }

  // Sigma fixed point: the weighted moments under the current Sigma.
  for (int step = 0; step < sh.n_fp; ++step) {
    const Precision P = precision(sh.a, sh.bq, sh.c);
    double m[kScaleSums] = {0.0, 0.0, 0.0};
    for (int j = threadIdx.x; j < n_mine; j += kThreads) {
      const Point q = load_point<false>(p, r, sh, s, j, base + j);
      if (q.valid) {
        float maha, w;
        tdist_weight(P, p.nu, q.rI, q.rZ, &maha, &w);
        m[0] += (double)mul(w, mul(q.rI, q.rI));
        m[1] += (double)mul(w, mul(q.rI, q.rZ));
        m[2] += (double)mul(w, mul(q.rZ, q.rZ));
      }
    }
    cluster_sum<kScaleSums>(m, sh, parity, C);
    if (threadIdx.x == 0) {
      sh.a = add(__fdiv_rn((float)sh.tot[0], sh.n), p.floor_ii);
      sh.bq = __fdiv_rn((float)sh.tot[1], sh.n);
      sh.c = add(__fdiv_rn((float)sh.tot[2], sh.n), p.floor_zz);
    }
    __syncthreads();
  }

  // Weights, Jacobian and the normal equations
  // (ops/linearize.py::normal_equations_reference).
  const Precision P = precision(sh.a, sh.bq, sh.c);
  {
    double acc[kNormalSums];
#pragma unroll
    for (int k = 0; k < kNormalSums; ++k) acc[k] = 0.0;
    const float p01 = p.use_depth ? P.p01 : 0.f;
    const float p11 = p.use_depth ? P.p11 : 0.f;
    const float fx = __ldg(p.K + 0), fy = __ldg(p.K + 1);
    for (int j = threadIdx.x; j < n_mine; j += kThreads) {
      const Point q = load_point<true>(p, r, sh, s, j, base + j);
      if (!q.valid) continue;
      float maha, w;
      tdist_weight(P, p.nu, q.rI, q.rZ, &maha, &w);
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
    cluster_sum<kNormalSums>(acc, sh, parity, C);
  }
  if (threadIdx.x == 0) {
    float* o = sh.lin;
    int e = 0;
    for (int j = 0; j < 6; ++j) {
      for (int k = j; k < 6; ++k, ++e) {
        o[kOutA + 6 * j + k] = (float)sh.tot[e];
        o[kOutA + 6 * k + j] = (float)sh.tot[e];
      }
    }
    for (int k = 0; k < 6; ++k) o[kOutB + k] = (float)sh.tot[21 + k];
    const float log1p_sum = (float)sh.tot[28];
    o[kOutErrMean] =
        add(0.5f * logf(P.det), __fdiv_rn((p.nu + 2.f) * 0.5f * log1p_sum, sh.n));
    o[kOutN] = sh.n;
    o[kOutNRaw] = sh.n_raw;
    o[kOutSigma + 0] = sh.a;
    o[kOutSigma + 1] = sh.bq;
    o[kOutSigma + 2] = sh.bq;
    o[kOutSigma + 3] = sh.c;
    o[kOutLog1p] = log1p_sum;
    o[kOutErrRaw] = (float)sh.tot[27];
  }
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

// One IRLS step of models/dense_tracker.py::_track_level for this row, from
// sh.lin (the linearization at sh.T), in thread 0. Writes iteration k's
// statistics when `stats` is set (rank 0).
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
  solve6(best + kBestA, best + kBestB, lam, delta);
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

__device__ __forceinline__ Points points_of(const Params& p, float4* dyn) {
  Points s;
  s.f = reinterpret_cast<float*>(dyn);
  s.P = p.P;
  s.valid = reinterpret_cast<uint8_t*>(s.f + kPointFloats * p.P);
  return s;
}

__global__ void __launch_bounds__(kThreads, 1) linearize_kernel(Params p) {
  extern __shared__ float4 dyn_smem[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const Row r = row_of(p, b);
  if (threadIdx.x < 16) sh.T[threadIdx.x] = p.T[16 * b + threadIdx.x];
  __syncthreads();
  int parity = 0;
  linearize_row(p, r, sh, points_of(p, dyn_smem), b, rank, C, parity,
                p.warm != 0, p.warm ? p.sigma_init + 4 * b : nullptr, true);
  if (rank == 0 && threadIdx.x < kOutSize)
    p.out[(int64_t)b * kOutSize + threadIdx.x] = sh.lin[threadIdx.x];
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

__global__ void __launch_bounds__(kThreads, 1) track_level_kernel(Params p) {
  extern __shared__ float4 dyn_smem[];
  __shared__ Shared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), C = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const Row r = row_of(p, b);
  const Points s = points_of(p, dyn_smem);
  const int M = p.max_iterations;
  float* o = p.out + (int64_t)b * (kLevelStats + 4 * M);
  if (threadIdx.x < 16) {
    sh.T[threadIdx.x] = p.T[16 * b + threadIdx.x];
    sh.Tbest[threadIdx.x] = p.T[16 * b + threadIdx.x];
  }
  if (threadIdx.x < kBestSize) sh.best[threadIdx.x] = 0.f;
  if (threadIdx.x == 0) {
    sh.lam = p.lm_init > 0.f ? p.lm_init : 0.f;
    sh.done = 0;
    sh.term = kTermIterations;
  }
  __syncthreads();
  int parity = 0, k = 0;
  // Bounded by max_iterations whatever the stop flag says; every CTA reads
  // the same flag (computed from the same sums), so all take the same
  // number of barriers.
  while (k < M) {
    linearize_row(p, r, sh, s, b, rank, C, parity,
                  k > 0 && p.warm_iters > 0, sh.best + kBestSigma, false);
    if (threadIdx.x == 0) irls_step(p, sh, k, rank == 0 ? o + kLevelStats : nullptr);
    __syncthreads();
    ++k;
    if (sh.done) break;
  }
  if (rank == 0) {
    if (threadIdx.x < 16) o[kLevelT + threadIdx.x] = sh.Tbest[threadIdx.x];
    if (threadIdx.x < kBestSize) o[kLevelBest + threadIdx.x] = sh.best[threadIdx.x];
    // Statistics past the last iteration are zero.
    for (int q = threadIdx.x; q < 4 * M; q += kThreads)
      if (q % M >= k) o[kLevelStats + q] = 0.f;
    if (threadIdx.x == 0) {
      p.out_i[2 * b] = k;
      p.out_i[2 * b + 1] = sh.term;
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

struct Plan {
  int P, stored;
  size_t dyn;
};

// The points per CTA and whether they fit in shared memory beside the
// kernel's static shared memory.
int plan_of(const void* kernel, int N, int C, Plan* plan) {
  int dev, optin;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return (int)e;
  plan->P = (N + C - 1) / C;
  const size_t all = ((size_t)kPointBytes * plan->P + 15) & ~(size_t)15;
  plan->stored = attr.sharedSizeBytes + all <= (size_t)optin;
  plan->dyn = plan->stored ? all : 0;
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

template <typename Kernel>
int launch(Kernel kernel, Params& p, int B, int C, void* stream) {
  if (C < 1 || C > kMaxCluster || B < 1 || p.N < 1) return (int)cudaErrorInvalidValue;
  Plan plan;
  int e = plan_of((const void*)kernel, p.N, C, &plan);
  if (e) return e;
  p.P = plan.P;
  p.stored = plan.stored;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = plan.dyn;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = prepare(kernel, C, plan.dyn, &cfg);
  if (e) return e;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, p);
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}

Params params(const float* px, const float* py, const float* pz, const float* i1,
              const uint8_t* selected, const float* rgix, const float* rgiy,
              const float* rgzx, const float* rgzy, int N, const float* slab,
              int64_t slab_stride, int H, int W, const float* K, const float* T,
              int use_depth, int ref_grad, float nu, float floor_ii, float floor_zz,
              int scale_iters, int warm_iters) {
  Params p = {};
  p.px = px; p.py = py; p.pz = pz; p.i1 = i1; p.selected = selected;
  p.rgix = rgix; p.rgiy = rgiy; p.rgzx = rgzx; p.rgzy = rgzy;
  p.N = N; p.slab = slab; p.slab_stride = slab_stride; p.H = H; p.W = W;
  p.K = K; p.T = T;
  p.use_depth = use_depth; p.ref_grad = ref_grad;
  p.nu = nu; p.floor_ii = floor_ii; p.floor_zz = floor_zz;
  p.scale_iters = scale_iters; p.warm_iters = warm_iters;
  return p;
}

}  // namespace

// What a launch over N points with clusters of C CTAs uses: out[0] points
// per CTA, out[1] 1 if they are kept in shared memory, out[2] dynamic
// shared memory bytes per CTA. Returns a CUDA error code (0: none).
extern "C" int dvo_level_plan(int N, int C, int* out) {
  Plan plan;
  const int e = plan_of((const void*)track_level_kernel, N, C, &plan);
  out[0] = plan.P;
  out[1] = plan.stored;
  out[2] = (int)plan.dyn;
  return e;
}

// The message of a code the entry points return.
extern "C" const char* dvo_error_string(int code) {
  if (code == kErrNoActiveCluster)
    return "no cluster of this size fits on the card "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString((cudaError_t)code);
}

// Mode (a): B linearizations, one per batch row, in one launch of clusters
// of C CTAs on `stream`, no host sync. The reference points (px..rgzy) are
// (B, N); row b's slab starts at slab + b * slab_stride floats; T is (B, 4,
// 4), sigma_init (B, 2, 2) (read only with warm). Reference gradients
// (rgix..rgzy) are read only with ref_grad (rgzx, rgzy only with use_depth
// too). out: (B, 51) floats, each row laid out as the kOut* offsets; rI,
// rZ, valid: (B, N), the residual pass's values. Returns a CUDA error code
// (0: launched).
extern "C" int dvo_linearize(
    int B, const float* px, const float* py, const float* pz, const float* i1,
    const uint8_t* selected, const float* rgix, const float* rgiy,
    const float* rgzx, const float* rgzy, int N, const float* slab,
    int64_t slab_stride, int H, int W, const float* K, const float* T,
    int use_depth, int ref_grad, float nu, float floor_ii, float floor_zz,
    int scale_iters, int warm_iters, const float* sigma_init, int warm, int C,
    float* out, float* rI, float* rZ, uint8_t* valid, void* stream) {
  Params p = params(px, py, pz, i1, selected, rgix, rgiy, rgzx, rgzy, N, slab,
                    slab_stride, H, W, K, T, use_depth, ref_grad, nu, floor_ii,
                    floor_zz, scale_iters, warm_iters);
  p.sigma_init = sigma_init;
  p.warm = warm;
  p.out = out;
  p.rI = rI;
  p.rZ = rZ;
  p.valid = valid;
  return launch(linearize_kernel, p, B, C, stream);
}

// Mode (b): one pyramid level's IRLS loop for B rows in one launch, from
// T_init (B, 4, 4) (the other inputs as dvo_linearize's). LM when lm_init >
// 0, else Gauss-Newton with rollback; the Sigma warm start from the last
// accepted Sigma after the first iteration when warm_iters > 0. out: (B,
// 66 + 4 * max_iterations) floats as the kLevel* offsets; out_i: (B, 2)
// iterations and termination code. Returns a CUDA error code (0: launched).
extern "C" int dvo_track_level(
    int B, const float* px, const float* py, const float* pz, const float* i1,
    const uint8_t* selected, const float* rgix, const float* rgiy,
    const float* rgzx, const float* rgzy, int N, const float* slab,
    int64_t slab_stride, int H, int W, const float* K, const float* T_init,
    int use_depth, int ref_grad, float nu, float floor_ii, float floor_zz,
    int scale_iters, int warm_iters, int max_iterations, float precision,
    float lm_init, float lm_up, float lm_down, float lm_max, int C, float* out,
    int* out_i, void* stream) {
  if (max_iterations < 1) return (int)cudaErrorInvalidValue;
  Params p = params(px, py, pz, i1, selected, rgix, rgiy, rgzx, rgzy, N, slab,
                    slab_stride, H, W, K, T_init, use_depth, ref_grad, nu,
                    floor_ii, floor_zz, scale_iters, warm_iters);
  p.max_iterations = max_iterations;
  p.precision = precision;
  p.lm_init = lm_init;
  p.lm_up = lm_up;
  p.lm_down = lm_down;
  p.lm_max = lm_max;
  p.out = out;
  p.out_i = out_i;
  return launch(track_level_kernel, p, B, C, stream);
}
