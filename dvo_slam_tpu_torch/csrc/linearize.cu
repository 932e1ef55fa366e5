// Fused IRLS linearization for Hopper (sm_90a): a residual kernel (K1) and a
// weighted-reduction kernel (K2) issued by one C entry point.
//
// What it replaces. K1 holds the bilinear gather of the TPU kernel
// dvo_slam_tpu/ops/pallas/sampler.py::sample_slab (line 226, pl.pallas_call
// at line 413) on the main path: the sample is taken inside the residual
// pass and never leaves registers. K1 and K2 together stand in for what XLA
// fused on the TPU in dvo_slam_tpu/ops/linearize.py:281-539 (warp, sample,
// bivariate residual, t-distribution Sigma fixed point, weights, analytic
// Jacobian, weighted 6x6 normal equations). The plain PyTorch version is
// ops/linearize.py::linearize_reference; this file computes the same
// function for the t-distribution branch (both gradient sources, use_depth
// on and off, the Sigma warm start).
//
//   K1 residual_kernel, one thread per reference point: warp by T, project
//      with the sign-preserving 1/Z guard, bilinear 4-corner gather of the
//      n_smp channels it needs (6 for "current" gradients, 2 or 1 for
//      "reference"), rI, rZ and validity; writes rI, rZ, valid and the
//      Jacobian inputs (X, Y, Z and the four gradients) per point, and
//      reduces the integer valid count and the moments sum rI^2, rI rZ,
//      rZ^2. Its last block seeds Sigma (cold moments or the warm start,
//      decided on the device) and the step count.
//   K2 reduce_kernel, launched once per Sigma fixed-point step (it reads the
//      step count from the device state and returns at once past it) and
//      once in normal-equations mode: reads Sigma from the device state,
//      computes maha and the weight per point, and reduces either the three
//      weighted moments (-> the next Sigma) or the 21 unique entries of A,
//      the 6 of b, err_raw and log1p_sum, which its last block finalises
//      (n clamp, det, err_mean, A mirrored) into the output vector.
//
// K2's normal-equations launch reads the Jacobian inputs K1 stored (28 B per
// point). Recomputing them there from the L2-resident slab was measured
// too: no faster at any level, so it was not kept.
//
// The residual arithmetic (warp, projection, sample, rI, rZ) uses the _rn
// intrinsics in the plain version's order, so nvcc contracts nothing into
// FMAs and rI, rZ and the valid mask equal the plain version's bit for bit.
//
// Batch. Both kernels take a batch of B independent problems, one per
// blockIdx.y (the counterpart of the JAX package's vmap over the tracker:
// dual alignment is B = 2, a loop-closure validation batch B = 8..32). Row
// b reads its own reference points (b * N on), its own T and Sigma seed,
// and its current slab at slab + b * slab_stride (stride 0: one current
// frame shared by every row). Each row has its own State, partials and
// ticket, so the last block of a row finalises that row alone, and a row's
// arithmetic does not depend on B: row b of a batch gives the bits of a
// B = 1 call on its inputs.
//
// Cross-block reduction: every block writes its partial sums to scratch;
// the last block of its row to finish (atomic ticket after __threadfence,
// ticket reset for the next launch) sums them in a fixed order and
// finalises on the device. No float atomics: the same inputs give the same
// bits every run.
// Sums run in f64 from the per-point f32 products on: an f32 sum over
// 76 800 terms of mixed sign loses several of its 24 bits, an f64 one
// keeps the kernels' sums well below the f32 rounding of the result (so a
// comparison with the plain version measures the plain version's own
// rounding), at a cost the card does not notice (a few hundred f64 adds per
// block against the launch's latency).
//
// What bounds the kernels on this card: launch and drain latency, not
// bytes. At level 1 (N = 76 800) K1's residual pass needs ~3.8 MB (16 B of
// reference point, 1 B selected, the 1.8 MB slab once, 9 B of rI, rZ, valid
// out), ~1.1 us at 3.35 TB/s, plus the 28 B per point of Jacobian inputs it
// stores for K2; a Sigma step moves 9 B per point, ~0.2 us; the
// normal-equations launch 37 B per point, ~0.85 us; each launch costs a few
// us of fixed overhead, and the last block's serial cross-block pass adds
// to it. The design therefore
// minimises launches (1 + steps + 1 per linearization, all from one host
// call, no host sync, T and Sigma read on the device) rather than bytes:
// the slab stays in the 50 MB L2 between launches, reductions are warp
// shuffles plus one shared-memory pass per block, and the cross-block pass
// runs in the last block instead of another launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kEps = 1e-12f;        // ops/linearize.py _EPS
constexpr int kScaleSums = 3;         // weighted moments of one Sigma step
constexpr int kNormalSums = 21 + 6 + 2;  // A (upper), b, err_raw, log1p_sum
constexpr int kMaxSums = kNormalSums;
constexpr int kJacPlanes = 7;         // X, Y, Z, gix, giy, gzx, gzy
// Output vector layout (ops/linearize.py reads the same offsets).
constexpr int kOutA = 0, kOutB = 36, kOutErrMean = 42, kOutN = 43,
              kOutNRaw = 44, kOutSigma = 45, kOutLog1p = 49, kOutErrRaw = 50,
              kOutSize = 51;

enum Mode { kScaleStep = 0, kNormalEquations = 1 };

struct State {
  float a, bq, c;      // Sigma entries
  float n, n_raw;      // valid count floored at 1, and raw
  int n_fp;            // Sigma fixed-point steps this call takes
  unsigned int ticket;  // blocks finished in the current launch
};

struct Params {
  // Reference points (N,), ops/linearize.py::RefData.
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
  const float* slab;  // (6, H, W) current pyramid level of row 0
  int64_t slab_stride;  // floats from one row's slab to the next (0: shared)
  int H, W;
  const float* K;           // (4,) fx, fy, cx, cy, shared by every row
  const float* T;           // (B, 4, 4) row-major
  const float* sigma_init;  // (B, 2, 2) or null
  int use_depth, ref_grad, warm;
  float nu, floor_ii, floor_zz;
  int scale_iters, warm_iters;
  // Scratch (one allocation, carved by the entry point).
  State* state;  // (B,)
  double* part;  // (B, kMaxSums, blocks)
  int* part_n;   // (B, blocks)
  float* rI;     // (B, N)
  float* rZ;
  uint8_t* valid;
  float* jac;    // (B, kJacPlanes, N)
  float* out;    // (B, 51) Linearization vectors
};

// The parameters of this block's batch row: every per-row pointer moved to
// row blockIdx.y. The kernels below then see a single problem.
__device__ __forceinline__ Params row_params(const Params& p) {
  const int64_t b = blockIdx.y, N = p.N, blocks = gridDim.x;
  Params q = p;
  q.px = p.px + b * N;
  q.py = p.py + b * N;
  q.pz = p.pz + b * N;
  q.i1 = p.i1 + b * N;
  q.selected = p.selected + b * N;
  if (p.rgix) q.rgix = p.rgix + b * N;
  if (p.rgiy) q.rgiy = p.rgiy + b * N;
  if (p.rgzx) q.rgzx = p.rgzx + b * N;
  if (p.rgzy) q.rgzy = p.rgzy + b * N;
  q.slab = p.slab + b * p.slab_stride;
  q.T = p.T + 16 * b;
  if (p.sigma_init) q.sigma_init = p.sigma_init + 4 * b;
  q.state = p.state + b;
  q.part = p.part + b * kMaxSums * blocks;
  q.part_n = p.part_n + b * blocks;
  q.rI = p.rI + b * N;
  q.rZ = p.rZ + b * N;
  q.valid = p.valid + b * N;
  q.jac = p.jac + b * kJacPlanes * N;
  q.out = p.out + b * kOutSize;
  return q;
}

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
  float X, Y, Z, zi, gix, giy, gzx, gzy, rI, rZ;
  bool valid;
};

// Warp, project, sample and residual of reference point i, in the order of
// ops/linearize.py::residuals_reference (and ops/sampler.py's plain sample).
__device__ __forceinline__ Point residual(const Params& p, int i) {
  const float* T = p.T;
  const float px = __ldg(p.px + i), py = __ldg(p.py + i), pz = __ldg(p.pz + i);
  Point q;
  q.X = add(add(add(mul(__ldg(T + 0), px), mul(__ldg(T + 1), py)),
                mul(__ldg(T + 2), pz)), __ldg(T + 3));
  q.Y = add(add(add(mul(__ldg(T + 4), px), mul(__ldg(T + 5), py)),
                mul(__ldg(T + 6), pz)), __ldg(T + 7));
  q.Z = add(add(add(mul(__ldg(T + 8), px), mul(__ldg(T + 9), py)),
                mul(__ldg(T + 10), pz)), __ldg(T + 11));
  q.zi = guarded_inv(q.Z);
  const float u = add(mul(mul(__ldg(p.K + 0), q.X), q.zi), __ldg(p.K + 2));
  const float v = add(mul(mul(__ldg(p.K + 1), q.Y), q.zi), __ldg(p.K + 3));

  // Bilinear sample, as csrc/sampler.cu: clamp in float before the cast.
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
  const float* c0 = p.slab + (int64_t)y0f * W + (int64_t)x0f;
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
    q.gix = __ldg(p.rgix + i);
    q.giy = __ldg(p.rgiy + i);
    q.gzx = p.use_depth ? __ldg(p.rgzx + i) : 0.f;
    q.gzy = p.use_depth ? __ldg(p.rgzy + i) : 0.f;
  } else {
    q.gix = s[2];
    q.giy = s[3];
    q.gzx = s[4];
    q.gzy = s[5];
  }
  const float rI = sub(i2, __ldg(p.i1 + i));
  const float rZ = sub(z2, q.Z);
  bool valid = p.selected[i] && inb && (q.Z > 1e-6f) && isfinite(rI);
  if (p.use_depth) valid = valid && isfinite(rZ) && isfinite(q.gzx) && isfinite(q.gzy);
  q.valid = valid;
  q.rI = valid ? rI : 0.f;
  q.rZ = (valid && p.use_depth) ? rZ : 0.f;
  return q;
}

// Block-wide sum of M per-thread values in a fixed order: warp shuffles,
// then one thread per quantity over the warps. tot[m] (shared) holds the
// block's sums on return, to every thread. smem: M * kWarps values.
template <typename T, int M>
__device__ __forceinline__ void block_sum(T (&v)[M], T* smem, T* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    T x = v[m];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) smem[m * kWarps + warp] = x;
  }
  __syncthreads();
  if (threadIdx.x < M) {
    T s = smem[threadIdx.x * kWarps];
    for (int w = 1; w < kWarps; ++w) s += smem[threadIdx.x * kWarps + w];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// In the last block of a row: the row's sums of M quantities from the (M, blocks)
// partials, in a fixed order (thread t takes blocks t, t + 256, ...; then
// block_sum). Partials are read through L2 (__ldcg): other SMs wrote them.
template <typename T, int M>
__device__ __forceinline__ void grid_sum(const T* part, T* smem, T* tot) {
  const int nb = gridDim.x;
  T v[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    v[m] = T(0);
    for (int b = threadIdx.x; b < nb; b += kThreads) v[m] += __ldcg(part + m * nb + b);
  }
  block_sum<T, M>(v, smem, tot);
}

template <typename T, int M>
__device__ __forceinline__ void store_partials(const T* tot, T* part) {
  if (threadIdx.x < M) part[threadIdx.x * gridDim.x + blockIdx.x] = tot[threadIdx.x];
}

// True in the last block of this batch row to finish (the row's gridDim.x
// blocks share its ticket). Every block's partials are visible device-wide
// before it takes its ticket.
__device__ __forceinline__ bool last_block(unsigned int* ticket) {
  __shared__ bool is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  return is_last;
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

__global__ void __launch_bounds__(kThreads) residual_kernel(Params batch) {
  const Params p = row_params(batch);
  __shared__ double smem[kScaleSums * kWarps];
  __shared__ double tot[kScaleSums];
  __shared__ int smem_n[kWarps];
  __shared__ int tot_n[1];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  double m[kScaleSums] = {0.0, 0.0, 0.0};
  int cnt[1] = {0};
  if (i < p.N) {
    const Point q = residual(p, i);
    p.rI[i] = q.rI;
    p.rZ[i] = q.rZ;
    p.valid[i] = q.valid;
    const int64_t N = p.N;
    p.jac[i] = q.X;
    p.jac[N + i] = q.Y;
    p.jac[2 * N + i] = q.Z;
    p.jac[3 * N + i] = q.gix;
    p.jac[4 * N + i] = q.giy;
    p.jac[5 * N + i] = q.gzx;
    p.jac[6 * N + i] = q.gzy;
    if (q.valid) {
      cnt[0] = 1;
      m[0] = (double)mul(q.rI, q.rI);
      m[1] = (double)mul(q.rI, q.rZ);
      m[2] = (double)mul(q.rZ, q.rZ);
    }
  }
  block_sum<double, kScaleSums>(m, smem, tot);
  block_sum<int, 1>(cnt, smem_n, tot_n);
  store_partials<double, kScaleSums>(tot, p.part);
  store_partials<int, 1>(tot_n, p.part_n);
  if (!last_block(&p.state->ticket)) return;
  grid_sum<double, kScaleSums>(p.part, smem, tot);
  grid_sum<int, 1>(p.part_n, smem_n, tot_n);
  if (threadIdx.x == 0) {
    State* st = p.state;
    const float n_raw = (float)tot_n[0];
    const float n = fmaxf(n_raw, 1.f);
    float a = add(__fdiv_rn((float)tot[0], n), p.floor_ii);
    float bq = __fdiv_rn((float)tot[1], n);
    float c = add(__fdiv_rn((float)tot[2], n), p.floor_zz);
    int n_fp = p.scale_iters;
    if (p.warm) {
      // Warm start from the previous iteration's Sigma when it is finite
      // (dvo_slam_tpu/ops/linearize.py:422-431 decides it with jnp.where).
      const float s00 = p.sigma_init[0], s01 = p.sigma_init[1];
      const float s10 = p.sigma_init[2], s11 = p.sigma_init[3];
      if (isfinite(s00) && isfinite(s01) && isfinite(s10) && isfinite(s11)) {
        a = fmaxf(s00, p.floor_ii);
        bq = s01;
        c = fmaxf(s11, p.floor_zz);
        n_fp = p.warm_iters;
      }
    }
    st->a = a;
    st->bq = bq;
    st->c = c;
    st->n = n;
    st->n_raw = n_raw;
    st->n_fp = n_fp;
    st->ticket = 0u;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) reduce_kernel(Params batch, int step) {
  const Params p = row_params(batch);
  constexpr int M = kMode == kScaleStep ? kScaleSums : kNormalSums;
  __shared__ double smem[M * kWarps];
  __shared__ double tot[M];
  const State* st = p.state;
  if constexpr (kMode == kScaleStep) {
    if (step >= st->n_fp) return;  // uniform: every block returns
  }
  const float a = st->a, bq = st->bq, c = st->c, n = st->n;
  const Precision P = precision(a, bq, c);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  double acc[M];
#pragma unroll
  for (int k = 0; k < M; ++k) acc[k] = 0.0;

  if (i < p.N) {
    Point q;
    q.valid = p.valid[i];
    q.rI = p.rI[i];
    q.rZ = p.rZ[i];
    if (q.valid) {
      float maha, w;
      tdist_weight(P, p.nu, q.rI, q.rZ, &maha, &w);
      if constexpr (kMode == kScaleStep) {
        acc[0] = (double)mul(w, mul(q.rI, q.rI));
        acc[1] = (double)mul(w, mul(q.rI, q.rZ));
        acc[2] = (double)mul(w, mul(q.rZ, q.rZ));
      } else {
        const int64_t N = p.N;
        q.X = p.jac[i];
        q.Y = p.jac[N + i];
        q.Z = p.jac[2 * N + i];
        q.gix = p.jac[3 * N + i];
        q.giy = p.jac[4 * N + i];
        q.gzx = p.jac[5 * N + i];
        q.gzy = p.jac[6 * N + i];
        q.zi = guarded_inv(q.Z);
        // Weights and Jacobian: ops/linearize.py::normal_equations_reference.
        const float p01 = p.use_depth ? P.p01 : 0.f;
        const float p11 = p.use_depth ? P.p11 : 0.f;
        const float fx = __ldg(p.K + 0), fy = __ldg(p.K + 1);
        const float X = q.X, Y = q.Y, Z = q.Z, zi = q.zi;
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
        for (int j = 0; j < 6; ++j) {
#pragma unroll
          for (int k = j; k < 6; ++k) acc[e++] = (double)(JI[j] * GI[k] + JZ[j] * GZ[k]);
        }
#pragma unroll
        for (int k = 0; k < 6; ++k) acc[21 + k] = (double)(GI[k] * q.rI + GZ[k] * q.rZ);
        acc[27] = (double)(w * maha);
        acc[28] = (double)log1pf(maha * (1.f / p.nu));
      }
    }
  }
  block_sum<double, M>(acc, smem, tot);
  store_partials<double, M>(tot, p.part);
  if (!last_block(&p.state->ticket)) return;
  grid_sum<double, M>(p.part, smem, tot);
  if (threadIdx.x != 0) return;
  State* ws = p.state;
  ws->ticket = 0u;
  if constexpr (kMode == kScaleStep) {
    ws->a = add(__fdiv_rn((float)tot[0], n), p.floor_ii);
    ws->bq = __fdiv_rn((float)tot[1], n);
    ws->c = add(__fdiv_rn((float)tot[2], n), p.floor_zz);
    return;
  }
  float* o = p.out;
  int e = 0;
  for (int j = 0; j < 6; ++j) {
    for (int k = j; k < 6; ++k, ++e) {
      o[kOutA + 6 * j + k] = (float)tot[e];
      o[kOutA + 6 * k + j] = (float)tot[e];
    }
  }
  for (int k = 0; k < 6; ++k) o[kOutB + k] = (float)tot[21 + k];
  const float log1p_sum = (float)tot[28];
  o[kOutErrMean] = add(0.5f * logf(P.det), __fdiv_rn((p.nu + 2.f) * 0.5f * log1p_sum, n));
  o[kOutN] = n;
  o[kOutNRaw] = ws->n_raw;
  o[kOutSigma + 0] = a;
  o[kOutSigma + 1] = bq;
  o[kOutSigma + 2] = bq;
  o[kOutSigma + 3] = c;
  o[kOutLog1p] = log1p_sum;
  o[kOutErrRaw] = (float)tot[27];
}

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

struct Layout {
  size_t state, part, part_n, rI, rZ, valid, jac, total;
};

Layout layout(int B, int N) {
  const size_t blocks = (N + kThreads - 1) / kThreads;
  const size_t BN = (size_t)B * N;
  Layout l;
  size_t off = 0;
  l.state = off;  off = align256(off + sizeof(State) * B);
  l.part = off;   off = align256(off + sizeof(double) * kMaxSums * blocks * B);
  l.part_n = off; off = align256(off + sizeof(int) * blocks * B);
  l.rI = off;     off = align256(off + sizeof(float) * BN);
  l.rZ = off;     off = align256(off + sizeof(float) * BN);
  l.valid = off;  off = align256(off + BN);
  l.jac = off;    off = align256(off + sizeof(float) * kJacPlanes * BN);
  l.total = off;
  return l;
}

}  // namespace

// Scratch layout for B rows of N points: off[0..2] = byte offsets of rI
// (f32), rZ (f32) and valid (u8), each (B, N), after the call that wrote
// them; off[3] = total bytes. The caller allocates the scratch zero-filled
// once per (stream, B, N) and passes it to every call on that stream with
// that B and N: the last block of each row leaves its ticket at 0.
extern "C" void dvo_linearize_layout(int B, int N, size_t* off) {
  const Layout l = layout(B, N);
  off[0] = l.rI;
  off[1] = l.rZ;
  off[2] = l.valid;
  off[3] = l.total;
}

// B linearizations, one per batch row: K1, then `steps` K2 Sigma steps
// (each row skips itself past its own step count), then K2 in
// normal-equations mode, each launch over a (blocks, B) grid, all on
// `stream`, with no host sync. The reference points (px..rgzy) are (B, N);
// row b's slab starts at slab + b * slab_stride floats; T is (B, 4, 4),
// sigma_init (B, 2, 2). Reference gradients (rgix..rgzy) are read only
// with ref_grad (rgzx, rgzy only with use_depth too); sigma_init only with
// warm. out: (B, 51) floats, each row laid out as the kOut* offsets.
// Returns cudaGetLastError() after the launches (0 = all launched).
extern "C" int dvo_linearize(
    int B, const float* px, const float* py, const float* pz,
    const float* i1, const uint8_t* selected, const float* rgix,
    const float* rgiy, const float* rgzx, const float* rgzy, int N,
    const float* slab, int64_t slab_stride, int H, int W, const float* K,
    const float* T, const float* sigma_init,
    int use_depth, int ref_grad, int warm, float nu, float floor_ii,
    float floor_zz, int scale_iters, int warm_iters, int steps,
    void* scratch, float* out, void* stream) {
  const Layout l = layout(B, N);
  char* base = (char*)scratch;
  Params p;
  p.px = px; p.py = py; p.pz = pz; p.i1 = i1; p.selected = selected;
  p.rgix = rgix; p.rgiy = rgiy; p.rgzx = rgzx; p.rgzy = rgzy;
  p.N = N; p.slab = slab; p.slab_stride = slab_stride; p.H = H; p.W = W;
  p.K = K; p.T = T; p.sigma_init = sigma_init;
  p.use_depth = use_depth; p.ref_grad = ref_grad; p.warm = warm;
  p.nu = nu; p.floor_ii = floor_ii; p.floor_zz = floor_zz;
  p.scale_iters = scale_iters; p.warm_iters = warm_iters;
  p.state = (State*)(base + l.state);
  p.part = (double*)(base + l.part);
  p.part_n = (int*)(base + l.part_n);
  p.rI = (float*)(base + l.rI);
  p.rZ = (float*)(base + l.rZ);
  p.valid = (uint8_t*)(base + l.valid);
  p.jac = (float*)(base + l.jac);
  p.out = out;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((N + kThreads - 1) / kThreads, B);
  residual_kernel<<<grid, kThreads, 0, s>>>(p);
  for (int k = 0; k < steps; ++k) reduce_kernel<kScaleStep><<<grid, kThreads, 0, s>>>(p, k);
  reduce_kernel<kNormalEquations><<<grid, kThreads, 0, s>>>(p, 0);
  return (int)cudaGetLastError();
}
