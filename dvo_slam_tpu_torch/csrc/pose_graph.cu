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
// Layout. One cluster of C CTAs of 512 threads per solve, M <= 128 vertices
// (n = 6M <= 768): C is the fewest CTAs (a power of two) whose column slabs
// fit, 1 up to M = 32, 4 at 64, 16 at 128 (a non-portable cluster size).
// CTA r holds columns [r w, (r + 1) w) of the damped system, w = ceil(n / C)
// <= 192, as n rows of w + 1 floats (at C = 1 the odd row stride keeps a
// column's reads free of bank conflicts), beside the right-hand side, two
// copies of the poses and, in a cluster, the pivot column and y: 153 088
// bytes at M = 32, 161 792 at 64, 176 128 at 128 (dvo_pose_graph_plan;
// models/pose_graph.py::kernel_plan mirrors it). Every CTA keeps the poses
// and takes every decision; the edges are split over the CTAs, and their
// sums meet through distributed shared memory, read in rank order.
// Per-edge blocks (P = Jj^T W Jj, whence Hii = Hjj = P, Hij = -P, and gj =
// -gi) go to a global scratch of E x 42 floats that stays in L2.
//
// Determinism. No float atomics: every sum into a slot of g or a block of H
// runs over that slot's contributions in increasing index order, from the
// host-built CSR plans (the order of models/pose_graph.py::_plan), and
// every reduction over edges is a fixed per-thread order, a fixed
// xor-shuffle tree and a fixed warp order. Two launches on the same inputs
// give the same bits.
//
// Per step: one thread per edge builds its residual, weight, P and gj; one
// thread per element of a CTA's lower-triangle columns sums H from the plan
// and adds the damping; a right-looking column Cholesky with one barrier per
// column (at C = 1 column k - 1 is scaled while column k updates the
// trailing triangle; in a cluster every CTA first copies column k from its
// owner and the barrier is the cluster's); the triangular solves in one warp
// (C = 1) or CTA by CTA over their columns; one thread per vertex applies
// exp(delta); one thread per edge takes the new chi2. Every CTA reads the
// same sums, so the decisions (accept, lambda, stop) are every CTA's.
//
// What bounds it on this card: not bytes or flops (a solve at M = 32 reads
// ~25 KB of graph and plans, and a step does ~2.6 MFLOP: < 0.1 us at 67
// TFLOP/s) but the n serial
// pivots of the factorization and the 2n serial steps of the solves, each a
// barrier (a cluster barrier past M = 32) or a warp step apart, and one
// cluster on 1 to 16 of the 132 SMs. The design removes the host from the
// loop: one launch per solve instead of ~200 eager ops and a host sync per
// LM step.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVertices = 128;
constexpr int kMaxCluster = 16;                  // non-portable past 8
constexpr int kMaxColumns = 192;                 // columns a CTA holds
constexpr int kColumnSlots = kMaxColumns / 32;   // a lane's columns per pivot
constexpr size_t kSmemBudget = 230400;           // dynamic bytes a CTA may ask
constexpr int kErrNoActiveCluster = 100001;      // as csrc/linearize.cu's
constexpr int kEdgeFloats = 42;                  // P (36), gj (6)
constexpr float kGaugeWeight = 1e6f;             // models/pose_graph.py _GAUGE_WEIGHT
constexpr float kJitter = 1e-6f;                 // models/pose_graph.py _JITTER

struct Params {
  const float* poses;   // (M, 4, 4)
  const float* Z;       // (E, 4, 4) measurements
  const float* info;    // (E, 6, 6)
  const float* mask;    // (E,) 1 or 0
  const int* edge_i;    // (E,)
  const int* edge_j;    // (E,)
  const int* v_off;     // (M + 1,) vertex plan: 2E contributions
  const int* v_idx;     // (2E,) [gi of edge e | gj of edge e]
  const int* d_off;     // (M M + 1,) dense plan: 4E + M blocks
  const int* d_idx;     // (4E + M,) [Hii | Hjj | Hij | Hij^T | extra]
  int M, E, nv, iterations, use_robust, gnc_adaptive, C;
  float cauchy_c, gnc_init;
  double cauchy_c64, gnc_decay;
  float* scratch;       // (E, kEdgeFloats)
  float* poses_out;     // (M, 4, 4)
  float* chi2_out;      // ()
  float* weights_out;   // (E,)
  float* stats_out;     // (iterations, 4) per step: chi2, chi2_new, |delta|, accept
  int* steps_out;       // ()
};

// Dynamic shared memory per CTA: its w = ceil(n / C) columns as n rows of
// w + 1 floats, the right-hand side, two pose copies and, in a cluster, the
// pivot column and y.
size_t shared_bytes(int M, int C) {
  const size_t n = 6 * (size_t)M, w = (n + C - 1) / C;
  return 4 * (n * (w + 1) + n + 32 * (size_t)M + (C > 1 ? 2 * n : 0));
}

// CTAs per solve: the smallest power of two whose column slabs fit (at most
// kMaxColumns columns and kSmemBudget bytes a CTA); 0 past the limit.
int cluster_for(int M) {
  if (M < 1 || M > kMaxVertices) return 0;
  for (int C = 1; C <= kMaxCluster; C *= 2)
    if ((6 * M + C - 1) / C <= kMaxColumns && shared_bytes(M, C) <= kSmemBudget) return C;
  return 0;
}

// ------------------------------------------------------------ f32 SE(3)
// ops/se3.py's functions on one 4x4 row-major matrix, branches copied.

__device__ void mm4(const float* a, const float* b, float* c) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) s += a[4 * r + k] * b[4 * k + q];
      c[4 * r + q] = s;
    }
}

// se3.inverse: [R^T, -(R^T t); 0 0 0 1].
__device__ void inverse4(const float* T, float* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) out[4 * r + q] = T[4 * q + r];
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) s += T[4 * k + r] * T[4 * k + 3];
    out[4 * r + 3] = -s;
  }
  out[12] = 0.f; out[13] = 0.f; out[14] = 0.f; out[15] = 1.f;
}

// se3.log: (4, 4) -> twist (v, w).
__device__ void log_se3(const float* T, float* xi) {
  const float trace = T[0] + T[5] + T[10];
  const float u = fminf(fmaxf((3.f - trace) * 0.5f, 0.f), 2.f);
  const bool small_u = u < 1e-6f;
  const float u_safe = small_u ? 1.f : u;
  const float theta_r = acosf(1.f - u_safe);
  const float sin_r = sqrtf(u_safe * (2.f - u_safe));
  const float tss = 2.f * u + u * u / 3.f;
  const float factor = small_u
      ? 0.5f + tss / 12.f + 7.f * tss * tss / 720.f
      : theta_r / (2.f * sin_r);
  const float w0 = factor * (T[9] - T[6]);   // vee(R - R^T)
  const float w1 = factor * (T[2] - T[8]);
  const float w2 = factor * (T[4] - T[1]);
  const float theta_sq = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = theta_sq < 1e-8f;
  const float theta = sqrtf(theta_sq < 1e-12f ? 1.f : theta_sq);
  const float coef = small
      ? 1.f / 12.f + theta_sq / 720.f
      : 1.f / theta_sq - (1.f + cosf(theta)) / (2.f * theta * sinf(theta));
  // W = hat(w), W2 = W W; V^{-1} = I - W / 2 + coef W2.
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float Vi[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float w2rq = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) w2rq += W[3 * r + k] * W[3 * k + q];
      Vi[3 * r + q] = (r == q ? 1.f : 0.f) - 0.5f * W[3 * r + q] + coef * w2rq;
    }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    xi[r] = Vi[3 * r] * T[3] + Vi[3 * r + 1] * T[7] + Vi[3 * r + 2] * T[11];
  xi[3] = w0; xi[4] = w1; xi[5] = w2;
}

// se3.exp: twist (v, w) -> (4, 4).
__device__ void exp_se3(const float* xi, float* T) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float theta_sq = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = theta_sq < 1e-8f;
  const float safe_sq = small ? 1.f : theta_sq;
  const float safe_t = sqrtf(safe_sq);
  const float sin_t = sinf(safe_t);
  const float a = small ? 1.f - theta_sq / 6.f : sin_t / safe_t;
  const float b = small ? 0.5f - theta_sq / 24.f : (1.f - cosf(safe_t)) / safe_sq;
  const float c = small ? 1.f / 6.f - theta_sq / 120.f
                        : (safe_t - sin_t) / (safe_sq * safe_t);
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float V[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float w2rq = 0.f;
#pragma unroll
      for (int k = 0; k < 3; ++k) w2rq += W[3 * r + k] * W[3 * k + q];
      const float eye = r == q ? 1.f : 0.f;
      T[4 * r + q] = eye + a * W[3 * r + q] + b * w2rq;
      V[3 * r + q] = eye + b * W[3 * r + q] + c * w2rq;
    }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    T[4 * r + 3] = V[3 * r] * xi[0] + V[3 * r + 1] * xi[1] + V[3 * r + 2] * xi[2];
  T[12] = 0.f; T[13] = 0.f; T[14] = 0.f; T[15] = 1.f;
}

// pose_graph.edge_residual: e = log(Z^{-1} T_i^{-1} T_j).
__device__ void edge_residual(const float* Ti, const float* Tj, const float* Z, float* e) {
  float Zi[16], Tii[16], A[16], B[16];
  inverse4(Z, Zi);
  inverse4(Ti, Tii);
  mm4(Zi, Tii, A);
  mm4(A, Tj, B);
  log_se3(B, e);
}

// An edge's residual (into e) and its chi2 e^T info e. Not inlined: every
// pass that takes an edge's chi2 (the step's system, the trial poses, the
// final weights) runs the same instructions, so a zero step gives the same
// chi2 bits in the accept test, as in the plain version.
__device__ __noinline__ float edge_chi2(const float* Ti, const float* Tj, const float* Z,
                                        const float* info, float* e) {
  edge_residual(Ti, Tj, Z, e);
  float s = 0.f;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float t = 0.f;
#pragma unroll
    for (int b = 0; b < 6; ++b) t += info[6 * a + b] * e[b];
    s += e[a] * t;
  }
  return s;
}

// ------------------------------------------------- f64 edge Jacobian
// pose_graph._edge_residual_and_jacobians: J_j = Jl^{-1}(e) Ad(Z^{-1}
// T_i^{-1}) in f64 (_jl_inv's closed form and Taylor branches).

__device__ void mm3d(const double* a, const double* b, double* c) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q)
      c[3 * r + q] = a[3 * r] * b[q] + a[3 * r + 1] * b[3 + q] + a[3 * r + 2] * b[6 + q];
}

__device__ void hat3d(const double* w, double* W) {
  W[0] = 0.0; W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2]; W[4] = 0.0; W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0]; W[8] = 0.0;
}

__device__ void inverse4d(const double* T, double* out) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) out[4 * r + q] = T[4 * q + r];
    out[4 * r + 3] = -(T[r] * T[3] + T[4 + r] * T[7] + T[8 + r] * T[11]);
  }
  out[12] = 0.0; out[13] = 0.0; out[14] = 0.0; out[15] = 1.0;
}

// Jj (6, 6) row-major, f32, from e (f32) and T_i, Z.
__device__ void edge_jacobian(const float* e, const float* Ti, const float* Z, float* Jf) {
  const double rho[3] = {(double)e[0], (double)e[1], (double)e[2]};
  const double phi[3] = {(double)e[3], (double)e[4], (double)e[5]};
  const double t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = t2 < 1e-4;
  const double t2s = small ? 1.0 : t2;
  const double t = sqrt(t2s);
  const double s = sin(t), c = cos(t);
  const double k = small ? 1.0 / 12 + t2 / 720 : 1.0 / t2s - (1.0 + c) / (2.0 * t * s);
  const double a = small ? 1.0 / 6 - t2 / 120 : (t - s) / (t2s * t);
  const double b = small ? 1.0 / 24 - t2 / 720 : (t2s + 2.0 * c - 2.0) / (2.0 * t2s * t2s);
  const double d = small ? 1.0 / 120 - t2 / 2520
                         : (2.0 * t - 3.0 * s + t * c) / (2.0 * t2s * t2s * t);
  double Phi[9], P[9], PhiP[9], PPhi[9], PhiPPhi[9], Phi2[9], X[9], Y[9];
  hat3d(phi, Phi);
  hat3d(rho, P);
  mm3d(Phi, P, PhiP);
  mm3d(P, Phi, PPhi);
  mm3d(PhiP, Phi, PhiPPhi);
  mm3d(Phi, Phi, Phi2);
  double Q[9], J3i[9];
  mm3d(Phi, PhiP, X);     // Phi @ PhiP
  mm3d(PPhi, Phi, Y);     // PPhi @ Phi
#pragma unroll
  for (int q = 0; q < 9; ++q)
    Q[q] = 0.5 * P[q] + a * (PhiP[q] + PPhi[q] + PhiPPhi[q])
           + b * (X[q] + Y[q] - 3.0 * PhiPPhi[q]);
  mm3d(PhiPPhi, Phi, X);  // PhiPPhi @ Phi
  mm3d(Phi, PhiPPhi, Y);  // Phi @ PhiPPhi
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    Q[q] += d * (X[q] + Y[q]);
    J3i[q] = (q % 4 == 0 ? 1.0 : 0.0) - 0.5 * Phi[q] + k * Phi2[q];
  }
  // Jl^{-1} = [J3i, -J3i Q J3i; 0, J3i].
  double JQ[9], JQJ[9];
  mm3d(J3i, Q, JQ);
  mm3d(JQ, J3i, JQJ);
  // A = Z^{-1} T_i^{-1}; Ad(A) = [R, hat(t) R; 0, R].
  double Zd[16], Td[16], Zi[16], Ti_inv[16], A[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) { Zd[q] = Z[q]; Td[q] = Ti[q]; }
  inverse4d(Zd, Zi);
  inverse4d(Td, Ti_inv);
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      A[4 * r + q] = Zi[4 * r] * Ti_inv[q] + Zi[4 * r + 1] * Ti_inv[4 + q]
                     + Zi[4 * r + 2] * Ti_inv[8 + q] + Zi[4 * r + 3] * Ti_inv[12 + q];
  double R[9], tv[3], tx[9], tR[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int q = 0; q < 3; ++q) R[3 * r + q] = A[4 * r + q];
    tv[r] = A[4 * r + 3];
  }
  hat3d(tv, tx);
  mm3d(tx, R, tR);
  // Jj = Jl^{-1} Ad = [J3i R, J3i tR - JQJ R; 0, J3i R].
  double JR[9], JtR[9], JQJR[9];
  mm3d(J3i, R, JR);
  mm3d(J3i, tR, JtR);
  mm3d(JQJ, R, JQJR);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      Jf[6 * r + q] = (float)JR[3 * r + q];
      Jf[6 * r + 3 + q] = (float)(JtR[3 * r + q] - JQJR[3 * r + q]);
      Jf[6 * (r + 3) + q] = 0.f;
      Jf[6 * (r + 3) + 3 + q] = (float)JR[3 * r + q];
    }
}

// ------------------------------------------------------------ reductions

__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// torch.max's semantics: a NaN anywhere gives NaN.
__device__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) s = nan_max(s, red[w]);
  __syncthreads();
  return s;
}

// ------------------------------------------------------------ the kernel

// The Cauchy IRLS weight 1 / (1 + chi2 / c^2), or 1 without the kernel.
__device__ float robust_weight(const Params& p, float chi2, float c2) {
  return p.use_robust ? 1.f / (1.f + chi2 / c2) : 1.f;
}

// One edge of _build_blocks at poses `pose`: writes P and gj to the
// scratch, returns w * chi2 (w the robust weight at c2 times the mask).
__device__ float build_edge(const Params& p, const float* pose, int e, float c2) {
  const float* Z = p.Z + 16 * e;
  const float* info = p.info + 36 * e;
  const float* Ti = pose + 16 * p.edge_i[e];
  const float* Tj = pose + 16 * p.edge_j[e];
  float r[6];
  const float chi2 = edge_chi2(Ti, Tj, Z, info, r);
  const float w = robust_weight(p, chi2, c2) * p.mask[e];
  float J[36];
  edge_jacobian(r, Ti, Z, J);
  float* out = p.scratch + (size_t)kEdgeFloats * e;
  // X = (w info) J; P = J^T X; gj = J^T ((w info) e).
  float X[36], we[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = 0.f;
#pragma unroll
    for (int b = 0; b < 6; ++b) s += (w * info[6 * a + b]) * r[b];
    we[a] = s;
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      float x = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) x += (w * info[6 * a + k]) * J[6 * k + q];
      X[6 * a + q] = x;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) s += J[6 * k + a] * X[6 * k + q];
      out[6 * a + q] = s;
    }
    float g = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) g += J[6 * k + a] * we[k];
    out[36 + a] = g;
  }
  return w * chi2;
}

// Element (r, c) of dense-plan contribution `ci`.
__device__ float contribution(const Params& p, int ci, int r, int c) {
  const int E = p.E;
  if (ci < 4 * E) {
    const int kind = ci / E, e = ci - kind * E;
    const float* P = p.scratch + (size_t)kEdgeFloats * e;
    if (kind < 2) return P[6 * r + c];     // Hii, Hjj
    if (kind == 2) return -P[6 * r + c];   // Hij
    return -P[6 * c + r];                  // Hij^T
  }
  if (r != c) return 0.f;
  const int v = ci - 4 * E;  // gauge prior on vertex 0, identity if inactive
  const float extra = v >= p.nv ? 1.f : 0.f;
  return v == 0 ? extra + kGaugeWeight : extra;
}

// Cluster-wide reductions: each CTA reduces its share, thread 0 puts it in
// `slot` (one slot per reduction of a step, so no slot is rewritten while
// another CTA may still read it), and after one cluster barrier every thread
// reads the C slots in rank order: every CTA holds the same bits.
__device__ double cluster_sum(double v, double* red, double* slot, int C) {
  v = block_sum(v, red);
  if (C == 1) return v;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  double s = 0.0;
  for (int r = 0; r < C; ++r) s += *cluster.map_shared_rank(slot, r);
  return s;
}

__device__ float cluster_max(float v, float* red, float* slot, int C) {
  v = block_max(v, red);
  if (C == 1) return v;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  float s = *cluster.map_shared_rank(slot, 0);
  for (int r = 1; r < C; ++r) s = nan_max(*cluster.map_shared_rank(slot, r), s);
  return s;
}

// The right-looking column Cholesky of one CTA's n x n system (row stride
// ld), one barrier per column: pass kk updates the trailing triangle by
// column kk (scaled on the fly) and writes the final values of column
// kk - 1, which no thread reads in that pass. False: a pivot <= 0 or NaN.
__device__ bool factor_cta(float* A, int n, int ld) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float d_prev = 1.f, inv_prev = 1.f;
  for (int kk = 0; kk < n; ++kk) {
    const float d = A[kk * ld + kk];
    if (kk > 0)
      for (int i = kk - 1 + threadIdx.x; i < n; i += kThreads)
        A[i * ld + kk - 1] = i == kk - 1 ? sqrtf(d_prev) : A[i * ld + kk - 1] * inv_prev;
    if (!(d > 0.f)) return false;  // every thread reads the same pivot
    const float inv = 1.f / sqrtf(d);
    float lj[kColumnSlots];
#pragma unroll
    for (int t = 0; t < kColumnSlots; ++t) {
      const int j = kk + 1 + lane + 32 * t;
      lj[t] = j < n ? A[j * ld + kk] * inv : 0.f;
    }
    for (int i = kk + 1 + warp; i < n; i += kWarps) {
      const float li = A[i * ld + kk] * inv;
      float* row = A + i * ld;
#pragma unroll
      for (int t = 0; t < kColumnSlots; ++t) {
        const int j = kk + 1 + lane + 32 * t;
        if (j <= i) row[j] -= li * lj[t];
      }
    }
    d_prev = d;
    inv_prev = inv;
    __syncthreads();
  }
  if (threadIdx.x == 0) A[(n - 1) * ld + n - 1] = sqrtf(d_prev);
  return true;
}

// The same factorization over a cluster: CTA `rank` holds columns [c0, c1)
// (row stride ld). Pass kk copies column kk from its owner's shared memory
// into `col`, updates this CTA's columns right of kk, and ends at a cluster
// barrier; the owner of column kk - 1 writes its final values in pass kk.
__device__ bool factor_cluster(float* A, float* col, int n, int ld, int w, int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = rank * w, c1 = min(n, c0 + w);
  float d_prev = 1.f, inv_prev = 1.f;
  bool ok = true;
  for (int kk = 0; kk < n; ++kk) {
    if (kk > 0 && (kk - 1) / w == rank)
      for (int i = kk - 1 + threadIdx.x; i < n; i += kThreads) {
        float* a = A + i * ld + kk - 1 - c0;
        *a = i == kk - 1 ? sqrtf(d_prev) : *a * inv_prev;
      }
    const int owner = kk / w;
    const float* src = cluster.map_shared_rank(A, owner) + kk - owner * w;
    for (int i = kk + threadIdx.x; i < n; i += kThreads) col[i] = src[i * ld];
    __syncthreads();
    const float d = col[kk];
    if (!(d > 0.f)) {  // every CTA reads the same pivot
      ok = false;
      break;
    }
    const float inv = 1.f / sqrtf(d);
    if (kk + 1 < c1) {
      float lj[kColumnSlots];
#pragma unroll
      for (int t = 0; t < kColumnSlots; ++t) {
        const int j = c0 + lane + 32 * t;
        lj[t] = (j > kk && j < c1) ? col[j] * inv : 0.f;
      }
      for (int i = max(kk + 1, c0) + warp; i < n; i += kWarps) {
        const float li = col[i] * inv;
        float* row = A + i * ld - c0;
#pragma unroll
        for (int t = 0; t < kColumnSlots; ++t) {
          const int j = c0 + lane + 32 * t;
          if (j > kk && j <= i && j < c1) row[j] -= li * lj[t];
        }
      }
    }
    d_prev = d;
    inv_prev = inv;
    cluster.sync();
  }
  if (ok && (n - 1) / w == rank && threadIdx.x == 0)
    A[(n - 1) * ld + n - 1 - c0] = sqrtf(d_prev);
  cluster.sync();
  return ok;
}

// L y = b, then L^T x = y, one CTA: warp 0 runs both, column by column;
// rhs holds b and ends holding x.
__device__ void solve_cta(const float* A, float* rhs, int n, int ld) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  for (int kk = 0; kk < n; ++kk) {
    const float y = rhs[kk] / A[kk * ld + kk];
    __syncwarp();
    if (lane == 0) rhs[kk] = y;
    for (int i = kk + 1 + lane; i < n; i += 32) rhs[i] -= A[i * ld + kk] * y;
    __syncwarp();
  }
  for (int kk = n - 1; kk >= 0; --kk) {
    const float x = rhs[kk] / A[kk * ld + kk];
    __syncwarp();
    if (lane == 0) rhs[kk] = x;
    for (int i = lane; i < kk; i += 32) rhs[i] -= A[kk * ld + i] * x;
    __syncwarp();
  }
}

// The same solves over a cluster, CTA by CTA over their columns: the
// forward sweep in rank order (each CTA takes b and the y so far from the
// one before it), the backward sweep in reverse rank order (x_k = (y_k -
// L[k+1:, k] . x[k+1:]) / L_kk, one warp, a fixed shuffle tree), then every
// CTA takes x from rank 0. rhs holds b on rank 0 and ends holding x on
// every CTA; ysol is scratch.
__device__ void solve_cluster(const float* A, float* rhs, float* ysol, int n, int ld,
                              int w, int rank, int C) {
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31;
  const int c0 = rank * w, c1 = min(n, c0 + w);
  for (int r = 0; r < C; ++r) {
    if (rank == r) {
      if (r > 0) {
        const float* pb = cluster.map_shared_rank(rhs, r - 1);
        const float* py = cluster.map_shared_rank(ysol, r - 1);
        for (int i = tid; i < n; i += kThreads)
          if (i < c0) ysol[i] = py[i]; else rhs[i] = pb[i];
        __syncthreads();
      }
      for (int kk = c0; kk < c1; ++kk) {
        const float y = rhs[kk] / A[kk * ld + kk - c0];
        if (tid == 0) ysol[kk] = y;
        for (int i = kk + 1 + tid; i < n; i += kThreads) rhs[i] -= A[i * ld + kk - c0] * y;
        __syncthreads();
      }
    }
    cluster.sync();
  }
  for (int r = C - 1; r >= 0; --r) {
    if (rank == r) {
      if (r < C - 1) {
        const float* py = cluster.map_shared_rank(ysol, C - 1);
        const float* px = cluster.map_shared_rank(rhs, r + 1);
        for (int i = tid; i < n; i += kThreads)
          if (i >= c1) rhs[i] = px[i]; else if (i >= c0) ysol[i] = py[i];
        __syncthreads();
      }
      if (tid < 32)
        for (int kk = c1 - 1; kk >= c0; --kk) {
          float s = 0.f;
          for (int i = kk + 1 + lane; i < n; i += 32) s += A[i * ld + kk - c0] * rhs[i];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          const float x = (ysol[kk] - s) / A[kk * ld + kk - c0];
          __syncwarp();
          if (lane == 0) rhs[kk] = x;
          __syncwarp();
        }
    }
    cluster.sync();
  }
  if (rank != 0) {
    const float* px = cluster.map_shared_rank(rhs, 0);
    for (int i = tid; i < n; i += kThreads) rhs[i] = px[i];
  }
  cluster.sync();  // rank 0's x is read before any CTA changes it
}

// One launch = one solve: a cluster of C CTAs (C = 1 up to M = 32). Every
// CTA keeps the poses and takes every decision; the edges are split over
// the CTAs and their sums meet through distributed shared memory; CTA r
// holds columns [r w, (r + 1) w) of the system.
__global__ void __launch_bounds__(kThreads, 1) pose_graph_kernel(Params p) {
  extern __shared__ float smem[];
  __shared__ double red[kWarps];
  __shared__ float redf[kWarps];
  __shared__ double s_sum[3];  // this CTA's share: step, trial and final chi2
  __shared__ float s_max;      // this CTA's share of the adaptive start
  __shared__ float s_step;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.C, rank = C > 1 ? (int)cluster.block_rank() : 0;
  const int M = p.M, E = p.E, n = 6 * M;
  const int w = (n + C - 1) / C, c0 = rank * w, c1 = min(n, c0 + w), ld = w + 1;
  float* A = smem;            // rows 0..n-1 of columns [c0, c1): the damped
  float* rhs = A + n * ld;    // system, then its factor; -g, then delta
  float* pose = rhs + n;      // (M, 16) current poses
  float* trial = pose + 16 * M;
  float* col = trial + 16 * M;  // C > 1: the pivot column, then y
  float* ysol = col + n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e0 = rank * kThreads + tid, de = C * kThreads;  // this thread's edges

  for (int q = tid; q < 16 * M; q += kThreads) pose[q] = p.poses[q];
  __syncthreads();

  // Adaptive GNC start: anneal0 = max(gnc_init, sqrt(max(max chi2, 1)) / c).
  float anneal0 = p.gnc_init;
  if (p.gnc_adaptive) {
    float mx = -INFINITY;
    for (int e = e0; e < E; e += de) {
      float r[6];
      mx = nan_max(mx, edge_chi2(pose + 16 * p.edge_i[e], pose + 16 * p.edge_j[e],
                                 p.Z + 16 * e, p.info + 36 * e, r) * p.mask[e]);
    }
    mx = cluster_max(mx, redf, &s_max, C);
    const float s = sqrtf(isnan(mx) ? mx : fmaxf(mx, 1.f)) / p.cauchy_c;
    anneal0 = nan_max(s, anneal0);
  }

  float lam = 1e-6f;
  int k = 0;
  while (k < p.iterations) {
    float anneal = anneal0 * (float)pow(p.gnc_decay, (double)k);
    anneal = isnan(anneal) ? anneal : fmaxf(anneal, 1.f);
    const float c_eff = p.cauchy_c * anneal;
    const float c2 = c_eff * c_eff;

    // Per-edge blocks and the chi2 at the current poses; the barriers of
    // the sum publish the scratch to every CTA.
    double part = 0.0;
    for (int e = e0; e < E; e += de) part += build_edge(p, pose, e, c2);
    const float chi2 = (float)cluster_sum(part, red, &s_sum[0], C);

    // rhs = -g (rank 0); this CTA's columns of the damped lower triangle
    // H + lam diag(H) + jitter I.
    if (rank == 0)
      for (int q = tid; q < n; q += kThreads) {
        const int v = q / 6, r = q - 6 * v;
        float g = 0.f;
        for (int u = p.v_off[v]; u < p.v_off[v + 1]; ++u) {
          const int ci = p.v_idx[u];
          g += ci < E ? -p.scratch[(size_t)kEdgeFloats * ci + 36 + r]
                      : p.scratch[(size_t)kEdgeFloats * (ci - E) + 36 + r];
        }
        rhs[q] = -g;
      }
    for (int R = warp; R < n; R += kWarps) {
      const int a = R / 6, r = R - 6 * a;
      for (int Cc = c0 + lane; Cc <= R && Cc < c1; Cc += 32) {
        const int b = Cc / 6, c = Cc - 6 * b;
        const int slot = a * M + b;
        float h = 0.f;
        for (int u = p.d_off[slot]; u < p.d_off[slot + 1]; ++u)
          h += contribution(p, p.d_idx[u], r, c);
        A[R * ld + Cc - c0] = R == Cc ? (h + lam * h) + kJitter : h;
      }
    }
    if (C > 1) cluster.sync(); else __syncthreads();

    // The factorization and both solves; a failed factorization or a
    // non-finite step gives delta = 0.
    const bool ok = C == 1 ? factor_cta(A, n, ld) : factor_cluster(A, col, n, ld, w, rank);
    __syncthreads();
    if (ok) {
      if (C == 1) solve_cta(A, rhs, n, ld);
      else solve_cluster(A, rhs, ysol, n, ld, w, rank, C);
    }
    __syncthreads();
    if (warp == 0) {
      bool bad = !ok;
      for (int i = lane; i < n; i += 32) bad |= !isfinite(rhs[i]);
      bad = __any_sync(0xffffffffu, bad);
      double ss = 0.0;
      for (int i = lane; i < n; i += 32) {
        if (bad) rhs[i] = 0.f;
        ss += (double)rhs[i] * rhs[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) s_step = (float)sqrt(ss);
    }
    __syncthreads();

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

    // chi2 at the trial poses (residuals only).
    part = 0.0;
    for (int e = e0; e < E; e += de) {
      float r[6];
      const float c = edge_chi2(trial + 16 * p.edge_i[e], trial + 16 * p.edge_j[e],
                                p.Z + 16 * e, p.info + 36 * e, r);
      const float w_e = robust_weight(p, c, c2) * p.mask[e];
      part += (double)(w_e * c);
    }
    const float chi2_new = (float)cluster_sum(part, red, &s_sum[1], C);

    const bool accept = chi2_new <= chi2;
    if (accept)
      for (int q = tid; q < 16 * M; q += kThreads) pose[q] = trial[q];
    lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.f, 1e-9f), 1e6f);
    const bool done = accept && s_step < 1e-8f && anneal <= 1.f;
    if (rank == 0 && tid == 0) {
      float* st = p.stats_out + 4 * k;
      st[0] = chi2;
      st[1] = chi2_new;
      st[2] = s_step;
      st[3] = accept ? 1.f : 0.f;
    }
    ++k;
    __syncthreads();
    if (done) break;
  }

  // Final chi2 and per-edge weights at the base Cauchy width.
  const float c2 = (float)(p.cauchy_c64 * p.cauchy_c64);
  double part = 0.0;
  for (int e = e0; e < E; e += de) {
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

// What a solve over M vertices uses: out[0] the largest M the kernel
// takes, out[1] CTAs per cluster (0 past the limit), out[2] threads per
// CTA, out[3] dynamic shared memory bytes per CTA at M (0 past the limit).
// Returns 0.
extern "C" int dvo_pose_graph_plan(int M, int* out) {
  const int C = cluster_for(M);
  out[0] = kMaxVertices;
  out[1] = C;
  out[2] = kThreads;
  out[3] = C ? (int)shared_bytes(M, C) : 0;
  return 0;
}

// One dense LM solve (models/pose_graph.py::optimize_reference's
// semantics) in one launch of one cluster on `stream`, no host sync.
// Inputs as Params; scratch: E * 42 floats. Outputs: poses_out (M, 4, 4),
// chi2_out, weights_out (E,), stats_out (iterations, 4: each step's chi2,
// trial chi2, step norm and accept flag, zero past the last step) and
// steps_out (the LM steps run). Returns a CUDA error code (0: launched).
extern "C" int dvo_pose_graph(
    const float* poses, const float* Z, const float* info, const float* mask,
    const int* edge_i, const int* edge_j, const int* v_off, const int* v_idx,
    const int* d_off, const int* d_idx, int M, int E, int nv, int iterations,
    int use_robust, double cauchy_c, double gnc_init, double gnc_decay,
    int gnc_adaptive, float* scratch, float* poses_out, float* chi2_out,
    float* weights_out, float* stats_out, int* steps_out, void* stream) {
  const int C = cluster_for(M);
  if (C == 0 || E < 0 || iterations < 0) return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.poses = poses; p.Z = Z; p.info = info; p.mask = mask;
  p.edge_i = edge_i; p.edge_j = edge_j;
  p.v_off = v_off; p.v_idx = v_idx; p.d_off = d_off; p.d_idx = d_idx;
  p.M = M; p.E = E; p.nv = nv; p.iterations = iterations; p.C = C;
  p.use_robust = use_robust; p.gnc_adaptive = gnc_adaptive;
  p.cauchy_c = (float)cauchy_c; p.gnc_init = (float)gnc_init;
  p.cauchy_c64 = cauchy_c; p.gnc_decay = gnc_decay;
  p.scratch = scratch; p.poses_out = poses_out; p.chi2_out = chi2_out;
  p.weights_out = weights_out; p.stats_out = stats_out; p.steps_out = steps_out;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = shared_bytes(M, C);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int prepared = prepare(dev, &cfg, C);
  if (prepared) return prepared;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, pose_graph_kernel, p);
  const cudaError_t last = cudaGetLastError();
  return (int)(launched != cudaSuccess ? launched : last);
}
