// Device functions shared by the two pose-graph kernels, csrc/pose_graph.cu
// (dense, M <= 128, one thread-block cluster) and csrc/pose_graph_grid.cu
// (every other CUDA solve, one cooperative grid): the f32 SE(3) helpers,
// an edge's residual, chi2 and f64 Jacobian, the edge pass's two stages, the
// dense plan's contributions, the Cauchy weight, the GNC anneal and the LM
// accept rule, the fixed-order CTA reductions and the one-warp Cholesky of a
// diagonal block. Both kernels repeat models/pose_graph.py's plain
// arithmetic with these, so the same graph gives the same per-edge blocks,
// chi2 and decisions on either kernel's route.
//
// Included by one translation unit at a time; everything here has internal
// linkage (an unnamed namespace), so each kernel's object holds its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kEdgeFloats = 42;                  // per-edge slot: P (36), gj (6)
constexpr float kGaugeWeight = 1e6f;             // models/pose_graph.py _GAUGE_WEIGHT
constexpr float kJitter = 1e-6f;                 // models/pose_graph.py _JITTER
constexpr unsigned kFull = 0xffffffffu;

// %globaltimer (ns), for the phase-timing buffers.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
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

// Jj's 18 distinct f32 entries from e (f32) and T_i, Z: the top-left (and
// bottom-right) block JR = J3i R and the top-right block TR = J3i tR - JQJ R,
// each 3x3 row-major; the bottom-left block is zero.
__device__ void edge_jacobian(const float* e, const float* Ti, const float* Z, float* JR,
                              float* TR) {
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
  double JRd[9], JtR[9], JQJR[9];
  mm3d(J3i, R, JRd);
  mm3d(J3i, tR, JtR);
  mm3d(JQJ, R, JQJR);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      JR[3 * r + q] = (float)JRd[3 * r + q];
      TR[3 * r + q] = (float)(JtR[3 * r + q] - JQJR[3 * r + q]);
    }
}

// ------------------------------------------------------------ reductions

// Sums v over a CTA of kW warps: a fixed xor-shuffle tree in each warp, then
// the warps in order; every thread gets the sum. Two __syncthreads.
template <int kW>
__device__ double block_sum(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  double s = 0.0;
#pragma unroll
  for (int w = 0; w < kW; ++w) s += red[w];
  __syncthreads();
  return s;
}

// torch.max's semantics: a NaN anywhere gives NaN.
__device__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// block_sum's order with nan_max.
template <int kW>
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < kW; ++w) s = nan_max(s, red[w]);
  __syncthreads();
  return s;
}

// ------------------------------------------------------ the LM decisions
// models/pose_graph.py::optimize_reference's scalar rules, evaluated by
// every CTA of a launch from the same bits.

// The adaptive GNC start: max(gnc_init, sqrt(max(max chi2, 1)) / c), a NaN
// chi2 propagating as torch.maximum does.
__device__ float adaptive_anneal0(float max_chi2, float cauchy_c, float gnc_init) {
  const float s = sqrtf(isnan(max_chi2) ? max_chi2 : fmaxf(max_chi2, 1.f)) / cauchy_c;
  return nan_max(s, gnc_init);
}

// The anneal of LM step k: max(anneal0 decay^k, 1) (NaN stays NaN).
__device__ float anneal_at(float anneal0, double decay, int k) {
  const float a = anneal0 * (float)pow(decay, (double)k);
  return isnan(a) ? a : fmaxf(a, 1.f);
}

// The accept test, the lambda update and clip and the stop rule of one LM
// step: accept when the trial chi2 is no larger; lambda halves on accept and
// quadruples on reject within [1e-9, 1e6]; stop after an accepted step of
// norm < 1e-8 once the anneal has reached 1.
struct LmStep {
  bool accept, done;
  float lam;
};

__device__ LmStep lm_step(float chi2, float chi2_new, float lam, float step, float anneal) {
  LmStep r;
  r.accept = chi2_new <= chi2;
  r.lam = fminf(fmaxf(r.accept ? lam * 0.5f : lam * 4.f, 1e-9f), 1e6f);
  r.done = r.accept && step < 1e-8f && anneal <= 1.f;
  return r;
}

// ------------------------------------------------------------ the edge pass

// The Cauchy IRLS weight 1 / (1 + chi2 / c^2), or 1 without the kernel.
template <class Prm>
__device__ float robust_weight(const Prm& p, float chi2, float c2) {
  return p.use_robust ? 1.f / (1.f + chi2 / c2) : 1.f;
}

// Stage A of edge e (one thread) at poses `pose`: its residual, chi2 and
// weight (robust at c2, times the mask) and the f64 Jacobian, left in the
// edge's slot for stage B as [JR (9) | TR (9) | e (6) | w]. A weight of 0
// with a finite chi2 makes P and gj zero, so the Jacobian is skipped (a
// masked or padded edge). Returns w * chi2.
template <class Prm>
__device__ float edge_stage_a(const Prm& p, const float* pose, int e, float c2,
                              float* slot) {
  const float* Z = p.Z + 16 * e;
  const float* Ti = pose + 16 * p.edge_i[e];
  const float* Tj = pose + 16 * p.edge_j[e];
  float r[6];
  const float chi2 = edge_chi2(Ti, Tj, Z, p.info + 36 * e, r);
  const float w = robust_weight(p, chi2, c2) * p.mask[e];
  float JR[9], TR[9];
  if (w == 0.f && isfinite(chi2)) {
#pragma unroll
    for (int q = 0; q < 9; ++q) JR[q] = TR[q] = 0.f;
  } else {
    edge_jacobian(r, Ti, Z, JR, TR);
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    slot[q] = JR[q];
    slot[9 + q] = TR[q];
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) slot[18 + q] = r[q];
  slot[24] = w;
  return w * chi2;
}

// Stage B of edge e over seven lanes of one warp (every lane of the warp
// calls it: a __syncwarp inside): lane q < 6 forms column q of P = J^T X
// with X = (w info) J, lane 6 forms gj = J^T ((w info) e), from stage A's
// slot, then overwrites the slot with [P (36, row-major) | gj (6)].
template <class Prm>
__device__ void edge_stage_b(const Prm& p, int e, int q, bool active, float* slot) {
  float J[36], col[6], w = 0.f;
  if (active) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        J[6 * k + a] = slot[3 * k + a];
        J[6 * k + 3 + a] = slot[9 + 3 * k + a];
        J[6 * (k + 3) + a] = 0.f;
        J[6 * (k + 3) + 3 + a] = slot[3 * k + a];
      }
#pragma unroll
    for (int k = 0; k < 6; ++k) {  // column q of J, or e (lane 6)
      float v = slot[18 + k];
#pragma unroll
      for (int a = 0; a < 6; ++a)
        if (q == a) v = J[6 * k + a];
      col[k] = v;
    }
    w = slot[24];
  }
  __syncwarp();
  if (!active) return;
  const float* info = p.info + 36 * e;
  float X[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float x = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) x += (w * info[6 * a + k]) * col[k];
    X[a] = x;
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) s += J[6 * k + a] * X[k];
    if (q < 6) slot[6 * a + q] = s;
    else slot[36 + a] = s;
  }
}

// Element (r, c) of the dense-plan contribution coded `code` (the host's
// encoding of the plan's index list: 4 e + kind for edge e's Hii, Hjj,
// Hij, Hij^T; -1 - v for vertex v's gauge prior or inactive identity), the
// edges' blocks at blk.
template <class Prm>
__device__ float contribution(const Prm& p, const float* blk, int code, int r, int c) {
  if (code >= 0) {
    const float* P = blk + (size_t)kEdgeFloats * (code >> 2);
    const int kind = code & 3;
    if (kind < 2) return P[6 * r + c];     // Hii, Hjj
    if (kind == 2) return -P[6 * r + c];   // Hij
    return -P[6 * c + r];                  // Hij^T
  }
  if (r != c) return 0.f;
  const int v = -1 - code;  // gauge prior on vertex 0, identity if inactive
  const float extra = v >= p.nv ? 1.f : 0.f;
  return v == 0 ? extra + kGaugeWeight : extra;
}

// Element (r, c) of a block of H: its contributions codes[0..count) summed
// in list order, loaded eight at a time so that their latencies overlap.
template <class Prm>
__device__ float block_element(const Prm& p, const float* blk, const int* codes,
                               int count, int r, int c) {
  float h = 0.f;
  for (int v0 = 0; v0 < count; v0 += 8) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = v0 + j < count ? contribution(p, blk, __ldg(codes + v0 + j), r, c) : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (v0 + j < count) h += x[j];
  }
  return h;
}

// Element r of vertex v's gradient g_v: its contributions in the vertex
// plan's order (v_off, v_idx: index u < E is edge u's gi = -gj, u >= E edge
// u - E's gj), loaded eight at a time so that their latencies overlap.
template <class Prm>
__device__ float vertex_gradient(const Prm& p, const float* blk, int v, int r) {
  const int E = p.E;
  const int u0 = __ldg(p.v_off + v), u1 = __ldg(p.v_off + v + 1);
  float g = 0.f;
  for (int u = u0; u < u1; u += 8) {
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ci = u + j < u1 ? __ldg(p.v_idx + u + j) : E;
      x[j] = u + j < u1 ? (ci < E ? -blk[(size_t)kEdgeFloats * ci + 36 + r]
                                  : blk[(size_t)kEdgeFloats * (ci - E) + 36 + r])
                        : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (u + j < u1) g += x[j];
  }
  return g;
}

// ------------------------------------------------------ the diagonal block

// 1 / x and 1 / sqrt(x) for x > 0 without the IEEE routines' branches
// (which stop the compiler from overlapping a pivot's chain with the
// shuffles around it): the MUFU estimate and one Newton step.
__device__ __forceinline__ float recip(float x) {
  const float r = __fdividef(1.f, x);
  return fmaf(r, fmaf(-x, r, 1.f), r);
}

__device__ __forceinline__ float rsqrt_nr(float x) {
  const float y = rsqrtf(x);
  return fmaf(y, fmaf(-0.5f * x * y, y, 0.5f), y);
}

// Factors the w x w diagonal block of a panel (its rows 0..w-1, row stride
// LDA >= W + 1; W <= 32) in the calling warp: lane i holds row i in registers. Pivot k
// goes to every lane by a shuffle, and each lane updates its row by the
// unscaled column k, A_ij -= (A_ik / d_k) A_jk; the square roots and the
// scaling L_ik = A_ik / sqrt(d_k) wait until every pivot is known, so a
// pivot's chain is one shuffle, a reciprocal and one FMA. The body has no
// branch (a branch would stop the compiler from overlapping one pivot's
// chain with the shuffles around it; a lane or pivot past w works on
// zeros), and a pivot <= 0 or NaN is only recorded: the values after it
// are discarded. Writes L's lower triangle and 1 / L_ii in the row's last
// float. False on every lane where a pivot failed (nothing written).
template <int W, int LDA>
__device__ bool factor_diag(float* A, int w) {
  const int lane = threadIdx.x & 31;
  float a[W], d[W];
#pragma unroll
  for (int j = 0; j < W; ++j) a[j] = (lane < w && j <= lane) ? A[lane * LDA + j] : 0.f;
  bool bad = false;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float dk = __shfl_sync(kFull, a[k], k);  // every lane the same pivot
    bad |= k < w && !(dk > 0.f);
    d[k] = k < w ? dk : 1.f;
    const float u = a[k] * recip(d[k]);
#pragma unroll
    for (int j = k + 1; j < W; ++j) {
      const float ajk = __shfl_sync(kFull, a[k], j);
      a[j] = lane >= j ? fmaf(-u, ajk, a[j]) : a[j];
    }
  }
  if (!bad && lane < w) {
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float inv = rsqrt_nr(d[j]), s = d[j] * inv;
      if (j < lane) A[lane * LDA + j] = a[j] * inv;
      if (j == lane) {
        A[lane * LDA + j] = s;
        A[lane * LDA + W] = inv;
      }
    }
  }
  return !bad;
}

}  // namespace
