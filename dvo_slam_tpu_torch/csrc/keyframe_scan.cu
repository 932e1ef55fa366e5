// The chunked keyframe scan's per-frame step for Hopper (sm_90a): one
// launch a frame, after the frame's pyramid launch and its three level
// launches, so that a chunk of frames runs as five launches a frame with no
// other device op and no host sync between them.
//
// What it replaces. No Pallas kernel: the body of the JAX package's scan
// step after the tracker (dvo_slam_tpu/models/keyframe_scan.py::_make_step
// :100-205, with _entropy_ratio_jnp :63-71, _fuse_relative_poses_jnp
// :74-82 and dvo_slam_tpu/ops/se3.py's exp :75, log_so3 :91, log :121 and
// inverse :146), which jax.lax.scan (:208-213) compiles with the tracker
// into one device program a chunk. The port's plain version is
// ops/scan_step.py::scan_step_reference, the decisions of the per-frame
// route's models/keyframe_scan.py::_step (about 60 eager ops and four
// full-pyramid selects a frame); ops/scan_step.py::scan_step_plain runs it
// on this kernel's buffers.
//
// What it computes, for frame k, in the plain version's order: from the
// two rows (keyframe, previous frame) of the level launches' output (the
// finest level's pose, log-likelihood, information and the entropy and
// valid-ratio extras), the carry slot k and force[k]: is_nan (a non-finite
// pose or log-likelihood), the acceptance, the sign-safe entropy ratio
// against the keyframe's first entropy (floor kEntropyFloor), the switch,
// the information-weighted fusion of the keyframe measurement with the
// chained odometry (SE(3) log, a 6x6 solve by Gaussian elimination with
// partial pivoting, exp; a non-finite step dropped), the switch
// measurement and its information (the 1e2 I fallback), the entropy
// history. It writes frame k's packed output row (the layout of
// ops/scan_step.py::output_layout, booleans and integers as int32 bits,
// the TrackStats planes copied from the level rows with stats), carry slot
// k + 1 (whose first 32 floats are frame k + 1's two initial poses, the
// T_init its first level launch reads) and frame k + 1's table of
// reference slab pointers, a tracked level a row: the keyframe's slab
// (frame k's where it switched) and frame k's. The level kernel reads that
// table from device memory (csrc/linearize.cu's device-table route), so
// the keyframe is chosen on the card with no copy of a slab.
//
// Bits. The comparisons, the entropy ratio (with _rn intrinsics, no FMA
// contraction, in the plain version's order) and the where-chain copy
// the plain version's f32 arithmetic, so the decisions and every copied
// field equal its bits. The products (the chained odometry T_alt), the
// SE(3) log and exp and the solve do not follow cuBLAS's, cuSOLVER's or
// PyTorch's order: the tests hold the fused pose to 1e-5.
//
// What bounds it on this card: about 1 KB read and written (more with the
// statistics) and a serial chain of a few thousand flops in one thread:
// the launch floor and the chain's latency, both small beside the frame's
// level launches. Its design: one CTA; thread 0 runs the chain while the
// other warps copy the fields that need no decision (the measurements,
// the informations, the iterations and statistics), then every thread
// writes its share of the decided fields.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxLevels = 6;
// Mode (b)'s row (csrc/linearize.cu kLevel*, kBest*, kExtra*).
constexpr int kLevelT = 0, kLevelLoglik = 16, kLevelBest = 17, kLevelStats = 67;
constexpr int kStatPlanes = 5, kExtraEntropy = 1, kExtraRatio = 2, kExtraSize = 3;
// The carry slot (ops/scan_step.py _STATE_*).
constexpr int kStateTKfPrev = 0, kStateOdoInit = 16, kStateLastOdo = 32;
constexpr int kStateHFirst = 48, kStateHasFirst = 49, kStateSize = 50;
static_assert(kStateHasFirst + 1 == kStateSize, "the carry slot ends with its flag");
// The packed output row (ops/scan_step.py output_layout); with stats the
// planes valid, error, delta_norm, accepted (2 L M each) and termination
// (2 L) follow the iterations (2 L).
constexpr int kOutRelPose = 0, kOutSwitch = 16, kOutZSwitch = 17, kOutInfoSwitch = 33;
constexpr int kOutEntropy = 69, kOutEntropyRatio = 70, kOutAccept = 71;
constexpr int kOutValidRatio = 72, kOutTKfMeas = 73, kOutTOdoMeas = 89;
constexpr int kOutInfoPair = 105, kOutIsNan = 177, kOutIterations = 179;
// models/dense_tracker.py _ENTROPY_DENOM_FLOOR; the switch measurement's
// information where neither alignment holds (1e2 I).
constexpr float kEntropyFloor = 1.0f;
constexpr float kFallbackInformation = 100.0f;

struct Params {
  const float* lev;  // (2, L, S): frame k's level rows
  const int* lev_i;  // (2, L, 2): iterations, termination
  int L, M, S;
  const float* state_in;
  const int64_t* table_in;  // (L, 2) slab pointers: keyframe, previous
  const uint8_t* force;
  const float* cur[kMaxLevels];  // frame k's tracked slabs
  float min_constraint_ratio, min_entropy_ratio;
  int fuse, use_init, with_stats;
  float* out;
  float* state_out;
  int64_t* table_out;
};

struct Decided {
  float T_kf_cur[16], Z[16], last_odo[16];
  float h, ratio, H_first;
  int kf_nan, odo_nan, accept, sw, has_first;
};

__device__ __forceinline__ float bits(int x) { return __int_as_float(x); }

__device__ void matmul4(const float* A, const float* B, float* C) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float s = 0.f;
      for (int k = 0; k < 4; ++k) s += A[4 * i + k] * B[4 * k + j];
      C[4 * i + j] = s;
    }
}

// ops/se3.py::inverse: [R^T, -R^T t; 0 0 0 1].
__device__ void inverse4(const float* T, float* out) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) out[4 * i + j] = T[4 * j + i];
    out[4 * i + 3] = -(T[i] * T[3] + T[4 + i] * T[7] + T[8 + i] * T[11]);
  }
  out[12] = out[13] = out[14] = 0.f;
  out[15] = 1.f;
}

// W @ W for W = hat(w).
__device__ void hat2(const float* w, float* W, float* W2) {
  W[0] = 0.f;   W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.f;   W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.f;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
}

// ops/se3.py::log (with log_so3): the twist (v, w) of T, its small-angle
// branches parameterized by u = 1 - cos(theta) as there.
__device__ void log_se3(const float* T, float* xi) {
  const float trace = T[0] + T[5] + T[10];
  const float u = fminf(fmaxf((3.f - trace) * 0.5f, 0.f), 2.f);
  const bool small_u = u < 1e-6f;
  const float u_safe = small_u ? 1.f : u;
  const float theta_u = acosf(1.f - u_safe);
  const float sin_u = sqrtf(u_safe * (2.f - u_safe));
  const float tss = 2.f * u + u * u / 3.f;
  const float factor = small_u ? 0.5f + tss / 12.f + 7.f * tss * tss / 720.f
                               : theta_u / (2.f * sin_u);
  float w[3] = {factor * (T[9] - T[6]), factor * (T[2] - T[8]), factor * (T[4] - T[1])};
  const float theta_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = theta_sq < 1e-8f;
  const float theta = sqrtf(theta_sq < 1e-12f ? 1.f : theta_sq);
  const float coef = small ? 1.f / 12.f + theta_sq / 720.f
                           : 1.f / theta_sq - (1.f + cosf(theta)) / (2.f * theta * sinf(theta));
  float W[9], W2[9];
  hat2(w, W, W2);
  for (int i = 0; i < 3; ++i) {
    float v = 0.f;
    for (int j = 0; j < 3; ++j) {
      const float Vinv = (i == j ? 1.f : 0.f) - 0.5f * W[3 * i + j] + coef * W2[3 * i + j];
      v += Vinv * T[4 * j + 3];
    }
    xi[i] = v;
    xi[3 + i] = w[i];
  }
}

// ops/se3.py::exp: (v, w) -> T, Taylor-safe coefficients as there.
__device__ void exp_se3(const float* xi, float* T) {
  const float* w = xi + 3;
  const float theta_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = theta_sq < 1e-8f;
  const float safe_sq = small ? 1.f : theta_sq;
  const float safe_t = sqrtf(safe_sq);
  const float sin_t = sinf(safe_t);
  const float a = small ? 1.f - theta_sq / 6.f : sin_t / safe_t;
  const float b = small ? 0.5f - theta_sq / 24.f : (1.f - cosf(safe_t)) / safe_sq;
  const float c = small ? 1.f / 6.f - theta_sq / 120.f : (safe_t - sin_t) / (safe_sq * safe_t);
  float W[9], W2[9];
  hat2(w, W, W2);
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.f : 0.f;
      T[4 * i + j] = I + a * W[3 * i + j] + b * W2[3 * i + j];
      t += (I + b * W[3 * i + j] + c * W2[3 * i + j]) * xi[j];
    }
    T[4 * i + 3] = t;
  }
  T[12] = T[13] = T[14] = 0.f;
  T[15] = 1.f;
}

// The fusion (ops/scan_step.py::fuse_relative_poses): one Gauss-Newton
// step from T_a towards T_b weighted by the two informations; a
// non-finite step (a singular information sum) is dropped.
__device__ void fuse(const float* T_a, const float* info_a, const float* T_b,
                     const float* info_b, float* out) {
  float inv[16], D[16], xi[6];
  inverse4(T_a, inv);
  matmul4(T_b, inv, D);
  log_se3(D, xi);
  float A[6][7];
  for (int i = 0; i < 6; ++i) {
    float r = 0.f;
    for (int j = 0; j < 6; ++j) {
      A[i][j] = info_a[6 * i + j] + info_b[6 * i + j];
      r += info_b[6 * i + j] * xi[j];
    }
    A[i][6] = r;
  }
  for (int c = 0; c < 6; ++c) {
    int p = c;
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(A[r][c]) > fabsf(A[p][c])) p = r;
    if (p != c)
      for (int j = c; j < 7; ++j) {
        const float t = A[c][j];
        A[c][j] = A[p][j];
        A[p][j] = t;
      }
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] / A[c][c];
      for (int j = c; j < 7; ++j) A[r][j] -= f * A[c][j];
    }
  }
  float delta[6];
  bool good = true;
  for (int i = 5; i >= 0; --i) {
    float s = A[i][6];
    for (int j = i + 1; j < 6; ++j) s -= A[i][j] * delta[j];
    delta[i] = s / A[i][i];
    good = good && isfinite(delta[i]);
  }
  if (!good)
    for (int i = 0; i < 6; ++i) delta[i] = 0.f;
  float E[16];
  exp_se3(delta, E);
  matmul4(E, T_a, out);
}

__device__ bool all_finite(const float* x, int n) {
  bool ok = true;
  for (int i = 0; i < n; ++i) ok = ok && isfinite(x[i]);
  return ok;
}

// Thread 0: the decisions (module comment), into d.
__device__ void decide(const Params& p, Decided& d) {
  const float* r0 = p.lev + (p.L - 1) * p.S;          // keyframe row
  const float* r1 = p.lev + (2 * p.L - 1) * p.S;      // previous-frame row
  const float* T0 = r0 + kLevelT;
  const float* T1 = r1 + kLevelT;
  const float* info0 = r0 + kLevelBest;  // the record's A comes first
  const float* info1 = r1 + kLevelBest;
  const float* extra0 = r0 + kLevelStats + kStatPlanes * p.M;
  const float* Tkp = p.state_in + kStateTKfPrev;
  const float H_prev = p.state_in[kStateHFirst];
  const bool has_prev = __float_as_int(p.state_in[kStateHasFirst]) != 0;

  const bool kf_nan = !(all_finite(T0, 16) && isfinite(r0[kLevelLoglik]));
  const bool odo_nan = !(all_finite(T1, 16) && isfinite(r1[kLevelLoglik]));
  for (int i = 0; i < 16; ++i)
    d.last_odo[i] = odo_nan ? p.state_in[kStateLastOdo + i] : T1[i];

  const float vr = extra0[kExtraRatio];
  const bool accept = !kf_nan && vr >= p.min_constraint_ratio;
  const float h = extra0[kExtraEntropy];
  // The sign-safe ratio: torch.clamp keeps a NaN, as the branch does.
  const float ref = has_prev ? H_prev : h;
  const float mag = fabsf(ref);
  const float den = mag < kEntropyFloor ? kEntropyFloor : mag;
  const float raw = __fsub_rn(1.f, __fdiv_rn(__fsub_rn(h, ref), den));
  const bool ok = isfinite(h) && isfinite(ref);
  const float er = has_prev ? (ok ? raw : -INFINITY) : 1.f;
  const float ratio = accept ? er : 1.f;
  const bool sw = p.force[0] != 0 || !accept || ratio < p.min_entropy_ratio;

  float T_alt[16];
  matmul4(T1, Tkp, T_alt);
  if (p.fuse && !odo_nan) {
    fuse(T0, info0, T_alt, info1, d.T_kf_cur);
  } else {
    for (int i = 0; i < 16; ++i) d.T_kf_cur[i] = T0[i];
  }
  for (int i = 0; i < 16; ++i) d.Z[i] = accept ? T0[i] : (odo_nan ? Tkp[i] : T_alt[i]);

  const bool set_first = accept && !has_prev && isfinite(h);
  float H_first = set_first ? h : H_prev;
  bool has_first = has_prev || set_first;
  d.H_first = sw ? 0.f : H_first;
  d.has_first = has_first && !sw;
  d.h = h;
  d.ratio = ratio;
  d.kf_nan = kf_nan;
  d.odo_nan = odo_nan;
  d.accept = accept;
  d.sw = sw;
}

__global__ void __launch_bounds__(kThreads) scan_step_kernel(Params p) {
  __shared__ Decided d;
  const int t = threadIdx.x;
  const int L = p.L, M = p.M, S = p.S;
  const float* r0 = p.lev + (L - 1) * p.S;
  const float* r1 = p.lev + (2 * L - 1) * p.S;
  float* o = p.out;
  if (t == 0) {
    decide(p, d);
  } else {
    // The fields that need no decision, by the other warps meanwhile.
    for (int i = t - 1; i < 16; i += kThreads - 1) {
      o[kOutTKfMeas + i] = r0[kLevelT + i];
      o[kOutTOdoMeas + i] = r1[kLevelT + i];
    }
    for (int i = t - 1; i < 36; i += kThreads - 1) {
      o[kOutInfoPair + i] = r0[kLevelBest + i];
      o[kOutInfoPair + 36 + i] = r1[kLevelBest + i];
    }
    for (int i = t - 1; i < 2 * L; i += kThreads - 1)
      o[kOutIterations + i] = bits(p.lev_i[2 * i]);
    if (p.with_stats) {
      // valid, error, delta_norm, accepted: (2, L, M) each, from the rows'
      // first four planes; termination (2, L).
      float* st = o + kOutIterations + 2 * L;
      const int plane = 2 * L * M;
      for (int i = t - 1; i < 4 * plane; i += kThreads - 1) {
        const int q = i / plane, r = i % plane;  // plane, (b, level, iter)
        const int bl = r / M, it = r % M;
        const float x = p.lev[bl * S + kLevelStats + q * M + it];
        st[i] = q == 3 ? bits(x != 0.f) : x;
      }
      for (int i = t - 1; i < 2 * L; i += kThreads - 1)
        st[4 * plane + i] = bits(p.lev_i[2 * i + 1]);
    }
  }
  __syncthreads();
  const bool sw = d.sw;
  if (t < 16) {
    const float I = (t % 5 == 0) ? 1.f : 0.f;
    const float T_kf_prev = sw ? I : d.T_kf_cur[t];
    o[kOutRelPose + t] = T_kf_prev;
    o[kOutZSwitch + t] = d.Z[t];
    p.state_out[kStateTKfPrev + t] = T_kf_prev;
    p.state_out[kStateOdoInit + t] = p.use_init ? d.last_odo[t] : I;
    p.state_out[kStateLastOdo + t] = d.last_odo[t];
  } else if (t >= 32 && t < 68) {
    const int i = t - 32;
    const float I = (i % 7 == 0) ? kFallbackInformation : 0.f;
    o[kOutInfoSwitch + i] = d.accept ? r0[kLevelBest + i]
                                     : (d.odo_nan ? I : r1[kLevelBest + i]);
  } else if (t >= 96 && t < 96 + L) {
    const int j = t - 96;
    const int64_t cur = (int64_t)(uintptr_t)p.cur[j];
    p.table_out[2 * j] = sw ? cur : p.table_in[2 * j];
    p.table_out[2 * j + 1] = cur;
  } else if (t == 127) {
    o[kOutSwitch] = bits(sw);
    o[kOutEntropy] = d.h;
    o[kOutEntropyRatio] = d.ratio;
    o[kOutAccept] = bits(d.accept);
    o[kOutValidRatio] = r0[kLevelStats + kStatPlanes * M + kExtraRatio];
    o[kOutIsNan] = bits(d.kf_nan);
    o[kOutIsNan + 1] = bits(d.odo_nan);
    p.state_out[kStateHFirst] = d.H_first;
    p.state_out[kStateHasFirst] = bits(d.has_first);
  }
}

}  // namespace

// Frame k's step of the chunked keyframe scan in one launch of one CTA on
// `stream`, no host sync. lev: frame k's (2, L, S) level rows (S = 67 +
// 5 M + 3: csrc/linearize.cu's mode (b) row), lev_i its (2, L, 2)
// iterations and termination codes; state_in: carry slot k (kState*);
// table_in: (L, 2) slab pointers (keyframe, previous frame) a tracked
// level; force: one byte; cur: L device pointers (a host array) of frame
// k's tracked slabs; with_stats: copy the TrackStats planes into the row.
// Writes out (the packed row, kOut*), state_out (carry slot k + 1) and
// table_out (frame k + 1's table). Returns a CUDA error code (0: launched).
extern "C" int dvo_scan_step(
    const float* lev, const int* lev_i, int L, int M, const float* state_in,
    const int64_t* table_in, const uint8_t* force, const float* const* cur,
    float min_constraint_ratio, float min_entropy_ratio, int fuse_odometry,
    int use_initial_estimate, int with_stats, float* out, float* state_out,
    int64_t* table_out, void* stream) {
  if (L < 1 || L > kMaxLevels || M < 1 || !cur) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.lev = lev;
  p.lev_i = lev_i;
  p.L = L;
  p.M = M;
  p.S = kLevelStats + kStatPlanes * M + kExtraSize;
  p.state_in = state_in;
  p.table_in = table_in;
  p.force = force;
  for (int j = 0; j < L; ++j) p.cur[j] = cur[j];
  p.min_constraint_ratio = min_constraint_ratio;
  p.min_entropy_ratio = min_entropy_ratio;
  p.fuse = fuse_odometry;
  p.use_init = use_initial_estimate;
  p.with_stats = with_stats;
  p.out = out;
  p.state_out = state_out;
  p.table_out = table_out;
  scan_step_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
