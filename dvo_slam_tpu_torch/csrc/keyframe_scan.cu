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
// PyTorch's order: the tests hold the fused pose to 1e-5. log and exp use
// the accurate acosf and sincosf (no fast-math intrinsics).
//
// What bounds it on this card: about 1 KB read and written (11 KB with the
// statistics) and a serial chain of about a thousand flops: the launch
// floor (~2 us for an empty kernel on a stream of launches) and the
// chain's latency. The design (PERF.md §6 has the phase split):
// - One CTA of four warps: warp 0 decides, warps 1-3 copy. Each loads its
//   inputs in one round (warp 0 into shared memory), every load in flight
//   at once, none waiting on another's value; no barrier joins the warps.
// - A programmatic dependent launch: dvo_scan_step launches with
//   cudaLaunchAttributeProgrammaticStreamSerialization, and
//   track_level_kernel (csrc/linearize.cu) triggers its dependents at its
//   start, so the step's CTA is resident, on one of the SMs the finest
//   level's launch leaves free, while that launch runs. Before the grid
//   dependency wait (griddepcontrol.wait, cudaGridDependencySynchronize)
//   the kernel reads only what was complete before the level launch
//   began: carry slot k, table k and force[k] (written by step k - 1 and
//   the chunk's upload) and the slab pointers (parameters); it writes
//   nothing before the wait (a caller's launch just before the step may
//   write the same row). Every read of the level rows and of lev_i comes
//   after the wait. No other launch of the port is
//   programmatic, so the trigger changes nothing elsewhere; the launch
//   after the step (the next frame's pyramid) is a plain launch and waits
//   for the step to end.
// - The decision chain on warp 0, in registers (no local stack frame):
//   the finite checks are warp votes; T_alt, T_alt T_a^-1 and exp(delta)
//   T_a an entry a lane, each summed over k in the plain matmul's order;
//   the scalar parts of log and exp on every lane alike; the 6x6 system a
//   row a lane (7 registers): the pivot search over shuffled values with
//   the first-maximum rule (a strictly larger |a| wins), rows swapped by
//   shuffles, IEEE division, back substitution from registers.
// - The copy warps copy the fields that need no decision meanwhile, and
//   with the statistics a (plane, row) run of M floats each, a batch of
//   loads in flight a lane (scalar: a row's planes start 67 + 50 q floats
//   in and the packed row is 1 391 floats wide at the defaults, so source
//   and destination rarely share a 16-B phase).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxLevels = 6;
// Mode (b)'s row (csrc/linearize.cu kLevel*, kBest*, kExtra*).
constexpr int kLevelT = 0, kLevelLoglik = 16, kLevelBest = 17, kLevelStats = 67;
constexpr int kStatPlanes = 5, kExtraEntropy = 1, kExtraRatio = 2, kExtraSize = 3;
// A row's head, staged whole: T, the log-likelihood and the information.
constexpr int kHead = kLevelBest + 36;
static_assert(kLevelT == 0 && kLevelLoglik == 16 && kLevelBest == 17,
              "the head is T, the log-likelihood, then the information");
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
// The phase-timing buffer (ops/scan_step.py timing_buffer / phase_times):
// %globaltimer (ns) at the start [0] and end [1]; clock64 at the start
// [2], when the grid dependency wait returned [3], when the inputs had
// landed [4], after the finite checks [5], T_alt [6], the fusion's log
// [7], its elimination [8], its exp and product [9], the decided writes
// [10] (warp 0) and warp 1's copies [11], and at the end [12]. Thread 0
// writes them but [11] (thread 32). Null on the main path.
constexpr int kTimingSlots = 13;
// Warp 0's loads before the wait (carry slot, table, force) and after it
// (two heads, the entropy and valid ratio), and the rounds of them a lane
// issues; the copy warps' fields that need no decision (two poses, two
// informations; then 2 L iterations, and with stats 2 L termination codes)
// and the rounds of them a thread issues.
constexpr int kPreLoads = kStateSize + 2 * kMaxLevels + 1;
constexpr int kPostLoads = 2 * kHead + 2;
constexpr int kPreRounds = (kPreLoads + 31) / 32;
constexpr int kPostRounds = (kPostLoads + 31) / 32;
constexpr int kCopyFields = 32 + 72;
constexpr int kCopyRounds = (kCopyFields + 4 * kMaxLevels + kThreads - 33) / (kThreads - 32);
// Floats a lane of the statistics copy loads before it stores them.
constexpr int kCopyBatch = 8;

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
  long long* timing;  // null, or kTimingSlots int64: phase stamps
};

// Warp 0's inputs, staged in shared memory by one round of loads.
struct Staged {
  float head[2][kHead];  // keyframe row, previous-frame row
  float h, vr;           // the keyframe row's entropy and valid ratio
  float state[kStateSize];
  long long table[2 * kMaxLevels];
  int force;
};

__device__ __forceinline__ float bits(int x) { return __int_as_float(x); }

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void stamp(const Params& p, int slot) {
  if (p.timing != nullptr) p.timing[slot] = clock64();
}

// Entry n of an array the compiler holds in registers, for a lane's own n:
// a chain of selects over the static indices (an index into the array
// itself would put it in local memory).
template <int N>
__device__ __forceinline__ float pick(const float (&a)[N], int n) {
  float x = a[0];
#pragma unroll
  for (int i = 1; i < N; ++i) x = n == i ? a[i] : x;
  return x;
}

// W @ W for W = hat(w).
__device__ __forceinline__ void hat2(const float* w, float* W, float* W2) {
  W[0] = 0.f;   W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];  W[4] = 0.f;   W[5] = -w[0];
  W[6] = -w[1]; W[7] = w[0];  W[8] = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[3 * i + j] = W[3 * i] * W[j] + W[3 * i + 1] * W[3 + j] + W[3 * i + 2] * W[6 + j];
}

// ops/se3.py::log (with log_so3): the twist (v, w) of T, its small-angle
// branches parameterized by u = 1 - cos(theta) as there.
__device__ __forceinline__ void log_se3(const float (&T)[16], float (&xi)[6]) {
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
  float sin_t, cos_t;
  sincosf(theta, &sin_t, &cos_t);
  const float coef = small ? 1.f / 12.f + theta_sq / 720.f
                           : 1.f / theta_sq - (1.f + cos_t) / (2.f * theta * sin_t);
  float W[9], W2[9];
  hat2(w, W, W2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float Vinv = (i == j ? 1.f : 0.f) - 0.5f * W[3 * i + j] + coef * W2[3 * i + j];
      v += Vinv * T[4 * j + 3];
    }
    xi[i] = v;
    xi[3 + i] = w[i];
  }
}

// ops/se3.py::exp: (v, w) -> T, Taylor-safe coefficients as there.
__device__ __forceinline__ void exp_se3(const float (&xi)[6], float (&T)[16]) {
  const float w[3] = {xi[3], xi[4], xi[5]};
  const float theta_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool small = theta_sq < 1e-8f;
  const float safe_sq = small ? 1.f : theta_sq;
  const float safe_t = sqrtf(safe_sq);
  float sin_t, cos_t;
  sincosf(safe_t, &sin_t, &cos_t);
  const float a = small ? 1.f - theta_sq / 6.f : sin_t / safe_t;
  const float b = small ? 0.5f - theta_sq / 24.f : (1.f - cos_t) / safe_sq;
  const float c = small ? 1.f / 6.f - theta_sq / 120.f : (safe_t - sin_t) / (safe_sq * safe_t);
  float W[9], W2[9];
  hat2(w, W, W2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float t = 0.f;
#pragma unroll
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

// Entry e = 4 i + j of A @ B for a 4x4 A held an entry a lane (lane e
// holds A[e]) and B in shared memory: sum over k in the plain order.
__device__ __forceinline__ float lanes_matmul(float a, const float* B, int i, int j) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) s += __shfl_sync(kFull, a, 4 * i + k) * B[4 * k + j];
  return s;
}

// The fusion (ops/scan_step.py::fuse_relative_poses) on warp 0: one
// Gauss-Newton step from T_a (shared) towards T_b (lane e holds T_b[e])
// weighted by the two informations (shared); a non-finite step (a singular
// information sum) is dropped. Returns lane e's entry of the fused pose
// (lanes 16-31 repeat lanes 0-15).
__device__ __forceinline__ float fuse(const Params& p, const float* T_a, const float* info_a,
                                      float T_b, const float* info_b, int lane) {
  const int e = lane & 15, i = e >> 2, j = e & 3;
  // ops/se3.py::inverse, an entry a lane: [R^T, -R^T t; 0 0 0 1].
  const float inv = i == 3 ? (j == 3 ? 1.f : 0.f)
                    : j == 3 ? -(T_a[i] * T_a[3] + T_a[4 + i] * T_a[7] + T_a[8 + i] * T_a[11])
                             : T_a[4 * j + i];
  // D = T_b @ inv, summed over k in the plain order.
  float d = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    d += __shfl_sync(kFull, T_b, 4 * i + k) * __shfl_sync(kFull, inv, 4 * k + j);
  float D[16], xi[6];
#pragma unroll
  for (int k = 0; k < 16; ++k) D[k] = __shfl_sync(kFull, d, k);
  log_se3(D, xi);
  if (lane == 0) stamp(p, 7);
  // Lane r holds row r of [info_a + info_b | info_b @ xi] (lanes 6-31 a
  // copy of row 5, never read).
  const int r = lane < 6 ? lane : 5;
  float A[7];
  float rhs = 0.f;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    A[c] = info_a[6 * r + c] + info_b[6 * r + c];
    rhs += info_b[6 * r + c] * xi[c];
  }
  A[6] = rhs;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    // The first row of the largest |a| at or below the diagonal: a
    // strictly larger |a| wins (a NaN never does), as the plain loop.
    int piv = c;
    float best = fabsf(__shfl_sync(kFull, A[c], c));
#pragma unroll
    for (int q = c + 1; q < 6; ++q) {
      const float v = fabsf(__shfl_sync(kFull, A[c], q));
      if (v > best) {
        best = v;
        piv = q;
      }
    }
    if (piv != c) {
      const int from = lane == c ? piv : lane == piv ? c : lane;
#pragma unroll
      for (int k = c; k < 7; ++k) A[k] = __shfl_sync(kFull, A[k], from);
    }
    float prow[7];
#pragma unroll
    for (int k = c; k < 7; ++k) prow[k] = __shfl_sync(kFull, A[k], c);
    if (lane > c) {
      const float f = A[c] / prow[c];
#pragma unroll
      for (int k = c; k < 7; ++k) A[k] -= f * prow[k];
    }
  }
  if (lane == 0) stamp(p, 8);
  float delta[6];
  bool good = true;
#pragma unroll
  for (int q = 5; q >= 0; --q) {
    float s = A[6];
#pragma unroll
    for (int k = q + 1; k < 6; ++k) s -= A[k] * delta[k];
    delta[q] = __shfl_sync(kFull, s / A[q], q);
    good = good && isfinite(delta[q]);
  }
  if (!good) {
#pragma unroll
    for (int q = 0; q < 6; ++q) delta[q] = 0.f;
  }
  float E[16];
  exp_se3(delta, E);
  return lanes_matmul(pick(E, e), T_a, i, j);
}

// The statistics planes valid, error, delta_norm, accepted of every level
// row: a run of M floats a (plane, row), the runs dealt over the copy warps
// 1..kWarps-1, the accepted plane as int32 bits of x != 0. Each lane walks
// its share (its run's elements lane, lane + 32, ..., then the warp's next
// run) kCopyBatch floats at a time, every load of a batch in flight before
// its stores; no division or modulo per element.
__device__ void copy_stats(const Params& p, int warp, int lane) {
  const int L = p.L, M = p.M, rows = 2 * L, runs = 4 * rows;
  if (lane >= M) return;
  const int step = kWarps - 1;
  float* st = p.out + kOutIterations + 2 * L;
  int run = warp - 1, it = lane;
  const float* src = nullptr;
  float* dst = nullptr;
  bool flags = false;
  auto locate = [&]() {
    if (run >= runs) return;
    const int q = run / rows, bl = run - q * rows;
    src = p.lev + (int64_t)bl * p.S + kLevelStats + q * M;
    dst = st + q * rows * M + bl * M;
    flags = q == 3;
  };
  locate();
  while (run < runs) {
    float v[kCopyBatch];
    float* d[kCopyBatch];
    bool f[kCopyBatch];
#pragma unroll
    for (int b = 0; b < kCopyBatch; ++b) {
      d[b] = nullptr;
      if (run < runs) {
        v[b] = __ldcg(src + it);
        d[b] = dst + it;
        f[b] = flags;
        it += 32;
        if (it >= M) {
          it = lane;
          run += step;
          locate();
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kCopyBatch; ++b)
      if (d[b] != nullptr) *d[b] = f[b] ? bits(v[b] != 0.f) : v[b];
  }
}

// Load n of the round before the wait (64-bit: table entries are).
__device__ __forceinline__ unsigned long long pre_load(const Params& p, int n) {
  if (n < kStateSize) return __float_as_uint(__ldcg(p.state_in + n));
  n -= kStateSize;
  if (n < 2 * p.L) return (unsigned long long)__ldcg((const long long*)p.table_in + n);
  return n == 2 * p.L ? (unsigned long long)p.force[0] : 0ull;
}

__device__ __forceinline__ void pre_store(Staged& s, const Params& p, int n,
                                          unsigned long long v) {
  if (n < kStateSize) {
    s.state[n] = __uint_as_float((unsigned)v);
    return;
  }
  n -= kStateSize;
  if (n < 2 * p.L) s.table[n] = (long long)v;
  else if (n == 2 * p.L) s.force = (int)v;
}

// Load n of the round after the wait: the two heads, the keyframe row's
// entropy and valid ratio.
__device__ __forceinline__ float post_load(const Params& p, int n) {
  const float* r0 = p.lev + (int64_t)(p.L - 1) * p.S;
  const float* r1 = p.lev + (int64_t)(2 * p.L - 1) * p.S;
  if (n < kHead) return __ldcg(r0 + n);
  if (n < 2 * kHead) return __ldcg(r1 + n - kHead);
  const float* extra0 = r0 + kLevelStats + kStatPlanes * p.M;
  if (n == 2 * kHead) return __ldcg(extra0 + kExtraEntropy);
  return n == 2 * kHead + 1 ? __ldcg(extra0 + kExtraRatio) : 0.f;
}

__device__ __forceinline__ void post_store(Staged& s, int n, float v) {
  if (n < 2 * kHead) (&s.head[0][0])[n] = v;
  else if (n == 2 * kHead) s.h = v;
  else if (n == 2 * kHead + 1) s.vr = v;
}

// The copy warps' field i (kCopyFields, then the iterations and, with
// stats, the termination codes): its source (an int32 read as its float
// bits) and its place in the packed row.
__device__ __forceinline__ const float* copy_src(const Params& p, int i) {
  const float* r0 = p.lev + (int64_t)(p.L - 1) * p.S;
  const float* r1 = p.lev + (int64_t)(2 * p.L - 1) * p.S;
  if (i < 16) return r0 + kLevelT + i;
  if (i < 32) return r1 + kLevelT + i - 16;
  if (i < 68) return r0 + kLevelBest + i - 32;
  if (i < kCopyFields) return r1 + kLevelBest + i - 68;
  i -= kCopyFields;
  const int* code = i < 2 * p.L ? p.lev_i + 2 * i : p.lev_i + 2 * (i - 2 * p.L) + 1;
  return reinterpret_cast<const float*>(code);
}

__device__ __forceinline__ float* copy_dst(const Params& p, int i) {
  float* o = p.out;
  if (i < 16) return o + kOutTKfMeas + i;
  if (i < 32) return o + kOutTOdoMeas + i - 16;
  if (i < kCopyFields) return o + kOutInfoPair + i - 32;
  i -= kCopyFields;
  // The termination codes follow the iterations and the four (2, L, M)
  // planes.
  return o + kOutIterations + i + (i < 2 * p.L ? 0 : 8 * p.L * p.M);
}

// Warp 0: the decisions (module comment) and their writes.
__device__ void decide(const Params& p, const Staged& s, int lane) {
  const int e = lane & 15;
  const float* T0 = s.head[0] + kLevelT;
  const float* T1 = s.head[1] + kLevelT;
  const float* Tkp = s.state + kStateTKfPrev;
  const float H_prev = s.state[kStateHFirst];
  const bool has_prev = __float_as_int(s.state[kStateHasFirst]) != 0;

  const bool kf_nan = !__all_sync(kFull, lane < 16 ? isfinite(T0[lane])
                                         : lane == 16 ? isfinite(s.head[0][kLevelLoglik])
                                                      : true);
  const bool odo_nan = !__all_sync(kFull, lane < 16 ? isfinite(T1[lane])
                                          : lane == 16 ? isfinite(s.head[1][kLevelLoglik])
                                                       : true);
  if (lane == 0) stamp(p, 5);
  const float last_odo = odo_nan ? s.state[kStateLastOdo + e] : T1[e];

  const bool accept = !kf_nan && s.vr >= p.min_constraint_ratio;
  const float h = s.h;
  // The sign-safe ratio: torch.clamp keeps a NaN, as the branch does.
  const float ref = has_prev ? H_prev : h;
  const float mag = fabsf(ref);
  const float den = mag < kEntropyFloor ? kEntropyFloor : mag;
  const float raw = __fsub_rn(1.f, __fdiv_rn(__fsub_rn(h, ref), den));
  const bool ok = isfinite(h) && isfinite(ref);
  const float er = has_prev ? (ok ? raw : -INFINITY) : 1.f;
  const float ratio = accept ? er : 1.f;
  const bool sw = s.force != 0 || !accept || ratio < p.min_entropy_ratio;

  // T_alt = T1 @ T_kf_prev, an entry a lane, in the plain order.
  const int i4 = e >> 2, j4 = e & 3;
  float T_alt = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) T_alt += T1[4 * i4 + k] * Tkp[4 * k + j4];
  if (lane == 0) stamp(p, 6);
  float T_kf_cur = T0[e];
  if (p.fuse && !odo_nan) {
    T_kf_cur = fuse(p, T0, s.head[0] + kLevelBest, T_alt, s.head[1] + kLevelBest, lane);
  } else if (lane == 0) {
    stamp(p, 7);
    stamp(p, 8);
  }
  if (lane == 0) stamp(p, 9);
  const float Z = accept ? T0[e] : (odo_nan ? Tkp[e] : T_alt);

  const bool set_first = accept && !has_prev && isfinite(h);
  const float H_first = set_first ? h : H_prev;
  const bool has_first = has_prev || set_first;

  float* o = p.out;
  if (lane < 16) {
    const float I = (e % 5 == 0) ? 1.f : 0.f;
    const float T_kf_prev = sw ? I : T_kf_cur;
    o[kOutRelPose + e] = T_kf_prev;
    o[kOutZSwitch + e] = Z;
    p.state_out[kStateTKfPrev + e] = T_kf_prev;
    p.state_out[kStateOdoInit + e] = p.use_init ? last_odo : I;
    p.state_out[kStateLastOdo + e] = last_odo;
  }
  for (int i = lane; i < 36; i += 32) {
    const float I = (i % 7 == 0) ? kFallbackInformation : 0.f;
    o[kOutInfoSwitch + i] = accept ? s.head[0][kLevelBest + i]
                                   : (odo_nan ? I : s.head[1][kLevelBest + i]);
  }
  if (lane < p.L) {
    const int64_t cur = (int64_t)(uintptr_t)(lane == 0   ? p.cur[0]
                                             : lane == 1 ? p.cur[1]
                                             : lane == 2 ? p.cur[2]
                                             : lane == 3 ? p.cur[3]
                                             : lane == 4 ? p.cur[4]
                                                         : p.cur[5]);
    p.table_out[2 * lane] = sw ? cur : s.table[2 * lane];
    p.table_out[2 * lane + 1] = cur;
  }
  if (lane == 0) {
    o[kOutSwitch] = bits(sw);
    o[kOutEntropy] = h;
    o[kOutEntropyRatio] = ratio;
    o[kOutAccept] = bits(accept);
    o[kOutValidRatio] = s.vr;
    o[kOutIsNan] = bits(kf_nan);
    o[kOutIsNan + 1] = bits(odo_nan);
    p.state_out[kStateHFirst] = sw ? 0.f : H_first;
    p.state_out[kStateHasFirst] = bits(has_first && !sw);
  }
  __syncwarp();
  if (lane == 0) stamp(p, 10);
}

__global__ void __launch_bounds__(kThreads) scan_step_kernel(Params p) {
  __shared__ Staged s;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (p.timing != nullptr && t == 0) {
    p.timing[0] = (long long)global_ns();
    stamp(p, 2);
  }
  if (warp == 0) {
    // Before the wait: what step k - 1 and the upload wrote (in flight
    // through the wait).
    unsigned long long pre[kPreRounds];
#pragma unroll
    for (int u = 0; u < kPreRounds; ++u) pre[u] = pre_load(p, lane + 32 * u);
    // cudaGridDependencySynchronize(): the finest level's launch has ended
    // and its writes are visible.
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (lane == 0) stamp(p, 3);
    float post[kPostRounds];
#pragma unroll
    for (int u = 0; u < kPostRounds; ++u) post[u] = post_load(p, lane + 32 * u);
#pragma unroll
    for (int u = 0; u < kPreRounds; ++u) pre_store(s, p, lane + 32 * u, pre[u]);
#pragma unroll
    for (int u = 0; u < kPostRounds; ++u) post_store(s, lane + 32 * u, post[u]);
    __syncwarp();
    if (lane == 0) stamp(p, 4);
    decide(p, s, lane);
  } else {
    // The copy warps: the fields that need no decision, then the
    // statistics.
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const int n = kCopyFields + 2 * p.L * (p.with_stats ? 2 : 1);
    float v[kCopyRounds];
#pragma unroll
    for (int u = 0; u < kCopyRounds; ++u) {
      const int i = t - 32 + (kThreads - 32) * u;
      v[u] = i < n ? __ldcg(copy_src(p, i)) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kCopyRounds; ++u) {
      const int i = t - 32 + (kThreads - 32) * u;
      if (i < n) *copy_dst(p, i) = v[u];
    }
    if (p.with_stats) copy_stats(p, warp, lane);
    if (p.timing != nullptr) {
      __syncwarp();
      if (t == 32) stamp(p, 11);
    }
  }
  if (p.timing != nullptr) {
    __syncthreads();
    if (t == 0) {
      stamp(p, 12);
      p.timing[1] = (long long)global_ns();
    }
  }
}

}  // namespace

// Frame k's step of the chunked keyframe scan in one launch of one CTA on
// `stream`, no host sync, launched as a programmatic dependent of the
// launch before it on the stream (module comment). lev: frame k's (2, L,
// S) level rows (S = 67 + 5 M + 3: csrc/linearize.cu's mode (b) row),
// lev_i its (2, L, 2) iterations and termination codes; state_in: carry
// slot k (kState*); table_in: (L, 2) slab pointers (keyframe, previous
// frame) a tracked level; force: one byte; cur: L device pointers (a host
// array) of frame k's tracked slabs; with_stats: copy the TrackStats
// planes into the row. Writes out (the packed row, kOut*), state_out
// (carry slot k + 1) and table_out (frame k + 1's table). timing: null, or
// kTimingSlots int64 (the phase stamps). Returns a CUDA error code (0:
// launched); a refused attributed launch is returned as it is, never
// retried as a plain launch.
extern "C" int dvo_scan_step(
    const float* lev, const int* lev_i, int L, int M, const float* state_in,
    const int64_t* table_in, const uint8_t* force, const float* const* cur,
    float min_constraint_ratio, float min_entropy_ratio, int fuse_odometry,
    int use_initial_estimate, int with_stats, float* out, float* state_out,
    int64_t* table_out, long long* timing, void* stream) {
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
  p.timing = timing;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, scan_step_kernel, p);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}
