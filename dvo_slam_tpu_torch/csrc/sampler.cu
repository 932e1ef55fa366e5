// Bilinear slab sampler for Hopper (sm_90a).
//
// Replaces the TPU kernel dvo_slam_tpu/ops/pallas/sampler.py::sample_slab
// (pl.pallas_call at line 413; bodies _sample_kernel_resident and
// _sample_kernel, shared tail _interp_and_store). That kernel evaluates the
// bilinear sample as MXU one-hot matmuls over row and column windows,
// because gathers are slow on a TPU. Hopper has fast cached gathers, so
// this is a direct 4-corner gather: no window, no window misses, no bf16
// slab layout, no 128-lane padding and no finiteness-mask channel.
//
// It computes exactly what dvo_slam_tpu/ops/linearize.py::_sample_gather
// computes, in the same order, for N warped points (u, v) and the first C
// planes of a (6, H, W) channel-major f32 slab:
//   u0f = floor(u), v0f = floor(v)
//   inb = u0f >= 0 && v0f >= 0 && u0f <= W-2 && v0f <= H-2
//   x0 = clip(u0f, 0, W-2), y0 = clip(v0f, 0, H-2)
//   fu = u - x0, fv = v - y0
//   top = s00 + fu*(s01-s00), bot = s10 + fu*(s11-s10), out = top + fv*(bot-top)
// NaNs in the slab propagate into out; the caller turns them into invalid
// points. The arithmetic uses the _rn intrinsics so nvcc does not contract
// it into FMAs: the result is bit-identical to the plain PyTorch version
// (ops/sampler.py::sample_slab_reference) on the same card, NaNs included.
//
// What bounds it on this card: latency. The slabs (1.8 MB at level 1) sit
// in the 50 MB L2; a point reads 8 B of u, v, gathers 4 corners x C
// channels (96 B at C = 6) and writes 4 C + 1 B, so the bytes bound is
// 0.08-1.3 us at levels 3-1 of 640x480, under the card's launch floor
// (~1.8 us for an empty kernel on a stream of launches, chip_smoke.py
// phase 12). What is left above the floor is rounds of memory latency.
//
// Design. An earlier version looped over a runtime C; its SASS (cuobjdump)
// unrolled the loop by four and issued each channel's four corner loads
// after the previous channel's lerps, and channels 5 and 6 in a remainder
// loop: at C = 6 some five rounds of L2 latency after the u, v loads,
// where one does. It also ran 256-thread blocks: 19 blocks on 132 SMs at
// level 3. This version:
//  * is a template on C (1..6), fully unrolled, every corner load written
//    ahead of the first lerp: at C <= 4 the SASS issues them all before
//    it; at C = 5 and 6 ptxas, holding the kernel to 32 registers, still
//    interleaves some with the lerps (~3 rounds, not 5);
//  * takes its block size from the caller (ops/sampler.py::block_threads:
//    256 threads, halved down to 64 while the grid gives the card's SMs
//    fewer than two blocks each), so levels 3 and 2 spread over the SMs;
//  * keeps one point a thread: the SASS shows the rounds came from the
//    channel loop, not from too few points in flight (level 1: 300 blocks
//    of 256), and the stores stay channel-major (C, N), coalesced a warp.
// The slab stays channel-major (C, H, W): the pyramid writes it and the
// level kernel reads it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 6;
constexpr int kMinThreads = 64, kMaxThreads = 256;

template <int C>
__global__ void __launch_bounds__(kMaxThreads)
sample_slab_kernel(const float* __restrict__ slab, int H, int W,
                   const float* __restrict__ u, const float* __restrict__ v,
                   int N, float* __restrict__ out, uint8_t* __restrict__ inb) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const float uu = __ldg(u + i);
  const float vv = __ldg(v + i);
  const float u0f = floorf(uu);
  const float v0f = floorf(vv);
  const float wmax = (float)(W - 2);
  const float hmax = (float)(H - 2);
  // Clamp in float BEFORE the int cast: (int)NaN and (int)1e9f are
  // undefined. A NaN or -huge coordinate fails ">= 0" and lands on 0, a
  // +huge one on the last valid corner, so every load stays in bounds.
  const float x0f = (u0f >= 0.f) ? fminf(u0f, wmax) : 0.f;
  const float y0f = (v0f >= 0.f) ? fminf(v0f, hmax) : 0.f;
  const int64_t plane = (int64_t)H * W;
  const float* p = slab + (int64_t)y0f * W + (int64_t)x0f;
  float s[C][4];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    s[c][0] = __ldg(p + c * plane);
    s[c][1] = __ldg(p + c * plane + 1);
    s[c][2] = __ldg(p + c * plane + W);
    s[c][3] = __ldg(p + c * plane + W + 1);
  }
  inb[i] = (u0f >= 0.f) && (v0f >= 0.f) && (u0f <= wmax) && (v0f <= hmax);
  const float fu = __fsub_rn(uu, x0f);
  const float fv = __fsub_rn(vv, y0f);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float top = __fadd_rn(s[c][0], __fmul_rn(fu, __fsub_rn(s[c][1], s[c][0])));
    const float bot = __fadd_rn(s[c][2], __fmul_rn(fu, __fsub_rn(s[c][3], s[c][2])));
    out[(int64_t)c * N + i] = __fadd_rn(top, __fmul_rn(fv, __fsub_rn(bot, top)));
  }
}

template <int C>
void launch(const float* slab, int H, int W, const float* u, const float* v, int N,
            float* out, uint8_t* inb, int threads, cudaStream_t stream) {
  sample_slab_kernel<C><<<(N + threads - 1) / threads, threads, 0, stream>>>(
      slab, H, W, u, v, N, out, inb);
}

// Does nothing: the launch floor that chip_smoke.py times beside the
// sampler and the pyramid (a call's device time on a stream of them).
__global__ void empty_kernel() {}

// For the scan step's ordering test: spins on %globaltimer until
// trigger_ns, triggers its programmatic dependents (as track_level_kernel
// does at its start), spins until spin_ns, then copies bytes0 from src0
// to dst0 and bytes1 from src1 to dst1 (4-byte words), so that a
// dependent that read them before its grid dependency wait would read
// what was there before.
__device__ __forceinline__ void spin_until(unsigned long long t0, long long ns) {
  unsigned long long t;
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while ((long long)(t - t0) < ns);
}

__global__ void late_copy_kernel(const int* src0, int* dst0, long long words0, const int* src1,
                                 int* dst1, long long words1, long long trigger_ns,
                                 long long spin_ns) {
  unsigned long long t0;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  spin_until(t0, trigger_ns);
  asm volatile("griddepcontrol.launch_dependents;");
  spin_until(t0, spin_ns);
  for (long long i = threadIdx.x; i < words0; i += blockDim.x) dst0[i] = src0[i];
  for (long long i = threadIdx.x; i < words1; i += blockDim.x) dst1[i] = src1[i];
}

}  // namespace

// slab: (>= C, H, W) f32 contiguous, 1 <= C <= 6; u, v: (N,) f32, N >= 1;
// out: (C, N) f32; inb: (N,) uint8; threads: the block size, a power of
// two in 64..256. Launches on `stream` and does not synchronize. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dvo_sample_slab(const float* slab, int C, int H, int W,
                               const float* u, const float* v, int N,
                               float* out, uint8_t* inb, int threads,
                               void* stream) {
  if (C < 1 || C > kMaxChannels || threads < kMinThreads || threads > kMaxThreads ||
      (threads & (threads - 1)) || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1: launch<1>(slab, H, W, u, v, N, out, inb, threads, s); break;
    case 2: launch<2>(slab, H, W, u, v, N, out, inb, threads, s); break;
    case 3: launch<3>(slab, H, W, u, v, N, out, inb, threads, s); break;
    case 4: launch<4>(slab, H, W, u, v, N, out, inb, threads, s); break;
    case 5: launch<5>(slab, H, W, u, v, N, out, inb, threads, s); break;
    default: launch<6>(slab, H, W, u, v, N, out, inb, threads, s); break;
  }
  return (int)cudaGetLastError();
}

// One launch of an empty kernel on `stream` (the launch floor).
extern "C" int dvo_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// One launch of late_copy_kernel (one CTA) on `stream`: bytes0 and bytes1
// multiples of 4, 0 <= trigger_ns <= spin_ns. A test's primary launch,
// never on the main path.
extern "C" int dvo_late_copy(const void* src0, void* dst0, int64_t bytes0, const void* src1,
                             void* dst1, int64_t bytes1, int64_t trigger_ns, int64_t spin_ns,
                             void* stream) {
  if (bytes0 % 4 || bytes1 % 4 || trigger_ns < 0 || spin_ns < trigger_ns)
    return (int)cudaErrorInvalidValue;
  late_copy_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(
      (const int*)src0, (int*)dst0, bytes0 / 4, (const int*)src1, (int*)dst1, bytes1 / 4,
      trigger_ns, spin_ns);
  return (int)cudaGetLastError();
}
