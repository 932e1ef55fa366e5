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
// it into FMAs: the result is then bit-identical to the plain PyTorch
// version (ops/sampler.py::sample_slab_reference) on the same card.
//
// What bounds it on this card: gather latency. The level-1 slab
// (6 x 320 x 240 x 4 B ~ 1.8 MB) stays in the 50 MB L2; each point reads
// 4 corners x C channels (96 B at C = 6) through L1/L2, reads 8 B of u, v
// and writes 4*C + 1 B. Design: one thread per point, 256 threads a block,
// read-only (__ldg) corner loads, channel-major (C, N) output so the
// stores of a warp are coalesced. Faster layouts (point-major (H, W, 8)
// for two 16 B corner loads, or fusing the sample into the residual pass)
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(256)
sample_slab_kernel(const float* __restrict__ slab, int C, int H, int W,
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
  inb[i] = (u0f >= 0.f) && (v0f >= 0.f) && (u0f <= wmax) && (v0f <= hmax);
  // Clamp in float BEFORE the int cast: (int)NaN and (int)1e9f are
  // undefined. A NaN or -huge coordinate fails ">= 0" and lands on 0, a
  // +huge one on the last valid corner, so every load stays in bounds.
  const float x0f = (u0f >= 0.f) ? fminf(u0f, wmax) : 0.f;
  const float y0f = (v0f >= 0.f) ? fminf(v0f, hmax) : 0.f;
  const float fu = __fsub_rn(uu, x0f);
  const float fv = __fsub_rn(vv, y0f);
  const int64_t plane = (int64_t)H * W;
  const float* p = slab + (int64_t)y0f * W + (int64_t)x0f;
  for (int c = 0; c < C; ++c, p += plane) {
    const float s00 = __ldg(p);
    const float s01 = __ldg(p + 1);
    const float s10 = __ldg(p + W);
    const float s11 = __ldg(p + W + 1);
    const float top = __fadd_rn(s00, __fmul_rn(fu, __fsub_rn(s01, s00)));
    const float bot = __fadd_rn(s10, __fmul_rn(fu, __fsub_rn(s11, s10)));
    out[(int64_t)c * N + i] = __fadd_rn(top, __fmul_rn(fv, __fsub_rn(bot, top)));
  }
}

}  // namespace

// slab: (>= C, H, W) f32 contiguous; u, v: (N,) f32; out: (C, N) f32;
// inb: (N,) uint8. Launches on `stream` and does not synchronize. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int dvo_sample_slab(const float* slab, int C, int H, int W,
                               const float* u, const float* v, int N,
                               float* out, uint8_t* inb, void* stream) {
  const int threads = 256;
  const int blocks = (N + threads - 1) / threads;
  sample_slab_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      slab, C, H, W, u, v, N, out, inb);
  return (int)cudaGetLastError();
}
