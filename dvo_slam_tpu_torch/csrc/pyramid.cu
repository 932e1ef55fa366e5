// The RGB-D image pyramid for Hopper (sm_90a): every level's (6, H_l, W_l)
// f32 slab [I, Z, dI/dx, dI/dy, dZ/dx, dZ/dy] in one launch.
//
// What it replaces. No Pallas kernel: the frame's pyramid, which XLA fused
// into the frame's one program on the TPU (dvo_slam_tpu/ops/pyramid.py::
// build_pyramid, :87-115, with unpack_depth12, :175, and convert_raw_depth,
// :118). The plain PyTorch version is ops/pyramid.py::
// build_pyramid_reference, about 130 eager ops at four levels.
//
// Inputs: level 0's intensity, f32 or u8 (H, W); depth, f32 metres (NaN
// invalid), u16 raw ticks (5000 a metre, 0 invalid) or 12-bit-packed u8
// (H, 3 W / 2) ticks. Output: one f32 allocation holding the levels one
// after the other, level l's slab at offset 6 * sum_{k<l} H_k W_k, H_{l+1} =
// floor(H_l / 2) (a trailing odd row or column is dropped at each
// downsample, as XLA's "VALID" reduce_window drops it).
//
// Design. A CTA owns a T x T tile of level 0 (T = max(32, 2^(L-1))) and the
// matching (T / 2^l)^2 tile of every level l. It loads its level-0 tile with
// a halo of h = 2^(L-1) pixels on every side, converting the raw inputs as
// it reads them, and downsamples in shared memory level by level; level l's
// buffer keeps a halo of h / 2^l pixels, one at the coarsest level, which is
// what the central differences read. So no CTA needs another's pixels and
// one launch writes every level. A pixel of level l + 1 reads only pixels of
// level l that exist, so the ragged edge of odd sizes needs nothing but the
// bounds test. The halo costs (T + 2h)^2 / T^2 level-0 loads (2.25x at T =
// 32, L = 4), served from L2.
//
// Bits. The plain version's arithmetic in its order, with the _rn
// intrinsics so that nvcc contracts nothing into an FMA: the 2x2 sums
// ((x00 + x01) + x10) + x11, the intensity's * 0.25, depth's total /
// max(count, 1) over the finite texels (NaN where none), 0.5 * (right -
// left) with one-sided differences at the borders (NaN neighbours
// propagate), raw ticks * fl(1 / 5000) (PyTorch divides a CUDA tensor by a
// host scalar as a product with its f32 reciprocal) and packed ticks *
// fl(16 / 5000). NaN is written as 0x7fc00000, as torch.full_like(.., nan).
// The slabs equal the plain version's on the card bit for bit.
//
// What bounds it on this card: bytes. At 640x480 with four levels and f32
// inputs it reads 2.46 MB and writes 9.79 MB, 3.66 us at 3.35 TB/s; raw
// inputs read 0.92 (u8 + u16) or 0.77 MB (u8 + packed). 300 CTAs of 256
// threads at 640x480 fill the card's 132 SMs about twice.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 6;
constexpr int kMinTile = 32;
// Depth encodings (ops/pyramid.py _DEPTH_*).
constexpr int kDepthF32 = 0, kDepthU16 = 1, kDepthPacked12 = 2;

struct Params {
  const void* intensity;  // (H, W) f32, or u8 with i_u8
  const void* depth;      // (H, W) f32 or u16, or (H, 3 W / 2) u8 packed
  int i_u8, depth_kind;
  int H, W, L, T;
  float inv_scale;   // fl(1 / 5000): u16 ticks -> metres
  float tick_scale;  // fl(16 / 5000): packed 12-bit units -> metres
  float* out;
};

__device__ __forceinline__ float nan32() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float load_intensity(const Params& p, int64_t i) {
  return p.i_u8 ? (float)static_cast<const uint8_t*>(p.intensity)[i]
                : static_cast<const float*>(p.intensity)[i];
}

// Level-0 depth of pixel (y, x), converted from its encoding.
__device__ __forceinline__ float load_depth(const Params& p, int y, int x) {
  if (p.depth_kind == kDepthF32)
    return static_cast<const float*>(p.depth)[(int64_t)y * p.W + x];
  if (p.depth_kind == kDepthU16) {
    const float d = (float)static_cast<const uint16_t*>(p.depth)[(int64_t)y * p.W + x];
    return d > 0.f ? __fmul_rn(d, p.inv_scale) : nan32();
  }
  // Three planes of W / 2 bytes a row: a = p0 << 4 | p1 >> 4 for the left
  // half, b = (p1 & 0xF) << 8 | p2 for the right.
  const int w2 = p.W / 2;
  const uint8_t* row = static_cast<const uint8_t*>(p.depth) + (int64_t)y * 3 * w2;
  int q;
  if (x < w2) {
    q = ((int)row[x] << 4) | ((int)row[w2 + x] >> 4);
  } else {
    const int c = x - w2;
    q = (((int)row[w2 + c] & 0xF) << 8) | (int)row[2 * w2 + c];
  }
  const float qf = (float)q;
  return qf > 0.f ? __fmul_rn(qf, p.tick_scale) : nan32();
}

__global__ void __launch_bounds__(kThreads) pyramid_kernel(Params p) {
  extern __shared__ float smem[];
  const int L = p.L, T = p.T, h = 1 << (L - 1);
  // Level 0's tile origin.
  const int ty0 = blockIdx.y * T, tx0 = blockIdx.x * T;

  float* buf[kMaxLevels];  // per level: I plane, then Z plane, D_l^2 each
  {
    float* b = smem;
    for (int l = 0; l < L; ++l) {
      const int D = (T + 2 * h) >> l;
      buf[l] = b;
      b += 2 * D * D;
    }
  }

  int64_t off = 0;  // level l's slab offset in the output
  int Hl = p.H, Wl = p.W;
  for (int l = 0; l < L; ++l) {
    const int D = (T + 2 * h) >> l, hl = h >> l, tl = T >> l;
    const int oy = (ty0 >> l) - hl, ox = (tx0 >> l) - hl;  // buffer origin
    float* bi = buf[l];
    float* bz = buf[l] + D * D;
    // Fill level l's buffer: level 0 from the inputs, the others from the
    // level above. Cells outside the image are never read.
    for (int c = threadIdx.x; c < D * D; c += kThreads) {
      const int by = c / D, bx = c - by * D;
      const int y = oy + by, x = ox + bx;
      if (y < 0 || x < 0 || y >= Hl || x >= Wl) continue;
      if (l == 0) {
        bi[c] = load_intensity(p, (int64_t)y * p.W + x);
        bz[c] = load_depth(p, y, x);
      } else {
        const int Du = D * 2;
        const float* ui = buf[l - 1];
        const float* uz = buf[l - 1] + Du * Du;
        const int u00 = (2 * by) * Du + 2 * bx, u01 = u00 + 1;
        const int u10 = u00 + Du, u11 = u10 + 1;
        bi[c] = __fmul_rn(
            __fadd_rn(__fadd_rn(__fadd_rn(ui[u00], ui[u01]), ui[u10]), ui[u11]), 0.25f);
        const float z00 = uz[u00], z01 = uz[u01], z10 = uz[u10], z11 = uz[u11];
        const bool f00 = isfinite(z00), f01 = isfinite(z01);
        const bool f10 = isfinite(z10), f11 = isfinite(z11);
        const float total = __fadd_rn(
            __fadd_rn(__fadd_rn(f00 ? z00 : 0.f, f01 ? z01 : 0.f), f10 ? z10 : 0.f),
            f11 ? z11 : 0.f);
        const float count = __fadd_rn(
            __fadd_rn(__fadd_rn(f00 ? 1.f : 0.f, f01 ? 1.f : 0.f), f10 ? 1.f : 0.f),
            f11 ? 1.f : 0.f);
        bz[c] = count > 0.f ? __fdiv_rn(total, fmaxf(count, 1.f)) : nan32();
      }
    }
    __syncthreads();
    // Write the tile's pixels of level l: I, Z and the central differences.
    const int64_t plane = (int64_t)Hl * Wl;
    float* o = p.out + off;
    for (int c = threadIdx.x; c < tl * tl; c += kThreads) {
      const int jy = c / tl, jx = c - jy * tl;
      const int y = (ty0 >> l) + jy, x = (tx0 >> l) + jx;
      if (y >= Hl || x >= Wl) continue;
      const int by = y - oy, bx = x - ox;
      const int k = by * D + bx;
      const int kl = (x > 0) ? k - 1 : k, kr = (x < Wl - 1) ? k + 1 : k;
      const int ku = (y > 0) ? k - D : k, kd = (y < Hl - 1) ? k + D : k;
      const int64_t q = (int64_t)y * Wl + x;
      o[q] = bi[k];
      o[plane + q] = bz[k];
      o[2 * plane + q] = __fmul_rn(0.5f, __fsub_rn(bi[kr], bi[kl]));
      o[3 * plane + q] = __fmul_rn(0.5f, __fsub_rn(bi[kd], bi[ku]));
      o[4 * plane + q] = __fmul_rn(0.5f, __fsub_rn(bz[kr], bz[kl]));
      o[5 * plane + q] = __fmul_rn(0.5f, __fsub_rn(bz[kd], bz[ku]));
    }
    off += 6 * plane;
    Hl /= 2;
    Wl /= 2;
  }
}

size_t smem_bytes(int L, int T) {
  size_t floats = 0;
  const int h = 1 << (L - 1);
  for (int l = 0; l < L; ++l) {
    const size_t D = (size_t)((T + 2 * h) >> l);
    floats += 2 * D * D;
  }
  return floats * sizeof(float);
}

}  // namespace

// Every level of the pyramid of one frame in one launch on `stream`, no
// host sync. intensity: (H, W) f32 or u8 (i_u8); depth: (H, W) f32 or u16,
// or (H, 3 W / 2) u8 12-bit packed (depth_kind 0 / 1 / 2); num_levels in
// 1..6, every level at least 1x1; out: the levels' slabs one after the
// other. inv_scale, tick_scale: the f32 factors of the raw encodings.
// Returns a CUDA error code (0: launched).
extern "C" int dvo_pyramid(const void* intensity, int i_u8, const void* depth,
                           int depth_kind, int H, int W, int num_levels,
                           float inv_scale, float tick_scale, float* out,
                           void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || (H >> (num_levels - 1)) < 1 ||
      (W >> (num_levels - 1)) < 1 || depth_kind < kDepthF32 ||
      depth_kind > kDepthPacked12 || (depth_kind == kDepthPacked12 && W % 2))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.intensity = intensity;
  p.depth = depth;
  p.i_u8 = i_u8;
  p.depth_kind = depth_kind;
  p.H = H;
  p.W = W;
  p.L = num_levels;
  p.T = (1 << (num_levels - 1)) > kMinTile ? (1 << (num_levels - 1)) : kMinTile;
  p.inv_scale = inv_scale;
  p.tick_scale = tick_scale;
  p.out = out;
  const size_t dyn = smem_bytes(num_levels, p.T);
  cudaError_t e = cudaFuncSetAttribute(pyramid_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + p.T - 1) / p.T, (H + p.T - 1) / p.T, 1);
  pyramid_kernel<<<grid, kThreads, dyn, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
