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
// Tiles. A CTA owns a tile of level 0, 32 columns by TY rows (32, or 40
// where that balances the SMs: ops/pyramid.py::tile_rows), and the
// matching (32 / 2^l) x (TY / 2^l) tile of every level l. It holds its
// level-0 tile with a halo of h = 2^(L-1) pixels on every side and
// downsamples in shared memory level by level; level l's buffer keeps a
// halo of h / 2^l pixels, one at the coarsest level, which is what the
// central differences read. So no CTA needs another's pixels and one launch
// writes every level. A pixel of level l + 1 reads only pixels of level l
// that exist, so the ragged edge of odd sizes needs nothing but the bounds
// test.
//
// Design for Hopper. An earlier version (32 x 32 tiles, 256 threads)
// filled level 0 with one scalar load an iteration, nine iterations a
// thread, each waiting on the last, and ran each level as fill, barrier,
// store. Its phase stamps (below) split its 10.8 us a CTA at
// 640x480, L = 4, f32 into the level-0 fill 4.70 us, the level-0 store
// 1.67, the downsample to level 1 1.44, then 0.35-0.71 a phase for the
// small levels; the barriers 0.03-0.17. So it waited on latency, not on
// bytes. This version:
//  * brings level 0 in by two (packed depth: three) TMA tile copies
//    (cp.async.bulk.tensor.2d) that one thread issues, completing on one
//    mbarrier: the whole halo tile in flight at once, the copy engine
//    computing the addresses and zero-filling what lies outside the image
//    (those cells are never read). Raw u8, u16 and packed inputs arrive as
//    bytes and are converted in shared memory with the scalar fill's
//    arithmetic, four cells a thread. The tensor maps are encoded on the
//    host (cuTensorMapEncodeTiled through the runtime's driver entry
//    point: no -lcuda) and passed in the __grid_constant__ parameters.
//    TMA needs a 16-B aligned base and rows of a 16-B multiple: other
//    inputs (642x482, 82x61, a view at an odd offset) take the scalar
//    fill, by the caller's choice (ops/pyramid.py::tma_fill), never after
//    a failure;
//  * is a template on L and TY, so every tile and buffer extent is a
//    constant: no division, the loops unrolled;
//  * runs each level as one phase, the downsample into the next level and
//    the level's store side by side (both only read level l), one barrier a
//    level;
//  * stores four pixels a thread as 16-B vectors where the level's width
//    and offset allow (at 640x480 every level with a 4-pixel-wide tile),
//    reading the quad's rows as 16-B loads where aligned, otherwise one
//    pixel a thread as before (coalesced along x either way);
//  * takes 40-row tiles where they leave the busiest SM less work: every
//    CTA is resident at once, and at 640x480 300 CTAs of 32 rows put 3 on
//    36 SMs, whose CTAs ran 21 % longer than those sharing an SM with one
//    other (the stamps' %smid); 240 CTAs of 40 rows put at most 2 on one.
//
// Bits. The plain version's arithmetic in its order, with the _rn
// intrinsics so that nvcc contracts nothing into an FMA: the 2x2 sums
// ((x00 + x01) + x10) + x11, the intensity's * 0.25, depth's total /
// max(count, 1) over the finite texels (NaN where none), 0.5 * (right -
// left) with one-sided differences at the borders (NaN neighbours
// propagate), raw ticks * fl(1 / 5000) (PyTorch divides a CUDA tensor by a
// host scalar as a product with its f32 reciprocal) and packed ticks *
// fl(16 / 5000). NaN is written as 0x7fc00000, as torch.full_like(.., nan).
// The slabs equal the plain version's on the card bit for bit, on both
// fill paths.
//
// What bounds it on this card: bytes. At 640x480 with four levels and f32
// inputs it reads 2.46 MB and writes 9.79 MB, 3.66 us at 3.35 TB/s; raw
// inputs read 0.92 (u8 + u16) or 0.77 MB (u8 + packed). What holds it
// above that (PERF.md): the card's launch floor (~1.8-2.0 us for an
// empty kernel on a stream of launches, chip_smoke.py phase 12), the TMA
// copy's latency (~1.1 us a CTA) with nothing to overlap it, and a chain
// of five short phases per CTA, each a round of shared-memory latency and
// a barrier; the raw inputs add their conversion (~0.6 us).
//
// The phase-timing buffer, when the caller passes one: per CTA (blockIdx.y
// * gridDim.x + blockIdx.x), kTimingSlots int64: %globaltimer (ns) at the
// CTA's start [0] and end [1]; clock64 at its start [2], when level 0 has
// arrived [3] and after the barrier that ends its conversion [4]; per level
// l, clock64 after the downsample into level l + 1 [5 + 3l], after its
// store [6 + 3l] and after the barrier [7 + 3l]; the SM it ran on [23].
// Thread 0 writes them. Null on the main path.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 6;
// A CTA's level-0 tile: kTile columns by kTile or kTallTile rows (the
// caller's choice, ops/pyramid.py::tile_rows; kTallTile for L <= 4).
constexpr int kTile = 32, kTallTile = 40;
constexpr int kTimingSlots = 24;
// Depth encodings (ops/pyramid.py _DEPTH_*) and level-0 fill paths
// (_FILL_*).
constexpr int kDepthF32 = 0, kDepthU16 = 1, kDepthPacked12 = 2;
constexpr int kFillScalar = 0, kFillTma = 1;

struct __align__(64) Params {
  CUtensorMap map_i;  // TMA fill: intensity (H, W) f32 or u8
  CUtensorMap map_z;  // TMA fill: depth (H, W) f32 or u16, or (H, 3 W / 2) u8
  const void* intensity;
  const void* depth;
  float* out;
  long long* timing;  // null, or (CTAs, kTimingSlots): phase stamps
  long long off[kMaxLevels];  // level l's slab offset in `out`, floats
  int i_u8, depth_kind;
  int H, W;
  int vec;           // bit l: level l's planes take 16-B stores
  float inv_scale;   // fl(1 / 5000): u16 ticks -> metres
  float tick_scale;  // fl(16 / 5000): packed 12-bit units -> metres
};

// Extents for L levels and TY-row tiles: the level-0 halo h, level 0's
// buffer Dy rows by Dx columns, level l's Dy >> l by Dx >> l (its pitch),
// and the shared memory offsets in bytes
// (every region 128-B aligned): [0, 128) the mbarrier, then per level the
// I and Z planes, then the raw staging: intensity bytes, then depth (u16,
// or two boxes of packed bytes).
//
// A TMA box's first column must lie on a 16-B boundary in global memory
// (on the card a box that did not faulted: an illegal instruction at the
// copy). Level 0's halo origin x = tx0 - h is a multiple of 16 B only where
// h is, so each box starts s elements left of it, s = -h mod (16 B / the
// element size), and lands s columns in: c0 (f32) in the level-0 buffers,
// whose pitch P covers c0 + Dx, s16 and s8 in the u16 and u8 staging, whose
// rows are P16 and P8 elements. Every pitch is a multiple of 16 B.
template <int L, int TY>
struct Shape {
  static_assert(TY % (1 << (L - 1)) == 0, "every level's tile rows are whole");
  static constexpr int threads = kTile / 4 * TY;  // one level-0 quad a thread
  static constexpr int h = 1 << (L - 1);
  static constexpr int Dx = kTile + 2 * h, Dy = TY + 2 * h;
  static constexpr int c0 = (4 - h % 4) % 4;
  static constexpr int P = (c0 + Dx + 15) / 16 * 16;
  static constexpr int s16 = (8 - h % 8) % 8;
  static constexpr int P16 = (s16 + Dx + 7) / 8 * 8;
  static constexpr int s8 = (16 - h % 16) % 16;
  static constexpr int P8 = (s8 + Dx + 15) / 16 * 16;
  __host__ __device__ static constexpr int pitch(int l) { return l == 0 ? P : Dx >> l; }
  __host__ __device__ static constexpr int up128(int b) { return (b + 127) / 128 * 128; }
  __host__ __device__ static constexpr int plane_bytes(int l) {
    return up128(4 * pitch(l) * (Dy >> l));
  }
  __host__ __device__ static constexpr int level_off(int l) {
    return l == 0 ? 128 : level_off(l - 1) + 2 * plane_bytes(l - 1);
  }
  static constexpr int stage_i = level_off(L);
  static constexpr int stage_z = stage_i + up128(P8 * Dy);
  static constexpr int bytes = stage_z + up128(2 * (P16 > P8 ? P16 : P8) * Dy);
};

__device__ __forceinline__ float nan32() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ long long* timing_row(const Params& p) {
  return p.timing + (int64_t)(blockIdx.y * gridDim.x + blockIdx.x) * kTimingSlots;
}

__device__ __forceinline__ void stamp(const Params& p, int slot) {
  if (p.timing != nullptr && threadIdx.x == 0) timing_row(p)[slot] = clock64();
}

__device__ __forceinline__ float tick_depth(float d, float scale) {
  return d > 0.f ? __fmul_rn(d, scale) : nan32();
}

// The 12-bit unit of level-0 pixel x from its two packed bytes: a = row[x]
// and b = row[W / 2 + x] (three planes of W / 2 bytes a row; the left half
// is p0 << 4 | p1 >> 4, the right (p1 & 0xF) << 8 | p2, and for x >= W / 2
// row[x] is p1 and row[W / 2 + x] is p2 of column x - W / 2).
__device__ __forceinline__ float packed_units(int a, int b, int x, int w2) {
  return (float)(x < w2 ? (a << 4) | (b >> 4) : ((a & 0xF) << 8) | b);
}

// Level-0 pixel (y, x) from global memory, converted (the scalar fill).
__device__ __forceinline__ float load_intensity(const Params& p, int y, int x) {
  const int64_t i = (int64_t)y * p.W + x;
  return p.i_u8 ? (float)static_cast<const uint8_t*>(p.intensity)[i]
                : static_cast<const float*>(p.intensity)[i];
}

__device__ __forceinline__ float load_depth(const Params& p, int y, int x) {
  if (p.depth_kind == kDepthF32)
    return static_cast<const float*>(p.depth)[(int64_t)y * p.W + x];
  if (p.depth_kind == kDepthU16)
    return tick_depth(
        (float)static_cast<const uint16_t*>(p.depth)[(int64_t)y * p.W + x],
        p.inv_scale);
  const int w2 = p.W / 2;
  const uint8_t* row = static_cast<const uint8_t*>(p.depth) + (int64_t)y * 3 * w2;
  return tick_depth(packed_units(row[x], row[w2 + x], x, w2), p.tick_scale);
}

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
         "r"(bar)
      : "memory");
}

// Level 0 into its I and Z buffers (pitch P, columns from ox - c0): by TMA
// or the scalar fill.
template <int L, int TY, int kFill>
__device__ __forceinline__ void fill_level0(const Params& p, unsigned char* smem, int oy,
                                            int ox) {
  using S = Shape<L, TY>;
  constexpr int P = S::P, Dx = S::Dx, Dy = S::Dy, c0 = S::c0, kThreads = S::threads;
  float* bi = reinterpret_cast<float*>(smem + S::level_off(0));
  float* bz = bi + S::plane_bytes(0) / 4;
  if constexpr (kFill == kFillTma) {
    constexpr int P8 = S::P8, P16 = S::P16, s8 = S::s8, s16 = S::s16;
    const uint32_t bar = smem_addr(smem);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    const bool packed = p.depth_kind == kDepthPacked12;
    unsigned char* si = smem + S::stage_i;
    unsigned char* sz = smem + S::stage_z;
    if (threadIdx.x == 0) {
      // A box counts its full bytes, the zero-filled ones included.
      const uint32_t bytes = (p.i_u8 ? P8 : 4 * P) * Dy +
                             (p.depth_kind == kDepthF32 ? 4 * P
                              : packed                  ? 2 * P8
                                                        : 2 * P16) * Dy;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(bar), "r"(bytes) : "memory");
      if (p.i_u8)
        tma_load(si, &p.map_i, ox - s8, oy, bar);
      else
        tma_load(bi, &p.map_i, ox - c0, oy, bar);
      if (p.depth_kind == kDepthF32) {
        tma_load(bz, &p.map_z, ox - c0, oy, bar);
      } else if (packed) {
        tma_load(sz, &p.map_z, ox - s8, oy, bar);
        tma_load(sz + P8 * Dy, &p.map_z, p.W / 2 + ox - s8, oy, bar);
      } else {
        tma_load(sz, &p.map_z, ox - s16, oy, bar);
      }
    }
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{ .reg .pred q; mbarrier.try_wait.parity.shared::cta.b64 q, [%1], 0;"
          " selp.u32 %0, 1, 0, q; }"
          : "=r"(done) : "r"(bar) : "memory");
    }
    stamp(p, 3);
    // The raw inputs' Dy x Dx cells into f32: four a thread (one 4- or 8-B
    // load, one 16-B store) where every offset is a multiple of 4 cells
    // (L >= 3), else one.
    if constexpr (c0 % 4 == 0 && s8 % 4 == 0 && s16 % 4 == 0) {
      constexpr int Q = Dx / 4;
      if (p.i_u8) {
#pragma unroll 3
        for (int c = threadIdx.x; c < Dy * Q; c += kThreads) {
          const int by = c / Q, bx = 4 * (c - by * Q);
          const uchar4 a = *reinterpret_cast<const uchar4*>(si + by * P8 + s8 + bx);
          *reinterpret_cast<float4*>(bi + by * P + c0 + bx) =
              make_float4((float)a.x, (float)a.y, (float)a.z, (float)a.w);
        }
      }
      if (p.depth_kind == kDepthU16) {
        const uint16_t* z16 = reinterpret_cast<const uint16_t*>(sz);
#pragma unroll 3
        for (int c = threadIdx.x; c < Dy * Q; c += kThreads) {
          const int by = c / Q, bx = 4 * (c - by * Q);
          const ushort4 a = *reinterpret_cast<const ushort4*>(z16 + by * P16 + s16 + bx);
          const float sc = p.inv_scale;
          *reinterpret_cast<float4*>(bz + by * P + c0 + bx) =
              make_float4(tick_depth((float)a.x, sc), tick_depth((float)a.y, sc),
                          tick_depth((float)a.z, sc), tick_depth((float)a.w, sc));
        }
      } else if (packed) {
        const int w2 = p.W / 2;
#pragma unroll 3
        for (int c = threadIdx.x; c < Dy * Q; c += kThreads) {
          const int by = c / Q, bx = 4 * (c - by * Q);
          const int k = by * P8 + s8 + bx, x = ox + bx;
          const uchar4 a = *reinterpret_cast<const uchar4*>(sz + k);
          const uchar4 b = *reinterpret_cast<const uchar4*>(sz + P8 * Dy + k);
          const float sc = p.tick_scale;
          *reinterpret_cast<float4*>(bz + by * P + c0 + bx) =
              make_float4(tick_depth(packed_units(a.x, b.x, x, w2), sc),
                          tick_depth(packed_units(a.y, b.y, x + 1, w2), sc),
                          tick_depth(packed_units(a.z, b.z, x + 2, w2), sc),
                          tick_depth(packed_units(a.w, b.w, x + 3, w2), sc));
        }
      }
    } else {
      if (p.i_u8) {
        for (int c = threadIdx.x; c < Dy * Dx; c += kThreads) {
          const int by = c / Dx, bx = c - by * Dx;
          bi[by * P + c0 + bx] = (float)si[by * P8 + s8 + bx];
        }
      }
      if (p.depth_kind == kDepthU16) {
        const uint16_t* z16 = reinterpret_cast<const uint16_t*>(sz);
        for (int c = threadIdx.x; c < Dy * Dx; c += kThreads) {
          const int by = c / Dx, bx = c - by * Dx;
          bz[by * P + c0 + bx] = tick_depth((float)z16[by * P16 + s16 + bx], p.inv_scale);
        }
      } else if (packed) {
        const int w2 = p.W / 2;
        for (int c = threadIdx.x; c < Dy * Dx; c += kThreads) {
          const int by = c / Dx, bx = c - by * Dx;
          const int k = by * P8 + s8 + bx;
          bz[by * P + c0 + bx] =
              tick_depth(packed_units(sz[k], sz[P8 * Dy + k], ox + bx, w2), p.tick_scale);
        }
      }
    }
  } else {
    // One pixel an iteration; cells outside the image are never read.
    for (int c = threadIdx.x; c < Dy * Dx; c += kThreads) {
      const int by = c / Dx, bx = c - by * Dx;
      const int y = oy + by, x = ox + bx;
      if (y < 0 || x < 0 || y >= p.H || x >= p.W) continue;
      bi[by * P + c0 + bx] = load_intensity(p, y, x);
      bz[by * P + c0 + bx] = load_depth(p, y, x);
    }
    stamp(p, 3);
  }
}

// Level l + 1's buffers from level l's (both in shared memory). Cells
// outside the image are never read.
template <int L, int TY, int l>
__device__ __forceinline__ void downsample(unsigned char* smem, int ty0, int tx0, int Hn,
                                           int Wn) {
  using S = Shape<L, TY>;
  constexpr int Du = S::pitch(l), Dnx = S::Dx >> (l + 1), Dny = S::Dy >> (l + 1);
  constexpr int hn = S::h >> (l + 1), cu = l == 0 ? S::c0 : 0;
  static_assert(Du % 2 == 0 && cu % 2 == 0, "8-B pair loads");
  const float* ui = reinterpret_cast<const float*>(smem + S::level_off(l));
  const float* uz = ui + S::plane_bytes(l) / 4;
  float* bi = reinterpret_cast<float*>(smem + S::level_off(l + 1));
  float* bz = bi + S::plane_bytes(l + 1) / 4;
  const int oy = (ty0 >> (l + 1)) - hn, ox = (tx0 >> (l + 1)) - hn;
#pragma unroll
  for (int c = threadIdx.x; c < Dny * Dnx; c += S::threads) {
    const int by = c / Dnx, bx = c - by * Dnx;
    const int y = oy + by, x = ox + bx;
    if (y < 0 || x < 0 || y >= Hn || x >= Wn) continue;
    // Pairs of adjacent cells as one 8-B load (Du and cu are even).
    const int u00 = (2 * by) * Du + cu + 2 * bx, u10 = u00 + Du;
    const float2 i0 = *reinterpret_cast<const float2*>(ui + u00);
    const float2 i1 = *reinterpret_cast<const float2*>(ui + u10);
    bi[c] = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(i0.x, i0.y), i1.x), i1.y), 0.25f);
    const float2 t0 = *reinterpret_cast<const float2*>(uz + u00);
    const float2 t1 = *reinterpret_cast<const float2*>(uz + u10);
    const float z00 = t0.x, z01 = t0.y, z10 = t1.x, z11 = t1.y;
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

__device__ __forceinline__ float half_diff(float hi, float lo) {
  return __fmul_rn(0.5f, __fsub_rn(hi, lo));
}

// Level l's tile pixels: I, Z and the central differences, from its
// buffer. Four pixels a thread as 16-B stores where p.vec allows it, else
// one pixel a thread.
template <int L, int TY, int l>
__device__ __forceinline__ void store_level(const Params& p, const unsigned char* smem,
                                            int ty0, int tx0, int Hl, int Wl) {
  using S = Shape<L, TY>;
  constexpr int pitch = S::pitch(l), hl = S::h >> l, tlx = kTile >> l, tly = TY >> l;
  const float* bi = reinterpret_cast<const float*>(smem + S::level_off(l));
  const float* bz = bi + S::plane_bytes(l) / 4;
  // The buffer's origin (level 0's columns start c0 further left).
  const int oy = (ty0 >> l) - hl, ox = (tx0 >> l) - hl - (l == 0 ? S::c0 : 0);
  const int64_t plane = (int64_t)Hl * Wl;
  float* o = p.out + p.off[l];
  if constexpr (tlx >= 4) {
    if (p.vec >> l & 1) {
      constexpr int quads = tlx / 4 * tly;
      if (threadIdx.x >= quads) return;
      const int jy = threadIdx.x / (tlx / 4), jx = 4 * (threadIdx.x % (tlx / 4));
      const int y = (ty0 >> l) + jy, x = (tx0 >> l) + jx;
      // Wl is a multiple of 4: a quad lies inside the image or outside it.
      if (y >= Hl || x >= Wl) return;
      const int k = (y - oy) * pitch + (x - ox);
      const int ku = y > 0 ? k - pitch : k, kd = y < Hl - 1 ? k + pitch : k;
      // The row from x - 1 to x + 4 (I in r, Z in q) and the rows above and
      // below; the quad's own cells as 16-B loads where k is a multiple of
      // 4 (every row, since the pitch is).
      float r[6], q[6], ui[4], uz[4], di[4], dz[4];
      r[0] = bi[k - 1];
      q[0] = bz[k - 1];
      r[5] = bi[k + 4];
      q[5] = bz[k + 4];
      if constexpr (pitch % 4 == 0 && (hl + (l == 0 ? S::c0 : 0)) % 4 == 0) {
        const float4 ci = *reinterpret_cast<const float4*>(bi + k);
        const float4 cz = *reinterpret_cast<const float4*>(bz + k);
        const float4 ai = *reinterpret_cast<const float4*>(bi + ku);
        const float4 az = *reinterpret_cast<const float4*>(bz + ku);
        const float4 bi4 = *reinterpret_cast<const float4*>(bi + kd);
        const float4 bz4 = *reinterpret_cast<const float4*>(bz + kd);
        r[1] = ci.x, r[2] = ci.y, r[3] = ci.z, r[4] = ci.w;
        q[1] = cz.x, q[2] = cz.y, q[3] = cz.z, q[4] = cz.w;
        ui[0] = ai.x, ui[1] = ai.y, ui[2] = ai.z, ui[3] = ai.w;
        uz[0] = az.x, uz[1] = az.y, uz[2] = az.z, uz[3] = az.w;
        di[0] = bi4.x, di[1] = bi4.y, di[2] = bi4.z, di[3] = bi4.w;
        dz[0] = bz4.x, dz[1] = bz4.y, dz[2] = bz4.z, dz[3] = bz4.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          r[j + 1] = bi[k + j];
          q[j + 1] = bz[k + j];
          ui[j] = bi[ku + j];
          uz[j] = bz[ku + j];
          di[j] = bi[kd + j];
          dz[j] = bz[kd + j];
        }
      }
      float4 gx_i, gx_z, gy_i, gy_z;
      float* gxi = &gx_i.x;
      float* gxz = &gx_z.x;
      float* gyi = &gy_i.x;
      float* gyz = &gy_z.x;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool left = x + j > 0, right = x + j < Wl - 1;
        gxi[j] = half_diff(right ? r[j + 2] : r[j + 1], left ? r[j] : r[j + 1]);
        gxz[j] = half_diff(right ? q[j + 2] : q[j + 1], left ? q[j] : q[j + 1]);
        gyi[j] = half_diff(di[j], ui[j]);
        gyz[j] = half_diff(dz[j], uz[j]);
      }
      float* dst = o + (int64_t)y * Wl + x;
      *reinterpret_cast<float4*>(dst) = make_float4(r[1], r[2], r[3], r[4]);
      *reinterpret_cast<float4*>(dst + plane) = make_float4(q[1], q[2], q[3], q[4]);
      *reinterpret_cast<float4*>(dst + 2 * plane) = gx_i;
      *reinterpret_cast<float4*>(dst + 3 * plane) = gy_i;
      *reinterpret_cast<float4*>(dst + 4 * plane) = gx_z;
      *reinterpret_cast<float4*>(dst + 5 * plane) = gy_z;
      return;
    }
  }
#pragma unroll
  for (int c = threadIdx.x; c < tlx * tly; c += S::threads) {
    const int jy = c / tlx, jx = c - jy * tlx;
    const int y = (ty0 >> l) + jy, x = (tx0 >> l) + jx;
    if (y >= Hl || x >= Wl) continue;
    const int k = (y - oy) * pitch + (x - ox);
    const int kl = (x > 0) ? k - 1 : k, kr = (x < Wl - 1) ? k + 1 : k;
    const int ku = (y > 0) ? k - pitch : k, kd = (y < Hl - 1) ? k + pitch : k;
    const int64_t q = (int64_t)y * Wl + x;
    o[q] = bi[k];
    o[plane + q] = bz[k];
    o[2 * plane + q] = half_diff(bi[kr], bi[kl]);
    o[3 * plane + q] = half_diff(bi[kd], bi[ku]);
    o[4 * plane + q] = half_diff(bz[kr], bz[kl]);
    o[5 * plane + q] = half_diff(bz[kd], bz[ku]);
  }
}

// Level l's phase: the downsample into level l + 1 and level l's store
// (both read level l only), then one barrier; the next level's phase after
// it. The downsample goes first: the store's 16-B writes then drain while
// the CTA waits at the barrier (0.2 us sooner a launch than store first,
// tests/torch_front_kernel_ab.py on the card).
template <int L, int TY, int l>
__device__ __forceinline__ void levels_from(const Params& p, unsigned char* smem, int ty0,
                                            int tx0) {
  const int Hl = p.H >> l, Wl = p.W >> l;
  if constexpr (l + 1 < L) downsample<L, TY, l>(smem, ty0, tx0, Hl >> 1, Wl >> 1);
  stamp(p, 5 + 3 * l);
  store_level<L, TY, l>(p, smem, ty0, tx0, Hl, Wl);
  stamp(p, 6 + 3 * l);
  if constexpr (l + 1 < L) {
    __syncthreads();
    stamp(p, 7 + 3 * l);
    levels_from<L, TY, l + 1>(p, smem, ty0, tx0);
  } else {
    stamp(p, 7 + 3 * l);
  }
}

template <int L, int TY, int kFill>
__global__ void __launch_bounds__(Shape<L, TY>::threads)
    pyramid_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ty0 = blockIdx.y * TY, tx0 = blockIdx.x * kTile;
  if (p.timing != nullptr && threadIdx.x == 0) {
    unsigned int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    timing_row(p)[0] = (long long)global_ns();
    timing_row(p)[kTimingSlots - 1] = sm;
  }
  stamp(p, 2);
  fill_level0<L, TY, kFill>(p, smem, ty0 - Shape<L, TY>::h, tx0 - Shape<L, TY>::h);
  __syncthreads();
  stamp(p, 4);
  levels_from<L, TY, 0>(p, smem, ty0, tx0);
  if (p.timing != nullptr && threadIdx.x == 0) timing_row(p)[1] = (long long)global_ns();
}

// cuTensorMapEncodeTiled's signature (CUDA 12.0), called through the
// driver entry point so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                     cudaEnableDefault, &q);
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 2-D map of a (rows, cols) row-major input with `row_bytes` a row, its
// boxes box_rows rows of box_cols elements; cells outside the input read
// as zero.
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rows,
            int cols, int row_bytes, int box_cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* ptr, long long row_bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && row_bytes % 16 == 0;
}

template <int L, int TY, int kFill>
int launch(Params p, cudaStream_t stream) {
  using S = Shape<L, TY>;
  if constexpr (kFill == kFillTma) {
    // Row-major maps of both inputs, boxes of Dy rows of P (f32), P16 (u16)
    // or P8 (u8) elements; cells outside an input read as zero.
    const bool packed = p.depth_kind == kDepthPacked12;
    const int z_cols = packed ? 3 * (p.W / 2) : p.W;
    const int z_size = p.depth_kind == kDepthF32 ? 4 : p.depth_kind == kDepthU16 ? 2 : 1;
    const CUtensorMapDataType z_type =
        p.depth_kind == kDepthF32   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
        : p.depth_kind == kDepthU16 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                    : CU_TENSOR_MAP_DATA_TYPE_UINT8;
    const int z_box = p.depth_kind == kDepthF32 ? S::P : packed ? S::P8 : S::P16;
    if (!encode(&p.map_i, p.i_u8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                p.intensity, p.H, p.W, p.W * (p.i_u8 ? 1 : 4), p.i_u8 ? S::P8 : S::P,
                S::Dy) ||
        !encode(&p.map_z, z_type, p.depth, p.H, z_cols, z_cols * z_size, z_box, S::Dy))
      return (int)cudaErrorNotSupported;
  }
  // The shared-memory limit is set once a card and instantiation.
  static bool set[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !set[dev]) {
    e = cudaFuncSetAttribute(pyramid_kernel<L, TY, kFill>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S::bytes);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) set[dev] = true;
  }
  const dim3 grid((p.W + kTile - 1) / kTile, (p.H + TY - 1) / TY, 1);
  pyramid_kernel<L, TY, kFill><<<grid, S::threads, S::bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int kFill>
int launch_levels(const Params& p, int L, int tile_rows, cudaStream_t stream) {
  if (tile_rows == kTallTile) {
    switch (L) {
      case 1: return launch<1, kTallTile, kFill>(p, stream);
      case 2: return launch<2, kTallTile, kFill>(p, stream);
      case 3: return launch<3, kTallTile, kFill>(p, stream);
      default: return launch<4, kTallTile, kFill>(p, stream);
    }
  }
  switch (L) {
    case 1: return launch<1, kTile, kFill>(p, stream);
    case 2: return launch<2, kTile, kFill>(p, stream);
    case 3: return launch<3, kTile, kFill>(p, stream);
    case 4: return launch<4, kTile, kFill>(p, stream);
    case 5: return launch<5, kTile, kFill>(p, stream);
    default: return launch<6, kTile, kFill>(p, stream);
  }
}

}  // namespace

// Every level of the pyramid of one frame in one launch on `stream`, no
// host sync. intensity: (H, W) f32 or u8 (i_u8); depth: (H, W) f32 or u16,
// or (H, 3 W / 2) u8 12-bit packed (depth_kind 0 / 1 / 2); num_levels in
// 1..6, every level at least 1x1; out: the levels' slabs one after the
// other, 16-B aligned. inv_scale, tick_scale: the f32 factors of the raw
// encodings. tile_rows: kTile, or kTallTile with up to 4 levels. fill:
// kFillTma (both inputs 16-B aligned with rows of a 16-B multiple;
// refused otherwise) or kFillScalar. timing: null, or the phase-timing
// buffer (CTAs x kTimingSlots int64). Returns a CUDA error
// code (0: launched).
extern "C" int dvo_pyramid(const void* intensity, int i_u8, const void* depth,
                           int depth_kind, int H, int W, int num_levels,
                           float inv_scale, float tick_scale, float* out,
                           int tile_rows, int fill, long long* timing, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || (H >> (num_levels - 1)) < 1 ||
      (W >> (num_levels - 1)) < 1 || depth_kind < kDepthF32 ||
      depth_kind > kDepthPacked12 || (depth_kind == kDepthPacked12 && W % 2) ||
      (fill != kFillScalar && fill != kFillTma) ||
      (tile_rows != kTile && (tile_rows != kTallTile || num_levels > 4)) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.intensity = intensity;
  p.depth = depth;
  p.i_u8 = i_u8;
  p.depth_kind = depth_kind;
  p.H = H;
  p.W = W;
  p.inv_scale = inv_scale;
  p.tick_scale = tick_scale;
  p.out = out;
  p.timing = timing;
  p.vec = 0;
  long long off = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    p.off[l] = off;
    if (l < num_levels) {
      const int Wl = W >> l;
      if ((kTile >> l) >= 4 && Wl % 4 == 0 && off % 4 == 0) p.vec |= 1 << l;
      off += 6LL * (H >> l) * Wl;
    }
  }
  if (fill == kFillTma) {
    const long long z_row = depth_kind == kDepthPacked12 ? 3LL * (W / 2)
                            : depth_kind == kDepthU16    ? 2LL * W
                                                         : 4LL * W;
    if (!aligned16(intensity, (long long)W * (i_u8 ? 1 : 4)) || !aligned16(depth, z_row))
      return (int)cudaErrorInvalidValue;
    return launch_levels<kFillTma>(p, num_levels, tile_rows, (cudaStream_t)stream);
  }
  return launch_levels<kFillScalar>(p, num_levels, tile_rows, (cudaStream_t)stream);
}
