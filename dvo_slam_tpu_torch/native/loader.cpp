// Native host runtime: PNG decode + prefetching RGB-D dataset loader.
//
// The PyTorch port's copy of dvo_slam_tpu/native/loader.cpp (same code and
// C ABI; only this comment differs). Equivalent of the reference's host
// I/O stack (SURVEY.md B1/R1): OpenCV imread + cv_bridge conversion +
// SurfacePyramid::convertRawDepthImage (dvo_core/src/core/surface_pyramid.cpp).
// The decoder implements the PNG subset the TUM RGB-D dataset uses (8-bit
// gray/RGB/RGBA for rgb frames, 16-bit big-endian grayscale for depth;
// non-interlaced), inflating IDAT with zlib and converting directly into
// the framework's canonical arrays:
//   rgb   -> float32 grayscale intensity in [0, 255]   (0.299 R + 0.587 G + 0.114 B)
//   depth -> float32 meters (raw u16 / 5000), 0 -> NaN
// A background prefetch thread decodes ahead of the device so PNG decode
// overlaps GPU compute (the reference's ROS message pipeline gave it the
// same overlap for free). dvo_slam_tpu_torch/utils/png.py is its plain
// version in numpy.
//
// Exposed as a C ABI for ctypes; built at first use by native/__init__.py.

#include <zlib.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int width = 0;
  int height = 0;
  int channels = 0;   // 1, 3, or 4
  int bit_depth = 0;  // 8 or 16
  std::vector<uint8_t> data;  // raw scanline bytes (big-endian for 16-bit)
};

uint32_t read_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  // fopen accepts directories on Linux; ftell then returns -1 or garbage.
  // A bogus size must become a clean error, not a 2^64-byte resize whose
  // bad_alloc would escape the C ABI and terminate the process.
  if (n < 0 || n > (1L << 31)) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out.resize(size_t(n));
  size_t got = std::fread(out.data(), 1, size_t(n), f);
  std::fclose(f);
  return got == size_t(n);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode a non-interlaced PNG. Returns false on unsupported/corrupt input.
bool decode_png(const std::vector<uint8_t>& file, Image& img,
                std::string& err) {
  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (file.size() < 8 || std::memcmp(file.data(), magic, 8) != 0) {
    err = "not a png";
    return false;
  }
  size_t pos = 8;
  std::vector<uint8_t> idat;
  int color_type = -1, interlace = -1;
  while (pos + 8 <= file.size()) {
    uint32_t len = read_be32(&file[pos]);
    if (pos + 12 + len > file.size()) break;
    const uint8_t* type = &file[pos + 4];
    const uint8_t* payload = &file[pos + 8];
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len < 13) { err = "truncated IHDR"; return false; }
      img.width = int(read_be32(payload));
      img.height = int(read_be32(payload + 4));
      img.bit_depth = payload[8];
      color_type = payload[9];
      interlace = payload[12];
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (img.width <= 0 || img.height <= 0) { err = "bad IHDR"; return false; }
  // IHDR dims are UNTRUSTED input driving allocations below: a crafted
  // header (e.g. 2^30 x 2^30) must become a clean error, not a bad_alloc
  // escaping the C ABI (std::terminate) or a size_t overflow in
  // (stride+1)*height that under-allocates the inflate buffer. 2^15 per
  // side admits any camera frame and keeps all products well inside 64
  // bits; the raw-size cap below bounds the worst allocation at ~8.6 GB
  // -> rejected long before resize for anything non-degenerate.
  if (img.width > (1 << 15) || img.height > (1 << 15)) {
    err = "implausible dimensions";
    return false;
  }
  if (interlace != 0) { err = "interlaced png unsupported"; return false; }
  switch (color_type) {
    case 0: img.channels = 1; break;  // grayscale
    case 2: img.channels = 3; break;  // RGB
    case 6: img.channels = 4; break;  // RGBA
    default:
      err = "unsupported color type " + std::to_string(color_type);
      return false;
  }
  if (img.bit_depth != 8 && img.bit_depth != 16) {
    err = "unsupported bit depth";
    return false;
  }

  const int bytes_per_px = img.channels * img.bit_depth / 8;
  const size_t stride = size_t(img.width) * bytes_per_px;
  const size_t raw_size = (stride + 1) * size_t(img.height);
  // Degenerate-but-in-cap headers (32k x 32k RGBA16) still describe ~8.6
  // GB; our frames are camera-sized. Reject before allocating.
  if (raw_size > (size_t(1) << 30)) {
    err = "implausible image size";
    return false;
  }
  std::vector<uint8_t> raw(raw_size);

  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) { err = "inflateInit failed"; return false; }
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  int zret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zret != Z_STREAM_END) { err = "inflate failed"; return false; }

  // Unfilter scanlines in place into img.data.
  img.data.resize(stride * size_t(img.height));
  const int bpp = bytes_per_px;
  for (int y = 0; y < img.height; ++y) {
    const uint8_t filter = raw[(stride + 1) * size_t(y)];
    const uint8_t* src = &raw[(stride + 1) * size_t(y) + 1];
    uint8_t* dst = &img.data[stride * size_t(y)];
    const uint8_t* prev = y > 0 ? &img.data[stride * size_t(y - 1)] : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:  // Sub
        for (size_t x = 0; x < stride; ++x)
          dst[x] = uint8_t(src[x] + (x >= size_t(bpp) ? dst[x - bpp] : 0));
        break;
      case 2:  // Up
        for (size_t x = 0; x < stride; ++x)
          dst[x] = uint8_t(src[x] + (prev ? prev[x] : 0));
        break;
      case 3:  // Average
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          dst[x] = uint8_t(src[x] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= size_t(bpp) ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          int c = (prev && x >= size_t(bpp)) ? prev[x - bpp] : 0;
          dst[x] = uint8_t(src[x] + paeth(a, b, c));
        }
        break;
      default:
        err = "bad filter byte";
        return false;
    }
  }
  return true;
}

// rgb png -> float32 grayscale intensity [0,255]
bool decode_intensity(const char* path, float* out, int expect_w,
                      int expect_h, std::string& err) {
  std::vector<uint8_t> file;
  if (!read_file(path, file)) { err = "cannot read file"; return false; }
  Image img;
  if (!decode_png(file, img, err)) return false;
  if (img.width != expect_w || img.height != expect_h) {
    err = "unexpected size";
    return false;
  }
  const size_t n = size_t(img.width) * img.height;
  if (img.bit_depth != 8) { err = "rgb must be 8-bit"; return false; }
  const uint8_t* p = img.data.data();
  if (img.channels == 1) {
    for (size_t i = 0; i < n; ++i) out[i] = float(p[i]);
  } else {
    const int c = img.channels;
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* px = p + i * c;
      out[i] = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
    }
  }
  return true;
}

// depth png (16-bit gray, units of 1/scale meters) -> float32 meters, 0->NaN
bool decode_depth(const char* path, float* out, int expect_w, int expect_h,
                  float scale, std::string& err) {
  std::vector<uint8_t> file;
  if (!read_file(path, file)) { err = "cannot read file"; return false; }
  Image img;
  if (!decode_png(file, img, err)) return false;
  if (img.width != expect_w || img.height != expect_h) {
    err = "unexpected size";
    return false;
  }
  if (img.channels != 1 || img.bit_depth != 16) {
    err = "depth must be 16-bit grayscale";
    return false;
  }
  const size_t n = size_t(img.width) * img.height;
  const uint8_t* p = img.data.data();
  const float inv = 1.0f / scale;
  for (size_t i = 0; i < n; ++i) {
    uint16_t v = uint16_t((p[2 * i] << 8) | p[2 * i + 1]);  // big-endian
    out[i] = v ? float(v) * inv : std::nanf("");
  }
  return true;
}

// ---------------------------------------------------------------------------
// Prefetching loader: a background thread decodes frame pairs ahead.
// ---------------------------------------------------------------------------

struct Frame {
  std::vector<float> intensity;
  std::vector<float> depth;
  int index = -1;
  bool ok = false;
  std::string err;
};

struct Loader {
  std::vector<std::string> rgb_paths;
  std::vector<std::string> depth_paths;
  int width = 0, height = 0;
  float depth_scale = 5000.0f;
  size_t queue_capacity = 4;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::deque<Frame> queue;
  std::atomic<bool> stop{false};
  // Set ONLY after the final frame has been pushed: the consumer's wait
  // predicate must not race with the gap between "last index consumed by
  // the decoder" and "last frame actually enqueued".
  std::atomic<bool> done{false};
  size_t next_decode = 0;

  void run() {
    while (!stop.load()) {
      if (next_decode >= rgb_paths.size()) break;
      Frame f;
      f.index = int(next_decode);
      const size_t n = size_t(width) * height;
      std::string err1, err2;
      // Exceptions (bad_alloc under memory pressure — including from the
      // frame-buffer resizes) must not escape the decode thread:
      // std::terminate would take the whole process down on one bad
      // frame. Failed frames are skipped like decode errors.
      try {
        f.intensity.resize(n);
        f.depth.resize(n);
        bool ok1 = decode_intensity(rgb_paths[next_decode].c_str(),
                                    f.intensity.data(), width, height, err1);
        bool ok2 = decode_depth(depth_paths[next_decode].c_str(),
                                f.depth.data(), width, height, depth_scale,
                                err2);
        f.ok = ok1 && ok2;
        if (!f.ok) f.err = err1.empty() ? err2 : err1;
      } catch (const std::exception& e) {
        f.ok = false;
        f.err = e.what();
      }
      ++next_decode;
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return queue.size() < queue_capacity || stop.load(); });
      if (stop.load()) break;
      queue.push_back(std::move(f));
      cv_pop.notify_one();
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      done.store(true);
    }
    cv_pop.notify_all();
  }
};

}  // namespace

extern "C" {

// One-shot decoders (thread-safe, no state). All entry points catch — a C
// ABI boundary an exception crosses is std::terminate, so one corrupt
// frame from a ctypes caller must never take the process down.
int dvo_decode_intensity(const char* path, float* out, int width, int height) {
  std::string err;
  try {
    if (decode_intensity(path, out, width, height, err)) return 0;
  } catch (const std::exception& e) {
    err = e.what();
  }
  std::fprintf(stderr, "dvo_decode_intensity(%s): %s\n", path, err.c_str());
  return -1;
}

int dvo_decode_depth(const char* path, float* out, int width, int height,
                     float scale) {
  std::string err;
  try {
    if (decode_depth(path, out, width, height, scale, err)) return 0;
  } catch (const std::exception& e) {
    err = e.what();
  }
  std::fprintf(stderr, "dvo_decode_depth(%s): %s\n", path, err.c_str());
  return -1;
}

// Probe a PNG's dimensions without full decode.
int dvo_png_size(const char* path, int* width, int* height) {
  try {
    static const uint8_t kMagic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    std::vector<uint8_t> file;
    if (!read_file(path, file) || file.size() < 33) return -1;
    if (std::memcmp(file.data(), kMagic, 8) != 0) return -1;
    if (read_be32(&file[12]) != 0x49484452 /* "IHDR" */) return -1;
    uint32_t w = read_be32(&file[16]);
    uint32_t h = read_be32(&file[20]);
    // A corrupt IHDR must fail here, not as a multi-GB allocation (or a
    // negative-dimension numpy array) in the caller: cap at 1 GPx total,
    // far above any RGB-D sensor.
    if (w == 0 || h == 0 || w > (1u << 20) || h > (1u << 20) ||
        uint64_t(w) * uint64_t(h) > (1ull << 30)) {
      return -1;
    }
    *width = int(w);
    *height = int(h);
    return 0;
  } catch (const std::exception&) {
    return -1;
  }
}

void* dvo_loader_create(const char** rgb_paths, const char** depth_paths,
                        int count, int width, int height, float depth_scale,
                        int prefetch) try {
  Loader* L = new Loader();
  L->rgb_paths.assign(rgb_paths, rgb_paths + count);
  L->depth_paths.assign(depth_paths, depth_paths + count);
  L->width = width;
  L->height = height;
  L->depth_scale = depth_scale;
  L->queue_capacity = size_t(prefetch > 0 ? prefetch : 4);
  L->worker = std::thread([L] { L->run(); });
  return L;
} catch (const std::exception&) {
  return nullptr;
}

// Blocks until the next frame is decoded. Returns the frame index, or -1 at
// end of sequence, or -2 on decode error (skipped frame).
int dvo_loader_next(void* handle, float* intensity_out, float* depth_out) {
  Loader* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_pop.wait(lk, [&] { return !L->queue.empty() || L->done.load(); });
  if (L->queue.empty()) return -1;
  Frame f = std::move(L->queue.front());
  L->queue.pop_front();
  L->cv_push.notify_one();
  lk.unlock();
  if (!f.ok) {
    std::fprintf(stderr, "dvo_loader_next: frame %d failed: %s\n", f.index,
                 f.err.c_str());
    return -2;
  }
  const size_t n = size_t(L->width) * L->height;
  std::memcpy(intensity_out, f.intensity.data(), n * sizeof(float));
  std::memcpy(depth_out, f.depth.data(), n * sizeof(float));
  return f.index;
}

void dvo_loader_destroy(void* handle) {
  Loader* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_push.notify_all();
  L->cv_pop.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

}  // extern "C"
