// coloc_tpu native data loader.
//
// Reference parity: the reference's ingest path is host-side C++ — OpenCV
// imread on the GPU path (GPUDetector.hpp:161) and OpenMVG ReadImage on the
// CPU path, driven synchronously per frame by DiskInterface
// (InterfaceDisk.hpp:11-33). This loader keeps ingest native but adds what
// the reference lacks: an asynchronous prefetcher, so image decode overlaps
// device compute (the TPU-side analog of the reference's CPU/GPU stream
// overlap, SURVEY.md §2.2).
//
// Formats: PGM (P5, 8-bit) and PNG (8-bit grayscale / RGB / RGBA / palette-
// free, via zlib inflate + full filter reconstruction). Output is always
// float32 grayscale in [0, 255].
//
// C ABI (ctypes-friendly):
//   void* coloc_loader_open(const char* folder, int num_drones,
//                           int num_frames, int height, int width,
//                           int prefetch_depth, int num_threads);
//   int   coloc_loader_get(void* handle, int drone, int frame, float* out);
//   void  coloc_loader_close(void* handle);
//   int   coloc_decode_image(const char* path, float* out, int h, int w);
//
// Build: make -C coloc_tpu/native   (produces libcoloc_loader.so)

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <condition_variable>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Image decoding
// ---------------------------------------------------------------------------

bool read_file(const std::string& path, std::vector<uint8_t>& out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  return got == out.size();
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Decode an 8-bit PNG into float32 grayscale. Returns false on any
// unsupported feature (interlace, 16-bit, palette).
bool decode_png(const std::vector<uint8_t>& buf, float* out, int oh, int ow) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', 0x0d, 0x0a, 0x1a, 0x0a};
  if (buf.size() < 8 || std::memcmp(buf.data(), kSig, 8) != 0) return false;

  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;

  size_t off = 8;
  while (off + 8 <= buf.size()) {
    uint32_t len = be32(&buf[off]);
    const char* type = reinterpret_cast<const char*>(&buf[off + 4]);
    const uint8_t* data = &buf[off + 8];
    if (off + 12 + len > buf.size()) return false;
    if (!std::memcmp(type, "IHDR", 4)) {
      w = be32(data);
      h = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    off += 12 + len;
  }
  if (w == 0 || h == 0 || bit_depth != 8 || interlace != 0) return false;
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;  // gray
    case 2: channels = 3; break;  // rgb
    case 4: channels = 2; break;  // gray+alpha
    case 6: channels = 4; break;  // rgba
    default: return false;        // palette unsupported
  }
  if (static_cast<int>(h) != oh || static_cast<int>(w) != ow) return false;

  const size_t stride = static_cast<size_t>(w) * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
    return false;

  std::vector<uint8_t> prev(stride, 0), cur(stride);
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* src = &raw[y * (stride + 1)];
    uint8_t filter = src[0];
    const uint8_t* line = src + 1;
    for (size_t x = 0; x < stride; ++x) {
      int a = (x >= static_cast<size_t>(channels)) ? cur[x - channels] : 0;
      int b = prev[x];
      int c = (x >= static_cast<size_t>(channels)) ? prev[x - channels] : 0;
      int v = line[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      cur[x] = static_cast<uint8_t>(v & 0xff);
    }
    float* dst = out + static_cast<size_t>(y) * w;
    for (uint32_t x = 0; x < w; ++x) {
      const uint8_t* px = &cur[x * channels];
      float g;
      if (channels == 1 || channels == 2) {
        g = px[0];
      } else {
        // ITU-R BT.601 luma
        g = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
      }
      dst[x] = g;
    }
    std::swap(prev, cur);
  }
  return true;
}

bool decode_pgm(const std::vector<uint8_t>& buf, float* out, int oh, int ow) {
  if (buf.size() < 2 || buf[0] != 'P' || buf[1] != '5') return false;
  size_t pos = 2;
  auto skip_ws = [&]() {
    while (pos < buf.size()) {
      if (buf[pos] == '#') {
        while (pos < buf.size() && buf[pos] != '\n') ++pos;
      } else if (std::isspace(buf[pos])) {
        ++pos;
      } else {
        break;
      }
    }
  };
  auto read_int = [&]() {
    skip_ws();
    long v = 0;
    while (pos < buf.size() && std::isdigit(buf[pos]))
      v = v * 10 + (buf[pos++] - '0');
    return v;
  };
  long w = read_int(), h = read_int(), maxval = read_int();
  ++pos;  // single whitespace after maxval
  if (w != ow || h != oh || maxval > 255) return false;
  if (pos + static_cast<size_t>(w) * h > buf.size()) return false;
  for (long i = 0; i < w * h; ++i) out[i] = static_cast<float>(buf[pos + i]);
  return true;
}

bool decode_any(const std::string& path, float* out, int h, int w) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf)) return false;
  if (decode_png(buf, out, h, w)) return true;
  if (decode_pgm(buf, out, h, w)) return true;
  return false;
}

// ---------------------------------------------------------------------------
// Prefetching loader: worker threads decode ahead into a bounded cache
// ---------------------------------------------------------------------------

struct Loader {
  std::string folder;
  int num_drones, num_frames, height, width, depth;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;
  std::map<int64_t, std::vector<float>> cache;  // key -> pixels
  std::atomic<int64_t> cursor{0};               // next frame index to prefetch
  std::atomic<bool> stop{false};

  int64_t key(int drone, int frame) const {
    return static_cast<int64_t>(frame) * num_drones + drone;
  }

  std::string path(int drone, int frame) const {
    char name[256];
    std::snprintf(name, sizeof(name), "img__Quad%d_%04d", drone, frame);
    for (const char* ext : {".png", ".pgm"}) {
      std::string p = folder + "/" + name + ext;
      FILE* f = std::fopen(p.c_str(), "rb");
      if (f) {
        std::fclose(f);
        return p;
      }
    }
    return folder + "/" + name + ".png";
  }

  void worker() {
    const size_t npix = static_cast<size_t>(height) * width;
    while (!stop.load()) {
      int64_t idx = cursor.fetch_add(1);
      if (idx >= static_cast<int64_t>(num_frames) * num_drones) break;
      int frame = static_cast<int>(idx / num_drones);
      int drone = static_cast<int>(idx % num_drones);
      std::vector<float> px(npix, 0.0f);
      if (!decode_any(path(drone, frame), px.data(), height, width)) {
        px.clear();  // empty vector = decode-failure sentinel
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        // bound memory: wait until the cache drains below depth
        cv.wait(lk, [&] {
          return stop.load() ||
                 cache.size() < static_cast<size_t>(depth);
        });
        if (stop.load()) break;
        cache.emplace(key(drone, frame), std::move(px));
        cv.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

void* coloc_loader_open(const char* folder, int num_drones, int num_frames,
                        int height, int width, int prefetch_depth,
                        int num_threads) {
  auto* L = new Loader();
  L->folder = folder;
  L->num_drones = num_drones;
  L->num_frames = num_frames;
  L->height = height;
  L->width = width;
  L->depth = prefetch_depth > 0 ? prefetch_depth : 8;
  int nt = num_threads > 0 ? num_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back([L] { L->worker(); });
  return L;
}

int coloc_loader_get(void* handle, int drone, int frame, float* out) {
  auto* L = static_cast<Loader*>(handle);
  const size_t npix = static_cast<size_t>(L->height) * L->width;
  int64_t k = L->key(drone, frame);
  std::unique_lock<std::mutex> lk(L->mu);
  // wait for the prefetcher; fall back to synchronous decode if the frame is
  // outside the prefetch window (random access)
  if (!L->cv.wait_for(lk, std::chrono::milliseconds(2000), [&] {
        return L->cache.count(k) > 0;
      })) {
    lk.unlock();
    return decode_any(L->path(drone, frame), out, L->height, L->width) ? 0 : 1;
  }
  const std::vector<float>& px = L->cache[k];
  bool ok = px.size() == npix;  // empty vector = prefetch decode failure
  if (ok) std::memcpy(out, px.data(), npix * sizeof(float));
  L->cache.erase(k);
  L->cv.notify_all();
  return ok ? 0 : 1;
}

void coloc_loader_close(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

int coloc_decode_image(const char* path, float* out, int h, int w) {
  return decode_any(path, out, h, w) ? 0 : 1;
}

}  // extern "C"
