// Threaded stereo-frame prefetcher: decodes 8-bit grayscale PNG/PGM
// images into padded float32 canvases on background threads and hands
// them to the Python host through a bounded ring buffer.
//
// Runtime counterpart of the reference's synchronous
// cv2.imread-everything-up-front loaders
// (/root/reference/visual_odometry_solution_methods.py:31-33 loads the
// whole sequence into RAM before the loop). Here decode overlaps with
// device compute: while the chip runs frame i, worker threads decode
// frames i+1..i+ring.
//
// PNG support: 8-bit grayscale (color type 0) and 8-bit RGB/RGBA
// (luma-converted), non-interlaced, all five filter types — which
// covers KITTI odometry grayscale exactly. PGM: binary P5 maxval 255.
//
// Build: g++ -O3 -shared -fPIC dataloader.cpp -o libslamloader.so -lz -lpthread

#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0, channels = 0;
  std::vector<uint8_t> pixels;  // row-major, channels interleaved
};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool read_file(const std::string& path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(n);
  bool ok = fread(out.data(), 1, n, f) == size_t(n);
  fclose(f);
  return ok;
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

bool decode_png(const std::vector<uint8_t>& buf, Image& img) {
  static const uint8_t magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (buf.size() < 8 || memcmp(buf.data(), magic, 8) != 0) return false;
  size_t pos = 8;
  int bit_depth = 0, color_type = -1, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= buf.size()) {
    uint32_t len = be32(&buf[pos]);
    const char* type = reinterpret_cast<const char*>(&buf[pos + 4]);
    const uint8_t* data = &buf[pos + 8];
    if (pos + 12 + len > buf.size()) return false;
    if (!memcmp(type, "IHDR", 4)) {
      img.w = be32(data);
      img.h = be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (bit_depth != 8 || interlace != 0) return false;
  int ch;
  switch (color_type) {
    case 0: ch = 1; break;  // gray
    case 2: ch = 3; break;  // rgb
    case 4: ch = 2; break;  // gray+alpha
    case 6: ch = 4; break;  // rgba
    default: return false;  // palette unsupported
  }
  img.channels = ch;
  const size_t stride = size_t(img.w) * ch;
  std::vector<uint8_t> raw((stride + 1) * img.h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    return false;

  img.pixels.resize(stride * img.h);
  std::vector<uint8_t> prev(stride, 0);
  for (int y = 0; y < img.h; ++y) {
    const uint8_t filter = raw[(stride + 1) * y];
    const uint8_t* src = &raw[(stride + 1) * y + 1];
    uint8_t* dst = &img.pixels[stride * y];
    for (size_t x = 0; x < stride; ++x) {
      const int a = x >= size_t(ch) ? dst[x - ch] : 0;
      const int b = prev[x];
      const int c = x >= size_t(ch) ? prev[x - ch] : 0;
      int v = src[x];
      switch (filter) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) / 2; break;
        case 4: v += paeth(a, b, c); break;
        default: return false;
      }
      dst[x] = uint8_t(v);
    }
    memcpy(prev.data(), dst, stride);
  }
  return true;
}

bool decode_pgm(const std::vector<uint8_t>& buf, Image& img) {
  if (buf.size() < 2 || buf[0] != 'P' || buf[1] != '5') return false;
  size_t pos = 2;
  auto next_int = [&](int& out) {
    while (pos < buf.size() &&
           (isspace(buf[pos]) || buf[pos] == '#')) {
      if (buf[pos] == '#')
        while (pos < buf.size() && buf[pos] != '\n') ++pos;
      else
        ++pos;
    }
    out = 0;
    bool any = false;
    while (pos < buf.size() && isdigit(buf[pos])) {
      out = out * 10 + (buf[pos++] - '0');
      any = true;
    }
    return any;
  };
  int maxval;
  if (!next_int(img.w) || !next_int(img.h) || !next_int(maxval)) return false;
  if (maxval != 255) return false;
  ++pos;  // single whitespace after maxval
  img.channels = 1;
  const size_t n = size_t(img.w) * img.h;
  if (buf.size() < pos + n) return false;
  img.pixels.assign(buf.begin() + pos, buf.begin() + pos + n);
  return true;
}

struct Frame {
  int index = -1;
  std::vector<float> canvas;  // H*W float32 in [0,1]
  bool ok = false;
};

struct Loader {
  std::vector<std::string> paths;
  int canvas_h, canvas_w;
  size_t ring;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::queue<Frame> ready;     // decoded frames, ordered by index
  std::atomic<int> next_decode{0};
  int next_emit = 0;
  std::vector<Frame> stash;    // out-of-order completions
  std::atomic<bool> stop{false};

  void work() {
    for (;;) {
      const int idx = next_decode.fetch_add(1);
      if (idx >= int(paths.size()) || stop.load()) return;
      Frame fr;
      fr.index = idx;
      fr.canvas.assign(size_t(canvas_h) * canvas_w, 0.f);
      std::vector<uint8_t> buf;
      Image img;
      if (read_file(paths[idx], buf) &&
          (decode_png(buf, img) || decode_pgm(buf, img))) {
        const int h = img.h < canvas_h ? img.h : canvas_h;
        const int w = img.w < canvas_w ? img.w : canvas_w;
        const int ch = img.channels;
        for (int y = 0; y < h; ++y) {
          const uint8_t* row = &img.pixels[size_t(y) * img.w * ch];
          float* out = &fr.canvas[size_t(y) * canvas_w];
          if (ch == 1) {
            for (int x = 0; x < w; ++x) out[x] = row[x] * (1.f / 255.f);
          } else {
            for (int x = 0; x < w; ++x) {
              const uint8_t* px = row + size_t(x) * ch;
              // integer luma (Rec.601-ish)
              out[x] = (77 * px[0] + 150 * px[1] + 29 * px[2]) *
                       (1.f / (255.f * 256.f));
            }
          }
        }
        fr.ok = true;
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_produce.wait(lk, [&] {
        return stop.load() ||
               (fr.index < next_emit + int(ring) &&
                ready.size() + stash.size() < ring);
      });
      if (stop.load()) return;
      stash.push_back(std::move(fr));
      // move any in-order frames to the ready queue
      bool moved = true;
      while (moved) {
        moved = false;
        for (size_t i = 0; i < stash.size(); ++i) {
          if (stash[i].index == next_emit + int(ready.size())) {
            ready.push(std::move(stash[i]));
            stash.erase(stash.begin() + i);
            moved = true;
            break;
          }
        }
      }
      cv_consume.notify_all();
      cv_produce.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n, int canvas_h, int canvas_w,
                    int ring, int threads) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->canvas_h = canvas_h;
  L->canvas_w = canvas_w;
  L->ring = ring < 2 ? 2 : ring;
  const int t = threads < 1 ? 1 : threads;
  for (int i = 0; i < t; ++i) L->workers.emplace_back([L] { L->work(); });
  return L;
}

// Blocks until the next in-order frame is decoded; copies it into `out`
// (canvas_h*canvas_w floats). Returns the frame index, or -1 at end of
// sequence, or -2 on decode failure of that frame.
int loader_next(void* handle, float* out) {
  auto* L = static_cast<Loader*>(handle);
  if (L->next_emit >= int(L->paths.size())) return -1;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_consume.wait(lk, [&] { return !L->ready.empty() || L->stop.load(); });
  if (L->stop.load()) return -1;
  Frame fr = std::move(L->ready.front());
  L->ready.pop();
  L->next_emit++;
  L->cv_produce.notify_all();
  lk.unlock();
  if (!fr.ok) return -2;
  memcpy(out, fr.canvas.data(), fr.canvas.size() * sizeof(float));
  return fr.index;
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->cv_produce.notify_all();
  L->cv_consume.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
