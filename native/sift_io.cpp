// sift_io: native data-loading runtime for the SIFT framework.
//
// Equivalent capability to the reference's C++ host runtime pieces — the
// host image container (/root/reference/sift_cuda/types/HostImage.hh),
// pinned-memory staging (types/CudaMemRAII.cuh:43-61) and the OpenCV image
// ingestion in its tools (tool/extract_and_match_example.cc:14-34) — as a
// dependency-free C++17 shared library: PGM/PPM decoding, RGB->grayscale
// conversion, bilinear resize, and a multithreaded prefetching frame queue
// that overlaps disk IO + decode with device compute.  Bound to Python via
// ctypes (sift_jax/io/native.py).
//
// Build: make -C native   (produces libsift_io.so)

#include <atomic>
#include <cctype>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PGM/PPM decoding (P2/P3 ascii, P5/P6 binary), output float32 grayscale.
// ---------------------------------------------------------------------------

struct DecodedImage {
  std::vector<float> data;
  int width = 0;
  int height = 0;
};

}  // extern "C" (struct is internal; C API below)

namespace {

bool skip_ws_comments(FILE* f) {
  int c;
  while ((c = fgetc(f)) != EOF) {
    if (c == '#') {
      while ((c = fgetc(f)) != EOF && c != '\n') {
      }
    } else if (!isspace(c)) {
      ungetc(c, f);
      return true;
    }
  }
  return false;
}

bool read_int(FILE* f, int* out) {
  if (!skip_ws_comments(f)) return false;
  return fscanf(f, "%d", out) == 1;
}

// Upper bound on decoded dimensions: headers are untrusted input, and a
// giant w*h must fail cleanly instead of throwing bad_alloc across the
// extern "C" boundary (or overflowing a caller buffer).
constexpr int kMaxDim = 1 << 16;                    // 65536 px per side
constexpr size_t kMaxPixels = size_t{1} << 27;      // 134 M px (512 MB f32)

bool decode_pnm(const char* path, DecodedImage* img) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  char magic[3] = {0, 0, 0};
  if (fread(magic, 1, 2, f) != 2 || magic[0] != 'P') {
    fclose(f);
    return false;
  }
  int type = magic[1] - '0';
  if (type != 2 && type != 3 && type != 5 && type != 6) {
    fclose(f);
    return false;
  }
  int w, h, maxv;
  if (!read_int(f, &w) || !read_int(f, &h) || !read_int(f, &maxv) ||
      w <= 0 || h <= 0 || maxv <= 0 || maxv > 65535 ||
      w > kMaxDim || h > kMaxDim ||
      static_cast<size_t>(w) * h > kMaxPixels) {
    fclose(f);
    return false;
  }
  const int channels = (type == 3 || type == 6) ? 3 : 1;
  const size_t n = static_cast<size_t>(w) * h * channels;
  std::vector<float> raw(n);
  if (type == 2 || type == 3) {
    for (size_t i = 0; i < n; ++i) {
      int v;
      if (!read_int(f, &v)) {
        fclose(f);
        return false;
      }
      raw[i] = static_cast<float>(v);
    }
  } else {
    fgetc(f);  // single whitespace after maxval
    if (maxv < 256) {
      std::vector<uint8_t> buf(n);
      if (fread(buf.data(), 1, n, f) != n) {
        fclose(f);
        return false;
      }
      for (size_t i = 0; i < n; ++i) raw[i] = buf[i];
    } else {
      std::vector<uint8_t> buf(n * 2);
      if (fread(buf.data(), 1, n * 2, f) != n * 2) {
        fclose(f);
        return false;
      }
      for (size_t i = 0; i < n; ++i)
        raw[i] = static_cast<float>((buf[2 * i] << 8) | buf[2 * i + 1]);
    }
  }
  fclose(f);
  // Scale to 0..255 like 8-bit, grayscale via BT.601 (OpenCV's weights,
  // matching cvMatToImage-on-IMREAD_GRAYSCALE ingestion).
  const float scale = 255.0f / static_cast<float>(maxv);
  img->width = w;
  img->height = h;
  img->data.resize(static_cast<size_t>(w) * h);
  if (channels == 1) {
    for (size_t i = 0; i < img->data.size(); ++i)
      img->data[i] = raw[i] * scale;
  } else {
    for (size_t i = 0; i < img->data.size(); ++i) {
      const float r = raw[3 * i], g = raw[3 * i + 1], b = raw[3 * i + 2];
      img->data[i] = (0.299f * r + 0.587f * g + 0.114f * b) * scale;
    }
  }
  return true;
}

void resize_bilinear(const std::vector<float>& src, int sw, int sh,
                     float* dst, int dw, int dh) {
  // Center-aligned coordinates, clamped taps — the same contract as
  // image_func/Resize.cu:26-63 and ops/resize.py.
  for (int i = 0; i < dh; ++i) {
    const float fy = (i + 0.5f) * sh / dh - 0.5f;
    int y0 = static_cast<int>(floorf(fy));
    float wy = fy - y0;
    int y1 = y0 + 1;
    if (y0 < 0) y0 = 0;
    if (y1 < 0) y1 = 0;
    if (y0 > sh - 1) y0 = sh - 1;
    if (y1 > sh - 1) y1 = sh - 1;
    for (int j = 0; j < dw; ++j) {
      const float fx = (j + 0.5f) * sw / dw - 0.5f;
      int x0 = static_cast<int>(floorf(fx));
      float wx = fx - x0;
      int x1 = x0 + 1;
      if (x0 < 0) x0 = 0;
      if (x1 < 0) x1 = 0;
      if (x0 > sw - 1) x0 = sw - 1;
      if (x1 > sw - 1) x1 = sw - 1;
      const float a = src[y0 * sw + x0] * (1 - wx) + src[y0 * sw + x1] * wx;
      const float b = src[y1 * sw + x0] * (1 - wx) + src[y1 * sw + x1] * wx;
      dst[i * dw + j] = a * (1 - wy) + b * wy;
    }
  }
}

struct Frame {
  std::vector<float> data;
  int width = 0;
  int height = 0;
  int index = -1;
  bool ok = false;
};

struct Loader {
  std::vector<std::string> paths;
  int out_w = 0, out_h = 0;  // 0 = native size
  size_t capacity = 4;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::deque<Frame> ready;      // min-heap-ish ordered delivery
  std::atomic<int> next_fetch{0};
  int next_deliver = 0;
  bool stopping = false;
};

void worker_loop(Loader* L) {
  for (;;) {
    const int idx = L->next_fetch.fetch_add(1);
    if (idx >= static_cast<int>(L->paths.size())) return;
    Frame fr;
    fr.index = idx;
    DecodedImage img;
    bool decoded = false;
    try {
      decoded = decode_pnm(L->paths[idx].c_str(), &img);
    } catch (const std::bad_alloc&) {
      decoded = false;  // deliver as a failed frame, don't kill the process
    }
    if (decoded) {
      fr.ok = true;
      if (L->out_w > 0 && L->out_h > 0 &&
          (L->out_w != img.width || L->out_h != img.height)) {
        fr.width = L->out_w;
        fr.height = L->out_h;
        fr.data.resize(static_cast<size_t>(L->out_w) * L->out_h);
        resize_bilinear(img.data, img.width, img.height, fr.data.data(),
                        L->out_w, L->out_h);
      } else {
        fr.width = img.width;
        fr.height = img.height;
        fr.data = std::move(img.data);
      }
    }
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_produce.wait(lk, [L, idx] {
      return L->stopping ||
             idx < L->next_deliver + static_cast<int>(L->capacity);
    });
    if (L->stopping) return;
    L->ready.push_back(std::move(fr));
    L->cv_consume.notify_all();
  }
}

}  // namespace

extern "C" {

// -- one-shot decode -------------------------------------------------------

// Returns 0 on success; fills *w / *h.  Call sift_io_read_into afterwards
// (two-phase so the caller allocates the buffer).
static thread_local DecodedImage g_last;

int sift_io_read_pnm(const char* path, int* w, int* h) {
  if (!decode_pnm(path, &g_last)) return -1;
  *w = g_last.width;
  *h = g_last.height;
  return 0;
}

int sift_io_read_into(float* dst, int w, int h) {
  if (w != g_last.width || h != g_last.height) return -1;
  memcpy(dst, g_last.data.data(), sizeof(float) * w * h);
  return 0;
}

// -- prefetching frame queue ----------------------------------------------

void* sift_io_loader_create(const char** paths, int n_paths, int n_threads,
                            int capacity, int out_w, int out_h) {
  auto* L = new Loader;
  L->paths.assign(paths, paths + n_paths);
  L->capacity = capacity > 0 ? capacity : 4;
  L->out_w = out_w;
  L->out_h = out_h;
  const int nt = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < nt; ++t) L->workers.emplace_back(worker_loop, L);
  return L;
}

// Blocks until the next frame (in path order) is ready; returns 0 on
// success, -2 when exhausted, -1 on decode failure of this frame, -3 when
// the frame exceeds dst_capacity floats (frame skipped; *w/*h report its
// true dims so the caller can re-allocate and retry via a new loader).
// Symbol is versioned (_v2 = the dst_capacity signature): a stale
// pre-capacity .so then fails loudly at ctypes lookup instead of reading
// the capacity value as its int* w pointer and corrupting memory.
int sift_io_loader_next_v2(void* handle, float* dst, int64_t dst_capacity,
                           int* w, int* h) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_deliver >= static_cast<int>(L->paths.size())) return -2;
  const int want = L->next_deliver;
  Frame fr;
  for (;;) {
    bool found = false;
    for (auto it = L->ready.begin(); it != L->ready.end(); ++it) {
      if (it->index == want) {
        fr = std::move(*it);
        L->ready.erase(it);
        found = true;
        break;
      }
    }
    if (found) break;
    L->cv_consume.wait(lk);
  }
  L->next_deliver++;
  L->cv_produce.notify_all();
  lk.unlock();
  if (!fr.ok) return -1;
  *w = fr.width;
  *h = fr.height;
  const size_t n = static_cast<size_t>(fr.width) * fr.height;
  if (static_cast<int64_t>(n) > dst_capacity) return -3;
  memcpy(dst, fr.data.data(), sizeof(float) * n);
  return 0;
}

void sift_io_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stopping = true;
  }
  L->cv_produce.notify_all();
  L->cv_consume.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// -- raw conversions -------------------------------------------------------

// Interleaved RGB8 [h, w, 3] -> float32 grayscale (BT.601).
void sift_io_rgb8_to_gray(const uint8_t* rgb, float* dst, int w, int h) {
  const size_t n = static_cast<size_t>(w) * h;
  for (size_t i = 0; i < n; ++i) {
    dst[i] = 0.299f * rgb[3 * i] + 0.587f * rgb[3 * i + 1] +
             0.114f * rgb[3 * i + 2];
  }
}

}  // extern "C"
