// Host runtime support of direct_stereo_slam_tpu_torch: the port's own copy
// of the JAX package's native/dsslam_native.cpp (the port loads nothing of
// that package). Image decoding (PGM/PPM), the fused photometric-LUT +
// bilinear-remap undistortion (DSO Undistort::undistort<uchar> +
// photometricUndist) and a threaded prefetching frame queue, so disk IO and
// preprocessing overlap the card's work. Host C++, not a device kernel.
// Bound from Python with ctypes (io/native.py), which builds it on first
// use with the flags of native/Makefile:
//
//   g++ -O3 -march=native -std=c++17 -fPIC -Wall -pthread -shared
//
// Differences from the JAX package's copy: the header's numbers are checked;
// the loader takes only 8-bit P5 files of its input size; and a frame whose
// file cannot be read stops the loader and queue_pop reports it (the caller
// raises), where the JAX package's loader queues a frame of zeros.

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PGM/PPM decoding (P5/P6 binary)
// ---------------------------------------------------------------------------

// Reads a PNM header up to the single whitespace after maxval: 0, or -2 (no
// magic), -3 (a number missing or not positive), -4 (not P5/P6).
static int pnm_header(FILE* f, int* w, int* h, int* channels, int* maxval) {
  char magic[3] = {0};
  if (fscanf(f, "%2s", magic) != 1) return -2;
  int c;
  // skip whitespace/comments
  auto skip = [&]() {
    while ((c = fgetc(f)) != EOF) {
      if (c == '#') { while ((c = fgetc(f)) != EOF && c != '\n') {} }
      else if (!isspace(c)) { ungetc(c, f); break; }
    }
  };
  skip(); if (fscanf(f, "%d", w) != 1 || *w <= 0) return -3;
  skip(); if (fscanf(f, "%d", h) != 1 || *h <= 0) return -3;
  skip(); if (fscanf(f, "%d", maxval) != 1 || *maxval <= 0) return -3;
  fgetc(f);  // single whitespace after maxval
  if (strcmp(magic, "P5") == 0) *channels = 1;
  else if (strcmp(magic, "P6") == 0) *channels = 3;
  else return -4;
  return 0;
}

// Parses header, returns 0 on success; fills w, h, channels (the caller
// allocates w*h*channels bytes for pnm_read after probing).
int pnm_probe(const char* path, int* w, int* h, int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int maxval;
  int rc = pnm_header(f, w, h, channels, &maxval);
  fclose(f);
  return rc;
}

// Copies the pixel bytes (8-bit; of a 16-bit P5 its first w*h bytes) into
// out: 0, a pnm_header code, -5 (more than out_size bytes) or -6 (short).
int pnm_read(const char* path, uint8_t* out, int out_size) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int width, height, channels, maxval;
  int rc = pnm_header(f, &width, &height, &channels, &maxval);
  long need = (long)width * height * channels;
  if (rc == 0 && need > out_size) rc = -5;
  if (rc == 0 && fread(out, 1, need, f) != (size_t)need) rc = -6;
  fclose(f);
  return rc;
}

// The loader's read: an 8-bit P5 of exactly w x h, else -7 (or the codes
// of pnm_read), so no frame is made of another frame's stale bytes.
static int read_gray8(const char* path, uint8_t* out, int w, int h) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int fw, fh, channels, maxval;
  int rc = pnm_header(f, &fw, &fh, &channels, &maxval);
  if (rc == 0 && (fw != w || fh != h || channels != 1 || maxval > 255)) rc = -7;
  if (rc == 0 && fread(out, 1, (size_t)w * h, f) != (size_t)w * h) rc = -6;
  fclose(f);
  return rc;
}

// ---------------------------------------------------------------------------
// Fused undistortion: u8 -> gamma LUT -> bilinear remap -> float32
// (DSO Undistort::undistort + photometricUndist in one pass)
// ---------------------------------------------------------------------------

static void undistort_rows(const uint8_t* src, int in_w, int in_h,
                           const float* lut,       // 256 or nullptr
                           const float* map_x,     // [out_h*out_w]
                           const float* map_y,
                           float* out, int out_w,
                           int row0, int row1) {
  for (int v = row0; v < row1; v++) {
    for (int u = 0; u < out_w; u++) {
      int i = v * out_w + u;
      float sx = map_x[i], sy = map_y[i];
      if (sx < 0.f || sy < 0.f) { out[i] = 0.f; continue; }
      int ix = (int)sx, iy = (int)sy;
      if (ix >= in_w - 1) ix = in_w - 2;
      if (iy >= in_h - 1) iy = in_h - 2;
      float fx = sx - ix, fy = sy - iy;
      const uint8_t* p = src + iy * in_w + ix;
      float p00 = p[0], p10 = p[1], p01 = p[in_w], p11 = p[in_w + 1];
      if (lut) {
        p00 = lut[(int)p00]; p10 = lut[(int)p10];
        p01 = lut[(int)p01]; p11 = lut[(int)p11];
      }
      float top = p00 + fx * (p10 - p00);
      float bot = p01 + fx * (p11 - p01);
      out[i] = top + fy * (bot - top);
    }
  }
}

void undistort_u8(const uint8_t* src, int in_w, int in_h,
                  const float* lut,
                  const float* map_x, const float* map_y,
                  float* out, int out_w, int out_h, int n_threads) {
  if (n_threads <= 1) {
    undistort_rows(src, in_w, in_h, lut, map_x, map_y, out, out_w, 0, out_h);
    return;
  }
  std::vector<std::thread> ts;
  int rows = (out_h + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    int r0 = t * rows, r1 = std::min(out_h, r0 + rows);
    if (r0 >= r1) break;
    ts.emplace_back(undistort_rows, src, in_w, in_h, lut, map_x, map_y,
                    out, out_w, r0, r1);
  }
  for (auto& t : ts) t.join();
}

// plain LUT application (identity geometry)
void apply_lut_u8(const uint8_t* src, int n, const float* lut, float* out) {
  for (int i = 0; i < n; i++) out[i] = lut[src[i]];
}

// ---------------------------------------------------------------------------
// Prefetching stereo frame queue
// ---------------------------------------------------------------------------

struct Frame {
  std::vector<float> img0, img1;
  double timestamp;
  int id;
};

struct FrameQueue {
  std::queue<Frame> q;
  std::mutex m;
  std::condition_variable cv_push, cv_pop;
  size_t capacity;
  std::atomic<bool> done{false};
  std::thread loader;
  int w = 0, h = 0;
  int error = 0;                 // read_gray8's code for frame error_id, or 0
  int error_id = -1;
};

struct LoaderSpec {
  std::vector<std::string> files0, files1;
  std::vector<double> stamps;
  const float* lut0; const float* lut1;
  const float* mapx0; const float* mapy0;
  const float* mapx1; const float* mapy1;
  int in_w, in_h, out_w, out_h;
  int n_threads;
};

static void loader_main(FrameQueue* fq, LoaderSpec spec) {
  std::vector<uint8_t> raw(spec.in_w * spec.in_h);
  for (size_t i = 0; i < spec.files0.size() && !fq->done.load(); i++) {
    Frame fr;
    fr.id = (int)i;
    fr.timestamp = spec.stamps[i];
    fr.img0.resize(spec.out_w * spec.out_h);
    fr.img1.resize(spec.out_w * spec.out_h);
    int rc = read_gray8(spec.files0[i].c_str(), raw.data(), spec.in_w, spec.in_h);
    if (rc == 0)
      undistort_u8(raw.data(), spec.in_w, spec.in_h, spec.lut0,
                   spec.mapx0, spec.mapy0, fr.img0.data(),
                   spec.out_w, spec.out_h, spec.n_threads);
    if (rc == 0) rc = read_gray8(spec.files1[i].c_str(), raw.data(), spec.in_w, spec.in_h);
    if (rc == 0)
      undistort_u8(raw.data(), spec.in_w, spec.in_h, spec.lut1,
                   spec.mapx1, spec.mapy1, fr.img1.data(),
                   spec.out_w, spec.out_h, spec.n_threads);
    std::unique_lock<std::mutex> lk(fq->m);
    if (rc != 0) {             // the frames before it stay queued
      fq->error = rc;
      fq->error_id = (int)i;
      break;
    }
    fq->cv_push.wait(lk, [&] { return fq->q.size() < fq->capacity || fq->done; });
    if (fq->done) break;
    fq->q.push(std::move(fr));
    fq->cv_pop.notify_one();
  }
  {
    // under the lock: a consumer between its test and its wait would miss
    // the notification
    std::lock_guard<std::mutex> lk(fq->m);
    fq->done = true;
  }
  fq->cv_pop.notify_all();
}

void* queue_create(int capacity) {
  auto* fq = new FrameQueue();
  fq->capacity = capacity;
  return fq;
}

// file lists passed as newline-joined strings; maps/luts are borrowed
// pointers that must outlive the queue (the Python wrapper keeps them alive)
void queue_start(void* h, const char* files0, const char* files1,
                 const double* stamps, int n,
                 const float* lut0, const float* lut1,
                 const float* mapx0, const float* mapy0,
                 const float* mapx1, const float* mapy1,
                 int in_w, int in_h, int out_w, int out_h, int n_threads) {
  auto* fq = (FrameQueue*)h;
  LoaderSpec spec;
  auto split = [](const char* s, std::vector<std::string>& out) {
    std::string cur;
    for (const char* p = s; *p; p++) {
      if (*p == '\n') { if (!cur.empty()) out.push_back(cur); cur.clear(); }
      else cur.push_back(*p);
    }
    if (!cur.empty()) out.push_back(cur);
  };
  split(files0, spec.files0);
  split(files1, spec.files1);
  spec.stamps.assign(stamps, stamps + n);
  spec.lut0 = lut0; spec.lut1 = lut1;
  spec.mapx0 = mapx0; spec.mapy0 = mapy0;
  spec.mapx1 = mapx1; spec.mapy1 = mapy1;
  spec.in_w = in_w; spec.in_h = in_h;
  spec.out_w = out_w; spec.out_h = out_h;
  spec.n_threads = n_threads;
  fq->w = out_w; fq->h = out_h;
  fq->loader = std::thread(loader_main, fq, std::move(spec));
}

// returns 1 on frame, 0 when exhausted, and once the frames before a frame
// that could not be read are popped, read_gray8's (negative) code for it, with
// its index in *id
int queue_pop(void* h, float* img0, float* img1, double* timestamp, int* id) {
  auto* fq = (FrameQueue*)h;
  std::unique_lock<std::mutex> lk(fq->m);
  fq->cv_pop.wait(lk, [&] { return !fq->q.empty() || fq->done; });
  if (fq->q.empty()) {
    *id = fq->error_id;
    return fq->error;
  }
  Frame fr = std::move(fq->q.front());
  fq->q.pop();
  fq->cv_push.notify_one();
  lk.unlock();
  memcpy(img0, fr.img0.data(), fr.img0.size() * sizeof(float));
  memcpy(img1, fr.img1.data(), fr.img1.size() * sizeof(float));
  *timestamp = fr.timestamp;
  *id = fr.id;
  return 1;
}

void queue_destroy(void* h) {
  auto* fq = (FrameQueue*)h;
  {
    std::lock_guard<std::mutex> lk(fq->m);
    fq->done = true;
  }
  fq->cv_push.notify_all();
  fq->cv_pop.notify_all();
  if (fq->loader.joinable()) fq->loader.join();
  delete fq;
}

}  // extern "C"
