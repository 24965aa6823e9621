// K15: the coarse tracker's template, on the card.
//
// `template_kernel` replaces the JAX package's hand-written XLA program
// direct_stereo_slam_tpu/models/depth_template.py:80 `build_template`:
// the window's points projected into the reference keyframe (N <= a few
// thousand: their pixel, by the truncating cast and the clip, and their
// weight where they are ok) summed per pixel into a level-0 idepth and
// weight map, the maps 2x2 sum-pooled up the pyramid and the image 2x2
// averaged, one dilation pass a level (diagonal neighbours on levels 0-1,
// axis neighbours above: a hole takes the mean of its neighbours with
// weight), the normalisation and the border / weight / idepth / finite
// gates, and per level the raster-order compaction of the good cells into
// the level's budget (the lanes past the count zeroed). Its plain version
// is models/depth_template.py::build_template_plain, whose orders it keeps:
// each pixel's points added to 0 in ascending point order (a stable sort
// by pixel), each pooled cell ((top left + top right) + bottom left) +
// bottom right, the dilation's neighbours in `_dilate_once`'s order; so the
// lists are bit-equal.
//
// What bounds it on the H100 (KITTI, 1232 x 368, 5 levels, N = 2560 or
// 4096): the bytes, ~4.5 MB (the level-0 image read once, the maps of
// ~0.6 M cells written and read back, the lists), ~1.4 us at 3.35 TB/s;
// ~10 operations a cell. What sets its time is the chain of phases, each
// over the whole level: the sort of the points, the per-pixel sums, each
// level's pooling and dilation, the compaction's global scan.
//
// Design: one cooperative grid (a block of 512 threads an SM), grid
// barriers between the phases (cg::this_grid().sync()). Phase 0: every
// block keeps all the points' pixels in shared memory and zeroes its part
// of the level-0 maps; a warp a point finds whether it is the first of its
// pixel (no earlier point on it, 32 keys a ballot) and, if so, walks the
// points from it on and sums those on its pixel in ascending order (the N
// x N key compares from shared memory, ~17 M at N = 4096, spread over the
// grid's warps; no sort, no atomics); phase 1: each pixel's first point
// writes its sums; phase 2 + l, each
// level l: every block dilates, normalises and gates its contiguous chunk
// of the level's cells (in raster order) and counts its good cells, and
// pools level l + 1 from level l; the last phase: each block ranks its
// chunk's good cells after the counts of the blocks before it (a block
// scan) and writes their list entries, and the lanes past the count are
// zeroed by the grid. `stamps` (optional) gets block 0's clock64 phase
// deltas. No atomics: two runs give the same bits.

#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"
#include "plain_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using dsslam::clamp_min;
using namespace dsslam::rn;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 8;
constexpr int kMaxPoints = 48 * 1024;    // the points' pixels in shared memory: 4 bytes each
// block 0's stamps: the pixels and their sums, their writes, each level's
// phase (each with the barrier after it), the compaction
constexpr int kTemplateStamps = kMaxLevels + 3;
static_assert(2 + kMaxLevels < kTemplateStamps, "a stamp for every phase");

// `_dilate_once`'s offsets, out[y, x] reading in[y + dy, x + dx]: diag
// [(1, 1), (-1, -1), (1, -1), (-1, 1)] on levels 0-1, axes [(0, 1), (0, -1),
// (1, 0), (-1, 0)] above
__constant__ int kDy[2][4] = {{1, -1, 1, -1}, {0, 0, 1, -1}};
__constant__ int kDx[2][4] = {{1, -1, -1, 1}, {1, -1, 0, 0}};

struct TemplateParams {
  int N, H, W, levels, img_row, img_col, grid;
  int h[kMaxLevels], w[kMaxLevels], budget[kMaxLevels];
  const float *pu, *pv, *pid, *pw;       // [N]
  const unsigned char* valid;            // [N]
  const float* img;                      // level 0's intensity, img_row / img_col apart
  // scratch [N]: a pixel's sums at its first point, and whether a point is
  // its pixel's first
  float *psum, *pwsum;
  unsigned char* plead;
  // scratch per level: the pooled (undilated) idepth and weight sums, the
  // image (levels >= 1), the normalised idepth and the good flags
  float *sum[kMaxLevels], *wsum[kMaxLevels], *limg[kMaxLevels], *idn[kMaxLevels];
  unsigned char* good[kMaxLevels];
  int* counts;                           // [levels, grid] good cells a block
  // the lists [budget[l]]
  float *o_pu[kMaxLevels], *o_pv[kMaxLevels], *o_pid[kMaxLevels], *o_pcolor[kMaxLevels];
  unsigned char* o_pmask[kMaxLevels];
  long long* stamps;                     // [kTemplateStamps] cycles, or null
};

// (proj + 0.5) cast to an integer as the plain version does: nan_to_num
// (NaN 0, +-inf the largest finite), clamp to +-2^30, truncate, then clip
// to [0, n - 1]
__device__ __forceinline__ int pixel_of(float x, int n) {
  float y = add(x, 0.5f);
  if (isnan(y)) y = 0.f;
  y = fminf(fmaxf(y, -1073741824.f), 1073741824.f);
  const long long i = static_cast<long long>(y);
  return static_cast<int>(i < 0 ? 0 : (i > n - 1 ? n - 1 : i));
}

// Point i's pixel and its two summands (proj_id * wgt, wgt).
__device__ __forceinline__ int point_of(const TemplateParams& p, int i, float& vd, float& vw) {
  const float u = p.pu[i], v = p.pv[i], id = p.pid[i];
  const bool ok = p.valid[i] != 0 && id > 0.f && u >= 0.f && v >= 0.f &&
                  u < static_cast<float>(p.W) && v < static_cast<float>(p.H);
  vw = ok ? p.pw[i] : 0.f;
  vd = mul(id, vw);
  return pixel_of(v, p.H) * p.W + pixel_of(u, p.W);
}

__device__ __forceinline__ float image_at(const TemplateParams& p, int l, int y, int x) {
  return l == 0 ? p.img[static_cast<size_t>(y) * p.img_row + static_cast<size_t>(x) * p.img_col]
                : p.limg[l][static_cast<size_t>(y) * p.w[l] + x];
}

// Cell c of level l + 1 from level l: the sums pooled, the image pooled
// times 0.25.
__device__ __forceinline__ void pool_cell(const TemplateParams& p, int l, int c) {
  const int W2 = p.w[l + 1], Wl = p.w[l];
  const int y = c / W2, x = c - y * W2;
  const size_t a = static_cast<size_t>(2 * y) * Wl + 2 * x, b = a + Wl;
  const float* s = p.sum[l];
  const float* w = p.wsum[l];
  p.sum[l + 1][c] = add(add(add(s[a], s[a + 1]), s[b]), s[b + 1]);
  p.wsum[l + 1][c] = add(add(add(w[a], w[a + 1]), w[b]), w[b + 1]);
  const float i00 = image_at(p, l, 2 * y, 2 * x), i01 = image_at(p, l, 2 * y, 2 * x + 1);
  const float i10 = image_at(p, l, 2 * y + 1, 2 * x), i11 = image_at(p, l, 2 * y + 1, 2 * x + 1);
  p.limg[l + 1][c] = mul(add(add(add(i00, i01), i10), i11), 0.25f);
}

// Cell c of level l dilated (`_dilate_once`), normalised and gated: its
// idn and good flag.
__device__ __forceinline__ bool dilate_cell(const TemplateParams& p, int l, int c) {
  const int Wl = p.w[l], Hl = p.h[l];
  const int y = c / Wl, x = c - y * Wl;
  const float* s_in = p.sum[l];
  const float* w_in = p.wsum[l];
  const int set = l < 2 ? 0 : 1;
  float s = 0.f, n = 0.f, cnt = 0.f;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int yy = y + kDy[set][o], xx = x + kDx[set][o];
    const bool in = yy >= 0 && yy < Hl && xx >= 0 && xx < Wl;
    const size_t q = static_cast<size_t>(yy) * Wl + xx;
    const float w_s = in ? w_in[q] : 0.f;
    const float i_s = in ? s_in[q] : 0.f;
    const float m = w_s > 0.f ? 1.f : 0.f;
    s = add(s, mul(i_s, m));
    n = add(n, mul(w_s, m));
    cnt = add(cnt, m);
  }
  float d = s_in[c], w = w_in[c];
  if (w <= 0.f && cnt > 0.f) {
    const float cs = cnt < 1.f ? 1.f : cnt;
    d = dvd(s, cs);
    w = dvd(n, cs);
  }
  const float idn = dvd(d, clamp_min(w, 1e-12f));
  const bool border = y >= 2 && y < Hl - 2 && x >= 2 && x < Wl - 2;
  const bool good = border && w > 0.f && idn > 0.f && isfinite(image_at(p, l, y, x));
  p.idn[l][c] = idn;
  p.good[l][c] = good;
  return good;
}

__global__ void __launch_bounds__(kThreads) template_kernel(const __grid_constant__ TemplateParams p) {
  extern __shared__ int s_px[];          // [N] the points' pixels
  __shared__ int s_scan[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, G = gridDim.x;
  long long* stamp = p.stamps && b == 0 && tid == 0 ? p.stamps : nullptr;
  long long t0 = clock64();
  const size_t n0 = static_cast<size_t>(p.H) * p.W;

  // ---- phase 0: the pixels; each pixel's sums at its first point, its
  // points added to 0 in ascending order; the level-0 maps zeroed
  for (int i = tid; i < p.N; i += kThreads) {
    float vd, vw;
    s_px[i] = point_of(p, i, vd, vw);
  }
  for (size_t c = static_cast<size_t>(b) * kThreads + tid; c < n0;
       c += static_cast<size_t>(G) * kThreads) {
    p.sum[0][c] = 0.f;
    p.wsum[0][c] = 0.f;
  }
  __syncthreads();
  // a warp a point: its lanes compare 32 keys at a time (a ballot), lane 0
  // adds the matches in ascending order
  for (int i = b * kWarps + warp; i < p.N; i += G * kWarps) {
    const int px = s_px[i];
    bool first = true;
    for (int j0 = 0; j0 < i && first; j0 += 32) {
      const int j = j0 + lane;
      first = __ballot_sync(kFull, j < i && s_px[j] == px) == 0u;
    }
    if (first) {
      float sd = 0.f, sw = 0.f;
      for (int j0 = i & ~31; j0 < p.N; j0 += 32) {
        const int j = j0 + lane;
        unsigned m = __ballot_sync(kFull, j >= i && j < p.N && s_px[j] == px);
        if (lane == 0)
          for (; m; m &= m - 1u) {
            float vd, vw;
            point_of(p, j0 + __ffs(m) - 1, vd, vw);
            sd = add(sd, vd);
            sw = add(sw, vw);
          }
      }
      if (lane == 0) {
        p.psum[i] = sd;
        p.pwsum[i] = sw;
      }
    }
    if (lane == 0) p.plead[i] = first;
  }
  if (stamp) stamp[0] = clock64() - t0;
  grid.sync();

  // ---- phase 1: the pixels' sums into the level-0 maps
  t0 = clock64();
  for (int i = b * kThreads + tid; i < p.N; i += G * kThreads)
    if (p.plead[i]) {
      p.sum[0][s_px[i]] = p.psum[i];
      p.wsum[0][s_px[i]] = p.pwsum[i];
    }
  grid.sync();
  if (stamp) stamp[1] = clock64() - t0;

  // ---- phase 2 + l: level l dilated, normalised and gated (a contiguous
  // chunk a block, counted), level l + 1 pooled
  for (int l = 0; l < p.levels; ++l) {
    t0 = clock64();
    const int nl = p.h[l] * p.w[l];
    const int chunk = (nl + G - 1) / G;
    const int c0 = min(nl, b * chunk), c1 = min(nl, c0 + chunk);
    int n_good = 0;
    for (int base = c0; base < c1; base += kThreads) {
      const int c = base + tid;
      const bool g = c < c1 && dilate_cell(p, l, c);
      n_good += __syncthreads_count(g);
    }
    if (tid == 0) p.counts[l * G + b] = n_good;
    if (l + 1 < p.levels) {
      const int n1 = p.h[l + 1] * p.w[l + 1];
      for (int c = b * kThreads + tid; c < n1; c += G * kThreads) pool_cell(p, l, c);
    }
    grid.sync();
    if (stamp) stamp[2 + l] = clock64() - t0;
  }

  // ---- the compaction: each level's good cells in raster order into its
  // budget
  t0 = clock64();
  for (int l = 0; l < p.levels; ++l) {
    const int nl = p.h[l] * p.w[l], Wl = p.w[l], B = p.budget[l];
    const int chunk = (nl + G - 1) / G;
    const int c0 = min(nl, b * chunk), c1 = min(nl, c0 + chunk);
    int before = 0, total = 0;
    for (int r = 0; r < G; ++r) {
      const int n = p.counts[l * G + r];
      before += r < b ? n : 0;
      total += n;
    }
    for (int base = c0; base < c1 && before < B; base += kThreads) {
      const int c = base + tid;
      const bool g = c < c1 && p.good[l][c] != 0;
      const unsigned bal = __ballot_sync(kFull, g);
      if (lane == 0) s_scan[warp] = __popc(bal);
      __syncthreads();
      int warps_before = 0, chunk_total = 0;
      for (int w = 0; w < kWarps; ++w) {
        warps_before += w < warp ? s_scan[w] : 0;
        chunk_total += s_scan[w];
      }
      __syncthreads();                   // s_scan is rewritten next round
      const int r = before + warps_before + __popc(bal & ((1u << lane) - 1u));
      if (g && r < B) {
        const int y = c / Wl;
        p.o_pu[l][r] = static_cast<float>(c - y * Wl);
        p.o_pv[l][r] = static_cast<float>(y);
        p.o_pid[l][r] = p.idn[l][c];
        p.o_pcolor[l][r] = image_at(p, l, y, c - y * Wl);
        p.o_pmask[l][r] = 1;
      }
      before += chunk_total;
    }
    for (int r = min(total, B) + b * kThreads + tid; r < B; r += G * kThreads) {
      p.o_pu[l][r] = 0.f;
      p.o_pv[l][r] = 0.f;
      p.o_pid[l][r] = 0.f;
      p.o_pcolor[l][r] = 0.f;
      p.o_pmask[l][r] = 0;
    }
  }
  if (stamp) stamp[2 + p.levels] = clock64() - t0;
}

// Lets the kernel take `smem` bytes of dynamic shared memory (above the
// default 48 KB only after the attribute is set).
cudaError_t grant_smem(int smem) {
  static int granted = 48 * 1024;        // the kernel's dynamic shared memory limit, as set
  if (smem <= granted) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(template_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) granted = smem;
  return err;
}

}  // namespace

// `p.grid` is a block an SM (ops/template.py); the cooperative launch
// fails unless every block is resident with its dynamic shared memory.
DSSLAM_API int dsslam_template(const TemplateParams* params, cudaStream_t stream) {
  const TemplateParams& p = *params;
  if (p.N < 0 || p.N > kMaxPoints || p.levels < 1 || p.levels > kMaxLevels || p.H < 1 ||
      p.W < 1 || p.grid < 1 || static_cast<long long>(p.H) * p.W >= (1ll << 31))
    return cudaErrorInvalidValue;
  for (int l = 0; l < p.levels; ++l)
    if (p.h[l] < 1 || p.w[l] < 1 || p.budget[l] < 1) return cudaErrorInvalidValue;
  const int smem = 4 * (p.N > 0 ? p.N : 1);
  cudaError_t err = grant_smem(smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<TemplateParams*>(params)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(template_kernel),
                                                dim3(p.grid), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
