// K15: the coarse tracker's template, on the card.
//
// `template_kernel` replaces the JAX package's hand-written XLA program
// direct_stereo_slam_tpu/models/depth_template.py:80 `build_template` and,
// in its state mode, the per-point part of models/ba.py:988
// `template_inputs`: the window's points projected into the reference
// keyframe (N <= a few thousand: their pixel, by the truncating cast and
// the clip, and their weight where they are ok) summed per pixel into a
// level-0 idepth and weight map, the maps 2x2 sum-pooled up the pyramid
// and the image 2x2 averaged, one dilation pass a level (diagonal
// neighbours on levels 0-1, axis neighbours above: a hole takes the mean
// of its neighbours with weight), the normalisation and the border /
// weight / idepth / finite gates, and per level the raster-order
// compaction of the good cells into the level's budget (the lanes past the
// count zeroed). Its plain versions are models/depth_template.py::
// build_template_plain and, for the state mode, models/ba.py::
// template_project before it, whose orders it keeps: each pixel's points
// added to 0 in ascending point order, each pooled cell ((top left + top
// right) + bottom left) + bottom right, the dilation's neighbours in
// `_dilate_once`'s order, the projection one rounded operation at a time;
// so the lists are bit-equal.
//
// Only the occupied cells are touched. A cell with no point under it
// holds exactly +0 in both sums, so after the dilation a cell can be good
// only where it or one of its dilation neighbours is occupied: the
// kernel keeps an occupancy bitmap a level (a bit a cell, rows padded to
// 32-bit words) and evaluates just those candidates, reading a cell's sums
// where its bit is set and +0 elsewhere, as the dense maps would give. No
// sum is ever -0 (a chain from +0 never gives -0), so a +0 or -0 summand
// leaves a sum as it is: a pixel's sums are its live points' summands
// (those not +-0, NaN included) added in ascending point order, and a
// pixel with one live point or none needs no order at all.
//
// What bounds it on the H100 (KITTI, 1232 x 368, 5 levels, N = 4096): the
// bytes, ~1 MB (the points, the image under the good cells, the lists),
// ~0.3 us at 3.35 TB/s; what sets its time is its chain of steps, each a
// round of L2 reads over the grid and a grid barrier.
//
// Design: one cooperative grid of 1024-thread blocks (a block an SM), a
// grid barrier after each step. (1) A thread a point: its pixel and
// summands (in the state mode its projection first), its bit set in the
// level-0 words and, if the bit was set already, in the duplicate words
// (integer atomicOr: an OR does not depend on the order), its pixel's
// sums set to +0; the blocks build the image pyramid (levels >= 1) tile
// by tile. (2) A live point alone on its pixel writes its sums (+0 plus
// its summands); a live point on a duplicate pixel is appended to a list.
// (3) A warp a list entry ranks it by (pixel, point) (the list is not
// short: points of several hosts converge in the reference keyframe), and
// (4) a warp a pixel adds its ranked entries in order. (5) Each level's
// words pooled 2x2 from the level below (a warp a word, a lane a cell: the
// words by bit operations, an occupied cell's sums from its four
// children), a barrier a level. (6) The candidates of every level (a warp
// a word: the words' shifted ORs, a lane a cell dilated, normalised and
// gated, the good bits by a ballot), each block counting its words' good
// cells. (7) The lists: a good cell's raster rank is the counts of the
// blocks before it plus a block scan; the level-0 and duplicate words are
// zeroed for the next launch (the buffers are allocated zeroed and reused
// in stream order).
// No float atomics: two runs give the same bits. `stamps` (optional) gets
// block 0's phase cycles (below).

#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"
#include "plain_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using dsslam::clamp_min;
using namespace dsslam::rn;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 8;
constexpr int kMaxPoints = 48 * 1024;
constexpr int kSmemList = 4096;           // the duplicates' list in shared memory up to this
constexpr int kImageTileCols = 256;       // level-0 columns of an image tile
constexpr int kSmemMax = 200 * 1024;      // the dynamic shared memory a block may take
// stamps (block 0's cycles): the points, block 1's image tiles, the wait
// at the first barrier, the lone points and the list (with its barrier),
// the list's ranks and sums (with theirs), the pooling (its barriers too),
// the candidates, the wait at their barrier, the lists
enum { kStampPoints, kStampImage, kStampBarrier, kStampLone, kStampDuplicates, kStampPool,
       kStampCandidates, kStampBarrier2, kStampLists, kTemplateStamps };
static_assert(kTemplateStamps == 9, "ops/template.py's TEMPLATE_STAMPS");

// ops/template.py mirrors this struct field for field. The caller fills
// the shapes, the inputs and the buffers; dsslam_template derives the rest.
struct TemplateParams {
  int N, H, W, levels, img_row, img_col, grid, mode, n_slots, cap;
  int trh_slot, trh_row, trh_col;        // T_rh's strides
  // derived: the words, the lanes, the words a block takes
  int bits_total, n_lanes, chunk;
  int h[kMaxLevels], w[kMaxLevels], budget[kMaxLevels];
  int nw[kMaxLevels], bits_off[kMaxLevels], boff[kMaxLevels];  // derived
  // points mode (0): pu, pv, pid, pw [N], valid [N] or null (all valid);
  // state mode (1): p_u, p_v, p_idepth, hdd in pu, pv, pid, pw, p_valid in
  // valid, p_host [N], T_rh [n_slots, 4, 4] (strided), calib [4] (fx, fy,
  // cx, cy)
  const float *pu, *pv, *pid, *pw;
  const unsigned char* valid;
  const long long* host;
  const float *trh, *calib;
  const float* img;                      // level 0's intensity, img_row / img_col apart
  float* maps;                           // the per-level maps (dsslam_template_sizes)
  // [2 bits_total + h0 nw0 + grid kMaxLevels + 1]: every level's
  // occupancy words, the good words, level 0's duplicate words, each
  // block's good cells a level, the list's length; the level-0 and
  // duplicate words are zero at a launch's start
  unsigned* bits;
  // [7 cap]: the points' pixels and summands, the list's pixels and
  // points, the ranked list's summands
  unsigned* pts;
  float* out;                            // [4, n_lanes]: pu, pv, pid, pcolor
  unsigned char* out_mask;               // [n_lanes]
  long long* stamps;                     // [kTemplateStamps] cycles, or null
  // derived from `maps`: a level's sums (valid where its bit is set), its
  // normalised idepth and colour (valid where good), its image (levels >= 1)
  float *sum[kMaxLevels], *wsum[kMaxLevels], *idn[kMaxLevels], *col[kMaxLevels];
  float* limg[kMaxLevels];
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

// The state mode's projection of point i, models/ba.py::template_project
// operation by operation: (proj_u, proj_v, new_id, w, valid). The pool's
// host slots lie in [0, n_slots) (an empty row's is 0); one outside would
// fail the plain version's index, and reads a NaN pose here.
__device__ __forceinline__ void project(const TemplateParams& p, int i, float& u, float& v,
                                        float& id, float& w, bool& valid) {
  const float fx = p.calib[0], fy = p.calib[1], cx = p.calib[2], cy = p.calib[3];
  const float inv = clamp_min(p.pid[i], 1e-6f);
  const float x0 = dvd(dvd(sub(p.pu[i], cx), fx), inv);
  const float x1 = dvd(dvd(sub(p.pv[i], cy), fy), inv);
  const float x2 = dvd(1.f, inv);
  const long long h = p.host[i];
  float pt[3];
  if (h < 0 || h >= p.n_slots) {
    pt[0] = pt[1] = pt[2] = __int_as_float(0x7fc00000);
  } else {
    const float* T = p.trh + h * p.trh_slot;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* row = T + r * p.trh_row;
      pt[r] = add(add(add(mul(row[0], x0), mul(row[p.trh_col], x1)), mul(row[2 * p.trh_col], x2)),
                  row[3 * p.trh_col]);
    }
  }
  u = add(dvd(mul(fx, pt[0]), pt[2]), cx);
  v = add(dvd(mul(fy, pt[1]), pt[2]), cy);
  id = num_over(1.f, clamp_min(pt[2], 1e-6f));
  valid = p.valid[i] != 0 && pt[2] > 0.f;
  w = __fsqrt_rn(mul(1e-3f, clamp_min(p.pw[i], 1e-9f)));
}

// Point i's pixel and its two summands (proj_id * wgt, wgt).
__device__ __forceinline__ unsigned point_of(const TemplateParams& p, int i, float& vd,
                                             float& vw) {
  float u, v, id, w;
  bool val;
  if (p.mode == 1) {
    project(p, i, u, v, id, w, val);
  } else {
    u = p.pu[i];
    v = p.pv[i];
    id = p.pid[i];
    w = p.pw[i];
    val = p.valid == nullptr || p.valid[i] != 0;
  }
  const bool ok = val && id > 0.f && u >= 0.f && v >= 0.f && u < static_cast<float>(p.W) &&
                  v < static_cast<float>(p.H);
  vw = ok ? w : 0.f;
  vd = mul(id, vw);
  return static_cast<unsigned>(pixel_of(v, p.H) * p.W + pixel_of(u, p.W));
}

__device__ __forceinline__ float image_at(const TemplateParams& p, int l, int y, int x) {
  return l == 0 ? p.img[static_cast<size_t>(y) * p.img_row + static_cast<size_t>(x) * p.img_col]
                : __ldcg(p.limg[l] + static_cast<size_t>(y) * p.w[l] + x);
}

// The exclusive prefix of v over the block's threads, and the total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* s_scan, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int z = s_scan[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, z, o);
      if (lane >= o) z += y;
    }
    s_scan[lane] = z;
  }
  __syncthreads();
  const int out = x - v + (warp > 0 ? s_scan[warp - 1] : 0);
  total = s_scan[kWarps - 1];
  __syncthreads();                       // s_scan is rewritten by the next scan
  return out;
}

// The pairs of a word's bits ORed: bit j of the result is bit 2j | bit
// 2j + 1 (16 bits).
__device__ __forceinline__ unsigned pair_or(unsigned v) {
  v = (v | (v >> 1)) & 0x55555555u;
  v = (v | (v >> 1)) & 0x33333333u;
  v = (v | (v >> 2)) & 0x0f0f0f0fu;
  v = (v | (v >> 4)) & 0x00ff00ffu;
  return (v | (v >> 8)) & 0x0000ffffu;
}

// `bits` after every level's occupancy and good words: level 0's
// duplicate words, each block's good cells a level, the list's length.
__device__ __forceinline__ unsigned* dup_words(const TemplateParams& p) {
  return p.bits + 2 * p.bits_total;
}
__device__ __forceinline__ unsigned* block_counts(const TemplateParams& p) {
  return dup_words(p) + p.h[0] * p.nw[0];
}
__device__ __forceinline__ unsigned* list_length(const TemplateParams& p) {
  return block_counts(p) + p.grid * kMaxLevels;
}

// A summand that changes a sum: neither +0 nor -0.
__device__ __forceinline__ bool live(float v) { return (__float_as_uint(v) << 1) != 0u; }

// Step 1, a thread a point: its pixel and summands kept, its bit set in
// the level-0 words (and in the duplicate words if it was set already),
// its pixel's sums +0.
__device__ void points_step(const TemplateParams& p) {
  unsigned* T0 = p.bits;
  unsigned* D0 = dup_words(p);
  unsigned* key = p.pts;
  if (blockIdx.x == 0 && threadIdx.x == 0) *list_length(p) = 0u;
  float* vd = reinterpret_cast<float*>(p.pts + p.cap);
  float* vw = reinterpret_cast<float*>(p.pts + 2 * p.cap);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.N; i += gridDim.x * kThreads) {
    float a, c;
    const unsigned k = point_of(p, i, a, c);
    key[i] = k;
    vd[i] = a;
    vw[i] = c;
    const int y = static_cast<int>(k / p.W), x = static_cast<int>(k) - y * p.W;
    const int wd = y * p.nw[0] + (x >> 5);
    const unsigned bit = 1u << (x & 31);
    if (atomicOr(T0 + wd, bit) & bit) atomicOr(D0 + wd, bit);
    p.sum[0][k] = 0.f;
    p.wsum[0][k] = 0.f;
  }
}

// Step 2: a live point alone on its pixel writes its pixel's sums; one on
// a duplicate pixel joins the list.
__device__ void lone_step(const TemplateParams& p) {
  const unsigned* D0 = dup_words(p);
  unsigned* n_list = list_length(p);
  const unsigned* key = p.pts;
  const float* vd = reinterpret_cast<const float*>(p.pts + p.cap);
  const float* vw = reinterpret_cast<const float*>(p.pts + 2 * p.cap);
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < p.N; i += gridDim.x * kThreads) {
    const float a = vd[i], c = vw[i];
    if (!live(a) && !live(c)) continue;
    const unsigned k = key[i];
    const int y = static_cast<int>(k / p.W), x = static_cast<int>(k) - y * p.W;
    if ((__ldcg(D0 + y * p.nw[0] + (x >> 5)) >> (x & 31)) & 1u) {
      const unsigned m = atomicAdd(n_list, 1u);
      p.pts[3 * p.cap + m] = k;
      p.pts[4 * p.cap + m] = i;
    } else {
      p.sum[0][k] = add(0.f, a);
      p.wsum[0][k] = add(0.f, c);
    }
  }
}

// Step 3, over the grid, a warp a list entry (the list in each block's
// shared memory when it fits): its rank by (pixel, point) among the
// entries; the entry's pixel and summands written at its rank, over the
// points' pixels (no longer read) and the buffer's last two parts.
__device__ void rank_step(const TemplateParams& p, unsigned char* smem) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5), GW = gridDim.x * kWarps;
  const unsigned M = __ldcg(list_length(p));
  const unsigned* lk = p.pts + 3 * p.cap;
  const unsigned* li = p.pts + 4 * p.cap;
  const float* vd = reinterpret_cast<const float*>(p.pts + p.cap);
  const float* vw = reinterpret_cast<const float*>(p.pts + 2 * p.cap);
  const bool in_smem = M <= kSmemList;
  if (in_smem) {
    unsigned* sk = reinterpret_cast<unsigned*>(smem);
    for (unsigned m = threadIdx.x; m < M; m += kThreads) {
      sk[m] = __ldcg(lk + m);
      sk[M + m] = __ldcg(li + m);
    }
    __syncthreads();
    lk = sk;
    li = sk + M;
  }
  auto at = [&](const unsigned* a, unsigned j) { return in_smem ? a[j] : __ldcg(a + j); };
  for (unsigned m = gw; m < M; m += GW) {
    const unsigned km = at(lk, m), im = at(li, m);
    const float a = __ldcg(vd + im), c = __ldcg(vw + im);
    unsigned r = 0;
    for (unsigned j = lane; j < M; j += 32) {
      const unsigned kj = at(lk, j);
      r += kj < km || (kj == km && at(li, j) < im);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) r += __shfl_xor_sync(kFull, r, o);
    if (lane == 0) {
      p.pts[r] = km;
      p.pts[5 * p.cap + r] = __float_as_uint(a);
      p.pts[6 * p.cap + r] = __float_as_uint(c);
    }
  }
}

// Step 4, over the grid, a warp a ranked entry: the first entry of a
// pixel adds its entries' summands to +0 in order, 32 read at a time.
__device__ void groups_step(const TemplateParams& p) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5), GW = gridDim.x * kWarps;
  const unsigned M = __ldcg(list_length(p));
  const unsigned* ok = p.pts;
  const float* od = reinterpret_cast<const float*>(p.pts + 5 * p.cap);
  const float* ow = reinterpret_cast<const float*>(p.pts + 6 * p.cap);
  for (unsigned r = gw; r < M; r += GW) {
    const unsigned k = __ldcg(ok + r);
    if (r > 0 && __ldcg(ok + r - 1) == k) continue;
    float a = 0.f, c = 0.f;
    for (unsigned base = r;; base += 32) {
      const unsigned j = base + lane;
      const bool mine = j < M && __ldcg(ok + j) == k;   // the pixel's entries: a prefix
      const float dj = mine ? __ldcg(od + j) : 0.f, wj = mine ? __ldcg(ow + j) : 0.f;
      const unsigned m = __ballot_sync(kFull, mine);
      for (unsigned b = m; b; b &= b - 1u) {
        const int src = __ffs(b) - 1;
        a = add(a, __shfl_sync(kFull, dj, src));
        c = add(c, __shfl_sync(kFull, wj, src));
      }
      if (m != kFull) break;
    }
    if (lane == 0) {
      p.sum[0][k] = a;
      p.wsum[0][k] = c;
    }
  }
}

// Levels >= 1 of the image, `0.25 * _pool` of the level below, tile by
// tile: a tile is R = 2^(levels - 1) level-0 rows by kImageTileCols
// columns, so each cell of a level lies in one tile with its four children;
// a block takes tiles first, first + stride, ...
__device__ void image_phase(const TemplateParams& p, int first, int stride) {
  if (p.levels < 2) return;
  const int R = 1 << (p.levels - 1), CW = max(kImageTileCols, R);
  const int nty = (p.H + R - 1) / R, ntx = (p.W + CW - 1) / CW;
  for (int t = first; t < nty * ntx; t += stride) {
    const int ty = t / ntx, tx = t - ty * ntx;
    for (int l = 1; l < p.levels; ++l) {
      const int rows = R >> l, cols = CW >> l;
      const int y0 = ty * rows, x0 = tx * cols;
      const int ny = min(y0 + rows, p.h[l]) - y0, nx = min(x0 + cols, p.w[l]) - x0;
      if (ny > 0 && nx > 0)
        for (int c = threadIdx.x; c < ny * nx; c += kThreads) {
          const int y = y0 + c / nx, x = x0 + c % nx;
          float i[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int yy = 2 * y + (q >> 1), xx = 2 * x + (q & 1);
            i[q] = l == 1 ? p.img[static_cast<size_t>(yy) * p.img_row +
                                  static_cast<size_t>(xx) * p.img_col]
                          : p.limg[l - 1][static_cast<size_t>(yy) * p.w[l - 1] + xx];
          }
          p.limg[l][static_cast<size_t>(y) * p.w[l] + x] =
              mul(add(add(add(i[0], i[1]), i[2]), i[3]), 0.25f);
        }
      __syncthreads();                   // the next level reads this one
    }
  }
}

// Level l + 1's occupancy words and its occupied cells' sums, from level
// l, over the grid: a warp a word, a lane a cell.
__device__ void pool_level(const TemplateParams& p, int l) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5), GW = gridDim.x * kWarps;
  const int H1 = p.h[l + 1], W1 = p.w[l + 1], nw1 = p.nw[l + 1], nw0 = p.nw[l], Wl = p.w[l];
  const unsigned* T0 = p.bits + p.bits_off[l];
  unsigned* T1 = p.bits + p.bits_off[l + 1];
  const float *s0 = p.sum[l], *w0 = p.wsum[l];
  for (int wi = gw; wi < H1 * nw1; wi += GW) {
    const int y = wi / nw1, k = wi - y * nw1;
    const unsigned* ra = T0 + 2 * y * nw0;
    const unsigned* rb = ra + nw0;
    const unsigned a0 = __ldcg(ra + 2 * k), b0 = __ldcg(rb + 2 * k);
    const unsigned a1 = 2 * k + 1 < nw0 ? __ldcg(ra + 2 * k + 1) : 0u;
    const unsigned b1 = 2 * k + 1 < nw0 ? __ldcg(rb + 2 * k + 1) : 0u;
    unsigned m = pair_or(a0 | b0) | (pair_or(a1 | b1) << 16);
    const int live = W1 - 32 * k;          // an odd level's last column drops out here
    if (live < 32) m &= (1u << live) - 1u;
    if (lane == 0) T1[wi] = m;
    if ((m >> lane) & 1u) {
      const int x = 32 * k + lane;
      const unsigned ca = lane < 16 ? a0 : a1, cb = lane < 16 ? b0 : b1;
      const int sb = (2 * lane) & 31;
      const size_t q = static_cast<size_t>(2 * y) * Wl + 2 * x, qb = q + Wl;
      const bool tl = (ca >> sb) & 1u, tr = (ca >> (sb + 1)) & 1u;
      const bool bl = (cb >> sb) & 1u, br = (cb >> (sb + 1)) & 1u;
      const size_t c = static_cast<size_t>(y) * W1 + x;
      p.sum[l + 1][c] = add(add(add(tl ? __ldcg(s0 + q) : 0.f, tr ? __ldcg(s0 + q + 1) : 0.f),
                                bl ? __ldcg(s0 + qb) : 0.f),
                            br ? __ldcg(s0 + qb + 1) : 0.f);
      p.wsum[l + 1][c] = add(add(add(tl ? __ldcg(w0 + q) : 0.f, tr ? __ldcg(w0 + q + 1) : 0.f),
                                 bl ? __ldcg(w0 + qb) : 0.f),
                             br ? __ldcg(w0 + qb + 1) : 0.f);
    }
  }
}

// The words around word k of row y: nb[r][c] is word k - 1 + c of row
// y - 1 + r (0 outside the level); rows end in zero bits.
__device__ __forceinline__ void neighbour_words(const unsigned* T, int Hl, int nw, int y, int k,
                                                unsigned (&nb)[3][3]) {
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int yy = y - 1 + r, kk = k - 1 + c;
      nb[r][c] = yy >= 0 && yy < Hl && kk >= 0 && kk < nw ? __ldcg(T + yy * nw + kk) : 0u;
    }
}

// `_dilate_once`'s offsets, out[y, x] reading in[y + dy, x + dx]: diag
// [(1, 1), (-1, -1), (1, -1), (-1, 1)] on levels 0-1 (SET 0), axes [(0, 1),
// (0, -1), (1, 0), (-1, 0)] above (SET 1)
template <int SET>
__device__ __forceinline__ constexpr int offset_dy(int o) {
  return SET == 0 ? (o == 0 || o == 2 ? 1 : -1) : (o < 2 ? 0 : (o == 2 ? 1 : -1));
}
template <int SET>
__device__ __forceinline__ constexpr int offset_dx(int o) {
  return SET == 0 ? (o == 0 || o == 3 ? 1 : -1) : (o == 0 ? 1 : (o == 1 ? -1 : 0));
}

// The candidates of the word: the cells that are occupied or have an
// occupied dilation neighbour (bit x of plus(r) is cell x + 1 of row r, of
// minus(r) cell x - 1).
template <int SET>
__device__ __forceinline__ unsigned candidates(const unsigned (&nb)[3][3]) {
  auto plus = [&](int r) { return (nb[r][1] >> 1) | (nb[r][2] << 31); };
  auto minus = [&](int r) { return (nb[r][1] << 1) | (nb[r][0] >> 31); };
  if (SET == 0) return nb[1][1] | plus(2) | minus(0) | minus(2) | plus(0);
  return nb[1][1] | plus(1) | minus(1) | nb[2][1] | nb[0][1];
}

// Cell (y, x = 32 k + b) of level l dilated (`_dilate_once`, a cell's sums
// read where its bit is set, +0 elsewhere), normalised and gated; a good
// cell's idepth and colour kept.
template <int SET>
__device__ __forceinline__ bool cell_good(const TemplateParams& p, int l, int y, int x, int b,
                                          const unsigned (&nb)[3][3]) {
  const int Wl = p.w[l], Hl = p.h[l];
  const float* S = p.sum[l];
  const float* Wm = p.wsum[l];
  const float iv = image_at(p, l, y, x);   // read with the sums, used if the other gates pass
  // the bit of cell (y + dy, x + dx), dx in -1 .. 1, from the words around
  auto occupied = [&](int dy, int dx) {
    const int bb = b + dx;
    const unsigned wd = bb < 0 ? nb[1 + dy][0] : (bb > 31 ? nb[1 + dy][2] : nb[1 + dy][1]);
    return ((wd >> (bb & 31)) & 1u) != 0u;
  };
  float s = 0.f, n = 0.f, cnt = 0.f;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int dy = offset_dy<SET>(o), dx = offset_dx<SET>(o);
    const bool t = occupied(dy, dx);
    const size_t q = static_cast<size_t>(y + dy) * Wl + (x + dx);
    const float w_s = t ? __ldcg(Wm + q) : 0.f;
    const float i_s = t ? __ldcg(S + q) : 0.f;
    const float m = w_s > 0.f ? 1.f : 0.f;
    s = add(s, mul(i_s, m));
    n = add(n, mul(w_s, m));
    cnt = add(cnt, m);
  }
  const size_t c = static_cast<size_t>(y) * Wl + x;
  const bool self = occupied(0, 0);
  float d = self ? __ldcg(S + c) : 0.f, w = self ? __ldcg(Wm + c) : 0.f;
  if (w <= 0.f && cnt > 0.f) {
    const float cs = cnt < 1.f ? 1.f : cnt;
    d = dvd(s, cs);
    w = dvd(n, cs);
  }
  const float idn = dvd(d, clamp_min(w, 1e-12f));
  const bool border = y >= 2 && y < Hl - 2 && x >= 2 && x < Wl - 2;
  if (!(border && w > 0.f && idn > 0.f && isfinite(iv))) return false;
  p.idn[l][c] = idn;
  p.col[l][c] = iv;
  return true;
}

// The level of word `wa` of all levels' words.
__device__ __forceinline__ int level_of(const TemplateParams& p, int wa) {
  int l = 0;
  while (l + 1 < p.levels && wa >= p.bits_off[l + 1]) ++l;
  return l;
}

// Each block's words [b chunk, (b + 1) chunk) of all levels: a warp a
// word, a lane a candidate cell; the good words and the block's good
// cells a level.
__device__ void candidates_step(const TemplateParams& p, int* s_cnt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.x;
  const int r0 = min(p.bits_total, b * p.chunk), r1 = min(p.bits_total, r0 + p.chunk);
  if (tid < kMaxLevels) s_cnt[tid] = 0;
  __syncthreads();
  for (int wa = r0 + warp; wa < r1; wa += kWarps) {
    const int l = level_of(p, wa);
    const int nw = p.nw[l], wi = wa - p.bits_off[l], y = wi / nw, k = wi - y * nw;
    unsigned nb[3][3];
    neighbour_words(p.bits + p.bits_off[l], p.h[l], nw, y, k, nb);
    unsigned c = l < 2 ? candidates<0>(nb) : candidates<1>(nb);
    const int live = p.w[l] - 32 * k;
    if (live < 32) c &= (1u << live) - 1u;
    bool g = false;
    if ((c >> lane) & 1u)
      g = l < 2 ? cell_good<0>(p, l, y, 32 * k + lane, lane, nb)
                : cell_good<1>(p, l, y, 32 * k + lane, lane, nb);
    const unsigned gw = __ballot_sync(kFull, g);
    if (lane == 0) {
      p.bits[p.bits_total + wa] = gw;
      if (gw) atomicAdd(s_cnt + l, __popc(gw));
    }
  }
  __syncthreads();
  if (tid < kMaxLevels) block_counts(p)[b * kMaxLevels + tid] = s_cnt[tid];
}

// The lists: a good cell's rank is its level's good cells in the blocks
// before (their counts), in this block's words before (a block scan), and
// in its word before it; the lanes past a level's count zeroed over the
// grid.
__device__ void lists_step(const TemplateParams& p, int* s_pre, int* s_scan,
                           int (*s_red)[2 * kMaxLevels], int* s_lvl) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, b = blockIdx.x, G = gridDim.x;
  const unsigned* counts = block_counts(p);
  const unsigned* good = p.bits + p.bits_total;
  // s_lvl[l]: the level's good cells in the blocks before this one;
  // s_lvl[kMaxLevels + l]: in all blocks
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    const int v = tid < G ? static_cast<int>(__ldcg(counts + tid * kMaxLevels + l)) : 0;
    int before = tid < b ? v : 0, all = v;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_xor_sync(kFull, before, o);
      all += __shfl_xor_sync(kFull, all, o);
    }
    if (lane == 0) {
      s_red[warp][l] = before;
      s_red[warp][kMaxLevels + l] = all;
    }
  }
  __syncthreads();
  if (tid < 2 * kMaxLevels) {
    int v = 0;
    for (int w = 0; w < kWarps; ++w) v += s_red[w][tid];
    s_lvl[tid] = v;
  }
  // this block's words' good cells before each word (a block scan)
  const int r0 = min(p.bits_total, b * p.chunk), r1 = min(p.bits_total, r0 + p.chunk);
  int carry = 0;
  for (int c0 = r0; c0 < r1; c0 += kThreads) {
    const int wa = c0 + tid;
    int total;
    const int pre = block_exclusive_scan(wa < r1 ? __popc(__ldcg(good + wa)) : 0, s_scan, total);
    if (wa < r1) s_pre[wa - r0] = carry + pre;
    carry += total;
  }
  __syncthreads();
  for (int wa = r0 + warp; wa < r1; wa += kWarps) {
    const unsigned g = __ldcg(good + wa);
    if (!g || !((g >> lane) & 1u)) continue;
    const int l = level_of(p, wa);
    const int first = max(r0, p.bits_off[l]);
    const int r = s_lvl[l] + s_pre[wa - r0] - s_pre[first - r0] + __popc(g & ((1u << lane) - 1u));
    if (r >= p.budget[l]) continue;
    const int nw = p.nw[l], wi = wa - p.bits_off[l], y = wi / nw, x = 32 * (wi - y * nw) + lane;
    const size_t c = static_cast<size_t>(y) * p.w[l] + x;
    float* o = p.out + p.boff[l] + r;
    o[0] = static_cast<float>(x);
    o[p.n_lanes] = static_cast<float>(y);
    o[2 * p.n_lanes] = __ldcg(p.idn[l] + c);
    o[3 * p.n_lanes] = __ldcg(p.col[l] + c);
    p.out_mask[p.boff[l] + r] = 1;
  }
  for (int l = 0; l < p.levels; ++l)
    for (int j = min(s_lvl[kMaxLevels + l], p.budget[l]) + b * kThreads + tid; j < p.budget[l];
         j += G * kThreads) {
      float* o = p.out + p.boff[l] + j;
      o[0] = 0.f;
      o[p.n_lanes] = 0.f;
      o[2 * p.n_lanes] = 0.f;
      o[3 * p.n_lanes] = 0.f;
      p.out_mask[p.boff[l] + j] = 0;
    }
  // the level-0 and duplicate words zeroed for the next launch (no step
  // after the candidates reads them)
  const int n0 = p.h[0] * p.nw[0];
  for (int wi = b * kThreads + tid; wi < n0; wi += G * kThreads) {
    p.bits[wi] = 0u;
    dup_words(p)[wi] = 0u;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    template_kernel(const __grid_constant__ TemplateParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_scan[kWarps];
  __shared__ int s_red[kWarps][2 * kMaxLevels];
  __shared__ int s_lvl[2 * kMaxLevels];
  cg::grid_group grid = cg::this_grid();
  const int b = blockIdx.x;
  long long* stamp = p.stamps && b == 0 && threadIdx.x == 0 ? p.stamps : nullptr;
  long long t0 = clock64();
  auto lap = [&](int k) {
    if (stamp) stamp[k] = clock64() - t0;
    t0 = clock64();
  };

  points_step(p);
  lap(kStampPoints);
  {
    const long long t1 = clock64();
    image_phase(p, b, gridDim.x);
    if (p.stamps && threadIdx.x == 0 && b == (gridDim.x > 1 ? 1 : 0))
      p.stamps[kStampImage] = clock64() - t1;
  }
  t0 = clock64();
  grid.sync();                           // the points' bits, pixels and +0 sums; the image
  lap(kStampBarrier);
  lone_step(p);
  grid.sync();                           // the lone points' sums, the list
  lap(kStampLone);
  rank_step(p, smem);
  grid.sync();                           // the list in (pixel, point) order
  groups_step(p);
  grid.sync();                           // every pixel's sums
  lap(kStampDuplicates);
  for (int l = 0; l + 1 < p.levels; ++l) {
    pool_level(p, l);
    grid.sync();                         // level l + 1's sums and words
  }
  lap(kStampPool);
  candidates_step(p, s_scan);
  lap(kStampCandidates);
  grid.sync();                           // every block's good words and counts
  lap(kStampBarrier2);
  lists_step(p, reinterpret_cast<int*>(smem), s_scan, s_red, s_lvl);
  lap(kStampLists);
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

// The levels' shapes, words and offsets from H, W and the levels; false
// if a level is empty.
bool level_layout(TemplateParams& p) {
  p.h[0] = p.H;
  p.w[0] = p.W;
  for (int l = 1; l < p.levels; ++l) {
    p.h[l] = p.h[l - 1] / 2;
    p.w[l] = p.w[l - 1] / 2;
  }
  p.bits_total = 0;
  for (int l = 0; l < p.levels; ++l) {
    if (p.h[l] < 1 || p.w[l] < 1) return false;
    p.nw[l] = (p.w[l] + 31) / 32;
    p.bits_off[l] = p.bits_total;
    p.bits_total += p.h[l] * p.nw[l];
  }
  return true;
}

// Floats of the per-level maps: a level's sum, weight sum, idepth and
// colour, and its image above level 0.
long long map_floats(const TemplateParams& p) {
  long long n = 0;
  for (int l = 0; l < p.levels; ++l)
    n += static_cast<long long>(p.h[l]) * p.w[l] * (l > 0 ? 5 : 4);
  return n;
}

bool shape_ok(const TemplateParams& p) {
  return p.levels >= 1 && p.levels <= kMaxLevels && p.H >= 1 && p.W >= 1 &&
         static_cast<long long>(p.H) * p.W < (1ll << 31) && p.grid >= 1 && p.grid <= kThreads;
}

}  // namespace

// The buffers a launch on `grid` blocks needs: out[0] floats of `maps`,
// out[1] words of `bits` (allocate them zeroed), out[2] words of `pts`
// (for up to cap points). Host only.
DSSLAM_API int dsslam_template_sizes(int H, int W, int levels, int grid, int cap,
                                     long long* out) {
  TemplateParams p{};
  p.H = H;
  p.W = W;
  p.levels = levels;
  p.grid = grid;
  if (!shape_ok(p) || cap < 0 || cap > kMaxPoints || !level_layout(p))
    return cudaErrorInvalidValue;
  out[0] = map_floats(p);
  out[1] = 2ll * p.bits_total + static_cast<long long>(p.h[0]) * p.nw[0] +
           static_cast<long long>(grid) * kMaxLevels + 1;
  out[2] = 7ll * cap;
  return cudaSuccess;
}

// `grid` is a block an SM (ops/template.py); the cooperative launch fails
// unless every block is resident with its dynamic shared memory.
DSSLAM_API int dsslam_template(const TemplateParams* params, cudaStream_t stream) {
  TemplateParams p = *params;
  if (!shape_ok(p) || p.N < 0 || p.N > p.cap || p.cap > kMaxPoints || !level_layout(p) ||
      !p.img || !p.maps || !p.bits || !p.pts || !p.out || !p.out_mask ||
      (p.N > 0 && (!p.pu || !p.pv || !p.pid || !p.pw)))
    return cudaErrorInvalidValue;
  if (p.mode == 1 && p.N > 0 && (!p.valid || !p.host || !p.trh || !p.calib || p.n_slots < 1))
    return cudaErrorInvalidValue;
  p.n_lanes = 0;
  for (int l = 0; l < p.levels; ++l) {
    if (p.budget[l] < 1) return cudaErrorInvalidValue;
    p.boff[l] = p.n_lanes;
    p.n_lanes += p.budget[l];
  }
  float* m = p.maps;
  for (int l = 0; l < p.levels; ++l) {
    const size_t n = static_cast<size_t>(p.h[l]) * p.w[l];
    p.sum[l] = m;
    p.wsum[l] = m + n;
    p.idn[l] = m + 2 * n;
    p.col[l] = m + 3 * n;
    p.limg[l] = l > 0 ? m + 4 * n : nullptr;
    m += (l > 0 ? 5 : 4) * n;
  }
  p.chunk = (p.bits_total + p.grid - 1) / p.grid;
  // the duplicates' list, a block's word prefix (the lists)
  long long smem = 8ll * (p.N < kSmemList ? p.N : kSmemList);
  if (4ll * p.chunk > smem) smem = 4ll * p.chunk;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t err = grant_smem(static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(template_kernel), dim3(p.grid),
                                    dim3(kThreads), args, static_cast<size_t>(smem), stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
