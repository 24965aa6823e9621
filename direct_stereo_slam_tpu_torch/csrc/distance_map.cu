// K1: activation distance map (replaces the Pallas kernel
// direct_stereo_slam_tpu/ops/distance_map.py::_dist_kernel, launched by
// _distance_from_occupancy(use_pallas=True), distance_map.py:56-66).
//
// Computes: occupancy of the projected active points on the half-res grid
// (round half to even, clip), then 16 (MAX_DIST) 3x3 min-plus relaxations
// with MAX_DIST borders. That is exactly min(16, Chebyshev distance to the
// nearest occupied cell): cells outside the grid stay at 16 and can lower
// nothing, and a rectangle is convex under 8-connected moves, so the
// shortest path between two cells of the grid never needs to leave it.
// Values are small integers in f32, so the result is bit-equal to the
// plain version.
//
// What bounds it on the H100: the KITTI half-res grid (184x616 f32, 453
// KB) is written once and the points (n <= 8192, 9 B each) read once, a
// fraction of a microsecond at 3.35 TB/s; done naively the 16 dependent
// stencil sweeps are 16 round trips through memory. Design: ONE launch,
// the distance as an exact integer form on bits. Each block owns a tile
// of 32 rows x 256 columns (8 words of 32 cells) and keeps the occupancy
// of its span (the tile plus 16 rows above and below and one word, 32
// columns, left and right) as bit rows in shared memory: 64 rows x 10
// words. It reads every point once and sets its bit with atomicOr (OR
// commutes, so the order does not matter). Then 15 steps of a 3x3
// dilation on words (w | w << 1 | w >> 1 with the neighbour words'
// carries, OR-ed over three rows) give D_1 ... D_15, the cells within
// Chebyshev distance k of a point, each of the 640 threads dilating its
// own word of the span from its 8 neighbours; a cell's distance is the
// number of D_0 ... D_15 that miss it, which the thread of each word of
// the tile adds into a 5-plane bit-sliced counter in registers. A cell
// k < 16 steps in from the span's edge may miss points outside the span,
// and 16 rows and 32 columns of halo keep that error out of the tile.
// The counters go through shared memory once, and the block writes its
// f32 tile in one coalesced pass. Bits outside the grid never start set;
// the dilation may pass through them, which the convexity above makes
// exact. No occupancy grid in device memory, nothing to allocate but the
// output. (Bands that exchange halo rows over distributed shared memory
// would need a cluster barrier per step; the redundant halo costs a few
// word operations instead.)

#include "common.cuh"

namespace {

constexpr int kSteps = 16;                 // ops/distance_map.py MAX_DIST
constexpr int kTileRows = 32;
constexpr int kTileWords = 8;              // 32 cells a word
constexpr int kHaloRows = kSteps;          // one row of reach per step
constexpr int kSpanRows = kTileRows + 2 * kHaloRows;
constexpr int kSpanWords = kTileWords + 2; // 16 columns of reach fit in a word
constexpr int kSpanCells = kSpanRows * kSpanWords;
constexpr int kThreads = kSpanCells;       // one span word each
constexpr int kPlanes = 5;                 // counts 0 ... 16
constexpr int kTileCells = kTileRows * kTileWords * 32;

__global__ void __launch_bounds__(kThreads)
distance_kernel(const float* __restrict__ pu, const float* __restrict__ pv,
                const unsigned char* __restrict__ mask, int n,
                float* __restrict__ out, int h2, int w2) {
  __shared__ unsigned bits[2][kSpanRows][kSpanWords];   // D_k, ping-pong
  __shared__ unsigned count[kPlanes][kTileRows][kTileWords];
  const int tid = threadIdx.x;
  const int y = tid / kSpanWords, x = tid % kSpanWords;  // this thread's word
  const bool inner = y >= kHaloRows && y < kHaloRows + kTileRows && x >= 1 &&
                     x <= kTileWords;
  const int row0 = static_cast<int>(blockIdx.y) * kTileRows - kHaloRows;
  const int col0 = (static_cast<int>(blockIdx.x) * kTileWords - 1) * 32;
  bits[0][y][x] = 0u;
  __syncthreads();
  // unconditional loads, unrolled, so several L2 reads are in flight
#pragma unroll 4
  for (int i = tid; i < n; i += kThreads) {
    const float u = pu[i], v = pv[i];
    const bool m = mask[i] != 0;
    // rintf rounds half to even like jnp.round; clamping in float before
    // the int conversion equals the reference's saturating cast + clip
    const int gx = static_cast<int>(
        fminf(fmaxf(rintf(u), 0.f), static_cast<float>(w2 - 1)));
    const int gy = static_cast<int>(
        fminf(fmaxf(rintf(v), 0.f), static_cast<float>(h2 - 1)));
    const int ty = gy - row0, tx = gx - col0;
    if (m && ty >= 0 && ty < kSpanRows && tx >= 0 && tx < kSpanWords * 32)
      atomicOr(&bits[0][ty][tx >> 5], 1u << (tx & 31));
  }
  __syncthreads();
  unsigned c[kPlanes] = {0u, 0u, 0u, 0u, 0u};
  int cur = 0;
  for (int k = 0;; ++k) {
    // the cells D_k misses add one to their count
    if (inner) {
      unsigned carry = ~bits[cur][y][x];
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        const unsigned t = c[p] & carry;
        c[p] ^= carry;
        carry = t;
      }
    }
    if (k + 1 == kSteps) break;
    // D_{k+1}: D_k dilated by one cell in the 8 directions
    unsigned d = 0u;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
      const int ry = y + dy;
      if (ry < 0 || ry >= kSpanRows) continue;
      const unsigned* r = bits[cur][ry];
      const unsigned mid = r[x];
      const unsigned left = x > 0 ? r[x - 1] : 0u;
      const unsigned right = x + 1 < kSpanWords ? r[x + 1] : 0u;
      d |= mid | (mid << 1) | (mid >> 1) | (left >> 31) | (right << 31);
    }
    bits[cur ^ 1][y][x] = d;
    __syncthreads();
    cur ^= 1;
  }
  if (inner) {
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) count[p][y - kHaloRows][x - 1] = c[p];
  }
  __syncthreads();
  // the tile, row by row: a warp writes 32 neighbouring cells
  for (int k = tid; k < kTileCells; k += kThreads) {
    const int ty = k / (kTileWords * 32), tx = k % (kTileWords * 32);
    const int gy = static_cast<int>(blockIdx.y) * kTileRows + ty;
    const int gx = static_cast<int>(blockIdx.x) * kTileWords * 32 + tx;
    if (gy < h2 && gx < w2) {
      unsigned d = 0u;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) d |= ((count[p][ty][tx >> 5] >> (tx & 31)) & 1u) << p;
      out[static_cast<size_t>(gy) * w2 + gx] = static_cast<float>(d);
    }
  }
}

}  // namespace

DSSLAM_API const char* dsslam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

DSSLAM_API int dsslam_distance_map(const float* pu, const float* pv,
                                   const unsigned char* mask, int n, float* out,
                                   int h2, int w2, cudaStream_t stream) {
  if (h2 < 1 || w2 < 1 || n < 0) return cudaErrorInvalidValue;
  const dim3 grid((w2 + kTileWords * 32 - 1) / (kTileWords * 32),
                  (h2 + kTileRows - 1) / kTileRows);
  distance_kernel<<<grid, kThreads, 0, stream>>>(pu, pv, mask, n, out, h2, w2);
  return cudaGetLastError();
}
