// K1: activation distance map (replaces the Pallas kernel
// direct_stereo_slam_tpu/ops/distance_map.py::_dist_kernel, launched by
// _distance_from_occupancy(use_pallas=True), distance_map.py:56-66).
//
// Computes: occupancy of the projected active points on the half-res grid
// (round half to even, clip), then 16 (MAX_DIST) 3x3 min-plus relaxations
// with MAX_DIST borders = Chebyshev distance to the nearest occupied cell,
// capped at 16. Values are small integers in f32, so the result is
// bit-equal to the plain version.
//
// What bounds it on the H100: the KITTI half-res grid (184x616 f32) is
// small, so launch latency and the 16 dependent stencil sweeps bound it;
// done naively the sweeps are 16 round trips through device memory (or 16
// launches). Design: each block owns a 32x32 output tile and loads it with
// a 16-px halo (a 64x64 f32 tile, ping-ponged in shared memory); 16
// relaxations reach exactly 16 px, so after 16 in-smem sweeps the inner
// tile is exact. 120 blocks cover the KITTI grid in one launch.

#include "common.cuh"

namespace {

constexpr float kMaxDist = 16.f;   // ops/distance_map.py MAX_DIST
constexpr int kIters = 16;         // == MAX_DIST relaxations
constexpr int kTile = 32;
constexpr int kHalo = kIters;      // one pixel of reach per relaxation
constexpr int kSpan = kTile + 2 * kHalo;
constexpr int kThreads = 256;

__global__ void fill_kernel(float* __restrict__ grid, int n, float value) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) grid[i] = value;
}

__global__ void occupancy_kernel(const float* __restrict__ pu,
                                 const float* __restrict__ pv,
                                 const unsigned char* __restrict__ mask, int n,
                                 float* __restrict__ occ, int h2, int w2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !mask[i]) return;
  // rintf rounds half to even like jnp.round; clamping in float before the
  // int conversion equals the reference's saturating cast + clip. Every
  // writer stores the same 0, so concurrent writes need no atomics.
  const float u = fminf(fmaxf(rintf(pu[i]), 0.f), static_cast<float>(w2 - 1));
  const float v = fminf(fmaxf(rintf(pv[i]), 0.f), static_cast<float>(h2 - 1));
  occ[static_cast<int>(v) * w2 + static_cast<int>(u)] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
relax_kernel(const float* __restrict__ occ, float* __restrict__ out, int h2,
             int w2) {
  __shared__ float buf[2][kSpan][kSpan + 1];
  const int y0 = blockIdx.y * kTile - kHalo;
  const int x0 = blockIdx.x * kTile - kHalo;
  for (int k = threadIdx.x; k < kSpan * kSpan; k += kThreads) {
    const int ty = k / kSpan, tx = k % kSpan;
    const int gy = y0 + ty, gx = x0 + tx;
    const bool in = gy >= 0 && gy < h2 && gx >= 0 && gx < w2;
    buf[0][ty][tx] = in ? occ[gy * w2 + gx] : kMaxDist;
  }
  __syncthreads();
  int cur = 0;
  for (int it = 0; it < kIters; ++it) {
    for (int k = threadIdx.x; k < kSpan * kSpan; k += kThreads) {
      const int ty = k / kSpan, tx = k % kSpan;
      const int gy = y0 + ty, gx = x0 + tx;
      const float d = buf[cur][ty][tx];
      float m = d;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int ny = ty + dy, nx = tx + dx;
          const bool ok = ny >= 0 && ny < kSpan && nx >= 0 && nx < kSpan;
          m = fminf(m, ok ? buf[cur][ny][nx] : kMaxDist);
        }
      }
      // cells outside the grid stay at the MAX_DIST border value, as the
      // reference's constant border rows/columns do
      const bool in = gy >= 0 && gy < h2 && gx >= 0 && gx < w2;
      buf[cur ^ 1][ty][tx] = in ? fminf(d, m + 1.f) : kMaxDist;
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int k = threadIdx.x; k < kTile * kTile; k += kThreads) {
    const int iy = k / kTile, ix = k % kTile;
    const int gy = blockIdx.y * kTile + iy, gx = blockIdx.x * kTile + ix;
    if (gy < h2 && gx < w2) out[gy * w2 + gx] = buf[cur][kHalo + iy][kHalo + ix];
  }
}

}  // namespace

DSSLAM_API const char* dsslam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

DSSLAM_API int dsslam_distance_map(const float* pu, const float* pv,
                                   const unsigned char* mask, int n,
                                   float* occ, float* out, int h2, int w2,
                                   cudaStream_t stream) {
  const int cells = h2 * w2;
  fill_kernel<<<(cells + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      occ, cells, kMaxDist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n > 0) {
    occupancy_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        pu, pv, mask, n, occ, h2, w2);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w2 + kTile - 1) / kTile, (h2 + kTile - 1) / kTile);
  relax_kernel<<<grid, kThreads, 0, stream>>>(occ, out, h2, w2);
  return cudaGetLastError();
}
