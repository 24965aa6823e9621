// Shared helpers of the port's CUDA kernels (plain C interface, ctypes).
#pragma once

#include <cuda_runtime.h>

#define DSSLAM_API extern "C" __attribute__((visibility("default")))

namespace dsslam {

// max(x, lo) that keeps a NaN x NaN, as torch.clamp(x, min=lo) and
// jnp.maximum do (fmaxf would return lo).
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// Bilinear read of an [H, W, 3] (I, dx, dy) image with ops/interp.py's
// semantics: clamp to [0, umax] x [0, vmax] (umax = W - 1.001 and
// vmax = H - 1.001, rounded to f32 on the host exactly as the reference
// rounds its weak-typed bound), blend the four taps. A NaN coordinate
// reads NaN, as torch.clamp and jnp.clip keep it NaN; fmaxf alone would
// clamp it to 0, so such a lane reads tap (0, 0) and is overwritten.
__device__ __forceinline__ void sample3(const float* __restrict__ img, int W,
                                        float umax, float vmax, float u,
                                        float v, float& i0, float& gx,
                                        float& gy) {
  const bool nan_uv = isnan(u) || isnan(v);
  u = fminf(fmaxf(u, 0.f), umax);
  v = fminf(fmaxf(v, 0.f), vmax);
  const float fu = floorf(u), fv = floorf(v);
  const int ix = static_cast<int>(fu), iy = static_cast<int>(fv);
  const float fx = u - fu, fy = v - fv;
  const float* p00 = img + 3 * (iy * W + ix);
  const float* p10 = p00 + 3;
  const float* p01 = p00 + 3 * W;
  const float* p11 = p01 + 3;
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = p00[c] * (1.f - fx) + p10[c] * fx;
    const float bot = p01[c] * (1.f - fx) + p11[c] * fx;
    out[c] = top * (1.f - fy) + bot * fy;
  }
  const float qnan = __int_as_float(0x7fc00000);
  i0 = nan_uv ? qnan : out[0];
  gx = nan_uv ? qnan : out[1];
  gy = nan_uv ? qnan : out[2];
}

// Block-wide sum of NACC per-thread accumulators in a fixed order (warp
// shuffles, then warps in index order): the result does not depend on
// scheduling, so repeated runs are bit-identical. Thread k < NACC writes
// sum k to dst[k].
template <int NACC, int THREADS>
__device__ __forceinline__ void block_sum(const float (&acc)[NACC],
                                          float* __restrict__ dst) {
  __shared__ float red[THREADS / 32][NACC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < NACC) {
    float s = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) s += red[w][threadIdx.x];
    dst[threadIdx.x] = s;
  }
}

}  // namespace dsslam

DSSLAM_API const char* dsslam_error_string(int err);
