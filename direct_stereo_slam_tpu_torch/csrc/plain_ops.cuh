// The plain PyTorch versions' elementwise operations, one at a time,
// each rounded as PyTorch rounds it on the card: every operation of the
// plain version is a kernel of its own, so no multiply-add is fused
// between them. Kernels that must give a plain version's bits (K12's
// gate, K14) build their arithmetic from these.
#pragma once

#include <cuda_runtime.h>

namespace dsslam {
namespace rn {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// number / tensor in PyTorch: the reciprocal, then the product
__device__ __forceinline__ float num_over(float n, float x) { return mul(__frcp_rn(x), n); }
// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// torch.minimum(x, hi) with NaN kept
__device__ __forceinline__ float min_keep_nan(float x, float hi) { return x > hi ? hi : x; }

// ops/interp.py's bilinear read of an [H, W, 3] (I, dx, dy) image, with
// its borders (dsslam::sample3's: the coordinates clamped to [0, umax] x
// [0, vmax], a NaN one reads NaN) and its roundings: each lerp's products
// and sum rounded one at a time, as the plain version's separate
// operations are (sample3 lets the compiler fuse them)
__device__ __forceinline__ void sample3_rn(const float* __restrict__ img, int W, float umax,
                                           float vmax, float u, float v, float& i0, float& gx,
                                           float& gy) {
  const bool nan_uv = isnan(u) || isnan(v);
  u = fminf(fmaxf(u, 0.f), umax);
  v = fminf(fmaxf(v, 0.f), vmax);
  const float fu = floorf(u), fv = floorf(v);
  const int ix = static_cast<int>(fu), iy = static_cast<int>(fv);
  const float fx = sub(u, fu), fy = sub(v, fv);
  const float gx1 = sub(1.f, fx), gy1 = sub(1.f, fy);
  const float* p00 = img + 3 * (iy * W + ix);
  const float* p10 = p00 + 3;
  const float* p01 = p00 + 3 * W;
  const float* p11 = p01 + 3;
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = add(mul(p00[c], gx1), mul(p10[c], fx));
    const float bot = add(mul(p01[c], gx1), mul(p11[c], fx));
    out[c] = add(mul(top, gy1), mul(bot, fy));
  }
  const float qnan = __int_as_float(0x7fc00000);
  i0 = nan_uv ? qnan : out[0];
  gx = nan_uv ? qnan : out[1];
  gy = nan_uv ? qnan : out[2];
}

// Channel 0 of sample3_rn's read (the intensity of an [H, W, 3] image):
// its clamp, taps and roundings.
__device__ __forceinline__ float sample1_rn(const float* __restrict__ img, int W, float umax,
                                           float vmax, float u, float v) {
  const bool nan_uv = isnan(u) || isnan(v);
  u = fminf(fmaxf(u, 0.f), umax);
  v = fminf(fmaxf(v, 0.f), vmax);
  const float fu = floorf(u), fv = floorf(v);
  const int ix = static_cast<int>(fu), iy = static_cast<int>(fv);
  const float fx = sub(u, fu), fy = sub(v, fv);
  const float gx1 = sub(1.f, fx), gy1 = sub(1.f, fy);
  const float* p00 = img + 3 * (iy * W + ix);
  const float* p01 = p00 + 3 * W;
  const float top = add(mul(p00[0], gx1), mul(p00[3], fx));
  const float bot = add(mul(p01[0], gx1), mul(p01[3], fx));
  return nan_uv ? __int_as_float(0x7fc00000) : add(mul(top, gy1), mul(bot, fy));
}

}  // namespace rn
}  // namespace dsslam
