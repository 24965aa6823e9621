// Per-point terms of the 8-parameter pose+affine pass and of the 1-DoF
// stereo scale pass, shared by the per-pass kernels K2 / K3 / K4
// (residual_hb.cu) and the resident LM kernels (resident_lm.cu), so the
// two forms run the same per-point arithmetic.
//
// Every lane contributes through the reference's multiplicative masks
// (mask * value, not a skip), so a NaN or infinity on a masked lane reaches
// H and b as it does in the reference; a NaN coordinate samples NaN, as
// the reference's clip keeps it (common.cuh, sample3).
#pragma once

#include "common.cuh"

namespace dsslam {

// accumulators: H upper triangle (36) | b (8) | E, n_terms, n_sat, n_in |
// K2 only: flow_t sum, flow_rt sum, flow subsample count
constexpr int kPoseAcc = 51;
constexpr int kPose3dAcc = 48;
constexpr int kE = 44, kNT = 45, kNS = 46, kNIN = 47, kFT = 48, kFRT = 49,
              kNSUB = 50;

__device__ __forceinline__ float sq(float x) { return x * x; }

// The warp of one pass: R K^-1 (K2) or R (K4), t, the relative affine
// (a, b) of the new frame, the saturation cutoff and the reference
// frame's affine b; Ki for K2's flow indicators.
struct PoseWarp {
  float r[9];
  float t[3];
  float a, b, cutoff, ref_b0;
  float k[9];
};

// Residual, Huber weight, cutoff, Jacobian and the masked sums of one
// warped point (u, v normalized, Ku, Kv pixel, new_id its new idepth).
__device__ __forceinline__ void pose_point_sums(
    const float* __restrict__ img, int H, int W, float umax, float vmax,
    float u, float v, float Ku, float Kv, float new_id, float col, bool m,
    const PoseWarp& c, float fx, float fy, float huber, float* acc) {
  float hi, gx, gy;
  sample3(img, W, umax, vmax, Ku, Kv, hi, gx, gy);
  const float wlim = static_cast<float>(W) - 3.f;
  const float hlim = static_cast<float>(H) - 3.f;
  const bool valid = m && Ku > 2.f && Kv > 2.f && Ku < wlim && Kv < hlim &&
                     new_id > 0.f && isfinite(hi);
  const float max_energy = 2.f * huber * c.cutoff - huber * huber;

  const float r = hi - (c.a * col + c.b);
  const float ar = fabsf(r);
  const float hw = ar < huber ? 1.f : huber / clamp_min(ar, 1e-12f);
  const bool sat = ar > c.cutoff;
  const float vf = valid ? 1.f : 0.f;
  acc[kE] += vf * (sat ? max_energy : hw * r * r * (2.f - hw));
  acc[kNT] += vf;
  acc[kNS] += vf * (sat ? 1.f : 0.f);

  const float in = (valid && !sat) ? 1.f : 0.f;
  const float w = in * hw;
  const float dxfx = gx * fx, dyfy = gy * fy;
  const float J[8] = {
      new_id * dxfx,
      new_id * dyfy,
      -new_id * (u * dxfx + v * dyfy),
      -(u * v * dxfx + (1.f + v * v) * dyfy),
      u * v * dyfy + (1.f + u * u) * dxfx,
      u * dyfy - v * dxfx,
      c.a * (c.ref_b0 - col),
      -1.f,
  };
  acc[kNIN] += in;
  int k = 0;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float jw = J[a] * w;
#pragma unroll
    for (int b = a; b < 8; ++b) acc[k++] += jw * J[b];
    acc[36 + a] += jw * r;
  }
}

// K2: template point i at pixel (x, y) with idepth id, warped by
// R K^-1 x + t * id; with compute_flow, the every-32nd-point flow
// indicators (residual_hb.py:182-196).
__device__ __forceinline__ void pose_point(
    const float* __restrict__ img, int H, int W, float umax, float vmax,
    float x, float y, float id, float col, bool m, int i, const PoseWarp& c,
    float fx, float fy, float cx, float cy, float huber, bool compute_flow,
    float* acc) {
  const float q0 = c.r[0] * x + c.r[1] * y + c.r[2];
  const float q1 = c.r[3] * x + c.r[4] * y + c.r[5];
  const float q2 = c.r[6] * x + c.r[7] * y + c.r[8];
  const float p0 = q0 + c.t[0] * id, p1 = q1 + c.t[1] * id,
              p2 = q2 + c.t[2] * id;
  const float u = p0 / p2, v = p1 / p2;
  const float Ku = fx * u + cx, Kv = fy * v + cy;
  pose_point_sums(img, H, W, umax, vmax, u, v, Ku, Kv, id / p2, col, m, c,
                  fx, fy, huber, acc);
  if (compute_flow) {
    const float sub = (m && (i % 32) == 0) ? 1.f : 0.f;
    const float s0 = c.k[0] * x + c.k[1] * y + c.k[2];
    const float s1 = c.k[3] * x + c.k[4] * y + c.k[5];
    const float s2 = c.k[6] * x + c.k[7] * y + c.k[8];
    const float a0 = s0 + c.t[0] * id, a1 = s1 + c.t[1] * id,
                a2 = s2 + c.t[2] * id;
    const float b0 = s0 - c.t[0] * id, b1 = s1 - c.t[1] * id,
                b2 = s2 - c.t[2] * id;
    const float c0 = q0 - c.t[0] * id, c1 = q1 - c.t[1] * id,
                c2 = q2 - c.t[2] * id;
    const float KuT = fx * a0 / a2 + cx, KvT = fy * a1 / a2 + cy;
    const float KuT2 = fx * b0 / b2 + cx, KvT2 = fy * b1 / b2 + cy;
    const float KuR2 = fx * c0 / c2 + cx, KvR2 = fy * c1 / c2 + cy;
    acc[kFT] += sub * ((sq(KuT - x) + sq(KvT - y)) +
                       (sq(KuT2 - x) + sq(KvT2 - y)));
    acc[kFRT] += sub * ((sq(Ku - x) + sq(Kv - y)) +
                        (sq(KuR2 - x) + sq(KvR2 - y)));
    acc[kNSUB] += sub;
  }
}

// K4: a metric point (x, y, z) in the matched keyframe's camera frame,
// warped by R p + t with new_id = 1 / z.
__device__ __forceinline__ void pose3d_point(
    const float* __restrict__ img, int H, int W, float umax, float vmax,
    float x, float y, float z, float col, bool m, const PoseWarp& c,
    float fx, float fy, float cx, float cy, float huber, float* acc) {
  const float p0 = c.r[0] * x + c.r[1] * y + c.r[2] * z + c.t[0];
  const float p1 = c.r[3] * x + c.r[4] * y + c.r[5] * z + c.t[1];
  const float p2 = c.r[6] * x + c.r[7] * y + c.r[8] * z + c.t[2];
  const float u = p0 / p2, v = p1 / p2;
  const float Ku = fx * u + cx, Kv = fy * v + cy;
  pose_point_sums(img, H, W, umax, vmax, u, v, Ku, Kv, 1.f / p2, col, m, c,
                  fx, fy, huber, acc);
}

// accumulators of the 1-DoF stereo scale pass (K3, K3-LM):
// H | b | E | n_terms | n_sat | n_in
constexpr int kScaleAcc = 6;
constexpr int kSH = 0, kSB = 1, kSE = 2, kSNT = 3, kSNS = 4, kSNIN = 5;

// The warp of one scale pass: R01 K0^-1 (r), t01 (t), the scale s and the
// saturation cutoff.
struct ScaleWarp {
  float r[9];
  float t[3];
  float s, cutoff;
};

// K3: template point (x, y) with idepth id warped into camera 1 by
// s R01 K0^-1 x + t01 id, with the closed-form 1-DoF scale Jacobian
// (residual_hb.py:361-368). A padded lane (id = 0) makes rx infinite and
// Js NaN, which reaches H and b through the multiplicative mask, as in the
// reference.
__device__ __forceinline__ void scale_point(
    const float* __restrict__ img, int H, int W, float umax, float vmax,
    float x, float y, float id, float col, bool m, const ScaleWarp& c,
    float fx, float fy, float cx, float cy, float huber, float* acc) {
  const float max_energy = 2.f * huber * c.cutoff - huber * huber;
  const float wlim = static_cast<float>(W) - 3.f;
  const float hlim = static_cast<float>(H) - 3.f;
  const float s = c.s;
  const float q0 = c.r[0] * x + c.r[1] * y + c.r[2];
  const float q1 = c.r[3] * x + c.r[4] * y + c.r[5];
  const float q2 = c.r[6] * x + c.r[7] * y + c.r[8];
  const float p0 = s * q0 + c.t[0] * id, p1 = s * q1 + c.t[1] * id,
              p2 = s * q2 + c.t[2] * id;
  const float u = p0 / p2, v = p1 / p2;
  const float Ku = fx * u + cx, Kv = fy * v + cy;
  const float new_id = id / p2;
  float hi, gx, gy;
  sample3(img, W, umax, vmax, Ku, Kv, hi, gx, gy);
  const bool valid = m && Ku > 2.f && Kv > 2.f && Ku < wlim && Kv < hlim &&
                     new_id > 0.f && isfinite(hi);

  const float r = hi - col;
  const float ar = fabsf(r);
  const float hw = ar < huber ? 1.f : huber / clamp_min(ar, 1e-12f);
  const bool sat = ar > c.cutoff;
  const float vf = valid ? 1.f : 0.f;
  acc[kSE] += vf * (sat ? max_energy : hw * r * r * (2.f - hw));
  acc[kSNT] += vf;
  acc[kSNS] += vf * (sat ? 1.f : 0.f);

  const float rx0 = q0 / id, rx1 = q1 / id, rx2 = q2 / id;
  const float deno_sqrt = s * rx2 + c.t[2];
  const float deno = 1.f / clamp_min(deno_sqrt * deno_sqrt, 1e-20f);
  const float xno = rx0 * c.t[2] - rx2 * c.t[0];
  const float yno = rx1 * c.t[2] - rx2 * c.t[1];
  const float Js = gx * fx * deno * xno + gy * fy * deno * yno;

  const float in = (valid && !sat) ? 1.f : 0.f;
  const float w = in * hw;
  acc[kSH] += w * Js * Js;
  acc[kSB] += w * Js * r;
  acc[kSNIN] += in;
}

// Index of H[i][j] (i <= j) in the packed upper triangle.
__host__ __device__ __forceinline__ int tri_index(int i, int j) {
  const int lo = i < j ? i : j, hi = i < j ? j : i;
  return lo * 8 - lo * (lo - 1) / 2 + (hi - lo);
}

}  // namespace dsslam
