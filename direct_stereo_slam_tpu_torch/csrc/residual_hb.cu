// K2 / K3 / K4: the fused residual -> Jacobian -> H/b passes of the
// tracker, the stereo scale optimizer and the loop-closure pose estimator.
// They replace the XLA-compiled programs
// direct_stereo_slam_tpu/ops/residual_hb.py::pose_residual_pass (:126-232),
// ::scale_residual_pass (:313-384) and ::pose3d_residual_pass (:235-310);
// the reference has no Pallas form of them (XLA fused the elementwise
// pipeline and reductions).
//
// One thread per template point warps it, reads (I, dx, dy) bilinearly
// (interp.py's clamp), applies the Huber weight and the saturation cutoff,
// forms the Jacobian and adds its terms to per-thread f32 accumulators.
// Every lane contributes through the reference's multiplicative masks
// (mask * value, not a skip), so a NaN or infinity on a masked lane
// reaches H and b as it does in the reference; a NaN coordinate samples
// NaN, as the reference's clip keeps it (common.cuh, sample3).
//
// What bounds them on the H100: per LM iteration a level reads N <= 8192
// points (5 words each) and 4 bilinear taps of 3 floats from an image
// that fits in L2, then reduces 51 (K2), 48 (K4) or 6 (K3) sums. That
// little data leaves latency (launch + reduction depth), not bandwidth or
// FLOPs, as the bound. Design: a grid of (blocks, candidates) with
// blockIdx.y the pose candidate (K2: 1, 5 or 78 of them), the loop seed
// (K4: 1 or 6) or the scale guess (K3: 8), a fixed-order block reduction
// (warp shuffles, then warps in order) into a partials buffer, and a
// second one-block-per-candidate stage that sums the partials in index
// order and normalises. No atomics: results are deterministic run to run.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 32;

// ---- K2 layout ------------------------------------------------------------
// accumulators: H upper triangle (36) | b (8) | E, n_terms, n_sat, n_in,
// flow_t sum, flow_rt sum, flow subsample count
constexpr int kPoseAcc = 51;
constexpr int kE = 44, kNT = 45, kNS = 46, kNIN = 47, kFT = 48, kFRT = 49,
              kNSUB = 50;
// per-candidate params: RKi (9) | t (3) | a | b | cutoff | ref_b0 | Ki (9)
// | precond (8) | pad
constexpr int kPoseParams = 40;
// output: H (64) | b (8) | E, n_terms, flow_t, flow_rt, sat_ratio, n_in
constexpr int kPoseOut = 80;

// ---- K3 layout ------------------------------------------------------------
// accumulators: H | b | E | n_terms | n_sat | n_in
constexpr int kScaleAcc = 6;
// per-guess params: R01Ki (9) | t01 (3) | scale | cutoff | pad
constexpr int kScaleParams = 16;
// output: H | b | E | n_terms | sat_ratio | n_in | pad
constexpr int kScaleOut = 8;

// ---- K4 layout ------------------------------------------------------------
// accumulators: K2's first 48 (H upper triangle | b | E, n_terms, n_sat,
// n_in); no flow statistics
constexpr int kPose3dAcc = 48;
// per-seed params: R (9) | t (3) | a | b | cutoff | ref_b0 | precond (8)
constexpr int kPose3dParams = 24;
constexpr int kPose3dPre = 16;
// output: K2's layout (flow entries 0)

__device__ __forceinline__ float sq(float x) { return x * x; }

__global__ void __launch_bounds__(kThreads)
pose_partial_kernel(const float* __restrict__ img, int H, int W, float umax,
                    float vmax, const float* __restrict__ pu,
                    const float* __restrict__ pv,
                    const float* __restrict__ pid,
                    const float* __restrict__ pcolor,
                    const unsigned char* __restrict__ pmask, int N,
                    const float* __restrict__ params, float fx, float fy,
                    float cx, float cy, float huber, int compute_flow,
                    float* __restrict__ partial) {
  const float* P = params + blockIdx.y * kPoseParams;
  const float r00 = P[0], r01 = P[1], r02 = P[2];
  const float r10 = P[3], r11 = P[4], r12 = P[5];
  const float r20 = P[6], r21 = P[7], r22 = P[8];
  const float tx = P[9], ty = P[10], tz = P[11];
  const float aff_a = P[12], aff_b = P[13], cutoff = P[14], ref_b0 = P[15];
  const float k00 = P[16], k01 = P[17], k02 = P[18];
  const float k10 = P[19], k11 = P[20], k12 = P[21];
  const float k20 = P[22], k21 = P[23], k22 = P[24];
  const float max_energy = 2.f * huber * cutoff - huber * huber;
  const float wlim = static_cast<float>(W) - 3.f;
  const float hlim = static_cast<float>(H) - 3.f;

  float acc[kPoseAcc];
#pragma unroll
  for (int k = 0; k < kPoseAcc; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < N;
       i += gridDim.x * kThreads) {
    const float x = pu[i], y = pv[i], id = pid[i], col = pcolor[i];
    const bool m = pmask[i] != 0;
    // R K^-1 x, then + t * idepth
    const float q0 = r00 * x + r01 * y + r02;
    const float q1 = r10 * x + r11 * y + r12;
    const float q2 = r20 * x + r21 * y + r22;
    const float p0 = q0 + tx * id, p1 = q1 + ty * id, p2 = q2 + tz * id;
    const float u = p0 / p2, v = p1 / p2;
    const float Ku = fx * u + cx, Kv = fy * v + cy;
    const float new_id = id / p2;
    float hi, gx, gy;
    dsslam::sample3(img, W, umax, vmax, Ku, Kv, hi, gx, gy);
    const bool valid = m && Ku > 2.f && Kv > 2.f && Ku < wlim && Kv < hlim &&
                       new_id > 0.f && isfinite(hi);

    const float r = hi - (aff_a * col + aff_b);
    const float ar = fabsf(r);
    const float hw = ar < huber ? 1.f : huber / dsslam::clamp_min(ar, 1e-12f);
    const bool sat = ar > cutoff;
    const float vf = valid ? 1.f : 0.f;
    acc[kE] += vf * (sat ? max_energy : hw * r * r * (2.f - hw));
    acc[kNT] += vf;
    acc[kNS] += vf * (sat ? 1.f : 0.f);

    if (compute_flow) {
      // every-32nd-point subsample (residual_hb.py:182-196)
      const float sub = (m && (i % 32) == 0) ? 1.f : 0.f;
      const float s0 = k00 * x + k01 * y + k02;
      const float s1 = k10 * x + k11 * y + k12;
      const float s2 = k20 * x + k21 * y + k22;
      const float a0 = s0 + tx * id, a1 = s1 + ty * id, a2 = s2 + tz * id;
      const float b0 = s0 - tx * id, b1 = s1 - ty * id, b2 = s2 - tz * id;
      const float c0 = q0 - tx * id, c1 = q1 - ty * id, c2 = q2 - tz * id;
      const float KuT = fx * a0 / a2 + cx, KvT = fy * a1 / a2 + cy;
      const float KuT2 = fx * b0 / b2 + cx, KvT2 = fy * b1 / b2 + cy;
      const float KuR2 = fx * c0 / c2 + cx, KvR2 = fy * c1 / c2 + cy;
      acc[kFT] += sub * ((sq(KuT - x) + sq(KvT - y)) +
                         (sq(KuT2 - x) + sq(KvT2 - y)));
      acc[kFRT] += sub * ((sq(Ku - x) + sq(Kv - y)) +
                          (sq(KuR2 - x) + sq(KvR2 - y)));
      acc[kNSUB] += sub;
    }

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
        aff_a * (ref_b0 - col),
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
  dsslam::block_sum<kPoseAcc, kThreads>(
      acc, partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                         kPoseAcc);
}

// Sums the partials of one candidate in index order and writes K2's output
// layout. NACC = kPoseAcc (K2, with flow statistics) or kPose3dAcc (K4);
// the preconditioner sits at params[c * NPARAMS + PRE].
template <int NACC, int NPARAMS, int PRE>
__global__ void pose_final_kernel(const float* __restrict__ partial, int nblk,
                                  const float* __restrict__ params,
                                  int compute_flow, float* __restrict__ out) {
  __shared__ float tot[NACC];
  const int c = blockIdx.x;
  if (threadIdx.x < NACC) {
    float s = 0.f;
    for (int j = 0; j < nblk; ++j)
      s += partial[(static_cast<size_t>(c) * nblk + j) * NACC + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
  const float* pre = params + c * NPARAMS + PRE;
  float* o = out + c * kPoseOut;
  const float n_safe = fmaxf(tot[kNIN], 1.f);
  const int t = threadIdx.x;
  if (t < 64) {
    const int i = t / 8, j = t % 8;
    const int lo = min(i, j), hi = max(i, j);
    const int k = lo * 8 - lo * (lo - 1) / 2 + (hi - lo);
    o[t] = tot[k] / n_safe * pre[i] * pre[j];
  } else if (t < 72) {
    o[t] = tot[36 + t - 64] / n_safe * pre[t - 64];
  } else if (t == 72) {
    o[72] = tot[kE];
    o[73] = tot[kNT];
    o[74] = 0.f;
    o[75] = 0.f;
    if constexpr (NACC > kNSUB) {
      const float num = tot[kNSUB] * 2.f + 0.1f;
      o[74] = compute_flow ? tot[kFT] / num : 0.f;
      o[75] = compute_flow ? tot[kFRT] / num : 0.f;
    }
    o[76] = tot[kNS] / fmaxf(tot[kNT], 1.f);
    o[77] = tot[kNIN];
    o[78] = 0.f;
    o[79] = 0.f;
  }
}

// K4: the loop-closure flavor of K2. The points are metric xyz in the
// matched keyframe's camera frame, warped by R p + t with new_id = 1 / z;
// the reference frame's affine b (ref_b0) is the estimator's zero affine.
__global__ void __launch_bounds__(kThreads)
pose3d_partial_kernel(const float* __restrict__ img, int H, int W, float umax,
                      float vmax, const float* __restrict__ px,
                      const float* __restrict__ py,
                      const float* __restrict__ pz,
                      const float* __restrict__ pcolor,
                      const unsigned char* __restrict__ pmask, int N,
                      const float* __restrict__ params, float fx, float fy,
                      float cx, float cy, float huber,
                      float* __restrict__ partial) {
  const float* P = params + blockIdx.y * kPose3dParams;
  const float r00 = P[0], r01 = P[1], r02 = P[2];
  const float r10 = P[3], r11 = P[4], r12 = P[5];
  const float r20 = P[6], r21 = P[7], r22 = P[8];
  const float tx = P[9], ty = P[10], tz = P[11];
  const float aff_a = P[12], aff_b = P[13], cutoff = P[14], ref_b0 = P[15];
  const float max_energy = 2.f * huber * cutoff - huber * huber;
  const float wlim = static_cast<float>(W) - 3.f;
  const float hlim = static_cast<float>(H) - 3.f;

  float acc[kPose3dAcc];
#pragma unroll
  for (int k = 0; k < kPose3dAcc; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < N;
       i += gridDim.x * kThreads) {
    const float x = px[i], y = py[i], z = pz[i], col = pcolor[i];
    const bool m = pmask[i] != 0;
    const float p0 = r00 * x + r01 * y + r02 * z + tx;
    const float p1 = r10 * x + r11 * y + r12 * z + ty;
    const float p2 = r20 * x + r21 * y + r22 * z + tz;
    const float u = p0 / p2, v = p1 / p2;
    const float Ku = fx * u + cx, Kv = fy * v + cy;
    const float new_id = 1.f / p2;
    float hi, gx, gy;
    dsslam::sample3(img, W, umax, vmax, Ku, Kv, hi, gx, gy);
    const bool valid = m && Ku > 2.f && Kv > 2.f && Ku < wlim && Kv < hlim &&
                       new_id > 0.f && isfinite(hi);

    const float r = hi - (aff_a * col + aff_b);
    const float ar = fabsf(r);
    const float hw = ar < huber ? 1.f : huber / dsslam::clamp_min(ar, 1e-12f);
    const bool sat = ar > cutoff;
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
        aff_a * (ref_b0 - col),
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
  dsslam::block_sum<kPose3dAcc, kThreads>(
      acc, partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                         kPose3dAcc);
}

__global__ void __launch_bounds__(kThreads)
scale_partial_kernel(const float* __restrict__ img, int H, int W, float umax,
                     float vmax, const float* __restrict__ pu,
                     const float* __restrict__ pv,
                     const float* __restrict__ pid,
                     const float* __restrict__ pcolor,
                     const unsigned char* __restrict__ pmask, int N,
                     const float* __restrict__ params, float fx, float fy,
                     float cx, float cy, float huber,
                     float* __restrict__ partial) {
  const float* P = params + blockIdx.y * kScaleParams;
  const float r00 = P[0], r01 = P[1], r02 = P[2];
  const float r10 = P[3], r11 = P[4], r12 = P[5];
  const float r20 = P[6], r21 = P[7], r22 = P[8];
  const float tx = P[9], ty = P[10], tz = P[11];
  const float s = P[12], cutoff = P[13];
  const float max_energy = 2.f * huber * cutoff - huber * huber;
  const float wlim = static_cast<float>(W) - 3.f;
  const float hlim = static_cast<float>(H) - 3.f;

  float acc[kScaleAcc];
#pragma unroll
  for (int k = 0; k < kScaleAcc; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < N;
       i += gridDim.x * kThreads) {
    const float x = pu[i], y = pv[i], id = pid[i], col = pcolor[i];
    const bool m = pmask[i] != 0;
    // scaled stereo warp: s * R01 K0^-1 x + t01 * idepth
    const float q0 = r00 * x + r01 * y + r02;
    const float q1 = r10 * x + r11 * y + r12;
    const float q2 = r20 * x + r21 * y + r22;
    const float p0 = s * q0 + tx * id, p1 = s * q1 + ty * id,
                p2 = s * q2 + tz * id;
    const float u = p0 / p2, v = p1 / p2;
    const float Ku = fx * u + cx, Kv = fy * v + cy;
    const float new_id = id / p2;
    float hi, gx, gy;
    dsslam::sample3(img, W, umax, vmax, Ku, Kv, hi, gx, gy);
    const bool valid = m && Ku > 2.f && Kv > 2.f && Ku < wlim && Kv < hlim &&
                       new_id > 0.f && isfinite(hi);

    const float r = hi - col;
    const float ar = fabsf(r);
    const float hw = ar < huber ? 1.f : huber / dsslam::clamp_min(ar, 1e-12f);
    const bool sat = ar > cutoff;
    const float vf = valid ? 1.f : 0.f;
    acc[2] += vf * (sat ? max_energy : hw * r * r * (2.f - hw));
    acc[3] += vf;
    acc[4] += vf * (sat ? 1.f : 0.f);

    // closed-form 1-DoF scale Jacobian (residual_hb.py:361-368)
    const float rx0 = q0 / id, rx1 = q1 / id, rx2 = q2 / id;
    const float deno_sqrt = s * rx2 + tz;
    const float deno = 1.f / dsslam::clamp_min(deno_sqrt * deno_sqrt, 1e-20f);
    const float xno = rx0 * tz - rx2 * tx;
    const float yno = rx1 * tz - rx2 * ty;
    const float Js = gx * fx * deno * xno + gy * fy * deno * yno;

    const float in = (valid && !sat) ? 1.f : 0.f;
    const float w = in * hw;
    acc[0] += w * Js * Js;
    acc[1] += w * Js * r;
    acc[5] += in;
  }
  dsslam::block_sum<kScaleAcc, kThreads>(
      acc, partial + (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
                         kScaleAcc);
}

__global__ void scale_final_kernel(const float* __restrict__ partial, int nblk,
                                   float* __restrict__ out) {
  __shared__ float tot[kScaleAcc];
  const int g = blockIdx.x;
  if (threadIdx.x < kScaleAcc) {
    float s = 0.f;
    for (int j = 0; j < nblk; ++j)
      s += partial[(static_cast<size_t>(g) * nblk + j) * kScaleAcc + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float* o = out + g * kScaleOut;
    const float n_safe = fmaxf(tot[5], 1.f);
    o[0] = tot[0] / n_safe;
    o[1] = tot[1] / n_safe;
    o[2] = tot[2];
    o[3] = tot[3];
    o[4] = tot[4] / fmaxf(tot[3], 1.f);
    o[5] = tot[5];
    o[6] = 0.f;
    o[7] = 0.f;
  }
}

int blocks_for(int N) {
  const int b = (N + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

}  // namespace

DSSLAM_API int dsslam_pose_pass(const float* img, int H, int W, float umax,
                                float vmax, const float* pu, const float* pv,
                                const float* pid, const float* pcolor,
                                const unsigned char* pmask, int N,
                                const float* params, int B, float fx, float fy,
                                float cx, float cy, float huber,
                                int compute_flow, float* partial, int nblk,
                                float* out, cudaStream_t stream) {
  if (nblk != blocks_for(N)) return cudaErrorInvalidValue;
  pose_partial_kernel<<<dim3(nblk, B), kThreads, 0, stream>>>(
      img, H, W, umax, vmax, pu, pv, pid, pcolor, pmask, N, params, fx, fy, cx,
      cy, huber, compute_flow, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pose_final_kernel<kPoseAcc, kPoseParams, 25><<<B, 96, 0, stream>>>(
      partial, nblk, params, compute_flow, out);
  return cudaGetLastError();
}

DSSLAM_API int dsslam_scale_pass(const float* img, int H, int W, float umax,
                                 float vmax, const float* pu, const float* pv,
                                 const float* pid, const float* pcolor,
                                 const unsigned char* pmask, int N,
                                 const float* params, int G, float fx,
                                 float fy, float cx, float cy, float huber,
                                 float* partial, int nblk, float* out,
                                 cudaStream_t stream) {
  if (nblk != blocks_for(N)) return cudaErrorInvalidValue;
  scale_partial_kernel<<<dim3(nblk, G), kThreads, 0, stream>>>(
      img, H, W, umax, vmax, pu, pv, pid, pcolor, pmask, N, params, fx, fy, cx,
      cy, huber, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scale_final_kernel<<<G, 32, 0, stream>>>(partial, nblk, out);
  return cudaGetLastError();
}

DSSLAM_API int dsslam_pose3d_pass(const float* img, int H, int W, float umax,
                                  float vmax, const float* px, const float* py,
                                  const float* pz, const float* pcolor,
                                  const unsigned char* pmask, int N,
                                  const float* params, int S, float fx,
                                  float fy, float cx, float cy, float huber,
                                  float* partial, int nblk, float* out,
                                  cudaStream_t stream) {
  if (nblk != blocks_for(N)) return cudaErrorInvalidValue;
  pose3d_partial_kernel<<<dim3(nblk, S), kThreads, 0, stream>>>(
      img, H, W, umax, vmax, px, py, pz, pcolor, pmask, N, params, fx, fy, cx,
      cy, huber, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  pose_final_kernel<kPose3dAcc, kPose3dParams, kPose3dPre>
      <<<S, 96, 0, stream>>>(partial, nblk, params, 0, out);
  return cudaGetLastError();
}
