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
// forms the Jacobian and adds its terms to per-thread f32 accumulators
// (pose_terms.cuh, shared with the resident LM kernels of resident_lm.cu,
// which run the tracker's, the scale optimizer's and the loop estimator's
// whole LM on the card; these single passes stay for callers that drive
// one pass at a time and as the per-point arithmetic's check).
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

#include "pose_terms.cuh"

namespace {

using dsslam::kE;
using dsslam::kNIN;
using dsslam::kNS;
using dsslam::kNT;
using dsslam::kPose3dAcc;
using dsslam::kPoseAcc;
using dsslam::kScaleAcc;
using dsslam::kFT;
using dsslam::kFRT;
using dsslam::kNSUB;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 32;

// ---- K2 layout ------------------------------------------------------------
// accumulators: dsslam::kPoseAcc (pose_terms.cuh)
// per-candidate params: RKi (9) | t (3) | a | b | cutoff | ref_b0 | Ki (9)
// | precond (8) | pad
constexpr int kPoseParams = 40;
// output: H (64) | b (8) | E, n_terms, flow_t, flow_rt, sat_ratio, n_in
constexpr int kPoseOut = 80;

// ---- K3 layout ------------------------------------------------------------
// accumulators: dsslam::kScaleAcc (pose_terms.cuh)
// per-guess params: R01Ki (9) | t01 (3) | scale | cutoff | pad
constexpr int kScaleParams = 16;
// output: H | b | E | n_terms | sat_ratio | n_in | pad
constexpr int kScaleOut = 8;

// ---- K4 layout ------------------------------------------------------------
// accumulators: dsslam::kPose3dAcc, K2's first 48 (no flow statistics)
// per-seed params: R (9) | t (3) | a | b | cutoff | ref_b0 | precond (8)
constexpr int kPose3dParams = 24;
constexpr int kPose3dPre = 16;
// output: K2's layout (flow entries 0)

// The pass's warp from a candidate's parameter row (K2 and K4 share the
// first 16 entries; Ki follows for K2).
__device__ __forceinline__ dsslam::PoseWarp load_warp(const float* P,
                                                      bool with_ki) {
  dsslam::PoseWarp c;
#pragma unroll
  for (int k = 0; k < 9; ++k) c.r[k] = P[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) c.t[k] = P[9 + k];
  c.a = P[12];
  c.b = P[13];
  c.cutoff = P[14];
  c.ref_b0 = P[15];
#pragma unroll
  for (int k = 0; k < 9; ++k) c.k[k] = 0.f;
  if (with_ki) {
#pragma unroll
    for (int k = 0; k < 9; ++k) c.k[k] = P[16 + k];
  }
  return c;
}

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
  const dsslam::PoseWarp c = load_warp(params + blockIdx.y * kPoseParams, true);
  float acc[kPoseAcc];
#pragma unroll
  for (int k = 0; k < kPoseAcc; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < N;
       i += gridDim.x * kThreads) {
    dsslam::pose_point(img, H, W, umax, vmax, pu[i], pv[i], pid[i], pcolor[i],
                       pmask[i] != 0, i, c, fx, fy, cx, cy, huber,
                       compute_flow != 0, acc);
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
    o[t] = tot[dsslam::tri_index(i, j)] / n_safe * pre[i] * pre[j];
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
  const dsslam::PoseWarp c =
      load_warp(params + blockIdx.y * kPose3dParams, false);
  float acc[kPose3dAcc];
#pragma unroll
  for (int k = 0; k < kPose3dAcc; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < N;
       i += gridDim.x * kThreads) {
    dsslam::pose3d_point(img, H, W, umax, vmax, px[i], py[i], pz[i], pcolor[i],
                         pmask[i] != 0, c, fx, fy, cx, cy, huber, acc);
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
  dsslam::ScaleWarp c;
#pragma unroll
  for (int k = 0; k < 9; ++k) c.r[k] = P[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) c.t[k] = P[9 + k];
  c.s = P[12];
  c.cutoff = P[13];

  float acc[kScaleAcc];
#pragma unroll
  for (int k = 0; k < kScaleAcc; ++k) acc[k] = 0.f;

  for (int i = blockIdx.x * kThreads + threadIdx.x; i < N;
       i += gridDim.x * kThreads) {
    dsslam::scale_point(img, H, W, umax, vmax, pu[i], pv[i], pid[i], pcolor[i],
                        pmask[i] != 0, c, fx, fy, cx, cy, huber, acc);
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
