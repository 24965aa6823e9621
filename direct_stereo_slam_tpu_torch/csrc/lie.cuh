// The SE(3) functions of geometry/lie.py that the pose-graph kernels (on
// dual numbers, pose_graph.cu) and the windowed BA's kernels (on floats,
// ba.cu) share, branch for branch: se3_exp with _sinc_coeffs' Taylor switch
// at theta^2 < 1e-4, the product of two rigid transforms and the inverse.
// Templates on the scalar type S: a type other than float brings its own
// val / sqrt_ / sin_ / cos_ and arithmetic, found by argument-dependent
// lookup.
#pragma once

#include "common.cuh"

namespace dsslam {

constexpr float kEps = 1e-4f;                              // lie._EPS

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ float sin_(float x) { return sinf(x); }
__device__ __forceinline__ float cos_(float x) { return cosf(x); }

// A rigid transform as its top three rows, row-major [3][4].
template <typename S>
struct Pose {
  S m[12];
};

// lie._sinc_coeffs: (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3)
template <typename S>
__device__ __forceinline__ void sinc_coeffs(S t2, S& A, S& B, S& C) {
  if (val(t2) < kEps) {
    A = 1.f - t2 / 6.f + t2 * t2 / 120.f;
    B = 0.5f - t2 / 24.f + t2 * t2 / 720.f;
    C = static_cast<float>(1.0 / 6.0) - t2 / 120.f + t2 * t2 / 5040.f;
  } else {
    const S t = sqrt_(t2);
    A = sin_(t) / t;
    B = (1.f - cos_(t)) / t2;
    C = (t - sin_(t)) / (t2 * t);
  }
}

template <typename S>
__device__ __forceinline__ void hat(const S* w, S (&W)[9]) {
  W[0] = S(0.f); W[1] = -w[2]; W[2] = w[1];
  W[3] = w[2];   W[4] = S(0.f); W[5] = -w[0];
  W[6] = -w[1];  W[7] = w[0];  W[8] = S(0.f);
}

template <typename S>
__device__ __forceinline__ void mat3(const S (&A)[9], const S (&B)[9], S (&C)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// lie.se3_exp: xi = (t, w) -> [R | V t]
template <typename S>
__device__ __forceinline__ Pose<S> se3_exp(const S (&xi)[6]) {
  const S* t = xi;
  const S* w = xi + 3;
  S A, B, C;
  sinc_coeffs(w[0] * w[0] + w[1] * w[1] + w[2] * w[2], A, B, C);
  S W[9], W2[9];
  hat(w, W);
  mat3(W, W, W2);
  Pose<S> T;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    S V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.f : 0.f;
      T.m[4 * i + j] = e + A * W[3 * i + j] + B * W2[3 * i + j];
      V[j] = e + B * W[3 * i + j] + C * W2[3 * i + j];
    }
    T.m[4 * i + 3] = V[0] * t[0] + V[1] * t[1] + V[2] * t[2];
  }
  return T;
}

// A @ B of two 4x4 rigid transforms (bottom rows 0 0 0 1)
template <typename S>
__device__ __forceinline__ Pose<S> compose(const Pose<S>& A, const Pose<S>& B) {
  Pose<S> C;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C.m[4 * i + j] = A.m[4 * i] * B.m[j] + A.m[4 * i + 1] * B.m[4 + j] +
                       A.m[4 * i + 2] * B.m[8 + j];
    C.m[4 * i + 3] = A.m[4 * i] * B.m[3] + A.m[4 * i + 1] * B.m[7] +
                     A.m[4 * i + 2] * B.m[11] + A.m[4 * i + 3];
  }
  return C;
}

// lie.se3_inverse: [R^T | -R^T t]
template <typename S>
__device__ __forceinline__ Pose<S> inverse(const Pose<S>& T) {
  Pose<S> I;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) I.m[4 * i + j] = T.m[4 * j + i];
    I.m[4 * i + 3] = -(T.m[i] * T.m[3] + T.m[4 + i] * T.m[7] + T.m[8 + i] * T.m[11]);
  }
  return I;
}

template <typename S>
__device__ __forceinline__ Pose<S> load_pose(const float* __restrict__ T, long long n) {
  Pose<S> P;
  const float* src = T + 16 * n;
#pragma unroll
  for (int k = 0; k < 12; ++k) P.m[k] = S(src[k]);
  return P;
}

}  // namespace dsslam
