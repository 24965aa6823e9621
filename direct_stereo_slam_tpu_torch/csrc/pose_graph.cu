// K6-K8: the loop closure's SE(3) pose graph on the card. One Gauss-Newton
// iteration of loop/pose_graph.py::optimize is K6 -> K7 -> a dense solve
// (up to 512 nodes) or K6 -> K8 (above), with no host read between.
//
// They replace the jitted JAX program
// direct_stereo_slam_tpu/loop/pose_graph.py::optimize (:187, 25 GN
// iterations in a lax.scan):
//   K6 dsslam_pose_graph_edges    <- :68 _edge_system (+ :56 _edge_res_jac)
//   K7 dsslam_pose_graph_assemble <- :96 _solve_dense, up to its solve
//   K8 dsslam_pose_graph_pcg      <- :122 _solve_cg (its while_loop)
// The port's plain versions are loop/pose_graph.py::_edge_system,
// _assemble_dense and _solve_cg.
//
// What bounds them on the H100. K6 reads two poses and a measurement per
// edge (~200 B) and writes a 12x12 block and a 12-vector (624 B): at the
// loop phase's E <= 1024 edges well under a microsecond at 3.35 TB/s; its
// ~3k f32 operations per edge are less. K7 writes the dense [6N, 6N]
// system: 2.4 MB at N = 128, 38 MB at N = 512, so bytes bound it (0.7 / 11
// us). K8 is a chain of ~100 CG steps, each a pass over the edge blocks
// (E x 576 B from L2) and two global dot products: latency bound, by its
// barriers. None has a product a tensor core could take (6x6 and 12x12
// blocks, f32 pinned by the reference).
//
// Design.
// - K6, forward-mode dual numbers, 16 lanes an edge (lanes 0-11 one
//   tangent direction each, 12-15 idle): every lane evaluates
//   r = log(Z^-1 T_a^-1 T_b) on (value, derivative) pairs through the same
//   Lie functions as geometry/lie.py, branch for branch (the Taylor switch
//   at theta^2 < 1e-4, so3_log's theta < 1e-5 and theta > pi - 1e-2,
//   se3_log's coefficient), with the derivative rules PyTorch's forward AD
//   applies (torch.where picks a side's derivative, clamp passes it inside
//   its bounds, d sqrt = dx / (2 sqrt x)), so the Jacobian is the plain
//   version's torch.func.jvp, NaN for NaN, not a closed form that would
//   differ from it at the branch points. Lane j holds column j of J; the
//   12x12 block and b come from 12 shuffles of the columns, each entry a
//   fixed-order sum over the 6 residual rows. The kernel also applies the
//   previous iteration's update T <- T exp(x) (a __noinline__ function,
//   so the pose an edge linearizes at and the one written out are the same
//   bits), which takes the ~30 plain launches of se3_exp off every
//   iteration; called with no edges it only updates (the last update).
// - K7, one block per node row: it lists the row node's valid edges in
//   ascending edge index (a block-wide ordered compaction) and marks the
//   nodes they reach; each thread then owns columns of the row's six rows
//   and adds the edges' sub-blocks into each entry in that order, writes a
//   zero where no edge reaches, masks fixed and invalid nodes and adds the
//   damping. No atomics: the same input gives the same bits. An invalid
//   edge's blocks are zero (its weight is 0), so skipping it changes no
//   sum (unless its Jacobian is not finite, which a padding edge's, at the
//   identity, never is).
// - K8, one 8-block cluster of 512 threads for the whole solve, the
//   reference's while_loop (it < cg_iters and |r|^2 > 1e-10 |b|^2) run on
//   the card. The per-node incidence lists (valid edges' sides in
//   ascending edge index, ops/pose_graph.py::incidence, made once per
//   optimize) give the block-Jacobi diagonal, b and every H p in a fixed
//   order; the 6x6 inverses are Gauss-Jordan on D = sum J^T W J + damp I,
//   which is symmetric positive definite, so no pivot is needed. A CG
//   step is an edge pass (each thread a row of an edge's block times the
//   two nodes' p), a node pass that gathers its entries, and two dot
//   products: each block reduces its part in a fixed order and pushes it
//   into every block's shared memory, and after the cluster barrier every
//   block sums the 8 parts in rank order, so all blocks hold the same bits
//   and take the same branch. p is formed where it is read (z + beta p),
//   so a step takes three cluster barriers. The state (x, r, z, p, H p:
//   [N, 6]; Dinv [N, 6, 6]; the edge products [E, 12]) stays in global
//   memory, in L2 at these sizes.

#include <cooperative_groups.h>

#include "lie.cuh"

namespace cg = cooperative_groups;

namespace {

using dsslam::clamp_min;
using dsslam::compose;
using dsslam::hat;
using dsslam::inverse;
using dsslam::kEps;
using dsslam::load_pose;
using dsslam::mat3;
using dsslam::Pose;
using dsslam::se3_exp;
using dsslam::sinc_coeffs;
using dsslam::val;
using dsslam::sqrt_;
using dsslam::sin_;
using dsslam::cos_;

// ---------------------------------------------------------------------------
// Dual numbers and the Lie functions of geometry/lie.py on them
// ---------------------------------------------------------------------------

struct Dual {
  float v, d;
  __device__ Dual() : v(0.f), d(0.f) {}
  __device__ Dual(float v_) : v(v_), d(0.f) {}
  __device__ Dual(float v_, float d_) : v(v_), d(d_) {}
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  return {a.v / b.v, a.d / b.v - b.d * (a.v / b.v) / b.v};
}
__device__ __forceinline__ Dual operator+(Dual a, float s) { return {a.v + s, a.d}; }
__device__ __forceinline__ Dual operator+(float s, Dual a) { return {s + a.v, a.d}; }
__device__ __forceinline__ Dual operator-(Dual a, float s) { return {a.v - s, a.d}; }
__device__ __forceinline__ Dual operator-(float s, Dual a) { return {s - a.v, -a.d}; }
__device__ __forceinline__ Dual operator*(Dual a, float s) { return {a.v * s, a.d * s}; }
__device__ __forceinline__ Dual operator*(float s, Dual a) { return {s * a.v, s * a.d}; }
__device__ __forceinline__ Dual operator/(Dual a, float s) { return {a.v / s, a.d / s}; }

__device__ __forceinline__ float val(Dual x) { return x.v; }
__device__ __forceinline__ Dual sqrt_(Dual x) {
  const float s = sqrtf(x.v);
  return {s, x.d / (2.f * s)};
}
__device__ __forceinline__ Dual sin_(Dual x) { return {sinf(x.v), cosf(x.v) * x.d}; }
__device__ __forceinline__ Dual cos_(Dual x) { return {cosf(x.v), -sinf(x.v) * x.d}; }
__device__ __forceinline__ Dual atan2_(Dual y, Dual x) {
  const float den = y.v * y.v + x.v * x.v;
  return {atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / den};
}
// torch.clamp: NaN stays NaN; the derivative passes where lo <= x <= hi
__device__ __forceinline__ Dual clamp_(Dual x, float lo, float hi) {
  const float v = x.v < lo ? lo : (x.v > hi ? hi : x.v);
  return {v, (x.v >= lo && x.v <= hi) ? x.d : 0.f};
}
__device__ __forceinline__ Dual clamp_min_(Dual x, float lo) {
  return {x.v < lo ? lo : x.v, x.v >= lo ? x.d : 0.f};
}

constexpr float kNearPi = static_cast<float>(3.141592653589793 - 1e-2);

// lie.so3_log: inverse Rodrigues with its small-angle and near-pi branches
__device__ __forceinline__ void so3_log(const Pose<Dual>& T, Dual (&out)[3]) {
  const Dual R00 = T.m[0], R01 = T.m[1], R02 = T.m[2];
  const Dual R10 = T.m[4], R11 = T.m[5], R12 = T.m[6];
  const Dual R20 = T.m[8], R21 = T.m[9], R22 = T.m[10];
  const Dual trace = R00 + R11 + R22;
  const Dual c = clamp_((trace - 1.f) * 0.5f, -1.f, 1.f);
  const Dual w[3] = {0.5f * (R21 - R12), 0.5f * (R02 - R20), 0.5f * (R10 - R01)};
  const Dual sin_sq = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const bool tiny = sin_sq.v < 1e-12f;
  const Dual s = tiny ? Dual(0.f) : sqrt_(sin_sq);
  const Dual theta = atan2_(s, c);
  if (theta.v > kNearPi) {
    const Dual omc = clamp_min_(1.f - c, 1e-12f);
    const Dual diag[3] = {R00, R11, R22};
    Dual ax[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) ax[i] = sqrt_(clamp_min_((diag[i] - c) / omc, 0.f));
    const float sg01 = (R01 + R10).v >= 0.f ? 1.f : -1.f;
    const float sg02 = (R02 + R20).v >= 0.f ? 1.f : -1.f;
    const float sg12 = (R12 + R21).v >= 0.f ? 1.f : -1.f;
    // torch.argmax: the first of equal maxima
    const int k = ax[1].v > ax[0].v ? (ax[2].v > ax[1].v ? 2 : 1)
                                    : (ax[2].v > ax[0].v ? 2 : 0);
    Dual axis[3];
    if (k == 0) {
      axis[0] = ax[0]; axis[1] = sg01 * ax[1]; axis[2] = sg02 * ax[2];
    } else if (k == 1) {
      axis[0] = sg01 * ax[0]; axis[1] = ax[1]; axis[2] = sg12 * ax[2];
    } else {
      axis[0] = sg02 * ax[0]; axis[1] = sg12 * ax[1]; axis[2] = ax[2];
    }
    const bool flip = (axis[0] * w[0] + axis[1] * w[1] + axis[2] * w[2]).v < 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i) out[i] = (flip ? -axis[i] : axis[i]) * theta;
    return;
  }
  const Dual s_safe = fabsf(s.v) < 1e-10f ? Dual(1.f) : s;
  const Dual scale = theta.v < 1e-5f ? 1.f + theta * theta / 6.f : theta / s_safe;
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = w[i] * scale;
}

// lie.se3_log: (V^-1 t, w)
__device__ __forceinline__ void se3_log(const Pose<Dual>& T, Dual (&xi)[6]) {
  Dual w[3];
  so3_log(T, w);
  const Dual t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  Dual A, B, C;
  sinc_coeffs(t2, A, B, C);
  Dual coef;
  if (t2.v < kEps) {
    coef = static_cast<float>(1.0 / 12.0) + t2 / 720.f;
  } else {
    const Dual B_safe = fabsf(B.v) < 1e-12f ? Dual(1.f) : B;
    coef = (1.f - A / (2.f * B_safe)) / t2;
  }
  Dual W[9], W2[9];
  hat(w, W);
  mat3(W, W, W2);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    Dual u = Dual(0.f);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.f : 0.f;
      const Dual vij = e - 0.5f * W[3 * i + j] + coef * W2[3 * i + j];
      u = j == 0 ? vij * T.m[3] : u + vij * T.m[4 * j + 3];
    }
    xi[i] = u;
    xi[3 + i] = w[i];
  }
}

// T[n] exp(x[n]): the pose node n takes after the previous iteration's
// update (lie.se3_exp, then the 4x4 product). Not inlined, so the edges
// that linearize at it and the node that writes it run the same code.
__device__ __noinline__ Pose<float> updated_pose(const float* __restrict__ T,
                                                 const float* __restrict__ x, long long n) {
  float xi[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) xi[k] = x[6 * n + k];
  return compose(load_pose<float>(T, n), se3_exp(xi));
}

__device__ __forceinline__ Pose<float> pose_at(const float* __restrict__ T,
                                               const float* __restrict__ x, long long n) {
  return x ? updated_pose(T, x, n) : load_pose<float>(T, n);
}

__device__ __forceinline__ Pose<Dual> to_dual(const Pose<float>& P) {
  Pose<Dual> D;
#pragma unroll
  for (int k = 0; k < 12; ++k) D.m[k] = Dual(P.m[k]);
  return D;
}

// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

constexpr int kEdgeThreads = 128;          // 8 edges of 16 lanes
constexpr int kEdgesPerBlock = kEdgeThreads / 16;

struct EdgeArgs {
  const float* T;          // [N, 4, 4] poses before the update
  const float* x;          // [N, 6] the update, or null (T as it is)
  float* T_out;            // [N, 4, 4] T exp(x), written when x is set
  int N;
  const float* Z;          // [E, 4, 4]
  const long long* a;      // [E]
  const long long* b;      // [E]
  const float* w_t;        // [E]
  const float* w_r;        // [E]
  const unsigned char* valid;  // [E]
  int E;
  float delta, delta_sq;   // Huber threshold and its square
  float* H;                // [E, 12, 12]
  float* g;                // [E, 12]
  int edge_blocks;
};

__global__ void __launch_bounds__(kEdgeThreads) edges_kernel(const EdgeArgs p) {
  if (static_cast<int>(blockIdx.x) >= p.edge_blocks) {
    // the update of every node
    const long long n = static_cast<long long>(blockIdx.x - p.edge_blocks) * kEdgeThreads +
                        threadIdx.x;
    if (n >= p.N) return;
    const Pose<float> P = updated_pose(p.T, p.x, n);
    float* dst = p.T_out + 16 * n;
#pragma unroll
    for (int k = 0; k < 12; ++k) dst[k] = P.m[k];
    dst[12] = 0.f; dst[13] = 0.f; dst[14] = 0.f; dst[15] = 1.f;
    return;
  }
  const int lane = threadIdx.x & 15;
  const int e_raw = blockIdx.x * kEdgesPerBlock + (threadIdx.x >> 4);
  const bool live = e_raw < p.E && lane < 12;
  const int e = min(e_raw, p.E - 1);     // a whole warp takes part in the shuffles
  const int j = lane < 12 ? lane : 0;    // this lane's tangent direction

  const long long na = p.a[e], nb = p.b[e];
  Pose<Dual> Ta = to_dual(pose_at(p.T, p.x, na));
  Pose<Dual> Tb = to_dual(pose_at(p.T, p.x, nb));
  Dual xi[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) xi[k] = Dual(0.f, k == j % 6 ? 1.f : 0.f);
  const Pose<Dual> X = se3_exp(xi);
  if (j < 6) Ta = compose(Ta, X);
  else Tb = compose(Tb, X);
  const Pose<Dual> M = compose(compose(to_dual(inverse(load_pose<float>(p.Z, e))), inverse(Ta)),
                               Tb);
  Dual r[6];
  se3_log(M, r);

  // Huber weight on chi^2, information w_t on r[0:3] and w_r on r[3:6]
  float info[6], chi2 = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    info[k] = k < 3 ? p.w_t[e] : p.w_r[e];
    chi2 = k == 0 ? info[k] * r[k].v * r[k].v : chi2 + info[k] * r[k].v * r[k].v;
  }
  const float hw = chi2 <= p.delta_sq ? 1.f : p.delta / sqrtf(clamp_min(chi2, 1e-12f));
  const float wv = hw * (p.valid[e] ? 1.f : 0.f);
  float Jw[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) Jw[k] = r[k].d * (info[k] * wv);

  // Hblk[i][j] = sum_k Jw[k][i] J[k][j]: column i from lane i
  float* Hrow = p.H + static_cast<size_t>(e) * 144;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float h = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float jwi = __shfl_sync(0xffffffffu, Jw[k], i, 16);
      h = k == 0 ? jwi * r[k].d : h + jwi * r[k].d;
    }
    if (live) Hrow[12 * i + j] = h;
  }
  float bj = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) bj = k == 0 ? Jw[k] * r[k].v : bj + Jw[k] * r[k].v;
  if (live) p.g[static_cast<size_t>(e) * 12 + j] = bj;
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

constexpr int kAsmThreads = 256;

struct AssembleArgs {
  const float* H;          // [E, 12, 12]
  const float* g;          // [E, 12]
  const long long* a;
  const long long* b;
  const unsigned char* valid;
  int E;
  const unsigned char* node_valid;  // [N]
  const long long* fixed;           // the fixed node (on the card)
  int N;
  float lam;
  float* Hd;               // [6N, 6N]
  float* rhs;              // [6N]
};

__device__ __forceinline__ bool node_free(const unsigned char* nv, long long fixed, long long n) {
  return nv[n] != 0 && n != fixed;
}

__global__ void __launch_bounds__(kAsmThreads) assemble_kernel(const AssembleArgs p) {
  extern __shared__ int smem[];
  int* list = smem;                                  // [E]: the row node's valid edges
  unsigned* reach = reinterpret_cast<unsigned*>(smem + p.E);   // [ceil(N / 32)]
  __shared__ int warp_count[kAsmThreads / 32];
  __shared__ int list_len;
  const int n = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long fixed = *p.fixed;
  const bool row_free = node_free(p.node_valid, fixed, n);
  const int words = (p.N + 31) / 32;
  for (int w = tid; w < words; w += kAsmThreads) reach[w] = 0u;
  if (tid == 0) list_len = 0;
  __syncthreads();
  if (row_free) {
    // the valid edges at n, in ascending edge index
    for (int base = 0; base < p.E; base += kAsmThreads) {
      const int e = base + tid;
      const bool inc = e < p.E && p.valid[e] && (p.a[e] == n || p.b[e] == n);
      const unsigned ballot = __ballot_sync(0xffffffffu, inc);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int off = list_len;
      for (int w = 0; w < warp; ++w) off += warp_count[w];
      if (inc) {
        list[off + __popc(ballot & ((1u << lane) - 1u))] = e;
        const long long ea = p.a[e], eb = p.b[e];
        atomicOr(&reach[ea >> 5], 1u << (ea & 31));    // OR commutes: no order
        atomicOr(&reach[eb >> 5], 1u << (eb & 31));
      }
      __syncthreads();
      if (tid == 0) {
        int total = 0;
        for (int w = 0; w < kAsmThreads / 32; ++w) total += warp_count[w];
        list_len += total;
      }
      __syncthreads();
    }
  }
  const int L = list_len;
  const int six_n = 6 * p.N;
  if (tid < 6) {
    float s = 0.f;
    for (int q = 0; q < L; ++q) {
      const int e = list[q];
      if (p.a[e] == n) s += p.g[12 * e + tid];
      if (p.b[e] == n) s += p.g[12 * e + 6 + tid];
    }
    p.rhs[6 * n + tid] = -(row_free ? s : 0.f);
  }
  for (int c = tid; c < six_n; c += kAsmThreads) {
    const int m = c / 6, jj = c - 6 * m;
    const bool live = row_free && ((reach[m >> 5] >> (m & 31)) & 1u) &&
                      node_free(p.node_valid, fixed, m);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float v = 0.f;
      if (live) {
        for (int q = 0; q < L; ++q) {
          const int e = list[q];
          const long long ea = p.a[e], eb = p.b[e];
          const float* Hb = p.H + static_cast<size_t>(e) * 144;
          if (ea == n && ea == m) v += Hb[12 * i + jj];
          if (ea == n && eb == m) v += Hb[12 * i + 6 + jj];
          if (eb == n && ea == m) v += Hb[12 * (6 + i) + jj];
          if (eb == n && eb == m) v += Hb[12 * (6 + i) + 6 + jj];
        }
      }
      const int r = 6 * n + i;
      if (r == c) v = (v + (row_free ? p.lam : 1.f)) + 1e-6f;
      p.Hd[static_cast<size_t>(r) * six_n + c] = v;
    }
  }
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

constexpr int kPcgCluster = 8;
constexpr int kPcgThreads = 512;
constexpr int kPcgWarps = kPcgThreads / 32;

struct PcgArgs {
  const float* H;          // [E, 12, 12]
  const float* g;          // [E, 12]
  const long long* a;
  const long long* b;
  const unsigned char* valid;
  int E;
  const int* inc_off;      // [N + 1]
  const int* inc_ent;      // 2 e + side, per node in ascending edge index
  const unsigned char* node_valid;
  const long long* fixed;
  int N;
  float damp;
  int cg_iters;
  float* r;                // [N, 6] each
  float* z;
  float* pv;
  float* Hp;
  float* Dinv;             // [N, 36]
  float* ye;               // [E, 12]
  float* x;                // [N, 6] the solution
  int* steps;              // the CG steps run, or null
};

// The cluster's sums of K per-thread values: warp shuffles, the block's
// warps in index order, then each block pushes its sums into slot[rank]
// of every block; after the barrier every thread adds the 8 slots in rank
// order, so every block holds the same bits.
template <int K>
__device__ __forceinline__ void cluster_sum(float (&v)[K], float (*slot)[4],
                                            float (*wsum)[4], int rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    if (lane == 0) wsum[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < kPcgCluster) {
    float s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] = wsum[0][k];
      for (int w = 1; w < kPcgWarps; ++w) s[k] += wsum[w][k];
    }
    float* dst = cg::this_cluster().map_shared_rank(&slot[rank][0], threadIdx.x);
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k] = s[k];
  }
  cg::this_cluster().sync();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = slot[0][k];
#pragma unroll
    for (int q = 1; q < kPcgCluster; ++q) v[k] += slot[q][k];
  }
}

__global__ void __cluster_dims__(kPcgCluster, 1, 1) __launch_bounds__(kPcgThreads)
pcg_kernel(const PcgArgs p) {
  __shared__ float slot[2][kPcgCluster][4];
  __shared__ float wsum[kPcgWarps][4];
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int gtid = rank * kPcgThreads + threadIdx.x;
  const int stride = kPcgCluster * kPcgThreads;
  const long long fixed = *p.fixed;
  auto fr = [&](long long n) { return node_free(p.node_valid, fixed, n) ? 1.f : 0.f; };

  // b, the block-Jacobi inverses, r = b, z = M r, x = 0
  float acc[3] = {0.f, 0.f, 0.f};          // b.b, r.z, r.r
  for (int n = gtid; n < p.N; n += stride) {
    const float f = fr(n);
    float bs[6], A[36], B[36];
#pragma unroll
    for (int i = 0; i < 6; ++i) bs[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 36; ++k) { A[k] = 0.f; B[k] = (k % 7 == 0) ? 1.f : 0.f; }
    for (int q = p.inc_off[n]; q < p.inc_off[n + 1]; ++q) {
      const int ent = p.inc_ent[q], e = ent >> 1, side = 6 * (ent & 1);
      const float* Hb = p.H + static_cast<size_t>(e) * 144;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        bs[i] += p.g[12 * e + side + i];
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) A[6 * i + jj] += Hb[12 * (side + i) + side + jj];
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) A[7 * i] += p.damp;
    // Gauss-Jordan on the symmetric positive definite block
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float inv = 1.f / A[7 * k];
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) { A[6 * k + jj] *= inv; B[6 * k + jj] *= inv; }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        if (i == k) continue;
        const float m = A[6 * i + k];
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) {
          A[6 * i + jj] -= m * A[6 * k + jj];
          B[6 * i + jj] -= m * B[6 * k + jj];
        }
      }
    }
    float* Dn = p.Dinv + 36 * n;
#pragma unroll
    for (int k = 0; k < 36; ++k) Dn[k] = B[k];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float bi = -bs[i] * f;
      float zi = 0.f;
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) zi += B[6 * i + jj] * (-bs[jj] * f);
      zi *= f;
      p.r[6 * n + i] = bi;
      p.z[6 * n + i] = zi;
      p.pv[6 * n + i] = 0.f;
      p.x[6 * n + i] = 0.f;
      acc[0] += bi * bi;
      acc[1] += bi * zi;
      acc[2] += bi * bi;
    }
  }
  cluster_sum<3>(acc, slot[0], wsum, rank);
  const float bb = fmaxf(acc[0], 1e-20f);
  float rz = acc[1], rr = acc[2], beta = 0.f;

  int it = 0;
  for (; it < p.cg_iters && rr > 1e-10f * bb; ++it) {
    // edge pass: row `row` of edge e's block times (p_a, p_b), p = z + beta p
    for (int q = gtid; q < 12 * p.E; q += stride) {
      const int e = q / 12, row = q - 12 * e;
      if (!p.valid[e]) continue;
      const long long na = p.a[e], nb = p.b[e];
      const float fa = fr(na), fb = fr(nb);
      const float* Hr = p.H + static_cast<size_t>(e) * 144 + 12 * row;
      float ya = 0.f, yb = 0.f;
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        const float pa = (p.z[6 * na + jj] + beta * p.pv[6 * na + jj]) * fa;
        const float pb = (p.z[6 * nb + jj] + beta * p.pv[6 * nb + jj]) * fb;
        ya += Hr[jj] * pa;
        yb += Hr[6 + jj] * pb;
      }
      p.ye[q] = ya + yb;
    }
    cg::this_cluster().sync();
    // node pass: p, H p = (sum of the edges' rows + damp p) on free nodes
    float pHp[1] = {0.f};
    for (int n = gtid; n < p.N; n += stride) {
      const float f = fr(n);
      float y[6], pn[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        pn[i] = p.z[6 * n + i] + beta * p.pv[6 * n + i];
        y[i] = 0.f;
      }
      for (int q = p.inc_off[n]; q < p.inc_off[n + 1]; ++q) {
        const int ent = p.inc_ent[q], e = ent >> 1, side = 6 * (ent & 1);
#pragma unroll
        for (int i = 0; i < 6; ++i) y[i] += p.ye[12 * e + side + i];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float hp = (y[i] + p.damp * (pn[i] * f)) * f;
        p.pv[6 * n + i] = pn[i];
        p.Hp[6 * n + i] = hp;
        pHp[0] += pn[i] * hp;
      }
    }
    cluster_sum<1>(pHp, slot[1], wsum, rank);
    const float alpha = rz / fmaxf(pHp[0], 1e-20f);
    // x += alpha p, r -= alpha H p, z = M r
    float sums[2] = {0.f, 0.f};              // r.z, r.r
    for (int n = gtid; n < p.N; n += stride) {
      const float f = fr(n);
      float rn[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        p.x[6 * n + i] += alpha * p.pv[6 * n + i];
        rn[i] = p.r[6 * n + i] - alpha * p.Hp[6 * n + i];
        p.r[6 * n + i] = rn[i];
      }
      const float* Dn = p.Dinv + 36 * n;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float zi = 0.f;
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) zi += Dn[6 * i + jj] * rn[jj];
        zi *= f;
        p.z[6 * n + i] = zi;
        sums[0] += rn[i] * zi;
        sums[1] += rn[i] * rn[i];
      }
    }
    cluster_sum<2>(sums, slot[0], wsum, rank);
    beta = sums[0] / fmaxf(rz, 1e-20f);
    rz = sums[0];
    rr = sums[1];
  }
  if (p.steps && gtid == 0) *p.steps = it;
  cg::this_cluster().sync();    // no block leaves while another reads its slots
}

}  // namespace

// K6: per edge the Gauss-Newton blocks at T exp(x) (x null: at T), and
// T exp(x) of every node into T_out; E = 0 only updates.
DSSLAM_API int dsslam_pose_graph_edges(const float* T, const float* x, float* T_out, int N,
                                       const float* Z, const long long* a, const long long* b,
                                       const float* w_t, const float* w_r,
                                       const unsigned char* valid, int E, float delta,
                                       float delta_sq, float* H, float* g,
                                       cudaStream_t stream) {
  if (N < 1 || E < 0 || (x && !T_out)) return cudaErrorInvalidValue;
  EdgeArgs p{T, x, T_out, N, Z, a, b, w_t, w_r, valid, E, delta, delta_sq, H, g,
             (E + kEdgesPerBlock - 1) / kEdgesPerBlock};
  const int node_blocks = x ? (N + kEdgeThreads - 1) / kEdgeThreads : 0;
  if (p.edge_blocks + node_blocks == 0) return cudaSuccess;
  edges_kernel<<<p.edge_blocks + node_blocks, kEdgeThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// K7: the damped, masked [6N, 6N] system and its right-hand side -b.
DSSLAM_API int dsslam_pose_graph_assemble(const float* H, const float* g, const long long* a,
                                          const long long* b, const unsigned char* valid,
                                          int E, const unsigned char* node_valid,
                                          const long long* fixed, int N, float lam,
                                          float* Hd, float* rhs, cudaStream_t stream) {
  if (N < 1 || E < 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(int) * (static_cast<size_t>(E) + (N + 31) / 32);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assemble_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  AssembleArgs p{H, g, a, b, valid, E, node_valid, fixed, N, lam, Hd, rhs};
  assemble_kernel<<<N, kAsmThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// K8: block-Jacobi PCG on the free nodes, one cluster, x [N, 6] out (and
// the number of CG steps it ran, if steps is set); work holds 4 x [N, 6] +
// [N, 36] + [E, 12] floats.
DSSLAM_API int dsslam_pose_graph_pcg(const float* H, const float* g, const long long* a,
                                     const long long* b, const unsigned char* valid, int E,
                                     const int* inc_off, const int* inc_ent,
                                     const unsigned char* node_valid, const long long* fixed,
                                     int N, float damp, int cg_iters, float* work, float* x,
                                     int* steps, cudaStream_t stream) {
  if (N < 1 || E < 0 || cg_iters < 0) return cudaErrorInvalidValue;
  const size_t n6 = 6 * static_cast<size_t>(N);
  PcgArgs p{H, g, a, b, valid, E, inc_off, inc_ent, node_valid, fixed, N, damp, cg_iters,
            work, work + n6, work + 2 * n6, work + 3 * n6, work + 4 * n6,
            work + 4 * n6 + 36 * static_cast<size_t>(N), x, steps};
  pcg_kernel<<<kPcgCluster, kPcgThreads, 0, stream>>>(p);
  return cudaGetLastError();
}
