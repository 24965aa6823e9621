// K6-K8: the loop closure's SE(3) pose graph on the card. A dense
// optimize (up to 512 nodes) of loop/pose_graph.py is one K7 launch that
// runs every Gauss-Newton iteration; above, a CG optimize is one launch of
// K8's redesign (dsslam_pose_graph_cg) that runs them all, K6's edge phase
// included. The queued K6 -> K8 form stays as its bit reference.
//
// They replace the jitted JAX program
// direct_stereo_slam_tpu/loop/pose_graph.py::optimize (:187, 25 GN
// iterations in a lax.scan):
//   K6 dsslam_pose_graph_edges <- :68 _edge_system (+ :56 _edge_res_jac)
//   K7 dsslam_pose_graph_gn    <- :96 _solve_dense (assembly and solve),
//                                 with K6's edge phase, the whole scan
//   K8 dsslam_pose_graph_pcg   <- :122 _solve_cg (its while_loop)
//      dsslam_pose_graph_cg    <- :187 optimize's CG scan whole (with K6's
//                                 edge phase and the update)
// The port's plain versions are loop/pose_graph.py::_edge_system,
// _solve_dense_fixed (K7's arithmetic, in its order) and _solve_cg.
//
// What bounds them on the H100. K6 reads two poses and a measurement per
// edge (~200 B) and writes a 12x12 block and a 12-vector (624 B): at the
// loop phase's E <= 1024 edges well under a microsecond at 3.35 TB/s; its
// ~3k f32 operations per edge are less. K7's factorization and solves
// take n^3 / 3 + 2 n^2 f32 operations at n = 6N (2.3 us at n = 768, 144
// us at 3072 over 67 TFLOP/s); its system (2.4 MB at N = 128, 38 MB at
// N = 512) stays in the 50 MB L2. What it really pays is latency: the
// factorization is n / 32 dependent panel steps, each behind grid
// barriers. K8 is a chain of ~100 CG steps, each a pass over the edge
// blocks (E x 576 B from L2) and two global dot products: latency bound,
// by its barriers. None has a product a tensor core could take (6x6 and
// 12x12 blocks, panels of 32, f32 pinned by the reference).
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
//   The edge body is __noinline__ too: K7's edge phase runs the same code.
// - K7, a persistent grid (a cooperative launch, one block of 256 threads
//   an SM, all resident; cg::this_grid().sync() between phases, ~1.4 us).
//   An iteration: K6's edge phase and the update (a warp two edges); the
//   assembly, one block a node row: the row node's valid edges in
//   ascending edge index (a block-wide ordered compaction), each thread
//   owning columns of the six rows and adding the edges' sub-blocks in
//   that order, the fixed and invalid nodes masked, then lam and 1e-6 on
//   the diagonal (the bits of _assemble_dense_fixed), into A whole and L's
//   lower triangle, -b into both border rows; a right-looking Cholesky of
//   L in panels of 32 columns (the system is J^T W J with W >= 0, masked
//   rows with a unit diagonal, and damping: symmetric positive definite,
//   so no pivoting; no entry is skipped, so a NaN spreads as LU spreads
//   it): a panel phase, a warp a chunk of 32 rows (each warp factors the
//   diagonal block itself, in registers, a shuffle and a __syncwarp a
//   column), and an update phase of 32x32 tiles on and below the
//   diagonal, every entry an FMA chain over the panel's columns in
//   ascending order, owned by one thread: no atomics, the same bits every
//   run. The border row turns the forward solve into a row of the
//   factorization; the panel phase also writes L^T above the diagonal, so
//   the solves read rows. Then the solves as wavefronts over the grid, a
//   warp a chunk of 32 unknowns, each waiting only for the chunks it needs
//   (an unknown is published with its solve's epoch in one 64-bit word):
//   x = L^-T y, the residual r = -b - A x on the whole matrix (a warp a
//   row, in twice f32's precision: Dot2), and x += L^-T L^-1 r. The f32
//   blocks are symmetric only to rounding and the Cholesky reads the
//   lower triangle, the reference's LU the whole: the refinement takes x
//   to the whole system's solution, ~1e-8 x max|x| from float64 where the
//   plain Cholesky was more than 2x LU's error on small graphs
//   (loop/pose_graph.py _solve_dense_fixed). Barriers an iteration:
//   2 n / 32 + 4.
// - K8 (queued), one 8-block cluster of 512 threads for the whole solve, the
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
// - The resident CG optimize (K8's redesign, cg_opt_kernel): every
//   Gauss-Newton iteration of optimize(solver="cg") in one launch: the
//   update and K6's edge phase (edge_lanes, as K7), K8's per-node set-up,
//   and a CG step of two barriers: a node pass that forms p and gathers
//   H p from the rows of its own edges (each edge side's rows are needed by
//   that side's node only, so nothing is computed twice and no edge pass or
//   barrier sits before it; p is double-buffered), then the update, each
//   eight lanes a node (a lane a row: the node's loads and FMA chains
//   split six ways, the entries read from records made with the incidence
//   lists: 2 e + side, both ends, their free bits). Every
//   dot product is summed in an order fixed by node index, which is K8's
//   for N <= 4096, through chunk partials in global memory that every warp
//   sums itself: the bits do not depend on the grid, and every block takes
//   the same branch. It is a cooperative grid, one block an SM, with grid
//   barriers: at N = 1024 a node pass is one round of its 132 blocks. (One
//   8-block cluster with cluster barriers, the same code at two rounds a
//   pass, measured slower: PERF.md.) A partial buffer is written again
//   only after a barrier that follows every read of it, so the set-up's
//   b.b has a buffer of its own: the first node pass writes its p.Hp
//   partials while slower blocks may still read the set-up's.

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

// Edge e_raw's 12x12 block and 12-vector at T exp(x), on the 16 lanes
// of a half warp (lane: this thread's lane among them; e_raw >= E: the
// half warp only takes part in the shuffles). Every lane of the warp
// calls it. Not inlined, so K6 and the dense kernel's edge phase run the
// same code and write the same bits.
__device__ __noinline__ void edge_lanes(const EdgeArgs& p, int e_raw, int lane) {
  const bool live = e_raw < p.E && lane < 12;
  const int e = min(e_raw, p.E - 1);
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

// T_out[n] = T[n] exp(x[n]), the bottom row [0 0 0 1]
__device__ __forceinline__ void write_updated(const float* __restrict__ T,
                                              const float* __restrict__ x, float* T_out,
                                              long long n) {
  const Pose<float> P = updated_pose(T, x, n);
  float* dst = T_out + 16 * n;
#pragma unroll
  for (int k = 0; k < 12; ++k) dst[k] = P.m[k];
  dst[12] = 0.f; dst[13] = 0.f; dst[14] = 0.f; dst[15] = 1.f;
}

__global__ void __launch_bounds__(kEdgeThreads) edges_kernel(const __grid_constant__ EdgeArgs p) {
  if (static_cast<int>(blockIdx.x) >= p.edge_blocks) {
    // the update of every node
    const long long n = static_cast<long long>(blockIdx.x - p.edge_blocks) * kEdgeThreads +
                        threadIdx.x;
    if (n < p.N) write_updated(p.T, p.x, p.T_out, n);
    return;
  }
  edge_lanes(p, blockIdx.x * kEdgesPerBlock + (threadIdx.x >> 4), threadIdx.x & 15);
}

// ---------------------------------------------------------------------------
// K7: the whole Gauss-Newton loop of a dense optimize in one launch
// ---------------------------------------------------------------------------

constexpr int kGnThreads = 256;
constexpr int kGnWarps = kGnThreads / 32;
constexpr int kPanel = 32;                         // loop/pose_graph.py PANEL
constexpr int kGnBlocksPerSm = 1;

// phase stamps (ops/pose_graph.py GN_STAMPS): block 0's thread 0 adds
// the %globaltimer ns it spends in each phase, and waiting at the grid
// barriers, over the whole launch
enum GnPhase {
  kStampEdges, kStampAssembly, kStampPanel, kStampUpdate, kStampSolve, kStampResidual,
  kStampRefine, kStampFinal, kStampBarrier, kStampBarriers, kStampTotal, kGnStamps
};

struct GnArgs {
  EdgeArgs e;              // T, x: the poses and the update the first iteration starts from
  const unsigned char* node_valid;
  const long long* fixed;
  float lam;
  int iterations;
  int stop;                // 0 all; 1 / 2 the last iteration stops after its assembly / solve;
                           // 3 only `iterations` grid barriers
  float* P;                // [2, N, 16] iteration k's poses in P[k & 1]
  float* x;                // [6N] the update
  float* A;                // [6N + 1, 6N] the damped system, -b in its last row
  float* L;                // [6N + 1, 6N] its Cholesky factor (lower; L^T above the diagonal),
                           // L^-1 (-b) in the last row
  float* r;                // [6N] the residual and its solve
  unsigned long long* words;    // [6N] the solves' published unknowns
  float* T_out;            // [N, 16]
  unsigned long long* timers;   // kGnStamps words, or null
};

struct Stamps {
  unsigned long long* t;
  unsigned long long last;
  __device__ static unsigned long long now() {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    return ns;
  }
  __device__ explicit Stamps(unsigned long long* timers)
      : t(blockIdx.x == 0 && threadIdx.x == 0 ? timers : nullptr), last(t ? now() : 0) {}
  __device__ void mark(int phase) {
    if (t) {
      const unsigned long long ns = now();
      t[phase] += ns - last;
      last = ns;
    }
  }
  // the end of a phase, then a grid barrier
  __device__ void sync(cg::grid_group& grid, int phase) {
    mark(phase);
    grid.sync();
    mark(kStampBarrier);
    if (t) t[kStampBarriers] += 1;
  }
};

__device__ __forceinline__ bool node_free(const unsigned char* nv, long long fixed, long long n) {
  return nv[n] != 0 && n != fixed;
}

// Rows 6 nd ... 6 nd + 5 of the damped system (block-wide): the row
// node's valid edges listed in ascending edge index (an ordered
// compaction), the nodes they reach marked; each thread then owns
// columns of the six rows and adds the edges' sub-blocks into each entry
// in that order, writes a zero where no edge reaches, masks fixed and
// invalid nodes and adds the damping: loop/pose_graph.py
// _assemble_dense_fixed's bits. An invalid edge's blocks are zero (its
// weight is 0), so skipping it changes no sum (unless its Jacobian is
// not finite, which a padding edge's, at the identity, never is). The
// rows go to A whole and to L below the diagonal; -b to both last rows.
__device__ void assemble_rows(const GnArgs& p, int nd, int* list, unsigned* reach) {
  __shared__ int warp_count[kGnWarps];
  __shared__ int list_len;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = p.e.N, E = p.e.E, n = 6 * N;
  const long long* ea = p.e.a;
  const long long* eb = p.e.b;
  const long long fixed = *p.fixed;
  const bool row_free = node_free(p.node_valid, fixed, nd);
  const int words = (N + 31) / 32;
  __syncthreads();                                   // the previous row's list is read
  for (int w = tid; w < words; w += kGnThreads) reach[w] = 0u;
  if (tid == 0) list_len = 0;
  __syncthreads();
  if (row_free) {
    for (int base = 0; base < E; base += kGnThreads) {
      const int e = base + tid;
      const bool inc = e < E && p.e.valid[e] && (ea[e] == nd || eb[e] == nd);
      const unsigned ballot = __ballot_sync(0xffffffffu, inc);
      if (lane == 0) warp_count[warp] = __popc(ballot);
      __syncthreads();
      int off = list_len;
      for (int w = 0; w < warp; ++w) off += warp_count[w];
      if (inc) {
        list[off + __popc(ballot & ((1u << lane) - 1u))] = e;
        atomicOr(&reach[ea[e] >> 5], 1u << (ea[e] & 31));    // OR commutes: no order
        atomicOr(&reach[eb[e] >> 5], 1u << (eb[e] & 31));
      }
      __syncthreads();
      if (tid == 0) {
        int total = 0;
        for (int w = 0; w < kGnWarps; ++w) total += warp_count[w];
        list_len += total;
      }
      __syncthreads();
    }
  }
  const int len = list_len;
  const float* Hb = p.e.H;
  const float* g = p.e.g;
  float* A_last = p.A + static_cast<size_t>(n) * n;
  float* L_last = p.L + static_cast<size_t>(n) * n;
  if (tid < 6) {
    float s = 0.f;
    for (int q = 0; q < len; ++q) {
      const int e = list[q];
      if (ea[e] == nd) s += g[12 * e + tid];
      if (eb[e] == nd) s += g[12 * e + 6 + tid];
    }
    const float rhs = -(row_free ? s : 0.f);
    A_last[6 * nd + tid] = rhs;
    L_last[6 * nd + tid] = rhs;
  }
  for (int c = tid; c < n; c += kGnThreads) {
    const int m = c / 6, jj = c - 6 * m;
    const bool live = row_free && ((reach[m >> 5] >> (m & 31)) & 1u) &&
                      node_free(p.node_valid, fixed, m);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float v = 0.f;
      if (live) {
        for (int q = 0; q < len; ++q) {
          const int e = list[q];
          const long long a = ea[e], b = eb[e];
          const float* B = Hb + static_cast<size_t>(e) * 144;
          if (a == nd && a == m) v += B[12 * i + jj];
          if (a == nd && b == m) v += B[12 * i + 6 + jj];
          if (b == nd && a == m) v += B[12 * (6 + i) + jj];
          if (b == nd && b == m) v += B[12 * (6 + i) + 6 + jj];
        }
      }
      const int r = 6 * nd + i;
      if (r == c) v = (v + (row_free ? p.lam : 1.f)) + 1e-6f;
      p.A[static_cast<size_t>(r) * n + c] = v;
      if (c <= r) p.L[static_cast<size_t>(r) * n + c] = v;
    }
  }
}

// A warp's 32x32 tile from its registers (lane i: row i) to rows r0 ...
// of L at column k0, through its shared buffer so that every global store
// is a coalesced row; rows past `rows`, columns past w and, with lower,
// entries above the diagonal are not written.
__device__ __forceinline__ void tile_store(float* L, int n, int r0, int k0, int rows, int w,
                                           bool lower, float (*tile)[kPanel + 1],
                                           const float (&R)[kPanel]) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kPanel; ++c) tile[lane][c] = R[c];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kPanel; ++r)
    if (r < rows && lane < w && (!lower || lane <= r))
      L[static_cast<size_t>(r0 + r) * n + k0 + lane] = tile[r][lane];
}

// One warp's part of panel k0 (width w, kFull: w = 32): the 32x32
// diagonal block and the chunk of `rows` rows from r0, a row of each a
// lane in registers (lane i: D = diagonal row k0 + i, C = chunk row
// r0 + i), loaded as coalesced rows through the warp's two tiles,
// factored a column at a time with no block barrier: the pivot's
// reciprocal square root r (rsqrt; L_jj = d r), the column times r, the
// column's diagonal-block entries through the warp's shared buffer
// (double-buffered: one __syncwarp a column), then the rank-1 update of
// both rows' later entries (an FMA each); the next pivot goes first, from
// the next lane's own entries, so its latency hides behind the update.
// The factor goes below the diagonal and, transposed, above it (the
// solves read both a row at a time); one warp (`diag`) writes the
// diagonal block.
template <bool kFull>
__device__ __forceinline__ void panel_chunk(float* L, int n, int k0, int w_rt, int r0, int rows,
                                            bool diag, float (*buf)[kPanel],
                                            float (*tile)[kPanel + 1]) {
  const int lane = threadIdx.x & 31;
  const int w = kFull ? kPanel : w_rt;
  float (*tile2)[kPanel + 1] = tile + kPanel;
  float D[kPanel], C[kPanel];
  __syncwarp();                                   // the tiles are free
#pragma unroll
  for (int r = 0; r < kPanel; ++r) {
    tile[r][lane] = r < w && lane < w && lane <= r
                        ? L[static_cast<size_t>(k0 + r) * n + k0 + lane] : 0.f;
    tile2[r][lane] = r < rows && lane < w ? L[static_cast<size_t>(r0 + r) * n + k0 + lane] : 0.f;
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    D[c] = tile[lane][c];
    C[c] = tile2[lane][c];
  }
  float d = __shfl_sync(0xffffffffu, D[0], 0);
  float inv = rsqrtf(d), piv = d * inv;
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    if (j < w) {
      D[j] = lane == j ? piv : (lane > j ? D[j] * inv : D[j]);
      C[j] *= inv;
      if (j + 1 < w) {
        // the next pivot first: lane j + 1's diagonal takes its own L_(j+1)j
        // (the same FMA the update below gives it), so the pivot chain
        // waits for no exchange but the broadcast
        d = __shfl_sync(0xffffffffu, fmaf(-D[j], D[j], D[j + 1]), j + 1);
        inv = rsqrtf(d);
        piv = d * inv;
      }
      buf[j & 1][lane] = D[j];                    // L[k0 + lane][k0 + j]
      __syncwarp();
#pragma unroll
      for (int c = j + 1; c < kPanel; ++c) {
        if (c < w) {
          const float lc = buf[j & 1][c];
          if (lane >= c) D[c] = fmaf(-D[j], lc, D[c]);
          C[c] = fmaf(-C[j], lc, C[c]);
        }
      }
    }
  }
  tile_store(L, n, r0, k0, rows, w, false, tile2, C);
#pragma unroll
  for (int c = 0; c < kPanel; ++c)                // L^T: row k0 + c, the chunk's columns
    if (c < w && lane < rows && r0 + lane < n)
      L[static_cast<size_t>(k0 + c) * n + r0 + lane] = C[c];
  if (diag) {
    tile_store(L, n, k0, k0, w, w, true, tile, D);
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      if (c < lane && lane < w) L[static_cast<size_t>(k0 + c) * n + k0 + lane] = D[c];
  }
}

// Panel k0's columns of L, rows k0 ... n (the border row n included),
// chunks of 32 rows below the diagonal block, a warp each.
__device__ void panel_phase(float* L, int n, int k0, float (*wbuf)[2][kPanel],
                            float (*tiles)[kPanel][kPanel + 1]) {
  float (*buf)[kPanel] = wbuf[threadIdx.x >> 5];
  float (*tile)[kPanel + 1] = tiles[2 * (threadIdx.x >> 5)];
  const int w = min(kPanel, n - k0);
  const int first = k0 + w;                       // the first row below the diagonal block
  const int chunks = (n + 1 - first + kPanel - 1) / kPanel;
  const int nwarps = gridDim.x * kGnWarps;
  for (int ch = (blockIdx.x * kGnThreads + threadIdx.x) >> 5; ch < chunks; ch += nwarps) {
    const int r0 = first + ch * kPanel, rows = min(kPanel, n + 1 - r0);
    // the last chunk (the border row's, the fewest rows) writes the diagonal block
    const bool diag = ch == chunks - 1;
    if (w == kPanel) panel_chunk<true>(L, n, k0, w, r0, rows, diag, buf, tile);
    else panel_chunk<false>(L, n, k0, w, r0, rows, diag, buf, tile);
  }
}

// The trailing update of panel k0: every 32x32 tile on or below the
// diagonal of the rows and columns after it, and the border row's tiles,
// L_ij -= sum_k L_ik L_jk over the panel's columns in ascending order
// (one thread an entry, an FMA chain; no atomics). A block's next tile is
// loaded into registers while it computes the current one.
struct UpdateTile {
  int I, J, ri, cj, nrows, ncols;
  bool border;
};

__device__ __forceinline__ UpdateTile update_tile(int t, int T, int lower, int k1, int n) {
  UpdateTile u;
  u.border = t >= lower;
  u.I = T;
  u.J = t - lower;
  if (!u.border) {
    int I = static_cast<int>((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while ((I + 1) * (I + 2) / 2 <= t) ++I;
    while (I * (I + 1) / 2 > t) --I;
    u.I = I;
    u.J = t - I * (I + 1) / 2;
  }
  u.ri = k1 + kPanel * u.I;
  u.cj = k1 + kPanel * u.J;
  u.nrows = u.border ? 1 : min(kPanel, n - u.ri);
  u.ncols = min(kPanel, n - u.cj);
  return u;
}

__device__ void update_phase(float* L, int n, int k0, float (*sa)[kPanel + 1],
                             float (*sb)[kPanel + 1]) {
  constexpr int kRows = kPanel / kGnWarps;        // the entries of a thread: rows i, i + 8, ...
  const int tid = threadIdx.x, j = tid % kPanel, i0 = tid / kPanel;
  const int w = min(kPanel, n - k0), k1 = k0 + w;
  const int T = (n - k1 + kPanel - 1) / kPanel;
  const int lower = T * (T + 1) / 2;
  float pa[kRows], pb[kRows];
  auto fetch = [&](const UpdateTile& u) {
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = i0 + kGnWarps * q;            // row i of the tile, column j of the panel
      pa[q] = i < u.nrows && j < w
                  ? L[static_cast<size_t>(u.border ? n : u.ri + i) * n + k0 + j] : 0.f;
      pb[q] = i < u.ncols && j < w ? L[static_cast<size_t>(u.cj + i) * n + k0 + j] : 0.f;
    }
  };
  int t = blockIdx.x;
  if (t < lower + T) fetch(update_tile(t, T, lower, k1, n));
  for (; t < lower + T; t += gridDim.x) {
    const UpdateTile u = update_tile(t, T, lower, k1, n);
    __syncthreads();                              // the previous tile's reads are done
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      sa[i0 + kGnWarps * q][j] = pa[q];
      sb[i0 + kGnWarps * q][j] = pb[q];
    }
    __syncthreads();
    if (t + static_cast<int>(gridDim.x) < lower + T)
      fetch(update_tile(t + gridDim.x, T, lower, k1, n));
    float acc[kRows];
    bool live[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = i0 + kGnWarps * q;
      live[q] = i < u.nrows && j < u.ncols && (u.border || u.I != u.J || j <= i);
      acc[q] = live[q] ? L[static_cast<size_t>(u.border ? n : u.ri + i) * n + u.cj + j] : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < kPanel; ++kk) {
      const float bj = sb[j][kk];
#pragma unroll
      for (int q = 0; q < kRows; ++q) acc[q] = fmaf(-sa[i0 + kGnWarps * q][kk], bj, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < kRows; ++q)
      if (live[q])
        L[static_cast<size_t>(u.border ? n : u.ri + i0 + kGnWarps * q) * n + u.cj + j] = acc[q];
  }
}

// A sum carried as hi + lo in f32 (Ogita, Rump and Oishi's Dot2): every
// product and sum adds its rounding error (an FMA for the product, the
// two-sum for the sum) to lo, so the result is as if accumulated in
// twice f32's precision. The refinement's residual needs it: rounded in
// f32, r's error is cond(A) eps, and a step of refinement gains nothing on
// a small well-conditioned graph.
struct Dot2 {
  float hi, lo;
  __device__ __forceinline__ void add(Dot2 o) {
    const float t = hi + o.hi, z = t - hi;
    lo += (hi - (t - z)) + (o.hi - z) + o.lo;
    hi = t;
  }
  __device__ __forceinline__ void add_product(float a, float b) {
    const float prod = a * b;
    add(Dot2{prod, fmaf(a, b, -prod)});
  }
};

// A solved unknown and the epoch of the solve that wrote it, in one
// 64-bit word: a single store publishes both, so a reader that sees its
// epoch sees its value (no flag, no fence).
__device__ __forceinline__ unsigned long long ld_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_word(unsigned long long* p, unsigned epoch, float x) {
  const unsigned long long v =
      (static_cast<unsigned long long>(epoch) << 32) | __float_as_uint(x);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// v := L^-1 v (forward) or L^-T v (backward) over the grid, a warp a
// chunk of 32 unknowns (in place; src, if set, is read instead of v's
// chunk, and add, if set, gets the result added to it). A chunk's warp
// takes the solved chunks' pushes in order (forward: ascending, from L^T
// above the diagonal; backward: descending, from L below it: a row of the
// factor a step, its block loaded before it waits), each once the
// chunk's words (unknown, epoch) carry this solve's epoch, then solves
// its 32x32 diagonal block in registers, a column a step (the unknown
// times the diagonal's reciprocal, broadcast, an FMA into each lane still
// to solve), and publishes its words. No grid barrier: a chunk waits only
// for the chunks it needs; every entry's sum has a fixed order.
template <bool kForward, bool kFull>
__device__ __forceinline__ void wave_chunk(const float* __restrict__ L, int n, int m, int P,
                                           float* v, const float* src, float* add,
                                           unsigned long long* words, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  const int r0 = kPanel * m, w = kFull ? kPanel : min(kPanel, n - r0);
  float D[kPanel], B[kPanel];
#pragma unroll
  for (int c = 0; c < kPanel; ++c) {
    const bool in = lane < w && c < w && (kForward ? c < lane : c > lane);
    D[c] = in ? L[static_cast<size_t>(r0 + c) * n + r0 + lane] : 0.f;
  }
  const float dg = lane < w ? L[static_cast<size_t>(r0 + lane) * n + r0 + lane] : 1.f;
  float t = lane < w ? (src ? src[r0 + lane] : v[r0 + lane]) : 0.f;
  for (int s = 0; s < (kForward ? m : P - 1 - m); ++s) {
    const int k = kForward ? s : P - 1 - s;
    const int k0 = kPanel * k, wk = kFull ? kPanel : min(kPanel, n - k0);
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      B[c] = c < wk && lane < w ? L[static_cast<size_t>(k0 + c) * n + r0 + lane] : 0.f;
    // lane 0 waits for the chunk's first word, then every lane reads its own
    if (lane == 0) {
      while (static_cast<unsigned>(ld_word(words + k0) >> 32) != epoch) __nanosleep(32);
    }
    __syncwarp();
    unsigned long long word = 0;
    if (lane < wk) {
      do {
        word = ld_word(words + k0 + lane);
      } while (static_cast<unsigned>(word >> 32) != epoch);
    }
    __syncwarp();
    const float xk = __uint_as_float(static_cast<unsigned>(word));
#pragma unroll
    for (int c = 0; c < kPanel; ++c)
      if (c < wk) t = fmaf(-B[c], __shfl_sync(0xffffffffu, xk, c), t);
  }
  const float inv = 1.f / dg;
#pragma unroll
  for (int qq = 0; qq < kPanel; ++qq) {
    const int c = kForward ? qq : kPanel - 1 - qq;
    if (c < w) {
      const float xc = __shfl_sync(0xffffffffu, t * inv, c);
      if (lane == c) t = xc;
      else if (kForward ? lane > c : lane < c) t = fmaf(-D[c], xc, t);
    }
  }
  if (lane < w) {
    st_word(words + r0 + lane, epoch, t);
    v[r0 + lane] = t;
    if (add) add[r0 + lane] += t;
  }
}

template <bool kForward>
__device__ void wave_solve(const float* __restrict__ L, int n, float* v, const float* src,
                           float* add, unsigned long long* words, unsigned epoch) {
  const int P = (n + kPanel - 1) / kPanel;
  const int nw = gridDim.x * kGnWarps, gw = (blockIdx.x * kGnThreads + threadIdx.x) >> 5;
  // this warp's chunks gw, gw + nw, ...: ascending forward, descending
  // backward (the same warp owns a chunk in both directions)
  const int mine = gw < P ? (P - 1 - gw) / nw + 1 : 0;
  for (int q = 0; q < mine; ++q) {
    const int m = gw + nw * (kForward ? q : mine - 1 - q);
    if (n % kPanel == 0) wave_chunk<kForward, true>(L, n, m, P, v, src, add, words, epoch);
    else wave_chunk<kForward, false>(L, n, m, P, v, src, add, words, epoch);
  }
}

// iterations x (T <- T exp(x), K6's edge phase, the assembly, the panel
// Cholesky with the forward solve, the back substitution, one step of
// refinement), then the last update, separated by grid barriers of a
// cooperative launch (every block resident).
__global__ void __launch_bounds__(kGnThreads) gn_kernel(const __grid_constant__ GnArgs p) {
  extern __shared__ __align__(16) unsigned char gsm[];
  cg::grid_group grid = cg::this_grid();
  Stamps st(p.timers);
  const int N = p.e.N, n = 6 * N;
  const int gtid = blockIdx.x * kGnThreads + threadIdx.x, gthreads = gridDim.x * kGnThreads;
  const int lane = threadIdx.x & 31;
  const unsigned long long t0 = st.last;
  if (p.stop == 3) {
    for (int it = 0; it < p.iterations; ++it) st.sync(grid, kStampFinal);
    if (st.t) st.t[kStampTotal] += Stamps::now() - t0;
    return;
  }
  float (*sa)[kPanel + 1] = reinterpret_cast<float (*)[kPanel + 1]>(gsm);
  float (*sb)[kPanel + 1] = sa + kPanel;
  float (*tiles)[kPanel][kPanel + 1] = reinterpret_cast<float (*)[kPanel][kPanel + 1]>(gsm);
  float (*wbuf)[2][kPanel] = reinterpret_cast<float (*)[2][kPanel]>(tiles + 2 * kGnWarps);
  int* list = reinterpret_cast<int*>(gsm);
  unsigned* reach = reinterpret_cast<unsigned*>(list + p.e.E);

  for (int k = gtid; k < n; k += gthreads) p.words[k] = 0ull;
  const float* Tprev = p.e.T;
  const float* xprev = p.e.x;
  for (int it = 0; it < p.iterations; ++it) {
    const bool last = it == p.iterations - 1;
    EdgeArgs ea = p.e;
    ea.T = Tprev;
    ea.x = xprev;
    ea.T_out = p.P + static_cast<size_t>(it & 1) * 16 * N;
    for (int e0 = 2 * (gtid >> 5); e0 < ea.E; e0 += 2 * (gthreads >> 5))
      edge_lanes(ea, e0 + (lane >> 4), lane & 15);
    if (xprev) {
      for (int nd = gtid; nd < N; nd += gthreads) write_updated(Tprev, xprev, ea.T_out, nd);
      Tprev = ea.T_out;
    }
    xprev = p.x;
    st.sync(grid, kStampEdges);
    for (int nd = blockIdx.x; nd < N; nd += gridDim.x) assemble_rows(p, nd, list, reach);
    st.sync(grid, kStampAssembly);
    if (p.stop == 1 && last) return;
    for (int k0 = 0; k0 < n; k0 += kPanel) {
      panel_phase(p.L, n, k0, wbuf, tiles);
      st.sync(grid, kStampPanel);
      if (k0 + kPanel >= n) break;
      update_phase(p.L, n, k0, sa, sb);
      st.sync(grid, kStampUpdate);
    }
    // x = L^-T y, y = L^-1 (-b) from the border row
    wave_solve<false>(p.L, n, p.x, p.L + static_cast<size_t>(n) * n, nullptr, p.words,
                      3 * it + 1);
    st.sync(grid, kStampSolve);
    // r = -b - A x, a warp a row, in twice f32's precision
    for (int row = gtid >> 5; row < n; row += gthreads >> 5) {
      const float* Ar = p.A + static_cast<size_t>(row) * n;
      Dot2 acc{lane == 0 ? p.A[static_cast<size_t>(n) * n + row] : 0.f, 0.f};
      for (int c = lane; c < n; c += 32) acc.add_product(-Ar[c], p.x[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc.add(Dot2{__shfl_down_sync(0xffffffffu, acc.hi, off),
                     __shfl_down_sync(0xffffffffu, acc.lo, off)});
      if (lane == 0) p.r[row] = acc.hi + acc.lo;
    }
    st.sync(grid, kStampResidual);
    // x += L^-T L^-1 r
    wave_solve<true>(p.L, n, p.r, nullptr, nullptr, p.words, 3 * it + 2);
    wave_solve<false>(p.L, n, p.r, nullptr, p.x, p.words, 3 * it + 3);
    st.sync(grid, kStampRefine);
    if (p.stop == 2 && last) return;
  }
  for (int nd = gtid; nd < N; nd += gthreads) write_updated(Tprev, p.x, p.T_out, nd);
  if (st.t) {
    st.mark(kStampFinal);
    st.t[kStampTotal] += Stamps::now() - t0;
  }
}

// ---------------------------------------------------------------------------
// K8, and the resident CG optimize
// ---------------------------------------------------------------------------

constexpr int kPcgCluster = 8;
constexpr int kPcgThreads = 512;
constexpr int kPcgWarps = kPcgThreads / 32;

// K8's phase stamps (ops/pose_graph.py PCG_STAMPS): block 0's thread 0
// adds the ns it spends in each phase and at the cluster barriers
enum PcgPhase {
  kPcgSetup, kPcgEdgePass, kPcgNodePass, kPcgUpdate, kPcgBarrier, kPcgBarriers, kPcgSteps,
  kPcgTotal, kPcgStamps
};

// The per-node state of a block-Jacobi PCG solve (K8 and the resident CG
// optimize): the edges' blocks, the incidence lists, the free nodes, and
// r, z, H p [N, 6], the inverses [N, 36] and x [N, 6].
struct CgNodes {
  const float* H;          // [E, 12, 12]
  const float* g;          // [E, 12]
  const long long* a;
  const long long* b;
  const int* inc_off;      // [N + 1]
  const int* inc_ent;      // 2 e + side, per node in ascending edge index
  const unsigned char* node_valid;
  long long fixed;         // the fixed node (each kernel reads it from the card first)
  float damp;
  float* r;
  float* z;
  float* Hp;
  float* Dinv;
  float* x;
  __device__ float free_(long long n) const { return node_free(node_valid, fixed, n) ? 1.f : 0.f; }
};

// Node n's set-up: b from its edges, its damped diagonal block inverted by
// Gauss-Jordan (symmetric positive definite: no pivot), r = b, z = M r,
// p = 0, x = 0; acc += its terms of b.b, r.z, r.r.
__device__ __forceinline__ void cg_node_setup(const CgNodes& c, int n, float* pv,
                                              float (&acc)[3]) {
  const float f = c.free_(n);
  float bs[6], A[36], B[36];
#pragma unroll
  for (int i = 0; i < 6; ++i) bs[i] = 0.f;
#pragma unroll
  for (int k = 0; k < 36; ++k) { A[k] = 0.f; B[k] = (k % 7 == 0) ? 1.f : 0.f; }
  for (int q = c.inc_off[n]; q < c.inc_off[n + 1]; ++q) {
    const int ent = c.inc_ent[q], e = ent >> 1, side = 6 * (ent & 1);
    const float* Hb = c.H + static_cast<size_t>(e) * 144;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      bs[i] += c.g[12 * e + side + i];
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) A[6 * i + jj] += Hb[12 * (side + i) + side + jj];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) A[7 * i] += c.damp;
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
  float* Dn = c.Dinv + 36 * n;
#pragma unroll
  for (int k = 0; k < 36; ++k) Dn[k] = B[k];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float bi = -bs[i] * f;
    float zi = 0.f;
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) zi += B[6 * i + jj] * (-bs[jj] * f);
    zi *= f;
    c.r[6 * n + i] = bi;
    c.z[6 * n + i] = zi;
    pv[6 * n + i] = 0.f;
    c.x[6 * n + i] = 0.f;
    acc[0] += bi * bi;
    acc[1] += bi * zi;
    acc[2] += bi * bi;
  }
}

struct PcgArgs {
  CgNodes c;
  const long long* fixed;
  const unsigned char* valid;
  int E;
  int N;
  int cg_iters;
  float* pv;               // [N, 6]
  float* ye;               // [E, 12]
  int* steps;              // the CG steps run, or null
  unsigned long long* timers;   // kPcgStamps words added to, or null
};

// Block 0's thread 0 adds the %globaltimer ns it spends in each phase
// (t: the phase words, or null).
struct PhaseClock {
  unsigned long long* t;
  unsigned long long last;
  __device__ static unsigned long long now() {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    return ns;
  }
  __device__ explicit PhaseClock(unsigned long long* timers)
      : t(blockIdx.x == 0 && threadIdx.x == 0 ? timers : nullptr), last(t ? now() : 0) {}
  __device__ void mark(int phase) {
    if (t) {
      const unsigned long long ns = now();
      t[phase] += ns - last;
      last = ns;
    }
  }
};

// The cluster's sums of K per-thread values: warp shuffles, the block's
// warps in index order, then each block pushes its sums into slot[rank]
// of every block; after the barrier every thread adds the 8 slots in rank
// order, so every block holds the same bits.
template <int K>
__device__ __forceinline__ void cluster_sum(float (&v)[K], float (*slot)[4],
                                            float (*wsum)[4], int rank, PhaseClock& clk,
                                            int phase) {
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
  clk.mark(phase);
  cg::this_cluster().sync();
  clk.mark(kPcgBarrier);
  if (clk.t) clk.t[kPcgBarriers] += 1;
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
  PhaseClock clk(p.timers);
  const unsigned long long t0 = clk.last;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int gtid = rank * kPcgThreads + threadIdx.x;
  const int stride = kPcgCluster * kPcgThreads;
  CgNodes c = p.c;
  c.fixed = *p.fixed;
  auto barrier = [&](int phase) {
    clk.mark(phase);
    cg::this_cluster().sync();
    clk.mark(kPcgBarrier);
    if (clk.t) clk.t[kPcgBarriers] += 1;
  };

  // b, the block-Jacobi inverses, r = b, z = M r, x = 0
  float acc[3] = {0.f, 0.f, 0.f};          // b.b, r.z, r.r
  for (int n = gtid; n < p.N; n += stride) cg_node_setup(c, n, p.pv, acc);
  cluster_sum<3>(acc, slot[0], wsum, rank, clk, kPcgSetup);
  const float bb = fmaxf(acc[0], 1e-20f);
  float rz = acc[1], rr = acc[2], beta = 0.f;

  int it = 0;
  for (; it < p.cg_iters && rr > 1e-10f * bb; ++it) {
    // edge pass: row `row` of edge e's block times (p_a, p_b), p = z + beta p
    for (int q = gtid; q < 12 * p.E; q += stride) {
      const int e = q / 12, row = q - 12 * e;
      if (!p.valid[e]) continue;
      const long long na = c.a[e], nb = c.b[e];
      const float fa = c.free_(na), fb = c.free_(nb);
      const float* Hr = c.H + static_cast<size_t>(e) * 144 + 12 * row;
      float ya = 0.f, yb = 0.f;
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) {
        const float pa = (c.z[6 * na + jj] + beta * p.pv[6 * na + jj]) * fa;
        const float pb = (c.z[6 * nb + jj] + beta * p.pv[6 * nb + jj]) * fb;
        ya += Hr[jj] * pa;
        yb += Hr[6 + jj] * pb;
      }
      p.ye[q] = ya + yb;
    }
    barrier(kPcgEdgePass);
    // node pass: p, H p = (sum of the edges' rows + damp p) on free nodes
    float pHp[1] = {0.f};
    for (int n = gtid; n < p.N; n += stride) {
      const float f = c.free_(n);
      float y[6], pn[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        pn[i] = c.z[6 * n + i] + beta * p.pv[6 * n + i];
        y[i] = 0.f;
      }
      for (int q = c.inc_off[n]; q < c.inc_off[n + 1]; ++q) {
        const int ent = c.inc_ent[q], e = ent >> 1, side = 6 * (ent & 1);
#pragma unroll
        for (int i = 0; i < 6; ++i) y[i] += p.ye[12 * e + side + i];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float hp = (y[i] + c.damp * (pn[i] * f)) * f;
        p.pv[6 * n + i] = pn[i];
        c.Hp[6 * n + i] = hp;
        pHp[0] += pn[i] * hp;
      }
    }
    cluster_sum<1>(pHp, slot[1], wsum, rank, clk, kPcgNodePass);
    const float alpha = rz / fmaxf(pHp[0], 1e-20f);
    // x += alpha p, r -= alpha H p, z = M r
    float sums[2] = {0.f, 0.f};              // r.z, r.r
    for (int n = gtid; n < p.N; n += stride) {
      const float f = c.free_(n);
      float rn[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        c.x[6 * n + i] += alpha * p.pv[6 * n + i];
        rn[i] = c.r[6 * n + i] - alpha * c.Hp[6 * n + i];
        c.r[6 * n + i] = rn[i];
      }
      const float* Dn = c.Dinv + 36 * n;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float zi = 0.f;
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) zi += Dn[6 * i + jj] * rn[jj];
        zi *= f;
        c.z[6 * n + i] = zi;
        sums[0] += rn[i] * zi;
        sums[1] += rn[i] * rn[i];
      }
    }
    cluster_sum<2>(sums, slot[0], wsum, rank, clk, kPcgUpdate);
    beta = sums[0] / fmaxf(rz, 1e-20f);
    rz = sums[0];
    rr = sums[1];
  }
  if (p.steps && gtid == 0) *p.steps = it;
  cg::this_cluster().sync();    // no block leaves while another reads its slots
  if (clk.t) {
    clk.t[kPcgSteps] += it;
    clk.t[kPcgTotal] += PhaseClock::now() - t0;
  }
}

// The resident CG optimize (K8's redesign): optimize(solver="cg") whole in
// one launch, `iterations` x (T <- T exp(x) and K6's edge phase, the
// block-Jacobi set-up, the CG while_loop), then the last update. Its CG
// step is two barriers: a node pass that forms p and gathers H p from the
// node's edges' rows itself (K8's edge pass and node pass in one), and the
// update. Each dot product is summed in an order fixed by node index: a
// warp's shuffle tree over 32 consecutive nodes (a chunk), 16 chunks to a
// group in order, the groups in order (at least kPcgCluster of them): K8's
// order wherever N <= 4096 (a chunk is one of its warps, a group one of
// its blocks). Every warp sums the chunks' partials itself, so all take
// the same branch, on any grid: a cooperative grid of kPcgThreads-thread
// blocks, one an SM, and grid barriers.
enum CgPhase {
  kCgEdges, kCgIncidence, kCgSetup, kCgNodePass, kCgUpdate, kCgFinal, kCgBarrier, kCgBarriers,
  kCgSteps, kCgTotal, kCgStamps
};

struct CgOptArgs {
  EdgeArgs e;              // T: the start poses; H, g: the edges' blocks (workspace)
  CgNodes c;               // damp, r, z, Hp, Dinv, x (x: each iteration's update)
  const long long* fixed;
  int iterations;
  int cg_iters;
  int groups;              // chunk groups: max(kPcgCluster, ceil(N / 512))
  int* inc;                // [2E] int4 records (2 e + side, a, b, free bits), [N] counts,
                           // [N + 1] offsets, [2E] entries: the incidence lists
  float* P;                // [2, N, 16] iteration k's poses in P[k & 1]
  float* pv;               // [2, N, 6] p, double-buffered by CG step
  float* part;             // [4, 16 * groups] the chunks' partials: p.Hp (and
                           // the set-up's r.z), r.z, r.r, the set-up's b.b
  float* T_out;            // [N, 16]
  int* steps;              // [iterations] CG steps run, or null
  unsigned long long* timers;   // kCgStamps words added to, or null
};

// The total of one dot product from its chunks' partials, by one warp:
// lane g sums group g's 16 in order, then the groups in order. The chunks
// from `real` on hold no node: their partials are +0 (a shuffle tree of
// zeros), added without being stored.
__device__ __forceinline__ float chunk_total(const float* part, int groups, int real,
                                             int lane) {
  float total = 0.f;
  for (int g0 = 0; g0 < groups; g0 += 32) {
    float G = 0.f;
    if (g0 + lane < groups) {
      const int c0 = 16 * (g0 + lane);
      float v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = c0 + k < real ? part[c0 + k] : 0.f;
      G = v[0];
#pragma unroll
      for (int k = 1; k < 16; ++k) G += v[k];
    }
    for (int k = 0; k < 32 && g0 + k < groups; ++k) {
      const float gk = __shfl_sync(0xffffffffu, G, k);
      total = g0 + k == 0 ? gk : total + gk;
    }
  }
  return total;
}

// a warp's shuffle tree of its lanes' values, lane 0's result into dst
__device__ __forceinline__ void chunk_partial(float v, float* dst, int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) *dst = v;
}

// A CG step's node phases, eight lanes a node (lane i < 6: row i; a warp
// four nodes, a block of kPcgThreads 64 nodes a round): each row's sums in
// K8's order, the node's terms of a dot product gathered by its first lane
// and added in row order as K8's thread adds them, then the block's two
// chunks of 32 nodes through shared memory to the shuffle tree of a warp
// each. sval: the block's [2][32] node values.
constexpr int kCgRowLanes = 8;
constexpr int kCgNodesPerBlock = kPcgThreads / kCgRowLanes;

// the node pass: p = z + beta p_old into pnew, H p, and p.Hp's chunk
// partials into part. rec: each incidence entry's (2 e + side, a, b, the
// ends' free bits). Per entry lane i loads entry i of each end's z and
// p_old and its row of the block (three float4), forms p_a[i] and p_b[i]
// and passes them to the node's other lanes by shuffles (the node's eight
// lanes run its entries together; lanes 6 and 7 shadow row 5).
__device__ __forceinline__ void cg_rows_apply(const CgNodes& c, const int4* rec, int N,
                                              float beta, const float* pold, float* pnew,
                                              float* part, int real, float* sval) {
  const int tid = threadIdx.x, lane = tid & 31, i = lane & (kCgRowLanes - 1);
  const int lead = lane & ~(kCgRowLanes - 1);
  const unsigned gmask = 0xffu << lead;
  const int ir = i < 6 ? i : 5;
  for (int r = blockIdx.x; r * 2 < real; r += gridDim.x) {
    const int n = r * kCgNodesPerBlock + tid / kCgRowLanes;
    float pn = 0.f, hp = 0.f;
    if (n < N) {
      const float f = c.free_(n);
      pn = c.z[6 * n + ir] + beta * pold[6 * n + ir];
      float y = 0.f;
      const int lo = c.inc_off[n], hi = c.inc_off[n + 1];
      for (int q = lo; q < hi; ++q) {
        const int4 rv = rec[q];
        const long long na = rv.y, nb = rv.z;
        const float fa = (rv.w & 1) ? 1.f : 0.f, fb = (rv.w & 2) ? 1.f : 0.f;
        const float pa = (c.z[6 * na + ir] + beta * pold[6 * na + ir]) * fa;
        const float pb = (c.z[6 * nb + ir] + beta * pold[6 * nb + ir]) * fb;
        const float4* Hr = reinterpret_cast<const float4*>(
            c.H + static_cast<size_t>(rv.x >> 1) * 144 + 12 * (6 * (rv.x & 1) + ir));
        const float4 h0 = Hr[0], h1 = Hr[1], h2 = Hr[2];
        const float hv[12] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w,
                              h2.x, h2.y, h2.z, h2.w};
        // K8's edge pass's sums, in its order
        float ya = 0.f, yb = 0.f;
#pragma unroll
        for (int jj = 0; jj < 6; ++jj) {
          ya += hv[jj] * __shfl_sync(gmask, pa, lead + jj);
          yb += hv[6 + jj] * __shfl_sync(gmask, pb, lead + jj);
        }
        y += ya + yb;
      }
      hp = (y + c.damp * (pn * f)) * f;
      if (i < 6) {
        pnew[6 * n + i] = pn;
        c.Hp[6 * n + i] = hp;
      }
    }
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      v += __shfl_sync(0xffffffffu, pn, lead + k) * __shfl_sync(0xffffffffu, hp, lead + k);
    __syncthreads();                     // the previous round's values are read
    if (i == 0) sval[tid / kCgRowLanes] = n < N ? v : 0.f;
    __syncthreads();
    const int w = tid >> 5;
    if (w < 2 && 2 * r + w < real) chunk_partial(sval[32 * w + lane], part + 2 * r + w, lane);
  }
}

// the update: x += alpha p, r -= alpha H p, z = M r, and r.z's and r.r's
// chunk partials into part1, part2
__device__ __forceinline__ void cg_rows_update(const CgNodes& c, int N, float alpha,
                                               const float* pv, float* part1, float* part2,
                                               int real, float (*sval)[kCgNodesPerBlock]) {
  const int tid = threadIdx.x, lane = tid & 31, i = lane & (kCgRowLanes - 1);
  const int lead = lane & ~(kCgRowLanes - 1);
  for (int r = blockIdx.x; r * 2 < real; r += gridDim.x) {
    const int n = r * kCgNodesPerBlock + tid / kCgRowLanes;
    const bool live = n < N && i < 6;
    float rn = 0.f;
    if (live) {
      c.x[6 * n + i] += alpha * pv[6 * n + i];
      rn = c.r[6 * n + i] - alpha * c.Hp[6 * n + i];
      c.r[6 * n + i] = rn;
    }
    float rj[6];
#pragma unroll
    for (int jj = 0; jj < 6; ++jj) rj[jj] = __shfl_sync(0xffffffffu, rn, lead + jj);
    float zi = 0.f;
    if (live) {
      const float* Dn = c.Dinv + 36 * n;
#pragma unroll
      for (int jj = 0; jj < 6; ++jj) zi += Dn[6 * i + jj] * rj[jj];
      zi *= c.free_(n);
      c.z[6 * n + i] = zi;
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float zk = __shfl_sync(0xffffffffu, zi, lead + k);
      s0 += rj[k] * zk;
      s1 += rj[k] * rj[k];
    }
    __syncthreads();
    if (i == 0) {
      sval[0][tid / kCgRowLanes] = n < N ? s0 : 0.f;
      sval[1][tid / kCgRowLanes] = n < N ? s1 : 0.f;
    }
    __syncthreads();
    const int w = tid >> 5;
    if (w < 2 && 2 * r + w < real) {
      chunk_partial(sval[0][32 * w + lane], part1 + 2 * r + w, lane);
      chunk_partial(sval[1][32 * w + lane], part2 + 2 * r + w, lane);
    }
  }
}

__global__ void __launch_bounds__(kPcgThreads) cg_opt_kernel(const __grid_constant__ CgOptArgs p) {
  PhaseClock clk(p.timers);
  const unsigned long long t0 = clk.last;
  const int N = p.e.N;
  const int gtid = blockIdx.x * kPcgThreads + threadIdx.x, gthreads = gridDim.x * kPcgThreads;
  const int lane = threadIdx.x & 31, gwarp = gtid >> 5, nwarps = gthreads >> 5;
  const int chunks = 16 * p.groups;
  const int real = (N + 31) / 32;          // the chunks that hold nodes
  __shared__ float sval[2][kCgNodesPerBlock];
  float* part0 = p.part;
  float* part1 = p.part + chunks;
  float* part2 = p.part + 2 * chunks;
  float* part3 = p.part + 3 * chunks;
  auto barrier = [&](int phase) {
    clk.mark(phase);
    cg::this_grid().sync();
    clk.mark(kCgBarrier);
    if (clk.t) clk.t[kCgBarriers] += 1;
  };
  CgNodes c = p.c;
  c.fixed = *p.fixed;
  const int E = p.e.E;
  int4* rec = reinterpret_cast<int4*>(p.inc);
  int* cnt = p.inc + 8 * E;
  int* off = cnt + N;
  int* ent = off + N + 1;
  c.inc_off = off;
  c.inc_ent = ent;
  const unsigned lt = (1u << lane) - 1u;
  // node n's valid edge ends among the 32 edges from base: (a side, b side)
  auto ends = [&](int n, int base, unsigned& ba, unsigned& bb) {
    const int e = base + lane;
    const bool v = e < E && p.e.valid[e];
    ba = __ballot_sync(0xffffffffu, v && p.e.a[e] == n);
    bb = __ballot_sync(0xffffffffu, v && p.e.b[e] == n);
  };
  const float* Tprev = p.e.T;
  const float* xprev = nullptr;
  for (int it = 0; it < p.iterations; ++it) {
    // the previous update and K6's edge phase at the updated poses
    EdgeArgs ea = p.e;
    ea.T = Tprev;
    ea.x = xprev;
    ea.T_out = p.P + static_cast<size_t>(it & 1) * 16 * N;
    for (int e0 = 2 * gwarp; e0 < ea.E; e0 += 2 * nwarps)
      edge_lanes(ea, e0 + (lane >> 4), lane & 15);
    if (xprev) {
      for (int nd = gtid; nd < N; nd += gthreads) write_updated(Tprev, xprev, ea.T_out, nd);
      Tprev = ea.T_out;
    }
    xprev = c.x;
    if (it == 0) {
      // the incidence lists (ops/pose_graph.py::incidence's), made once:
      // each node's valid edge ends counted, a warp a node
      for (int n = gwarp; n < N; n += nwarps) {
        int k = 0;
        for (int base = 0; base < E; base += 32) {
          unsigned ba, bb;
          ends(n, base, ba, bb);
          k += __popc(ba) + __popc(bb);
        }
        if (lane == 0) cnt[n] = k;
      }
    }
    barrier(kCgEdges);
    if (it == 0) {
      // each node's offset (the counts before it, exact integers) and its
      // entries 2 e + side in ascending order
      for (int n = gwarp; n < N; n += nwarps) {
        int s = 0;
        for (int m = lane; m < n; m += 32) s += cnt[m];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) {
          off[n] = s;
          if (n == N - 1) off[N] = s + cnt[n];
        }
        for (int base = 0; base < E; base += 32) {
          unsigned ba, bb;
          ends(n, base, ba, bb);
          const int pos = s + __popc(ba & lt) + __popc(bb & lt);
          const int e = base + lane;
          const int ha = (ba >> lane) & 1u;
          if (ha || ((bb >> lane) & 1u)) {
            const long long na = p.e.a[e], nb = p.e.b[e];
            const int fr = (c.free_(na) != 0.f ? 1 : 0) | (c.free_(nb) != 0.f ? 2 : 0);
            if (ha) {
              ent[pos] = 2 * e;
              rec[pos] = make_int4(2 * e, static_cast<int>(na), static_cast<int>(nb), fr);
            }
            if ((bb >> lane) & 1u) {
              ent[pos + ha] = 2 * e + 1;
              rec[pos + ha] = make_int4(2 * e + 1, static_cast<int>(na), static_cast<int>(nb), fr);
            }
          }
          s += __popc(ba) + __popc(bb);
        }
      }
      barrier(kCgIncidence);
    }
    // the block-Jacobi set-up, a chunk a warp (b.b into part3: the first
    // node pass writes part0 with no barrier after these reads)
    for (int ch = gwarp; ch < real; ch += nwarps) {
      const int n = 32 * ch + lane;
      float acc[3] = {0.f, 0.f, 0.f};
      if (n < N) cg_node_setup(c, n, p.pv, acc);
      chunk_partial(acc[0], part3 + ch, lane);
      chunk_partial(acc[1], part1 + ch, lane);
      chunk_partial(acc[2], part2 + ch, lane);
    }
    barrier(kCgSetup);
    const float bb = fmaxf(chunk_total(part3, p.groups, real, lane), 1e-20f);
    float rz = chunk_total(part1, p.groups, real, lane);
    float rr = chunk_total(part2, p.groups, real, lane);
    float beta = 0.f;
    int k = 0;
    for (; k < p.cg_iters && rr > 1e-10f * bb; ++k) {
      const float* pold = p.pv + static_cast<size_t>(k & 1) * 6 * N;
      float* pnew = p.pv + static_cast<size_t>((k + 1) & 1) * 6 * N;
      cg_rows_apply(c, rec, N, beta, pold, pnew, part0, real, sval[0]);
      barrier(kCgNodePass);
      const float alpha = rz / fmaxf(chunk_total(part0, p.groups, real, lane), 1e-20f);
      cg_rows_update(c, N, alpha, pnew, part1, part2, real, sval);
      barrier(kCgUpdate);
      const float rz_new = chunk_total(part1, p.groups, real, lane);
      rr = chunk_total(part2, p.groups, real, lane);
      beta = rz_new / fmaxf(rz, 1e-20f);
      rz = rz_new;
    }
    if (gtid == 0 && p.steps) p.steps[it] = k;
    if (clk.t) clk.t[kCgSteps] += k;
  }
  for (int nd = gtid; nd < N; nd += gthreads) write_updated(Tprev, c.x, p.T_out, nd);
  if (clk.t) {
    clk.mark(kCgFinal);
    clk.t[kCgTotal] += PhaseClock::now() - t0;
  }
}

// Dynamic shared memory of K7's block: the assembly's edge list and
// reach bits, or two tiles and a column buffer a warp (the panel phase;
// the update phase takes two tiles of it).
size_t gn_smem(int N, int E) {
  const size_t assembly = sizeof(int) * (static_cast<size_t>(E) + (N + 31) / 32);
  const size_t tiles = sizeof(float) * kGnWarps * (2 * kPanel * (kPanel + 1) + 2 * kPanel);
  return assembly > tiles ? assembly : tiles;
}

// The cooperative grid: kGnBlocksPerSm blocks an SM (fewer if fewer fit),
// every block resident.
cudaError_t gn_grid(size_t smem, int* grid) {
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_kernel, kGnThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *grid = sms * (per_sm < kGnBlocksPerSm ? per_sm : kGnBlocksPerSm);
  return cudaSuccess;
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

// K7: `iterations` Gauss-Newton steps of a dense optimize in one
// cooperative launch (every block resident), from the poses T exp(x) (x
// null: T); T_out the optimized poses. The workspace: P [2, N, 16], x and
// r [6N], words [6N] 64-bit, H [E, 12, 12], g [E, 12], A and L
// [6N + 1, 6N]. stop 1 / 2: the
// last iteration stops after its assembly / its solve (T_out untouched);
// 3: only `iterations` grid barriers. timers: kGnStamps words added to, or
// null.
DSSLAM_API int dsslam_pose_graph_gn(const float* T, const float* x, int N, const float* Z,
                                    const long long* a, const long long* b, const float* w_t,
                                    const float* w_r, const unsigned char* valid, int E,
                                    float delta, float delta_sq,
                                    const unsigned char* node_valid, const long long* fixed,
                                    float lam, int iterations, int stop, float* P, float* xw,
                                    float* r, unsigned long long* words, float* H,
                                    float* g, float* A, float* L, float* T_out,
                                    unsigned long long* timers,
                                    cudaStream_t stream) {
  if (N < 1 || E < 0 || iterations < 0 || stop < 0 || stop > 3) return cudaErrorInvalidValue;
  if (iterations == 0) return cudaSuccess;
  const size_t smem = gn_smem(N, E);
  int grid = 0;
  cudaError_t err = gn_grid(smem, &grid);
  if (err != cudaSuccess) return err;
  GnArgs p{EdgeArgs{T, x, nullptr, N, Z, a, b, w_t, w_r, valid, E, delta, delta_sq, H, g, 0},
           node_valid, fixed, lam, iterations, stop, P, xw, A, L, r, words, T_out, timers};
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gn_kernel), dim3(grid),
                                    dim3(kGnThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K7's grid: the blocks of one launch at these sizes, the blocks an SM
// holds, the registers and the dynamic shared memory of a block.
DSSLAM_API int dsslam_pose_graph_gn_grid(int N, int E, int* out) {
  if (N < 1 || E < 0) return cudaErrorInvalidValue;
  const size_t smem = gn_smem(N, E);
  int grid = 0;
  cudaError_t err = gn_grid(smem, &grid);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, gn_kernel);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gn_kernel, kGnThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = grid;
  out[1] = per_sm;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(smem);
  return cudaSuccess;
}

// K8: block-Jacobi PCG on the free nodes, one cluster, x [N, 6] out (and
// the number of CG steps it ran, if steps is set); work holds 4 x [N, 6] +
// [N, 36] + [E, 12] floats. timers: kPcgStamps words added to, or null.
DSSLAM_API int dsslam_pose_graph_pcg(const float* H, const float* g, const long long* a,
                                     const long long* b, const unsigned char* valid, int E,
                                     const int* inc_off, const int* inc_ent,
                                     const unsigned char* node_valid, const long long* fixed,
                                     int N, float damp, int cg_iters, float* work, float* x,
                                     int* steps, unsigned long long* timers,
                                     cudaStream_t stream) {
  if (N < 1 || E < 0 || cg_iters < 0) return cudaErrorInvalidValue;
  const size_t n6 = 6 * static_cast<size_t>(N);
  PcgArgs p{CgNodes{H, g, a, b, inc_off, inc_ent, node_valid, 0, damp, work, work + n6,
                    work + 3 * n6, work + 4 * n6, x},
            fixed, valid, E, N, cg_iters, work + 2 * n6,
            work + 4 * n6 + 36 * static_cast<size_t>(N), steps, timers};
  pcg_kernel<<<kPcgCluster, kPcgThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The resident CG optimize: `iterations` Gauss-Newton steps of
// optimize(solver="cg") from the poses T in one cooperative launch; T_out
// the optimized poses, x
// [N, 6] the last iteration's update. The workspace: H [E, 12, 12], g
// [E, 12], work of dsslam_pose_graph_cg_work(N) floats and inc of
// 2N + 1 + 10E ints (16-byte aligned). steps: [iterations] CG steps run, or null; timers:
// kCgStamps words added to, or null.
DSSLAM_API int dsslam_pose_graph_cg_work(int N) {
  const int groups = (N + 511) / 512 > kPcgCluster ? (N + 511) / 512 : kPcgCluster;
  return 6 * N * 3 + 36 * N + 32 * N + 12 * N + 4 * 16 * groups;
}

DSSLAM_API int dsslam_pose_graph_cg(const float* T, int N, const float* Z, const long long* a,
                                    const long long* b, const float* w_t, const float* w_r,
                                    const unsigned char* valid, int E, float delta,
                                    float delta_sq, const unsigned char* node_valid,
                                    const long long* fixed, float damp, int iterations,
                                    int cg_iters, float* work, int* inc, float* H,
                                    float* g, float* x, float* T_out, int* steps,
                                    unsigned long long* timers, cudaStream_t stream) {
  if (N < 1 || E < 0 || iterations < 1 || cg_iters < 0) return cudaErrorInvalidValue;
  const size_t n6 = 6 * static_cast<size_t>(N);
  const int groups = (N + 511) / 512 > kPcgCluster ? (N + 511) / 512 : kPcgCluster;
  CgOptArgs p{EdgeArgs{T, nullptr, nullptr, N, Z, a, b, w_t, w_r, valid, E, delta, delta_sq,
                       H, g, 0},
              CgNodes{H, g, a, b, nullptr, nullptr, node_valid, 0, damp, work, work + n6,
                      work + 2 * n6, work + 3 * n6, x},
              fixed, iterations, cg_iters, groups, inc,
              work + 3 * n6 + 36 * static_cast<size_t>(N),
              work + 3 * n6 + 68 * static_cast<size_t>(N),
              work + 3 * n6 + 80 * static_cast<size_t>(N), T_out, steps, timers};
  cudaError_t err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cg_opt_kernel, kPcgThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(cg_opt_kernel), dim3(sms),
                                    dim3(kPcgThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
