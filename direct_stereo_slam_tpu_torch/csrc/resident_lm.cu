// K2-LM, K3-LM and K4-LM: the whole coarse-to-fine Levenberg-Marquardt of
// the tracker, of the stereo scale optimizer and of the loop-closure pose
// estimator, resident on the card, one launch per candidate batch (K2-LM),
// guess grid (K3-LM) or seed stack (K4-LM).
//
// They replace the jitted JAX programs
// direct_stereo_slam_tpu/models/tracker.py::track_candidates_batch
// (cutoff loop :143, LM while_loop :206, level repeat :269, vmap over the
// candidates :316-333),
// direct_stereo_slam_tpu/models/scale_opt.py::optimize_scale_batch (cutoff
// loop :51-66, LM while_loop :70-113, level repeat :149-160, vmap over the
// guesses :169-182) and
// direct_stereo_slam_tpu/loop/pose_estimator.py::_estimate_seeds (:74,
// :115, :167, vmap over the seeds :217-252); per LM iteration those run
// the XLA pass programs ops/residual_hb.py::pose_residual_pass (:126),
// ::scale_residual_pass (:313) and ::pose3d_residual_pass (:235). The
// port's plain versions are the Python loops
// models/tracker.py::track_candidates_batch_plain,
// models/scale_opt.py::optimize_scale_batch_plain and
// loop/pose_estimator.py::estimate_seeds_plain.
//
// What bounds them on the H100. One LM pass reads a level's points (17 B
// each) and 4 bilinear taps of (I, dx, dy) per point, then reduces 51
// (K2), 6 (K3) or 48 (K4) sums; per candidate a call runs ~20-200 such
// passes in sequence, each followed by a step (an 8x8 solve and an SE(3)
// exponential, or K3's scalar division) that decides the next pass. Bytes
// over 3.35 TB/s bound a call at microseconds (one candidate) to a
// fraction of a millisecond (78 candidates); the f32 operations (~80-200
// per point and pass) take ~5x less, so there is no use for tensor cores
// (and the reference pins f32: no TF32 anywhere). The real cost is the
// latency of each pass and LM step in sequence. What the per-pass form
// lost was the host: a parameter tensor, a ctypes crossing and a blocking
// read per LM iteration. Here the data-dependent control flow (cutoff
// doubling, LM accept/reject, the increment-norm break, the one-shot level
// repeat) runs on the card, so a batch costs one launch and no host read.
//
// Design:
// - One thread-block cluster of 8 blocks (portable size) per candidate,
//   guess or seed, on blockIdx.y. Candidates never talk to each other, so
//   no grid-wide sync; a finished candidate stops, which is what vmap of a
//   while_loop computes. 8 blocks spread even a batch of one over 8 SMs.
// - At each level a block copies its eighth of the level's points into
//   shared memory with cp.async (cooperative_groups::memcpy_async) once;
//   every pass of the level reads them from there. At most 8192 points x
//   17 B / 8 = 17 KB per block. Image taps come through L2 (level 0 at
//   KITTI size is 5.4 MB, inside the 50 MB L2).
// - Per pass each thread runs the per-point arithmetic of the per-pass
//   kernels (pose_terms.cuh), the block reduces in a fixed order (warp
//   shuffles, then warps in order: block_sum) into a double-buffered
//   slot, and after one cluster barrier every block sums the 8 blocks'
//   slots through distributed shared memory in rank order (ClusterSums,
//   shared by the three LMs). Every block thus holds bit-identical totals
//   and runs the same LM step on them, so the whole cluster follows one
//   path with no broadcast and one cluster barrier per pass. K2-LM and
//   K4-LM take the step on thread 0 (the damped solve by the affine mode
//   as an f32 LU with partial pivoting, extrapolation, preconditioning and
//   the isfinite guard, se3_exp as geometry/lie.py computes it,
//   accept/reject and the lambda schedule) and share it through shared
//   memory; K3-LM's state is a handful of scalars that every thread holds
//   in registers and updates alike. No atomics: two runs give the same
//   bits.
// - Host side: one parameter struct passed by value (per-level image and
//   point pointers, intrinsics, the level's 3x3 matrix, the LM's scalars;
//   K2-LM's scalars that live on the card are read there through a
//   pointer). Output per candidate: K2-LM / K4-LM T, a, b, the per-level
//   residual, the flow indicators (K2) or level 0's E and n (K4), and the
//   passes run per level; K3-LM the scale, the error, level 0's E and n,
//   the cutoff-doubling factor and the passes run per level. The
//   acceptance gates, the winner and the trap decision stay on the host.

#include <cooperative_groups.h>
#include <cooperative_groups/memcpy_async.h>

#include "pose_terms.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kLmThreads = 256;
constexpr int kMaxLevels = 8;

// output row per candidate (ops/resident_lm.py reads the same slots)
constexpr int kLmOut = 40;
constexpr int kOutA = 16, kOutB = 17, kOutRes = 18, kOutX0 = 26, kOutX1 = 27,
              kOutPasses = 28;
// K3-LM: output row per guess
constexpr int kScaleOut = 20;
constexpr int kSOutScale = 0, kSOutErr = 1, kSOutE = 2, kSOutN = 3,
              kSOutRepeat = 4, kSOutPasses = 12;

}  // namespace

// The layouts below are mirrored by ctypes structures in
// ops/resident_lm.py; dsslam_lm_params_size and dsslam_scale_lm_params_size
// let that module check them.
struct LmLevel {
  const float* img;            // [H, W, 3] (I, dx, dy)
  const float* p0;             // pu | px
  const float* p1;             // pv | py
  const float* p2;             // pid | pz
  const float* pcolor;         // colour of point i at pcolor[i * color_stride]
  const unsigned char* pmask;
  int H, W;
  float umax, vmax;
  int N;
  int color_stride;
  float fx, fy, cx, cy;         // K3-LM: camera 1's
  float Ki[9];                 // K^-1 of the level; K3-LM: R01 K0^-1
  int max_iters;
  int compute_flow;
};

// A scalar that lives on the card (ptr) or is given by value (ptr null).
struct LmScalar {
  const float* ptr;
  float value;
};

struct LmParams {
  LmLevel lv[kMaxLevels];
  const float* T_init;         // [B, 4, 4]
  float* out;                  // [B, kLmOut]
  LmScalar aff_a0, aff_b0, ref_a, ref_b, ref_exp, new_exp;
  float pre[8];                // POSE_PRECOND
  float huber, coarse_cutoff, sat_ratio_repeat, cutoff_repeat_max;
  float lambda_init, lambda_lim, lambda_accept, lambda_reject, inc_break;
  float mode_a, mode_b;
  int levels;
  int B;
  int chunk;                   // points per block slice (multiple of 4)
};

struct ScaleLmParams {
  LmLevel lv[kMaxLevels];
  const float* s_init;         // [G] initial scales
  float* out;                  // [G, kScaleOut]
  float t01[3];
  float huber, coarse_cutoff, sat_ratio_repeat, cutoff_repeat_max;
  float lambda_init, lambda_lim, lambda_accept, lambda_reject, inc_break;
  int levels;
  int G;
  int chunk;                   // points per block slice (multiple of 4)
};

static_assert(sizeof(LmLevel) == 136, "LmLevel layout");
static_assert(sizeof(LmParams) == 1288, "LmParams layout");
static_assert(sizeof(ScaleLmParams) == 1168, "ScaleLmParams layout");

namespace {

// Per-cluster LM state, one copy in every block's shared memory; thread 0
// writes it, all threads read it after a barrier.
struct LmState {
  float T[16], a, b;                       // accepted carry
  float H[64], g[8];
  float E, n, n_in, ft, frt, sat;
  float lam;
  int done;
  float T0[16], a0, b0;                    // the level's start
  float repeat;
  float Tn[16], an, bn;                    // the trial step
  float inc_norm;
  dsslam::PoseWarp warp;                   // the next pass's warp
  float oH[64], og[8];                     // the last pass's result
  float oE, on, osat, onin, oft, ofrt;
  float res[kMaxLevels];
  float x0, x1;
  int passes[kMaxLevels];
  float ref_a, ref_b, ref_exp, new_exp;
  float M[64], rhs[8];                     // solve scratch
};

__device__ __forceinline__ float read_scalar(const LmScalar& s) {
  return s.ptr ? *s.ptr : s.value;
}

// Points per block slice at a level: an eighth, rounded up to 4 so every
// slice starts 16-byte aligned.
__host__ __device__ __forceinline__ int slice_len(int N) {
  const int per = (N + kCluster - 1) / kCluster;
  return (per + 3) / 4 * 4;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int chunk) {
  return (static_cast<size_t>(chunk) * 17 + 15) / 16 * 16;
}

// A block's slice of a level's points in shared memory, and the cluster's
// fixed-order sum of NACC per-thread accumulators: what K2-LM, K3-LM and
// K4-LM share. Every thread calls reduce() alike, so the double-buffer
// index lives in a register.
template <int NACC>
struct ClusterSums {
  float (*red)[NACC];          // [2][NACC] this block's sums, double-buffered
  float* tot;                  // [NACC] the cluster's totals
  float *s0, *s1, *s2, *sc;    // the slice: p0, p1, p2, colour
  unsigned char* sm;           // the slice: mask
  int rank, tid;
  int start = 0, count = 0, buf = 0;

  __device__ ClusterSums(unsigned char* smem, int chunk, float (*red_)[NACC],
                         float* tot_)
      : red(red_), tot(tot_), s0(reinterpret_cast<float*>(smem)),
        s1(s0 + chunk), s2(s1 + chunk), sc(s2 + chunk),
        sm(reinterpret_cast<unsigned char*>(sc + chunk)),
        rank(static_cast<int>(cg::this_cluster().block_rank())),
        tid(threadIdx.x) {}

  // This block's slice of level L's points into shared memory.
  __device__ void load_level(const LmLevel& L) {
    __syncthreads();        // nobody still reads the previous level's slice
    const int per = slice_len(L.N);
    start = min(rank * per, L.N);
    count = min(per, L.N - start);
    cg::thread_block block = cg::this_thread_block();
    if (count > 0) {
      cg::memcpy_async(block, s0, L.p0 + start, sizeof(float) * count);
      cg::memcpy_async(block, s1, L.p1 + start, sizeof(float) * count);
      cg::memcpy_async(block, s2, L.p2 + start, sizeof(float) * count);
      cg::memcpy_async(block, sm, L.pmask + start,
                       sizeof(unsigned char) * count);
      if (L.color_stride == 1) {
        cg::memcpy_async(block, sc, L.pcolor + start, sizeof(float) * count);
      } else {
        for (int j = tid; j < count; j += kLmThreads)
          sc[j] = L.pcolor[static_cast<size_t>(start + j) * L.color_stride];
      }
    }
    cg::wait(block);
  }

  // All threads: the cluster's sums of acc into tot, the same bits in
  // every block (block_sum, one cluster barrier, the 8 blocks' slots in
  // rank order), readable by every thread on return.
  __device__ void reduce(const float (&acc)[NACC]) {
    dsslam::block_sum<NACC, kLmThreads>(acc, red[buf]);
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (tid < NACC) {
      float s = 0.f;
      for (int r = 0; r < kCluster; ++r)
        s += cluster.map_shared_rank(&red[buf][0], r)[tid];
      tot[tid] = s;
    }
    __syncthreads();
    buf ^= 1;
  }
};

// Damped solve of the 8-parameter system by the affine mode
// (models/tracker.py::_solve_inc): Hl = H + lam diag(H), the 6-, 7- or
// 8-unknown sub-block ("stitch b into slot 6" when only b is free), f32
// LU with partial pivoting (first largest pivot, as LAPACK's isamax) and
// substitution. A singular system gives non-finite values, which the
// caller's isfinite guard rejects, as the reference's solve does.
__device__ void solve_inc(LmState& s, float mode_a, float mode_b,
                          float* inc) {
  int idx[8];
  int m = 0;
  for (int k = 0; k < 6; ++k) idx[m++] = k;
  if (mode_a >= 0.f) idx[m++] = 6;
  if (mode_b >= 0.f) idx[m++] = 7;
  for (int r = 0; r < m; ++r) {
    for (int c = 0; c < m; ++c) {
      const float h = s.H[idx[r] * 8 + idx[c]];
      s.M[r * 8 + c] = r == c ? h + s.lam * h : h;
    }
    s.rhs[r] = -s.g[idx[r]];
  }
  for (int k = 0; k < m; ++k) {
    int piv = k;
    float best = fabsf(s.M[k * 8 + k]);
    for (int i = k + 1; i < m; ++i) {
      const float v = fabsf(s.M[i * 8 + k]);
      if (v > best) {
        best = v;
        piv = i;
      }
    }
    if (piv != k) {
      for (int c = 0; c < m; ++c) {
        const float t = s.M[k * 8 + c];
        s.M[k * 8 + c] = s.M[piv * 8 + c];
        s.M[piv * 8 + c] = t;
      }
      const float t = s.rhs[k];
      s.rhs[k] = s.rhs[piv];
      s.rhs[piv] = t;
    }
    const float d = s.M[k * 8 + k];
    for (int i = k + 1; i < m; ++i) {
      const float l = s.M[i * 8 + k] / d;
      for (int c = k + 1; c < m; ++c) s.M[i * 8 + c] -= l * s.M[k * 8 + c];
      s.rhs[i] -= l * s.rhs[k];
    }
  }
  float x[8];
  for (int i = m - 1; i >= 0; --i) {
    float acc = s.rhs[i];
    for (int c = i + 1; c < m; ++c) acc -= s.M[i * 8 + c] * x[c];
    x[i] = acc / s.M[i * 8 + i];
  }
  for (int k = 0; k < 8; ++k) inc[k] = 0.f;
  for (int r = 0; r < m; ++r) inc[idx[r]] = x[r];
}

// SE(3) exp of xi = [t, w] as geometry/lie.py::se3_exp computes it in f32
// (Taylor switch below theta^2 = 1e-4), as a 4x4 row-major matrix.
__device__ void se3_exp(const float* xi, float* E) {
  const float w0 = xi[3], w1 = xi[4], w2 = xi[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < 1e-4f;
  const float st2 = small ? 1.f : th2;
  const float st = sqrtf(st2);
  const float A = small ? 1.f - th2 / 6.f + th2 * th2 / 120.f : sinf(st) / st;
  const float B = small ? 0.5f - th2 / 24.f + th2 * th2 / 720.f
                        : (1.f - cosf(st)) / st2;
  const float C = small ? 1.f / 6.f - th2 / 120.f + th2 * th2 / 5040.f
                        : (st - sinf(st)) / (st2 * st);
  const float W[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
  float W2[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i * 3 + j] = W[i * 3 + 0] * W[0 * 3 + j] + W[i * 3 + 1] * W[1 * 3 + j] +
                      W[i * 3 + 2] * W[2 * 3 + j];
  float V[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      E[i * 4 + j] = eye + A * W[i * 3 + j] + B * W2[i * 3 + j];
      V[i * 3 + j] = eye + B * W[i * 3 + j] + C * W2[i * 3 + j];
    }
  }
  for (int i = 0; i < 3; ++i)
    E[i * 4 + 3] = V[i * 3 + 0] * xi[0] + V[i * 3 + 1] * xi[1] + V[i * 3 + 2] * xi[2];
  E[12] = 0.f;
  E[13] = 0.f;
  E[14] = 0.f;
  E[15] = 1.f;
}

template <bool kPoints3d>
class LmCluster {
 public:
  static constexpr int NACC = kPoints3d ? dsslam::kPose3dAcc : dsslam::kPoseAcc;

  __device__ LmCluster(const LmParams& p, LmState& st, ClusterSums<NACC>& cs)
      : p_(p), st_(st), cs_(cs), tid_(threadIdx.x) {}

  // thread 0: the warp of a pass at pose T, affine (a, b) and cutoff
  __device__ void set_warp(const float* T, float a, float b, float cutoff,
                           const LmLevel& L) {
    dsslam::PoseWarp& w = st_.warp;
    if (kPoints3d) {
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) w.r[i * 3 + j] = T[i * 4 + j];
    } else {
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j)
          w.r[i * 3 + j] = T[i * 4 + 0] * L.Ki[0 * 3 + j] +
                           T[i * 4 + 1] * L.Ki[1 * 3 + j] +
                           T[i * 4 + 2] * L.Ki[2 * 3 + j];
    }
    w.t[0] = T[3];
    w.t[1] = T[7];
    w.t[2] = T[11];
    // aff_from_to(ref_exposure, ref a, ref b, new_exposure, a, b)
    const float a_rel = expf(a - st_.ref_a) *
                        (st_.new_exp / dsslam::clamp_min(st_.ref_exp, 1e-9f));
    w.a = a_rel;
    w.b = b - a_rel * st_.ref_b;
    w.cutoff = cutoff;
    w.ref_b0 = st_.ref_b;
    for (int k = 0; k < 9; ++k) w.k[k] = L.Ki[k];
  }

  // All threads: one pass over the level at st.warp; leaves the pass's
  // H, b and statistics in st.o*.
  __device__ void pass(int lvl, const LmLevel& L) {
    const dsslam::PoseWarp c = st_.warp;
    float acc[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
    for (int j = tid_; j < cs_.count; j += kLmThreads) {
      if constexpr (kPoints3d) {
        dsslam::pose3d_point(L.img, L.H, L.W, L.umax, L.vmax, cs_.s0[j],
                             cs_.s1[j], cs_.s2[j], cs_.sc[j], cs_.sm[j] != 0, c,
                             L.fx, L.fy, L.cx, L.cy, p_.huber, acc);
      } else {
        dsslam::pose_point(L.img, L.H, L.W, L.umax, L.vmax, cs_.s0[j],
                           cs_.s1[j], cs_.s2[j], cs_.sc[j], cs_.sm[j] != 0,
                           cs_.start + j, c, L.fx, L.fy, L.cx, L.cy, p_.huber,
                           L.compute_flow != 0, acc);
      }
    }
    cs_.reduce(acc);
    if (tid_ == 0) {
      using namespace dsslam;
      const float* tot = cs_.tot;
      const float n_safe = fmaxf(tot[kNIN], 1.f);
      for (int i = 0; i < 8; ++i) {
        for (int j = 0; j < 8; ++j)
          st_.oH[i * 8 + j] = tot[tri_index(i, j)] / n_safe * p_.pre[i] * p_.pre[j];
        st_.og[i] = tot[36 + i] / n_safe * p_.pre[i];
      }
      st_.oE = tot[kE];
      st_.on = tot[kNT];
      st_.osat = tot[kNS] / fmaxf(tot[kNT], 1.f);
      st_.onin = tot[kNIN];
      st_.oft = 0.f;
      st_.ofrt = 0.f;
      if constexpr (!kPoints3d) {
        if (L.compute_flow) {
          const float num = tot[kNSUB] * 2.f + 0.1f;
          st_.oft = tot[kFT] / num;
          st_.ofrt = tot[kFRT] / num;
        }
      }
      st_.passes[lvl] += 1;
    }
    __syncthreads();
  }

  // thread 0: the last pass becomes the carry's system (pre-loop)
  __device__ void take_pass() {
    for (int k = 0; k < 64; ++k) st_.H[k] = st_.oH[k];
    for (int k = 0; k < 8; ++k) st_.g[k] = st_.og[k];
    st_.E = st_.oE;
    st_.n = st_.on;
    st_.n_in = st_.onin;
    st_.ft = st_.oft;
    st_.frt = st_.ofrt;
    st_.sat = st_.osat;
  }

  // thread 0: the LM trial step from the carry
  __device__ void trial(float cutoff, const LmLevel& L) {
    float inc[8];
    solve_inc(st_, p_.mode_a, p_.mode_b, inc);
    const float lim = p_.lambda_lim;
    const float extrap = st_.lam < lim ? sqrtf(sqrtf(lim / st_.lam)) : 1.f;
    float scaled[8];
    float sum = 0.f, nrm = 0.f;
    for (int k = 0; k < 8; ++k) {
      inc[k] = inc[k] * extrap;
      scaled[k] = inc[k] * p_.pre[k];
      sum += scaled[k];
      nrm += inc[k] * inc[k];
    }
    if (!isfinite(sum))
      for (int k = 0; k < 8; ++k) scaled[k] = 0.f;
    st_.inc_norm = sqrtf(nrm);
    float Ex[16];
    se3_exp(scaled, Ex);
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j)
        st_.Tn[i * 4 + j] = Ex[i * 4 + 0] * st_.T[0 * 4 + j] +
                            Ex[i * 4 + 1] * st_.T[1 * 4 + j] +
                            Ex[i * 4 + 2] * st_.T[2 * 4 + j] +
                            Ex[i * 4 + 3] * st_.T[3 * 4 + j];
    st_.an = st_.a + scaled[6];
    st_.bn = st_.b + scaled[7];
    set_warp(st_.Tn, st_.an, st_.bn, cutoff, L);
  }

  // thread 0: accept or reject the trial, the lambda schedule, the break
  __device__ void update() {
    const float e_new = st_.oE / dsslam::clamp_min(st_.on, 1.f);
    const float e_old = st_.E / dsslam::clamp_min(st_.n, 1.f);
    if (e_new < e_old) {
      for (int k = 0; k < 16; ++k) st_.T[k] = st_.Tn[k];
      st_.a = st_.an;
      st_.b = st_.bn;
      take_pass();
      st_.lam = st_.lam * p_.lambda_accept;
    } else {
      st_.lam = dsslam::clamp_min(st_.lam * p_.lambda_reject, p_.lambda_lim);
    }
    st_.done = st_.inc_norm <= p_.inc_break ? 1 : 0;
  }

  // All threads: one level of LM from the carry (models/tracker.py::
  // _track_level for one candidate). Returns the cutoff-doubling factor.
  __device__ float level(int lvl, const LmLevel& L) {
    if (tid_ == 0) {
      for (int k = 0; k < 16; ++k) st_.T0[k] = st_.T[k];
      st_.a0 = st_.a;
      st_.b0 = st_.b;
      st_.repeat = 1.f;
      set_warp(st_.T0, st_.a0, st_.b0, p_.coarse_cutoff * st_.repeat, L);
    }
    __syncthreads();
    pass(lvl, L);
    if (tid_ == 0) take_pass();
    __syncthreads();
    // cutoff doubling while too many residuals saturate
    for (;;) {
      const bool more = st_.sat > p_.sat_ratio_repeat &&
                        st_.repeat < p_.cutoff_repeat_max;
      __syncthreads();
      if (!more) break;
      if (tid_ == 0) {
        st_.repeat = st_.repeat * 2.f;
        set_warp(st_.T0, st_.a0, st_.b0, p_.coarse_cutoff * st_.repeat, L);
      }
      __syncthreads();
      pass(lvl, L);
      if (tid_ == 0) take_pass();
      __syncthreads();
    }
    const float repeat = st_.repeat;
    const float cutoff = p_.coarse_cutoff * repeat;
    if (tid_ == 0) {
      st_.lam = p_.lambda_init;
      st_.done = 0;
    }
    __syncthreads();
    for (int it = 0; it < L.max_iters; ++it) {
      const bool done = st_.done != 0;
      __syncthreads();
      if (done) break;
      if (tid_ == 0) trial(cutoff, L);
      __syncthreads();
      pass(lvl, L);
      if (tid_ == 0) update();
      __syncthreads();
    }
    return repeat;
  }

  // All threads: every level coarse to fine with the one-shot level
  // repeat (track_candidates_batch / _estimate_seeds for one candidate).
  __device__ void run(int cand) {
    if (tid_ == 0) {
      for (int k = 0; k < 16; ++k) st_.T[k] = p_.T_init[cand * 16 + k];
      st_.a = read_scalar(p_.aff_a0);
      st_.b = read_scalar(p_.aff_b0);
      st_.ref_a = read_scalar(p_.ref_a);
      st_.ref_b = read_scalar(p_.ref_b);
      st_.ref_exp = read_scalar(p_.ref_exp);
      st_.new_exp = read_scalar(p_.new_exp);
      st_.x0 = 0.f;
      st_.x1 = 1.f;
      for (int l = 0; l < kMaxLevels; ++l) {
        st_.res[l] = 0.f;
        st_.passes[l] = 0;
      }
    }
    bool have_repeated = false;
    for (int lvl = p_.levels - 1; lvl >= 0; --lvl) {
      const LmLevel& L = p_.lv[lvl];
      cs_.load_level(L);
      const float repeat = level(lvl, L);
      if (repeat > 1.f && !have_repeated) level(lvl, L);
      have_repeated = have_repeated || repeat > 1.f;
      if (tid_ == 0) {
        st_.res[lvl] = st_.n > 0.f
                           ? sqrtf(st_.E / dsslam::clamp_min(st_.n, 1.f))
                           : __int_as_float(0x7f800000);
        if (lvl == 0) {
          st_.x0 = kPoints3d ? st_.E : st_.ft;
          st_.x1 = kPoints3d ? st_.n : st_.frt;
        }
      }
    }
    __syncthreads();
    if (cs_.rank == 0 && tid_ == 0) {
      float* o = p_.out + static_cast<size_t>(cand) * kLmOut;
      for (int k = 0; k < 16; ++k) o[k] = st_.T[k];
      o[kOutA] = st_.a;
      o[kOutB] = st_.b;
      for (int l = 0; l < kMaxLevels; ++l) {
        o[kOutRes + l] = st_.res[l];
        o[kOutPasses + l] = static_cast<float>(st_.passes[l]);
      }
      o[kOutX0] = st_.x0;
      o[kOutX1] = st_.x1;
      for (int k = kOutPasses + kMaxLevels; k < kLmOut; ++k) o[k] = 0.f;
    }
    // no block leaves while another may still read its shared memory
    cg::this_cluster().sync();
  }

 private:
  const LmParams& p_;
  LmState& st_;
  ClusterSums<NACC>& cs_;
  int tid_;
};

template <bool kPoints3d>
__global__ void __launch_bounds__(kLmThreads) lm_kernel(const LmParams p) {
  constexpr int NACC = LmCluster<kPoints3d>::NACC;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][NACC];
  __shared__ float tot[NACC];
  __shared__ LmState st;
  // the parameters in shared memory, where the levels index them freely
  __shared__ LmParams sp;
  if (threadIdx.x == 0) sp = p;
  __syncthreads();
  ClusterSums<NACC> cs(smem, p.chunk, red, tot);
  LmCluster<kPoints3d> lm(sp, st, cs);
  lm.run(blockIdx.y);
}

// K3-LM: one guess's coarse-to-fine 1-DoF scale LM
// (models/scale_opt.py::optimize_scale_batch_plain for one guess). Its
// state is a few scalars that every thread of the cluster holds and
// updates alike from the bit-identical cluster sums: no thread waits for
// another's step. The step is the reference's scalar one, no solve.
class ScaleLm {
 public:
  __device__ ScaleLm(const ScaleLmParams& p, ClusterSums<dsslam::kScaleAcc>& cs)
      : p_(p), cs_(cs) {}

  struct Pass {
    float H, b, E, n, sat;
  };

  // All threads: one pass over level L at scale s and cutoff.
  __device__ Pass pass(const LmLevel& L, float s, float cutoff, int& passes) {
    using namespace dsslam;
    ScaleWarp w;
#pragma unroll
    for (int k = 0; k < 9; ++k) w.r[k] = L.Ki[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) w.t[k] = p_.t01[k];
    w.s = s;
    w.cutoff = cutoff;
    float acc[kScaleAcc];
#pragma unroll
    for (int k = 0; k < kScaleAcc; ++k) acc[k] = 0.f;
    for (int j = cs_.tid; j < cs_.count; j += kLmThreads)
      scale_point(L.img, L.H, L.W, L.umax, L.vmax, cs_.s0[j], cs_.s1[j],
                  cs_.s2[j], cs_.sc[j], cs_.sm[j] != 0, w, L.fx, L.fy, L.cx,
                  L.cy, p_.huber, acc);
    cs_.reduce(acc);
    const float* t = cs_.tot;
    const float n_safe = fmaxf(t[kSNIN], 1.f);
    ++passes;
    return Pass{t[kSH] / n_safe, t[kSB] / n_safe, t[kSE], t[kSNT],
                t[kSNS] / fmaxf(t[kSNT], 1.f)};
  }

  // All threads: models/scale_opt.py::_optimize_scale_level for one guess
  // from s. Leaves the level's s, E and n; returns the cutoff-doubling
  // factor.
  __device__ float level(const LmLevel& L, float& s, float& E, float& n,
                         int& passes) {
    using dsslam::clamp_min;
    const float s0 = s;
    float repeat = 1.f;
    Pass o = pass(L, s0, p_.coarse_cutoff * repeat, passes);
    while (o.sat > p_.sat_ratio_repeat && repeat < p_.cutoff_repeat_max) {
      repeat = repeat * 2.f;
      o = pass(L, s0, p_.coarse_cutoff * repeat, passes);
    }
    const float cutoff = p_.coarse_cutoff * repeat;
    float H = o.H, b = o.b;
    E = o.E;
    n = o.n;
    float lam = p_.lambda_init;
    const float lim = p_.lambda_lim;
    for (int it = 0; it < L.max_iters; ++it) {
      const float Hl = H * (1.f + lam);
      float inc = -b / (fabsf(Hl) < 1e-20f ? 1e-20f : Hl);
      const float extrap = lam < lim ? sqrtf(sqrtf(lim / lam)) : 1.f;
      inc = inc * extrap;
      // reject non-finite or over-large steps
      if (!(isfinite(inc) && fabsf(inc) <= s)) inc = 0.f;
      const float s_new = s + inc;
      const Pass t = pass(L, s_new, cutoff, passes);
      if (t.E / clamp_min(t.n, 1.f) < E / clamp_min(n, 1.f)) {
        s = s_new;
        H = t.H;
        b = t.b;
        E = t.E;
        n = t.n;
        lam = lam * p_.lambda_accept;
      } else {
        lam = clamp_min(lam * p_.lambda_reject, lim);
      }
      if (fabsf(inc) <= p_.inc_break) break;
    }
    return repeat;
  }

  // All threads: every level coarse to fine with the one-shot level repeat.
  __device__ void run(int g) {
    const bool leader = cs_.rank == 0 && cs_.tid == 0;
    float* o = p_.out + static_cast<size_t>(g) * kScaleOut;
    float s = p_.s_init[g];
    float E = 0.f, n = 0.f;
    bool have_repeated = false;
    for (int lvl = p_.levels - 1; lvl >= 0; --lvl) {
      const LmLevel& L = p_.lv[lvl];
      cs_.load_level(L);
      int passes = 0;
      const float repeat = level(L, s, E, n, passes);
      if (repeat > 1.f && !have_repeated) level(L, s, E, n, passes);
      have_repeated = have_repeated || repeat > 1.f;
      if (leader) {
        o[kSOutRepeat + lvl] = repeat;
        o[kSOutPasses + lvl] = static_cast<float>(passes);
      }
    }
    if (leader) {
      o[kSOutScale] = s;
      o[kSOutErr] = sqrtf(E / dsslam::clamp_min(n, 1.f));
      o[kSOutE] = E;
      o[kSOutN] = n;
      for (int l = p_.levels; l < kMaxLevels; ++l) {
        o[kSOutRepeat + l] = 0.f;
        o[kSOutPasses + l] = 0.f;
      }
    }
    // no block leaves while another may still read its shared memory
    cg::this_cluster().sync();
  }

 private:
  const ScaleLmParams& p_;
  ClusterSums<dsslam::kScaleAcc>& cs_;
};

__global__ void __launch_bounds__(kLmThreads)
    scale_lm_kernel(const ScaleLmParams p) {
  constexpr int NACC = dsslam::kScaleAcc;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][NACC];
  __shared__ float tot[NACC];
  __shared__ ScaleLmParams sp;
  if (threadIdx.x == 0) sp = p;
  __syncthreads();
  ClusterSums<NACC> cs(smem, p.chunk, red, tot);
  ScaleLm lm(sp, cs);
  lm.run(blockIdx.y);
}

cudaLaunchConfig_t lm_config(int B, size_t smem, cudaStream_t stream,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B, 1);
  cfg.blockDim = dim3(kLmThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One cluster per candidate (batch of them) of an LM kernel taking Params.
template <typename Params>
int launch_lm(void (*kernel)(const Params), const Params* p, int batch,
              cudaStream_t stream) {
  if (p->levels < 1 || p->levels > kMaxLevels || batch < 1 || p->chunk % 4 != 0)
    return cudaErrorInvalidValue;
  for (int l = 0; l < p->levels; ++l)
    if (slice_len(p->lv[l].N) > p->chunk) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p->chunk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lm_config(batch, smem, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, *p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

DSSLAM_API int dsslam_lm_params_size() {
  return static_cast<int>(sizeof(LmParams));
}

DSSLAM_API int dsslam_scale_lm_params_size() {
  return static_cast<int>(sizeof(ScaleLmParams));
}

DSSLAM_API int dsslam_track_lm(const LmParams* p, cudaStream_t stream) {
  return launch_lm(lm_kernel<false>, p, p->B, stream);
}

DSSLAM_API int dsslam_loop_pose_lm(const LmParams* p, cudaStream_t stream) {
  return launch_lm(lm_kernel<true>, p, p->B, stream);
}

DSSLAM_API int dsslam_scale_lm(const ScaleLmParams* p, cudaStream_t stream) {
  return launch_lm(scale_lm_kernel, p, p->G, stream);
}

// How many 8-block clusters of an LM kernel (kind 0: K2-LM, 1: K4-LM,
// 2: K3-LM) fit on the card at once for a slice of `chunk` points.
DSSLAM_API int dsslam_lm_max_active_clusters(int kind, int chunk, int* out) {
  const size_t smem = smem_bytes(chunk);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lm_config(1, smem, nullptr, attr);
  switch (kind) {
    case 0:
      return cudaOccupancyMaxActiveClusters(out, lm_kernel<false>, &cfg);
    case 1:
      return cudaOccupancyMaxActiveClusters(out, lm_kernel<true>, &cfg);
    case 2:
      return cudaOccupancyMaxActiveClusters(out, scale_lm_kernel, &cfg);
    default:
      return cudaErrorInvalidValue;
  }
}
