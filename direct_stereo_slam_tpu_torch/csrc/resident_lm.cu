// K2-LM and K4-LM: the whole coarse-to-fine Levenberg-Marquardt of the
// tracker and of the loop-closure pose estimator, resident on the card,
// one launch per candidate batch (K2-LM) or seed stack (K4-LM).
//
// They replace the jitted JAX programs
// direct_stereo_slam_tpu/models/tracker.py::track_candidates_batch
// (cutoff loop :143, LM while_loop :206, level repeat :269, vmap over the
// candidates :316-333) and
// direct_stereo_slam_tpu/loop/pose_estimator.py::_estimate_seeds (:74,
// :115, :167, vmap over the seeds :217-252); per LM iteration those run
// the XLA pass programs ops/residual_hb.py::pose_residual_pass (:126) and
// ::pose3d_residual_pass (:235). The port's plain versions are the Python
// loops models/tracker.py::track_candidates_batch_plain and
// loop/pose_estimator.py::estimate_seeds_plain.
//
// What bounds them on the H100. One LM pass reads a level's points (17 B
// each) and 4 bilinear taps of (I, dx, dy) per point, then reduces 51
// (K2) or 48 (K4) sums; per candidate a call runs ~20-200 such passes in
// sequence, each followed by an 8x8 solve and an SE(3) exponential that
// decide the next pass. Bytes over 3.35 TB/s bound a call at microseconds
// (one candidate) to a fraction of a millisecond (78 candidates); the f32
// operations (~200 per point and pass) take ~5x less, so there is no use
// for tensor cores (and the reference pins f32: no TF32 anywhere). The
// real cost is the latency of each pass and LM step in sequence. What the per-pass form lost was the host: a
// parameter tensor, a ctypes crossing and a blocking read per LM
// iteration. Here the data-dependent control flow (cutoff doubling, LM
// accept/reject, the increment-norm break, the one-shot level repeat)
// runs on the card, so a batch costs one launch and no host read.
//
// Design:
// - One thread-block cluster of 8 blocks (portable size) per candidate or
//   seed, the candidate on blockIdx.y. Candidates never talk to each
//   other, so no grid-wide sync; a finished candidate stops, which is
//   what vmap of a while_loop computes. 8 blocks spread even a batch of
//   one over 8 SMs.
// - At each level a block copies its eighth of the level's points into
//   shared memory with cp.async (cooperative_groups::memcpy_async) once;
//   every pass of the level reads them from there. At most 8192 points x
//   17 B / 8 = 17 KB per block. Image taps come through L2 (level 0 at
//   KITTI size is 5.4 MB, inside the 50 MB L2).
// - Per pass each thread runs the per-point arithmetic of the per-pass
//   kernels (pose_terms.cuh), the block reduces in a fixed order (warp
//   shuffles, then warps in order: block_sum) into a double-buffered
//   slot, and after one cluster barrier every block sums the 8 blocks'
//   slots through distributed shared memory in rank order. Every block
//   thus holds bit-identical totals and runs the same LM step on them
//   (thread 0: the damped solve by the affine mode as an f32 LU with
//   partial pivoting, extrapolation, preconditioning and the isfinite
//   guard, se3_exp as geometry/lie.py computes it, accept/reject and the
//   lambda schedule), so the whole cluster follows one path with no
//   broadcast and one cluster barrier per pass. No atomics: two runs give
//   the same bits.
// - Host side: one parameter struct passed by value (per-level image and
//   point pointers, intrinsics, Ki, the tracker's scalars, the affine
//   modes; scalars that live on the card are read there through a
//   pointer). Output per candidate: T, a, b, the per-level residual, the
//   flow indicators (K2) or level 0's E and n (K4), and the passes run
//   per level. The acceptance gates and the winner stay in PyTorch.

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

}  // namespace

// The layouts below are mirrored by ctypes structures in
// ops/resident_lm.py; dsslam_lm_params_size lets that module check them.
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
  float fx, fy, cx, cy;
  float Ki[9];
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

static_assert(sizeof(LmLevel) == 136, "LmLevel layout");
static_assert(sizeof(LmParams) == 1288, "LmParams layout");

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
  int buf;
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

  __device__ LmCluster(const LmParams& p, LmState& st, float (*red)[NACC],
                       float* tot, float* s0, float* s1, float* s2, float* sc,
                       unsigned char* sm)
      : p_(p), st_(st), red_(red), tot_(tot), s0_(s0), s1_(s1), s2_(s2),
        sc_(sc), sm_(sm),
        rank_(static_cast<int>(cg::this_cluster().block_rank())),
        tid_(threadIdx.x) {}

  // This block's slice of level lvl's points into shared memory.
  __device__ void load_level(const LmLevel& L) {
    __syncthreads();        // nobody still reads the previous level's slice
    const int per = slice_len(L.N);
    start_ = min(rank_ * per, L.N);
    count_ = min(per, L.N - start_);
    cg::thread_block block = cg::this_thread_block();
    if (count_ > 0) {
      cg::memcpy_async(block, s0_, L.p0 + start_, sizeof(float) * count_);
      cg::memcpy_async(block, s1_, L.p1 + start_, sizeof(float) * count_);
      cg::memcpy_async(block, s2_, L.p2 + start_, sizeof(float) * count_);
      cg::memcpy_async(block, sm_, L.pmask + start_,
                       sizeof(unsigned char) * count_);
      if (L.color_stride == 1) {
        cg::memcpy_async(block, sc_, L.pcolor + start_, sizeof(float) * count_);
      } else {
        for (int j = tid_; j < count_; j += kLmThreads)
          sc_[j] = L.pcolor[static_cast<size_t>(start_ + j) * L.color_stride];
      }
    }
    cg::wait(block);
  }

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
    const int buf = st_.buf;
    float acc[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
    for (int j = tid_; j < count_; j += kLmThreads) {
      if constexpr (kPoints3d) {
        dsslam::pose3d_point(L.img, L.H, L.W, L.umax, L.vmax, s0_[j], s1_[j],
                             s2_[j], sc_[j], sm_[j] != 0, c, L.fx, L.fy, L.cx,
                             L.cy, p_.huber, acc);
      } else {
        dsslam::pose_point(L.img, L.H, L.W, L.umax, L.vmax, s0_[j], s1_[j],
                           s2_[j], sc_[j], sm_[j] != 0, start_ + j, c, L.fx,
                           L.fy, L.cx, L.cy, p_.huber, L.compute_flow != 0,
                           acc);
      }
    }
    dsslam::block_sum<NACC, kLmThreads>(acc, red_[buf]);
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (tid_ < NACC) {
      float s = 0.f;
      for (int r = 0; r < kCluster; ++r)
        s += cluster.map_shared_rank(&red_[buf][0], r)[tid_];
      tot_[tid_] = s;
    }
    __syncthreads();
    if (tid_ == 0) {
      using namespace dsslam;
      const float n_safe = fmaxf(tot_[kNIN], 1.f);
      for (int i = 0; i < 8; ++i) {
        for (int j = 0; j < 8; ++j)
          st_.oH[i * 8 + j] = tot_[tri_index(i, j)] / n_safe * p_.pre[i] * p_.pre[j];
        st_.og[i] = tot_[36 + i] / n_safe * p_.pre[i];
      }
      st_.oE = tot_[kE];
      st_.on = tot_[kNT];
      st_.osat = tot_[kNS] / fmaxf(tot_[kNT], 1.f);
      st_.onin = tot_[kNIN];
      st_.oft = 0.f;
      st_.ofrt = 0.f;
      if constexpr (!kPoints3d) {
        if (L.compute_flow) {
          const float num = tot_[kNSUB] * 2.f + 0.1f;
          st_.oft = tot_[kFT] / num;
          st_.ofrt = tot_[kFRT] / num;
        }
      }
      st_.buf = buf ^ 1;
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
      st_.buf = 0;
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
      load_level(L);
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
    if (rank_ == 0 && tid_ == 0) {
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
  float (*red_)[NACC];
  float* tot_;
  float *s0_, *s1_, *s2_, *sc_;
  unsigned char* sm_;
  int rank_;
  int tid_;
  int start_ = 0;
  int count_ = 0;
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
  float* s0 = reinterpret_cast<float*>(smem);
  float* s1 = s0 + p.chunk;
  float* s2 = s1 + p.chunk;
  float* sc = s2 + p.chunk;
  unsigned char* sm = reinterpret_cast<unsigned char*>(sc + p.chunk);
  LmCluster<kPoints3d> lm(sp, st, red, tot, s0, s1, s2, sc, sm);
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

template <bool kPoints3d>
int launch_lm(const LmParams* p, cudaStream_t stream) {
  if (p->levels < 1 || p->levels > kMaxLevels || p->B < 1 || p->chunk % 4 != 0)
    return cudaErrorInvalidValue;
  for (int l = 0; l < p->levels; ++l)
    if (slice_len(p->lv[l].N) > p->chunk) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p->chunk);
  auto kernel = lm_kernel<kPoints3d>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lm_config(p->B, smem, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, *p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

DSSLAM_API int dsslam_lm_params_size() {
  return static_cast<int>(sizeof(LmParams));
}

DSSLAM_API int dsslam_track_lm(const LmParams* p, cudaStream_t stream) {
  return launch_lm<false>(p, stream);
}

DSSLAM_API int dsslam_loop_pose_lm(const LmParams* p, cudaStream_t stream) {
  return launch_lm<true>(p, stream);
}

// How many 8-block clusters of the LM kernel (K2-LM, or K4-LM when
// points3d) fit on the card at once for a slice of `chunk` points.
DSSLAM_API int dsslam_lm_max_active_clusters(int points3d, int chunk,
                                             int* out) {
  const size_t smem = smem_bytes(chunk);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lm_config(1, smem, nullptr, attr);
  return points3d ? cudaOccupancyMaxActiveClusters(out, lm_kernel<true>, &cfg)
                  : cudaOccupancyMaxActiveClusters(out, lm_kernel<false>, &cfg);
}
