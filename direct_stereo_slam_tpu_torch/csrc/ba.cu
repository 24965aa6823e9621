// K9-K11: the windowed photometric BA (models/ba.py) on the card.
// optimize_keyframe's whole Levenberg-Marquardt loop is one resident launch
// (dsslam_ba_optimize): K9 and K11's start, then rounds of K10 (the step)
// -> K9 (the linearization at the candidate) -> K11 (accept or reject),
// and the loop's bookkeeping. The queued entry points run the same code one
// launch at a time (K9 alone serves linearize; K10 and K11 queued are the
// bit reference of the resident launch).
//
// They replace the JAX package's jitted windowed BA,
// direct_stereo_slam_tpu/models/ba.py (no Pallas kernel there: XLA
// programs):
//   K9  dsslam_ba_linearize <- :198 linearize
//   K10 dsslam_ba_step      <- :551 solve_step, :594 apply_step,
//                              :602 _step_converged
//   K11 dsslam_ba_accept    <- :645-700, total_energy and the while_loop
//                              body's accept / reject
//   dsslam_ba_optimize      <- :645-732, _optimize_impl whole (its loop and
//                              the isOOB bookkeeping after it)
// The port's plain versions are models/ba.py::linearize_plain, solve_step,
// apply_step, _step_converged, _optimize_loop_plain and _finish_optimize.
//
// What bounds them on the H100. K9 samples 4 bilinear corners of 12 bytes
// for each of NP x W x 8 residuals (7.9 MB at NP = 2560, W = 8: ~2.4 us at
// 3.35 TB/s) and does ~650 f32 operations a residual (its Jacobian and its
// 230 products into the 20x20 block and b: ~1.6 us at 67 TFLOP/s), so it
// is bound by bytes, then operations. K10 reads Hfd and the point terms
// (0.8 MB, ~0.24 us) and needs ~13 M operations (one multiply-add per
// point for each of the Schur entries, ~0.2 us): bound by bytes on paper,
// in practice by its damped solve's chain of 8W - 4 dependent pivot steps.
// K11 is a 68 x 68 product. None has a product a tensor core could take
// in f32 (the reference pins Precision.HIGHEST).
//
// Design (fixed order and no atomics throughout: two runs give the same
// bits).
// - K9 is two launches. The first is one block per (chunk, target t, host
//   s), in clusters of the kChunks chunks of one (s, t). The points are
//   grouped by host once per parameter block (ops/ba.py::host_groups: a
//   stable sort of p_host), and chunk c takes the c-th eighth of host s's
//   list, so a block's 20x20 block and b belong to one (s, t) and need no
//   per-point scatter. A round takes 32 points x 8 pattern pixels, a
//   thread a pixel: its warp, bilinear sample, Huber weight, 20-wide
//   Jacobian row, its pair's sums by 8-lane shuffles. Only the rows of a
//   good pair (the pairs whose weights can be non-zero) are compacted into
//   shared memory; 12 groups of 20 threads each hold a 4x4 tile of the
//   upper triangle (or 4 entries of b) in registers across the rows, read
//   as float4. A pair that is not good adds J * 0: nothing unless its
//   Jacobian or residual is not finite, which its non-finite mask records
//   (entry (i, j) is NaN iff bit i or bit j is set, as J_i * 0 * J_j).
//   The chunks' partials are summed in rank order through distributed
//   shared memory by the cluster's rank 0 into the (s, t) block. Per
//   (point, target) the 22 sums that feed Hfd, Hdd and bd go to a scratch
//   [NP, W, 22]. The second launch forms each point's Hfd row, Hdd and bd
//   from it and assembles Hff and bf from the W x W reduced blocks, eight
//   threads an entry (one per host s, over the targets t), summed in s
//   order by shuffles.
// - K10 is one launch of a cluster of 16 blocks (8 where 16 cannot be
//   resident). Each block copies its range of Hfd rows into shared memory
//   (cooperative_groups::memcpy_async; a loop over chunks where the range
//   does not fit) and forms its Schur partial over the free unknowns (the
//   anchor's 8 are frozen: 8W - 4 of them) with 3 groups of threads, each
//   thread a 4x4 tile of the upper triangle or 4 entries of b. After a
//   cluster barrier block 0 adds the partials in rank order through
//   distributed shared memory, assembles the damped, preconditioned
//   system (Hff, HM, bf and bM copied into its shared memory during the
//   Schur sums) and solves it by LU with partial pivoting in two warps: a
//   row in each lane's registers, shifted one column left per step so
//   every index is static, the pivot the first row of largest |entry| (a
//   warp max of a key of |entry| and the row, then one two-warp barrier),
//   pivot rows kept in shared memory in pivot order, then a back-
//   substitution a column at a time in one warp. (Gauss-Jordan, which needs
//   no back-substitution, left x ~4e-3 from a float64 solve where lam is
//   1e-6 and the scale direction nearly free; LU, like solve_ex, ~3e-6.)
//   The nullspace projection and the convergence test are warp
//   reductions. Block 0 pushes x into every block's shared memory; after a
//   second cluster barrier every block back-substitutes x_d for its own
//   points from the rows it holds and writes the candidate state.
// - NaN as the plain version: a pair whose weight is 0 still adds J * 0,
//   so a NaN pose makes H NaN as J20 * w_pix does; and the plain version's
//   one-hot matmul spreads a NaN product to every host's block of that
//   target: the assembly adds, to every (s, t) term, the other hosts'
//   blocks of t times 0 (read only where a block of t is not finite). The
//   solve's pivot search never loops on data; a NaN in the system reaches
//   x as it does through torch.linalg.solve_ex, and the nullspace
//   projection spreads it to every entry. Bilinear samples clamp finite
//   coordinates (common.cuh, sample3). The JAX package gathers each point's
//   relative poses toward t by a one-hot matmul (the plain version mirrors
//   it, _host_blocks), so a block toward t that is not finite for any host
//   makes every pair toward t non-finite: every finite entry of the pass's
//   relative poses is NaN then.
// - No host read: each queued launch reads the device's done flag first
//   and returns at once once it is set, so the host queues a fixed number
//   of iterations. The state and the linearization live in two buffers
//   each; ctrl_i[0] names the current one, and K11 moves it to the
//   candidate on accept (or, in DSO's force-accept mode, whenever the step
//   applies).
// - The resident launch (K11's redesign: the loop's control on the card,
//   where the host issued ~3 launches an iteration) is a cooperative grid
//   of 512-thread blocks, one an SM, every block resident, and the same
//   device functions as the queued launches. Work is fixed by the data, not
//   by the grid: K9's (chunk, target, host) items run on the blocks'
//   256-thread halves (named barriers), their partials go through global
//   scratch (L2) instead of a cluster's shared memory and are summed in
//   rank order after a grid barrier; K10 runs as the queued plan's R ranks
//   (blocks 0 .. R - 1), its partials summed by rank 0 in rank order. So
//   every sum has the queued order and the result is the same bits on any
//   SM count. K11 runs in every block from the same sums (each block forms
//   the energy as K9's assembly writes it), so all blocks take the same
//   branch and leave the loop together, and no barrier follows it; the
//   assembly's Hff and bf are left running beside the next step's Schur
//   sums, which read them only after their first barrier; the prior part
//   of the energy is formed by one block that holds no rank while the
//   ranks back-substitute. Five grid barriers an iteration (Schur
//   partials, x, the candidate, the pixel pass, the chunks' sums). The
//   pixel pass's items go to the blocks' halves heaviest host first, in a
//   snake (the halves in order, then in reverse), as the queued launch's
//   block scheduler balances them; its and K10's phases are calls of
//   their own, so that the values the loop keeps do not crowd their
//   registers. The accepted buffers and the bookkeeping (p_num_good,
//   p_last_res, rmse, ok) are written by the launch itself.

#include <cooperative_groups.h>
#include <cooperative_groups/memcpy_async.h>

#include "lie.cuh"

namespace cg = cooperative_groups;

namespace {

using dsslam::block_sum;
using dsslam::clamp_min;
using dsslam::compose;
using dsslam::inverse;
using dsslam::load_pose;
using dsslam::Pose;
using dsslam::sample3;
using dsslam::se3_exp;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSlots = 8;
constexpr int kMaxD = 4 + 8 * kMaxSlots;
constexpr int kHU = 210;               // the 20x20 block's upper triangle
constexpr int kHB = 230;               // ... and its b
constexpr int kHE = 232;               // per (s, t) block: kHB | energy | good pairs
constexpr int kG = 22;                 // per (point, target): G20 | Hdd | bd
// K9's pixel pass
constexpr int kLinThreads = 256;       // 32 points x 8 pattern pixels a round
constexpr int kRoundPts = kLinThreads / 8;
constexpr int kChunks = 8;             // the cluster: chunks of one host's points
constexpr int kRow = 24;               // a staged row: J20 | r, w, Jd, 0
constexpr int kTiles = 20;             // 15 tiles of 4x4 (upper) + 5 of b
constexpr int kGroups = 12;            // 12 x 20 threads hold the tiles
constexpr int kTileFloats = 15 * 16 + 5 * 4;
constexpr int kFinThreads = 256;
// K10
constexpr int kStepThreads = 512;
constexpr int kFreeMax = 64;           // free unknowns, 8 W - 4 <= 60, padded
constexpr int kGroupsMax = 2 * kMaxSlots - 1;    // free float4 groups of a row
constexpr int kSTiles = kGroupsMax * (kGroupsMax + 1) / 2 + kGroupsMax;   // 135
constexpr int kSGroups = 3;            // 3 x 135 threads hold the tiles
constexpr int kSchurFloats = (kSTiles - kGroupsMax) * 16 + kGroupsMax * 4;   // 1980
// the groups' tiles; in block 0 afterwards the Schur sums, the system, the
// rows' copies, the pivot keys and x (kSchurFloats + 4 + 64 x 65 + 64 x 68
// + 256 + 64 = 10816)
constexpr int kSlot = kFreeMax + 4;
constexpr int kPartFloats = 10816;
constexpr size_t kSmemLimit = 232448 - 4096;   // dynamic, beside the static arrays
constexpr int kSysStride = kFreeMax + 1;
constexpr int kAcceptThreads = 128;
constexpr int kLinStamps = 8, kStepStamps = 10;
constexpr int kLinTimerWords = kMaxSlots * kMaxSlots * kChunks * kLinStamps;
constexpr int kFinStampBlocks = 1024;   // K9's second launch: start and end of its first blocks
constexpr int kPartStride = kSchurFloats + 4;
constexpr int kMaxRanks = 16;
// the resident launch: its phases (block 0's ns in each, ops/ba.py OPT_STAMPS)
enum OptPhase {
  kOptPixel, kOptReduce, kOptFinish, kOptSchur, kOptSolve, kOptBacksub, kOptEpilogue,
  kOptBarrier, kOptBarriers, kOptTotal, kOptStamps
};
constexpr int kOptBase = kLinTimerWords + 16 * kStepStamps + 8 + 2 * kFinStampBlocks;

}  // namespace

// The parameter block every entry point reads (ops/ba.py::BaParams mirrors
// it field for field). Buffers [3]: 0 and 1 the current state /
// linearization and the candidate, 2 the resident launch's output (the
// accepted ones); ctrl_i = {cur, done, converged, rounds run}, ctrl_f =
// {lam, e_old}.
struct BaParams {
  int W, NP, Himg, Wimg;
  float umax, vmax, u_hi, v_hi;
  float huber, calib_h, a_prior, b_prior;
  float th_a, th_b, th_r, th_t;
  int min_opt_iterations, force_accept;
  const float* images;
  const float* T_zero;
  const float* aff_zero;
  const float* exposure;
  const float* energy_th;
  const float* calib_zero;
  const unsigned char* frame_valid;
  const int* frame_id;
  const float* HM;
  const float* bM;
  const unsigned char* p_valid;
  const long long* p_host;
  const float* p_u;
  const float* p_v;
  const float* p_idepth_zero;
  const float* p_color;
  const float* p_weight;
  const float* p_prior;
  const unsigned char* p_res_good;
  const float* precond;   // [D]: models/ba.py::_precond (config.py's SCALE_*)
  const float* pat_u;     // [8]: config.py's PATTERN_OFFSETS, u then v
  const float* pat_v;
  const int* host_pts;    // [NP]: point indices grouped by host (ops/ba.py::host_groups)
  const int* host_off;    // [W + 1]: host s's points are host_pts[host_off[s]:host_off[s + 1]]
  const float* p_num_good;        // [NP]
  const int* p_last_res;          // [NP, 2]
  float* calib_delta[3];
  float* delta[3];
  float* idepth[3];
  float* Hff[3];
  float* bf[3];
  float* Hfd[3];
  float* Hdd[3];
  float* bd[3];
  float* energy[3];
  float* num_terms[3];
  float* pair_energy[3];
  unsigned char* pair_good[3];
  unsigned char* pair_in[3];
  int* ctrl_i;
  float* ctrl_f;
  float* lin_part;     // [W (s), W (t), kHE] reduced blocks, then [W, W] not-finite flags
  float* pt_part;      // [NP, W, kG]
  float* x;            // [D]
  float* x_d;          // [NP]
  float* chunk_part;   // [W (s), W (t), kChunks, kHE]: the resident launch's chunk partials
  float* schur_part;   // [16, kSchurFloats + 4]: ... its Schur partials per rank, then
                       // the prior part of the energy of the state it linearizes
  // the resident launch's bookkeeping (models/ba.py::_finish_optimize):
  // p_num_good, p_last_res, rmse, ok of the accepted linearization
  float* out_num_good;            // [NP]
  int* out_last_res;              // [NP, 2]
  float* out_rmse;                // [1]
  unsigned char* out_ok;          // [1]
  // phase stamps, null on the main path (ops/ba.py::timer_buffer): K9's
  // pixel pass kLinStamps per block (%globaltimer ns at its start, set-up,
  // rounds and end; then thread 0's clock64 cycles in the rounds' warp and
  // sample, compaction, and rows and products, and its rounds), K10's
  // kStepStamps per rank (ns at its phases' ends), then rank 0's solve's
  // cycles per part of a pivot step (key, candidate row, barrier, factor,
  // elimination), K9's second launch's stamps, then the resident launch's
  // kOptStamps (block 0's ns per phase, at its grid barriers, their count)
  unsigned long long* timers;
};

namespace {

__device__ __forceinline__ bool is_done(const BaParams& p) {
  return p.ctrl_i != nullptr && p.ctrl_i[1] != 0;
}

__device__ __forceinline__ int current(const BaParams& p) {
  return p.ctrl_i != nullptr ? p.ctrl_i[0] : 0;
}

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ long long cycles() { return clock64(); }

// phase stamp i of a block (thread 0 only, where timers is set)
__device__ __forceinline__ void stamp(const BaParams& p, int base, int i) {
  if (p.timers != nullptr && threadIdx.x == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    p.timers[base + i] = ns;
  }
}

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? qnan() : fmaxf(a, b);
}

// BAState.T_current of frame f in buffer b: se3_exp(delta[:6]) @ T_zero
__device__ __forceinline__ Pose<float> current_pose(const BaParams& p, int b, int f) {
  float xi[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) xi[k] = p.delta[b][8 * f + k];
  return compose(se3_exp(xi), load_pose<float>(p.T_zero, f));
}

// _prior_diag entry d
__device__ __forceinline__ float prior_at(const BaParams& p, int d) {
  if (d < 4) return p.calib_h;
  const int f = (d - 4) >> 3, k = (d - 4) & 7;
  if (!p.frame_valid[f]) return 1e12f;
  return k < 6 ? 0.f : (k == 6 ? p.a_prior : p.b_prior);
}

__device__ __forceinline__ float state_at(const BaParams& p, int b, int d) {
  return d < 4 ? p.calib_delta[b][d] : p.delta[b][d - 4];
}

// (i, j) of entry e of an n x n upper triangle, row-major
__device__ __forceinline__ void upper_ij(int e, int n, int& i, int& j) {
  i = 0;
  while (e >= n - i) {
    e -= n - i;
    ++i;
  }
  j = i + e;
}

// index of tile (I, J), I <= J, of an n x n upper triangle of tiles
__device__ __forceinline__ int tile_index(int I, int J, int n) {
  return I * n - I * (I - 1) / 2 + (J - I);
}

// ---------------------------------------------------------------------------
// K9, first launch: one block per (chunk, target t, host s)
// ---------------------------------------------------------------------------

// where entry e (< kHB) of a block sits in a group's tiles (kTileFloats)
__device__ __forceinline__ int tile_slot(int e) {
  if (e >= kHU) {
    const int i = e - kHU;
    return 15 * 16 + (i >> 2) * 4 + (i & 3);
  }
  int i, j;
  upper_ij(e, 20, i, j);
  return tile_index(i >> 2, j >> 2, 5) * 16 + (i & 3) * 4 + (j & 3);
}

// a pixel's point inputs (point idx of a host's list, below hi, pattern
// pixel k, target t)
struct PixelIn {
  int pt;
  float u, v, idepth, idepth_zero, color, weight;
  bool valid, res_good;
};

__device__ __forceinline__ PixelIn fetch_pixel(const BaParams& p, int b, int idx, int hi, int k,
                                               int t) {
  PixelIn in{};
  if (idx < hi) {
    const int pt = p.host_pts[idx];
    in.pt = pt;
    in.u = p.p_u[pt];
    in.v = p.p_v[pt];
    in.idepth = p.idepth[b][pt];
    in.idepth_zero = p.p_idepth_zero[pt];
    in.color = p.p_color[8 * pt + k];
    in.weight = p.p_weight[8 * pt + k];
    in.valid = p.p_valid[pt] != 0;
    in.res_good = p.p_res_good[static_cast<size_t>(pt) * p.W + t] != 0;
  }
  return in;
}

// the non-finite bits of a pixel: J0..J19, the residual (bit 20), Jd (21)
constexpr int kBitR = 20, kBitJd = 21;

// A 256-thread group's barrier: the whole block of a queued launch, or one
// half of the resident launch's 512-thread block (named barrier `bar`).
__device__ __forceinline__ void group_sync(int bar) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(kLinThreads) : "memory");
}

// K9's pixel pass's shared memory, one per 256-thread group
struct __align__(16) PixSmem {
  float rows[kLinThreads][kRow];         // the compacted rows (first: 16-byte aligned)
  float acc[kGroups][kTileFloats];
  float out[kHE];                        // this chunk's partial
  float tc[12], tz[12], par[4], cal[12], pose[2][12];
  unsigned nf[kMaxSlots];                // poses not finite, by slot
  float red[kLinThreads / 32][2];
  int pt[kRoundPts], cnt[kLinThreads / 32];
  unsigned mask[kLinThreads / 32];
};

// K9's pixel pass of chunk c of host s's points toward target t, from
// state buffer b, by a group of 256 threads (tid its thread): the pairs'
// energies and flags and the (point, target) sums into buffer b and
// pt_part, this chunk's 20x20 block, b, energy and good pairs into sm.out
// (complete behind one more group_sync). timers: the queued launch's
// stamps, or null.
__device__ __forceinline__ void pixel_pass(const BaParams& p, int b, int c, int t, int s,
                                           int tid, PixSmem& sm, int bar,
                                           unsigned long long* timers) {
  const int W = p.W;
  const int lane = tid & 31, warp = tid >> 5;
  const int tbase = ((s * kMaxSlots + t) * kChunks + c) * kLinStamps;
  auto mark = [&](int i) {
    if (timers != nullptr && tid == 0) {
      unsigned long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      timers[tbase + i] = ns;
    }
  };
  mark(0);

  // the set-up, spread over warps: the two current poses, the first
  // estimates' relative pose, the affine terms, the calibration
  if (tid == 0 || tid == 32) {
    const Pose<float> P = current_pose(p, b, tid == 0 ? t : s);
#pragma unroll
    for (int k = 0; k < 12; ++k) sm.pose[tid >> 5][k] = P.m[k];
  } else if (tid == 96) {
    const Pose<float> Z = compose(load_pose<float>(p.T_zero, t),
                                  inverse(load_pose<float>(p.T_zero, s)));
#pragma unroll
    for (int k = 0; k < 12; ++k) sm.tz[k] = Z.m[k];
  } else if (tid == 64) {
    const float a_h = p.aff_zero[2 * s] + p.delta[b][8 * s + 6];
    const float b_h = p.aff_zero[2 * s + 1] + p.delta[b][8 * s + 7];
    const float a_t = p.aff_zero[2 * t] + p.delta[b][8 * t + 6];
    const float b_t = p.aff_zero[2 * t + 1] + p.delta[b][8 * t + 7];
    const float a_th = expf(a_t - a_h) * (p.exposure[t] / clamp_min(p.exposure[s], 1e-9f));
    sm.par[0] = a_th;
    sm.par[1] = b_t - a_th * b_h;
    sm.par[2] = b_h;
    sm.par[3] = nanmax(p.energy_th[s], p.energy_th[t]);
  } else if (tid >= 160 && tid < 160 + W) {
    // whether slot h's current (bit 0) and first-estimate (bit 1) poses
    // are finite: a relative pose toward t is not finite for some host
    // exactly when one of them is not (barring a finite product that
    // overflows, which _host_blocks would see), and the reference's
    // one-hot gather spreads it (times 0) to every host's
    const int h = tid - 160;
    const Pose<float> C = current_pose(p, b, h);
    const Pose<float> Z = load_pose<float>(p.T_zero, h);
    unsigned nf = 0;
#pragma unroll
    for (int k = 0; k < 12; ++k)
      nf |= (isfinite(C.m[k]) ? 0u : 1u) | (isfinite(Z.m[k]) ? 0u : 2u);
    sm.nf[h] = nf;
  } else if (tid >= 128 && tid < 132) {
    const int k = tid - 128;
    const float c0 = p.calib_zero[k], cc = c0 + p.calib_delta[b][k];
    sm.cal[k] = c0;
    sm.cal[4 + k] = cc;
    if (k < 2) {                         // 1 / fx, 1 / fy at zero and current
      sm.cal[8 + k] = 1.f / c0;
      sm.cal[10 + k] = 1.f / cc;
    }
  }
  group_sync(bar);
  if (tid == 0) {
    Pose<float> Pt, Ps;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      Pt.m[k] = sm.pose[0][k];
      Ps.m[k] = sm.pose[1][k];
    }
    const Pose<float> A = compose(Pt, inverse(Ps));
    unsigned nf = 0;
    for (int h = 0; h < W; ++h) nf |= sm.nf[h];
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      sm.tc[k] = (nf & 1u) && isfinite(A.m[k]) ? qnan() : A.m[k];
      if ((nf & 2u) && isfinite(sm.tz[k])) sm.tz[k] = qnan();
    }
  }
  group_sync(bar);
  const float* sTc = sm.tc;
  const float* sTz = sm.tz;
  const float fx0 = sm.cal[0], fy0 = sm.cal[1], cx0 = sm.cal[2], cy0 = sm.cal[3];
  const float fxc = sm.cal[4], fyc = sm.cal[5], cxc = sm.cal[6], cyc = sm.cal[7];
  const float ifx0 = sm.cal[8], ify0 = sm.cal[9], ifxc = sm.cal[10], ifyc = sm.cal[11];
  const float a_th = sm.par[0], b_th = sm.par[1], b_h = sm.par[2], th = sm.par[3];
  const float* img = p.images + static_cast<size_t>(t) * p.Himg * p.Wimg * 3;
  const bool t_ok = p.frame_valid[t] && t != s;
  mark(1);

  // this chunk of host s's points
  const int off0 = p.host_off[s], n_s = p.host_off[s + 1] - off0;
  const int cs = (n_s + kChunks - 1) / kChunks;
  const int lo = off0 + min(c * cs, n_s), hi = off0 + min((c + 1) * cs, n_s);

  // this thread's tile: group g takes rows g, g + kGroups, ...
  const int g = tid / kTiles, tl = tid % kTiles;
  const bool tiler = tid < kGroups * kTiles;
  int I = 0, J = 0;
  if (tl < 15) {
    int e = tl;
    while (e >= 5 - I) {
      e -= 5 - I;
      ++I;
    }
    J = I + e;
  } else {
    I = tl - 15;
  }
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  unsigned blk_nf = 0;                   // warp leader: the masks of its pairs that are not good
  float e_sum = 0.f, n_good = 0.f;       // the 8-lane group's leader: its pairs

  const int q = tid >> 3, k = tid & 7;
  long long spent[3] = {0, 0, 0}, c0 = 0;
  int rounds = 0;
  // a pixel's point inputs, fetched a round ahead
  const float du = p.pat_u[k], dv = p.pat_v[k];
  PixelIn nx = fetch_pixel(p, b, lo + q, hi, k, t);
  for (int r0 = lo; r0 < hi; r0 += kRoundPts) {
    if (timers != nullptr && tid == 0) c0 = cycles();
    ++rounds;
    const int idx = r0 + q;
    const bool live = idx < hi;
    const PixelIn in = nx;
    nx = fetch_pixel(p, b, idx + kRoundPts, hi, k, t);
    const int pt = in.pt;
    float J20[20], w = 0.f, res = 0.f, Jd = 0.f, pair_e = 0.f;
    int mask = 0, inb = 0, okpix = 0;
    if (live) {
      const float pu = in.u + du, pv = in.v + dv;
      // products with reciprocals where the plain version divides (each
      // within an ulp or two of the quotient)
      const float iid = 1.f / clamp_min(in.idepth, 1e-6f);
      const float iidz = 1.f / clamp_min(in.idepth_zero, 1e-6f);
      const float xh_x = (pu - cx0) * ifx0, xh_y = (pv - cy0) * ify0;
      const float Xc[3] = {(pu - cxc) * ifxc * iid, (pv - cyc) * ifyc * iid, iid};
      const float Xz[3] = {xh_x * iidz, xh_y * iidz, iidz};
      float pc[3], pz[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pc[i] = sTc[4 * i] * Xc[0] + sTc[4 * i + 1] * Xc[1] + sTc[4 * i + 2] * Xc[2] +
                sTc[4 * i + 3];
        pz[i] = sTz[4 * i] * Xz[0] + sTz[4 * i + 1] * Xz[1] + sTz[4 * i + 2] * Xz[2] +
                sTz[4 * i + 3];
      }
      const float z = pc[2], iz = 1.f / z;
      const float Ku = fxc * (pc[0] * iz) + cxc;
      const float Kv = fyc * (pc[1] * iz) + cyc;
      inb = Ku > 1.1f && Kv > 1.1f && Ku < p.u_hi && Kv < p.v_hi && z > 1e-4f;
      float hit, gx, gy;
      sample3(img, p.Wimg, p.umax, p.vmax, Ku, Kv, hit, gx, gy);
      const float color = in.color, wp = in.weight;
      res = hit - (a_th * color + b_th);
      const float abs_r = fabsf(res);
      const float huber = p.huber;
      const float hw = abs_r < huber ? 1.f : huber / clamp_min(abs_r, 1e-12f);
      mask = t_ok && in.valid && in.res_good;
      okpix = inb && isfinite(hit) && mask;
      const float pix_e = hw * res * res * (2.f - hw) * wp * wp;
      pair_e = okpix ? pix_e : 0.f;
      w = hw * wp * wp;                  // masked below, once the pair's sums are in

      // Jacobians at the first estimate
      const float iz0 = 1.f / clamp_min(pz[2], 1e-6f);
      const float un0 = pz[0] * iz0, vn0 = pz[1] * iz0;
      const float gxf = gx * fx0, gyf = gy * fy0;
      const float Jt[6] = {iz0 * gxf, iz0 * gyf, -iz0 * (un0 * gxf + vn0 * gyf),
                           -(un0 * vn0 * gxf + (1.f + vn0 * vn0) * gyf),
                           un0 * vn0 * gyf + (1.f + un0 * un0) * gxf, un0 * gyf - vn0 * gxf};
      // G = [I | -hat(X)], RG = R G, Jh = -(dr/dpt . RG)
      const float G[3][6] = {{1.f, 0.f, 0.f, 0.f, Xz[2], -Xz[1]},
                             {0.f, 1.f, 0.f, -Xz[2], 0.f, Xz[0]},
                             {0.f, 0.f, 1.f, Xz[1], -Xz[0], 0.f}};
#pragma unroll
      for (int l = 0; l < 6; ++l) {
        float sm_ = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float rg = sTz[4 * i] * G[0][l] + sTz[4 * i + 1] * G[1][l] +
                           sTz[4 * i + 2] * G[2][l];
          sm_ = i == 0 ? Jt[0] * rg : sm_ + Jt[i] * rg;
        }
        J20[4 + l] = -sm_;
      }
      float dd[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) dd[i] = -(pz[i] - sTz[4 * i + 3]) * iidz;
      Jd = Jt[0] * dd[0] + Jt[1] * dd[1] + Jt[2] * dd[2];
      const float ffx = xh_x * ifx0 * iidz, ffy = xh_y * ify0 * iidz;
      const float fcx = ifx0 * iidz, fcy = ify0 * iidz;
      float sfx = 0.f, sfy = 0.f, scx = 0.f, scy = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        sfx += Jt[i] * -(sTz[4 * i] * ffx);
        sfy += Jt[i] * -(sTz[4 * i + 1] * ffy);
        scx += Jt[i] * -(sTz[4 * i] * fcx);
        scy += Jt[i] * -(sTz[4 * i + 1] * fcy);
      }
      J20[0] = gx * un0 + sfx;
      J20[1] = gy * vn0 + sfy;
      J20[2] = gx + scx;
      J20[3] = gy + scy;
      const float cmb = color - b_h;
      J20[10] = a_th * cmb;
      J20[11] = a_th;
#pragma unroll
      for (int l = 0; l < 6; ++l) J20[12 + l] = Jt[l];
      J20[18] = -a_th * cmb;
      J20[19] = -1.f;
    } else {
#pragma unroll
      for (int i = 0; i < 20; ++i) J20[i] = 0.f;
    }
    // the pair's sums over its 8 pixels (lanes k of one 8-lane group)
    int all_in = inb || !mask;
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      pair_e += __shfl_xor_sync(kFull, pair_e, off);
      all_in &= __shfl_xor_sync(kFull, all_in, off);
    }
    const bool good = live && mask && all_in && pair_e < th;
    w = (good && okpix) ? w : 0.f;
    if (live && k == 0) {
      const size_t pw = static_cast<size_t>(pt) * W + t;
      p.pair_energy[b][pw] = pair_e;
      p.pair_good[b][pw] = good;
      p.pair_in[b][pw] = mask && all_in;
      e_sum += good ? pair_e : (mask ? th : 0.f);
      n_good += good ? 1.f : 0.f;
    }
    // a pair that is not good adds J * 0: its non-finite bits
    unsigned nf = 0;
    if (live && !good) {
#pragma unroll
      for (int i = 0; i < 20; ++i) nf |= isfinite(J20[i]) ? 0u : (1u << i);
      nf |= isfinite(res) ? 0u : (1u << kBitR);
      nf |= isfinite(Jd) ? 0u : (1u << kBitJd);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) nf |= __shfl_xor_sync(kFull, nf, off);
    if (live && !good && k < 3) {
      // its G20 | Hdd | bd: (J_i w) Jd, (w Jd) Jd, (w Jd) r with w = 0
      float* dst = p.pt_part + (static_cast<size_t>(pt) * W + t) * kG;
      for (int cc = k; cc < kG; cc += 3) {
        const unsigned bits = cc < 20 ? (1u << cc) | (1u << kBitJd)
                                      : (cc == 20 ? (1u << kBitJd)
                                                  : (1u << kBitJd) | (1u << kBitR));
        dst[cc] = (nf & bits) ? qnan() : 0.f;
      }
    }
    blk_nf |= __reduce_or_sync(kFull, nf);

    long long c1 = 0;
    if (timers != nullptr && tid == 0) c1 = cycles();
    // the good pairs' rows, compacted in point order
    const unsigned bal = __ballot_sync(kFull, good);
    if (lane == 0) sm.cnt[warp] = __popc(bal) >> 3;
    group_sync(bar);
    int before = 0, total = 0;
#pragma unroll
    for (int v = 0; v < kLinThreads / 32; ++v) {
      before += v < warp ? sm.cnt[v] : 0;
      total += sm.cnt[v];
    }
    if (good) {
      const int slot = before + (__popc(bal & ((1u << lane) - 1u)) >> 3);
      float4* row = reinterpret_cast<float4*>(sm.rows[slot * 8 + k]);
#pragma unroll
      for (int i = 0; i < 5; ++i)
        row[i] = make_float4(J20[4 * i], J20[4 * i + 1], J20[4 * i + 2], J20[4 * i + 3]);
      row[5] = make_float4(res, w, Jd, 0.f);
      if (k == 0) sm.pt[slot] = pt;
    }
    group_sync(bar);
    long long c2 = 0;
    if (timers != nullptr && tid == 0) c2 = cycles();
    // per good pair: G20 = sum_k (J w) Jd, Hdd = sum_k (w Jd) Jd, bd = sum_k (w Jd) r
    for (int e = tid; e < total * kG; e += kLinThreads) {
      const int sl = e / kG, cc = e % kG;
      float v = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float* px = sm.rows[sl * 8 + kk];
        const float f = cc < 20 ? px[cc] * px[21] : px[21] * px[22];
        v += f * (cc < 21 ? px[22] : px[20]);
      }
      p.pt_part[(static_cast<size_t>(sm.pt[sl]) * W + t) * kG + cc] = v;
    }
    // the products: tile (I, J) of (J w) J^T, or b tile I of (J w) r
    if (tiler) {
      const int nrows = total * 8;
#pragma unroll 4
      for (int r = g; r < nrows; r += kGroups) {
        const float4* row = reinterpret_cast<const float4*>(sm.rows[r]);
        const float4 tail = row[5];
        const float4 a = row[I];
        const float av[4] = {a.x * tail.y, a.y * tail.y, a.z * tail.y, a.w * tail.y};
        if (tl < 15) {
          const float4 bq = row[J];
          const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[4 * i + j] += av[i] * bv[j];
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i] += av[i] * tail.x;
        }
      }
    }
    group_sync(bar);
    if (timers != nullptr && tid == 0) {
      const long long c3 = cycles();
      spent[0] += c1 - c0;
      spent[1] += c2 - c1;
      spent[2] += c3 - c2;
    }
  }

  mark(2);
  // the groups' tiles summed in group order, then the masks of the pairs
  // that are not good
  if (tiler) {
    float* dst = sm.acc[g] + (tl < 15 ? tl * 16 : 240 + (tl - 15) * 4);
    const int n = tl < 15 ? 16 : 4;
    for (int i = 0; i < n; ++i) dst[i] = acc[i];
  }
  if (lane == 0) sm.mask[warp] = blk_nf;
  group_sync(bar);
  unsigned nf_all = 0;
#pragma unroll
  for (int v = 0; v < kLinThreads / 32; ++v) nf_all |= sm.mask[v];
  for (int e = tid; e < kHB; e += kLinThreads) {
    const int slot = tile_slot(e);
    float v = 0.f;
    for (int gg = 0; gg < kGroups; ++gg) v += sm.acc[gg][slot];
    int i, j;
    if (e < kHU) upper_ij(e, 20, i, j);
    else {
      i = e - kHU;
      j = kBitR;
    }
    sm.out[e] = (nf_all & ((1u << i) | (1u << j))) ? v + qnan() : v;
  }
  // the energy and the good pairs: warp shuffles, then the warps in order
  // (common.cuh's block_sum over the group)
  const float es[2] = {e_sum, n_good};
#pragma unroll
  for (int kq = 0; kq < 2; ++kq) {
    float sv = es[kq];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sv += __shfl_down_sync(kFull, sv, off);
    if (lane == 0) sm.red[warp][kq] = sv;
  }
  group_sync(bar);
  if (tid < 2) {
    float sv = 0.f;
    for (int v = 0; v < kLinThreads / 32; ++v) sv += sm.red[v][tid];
    sm.out[kHB + tid] = sv;
  }
  if (timers != nullptr && tid == 0) {
    for (int i = 0; i < 3; ++i) timers[tbase + 4 + i] = spent[i];
    timers[tbase + 7] = rounds;
  }
}

// The chunks' partials of a (host s, target t) block in rank order (part(r)
// the rank's kHE floats), its entry e: 0 + p_0 + ... + p_7
template <class Part>
__device__ __forceinline__ float chunk_sum(Part part, int e) {
  float v8[kChunks];
#pragma unroll
  for (int r = 0; r < kChunks; ++r) v8[r] = part(r)[e];
  float v = 0.f;
#pragma unroll
  for (int r = 0; r < kChunks; ++r) v += v8[r];
  return v;
}

__global__ void __cluster_dims__(kChunks, 1, 1) __launch_bounds__(kLinThreads)
    lin_pair_kernel(const BaParams p, int mode) {
  if (mode != 0 && is_done(p)) return;            // the same for the whole cluster
  const int cur = current(p);
  const int b = mode != 0 ? 1 - cur : cur;
  const int W = p.W;
  const int c = blockIdx.x, t = blockIdx.y, s = blockIdx.z, tid = threadIdx.x;
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ PixSmem sm;
  pixel_pass(p, b, c, t, s, tid, sm, 1, p.timers);
  cluster.sync();
  if (c == 0) {
    // the chunks in rank order into the (s, t) block
    float* blk = p.lin_part + (static_cast<size_t>(s) * W + t) * kHE;
    int bad = 0;
    for (int e = tid; e < kHE; e += kLinThreads) {
      const float v = chunk_sum([&](int r) { return cluster.map_shared_rank(sm.out, r); }, e);
      blk[e] = v;
      bad |= e < kHB && !isfinite(v);
    }
    bad = __syncthreads_or(bad);
    if (tid == 0) p.lin_part[static_cast<size_t>(W) * W * kHE + s * W + t] = bad ? 1.f : 0.f;
  }
  cluster.sync();                        // no block leaves while rank 0 reads it
  stamp(p, ((s * kMaxSlots + t) * kChunks + c) * kLinStamps, 3);
}

// the indices of a (host s, target t) block's 20 that column c of the
// D-vector gets: calib c (c < 4), else the frame part's index as host
// (4 + k, when s is its frame) then as target (12 + k, when t is), -1 for
// none; i0 the first
__device__ __forceinline__ void block_indices(int c, int s, int t, int& i0, int& i1) {
  if (c < 4) {
    i0 = c;
    i1 = -1;
    return;
  }
  const int f = (c - 4) >> 3, k = (c - 4) & 7;
  const int h = s == f ? 4 + k : -1, g = t == f ? 12 + k : -1;
  i0 = h >= 0 ? h : g;
  i1 = h >= 0 ? g : -1;
}

// (i, j) of entry e of an n x n upper triangle, row-major, in closed form
__device__ __forceinline__ void upper_ij_fast(int e, int n, int& i, int& j) {
  const float m = static_cast<float>(2 * n + 1);
  i = static_cast<int>(0.5f * (m - sqrtf(m * m - 8.f * static_cast<float>(e))));
  i = max(0, min(i, n - 1));
  while (i > 0 && i * n - i * (i - 1) / 2 > e) --i;
  while (i + 1 < n && (i + 1) * n - (i + 1) * i / 2 <= e) ++i;
  j = i + (e - (i * n - i * (i - 1) / 2));
}

// the sum over targets t < W of G[t * kG + c], in t order (loads first)
__device__ __forceinline__ float sum_targets(const float* __restrict__ G, int W, int c) {
  float v[kMaxSlots];
#pragma unroll
  for (int t = 0; t < kMaxSlots; ++t) v[t] = t < W ? G[t * kG + c] : 0.f;
  float acc = v[0];
#pragma unroll
  for (int t = 1; t < kMaxSlots; ++t)
    if (t < W) acc += v[t];
  return acc;
}

// K9's second pass, virtual block vb of sum_blocks + row blocks of 256
// threads (tid its thread; warp-level synchronization only): Hff, bf,
// energy and num_terms from the reduced blocks, eight lanes an entry (host
// s = lane & 7, over the targets t), in the first sum_blocks, then each
// point's Hfd row, Hdd and bd, a warp a point (its sums staged in sG[warp]).
// timers: the queued launch's stamps, or null.
__device__ __forceinline__ void finish_block(const BaParams& p, int b, int vb, int sum_blocks,
                                             int tid, float (*sG)[kMaxSlots * kG],
                                             unsigned long long* timers) {
  const int W = p.W, NP = p.NP, D = 4 + 8 * W;
  const int lane = tid & 31;
  const int fbase = kLinTimerWords + 16 * kStepStamps + 8 + 2 * vb;
  const bool fin_timed = timers != nullptr && vb < kFinStampBlocks;
  auto mark = [&](int i) {
    if (fin_timed && tid == 0) {
      unsigned long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      timers[fbase + i] = ns;
    }
  };
  mark(0);
  if (vb >= sum_blocks) {
    // a warp a point: its W x kG sums staged in shared memory, then its Hfd
    // row, Hdd and bd
    const int w = tid >> 5;
    const int pt = (vb - sum_blocks) * (kFinThreads / 32) + w;
    if (pt >= NP) return;                // the whole warp
    const float* src = p.pt_part + static_cast<size_t>(pt) * W * kG;
    float* G = sG[w];
    for (int i = lane; i < W * kG; i += 32) G[i] = src[i];
    __syncwarp();
    const int host = static_cast<int>(p.p_host[pt]);
    for (int d = lane; d < D; d += 32) {
      float v;
      if (d < 4) {
        v = sum_targets(G, W, d);
      } else {
        const int f = (d - 4) >> 3, k = (d - 4) & 7;
        v = G[f * kG + 12 + k];
        if (f == host) v += sum_targets(G, W, 4 + k);
      }
      p.Hfd[b][static_cast<size_t>(pt) * D + d] = v;
    }
    if (lane == 0) {
      const float hdd = sum_targets(G, W, 20), bd = sum_targets(G, W, 21);
      const float prior = p.p_prior[pt];
      p.Hdd[b][pt] = hdd + prior;
      p.bd[b][pt] = bd + prior * (p.idepth[b][pt] - p.p_idepth_zero[pt]);
    }
    __syncwarp();
    mark(1);
    return;
  }
  // bit t: a block of target t is not finite (the W x W blocks' flags)
  const float* flags = p.lin_part + static_cast<size_t>(W) * W * kHE;
  const unsigned lo_bad = __ballot_sync(kFull, lane < W * W && flags[lane] != 0.f);
  const unsigned hi_bad = __ballot_sync(kFull, lane + 32 < W * W && flags[lane + 32] != 0.f);
  unsigned bad_t = 0;
  for (int i = 0; i < W * W; ++i)
    if (((i < 32 ? lo_bad >> i : hi_bad >> (i - 32)) & 1u) != 0) bad_t |= 1u << (i % W);
  const long long gid = static_cast<long long>(vb) * kFinThreads + tid;
  const int e = static_cast<int>(gid >> 3), s = static_cast<int>(gid & 7);
  const int U = D * (D + 1) / 2;
  float v = 0.f, v2 = 0.f;
  if (s < W && e < U + D) {
    // each target's up to 2 x 2 terms in (t, row index, column index)
    // order, every index a scalar (no local array: the loads stay in flight
    // together)
    int r, c = -1;
    if (e < U) upper_ij_fast(e, D, r, c);
    else r = e - U;
#pragma unroll
    for (int t = 0; t < kMaxSlots; ++t) {
      const bool tv = t < W;             // predicated, no branch: the loads of every t fly together
      int r0, r1, c0 = -1, c1 = -1;
      block_indices(r, s, t, r0, r1);
      if (c >= 0) block_indices(c, s, t, c0, c1);
      const float* blk = p.lin_part + (static_cast<size_t>(s) * W + t) * kHE;
      float q[4];
      int ents[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = m < 2 ? r0 : r1, j = (m & 1) ? c1 : c0;
        const bool ok = tv && i >= 0 && (c < 0 ? m % 2 == 0 : j >= 0);
        const int lo = c < 0 ? i : min(i, j), hi = c < 0 ? i : max(i, j);
        ents[m] = !ok ? -1 : (c < 0 ? kHU + i : lo * 20 - lo * (lo - 1) / 2 + (hi - lo));
        q[m] = ok ? blk[ents[m]] : 0.f;
      }
      if (tv && ((bad_t >> t) & 1u)) {
        // the other hosts' blocks of t times 0 (the one-hot matmul's 0 x NaN)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (ents[m] < 0) continue;
          float z = 0.f;
          for (int h = 0; h < W; ++h)
            if (h != s) z += p.lin_part[(static_cast<size_t>(h) * W + t) * kHE + ents[m]] * 0.f;
          q[m] += z;
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (ents[m] >= 0) v += q[m];
    }
  } else if (s < W && e == U + D) {
    for (int t = 0; t < W; ++t) {
      const float* blk = p.lin_part + (static_cast<size_t>(s) * W + t) * kHE;
      v += blk[kHB];
      v2 += blk[kHB + 1];
    }
  }
  // the hosts' sums in s order
  float tot = 0.f, tot2 = 0.f;
#pragma unroll
  for (int ss = 0; ss < kMaxSlots; ++ss) {
    tot += __shfl_sync(kFull, v, (lane & ~7) + ss);
    tot2 += __shfl_sync(kFull, v2, (lane & ~7) + ss);
  }
  if (s != 0) return;
  if (e < U) {
    int r, c;
    upper_ij_fast(e, D, r, c);
    p.Hff[b][r * D + c] = tot;
    p.Hff[b][c * D + r] = tot;
  } else if (e < U + D) {
    p.bf[b][e - U] = tot;
  } else if (e == U + D) {
    *p.energy[b] = tot;
    *p.num_terms[b] = tot2 * 8.f;
  }
  mark(1);
}

// The energy and the good pairs' count of a linearization, as
// finish_block writes them (the same sums in the same order), by one warp
// (lane l < 8: host l): every block of the resident launch computes them
// itself, so none waits for the block that writes them.
__device__ __forceinline__ void energy_terms(const BaParams& p, int lane, float& energy,
                                            float& num_terms) {
  const int W = p.W, s = lane & 7;
  float v = 0.f, v2 = 0.f;
  if (s < W) {
    for (int t = 0; t < W; ++t) {
      const float* blk = p.lin_part + (static_cast<size_t>(s) * W + t) * kHE;
      v += blk[kHB];
      v2 += blk[kHB + 1];
    }
  }
  float tot = 0.f, tot2 = 0.f;
#pragma unroll
  for (int ss = 0; ss < kMaxSlots; ++ss) {
    tot += __shfl_sync(kFull, v, (lane & ~7) + ss);
    tot2 += __shfl_sync(kFull, v2, (lane & ~7) + ss);
  }
  energy = tot;
  num_terms = tot2 * 8.f;
}

__global__ void __launch_bounds__(kFinThreads) lin_finish_kernel(const BaParams p, int mode,
                                                                 int sum_blocks) {
  if (mode != 0 && is_done(p)) return;
  const int cur = current(p);
  __shared__ float sG[kFinThreads / 32][kMaxSlots * kG];
  finish_block(p, mode != 0 ? 1 - cur : cur, blockIdx.x, sum_blocks, threadIdx.x, sG, p.timers);
}

// ---------------------------------------------------------------------------
// K10: one cluster: the Schur sums, the solve, the back-substitution
// ---------------------------------------------------------------------------

// cp.async of n floats (a multiple of 4, both ends 16-byte aligned) by the
// whole block; cp_wait() completes them
__device__ __forceinline__ void cp_floats(float* dst, const float* src, int n) {
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(base + 16u * i),
                 "l"(src + 4 * i)
                 : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// The pivot search's key of row `row` (0..63) holding v in the column: a
// row already used sorts below every other, a NaN above them, then |v| by
// its bits with the low 6 bits replaced by 63 - row, so that one warp max
// picks the largest |v| and, among values equal but for those bits
// (within 2^-17 relative), the lowest row.
__device__ __forceinline__ unsigned pivot_key(float v, bool used, int row) {
  const unsigned k = used ? 0u : (isnan(v) ? 64u : __float_as_uint(fabsf(v)) + 128u);
  return (k & ~63u) | static_cast<unsigned>(63 - row);
}

// LU with partial pivoting on the n x n system in sys (rows
// [kFreeMax][kSysStride], column kFreeMax the right-hand side; rows n.. are
// identity), by threads 0..63 (warps 0 and 1), a row per thread, shifted
// one column left per step so that column k is always entry 0. Every row
// not yet a pivot keeps a copy of itself (its live columns and its
// right-hand side) in rows[thread]; per step each warp's max key names its
// candidate, which writes its key and reciprocal to hdr[k][warp]; after
// one two-warp barrier (named barrier 1) the larger key's row is pivot k,
// read from its copy by every row not yet a pivot, which subtracts its
// multiple and rewrites its copy. A pivot row's copy is never written
// again: it is U's row k, in place. Then warp 0 back-substitutes a column
// at a time, a lane two of U's rows, x_k broadcast by a shuffle:
// x[k] = xf[k]. (Every division is a product with a correctly rounded
// reciprocal.)
__device__ __forceinline__ void lu_solve(const float* __restrict__ sys, int n,
                                         float* __restrict__ rows,
                                         float2* __restrict__ hdr,
                                         float* __restrict__ xf,
                                         unsigned long long* __restrict__ prof) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float r[kFreeMax];
  const float* src = sys + tid * kSysStride;
#pragma unroll
  for (int j = 0; j < kFreeMax; ++j) r[j] = src[j];
  float rhs = src[kFreeMax];
  float* mine = rows + tid * kSlot;
  float4* mine4 = reinterpret_cast<float4*>(mine);
#pragma unroll
  for (int j = 0; j < kFreeMax / 4; ++j)
    mine4[j] = make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
  mine[kFreeMax] = rhs;
  bool used = false;
  long long cyc[5] = {0, 0, 0, 0, 0}, c0 = 0, c1 = 0;
  const bool timed = prof != nullptr && tid == 0;
  auto lap = [&](int i) {
    if (timed) {
      c1 = cycles();
      cyc[i] += c1 - c0;
      c0 = c1;
    }
  };
  const float4* hdr4 = reinterpret_cast<const float4*>(hdr);
  unsigned wmax = __reduce_max_sync(kFull, pivot_key(r[0], used, tid));
  for (int k = 0; k < n; ++k) {
    if (timed) c0 = cycles();
    const int live = n - k;
    if (tid == 63 - static_cast<int>(wmax & 63u))
      hdr[2 * k + warp] = make_float2(__uint_as_float(wmax), __frcp_rn(r[0]));
    lap(0);
    asm volatile("bar.sync 1, 64;" ::: "memory");
    lap(1);
    const float4 h = hdr4[k];
    const bool w1 = __float_as_uint(h.z) > __float_as_uint(h.x);   // ties: warp 0, the lower rows
    const int prow = 63 - static_cast<int>(__float_as_uint(w1 ? h.z : h.x) & 63u);
    if (tid == prow) used = true;
    const float f = used ? 0.f : r[0] * (w1 ? h.w : h.y);
    lap(2);
    // every column, live or not: no branch between the loads and the
    // products (the entries past the live ones are never read); the next
    // column first, so that the next step's warp max is in flight while
    // the rest of the row is updated and copied
    const float* pv = rows + prow * kSlot;
    const float4* pv4 = reinterpret_cast<const float4*>(pv);
    const float4 q0 = pv4[0];
    r[0] = fmaf(-f, q0.y, r[1]);
    if (k + 1 < n) wmax = __reduce_max_sync(kFull, pivot_key(r[0], used, tid));
    lap(3);
    r[1] = fmaf(-f, q0.z, r[2]);
    r[2] = fmaf(-f, q0.w, r[3]);
#pragma unroll
    for (int j = 1; j < kFreeMax / 4; ++j) {
      const float4 q = pv4[j];
      r[4 * j - 1] = fmaf(-f, q.x, r[4 * j]);
      r[4 * j] = fmaf(-f, q.y, r[4 * j + 1]);
      r[4 * j + 1] = fmaf(-f, q.z, r[4 * j + 2]);
      r[4 * j + 2] = fmaf(-f, q.w, r[4 * j + 3]);
    }
    rhs = fmaf(-f, pv[kFreeMax], rhs);
    if (!used) {
#pragma unroll
      for (int j = 0; j < kFreeMax / 4; ++j)
        if (4 * j < live) mine4[j] = make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
      mine[kFreeMax] = rhs;
    }
    lap(4);
  }
  if (timed)
    for (int i = 0; i < 5; ++i) prof[i] = cyc[i];
  asm volatile("bar.sync 1, 64;" ::: "memory");   // the last copies written
  if (warp != 0) return;
  // back-substitution: lane holds U's rows a = lane and b = lane + 32
  // (and the pivot's reciprocal): x_k = c_k / U_kk as c_k * (1 / U_kk)
  auto urow = [&](int k, float& inv) {
    const float4 hh = hdr4[k];
    const bool up = __float_as_uint(hh.z) > __float_as_uint(hh.x);
    inv = up ? hh.w : hh.y;
    return rows + (63 - static_cast<int>(__float_as_uint(up ? hh.z : hh.x) & 63u)) * kSlot;
  };
  const int a = lane, bq = lane + 32;
  float ia = 0.f, ib = 0.f;
  const float* ua = a < n ? urow(a, ia) : nullptr;
  const float* ub = bq < n ? urow(bq, ib) : nullptr;
  float ca = ua ? ua[kFreeMax] : 0.f, cb = ub ? ub[kFreeMax] : 0.f;
  for (int k = n - 1; k >= 0; --k) {
    const bool lo = k < 32;
    const float own = lo ? ca * ia : cb * ib;
    const float xk = __shfl_sync(kFull, own, k & 31);
    if (a < k) ca = fmaf(-ua[k - a], xk, ca);
    if (bq < k) cb = fmaf(-ub[k - bq], xk, cb);
    if (lane == 0) xf[k] = xk;
  }
  __syncwarp();
}

// How K10's ranks exchange their Schur partials and x: in the queued
// launch, one cluster's distributed shared memory and cluster barriers.
// (kLateSums: Hff and bf are copied by rank 0 only once the partials are
// in, not while it sums its rows.)
struct ClusterExchange {
  static constexpr bool kLateSums = false;
  cg::cluster_group cl;
  __device__ void parts_ready(const float*, int, int) { cl.sync(); }
  __device__ float part(float* sRed, int r, int src) { return cl.map_shared_rank(sRed, r)[src]; }
  __device__ void push_x(float* sX, int R, int D) {
    for (int i = threadIdx.x; i < R * D; i += kStepThreads)
      cl.map_shared_rank(sX, i / D)[i % D] = sX[i % D];
  }
  __device__ void x_ready(float*, const BaParams&, int) { cl.sync(); }
};

// K10 as rank `rank` of R, from buffer cur at lambda lam (smem4: the
// dynamic shared memory, step_smem(cap, D) bytes): the Schur partials of
// this rank's per points, exchanged by ex; rank 0's solve, the
// convergence flag and the candidate's calibration and frame states; then
// the idepth steps of this rank's points and their candidate idepths.
// timers: the queued launch's stamps, or null.
template <class Ex>
__device__ __forceinline__ void step_body(const BaParams& p, int cur, float lam, int rank, int R,
                                          int cap, int per, float4* smem4, Ex& ex,
                                          unsigned long long* timers) {
  const int nxt = 1 - cur;
  const int W = p.W, NP = p.NP, D = 4 + 8 * W, D4 = D / 4, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int capr = (cap + 3) & ~3;
  float* sRows = reinterpret_cast<float*>(smem4);           // [cap][D]
  float* sInv = sRows + static_cast<size_t>(cap) * D;        // [cap]
  float* sIB = sInv + capr;                                  // [cap]
  float* sPart = sIB + capr;                                 // [kSGroups][kSTiles * 16]
  float* sRed = sPart + kPartFloats;                         // [kSchurFloats + 4]
  float* sX = sRed + kSchurFloats + 4;                       // [kMaxD]: x, pushed by rank 0
  float* sHff = sX + kMaxD;                                  // rank 0: Hff, HM, bf, bM
  float* sHM = sHff + D * D;
  float* sbf = sHM + D * D;
  float* sbM = sbf + D;
  __shared__ int sFg[kGroupsMax], sMeta[2];
  __shared__ float sSum[2], sP[kMaxD], sX0[kMaxD], sPrior[kMaxD], sN[kMaxD];
  const int tbase = kLinTimerWords + rank * kStepStamps;
  auto mark = [&](int i) {
    if (timers != nullptr && tid == 0) {
      unsigned long long ns;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      timers[tbase + i] = ns;
    }
  };
  mark(0);
  // this block's points, in chunks of at most cap rows; the first chunk's
  // copy in flight from the start
  const int r_lo = min(rank * per, NP), r_hi = min(r_lo + per, NP);
  if (r_lo < r_hi)
    cp_floats(sRows, p.Hfd[cur] + static_cast<size_t>(r_lo) * D, min(cap, r_hi - r_lo) * D);

  // the anchor (warp 0: the oldest valid frame, the first of equals) and
  // the free float4 groups of a row
  if (warp == 0) {
    const int fid = lane < W && p.frame_valid[lane] ? p.frame_id[lane] : (1 << 30);
    const int best = __reduce_min_sync(kFull, fid);
    const int a = min(__ffs(__ballot_sync(kFull, fid == best)) - 1, W - 1);
    if (lane == 0) {
      int n = 0;
      for (int gi = 0; gi < D4; ++gi)
        if (gi != 1 + 2 * a && gi != 2 + 2 * a) sFg[n++] = gi;
      sMeta[0] = a;
      sMeta[1] = n;
    }
  }
  if (rank == 0) {
    // the system's other terms, in flight during the Schur sums
    if (!Ex::kLateSums) cp_floats(sHff, p.Hff[cur], D * D);
    cp_floats(sHM, p.HM, D * D);
    if (!Ex::kLateSums) cp_floats(sbf, p.bf[cur], D);
    cp_floats(sbM, p.bM, D);
    for (int d = tid; d < D; d += kStepThreads) {
      sP[d] = p.precond[d];
      sX0[d] = state_at(p, cur, d);
      sPrior[d] = prior_at(p, d);
    }
  }
  __syncthreads();
  const int anchor = sMeta[0], ng = sMeta[1], n = 4 * ng;
  const int nT = ng * (ng + 1) / 2;

  // this thread's Schur tile: (I, J) of the upper triangle, or b tile I
  const int g = tid / kSTiles, ti = tid % kSTiles;
  const bool tiler = g < kSGroups && ti < nT + ng;
  int I = 0, J = 0;
  if (ti < nT) {
    int e = ti;
    while (e >= ng - I) {
      e -= ng - I;
      ++I;
    }
    J = I + e;
  } else {
    I = ti - nT;
  }
  const int gI = tiler ? sFg[I] : 0, gJ = tiler && ti < nT ? sFg[J] : 0;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;

  float id_sum = 0.f, id_cnt = 0.f;
  int res_lo = r_lo;
  for (int c0 = r_lo; c0 < r_hi; c0 += cap) {
    const int cnt = min(cap, r_hi - c0);
    res_lo = c0;
    if (c0 > r_lo) cp_floats(sRows, p.Hfd[cur] + static_cast<size_t>(c0) * D, cnt * D);
    for (int i = tid; i < cnt; i += kStepThreads) {
      const int pt = c0 + i;
      const float hdd = p.Hdd[cur][pt];
      const float mult = hdd * (1.f + lam) + 1e-10f;
      const float inv = hdd > 1e-10f ? 1.f / mult : 0.f;
      sInv[i] = inv;
      sIB[i] = inv * p.bd[cur][pt];
      if (p.p_valid[pt]) {
        id_sum += fabsf(p.idepth[cur][pt]);
        id_cnt += 1.f;
      }
    }
    cp_wait();
    __syncthreads();
    mark(8);
    if (tiler) {
#pragma unroll 4
      for (int i = g; i < cnt; i += kSGroups) {
        const float4* row = reinterpret_cast<const float4*>(sRows + static_cast<size_t>(i) * D);
        const float4 a = row[gI];
        const float inv = sInv[i];
        const float av[4] = {a.x * inv, a.y * inv, a.z * inv, a.w * inv};
        if (ti < nT) {
          const float4 bq = row[gJ];
          const float bv[4] = {bq.x, bq.y, bq.z, bq.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[4 * u + v] += av[u] * bv[v];
        } else {
          const float ib = sIB[i];
          const float aw[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[u] += aw[u] * ib;
        }
      }
    }
    __syncthreads();
  }
  if (r_lo >= r_hi) {                    // no rows: the prefetch alone
    cp_wait();
    __syncthreads();
  }
  // the groups' tiles summed in group order: this block's partial
  if (tiler) {
    float* dst = sPart + g * kSTiles * 16 + ti * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[i] = acc[i];
  }
  const float ids[2] = {id_sum, id_cnt};
  block_sum<2, kStepThreads>(ids, sRed + kSchurFloats);
  __syncthreads();
  mark(1);
  const int nS = nT * 16 + ng * 4;
  for (int e = tid; e < nS; e += kStepThreads) {
    const int src = e < nT * 16 ? e : nT * 16 + ((e - nT * 16) >> 2) * 16 + (e & 3);
    float v = 0.f;
    for (int gg = 0; gg < kSGroups; ++gg) v += sPart[gg * kSTiles * 16 + src];
    sRed[e] = v;
  }
  ex.parts_ready(sRed, rank, nS);
  mark(2);

  if (rank == 0) {
    // the ranks' partials in rank order (sPart is free now: the Schur sums
    // then the system)
    float* sSc = sPart;
    float* sys = sPart + kSchurFloats + 4;
    if (Ex::kLateSums) {                 // in flight while the partials are summed
      cp_floats(sHff, p.Hff[cur], D * D);
      cp_floats(sbf, p.bf[cur], D);
    }
    for (int e = tid; e < nS + 2; e += kStepThreads) {
      const int src = e < nS ? e : kSchurFloats + (e - nS);
      float part[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) part[r] = r < R ? ex.part(sRed, r, src) : 0.f;
      float v = 0.f;
#pragma unroll
      for (int r = 0; r < 16; ++r) v += r < R ? part[r] : 0.f;
      if (e < nS) sSc[e] = v;
      else sSum[e - nS] = v;
    }
    if (Ex::kLateSums) cp_wait();
    __syncthreads();
    auto dof = [&](int fi) { return sFg[fi >> 2] * 4 + (fi & 3); };
    auto schur = [&](int fi, int fj) {
      const int a = fi >> 2, bq = fj >> 2;
      return a <= bq ? sSc[tile_index(a, bq, ng) * 16 + (fi & 3) * 4 + (fj & 3)]
                     : sSc[tile_index(bq, a, ng) * 16 + (fj & 3) * 4 + (fi & 3)];
    };
    // the damped, preconditioned system over the free unknowns
    for (int e = tid; e < kFreeMax * kFreeMax; e += kStepThreads) {
      const int i = e / kFreeMax, j = e % kFreeMax;
      float hp;
      if (i < n && j < n) {
        const int di = dof(i), dj = dof(j);
        const float h = sHff[di * D + dj] - schur(i, j) + sHM[di * D + dj] +
                        (i == j ? sPrior[di] : 0.f);
        hp = h * sP[di] * sP[dj];
        if (i == j) hp = hp + lam * hp + 1e-8f;
      } else {
        hp = i == j ? 1.f : 0.f;
      }
      sys[i * kSysStride + j] = hp;
    }
    // the right-hand side: a warp a row, HM x0 from shared memory
    for (int i = warp; i < kFreeMax; i += kStepThreads / 32) {
      if (i >= n) {
        if (lane == 0) sys[i * kSysStride + kFreeMax] = 0.f;
        continue;
      }
      const int di = dof(i);
      float hx = 0.f;
      for (int j = lane; j < D; j += 32) hx += sHM[di * D + j] * sX0[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) hx += __shfl_xor_sync(kFull, hx, off);
      if (lane == 0) {
        const float bsc = sSc[nT * 16 + (i >> 2) * 4 + (i & 3)];
        const float bi = sbf[di] - bsc + sbM[di] + hx + sPrior[di] * sX0[di];
        sys[i * kSysStride + kFreeMax] = -(bi * sP[di]);
      }
    }
    __syncthreads();
    mark(3);
    float* rows = sys + kFreeMax * kSysStride;                    // [kFreeMax][kSlot]
    float2* hdr = reinterpret_cast<float2*>(rows + kFreeMax * kSlot);   // [kFreeMax][2]
    float* xf = rows + kFreeMax * kSlot + 4 * kFreeMax;           // [kFreeMax]
    if (tid < 64) {
      lu_solve(sys, n, rows, hdr, xf,
               timers != nullptr ? timers + kLinTimerWords + 16 * kStepStamps : nullptr);
    } else if (warp == 2) {
      // meanwhile the scale nullspace: the valid frames' translations but
      // the anchor's
      for (int d = lane; d < D; d += 32) {
        const int f = (d - 4) >> 3, k = (d - 4) & 7;
        float v = 0.f;
        if (d >= 4 && k < 3 && p.frame_valid[f] && f != anchor)
          v = current_pose(p, cur, f).m[4 * k + 3];
        sN[d] = v;
      }
    }
    __syncthreads();
    mark(4);
    // x = xp P (the anchor's 0), the nullspace projected out, and DSO's
    // doStepFromBackup convergence test: warp 0
    if (warp == 0) {
      float xs[3], N[3];
      float ntn = 0.f, ntx = 0.f;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int d = lane + 32 * m;
        xs[m] = 0.f;
        N[m] = 0.f;
        if (d < D) {
          const int f = (d - 4) >> 3;
          const bool is_anchor = d >= 4 && f == anchor;
          const int fi = d < 4 ? d : (f < anchor ? d : d - 8);
          xs[m] = (is_anchor ? 0.f : xf[fi]) * sP[d];
          N[m] = sN[d];
          ntn += N[m] * N[m];
          ntx += N[m] * xs[m];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ntn += __shfl_xor_sync(kFull, ntn, off);
        ntx += __shfl_xor_sync(kFull, ntx, off);
      }
      const float coef = ntx / (ntn + 1e-6f);
      float sT = 0.f, sR = 0.f, sA = 0.f, sB = 0.f;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int d = lane + 32 * m;
        if (d < D) {
          const float xd = xs[m] - N[m] * coef;
          sX[d] = xd;
          p.x[d] = xd;
          if (d < 4) {
            p.calib_delta[nxt][d] = sX0[d] + xd;
          } else {
            p.delta[nxt][d - 4] = sX0[d] + xd;
            const int f = (d - 4) >> 3, k = (d - 4) & 7;
            const float msk = p.frame_valid[f] ? 1.f : 0.f;
            const float sq = msk * (xd * xd);
            if (k < 3) sT += sq;
            else if (k < 6) sR += sq;
            else if (k == 6) sA += sq;
            else sB += sq;
          }
        }
      }
      float nf = lane < W && p.frame_valid[lane] ? 1.f : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sT += __shfl_xor_sync(kFull, sT, off);
        sR += __shfl_xor_sync(kFull, sR, off);
        sA += __shfl_xor_sync(kFull, sA, off);
        sB += __shfl_xor_sync(kFull, sB, off);
        nf += __shfl_xor_sync(kFull, nf, off);
      }
      if (lane == 0) {
        nf = fmaxf(nf, 1.f);
        const float nid = fmaxf(sSum[1], 1.f);
        const float sum_nid = sSum[0] / nid;
        const bool conv = sqrtf(sA / nf) < p.th_a && sqrtf(sB / nf) < p.th_b &&
                          sqrtf(sR / nf) < p.th_r && sqrtf(sT / nf) * sum_nid < p.th_t;
        p.ctrl_i[2] = conv ? 1 : 0;
      }
    }
    __syncthreads();
    // x into every block's shared memory
    ex.push_x(sX, R, D);
    mark(5);
  }
  ex.x_ready(sX, p, D);
  mark(6);

  // the idepth steps x_d = inv_Hdd (-bd - Hfd x), 8 lanes a point, from the
  // rows this block holds, and the candidate state (buffer 1 - cur)
  const float4* x4 = reinterpret_cast<const float4*>(sX);
  const int l8 = tid & 7;
  for (int base = r_lo; base < r_hi; base += kStepThreads / 8) {
    const int pt = base + (tid >> 3);
    const bool live = pt < r_hi;
    float sdot = 0.f;
    if (live) {
      const float* row = pt >= res_lo ? sRows + static_cast<size_t>(pt - res_lo) * D
                                      : p.Hfd[cur] + static_cast<size_t>(pt) * D;
      const float4* row4 = reinterpret_cast<const float4*>(row);
      for (int gi = l8; gi < D4; gi += 8) {
        const float4 h = row4[gi], xv = x4[gi];
        sdot += h.x * xv.x + h.y * xv.y + h.z * xv.z + h.w * xv.w;
      }
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) sdot += __shfl_xor_sync(kFull, sdot, off);
    if (live && l8 == 0) {
      const float hdd = p.Hdd[cur][pt];
      const float inv = hdd > 1e-10f ? 1.f / (hdd * (1.f + lam) + 1e-10f) : 0.f;
      const float xd = inv * (-p.bd[cur][pt] - sdot);
      p.x_d[pt] = xd;
      const float id = p.idepth[cur][pt];
      p.idepth[nxt][pt] = p.p_valid[pt] ? id + xd : id;
    }
  }
  mark(7);
}

__global__ void __launch_bounds__(kStepThreads, 1) step_kernel(const BaParams p, int cap,
                                                              int per) {
  if (is_done(p)) return;                // the same for the whole cluster
  extern __shared__ float4 smem4[];
  ClusterExchange ex{cg::this_cluster()};
  step_body(p, current(p), p.ctrl_f[0], static_cast<int>(ex.cl.block_rank()),
            static_cast<int>(ex.cl.num_blocks()), cap, per, smem4, ex, p.timers);
}

// ---------------------------------------------------------------------------
// K11: total energy of a state and its linearization; accept / reject
// ---------------------------------------------------------------------------

// The LM loop's control: ctrl_i = {cur, done, conv, rounds}, ctrl_f =
// {lam, e_old}; num: the current linearization's good pairs x 8.
struct LmCtrl {
  int cur, done, conv, rounds;
  float lam, e_old, num;
};

// The prior part of state buffer sb's total energy, x . (HM x + 2 bM +
// prior x), by a block of nthreads (every thread calls it): each row's
// product in column order, the entries summed in index order by thread 0,
// which returns it.
__device__ __forceinline__ float prior_energy(const BaParams& p, int sb, float* sx, float* sv,
                                              int nthreads) {
  const int D = 4 + 8 * p.W, tid = threadIdx.x;
  for (int d = tid; d < D; d += nthreads) sx[d] = state_at(p, sb, d);
  __syncthreads();
  for (int i = tid; i < D; i += nthreads) {
    float hx = 0.f;
    for (int j = 0; j < D; ++j) hx += p.HM[i * D + j] * sx[j];
    sv[i] = sx[i] * (hx + 2.f * p.bM[i] + prior_at(p, i) * sx[i]);
  }
  __syncthreads();
  float dot = 0.f;
  if (tid == 0)
    for (int d = 0; d < D; ++d) dot += sv[d];
  return dot;
}

// The accept / reject of iteration it's candidate (buffer 1 - cur) of
// total energy e and num_sb good pairs x 8 (c.conv: its step's
// convergence flag)
__device__ __forceinline__ void lm_accept(const BaParams& p, LmCtrl& c, int it, float e,
                                          float num_sb) {
  const int sb = 1 - c.cur;
  float lam = c.lam;
  if (p.force_accept) {
    if (!c.conv || it < p.min_opt_iterations) c.cur = sb;
    lam = lam * 0.25f;
  } else {
    const bool accept = e < c.e_old && num_sb >= 0.3f * c.num;
    if (accept) {
      c.cur = sb;
      c.e_old = e;
    }
    lam = accept ? lam * 0.25f : fminf(lam * 100.f, 1e4f);
  }
  if (c.cur == sb) c.num = num_sb;
  c.lam = lam;
  c.done = (c.conv && it + 1 >= p.min_opt_iterations) ? 1 : 0;
  c.rounds = it + 1;
}

__global__ void __launch_bounds__(kAcceptThreads) accept_kernel(const BaParams p, int it) {
  if (it >= 0 && is_done(p)) return;
  const int cur = current(p);
  const int sb = it < 0 ? cur : 1 - cur;
  __shared__ float sx[kMaxD], sv[kMaxD];
  const float dot = prior_energy(p, sb, sx, sv, kAcceptThreads);
  if (threadIdx.x != 0) return;
  const float e = *p.energy[sb] + dot;
  if (it < 0) {
    p.ctrl_f[0] = 0.1f;
    p.ctrl_f[1] = e;
    p.ctrl_i[1] = 0;
    p.ctrl_i[2] = 0;
    p.ctrl_i[3] = 0;
    return;
  }
  LmCtrl c{cur, 0, p.ctrl_i[2], 0, p.ctrl_f[0], p.ctrl_f[1], *p.num_terms[cur]};
  lm_accept(p, c, it, e, *p.num_terms[sb]);
  p.ctrl_i[0] = c.cur;
  p.ctrl_i[1] = c.done;
  p.ctrl_i[3] = c.rounds;
  p.ctrl_f[0] = c.lam;
  p.ctrl_f[1] = c.e_old;
}

// ---------------------------------------------------------------------------
// The resident launch: optimize_keyframe's whole LM loop (K9, K11's start,
// rounds of K10 -> K9 -> K11) and _finish_optimize's bookkeeping
// ---------------------------------------------------------------------------

// Block 0's thread 0 adds the %globaltimer ns it spends in each phase,
// and waiting at the grid barriers, over the launch (kOptStamps words of
// the timers from kOptBase; null: nothing).
struct OptStamps {
  unsigned long long* t;
  unsigned long long last;
  __device__ static unsigned long long now() {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    return ns;
  }
  __device__ explicit OptStamps(unsigned long long* timers)
      : t(timers != nullptr && blockIdx.x == 0 && threadIdx.x == 0 ? timers + kOptBase
                                                                   : nullptr),
        last(t ? now() : 0) {}
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
    mark(kOptBarrier);
    if (t) t[kOptBarriers] += 1;
  }
};

// How K10's ranks exchange their Schur partials and x in the resident
// launch: global scratch (in L2) behind grid barriers; rank 0 sums the
// partials in rank order as the cluster does. Hff and bf are read only
// after the first barrier: the blocks that assemble them run beside the
// ranks' Schur sums.
struct GridExchange {
  static constexpr bool kLateSums = true;
  cg::grid_group& grid;
  OptStamps& st;
  float* gpart;
  __device__ void parts_ready(const float* sRed, int rank, int nS) {
    for (int e = threadIdx.x; e < nS + 2; e += kStepThreads) {
      const int src = e < nS ? e : kSchurFloats + (e - nS);
      gpart[rank * kPartStride + src] = sRed[src];
    }
    st.sync(grid, kOptSchur);
  }
  __device__ float part(float*, int r, int src) { return gpart[r * kPartStride + src]; }
  __device__ void push_x(float*, int, int) {}
  __device__ void x_ready(float* sX, const BaParams& p, int D) {
    st.sync(grid, kOptSolve);
    for (int d = threadIdx.x; d < D; d += kStepThreads) sX[d] = p.x[d];
    __syncthreads();
  }
  // a block that holds no rank: the same barriers
  __device__ void idle() {
    st.sync(grid, kOptSchur);
    st.sync(grid, kOptSolve);
  }
};

__device__ __forceinline__ void copy_floats(float* dst, const float* src, long long n,
                                            long long i0, long long step) {
  for (long long i = i0; i < n; i += step) dst[i] = src[i];
}

// RES_* (models/ba.py) of point pt's pair toward target t in the accepted
// linearization (buffer cur), where it took part
__device__ __forceinline__ int pair_state(const BaParams& p, int cur, int pt, int t) {
  const size_t pw = static_cast<size_t>(pt) * p.W + t;
  return p.pair_good[cur][pw] ? 0 : (p.pair_in[cur][pw] ? 2 : 1);
}

__device__ __forceinline__ bool participated(const BaParams& p, int pt, int t) {
  return p.p_valid[pt] && p.frame_valid[t] && t != p.p_host[pt] &&
         p.p_res_good[static_cast<size_t>(pt) * p.W + t];
}

// The resident launch's heavy phases, each a call of its own (not
// inlined): the kernel's values live across the LM loop are saved around
// the call instead of crowding the phase's registers (the LU's row, the
// pixel pass's tiles). Their shared memory is the kernel's dynamic array,
// named here so that every access stays a shared-memory one.
__device__ __noinline__ void resident_pixel(const BaParams& p, int b, int item, int half,
                                            int htid) {
  extern __shared__ float4 dyn4[];
  PixSmem& sm = reinterpret_cast<PixSmem*>(dyn4)[half];
  const int W = p.W;
  const int c = item % kChunks, t = (item / kChunks) % W, s = item / (kChunks * W);
  pixel_pass(p, b, c, t, s, htid, sm, 2 + half, nullptr);
  group_sync(2 + half);
  float* dst = p.chunk_part + static_cast<size_t>(item) * kHE;
  for (int i = htid; i < kHE; i += kLinThreads) dst[i] = sm.out[i];
}

__device__ __noinline__ void resident_step(const BaParams& p, int cur, float lam, int R, int cap,
                                           int per, GridExchange& ex) {
  extern __shared__ float4 dyn4[];
  if (static_cast<int>(blockIdx.x) < R)
    step_body(p, cur, lam, blockIdx.x, R, cap, per, dyn4, ex, p.timers);
  else
    ex.idle();
}

// One cooperative launch of kStepThreads-thread blocks, one an SM, every
// block resident: the linearization's pixel pass in two 256-thread halves
// a block (work items (chunk, target, host)), the chunks' partials and
// the points' rows, the assembly's sums (left to run beside K10's Schur
// sums), K10 as ranks 0 .. R - 1 (the queued plan's R, cap, per), and
// K11 in every block from the same sums (the same decision bits
// everywhere: every block leaves the loop at once). Barriers: 2 for the
// first linearization, 5 an iteration (Schur partials, x, the candidate,
// the pixel pass, the chunks' sums), 1 before the bookkeeping.
__global__ void __launch_bounds__(kStepThreads, 1)
    optimize_kernel(const __grid_constant__ BaParams p, int iterations, int R, int cap,
                    int per) {
  extern __shared__ float4 smem4[];
  __shared__ float sx[kMaxD], sv[kMaxD];
  __shared__ LmCtrl sCtrl;
  __shared__ int sOrder[kMaxSlots];
  cg::grid_group grid = cg::this_grid();
  OptStamps st(p.timers);
  const unsigned long long t0 = st.last;
  GridExchange ex{grid, st, p.schur_part};
  const int W = p.W, NP = p.NP, D = 4 + 8 * W, tid = threadIdx.x;
  const int half = tid >> 8, htid = tid & (kLinThreads - 1), lane = tid & 31, warp = tid >> 5;
  const int nblk = gridDim.x;
  const long long gtid = static_cast<long long>(blockIdx.x) * kStepThreads + tid;
  const long long gthreads = static_cast<long long>(nblk) * kStepThreads;
  float (*sG)[kMaxSlots * kG] =
      reinterpret_cast<float (*)[kMaxSlots * kG]>(smem4) + half * (kFinThreads / 32);
  const int U = D * (D + 1) / 2;
  const int sum_blocks = ((U + D + 1) * kMaxSlots + kFinThreads - 1) / kFinThreads;
  const int row_blocks = (NP + kFinThreads / 32 - 1) / (kFinThreads / 32);
  const int items = kChunks * W * W;
  if (tid == 0) {
    // the hosts by their points, most first (the first of equals first)
    for (int s = 0; s < W; ++s) sOrder[s] = s;
    for (int a = 0; a < W; ++a)
      for (int b2 = a + 1; b2 < W; ++b2) {
        const int na = p.host_off[sOrder[a] + 1] - p.host_off[sOrder[a]];
        const int nb = p.host_off[sOrder[b2] + 1] - p.host_off[sOrder[b2]];
        if (nb > na || (nb == na && sOrder[b2] < sOrder[a])) {
          const int tmp = sOrder[a];
          sOrder[a] = sOrder[b2];
          sOrder[b2] = tmp;
        }
      }
  }
  __syncthreads();

  // the prior part of the energy of the state being linearized: one block
  // that holds no rank forms it where it waits (prior_energy's order) and
  // leaves it behind a barrier
  float* prior_dot = p.schur_part + kMaxRanks * kPartStride;
  const bool dot_block = static_cast<int>(blockIdx.x) == R % nblk;
  auto prior = [&](int b) {
    const float dot = prior_energy(p, b, sx, sv, kStepThreads);
    if (tid == 0) *prior_dot = dot;
  };

  // K9 of state buffer b into linearization b; returns (thread 0) its
  // total energy (the prior part from prior_dot) and good pairs x 8. The
  // assembly's sums are left running (read after the next barrier).
  auto linearize = [&](int b, float& e, float& num) {
    // the items heaviest host first, dealt to the halves in a snake (round
    // r: the halves in order, then in reverse), so that a half with a heavy
    // item gets a light one next
    const int halves = 2 * nblk, h = 2 * blockIdx.x + half;
    for (int r = 0; r * halves < items; ++r) {
      const int k = r * halves + ((r & 1) ? halves - 1 - h : h);
      if (k >= items) continue;
      const int s = sOrder[k / (kChunks * W)], rest = k % (kChunks * W);
      resident_pixel(p, b, s * kChunks * W + rest, half, htid);
    }
    st.sync(grid, kOptPixel);
    // the chunks in rank order into the (s, t) blocks (a block a block,
    // an entry a thread, as the queued cluster's rank 0)
    for (int st_ = blockIdx.x; st_ < W * W; st_ += nblk) {
      const float* part = p.chunk_part + static_cast<size_t>(st_) * kChunks * kHE;
      int bad = 0;
      if (tid < kHE) {
        const float v = chunk_sum([&](int r) { return part + r * kHE; }, tid);
        p.lin_part[static_cast<size_t>(st_) * kHE + tid] = v;
        bad = tid < kHB && !isfinite(v);
      }
      bad = __syncthreads_or(bad);
      if (tid == 0) p.lin_part[static_cast<size_t>(W) * W * kHE + st_] = bad ? 1.f : 0.f;
    }
    // the points' Hfd rows, Hdd and bd
    for (int rb = 2 * blockIdx.x + half; rb < row_blocks; rb += 2 * nblk)
      finish_block(p, b, sum_blocks + rb, sum_blocks, htid, sG, nullptr);
    st.sync(grid, kOptReduce);
    if (warp == 0) {
      float en, nt;
      energy_terms(p, lane, en, nt);
      e = en + *prior_dot;
      num = nt;
    }
    // Hff, bf, energy, num_terms: from block R on, so that the ranks start
    // their Schur sums first
    const int first = (blockIdx.x + nblk - R % nblk) % nblk;
    for (int vb = 2 * first + half; vb < sum_blocks; vb += 2 * nblk)
      finish_block(p, b, vb, sum_blocks, htid, sG, nullptr);
    st.mark(kOptFinish);
  };

  float e = 0.f, num = 0.f;
  if (dot_block) prior(0);
  linearize(0, e, num);
  if (tid == 0) sCtrl = LmCtrl{0, 0, 0, 0, 0.1f, e, num};
  __syncthreads();
  LmCtrl c = sCtrl;
  for (int it = 0; it < iterations && !c.done; ++it) {
    resident_step(p, c.cur, c.lam, R, cap, per, ex);
    if (dot_block) prior(1 - c.cur);     // the candidate's calibration and frames are in
    st.sync(grid, kOptBacksub);
    linearize(1 - c.cur, e, num);
    if (tid == 0) {
      c.conv = p.ctrl_i[2];
      lm_accept(p, c, it, e, num);
      sCtrl = c;
    }
    __syncthreads();
    c = sCtrl;
  }
  st.sync(grid, kOptFinish);             // the last assembly's sums are in

  // the accepted buffer into buffer 2, and the bookkeeping
  const int cur = c.cur;
  copy_floats(p.calib_delta[2], p.calib_delta[cur], 4, gtid, gthreads);
  copy_floats(p.delta[2], p.delta[cur], 8 * W, gtid, gthreads);
  copy_floats(p.idepth[2], p.idepth[cur], NP, gtid, gthreads);
  copy_floats(p.Hff[2], p.Hff[cur], D * D, gtid, gthreads);
  copy_floats(p.bf[2], p.bf[cur], D, gtid, gthreads);
  copy_floats(p.Hfd[2], p.Hfd[cur], static_cast<long long>(NP) * D, gtid, gthreads);
  copy_floats(p.Hdd[2], p.Hdd[cur], NP, gtid, gthreads);
  copy_floats(p.bd[2], p.bd[cur], NP, gtid, gthreads);
  copy_floats(p.energy[2], p.energy[cur], 1, gtid, gthreads);
  copy_floats(p.num_terms[2], p.num_terms[cur], 1, gtid, gthreads);
  copy_floats(p.pair_energy[2], p.pair_energy[cur], static_cast<long long>(NP) * W, gtid,
              gthreads);
  for (long long i = gtid; i < static_cast<long long>(NP) * W; i += gthreads) {
    p.pair_good[2][i] = p.pair_good[cur][i];
    p.pair_in[2][i] = p.pair_in[cur][i];
  }
  // the two newest valid slots (torch.argmax: the first of equals)
  int newest = 0, second = 0, best = -1, best2 = -1;
  for (int f = 0; f < W; ++f) {
    const int fid = p.frame_valid[f] ? p.frame_id[f] : -1;
    if (fid > best) {
      best = fid;
      newest = f;
    }
  }
  for (int f = 0; f < W; ++f) {
    const int fid = f == newest ? -1 : (p.frame_valid[f] ? p.frame_id[f] : -1);
    if (fid > best2) {
      best2 = fid;
      second = f;
    }
  }
  for (long long q = gtid; q < NP; q += gthreads) {
    const int pt = static_cast<int>(q);
    int good = 0;
    for (int t = 0; t < W; ++t) good += p.pair_good[cur][static_cast<size_t>(pt) * W + t];
    p.out_num_good[pt] = p.p_num_good[pt] + static_cast<float>(good);
    p.out_last_res[2 * pt] = participated(p, pt, newest) ? pair_state(p, cur, pt, newest)
                                                         : p.p_last_res[2 * pt];
    p.out_last_res[2 * pt + 1] = best2 >= 0 && participated(p, pt, second)
                                     ? pair_state(p, cur, pt, second)
                                     : p.p_last_res[2 * pt + 1];
  }
  if (blockIdx.x == 0 && tid == 0) {
    const float en = *p.energy[cur];
    *p.out_rmse = sqrtf(en / clamp_min(*p.num_terms[cur], 1.f));
    *p.out_ok = isfinite(en) ? 1 : 0;
    p.ctrl_i[0] = c.cur;
    p.ctrl_i[1] = c.done;
    p.ctrl_i[2] = c.conv;
    p.ctrl_i[3] = c.rounds;
    p.ctrl_f[0] = c.lam;
    p.ctrl_f[1] = c.e_old;
  }
  if (st.t) {
    st.mark(kOptEpilogue);
    st.t[kOptTotal] += OptStamps::now() - t0;
  }
}

bool sizes_ok(const BaParams& p) {
  return p.W >= 1 && p.W <= kMaxSlots && p.NP >= 1;
}

// K10's dynamic shared memory for blocks of at most cap rows
size_t step_smem(int cap, int D) {
  const size_t capr = (static_cast<size_t>(cap) + 3) & ~static_cast<size_t>(3);
  return sizeof(float) * (static_cast<size_t>(cap) * D + 2 * capr + kPartFloats +
                          kSchurFloats + 4 + kMaxD + 2 * D * D + 2 * D);
}

cudaLaunchConfig_t step_config(int R, size_t smem, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(R, 1, 1);
  cfg.blockDim = dim3(kStepThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = R;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// K10's cluster: 16 blocks (a non-portable size) where the card holds such
// a cluster of these blocks, else 8; each block takes per = NP / R points
// (rounded up), at most cap rows at a time. Planned once per device, NP
// and W.
struct StepPlan {
  int device = -1, NP = -1, W = -1, R = 0, cap = 0, per = 0;
  size_t smem = 0;
};

cudaError_t plan_step(const BaParams& p, StepPlan& plan) {
  static StepPlan cached;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (cached.device == device && cached.NP == p.NP && cached.W == p.W) {
    plan = cached;
    return cudaSuccess;
  }
  const int D = 4 + 8 * p.W;
  err = cudaFuncSetAttribute(step_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemLimit));
  if (err != cudaSuccess) return err;
  const int cap_max = static_cast<int>((kSmemLimit - step_smem(0, D)) / sizeof(float) - 6) /
                      (D + 2);
  const int sizes[2] = {16, 8};
  for (const int R : sizes) {
    const int per = (p.NP + R - 1) / R;
    const int cap = per < cap_max ? per : cap_max;
    const size_t smem = step_smem(cap, D);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = step_config(R, smem, nullptr, attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, step_kernel, &cfg);
    if (err != cudaSuccess) {
      cudaGetLastError();                // a refused size is not the launch's error
      continue;
    }
    if (n >= 1) {
      cached.device = device;
      cached.NP = p.NP;
      cached.W = p.W;
      cached.R = R;
      cached.cap = cap;
      cached.per = per;
      cached.smem = smem;
      plan = cached;
      return cudaSuccess;
    }
  }
  return err != cudaSuccess ? err : cudaErrorInvalidConfiguration;
}

// The resident launch's grid (one kStepThreads block an SM, all resident,
// at least K10's R of them) and its dynamic shared memory (the largest of
// K10's, two pixel passes' and two halves' staged point sums), planned
// once per device, NP and W with K10's plan.
struct OptPlan {
  int device = -1, NP = -1, W = -1, grid = 0, per_sm = 0;
  size_t smem = 0;
  StepPlan step;
};

cudaError_t plan_optimize(const BaParams& p, OptPlan& plan) {
  static OptPlan cached;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (cached.device == device && cached.NP == p.NP && cached.W == p.W) {
    plan = cached;
    return cudaSuccess;
  }
  OptPlan o;
  if ((err = plan_step(p, o.step)) != cudaSuccess) return err;
  const size_t pix = 2 * sizeof(PixSmem);
  const size_t fin = sizeof(float) * 2 * (kFinThreads / 32) * kMaxSlots * kG;
  o.smem = o.step.smem;
  if (pix > o.smem) o.smem = pix;
  if (fin > o.smem) o.smem = fin;
  err = cudaFuncSetAttribute(optimize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(o.smem));
  if (err != cudaSuccess) return err;
  int sms = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o.per_sm, optimize_kernel, kStepThreads,
                                                      o.smem);
  if (err != cudaSuccess) return err;
  o.grid = sms * (o.per_sm < 1 ? o.per_sm : 1);
  if (o.grid < o.step.R) return cudaErrorCooperativeLaunchTooLarge;
  o.device = device;
  o.NP = p.NP;
  o.W = p.W;
  cached = o;
  plan = o;
  return cudaSuccess;
}

}  // namespace

// K9: the linearization of state buffer cur (mode 0) or of the candidate
// 1 - cur (mode 1, skipped once done) into the linearization buffer of the
// same index.
DSSLAM_API int dsslam_ba_linearize(const BaParams* p, int mode, cudaStream_t stream) {
  if (!sizes_ok(*p)) return cudaErrorInvalidValue;
  const int D = 4 + 8 * p->W, U = D * (D + 1) / 2;
  const int row_blocks = (p->NP + kFinThreads / 32 - 1) / (kFinThreads / 32);
  const int sum_blocks = ((U + D + 1) * kMaxSlots + kFinThreads - 1) / kFinThreads;
  lin_pair_kernel<<<dim3(kChunks, p->W, p->W), kLinThreads, 0, stream>>>(*p, mode);
  lin_finish_kernel<<<sum_blocks + row_blocks, kFinThreads, 0, stream>>>(*p, mode, sum_blocks);
  return cudaGetLastError();
}

// K10: the LM step from buffer cur (lambda ctrl_f[0]): x [D], x_d [NP], the
// convergence flag, and the candidate state in buffer 1 - cur.
DSSLAM_API int dsslam_ba_step(const BaParams* p, cudaStream_t stream) {
  if (!sizes_ok(*p) || !p->ctrl_i || !p->ctrl_f) return cudaErrorInvalidValue;
  StepPlan plan;
  const cudaError_t err = plan_step(*p, plan);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = step_config(plan.R, plan.smem, stream, attr);
  const cudaError_t lerr = cudaLaunchKernelEx(&cfg, step_kernel, *p, plan.cap, plan.per);
  if (lerr != cudaSuccess) return lerr;
  return cudaGetLastError();
}

// K11: it < 0: lam = 0.1 and e_old = the total energy of buffer cur (the
// loop's start); else accept or reject the candidate of iteration it.
DSSLAM_API int dsslam_ba_accept(const BaParams* p, int it, cudaStream_t stream) {
  if (!sizes_ok(*p) || !p->ctrl_i || !p->ctrl_f) return cudaErrorInvalidValue;
  accept_kernel<<<1, kAcceptThreads, 0, stream>>>(*p, it);
  return cudaGetLastError();
}

// The resident launch: optimize_keyframe's whole LM loop from state
// buffer 0 (K9, K11's start, then up to `iterations` rounds of K10 -> K9 ->
// K11, leaving once done) and _finish_optimize's bookkeeping, in one
// cooperative launch: the accepted state and linearization in buffer 2,
// p_num_good, p_last_res, rmse and ok in the out_* fields, the final
// control in ctrl_i / ctrl_f.
DSSLAM_API int dsslam_ba_optimize(const BaParams* p, int iterations, cudaStream_t stream) {
  if (!sizes_ok(*p) || iterations < 0 || !p->ctrl_i || !p->ctrl_f || !p->chunk_part ||
      !p->schur_part || !p->out_num_good || !p->out_last_res || !p->out_rmse || !p->out_ok)
    return cudaErrorInvalidValue;
  OptPlan plan;
  cudaError_t err = plan_optimize(*p, plan);
  if (err != cudaSuccess) return err;
  int R = plan.step.R, cap = plan.step.cap, per = plan.step.per;
  void* args[] = {const_cast<BaParams*>(p), &iterations, &R, &cap, &per};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(optimize_kernel),
                                    dim3(plan.grid), dim3(kStepThreads), args, plan.smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The resident launch at these sizes: blocks, blocks an SM, registers,
// dynamic shared memory bytes, K10's ranks, local (spill) bytes a thread
// (host calls only).
DSSLAM_API int dsslam_ba_optimize_grid(int W, int NP, int* out) {
  BaParams p{};
  p.W = W;
  p.NP = NP;
  if (!sizes_ok(p)) return cudaErrorInvalidValue;
  OptPlan plan;
  cudaError_t err = plan_optimize(p, plan);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, optimize_kernel)) != cudaSuccess) return err;
  out[0] = plan.grid;
  out[1] = plan.per_sm;
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(plan.smem);
  out[4] = plan.step.R;
  out[5] = static_cast<int>(attr.localSizeBytes);
  return cudaSuccess;
}
