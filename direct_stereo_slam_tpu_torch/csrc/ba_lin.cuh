// K9's device code (csrc/ba.cu's linearization of the windowed BA): the
// parameter block every BA entry point reads, the pixel pass of one
// (chunk, target, host) item, the chunks' rank-order sums and the second
// pass (each point's Hfd row, Hdd and bd; Hff and bf from the reduced
// blocks). ba.cu's kernels (K9-K11 and the resident launch) and
// window.cu's K18 (the marginalization, which runs K9's pair phase over
// the flagged points only) include it; csrc/ba.cu's head comment gives the
// design.
#pragma once

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

// a (host, target) block's not-finite flag: kFlagH for an entry of its H,
// kFlagB for one of its b (0: finite), kept as a float beside the blocks
constexpr int kFlagH = 1, kFlagB = 2;
__device__ __forceinline__ float block_flag(int hbad, int bbad) {
  return static_cast<float>((hbad ? kFlagH : 0) | (bbad ? kFlagB : 0));
}

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

// K9's second pass for one point pt, by one warp (lane its lane): its
// W x kG sums staged in G (shared memory), then its Hfd row, Hdd and bd
// into buffer b
__device__ __forceinline__ void point_row(const BaParams& p, int b, int pt, int lane,
                                          float* G) {
  const int W = p.W, D = 4 + 8 * W;
  const float* src = p.pt_part + static_cast<size_t>(pt) * W * kG;
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
    point_row(p, b, pt, lane, sG[w]);
    mark(1);
    return;
  }
  // bit t: a block of target t is not finite (the W x W blocks' flags)
  const float* flags = p.lin_part + static_cast<size_t>(W) * W * kHE;
  const int f_lo = lane < W * W ? static_cast<int>(flags[lane]) : 0;
  const int f_hi = lane + 32 < W * W ? static_cast<int>(flags[lane + 32]) : 0;
  const unsigned lo_bad = __ballot_sync(kFull, f_lo != 0);
  const unsigned hi_bad = __ballot_sync(kFull, f_hi != 0);
  // the JAX package places the blocks by one einsum with 0/1 matrices, so
  // one non-finite entry of a block's H (b) makes all of Hff (bf) NaN
  const bool h_nan = __any_sync(kFull, ((f_lo | f_hi) & kFlagH) != 0);
  const bool b_nan = __any_sync(kFull, ((f_lo | f_hi) & kFlagB) != 0);
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
    p.Hff[b][r * D + c] = h_nan ? qnan() : tot;
    p.Hff[b][c * D + r] = h_nan ? qnan() : tot;
  } else if (e < U + D) {
    p.bf[b][e - U] = b_nan ? qnan() : tot;
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

}  // namespace
