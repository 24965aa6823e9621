// K9-K11: the windowed photometric BA (models/ba.py) on the card. One
// Levenberg-Marquardt iteration of optimize_keyframe is K10 (the step) ->
// K9 (the linearization at the candidate) -> K11 (accept or reject), all
// queued by the host with no read of the card between them.
//
// They replace the JAX package's jitted windowed BA,
// direct_stereo_slam_tpu/models/ba.py (no Pallas kernel there: XLA
// programs):
//   K9  dsslam_ba_linearize <- :198 linearize
//   K10 dsslam_ba_step      <- :551 solve_step, :594 apply_step,
//                              :602 _step_converged
//   K11 dsslam_ba_accept    <- :645-700, total_energy and the while_loop
//                              body's accept / reject
// The port's plain versions are models/ba.py::linearize_plain, solve_step,
// apply_step, _step_converged and the loop of _optimize_plain.
//
// What bounds them on the H100. K9 samples 4 bilinear corners of 12 bytes
// for each of NP x W x 8 residuals (7.9 MB at NP = 2560, W = 8: ~2.4 us at
// 3.35 TB/s) and does ~650 f32 operations a residual (its Jacobian and its
// 230 products into the 20x20 block and b: ~1.6 us at 67 TFLOP/s), so it
// is bound by bytes, then operations. K10 reads Hfd and the point terms
// (0.8 MB, ~0.24 us) and needs ~13 M operations (one multiply-add per
// point for each of the 2414 Schur entries, ~0.2 us): bound by bytes on
// paper, in practice by its 68 x 68 solve's chain of dependent steps.
// K11 is a 68 x 68 product. None has a product a tensor core could
// take in f32 (the reference pins Precision.HIGHEST).
//
// Design.
// - Fixed order, no atomics: every sum runs in an order fixed by point
//   index and tile, so two runs give the same bits.
//   K9 is two launches. The first has one block per (tile of 128 points,
//   target frame t): 256 threads take 32 points x 8 pattern pixels at a
//   time, each thread one pixel's residual, Huber weight and 20-wide
//   Jacobian row, kept in shared memory; the pair sums (energy, all pixels
//   in bounds) are 8-lane shuffles. Then thread e of the first 230 adds
//   entry e of each point's 20x20 block (upper triangle) or b into its
//   host's accumulator, point by point in index order; the per-(point,
//   target) sums that feed Hfd, Hdd and bd go to a scratch [NP, W, 22].
//   The second launch sums the tiles in order: one thread per entry of Hff
//   (each (host s, target t) block's entries placed at calib 0:4, host
//   4 + 8s, target 4 + 8t, in ascending s, t, tile: the sum index_add_
//   forms), of bf, and of each point's Hfd row, Hdd and bd. The
//   [NP, W, 8, 20] Jacobian and the [NP, W, 20, 20] products never reach
//   memory.
//   K10 is three launches: the Schur sums per tile of 64 points (each
//   thread an entry of the upper triangle, points in order), one block that
//   adds the tiles in order, assembles and solves the damped system, and
//   the back-substitution of the idepth steps, one warp a point.
// - NaN as the plain version: a pair whose weight is 0 still adds J * 0,
//   so a NaN pose makes H NaN as J20 * w_pix does; and the plain version's
//   one-hot matmul spreads a NaN product to every host's block of that
//   target, which each tile reproduces by adding (sum of products) * 0 to
//   every host's accumulator. The solve is an LU with partial pivoting
//   (the search is a fixed scan of the column, never a loop on data): a
//   NaN in the system reaches x as it does through torch.linalg.solve_ex,
//   and the nullspace projection spreads it to every entry. Bilinear
//   samples clamp finite coordinates (common.cuh, sample3).
// - No host read: each launch reads the device's done flag first and
//   returns at once once it is set, so the host queues a fixed number of
//   iterations. The state and the linearization live in two buffers each;
//   ctrl_i[0] names the current one, and K11 moves it to the candidate on
//   accept (or, in DSO's force-accept mode, whenever the step applies).

#include "lie.cuh"

namespace {

using dsslam::block_sum;
using dsslam::clamp_min;
using dsslam::compose;
using dsslam::inverse;
using dsslam::load_pose;
using dsslam::Pose;
using dsslam::sample3;
using dsslam::se3_exp;

constexpr int kMaxSlots = 8;
constexpr int kMaxD = 4 + 8 * kMaxSlots;
constexpr int kHU = 210;               // the 20x20 block's upper triangle
constexpr int kHB = 230;               // ... and its b
constexpr int kHE = 232;               // per (s, t) block in a tile's partial
constexpr int kG = 22;                 // per (point, target): G20 | Hdd | bd
constexpr int kLinThreads = 256;       // 32 points x 8 pattern pixels a round
constexpr int kRoundPts = kLinThreads / 8;
constexpr int kLinTile = 128;          // points per tile
constexpr int kPix = 24;               // per pixel in shared memory: J20 | w | r | Jd
constexpr int kFinThreads = 256;
constexpr int kSchurTile = 64;
constexpr int kSchurThreads = 256;
constexpr int kSolveThreads = 512;
constexpr int kBackThreads = 256;      // 8 warps, a point each
constexpr int kAcceptThreads = 128;

}  // namespace

// The parameter block every entry point reads (ops/ba.py::BaParams mirrors
// it field for field). Buffers [2]: the current state / linearization and
// the candidate; ctrl_i = {cur, done, converged}, ctrl_f = {lam, e_old}.
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
  float* calib_delta[2];
  float* delta[2];
  float* idepth[2];
  float* Hff[2];
  float* bf[2];
  float* Hfd[2];
  float* Hdd[2];
  float* bd[2];
  float* energy[2];
  float* num_terms[2];
  float* pair_energy[2];
  unsigned char* pair_good[2];
  unsigned char* pair_in[2];
  int* ctrl_i;
  float* ctrl_f;
  float* lin_part;     // [tiles, W (t), W (s), kHE], then [tiles, W, 2]
  float* pt_part;      // [NP, W, kG]
  float* sc_part;      // [schur tiles, U + D + 2]
  float* inv_hdd;      // [NP]
  float* x;            // [D]
  float* x_d;          // [NP]
};

namespace {

__device__ __forceinline__ bool is_done(const BaParams& p) {
  return p.ctrl_i != nullptr && p.ctrl_i[1] != 0;
}

__device__ __forceinline__ int current(const BaParams& p) {
  return p.ctrl_i != nullptr ? p.ctrl_i[0] : 0;
}

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nanmax(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
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

// ---------------------------------------------------------------------------
// K9, first launch: one block per (tile of points, target)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kLinThreads) lin_tile_kernel(const BaParams p, int mode) {
  if (mode != 0 && is_done(p)) return;
  const int cur = current(p);
  const int b = mode != 0 ? 1 - cur : cur;
  const int W = p.W, NP = p.NP;
  const int t = blockIdx.y, tile = blockIdx.x, tid = threadIdx.x;
  __shared__ float sTc[kMaxSlots][12], sTz[kMaxSlots][12];
  __shared__ float sAth[kMaxSlots], sBth[kMaxSlots], sBh[kMaxSlots], sTh[kMaxSlots];
  __shared__ float sCal[8];
  __shared__ float sPix[kRoundPts][8][kPix];
  __shared__ float sAcc[kMaxSlots][kHB];
  __shared__ int sHost[kRoundPts];

  if (tid < W) {
    const int h = tid;
    const Pose<float> A = compose(current_pose(p, b, t), inverse(current_pose(p, b, h)));
    const Pose<float> Z = compose(load_pose<float>(p.T_zero, t),
                                  inverse(load_pose<float>(p.T_zero, h)));
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      sTc[h][k] = A.m[k];
      sTz[h][k] = Z.m[k];
    }
    const float a_h = p.aff_zero[2 * h] + p.delta[b][8 * h + 6];
    const float b_h = p.aff_zero[2 * h + 1] + p.delta[b][8 * h + 7];
    const float a_t = p.aff_zero[2 * t] + p.delta[b][8 * t + 6];
    const float b_t = p.aff_zero[2 * t + 1] + p.delta[b][8 * t + 7];
    const float a_th = expf(a_t - a_h) * (p.exposure[t] / clamp_min(p.exposure[h], 1e-9f));
    sAth[h] = a_th;
    sBth[h] = b_t - a_th * b_h;
    sBh[h] = b_h;
    sTh[h] = nanmax(p.energy_th[h], p.energy_th[t]);
  }
  if (tid < 4) {
    sCal[tid] = p.calib_zero[tid];
    sCal[4 + tid] = p.calib_zero[tid] + p.calib_delta[b][tid];
  }
  for (int i = tid; i < kMaxSlots * kHB; i += kLinThreads) (&sAcc[0][0])[i] = 0.f;
  __syncthreads();
  const float fx0 = sCal[0], fy0 = sCal[1], cx0 = sCal[2], cy0 = sCal[3];
  const float fxc = sCal[4], fyc = sCal[5], cxc = sCal[6], cyc = sCal[7];
  const float* img = p.images + static_cast<size_t>(t) * p.Himg * p.Wimg * 3;

  float poison = 0.f;                    // thread e: sum of its products x 0
  float e_sum = 0.f, n_good = 0.f;       // the 8-lane group's leader: its pairs
  const int q = tid >> 3, k = tid & 7;
  for (int r0 = 0; r0 < kLinTile; r0 += kRoundPts) {
    const int base = tile * kLinTile + r0;
    const int pt = base + q;
    const bool live = pt < NP;
    float J[20], w = 0.f, res = 0.f, Jd = 0.f;
    float pair_e = 0.f;
    int h = 0, mask = 0, inb = 0, okpix = 0;
    if (live) {
      h = static_cast<int>(p.p_host[pt]);
      const float pu = p.p_u[pt] + p.pat_u[k], pv = p.p_v[pt] + p.pat_v[k];
      const float id_cur = clamp_min(p.idepth[b][pt], 1e-6f);
      const float id_zero = clamp_min(p.p_idepth_zero[pt], 1e-6f);
      const float Xc[3] = {(pu - cxc) / fxc / id_cur, (pv - cyc) / fyc / id_cur, 1.f / id_cur};
      const float Xz[3] = {(pu - cx0) / fx0 / id_zero, (pv - cy0) / fy0 / id_zero,
                           1.f / id_zero};
      const float* Rc = sTc[h];
      const float* Rz = sTz[h];
      float pc[3], pz[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        pc[i] = Rc[4 * i] * Xc[0] + Rc[4 * i + 1] * Xc[1] + Rc[4 * i + 2] * Xc[2] + Rc[4 * i + 3];
        pz[i] = Rz[4 * i] * Xz[0] + Rz[4 * i + 1] * Xz[1] + Rz[4 * i + 2] * Xz[2] + Rz[4 * i + 3];
      }
      const float z = pc[2];
      const float Ku = fxc * (pc[0] / z) + cxc;
      const float Kv = fyc * (pc[1] / z) + cyc;
      inb = Ku > 1.1f && Kv > 1.1f && Ku < p.u_hi && Kv < p.v_hi && z > 1e-4f;
      float hit, gx, gy;
      sample3(img, p.Wimg, p.umax, p.vmax, Ku, Kv, hit, gx, gy);
      const float a_th = sAth[h];
      const float color = p.p_color[8 * pt + k], wp = p.p_weight[8 * pt + k];
      res = hit - (a_th * color + sBth[h]);
      const float abs_r = fabsf(res);
      const float huber = p.huber;
      const float hw = abs_r < huber ? 1.f : huber / clamp_min(abs_r, 1e-12f);
      mask = p.p_valid[pt] && p.frame_valid[t] && t != h && p.p_res_good[pt * W + t];
      okpix = inb && isfinite(hit) && mask;
      const float pix_e = hw * res * res * (2.f - hw) * wp * wp;
      pair_e = okpix ? pix_e : 0.f;
      w = hw * wp * wp;                  // masked below, once the pair's sums are in

      // Jacobians at the first estimate
      const float z0 = clamp_min(pz[2], 1e-6f);
      const float un0 = pz[0] / z0, vn0 = pz[1] / z0, iz0 = 1.f / z0;
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
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float rg = Rz[4 * i] * G[0][l] + Rz[4 * i + 1] * G[1][l] + Rz[4 * i + 2] * G[2][l];
          s = i == 0 ? Jt[0] * rg : s + Jt[i] * rg;
        }
        J[4 + l] = -s;
      }
      float dd[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) dd[i] = -(pz[i] - Rz[4 * i + 3]) / id_zero;
      Jd = Jt[0] * dd[0] + Jt[1] * dd[1] + Jt[2] * dd[2];
      const float xh_x = (pu - cx0) / fx0, xh_y = (pv - cy0) / fy0;
      const float ffx = xh_x / fx0 / id_zero, ffy = xh_y / fy0 / id_zero;
      const float fcx = 1.f / fx0 / id_zero, fcy = 1.f / fy0 / id_zero;
      float sfx = 0.f, sfy = 0.f, scx = 0.f, scy = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        sfx += Jt[i] * -(Rz[4 * i] * ffx);
        sfy += Jt[i] * -(Rz[4 * i + 1] * ffy);
        scx += Jt[i] * -(Rz[4 * i] * fcx);
        scy += Jt[i] * -(Rz[4 * i + 1] * fcy);
      }
      J[0] = gx * un0 + sfx;
      J[1] = gy * vn0 + sfy;
      J[2] = gx + scx;
      J[3] = gy + scy;
      const float cmb = color - sBh[h];
      J[10] = a_th * cmb;
      J[11] = a_th;
#pragma unroll
      for (int l = 0; l < 6; ++l) J[12 + l] = Jt[l];
      J[18] = -a_th * cmb;
      J[19] = -1.f;
    }
    // the pair's sums over its 8 pixels (lanes k of one 8-lane group)
    int all_in = inb || !mask;
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      pair_e += __shfl_xor_sync(0xffffffffu, pair_e, off);
      all_in &= __shfl_xor_sync(0xffffffffu, all_in, off);
    }
    const float th = live ? sTh[h] : 0.f;
    const bool good = mask && all_in && pair_e < th;
    w = (good && okpix) ? w : 0.f;
    if (live && k == 0) {
      const size_t pw = static_cast<size_t>(pt) * W + t;
      p.pair_energy[b][pw] = pair_e;
      p.pair_good[b][pw] = good;
      p.pair_in[b][pw] = mask && all_in;
      e_sum += good ? pair_e : (mask ? th : 0.f);
      n_good += good ? 1.f : 0.f;
    }
    if (live) {
      float* px = sPix[q][k];
#pragma unroll
      for (int i = 0; i < 20; ++i) px[i] = J[i];
      px[20] = w;
      px[21] = res;
      px[22] = Jd;
      if (k == 0) sHost[q] = h;
    }
    __syncthreads();
    const int n = min(kRoundPts, NP - base);
    // per (point, target): G20 = sum_k (J w) Jd, Hdd = sum_k (w Jd) Jd,
    // bd = sum_k (w Jd) r
    for (int idx = tid; idx < n * kG; idx += kLinThreads) {
      const int qq = idx / kG, c = idx % kG;
      float v = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const float* px = sPix[qq][kk];
        const float f = c < 20 ? px[c] * px[20] : px[20] * px[22];
        v += f * (c < 21 ? px[22] : px[21]);
      }
      p.pt_part[(static_cast<size_t>(base + qq) * W + t) * kG + c] = v;
    }
    // entry e of each point's 20x20 block (upper triangle) or b, into its
    // host's accumulator, in point order
    if (tid < kHB) {
      int i, j = 0;
      if (tid < kHU) upper_ij(tid, 20, i, j);
      else i = tid - kHU;
      for (int qq = 0; qq < n; ++qq) {
        float v = 0.f;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const float* px = sPix[qq][kk];
          v += (px[i] * px[20]) * (tid < kHU ? px[j] : px[21]);
        }
        sAcc[sHost[qq]][tid] += v;
        poison += v * 0.f;
      }
    }
    __syncthreads();
  }
  // the tile's partial: every host's block of target t, each with the
  // products' NaN (the one-hot matmul's 0 x NaN)
  const size_t tb = static_cast<size_t>(tile) * W + t;
  if (tid < kHB)
    for (int s = 0; s < W; ++s) p.lin_part[(tb * W + s) * kHE + tid] = sAcc[s][tid] + poison;
  const float acc[2] = {e_sum, n_good};
  __shared__ float sums[2];
  block_sum<2, kLinThreads>(acc, sums);
  __syncthreads();
  const size_t ntiles = gridDim.x;
  if (tid < 2) p.lin_part[ntiles * W * W * kHE + tb * 2 + tid] = sums[tid];
}

// the columns of the D-vector a (host s, target t) block's 20 indices
// reach: column c is index i when c's calib or frame part matches
__device__ __forceinline__ int block_indices(int c, int s, int t, int (&idx)[2]) {
  if (c < 4) {
    idx[0] = c;
    return 1;
  }
  const int f = (c - 4) >> 3, k = (c - 4) & 7;
  int n = 0;
  if (s == f) idx[n++] = 4 + k;
  if (t == f) idx[n++] = 12 + k;
  return n;
}

// K9, second launch: the tiles summed in order into Hff, bf, energy and
// num_terms (blocks past the point rows), and each point's Hfd row, Hdd
// and bd
__global__ void __launch_bounds__(kFinThreads) lin_finish_kernel(const BaParams p, int mode,
                                                                 int ntiles, int row_blocks) {
  if (mode != 0 && is_done(p)) return;
  const int cur = current(p);
  const int b = mode != 0 ? 1 - cur : cur;
  const int W = p.W, NP = p.NP, D = 4 + 8 * W;
  if (static_cast<int>(blockIdx.x) < row_blocks) {
    const long long idx = static_cast<long long>(blockIdx.x) * kFinThreads + threadIdx.x;
    if (idx >= static_cast<long long>(NP) * D) return;
    const int pt = static_cast<int>(idx / D), d = static_cast<int>(idx % D);
    const float* G = p.pt_part + static_cast<size_t>(pt) * W * kG;
    float v;
    if (d < 4) {
      v = G[d];
      for (int t = 1; t < W; ++t) v += G[t * kG + d];
    } else {
      const int f = (d - 4) >> 3, k = (d - 4) & 7;
      v = G[f * kG + 12 + k];
      if (f == static_cast<int>(p.p_host[pt])) {
        float hs = G[4 + k];
        for (int t = 1; t < W; ++t) hs += G[t * kG + 4 + k];
        v += hs;
      }
    }
    p.Hfd[b][idx] = v;
    if (d == 0) {
      float hdd = G[20], bd = G[21];
      for (int t = 1; t < W; ++t) {
        hdd += G[t * kG + 20];
        bd += G[t * kG + 21];
      }
      const float prior = p.p_prior[pt];
      p.Hdd[b][pt] = hdd + prior;
      p.bd[b][pt] = bd + prior * (p.idepth[b][pt] - p.p_idepth_zero[pt]);
    }
    return;
  }
  const int e = (blockIdx.x - row_blocks) * kFinThreads + threadIdx.x;
  const int U = D * (D + 1) / 2;
  const size_t part_stride = static_cast<size_t>(W) * W * kHE;
  if (e < U) {
    int r, c;
    upper_ij(e, D, r, c);
    float v = 0.f;
    for (int s = 0; s < W; ++s)
      for (int t = 0; t < W; ++t) {
        int ir[2], jc[2];
        const int nr = block_indices(r, s, t, ir), nc = block_indices(c, s, t, jc);
        for (int a = 0; a < nr; ++a)
          for (int bb = 0; bb < nc; ++bb) {
            const int i = min(ir[a], jc[bb]), j = max(ir[a], jc[bb]);
            const int ent = i * 20 - i * (i - 1) / 2 + (j - i);
            const float* src = p.lin_part + (static_cast<size_t>(t) * W + s) * kHE + ent;
            for (int tl = 0; tl < ntiles; ++tl) v += src[tl * part_stride];
          }
      }
    p.Hff[b][r * D + c] = v;
    p.Hff[b][c * D + r] = v;
  } else if (e < U + D) {
    const int r = e - U;
    float v = 0.f;
    for (int s = 0; s < W; ++s)
      for (int t = 0; t < W; ++t) {
        int ir[2];
        const int nr = block_indices(r, s, t, ir);
        for (int a = 0; a < nr; ++a) {
          const float* src = p.lin_part + (static_cast<size_t>(t) * W + s) * kHE + kHU + ir[a];
          for (int tl = 0; tl < ntiles; ++tl) v += src[tl * part_stride];
        }
      }
    p.bf[b][r] = v;
  } else if (e == U + D) {
    const float* src = p.lin_part + static_cast<size_t>(ntiles) * part_stride;
    float en = 0.f, ng = 0.f;
    for (int i = 0; i < ntiles * W; ++i) {
      en += src[2 * i];
      ng += src[2 * i + 1];
    }
    *p.energy[b] = en;
    *p.num_terms[b] = ng * 8.f;
  }
}

// ---------------------------------------------------------------------------
// K10: Schur sums per tile, the solve, the back-substitution
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kSchurThreads) schur_kernel(const BaParams p) {
  if (is_done(p)) return;
  const int cur = current(p);
  const int W = p.W, NP = p.NP, D = 4 + 8 * W, U = D * (D + 1) / 2;
  const float lam = p.ctrl_f[0];
  __shared__ float sH[kSchurTile][kMaxD + 1];
  __shared__ float sInv[kSchurTile], sIB[kSchurTile];
  const int p0 = blockIdx.x * kSchurTile, tid = threadIdx.x;
  const int n = min(kSchurTile, NP - p0);
  for (int i = tid; i < n * D; i += kSchurThreads)
    sH[i / D][i % D] = p.Hfd[cur][static_cast<size_t>(p0) * D + i];
  float acc[2] = {0.f, 0.f};
  if (tid < n) {
    const int pt = p0 + tid;
    const float hdd = p.Hdd[cur][pt];
    const float mult = hdd * (1.f + lam) + 1e-10f;
    const float inv = hdd > 1e-10f ? 1.f / mult : 0.f;
    sInv[tid] = inv;
    sIB[tid] = inv * p.bd[cur][pt];
    p.inv_hdd[pt] = inv;
    if (p.p_valid[pt]) {
      acc[0] = fabsf(p.idepth[cur][pt]);
      acc[1] = 1.f;
    }
  }
  __syncthreads();
  const size_t stride = static_cast<size_t>(U + D + 2);
  float* out = p.sc_part + blockIdx.x * stride;
  for (int e = tid; e < U + D; e += kSchurThreads) {
    float v = 0.f;
    if (e < U) {
      int i, j;
      upper_ij(e, D, i, j);
      for (int qq = 0; qq < n; ++qq) v += (sH[qq][i] * sInv[qq]) * sH[qq][j];
    } else {
      const int i = e - U;
      for (int qq = 0; qq < n; ++qq) v += sH[qq][i] * sIB[qq];
    }
    out[e] = v;
  }
  __shared__ float sums[2];
  block_sum<2, kSchurThreads>(acc, sums);
  __syncthreads();
  if (tid < 2) out[U + D + tid] = sums[tid];
}

__global__ void __launch_bounds__(kSolveThreads) solve_kernel(const BaParams p, int ntiles) {
  if (is_done(p)) return;
  const int cur = current(p);
  const int W = p.W, D = 4 + 8 * W, U = D * (D + 1) / 2, tid = threadIdx.x;
  const float lam = p.ctrl_f[0];
  extern __shared__ float smem[];
  float* sc = smem;                        // U + D + 2: H_sc upper, b_sc, |id| sum, count
  float* A = sc + U + D + 2;               // [D][D + 1]
  float* rhs = A + D * (D + 1);            // [D]
  float* P = rhs + D;
  float* x0 = P + D;
  float* xs = x0 + D;
  float* N = xs + D;
  __shared__ int s_anchor, s_piv;
  __shared__ float s_red[4];

  const size_t stride = static_cast<size_t>(U + D + 2);
  for (int e = tid; e < U + D + 2; e += kSolveThreads) {
    float v = 0.f;
    for (int tl = 0; tl < ntiles; ++tl) v += p.sc_part[tl * stride + e];
    sc[e] = v;
  }
  if (tid == 0) {
    int a = 0, best = 1 << 30;
    for (int f = 0; f < W; ++f) {
      const int fid = p.frame_valid[f] ? p.frame_id[f] : (1 << 30);
      if (fid < best) {
        best = fid;
        a = f;
      }
    }
    s_anchor = a;
  }
  for (int d = tid; d < D; d += kSolveThreads) {
    P[d] = p.precond[d];
    x0[d] = state_at(p, cur, d);
  }
  __syncthreads();
  const int a0 = 4 + 8 * s_anchor;
  auto is_free = [&](int d) { return d < a0 || d >= a0 + 8; };
  auto hsc = [&](int i, int j) {
    const int r = min(i, j), c = max(i, j);
    return sc[r * D - r * (r - 1) / 2 + (c - r)];
  };
  const float* Hff = p.Hff[cur];
  for (int e = tid; e < D * D; e += kSolveThreads) {
    const int i = e / D, j = e % D;
    float h = Hff[e] - hsc(i, j) + p.HM[e] + (i == j ? prior_at(p, i) : 0.f);
    h = (is_free(i) && is_free(j)) ? h : 0.f;
    if (i == j) h += is_free(i) ? 0.f : 1.f;
    float hp = h * P[i] * P[j];
    if (i == j) hp = hp + lam * hp + 1e-8f;
    A[i * (D + 1) + j] = hp;
  }
  for (int i = tid; i < D; i += kSolveThreads) {
    float hx = 0.f;
    for (int j = 0; j < D; ++j) hx += p.HM[i * D + j] * x0[j];
    float bi = p.bf[cur][i] - sc[U + i] + p.bM[i] + hx + prior_at(p, i) * x0[i];
    bi = is_free(i) ? bi : 0.f;
    rhs[i] = -(bi * P[i]);
  }
  __syncthreads();

  // LU with partial pivoting (the first row of largest |entry|), the
  // eliminated rows' multipliers recomputed where they are used
  for (int k = 0; k < D; ++k) {
    if (tid < 32) {
      float best = -1.f;
      int arg = k;
      for (int r = k + tid; r < D; r += 32) {
        const float v = fabsf(A[r * (D + 1) + k]);
        if (v > best) {
          best = v;
          arg = r;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        if (ob > best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      if (tid == 0) s_piv = arg;
    }
    __syncthreads();
    const int pr = s_piv;
    if (pr != k) {
      for (int c = k + tid; c <= D; c += kSolveThreads) {
        float* ra = c < D ? &A[k * (D + 1) + c] : &rhs[k];
        float* rb = c < D ? &A[pr * (D + 1) + c] : &rhs[pr];
        const float tmp = *ra;
        *ra = *rb;
        *rb = tmp;
      }
      __syncthreads();
    }
    const float piv = A[k * (D + 1) + k];
    const int rows = D - k - 1, cols = D - k;     // columns k+1 .. D-1 and rhs
    for (int e = tid; e < rows * cols; e += kSolveThreads) {
      const int r = k + 1 + e / cols, c = k + 1 + e % cols;
      const float f = A[r * (D + 1) + k] / piv;
      if (c < D) A[r * (D + 1) + c] -= f * A[k * (D + 1) + c];
      else rhs[r] -= f * rhs[k];
    }
    __syncthreads();
  }
  // back-substitution, a column at a time
  for (int k = D - 1; k >= 0; --k) {
    if (tid == 0) xs[k] = rhs[k] / A[k * (D + 1) + k];
    __syncthreads();
    const float xk = xs[k];
    for (int r = tid; r < k; r += kSolveThreads) rhs[r] -= A[r * (D + 1) + k] * xk;
    __syncthreads();
  }
  // x = xp P, then the scale nullspace projected out
  if (tid < W) {
    const int f = tid;
    const Pose<float> T = current_pose(p, cur, f);
    const float blk = (p.frame_valid[f] && f != s_anchor) ? 1.f : 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) N[4 + 8 * f + k] = T.m[4 * k + 3] * blk;
#pragma unroll
    for (int k = 3; k < 8; ++k) N[4 + 8 * f + k] = 0.f;
  }
  if (tid < 4) N[tid] = 0.f;
  for (int d = tid; d < D; d += kSolveThreads) xs[d] = xs[d] * P[d];
  __syncthreads();
  if (tid == 0) {
    float ntn = 0.f, ntx = 0.f;
    for (int d = 0; d < D; ++d) {
      ntn += N[d] * N[d];
      ntx += N[d] * xs[d];
    }
    s_red[0] = ntx / (ntn + 1e-6f);
  }
  __syncthreads();
  for (int d = tid; d < D; d += kSolveThreads) {
    const float xd = xs[d] - N[d] * s_red[0];
    xs[d] = xd;
    p.x[d] = xd;
  }
  __syncthreads();
  // DSO's doStepFromBackup convergence test
  if (tid == 0) {
    float nf = 0.f, sT = 0.f, sR = 0.f, sA = 0.f, sB = 0.f;
    for (int f = 0; f < W; ++f) {
      const float m = p.frame_valid[f] ? 1.f : 0.f;
      const float* xf = xs + 4 + 8 * f;
      nf += m;
      sT += m * (xf[0] * xf[0]) + m * (xf[1] * xf[1]) + m * (xf[2] * xf[2]);
      sR += m * (xf[3] * xf[3]) + m * (xf[4] * xf[4]) + m * (xf[5] * xf[5]);
      sA += m * (xf[6] * xf[6]);
      sB += m * (xf[7] * xf[7]);
    }
    nf = fmaxf(nf, 1.f);
    const float nid = fmaxf(sc[U + D + 1], 1.f);
    const float sum_nid = sc[U + D] / nid;
    const bool conv = sqrtf(sA / nf) < p.th_a && sqrtf(sB / nf) < p.th_b &&
                      sqrtf(sR / nf) < p.th_r && sqrtf(sT / nf) * sum_nid < p.th_t;
    p.ctrl_i[2] = conv ? 1 : 0;
  }
}

// the idepth steps x_d = inv_Hdd (-bd - Hfd x), one warp a point, and the
// candidate state (buffer 1 - cur)
__global__ void __launch_bounds__(kBackThreads) backsub_kernel(const BaParams p) {
  if (is_done(p)) return;
  const int cur = current(p), nxt = 1 - cur;
  const int W = p.W, D = 4 + 8 * W;
  __shared__ float sx[kMaxD];
  for (int d = threadIdx.x; d < D; d += kBackThreads) sx[d] = p.x[d];
  __syncthreads();
  if (blockIdx.x == 0)
    for (int d = threadIdx.x; d < D; d += kBackThreads) {
      if (d < 4) p.calib_delta[nxt][d] = p.calib_delta[cur][d] + sx[d];
      else p.delta[nxt][d - 4] = p.delta[cur][d - 4] + sx[d];
    }
  const int lane = threadIdx.x & 31;
  const int pt = blockIdx.x * (kBackThreads / 32) + (threadIdx.x >> 5);
  if (pt >= p.NP) return;
  const float* row = p.Hfd[cur] + static_cast<size_t>(pt) * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += row[d] * sx[d];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    const float xd = p.inv_hdd[pt] * (-p.bd[cur][pt] - s);
    p.x_d[pt] = xd;
    const float id = p.idepth[cur][pt];
    p.idepth[nxt][pt] = p.p_valid[pt] ? id + xd : id;
  }
}

// ---------------------------------------------------------------------------
// K11: total energy of a state and its linearization; accept / reject
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kAcceptThreads) accept_kernel(const BaParams p, int it) {
  if (it >= 0 && is_done(p)) return;
  const int cur = current(p);
  const int sb = it < 0 ? cur : 1 - cur;
  const int W = p.W, D = 4 + 8 * W, tid = threadIdx.x;
  __shared__ float sx[kMaxD], sv[kMaxD];
  for (int d = tid; d < D; d += kAcceptThreads) sx[d] = state_at(p, sb, d);
  __syncthreads();
  for (int i = tid; i < D; i += kAcceptThreads) {
    float hx = 0.f;
    for (int j = 0; j < D; ++j) hx += p.HM[i * D + j] * sx[j];
    sv[i] = sx[i] * (hx + 2.f * p.bM[i] + prior_at(p, i) * sx[i]);
  }
  __syncthreads();
  if (tid != 0) return;
  float dot = 0.f;
  for (int d = 0; d < D; ++d) dot += sv[d];
  const float e = *p.energy[sb] + dot;
  float lam = p.ctrl_f[0];
  if (it < 0) {
    p.ctrl_f[0] = 0.1f;
    p.ctrl_f[1] = e;
    p.ctrl_i[1] = 0;
    p.ctrl_i[2] = 0;
    return;
  }
  const bool conv = p.ctrl_i[2] != 0;
  if (p.force_accept) {
    if (!conv || it < p.min_opt_iterations) p.ctrl_i[0] = sb;
    lam = lam * 0.25f;
  } else {
    const bool accept = e < p.ctrl_f[1] && *p.num_terms[sb] >= 0.3f * *p.num_terms[cur];
    if (accept) {
      p.ctrl_i[0] = sb;
      p.ctrl_f[1] = e;
    }
    lam = accept ? lam * 0.25f : fminf(lam * 100.f, 1e4f);
  }
  p.ctrl_f[0] = lam;
  p.ctrl_i[1] = (conv && it + 1 >= p.min_opt_iterations) ? 1 : 0;
}

int lin_tiles(const BaParams& p) { return (p.NP + kLinTile - 1) / kLinTile; }

bool sizes_ok(const BaParams& p) {
  return p.W >= 1 && p.W <= kMaxSlots && p.NP >= 1;
}

}  // namespace

// K9: the linearization of state buffer cur (mode 0) or of the candidate
// 1 - cur (mode 1, skipped once done) into the linearization buffer of the
// same index.
DSSLAM_API int dsslam_ba_linearize(const BaParams* p, int mode, cudaStream_t stream) {
  if (!sizes_ok(*p)) return cudaErrorInvalidValue;
  const int ntiles = lin_tiles(*p);
  const int D = 4 + 8 * p->W;
  const long long rows = static_cast<long long>(p->NP) * D;
  const int row_blocks = static_cast<int>((rows + kFinThreads - 1) / kFinThreads);
  const int sum_blocks = (D * (D + 1) / 2 + D + 1 + kFinThreads - 1) / kFinThreads;
  const dim3 grid(ntiles, p->W);
  lin_tile_kernel<<<grid, kLinThreads, 0, stream>>>(*p, mode);
  lin_finish_kernel<<<row_blocks + sum_blocks, kFinThreads, 0, stream>>>(*p, mode, ntiles,
                                                                        row_blocks);
  return cudaGetLastError();
}

// K10: the LM step from buffer cur (lambda ctrl_f[0]): x [D], x_d [NP], the
// convergence flag, and the candidate state in buffer 1 - cur.
DSSLAM_API int dsslam_ba_step(const BaParams* p, cudaStream_t stream) {
  if (!sizes_ok(*p) || !p->ctrl_i || !p->ctrl_f) return cudaErrorInvalidValue;
  const int D = 4 + 8 * p->W, U = D * (D + 1) / 2;
  const int ntiles = (p->NP + kSchurTile - 1) / kSchurTile;
  const size_t smem = sizeof(float) * (U + D + 2 + D * (D + 1) + 5 * D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  schur_kernel<<<ntiles, kSchurThreads, 0, stream>>>(*p);
  solve_kernel<<<1, kSolveThreads, smem, stream>>>(*p, ntiles);
  const int back_blocks = (p->NP + kBackThreads / 32 - 1) / (kBackThreads / 32);
  backsub_kernel<<<back_blocks, kBackThreads, 0, stream>>>(*p);
  return cudaGetLastError();
}

// K11: it < 0: lam = 0.1 and e_old = the total energy of buffer cur (the
// loop's start); else accept or reject the candidate of iteration it.
DSSLAM_API int dsslam_ba_accept(const BaParams* p, int it, cudaStream_t stream) {
  if (!sizes_ok(*p) || !p->ctrl_i || !p->ctrl_f) return cudaErrorInvalidValue;
  accept_kernel<<<1, kAcceptThreads, 0, stream>>>(*p, it);
  return cudaGetLastError();
}
