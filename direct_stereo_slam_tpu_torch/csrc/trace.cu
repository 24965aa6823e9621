// K14: the front end's epipolar trace over the window, on the card.
//
// `trace_kernel` replaces the JAX package's hand-written XLA
// program direct_stereo_slam_tpu/models/immature.py:479
// `trace_points_all_compact` (the search's arithmetic as in `trace_points`,
// :115-300): over the window's stacked [S, NI] immature candidates,
//   phase 1, every lane: the epipolar segment from the idepth interval,
//     the OOB / SKIPPED / BADCONDITION gates and their statuses, the
//     search mask (with the steady tier's `max_reach` deferral);
//   the compaction of the searching lanes, row-major over all S x NI,
//     into `budget` lanes (the rest keep their state and are counted in
//     n_overflow);
//   phase 2, each compacted lane: the `num_steps`-point search along the
//     segment (8 pattern taps a point on the intensity plane), the best
//     energy (the first index on ties), the second best at least
//     MIN_TEST_RADIUS px away, the quality, the GN refine on the
//     intensity and gradient planes, the outlier test and the interval
//     update;
//   phase 3: the results into new [S, NI] tensors (the input stays as it
//     was) and n_search, n_overflow into two int64 scalars.
// Its plain version is models/immature.py::trace_points_all_compact_plain.
// Every elementwise operation is that version's, rounded one at a time
// (plain_ops.cuh: no contraction into fused multiply-adds), its sums are
// its left-to-right chains and its argmin PyTorch's (NaN first, then the
// lower index on ties): the two give the same bits.
//
// What bounds it on the H100 (KITTI, preset 0: S = 8, NI = 1024, a full
// call's budget 2048 of 48 steps, the steady tier's 1024 of 16): the
// search reads ~2048 x 48 x 8 bilinear samples of 4 taps from L2 (the
// [368, 1232, 3] planes are 5.4 MB), ~3 M loads but only the segments'
// distinct pixels from memory (< 1 MB), and ~10 M f32 operations; neither
// bound is reached (a few us). What sets its time is the chain of
// dependent steps: a lane's search, its 3 GN steps of two dependent taps
// each, and the compaction, which is global over S x NI.
//
// Design: one cooperative grid, a block of 512 threads an SM, one grid
// barrier. Phase 1 runs a lane a thread over the grid: it writes the lane's
// outputs as the gates leave them (the input's values, the gate status)
// and its flags (searching, wanting, deferred) to global memory. After the
// grid barrier every block reads all S x NI flags (8 KB at KITTI size) and
// compacts the searching lanes by a block scan into its shared memory (the
// same ranks in every block; block 0 also counts n_search and n_overflow),
// and the grid's warps take the compacted positions, a warp a position,
// ~2000 warps over the budget in one wave: the steps across the warp's
// threads (a thread's steps l, l + 32, ... in its registers), the argmin
// and the second best by shuffles in an order-independent comparison, the
// GN taps on 8 threads, their sums as the plain version's chains by
// shuffles from lanes 0-7 in order (every thread then holds the same bits
// and takes the same step). A first form, one 8-block cluster whose 256
// warps took up to 8 positions each in turn, spent 74 of its 80 us in the
// search on an H100 (chip_smoke.py's fullest e2e call): one wave over the
// grid is the search's latency once. The per-slot inputs KRKi, Kt, a, b come in the
// launch's parameters (`__grid_constant__`), not through an upload.
// `stamps` (optional) gets clock64 phase deltas of thread 0 of each block
// (kTraceStamps). No atomics: two runs give the same bits.

#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"
#include "plain_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using dsslam::clamp_min;
using namespace dsslam::rn;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 32;
constexpr int kMaxSteps = 128;
constexpr int kStepsPerThread = kMaxSteps / 32;
// phase stamps per block: phase 1; the grid barrier; the compaction; the
// searches
constexpr int kTraceStamps = 4;

// DSO's IPS_* states (models/immature.py)
constexpr int kIpsGood = 0, kIpsOob = 1, kIpsOutlier = 2, kIpsSkipped = 3, kIpsBadCondition = 4;

// config.PATTERN_OFFSETS (du, dv)
__constant__ float kPatU[8] = {0.f, -1.f, 1.f, -2.f, 0.f, 2.f, -1.f, 0.f};
__constant__ float kPatV[8] = {-2.f, -1.f, -1.f, 0.f, 0.f, 0.f, 1.f, 2.f};

struct TraceParams {
  int S, NI, H, W, budget, num_steps, gn_iters, has_reach;
  // f32 roundings of the config's numbers, as PyTorch casts a scalar
  float max_pix, slack, min_improve, outlier_e, max_reach, step_size, inv_steps, umax, vmax;
  // the candidates [S, NI] ([S, NI, 8] color, [S, NI, 3] grad_h)
  const unsigned char* valid;
  const float *u, *v, *idepth_min, *idepth_max, *color, *grad_h, *quality;
  const int* status;
  const float* pixel_interval;
  const float* planes;                   // [H, W, 3] (I, dx, dy)
  float *o_idepth_min, *o_idepth_max, *o_quality;
  int* o_status;
  float* o_pixel_interval;
  long long* counts;                     // [2]: n_search, n_overflow
  long long* lanes;                      // [budget] the compacted lanes, or null
  long long* stamps;                     // [grid, kTraceStamps] cycles, or null
  unsigned char* flags;                  // [S, NI] scratch
  float slot[kMaxSlots * 14];            // per slot KRKi row-major, Kt, a, b
};

// A lane's segment (models/immature.py::_segment, with `_project`'s pr).
struct Seg {
  float pr[3];
  float u_min, v_min, dirx, diry, dist, err;
  bool oob, skipped, badcond;
};

__device__ __forceinline__ Seg segment(const TraceParams& p, size_t k, int s) {
  const float* M = p.slot + 14 * s;
  const float u = p.u[k], v = p.v[k];
  Seg g;
#pragma unroll
  for (int r = 0; r < 3; ++r) g.pr[r] = add(add(mul(M[3 * r], u), mul(M[3 * r + 1], v)), M[3 * r + 2]);
  const float imin = p.idepth_min[k], imax = p.idepth_max[k];
  const float q0 = add(g.pr[0], mul(M[9], imin)), q1 = add(g.pr[1], mul(M[10], imin));
  const float q2 = add(g.pr[2], mul(M[11], imin));
  g.u_min = dvd(q0, q2);
  g.v_min = dvd(q1, q2);
  const float Wb = static_cast<float>(p.W - 5), Hb = static_cast<float>(p.H - 5);
  const bool oob_min = !(g.u_min > 4.f && g.v_min > 4.f && g.u_min < Wb && g.v_min < Hb);
  const bool have_max = isfinite(imax);
  const float idm = have_max ? imax : 0.01f;
  const float m0 = add(g.pr[0], mul(M[9], idm)), m1 = add(g.pr[1], mul(M[10], idm));
  const float m2 = add(g.pr[2], mul(M[11], idm));
  const float u_max = dvd(m0, m2), v_max = dvd(m1, m2);
  const float d_u = sub(u_max, g.u_min), d_v = sub(v_max, g.v_min);
  const float dist_full = __fsqrt_rn(add(mul(d_u, d_u), mul(d_v, d_v)));
  g.dirx = dvd(d_u, clamp_min(dist_full, 1e-9f));
  g.diry = dvd(d_v, clamp_min(dist_full, 1e-9f));
  g.dist = have_max ? min_keep_nan(dist_full, p.max_pix) : p.max_pix;
  const float u2 = add(g.u_min, mul(g.dirx, g.dist)), v2 = add(g.v_min, mul(g.diry, g.dist));
  const bool oob_max = !(u2 > 4.f && v2 > 4.f && u2 < Wb && v2 < Hb);
  g.oob = oob_min || oob_max;
  const float gxx = p.grad_h[3 * k], gxy = p.grad_h[3 * k + 1], gyy = p.grad_h[3 * k + 2];
  const float xx = mul(g.dirx, g.dirx), yy = mul(g.diry, g.diry);
  const float cross = mul(mul(mul(2.f, g.dirx), g.diry), gxy);
  const float a = add(add(mul(xx, gxx), cross), mul(yy, gyy));
  const float b = add(sub(mul(yy, gxx), cross), mul(xx, gyy));
  const float err = add(dvd(mul(add(a, b), 0.2f), clamp_min(a, 1e-9f)), 0.2f);
  g.badcond = err > 10.f;
  g.err = min_keep_nan(err, 10.f);
  g.skipped = g.dist < p.slack || mul(g.err, p.min_improve) > g.dist;
  return g;
}

// torch.minimum / torch.maximum on the card: a NaN operand is returned
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
// torch.sign: (0 < x) - (x < 0), so 0 for 0 and NaN
__device__ __forceinline__ float sgn(float x) {
  return static_cast<float>(0.f < x) - static_cast<float>(x < 0.f);
}
// torch.min(dim)'s order (SharedReduceOps' LessOrNan): NaN first, then
// the smaller value, the lower index on ties; a strict total order on
// (value, index), so any reduction tree gives the same pair
__device__ __forceinline__ bool less_or_nan(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  if (isnan(b)) return false;
  return a == b ? ia < ib : a < b;
}
// torch.amin: NaN propagates
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

// The sum over lanes 0-7 of the warp of x, left to right (the same bits
// on every lane).
__device__ __forceinline__ float chain8(float x) {
  float s = __shfl_sync(kFull, x, 0);
#pragma unroll
  for (int j = 1; j < 8; ++j) s = add(s, __shfl_sync(kFull, x, j));
  return s;
}

// The lane at flat index k (slot s) searched by the calling warp, its
// outputs written by lane 0 (models/immature.py::_search). `tap`, the
// warp's [3][8] shared scratch: each pattern pixel's reference, rdu, rdv.
__device__ __forceinline__ void search_lane(const TraceParams& p, size_t k, int s, int lane,
                                            float* tap) {
  const Seg g = segment(p, k, s);
  const float* M = p.slot + 14 * s;
  const float aa = M[12], bb = M[13];
  const int kk = lane & 7;
  if (lane < 8) {
    tap[kk] = add(mul(aa, p.color[8 * k + kk]), bb);                       // ref = a * color + b
    tap[8 + kk] = add(mul(M[0], kPatU[kk]), mul(M[1], kPatV[kk]));          // rdu
    tap[16 + kk] = add(mul(M[3], kPatU[kk]), mul(M[4], kPatV[kk]));         // rdv
  }
  __syncwarp();
  const float my_ref = tap[kk], my_rdu = tap[8 + kk], my_rdv = tap[16 + kk];
  const float step_len = mul(clamp_min(g.dist, 1e-6f), p.inv_steps);
  const float inf = __int_as_float(0x7f800000);
  const float Wl = static_cast<float>(p.W - 4), Hl = static_cast<float>(p.H - 4);

  // the energies of this thread's steps, then the argmin over the warp
  float en[kStepsPerThread];
  float best_e = inf;
  int best_i = 0x7fffffff;
#pragma unroll
  for (int q = 0; q < kStepsPerThread; ++q) {
    const int t = lane + 32 * q;
    en[q] = inf;
    if (t < p.num_steps) {
      const float tf = static_cast<float>(t);
      const float px = add(g.u_min, mul(mul(g.dirx, tf), step_len));
      const float py = add(g.v_min, mul(mul(g.diry, tf), step_len));
      const bool s_ok = px > 3.f && py > 3.f && px < Wl && py < Hl;
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float h = sample1_rn(p.planes, p.W, p.umax, p.vmax, add(px, tap[8 + j]),
                                   add(py, tap[16 + j]));
        const float r = sub(h, tap[j]);
        e = j == 0 ? mul(r, r) : add(e, mul(r, r));
      }
      en[q] = s_ok ? e : inf;
      if (less_or_nan(en[q], t, best_e, best_i)) {
        best_e = en[q];
        best_i = t;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oe = __shfl_xor_sync(kFull, best_e, off);
    const int oi = __shfl_xor_sync(kFull, best_i, off);
    if (less_or_nan(oe, oi, best_e, best_i)) {
      best_e = oe;
      best_i = oi;
    }
  }
  // the second best at least MIN_TEST_RADIUS (2 px) from the best
  const float bi = static_cast<float>(best_i);
  float second = inf;
#pragma unroll
  for (int q = 0; q < kStepsPerThread; ++q) {
    const int t = lane + 32 * q;
    if (t < p.num_steps) {
      const bool far = mul(fabsf(sub(static_cast<float>(t), bi)), step_len) >= 2.f;
      second = min_nan(second, far ? en[q] : inf);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) second = min_nan(second, __shfl_xor_sync(kFull, second, off));
  const float new_q = isfinite(second) ? dvd(second, clamp_min(best_e, 1e-9f)) : 1e4f;
  const float quality = g.dist > 3.f ? new_q : minimum(p.quality[k], new_q);

  // the GN refine along the segment, a pattern pixel on each of lanes 0-7
  float best_u = add(g.u_min, mul(mul(g.dirx, step_len), bi));
  float best_v = add(g.v_min, mul(mul(g.diry, step_len), bi));
  for (int it = 0; it < p.gn_iters; ++it) {
    float h0, h1, h2;
    sample3_rn(p.planes, p.W, p.umax, p.vmax, add(best_u, my_rdu), add(best_v, my_rdv), h0, h1,
               h2);
    const float r = sub(h0, my_ref);
    const float gd = add(mul(h1, g.dirx), mul(h2, g.diry));
    const float Hs = chain8(mul(gd, gd)), bs = chain8(mul(r, gd));
    const float stp = mul(clamp(dvd(-bs, clamp_min(Hs, 1e-9f)), -0.5f, 0.5f), p.step_size);
    const float nu = add(best_u, mul(stp, g.dirx)), nv = add(best_v, mul(stp, g.diry));
    const float rn = sub(sample1_rn(p.planes, p.W, p.umax, p.vmax, add(nu, my_rdu),
                                    add(nv, my_rdv)), my_ref);
    const float ne = chain8(mul(rn, rn));
    if (ne < best_e) {                   // the same on every lane
      best_u = nu;
      best_v = nv;
      best_e = ne;
    }
  }
  __syncwarp();                          // `tap` is the next lane's after this
  if (lane != 0) return;
  const bool outlier = best_e > p.outlier_e;
  p.o_quality[k] = quality;
  p.o_status[k] = outlier ? kIpsOutlier : kIpsGood;
  if (outlier) return;
  // the interval from best +- err along the segment (id_from_px)
  const bool use_x = mul(g.dirx, g.dirx) > mul(g.diry, g.diry);
  const float* Kt = M + 9;
  auto id_from_px = [&](float uu, float vv) {
    if (use_x) {
      const float dx = sub(Kt[0], mul(Kt[2], uu));
      return mul(dvd(sub(mul(g.pr[2], uu), g.pr[0]), clamp_min(fabsf(dx), 1e-12f)), sgn(dx));
    }
    const float dy = sub(Kt[1], mul(Kt[2], vv));
    return mul(dvd(sub(mul(g.pr[2], vv), g.pr[1]), clamp_min(fabsf(dy), 1e-12f)), sgn(dy));
  };
  const float ex = mul(g.err, g.dirx), ey = mul(g.err, g.diry);
  const float lo = id_from_px(sub(best_u, ex), sub(best_v, ey));
  const float hi = id_from_px(add(best_u, ex), add(best_v, ey));
  p.o_idepth_min[k] = minimum(lo, hi);
  p.o_idepth_max[k] = maximum(lo, hi);
  p.o_pixel_interval[k] = mul(g.err, 2.f);
}

// K14: one cooperative grid, a block of kThreads an SM. Dynamic shared
// memory: the compacted lanes [budget].
__global__ void __launch_bounds__(kThreads) trace_kernel(const __grid_constant__ TraceParams p) {
  extern __shared__ int s_lanes[];
  __shared__ int s_scan[kWarps];
  __shared__ float s_tap[kWarps][24];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, G = gridDim.x;
  const int n = p.S * p.NI;
  long long* stamp = p.stamps && tid == 0 ? p.stamps + b * kTraceStamps : nullptr;
  long long t0 = clock64();

  // ---- phase 1: the gates on every lane, its outputs as the gates leave
  // them and its flags (1 searching, 2 wanting, 4 deferred)
  for (int k = b * kThreads + tid; k < n; k += G * kThreads) {
    const int s = k / p.NI;
    const int st = p.status[k];
    const bool traceable = p.valid[k] != 0 && st != kIpsOob;
    const Seg g = segment(p, k, s);
    const bool want = traceable && !g.oob && !g.skipped && !g.badcond;
    const bool flag = want && (!p.has_reach || g.dist <= p.max_reach);
    const bool def = p.has_reach && want && g.dist > p.max_reach;
    p.o_status[k] = !traceable ? st
                    : g.oob    ? kIpsOob
                    : g.skipped ? kIpsSkipped
                    : g.badcond ? kIpsBadCondition
                                : st;
    p.o_idepth_min[k] = p.idepth_min[k];
    p.o_idepth_max[k] = p.idepth_max[k];
    p.o_quality[k] = p.quality[k];
    p.o_pixel_interval[k] = p.pixel_interval[k];
    p.flags[k] = static_cast<unsigned char>(flag | (want << 1) | (def << 2));
  }
  if (stamp) stamp[0] = clock64() - t0;
  t0 = clock64();
  grid.sync();                           // every lane's flags written
  if (stamp) stamp[1] = clock64() - t0;
  t0 = clock64();

  // ---- the compaction, in every block: the searching lanes in row-major
  // order into the first `budget` positions (block 0 also counts)
  int before = 0, wanting = 0, deferred = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int k = base + tid;
    const unsigned f = k < n ? p.flags[k] : 0u;
    const bool flag = (f & 1u) != 0;
    const unsigned bal = __ballot_sync(kFull, flag);
    if (lane == 0) s_scan[warp] = __popc(bal);
    if (b == 0) {
      wanting += __syncthreads_count((f & 2u) != 0);
      deferred += __syncthreads_count((f & 4u) != 0);
    } else {
      __syncthreads();
    }
    int warps_before = 0, chunk_total = 0;
    for (int w = 0; w < kWarps; ++w) {
      warps_before += w < warp ? s_scan[w] : 0;
      chunk_total += s_scan[w];
    }
    __syncthreads();                     // s_scan is rewritten next round
    const int r = before + warps_before + __popc(bal & ((1u << lane) - 1u));
    if (flag && r < p.budget) {
      s_lanes[r] = k;
      if (b == 0 && p.lanes) p.lanes[r] = k;
    }
    before += chunk_total;
  }
  const int n_c = min(before, p.budget);
  if (b == 0) {
    if (tid == 0) {
      p.counts[0] = wanting;
      p.counts[1] = static_cast<long long>(max(before - p.budget, 0)) + deferred;
    }
    if (p.lanes)
      for (int j = n_c + tid; j < p.budget; j += kThreads) p.lanes[j] = n;
  }
  __syncthreads();                       // the positions' lanes written
  if (stamp) stamp[2] = clock64() - t0;
  t0 = clock64();

  // ---- phase 2: the search, a warp a compacted position over the grid
  for (int j = b * kWarps + warp; j < n_c; j += G * kWarps) {
    const int k = s_lanes[j];
    search_lane(p, k, k / p.NI, lane, s_tap[warp]);
  }
  if (stamp) stamp[3] = clock64() - t0;
}

}  // namespace

// `grid` is a block an SM (ops/trace.py); the cooperative launch fails
// unless every block is resident with its dynamic shared memory.
DSSLAM_API int dsslam_trace(const TraceParams* params, int grid, cudaStream_t stream) {
  const TraceParams& p = *params;
  if (p.S < 1 || p.S > kMaxSlots || p.NI < 1 || p.budget < 1 ||
      p.budget > p.S * p.NI || p.num_steps < 2 || p.num_steps > kMaxSteps || p.H < 10 ||
      p.W < 10 || p.gn_iters < 0 || static_cast<long long>(p.S) * p.NI > (1 << 24) || grid < 1)
    return cudaErrorInvalidValue;
  const size_t smem = 4 * static_cast<size_t>(p.budget);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  void* args[] = {const_cast<TraceParams*>(params)};
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(trace_kernel),
                                                dim3(grid), dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
