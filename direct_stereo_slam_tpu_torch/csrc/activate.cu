// K12 and K13: a keyframe's activation of immature candidates, on the card.
//
// K12 `gate_cluster_kernel` replaces the JAX package's hand-written XLA
// program direct_stereo_slam_tpu/models/frontend.py:149
// `_gate_compact_activate` (with `_gate_impl`, :97, and
// models/immature.py:709 `activate_points_all`): over the window's stacked
// [S, NI] candidates, the activation gate (the pre-gates of
// `can_activate`, the half-res projection with the mid idepth, K1's
// distance map read with the frac(ptp[0]) dither, the unclipped bounds
// test, the deletion mask `drop`), the stable lane-order compaction of the
// survivors into `budget` lanes a slot (`argsort(~gate_ok, stable)`:
// survivors in lane order, then the rest in lane order), and on those
// lanes the 1-D inverse-depth LM against every window frame (one pass at
// the mid idepth, then 3 damped steps with a pass each; Huber weights,
// pair gates at 8 x outlier_th, the threshold penalty, lambda x0.5 / x4).
// Its plain version is ops/activate.py::gate_compact_activate_plain.
//
// K13 `alloc_cluster_kernel` replaces `_allocate_candidates` (:190),
// `_insert_candidates_all` (:252) and `_consume_candidates` (:268): slots
// in ascending order, each slot's accepted lanes (compacted order) take
// the slot's own free pool rows first (ascending), then any other free row
// (ascending), capped by the pool's capacity; the chosen rows of the point
// pool are written and the consumed candidates (dropped, or placed) leave
// the immature set. Its plain version is
// ops/activate.py::allocate_insert_consume_plain; all integer, so the two
// are bit-equal.
//
// What bounds them on the H100 (KITTI, preset 0: S = 8, NI = 1024, budget
// 256, W = 8 frames, pool B = 4096). Neither is near a bandwidth or
// arithmetic bound (the e2e run's fullest call: K12 needs ~0.45 MB and
// ~4 M f32 operations, 0.13 us; K13 moves ~0.9 MB of pool rows, 0.35 us):
// both are chains of dependent steps.
//
// K12 (`gate_cluster_kernel`): a slot's gate and compaction are one
// block's work (NI lanes, a block scan), and the LM a lane is 4 dependent
// residual passes of gathers, a division chain and warp reductions (~2-3
// us each). The LM matters only on the gate's survivors: the final `ok`
// is the gate's AND the LM's, and K13 reads the idepth of accepted lanes
// only (the e2e run's fullest call: 203 survivors of 2048 compacted
// lanes). Design: one 8-block cluster of 1024 threads per slot. Rank 0
// evaluates the gate on the slot's NI lanes once, writes `drop`, and
// compacts by a block scan (survivors in lane order, then the rest); it
// writes the outputs of every position j >= n_ok itself (ok = 0, its
// lane, idepth NaN: no output reads it) and each survivor's lane straight
// into the shared memory of the block that runs position j = q * 8 +
// rank (distributed shared memory; a barrier phase begun at the start
// makes sure every block has started), and n_ok into every block's. After
// one cluster barrier warp q of each block runs position j's LM
// (`lane_lm`), 256 warps a slot: up to `budget` = 256 survivors in one
// wave. `lm_ran` (optional, [S, budget]) gets 1 where a warp ran the LM, 0
// elsewhere. The per-slot warps KRKi1 / Kt1 come in the launch's
// parameters (`__grid_constant__`), not through an upload.
//
// K13 (`alloc_cluster_kernel`): the allocation is sequential in the slots
// and each slot's picks depend on the free rows the slots before it left;
// the copy is ~0.9 MB. Design: one 8-block cluster of 512 threads. Rank 0
// keeps the free mask as B / 32 words and each slot's `ok` row as budget /
// 32 words in shared memory, and one warp walks the slots: per slot a
// lane counts its 4 words' free rows in and outside the slot's own
// segment and its ok words' accepted lanes with __popc, three warp prefix
// sums rank them, and the lanes take the first k = min(free, accepted,
// B - filled) rows (own segment first, each ascending) by their set bits,
// clear them and pair them with the accepted lanes in compacted order: a
// few shuffles a slot, no block barrier. When every participating slot's
// own segment holds its accepted lanes (the common case: then no slot
// takes another's rows), a warp takes each slot, in parallel, its
// placements numbered by the slots' prefix sums; the same result. It
// publishes each pool row's
// source (the old row or candidate o = slot * budget + sub), each
// placement's row and a byte per (slot, lane) placed. Meanwhile every
// block copies the rows of its eighth of the pool that were valid (no
// slot can take them); after one cluster barrier each block writes its
// eighth's free rows (the placed candidate or the old row), its eighth of
// the allocation and of the candidates' consumption and validity, reading
// rank 0's tables over distributed shared memory: every row written once,
// coalesced, on 8 SMs. All integer: K13 is bit-equal to the plain
// version.
//
// `stamps` (optional) gets clock64 phase deltas of thread 0 of each block
// (kGateStamps, kPoolStamps; chip_smoke.py's act phase prints them). No
// atomics: two runs give the same bits.

#include <cstdint>

#include <cooperative_groups.h>

#include "common.cuh"
#include "plain_ops.cuh"

namespace cg = cooperative_groups;

namespace {

using dsslam::clamp_min;
using namespace dsslam::rn;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWin = 8;               // window frames (2 a thread)
constexpr int kRanks = 8;                // blocks of a K12 / K13 cluster
constexpr int kActThreads = 1024;        // K12's cluster blocks: 32 LM warps each
constexpr int kActWarps = kActThreads / 32;
constexpr int kPoolThreads = 512;        // K13's cluster blocks
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxSlots = 32;            // the slot bitmasks' width
// phase stamps (clock64 deltas of thread 0 of a block), with `stamps` set;
// a stamped launch runs the same barriers as one without:
// K12 per (slot, block): rank 0's gate, compaction and writes; the cluster
// barrier; warp 0's first LM: its set-up, first pass and the 3 steps; warp
// 0's LM positions, all of them; K13 per block: tables, warp 0's part of
// the walk (rank 0), start to the barrier, the rest
constexpr int kGateStamps = 6, kPoolStamps = 4;

// DSO's IPS_* states (models/immature.py)
constexpr int kIpsGood = 0, kIpsOob = 1, kIpsOutlier = 2, kIpsSkipped = 3,
              kIpsBadCondition = 4, kIpsUninitialized = 5;

struct GateParams {
  int S, NI, budget, h2, w2, Wn, Himg, Wimg, host_flagged;
  float min_act_dist, min_trace_quality, th, min_h_act, umax, vmax;
  // the immature set [S, NI] ([S, NI, 8] color and weight)
  const unsigned char* valid;
  const float *u, *v, *idepth_min, *idepth_max, *color, *weight, *quality, *my_type;
  const int* status;
  const float* pixel_interval;
  const float* dist;                     // [h2, w2]
  const float* images;                   // [Wn, Himg, Wimg, 3]
  const unsigned char* frame_valid;      // [Wn]
  // [Wn, 4, 4] poses and their inverses (K16's, csrc/window.cu, which the
  // plain version reads too), [Wn, 2], [4], [Wn]
  const float *T_cw, *T_wc, *aff, *calib, *exposure;
  const float *pat_u, *pat_v;            // [8]
  unsigned char* ok;                     // [S, budget]
  float* idepth;                         // [S, budget]
  long long* lane;                       // [S, budget]
  unsigned char* drop;                   // [S, NI]
  unsigned char* lm_ran;                 // [S, budget] or null: 1 where the LM ran
  long long* stamps;                     // [S, kRanks, kGateStamps] cycles, or null
  float proj[kMaxSlots * 12];            // per slot KRKi1 row-major, then Kt1
};

struct AllocParams {
  int S, budget, NI, P, B, W, participate;
  const unsigned char* ok;               // [S, budget]
  const long long* lane;                 // [S, budget]
  const unsigned char* drop;             // [S, NI]
  const float* idepth;                   // [S, budget]
  const float *u, *v, *color, *weight;   // the immature set's [S, NI] (x 8)
  const unsigned char* imm_valid;
  // the pool [B] (x 8, x W, x 2) before and after
  const unsigned char* p_valid;
  const long long* p_host;
  const float *p_u, *p_v, *p_idepth, *p_idepth_zero, *p_color, *p_weight, *p_prior;
  const unsigned char* p_res_good;
  const float* p_num_good;
  const int* p_last_res;
  unsigned char* o_valid;
  long long* o_host;
  float *o_u, *o_v, *o_idepth, *o_idepth_zero, *o_color, *o_weight, *o_prior;
  unsigned char* o_res_good;
  float* o_num_good;
  int* o_last_res;
  unsigned char* o_imm_valid;            // [S, NI]
  // the allocation itself, as the plain version returns it
  long long *src_slot, *src_sub, *src_lane, *dst, *host;  // [B]
  unsigned char* alloc_valid;            // [B]
  unsigned char* consumed;               // [S, NI]
  long long* stamps;                     // [kRanks, kPoolStamps] cycles, or null
};

// frontend._to_int: NaN -> 0, saturate at +-2^30, truncate
__device__ __forceinline__ long long to_int(float x) {
  if (isnan(x)) return 0;
  x = fminf(fmaxf(x, -1073741824.f), 1073741824.f);
  return static_cast<long long>(x);
}

// One candidate's gate: gate_ok and drop (ops/activate.py::_gate_impl).
__device__ __forceinline__ void gate_lane(const GateParams& p, int s, int i, bool& gate_ok,
                                          bool& drop) {
  const size_t k = static_cast<size_t>(s) * p.NI + i;
  const bool valid = p.valid[k] != 0;
  const int st = p.status[k];
  const float imin = p.idepth_min[k], imax = p.idepth_max[k];
  const bool can = valid &&
                   (st == kIpsGood || st == kIpsSkipped || st == kIpsBadCondition ||
                    st == kIpsOob) &&
                   p.pixel_interval[k] < 8.f && p.quality[k] > p.min_trace_quality &&
                   add(imax, imin) > 0.f && isfinite(imax);
  const float u1 = sub(mul(add(p.u[k], 0.5f), 0.5f), 0.5f);
  const float v1 = sub(mul(add(p.v[k], 0.5f), 0.5f), 0.5f);
  const float id_mid = mul(0.5f, add(imin, min_keep_nan(imax, 1e3f)));
  const float* M = p.proj + 12 * s;
  float ptp[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    // xyz @ KRKi1^T (a dot of 3 in index order), then + Kt1 * id_mid
    const float dot = add(fmaf(v1, M[3 * r + 1], mul(u1, M[3 * r])), M[3 * r + 2]);
    ptp[r] = add(dot, mul(M[9 + r], id_mid));
  }
  const float z = ptp[2];
  const float zs = z == 0.f ? 1e-9f : z;
  const long long gu_raw = to_int(floorf(add(dvd(ptp[0], zs), 0.5f)));
  const long long gv_raw = to_int(floorf(add(dvd(ptp[1], zs), 0.5f)));
  const long long gu = gu_raw < 0 ? 0 : (gu_raw > p.w2 - 1 ? p.w2 - 1 : gu_raw);
  const long long gv = gv_raw < 0 ? 0 : (gv_raw > p.h2 - 1 ? p.h2 - 1 : gv_raw);
  const bool in_b = z > 0.f && gu_raw > 0 && gv_raw > 0 && gu_raw < p.w2 - 1 &&
                    gv_raw < p.h2 - 1;
  const float dither = sub(ptp[0], floorf(ptp[0]));
  const bool gate = add(p.dist[gv * p.w2 + gu], dither) >= mul(p.min_act_dist, p.my_type[k]);
  gate_ok = can && in_b && gate;
  const bool never_traced = !isfinite(imax) && st != kIpsUninitialized;
  const bool flagged = ((p.host_flagged >> s) & 1) != 0;
  drop = valid && (never_traced || st == kIpsOutlier || (!can && (flagged || st == kIpsOob)) ||
                   (can && !in_b));
}

// The (host s, target t) warp and affine transfer of activate_points_all,
// by the block's thread t: Tth = T_cw[t] @ T_wc[s] as rows [R | t] (a dot
// of 4 in index order), a_t, b_t and whether the pair counts.
struct Pair {
  float T[12];
  float a, b;
  int ok;
};

__device__ __forceinline__ void pair_setup(const GateParams& p, int s, int t, Pair& out) {
  const float* Tt = p.T_cw + 16 * t;
  const float* Hi = p.T_wc + 16 * s;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float acc = Tt[4 * r] * Hi[c];
#pragma unroll
      for (int j = 1; j < 4; ++j) acc = fmaf(Tt[4 * r + j], Hi[4 * j + c], acc);
      out.T[4 * r + c] = acc;
    }
  }
  const float a_rel = expf(sub(p.aff[2 * t], p.aff[2 * s]));
  out.a = mul(a_rel, dvd(p.exposure[t], clamp_min(p.exposure[s], 1e-9f)));
  out.b = sub(p.aff[2 * t + 1], mul(out.a, p.aff[2 * s + 1]));
  out.ok = p.frame_valid[t] != 0 && t != s;
}

// One lane's candidate, its pattern pixel k (the thread's lane & 7).
struct Cand {
  float xh, yh, color, wpat;
};

// One residual pass at `idepth` over the lane's W x 8 terms, a thread per
// pattern pixel k and frames t = g, g + 4 (g = lane >> 3): (H, b, E,
// n_good), the same on every lane of the warp.
__device__ __forceinline__ void residual_pass(const GateParams& p, const Pair* pairs,
                                              const Cand& c, float idepth, int lane, float& H,
                                              float& b, float& E, int& n_good) {
  const float fx = p.calib[0], fy = p.calib[1], cx = p.calib[2], cy = p.calib[3];
  const float X[3] = {dvd(c.xh, idepth), dvd(c.yh, idepth), dvd(1.f, idepth)};
  const int g = lane >> 3;
  float h_acc = 0.f, b_acc = 0.f, e_acc = 0.f;
  int n_acc = 0;
#pragma unroll
  for (int m = 0; m < kMaxWin / 4; ++m) {
    const int t = g + 4 * m;
    const bool live = t < p.Wn;
    const Pair& q = pairs[live ? t : 0];
    float pt[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float acc = q.T[4 * r] * X[0];
      acc = fmaf(q.T[4 * r + 1], X[1], acc);
      acc = fmaf(q.T[4 * r + 2], X[2], acc);
      pt[r] = add(acc, q.T[4 * r + 3]);
    }
    const float z = pt[2];
    const float un = dvd(pt[0], z), vn = dvd(pt[1], z);
    const float Ku = add(mul(fx, un), cx), Kv = add(mul(fy, vn), cy);
    const bool inb = Ku > 2.f && Kv > 2.f && Ku < static_cast<float>(p.Wimg - 3) &&
                     Kv < static_cast<float>(p.Himg - 3) && z > 1e-4f;
    float hi = 0.f, dx = 0.f, dy = 0.f;
    if (live)
      sample3_rn(p.images + static_cast<size_t>(t) * p.Himg * p.Wimg * 3, p.Wimg, p.umax,
                 p.vmax, Ku, Kv, hi, dx, dy);
    const float r = sub(hi, add(mul(q.a, c.color), q.b));
    const float ar = fabsf(r);
    const float hw = ar < 9.f ? 1.f : num_over(9.f, clamp_min(ar, 1e-9f));
    const float iz = num_over(1.f, z);
    const float d0 = mul(mul(iz, dx), fx);
    const float d1 = mul(mul(iz, dy), fy);
    const float d2 = mul(-iz, add(mul(mul(un, dx), fx), mul(mul(vn, dy), fy)));
    const float Jd = add(add(mul(d0, dvd(-sub(pt[0], q.T[3]), idepth)),
                             mul(d1, dvd(-sub(pt[1], q.T[7]), idepth))),
                         mul(d2, dvd(-sub(pt[2], q.T[11]), idepth)));
    const float e_pix = inb ? mul(mul(mul(mul(hw, r), r), sub(2.f, hw)), c.wpat) : 0.f;
    // the pair (t): its 8 pixels' energy (a fixed shuffle tree over the
    // lane's group of 8), all in bounds, the gates
    float pe = e_pix;
    pe += __shfl_xor_sync(kFull, pe, 1);
    pe += __shfl_xor_sync(kFull, pe, 2);
    pe += __shfl_xor_sync(kFull, pe, 4);
    const unsigned all_in = __ballot_sync(kFull, inb);
    const bool pair_in = live && q.ok && ((all_in >> (lane & ~7)) & 0xffu) == 0xffu;
    const bool pair_good = pair_in && pe < p.th;
    const float w = mul(mul(pair_good && inb ? 1.f : 0.f, hw), c.wpat);
    if (live) {
      h_acc = add(h_acc, mul(mul(w, Jd), Jd));
      b_acc = add(b_acc, mul(mul(w, Jd), r));
      if ((lane & 7) == 0) {
        e_acc = add(e_acc, pair_good ? pe : (pair_in ? p.th : 0.f));
        n_acc += pair_good ? 1 : 0;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    h_acc += __shfl_xor_sync(kFull, h_acc, off);
    b_acc += __shfl_xor_sync(kFull, b_acc, off);
    e_acc += __shfl_xor_sync(kFull, e_acc, off);
    n_acc += __shfl_xor_sync(kFull, n_acc, off);
  }
  H = h_acc;
  b = b_acc;
  E = e_acc;
  n_good = n_acc;
}

// Candidate k's 1-D idepth LM by the calling warp (activate_points_all):
// one residual pass at the clamped mid idepth, then 3 damped steps with a
// pass each. Returns the LM's accept (n_good >= 1, H above the threshold,
// idepth above 1e-5, a finite energy) and the idepth, the same on every
// lane. `stamp`, K12's stamps of the block, gets the set-up, the first
// pass and the 3 steps in its entries 2-4.
__device__ __forceinline__ bool lane_lm(const GateParams& p, const Pair* pairs, size_t k,
                                        int lane, float& idep, long long* stamp = nullptr) {
  const long long t0 = stamp ? clock64() : 0;
  const int kp = lane & 7;
  const float fx = p.calib[0], fy = p.calib[1], cx = p.calib[2], cy = p.calib[3];
  Cand c;
  c.xh = dvd(sub(add(p.u[k], p.pat_u[kp]), cx), fx);
  c.yh = dvd(sub(add(p.v[k], p.pat_v[kp]), cy), fy);
  c.color = p.color[k * 8 + kp];
  c.wpat = mul(p.weight[k * 8 + kp], p.weight[k * 8 + kp]);
  const float id0 = clamp(mul(0.5f, add(p.idepth_min[k], min_keep_nan(p.idepth_max[k], 1e3f))),
                          1e-4f, 1e3f);
  if (stamp) stamp[2] = clock64() - t0;
  float H, b, E;
  int n_good;
  residual_pass(p, pairs, c, id0, lane, H, b, E, n_good);
  if (stamp) stamp[3] = clock64() - t0 - stamp[2];
  float lam = 0.1f;
  idep = id0;
  for (int it = 0; it < 3; ++it) {
    const float stp = dvd(-b, clamp_min(mul(H, add(1.f, lam)), 1e-9f));
    const float nid = clamp(add(idep, stp), 1e-5f, 50.f);
    float H2, b2, E2;
    int n2;
    residual_pass(p, pairs, c, nid, lane, H2, b2, E2, n2);
    const bool better = E2 < E;
    idep = better ? nid : idep;
    lam = better ? mul(lam, 0.5f) : mul(lam, 4.f);
    H = better ? H2 : H;
    b = better ? b2 : b;
    E = better ? E2 : E;
    n_good = better ? n2 : n_good;
  }
  if (stamp) stamp[4] = clock64() - t0 - stamp[2] - stamp[3];
  return n_good >= 1 && H > p.min_h_act && idep > 1e-5f && isfinite(E);
}

// Block-wide exclusive rank of `pred` among this chunk of the block's
// threads, plus `carry`; returns the chunk's count through `total`.
template <int THREADS>
__device__ __forceinline__ int block_rank(bool pred, int carry, int* scratch, int& total) {
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(kFull, pred);
  if (lane == 0) scratch[warp] = __popc(bal);
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int n = scratch[w];
    before += w < warp ? n : 0;
    all += n;
  }
  __syncthreads();                       // scratch is reused by the next call
  total = all;
  return carry + before + __popc(bal & ((1u << lane) - 1u));
}

// The split cluster barrier: arrive (release: this thread's reads and
// writes before it are done), later wait (acquire) for every thread of
// the cluster to have arrived. A block may leave only after its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// K12: one cluster of kRanks blocks per slot (blockIdx.y). Dynamic shared
// memory: this block's positions' lanes [ceil(budget / kRanks)] (written
// by rank 0), then rank 0's gate bytes [NI] (when NI exceeds the block).
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kActThreads, 1)
    gate_cluster_kernel(const __grid_constant__ GateParams p) {
  extern __shared__ int s_act[];
  __shared__ int s_scan[kActWarps];
  __shared__ int s_nok;
  __shared__ Pair s_pair[kMaxWin];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int BUD = p.budget, NI = p.NI;
  int* s_mine = s_act;
  unsigned char* s_gate =
      reinterpret_cast<unsigned char*>(s_mine + (BUD + kRanks - 1) / kRanks);
  long long* stamp = p.stamps && tid == 0
                        ? p.stamps + (static_cast<size_t>(s) * kRanks + rank) * kGateStamps
                        : nullptr;
  long long t0 = clock64();
  // every block has started once this barrier phase completes: rank 0
  // waits on it only before it writes into the others' shared memory
  cluster_arrive();
  if (tid < p.Wn) pair_setup(p, s, tid, s_pair[tid]);

  if (rank == 0) {
    // the gate on every lane of the slot, once, and the stable
    // compaction: survivors in lane order, then the rest
    int n_ok = 0, ok_before = 0;
    const bool one_pass = NI <= kActThreads;
    if (!one_pass) {
      for (int base = 0; base < NI; base += kActThreads) {
        const int i = base + tid;
        bool g = false, d = false;
        if (i < NI) {
          gate_lane(p, s, i, g, d);
          s_gate[i] = g;
          p.drop[static_cast<size_t>(s) * NI + i] = d;
        }
        n_ok += __syncthreads_count(g);
      }
    }
    cluster_wait();
    for (int base = 0; base < NI; base += kActThreads) {
      const int i = base + tid;
      bool g = false;
      if (one_pass) {
        bool d = false;
        if (i < NI) {
          gate_lane(p, s, i, g, d);
          p.drop[static_cast<size_t>(s) * NI + i] = d;
        }
      } else {
        g = i < NI && s_gate[i] != 0;
      }
      int total;
      const int r_ok = block_rank<kActThreads>(g, ok_before, s_scan, total);
      if (one_pass) n_ok = total;
      if (i < NI) {
        if (g) {
          // position r_ok's lane into the shared memory of the block that runs it
          if (r_ok < BUD) *cluster.map_shared_rank(s_mine + r_ok / kRanks, r_ok % kRanks) = i;
        } else if (n_ok + (i - r_ok) < BUD) {
          const size_t o = static_cast<size_t>(s) * BUD + n_ok + (i - r_ok);
          p.ok[o] = 0;
          p.idepth[o] = __int_as_float(0x7fc00000);
          p.lane[o] = i;
          if (p.lm_ran) p.lm_ran[o] = 0;
        }
      }
      ok_before += total;
    }
    if (tid < kRanks) *cluster.map_shared_rank(&s_nok, tid) = n_ok;
    if (stamp) stamp[0] = clock64() - t0;
  } else {
    cluster_wait();
  }
  t0 = clock64();
  cluster.sync();                        // the lanes and n_ok have landed
  if (stamp) stamp[1] = clock64() - t0;
  t0 = clock64();

  // the idepth LM on the survivors only, a warp a position j = q * kRanks
  // + rank
  const int n_lm = min(s_nok, BUD);
  for (int q = warp; q * kRanks + rank < n_lm; q += kActWarps) {
    const int j = q * kRanks + rank, i = s_mine[q];
    float idep;
    const bool ok = lane_lm(p, s_pair, static_cast<size_t>(s) * NI + i, lane, idep,
                            q == warp ? stamp : nullptr);
    if (lane == 0) {
      const size_t o = static_cast<size_t>(s) * BUD + j;
      p.ok[o] = ok;                      // a survivor passed the gate
      p.idepth[o] = idep;
      p.lane[o] = i;
      if (p.lm_ran) p.lm_ran[o] = 1;
    }
  }
  if (stamp) stamp[5] = clock64() - t0;
}

// K13's shared memory (rank 0's tables; every rank has the same size):
// ints src [B] (a pool row's source: -1 the old row, else the placed
// candidate o = slot * budget + sub), srcln [B] (that candidate's lane),
// gdst [G] (placement g's row, G = min(B, S * budget)), pick [S *
// budget] (each slot's rows in pick order), lanes [S * budget] (K12's lane
// of each position), accpre [S * ceil(budget / 32)] (a slot's accepted
// lanes before each ok word); words free [ceil(B / 32)] and okw [S *
// ceil(budget / 32)]; bytes placed [S * NI], then the inputs' raw p_valid
// [B] and ok [S * budget] bytes.
struct PoolSmem {
  int *src, *srcln, *gdst, *pick, *lanes, *accpre;
  unsigned *free, *okw;
  unsigned char *placed, *vbytes, *okbytes;
};

__host__ __device__ __forceinline__ size_t pool_smem_layout(const AllocParams& p, int* base,
                                                            PoolSmem* sm) {
  const size_t B = p.B, SB = static_cast<size_t>(p.S) * p.budget;
  const size_t G = B < SB ? B : SB, okn = (p.budget + 31) / 32;
  const size_t nw = (B + 31) / 32, okw = static_cast<size_t>(p.S) * okn;
  const size_t n_int = 2 * B + G + 2 * SB + okw + nw + okw;
  if (sm) {
    sm->src = base;
    sm->srcln = sm->src + B;
    sm->gdst = sm->srcln + B;
    sm->pick = sm->gdst + G;
    sm->lanes = sm->pick + SB;
    sm->accpre = sm->lanes + SB;
    sm->free = reinterpret_cast<unsigned*>(sm->accpre + okw);
    sm->okw = sm->free + nw;
    sm->placed = reinterpret_cast<unsigned char*>(sm->okw + okw);
    sm->vbytes = sm->placed + static_cast<size_t>(p.S) * p.NI;
    sm->okbytes = sm->vbytes + B;
  }
  return 4 * n_int + static_cast<size_t>(p.S) * p.NI + B + SB;
}

// The bits of word w that are rows in [lo, hi).
__device__ __forceinline__ unsigned seg_mask(int w, int lo, int hi) {
  const int a = max(lo - 32 * w, 0), e = min(hi - 32 * w, 32);
  if (e <= a) return 0u;
  const unsigned upper = e >= 32 ? kFull : (1u << e) - 1u;
  return upper & ~((1u << a) - 1u);
}

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ int warp_incl(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    x += lane >= off ? y : 0;
  }
  return x;
}

// Slot s's allocation by one warp, its placements numbered from n_fill on;
// a lane holds words [lane * wpl, (lane + 1) * wpl) of the free mask and
// of the slot's ok row. With `own_only` (every slot's own segment holds
// its accepted lanes, so the slots take disjoint rows and go in parallel)
// only the slot's own segment is read or written. Returns its placements.
__device__ __forceinline__ int slot_take(const AllocParams& p, const PoolSmem& sm, int s,
                                         int n_fill, int lane, bool own_only) {
  const int B = p.B, BUD = p.budget, nw = (B + 31) / 32, wpl = (nw + 31) / 32;
  const int okn = (BUD + 31) / 32, opl = (okn + 31) / 32;
  const int lo = s * p.P, hi = (s + 1) * p.P;
  const unsigned* okw = sm.okw + static_cast<size_t>(s) * okn;
  int* pick = sm.pick + static_cast<size_t>(s) * BUD;
  int* accpre = sm.accpre + static_cast<size_t>(s) * okn;
  int c_own = 0, c_oth = 0, c_acc = 0;
  for (int q = 0; q < wpl; ++q) {
    const int w = lane * wpl + q;
    const unsigned m = w < nw ? seg_mask(w, lo, hi) : 0u;
    if (w < nw && (m || !own_only)) {
      const unsigned f = sm.free[w];
      c_own += __popc(f & m);
      c_oth += own_only ? 0 : __popc(f & ~m);
    }
  }
  for (int q = 0; q < opl; ++q) {
    const int w = lane * opl + q;
    if (w < okn) c_acc += __popc(okw[w]);
  }
  const int own_in = warp_incl(c_own, lane), oth_in = warp_incl(c_oth, lane);
  const int acc_in = warp_incl(c_acc, lane);
  const int n_own = __shfl_sync(kFull, own_in, 31), n_oth = __shfl_sync(kFull, oth_in, 31);
  const int n_acc = __shfl_sync(kFull, acc_in, 31);
  const int k = min(min(n_own + n_oth, n_acc), B - n_fill);
  // the first k free rows: the own segment's, then the others', each
  // ascending; their bits cleared
  int r_own = own_in - c_own, r_oth = n_own + oth_in - c_oth;
  for (int q = 0; q < wpl; ++q) {
    const int w = lane * wpl + q;
    if (w >= nw) break;
    const unsigned m = seg_mask(w, lo, hi);
    if (own_only && !m) continue;
    const unsigned f = sm.free[w];
    unsigned take = 0u;
    for (unsigned b = f & m; b && r_own < k; b &= b - 1u) {
      take |= b & (~b + 1u);
      pick[r_own++] = 32 * w + __ffs(b) - 1;
    }
    for (unsigned b = own_only ? 0u : f & ~m; b && r_oth < k; b &= b - 1u) {
      take |= b & (~b + 1u);
      pick[r_oth++] = 32 * w + __ffs(b) - 1;
    }
    // (with `own_only` no later step reads the mask, and a word that two
    // slots' segments share is left alone)
    if (take && !own_only) sm.free[w] = f & ~take;
  }
  // the accepted lanes in compacted order take them: a lane a bit of
  // each ok word, ranked by the words' prefix counts
  int run = acc_in - c_acc;
  for (int q = 0; q < opl; ++q) {
    const int w = lane * opl + q;
    if (w < okn) {
      accpre[w] = run;
      run += __popc(okw[w]);
    }
  }
  __syncwarp();
  for (int w = 0; w < okn; ++w) {
    const int before = accpre[w];
    if (before >= k) break;              // the same on every lane
    const unsigned word = okw[w];
    const int r = before + __popc(word & ((1u << lane) - 1u));
    if (((word >> lane) & 1u) != 0 && r < k) {
      const int o = s * BUD + 32 * w + lane;
      const int d = pick[r], ln = sm.lanes[o];
      sm.src[d] = o;
      sm.srcln[d] = ln;
      sm.gdst[n_fill + r] = d;
      if (ln >= 0 && ln < p.NI) sm.placed[static_cast<size_t>(s) * p.NI + ln] = 1;
    }
  }
  __syncwarp();
  return k;
}

// A pool row's fields, read before any is written: the compiler cannot
// tell the old state's arrays from the new one's, and would otherwise
// wait for each load before the store after it.
constexpr int kRowFlags = 16;             // res_good flags a row holds in registers

struct Row {
  unsigned char valid;
  long long host;
  float u, v, idepth, idepth_zero, prior, num_good;
  float4 color[2], weight[2];
  int last_res[2];
  unsigned char res_good[kRowFlags];     // the first min(W, kRowFlags) flags
  int tail;                              // the flags past them: -1 the old row's, or this
};

__device__ __forceinline__ void load8(const float* src, float4 (&dst)[2], bool vec) {
  if (vec) {
    dst[0] = reinterpret_cast<const float4*>(src)[0];
    dst[1] = reinterpret_cast<const float4*>(src)[1];
  } else {
    dst[0] = make_float4(src[0], src[1], src[2], src[3]);
    dst[1] = make_float4(src[4], src[5], src[6], src[7]);
  }
}

__device__ __forceinline__ void store8(float* dst, const float4 (&src)[2], bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(dst)[0] = src[0];
    reinterpret_cast<float4*>(dst)[1] = src[1];
  } else {
    dst[0] = src[0].x, dst[1] = src[0].y, dst[2] = src[0].z, dst[3] = src[0].w;
    dst[4] = src[1].x, dst[5] = src[1].y, dst[6] = src[1].z, dst[7] = src[1].w;
  }
}

// Row d of the new pool.
__device__ __forceinline__ void store_row(const AllocParams& p, int d, const Row& r,
                                          bool vec) {
  const size_t D = static_cast<size_t>(d);
  p.o_valid[d] = r.valid;
  p.o_host[d] = r.host;
  p.o_u[d] = r.u;
  p.o_v[d] = r.v;
  p.o_idepth[d] = r.idepth;
  p.o_idepth_zero[d] = r.idepth_zero;
  store8(p.o_color + 8 * D, r.color, vec);
  store8(p.o_weight + 8 * D, r.weight, vec);
  p.o_prior[d] = r.prior;
  p.o_num_good[d] = r.num_good;
  p.o_last_res[2 * D] = r.last_res[0];
  p.o_last_res[2 * D + 1] = r.last_res[1];
#pragma unroll
  for (int t = 0; t < kRowFlags; ++t)
    if (t < p.W) p.o_res_good[D * p.W + t] = r.res_good[t];
  for (int t = kRowFlags; t < p.W; ++t)
    p.o_res_good[D * p.W + t] = r.tail < 0 ? p.p_res_good[D * p.W + t] : r.tail;
}

// Pool row d of the old state into the new one.
__device__ __forceinline__ void keep_row(const AllocParams& p, int d, bool vec) {
  const size_t D = static_cast<size_t>(d);
  Row r;
  r.valid = p.p_valid[d];
  r.host = p.p_host[d];
  r.u = p.p_u[d];
  r.v = p.p_v[d];
  r.idepth = p.p_idepth[d];
  r.idepth_zero = p.p_idepth_zero[d];
  load8(p.p_color + 8 * D, r.color, vec);
  load8(p.p_weight + 8 * D, r.weight, vec);
  r.prior = p.p_prior[d];
  r.num_good = p.p_num_good[d];
  r.last_res[0] = p.p_last_res[2 * D];
  r.last_res[1] = p.p_last_res[2 * D + 1];
#pragma unroll
  for (int t = 0; t < kRowFlags; ++t) r.res_good[t] = t < p.W ? p.p_res_good[D * p.W + t] : 0;
  r.tail = -1;
  store_row(p, d, r, vec);
}

// Candidate o = slot * budget + sub, at lane ln, into pool row d.
__device__ __forceinline__ void place_row(const AllocParams& p, int d, int o, int ln, bool vec) {
  const int slot = o / p.budget;
  const size_t c = static_cast<size_t>(slot) * p.NI + ln;
  Row r;
  r.valid = 1;
  r.host = slot;
  r.u = p.u[c];
  r.v = p.v[c];
  r.idepth = r.idepth_zero = p.idepth[o];
  load8(p.color + 8 * c, r.color, vec);
  load8(p.weight + 8 * c, r.weight, vec);
  r.prior = 0.f;
  r.num_good = 0.f;
  r.last_res[0] = r.last_res[1] = 0;     // RES_IN
#pragma unroll
  for (int t = 0; t < kRowFlags; ++t) r.res_good[t] = 1;
  r.tail = 1;
  store_row(p, d, r, vec);
}

// K13: one cluster of kRanks blocks; block r writes the r-th eighth of the
// pool's rows, of the allocation and of the candidates.
__global__ void __cluster_dims__(kRanks, 1, 1) __launch_bounds__(kPoolThreads)
    alloc_cluster_kernel(const AllocParams p) {
  extern __shared__ int s_pool[];
  __shared__ int s_nfill, s_fast;
  __shared__ int s_own[kMaxSlots], s_acc[kMaxSlots], s_first[kMaxSlots];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kPoolThreads / 32;
  const int B = p.B, BUD = p.budget, NI = p.NI;
  PoolSmem sm;
  pool_smem_layout(p, s_pool, &sm);
  const bool vec = ((reinterpret_cast<uintptr_t>(p.p_color) | reinterpret_cast<uintptr_t>(p.p_weight) |
                     reinterpret_cast<uintptr_t>(p.o_color) | reinterpret_cast<uintptr_t>(p.o_weight) |
                     reinterpret_cast<uintptr_t>(p.color) | reinterpret_cast<uintptr_t>(p.weight)) &
                    15u) == 0;
  const int per = (B + kRanks - 1) / kRanks;
  const int r0 = min(B, rank * per), r1 = min(B, r0 + per);
  int copier = tid, copiers = kPoolThreads;    // the threads copying before the barrier
  bool late_copy = false;                       // rank 0 copies after it instead

  long long* stamp = p.stamps && tid == 0 ? p.stamps + rank * kPoolStamps : nullptr;
  const long long t_start = clock64();
  if (rank == 0) {
    // the tables from the inputs (every load in flight at once), then the
    // walk while the idle warps copy
    const int nw = (B + 31) / 32, okn = (BUD + 31) / 32, SB = p.S * BUD;
#pragma unroll 8
    for (int r = tid; r < B; r += kPoolThreads) sm.vbytes[r] = p.p_valid[r];
#pragma unroll 4
    for (int o = tid; o < SB; o += kPoolThreads) {
      sm.okbytes[o] = p.ok[o];
      sm.lanes[o] = static_cast<int>(p.lane[o]);
    }
    for (int r = tid; r < B; r += kPoolThreads) sm.src[r] = -1;
    for (int i = tid; i < p.S * NI; i += kPoolThreads) sm.placed[i] = 0;
    __syncthreads();
    for (int w = warp; w < nw; w += kWarps) {
      const int r = 32 * w + lane;
      const unsigned bits = __ballot_sync(kFull, r < B && sm.vbytes[r] == 0);
      if (lane == 0) sm.free[w] = bits;
    }
    for (int w = warp; w < p.S * okn; w += kWarps) {
      const int s = w / okn, jj = 32 * (w - s * okn) + lane;
      const unsigned bits = __ballot_sync(kFull, jj < BUD && sm.okbytes[s * BUD + jj] != 0);
      if (lane == 0) sm.okw[w] = bits;
    }
    __syncthreads();                     // every word written before another warp reads it
    // each slot's free rows in its own segment and accepted lanes, a warp
    // a slot: when every participating slot's own segment holds its
    // accepted lanes, no slot takes another's rows and the slots go in
    // parallel (their placements numbered by the counts' prefix sums);
    // else one warp walks them in order
    for (int s = warp; s < p.S; s += kWarps) {
      const int lo = s * p.P, hi = (s + 1) * p.P;
      int own = 0, acc = 0;
      if (((p.participate >> s) & 1) != 0) {
        for (int w = max(lo, 0) / 32 + lane; w < nw && 32 * w < hi; w += 32)
          own += __popc(sm.free[w] & seg_mask(w, lo, hi));
        for (int w = lane; w < okn; w += 32) acc += __popc(sm.okw[s * okn + w]);
      }
      for (int off = 16; off > 0; off >>= 1) {
        own += __shfl_xor_sync(kFull, own, off);
        acc += __shfl_xor_sync(kFull, acc, off);
      }
      if (lane == 0) {
        s_own[s] = own;
        s_acc[s] = acc;
      }
    }
    __syncthreads();
    if (tid == 0) {
      int fill = 0;
      bool fast = true;
      for (int s = 0; s < p.S; ++s) {
        s_first[s] = fill;
        fill += s_acc[s];
        fast = fast && s_own[s] >= s_acc[s];
      }
      s_fast = fast;
      s_nfill = fill;
    }
    __syncthreads();
    if (stamp) stamp[0] = clock64() - t_start;
    if (s_fast) {
      for (int s = warp; s < p.S; s += kWarps)
        if (((p.participate >> s) & 1) != 0) slot_take(p, sm, s, s_first[s], lane, true);
      // the warps past the slots copy; with a slot on every warp, the
      // copy waits for the barrier
      const int busy = 32 * min(p.S, kWarps);
      copier = tid - busy;
      copiers = kPoolThreads - busy;
      late_copy = copiers == 0;
    } else {
      if (warp == 0) {
        int n_fill = 0;
        for (int s = 0; s < p.S; ++s)
          if (((p.participate >> s) & 1) != 0) n_fill += slot_take(p, sm, s, n_fill, lane, false);
        if (lane == 0) s_nfill = n_fill;
      }
      copier = tid - 32;
      copiers = kPoolThreads - 32;
    }
    if (stamp) stamp[1] = clock64() - t_start - stamp[0];
  }
  // rows that were valid keep their data (no slot takes them)
  if (copier >= 0 && copiers > 0)
    for (int d = r0 + copier; d < r1; d += copiers)
      if (p.p_valid[d]) keep_row(p, d, vec);
  cluster.sync();
  if (late_copy)
    for (int d = r0 + tid; d < r1; d += kPoolThreads)
      if (p.p_valid[d]) keep_row(p, d, vec);
  const long long t_sync = clock64();
  if (stamp) stamp[2] = t_sync - t_start;

  const int* src = cluster.map_shared_rank(sm.src, 0);
  const int* srcln = cluster.map_shared_rank(sm.srcln, 0);
  const int* gdst = cluster.map_shared_rank(sm.gdst, 0);
  const unsigned char* placed = cluster.map_shared_rank(sm.placed, 0);
  const int n_fill = *cluster.map_shared_rank(&s_nfill, 0);
  // rows that were free: a placed candidate, or the old row
  for (int d = r0 + tid; d < r1; d += kPoolThreads) {
    if (p.p_valid[d]) continue;
    const int o = src[d];
    if (o < 0)
      keep_row(p, d, vec);
    else
      place_row(p, d, o, srcln[d], vec);
  }
  // the allocation, as the plain version returns it
  for (int g = r0 + tid; g < r1; g += kPoolThreads) {
    long long slot = 0, sub = 0, ln = 0, d = 0;
    if (g < n_fill) {
      d = gdst[g];
      const int o = src[d];
      slot = o / BUD;
      sub = o - slot * BUD;
      ln = srcln[d];
    }
    p.src_slot[g] = slot;
    p.src_sub[g] = sub;
    p.src_lane[g] = ln;
    p.dst[g] = d;
    p.host[g] = slot;
    p.alloc_valid[g] = g < n_fill;
  }
  // the candidates: consumed (a participating slot's dropped or placed
  // lanes) leave the immature set
  const int nc = p.S * NI, cper = (nc + kRanks - 1) / kRanks;
  const int c0 = min(nc, rank * cper), c1 = min(nc, c0 + cper);
  for (int c = c0 + tid; c < c1; c += kPoolThreads) {
    const int s = c / NI;
    const bool cons = ((p.participate >> s) & 1) != 0 && (p.drop[c] != 0 || placed[c] != 0);
    p.consumed[c] = cons;
    p.o_imm_valid[c] = p.imm_valid[c] != 0 && !cons;
  }
  cluster.sync();                        // rank 0's tables outlive every read of them
  if (stamp) stamp[3] = clock64() - t_sync;
}

}  // namespace

DSSLAM_API int dsslam_gate_activate(const GateParams* params, cudaStream_t stream) {
  const GateParams& p = *params;
  if (p.S < 1 || p.S > 32 || p.NI < 1 || p.budget < 1 || p.budget > p.NI || p.Wn < 1 ||
      p.Wn > kMaxWin || p.h2 < 1 || p.w2 < 1)
    return cudaErrorInvalidValue;
  const size_t smem = 4 * static_cast<size_t>((p.budget + kRanks - 1) / kRanks) +
                      (p.NI > kActThreads ? static_cast<size_t>(p.NI) : 0);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  gate_cluster_kernel<<<dim3(kRanks, p.S), kActThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

DSSLAM_API int dsslam_allocate_insert(const AllocParams* params, cudaStream_t stream) {
  const AllocParams& p = *params;
  if (p.S < 1 || p.S > 32 || p.budget < 1 || p.NI < 1 || p.B < 1 || p.W < 1 || p.P < 0 ||
      p.B > (1 << 20) || static_cast<long long>(p.S) * p.NI > (1 << 20))
    return cudaErrorInvalidValue;
  const size_t smem = pool_smem_layout(p, nullptr, nullptr);
  if (smem > static_cast<size_t>(kMaxSmem) - 1024) return cudaErrorInvalidValue;
  static size_t granted = 48 * 1024;      // the kernel's dynamic shared memory limit, as set
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        alloc_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  alloc_cluster_kernel<<<kRanks, kPoolThreads, smem, stream>>>(p);
  return cudaGetLastError();
}
