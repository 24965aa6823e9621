// K12 and K13: a keyframe's activation of immature candidates, on the card.
//
// K12 `gate_activate_kernel` replaces the JAX package's hand-written XLA
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
// K13 `allocate_insert_kernel` replaces `_allocate_candidates` (:190),
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
// 256, W = 8 frames, pool B = 4096): K12 reads ~0.3 MB of candidates and
// takes 4 passes x 8 frames x 2048 lanes x 8 pattern pixels = 524288
// bilinear samples of 4 taps x 12 B: 25 MB of loads, mostly L2 hits (the
// taps of a pattern share lines, and the 3 steps sample around the same
// projection), over far fewer distinct image bytes (chip_smoke.py's act
// phase counts them on a call); either is a few microseconds or less at
// 3.35 TB/s. Its time is the latency of 4 dependent passes of gathers, a
// division chain and warp reductions a lane. Design: one block of 512
// threads per (slot, 16 compacted lanes): every block of a slot computes
// the slot's gate on all NI lanes (cheap, from the same bits, so the
// blocks agree) and the stable compaction by a block scan, then each warp
// runs one compacted lane's LM, a thread per (frame, pattern pixel) term
// (2 frames a thread), the sums in a fixed shuffle order: 128 blocks, one
// wave. K13 moves ~0.7 MB (the pool's rows copied to the new state); its
// time is one block's sequential walk over the slots (a few scans of the
// pool's free mask a slot). No atomics: two runs give the same bits.

#include <cstdint>

#include "common.cuh"

namespace {

using dsslam::clamp_min;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWin = 8;               // window frames (2 a thread)
constexpr int kGateThreads = 512;
constexpr int kGateWarps = kGateThreads / 32;
constexpr int kAllocThreads = 1024;

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
  const float* proj;                     // [S, 12]: KRKi1 row-major, then Kt1
  const float* images;                   // [Wn, Himg, Wimg, 3]
  const unsigned char* frame_valid;      // [Wn]
  // [Wn, 4, 4] poses and their inverses (torch.linalg.inv_ex's, as the
  // plain version computes them), [Wn, 2], [4], [Wn]
  const float *T_cw, *T_wc, *aff, *calib, *exposure;
  const float *pat_u, *pat_v;            // [8]
  unsigned char* ok;                     // [S, budget]
  float* idepth;                         // [S, budget]
  long long* lane;                       // [S, budget]
  unsigned char* drop;                   // [S, NI]
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
};

// the plain version's operations one at a time, each rounded (PyTorch
// runs each as its own kernel: no fused multiply-add between them)
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// number / tensor in PyTorch: the reciprocal, then the product
__device__ __forceinline__ float num_over(float n, float x) { return mul(__frcp_rn(x), n); }
// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}
// torch.minimum(x, hi) with NaN kept
__device__ __forceinline__ float min_keep_nan(float x, float hi) { return x > hi ? hi : x; }

// ops/interp.py's bilinear read of an [H, W, 3] (I, dx, dy) image, with
// its borders (dsslam::sample3's: the coordinates clamped to [0, umax] x
// [0, vmax], a NaN one reads NaN) and its roundings: each lerp's products
// and sum rounded one at a time, as the plain version's separate
// operations are (sample3 lets the compiler fuse them)
__device__ __forceinline__ void sample3_rn(const float* __restrict__ img, int W, float umax,
                                           float vmax, float u, float v, float& i0, float& gx,
                                           float& gy) {
  const bool nan_uv = isnan(u) || isnan(v);
  u = fminf(fmaxf(u, 0.f), umax);
  v = fminf(fmaxf(v, 0.f), vmax);
  const float fu = floorf(u), fv = floorf(v);
  const int ix = static_cast<int>(fu), iy = static_cast<int>(fv);
  const float fx = sub(u, fu), fy = sub(v, fv);
  const float gx1 = sub(1.f, fx), gy1 = sub(1.f, fy);
  const float* p00 = img + 3 * (iy * W + ix);
  const float* p10 = p00 + 3;
  const float* p01 = p00 + 3 * W;
  const float* p11 = p01 + 3;
  float out[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float top = add(mul(p00[c], gx1), mul(p10[c], fx));
    const float bot = add(mul(p01[c], gx1), mul(p11[c], fx));
    out[c] = add(mul(top, gy1), mul(bot, fy));
  }
  const float qnan = __int_as_float(0x7fc00000);
  i0 = nan_uv ? qnan : out[0];
  gx = nan_uv ? qnan : out[1];
  gy = nan_uv ? qnan : out[2];
}

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

__global__ void __launch_bounds__(kGateThreads) gate_activate_kernel(const GateParams p) {
  extern __shared__ unsigned char s_gate[];          // [NI]
  __shared__ int s_scan[kGateWarps];
  __shared__ int s_lane[kGateWarps];
  __shared__ Pair s_pair[kMaxWin];
  const int s = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.y * kGateWarps;
  const bool writer = blockIdx.y == 0;
  if (tid < p.Wn) pair_setup(p, s, tid, s_pair[tid]);
  if (tid < kGateWarps) s_lane[tid] = 0;

  // the gate on every lane of the slot
  int n_ok = 0;
  for (int base = 0; base < p.NI; base += kGateThreads) {
    const int i = base + tid;
    bool g = false, d = false;
    if (i < p.NI) {
      gate_lane(p, s, i, g, d);
      s_gate[i] = g;
      if (writer) p.drop[static_cast<size_t>(s) * p.NI + i] = d;
    }
    n_ok += __syncthreads_count(g);
  }
  // the stable compaction: survivors in lane order, then the rest; this
  // block keeps the lanes of its compacted positions j0 ... j0 + 15
  int ok_before = 0;
  for (int base = 0; base < p.NI; base += kGateThreads) {
    const int i = base + tid;
    const bool g = i < p.NI && s_gate[i] != 0;
    int total;
    const int r_ok = block_rank<kGateThreads>(g, ok_before, s_scan, total);
    if (i < p.NI) {
      const int rank = g ? r_ok : n_ok + (i - r_ok);
      if (rank >= j0 && rank < j0 + kGateWarps) s_lane[rank - j0] = i;
    }
    ok_before += total;
  }
  __syncthreads();

  // the idepth LM, a warp a compacted lane
  const int j = j0 + warp;
  if (j >= p.budget) return;             // the whole warp
  const int i = s_lane[warp];
  const size_t k = static_cast<size_t>(s) * p.NI + i;
  const int kp = lane & 7;
  const float fx = p.calib[0], fy = p.calib[1], cx = p.calib[2], cy = p.calib[3];
  Cand c;
  c.xh = dvd(sub(add(p.u[k], p.pat_u[kp]), cx), fx);
  c.yh = dvd(sub(add(p.v[k], p.pat_v[kp]), cy), fy);
  c.color = p.color[k * 8 + kp];
  c.wpat = mul(p.weight[k * 8 + kp], p.weight[k * 8 + kp]);
  const float id0 = clamp(mul(0.5f, add(p.idepth_min[k], min_keep_nan(p.idepth_max[k], 1e3f))),
                          1e-4f, 1e3f);
  float H, b, E;
  int n_good;
  residual_pass(p, s_pair, c, id0, lane, H, b, E, n_good);
  float idep = id0, lam = 0.1f;
  for (int it = 0; it < 3; ++it) {
    const float stp = dvd(-b, clamp_min(mul(H, add(1.f, lam)), 1e-9f));
    const float nid = clamp(add(idep, stp), 1e-5f, 50.f);
    float H2, b2, E2;
    int n2;
    residual_pass(p, s_pair, c, nid, lane, H2, b2, E2, n2);
    const bool better = E2 < E;
    idep = better ? nid : idep;
    lam = better ? mul(lam, 0.5f) : mul(lam, 4.f);
    H = better ? H2 : H;
    b = better ? b2 : b;
    E = better ? E2 : E;
    n_good = better ? n2 : n_good;
  }
  if (lane == 0) {
    const bool ok = s_gate[i] != 0 && p.valid[k] != 0 && n_good >= 1 && H > p.min_h_act &&
                    idep > 1e-5f && isfinite(E);
    const size_t o = static_cast<size_t>(s) * p.budget + j;
    p.ok[o] = ok;
    p.idepth[o] = idep;
    p.lane[o] = i;
  }
}

// n bytes from src to dst by the block (16 bytes a thread where both are
// aligned and n is a multiple of 16)
__device__ __forceinline__ void copy_bytes(void* dst, const void* src, size_t n) {
  const bool wide = ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src) |
                      n) & 15u) == 0;
  if (wide) {
    int4* d = static_cast<int4*>(dst);
    const int4* s = static_cast<const int4*>(src);
    for (size_t i = threadIdx.x; i < n / 16; i += blockDim.x) d[i] = s[i];
  } else {
    unsigned char* d = static_cast<unsigned char*>(dst);
    const unsigned char* s = static_cast<const unsigned char*>(src);
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
  }
}

__global__ void __launch_bounds__(kAllocThreads) allocate_insert_kernel(const AllocParams p) {
  extern __shared__ int s_dyn[];
  int* s_pick = s_dyn;                                       // [budget]
  unsigned char* s_free = reinterpret_cast<unsigned char*>(s_dyn + p.budget);  // [B]
  __shared__ int s_scan[kAllocThreads / 32];
  const int tid = threadIdx.x;
  const int B = p.B, W = p.W, NI = p.NI, BUD = p.budget;

  // the pool and the immature set as they stand, and empty outputs
  copy_bytes(p.o_valid, p.p_valid, B);
  copy_bytes(p.o_host, p.p_host, B * sizeof(long long));
  copy_bytes(p.o_u, p.p_u, B * sizeof(float));
  copy_bytes(p.o_v, p.p_v, B * sizeof(float));
  copy_bytes(p.o_idepth, p.p_idepth, B * sizeof(float));
  copy_bytes(p.o_idepth_zero, p.p_idepth_zero, B * sizeof(float));
  copy_bytes(p.o_color, p.p_color, B * 8 * sizeof(float));
  copy_bytes(p.o_weight, p.p_weight, B * 8 * sizeof(float));
  copy_bytes(p.o_prior, p.p_prior, B * sizeof(float));
  copy_bytes(p.o_res_good, p.p_res_good, static_cast<size_t>(B) * W);
  copy_bytes(p.o_num_good, p.p_num_good, B * sizeof(float));
  copy_bytes(p.o_last_res, p.p_last_res, B * 2 * sizeof(int));
  for (int r = tid; r < B; r += kAllocThreads) {
    s_free[r] = p.p_valid[r] == 0;
    p.src_slot[r] = p.src_sub[r] = p.src_lane[r] = p.dst[r] = p.host[r] = 0;
    p.alloc_valid[r] = 0;
  }
  for (int i = tid; i < p.S * NI; i += kAllocThreads) p.consumed[i] = 0;
  __syncthreads();

  int n_fill = 0;
  for (int s = 0; s < p.S; ++s) {
    if (((p.participate >> s) & 1) == 0) continue;       // the same for every thread
    const int lo = s * p.P, hi = (s + 1) * p.P;
    int n_own = 0, n_free = 0, n_acc = 0;
    for (int base = 0; base < B; base += kAllocThreads) {
      const int r = base + tid;
      const bool f = r < B && s_free[r] != 0;
      n_own += __syncthreads_count(f && r >= lo && r < hi);
      n_free += __syncthreads_count(f);
    }
    for (int base = 0; base < BUD; base += kAllocThreads) {
      const int jj = base + tid;
      n_acc += __syncthreads_count(jj < BUD && p.ok[static_cast<size_t>(s) * BUD + jj] != 0);
    }
    const int k = min(min(n_free, n_acc), B - n_fill);
    // the first k free rows in (own segment, then the rest) ascending order
    int own_before = 0, out_before = 0;
    for (int base = 0; base < B; base += kAllocThreads) {
      const int r = base + tid;
      const bool f = r < B && s_free[r] != 0;
      const bool own = r >= lo && r < hi;
      int t_own, t_out;
      const int r_own = block_rank<kAllocThreads>(f && own, own_before, s_scan, t_own);
      const int r_out = block_rank<kAllocThreads>(f && !own, out_before, s_scan, t_out);
      if (f) {
        const int idx = own ? r_own : n_own + r_out;
        if (idx < k) s_pick[idx] = r;
      }
      own_before += t_own;
      out_before += t_out;
    }
    // the consumed row: the dropped lanes, then the placed ones
    for (int i = tid; i < NI; i += kAllocThreads)
      p.consumed[static_cast<size_t>(s) * NI + i] = p.drop[static_cast<size_t>(s) * NI + i];
    __syncthreads();
    int acc_before = 0;
    for (int base = 0; base < BUD; base += kAllocThreads) {
      const int jj = base + tid;
      const size_t o = static_cast<size_t>(s) * BUD + jj;
      const bool acc = jj < BUD && p.ok[o] != 0;
      int total;
      const int rank = block_rank<kAllocThreads>(acc, acc_before, s_scan, total);
      if (acc && rank < k) {
        const int g = n_fill + rank, d = s_pick[rank];
        const long long ln = p.lane[o];
        p.src_slot[g] = s;
        p.src_sub[g] = jj;
        p.src_lane[g] = ln;
        p.dst[g] = d;
        p.host[g] = s;
        p.alloc_valid[g] = 1;
        s_free[d] = 0;
        p.consumed[static_cast<size_t>(s) * NI + ln] = 1;
      }
      acc_before += total;
    }
    n_fill += k;
    __syncthreads();
  }

  // the placed candidates into their pool rows, the consumed ones out of
  // the immature set
  for (int g = tid; g < n_fill; g += kAllocThreads) {
    const int d = static_cast<int>(p.dst[g]);
    const size_t c = static_cast<size_t>(p.src_slot[g]) * NI + p.src_lane[g];
    const float idep = p.idepth[static_cast<size_t>(p.src_slot[g]) * BUD + p.src_sub[g]];
    p.o_valid[d] = 1;
    p.o_host[d] = p.host[g];
    p.o_u[d] = p.u[c];
    p.o_v[d] = p.v[c];
    p.o_idepth[d] = idep;
    p.o_idepth_zero[d] = idep;
    for (int m = 0; m < 8; ++m) {
      p.o_color[static_cast<size_t>(d) * 8 + m] = p.color[c * 8 + m];
      p.o_weight[static_cast<size_t>(d) * 8 + m] = p.weight[c * 8 + m];
    }
    p.o_prior[d] = 0.f;
    for (int t = 0; t < W; ++t) p.o_res_good[static_cast<size_t>(d) * W + t] = 1;
    p.o_num_good[d] = 0.f;
    p.o_last_res[2 * d] = 0;             // RES_IN
    p.o_last_res[2 * d + 1] = 0;
  }
  for (int i = tid; i < p.S * NI; i += kAllocThreads)
    p.o_imm_valid[i] = p.imm_valid[i] != 0 && p.consumed[i] == 0;
}

}  // namespace

DSSLAM_API int dsslam_gate_activate(const GateParams* params, cudaStream_t stream) {
  const GateParams& p = *params;
  if (p.S < 1 || p.S > 32 || p.NI < 1 || p.budget < 1 || p.budget > p.NI || p.Wn < 1 ||
      p.Wn > kMaxWin || p.h2 < 1 || p.w2 < 1 || p.NI > 48 * 1024)
    return cudaErrorInvalidValue;
  const dim3 grid(p.S, (p.budget + kGateWarps - 1) / kGateWarps);
  gate_activate_kernel<<<grid, kGateThreads, p.NI, stream>>>(p);
  return cudaGetLastError();
}

DSSLAM_API int dsslam_allocate_insert(const AllocParams* params, cudaStream_t stream) {
  const AllocParams& p = *params;
  if (p.S < 1 || p.S > 32 || p.budget < 1 || p.NI < 1 || p.B < 1 || p.W < 1 || p.P < 0)
    return cudaErrorInvalidValue;
  const size_t smem = p.budget * sizeof(int) + p.B;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  allocate_insert_kernel<<<1, kAllocThreads, smem, stream>>>(p);
  return cudaGetLastError();
}
