// K16-K18: the windowed BA's state programs (models/ba.py) on the card,
// the small programs around the resident BA launch and the keyframe
// tail's marginalization.
//
// They replace the JAX package's jitted programs of
// direct_stereo_slam_tpu/models/ba.py (XLA programs, no Pallas kernel):
//   K16 dsslam_window_pose      <- :125-133 BAState.T_current, aff_current,
//                                  calib_current; :895 current_views; the
//                                  inverse and T_rh of :988 template_inputs
//                                  (and models/frontend.py:71-81's T_nh)
//   K17 dsslam_ba_prologue      <- :908 _compact_points (and ops/ba.py's
//                                  host_groups)
//       dsslam_ba_epilogue      <- :755 set_new_frame_energy_th_from_lin,
//                                  :778 reset_fej_newest, :953
//                                  optimize_keyframe's drop, :936
//                                  _scatter_points
//   K18 dsslam_marginalize      <- :796 marginalize_points, :832
//                                  drop_points, :838 marginalize_frame
// The port's plain versions: ops/window.py::window_pose_plain,
// models/ba.py::optimize_keyframe_plain and marginalize_plain.
//
// What bounds them on the H100: each moves at most a few hundred KB (K17's
// compaction: the pool's rows once, ~0.4 MB at NP = 4096; K18: the flagged
// points' pixels, their Hfd rows and HM) and does at most a few million
// operations, so every one is bound by its latency (its launch, its chain
// of barriers), not by bytes or operations.
//
// Design (no atomics: two runs give the same bits).
// - K16: one block, a warp a slot. Lane 0 forms se3_exp(delta[:6]) with
//   lie.cuh's se3_exp on a float whose every operation is rounded on its
//   own (rn::Rf: the plain version's operations are separate launches,
//   nothing fused), lanes 0-15 an entry of exp @ T_zero (the four
//   products summed left to right), then of the rigid inverse (R^T,
//   -R^T t); after one barrier lanes 0-15 an entry of T_all[ref] @
//   T_inv[h]. One output buffer (T_all | T_inv | T_rh | aff | calib) that
//   K12's and K15's wrappers read as views.
// - K17's prologue: one block of 1024 threads. The stable valid-first rank
//   is a block scan of each thread's count of valid points (a valid point's
//   row is the valid points before it, an invalid one's the valid total
//   plus the invalid points before it); the host groups are two block
//   scans of four 16-bit per-host counters packed in a 64-bit word. Its
//   epilogue: block 0 the newest slot's threshold (a bitonic sort of the
//   energies' order-preserving keys in shared memory, NaN last, then
//   torch.nanquantile's rank and lerp), the FEJ reset (K16's T_current)
//   and the frame outputs; the other blocks a thread a pool point (the
//   drop and the scatter). Two launches around the resident one, not its
//   last phase: the resident launch keeps its registers for the LM loop,
//   and the prologue must finish before its first pixel pass anyway.
// - K18: one cooperative launch of 512-thread blocks. Block 0 lists the
//   flagged points (ascending, and grouped by host as host_groups does);
//   K9's pixel pass (ba_lin.cuh) runs over them alone, a (chunk, target,
//   host) item on each 256-thread half, its chunks summed in rank order,
//   each flagged point's Hfd row by K9's point_row; the Schur sums H_sc and
//   b_sc a thread an entry over the flagged points in ascending order; then
//   block 0 updates HM and bM with x0 and marginalizes each flagged frame
//   in the loop's order: the anchor's prior, the 8x8 inverse by
//   Gauss-Jordan with partial pivoting in one warp (a row a lane), the
//   rank-8 update, the slot's bookkeeping. Four grid barriers.

#include "ba_lin.cuh"
#include "plain_ops.cuh"

namespace dsslam {
namespace rn {

// A float whose every operation is rounded on its own (no contraction into
// a fused multiply-add), with PyTorch's division by a number: the
// reciprocal, then the product. lie.cuh's templates take it by argument-
// dependent lookup of val / sqrt_ / sin_ / cos_.
struct Rf {
  float v;
  Rf() = default;
  __device__ Rf(float x) : v(x) {}
};
__device__ __forceinline__ Rf operator+(Rf a, Rf b) { return Rf(add(a.v, b.v)); }
__device__ __forceinline__ Rf operator-(Rf a, Rf b) { return Rf(sub(a.v, b.v)); }
__device__ __forceinline__ Rf operator*(Rf a, Rf b) { return Rf(mul(a.v, b.v)); }
__device__ __forceinline__ Rf operator/(Rf a, Rf b) { return Rf(dvd(a.v, b.v)); }
__device__ __forceinline__ Rf operator-(Rf a) { return Rf(-a.v); }
__device__ __forceinline__ Rf operator+(float a, Rf b) { return Rf(add(a, b.v)); }
__device__ __forceinline__ Rf operator-(float a, Rf b) { return Rf(sub(a, b.v)); }
__device__ __forceinline__ Rf operator/(Rf a, float b) { return Rf(mul(a.v, __frcp_rn(b))); }
__device__ __forceinline__ float val(Rf x) { return x.v; }
__device__ __forceinline__ Rf sqrt_(Rf x) { return Rf(__fsqrt_rn(x.v)); }
__device__ __forceinline__ Rf sin_(Rf x) { return Rf(sinf(x.v)); }
__device__ __forceinline__ Rf cos_(Rf x) { return Rf(cosf(x.v)); }

}  // namespace rn
}  // namespace dsslam

namespace {

using dsslam::rn::Rf;
namespace rn = dsslam::rn;

// ---------------------------------------------------------------------------
// K16: the window's poses
// ---------------------------------------------------------------------------

// Entry (i, k) of A @ B for 4x4 row-major A, B: the four products summed
// left to right, each operation rounded (the plain version's broadcast
// products and sums)
__device__ __forceinline__ float mat4_entry(const float* A, const float* B, int i, int k) {
  float v = rn::mul(A[4 * i], B[k]);
  v = rn::add(v, rn::mul(A[4 * i + 1], B[4 + k]));
  v = rn::add(v, rn::mul(A[4 * i + 2], B[8 + k]));
  return rn::add(v, rn::mul(A[4 * i + 3], B[12 + k]));
}

// se3_exp(xi) as a 4x4 row-major matrix (bottom row 0 0 0 1)
__device__ __forceinline__ void exp4(const float* xi, float* E) {
  Rf x[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) x[k] = Rf(xi[k]);
  const dsslam::Pose<Rf> P = dsslam::se3_exp(x);
#pragma unroll
  for (int k = 0; k < 12; ++k) E[k] = P.m[k].v;
  E[12] = 0.f;
  E[13] = 0.f;
  E[14] = 0.f;
  E[15] = 1.f;
}

// entry e (< 16) of the rigid inverse of the 4x4 T: (R^T, -R^T t)
__device__ __forceinline__ float inv4_entry(const float* T, int e) {
  const int i = e >> 2, j = e & 3;
  if (i == 3) return j == 3 ? 1.f : 0.f;
  if (j < 3) return T[4 * j + i];
  float v = rn::mul(T[i], T[3]);
  v = rn::add(v, rn::mul(T[4 + i], T[7]));
  v = rn::add(v, rn::mul(T[8 + i], T[11]));
  return -v;
}

struct PoseParams {
  int W, ref;
  const float* T_zero;       // [W, 4, 4]
  const float* delta;        // [W, 8]
  const float* aff_zero;     // [W, 2]
  const float* calib_zero;   // [4]
  const float* calib_delta;  // [4]
  float* out;                // [W, 16] T_all | [W, 16] T_inv | [W, 16] T_rh | [W, 2] aff | [4]
};

constexpr int kPoseThreads = 32 * kMaxSlots;

__global__ void __launch_bounds__(kPoseThreads) window_pose_kernel(const PoseParams p) {
  __shared__ float sE[kMaxSlots][16], sT[kMaxSlots][16], sI[kMaxSlots][16];
  const int W = p.W, lane = threadIdx.x & 31, f = threadIdx.x >> 5;
  float* T_all = p.out;
  float* T_inv = p.out + 16 * W;
  float* T_rh = p.out + 32 * W;
  float* aff = p.out + 48 * W;
  float* calib = p.out + 50 * W;
  if (f < W) {
    if (lane == 0) exp4(p.delta + 8 * f, sE[f]);
    __syncwarp();
    if (lane < 16) {
      const float v = mat4_entry(sE[f], p.T_zero + 16 * f, lane >> 2, lane & 3);
      sT[f][lane] = v;
      T_all[16 * f + lane] = v;
    } else if (lane < 18) {
      const int k = lane - 16;
      aff[2 * f + k] = rn::add(p.aff_zero[2 * f + k], p.delta[8 * f + 6 + k]);
    } else if (f == 0 && lane >= 24 && lane < 28) {
      const int k = lane - 24;
      calib[k] = rn::add(p.calib_zero[k], p.calib_delta[k]);
    }
    __syncwarp();
    if (lane < 16) {
      const float v = inv4_entry(sT[f], lane);
      sI[f][lane] = v;
      T_inv[16 * f + lane] = v;
    }
  }
  __syncthreads();
  if (f < W && lane < 16)
    T_rh[16 * f + lane] = mat4_entry(sT[p.ref], sI[f], lane >> 2, lane & 3);
}

// ---------------------------------------------------------------------------
// block scans (no atomics)
// ---------------------------------------------------------------------------

// The exclusive prefix of v over the block's threads in thread order, and
// its total; sh holds 32 words; every thread must call it.
template <typename T>
__device__ __forceinline__ T block_exclusive_scan(T v, T* sh, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T w = lane < nwarps ? sh[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    sh[lane] = w;
  }
  __syncthreads();
  const T before = warp > 0 ? sh[warp - 1] : T(0);
  total = sh[nwarps - 1];
  __syncthreads();
  return before + x - v;
}

// The points i of [0, n) with keep(i) grouped by host (host(i) in [0, W)),
// each group in ascending i, into pts, and the groups' offsets into off
// [W + 1] (ops/ba.py::host_groups' order): each thread counts its range of
// i per host, as four 16-bit counters in each of two 64-bit words, which
// two block scans rank. n < 65536.
template <class Keep, class Host>
__device__ __forceinline__ void group_by_host(int n, int W, Keep keep, Host host, int* pts,
                                              int* off, unsigned long long* sh) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int per = (n + T - 1) / T, lo = min(tid * per, n), hi = min(lo + per, n);
  unsigned long long c[2] = {0ull, 0ull};
  for (int i = lo; i < hi; ++i)
    if (keep(i)) {
      const int h = host(i);
      c[h >> 2] += 1ull << (16 * (h & 3));
    }
  unsigned long long tot[2];
  const unsigned long long ex0 = block_exclusive_scan(c[0], sh, tot[0]);
  const unsigned long long ex1 = block_exclusive_scan(c[1], sh, tot[1]);
  int base[kMaxSlots];
  int acc = 0;
#pragma unroll
  for (int h = 0; h < kMaxSlots; ++h) {
    const int t_h = static_cast<int>((tot[h >> 2] >> (16 * (h & 3))) & 0xffffull);
    const int e_h = static_cast<int>(((h < 4 ? ex0 : ex1) >> (16 * (h & 3))) & 0xffffull);
    if (tid == 0 && h <= W) off[h] = acc;
    base[h] = acc + e_h;
    acc += h < W ? t_h : 0;
  }
  if (tid == 0 && W == kMaxSlots) off[kMaxSlots] = acc;
  for (int i = lo; i < hi; ++i)
    if (keep(i)) {
      const int h = host(i);
      int slot = 0;
#pragma unroll
      for (int g = 0; g < kMaxSlots; ++g)
        if (g == h) slot = base[g]++;
      pts[slot] = i;
    }
}

// ---------------------------------------------------------------------------
// K17: around optimize_keyframe's resident launch
// ---------------------------------------------------------------------------

struct KfParams {
  int W, NP, B, compact, newest;
  float q, fac, c_const, c_keep, w2, fallback;
  // the pool (inputs)
  const unsigned char* p_valid;
  const long long* p_host;
  const float* p_u;
  const float* p_v;
  const float* p_idepth;
  const float* p_idepth_zero;
  const float* p_color;
  const float* p_weight;
  const float* p_prior;
  const unsigned char* p_res_good;
  const float* p_num_good;
  const int* p_last_res;
  const float* calib_delta;
  const float* delta;
  const float* T_zero;
  const float* energy_th;
  // the compact view: the prologue's outputs, the resident launch's inputs
  unsigned char* c_valid;
  long long* c_host;
  float* c_u;
  float* c_v;
  float* c_idepth_zero;
  float* c_color;
  float* c_weight;
  float* c_prior;
  unsigned char* c_res_good;
  float* c_num_good;
  int* c_last_res;
  float* s_calib_delta[3];
  float* s_delta[3];
  float* s_idepth[3];
  int* host_pts;   // [B]
  int* host_off;   // [W + 1]
  int* rows;       // [B]: the pool row of each compact row
  int* pos;        // [NP]: the compact row of each pool row, -1 for none
  long long* n_dropped;
  // the resident launch's accepted buffer and bookkeeping (the epilogue's inputs)
  const float* l_pair_energy;
  const unsigned char* l_pair_in;
  const unsigned char* l_pair_good;
  const float* l_Hdd;
  const float* o_num_good;
  const int* o_last_res;
  const float* o_rmse;
  const unsigned char* o_ok;
  // the epilogue's outputs
  float* T_zero_out;
  float* delta_out;
  float* calib_delta_out;
  float* energy_th_out;
  float* p_idepth_out;
  unsigned char* p_valid_out;
  unsigned char* p_res_good_out;
  float* p_num_good_out;
  int* p_last_res_out;
  float* hdd_out;
  float* rmse_out;
  unsigned char* ok_out;
};

constexpr int kKfThreads = 1024;
constexpr int kSortMax = 8192;         // the threshold's keys in shared memory

__global__ void __launch_bounds__(kKfThreads) ba_prologue_kernel(const KfParams p) {
  __shared__ int shi[32];
  __shared__ unsigned long long shl[32];
  const int NP = p.NP, B = p.B, W = p.W, T = blockDim.x, tid = threadIdx.x;
  const int per = (NP + T - 1) / T, lo = min(tid * per, NP), hi = min(lo + per, NP);
  if (p.compact) {
    int cnt = 0;
    for (int i = lo; i < hi; ++i) cnt += p.p_valid[i] != 0;
    int total;
    const int before = block_exclusive_scan(cnt, shi, total);
    int rv = before, ri = total + (lo - before);
    for (int i = lo; i < hi; ++i) {
      const int r = p.p_valid[i] ? rv++ : ri++;
      p.pos[i] = r < B ? r : -1;
      if (r < B) p.rows[r] = i;
    }
    if (tid == 0) *p.n_dropped = total > B ? total - B : 0;
  } else {
    for (int i = lo; i < hi; ++i) {
      p.pos[i] = i;
      p.rows[i] = i;
    }
    if (tid == 0) *p.n_dropped = 0;
  }
  __syncthreads();                       // rows (global) complete for the block
  for (int r = tid; r < B; r += T) {
    const int i = p.rows[r];
    p.c_valid[r] = p.p_valid[i];
    p.c_host[r] = p.p_host[i];
    p.c_u[r] = p.p_u[i];
    p.c_v[r] = p.p_v[i];
    p.c_idepth_zero[r] = p.p_idepth_zero[i];
    p.c_prior[r] = p.p_prior[i];
    p.c_num_good[r] = p.p_num_good[i];
    p.c_last_res[2 * r] = p.p_last_res[2 * i];
    p.c_last_res[2 * r + 1] = p.p_last_res[2 * i + 1];
    const float id = p.p_idepth[i];
    for (int k = 0; k < 3; ++k) p.s_idepth[k][r] = id;
  }
  for (int e = tid; e < B * 8; e += T) {
    const int r = e >> 3, k = e & 7, i = p.rows[r];
    p.c_color[e] = p.p_color[8 * i + k];
    p.c_weight[e] = p.p_weight[8 * i + k];
  }
  for (int e = tid; e < B * W; e += T) {
    const int r = e / W, t = e % W;
    p.c_res_good[e] = p.p_res_good[static_cast<size_t>(p.rows[r]) * W + t];
  }
  if (tid < 4 + 8 * W) {
    const float v = tid < 4 ? p.calib_delta[tid] : p.delta[tid - 4];
    for (int k = 0; k < 3; ++k) {
      if (tid < 4) p.s_calib_delta[k][tid] = v;
      else p.s_delta[k][tid - 4] = v;
    }
  }
  group_by_host(
      B, W, [](int) { return true; },
      [&](int r) { return static_cast<int>(p.p_host[p.rows[r]]); }, p.host_pts, p.host_off, shl);
}

// a float's order-preserving key (NaN last, as torch.sort places it)
__device__ __forceinline__ unsigned sort_key(float x) {
  if (isnan(x)) return 0xffffffffu;
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  if (k == 0xffffffffu) return __int_as_float(0x7fc00000);
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ATen's lerp (a + w (b - a) below w = 0.5, else b - (b - a)(1 - w)), as
// its kernel is compiled: the product and the sum fused
__device__ __forceinline__ float aten_lerp(float a, float b, float w) {
  const float d = b - a;
  return fabsf(w) < 0.5f ? __fmaf_rn(w, d, a) : __fmaf_rn(-d, 1.f - w, b);
}

__global__ void __launch_bounds__(kKfThreads) ba_epilogue_kernel(const KfParams p) {
  const int W = p.W, NP = p.NP, tid = threadIdx.x;
  if (blockIdx.x > 0) {
    // a thread a pool point: the drop of points left without a good
    // residual, and the compact rows scattered back into the pool
    const int i = (blockIdx.x - 1) * blockDim.x + tid;
    if (i >= NP) return;
    const int r = p.pos[i];
    if (r >= 0) {
      const unsigned char valid = p.c_valid[r];
      bool any = false;
      for (int t = 0; t < W; ++t) {
        const unsigned char g = p.l_pair_good[static_cast<size_t>(r) * W + t];
        p.p_res_good_out[static_cast<size_t>(i) * W + t] = g;
        any |= g && valid;
      }
      p.p_valid_out[i] = valid && any;
      p.p_idepth_out[i] = p.s_idepth[2][r];
      p.p_num_good_out[i] = p.o_num_good[r];
      p.p_last_res_out[2 * i] = p.o_last_res[2 * r];
      p.p_last_res_out[2 * i + 1] = p.o_last_res[2 * r + 1];
      p.hdd_out[i] = p.l_Hdd[r];
    } else {
      for (int t = 0; t < W; ++t)
        p.p_res_good_out[static_cast<size_t>(i) * W + t] =
            p.p_res_good[static_cast<size_t>(i) * W + t];
      p.p_valid_out[i] = p.p_valid[i];
      p.p_idepth_out[i] = p.p_idepth[i];
      p.p_num_good_out[i] = p.p_num_good[i];
      p.p_last_res_out[2 * i] = p.p_last_res[2 * i];
      p.p_last_res_out[2 * i + 1] = p.p_last_res[2 * i + 1];
      p.hdd_out[i] = 0.f;
    }
    return;
  }
  // block 0: the newest slot's energy threshold (a linear-interpolated
  // nanquantile of its pairs' energies), the FEJ reset, the frame outputs
  __shared__ unsigned keys[kSortMax];
  __shared__ float sE[16];
  __shared__ float sTh;
  const int B = p.B, nw = p.newest;
  int n2 = 1;
  while (n2 < B) n2 <<= 1;
  for (int r = tid; r < n2; r += blockDim.x) {
    unsigned k = 0xffffffffu;
    if (r < B) {
      const size_t pw = static_cast<size_t>(r) * W + nw;
      k = sort_key(p.l_pair_in[pw] ? p.l_pair_energy[pw] : __int_as_float(0x7fc00000));
    }
    keys[r] = k;
  }
  __syncthreads();
  // bitonic sort, ascending
  for (int k = 2; k <= n2; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n2; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned a = keys[i], b = keys[l];
          if (((i & k) == 0) == (a > b)) {
            keys[i] = b;
            keys[l] = a;
          }
        }
      }
      __syncthreads();
    }
  if (tid == 0) {
    // the non-NaN count: the first NaN key's position
    int lo = 0, hi = n2;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (keys[mid] == 0xffffffffu) hi = mid;
      else lo = mid + 1;
    }
    const int count = lo;
    float rank = __fmul_rn(p.q, static_cast<float>(count - 1));
    if (rank < 0.f) rank = 0.f;
    const int below = static_cast<int>(rank);
    const int above = static_cast<int>(ceilf(rank));
    const float w = rank - static_cast<float>(below);
    const float nth = aten_lerp(key_value(keys[below]), key_value(keys[above]), w);
    float th = isfinite(nth) ? __fsqrt_rn(nth) : p.fallback;
    th = rn::mul(th, p.fac);
    th = rn::add(rn::mul(th, p.c_keep), p.c_const);
    th = rn::mul(rn::mul(th, th), p.w2);
    sTh = th;
    exp4(p.s_delta[2] + 8 * nw, sE);
  }
  __syncthreads();
  if (tid < 16 * W) {
    const int f = tid >> 4, e = tid & 15;
    p.T_zero_out[tid] = f == nw ? mat4_entry(sE, p.T_zero + 16 * nw, e >> 2, e & 3)
                                : p.T_zero[tid];
  }
  if (tid < 8 * W) {
    const int f = tid >> 3, k = tid & 7;
    p.delta_out[tid] = f == nw && k < 6 ? 0.f : p.s_delta[2][tid];
  }
  if (tid < W) p.energy_th_out[tid] = tid == nw ? sTh : p.energy_th[tid];
  if (tid < 4) p.calib_delta_out[tid] = p.s_calib_delta[2][tid];
  if (tid == 0) {
    *p.rmse_out = *p.o_rmse;
    *p.ok_out = *p.o_ok;
  }
}

// ---------------------------------------------------------------------------
// K18: the keyframe tail's marginalization
// ---------------------------------------------------------------------------

struct MargParams {
  BaParams ba;                   // the state's K9 inputs; buffer 0: the state's, the
                                 // linearization's and the scratch
  const unsigned char* flags;    // [NP]: bit 0 marginalize, bit 1 drop
  const float* Hdd;              // [NP]: the tail's linearization's
  const float* calib_delta;      // [4]: x0's calibration part
  int points;                    // fold the flagged points into (HM, bM)
  int n_slots;
  int slots[kMaxSlots];          // the frames to marginalize, in order
  float marg_w;                  // cfg.ba.marg_weight_fac
  int* mlist;                    // [NP + 1]: the flagged points, ascending, then their count
  float* Hsc;                    // [D, D]
  float* bsc;                    // [D]
  float* HM_out;
  float* bM_out;
  unsigned char* frame_valid_out;
  int* frame_id_out;
  float* delta_out;
  unsigned char* p_valid_out;
  unsigned char* p_res_good_out;
};

constexpr int kMargThreads = 512;

__device__ __noinline__ void marg_pixel(const BaParams& p, int item, int half, int htid) {
  extern __shared__ float4 dyn4[];
  PixSmem& sm = reinterpret_cast<PixSmem*>(dyn4)[half];
  const int W = p.W;
  const int c = item % kChunks, t = (item / kChunks) % W, s = item / (kChunks * W);
  pixel_pass(p, 0, c, t, s, htid, sm, 2 + half, nullptr);
  group_sync(2 + half);
  float* dst = p.chunk_part + static_cast<size_t>(item) * kHE;
  for (int i = htid; i < kHE; i += kLinThreads) dst[i] = sm.out[i];
}

// Block 0's last phase: HM and bM with the flagged points folded in, then
// each flagged frame marginalized in order (models/ba.py's
// marginalize_frame), in shared memory.
__device__ __noinline__ void marg_frames(const MargParams& m) {
  extern __shared__ float4 dyn4[];
  const BaParams& p = m.ba;
  const int W = p.W, D = 4 + 8 * W, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  float* sH = reinterpret_cast<float*>(dyn4);      // [D * D]
  float* sAb = sH + kMaxD * kMaxD;                 // [D, 8]: Hab
  float* sK = sAb + kMaxD * 8;                     // [D, 8]: Hab @ inv(Hbb)
  float* sB = sK + kMaxD * 8;                      // [D]
  float* sX = sB + kMaxD;                          // [D]: x0
  float* sInv = sX + kMaxD;                        // [8, 8]
  float* sY = sInv + 64;                           // [8]
  __shared__ int sValid[kMaxSlots], sId[kMaxSlots];
  for (int e = tid; e < D * D; e += blockDim.x) {
    float h = p.HM[e];
    if (m.points) h = h + m.marg_w * (p.Hff[0][e] - m.Hsc[e]);
    sH[e] = h;
  }
  for (int d = tid; d < D; d += blockDim.x) sX[d] = d < 4 ? m.calib_delta[d] : p.delta[0][d - 4];
  if (tid < W) {
    sValid[tid] = p.frame_valid[tid];
    sId[tid] = p.frame_id[tid];
  }
  __syncthreads();
  // bM + db - dH x0, a warp a row (dH's row summed in lane order, then a
  // shuffle tree)
  for (int i = warp; i < D; i += nwarps) {
    float s = 0.f;
    if (m.points)
      for (int j = lane; j < D; j += 32)
        s += m.marg_w * (p.Hff[0][i * D + j] - m.Hsc[i * D + j]) * sX[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) {
      float b = p.bM[i];
      if (m.points) b = (b + m.marg_w * (p.bf[0][i] - m.bsc[i])) - s;
      sB[i] = b;
    }
  }
  __syncthreads();
  for (int q = 0; q < m.n_slots; ++q) {
    const int slot = m.slots[q], i0 = 4 + 8 * slot;
    // the anchor: the oldest valid frame (torch.argmin: the first of equals)
    int anchor = 0, best = 1 << 30;
    for (int f = 0; f < W; ++f) {
      const int fid = sValid[f] ? sId[f] : (1 << 30);
      if (fid < best) {
        best = fid;
        anchor = f;
      }
    }
    if (anchor == slot && tid < 8) sH[(i0 + tid) * D + i0 + tid] += 1e8f;
    __syncthreads();
    for (int e = tid; e < D * 8; e += blockDim.x) {
      const int i = e >> 3, k = e & 7;
      const bool keep = i < i0 || i >= i0 + 8;
      sAb[e] = keep ? sH[i * D + i0 + k] : sH[i * D + i0 + k] * 0.f;
    }
    if (warp == 0) {
      // inv(Hbb + 1e-8 I) by Gauss-Jordan with partial pivoting: lane r < 8
      // holds row r of [Hbb | I]
      float a[16];
      const int r = lane & 7;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        a[k] = sH[(i0 + r) * D + i0 + k] + (k == r ? 1e-8f : 0.f);
        a[8 + k] = k == r ? 1.f : 0.f;
      }
      bool used = lane >= 8;
      int piv_of[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        // the pivot: the unused row of largest |a[c]| (NaN first, then the
        // lower row on ties)
        float key = used ? -1.f : (isnan(a[c]) ? __int_as_float(0x7f800000) : fabsf(a[c]));
        int who = lane;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const float k2 = __shfl_xor_sync(kFull, key, o);
          const int w2 = __shfl_xor_sync(kFull, who, o);
          if (k2 > key || (k2 == key && w2 < who)) {
            key = k2;
            who = w2;
          }
        }
        piv_of[c] = who;
        float prow[16];
        const float pv = __shfl_sync(kFull, a[c], who);
#pragma unroll
        for (int k = 0; k < 16; ++k) prow[k] = __shfl_sync(kFull, a[k], who) / pv;
        if (lane == who) {
#pragma unroll
          for (int k = 0; k < 16; ++k) a[k] = prow[k];
          used = true;
        } else {
          const float f = a[c];
#pragma unroll
          for (int k = 0; k < 16; ++k) a[k] = a[k] - f * prow[k];
        }
      }
      // row c of the inverse: the right half of column c's pivot row
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (lane == piv_of[c])
#pragma unroll
          for (int k = 0; k < 8; ++k) sInv[8 * c + k] = a[8 + k];
    }
    __syncthreads();
    for (int e = tid; e < D * 8; e += blockDim.x) {
      const int i = e >> 3, k = e & 7;
      float v = 0.f;
#pragma unroll
      for (int l = 0; l < 8; ++l) v += sAb[8 * i + l] * sInv[8 * l + k];
      sK[e] = v;
    }
    if (tid < 8) {
      float v = 0.f;
#pragma unroll
      for (int l = 0; l < 8; ++l) v += sInv[8 * tid + l] * sB[i0 + l];
      sY[tid] = v;
    }
    __syncthreads();
    for (int e = tid; e < D * D; e += blockDim.x) {
      const int i = e / D, j = e % D;
      const bool keep = (i < i0 || i >= i0 + 8) && (j < i0 || j >= i0 + 8);
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) v += sK[8 * i + k] * sAb[8 * j + k];
      sH[e] = keep ? sH[e] - v : 0.f;
    }
    for (int i = tid; i < D; i += blockDim.x) {
      const bool keep = i < i0 || i >= i0 + 8;
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) v += sAb[8 * i + k] * sY[k];
      sB[i] = keep ? sB[i] - v : 0.f;
    }
    if (tid == 0) {
      sValid[slot] = 0;
      sId[slot] = -1;
    }
    __syncthreads();
  }
  for (int e = tid; e < D * D; e += blockDim.x) m.HM_out[e] = sH[e];
  for (int d = tid; d < D; d += blockDim.x) m.bM_out[d] = sB[d];
}

__global__ void __launch_bounds__(kMargThreads, 1) marg_kernel(const __grid_constant__ MargParams m) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long shl[32];
  __shared__ int shi[32];
  const BaParams& p = m.ba;
  cg::grid_group grid = cg::this_grid();
  const int W = p.W, NP = p.NP, D = 4 + 8 * W, tid = threadIdx.x;
  const int half = tid >> 8, htid = tid & (kLinThreads - 1), lane = tid & 31, warp = tid >> 5;
  const int nblk = gridDim.x;
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const long long gthreads = static_cast<long long>(nblk) * blockDim.x;
  unsigned slot_bits = 0;
  for (int q = 0; q < m.n_slots; ++q) slot_bits |= 1u << m.slots[q];

  // the outputs that need no sums: validity, the slots' bookkeeping
  for (long long i = gtid; i < NP; i += gthreads) {
    const int pt = static_cast<int>(i);
    const bool in_slot = (slot_bits >> static_cast<int>(p.p_host[pt])) & 1u;
    m.p_valid_out[pt] = p.p_valid[pt] && (m.flags[pt] & 3) == 0 && !in_slot;
  }
  for (long long e = gtid; e < static_cast<long long>(NP) * W; e += gthreads) {
    const int t = static_cast<int>(e % W);
    m.p_res_good_out[e] = ((slot_bits >> t) & 1u) ? 0 : p.p_res_good[e];
  }
  if (gtid < W) {
    const int f = static_cast<int>(gtid);
    const bool out = (slot_bits >> f) & 1u;
    m.frame_valid_out[f] = out ? 0 : p.frame_valid[f];
    m.frame_id_out[f] = out ? -1 : p.frame_id[f];
  }
  if (gtid < 8 * W) {
    const int f = static_cast<int>(gtid) >> 3;
    m.delta_out[gtid] = ((slot_bits >> f) & 1u) ? 0.f : p.delta[0][gtid];
  }

  if (m.points) {
    // the flagged points: ascending (the Schur sums' order) and grouped by
    // host (the pixel pass's lists), by block 0
    auto flagged = [&](int i) { return (m.flags[i] & 1) && p.p_valid[i]; };
    if (blockIdx.x == 0) {
      const int T = blockDim.x, per = (NP + T - 1) / T;
      const int lo = min(tid * per, NP), hi = min(lo + per, NP);
      int cnt = 0;
      for (int i = lo; i < hi; ++i) cnt += flagged(i);
      int total;
      int at = block_exclusive_scan(cnt, shi, total);
      for (int i = lo; i < hi; ++i)
        if (flagged(i)) m.mlist[at++] = i;
      if (tid == 0) m.mlist[NP] = total;
      group_by_host(
          NP, W, flagged, [&](int i) { return static_cast<int>(p.p_host[i]); },
          const_cast<int*>(p.host_pts), const_cast<int*>(p.host_off), shl);
    }
    grid.sync();
    // K9's pixel pass over them: (chunk, target, host) items on the halves
    const int items = kChunks * W * W;
    for (int k = 2 * blockIdx.x + half; k < items; k += 2 * nblk) marg_pixel(p, k, half, htid);
    grid.sync();
    // the chunks in rank order into the (s, t) blocks, and each flagged
    // point's Hfd row, Hdd and bd
    for (int st_ = blockIdx.x; st_ < W * W; st_ += nblk) {
      const float* part = p.chunk_part + static_cast<size_t>(st_) * kChunks * kHE;
      int hbad = 0, bbad = 0;
      if (tid < kHE) {
        const float v = chunk_sum([&](int r) { return part + r * kHE; }, tid);
        p.lin_part[static_cast<size_t>(st_) * kHE + tid] = v;
        hbad = tid < kHU && !isfinite(v);
        bbad = tid >= kHU && tid < kHB && !isfinite(v);
      }
      hbad = __syncthreads_or(hbad);
      bbad = __syncthreads_or(bbad);
      if (tid == 0) p.lin_part[static_cast<size_t>(W) * W * kHE + st_] = block_flag(hbad, bbad);
    }
    float (*sG)[kMaxSlots * kG] = reinterpret_cast<float (*)[kMaxSlots * kG]>(smem4);
    const int nm = m.mlist[NP];
    for (int q = blockIdx.x * (blockDim.x >> 5) + warp; q < nm;
         q += nblk * (blockDim.x >> 5))
      point_row(p, 0, m.mlist[q], lane, sG[warp]);
    grid.sync();
    // Hff and bf from the reduced blocks; the Schur sums over the flagged
    // points in ascending order, a thread an entry of the upper triangle
    // or of b
    const int U = D * (D + 1) / 2;
    const int sum_blocks = ((U + D + 1) * kMaxSlots + kFinThreads - 1) / kFinThreads;
    for (int vb = 2 * blockIdx.x + half; vb < sum_blocks; vb += 2 * nblk)
      finish_block(p, 0, vb, sum_blocks, htid, sG + half * (kFinThreads / 32), nullptr);
    // 16 lanes an entry, lane l summing the points l, l + 16, ..., then a
    // fixed shuffle tree; a warp takes two entries a round
    const int sub = lane & 15;
    const long long gwarps = gthreads >> 5;
    for (long long base = 2 * (gtid >> 5); base < U + D; base += 2 * gwarps) {
      const long long e = base + (lane >> 4);
      const bool live = e < U + D;
      int i = 0, j = 0;
      if (live && e < U) upper_ij_fast(static_cast<int>(e), D, i, j);
      else if (live) i = static_cast<int>(e - U);
      float v = 0.f;
      if (live) {
#pragma unroll 4
        for (int q = sub; q < nm; q += 16) {
          const int pt = m.mlist[q];
          const float h = m.Hdd[pt];
          const float inv = h > 1e-10f ? 1.f / h : 0.f;
          const float* row = p.Hfd[0] + static_cast<size_t>(pt) * D;
          v += e < U ? (row[i] * inv) * row[j] : row[i] * (inv * p.bd[0][pt]);
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
      if (live && sub == 0) {
        if (e < U) {
          m.Hsc[i * D + j] = v;
          m.Hsc[j * D + i] = v;
        } else {
          m.bsc[i] = v;
        }
      }
    }
    grid.sync();
  }
  if (blockIdx.x == 0) marg_frames(m);
}

size_t marg_smem() {
  const size_t pix = 2 * sizeof(PixSmem);
  const size_t fin = sizeof(float) * (kMargThreads / 32) * kMaxSlots * kG;
  const size_t frames = sizeof(float) * (kMaxD * kMaxD + 2 * kMaxD * 8 + 2 * kMaxD + 64 + 8);
  size_t s = pix;
  if (fin > s) s = fin;
  if (frames > s) s = frames;
  return s;
}

}  // namespace

// K16: the window's current poses, their rigid inverses, T_rh toward slot
// ref, the affine parameters and the intrinsics, into one buffer.
DSSLAM_API int dsslam_window_pose(const PoseParams* p, cudaStream_t stream) {
  if (p->W < 1 || p->W > kMaxSlots || p->ref < 0 || p->ref >= p->W) return cudaErrorInvalidValue;
  window_pose_kernel<<<1, kPoseThreads, 0, stream>>>(*p);
  return cudaGetLastError();
}

// K17: the compact view and its host groups before the resident launch ...
DSSLAM_API int dsslam_ba_prologue(const KfParams* p, cudaStream_t stream) {
  if (p->W < 1 || p->W > kMaxSlots || p->B < 1 || p->B > p->NP || p->B >= 65536)
    return cudaErrorInvalidValue;
  ba_prologue_kernel<<<1, kKfThreads, 0, stream>>>(*p);
  return cudaGetLastError();
}

// ... and the threshold, the FEJ reset, the drop and the scatter after it.
DSSLAM_API int dsslam_ba_epilogue(const KfParams* p, cudaStream_t stream) {
  if (p->W < 1 || p->W > kMaxSlots || p->B > kSortMax || p->newest < 0 || p->newest >= p->W)
    return cudaErrorInvalidValue;
  const int blocks = 1 + (p->NP + kKfThreads - 1) / kKfThreads;
  ba_epilogue_kernel<<<blocks, kKfThreads, 0, stream>>>(*p);
  return cudaGetLastError();
}

// K18: the keyframe tail's point and frame marginalization, one
// cooperative launch of `grid` blocks (at most one an SM).
DSSLAM_API int dsslam_marginalize(const MargParams* m, int grid, cudaStream_t stream) {
  if (m->ba.W < 1 || m->ba.W > kMaxSlots || m->ba.NP < 1 || m->ba.NP >= 65536 ||
      m->n_slots < 0 || m->n_slots > kMaxSlots || grid < 1)
    return cudaErrorInvalidValue;
  const size_t smem = marg_smem();
  cudaError_t err = cudaFuncSetAttribute(marg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<MargParams*>(m)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(marg_kernel), dim3(grid),
                                    dim3(kMargThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
