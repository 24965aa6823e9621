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
// of barriers), not by bytes or operations: the designs keep the chains
// short and spread each step over many SMs.
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
// - K17's prologue: one 8-block cluster, each block an eighth of the pool
//   (the stable valid-first rank from the blocks' counts exchanged through
//   distributed shared memory, each block's rows placed and gathered by
//   the block; the host groups from per-(kind, host) 16-bit counters
//   exchanged the same way), two cluster barriers. Its epilogue: block 0
//   the newest slot's threshold (torch.nanquantile's two order statistics
//   by an exact bit-serial select on the energies' order-preserving keys,
//   a block-wide count a bit, no sort; its rank and ATen's lerp), the FEJ
//   reset (K16's T_current) and the frame outputs; the other blocks a
//   thread a pool point (the drop and the scatter). Two launches around
//   the resident one, not its last phase: the resident launch keeps its
//   registers for the LM loop, and the prologue must finish before its
//   first pixel pass anyway.
// - K18: one cooperative launch of 512-thread blocks, three grid barriers,
//   no block working while the others wait. The flagged points' lists
//   (ascending, and grouped by host as host_groups does) come from the
//   host with the flags, in one copy. K9's pixel pass (ba_lin.cuh) runs a
//   (chunk, target, host) item on each 256-thread half, for the hosts with
//   flagged points only (the others' reduced blocks are zeros), its chunks
//   summed in rank order, each flagged point's Hfd row by K9's point_row;
//   the Schur sums by 8x8 tiles of the upper triangle, a block a tile (its
//   Hff entries as finish_block sums them, its Hsc entries by 32 groups of
//   the flagged points through shared memory, summed in group order), each
//   tile writing HM + w (Hff - Hsc) and its terms of dH x0; then block 0
//   sums bM and marginalizes each flagged frame in the loop's order: the
//   anchor's prior, the 8x8 inverse by Gauss-Jordan with partial pivoting
//   in one warp (a row a lane), the rank-8 update, the slot's bookkeeping.
//   Every sum's order is the data's, not the grid's.

#include <atomic>

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

// Phase stamps: lane 0 of every warp writes %globaltimer's ns at phase
// boundary i into timers[(block * warps + warp) * n + i] (ops/window.py
// reads them); null on the main path, which writes nothing.
__device__ __forceinline__ void warp_stamp(unsigned long long* timers, int n, int i) {
  if (timers != nullptr && (threadIdx.x & 31) == 0) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    timers[(static_cast<size_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5)) * n + i] =
        ns;
  }
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
  unsigned long long* pro_timers;   // kProStamps a warp, or null
  unsigned long long* epi_timers;   // kEpiStamps a warp, or null
};

constexpr int kKfThreads = 1024;
constexpr int kProBlocks = 8;          // the prologue's cluster
constexpr int kProRounds = 8;          // NP < 65536: at most 8 rounds of 1024 points a block
constexpr int kKeysPerThread = 16;     // the threshold's keys a thread of the epilogue's block 0
constexpr int kSelectMax = kKfThreads * kKeysPerThread;
constexpr int kProStamps = 6, kEpiStamps = 5;

// The exclusive prefix of 4 words at once over the block's threads in
// thread order, and their totals; sh holds 32 x 4 words.
__device__ __forceinline__ void block_scan4(const unsigned long long (&v)[4],
                                            unsigned long long (&ex)[4],
                                            unsigned long long (&tot)[4],
                                            unsigned long long (*sh)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  unsigned long long x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k] = v[k];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, x[k], o);
      if (lane >= o) x[k] += y;
    }
    if (lane == 31) sh[warp][k] = x[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned long long w = lane < nwarps ? sh[lane][k] : 0ull;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned long long y = __shfl_up_sync(kFull, w, o);
        if (lane >= o) w += y;
      }
      sh[lane][k] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ex[k] = (warp > 0 ? sh[warp - 1][k] : 0ull) + x[k] - v[k];
    tot[k] = sh[nwarps - 1][k];
  }
  __syncthreads();
}

// 16-bit counter h (< 8) of the packed pair of words w[k], w[k + 1]
__device__ __forceinline__ int counter(const unsigned long long* w, int k, int h) {
  const unsigned long long x = (h >> 2) ? w[k + 1] : w[k];
  return static_cast<int>((x >> (16 * (h & 3))) & 0xffffull);
}

// One 8-block cluster; block `rank` takes the pool's rank-th eighth, in
// rounds of a point a thread. (1) Each block counts its kept points (the
// valid ones, or all of them without compaction) and pushes the count
// into every block's shared memory. (2) After a cluster barrier each block
// places its points (a kept point's row is the kept points before it, the
// others' the kept total plus the others before them: torch.sort(stable)
// of the invalid flags), gathers the rows below B into the compact view,
// and counts them per (host, kept or not) as 16-bit counters packed in
// four words, pushed to every block the same way. (3) After a second
// barrier each block writes its rows' places in the host groups: host h's
// kept rows of every block in block order, then its other rows
// (ops/ba.py::host_groups' order on the compact view).
__global__ void __cluster_dims__(kProBlocks, 1, 1) __launch_bounds__(kKfThreads)
    ba_prologue_kernel(const KfParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int shi[32];
  __shared__ unsigned long long sh4[32][4];
  __shared__ int sKept[kProBlocks];                    // each block's kept points
  __shared__ unsigned long long sHost[kProBlocks][4];  // each block's rows per (kind, host)
  const int NP = p.NP, B = p.B, W = p.W, T = blockDim.x, tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const int span = (NP + kProBlocks - 1) / kProBlocks;
  const int blo = min(rank * span, NP), bhi = min(blo + span, NP);
  const int rounds = (bhi - blo + T - 1) / T;
  // every block of the cluster has started before another writes into its
  // shared memory: arrive now, wait just before the first remote write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  warp_stamp(p.pro_timers, kProStamps, 0);
  // (1) the kept points before each of this thread's, within the block
  unsigned kept = 0;                     // bit k: round k's point is kept
  int before[kProRounds];
  int n_kept = 0;
#pragma unroll
  for (int k = 0; k < kProRounds; ++k) {
    if (k >= rounds) break;
    const int i = blo + k * T + tid;
    const bool kp = i < bhi && (!p.compact || p.p_valid[i] != 0);
    kept |= kp ? 1u << k : 0u;
    int tot;
    before[k] = n_kept + block_exclusive_scan(kp ? 1 : 0, shi, tot);
    n_kept += tot;
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < kProBlocks) *cluster.map_shared_rank(&sKept[rank], tid) = n_kept;
  warp_stamp(p.pro_timers, kProStamps, 1);
  cluster.sync();
  warp_stamp(p.pro_timers, kProStamps, 2);
  int base = 0, total = 0;
#pragma unroll
  for (int b = 0; b < kProBlocks; ++b) {
    base += b < rank ? sKept[b] : 0;
    total += sKept[b];
  }
  // (2) the rows: place, gather, count per (kind, host); info[k]: the row,
  // its host (bits 16-18) and kind (bit 19: not kept), or -1; grank[k]: its
  // place among this block's rows of its (kind, host)
  int info[kProRounds], grank[kProRounds];
  unsigned long long cnt[4] = {0ull, 0ull, 0ull, 0ull};
#pragma unroll
  for (int k = 0; k < kProRounds; ++k) {
    if (k >= rounds) break;
    const int i = blo + k * T + tid;
    const bool kp = (kept >> k) & 1u;
    int r = -1, h = 0;
    if (i < bhi) {
      const int kb = base + before[k];           // the kept points before i
      r = kp ? kb : total + (i - kb);
      r = r < B ? r : -1;
      p.pos[i] = r;
    }
    unsigned long long one[4] = {0ull, 0ull, 0ull, 0ull};
    const int kind = kp ? 0 : 2;
    if (r >= 0) {
      h = static_cast<int>(p.p_host[i]);
      p.rows[r] = i;
      p.c_valid[r] = p.p_valid[i];
      p.c_host[r] = h;
      p.c_u[r] = p.p_u[i];
      p.c_v[r] = p.p_v[i];
      p.c_idepth_zero[r] = p.p_idepth_zero[i];
      p.c_prior[r] = p.p_prior[i];
      p.c_num_good[r] = p.p_num_good[i];
      p.c_last_res[2 * r] = p.p_last_res[2 * i];
      p.c_last_res[2 * r + 1] = p.p_last_res[2 * i + 1];
      const float id = p.p_idepth[i];
      for (int s = 0; s < 3; ++s) p.s_idepth[s][r] = id;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        p.c_color[8 * static_cast<size_t>(r) + c] = p.p_color[8 * static_cast<size_t>(i) + c];
        p.c_weight[8 * static_cast<size_t>(r) + c] = p.p_weight[8 * static_cast<size_t>(i) + c];
      }
      for (int t = 0; t < W; ++t)
        p.c_res_good[static_cast<size_t>(r) * W + t] =
            p.p_res_good[static_cast<size_t>(i) * W + t];
#pragma unroll
      for (int w = 0; w < 4; ++w) one[w] = w == kind + (h >> 2) ? 1ull << (16 * (h & 3)) : 0ull;
    }
    unsigned long long ex[4], tot[4];
    block_scan4(one, ex, tot, sh4);
    info[k] = r < 0 ? -1 : r | (h << 16) | (kp ? 0 : 1 << 19);
    grank[k] = kind ? counter(ex, 2, h) + counter(cnt, 2, h) : counter(ex, 0, h) + counter(cnt, 0, h);
#pragma unroll
    for (int w = 0; w < 4; ++w) cnt[w] += tot[w];
  }
  if (rank == 0) {
    if (tid < 4 + 8 * W) {
      const float v = tid < 4 ? p.calib_delta[tid] : p.delta[tid - 4];
      for (int s = 0; s < 3; ++s) {
        if (tid < 4) p.s_calib_delta[s][tid] = v;
        else p.s_delta[s][tid - 4] = v;
      }
    }
    if (tid == 0) *p.n_dropped = p.compact && total > B ? total - B : 0;
  }
  if (tid < kProBlocks * 4) {
    const int w = tid & 3;
    cluster.map_shared_rank(&sHost[rank][0], tid >> 2)[w] =
        w == 0 ? cnt[0] : w == 1 ? cnt[1] : w == 2 ? cnt[2] : cnt[3];
  }
  warp_stamp(p.pro_timers, kProStamps, 3);
  cluster.sync();
  warp_stamp(p.pro_timers, kProStamps, 4);
  // (3) the host groups: host h's kept rows of blocks 0..7, then its others
  int kept_h[kMaxSlots], mine_k[kMaxSlots], mine_o[kMaxSlots], off[kMaxSlots + 1];
  off[0] = 0;
#pragma unroll
  for (int h = 0; h < kMaxSlots; ++h) {
    int tk = 0, to = 0, bk = 0, bo = 0;
#pragma unroll
    for (int b = 0; b < kProBlocks; ++b) {
      const int ck = counter(sHost[b], 0, h), co = counter(sHost[b], 2, h);
      tk += ck;
      to += co;
      bk += b < rank ? ck : 0;
      bo += b < rank ? co : 0;
    }
    kept_h[h] = tk;
    mine_k[h] = bk;
    mine_o[h] = bo;
    off[h + 1] = off[h] + (h < W ? tk + to : 0);
  }
  if (rank == 0 && tid <= W) {
    int o = 0;
#pragma unroll
    for (int h = 0; h <= kMaxSlots; ++h)
      if (h == tid) o = off[h];
    p.host_off[tid] = o;
  }
#pragma unroll
  for (int k = 0; k < kProRounds; ++k) {
    if (k >= rounds) break;
    if (info[k] < 0) continue;
    const int h = (info[k] >> 16) & 7;
    const bool other = (info[k] >> 19) & 1;
    int slot = 0;
#pragma unroll
    for (int g = 0; g < kMaxSlots; ++g)
      if (g == h) slot = off[g] + (other ? kept_h[g] + mine_o[g] : mine_k[g]) + grank[k];
    p.host_pts[slot] = info[k] & 0xffff;
  }
  warp_stamp(p.pro_timers, kProStamps, 5);
}

// The sum over the block of each thread's v, for every thread: warp sums
// into one half of sh (round & 1), a barrier, then every warp sums the
// warps' sums, a lane each. Two halves: a round's reads end before any
// thread passes the next round's barrier, so the round after it may write
// the same half. (An integer sum: its order does not matter.)
__device__ __forceinline__ int block_count(int v, int (*sh)[32], int round) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) sh[round & 1][warp] = v;
  __syncthreads();
  return __reduce_add_sync(kFull, lane < nwarps ? sh[round & 1][lane] : 0);
}

// the least of each thread's v over the block, for every thread (as
// block_count)
__device__ __forceinline__ unsigned block_min(unsigned v, int (*sh)[32], int round) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  v = __reduce_min_sync(kFull, v);
  if (lane == 0) sh[round & 1][warp] = static_cast<int>(v);
  __syncthreads();
  return __reduce_min_sync(
      kFull, lane < nwarps ? static_cast<unsigned>(sh[round & 1][lane]) : 0xffffffffu);
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
  warp_stamp(p.epi_timers, kEpiStamps, 0);
  if (blockIdx.x > 0) {
    // a thread a pool point: the drop of points left without a good
    // residual, and the compact rows scattered back into the pool
    const int i = (blockIdx.x - 1) * blockDim.x + tid;
    if (i >= NP) {
      warp_stamp(p.epi_timers, kEpiStamps, 1);
      return;
    }
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
    warp_stamp(p.epi_timers, kEpiStamps, 1);
    return;
  }
  // block 0: the newest slot's energy threshold (a linear-interpolated
  // nanquantile of its pairs' energies), the FEJ reset, the frame outputs
  __shared__ int sCount[2][32];
  __shared__ float sE[16];
  __shared__ float sTh;
  const int B = p.B, nw = p.newest;
  // this thread's keys (rows tid, tid + 1024, ...; past B a NaN's key)
  unsigned key[kKeysPerThread];
  int n_real = 0;
#pragma unroll
  for (int j = 0; j < kKeysPerThread; ++j) {
    const int r = j * kKfThreads + tid;
    unsigned k = 0xffffffffu;
    if (r < B) {
      const size_t pw = static_cast<size_t>(r) * W + nw;
      k = sort_key(p.l_pair_in[pw] ? p.l_pair_energy[pw] : __int_as_float(0x7fc00000));
    }
    key[j] = k;
    n_real += k != 0xffffffffu;
  }
  if (tid == 32) exp4(p.s_delta[2] + 8 * nw, sE);         // the FEJ reset's se3_exp
  int rnd = 0;
  const int count = block_count(n_real, sCount, rnd++);     // the non-NaN keys
  warp_stamp(p.epi_timers, kEpiStamps, 1);
  float rank = __fmul_rn(p.q, static_cast<float>(count - 1));
  if (rank < 0.f) rank = 0.f;
  const int below = static_cast<int>(rank);
  const int above = static_cast<int>(ceilf(rank));
  // the key of rank `below` (every key past B and every NaN's sorts last,
  // and below < count unless there is no finite key: then it is a NaN's),
  // one bit a round from the top: the keys that share the bits chosen so
  // far and have this one clear are counted; the rank is among them or
  // the bit is set
  unsigned sel = 0;
  int k_rank = below;
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned hi = ~((2u << bit) - 1u);     // the bits above `bit` (none for 31)
    int c = 0;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j)
      c += ((key[j] ^ sel) & hi) == 0u && ((key[j] >> bit) & 1u) == 0u;
    const int n = block_count(c, sCount, rnd++);
    if (k_rank >= n) {
      k_rank -= n;
      sel |= 1u << bit;
    }
  }
  warp_stamp(p.epi_timers, kEpiStamps, 2);
  // rank `above`: the same key while the keys up to it cover the rank, else
  // the least key above it
  unsigned sel_above = sel;
  if (above != below) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) c += key[j] <= sel;
    if (block_count(c, sCount, rnd++) <= above) {
      unsigned m = 0xffffffffu;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) m = key[j] > sel && key[j] < m ? key[j] : m;
      sel_above = block_min(m, sCount, rnd++);
    }
  }
  if (tid == 0) {
    const float w = rank - static_cast<float>(below);
    const float nth = aten_lerp(key_value(sel), key_value(sel_above), w);
    float th = isfinite(nth) ? __fsqrt_rn(nth) : p.fallback;
    th = rn::mul(th, p.fac);
    th = rn::add(rn::mul(th, p.c_keep), p.c_const);
    th = rn::mul(rn::mul(th, th), p.w2);
    sTh = th;
  }
  __syncthreads();
  warp_stamp(p.epi_timers, kEpiStamps, 3);
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
  warp_stamp(p.epi_timers, kEpiStamps, 4);
}

// ---------------------------------------------------------------------------
// K18: the keyframe tail's marginalization
// ---------------------------------------------------------------------------

struct MargParams {
  BaParams ba;                   // the state's K9 inputs; buffer 0: the state's, the
                                 // linearization's and the scratch; host_pts / host_off:
                                 // the flagged points grouped by host (the upload)
  const unsigned char* flags;    // [NP]: bit 0 marginalize, bit 1 drop (the upload)
  const int* mlist;              // [nm]: the flagged valid points, ascending (the upload)
  const float* Hdd;              // [NP]: the tail's linearization's
  const float* calib_delta;      // [4]: x0's calibration part
  int nm;                        // flagged valid points (0: no point is folded in)
  int n_slots;
  int slots[kMaxSlots];          // the frames to marginalize, in order
  float marg_w;                  // cfg.ba.marg_weight_fac
  float* bpart;                  // [D, kMargTileRows]: dH x0 by tile column; then db [D]
  float* HM_out;
  float* bM_out;
  unsigned char* frame_valid_out;
  int* frame_id_out;
  float* delta_out;
  unsigned char* p_valid_out;
  unsigned char* p_res_good_out;
  unsigned long long* timers;    // kMargStamps a warp, or null
};

constexpr int kMargThreads = 512;
constexpr int kMargStamps = 8;
constexpr int kMT = 8;                          // a Schur tile's side
constexpr int kMargTileRows = (kMaxD + kMT - 1) / kMT;
constexpr int kMGroups = 32;                    // the point groups of a tile (16 threads each)
constexpr int kMStage = 32;                     // points of a group staged at once

// K18's Schur tile's shared memory: each group's staged points (the tile's
// row columns scaled by 1 / Hdd, then its column columns), the groups'
// partials, the tile's Hff and dH
struct __align__(16) TileSmem {
  float st[kMGroups][kMStage][2 * kMT];
  float part[kMGroups][kMT * kMT];
  float hff[kMT * kMT];
  float dh[kMT * kMT];
  int bad_t, h_nan, b_nan;
};

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

// Entry (r, c) of Hff (c >= 0), or r of bf (c < 0), host s's share of it
// from the reduced (s, t) blocks: finish_block's terms in its order (each
// target's up to 2 x 2 terms in (t, row index, column index) order, a
// block of a target with a non-finite block adding the other hosts'
// blocks times 0)
__device__ __forceinline__ float hff_share(const BaParams& p, int r, int c, int s,
                                          unsigned bad_t) {
  const int W = p.W;
  float v = 0.f;
  if (s >= W) return v;
  for (int t = 0; t < W; ++t) {
    int r0, r1, c0 = -1, c1 = -1;
    block_indices(r, s, t, r0, r1);
    if (c >= 0) block_indices(c, s, t, c0, c1);
    const float* blk = p.lin_part + (static_cast<size_t>(s) * W + t) * kHE;
    float q[4];
    int ents[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = m < 2 ? r0 : r1, j = (m & 1) ? c1 : c0;
      const bool ok = i >= 0 && (c < 0 ? m % 2 == 0 : j >= 0);
      const int lo = c < 0 ? i : min(i, j), hi = c < 0 ? i : max(i, j);
      ents[m] = !ok ? -1 : (c < 0 ? kHU + i : lo * 20 - lo * (lo - 1) / 2 + (hi - lo));
      q[m] = ok ? blk[ents[m]] : 0.f;
    }
    if ((bad_t >> t) & 1u) {
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
  return v;
}

// The Schur unit u of the points stage, by one block: a tile (I, J), I <= J,
// of the upper triangle of D x D in kMT x kMT entries, or (u past the
// tiles) the b entries of tile row I. A tile: its Hff entries (eight lanes
// an entry, a host each, summed in host order as finish_block sums them);
// its Hsc entries sum_q (Hfd[q, i] / Hdd[q]) Hfd[q, j] over the flagged
// points, the point list cut into kMGroups contiguous groups (16 threads a
// group, 2 x 2 entries a thread, each group's points in ascending order
// through shared memory), the groups' partials summed in group order; then
// HM + w (Hff - Hsc) into HM_out at (i, j) and (j, i), and dH x0's terms of
// the tile's rows (and, off the diagonal, of its columns' rows) into bpart.
// A b unit: w (bf - bsc) of its rows into db.
__device__ __noinline__ void marg_unit(const MargParams& m, int u, int ntiles) {
  extern __shared__ float4 dyn4[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(dyn4);
  const BaParams& p = m.ba;
  const int W = p.W, D = 4 + 8 * W, TR = (D + kMT - 1) / kMT, tid = threadIdx.x;
  const int lane = tid & 31, nm = m.nm;
  const float w = m.marg_w;
  float* db = m.bpart + D * kMargTileRows;
  int I, J;
  const bool b_unit = u >= ntiles;
  if (b_unit) {
    I = u - ntiles;
    J = -1;
  } else {
    upper_ij(u, TR, I, J);
  }
  const int i0 = I * kMT, j0 = J * kMT;
  if (tid < 32) {
    // bit t: a block of target t is not finite; any H (b) flag
    const float* fl = p.lin_part + static_cast<size_t>(W) * W * kHE;
    const int f_lo = lane < W * W ? static_cast<int>(fl[lane]) : 0;
    const int f_hi = lane + 32 < W * W ? static_cast<int>(fl[lane + 32]) : 0;
    const unsigned lo_bad = __ballot_sync(kFull, f_lo != 0);
    const unsigned hi_bad = __ballot_sync(kFull, f_hi != 0);
    const bool h_nan = __any_sync(kFull, ((f_lo | f_hi) & kFlagH) != 0);
    const bool b_nan = __any_sync(kFull, ((f_lo | f_hi) & kFlagB) != 0);
    if (lane == 0) {
      unsigned bad_t = 0;
      for (int i = 0; i < W * W; ++i)
        if (((i < 32 ? lo_bad >> i : hi_bad >> (i - 32)) & 1u) != 0) bad_t |= 1u << (i % W);
      sm.bad_t = static_cast<int>(bad_t);
      sm.h_nan = h_nan;
      sm.b_nan = b_nan;
    }
  }
  __syncthreads();
  const unsigned bad_t = static_cast<unsigned>(sm.bad_t);
  // Hff (bf) of the unit's entries: eight lanes an entry, lane & 7 its host
  {
    const int e = tid >> 3, s = tid & 7;
    const int ei = e >> 3, ej = e & 7;
    const int r = i0 + ei, c = b_unit ? -1 : j0 + ej;
    const bool live = r < D && (b_unit ? ej == 0 : c < D);
    const float v = live ? hff_share(p, r, c, s, bad_t) : 0.f;
    float tot = 0.f;
#pragma unroll
    for (int ss = 0; ss < kMaxSlots; ++ss) tot += __shfl_sync(kFull, v, (lane & ~7) + ss);
    if (s == 0) sm.hff[e] = (b_unit ? sm.b_nan : sm.h_nan) ? qnan() : tot;
  }
  // the Schur sums: group g takes the points [g nm / G, (g + 1) nm / G)
  const int g = tid >> 4, gt = tid & 15;
  const int q_lo = static_cast<int>(static_cast<long long>(g) * nm / kMGroups);
  const int q_hi = static_cast<int>(static_cast<long long>(g + 1) * nm / kMGroups);
  const int per_max = (nm + kMGroups - 1) / kMGroups;
  const int ti = gt >> 2, tj = gt & 3;          // rows 2 ti, 2 ti + 1; columns 2 tj, 2 tj + 1
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int b0 = 0; b0 < per_max; b0 += kMStage) {
    // stage each group's next kMStage points: a thread a (group, point,
    // half of 8 floats): a tile's rows' columns over Hdd, then its columns'
    // columns; a b unit's rows' columns, then bd / Hdd in column 0
    for (int x = tid; x < kMGroups * kMStage * 2; x += kMargThreads) {
      const int gg = x / (kMStage * 2), k = (x >> 1) % kMStage, hf = x & 1;
      const int ql = static_cast<int>(static_cast<long long>(gg) * nm / kMGroups) + b0 + k;
      const int qh = static_cast<int>(static_cast<long long>(gg + 1) * nm / kMGroups);
      float vals[kMT];
#pragma unroll
      for (int z = 0; z < kMT; ++z) vals[z] = 0.f;
      if (ql < qh) {
        const int pt = m.mlist[ql];
        const float h = m.Hdd[pt];
        const float inv = h > 1e-10f ? 1.f / h : 0.f;
        const float* row = p.Hfd[0] + static_cast<size_t>(pt) * D;
        if (hf == 0) {
#pragma unroll
          for (int z = 0; z < kMT; ++z)
            vals[z] = i0 + z >= D ? 0.f : (b_unit ? row[i0 + z] : row[i0 + z] * inv);
        } else if (!b_unit) {
#pragma unroll
          for (int z = 0; z < kMT; ++z) vals[z] = j0 + z < D ? row[j0 + z] : 0.f;
        } else {
          vals[0] = inv * p.bd[0][pt];
        }
      }
      float4* dst = reinterpret_cast<float4*>(&sm.st[gg][k][hf * kMT]);
      dst[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
      dst[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
    }
    __syncthreads();
    const int n = min(kMStage, q_hi - q_lo - b0);
    for (int k = 0; k < n; ++k) {
      const float2 a = *reinterpret_cast<const float2*>(&sm.st[g][k][2 * ti]);
      const float2 c = *reinterpret_cast<const float2*>(&sm.st[g][k][kMT + 2 * tj]);
      acc[0][0] += a.x * c.x;
      acc[0][1] += a.x * c.y;
      acc[1][0] += a.y * c.x;
      acc[1][1] += a.y * c.y;
    }
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) sm.part[g][(2 * ti + x) * kMT + 2 * tj + y] = acc[x][y];
  __syncthreads();
  if (tid < kMT * kMT) {
    float v = 0.f;
    for (int gg = 0; gg < kMGroups; ++gg) v += sm.part[gg][tid];
    const int ei = tid >> 3, ej = tid & 7, r = i0 + ei;
    if (b_unit) {
      // the b unit's column 0: bsc; db = w (bf - bsc)
      if (ej == 0 && r < D) db[r] = w * (sm.hff[tid] - v);
    } else {
      sm.dh[tid] = w * (sm.hff[tid] - v);
    }
  }
  __syncthreads();
  if (b_unit) return;
  if (tid < kMT * kMT) {
    // the upper triangle's entries (the diagonal tile's lower ones mirror them)
    const int ei = tid >> 3, ej = tid & 7, r = i0 + ei, c = j0 + ej;
    if (r < D && c < D && (I < J || ei <= ej)) {
      const float d = sm.dh[tid];
      m.HM_out[r * D + c] = p.HM[r * D + c] + d;
      if (r != c) m.HM_out[c * D + r] = p.HM[c * D + r] + d;
    }
  } else if (tid < kMT * kMT + 2 * kMT) {
    // dH x0 by tile: the tile's rows over its columns, and (off the
    // diagonal) its columns' rows over its rows, each in index order
    const int k = tid - kMT * kMT, col = k >= kMT, z = k & (kMT - 1);
    if (!col || I < J) {
      const int r = (col ? j0 : i0) + z, cb = col ? i0 : j0;
      if (r < D) {
        float v = 0.f;
        for (int y = 0; y < kMT && cb + y < D; ++y) {
          const int c = cb + y;
          const int ei = col ? y : z, ej = col ? z : y;
          const float d = (I < J || ei <= ej) ? sm.dh[ei * kMT + ej] : sm.dh[ej * kMT + ei];
          v += d * (c < 4 ? m.calib_delta[c] : p.delta[0][c - 4]);
        }
        m.bpart[r * kMargTileRows + (col ? I : J)] = v;
      }
    }
  }
  __syncthreads();                       // the shared memory is the next unit's
}

// Block 0's last phase: bM with the flagged points folded in (points), then
// each flagged frame marginalized in order (models/ba.py's
// marginalize_frame), in shared memory, from HM_out (the points stage's
// prior) or HM (no point folded in).
__device__ __noinline__ void marg_frames(const MargParams& m) {
  extern __shared__ float4 dyn4[];
  const BaParams& p = m.ba;
  const int W = p.W, D = 4 + 8 * W, TR = (D + kMT - 1) / kMT, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool points = m.nm > 0;
  float* sH = reinterpret_cast<float*>(dyn4);      // [D * D]
  float* sAb = sH + kMaxD * kMaxD;                 // [D, 8]: Hab
  float* sK = sAb + kMaxD * 8;                     // [D, 8]: Hab @ inv(Hbb)
  float* sB = sK + kMaxD * 8;                      // [D]
  float* sInv = sB + kMaxD;                        // [8, 8]
  float* sY = sInv + 64;                           // [8]
  __shared__ int sValid[kMaxSlots], sId[kMaxSlots];
  // bM + db - dH x0 (dH x0: its tiles' terms in tile order)
  for (int i = tid; i < D; i += blockDim.x) {
    float b = p.bM[i];
    if (points) {
      float s = 0.f;
      for (int J = 0; J < TR; ++J) s += m.bpart[i * kMargTileRows + J];
      b = (b + m.bpart[D * kMargTileRows + i]) - s;
    }
    sB[i] = b;
  }
  if (m.n_slots == 0) {
    for (int i = tid; i < D; i += blockDim.x) m.bM_out[i] = sB[i];
    if (!points)
      for (int e = tid; e < D * D; e += blockDim.x) m.HM_out[e] = p.HM[e];
    return;
  }
  const float* H0 = points ? m.HM_out : p.HM;
  for (int e = tid; e < D * D; e += blockDim.x) sH[e] = H0[e];
  if (tid < W) {
    sValid[tid] = p.frame_valid[tid];
    sId[tid] = p.frame_id[tid];
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

// One cooperative launch; every phase spread over the grid, no block
// working while the others wait at a barrier: (1) the bookkeeping, K9's
// pixel pass over the (chunk, target) items of the hosts with flagged
// points only (the others' reduced blocks are zero: written as zeros);
// (2) their reduced blocks (the chunks in rank order) and each flagged
// point's Hfd row, Hdd and bd; (3) the Schur units (marg_unit); (4) block
// 0: bM and the frames. Without points: block 0's frames alone.
__global__ void __launch_bounds__(kMargThreads, 1) marg_kernel(const __grid_constant__ MargParams m) {
  extern __shared__ float4 smem4[];
  const BaParams& p = m.ba;
  cg::grid_group grid = cg::this_grid();
  const int W = p.W, NP = p.NP, D = 4 + 8 * W, tid = threadIdx.x;
  const int half = tid >> 8, htid = tid & (kLinThreads - 1), lane = tid & 31, warp = tid >> 5;
  const int nblk = gridDim.x;
  const long long gtid = static_cast<long long>(blockIdx.x) * blockDim.x + tid;
  const long long gthreads = static_cast<long long>(nblk) * blockDim.x;
  unsigned slot_bits = 0;
  for (int q = 0; q < m.n_slots; ++q) slot_bits |= 1u << m.slots[q];
  auto mark = [&](int i) { warp_stamp(m.timers, kMargStamps, i); };
  mark(0);

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

  if (m.nm > 0) {
    // the hosts with flagged points, in order
    unsigned hosts = 0;
    int nh = 0;
    for (int s = 0; s < W; ++s)
      if (p.host_off[s + 1] > p.host_off[s]) {
        hosts |= 1u << s;
        ++nh;
      }
    auto nth_host = [&](int j) {
      int s = 0;
      for (unsigned b = hosts; b; b &= b - 1, --j)
        if (j == 0) {
          s = __ffs(b) - 1;
          break;
        }
      return s;
    };
    // (1) K9's pixel pass: the (chunk, target) items of those hosts on the
    // blocks' halves; zeros for the other hosts' reduced blocks
    const int items = nh * kChunks * W;
    for (int k = 2 * blockIdx.x + half; k < items; k += 2 * nblk) {
      const int s = nth_host(k / (kChunks * W));
      marg_pixel(p, s * kChunks * W + k % (kChunks * W), half, htid);
    }
    for (long long e = gtid; e < static_cast<long long>(W) * W * (kHE + 1); e += gthreads) {
      const bool flag = e >= static_cast<long long>(W) * W * kHE;
      const int st_ = static_cast<int>(flag ? e - static_cast<long long>(W) * W * kHE : e / kHE);
      if (!((hosts >> (st_ / W)) & 1u)) p.lin_part[e] = 0.f;
    }
    mark(1);
    grid.sync();
    mark(2);
    // (2) the chunks in rank order into those hosts' (s, t) blocks, and
    // each flagged point's Hfd row, Hdd and bd
    for (int k = blockIdx.x; k < nh * W; k += nblk) {
      const int st_ = nth_host(k / W) * W + k % W;
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
    for (int q = blockIdx.x * (blockDim.x >> 5) + warp; q < m.nm;
         q += nblk * (blockDim.x >> 5))
      point_row(p, 0, m.mlist[q], lane, sG[warp]);
    mark(3);
    grid.sync();
    mark(4);
    // (3) the Schur units
    const int TR = (D + kMT - 1) / kMT, ntiles = TR * (TR + 1) / 2;
    for (int u = blockIdx.x; u < ntiles + TR; u += nblk) marg_unit(m, u, ntiles);
    mark(5);
    grid.sync();
    mark(6);
  } else {
    for (int i = 1; i < 7; ++i) mark(i);
  }
  // (4) bM and the frames
  if (blockIdx.x == 0) marg_frames(m);
  mark(7);
}

size_t marg_smem() {
  const size_t pix = 2 * sizeof(PixSmem);
  const size_t fin = sizeof(float) * (kMargThreads / 32) * kMaxSlots * kG;
  const size_t tile = sizeof(TileSmem);
  const size_t frames = sizeof(float) * (kMaxD * kMaxD + 2 * kMaxD * 8 + kMaxD + 64 + 8);
  size_t s = pix;
  if (fin > s) s = fin;
  if (tile > s) s = tile;
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
  // NP < 65536: each block's kProRounds rounds and 16-bit counters
  if (p->W < 1 || p->W > kMaxSlots || p->B < 1 || p->B > p->NP || p->NP >= 65536)
    return cudaErrorInvalidValue;
  ba_prologue_kernel<<<kProBlocks, kKfThreads, 0, stream>>>(*p);
  return cudaGetLastError();
}

// ... and the threshold, the FEJ reset, the drop and the scatter after it.
DSSLAM_API int dsslam_ba_epilogue(const KfParams* p, cudaStream_t stream) {
  if (p->W < 1 || p->W > kMaxSlots || p->B > kSelectMax || p->newest < 0 || p->newest >= p->W)
    return cudaErrorInvalidValue;
  const int blocks = 1 + (p->NP + kKfThreads - 1) / kKfThreads;
  ba_epilogue_kernel<<<blocks, kKfThreads, 0, stream>>>(*p);
  return cudaGetLastError();
}

// K18: the keyframe tail's point and frame marginalization, one
// cooperative launch of `grid` blocks (at most one an SM).
DSSLAM_API int dsslam_marginalize(const MargParams* m, int grid, cudaStream_t stream) {
  if (m->ba.W < 1 || m->ba.W > kMaxSlots || m->ba.NP < 1 || m->ba.NP >= 65536 ||
      m->n_slots < 0 || m->n_slots > kMaxSlots || m->nm < 0 || m->nm > m->ba.NP || grid < 1)
    return cudaErrorInvalidValue;
  const size_t smem = marg_smem();
  static std::atomic<unsigned long long> sized{0};   // bit d: the attribute set on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!((sized.load() >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(marg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    sized.fetch_or(1ull << dev);
  }
  void* args[] = {const_cast<MargParams*>(m)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(marg_kernel), dim3(grid), dim3(kMargThreads), args, smem,
      stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
