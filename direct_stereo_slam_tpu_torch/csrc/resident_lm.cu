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
// latency of each pass and LM step in sequence: at the coarse levels a
// block holds a point or less per thread, so a pass costs its reduction,
// its barriers and its step. The design keeps that chain short.
//
// Design:
// - One thread-block cluster of 8 blocks (portable size) per candidate,
//   guess or seed, on blockIdx.y. Candidates never talk to each other, so
//   no grid-wide sync; a finished candidate stops, which is what vmap of a
//   while_loop computes. 8 blocks spread even a batch of one over 8 SMs.
// - A sequence axis (K2-LM, K3-LM; the batched evaluation over sequences,
//   parallel/mesh.py): S sequences of per_seq candidates each, every
//   sequence with its own pyramid and template, stacked at fixed strides
//   (LmLevel::img_stride, pt_stride). Thread 0 moves its copy of the level
//   pointers to sequence blockIdx.y / per_seq before anything reads them;
//   strides of 0 leave them as given, so a launch on one sequence runs the
//   same instructions on the same data as before the axis existed.
// - At each level a block copies its eighth of the level's points into
//   shared memory with cp.async (cooperative_groups::memcpy_async) once;
//   every pass of the level reads them from there. At most 8192 points x
//   17 B / 8 = 17 KB per block. Image taps come through L2 (level 0 at
//   KITTI size is 5.4 MB, inside the 50 MB L2).
// - Per pass each thread runs the per-point arithmetic of the per-pass
//   kernels (pose_terms.cuh). The cluster's sums (ClusterSums, shared by
//   the three LMs) take one __syncthreads and one cluster barrier: a
//   reduce-scatter inside each warp (common.cuh), the warps' partials
//   summed in index order, each block's sums pushed into slot [rank] of
//   every block's shared memory (distributed shared memory stores, two per
//   thread), barrier.cluster.arrive / wait, then the warps that need the
//   totals sum their own block's 8 slots in rank order. No atomics: every
//   block holds the same bits, and two runs give the same bits.
// - K2-LM / K4-LM: warp 0 of every block takes the LM step in its
//   registers (LmCluster::plan): the damped sub-block by the affine mode,
//   solved by an LU with partial pivoting (the first largest |pivot|, as
//   LAPACK's isamax; rows chosen by selects, every index known at compile
//   time), the extrapolation and the isfinite guard, se3_exp as
//   geometry/lie.py computes it, the trial pose and the next pass's warp,
//   accept / reject, the lambda schedule and the increment-norm break. It
//   publishes the block's next operation (a pass at that warp, a level's
//   slice load, or the end) behind one __syncthreads, so a pass crosses
//   two block barriers and one cluster barrier. Every block's warp 0
//   reads the same totals, so the whole cluster follows one path with no
//   broadcast between blocks. (Every thread taking the step alike needs
//   ~220 registers: one block per SM, half the clusters resident; capped
//   at 128, the spilled carry cost the batches 14-16% more than this
//   form, PERF.md.) K3-LM's step is a few scalars that every thread holds
//   and updates alike; it runs no pass whose sums it holds (ScaleLm).
// - Host side: one parameter struct passed by value (per-level image and
//   point pointers, intrinsics, the level's 3x3 matrix, the LM's scalars;
//   K2-LM's scalars that live on the card are read there through a
//   pointer). Output per candidate: K2-LM / K4-LM T, a, b, the per-level
//   residual, the flow indicators (K2) or level 0's E and n (K4), and the
//   passes run per level; K3-LM the scale, the error, level 0's E and n,
//   the cutoff-doubling factor and per level the passes of the reference's
//   loop and those run. The acceptance gates, the winner and the trap
//   decision stay on the host.
// - Phase counters: with LmParams::timers (ScaleLmParams::timers) set,
//   thread 0 of cluster rank 0 adds clock64() deltas per level and phase
//   (the slice load, the point loop, the reduction, the cluster barrier
//   and gather, the step, the block barriers) and the run's cycles and
//   %globaltimer nanoseconds; ops/resident_lm.py turns them into
//   microseconds per pass.

#include <cooperative_groups.h>
#include <cooperative_groups/memcpy_async.h>

#include "pose_terms.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kLmThreads = 256;
constexpr int kWarps = kLmThreads / 32;
constexpr int kMaxLevels = 8;

// output row per candidate (ops/resident_lm.py reads the same slots)
constexpr int kLmOut = 40;
constexpr int kOutA = 16, kOutB = 17, kOutRes = 18, kOutX0 = 26, kOutX1 = 27,
              kOutPasses = 28;
// K3-LM: output row per guess (kSOutPasses: the passes the reference's
// loop runs per level; kSOutRun: those the kernel ran)
constexpr int kScaleOut = 28;
constexpr int kSOutScale = 0, kSOutErr = 1, kSOutE = 2, kSOutN = 3,
              kSOutRepeat = 4, kSOutPasses = 12, kSOutRun = 20;
// phase counters (LmParams::timers): per candidate kMaxLevels x kPhases
// clock64() sums, then the whole run's cycles and %globaltimer nanoseconds
enum Phase { kPhLoad = 0, kPhPoints, kPhReduce, kPhCluster, kPhStep, kPhBarrier, kPhases };
constexpr int kTimerWords = kMaxLevels * kPhases + 2;

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
  // Elements between two sequences' images (img) and point lists (p0, p1,
  // p2, pcolor, pmask) when one launch covers several sequences, each with
  // its own pyramid and template; 0 for a launch on one sequence.
  long long img_stride;
  long long pt_stride;
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
  long long* timers;           // [B, kTimerWords] phase counters, or null
  LmScalar aff_a0, aff_b0, ref_a, ref_b, ref_exp, new_exp;
  float pre[8];                // POSE_PRECOND
  float huber, coarse_cutoff, sat_ratio_repeat, cutoff_repeat_max;
  float lambda_init, lambda_lim, lambda_accept, lambda_reject, inc_break;
  float mode_a, mode_b;
  int levels;
  int B;
  int chunk;                   // points per block slice (multiple of 4)
  int per_seq;                 // candidates per sequence: cluster y reads sequence y / per_seq
};

struct ScaleLmParams {
  LmLevel lv[kMaxLevels];
  const float* s_init;         // [G] initial scales
  float* out;                  // [G, kScaleOut]
  long long* timers;           // [G, kTimerWords] phase counters, or null
  float t01[3];
  float huber, coarse_cutoff, sat_ratio_repeat, cutoff_repeat_max;
  float lambda_init, lambda_lim, lambda_accept, lambda_reject, inc_break;
  int levels;
  int G;
  int per_seq;                 // guesses per sequence: cluster y reads sequence y / per_seq
};

static_assert(sizeof(LmLevel) == 152, "LmLevel layout");
static_assert(sizeof(LmParams) == 1432, "LmParams layout");
static_assert(sizeof(ScaleLmParams) == 1304, "ScaleLmParams layout");

namespace {

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

// Thread 0 of cluster rank 0, with LmParams::timers set: clock64() deltas
// per level and phase into shared memory (acc); mark(p) ends phase p. For
// every other thread acc is null and mark() does nothing.
struct PhaseTimer {
  long long* acc = nullptr;
  long long t = 0;
  int lvl = 0;
  __device__ __forceinline__ void mark(int phase) {
    if (acc) {
      const long long now = clock64();
      acc[lvl * kPhases + phase] += now - t;
      t = now;
    }
  }
  // The timed thread: count from the kernel's start c0 into sums (shared
  // memory, kMaxLevels * kPhases words).
  __device__ void start(long long* sums, long long c0) {
    for (int k = 0; k < kMaxLevels * kPhases; ++k) sums[k] = 0;
    acc = sums;
    t = c0;
  }
  // The timed thread, at the end: the sums, the run's cycles and its
  // nanoseconds since (c0, n0) into the candidate's kTimerWords.
  __device__ void finish(long long* row, long long c0, long long n0) {
    mark(kPhBarrier);
    for (int k = 0; k < kMaxLevels * kPhases; ++k) row[k] = acc[k];
    row[kMaxLevels * kPhases] = clock64() - c0;
    row[kMaxLevels * kPhases + 1] = global_ns() - n0;
  }
};

__device__ __forceinline__ float read_scalar(const LmScalar& s) {
  return s.ptr ? *s.ptr : s.value;
}

// The levels of a sequence: each level's image and point pointers moved by
// seq strides (strides of 0, a launch on one sequence, leave them as given).
__device__ __forceinline__ void to_sequence(LmLevel* lv, int levels, int seq) {
  for (int l = 0; l < levels; ++l) {
    LmLevel& L = lv[l];
    const long long i = seq * L.img_stride, k = seq * L.pt_stride;
    L.img += i;
    L.p0 += k;
    L.p1 += k;
    L.p2 += k;
    L.pcolor += k;
    L.pmask += k;
  }
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

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// A block's dynamic shared memory at most (the H100 gives a block 227 KB,
// some of it static)
constexpr size_t kMaxDynamicSmem = 200 * 1024;

// The cluster barrier split in its two halves: arrive releases this
// thread's earlier stores (to any block's shared memory), wait acquires
// every thread's of the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// A block's slice of a level's points in shared memory, and the cluster's
// fixed-order sum of NACC per-thread accumulators: what K2-LM, K3-LM and
// K4-LM share. Every thread calls reduce() alike, so the double-buffer
// index lives in a register.
template <int NACC>
struct ClusterSums {
  static constexpr int NS = pow2_at_least(NACC);   // NACC padded (64 / 8)
  static constexpr int PER = NS >= 32 ? NS / 32 : 1;   // sums a lane holds
  static constexpr int SPAN = NS >= 32 ? 1 : 32 / NS;  // lanes holding each

  struct Shared {
    float part[kWarps][NS];              // this block's warp partials
    float slot[2][kCluster][NS];         // every block's partials, pushed
  };

  Shared& sh;
  unsigned char* base;         // the dynamic shared memory
  float *s0, *s1, *s2, *sc;    // the slice: p0, p1, p2, colour
  unsigned char* sm;           // the slice: mask
  int rank, tid, lane, warp;
  int start = 0, count = 0, buf = 0;
  PhaseTimer tm;

  __device__ ClusterSums(Shared& sh_, unsigned char* smem)
      : sh(sh_), base(smem), rank(static_cast<int>(cg::this_cluster().block_rank())),
        tid(threadIdx.x), lane(threadIdx.x & 31), warp(threadIdx.x >> 5) {}

  // This block's slice of level L's points at at, len points an array.
  __device__ void point_to(const LmLevel& L, unsigned char* at, int len) {
    s0 = reinterpret_cast<float*>(at);
    s1 = s0 + len;
    s2 = s1 + len;
    sc = s2 + len;
    sm = reinterpret_cast<unsigned char*>(sc + len);
    const int per = slice_len(L.N);
    start = min(rank * per, L.N);
    count = min(per, L.N - start);
  }

  // Start the copies of the points point_to named (cp.async); wait for
  // them with cg::wait.
  __device__ void copy_points(const LmLevel& L) {
    if (count <= 0) return;
    cg::thread_block block = cg::this_thread_block();
    cg::memcpy_async(block, s0, L.p0 + start, sizeof(float) * count);
    cg::memcpy_async(block, s1, L.p1 + start, sizeof(float) * count);
    cg::memcpy_async(block, s2, L.p2 + start, sizeof(float) * count);
    cg::memcpy_async(block, sm, L.pmask + start, sizeof(unsigned char) * count);
    if (L.color_stride == 1) {
      cg::memcpy_async(block, sc, L.pcolor + start, sizeof(float) * count);
    } else {
      for (int j = tid; j < count; j += kLmThreads)
        sc[j] = L.pcolor[static_cast<size_t>(start + j) * L.color_stride];
    }
  }

  // This block's slice of level L's points (len points an array) into
  // shared memory.
  __device__ void load_level(const LmLevel& L, int len) {
    __syncthreads();        // nobody still reads the previous level's slice
    point_to(L, base, len);
    copy_points(L);
    cg::thread_block block = cg::this_thread_block();
    cg::wait(block);
    tm.mark(kPhLoad);
  }

  // All threads, right after the point loop: the cluster's sums of acc,
  // the same bits in every warp that gathers them, in every block. Each
  // warp's lanes hold PER sums from entry e0 = lane / SPAN * PER on, which
  // finish(s, e0) may rewrite (it runs on every lane, so it may shuffle);
  // they land in dst (the warp's own NS floats), readable by the warp on
  // return. A warp that passes no dst gathers nothing.
  template <class Finish>
  __device__ __forceinline__ void reduce(const float (&acc)[NACC], float* dst,
                                         Finish finish) {
    tm.mark(kPhPoints);
    float v[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) v[k] = k < NACC ? acc[k] : 0.f;
    dsslam::warp_reduce_scatter<NS>(v, lane);
    const int e0 = lane / SPAN * PER;
    if (lane % SPAN == 0) {
#pragma unroll
      for (int j = 0; j < PER; ++j) sh.part[warp][e0 + j] = v[j];
    }
    tm.mark(kPhReduce);
    __syncthreads();
    tm.mark(kPhBarrier);
    // the block's sums (warps in index order), pushed into slot [buf][rank]
    // of every block: thread t sums entry t % NS and stores it to kDest
    // blocks
    constexpr int kGroups = kLmThreads / NS;
    constexpr int kDest = (kCluster + kGroups - 1) / kGroups;
    static_assert(kWarps == 8, "the block sum's order is written for 8 warps");
    const int e = tid % NS, q = tid / NS;
    if (q * kDest < kCluster) {
      const float s = ((sh.part[0][e] + sh.part[1][e]) + (sh.part[2][e] + sh.part[3][e])) +
                      ((sh.part[4][e] + sh.part[5][e]) + (sh.part[6][e] + sh.part[7][e]));
      cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
      for (int d = 0; d < kDest; ++d) {
        const int r = q * kDest + d;
        if (r < kCluster) *cluster.map_shared_rank(&sh.slot[buf][rank][e], r) = s;
      }
    }
    tm.mark(kPhReduce);
    cluster_arrive();
    cluster_wait();
    tm.mark(kPhCluster);
    buf ^= 1;
    if (dst == nullptr) return;
    float s[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      float t = sh.slot[buf ^ 1][0][e0 + j];
#pragma unroll
      for (int r = 1; r < kCluster; ++r) t += sh.slot[buf ^ 1][r][e0 + j];
      s[j] = t;
    }
    finish(s, e0);
    if (lane % SPAN == 0) {
#pragma unroll
      for (int j = 0; j < PER; ++j) dst[e0 + j] = s[j];
    }
    __syncwarp();
    tm.mark(kPhCluster);
  }
};

// The parameters of the 8-parameter system that the affine mode leaves
// free (models/tracker.py::_solve_inc): both (8 unknowns), a only (7),
// b only ("stitch b into slot 6": 7) or neither (6).
enum SolveMode { kFreeBoth = 0, kFixB, kFixA, kFixBoth };

__host__ __device__ __forceinline__ int solve_mode(float mode_a, float mode_b) {
  return mode_a >= 0.f ? (mode_b >= 0.f ? kFreeBoth : kFixB)
                       : (mode_b >= 0.f ? kFixA : kFixBoth);
}

template <int Mode>
__host__ __device__ constexpr int solve_size() {
  return Mode == kFreeBoth ? 8 : Mode == kFixBoth ? 6 : 7;
}

template <int Mode>
__device__ __forceinline__ constexpr int solve_index(int r) {
  return Mode == kFixA && r == 6 ? 7 : r;
}

// Damped solve of the 8-parameter system by the affine mode: Hl = H + lam
// diag(H) over the free sub-block, f32 LU with partial pivoting (the
// first largest |pivot|, as LAPACK's isamax; rows chosen by selects) and
// substitution, in registers: h(i, j) gives H's entries, g the gradient.
// A singular system gives non-finite values, which the caller's isfinite
// guard rejects, as the reference's solve does. piv (the pivot row of
// each column) is for the test entry point; the LM passes null.
template <int Mode, class HFn>
__device__ __forceinline__ void damped_solve(HFn h, const float (&g)[8], float lam,
                                             float (&inc)[8], int* piv) {
  constexpr int M = solve_size<Mode>();
  float A[M][M], r[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int c = 0; c < M; ++c) {
      const float v = h(solve_index<Mode>(i), solve_index<Mode>(c));
      A[i][c] = i == c ? v + lam * v : v;
    }
    r[i] = -g[solve_index<Mode>(i)];
  }
#pragma unroll
  for (int k = 0; k < M; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const float v = fabsf(A[i][k]);
      const bool larger = v > best;
      best = larger ? v : best;
      p = larger ? i : p;
    }
    if (piv) piv[k] = p;
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const bool swap = p == i;
#pragma unroll
      for (int c = k; c < M; ++c) {
        const float top = A[k][c], low = A[i][c];
        A[k][c] = swap ? low : top;
        A[i][c] = swap ? top : low;
      }
      const float top = r[k], low = r[i];
      r[k] = swap ? low : top;
      r[i] = swap ? top : low;
    }
    const float d = A[k][k];
#pragma unroll
    for (int i = k + 1; i < M; ++i) {
      const float l = A[i][k] / d;
#pragma unroll
      for (int c = k + 1; c < M; ++c) A[i][c] -= l * A[k][c];
      r[i] -= l * r[k];
    }
  }
  float x[M];
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float acc = r[i];
#pragma unroll
    for (int c = i + 1; c < M; ++c) acc -= A[i][c] * x[c];
    x[i] = acc / A[i][i];
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) inc[k] = 0.f;
#pragma unroll
  for (int i = 0; i < M; ++i) inc[solve_index<Mode>(i)] = x[i];
}

// The solve of the launch's affine mode (uniform across the launch).
template <class HFn>
__device__ __forceinline__ void solve_inc(int mode, HFn h, const float (&g)[8],
                                          float lam, float (&inc)[8], int* piv) {
  switch (mode) {
    case kFreeBoth: damped_solve<kFreeBoth>(h, g, lam, inc, piv); break;
    case kFixB: damped_solve<kFixB>(h, g, lam, inc, piv); break;
    case kFixA: damped_solve<kFixA>(h, g, lam, inc, piv); break;
    default: damped_solve<kFixBoth>(h, g, lam, inc, piv); break;
  }
}

// SE(3) exp of xi = [t, w] as geometry/lie.py::se3_exp computes it in f32
// (Taylor switch below theta^2 = 1e-4), as a 4x4 row-major matrix.
__device__ __forceinline__ void se3_exp(const float (&xi)[8], float (&E)[16]) {
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
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[i * 3 + j] = W[i * 3 + 0] * W[0 * 3 + j] + W[i * 3 + 1] * W[1 * 3 + j] +
                      W[i * 3 + 2] * W[2 * 3 + j];
  float V[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      E[i * 4 + j] = eye + A * W[i * 3 + j] + B * W2[i * 3 + j];
      V[i * 3 + j] = eye + B * W[i * 3 + j] + C * W2[i * 3 + j];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    E[i * 4 + 3] = V[i * 3 + 0] * xi[0] + V[i * 3 + 1] * xi[1] + V[i * 3 + 2] * xi[2];
  E[12] = 0.f;
  E[13] = 0.f;
  E[14] = 0.f;
  E[15] = 1.f;
}

// K2-LM (kPoints3d false) and K4-LM (true): one candidate's coarse-to-fine
// LM (models/tracker.py::track_candidates_batch_plain /
// loop/pose_estimator.py::estimate_seeds_plain for one candidate). Warp 0
// of every block runs the LM's logic (plan) in its registers from the
// pass totals, which only warp 0 gathers, and publishes the block's next
// operation: a pass at a warp, a level's slice load, or the end. Every
// block's warp 0 reads the same totals and so publishes the same
// operations: the cluster follows one path with no broadcast between
// blocks.
enum LmOp { kOpPass = 0, kOpLoad, kOpStop };
enum LmPhase { kStart = 0, kBegin, kPre, kTrial, kLm, kEnd };

// What warp 0 publishes before each block-wide operation.
struct LmCtl {
  dsslam::PoseWarp w;          // the pass's warp
  int op, lvl, dst;            // the operation, its level, the totals' buffer
};

// Warp 0's LM state between its plans (lane 0 stores it).
struct LmCarry {
  float T[16], a, b;           // the accepted pose and affine
  float Tn[16], an, bn;        // the trial in flight
  float lam, inc_norm, repeat, first_repeat;
  float ref_a, ref_b, exp_ratio;
  int phase, lvl, it, ci, passes, second_run, have_repeated;
};

template <bool kPoints3d>
class LmCluster {
 public:
  static constexpr int NACC = kPoints3d ? dsslam::kPose3dAcc : dsslam::kPoseAcc;
  using Sums = ClusterSums<NACC>;
  static constexpr int NS = Sums::NS;
  static_assert(NS == 64 && Sums::PER == 2, "a lane holds two of 64 sums");

  // sys: warp 0's [2][NS] pass totals; row: this block's output row
  __device__ LmCluster(const LmParams& p, Sums& cs, float (*sys)[NS], float* row,
                       LmCtl* ctl, LmCarry* carry)
      : p_(p), cs_(cs), sys_(sys), row_(row), ctl_(ctl), carry_(carry),
        mode_(solve_mode(p.mode_a, p.mode_b)) {}

  // The warp of a pass at pose T, affine (a, b) and cutoff.
  __device__ __forceinline__ dsslam::PoseWarp warp(const LmCarry& c, const float (&T)[16],
                                                   float a, float b, float cutoff,
                                                   const LmLevel& L) const {
    dsslam::PoseWarp w;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        w.r[i * 3 + j] = kPoints3d ? T[i * 4 + j]
                                   : T[i * 4 + 0] * L.Ki[0 * 3 + j] +
                                         T[i * 4 + 1] * L.Ki[1 * 3 + j] +
                                         T[i * 4 + 2] * L.Ki[2 * 3 + j];
      }
    }
    w.t[0] = T[3];
    w.t[1] = T[7];
    w.t[2] = T[11];
    // aff_from_to(ref_exposure, ref a, ref b, new_exposure, a, b)
    const float a_rel = expf(a - c.ref_a) * c.exp_ratio;
    w.a = a_rel;
    w.b = b - a_rel * c.ref_b;
    w.cutoff = cutoff;
    w.ref_b0 = c.ref_b;
#pragma unroll
    for (int k = 0; k < 9; ++k) w.k[k] = L.Ki[k];
    return w;
  }

  // All threads: one pass over level L at the published warp; warp 0
  // receives H / n_in (packed upper triangle), b / n_in, E, n_terms, the
  // saturated ratio, n_in and (K2, level 0) the flow indicators, at
  // dsslam's accumulator indices, in its buffer dst.
  __device__ __forceinline__ void pass(const LmLevel& L, int dst) {
    using namespace dsslam;
    const PoseWarp c = ctl_->w;
    float acc[NACC];
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
    for (int j = cs_.tid; j < cs_.count; j += kLmThreads) {
      if constexpr (kPoints3d) {
        pose3d_point(L.img, L.H, L.W, L.umax, L.vmax, cs_.s0[j], cs_.s1[j], cs_.s2[j],
                     cs_.sc[j], cs_.sm[j] != 0, c, L.fx, L.fy, L.cx, L.cy, p_.huber, acc);
      } else {
        pose_point(L.img, L.H, L.W, L.umax, L.vmax, cs_.s0[j], cs_.s1[j], cs_.s2[j],
                   cs_.sc[j], cs_.sm[j] != 0, cs_.start + j, c, L.fx, L.fy, L.cx, L.cy,
                   p_.huber, L.compute_flow != 0, acc);
      }
    }
    const bool flow = !kPoints3d && L.compute_flow != 0;
    cs_.reduce(acc, cs_.warp == 0 ? sys_[dst] : nullptr, [flow](float (&s)[2], int e0) {
      const unsigned all = 0xffffffffu;
      const float n_in = __shfl_sync(all, s[kNIN % 2], kNIN / 2);
      const float nt = __shfl_sync(all, s[kNT % 2], kNT / 2);
      const float ns = __shfl_sync(all, s[kNS % 2], kNS / 2);
      const float nsub = __shfl_sync(all, s[kNSUB % 2], kNSUB / 2);
      const float n_safe = fmaxf(n_in, 1.f);
      const float num = nsub * 2.f + 0.1f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = e0 + j;
        if (e < kE)
          s[j] = s[j] / n_safe;
        else if (e == kNS)
          s[j] = ns / fmaxf(nt, 1.f);
        else if (e == kFT || e == kFRT)
          s[j] = flow ? s[j] / num : 0.f;
      }
    });
  }

  // Warp 0: the LM trial step from the carry (its system in sys_[c.ci])
  // at damping c.lam: the trial pose and affine, the increment's norm and
  // the next pass's warp.
  __device__ __forceinline__ dsslam::PoseWarp trial(LmCarry& c, const LmLevel& L) const {
    const float* s = sys_[c.ci];
    const float* pre = p_.pre;
    float g[8], inc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = s[36 + i] * pre[i];
    solve_inc(mode_, [s, pre](int i, int j) {
      return s[dsslam::tri_index(i, j)] * pre[i] * pre[j];
    }, g, c.lam, inc, nullptr);
    const float lim = p_.lambda_lim;
    const float extrap = c.lam < lim ? sqrtf(sqrtf(lim / c.lam)) : 1.f;
    float scaled[8];
    float sum = 0.f, nrm = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      inc[k] = inc[k] * extrap;
      scaled[k] = inc[k] * pre[k];
      sum += scaled[k];
      nrm += inc[k] * inc[k];
    }
    if (!isfinite(sum)) {
#pragma unroll
      for (int k = 0; k < 8; ++k) scaled[k] = 0.f;
    }
    c.inc_norm = sqrtf(nrm);
    float Ex[16];
    se3_exp(scaled, Ex);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c.Tn[i * 4 + j] = Ex[i * 4 + 0] * c.T[0 * 4 + j] + Ex[i * 4 + 1] * c.T[1 * 4 + j] +
                          Ex[i * 4 + 2] * c.T[2 * 4 + j] + Ex[i * 4 + 3] * c.T[3 * 4 + j];
    c.an = c.a + scaled[6];
    c.bn = c.b + scaled[7];
    return warp(c, c.Tn, c.an, c.bn, p_.coarse_cutoff * c.repeat, L);
  }

  // Warp 0: the LM's logic from the last operation's result to the next
  // operation (track_candidates_batch / _estimate_seeds for one candidate:
  // every level coarse to fine, the cutoff doubling, the LM iterations and
  // the one-shot level repeat), published in ctl_ with the carry.
  __device__ void plan(int cand) {
    using dsslam::clamp_min;
    LmCarry c = *carry_;
    __syncwarp();
    LmCtl o = {};
    for (bool next = false; !next;) {
      switch (c.phase) {
        case kStart:
#pragma unroll
          for (int k = 0; k < 16; ++k) c.T[k] = p_.T_init[cand * 16 + k];
          c.a = read_scalar(p_.aff_a0);
          c.b = read_scalar(p_.aff_b0);
          c.ref_a = read_scalar(p_.ref_a);
          c.ref_b = read_scalar(p_.ref_b);
          c.exp_ratio = read_scalar(p_.new_exp) / clamp_min(read_scalar(p_.ref_exp), 1e-9f);
          c.lvl = p_.levels - 1;
          c.ci = 0;
          c.have_repeated = 0;
          c.second_run = 0;
          c.passes = 0;
          c.phase = kBegin;
          o.op = kOpLoad;
          next = true;
          break;
        case kBegin:   // the level's (or its repeat's) first pass at the carry
          c.repeat = 1.f;
          o.w = warp(c, c.T, c.a, c.b, p_.coarse_cutoff * c.repeat, p_.lv[c.lvl]);
          o.op = kOpPass;
          c.phase = kPre;
          next = true;
          break;
        case kPre: {   // a pass of the cutoff doubling is the carry's
          ++c.passes;
          c.ci ^= 1;
          const float sat = sys_[c.ci][dsslam::kNS];
          if (sat > p_.sat_ratio_repeat && c.repeat < p_.cutoff_repeat_max) {
            c.repeat = c.repeat * 2.f;
            o.w = warp(c, c.T, c.a, c.b, p_.coarse_cutoff * c.repeat, p_.lv[c.lvl]);
            o.op = kOpPass;
            next = true;
          } else {
            c.lam = p_.lambda_init;
            c.it = 0;
            c.phase = kTrial;
          }
          break;
        }
        case kTrial:
          if (c.it >= p_.lv[c.lvl].max_iters) {
            c.phase = kEnd;
          } else {
            o.w = trial(c, p_.lv[c.lvl]);
            o.op = kOpPass;
            c.phase = kLm;
            next = true;
          }
          break;
        case kLm: {    // accept or reject the trial, the lambda schedule, the break
          ++c.passes;
          const float* t = sys_[c.ci ^ 1];
          const float* s = sys_[c.ci];
          const float e_new = t[dsslam::kE] / clamp_min(t[dsslam::kNT], 1.f);
          const float e_old = s[dsslam::kE] / clamp_min(s[dsslam::kNT], 1.f);
          if (e_new < e_old) {
#pragma unroll
            for (int k = 0; k < 16; ++k) c.T[k] = c.Tn[k];
            c.a = c.an;
            c.b = c.bn;
            c.ci ^= 1;
            c.lam = c.lam * p_.lambda_accept;
          } else {
            c.lam = clamp_min(c.lam * p_.lambda_reject, p_.lambda_lim);
          }
          ++c.it;
          c.phase = c.inc_norm <= p_.inc_break ? kEnd : kTrial;
          break;
        }
        default: {     // kEnd: the level's run ended
          if (!c.second_run) {
            c.first_repeat = c.repeat;
            if (c.repeat > 1.f && !c.have_repeated) {
              c.second_run = 1;
              c.phase = kBegin;
              break;
            }
          }
          c.have_repeated = c.have_repeated || c.first_repeat > 1.f;
          const float* s = sys_[c.ci];
          const float E = s[dsslam::kE], n = s[dsslam::kNT];
          if (cs_.lane == 0) {
            row_[kOutRes + c.lvl] = n > 0.f ? sqrtf(E / clamp_min(n, 1.f))
                                            : __int_as_float(0x7f800000);
            row_[kOutPasses + c.lvl] = static_cast<float>(c.passes);
            if (c.lvl == 0) {
              row_[kOutX0] = kPoints3d ? E : s[dsslam::kFT];
              row_[kOutX1] = kPoints3d ? n : s[dsslam::kFRT];
            }
          }
          if (c.lvl == 0) {
            o.op = kOpStop;
          } else {
            --c.lvl;
            c.passes = 0;
            c.second_run = 0;
            c.phase = kBegin;
            o.op = kOpLoad;
          }
          next = true;
          break;
        }
      }
    }
    o.lvl = c.lvl;
    o.dst = c.ci ^ 1;
    __syncwarp();
    if (cs_.lane == 0) {
      *carry_ = c;
      *ctl_ = o;
    }
  }

  // All threads: the operations warp 0 plans, until the end.
  __device__ void run(int cand) {
    if (cs_.tid == 0)
      for (int k = 0; k < kLmOut; ++k) row_[k] = 0.f;
    if (cs_.warp == 0) plan(cand);
    for (;;) {
      cs_.tm.mark(kPhStep);
      __syncthreads();
      cs_.tm.mark(kPhBarrier);
      const int op = ctl_->op, lvl = ctl_->lvl;
      if (op == kOpStop) break;
      cs_.tm.lvl = lvl;
      if (op == kOpLoad)
        cs_.load_level(p_.lv[lvl], p_.chunk);
      else
        pass(p_.lv[lvl], ctl_->dst);
      if (cs_.warp == 0) plan(cand);
    }
    if (cs_.rank == 0 && cs_.tid == 0) {
      float* o = p_.out + static_cast<size_t>(cand) * kLmOut;
      for (int k = 0; k < kLmOut; ++k) o[k] = row_[k];
      for (int k = 0; k < 16; ++k) o[k] = carry_->T[k];
      o[kOutA] = carry_->a;
      o[kOutB] = carry_->b;
    }
    // no block leaves while another may still write its shared memory
    cg::this_cluster().sync();
  }

 private:
  const LmParams& p_;
  Sums& cs_;
  float (*sys_)[NS];
  float* row_;
  LmCtl* ctl_;
  LmCarry* carry_;
  int mode_;
};

// Two blocks per SM (at most 128 registers a thread): an H100 holds 30
// clusters of a batch at once, not 15.
template <bool kPoints3d>
__global__ void __launch_bounds__(kLmThreads, 2) lm_kernel(const LmParams p) {
  using Lm = LmCluster<kPoints3d>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ typename Lm::Sums::Shared sums;
  __shared__ float sys[2][Lm::NS];
  __shared__ float row[kLmOut];
  __shared__ LmCtl ctl;
  __shared__ LmCarry carry;
  // the parameters in shared memory, where the levels index them freely
  __shared__ LmParams sp;
  __shared__ long long tacc[kMaxLevels * kPhases];
  const long long c0 = clock64(), n0 = global_ns();
  if (threadIdx.x == 0) {
    sp = p;
    to_sequence(sp.lv, p.levels, blockIdx.y / p.per_seq);
    carry.phase = kStart;
  }
  // every block runs, and has its parameters, before any block stores
  // into another's shared memory
  cg::this_cluster().sync();
  typename Lm::Sums cs(sums, smem);
  const bool timed = p.timers && cs.rank == 0 && threadIdx.x == 0;
  if (timed) cs.tm.start(tacc, c0);
  Lm lm(sp, cs, sys, row, &ctl, &carry);
  lm.run(blockIdx.y);
  if (timed) cs.tm.finish(p.timers + static_cast<size_t>(blockIdx.y) * kTimerWords, c0, n0);
}

// The LM's damped solve on a batch of systems, one thread each (the test
// entry point of damped_solve): H [n, 8, 8], g [n, 8], lam [n] ->
// inc [n, 8] and the pivot row of each column [n, 8] (-1 past the
// sub-block).
__global__ void lm_solve_kernel(const float* __restrict__ H, const float* __restrict__ g,
                                const float* __restrict__ lam, int mode, int n,
                                float* __restrict__ inc, int* __restrict__ piv) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* h = H + static_cast<size_t>(i) * 64;
  float gl[8], x[8];
  int pv[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    gl[k] = g[static_cast<size_t>(i) * 8 + k];
    pv[k] = -1;
  }
  solve_inc(mode, [h](int r, int c) { return h[r * 8 + c]; }, gl, lam[i], x, pv);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    inc[static_cast<size_t>(i) * 8 + k] = x[k];
    piv[static_cast<size_t>(i) * 8 + k] = pv[k];
  }
}

// K3-LM: one guess's coarse-to-fine 1-DoF scale LM
// (models/scale_opt.py::optimize_scale_batch_plain for one guess). Its
// state is a few scalars that every thread of the cluster holds and
// updates alike from the bit-identical cluster sums: no thread waits for
// another's step. The step is the reference's scalar one, no solve. What
// keeps a call short (PERF.md, the phase counters):
// - No pass whose result is in hand. A pass is a function of the scale
//   and the cutoff alone, and the level's sums in hand are always those of
//   the current scale at the level's cutoff (the cutoff loop's last pass,
//   or the last accepted trial). A trial whose scale has the same bits (a
//   zeroed step, as every step on a padded template whose H and b are
//   NaN, or one too small to move s) gets those sums; the reference's loop
//   runs the pass and gets the same bits, rejects it and breaks.
// - Every level's slice copied into shared memory at the start, in one
//   batch of cp.async copies: no level waits for its own.
// kSOutPasses counts the reference's passes, kSOutRun those run.
class ScaleLm {
 public:
  using Sums = ClusterSums<dsslam::kScaleAcc>;

  // tot: this warp's Sums::NS pass totals
  __device__ ScaleLm(const ScaleLmParams& p, Sums& cs, float* tot)
      : p_(p), cs_(cs), tot_(tot) {}

  struct Pass {
    float H, b, E, n, sat;
  };

  // Passes per level: the reference loop's and those run.
  struct Count {
    int passes = 0, run = 0;
  };

  // All threads: one pass over level L at scale s and cutoff.
  __device__ Pass pass(const LmLevel& L, float s, float cutoff, Count& c) {
    using namespace dsslam;
    cs_.tm.mark(kPhStep);
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
    // unrolled so that a thread's taps of several points are in flight
    // together (level 0 of a base-8192 template: 4 points a thread)
#pragma unroll 4
    for (int j = cs_.tid; j < cs_.count; j += kLmThreads)
      scale_point(L.img, L.H, L.W, L.umax, L.vmax, cs_.s0[j], cs_.s1[j],
                  cs_.s2[j], cs_.sc[j], cs_.sm[j] != 0, w, L.fx, L.fy, L.cx,
                  L.cy, p_.huber, acc);
    cs_.reduce(acc, tot_, [](auto&, int) {});
    const float* t = tot_;
    const float n_safe = fmaxf(t[kSNIN], 1.f);
    ++c.passes;
    ++c.run;
    return Pass{t[kSH] / n_safe, t[kSB] / n_safe, t[kSE], t[kSNT],
                t[kSNS] / fmaxf(t[kSNT], 1.f)};
  }

  // All threads: models/scale_opt.py::_optimize_scale_level for one guess
  // from s. Leaves the level's s, E and n; returns the cutoff-doubling
  // factor.
  __device__ float level(const LmLevel& L, float& s, float& E, float& n, Count& c) {
    using dsslam::clamp_min;
    const float s0 = s;
    float repeat = 1.f;
    Pass o = pass(L, s0, p_.coarse_cutoff * repeat, c);
    while (o.sat > p_.sat_ratio_repeat && repeat < p_.cutoff_repeat_max) {
      repeat = repeat * 2.f;
      o = pass(L, s0, p_.coarse_cutoff * repeat, c);
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
      Pass t;
      if (__float_as_uint(s_new) == __float_as_uint(s)) {
        t = Pass{H, b, E, n, 0.f};    // the sums in hand: the pass's bits
        ++c.passes;
      } else {
        t = pass(L, s_new, cutoff, c);
      }
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
    // every level's slice, in one batch
    unsigned char* at = cs_.base;
    for (int lvl = p_.levels - 1; lvl >= 0; --lvl) {
      const int len = slice_len(p_.lv[lvl].N);
      cs_.point_to(p_.lv[lvl], at, len);
      cs_.copy_points(p_.lv[lvl]);
      at += smem_bytes(len);
    }
    cs_.tm.lvl = p_.levels - 1;
    cg::thread_block block = cg::this_thread_block();
    cg::wait(block);
    cs_.tm.mark(kPhLoad);
    at = cs_.base;
    for (int lvl = p_.levels - 1; lvl >= 0; --lvl) {
      const LmLevel& L = p_.lv[lvl];
      const int len = slice_len(L.N);
      cs_.tm.lvl = lvl;
      cs_.point_to(L, at, len);
      at += smem_bytes(len);
      Count c;
      const float repeat = level(L, s, E, n, c);
      if (repeat > 1.f && !have_repeated) level(L, s, E, n, c);
      have_repeated = have_repeated || repeat > 1.f;
      if (leader) {
        o[kSOutRepeat + lvl] = repeat;
        o[kSOutPasses + lvl] = static_cast<float>(c.passes);
        o[kSOutRun + lvl] = static_cast<float>(c.run);
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
        o[kSOutRun + l] = 0.f;
      }
    }
    // no block leaves while another may still read its shared memory
    cg::this_cluster().sync();
  }

 private:
  const ScaleLmParams& p_;
  Sums& cs_;
  float* tot_;
};

__global__ void __launch_bounds__(kLmThreads) scale_lm_kernel(const ScaleLmParams p) {
  using Lm = ScaleLm;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Lm::Sums::Shared sums;
  __shared__ float tot[kWarps][Lm::Sums::NS];
  __shared__ ScaleLmParams sp;
  __shared__ long long tacc[kMaxLevels * kPhases];
  const long long c0 = clock64(), n0 = global_ns();
  if (threadIdx.x == 0) {
    sp = p;
    to_sequence(sp.lv, p.levels, blockIdx.y / p.per_seq);
  }
  // every block runs, and has its parameters, before any block stores
  // into another's shared memory
  cg::this_cluster().sync();
  Lm::Sums cs(sums, smem);
  const bool timed = p.timers && cs.rank == 0 && threadIdx.x == 0;
  if (timed) cs.tm.start(tacc, c0);
  Lm lm(sp, cs, tot[threadIdx.x >> 5]);
  lm.run(blockIdx.y);
  if (timed) cs.tm.finish(p.timers + static_cast<size_t>(blockIdx.y) * kTimerWords, c0, n0);
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

// One cluster per candidate (batch of them) of an LM kernel taking Params,
// with smem bytes of dynamic shared memory.
template <typename Params>
int launch_clusters(void (*kernel)(const Params), const Params& p, int batch, size_t smem,
                    cudaStream_t stream) {
  if (p.levels < 1 || p.levels > kMaxLevels || batch < 1 || smem > kMaxDynamicSmem ||
      p.per_seq < 1 || batch % p.per_seq != 0)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lm_config(batch, smem, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// K2-LM / K4-LM: a block holds a level's slice of at most p->chunk points.
int launch_lm(void (*kernel)(const LmParams), const LmParams* p, cudaStream_t stream) {
  if (p->chunk % 4 != 0 || p->levels > kMaxLevels) return cudaErrorInvalidValue;
  for (int l = 0; l < p->levels; ++l)
    if (slice_len(p->lv[l].N) > p->chunk) return cudaErrorInvalidValue;
  return launch_clusters(kernel, *p, p->B, smem_bytes(p->chunk), stream);
}

// K3-LM's dynamic shared memory: every level's slice.
size_t scale_smem(const ScaleLmParams& p) {
  size_t total = 0;
  for (int l = 0; l < p.levels && l < kMaxLevels; ++l) total += smem_bytes(slice_len(p.lv[l].N));
  return total;
}

}  // namespace

DSSLAM_API int dsslam_lm_params_size() {
  return static_cast<int>(sizeof(LmParams));
}

DSSLAM_API int dsslam_scale_lm_params_size() {
  return static_cast<int>(sizeof(ScaleLmParams));
}

DSSLAM_API int dsslam_track_lm(const LmParams* p, cudaStream_t stream) {
  return launch_lm(lm_kernel<false>, p, stream);
}

DSSLAM_API int dsslam_loop_pose_lm(const LmParams* p, cudaStream_t stream) {
  return launch_lm(lm_kernel<true>, p, stream);
}

DSSLAM_API int dsslam_scale_lm(const ScaleLmParams* p, cudaStream_t stream) {
  return launch_clusters(scale_lm_kernel, *p, p->G, scale_smem(*p), stream);
}

// The LM's damped solve (damped_solve) on n systems for the affine mode
// (mode_a, mode_b): H [n, 8, 8], g [n, 8], lam [n] -> inc [n, 8], piv
// [n, 8] (int32). For tests.
DSSLAM_API int dsslam_lm_solve(const float* H, const float* g, const float* lam,
                               float mode_a, float mode_b, int n, float* inc, int* piv,
                               cudaStream_t stream) {
  if (n < 1) return cudaErrorInvalidValue;
  lm_solve_kernel<<<(n + 127) / 128, 128, 0, stream>>>(
      H, g, lam, solve_mode(mode_a, mode_b), n, inc, piv);
  return cudaGetLastError();
}

// How many 8-block clusters of an LM kernel (kind 0: K2-LM, 1: K4-LM,
// 2: K3-LM) fit on the card at once with smem bytes of dynamic shared
// memory a block.
DSSLAM_API int dsslam_lm_max_active_clusters(int kind, int smem, int* out) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = lm_config(1, static_cast<size_t>(smem), nullptr, attr);
  switch (kind) {
    case 0:
      return cudaOccupancyMaxActiveClusters(out, lm_kernel<false>, &cfg);
    case 1:
      return cudaOccupancyMaxActiveClusters(out, lm_kernel<true>, &cfg);
    case 2:
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            scale_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return err;
      }
      return cudaOccupancyMaxActiveClusters(out, scale_lm_kernel, &cfg);
    default:
      return cudaErrorInvalidValue;
  }
}
