// The layout that kernels nw_viterbi (csrc/nw_viterbi.cu) and sw_scores
// (csrc/sw_scores.cu) share: one pair's DP row over a team of warps, and
// the row's max-plus gap scan.
//
// A team is the warps that hold one pair's row: lane l of the team owns
// the C contiguous columns l*C .. l*C+C-1, each column's DP state in
// registers. geometry(W) picks, for a row of W lanes (ops/dp_cuda.
// geometry mirrors it), one of three modes, each its own instantiation:
//   * W <= kWarpLanes: one warp a block (Mode::kWarp), C = 2 or 4 (the
//     least that holds the row); no barrier and no shared memory but the
//     table, the scan in registers and shuffles (maxplus_scan);
//   * W <= kBlockLanes: a block of ceil(W / (32 kBlockCols)) warps
//     (Mode::kBlock), C = kBlockCols; the warps that the pair's own width
//     needs (the others leave) meet at a named barrier (bar.sync 1, n);
//   * beyond, up to kClusterLanes * kMaxCluster: a thread-block cluster
//     of ceil(W / kClusterLanes) blocks of 32 warps (Mode::kCluster),
//     C = kClusterCols; the blocks meet at the cluster barrier and read
//     each other's shared memory (mapa / ld.shared::cluster).
// A team of several warps (block or cluster) exchanges each row once
// (every warp publishes its columns' values, one barrier), then every
// warp runs the rounds k < 32C on its own columns and on a shadow of the
// warp below's, which it builds from the exchange (team_scan), and the
// rounds k >= 32C through the edge buffer, a barrier each. Blocks (or
// clusters) are pairs, so a batch of short pairs puts several pairs on
// an SM, and each pair stops at its own (lx, ly): columns past the
// pair's width and rows past its lx are never computed, and the launch
// takes as long as its longest pair.
//
// The gap scan is the JAX package's Hillis-Steele max-plus scan
// (muscle_tpu/ops/sw.py::_maxplus_scan): round k = 1, 2, 4, ... takes
// u'[j] = max(u[j], u[j-k] + k*decay) for j >= k, each round from the
// last round's values, in increasing k. A column's result is then the
// maximum over its sources j-i of u[j-i] plus the set bits of i added in
// increasing order, so any layout that computes each round from the
// last one gives the same bits; a running or two-level scan would not
// (it changes ties). Round k only changes columns >= k and a column
// reads only columns to its left, so a pair of width w runs the rounds
// k < w alone and its columns < w are those of the scan over the whole
// pad. Rounds k < C read the lane's own registers (the k lowest columns
// the lane below's, by a shuffle); rounds C <= k < 32C shuffle up by
// k/C lanes (a warp's bottom lanes from the shadow); the rounds k >= 32C
// read the edge buffer in shared memory (column-major by a lane's
// column, free of bank conflicts; two halves, alternating, so one
// barrier a round).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace dp {

constexpr int kWarp = 32;
constexpr int kMaxAlpha = 32;
// one warp a pair up to kWarpLanes lanes (C at most 4)
constexpr int kWarpLanes = 128;
// a block of warps up to kBlockLanes lanes, kBlockCols columns a lane
constexpr int kBlockCols = 4;
constexpr int kBlockLanes = 4096;
// beyond, a cluster of up to kMaxCluster blocks of kClusterLanes lanes
// each, at kClusterCols columns a lane (32 warps a block)
constexpr int kClusterCols = 8;
constexpr int kClusterLanes = 8192;
constexpr int kMaxCluster = 8;

constexpr unsigned kAll = 0xffffffffu;

enum class Mode { kWarp, kBlock, kCluster };

__host__ __device__ constexpr int max_threads(Mode m) {
  return m == Mode::kWarp    ? kWarp
         : m == Mode::kBlock ? kBlockLanes / kBlockCols
                             : kClusterLanes / kClusterCols;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ int clamp_code(int c, int k1) {
  return c < 0 ? 0 : (c >= k1 ? k1 - 1 : c);
}

// The code of column c of a lane, four to a register.
template <int C>
__device__ __forceinline__ int code(const uint32_t (&packed)[(C + 3) / 4],
                                    int c) {
  return static_cast<int>((packed[c >> 2] >> (8 * (c & 3))) & 0xffu);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// The cluster's barrier (release / acquire: the edge buffers' writes
// before it are seen after it), .aligned after the warp reconverges
// (it follows writes that only some lanes of a warp make).
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile(
      "barrier.cluster.arrive.aligned;\n\t"
      "barrier.cluster.wait.aligned;" ::: "memory");
}

// A float of block `rank`'s shared memory at the offset of `p` in ours.
__device__ __forceinline__ float cluster_load(const float* p, unsigned rank) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t ra;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(ra) : "r"(a), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v) : "r"(ra) : "memory");
  return v;
}

// One thread's place in its pair's team.
template <int C, Mode M>
struct Team {
  static constexpr int kSpan = kWarp * C;  // a warp's columns
  int lane;
  int warp;         // in the team (across the cluster's blocks)
  int j0;           // this lane's first column
  int width;        // the pair's lanes: columns 0 .. width - 1 are real
  bool multi;       // several warps: the exchange, the shadow, barriers
  unsigned nthreads;  // block mode: the threads at the barrier
  unsigned rank;    // cluster mode: this block's rank
  float* edge;      // this block's edge buffer, four regions of kHalf
  int half;

  // the slot of a block's column x: by column of the lane, then lane, so
  // that a warp's lanes reading or writing their column c (or any column
  // k / C lanes down) touch 32 neighbouring words; the stride is the
  // instantiation's most threads, so a column's offset is a constant
  static constexpr int kStride = max_threads(M);
  __device__ __forceinline__ static int slot(int x) {
    return (x % C) * kStride + x / C;
  }

  __device__ __forceinline__ void sync() const {
    if constexpr (M == Mode::kCluster) {
      cluster_sync();
    } else {
      __syncwarp();
      asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
    }
  }
  // The edge buffer's regions, each kHalf floats: 0 and 1 the two halves
  // of the rounds k >= 32C (alternating), 2 and 3 a row's exchange
  // arrays (written before the row's exchange barrier, read after it;
  // the row's rounds k >= 32C put a barrier before the next writes).
  static constexpr int kHalf = C * kStride;
  // column x (one of this block's) into region g
  __device__ __forceinline__ void store(int g, int x, float val) const {
    if constexpr (M == Mode::kCluster)
      x -= static_cast<int>(rank) * kClusterLanes;
    edge[g * kHalf + slot(x)] = val;
  }
  // column x (any block's) from region g
  __device__ __forceinline__ float load(int g, int x) const {
    if constexpr (M == Mode::kCluster) {
      const int r = x / kClusterLanes;
      return cluster_load(edge + g * kHalf + slot(x - r * kClusterLanes),
                          static_cast<unsigned>(r));
    } else {
      return edge[g * kHalf + slot(x)];
    }
  }
  __device__ __forceinline__ void put(int x, float val) const {
    store(half, x, val);
  }
  __device__ __forceinline__ float get(int x) const { return load(half, x); }
  __device__ __forceinline__ void next() { half ^= 1; }
  __device__ __forceinline__ void xput(int a, int x, float val) const {
    store(2 + a, x, val);
  }
  __device__ __forceinline__ float xget(int a, int x) const {
    return load(2 + a, x);
  }

  // (an, bn) = the values a and b of the lane below (garbage for lane
  // 0): the column left of a lane's first in a team of one warp.
  __device__ __forceinline__ void from_left(float a, float b, float& an,
                                            float& bn) const {
    an = __shfl_up_sync(kAll, a, 1);
    bn = __shfl_up_sync(kAll, b, 1);
  }
};

// Fills `tm` for this thread of a pair of `width` lanes. Returns false
// for a warp the pair does not reach (block mode), which leaves; in
// cluster mode every thread stays (the cluster barrier counts them all).
// A pair no wider than a warp's columns runs as a team of one warp (no
// barrier); a wider one as several (multi: then the rounds k >= 32C put
// a barrier between a row's exchange reads and the next row's writes).
template <int C, Mode M>
__device__ __forceinline__ bool join_team(Team<C, M>& tm, int width,
                                          float* edge) {
  constexpr int kSpan = Team<C, M>::kSpan;
  const int wib = static_cast<int>(threadIdx.x) / kWarp;
  tm.lane = static_cast<int>(threadIdx.x) % kWarp;
  tm.width = width;
  tm.edge = edge;
  tm.half = 0;
  tm.rank = 0;
  tm.nthreads = 0;
  tm.warp = wib;
  tm.multi = M != Mode::kWarp && width > kSpan;
  if constexpr (M == Mode::kCluster) {
    tm.rank = cluster_rank();
    tm.warp = static_cast<int>(tm.rank) * (kClusterLanes / kSpan) + wib;
  } else if constexpr (M == Mode::kBlock) {
    const int active = (width + kSpan - 1) / kSpan;
    if (wib >= active) return false;
    tm.nthreads = static_cast<unsigned>(active * kWarp);
  }
  tm.j0 = (tm.warp * kWarp + tm.lane) * C;
  return true;
}

// Round K (< C) and the rounds after it below C of a team of one warp:
// the lane's own columns, the K lowest from the lane below (K a template
// argument, so that every register index is a constant). False once the
// rounds pass the width. Branch-free in each column: a column without a
// source (j < K) takes max(u, -inf + K*decay) = u.
template <int K, int C, Mode M>
__device__ __forceinline__ bool lane_rounds(float (&v)[C],
                                            const Team<C, M>& tm,
                                            float decay) {
  if constexpr (K < C) {
    if (K >= tm.width) return false;
    const float kd = static_cast<float>(K) * decay;
    float t[K];
#pragma unroll
    for (int c = 0; c < K; ++c) t[c] = __shfl_up_sync(kAll, v[C - K + c], 1);
#pragma unroll
    for (int c = C - 1; c >= K; --c) v[c] = fmaxf(v[c], v[c - K] + kd);
    const bool left = tm.j0 > 0;
#pragma unroll
    for (int c = 0; c < K; ++c)
      v[c] = fmaxf(v[c], (left ? t[c] : neg_inf()) + kd);
    return lane_rounds<2 * K>(v, tm, decay);
  } else {
    return true;
  }
}

// The rounds C <= k < 32C of a team of one warp: k / C lanes down. A lane
// below k / C shuffles its own value, and max(u, u + k*decay) = u (decay
// < 0), so no column needs a branch; a round's C shuffles all go out
// before its maxes (one at a time would wait out each one's latency).
template <int C, Mode M>
__device__ __forceinline__ void shuffle_rounds(float (&v)[C],
                                               const Team<C, M>& tm,
                                               float decay) {
#pragma unroll
  for (int d = 1; d < kWarp; d *= 2) {
    const int k = d * C;
    if (k >= tm.width) return;
    const float kd = static_cast<float>(k) * decay;
    float t[C];
#pragma unroll
    for (int c = 0; c < C; ++c) t[c] = __shfl_up_sync(kAll, v[c], d);
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = fmaxf(v[c], t[c] + kd);
  }
}

// The rounds k >= 32C of a team of several warps (k and the columns a
// lane are multiples of C, so a lane's columns all have a source or
// none): every lane writes its columns and reads (a clamped slot), and a
// select keeps -inf where it has no source.
template <int C, Mode M>
__device__ __forceinline__ void cross_rounds(float (&v)[C], Team<C, M>& tm,
                                             float decay) {
  const int j0 = tm.j0;
  for (int k = kWarp * C; k < tm.width; k *= 2) {
    const float kd = static_cast<float>(k) * decay;
#pragma unroll
    for (int c = 0; c < C; ++c) tm.put(j0 + c, v[c]);
    tm.sync();
    const bool has = j0 >= k;
    float t[C];
#pragma unroll
    for (int c = 0; c < C; ++c) t[c] = tm.get(max(j0 + c - k, 0));
#pragma unroll
    for (int c = 0; c < C; ++c)
      v[c] = fmaxf(v[c], (has ? t[c] : neg_inf()) + kd);
    tm.next();
  }
}

// The Hillis-Steele rounds k < tm.width of a team of one warp (this
// lane's C columns v), in increasing k, each from the last round's
// values. (A team of several warps runs team_scan.)
template <int C, Mode M>
__device__ __forceinline__ void maxplus_scan(float (&v)[C],
                                             const Team<C, M>& tm,
                                             float decay) {
  if (lane_rounds<1>(v, tm, decay)) shuffle_rounds(v, tm, decay);
}

// A team of several warps (block or cluster mode): the rounds k < 32C
// run, with no barrier, on the lane's own columns v and on its shadow sv, the same
// lane's columns of the warp below (the first warp's shadow is unused),
// which each warp builds itself from the row's exchange. The shadow's
// columns whose source lies below the warp below get none (-inf): after
// the rounds below k a shadow column at least k - 1 above the shadow's
// start is exact, and round k's own reads land at least 32C - k >= k - 1
// above it (k <= 16C), so every shadow value an own column reads is
// exact. Own lanes below
// the shift read the shadow lane 32 - d above them by an indexed
// shuffle. Round K (< C): the lane's own columns, the K lowest from the
// lane below (or for lane 0 the shadow's lane 31).
template <int K, int C, Mode M>
__device__ __forceinline__ bool shadow_lane_rounds(float (&v)[C],
                                                   float (&sv)[C],
                                                   const Team<C, M>& tm,
                                                   float decay) {
  if constexpr (K < C) {
    if (K >= tm.width) return false;
    const float kd = static_cast<float>(K) * decay;
    const bool up = tm.lane > 0, top = tm.warp > 0;
    float t[K], st[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const float a = __shfl_up_sync(kAll, v[C - K + c], 1);
      const float b = __shfl_sync(kAll, sv[C - K + c], kWarp - 1);
      const float sa = __shfl_up_sync(kAll, sv[C - K + c], 1);
      t[c] = up ? a : (top ? b : neg_inf());
      st[c] = up ? sa : neg_inf();
    }
#pragma unroll
    for (int c = C - 1; c >= K; --c) {
      v[c] = fmaxf(v[c], v[c - K] + kd);
      sv[c] = fmaxf(sv[c], sv[c - K] + kd);
    }
#pragma unroll
    for (int c = 0; c < K; ++c) {
      v[c] = fmaxf(v[c], t[c] + kd);
      sv[c] = fmaxf(sv[c], st[c] + kd);
    }
    return shadow_lane_rounds<2 * K>(v, sv, tm, decay);
  } else {
    return true;
  }
}

// The rounds C <= k < 32C of team_scan: k / C lanes down, an own lane
// below the shift from the shadow (the first warp's lanes keep their
// own value: max(u, u + k*decay) = u); the shadow's lanes below the
// shift keep theirs.
template <int C, Mode M>
__device__ __forceinline__ bool shadow_shuffle_rounds(float (&v)[C],
                                                      float (&sv)[C],
                                                      const Team<C, M>& tm,
                                                      float decay) {
#pragma unroll
  for (int d = 1; d < kWarp; d *= 2) {
    const int k = d * C;
    if (k >= tm.width) return false;
    const float kd = static_cast<float>(k) * decay;
    const bool below = tm.lane < d && tm.warp > 0;
    const int src = (tm.lane - d) & (kWarp - 1);
    float a[C], b[C], sa[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      a[c] = __shfl_up_sync(kAll, v[c], d);
      b[c] = __shfl_sync(kAll, sv[c], src);
      sa[c] = __shfl_up_sync(kAll, sv[c], d);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = fmaxf(v[c], (below ? b[c] : a[c]) + kd);
      sv[c] = fmaxf(sv[c], sa[c] + kd);
    }
  }
  return true;
}

// The rounds of a team of several warps: the in-warp rounds on own and
// shadow columns, then the rounds k >= 32C through the edge buffer.
template <int C, Mode M>
__device__ __forceinline__ void team_scan(float (&v)[C], float (&sv)[C],
                                          Team<C, M>& tm, float decay) {
  if (shadow_lane_rounds<1>(v, sv, tm, decay) &&
      shadow_shuffle_rounds(v, sv, tm, decay))
    cross_rounds(v, tm, decay);
}

// (columns a lane, warps a block, blocks a pair) of a row of W lanes, and
// its mode.
struct Geometry {
  int cols, warps, blocks;
  Mode mode;
};

inline Geometry geometry(int W) {
  if (W <= kWarpLanes) {
    Geometry g{2, 1, 1, Mode::kWarp};
    while (g.cols * kWarp < W) g.cols *= 2;
    return g;
  }
  if (W <= kBlockLanes)
    return {kBlockCols, (W + kWarp * kBlockCols - 1) / (kWarp * kBlockCols),
            1, Mode::kBlock};
  return {kClusterCols, kClusterLanes / (kWarp * kClusterCols),
          (W + kClusterLanes - 1) / kClusterLanes, Mode::kCluster};
}

// Shared memory of a block: the table (rounded to 16 bytes), then the
// edge buffer's four regions but in warp mode.
__host__ __device__ inline int table_floats(int K1) {
  return (K1 * K1 + 3) / 4 * 4;
}

inline size_t smem_bytes(const Geometry& g, int K1) {
  const size_t half = static_cast<size_t>(g.cols) * max_threads(g.mode);
  return (table_floats(K1) + (g.mode == Mode::kWarp ? 0 : 4 * half)) *
         sizeof(float);
}

// Launches kern on B pairs (clusters of g.blocks blocks in cluster
// mode), checking the launch.
template <class... Params, class... Args>
inline cudaError_t launch(void (*kern)(Params...), const Geometry& g, int B,
                          size_t smem, cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * g.blocks);
  cfg.blockDim = dim3(g.warps * kWarp);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = g.mode == Mode::kCluster ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Warp mode: launch.template run<C, Mode::kWarp>(g) for the geometry's
// C, instantiated for C = 2, 4, ... up to kWarpLanes / 32 only.
template <int C, class Launch>
inline cudaError_t run_warp(const Geometry& g, const Launch& l) {
  if constexpr (C * kWarp <= kWarpLanes) {
    if (g.cols == C) return l.template run<C, Mode::kWarp>(g);
    return run_warp<2 * C>(g, l);
  } else {
    return cudaErrorInvalidValue;
  }
}

// Calls launch.template run<C, M>(g) for the geometry's instantiation;
// cudaErrorInvalidValue past the widest row.
template <class Launch>
inline cudaError_t dispatch(int W, const Launch& l) {
  if (W < 1 || W > kClusterLanes * kMaxCluster) return cudaErrorInvalidValue;
  const Geometry g = geometry(W);
  if (g.mode == Mode::kCluster)
    return l.template run<kClusterCols, Mode::kCluster>(g);
  if (g.mode == Mode::kBlock)
    return l.template run<kBlockCols, Mode::kBlock>(g);
  return run_warp<2>(g, l);
}

}  // namespace dp
