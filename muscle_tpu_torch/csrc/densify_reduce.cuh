// Shared body of kernels 7 and 7L, the device joins' densify-reduce
// (densify_reduce.cu: the refine joins' pair-index grid;
// densify_reduce_list.cu: PProg's sampled-pair runs).
//
// Both replace muscle_tpu/pipeline/devjoin.py::_dr_kernel (:88). For a
// row-owner s with entries e (each a store row p_e of the (P1, L, K)
// store and a col-owner t_e) they compute
//
//   F[s, l, c] = sum over e, in entry order, of vals[p_e, l, k]
//                where c = bank[t_e, cols[p_e, l, k]]
//
// with bank the col-owners' pos->col maps. The Pallas kernel compares
// against the col->pos inverse maps instead; both select the same cells.
// A row's slots hold unique positions and pos->col is injective, so an F
// cell takes at most one value per entry: the sums need no atomics and,
// taken in entry order, repeat the plain versions'
// (ops/devjoin_cuda.py) bits. The two variants differ only in where an
// owner's entries come from (GridRows, ListRuns below), as the pair-HMM
// kernels differ only in their emission source (pairhmm_common.cuh).
//
// What bounds it on the H100: bytes, ~0.075 ms for a 100 x 100 refine
// half at L = 512, cc = 768 (F written once, the real pairs' valid
// slots read once). The first version (one block-wide barrier per entry,
// every entry of the grid row walked, rows * k2 items spread over the
// block) took 1.0 ms there: a chain of dependent loads per entry (pid,
// slots, values, bank gather, add) with nothing of the next entry in
// flight. The store is far larger than L2, so every real pair's row
// comes from device memory at a random place; a row holds ~5 valid
// slots, valid slots first (ops/sparse.py). The design:
//
// * Entries are staged once per block, in chunks of blockDim.x: each
//   thread reads one entry, a ballot and a prefix over the warps compact
//   the real ones (not the dump row, in range) in order into shared
//   memory. Dump pairs of the grid cost one read per block.
// * A warp owns 2 tile rows and 16 lanes own a row's slots, 16 slots
//   (64 bytes) a step. The lanes of one row add into distinct cells, and
//   each cell is written by one warp only, entry after entry, with a
//   __syncwarp() between entries: no block barrier inside the walk.
// * Only what a row holds is read: a row ends at its first empty slot,
//   so the next 16 slots are read only where a ballot finds the last 16
//   full (k2 > 16, rare; any k2 up to K). A step's values are loaded
//   beside its slots, so an entry costs one device-memory round trip and
//   one L2 gather of the bank map.
// * Loads stay in flight: a warp issues the first steps (slots and
//   values) of the next kAhead entries together, then their bank loads,
//   then adds them in order. The bank maps (n_c * L * 4 B, ~200 KB)
//   stay in L2, read through the read-only path.
// * The (tr, tc) tile of F lives in dynamic shared memory (above 48 KB
//   when it must): ops/devjoin_cuda.py::_geometry takes as many warps a
//   block (1-8) as keep a block within a quarter of an SM, the whole cc
//   where it fits, column tiles where not. The tile goes to F once with
//   16-byte stores: a whole-row tile is one contiguous run of F, placed
//   in shared memory at F's alignment.
//
// Measured on the H100 (tools/torch_densify_reduce_probe.py; PERF.md
// §6): the n = 200 half takes ~0.30 ms, ~0.05 of it the tile's zero
// fill and F's write, ~0.11 the walk with the store's rows in L2, the
// rest the store's rows from device memory. Neither 8 lanes a row, 16
// entries ahead, values loaded only behind valid slots, a block barrier
// per group of entries, nor 16-warp blocks moved it by more than ~12 %.
//
// Contract: the store's valid slots come first in each row (sparsify's
// descending order); with it the kernels repeat the plain versions'
// bits. Arithmetic: __fadd_rn only, and the build passes -fmad=false.
#pragma once

#include <cuda_runtime.h>

#define DR_FULL 0xffffffffu

namespace dr {

constexpr int kMaxThreads = 256;   // 8 warps a block at most
constexpr int kLanes = 16;         // lanes a row: 64 bytes of slots a step
constexpr int kRowsPerWarp = 32 / kLanes;
// entries whose loads a warp keeps in flight ahead of its adds
constexpr int kAhead = 8;

// Kernel 7: owner s's entries are its grid row pid[s, 0:n_c]; entry t
// takes bank row t.
struct GridRows {
  const int* pid;
  int n_c;
  __device__ int begin(int s) const { return 0; }
  __device__ int end(int s) const { return n_c; }
  __device__ void at(int s, int e, int& p, int& t) const {
    p = __ldg(pid + (size_t)s * n_c + e);
    t = e;
  }
  __device__ int banks() const { return n_c; }
};

// Kernel 7L: owner s's entries are the run row_ptr[s]..row_ptr[s + 1];
// entry e takes store row pid[e] and bank row co[e].
struct ListRuns {
  const int* row_ptr;
  const int* pid;
  const int* co;
  int n2;
  __device__ int begin(int s) const { return __ldg(row_ptr + s); }
  __device__ int end(int s) const { return __ldg(row_ptr + s + 1); }
  __device__ void at(int s, int e, int& p, int& t) const {
    p = __ldg(pid + e);
    t = __ldg(co + e);
  }
  __device__ int banks() const { return n2; }
};

struct Args {
  const float* vals;
  const int* cols;
  int P1, L, K, k2;
  const int* bank;
  int dump, cc;
  int tr, tc;  // tile rows (kRowsPerWarp a warp), tile columns
  float* out;
};

// One block of tr / kRowsPerWarp warps per (row-owner s = blockIdx.x,
// tile of tr rows, tile of tc columns).
template <class Source>
__global__ void __launch_bounds__(kMaxThreads)
densify_reduce_kernel(Source src, Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int ep[kMaxThreads], et[kMaxThreads], wcount[kMaxThreads / 32];
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int s = blockIdx.x;
  const int r0 = blockIdx.y * a.tr, c0 = blockIdx.z * a.tc;
  const int rows = min(a.tr, a.L - r0), width = min(a.tc, a.cc - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // A whole-row tile is F's run [(s * L + r0) * cc, + rows * cc): place
  // it at that run's 16-byte phase so both sides take float4 accesses.
  const size_t gbase = ((size_t)s * a.L + r0) * a.cc + c0;
  const int phase = a.tc == a.cc ? (int)(gbase & 3) : 0;
  float* tile = smem + phase;
  const int n4 = (phase + a.tr * a.tc + 3) >> 2;  // within tr * tc + 8
  for (int i = threadIdx.x; i < n4; i += nthreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // this lane's tile row, its slot in a step, and its row's lanes
  const int r = warp * kRowsPerWarp + lane / kLanes;
  const int k = lane % kLanes;
  const unsigned rmask = 0xffffu << (lane & ~(kLanes - 1));
  const bool row_ok = r < rows;
  const bool warp_ok = warp * kRowsPerWarp < rows;  // uniform over the warp
  const size_t row_off = (size_t)(r0 + r) * a.K;
  const size_t stride = (size_t)a.L * a.K;
  float* trow = tile + r * a.tc;

  const int e0 = src.begin(s), e1 = src.end(s), n_t = src.banks();
  for (int c = e0; c < e1; c += nthreads) {
    // stage this chunk's real entries, in order
    const int e = c + threadIdx.x;
    int p = 0, t = 0;
    bool ok = false;
    if (e < e1) {
      src.at(s, e, p, t);
      ok = p != a.dump && p >= 0 && p < a.P1 && t >= 0 && t < n_t;
    }
    const unsigned m = __ballot_sync(DR_FULL, ok);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();  // also orders the tile's zero fill before the adds
    int off = 0, n = 0;
    for (int w = 0; w < nwarps; ++w) {
      off += w < warp ? wcount[w] : 0;
      n += wcount[w];
    }
    if (ok) {
      const int i = off + __popc(m & ((1u << lane) - 1u));
      ep[i] = p;
      et[i] = t;
    }
    __syncthreads();

    for (int b = 0; warp_ok && b < n; b += kAhead) {
      int pos[kAhead], col[kAhead];
      float v[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {  // first steps: slots, values
        pos[u] = -1;
        v[u] = 0.f;
        if (b + u < n && row_ok && k < a.k2) {
          const size_t o = ep[b + u] * stride + row_off + k;
          pos[u] = __ldg(a.cols + o);
          v[u] = __ldg(a.vals + o);
        }
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {  // their columns
        col[u] = -1;
        if (pos[u] >= 0 && pos[u] < a.L)
          col[u] = __ldg(a.bank + (size_t)et[b + u] * a.L + pos[u]) - c0;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {  // the adds, entry after entry
        if (col[u] >= 0 && col[u] < width)
          trow[col[u]] = __fadd_rn(trow[col[u]], v[u]);
        // rows whose step was full go on to the next one
        bool more = (__ballot_sync(DR_FULL, pos[u] >= 0) & rmask) == rmask;
        for (int j = kLanes; j < a.k2 && __any_sync(DR_FULL, more);
             j += kLanes) {
          int q = -1;
          float w = 0.f;
          if (more && j + k < a.k2) {
            const size_t o = ep[b + u] * stride + row_off + j + k;
            q = __ldg(a.cols + o);
            w = __ldg(a.vals + o);
          }
          if (q >= 0 && q < a.L) {
            const int cl = __ldg(a.bank + (size_t)et[b + u] * a.L + q) - c0;
            if (cl >= 0 && cl < width) trow[cl] = __fadd_rn(trow[cl], w);
          }
          more = (__ballot_sync(DR_FULL, q >= 0) & rmask) == rmask;
        }
        __syncwarp();  // entry b + u's adds before entry b + u + 1's
      }
    }
    __syncthreads();  // the staged entries are read before the next chunk
  }

  // the tile to F once
  __syncthreads();  // (an owner with no entry skipped the chunk loop)
  if (a.tc == a.cc) {
    float* dst = a.out + gbase;
    const int total = rows * a.cc;
    const int head = min(total, (4 - phase) & 3);
    if ((int)threadIdx.x < head) dst[threadIdx.x] = tile[threadIdx.x];
    const int body = (total - head) >> 2;
    const float4* src4 = reinterpret_cast<const float4*>(tile + head);
    float4* dst4 = reinterpret_cast<float4*>(dst + head);
    for (int i = threadIdx.x; i < body; i += nthreads) dst4[i] = src4[i];
    for (int j = head + 4 * body + threadIdx.x; j < total; j += nthreads)
      dst[j] = tile[j];
  } else {
    for (int rr = warp; rr < rows; rr += nwarps) {
      float* dst = a.out + gbase + (size_t)rr * a.cc;
      const float* sr = tile + rr * a.tc;
      if ((a.cc & 3) == 0) {  // c0 and tc are multiples of 4 too
        for (int j = lane; j < width >> 2; j += 32)
          reinterpret_cast<float4*>(dst)[j] =
              reinterpret_cast<const float4*>(sr)[j];
      } else {
        for (int j = lane; j < width; j += 32) dst[j] = sr[j];
      }
    }
  }
}

// Launch on (n_owners, ceil(L / tr), ceil(cc / tc)) blocks of
// tr / kRowsPerWarp warps; the tile takes (tr * tc + 8) floats of
// dynamic shared memory (room for its phase and the float4 zero fill).
template <class Source>
cudaError_t launch(const Source& src, const Args& a, int n_owners,
                   cudaStream_t st) {
  const int threads = a.tr / kRowsPerWarp * 32;
  if (a.tr < kRowsPerWarp || a.tr % kRowsPerWarp != 0 ||
      threads > kMaxThreads || a.tc < 1 || a.k2 < 1 || a.k2 > a.K ||
      (a.tc != a.cc && (a.tc & 3) != 0))
    return cudaErrorInvalidValue;
  const size_t smem = ((size_t)a.tr * a.tc + 8) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      densify_reduce_kernel<Source>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(n_owners, (a.L + a.tr - 1) / a.tr,
                  (a.cc + a.tc - 1) / a.tc);
  densify_reduce_kernel<Source><<<grid, threads, smem, st>>>(src, a);
  return cudaGetLastError();
}

}  // namespace dr
