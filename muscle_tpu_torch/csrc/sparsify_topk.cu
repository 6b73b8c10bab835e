// The sparsify's top-K selection: each posterior row's K largest entries,
// a warp a row, the row read once.
//
// Replaces muscle_tpu/ops/sparse.py:38 sparsify's jax.lax.top_k (XLA, not
// Pallas): of each row of a (B, Lx, Ly) f32 posterior, finite and >= 0,
// the entries > 0 in order of value descending, then column ascending
// (lax.top_k's order on ties), into (B, Lx, K) vals f32 and cols int32,
// empty slots 0.0 / -1; and the largest count of entries > 0 in a row
// (all of them, past K too), atomicMax'ed into a zeroed int32.
//
// Keys: an entry v > 0 at column c is the 64-bit key
// (bits(v) << 32) | (0xFFFFFFFF - c). Non-negative floats order as their
// bits do and columns are unique in a row, so the keys are distinct and
// their descending order is the output order; the empty key 0 decodes
// to 0.0 / -1 by the same two lines. The warp keeps a sorted list of
// 32 * S keys, S in a lane's registers (rank s * 32 + lane), and offers
// it each entry > 0 that beats its last key: pos = the count of keys
// above the entry (S ballots), ranks past pos shift down one (shuffles;
// lane 0 of stripe s takes lane 31 of stripe s - 1), the entry goes to
// rank pos, the last key falls off. K > 32 * S (S is at most 8) takes
// more passes over the row: pass p keeps the keys below pass p - 1's last
// one, ranks p * 32 * S on, until a pass ends short of a full list or
// the K slots are written. ops/sparse.py::sparsify_schedule_model runs
// this schedule on the CPU.
//
// What bounds it on the H100: bytes, the posterior read once (4 B a
// cell) and the output written once (8 B a slot): 0.18 ms at 512 x
// 512^2, 1.44 ms at mega-long's chunk (8 x 12288^2), 3.35 TB/s. A
// row's entries > 0 are few (~5 on average, the store's K = 32 is rarely
// reached), so a warp's work is its row's 16-byte loads, four ballots a
// 128 columns, and one insert an entry; the next 128 columns are loaded
// before the current ones are offered. Blocks of 8 warps walk the rows
// in a grid-stride loop (8 blocks an SM), one atomicMax a block.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
using Key = unsigned long long;

__device__ __forceinline__ Key make_key(float v, int col) {
  return (static_cast<Key>(__float_as_uint(v)) << 32) |
         static_cast<Key>(0xffffffffu - static_cast<unsigned>(col));
}

// a warp's sorted list of 32 * S keys, descending by rank s * 32 + lane
template <int S>
struct TopList {
  Key key[S];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < S; ++s) key[s] = 0;
  }

  // the key at the last rank (0 while the list is not full)
  __device__ __forceinline__ Key last() const {
    return __shfl_sync(kFull, key[S - 1], 31);
  }

  // c (warp-uniform, above last(), not in the list) into its rank
  __device__ __forceinline__ void insert(Key c, int lane) {
    int pos = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) pos += __popc(__ballot_sync(kFull, key[s] > c));
    Key up[S], carry[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      up[s] = __shfl_up_sync(kFull, key[s], 1);
      carry[s] = s > 0 ? __shfl_sync(kFull, key[s > 0 ? s - 1 : 0], 31) : 0;
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int r = s * 32 + lane;
      if (r == pos) key[s] = c;
      else if (r > pos) key[s] = lane > 0 ? up[s] : carry[s];
    }
  }
};

// one column of each lane offered to the list: the entries > 0 whose key
// lies in (kmin, bound), in lane order; nnz counts the entries > 0
template <int S>
__device__ __forceinline__ void offer(TopList<S>& list, float v, int col,
                                      Key& kmin, Key bound, int lane,
                                      int& nnz) {
  const Key mine = make_key(v, col);
  const bool nz = v > 0.0f;
  nnz += __popc(__ballot_sync(kFull, nz));
  unsigned m = __ballot_sync(kFull, nz && mine > kmin && mine < bound);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const Key c = __shfl_sync(kFull, mine, src);
    if (c > kmin) {
      list.insert(c, lane);
      kmin = list.last();
    }
  }
}

template <int S, bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    topk_kernel(const float* __restrict__ post, long long sb, long long sx,
                long long sy, int lx, int ly, long long rows, int k,
                float* __restrict__ vals, int* __restrict__ cols,
                int* __restrict__ max_nnz) {
  __shared__ int warp_max[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int row_max = 0;
  for (long long r = static_cast<long long>(blockIdx.x) * kWarps + warp;
       r < rows; r += static_cast<long long>(gridDim.x) * kWarps) {
    const long long b = r / lx;
    const float* row = post + b * sb + (r - b * lx) * sx;
    float* vout = vals + r * k;
    int* cout = cols + r * k;
    Key bound = ~0ull;
    for (int slot0 = 0; slot0 < k; slot0 += 32 * S) {
      TopList<S> list;
      list.clear();
      Key kmin = 0;
      int nnz = 0;
      if (kVec) {
        // 128 columns a step, 4 a lane; the next step's loaded ahead
        float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
        if (4 * lane < ly)
          next = *reinterpret_cast<const float4*>(row + 4 * lane);
        for (int c0 = 0; c0 < ly; c0 += 128) {
          const float4 v = next;
          const int col = c0 + 4 * lane;
          next = col + 128 < ly
                     ? *reinterpret_cast<const float4*>(row + col + 128)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
          offer(list, v.x, col, kmin, bound, lane, nnz);
          offer(list, v.y, col + 1, kmin, bound, lane, nnz);
          offer(list, v.z, col + 2, kmin, bound, lane, nnz);
          offer(list, v.w, col + 3, kmin, bound, lane, nnz);
        }
      } else {
        for (int c0 = 0; c0 < ly; c0 += 32) {
          const int col = c0 + lane;
          const float v = col < ly ? row[col * sy] : 0.f;
          offer(list, v, col, kmin, bound, lane, nnz);
        }
      }
      if (slot0 == 0) row_max = max(row_max, nnz);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int slot = slot0 + s * 32 + lane;
        if (slot < k) {
          vout[slot] = __uint_as_float(static_cast<unsigned>(list.key[s] >> 32));
          cout[slot] = static_cast<int>(
              0xffffffffu - static_cast<unsigned>(list.key[s]));
        }
      }
      const Key tail = list.last();
      if (tail == 0) {
        // the list ended short: the rest of the row's slots are empty
        for (int slot = slot0 + 32 * S + lane; slot < k; slot += 32) {
          vout[slot] = 0.f;
          cout[slot] = -1;
        }
        break;
      }
      bound = tail;
    }
  }
  if (lane == 0) warp_max[warp] = row_max;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
    for (int w = 0; w < kWarps; ++w) m = max(m, warp_max[w]);
    if (m > 0) atomicMax(max_nnz, m);
  }
}

template <int S>
void launch(bool vec, int blocks, cudaStream_t st, const float* post,
            long long sb, long long sx, long long sy, int lx, int ly,
            long long rows, int k, float* vals, int* cols, int* max_nnz) {
  if (vec)
    topk_kernel<S, true><<<blocks, kWarps * 32, 0, st>>>(
        post, sb, sx, sy, lx, ly, rows, k, vals, cols, max_nnz);
  else
    topk_kernel<S, false><<<blocks, kWarps * 32, 0, st>>>(
        post, sb, sx, sy, lx, ly, rows, k, vals, cols, max_nnz);
}

}  // namespace

// post: (b, lx, ly) f32 with element strides (sb, sx, sy); vec = 1 only
// where sy = 1, ly % 4 = 0 and every row starts 16-byte aligned. stripes
// (S, keys a lane a pass): 1, 2, 4 or 8. vals / cols: contiguous (b, lx,
// k); max_nnz: one zeroed int32. Returns the launch's cudaError_t.
extern "C" int sparsify_topk(const float* post, long long sb, long long sx,
                             long long sy, int b, int lx, int ly, int k,
                             int stripes, int vec, int blocks, float* vals,
                             int* cols, int* max_nnz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = static_cast<long long>(b) * lx;
  switch (stripes) {
    case 1:
      launch<1>(vec, blocks, st, post, sb, sx, sy, lx, ly, rows, k, vals,
                cols, max_nnz);
      break;
    case 2:
      launch<2>(vec, blocks, st, post, sb, sx, sy, lx, ly, rows, k, vals,
                cols, max_nnz);
      break;
    case 4:
      launch<4>(vec, blocks, st, post, sb, sx, sy, lx, ly, rows, k, vals,
                cols, max_nnz);
      break;
    case 8:
      launch<8>(vec, blocks, st, post, sb, sx, sy, lx, ly, rows, k, vals,
                cols, max_nnz);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sparsify_topk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
