// Kernel 7: densify-reduce of the device refine joins, one thread block
// per (row-owner s, tile of its rows, tile of output columns).
//
// Replaces muscle_tpu/pipeline/devjoin.py::_dr_kernel (grid variant,
// driven by _densify_reduce inside _half). For a join of profile rows
// s (row-owners) against rows t (col-owners), with pid (n_r, n_c) the
// store row of pair (s, t) (or the dump row where the pair is stored
// the other way round), it computes
//
//   F[s, l, c] = sum over t, in order, of P_st[l, p] where
//                c = pos_to_col_t[p]
//
// straight from the (P1, L, K) store through the pair-index grid: each
// valid slot (value v, position p) of row l adds v at column
// pos_to_col_t[p]. The Pallas kernel compares against the col->pos
// inverse map instead; the two maps are inverse bijections between the
// positions and the non-gap columns of t, so both select the same
// cells. Each F cell gets at most one value per t (positions are unique
// within a row, pos_to_col is injective), added in t order — the Pallas
// kernel's `o += acc` order — so the kernel and its plain version
// (ops/devjoin_cuda.py::densify_reduce_plain) agree bit for bit with no
// atomics.
//
// What bounds it on the H100: bytes. It reads the real pairs' rows
// (8 B per slot, k2 slots per row) and the col-owners' maps, and
// writes F once (n_r * L * cc * 4 B): ~0.2 ms for a 100 x 100 grid at
// L = 512, k2 = 24, cc = 768. The design: the block's (rows, cols)
// output tile lives in shared memory for the whole loop over t; per t
// the block reads its rows' slots as one contiguous run of the store
// row (coalesced), adds into the tile, and waits at one barrier, which
// also keeps the adds in t order; dump pairs are skipped whole. The
// tile goes to F once, coalesced.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
densify_reduce_kernel(const float* __restrict__ vals,
                      const int* __restrict__ cols, int P1, int L, int K,
                      int k2, const int* __restrict__ pid, int n_c,
                      const int* __restrict__ bank, int dump, int cc,
                      int tr, int tc, float* __restrict__ out) {
  extern __shared__ float tile[];
  const int s = blockIdx.x;
  const int r0 = blockIdx.y * tr, c0 = blockIdx.z * tc;
  const int rows = min(tr, L - r0), width = min(tc, cc - c0);
  for (int e = threadIdx.x; e < tr * tc; e += blockDim.x) tile[e] = 0.0f;
  __syncthreads();
  for (int t = 0; t < n_c; ++t) {
    const int p = pid[(size_t)s * n_c + t];
    if (p == dump || p < 0 || p >= P1) continue;  // uniform over the block
    const float* v = vals + ((size_t)p * L + r0) * K;
    const int* c = cols + ((size_t)p * L + r0) * K;
    const int* b2c = bank + (size_t)t * L;
    for (int e = threadIdx.x; e < rows * k2; e += blockDim.x) {
      const int r = e / k2, k = e - r * k2;
      const int pos = c[r * K + k];
      if (pos < 0 || pos >= L) continue;
      const int col = b2c[pos] - c0;
      if (col < 0 || col >= width) continue;
      float* cell = tile + r * tc + col;
      *cell = __fadd_rn(*cell, v[r * K + k]);
    }
    __syncthreads();
  }
  for (int r = 0; r < rows; ++r) {
    float* dst = out + ((size_t)s * L + r0 + r) * cc + c0;
    for (int j = threadIdx.x; j < width; j += blockDim.x)
      dst[j] = tile[r * tc + j];
  }
}

}  // namespace

// vals/cols: (P1, L, K) store, of which the first k2 slots are read;
// pid: (n_r, n_c) int32; bank: (n_c, L) int32 pos->col of the
// col-owners; out: (n_r, L, cc) f32. tr x tc is the shared-memory tile.
extern "C" int densify_reduce(const float* vals, const int* cols, int P1,
                              int L, int K, int k2, const int* pid, int n_r,
                              int n_c, const int* bank, int dump, int cc,
                              int tr, int tc, float* out, void* stream) {
  const dim3 grid(n_r, (L + tr - 1) / tr, (cc + tc - 1) / tc), block(256);
  const size_t smem = (size_t)tr * tc * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  densify_reduce_kernel<<<grid, block, smem, st>>>(
      vals, cols, P1, L, K, k2, pid, n_c, bank, dump, cc, tr, tc, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* densify_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
