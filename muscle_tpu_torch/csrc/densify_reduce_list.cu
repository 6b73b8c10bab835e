// Kernel 7L: densify-reduce of PProg's sampled-pair joins, one thread
// block per (row-owner s, tile of its rows, tile of output columns).
//
// Replaces muscle_tpu/pipeline/devjoin.py::_dr_kernel in its list
// variant (per_pair_imap=True), driven by list_build_and_mea through
// align_sampled_device. A profile-profile join of msa1 against msa2
// samples up to ~2000 (msa1 row, msa2 row) pairs; their posteriors sit
// in rows pid[e] of a (P1, L, K) store. The sampled msa1 rows are
// compacted into row-owners s, and owner s's entries are the run
// e in [row_ptr[s], row_ptr[s + 1]), each with its store row pid[e] and
// its msa2 row co[e]. The kernel computes
//
//   F[s, l, c] = sum over e of owner s, in entry order, of P_e[l, p]
//                where c = pos_to_col_{co[e]}[p]
//
// — what JAX's f_acc.at[ro].add(e) computes over its chunks of 64
// pairs. As in kernel 7 (csrc/densify_reduce.cu) each valid slot
// (value v, position p) of row l adds v at column bank[co[e], p] (the
// pos->col map), where the Pallas kernel compares against the inverse
// col->pos map: both select the same cells. Each F cell gets at most
// one value per entry, added in entry order, so the kernel and its
// plain version (ops/devjoin_cuda.py::densify_reduce_list_plain) agree
// bit for bit with no atomics. The only difference from kernel 7 is the
// per-entry indirection bank + co[e] * L in place of bank + t * L.
//
// What bounds it on the H100: bytes. It reads the sampled pairs' valid
// slots (8 B each) and writes F once (4 B x n_s x L x cc): ~0.05 ms for
// 2000 pairs of a 128 x 128-row join at L = 384, a few valid slots a
// row, cc = 600, most of it F. The design: the block's (rows, cols) output tile
// lives in shared memory for the whole loop over the owner's entries;
// per entry the block reads its rows' slots as one contiguous run of
// the store row (coalesced), adds into the tile and waits at one
// barrier, which also keeps the adds in entry order; dump and
// out-of-range entries are skipped whole. The tile goes to F once,
// coalesced.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
densify_reduce_list_kernel(const float* __restrict__ vals,
                           const int* __restrict__ cols, int P1, int L,
                           int K, int k2, const int* __restrict__ row_ptr,
                           const int* __restrict__ pid,
                           const int* __restrict__ co,
                           const int* __restrict__ bank, int n2, int dump,
                           int cc, int tr, int tc, float* __restrict__ out) {
  extern __shared__ float tile[];
  const int s = blockIdx.x;
  const int r0 = blockIdx.y * tr, c0 = blockIdx.z * tc;
  const int rows = min(tr, L - r0), width = min(tc, cc - c0);
  for (int e = threadIdx.x; e < tr * tc; e += blockDim.x) tile[e] = 0.0f;
  __syncthreads();
  const int e0 = row_ptr[s], e1 = row_ptr[s + 1];
  for (int e = e0; e < e1; ++e) {
    const int p = pid[e], t = co[e];
    // uniform over the block
    if (p == dump || p < 0 || p >= P1 || t < 0 || t >= n2) continue;
    const float* v = vals + ((size_t)p * L + r0) * K;
    const int* c = cols + ((size_t)p * L + r0) * K;
    const int* b2c = bank + (size_t)t * L;
    for (int q = threadIdx.x; q < rows * k2; q += blockDim.x) {
      const int r = q / k2, k = q - r * k2;
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
// row_ptr: (n_s + 1) int32 entry runs of the row-owners; pid, co: int32
// store row and col-owner of each entry; bank: (n2, L) int32 pos->col
// of the col-owners; out: (n_s, L, cc) f32. tr x tc is the shared-memory
// tile.
extern "C" int densify_reduce_list(const float* vals, const int* cols,
                                   int P1, int L, int K, int k2,
                                   const int* row_ptr, int n_s,
                                   const int* pid, const int* co,
                                   const int* bank, int n2, int dump, int cc,
                                   int tr, int tc, float* out, void* stream) {
  const dim3 grid(n_s, (L + tr - 1) / tr, (cc + tc - 1) / tc), block(256);
  const size_t smem = (size_t)tr * tc * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  densify_reduce_list_kernel<<<grid, block, smem, st>>>(
      vals, cols, P1, L, K, k2, row_ptr, pid, co, bank, n2, dump, cc, tr, tc,
      out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* densify_reduce_list_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
