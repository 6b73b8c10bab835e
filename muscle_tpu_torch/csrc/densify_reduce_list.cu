// Kernel 7L: densify-reduce of PProg's sampled-pair joins.
//
// Replaces muscle_tpu/pipeline/devjoin.py::_dr_kernel (:88) in its list
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
// pairs. Kernel 7's body (densify_reduce.cuh) with the owners' runs as
// its entry source; the header says what bounds it on the H100 (bytes:
// F written once, the sampled pairs' valid slots read once) and what the
// design does about that. Dump and out-of-range entries add nothing.
#include "densify_reduce.cuh"

// vals/cols: (P1, L, K) store, of which the first k2 slots are read;
// row_ptr: (n_s + 1) int32 entry runs of the row-owners; pid, co: int32
// store row and col-owner of each entry; bank: (n2, L) int32 pos->col
// of the col-owners; out: (n_s, L, cc) f32. tr x tc: the tile
// (ops/devjoin_cuda.py::_geometry).
extern "C" int densify_reduce_list(const float* vals, const int* cols,
                                   int P1, int L, int K, int k2,
                                   const int* row_ptr, int n_s,
                                   const int* pid, const int* co,
                                   const int* bank, int n2, int dump, int cc,
                                   int tr, int tc, float* out,
                                   void* stream) {
  const dr::ListRuns src{row_ptr, pid, co, n2};
  const dr::Args a{vals, cols, P1, L, K, k2, bank, dump, cc, tr, tc, out};
  return static_cast<int>(
      dr::launch(src, a, n_s, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* densify_reduce_list_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
