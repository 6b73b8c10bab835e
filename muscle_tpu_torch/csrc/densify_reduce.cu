// Kernel 7: densify-reduce of the device refine joins, through the
// pair-index grid.
//
// Replaces muscle_tpu/pipeline/devjoin.py::_dr_kernel (:88), grid
// variant, driven by _densify_reduce inside _half. For a join of profile
// rows s (row-owners) against rows t (col-owners), with pid (n_r, n_c)
// the store row of pair (s, t) (or the dump row where the pair is stored
// the other way round), it computes
//
//   F[s, l, c] = sum over t, in order, of P_st[l, p] where
//                c = pos_to_col_t[p]
//
// straight from the (P1, L, K) store: owner s's entries are its grid
// row, entry t reads bank row t. The body, what bounds it on the H100
// (bytes: F written once, ~0.075 ms for a 100 x 100 half at L = 512,
// cc = 768) and what its design does about that are in
// densify_reduce.cuh, shared with kernel 7L.
#include "densify_reduce.cuh"

// vals/cols: (P1, L, K) store, of which the first k2 slots are read;
// pid: (n_r, n_c) int32; bank: (n_c, L) int32 pos->col of the
// col-owners; out: (n_r, L, cc) f32. tr x tc: the tile
// (ops/devjoin_cuda.py::_geometry).
extern "C" int densify_reduce(const float* vals, const int* cols, int P1,
                              int L, int K, int k2, const int* pid, int n_r,
                              int n_c, const int* bank, int dump, int cc,
                              int tr, int tc, float* out,
                              void* stream) {
  const dr::GridRows src{pid, n_c};
  const dr::Args a{vals, cols, P1, L, K, k2, bank, dump, cc, tr, tc, out};
  return static_cast<int>(
      dr::launch(src, a, n_r, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* densify_reduce_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
