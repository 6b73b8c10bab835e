// Kernel A: pair-HMM forward pass from letters (the kernel is in
// pairhmm_fwd.cuh; kernel 1E, its emission-lattice form, in
// pairhmm_fwd_emis.cu), and kernel 1M, the same kernel with per-pair
// score tables.
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_fwd_kernel (kk=K, launched
// by _fwd_pallas_fused; kernel 1M: the per-pair-table form that
// batch_posteriors_pallas_multi runs, with per-pair params rows from
// _params_rows_multi). Ly <= 10240 (S <= 5).
#include "pairhmm_fwd.cuh"

// per_pair = 0: one (K+1)^2 match table, one (K+1) insert table and one
// (16,) params vector shared by every pair (kernel A). per_pair = 1:
// match (B, K+1, K+1), insert (B, K+1) and params (B, 16), one table set
// a pair, the ensembles' replicates in one launch (kernel 1M).
extern "C" int pairhmm_fwd(const int* xb, const int* yb, const int* lxb,
                           const int* lyb, const float* match,
                           const float* insert, const float* params,
                           int per_pair, int B, int Lx, int Ly, int kk,
                           float* fm, float* fend, void* stream) {
  const CodeEmission::Args args{xb, yb, match, insert, kk,
                                per_pair ? kk * kk : 0, per_pair ? kk : 0};
  return dispatch_fwd<CodeEmission, 5>(B, static_cast<cudaStream_t>(stream),
                                       args, lxb, lyb, params,
                                       per_pair ? 16 : 0, Lx, Ly, fm, fend);
}
