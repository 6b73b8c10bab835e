// Kernel A: pair-HMM forward pass from letters (the kernel is in
// pairhmm_fwd.cuh; kernel 1E, its emission-lattice form, in
// pairhmm_fwd_emis.cu), and kernel 1M, the same kernel with per-pair
// score tables.
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_fwd_kernel (kk=K, launched
// by _fwd_pallas_fused; kernel 1M: the per-pair-table form that
// batch_posteriors_pallas_multi runs, with per-pair params rows from
// _params_rows_multi). Ly <= 10240 (S <= 5). Two schedules of the same
// arithmetic: one block a pair, or the wide schedule's wavefront of
// groups across SMs (ops/pairhmm_cuda.py::ab_geometry picks).
#include "pairhmm_fwd.cuh"
#include "pairhmm_wave.cuh"

// per_pair = 0: one (K+1)^2 match table, one (K+1) insert table and one
// (16,) params vector shared by every pair (kernel A). per_pair = 1:
// match (B, K+1, K+1), insert (B, K+1) and params (B, 16), one table set
// a pair, the ensembles' replicates in one launch (kernel 1M).
// G = 0: one block a pair (pairhmm_fwd.cuh). G > 0: the wide schedule,
// groups of G segments as a skewed wavefront (pairhmm_wave.cuh), with
// the hand-over's ticket and counters `sync` (zeroed), its records
// `hand`, the fault flag, R rows a publication, the watchdog's wait_ns,
// and row0 (4 B Ly floats) for row 0.
extern "C" int pairhmm_fwd(const int* xb, const int* yb, const int* lxb,
                           const int* lyb, const float* match,
                           const float* insert, const float* params,
                           int per_pair, int B, int Lx, int Ly, int kk, int G,
                           int R, long long wait_ns, int* sync, int* fault,
                           float* hand, float* row0, float* fm, float* fend,
                           void* stream) {
  const CodeEmission::Args args{xb, yb, match, insert, kk,
                                per_pair ? kk * kk : 0, per_pair ? kk : 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > 0)
    return launch_fwd_wave<CodeEmission>(B, st, args, lxb, lyb, params,
                                         per_pair ? 16 : 0, Lx, Ly, G, R,
                                         wait_ns, sync, fault, hand, row0, fm,
                                         fend);
  return dispatch_fwd<CodeEmission, 5>(B, st, args, lxb, lyb, params,
                                       per_pair ? 16 : 0, Lx, Ly, fm, fend);
}
