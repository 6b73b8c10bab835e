// Kernel A: pair-HMM forward pass from letters (the kernel is in
// pairhmm_fwd.cuh; kernel 1E, its emission-lattice form, in
// pairhmm_fwd_emis.cu).
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_fwd_kernel (kk=K, launched
// by _fwd_pallas_fused). Ly <= 10240 (S <= 5).
#include "pairhmm_fwd.cuh"

extern "C" int pairhmm_fwd(const int* xb, const int* yb, const int* lxb,
                           const int* lyb, const float* match,
                           const float* insert, const float* params, int B,
                           int Lx, int Ly, int kk, float* fm, float* fend,
                           void* stream) {
  const CodeEmission::Args args{xb, yb, match, insert, kk};
  return dispatch_fwd<CodeEmission, 5>(B, static_cast<cudaStream_t>(stream),
                                       args, lxb, lyb, params, Lx, Ly, fm,
                                       fend);
}
