// Kernel 3K: the legacy pair-HMM backward pass from letters (the block
// body of pairhmm_bwd.cuh, whose steps kernel 3 runs on the wave, with
// the letter source of kernel A: codes read through reversed indices,
// tables in shared memory).
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_bwd_kernel (kk=K, launched
// by _bwd_pallas_fused): the letter path's legacy route, taken under
// MUSCLE_TPU_FUSED=0, with one table set for every pair (per_pair = 0)
// or match (B, K+1, K+1), insert (B, K+1) and params (B, 16), one a pair
// (per_pair = 1, batch_posteriors_pallas_multi's legacy route).
// Ly <= 10240 (S <= 5), as kernels A and B.
#include "pairhmm_bwd.cuh"

extern "C" int pairhmm_bwd_codes(const int* xb, const int* yb,
                                 const int* lxb, const int* lyb,
                                 const float* match, const float* insert,
                                 const float* params, int per_pair, int B,
                                 int Lx, int Ly, int kk, float* rbm,
                                 void* stream) {
  const CodeEmission::Args args{xb, yb, match, insert, kk,
                                per_pair ? kk * kk : 0, per_pair ? kk : 0};
  return dispatch_bwd<CodeEmission>(B, static_cast<cudaStream_t>(stream),
                                       args, lxb, lyb, params,
                                       per_pair ? 16 : 0, Lx, Ly, rbm);
}
