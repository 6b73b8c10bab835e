// Kernel B: pair-HMM backward + posterior + MEA from letters (the kernel
// is in pairhmm_bwd_post.cuh; kernel 2E, its emission-lattice form, in
// pairhmm_bwd_post_emis.cu).
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_bwd_post_kernel (kk=K,
// launched by _bwd_post_pallas). Ly <= 10240 (S <= 5).
#include "pairhmm_bwd_post.cuh"

extern "C" int pairhmm_bwd_post(const int* xb, const int* yb, const int* lxb,
                                const int* lyb, const float* match,
                                const float* insert, const float* params,
                                const float* tot, int B, int Lx, int Ly,
                                int kk, int with_mea, const float* fm,
                                float* post, float* mea, void* stream) {
  const CodeEmission::Args args{xb, yb, match, insert, kk};
  return dispatch_bwd_post<CodeEmission, 5>(
      B, static_cast<cudaStream_t>(stream), args, lxb, lyb, params, tot, Lx,
      Ly, with_mea, fm, post, mea);
}
