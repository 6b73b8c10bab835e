// Kernel B: pair-HMM backward + posterior + MEA from letters (the kernel
// is in pairhmm_bwd_post.cuh; kernel 2E, its emission-lattice form, in
// pairhmm_bwd_post_emis.cu), and kernel 2M, the same kernel with per-pair
// score tables.
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_bwd_post_kernel (kk=K,
// launched by _bwd_post_pallas; kernel 2M: the per-pair-table form that
// batch_posteriors_pallas_multi runs). Ly <= 10240 (S <= 5). Two
// schedules, as kernel A's (pairhmm_fwd.cu).
#include "pairhmm_bwd_post.cuh"
#include "pairhmm_wave.cuh"

// per_pair as in pairhmm_fwd.cu: 0 for one table set shared by every
// pair (kernel B), 1 for one a pair (kernel 2M). G and the wave's
// buffers as in pairhmm_fwd.cu; the wide schedule always computes the
// MEA row.
extern "C" int pairhmm_bwd_post(const int* xb, const int* yb, const int* lxb,
                                const int* lyb, const float* match,
                                const float* insert, const float* params,
                                int per_pair, const float* tot, int B, int Lx,
                                int Ly, int kk, int with_mea, int G, int R,
                                long long wait_ns, int* sync, int* fault,
                                float* hand, float* row0, const float* fm,
                                float* post, float* mea, void* stream) {
  const CodeEmission::Args args{xb, yb, match, insert, kk,
                                per_pair ? kk * kk : 0, per_pair ? kk : 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > 0)
    return launch_bwd_wave<CodeEmission>(B, st, args, lxb, lyb, params,
                                         per_pair ? 16 : 0, tot, Lx, Ly, G, R,
                                         wait_ns, sync, fault, hand, row0, fm,
                                         post, mea);
  return dispatch_bwd_post<CodeEmission, 5>(
      B, st, args, lxb, lyb, params, per_pair ? 16 : 0, tot, Lx, Ly, with_mea,
      fm, post, mea);
}
