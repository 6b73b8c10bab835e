// Kernel 3K: the legacy pair-HMM backward pass from letters, with the
// letter source of kernel A (codes read through reversed indices, tables
// in shared memory).
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_bwd_kernel (kk=K, launched
// by _bwd_pallas_fused): the letter path's legacy route, taken under
// MUSCLE_TPU_FUSED=0, with one table set for every pair (per_pair = 0)
// or match (B, K+1, K+1), insert (B, K+1) and params (B, 16), one a pair
// (per_pair = 1, batch_posteriors_pallas_multi's legacy route).
// Ly <= 10240, as kernels A and B, and on their two schedules
// (ops/pairhmm_cuda.py::bwd_codes_geometry picks): G = 0, one block a
// pair (pairhmm_bwd.cuh's block body, Ly <= 2048 only); G > 0, kernel
// 3's wave (pairhmm_wave.cuh's backward body with kLegacy), each pair's
// row cut into groups of G segments that run at once on as many SMs,
// handing each step's edge values on through `hand` (with the ticket and
// counters `sync`, zeroed, the fault flag, R steps a publication, the
// watchdog's wait_ns), the boundary row computed in the launch (row0, 4
// B Ly floats). On the letter lattice match[x_i, y_j] kernel 3K is
// kernel 3, as 1E is A: the same steps, the same bits.
//
// corner (B, 5), when not null: the five backward states of each pair at
// the reversed lattice's far corner (row lx, column ly), for -testfb's
// total_prob_bwd; both bodies then run one step more (their kCorner
// instances), and the caller passes Lx > lx. A null corner launches the
// bodies without it.
#include "pairhmm_bwd.cuh"
#include "pairhmm_wave.cuh"

extern "C" int pairhmm_bwd_codes(const int* xb, const int* yb,
                                 const int* lxb, const int* lyb,
                                 const float* match, const float* insert,
                                 const float* params, int per_pair, int B,
                                 int Lx, int Ly, int kk, int G, int R,
                                 long long wait_ns, int* sync, int* fault,
                                 float* hand, float* row0, float* rbm,
                                 float* corner, void* stream) {
  const CodeEmission::Args args{xb, yb, match, insert, kk,
                                per_pair ? kk * kk : 0, per_pair ? kk : 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ps = per_pair ? 16 : 0;
  if (G > 0 && corner)
    return launch_bwd_legacy_wave<CodeEmission, true>(
        B, st, args, lxb, lyb, params, ps, Lx, Ly, G, R, wait_ns, sync,
        fault, hand, row0, rbm, corner);
  if (G > 0)
    return launch_bwd_legacy_wave<CodeEmission>(
        B, st, args, lxb, lyb, params, ps, Lx, Ly, G, R, wait_ns, sync,
        fault, hand, row0, rbm);
  return dispatch_bwd<CodeEmission>(B, st, args, lxb, lyb, params, ps, Lx,
                                    Ly, rbm, corner);
}
