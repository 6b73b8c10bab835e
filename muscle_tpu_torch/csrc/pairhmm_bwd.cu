// Kernel 3: the legacy pair-HMM backward pass from a precomputed
// (B, Lx, Ly) f32 emission lattice (Muscle-3D feature profiles), read
// through reversed indices; the kernel is in pairhmm_bwd.cuh.
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_bwd_kernel (kk=None,
// launched by _bwd_pallas): the emissions path's legacy route beyond
// FUSED_MAX_LY. Ly <= 12288 (S <= 6). per_pair is 0 for one (16,) params
// vector, 1 for (B, 16) rows.
#include "pairhmm_bwd.cuh"

extern "C" int pairhmm_bwd(const float* e, const float* ins_x,
                           const float* ins_y, const int* lxb, const int* lyb,
                           const float* params, int per_pair, int B, int Lx,
                           int Ly, float* rbm, void* stream) {
  const LatticeEmission::Args args{e, ins_x, ins_y};
  return dispatch_bwd<LatticeEmission, 6>(
      B, static_cast<cudaStream_t>(stream), args, lxb, lyb, params,
      per_pair ? 16 : 0, Lx, Ly, rbm);
}
