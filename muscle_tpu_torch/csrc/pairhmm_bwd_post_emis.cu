// Kernel 2E: pair-HMM backward + posterior + MEA from the forward-layout
// (B, Lx, Ly) f32 emission lattice that kernel 1E read (Muscle-3D
// feature profiles); the kernel is kernel B's (pairhmm_bwd_post.cuh) with
// the lattice as its emission source, read through reversed indices.
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_bwd_post_kernel (kk=None,
// flip_e=True, launched by _bwd_post_pallas_emissions, also with the
// per-pair params rows of batch_posteriors_pallas_multi). The fused route
// takes Ly <= FUSED_MAX_LY = 9856 (S <= 5). per_pair is 0 for one (16,)
// params vector, 1 for (B, 16) rows.
#include "pairhmm_bwd_post.cuh"

extern "C" int pairhmm_bwd_post_emis(const float* e, const float* ins_x,
                                     const float* ins_y, const int* lxb,
                                     const int* lyb, const float* params,
                                     int per_pair, const float* tot, int B,
                                     int Lx, int Ly, const float* fm,
                                     float* post, float* mea, void* stream) {
  const LatticeEmission::Args args{e, ins_x, ins_y};
  return dispatch_bwd_post<LatticeEmission, 5>(
      B, static_cast<cudaStream_t>(stream), args, lxb, lyb, params,
      per_pair ? 16 : 0, tot, Lx, Ly, 1, fm, post, mea);
}
