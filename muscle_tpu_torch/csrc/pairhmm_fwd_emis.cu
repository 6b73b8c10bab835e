// Kernel 1E: pair-HMM forward pass from a precomputed (B, Lx, Ly) f32
// emission lattice (Muscle-3D feature profiles) with per-position insert
// scores; the kernel is kernel A's (pairhmm_fwd.cuh) with the lattice as
// its emission source.
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_fwd_kernel (kk=None,
// launched by _fwd_pallas, and by _emissions_path_fused, also with the
// per-pair params rows of batch_posteriors_pallas_multi). Ly <= 12288
// (S <= 6): the legacy route of the emissions path runs pads of 12288
// (ops/pairhmm_emis_cuda.py). per_pair is 0 for one (16,) params vector,
// 1 for (B, 16) rows.
#include "pairhmm_fwd.cuh"

extern "C" int pairhmm_fwd_emis(const float* e, const float* ins_x,
                                const float* ins_y, const int* lxb,
                                const int* lyb, const float* params,
                                int per_pair, int B, int Lx, int Ly,
                                float* fm, float* fend, void* stream) {
  const LatticeEmission::Args args{e, ins_x, ins_y};
  return dispatch_fwd<LatticeEmission, 6>(
      B, static_cast<cudaStream_t>(stream), args, lxb, lyb, params,
      per_pair ? 16 : 0, Lx, Ly, fm, fend);
}
