// Kernel 3: the legacy pair-HMM backward pass from a precomputed
// (B, Lx, Ly) f32 emission lattice (Muscle-3D feature profiles), read
// through reversed indices.
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_bwd_kernel (kk=None,
// launched by _bwd_pallas): the emissions path's legacy route beyond
// FUSED_MAX_LY. Ly <= 12288. per_pair is 0 for one (16,) params vector,
// 1 for (B, 16) rows.
//
// Kernel 3's layout and steps are pairhmm_bwd.cuh's (kernel 3K's block
// body), run on kernels A and B's wide schedule: pairhmm_wave.cuh's
// backward body with kLegacy, each pair's row cut into groups of G
// segments (ops/pairhmm_emis_cuda.bwd_geometry) that run at once on as
// many SMs, handing each step's edge values on through `hand`; the
// boundary row computed in the launch with kernel 3's rounds (row0, 4 B
// Ly floats). At 12288 (mega-long's chunk, 8 pairs) that is 48 groups of
// 4 segments a pair, a group's step ~4 us; one block a pair ran 8 of 132
// SMs, each row a ~60 us chain with ~1 KB of spills a thread.
#include "pairhmm_wave.cuh"

using namespace ph;

extern "C" int pairhmm_bwd(const float* e, const float* ins_x,
                           const float* ins_y, const int* lxb, const int* lyb,
                           const float* params, int per_pair, int B, int Lx,
                           int Ly, int G, int R, long long wait_ns, int* sync,
                           int* fault, float* hand, float* row0, float* rbm,
                           void* stream) {
  const LatticeEmission::Args args{e, ins_x, ins_y};
  return launch_bwd_legacy_wave<LatticeEmission>(
      B, static_cast<cudaStream_t>(stream), args, lxb, lyb, params,
      per_pair ? 16 : 0, Lx, Ly, G, R, wait_ns, sync, fault, hand, row0, rbm);
}
