// Kernel 1E: pair-HMM forward pass from a precomputed (B, Lx, Ly) f32
// emission lattice (Muscle-3D feature profiles) with per-position insert
// scores; the kernel is kernel A's with the lattice as its emission
// source, on kernel A's two schedules.
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_fwd_kernel (kk=None,
// launched by _fwd_pallas, and by _emissions_path_fused, also with the
// per-pair params rows of batch_posteriors_pallas_multi). per_pair is 0
// for one (16,) params vector, 1 for (B, 16) rows.
//
// G = 0: one block a pair (pairhmm_fwd.cuh), Ly <= 2048 (S = 1; the
// 384 rung of the main path). G > 0: the wide schedule
// (pairhmm_wave.cuh), each pair's row cut into groups of G segments that
// run at once on as many SMs, handing each DP row's edge values on
// through `hand` (the arguments as kernel A's, pairhmm_fwd.cu). Its
// source is LatticeAhead: the loads of row i + 1's lattice cells and x
// insert score are started before row i runs, so their latency stays off
// the row's dependent chain. At 12288 (mega-long's chunk, 8 pairs) that
// is 48 groups of 4 segments a pair on all SMs: 31.3-32.9 ms on an H100
// 80GB HBM3 at 700 W, where one block a pair ran 8 of 132 SMs, each row
// a serial chain with ~1 KB of spills a thread (S = 6), 382 ms
// (tools/torch_fwd_densify_probe.py). A row takes ~1.9 us while each SM
// holds one group's block and ~3.4 us at the chunk's 384 blocks (~3 an
// SM): the wave is then bound by the SMs' instruction throughput, not
// by a row's chain.
//
// What bounds it: the function reads the lattice's real cells and
// writes the M lattice's once (8 bytes a cell: ~1.5 ms for the chunk's
// 9.6e7 cells at 3.35 TB/s); the rows are a dependent chain, so the
// wave's floor is lx times one row's critical path
// (chip_smoke.row_floor_ms, ~8 ms for the chunk).
#include "pairhmm_fwd.cuh"
#include "pairhmm_wave.cuh"

extern "C" int pairhmm_fwd_emis(const float* e, const float* ins_x,
                                const float* ins_y, const int* lxb,
                                const int* lyb, const float* params,
                                int per_pair, int B, int Lx, int Ly, int G,
                                int R, long long wait_ns, int* sync,
                                int* fault, float* hand, float* row0,
                                float* fm, float* fend, void* stream) {
  const LatticeEmission::Args args{e, ins_x, ins_y};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G > 0)
    return launch_fwd_wave<LatticeAhead>(B, st, args, lxb, lyb, params,
                                         per_pair ? 16 : 0, Lx, Ly, G, R,
                                         wait_ns, sync, fault, hand, row0, fm,
                                         fend);
  return dispatch_fwd<LatticeEmission, 1>(B, st, args, lxb, lyb, params,
                                          per_pair ? 16 : 0, Lx, Ly, fm, fend);
}
