// Kernel 6: pair-HMM backward pass fused with the posterior combine and
// the MEA row over the whole padded Y row of every pair of a batch, cut
// into reversed stripes of W lanes, in one launch that runs the stripes
// as a skewed wavefront of groups across SMs.
//
// Replaces muscle_tpu/ops/pairhmm_striped.py::_bwd_stripe_kernel
// (pairhmm_striped.py:312, launched by _bwd_stripe_call once per
// stripe). reference: src/bwdflat3.cpp:10-190,
// src/calcposteriorflat.cpp:4-27, src/calcalnscoreflat.cpp:4-32.
//
// Numbers: kernel B's recurrence (pairhmm_bwd_post.cu) on each reversed
// stripe of W flipped lanes (reversed stripe sp is forward stripe
// S-1-sp read right to left), with what crosses its left edge taken from
// the reversed stripe before it, exactly as the per-stripe twin
// bwd_stripe_plain chains it:
//   - the M shift-in of step u takes that stripe's last-lane M at step
//     u-1, and the posterior's one-lane shift its M at step u;
//   - the IY/JY scans take its step-u IY/JY as carries injected into
//     lane 0, u_0 = LOG_ADD(carry + a_0, c_0), and as the fill of their
//     shift into M; the carry chain over the stripe's segments starts
//     from NEG_BIG at its segment 0;
//   - the MEA row's shift takes its MEA at step u-1, and the new row is
//     raised to its MEA at step u (the max-plus carry).
// Reversed stripe 0 runs the column-0 chains instead. Flipped lanes
// below By-ly are padding and carry the column boundary chains. The
// boundary row B(lx, .) comes from the global closed forms iy0b/jy0b;
// steps u <= u0 = Lx-lx keep it. Every operation is kernel B's, so
// kernel and twin agree bit for bit.
//
// Schedule (stripe_wavefront.cuh): a block is one group, G warps = G
// segments of one pair, and one launch runs all B * By / (64 G) groups.
// Inside a stripe, the segment left of a group's lane 0 hands over its
// last lane's M, IY, JY and MEA and the chain carries leaving it; at a
// stripe edge the same last-lane values are the twin's boundary column
// (the MEA carry max over the segments before is the left group's final
// MEA: max is exact in any order). So a record is eight floats a step
// [M, IY, JY, MEA, carry IY, carry JY, 0, 0]. Each step combines the
// backward M row with forward row Lx-1-u into the posterior, written in
// place over that forward row: the thread of a cell reads fm there and
// writes the posterior to the same cell, so the pass needs no second
// (B, Lx, By) lattice (the port updates in place where the JAX package,
// whose arrays are immutable, writes a new stripe). The group also zeroes
// its lanes of rows past lx. Outputs: the posterior over fm, and mea
// (B,) the MEA row's last lane, written by the last group.
//
// What bounds it on the H100: for the function, bytes (the M lattice
// read and the posterior written, 8 bytes a cell, against ~146 f32
// operations a real cell). A step is a serial chain (the IY/JY scans,
// the G-step carry chain, the five-way M fold, the MEA max-scan, five
// block barriers), so the pass is bound by Lx times one step's critical
// path plus the wavefront's skew. Why a wavefront: one block per pair
// and one launch per stripe ran the stripes one after another on one
// SM; the groups of a pair now run at once on By / (64 G) SMs.
//
// The body is pairhmm_bwd_wave_kernel (pairhmm_wave.cuh), shared with
// kernel B's wide schedule, here with the closed forms as row 0
// (kRow0 = false) and the letter emission source.
#include "pairhmm_wave.cuh"

using namespace ph;

extern "C" int pairhmm_bwd_stripe(const int* xb, const int* yb,
                                  const int* lxb, const int* lyb,
                                  const float* match, const float* insert,
                                  const float* params, const float* tot,
                                  const float* iy0b, const float* jy0b, int B,
                                  int Lx, int By, int Wd, int G, int kk, int R,
                                  long long wait_ns, int* sync, int* fault,
                                  float* hand,
                                  float* fm_post, float* mea, void* stream) {
  if (!wave_ok(B, By, Wd, G, R) || Wd > 2048 || 32 % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const CodeEmission::Args args{xb, yb, match, insert, kk, 0, 0};
  const int groups = By / (64 * G);
  // the posterior goes over the forward's M lattice, in place
  pairhmm_bwd_wave_kernel<CodeEmission, false>
      <<<B * groups, G * 32, bwd_wave_smem<CodeEmission>(args, G),
         static_cast<cudaStream_t>(stream)>>>(
          args, lxb, lyb, params, 0, tot, const_cast<float*>(iy0b),
          const_cast<float*>(jy0b), nullptr, B, Lx, By, Wd, G, R, wait_ns,
          sync, fault, reinterpret_cast<wf::Rec8*>(hand), fm_post, fm_post,
          mea, nullptr);
  return static_cast<int>(cudaGetLastError());
}
