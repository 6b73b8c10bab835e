// Kernel 5: pair-HMM forward pass over the whole padded Y row of every
// pair of a batch, cut into stripes of W lanes, in one launch that runs
// the stripes as a skewed wavefront of groups across SMs.
//
// Replaces muscle_tpu/ops/pairhmm_striped.py::_fwd_stripe_kernel
// (pairhmm_striped.py:96, launched by _fwd_stripe_call once per stripe).
// reference: src/fwdflat3.cpp:12-153.
//
// Numbers: kernel A's recurrence (pairhmm_fwd.cu) on each stripe of W
// lanes, with what crosses a stripe's left edge taken from the stripe to
// its left, exactly as the per-stripe twin fwd_stripe_plain chains it:
//   - the one-lane shift into M at the stripe's lane 0 folds the five
//     states of the left stripe's last column at DP row i (DP row 0 from
//     the global closed forms iy0/jy0 when i = 0), and its c operand
//     takes that column's new M;
//   - the within-row IY/JY scan takes that column's new IY/JY as a carry
//     injected into lane 0, u_0 = LOG_ADD(carry + a_0, c_0), and its
//     carry chain over the stripe's 64-lane segments starts from NEG_BIG
//     at the stripe's segment 0.
// Stripe 0 runs the column-0 chains instead. The segmented scan, the
// chain's order, the LOG_ADD variants and every operation are kernel
// A's, so kernel and twin agree bit for bit.
//
// Schedule (stripe_wavefront.cuh): a block is one group, G warps = G
// segments of one pair (G divides W / 64), and one launch runs all B *
// By / (64 G) groups. The fold at a segment's lane 0 is the fold of the
// lane to its left, so at a stripe edge it is the left stripe's fold
// edge, the five-state LOG_ADD5 the twin computes from that column. So a
// group's left neighbour hands over per DP row four floats: its fold
// edge, its M edge, and its IY/JY chain carries (inside a stripe) or its
// last column's IY/JY (at a stripe edge). Inside a group, the block runs
// today's stages with G warps: four block barriers a row and a G-step
// carry chain. Outputs: the M lattice fm (B, Lx, By) (rows past lx are
// not written; the wrapper zeroes them) and the final states fend (B, 5)
// at (lx, ly), written by the thread holding column ly.
//
// What bounds it on the H100: for the function, operations (~130 f32
// operations a real cell against 4 bytes written a cell): 0.70 ms for the
// long pair's 3.6e8 cells. A DP row is a serial chain, so the pass is
// bound by Lx times one row's critical path (the five-way fold, six
// shuffle + LOG_ADD rounds of the scan, the G-step carry chain, four
// barriers) plus the wavefront's skew (a group starts ~R rows after its
// left neighbour). Why a wavefront: one block per pair and one launch
// per stripe ran the stripes one after another on one SM; the groups of
// a pair now run at once on By / (64 G) SMs, and a row's pace is set by
// one warp's chain (~1.2 us at G = 4 with the LOG_ADDs as selects,
// kBF), not by the hand-over.
//
// The body is pairhmm_fwd_wave_kernel (pairhmm_wave.cuh), shared with
// kernel A's wide schedule, here with the closed forms as row 0
// (kRow0 = false) and the letter emission source.
#include "pairhmm_wave.cuh"

using namespace ph;

extern "C" int pairhmm_fwd_stripe(const int* xb, const int* yb,
                                  const int* lxb, const int* lyb,
                                  const float* match, const float* insert,
                                  const float* params, const float* iy0,
                                  const float* jy0, int B, int Lx, int By,
                                  int Wd, int G, int kk, int R,
                                  long long wait_ns, int* sync, int* fault,
                                  float* hand,
                                  float* fend, float* fm, void* stream) {
  if (!wave_ok(B, By, Wd, G, R) || Wd > 2048 || 32 % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const CodeEmission::Args args{xb, yb, match, insert, kk, 0, 0};
  const int groups = By / (64 * G);
  // the closed forms are read, never written (kRow0 = false)
  pairhmm_fwd_wave_kernel<CodeEmission, false>
      <<<B * groups, G * 32, fwd_wave_smem<CodeEmission>(args, G),
         static_cast<cudaStream_t>(stream)>>>(
          args, lxb, lyb, params, 0, const_cast<float*>(iy0),
          const_cast<float*>(jy0), nullptr, B, Lx, By, Wd, G, R, wait_ns,
          sync, fault, reinterpret_cast<wf::Rec4*>(hand), fend, fm);
  return static_cast<int>(cudaGetLastError());
}
