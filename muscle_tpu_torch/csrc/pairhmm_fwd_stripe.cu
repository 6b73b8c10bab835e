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
#include "pairhmm_common.cuh"
#include "stripe_wavefront.cuh"

using namespace ph;

namespace {
// LOG_ADDs as selects, not branches (pairhmm_common.cuh select_f): the
// same bits, and a thread's independent LOG_ADDs interleave
constexpr bool kBF = true;
}  // namespace
__global__ void __launch_bounds__(1024)
pairhmm_fwd_stripe_kernel(const int* __restrict__ xb,
                          const int* __restrict__ yb,
                          const int* __restrict__ lxb,
                          const int* __restrict__ lyb,
                          const float* __restrict__ match,
                          const float* __restrict__ insert,
                          const float* __restrict__ params,
                          const float* __restrict__ iy0,
                          const float* __restrict__ jy0, int B, int Lx,
                          int By, int Wd, int G, int kk, int R,
                          long long wait_ns, int* __restrict__ sync,
                          int* __restrict__ fault,
                          wf::Rec4* __restrict__ hand,
                          float* __restrict__ fend, float* __restrict__ fm) {
  extern __shared__ float smem[];
  float* s_match = smem;
  float* s_ins = s_match + kk * kk;
  float* s_edge_c = s_ins + kk;        // fold edge (G)
  float* s_edge_m = s_edge_c + G;      // M edge (G)
  float* s_tot = s_edge_m + G;         // 4 * G
  float* s_carry = s_tot + 4 * G;      // 2 * (G + 1)

  const int g = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int k = threadIdx.x; k < kk * kk; k += blockDim.x) s_match[k] = match[k];
  for (int k = threadIdx.x; k < kk; k += blockDim.x) s_ins[k] = insert[k];
  const int t = wf::take_ticket(sync);  // (its barrier covers the tables)
  const int groups = By / (64 * G);
  const int gi = t / B, b = t % B;
  const int nseg_w = Wd >> 6;
  const int seg0 = gi * G;                      // first global segment
  const bool has_left = gi > 0;                 // else stripe 0, lane 0
  const bool left_edge = seg0 % nseg_w == 0;    // starts a stripe
  const bool has_right = gi + 1 < groups;
  const bool right_edge = (seg0 + G) % nseg_w == 0;
  const bool chain_out = has_right && !right_edge;
  const float tSM = params[TSM], tSI = params[TSI], tSJ = params[TSJ];
  const float tMM = params[TMM], tMI = params[TMI], tMJ = params[TMJ];
  const float tII = params[TII], tIM = params[TIM], tJJ = params[TJJ];
  const float tJM = params[TJM];
  const int lx = lxb[b], ly = lyb[b];
  const int* xrow = xb + (size_t)b * Lx;
  float* fm_b = fm + (size_t)b * Lx * By;
  int* progress = sync + wf::PROGRESS + b * groups + gi;
  wf::Rec4* out = hand + ((size_t)b * groups + gi) * Lx;
  wf::Window<wf::Rec4> win(has_left ? progress - 1 : progress,
                           has_left ? out - Lx : out, fault,
                           wait_ns, 0);

  const int j = seg0 * 64 + g * 64 + 2 * l;  // this thread's lanes j, j + 1
  int yc[2];
  float insy[2], m[2], ix[2], iy[2], jx[2], jy[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    yc[e] = yb[(size_t)b * By + j + e];
    insy[e] = s_ins[yc[e]];
    m[e] = ix[e] = jx[e] = LOG_ZERO;
    iy[e] = iy0[(size_t)b * By + j + e];
    jy[e] = jy0[(size_t)b * By + j + e];
  }
  const bool owner = g == G - 1 && l == 31;  // holds the group's last lane

  float ix0 = LOG_ZERO, jx0 = LOG_ZERO;  // column-0 chains (group 0)
  for (int i = 0; i < lx; ++i) {
    // the left group's record of row i: fold edge, M edge, carries or
    // last column's IY/JY (warp 0 only)
    float h_c = LOG_ZERO, h_m = LOG_ZERO, h_i = NEG_BIG, h_j = NEG_BIG;
    if (has_left && g == 0) {
      if (i >= win.ready) win.refill(i, lx, l);
      const int src = i - win.base;
      h_c = wf::field(win.rec.v, 0, src);
      h_m = wf::field(win.rec.v, 1, src);
      h_i = wf::field(win.rec.v, 2, src);
      h_j = wf::field(win.rec.v, 3, src);
    }
    const int xc = xrow[i];
    const float insx = s_ins[xc];
    const float* mrow = s_match + xc * kk;
    float comb[2], ixn[2], jxn[2], mn[2], aI[2], cI[2], aJ[2], cJ[2];

    // (1) fold of the five predecessors; IX/JX rows
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      comb[e] = log_add5<kBF>(__fadd_rn(m[e], tMM), __fadd_rn(ix[e], tIM),
                              __fadd_rn(jx[e], tJM), __fadd_rn(iy[e], tIM),
                              __fadd_rn(jy[e], tJM));
      ixn[e] = __fadd_rn(
          log_add<kBF>(__fadd_rn(ix[e], tII), __fadd_rn(m[e], tMI)), insx);
      jxn[e] = __fadd_rn(
          log_add<kBF>(__fadd_rn(jx[e], tJJ), __fadd_rn(m[e], tMJ)), insx);
    }
    if (l == 31) s_edge_c[g] = comb[1];
    // left of the group's lane 0: the left group's fold edge (at a
    // stripe edge, the twin's fold of the left stripe's last column),
    // else the column-0 chains
    const float fill = has_left ? h_c
                                : log_add<kBF>(__fadd_rn(ix0, tIM),
                                               __fadd_rn(jx0, tJM));
    const float ix0n = i == 0 ? __fadd_rn(tSI, insx)
                              : __fadd_rn(__fadd_rn(ix0, tII), insx);
    const float jx0n = i == 0 ? __fadd_rn(tSJ, insx)
                              : __fadd_rn(__fadd_rn(jx0, tJJ), insx);
    __syncthreads();

    // (2) M row = fold shifted one lane + emission
    {
      const float left = left_of_even(comb[1], fill, s_edge_c, g, l);
      const float e0 = mrow[yc[0]], e1 = mrow[yc[1]];
      mn[0] = __fadd_rn(left, e0);
      mn[1] = __fadd_rn(comb[0], e1);
      if (!has_left && i == 0 && g == 0 && l == 0) mn[0] = __fadd_rn(tSM, e0);
      *reinterpret_cast<float2*>(fm_b + (size_t)i * By + j) =
          make_float2(mn[0], mn[1]);
      if (l == 31) s_edge_m[g] = mn[1];
    }
    __syncthreads();

    // (3) IY/JY within-row scans, segment level; the left group's M
    // edge fills the M shift, and at a stripe edge its last column's
    // IY/JY carry into lane 0
    {
      const float msh[2] = {left_of_even(mn[1], h_m, s_edge_m, g, l), mn[0]};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        aI[e] = __fadd_rn(insy[e], tII);
        cI[e] = __fadd_rn(__fadd_rn(msh[e], tMI), insy[e]);
        aJ[e] = __fadd_rn(insy[e], tJJ);
        cJ[e] = __fadd_rn(__fadd_rn(msh[e], tMJ), insy[e]);
      }
      if (has_left && left_edge && g == 0 && l == 0) {
        cI[0] = log_add<kBF>(__fadd_rn(h_i, aI[0]), cI[0]);
        cJ[0] = log_add<kBF>(__fadd_rn(h_j, aJ[0]), cJ[0]);
      }
      seg_scan<kBF>(aI, cI, l);
      seg_scan<kBF>(aJ, cJ, l);
      if (l == 31) {
        s_tot[g] = aI[1];
        s_tot[G + g] = cI[1];
        s_tot[2 * G + g] = aJ[1];
        s_tot[3 * G + g] = cJ[1];
      }
    }
    __syncthreads();
    // (4) carry over the group's segments, from the left group's carry
    // inside a stripe (NEG_BIG at a stripe's segment 0); one step more
    // for the right neighbour inside the stripe
    if (threadIdx.x < 2) {
      const int tt = threadIdx.x;
      const float* ta = s_tot + 2 * tt * G;
      const float* tc = ta + G;
      float* car = s_carry + tt * (G + 1);
      float cc = has_left && !left_edge ? (tt == 0 ? h_i : h_j) : NEG_BIG;
      car[0] = cc;
      const int steps = chain_out ? G : G - 1;
      for (int s = 0; s < steps; ++s) {
        cc = log_add_p<kBF>(__fadd_rn(cc, ta[s]), tc[s]);
        car[s + 1] = cc;
      }
    }
    __syncthreads();

    // (5) combine; new row becomes the state; record for the right
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      iy[e] = log_add_p<kBF>(__fadd_rn(s_carry[g], aI[e]), cI[e]);
      jy[e] = log_add_p<kBF>(__fadd_rn(s_carry[G + 1 + g], aJ[e]), cJ[e]);
      m[e] = mn[e];
      ix[e] = ixn[e];
      jx[e] = jxn[e];
      if (i == lx - 1 && j + e == ly - 1) {
        float* o = fend + (size_t)b * 5;
        o[0] = m[e];
        o[1] = ix[e];
        o[2] = iy[e];
        o[3] = jx[e];
        o[4] = jy[e];
      }
    }
    if (owner && has_right) {
      const float ri = right_edge ? iy[1] : s_carry[G];
      const float rj = right_edge ? jy[1] : s_carry[2 * G + 1];
      wf::stcg(out + i, wf::Rec4{make_float4(comb[1], mn[1], ri, rj)});
      wf::publish(progress, i, 0, lx, R);
    }
    ix0 = ix0n;
    jx0 = jx0n;
  }
}

extern "C" int pairhmm_fwd_stripe(const int* xb, const int* yb,
                                  const int* lxb, const int* lyb,
                                  const float* match, const float* insert,
                                  const float* params, const float* iy0,
                                  const float* jy0, int B, int Lx, int By,
                                  int Wd, int G, int kk, int R,
                                  long long wait_ns, int* sync, int* fault,
                                  float* hand,
                                  float* fend, float* fm, void* stream) {
  if (Wd % 64 != 0 || Wd < 64 || Wd > 2048 || By % Wd != 0 || G < 1 ||
      G > 32 || 32 % G != 0 || (Wd / 64) % G != 0 || R < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = By / (64 * G);
  const size_t smem = sizeof(float) * (size_t)(kk * kk + kk + 8 * G + 2);
  pairhmm_fwd_stripe_kernel<<<B * groups, G * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      xb, yb, lxb, lyb, match, insert, params, iy0, jy0, B, Lx, By, Wd, G, kk,
      R, wait_ns, sync, fault, reinterpret_cast<wf::Rec4*>(hand), fend, fm);
  return static_cast<int>(cudaGetLastError());
}
