// The wavefront bodies of the pair-HMM kernels: one launch runs every
// pair of a batch, each pair's padded Y row cut into groups of G 64-lane
// segments that run at once on as many SMs, a few DP rows apart
// (stripe_wavefront.cuh: tickets, hand-over records, the watchdog).
//
//   - pairhmm_fwd_wave_kernel: kernel A's forward recurrence
//     (pairhmm_fwd.cuh), instantiated by kernel 5 (pairhmm_fwd_stripe.cu,
//     the row cut into stripes of W lanes), by kernel A's wide schedule
//     (pairhmm_fwd.cu, one stripe of the whole row) and by kernel 1E's
//     (pairhmm_fwd_emis.cu, the lattice read a row ahead: LatticeAhead);
//   - pairhmm_bwd_wave_kernel: kernel B's backward + posterior + MEA
//     (pairhmm_bwd_post.cuh), instantiated by kernel 6
//     (pairhmm_bwd_stripe.cu) and by kernel B's wide schedule
//     (pairhmm_bwd_post.cu); with kLegacy, kernel 3's legacy backward
//     (pairhmm_bwd.cuh) on its wide schedule (pairhmm_bwd.cu): the same
//     steps without the posterior and the MEA, in kernel 3's layout.
//
// Both are templated on the emission source (pairhmm_common.cuh) and on
// where row 0 (the forward's IY/JY row 0, the backward's boundary row
// B(lx, .)) comes from:
//   - kRow0 = false (kernels 5/6): given, (B, By) rows of the global
//     closed forms that ops/pairhmm_striped.py computes with XLA's
//     prefix-sum grouping;
//   - kRow0 = true (kernels A/B): computed in the launch by group 0 of
//     each pair with kernels A/B's own full-width Hillis-Steele rounds
//     (block_cumsum's, in device memory: `row_cumsum2`), then read by
//     every group of the pair once its left neighbour has published its
//     first rows. The association is A/B's, so the rows are theirs bit
//     for bit.
//
// Numbers. Inside a stripe a group hands its right neighbour, per DP row
// (or backward step), exactly the values its block-per-pair kernel reads
// across a segment edge: the forward's fold edge, M edge and the IY/JY
// chain carries leaving its last segment (the carry chain continues from
// the left group's carry in segment order, so it is kernel A's chain);
// the backward's last-lane M, IY, JY and MEA and the two carries (the
// MEA max-carry is the left group's final MEA: max is exact in any
// order). Across a stripe edge (kernels 5/6 only) the carries are
// injected into lane 0 of the scan instead (ops/pairhmm_striped.py). So
// with one stripe of the whole row, each kernel is kernel A's or B's
// arithmetic in kernel A's or B's association, and equals its plain
// version bit for bit.
//
// Speed. A row's pace is set by one warp's chain (the five-way fold, six
// shuffle + LOG_ADD_p rounds of each scan, a G-step carry chain, four or
// five block barriers), not by the hand-over; the LOG_ADDs are selects
// (kBF: select_f), since a warp's row is latency-bound here.
#pragma once

#include "pairhmm_common.cuh"
#include "stripe_wavefront.cuh"

namespace ph {

// Hillis-Steele prefix sums of two rows of n lanes in device memory by
// the whole block: init(j) gives lane j's two start values, round k adds
// lane j - k (or 0.0), as block_cumsum does, ping-ponging between (a, b)
// and (ta, tb); fin(j, sa, sb) turns lane j's two sums into the values
// left in a and b. Ends with the rows visible to the device (fence) and
// to the block (barrier).
template <class Init, class Fin>
__device__ void row_cumsum2(int n, float* a, float* b, float* ta, float* tb,
                            Init init, Fin fin) {
  int rounds = 0;
  for (int k = 1; k < n; k <<= 1) ++rounds;
  float* sa = (rounds & 1) ? ta : a;  // so that the sums end in a, b
  float* sb = (rounds & 1) ? tb : b;
  float* da = (rounds & 1) ? a : ta;
  float* db = (rounds & 1) ? b : tb;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float2 v = init(j);
    sa[j] = v.x;
    sb[j] = v.y;
  }
  __syncthreads();
  for (int k = 1; k < n; k <<= 1) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      da[j] = __fadd_rn(sa[j], j >= k ? sa[j - k] : 0.0f);
      db[j] = __fadd_rn(sb[j], j >= k ? sb[j - k] : 0.0f);
    }
    __syncthreads();
    float* t = sa;
    sa = da;
    da = t;
    t = sb;
    sb = db;
    db = t;
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float2 r = fin(j, sa[j], sb[j]);
    a[j] = r.x;
    b[j] = r.y;
  }
  __threadfence();
  __syncthreads();
}

// Forward. A block is one group: G warps, G segments of pair b, which
// hand their right neighbour per DP row a wf::Rec4 [fold edge, M edge,
// IY carry, JY carry] (at a stripe edge the last column's IY/JY instead
// of the carries). Outputs: the M lattice fm (B, Lx, By), rows < lx
// (rows past lx are not written), and fend (B, 5) at (lx, ly), written
// by the thread holding column ly - 1. Wd is the stripe width (By for
// kernel A); iy0/jy0 (B, By) row 0, written here when kRow0 (with
// row_tmp, (B, 2, By), as the rounds' second buffers).
template <class Src, bool kRow0>
__global__ void __launch_bounds__(1024)
pairhmm_fwd_wave_kernel(const typename Src::Args args,
                        const int* __restrict__ lxb,
                        const int* __restrict__ lyb,
                        const float* __restrict__ params, int pstride,
                        float* iy0, float* jy0, float* row_tmp, int B, int Lx,
                        int By, int Wd, int G, int R, long long wait_ns,
                        int* __restrict__ sync, int* __restrict__ fault,
                        wf::Rec4* __restrict__ hand,
                        float* __restrict__ fend, float* __restrict__ fm) {
  extern __shared__ float smem[];
  const int g = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int t = wf::take_ticket(sync);
  const int groups = By / (64 * G);
  const int gi = t / B, b = t % B;
  Src src(args, b, Lx, By, smem);
  float* s_edge_c = smem + Src::table_floats(args);  // fold edge (G)
  float* s_edge_m = s_edge_c + G;      // M edge (G)
  float* s_tot = s_edge_m + G;         // 4 * G
  float* s_carry = s_tot + 4 * G;      // 2 * (G + 1)
  const int nseg_w = Wd >> 6;
  const int seg0 = gi * G;                      // first global segment
  const bool has_left = gi > 0;                 // else column 0's chains
  const bool left_edge = seg0 % nseg_w == 0;    // starts a stripe
  const bool has_right = gi + 1 < groups;
  const bool right_edge = (seg0 + G) % nseg_w == 0;
  const bool chain_out = has_right && !right_edge;
  const float* pp = pair_params(params, pstride, b);
  const float tSM = pp[TSM], tSI = pp[TSI], tSJ = pp[TSJ];
  const float tMM = pp[TMM], tMI = pp[TMI], tMJ = pp[TMJ];
  const float tII = pp[TII], tIM = pp[TIM], tJJ = pp[TJJ];
  const float tJM = pp[TJM];
  const int lx = lxb[b], ly = lyb[b];
  float* fm_b = fm + (size_t)b * Lx * By;
  float* iy0_b = iy0 + (size_t)b * By;
  float* jy0_b = jy0 + (size_t)b * By;
  int* progress = sync + wf::PROGRESS + b * groups + gi;
  wf::Rec4* out = hand + ((size_t)b * groups + gi) * Lx;
  wf::Window<wf::Rec4> win(has_left ? progress - 1 : progress,
                           has_left ? out - Lx : out, fault, wait_ns, 0);
  __syncthreads();  // the emission tables

  if constexpr (kRow0) {
    // row 0 (reference: src/fwdflat3.cpp:35-93): kernel A's rounds over
    // the whole row by group 0; the others read it once their left
    // neighbour has published rows (so after group 0 wrote it)
    if (!has_left) {
      float* ti = row_tmp + (size_t)b * 2 * By;
      const float iy_base = __fsub_rn(tSI, tII);
      const float jy_base = __fsub_rn(tSJ, tJJ);
      row_cumsum2(
          By, iy0_b, jy0_b, ti, ti + By,
          [&](int j) {
            const float ins = src.insy(j, src.tag(j));
            return make_float2(__fadd_rn(ins, tII), __fadd_rn(ins, tJJ));
          },
          [&](int, float si, float sj) {
            return make_float2(__fadd_rn(iy_base, si),
                               __fadd_rn(jy_base, sj));
          });
    } else if (lx > 0) {
      if (g == 0) win.refill(0, lx, l);
      __syncthreads();
    }
  }

  const int j = seg0 * 64 + g * 64 + 2 * l;  // this thread's lanes j, j + 1
  int yc[2];
  float insy[2], m[2], ix[2], iy[2], jx[2], jy[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    yc[e] = src.tag(j + e);
    insy[e] = src.insy(j + e, yc[e]);
    m[e] = ix[e] = jx[e] = LOG_ZERO;
    iy[e] = __ldcg(iy0_b + j + e);
    jy[e] = __ldcg(jy0_b + j + e);
  }
  const bool owner = g == G - 1 && l == 31;  // holds the group's last lane

  float ix0 = LOG_ZERO, jx0 = LOG_ZERO;  // column-0 chains (group 0)
  if (lx > 0) src.prefetch(0, j);
  for (int i = 0; i < lx; ++i) {
    // the left group's record of row i: fold edge, M edge, carries or
    // last column's IY/JY (warp 0 only)
    float h_c = LOG_ZERO, h_m = LOG_ZERO, h_i = NEG_BIG, h_j = NEG_BIG;
    if (has_left && g == 0) {
      if (i >= win.ready) win.refill(i, lx, l);
      const int s = i - win.base;
      h_c = wf::field(win.rec.v, 0, s);
      h_m = wf::field(win.rec.v, 1, s);
      h_i = wf::field(win.rec.v, 2, s);
      h_j = wf::field(win.rec.v, 3, s);
    }
    src.row(i);
    if (i + 1 < lx) src.prefetch(i + 1, j);  // off the chain (LatticeAhead)
    const float insx = src.insx;
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
      const float2 ev = src.emit2(j, yc[0], yc[1]);
      mn[0] = __fadd_rn(left, ev.x);
      mn[1] = __fadd_rn(comb[0], ev.y);
      if (!has_left && i == 0 && g == 0 && l == 0) mn[0] = __fadd_rn(tSM, ev.x);
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

// Shared memory of a forward wave block, bytes.
template <class Src>
inline size_t fwd_wave_smem(const typename Src::Args& args, int G) {
  return sizeof(float) * (size_t)(Src::table_floats(args) + 8 * G + 2);
}

// Backward + posterior + MEA. Lane q holds forward column By-1-q (kernel
// B's flipped layout); lanes below By-ly are padding and carry the
// column boundary chains.
//
// kLegacy (kernel 3, one stripe of the whole row, row 0 in the launch):
// kernel 3's layout instead, lane v holding column ly-1-v, start-aligned
// (lanes v >= ly take LOG_ZERO emissions and insert scores, and compute
// the boundary row like the real lanes), steps u = 0..lx-1 reading x
// position lx-u; each step writes row u of RB_M = post (B, Lx, By) as
// shift_fill(M row, column-0 chain), the groups zero their lanes of rows
// u >= lx, and the record's MEA slot is unused (tot, fm, mea_out are
// not read). The steps are kernel 3's arithmetic in its association,
// so the wave repeats the block kernel's bits. A block is one group: G warps, G segments of
// pair b, which hand their right neighbour per step a wf::Rec8 [M, IY,
// JY, MEA, IY carry, JY carry, 0, 0] of their last lane (at a stripe edge
// the twin's boundary column). Each step combines the backward M row with
// forward row Lx-1-u of fm into the posterior, written to post (the same
// cell, so post may be fm: kernel 6 writes in place); the group also
// zeroes its lanes of post's rows past lx. mea (B,): the MEA row's last
// lane, written by the pair's last group. iy0b/jy0b (B, By): the
// boundary row B(lx, .) in flipped lanes, written here when kRow0 (with
// row_tmp as for the forward).
//
// kCorner (with kLegacy; kernel 3K for -testfb): one step more, u = lx,
// reading x position 0, handed on but not written to RB_M; then the
// thread holding lane ly-1 writes the five states [M, IX, IY, JX, JY] of
// row lx there (the reversed lattice's far corner) to corner (B, 5).
// The caller launches it with Lx > lx (the hand-over holds Lx steps a
// group). corner is not read otherwise.
template <class Src, bool kRow0, bool kLegacy = false, bool kCorner = false>
__global__ void __launch_bounds__(1024)
pairhmm_bwd_wave_kernel(const typename Src::Args args,
                        const int* __restrict__ lxb,
                        const int* __restrict__ lyb,
                        const float* __restrict__ params, int pstride,
                        const float* __restrict__ tot, float* iy0b,
                        float* jy0b, float* row_tmp, int B, int Lx, int By,
                        int Wd, int G, int R, long long wait_ns,
                        int* __restrict__ sync, int* __restrict__ fault,
                        wf::Rec8* __restrict__ hand, const float* fm,
                        float* post, float* __restrict__ mea_out,
                        float* __restrict__ corner) {
  static_assert(kLegacy || !kCorner, "the corner is the legacy body's");
  extern __shared__ float smem[];
  const int g = threadIdx.x >> 5, l = threadIdx.x & 31;
  const int t = wf::take_ticket(sync);
  const int groups = By / (64 * G);
  const int gi = t / B, b = t % B;
  Src src(args, b, Lx, By, smem);
  float* s_edge_m = smem + Src::table_floats(args);  // M state edge (G)
  float* s_edge_iy = s_edge_m + G;     // IY edge
  float* s_edge_jy = s_edge_iy + G;    // JY edge
  float* s_edge_mea = s_edge_jy + G;
  float* s_segmax = s_edge_mea + G;
  float* s_tot = s_segmax + G;         // 4 * G
  float* s_carry = s_tot + 4 * G;      // 2 * (G + 1)
  float* s_mea_in = s_carry + 2 * (G + 1);  // the left group's MEA
  const int nseg_w = Wd >> 6;
  const int seg0 = gi * G;                      // first flipped segment
  const bool has_left = gi > 0;                 // else column 0's chains
  const bool left_edge = seg0 % nseg_w == 0;
  const bool has_right = gi + 1 < groups;
  const bool right_edge = (seg0 + G) % nseg_w == 0;
  const bool chain_out = has_right && !right_edge;
  const float* pp = pair_params(params, pstride, b);
  const float tSM = pp[TSM], tSI = pp[TSI], tSJ = pp[TSJ];
  const float tMM = pp[TMM], tMI = pp[TMI], tMJ = pp[TMJ];
  const float tII = pp[TII], tIM = pp[TIM], tJJ = pp[TJJ];
  const float tJM = pp[TJM];
  const float totb = kLegacy ? 0.0f : tot[b];
  const int lx = lxb[b], ly = lyb[b];
  const int q0 = By - ly;   // flipped lanes below q0 are padding
  const float* fm_b = kLegacy ? fm : fm + (size_t)b * Lx * By;
  float* post_b = post + (size_t)b * Lx * By;
  float* iy0_b = iy0b + (size_t)b * By;
  float* jy0_b = jy0b + (size_t)b * By;
  int* progress = sync + wf::PROGRESS + b * groups + gi;
  wf::Rec8* out = hand + ((size_t)b * groups + gi) * Lx;
  // steps u0 .. uend-1; step u reads x position uend-u (u > u0)
  const int u0 = kLegacy ? 0 : Lx - lx;
  const int uend = kLegacy ? lx : Lx;
  const int usteps = uend + (kCorner ? 1 : 0);  // the steps run
  wf::Window<wf::Rec8> win(has_left ? progress - 1 : progress,
                           has_left ? out - Lx : out, fault, wait_ns, u0);
  __syncthreads();  // the emission tables

  if constexpr (kRow0) {
    // the boundary row B(lx, .): kernel B's rounds over the whole row,
    // prefix sums from the first real lane, by group 0; the others read
    // it once their left neighbour has published steps
    if (!has_left && kLegacy) {
      // kernel 3's boundary row: prefix sums from lane 0, LOG_ZERO insert
      // scores past ly
      float* ti = row_tmp + (size_t)b * 2 * By;
      row_cumsum2(
          By, iy0_b, jy0_b, ti, ti + By,
          [&](int v) {
            const float ins =
                v < ly ? src.insy(ly - 1 - v, src.tag(ly - 1 - v)) : LOG_ZERO;
            return make_float2(__fadd_rn(ins, tII), __fadd_rn(ins, tJJ));
          },
          [&](int, float si, float sj) {
            return make_float2(__fadd_rn(tSI, si), __fadd_rn(tSJ, sj));
          });
    } else if (!has_left) {
      float* ti = row_tmp + (size_t)b * 2 * By;
      row_cumsum2(
          By, iy0_b, jy0_b, ti, ti + By,
          [&](int q) {
            if (q < q0) return make_float2(0.0f, 0.0f);
            const float ins = src.insy(By - 1 - q, src.tag(By - 1 - q));
            return make_float2(__fadd_rn(ins, tII), __fadd_rn(ins, tJJ));
          },
          [&](int q, float si, float sj) {
            return q < q0 ? make_float2(tSI, tSJ)
                          : make_float2(__fadd_rn(tSI, si),
                                        __fadd_rn(tSJ, sj));
          });
    } else if (usteps > u0) {
      if (g == 0) win.refill(u0, usteps, l);
      __syncthreads();
    }
  }

  const int q = seg0 * 64 + g * 64 + 2 * l;  // flipped lanes q, q + 1
  // ... which are forward lanes By-1-q, By-2-q: one float2 at By-2-q
  // (kLegacy: lanes q, q + 1 of RB_M, columns ly-1-q, ly-2-q)
  const int fcol = By - 2 - q;
  const int ocol = kLegacy ? q : fcol;
  // rows past lx of the posterior (of RB_M) are zero
  for (int r = lx; r < Lx; ++r)
    *reinterpret_cast<float2*>(post_b + (size_t)r * By + ocol) =
        make_float2(0.f, 0.f);

  int yc[2];
  bool pad[2];
  float insy[2], m[2], ix[2], iy[2], jx[2], jy[2], mea[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int gq = q + e;
    const int col = kLegacy ? ly - 1 - gq : By - 1 - gq;
    pad[e] = kLegacy ? gq >= ly : gq < q0;
    yc[e] = kLegacy && pad[e] ? 0 : src.tag(col);
    insy[e] = pad[e] ? LOG_ZERO : src.insy(col, yc[e]);
    iy[e] = __ldcg(iy0_b + gq);
    jy[e] = __ldcg(jy0_b + gq);
    mea[e] = 0.0f;
  }
  if (l == 31) {
    s_edge_iy[g] = iy[1];
    s_edge_jy[g] = jy[1];
    s_edge_mea[g] = 0.0f;
  }
  __syncthreads();
  // boundary row B(lx, .): M from the IY/JY row shifted one lane; left of
  // the group, lane q - 1 of the boundary row (the column-0 chains' start
  // at flipped lane 0)
  {
    const float fiy = has_left ? __ldcg(iy0_b + q - 1) : tSI;
    const float fjy = has_left ? __ldcg(jy0_b + q - 1) : tSJ;
    const float shi[2] = {left_of_even(iy[1], fiy, s_edge_iy, g, l), iy[0]};
    const float shj[2] = {left_of_even(jy[1], fjy, s_edge_jy, g, l), jy[0]};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mr =
          log_add<kBF>(__fadd_rn(__fadd_rn(tMI, shi[e]), insy[e]),
                       __fadd_rn(__fadd_rn(tMJ, shj[e]), insy[e]));
      // kernel B's padding lanes carry the column boundary chains
      const bool chain = !kLegacy && pad[e];
      m[e] = chain ? tSM : mr;
      ix[e] = chain ? tSI : LOG_ZERO;
      jx[e] = chain ? tSJ : LOG_ZERO;
    }
    if (l == 31) s_edge_m[g] = m[1];
  }
  float ix0 = tSI, jx0 = tSJ, m0 = tSM;  // column-0 chains (group 0)
  const bool owner = g == G - 1 && l == 31;  // holds the group's last lane
  // the left group's last-lane M and MEA at the step before (warp 0)
  float h_m_prev = LOG_ZERO, h_mea_prev = 0.0f;
  __syncthreads();

  for (int u = u0; u < usteps; ++u) {
    // the left group's record of step u (warp 0 only)
    float h_m = LOG_ZERO, h_iy = LOG_ZERO, h_jy = LOG_ZERO, h_mea = NEG_BIG;
    float h_ci = NEG_BIG, h_cj = NEG_BIG;
    if (has_left && g == 0) {
      if (u >= win.ready) win.refill(u, usteps, l);
      const int s = u - win.base;
      h_m = wf::field(win.rec.v0, 0, s);
      h_iy = wf::field(win.rec.v0, 1, s);
      h_jy = wf::field(win.rec.v0, 2, s);
      h_mea = wf::field(win.rec.v0, 3, s);
      h_ci = wf::field(win.rec.v1, 0, s);
      h_cj = wf::field(win.rec.v1, 1, s);
    }
    float car_i = NEG_BIG, car_j = NEG_BIG;  // leaving carries (owner)
    if (u > u0) {
      src.row(uend - u);
      const float insx = src.insx;
      const float fmv = has_left ? h_m_prev : m0;
      float nm[2], nix[2], njx[2], aI[2], cI[2], aJ[2], cJ[2];
      // (1) next-row terms, IX/JX, IY/JY segment scans
      {
        const float shm[2] = {left_of_even(m[1], fmv, s_edge_m, g, l), m[0]};
        // lanes q, q+1 are columns By-1-q, By-2-q (kLegacy: ly-1-q,
        // ly-2-q, read one at a time: ly is any length)
        float emit[2];
        if (kLegacy) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            emit[e] = pad[e] ? LOG_ZERO : src.emit1(ly - 1 - q - e, yc[e]);
        } else {
          const float2 ev = src.emit2(fcol, yc[1], yc[0]);
          emit[0] = ev.y;
          emit[1] = ev.x;
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float er = pad[e] ? LOG_ZERO : emit[e];
          nm[e] = __fadd_rn(shm[e], er);
          nix[e] = __fadd_rn(ix[e], insx);
          njx[e] = __fadd_rn(jx[e], insx);
          ix[e] = log_add<kBF>(__fadd_rn(tII, nix[e]), __fadd_rn(tIM, nm[e]));
          jx[e] = log_add<kBF>(__fadd_rn(tJJ, njx[e]), __fadd_rn(tJM, nm[e]));
          aI[e] = __fadd_rn(insy[e], tII);
          cI[e] = __fadd_rn(tIM, nm[e]);
          aJ[e] = __fadd_rn(insy[e], tJJ);
          cJ[e] = __fadd_rn(tJM, nm[e]);
        }
        if (has_left && left_edge && g == 0 && l == 0) {
          cI[0] = log_add<kBF>(__fadd_rn(h_iy, aI[0]), cI[0]);
          cJ[0] = log_add<kBF>(__fadd_rn(h_jy, aJ[0]), cJ[0]);
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
      const float ix0n = __fadd_rn(__fadd_rn(tII, ix0), insx);
      const float jx0n = __fadd_rn(__fadd_rn(tJJ, jx0), insx);
      const float m0n = log_add<kBF>(__fadd_rn(__fadd_rn(tMI, ix0), insx),
                                     __fadd_rn(__fadd_rn(tMJ, jx0), insx));
      __syncthreads();
      // (2) carry over the group's segments, from the left group's carry
      // inside a stripe (NEG_BIG at a stripe's segment 0); one step more
      // for the right neighbour inside the stripe
      if (threadIdx.x < 2) {
        const int tt = threadIdx.x;
        const float* ta = s_tot + 2 * tt * G;
        const float* tc = ta + G;
        float* car = s_carry + tt * (G + 1);
        float cc = has_left && !left_edge ? (tt == 0 ? h_ci : h_cj) : NEG_BIG;
        car[0] = cc;
        const int steps = chain_out ? G : G - 1;
        for (int s = 0; s < steps; ++s) {
          cc = log_add_p<kBF>(__fadd_rn(cc, ta[s]), tc[s]);
          car[s + 1] = cc;
        }
      }
      __syncthreads();
      // (3) IY/JY rows
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        iy[e] = log_add_p<kBF>(__fadd_rn(s_carry[g], aI[e]), cI[e]);
        jy[e] = log_add_p<kBF>(__fadd_rn(s_carry[G + 1 + g], aJ[e]), cJ[e]);
      }
      if (l == 31) {
        s_edge_iy[g] = iy[1];
        s_edge_jy[g] = jy[1];
      }
      if (owner && chain_out) {
        car_i = s_carry[G];
        car_j = s_carry[2 * G + 1];
      }
      __syncthreads();
      // (4) M row
      {
        const float fy = has_left ? h_iy : LOG_ZERO;
        const float fj = has_left ? h_jy : LOG_ZERO;
        const float shi[2] = {left_of_even(iy[1], fy, s_edge_iy, g, l),
                              iy[0]};
        const float shj[2] = {left_of_even(jy[1], fj, s_edge_jy, g, l),
                              jy[0]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float niy = __fadd_rn(shi[e], insy[e]);
          const float njy = __fadd_rn(shj[e], insy[e]);
          m[e] = log_add5<kBF>(__fadd_rn(tMM, nm[e]), __fadd_rn(tMI, nix[e]),
                               __fadd_rn(tMJ, njx[e]), __fadd_rn(tMI, niy),
                               __fadd_rn(tMJ, njy));
        }
        if (l == 31) s_edge_m[g] = m[1];
      }
      ix0 = ix0n;
      jx0 = jx0n;
      m0 = m0n;
      __syncthreads();
    }

    if constexpr (kLegacy) {
      // (5) row u of RB_M: the M row shifted one lane, the left group's
      // last lane (group 0: the column-0 chain) in lane 0
      const float lo = left_of_even(m[1], has_left ? h_m : m0, s_edge_m, g, l);
      if (!kCorner || u < uend)
        *reinterpret_cast<float2*>(post_b + (size_t)u * By + q) =
            make_float2(lo, m[0]);
      if (owner && has_right) {
        wf::stcg(out + u, wf::Rec8{make_float4(m[1], iy[1], jy[1], 0.f),
                                   make_float4(car_i, car_j, 0.f, 0.f)});
        wf::publish(progress, u, u0, usteps, R);
      }
      h_m_prev = h_m;
      continue;
    }
    // (5) posterior row Lx-1-u from the forward M there; MEA row
    const int pf = Lx - 1 - u;
    float p[2];
    {
      const float bfill = has_left ? h_m : m0;
      const float bn[2] = {left_of_even(m[1], bfill, s_edge_m, g, l), m[0]};
      const size_t off = (size_t)pf * By + fcol;
      const float2 f = *reinterpret_cast<const float2*>(fm_b + off);
      const float fv[2] = {f.y, f.x};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float score = __fsub_rn(__fadd_rn(fv[e], bn[e]), totb);
        p[e] = select_f(score >= MIN_SPARSE_SCORE && !pad[e],
                        expf(fminf(score, 0.0f)), 0.0f);
      }
      *reinterpret_cast<float2*>(post_b + off) = make_float2(p[1], p[0]);
      const float f_old = has_left && u > u0 ? h_mea_prev : 0.0f;
      const float osh = left_of_even(mea[1], f_old, s_edge_mea, g, l);
      float ev0 = fmaxf(fmaxf(__fadd_rn(osh, p[0]), mea[0]), 0.0f);
      float ev1 = fmaxf(fmaxf(__fadd_rn(mea[0], p[1]), mea[1]), 0.0f);
      // inclusive max-scan over the segment (max is exact in any order)
      ev1 = fmaxf(ev0, ev1);
      float run = ev1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float up = __shfl_up_sync(PH_FULL, run, d);
        if (l >= d) run = fmaxf(run, up);
      }
      const float before = __shfl_up_sync(PH_FULL, run, 1);
      if (l > 0) ev0 = fmaxf(ev0, before);
      mea[0] = ev0;
      mea[1] = run;
      if (l == 31) s_segmax[g] = run;
      if (threadIdx.x == 0) *s_mea_in = has_left ? h_mea : NEG_BIG;
    }
    __syncthreads();
    {
      float pre = *s_mea_in;  // the max-plus carry
      for (int h = 0; h < g; ++h) pre = fmaxf(pre, s_segmax[h]);
      mea[0] = fmaxf(mea[0], pre);
      mea[1] = fmaxf(mea[1], pre);
      if (l == 31) s_edge_mea[g] = mea[1];
    }
    if (owner && has_right) {
      wf::stcg(out + u, wf::Rec8{make_float4(m[1], iy[1], jy[1], mea[1]),
                                 make_float4(car_i, car_j, 0.f, 0.f)});
      wf::publish(progress, u, u0, Lx, R);
    }
    h_m_prev = h_m;
    h_mea_prev = h_mea;
  }
  if (!kLegacy && owner && !has_right) mea_out[b] = mea[1];
  if constexpr (kCorner) {
    // lane ly-1 of row lx: element (ly-1) & 1 of the thread at lanes
    // q, q + 1, chosen by a select
    const int c = ly - 1;
    if (q == (c & ~1)) {
      const bool hi = c & 1;
      float* o = corner + (size_t)b * 5;
      o[0] = hi ? m[1] : m[0];
      o[1] = hi ? ix[1] : ix[0];
      o[2] = hi ? iy[1] : iy[0];
      o[3] = hi ? jx[1] : jx[0];
      o[4] = hi ? jy[1] : jy[0];
    }
  }
}

// Shared memory of a backward wave block, bytes.
template <class Src>
inline size_t bwd_wave_smem(const typename Src::Args& args, int G) {
  return sizeof(float) * (size_t)(Src::table_floats(args) + 11 * G + 3);
}

// The launch limits of a wave pass: Wd a 64-multiple dividing By, G
// dividing the stripe's segments, at most 32 warps a group.
inline bool wave_ok(int B, int By, int Wd, int G, int R) {
  return Wd % 64 == 0 && Wd >= 64 && By % Wd == 0 && G >= 1 && G <= 32 &&
         (Wd / 64) % G == 0 && R >= 1 && B >= 1;
}

// Kernels A and B (and their per-pair-table forms 1M, 2M) on the wide
// schedule: one stripe of the whole row (Wd = Ly), row 0 and the
// boundary row computed in the launch. row0 (4 B Ly floats): the rows
// [IY (B, Ly) | JY (B, Ly) | the rounds' second buffers (B, 2, Ly)].
template <class Src>
inline int launch_fwd_wave(int B, cudaStream_t st,
                           const typename Src::Args& args, const int* lxb,
                           const int* lyb, const float* params, int pstride,
                           int Lx, int Ly, int G, int R, long long wait_ns,
                           int* sync, int* fault, float* hand, float* row0,
                           float* fm, float* fend) {
  if (!wave_ok(B, Ly, Ly, G, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_wave_smem<Src>(args, G);
  const cudaError_t e = allow_smem(pairhmm_fwd_wave_kernel<Src, true>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t n = (size_t)B * Ly;
  pairhmm_fwd_wave_kernel<Src, true><<<B * (Ly / (64 * G)), G * 32, smem, st>>>(
      args, lxb, lyb, params, pstride, row0, row0 + n, row0 + 2 * n, B, Lx,
      Ly, Ly, G, R, wait_ns, sync, fault, reinterpret_cast<wf::Rec4*>(hand),
      fend, fm);
  return static_cast<int>(cudaGetLastError());
}

template <class Src>
inline int launch_bwd_wave(int B, cudaStream_t st,
                           const typename Src::Args& args, const int* lxb,
                           const int* lyb, const float* params, int pstride,
                           const float* tot, int Lx, int Ly, int G, int R,
                           long long wait_ns, int* sync, int* fault,
                           float* hand, float* row0, const float* fm,
                           float* post, float* mea) {
  if (!wave_ok(B, Ly, Ly, G, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_wave_smem<Src>(args, G);
  const cudaError_t e = allow_smem(pairhmm_bwd_wave_kernel<Src, true>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t n = (size_t)B * Ly;
  pairhmm_bwd_wave_kernel<Src, true><<<B * (Ly / (64 * G)), G * 32, smem, st>>>(
      args, lxb, lyb, params, pstride, tot, row0, row0 + n, row0 + 2 * n, B,
      Lx, Ly, Ly, G, R, wait_ns, sync, fault,
      reinterpret_cast<wf::Rec8*>(hand), fm, post, mea, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// Kernel 3 on the wide schedule: one stripe of the whole row, the
// boundary row computed in the launch (row0 as for kernel B), RB_M
// written to rbm (B, Lx, Ly); with kCorner (kernel 3K) also the far
// corner's states to corner (B, 5).
template <class Src, bool kCorner = false>
inline int launch_bwd_legacy_wave(int B, cudaStream_t st,
                                  const typename Src::Args& args,
                                  const int* lxb, const int* lyb,
                                  const float* params, int pstride, int Lx,
                                  int Ly, int G, int R, long long wait_ns,
                                  int* sync, int* fault, float* hand,
                                  float* row0, float* rbm,
                                  float* corner = nullptr) {
  if (!wave_ok(B, Ly, Ly, G, R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bwd_wave_smem<Src>(args, G);
  const cudaError_t e =
      allow_smem(pairhmm_bwd_wave_kernel<Src, true, true, kCorner>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t n = (size_t)B * Ly;
  pairhmm_bwd_wave_kernel<Src, true, true, kCorner>
      <<<B * (Ly / (64 * G)), G * 32, smem, st>>>(
          args, lxb, lyb, params, pstride, nullptr, row0, row0 + n,
          row0 + 2 * n, B, Lx, Ly, Ly, G, R, wait_ns, sync, fault,
          reinterpret_cast<wf::Rec8*>(hand), nullptr, rbm, nullptr, corner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ph
