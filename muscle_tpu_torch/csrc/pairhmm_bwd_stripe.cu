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
#include "pairhmm_common.cuh"
#include "stripe_wavefront.cuh"

using namespace ph;

namespace {
// LOG_ADDs as selects, not branches (pairhmm_common.cuh select_f): the
// same bits, and a thread's independent LOG_ADDs interleave
constexpr bool kBF = true;
}  // namespace
__global__ void __launch_bounds__(1024)
pairhmm_bwd_stripe_kernel(const int* __restrict__ xb,
                          const int* __restrict__ yb,
                          const int* __restrict__ lxb,
                          const int* __restrict__ lyb,
                          const float* __restrict__ match,
                          const float* __restrict__ insert,
                          const float* __restrict__ params,
                          const float* __restrict__ tot,
                          const float* __restrict__ iy0b,
                          const float* __restrict__ jy0b, int B, int Lx,
                          int By, int Wd, int G, int kk, int R,
                          long long wait_ns, int* __restrict__ sync,
                          int* __restrict__ fault,
                          wf::Rec8* __restrict__ hand,
                          float* __restrict__ fm_post,
                          float* __restrict__ mea_out) {
  extern __shared__ float smem[];
  float* s_match = smem;
  float* s_ins = s_match + kk * kk;
  float* s_edge_m = s_ins + kk;        // M state edge (G)
  float* s_edge_iy = s_edge_m + G;     // IY edge
  float* s_edge_jy = s_edge_iy + G;    // JY edge
  float* s_edge_mea = s_edge_jy + G;
  float* s_segmax = s_edge_mea + G;
  float* s_tot = s_segmax + G;         // 4 * G
  float* s_carry = s_tot + 4 * G;      // 2 * (G + 1)
  float* s_mea_in = s_carry + 2 * (G + 1);  // the left group's MEA

  const int g = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int k = threadIdx.x; k < kk * kk; k += blockDim.x) s_match[k] = match[k];
  for (int k = threadIdx.x; k < kk; k += blockDim.x) s_ins[k] = insert[k];
  const int t = wf::take_ticket(sync);  // (its barrier covers the tables)
  const int groups = By / (64 * G);
  const int gi = t / B, b = t % B;
  const int nseg_w = Wd >> 6;
  const int seg0 = gi * G;                      // first flipped segment
  const bool has_left = gi > 0;                 // else reversed stripe 0
  const bool left_edge = seg0 % nseg_w == 0;
  const bool has_right = gi + 1 < groups;
  const bool right_edge = (seg0 + G) % nseg_w == 0;
  const bool chain_out = has_right && !right_edge;
  const float tSM = params[TSM], tSI = params[TSI], tSJ = params[TSJ];
  const float tMM = params[TMM], tMI = params[TMI], tMJ = params[TMJ];
  const float tII = params[TII], tIM = params[TIM], tJJ = params[TJJ];
  const float tJM = params[TJM];
  const float totb = tot[b];
  const int lx = lxb[b], ly = lyb[b];
  const int q0 = By - ly;   // flipped lanes below q0 are padding
  const int* xrow = xb + (size_t)b * Lx;
  const int* yrow = yb + (size_t)b * By;
  float* fp_b = fm_post + (size_t)b * Lx * By;
  int* progress = sync + wf::PROGRESS + b * groups + gi;
  wf::Rec8* out = hand + ((size_t)b * groups + gi) * Lx;
  const int u0 = Lx - lx;
  wf::Window<wf::Rec8> win(has_left ? progress - 1 : progress,
                           has_left ? out - Lx : out, fault,
                           wait_ns, u0);

  const int q = seg0 * 64 + g * 64 + 2 * l;  // flipped lanes q, q + 1
  // ... which are forward lanes By-1-q, By-2-q: one float2 at By-2-q
  const int fcol = By - 2 - q;
  // rows past lx of the posterior are zero
  for (int r = lx; r < Lx; ++r)
    *reinterpret_cast<float2*>(fp_b + (size_t)r * By + fcol) =
        make_float2(0.f, 0.f);

  int yc[2];
  bool pad[2];
  float insy[2], m[2], ix[2], iy[2], jx[2], jy[2], mea[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int gq = q + e;
    yc[e] = yrow[By - 1 - gq];
    pad[e] = gq < q0;
    insy[e] = pad[e] ? LOG_ZERO : s_ins[yc[e]];
    iy[e] = iy0b[(size_t)b * By + gq];
    jy[e] = jy0b[(size_t)b * By + gq];
    mea[e] = 0.0f;
  }
  if (l == 31) {
    s_edge_iy[g] = iy[1];
    s_edge_jy[g] = jy[1];
    s_edge_mea[g] = 0.0f;
  }
  __syncthreads();
  // boundary row B(lx, .): M from the IY/JY row shifted one lane; left of
  // the group, the global closed forms' lane q - 1 (the column-0 chains'
  // start at flipped lane 0)
  {
    const float fiy = has_left ? iy0b[(size_t)b * By + q - 1] : tSI;
    const float fjy = has_left ? jy0b[(size_t)b * By + q - 1] : tSJ;
    const float shi[2] = {left_of_even(iy[1], fiy, s_edge_iy, g, l), iy[0]};
    const float shj[2] = {left_of_even(jy[1], fjy, s_edge_jy, g, l), jy[0]};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mr =
          log_add<kBF>(__fadd_rn(__fadd_rn(tMI, shi[e]), insy[e]),
                       __fadd_rn(__fadd_rn(tMJ, shj[e]), insy[e]));
      m[e] = pad[e] ? tSM : mr;
      ix[e] = pad[e] ? tSI : LOG_ZERO;
      jx[e] = pad[e] ? tSJ : LOG_ZERO;
    }
    if (l == 31) s_edge_m[g] = m[1];
  }
  float ix0 = tSI, jx0 = tSJ, m0 = tSM;  // column-0 chains (group 0)
  const bool owner = g == G - 1 && l == 31;  // holds the group's last lane
  // the left group's last-lane M and MEA at the step before (warp 0)
  float h_m_prev = LOG_ZERO, h_mea_prev = 0.0f;
  __syncthreads();

  for (int u = u0; u < Lx; ++u) {
    // the left group's record of step u (warp 0 only)
    float h_m = LOG_ZERO, h_iy = LOG_ZERO, h_jy = LOG_ZERO, h_mea = NEG_BIG;
    float h_ci = NEG_BIG, h_cj = NEG_BIG;
    if (has_left && g == 0) {
      if (u >= win.ready) win.refill(u, Lx, l);
      const int src = u - win.base;
      h_m = wf::field(win.rec.v0, 0, src);
      h_iy = wf::field(win.rec.v0, 1, src);
      h_jy = wf::field(win.rec.v0, 2, src);
      h_mea = wf::field(win.rec.v0, 3, src);
      h_ci = wf::field(win.rec.v1, 0, src);
      h_cj = wf::field(win.rec.v1, 1, src);
    }
    float car_i = NEG_BIG, car_j = NEG_BIG;  // leaving carries (owner)
    if (u > u0) {
      const int xc = xrow[Lx - u];
      const float insx = s_ins[xc];
      const float* mrow = s_match + xc * kk;
      const float fmv = has_left ? h_m_prev : m0;
      float nm[2], nix[2], njx[2], aI[2], cI[2], aJ[2], cJ[2];
      // (1) next-row terms, IX/JX, IY/JY segment scans
      {
        const float shm[2] = {left_of_even(m[1], fmv, s_edge_m, g, l), m[0]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float er = pad[e] ? LOG_ZERO : mrow[yc[e]];
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

    // (5) posterior row Lx-1-u, in place over the forward M; MEA row
    const int pf = Lx - 1 - u;
    float p[2];
    {
      const float bfill = has_left ? h_m : m0;
      const float bn[2] = {left_of_even(m[1], bfill, s_edge_m, g, l), m[0]};
      float2* cell = reinterpret_cast<float2*>(fp_b + (size_t)pf * By + fcol);
      const float2 f = *cell;
      const float fv[2] = {f.y, f.x};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float score = __fsub_rn(__fadd_rn(fv[e], bn[e]), totb);
        p[e] = select_f(score >= MIN_SPARSE_SCORE && !pad[e],
                        expf(fminf(score, 0.0f)), 0.0f);
      }
      *cell = make_float2(p[1], p[0]);
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
  if (owner && !has_right) mea_out[b] = mea[1];
}

extern "C" int pairhmm_bwd_stripe(const int* xb, const int* yb,
                                  const int* lxb, const int* lyb,
                                  const float* match, const float* insert,
                                  const float* params, const float* tot,
                                  const float* iy0b, const float* jy0b, int B,
                                  int Lx, int By, int Wd, int G, int kk, int R,
                                  long long wait_ns, int* sync, int* fault,
                                  float* hand,
                                  float* fm_post, float* mea, void* stream) {
  if (Wd % 64 != 0 || Wd < 64 || Wd > 2048 || By % Wd != 0 || G < 1 ||
      G > 32 || 32 % G != 0 || (Wd / 64) % G != 0 || R < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = By / (64 * G);
  const size_t smem = sizeof(float) * (size_t)(kk * kk + kk + 11 * G + 3);
  pairhmm_bwd_stripe_kernel<<<B * groups, G * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      xb, yb, lxb, lyb, match, insert, params, tot, iy0b, jy0b, B, Lx, By, Wd,
      G, kk, R, wait_ns, sync, fault, reinterpret_cast<wf::Rec8*>(hand),
      fm_post, mea);
  return static_cast<int>(cudaGetLastError());
}
