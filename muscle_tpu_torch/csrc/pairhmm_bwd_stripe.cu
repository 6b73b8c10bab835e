// Kernel 6: pair-HMM backward pass fused with the posterior combine and
// the MEA row, on one reversed stripe of W lanes, one thread block per
// pair.
//
// Replaces muscle_tpu/ops/pairhmm_striped.py::_bwd_stripe_kernel
// (launched by _bwd_stripe_call, once per stripe). reference:
// src/bwdflat3.cpp:10-190, src/calcposteriorflat.cpp:4-27,
// src/calcalnscoreflat.cpp:4-32.
//
// Kernel B's recurrence (pairhmm_bwd_post.cu) restricted to the flipped
// lanes sp*W .. sp*W+W-1, which are forward stripe S-1-sp read right to
// left (W divides By). Flipped lanes below By-ly are padding and carry
// the column boundary chains, as in kernel B, with the padding mask
// taken over the whole row. What crosses the stripe's left edge comes
// from the previous reversed stripe's boundary column bnd_in (B, Lx, 8),
// rows [M, IX, IY, JX, JY, MEA, ...] by step u:
//   - the M shift-in of step u takes its M at step u-1, and the
//     posterior's one-lane shift its M at step u;
//   - the IY/JY scans take its step-u values as carries injected into
//     lane 0, u_0 = LOG_ADD(carry + a_0, c_0), and as the fill of their
//     shift into M;
//   - the MEA row's shift takes its MEA at step u-1, and the new row is
//     raised to its MEA at step u (the max-plus carry).
// Reversed stripe 0 runs the column-0 chains instead. The boundary row
// B(lx, .) comes from the global closed forms iy0b/jy0b. Step u <= u0 =
// Lx-lx keeps the boundary state in the Pallas kernel; the block starts
// at u0, writes the posterior rows past lx as zeros and the boundary
// column of steps below u0 as the boundary state, MEA 0. Each step
// combines the backward M row with forward row Lx-1-u of stripe S-1-sp
// (fm) into the posterior, in forward lanes, and updates the MEA row.
//
// Geometry: one 64-lane segment per warp, kernel B's scan, LOG_ADD
// variants and arithmetic unchanged, so kernel and plain twin agree bit
// for bit.
//
// What bounds it on the H100: for the function, bytes (the M stripe read
// and the posterior stripe written, 8 bytes a cell, against ~146 f32
// operations a real cell). The kernel is latency-bound instead, like
// kernel 5: a serial row chain with five block barriers per step, B
// blocks on the card's 132 SMs, stripes one after another. The design
// keeps state, MEA row and scan in registers and warp shuffles and reads
// the M stripe and writes the posterior once each, coalesced.
#include "pairhmm_common.cuh"

using namespace ph;

namespace {
constexpr int BND = 8;
enum { B_M, B_IX, B_IY, B_JX, B_JY, B_MEA };
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
                          const float* __restrict__ jy0b,
                          const float* __restrict__ bnd_in,
                          const float* __restrict__ fm, int Lx, int By,
                          int sp, int Wd, int kk, float* __restrict__ post,
                          float* __restrict__ bnd_out,
                          float* __restrict__ mea_out) {
  extern __shared__ float smem[];
  const int nseg = Wd >> 6;
  float* s_match = smem;
  float* s_ins = s_match + kk * kk;
  float* s_edge_m = s_ins + kk;        // M state edge (nseg)
  float* s_edge_iy = s_edge_m + nseg;  // IY edge
  float* s_edge_jy = s_edge_iy + nseg; // JY edge
  float* s_edge_mea = s_edge_jy + nseg;
  float* s_segmax = s_edge_mea + nseg;
  float* s_tot = s_segmax + nseg;      // 4 * nseg
  float* s_carry = s_tot + 4 * nseg;   // 2 * nseg

  const int b = blockIdx.x;
  const int g = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int k = threadIdx.x; k < kk * kk; k += blockDim.x) s_match[k] = match[k];
  for (int k = threadIdx.x; k < kk; k += blockDim.x) s_ins[k] = insert[k];
  const float tSM = params[TSM], tSI = params[TSI], tSJ = params[TSJ];
  const float tMM = params[TMM], tMI = params[TMI], tMJ = params[TMJ];
  const float tII = params[TII], tIM = params[TIM], tJJ = params[TJJ];
  const float tJM = params[TJM];
  const bool first = sp == 0;
  const float totb = tot[b];
  const int lx = lxb[b], ly = lyb[b];
  const int q0 = By - ly;   // flipped lanes below q0 are padding
  const int g0 = sp * Wd;   // first flipped lane of this stripe
  const int* xrow = xb + (size_t)b * Lx;
  const int* yrow = yb + (size_t)b * By;
  const float* fm_b = fm + (size_t)b * Lx * Wd;
  float* post_b = post + (size_t)b * Lx * Wd;
  const float* bin = first ? nullptr : bnd_in + (size_t)b * Lx * BND;
  float* bout = bnd_out + (size_t)b * Lx * BND;
  __syncthreads();

  // rows i > lx of the posterior stripe are zero
  for (size_t k = (size_t)lx * Wd + 4 * threadIdx.x; k < (size_t)Lx * Wd;
       k += 4 * blockDim.x)
    *reinterpret_cast<float4*>(post_b + k) = make_float4(0.f, 0.f, 0.f, 0.f);

  const int q = g * 64 + 2 * l;  // this thread's local lanes q, q + 1
  int yc[2];
  bool pad[2];
  float insy[2], m[2], ix[2], iy[2], jx[2], jy[2], mea[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int gq = g0 + q + e;
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
  // boundary row B(lx, .): M from the IY/JY row shifted one lane, the
  // previous stripe's last lane from the global closed forms
  {
    const float fiy = first ? tSI : iy0b[(size_t)b * By + g0 - 1];
    const float fjy = first ? tSJ : jy0b[(size_t)b * By + g0 - 1];
    const float shi[2] = {left_of_even(iy[1], fiy, s_edge_iy, g, l), iy[0]};
    const float shj[2] = {left_of_even(jy[1], fjy, s_edge_jy, g, l), jy[0]};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float mr = log_add(__fadd_rn(__fadd_rn(tMI, shi[e]), insy[e]),
                               __fadd_rn(__fadd_rn(tMJ, shj[e]), insy[e]));
      m[e] = pad[e] ? tSM : mr;
      ix[e] = pad[e] ? tSI : LOG_ZERO;
      jx[e] = pad[e] ? tSJ : LOG_ZERO;
    }
    if (l == 31) s_edge_m[g] = m[1];
  }
  float ix0 = tSI, jx0 = tSJ, m0 = tSM;  // column-0 chains (stripe 0)
  const bool owner = g == nseg - 1 && l == 31;  // holds lane W-1
  const int u0 = Lx - lx;
  if (owner) {
    for (int u = 0; u < u0; ++u) {
      float* o = bout + (size_t)u * BND;
      o[B_M] = m[1];
      o[B_IX] = ix[1];
      o[B_IY] = iy[1];
      o[B_JX] = jx[1];
      o[B_JY] = jy[1];
      o[B_MEA] = 0.0f;
      o[6] = o[7] = 0.0f;
    }
  }
  __syncthreads();

  for (int u = u0; u < Lx; ++u) {
    // the previous stripe's last column at this step
    const float* c = first ? nullptr : bin + (size_t)u * BND;
    if (u > u0) {
      const int xc = xrow[Lx - u];
      const float insx = s_ins[xc];
      const float* mrow = s_match + xc * kk;
      const float fmv = first ? m0 : bin[(size_t)(u - 1) * BND + B_M];
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
          ix[e] = log_add(__fadd_rn(tII, nix[e]), __fadd_rn(tIM, nm[e]));
          jx[e] = log_add(__fadd_rn(tJJ, njx[e]), __fadd_rn(tJM, nm[e]));
          aI[e] = __fadd_rn(insy[e], tII);
          cI[e] = __fadd_rn(tIM, nm[e]);
          aJ[e] = __fadd_rn(insy[e], tJJ);
          cJ[e] = __fadd_rn(tJM, nm[e]);
        }
        if (!first && g == 0 && l == 0) {
          cI[0] = log_add(__fadd_rn(c[B_IY], aI[0]), cI[0]);
          cJ[0] = log_add(__fadd_rn(c[B_JY], aJ[0]), cJ[0]);
        }
        seg_scan(aI, cI, l);
        seg_scan(aJ, cJ, l);
        if (l == 31) {
          s_tot[g] = aI[1];
          s_tot[nseg + g] = cI[1];
          s_tot[2 * nseg + g] = aJ[1];
          s_tot[3 * nseg + g] = cJ[1];
        }
      }
      const float ix0n = __fadd_rn(__fadd_rn(tII, ix0), insx);
      const float jx0n = __fadd_rn(__fadd_rn(tJJ, jx0), insx);
      const float m0n = log_add(__fadd_rn(__fadd_rn(tMI, ix0), insx),
                                __fadd_rn(__fadd_rn(tMJ, jx0), insx));
      __syncthreads();
      // (2) carry over the segments
      carry_chain(s_tot, s_carry, nseg);
      __syncthreads();
      // (3) IY/JY rows
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        iy[e] = log_add_p(__fadd_rn(s_carry[g], aI[e]), cI[e]);
        jy[e] = log_add_p(__fadd_rn(s_carry[nseg + g], aJ[e]), cJ[e]);
      }
      if (l == 31) {
        s_edge_iy[g] = iy[1];
        s_edge_jy[g] = jy[1];
      }
      __syncthreads();
      // (4) M row
      {
        const float fy = first ? LOG_ZERO : c[B_IY];
        const float fj = first ? LOG_ZERO : c[B_JY];
        const float shi[2] = {left_of_even(iy[1], fy, s_edge_iy, g, l),
                              iy[0]};
        const float shj[2] = {left_of_even(jy[1], fj, s_edge_jy, g, l),
                              jy[0]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float niy = __fadd_rn(shi[e], insy[e]);
          const float njy = __fadd_rn(shj[e], insy[e]);
          m[e] = log_add5(__fadd_rn(tMM, nm[e]), __fadd_rn(tMI, nix[e]),
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

    // (5) posterior row Lx-1-u of the stripe; MEA running row
    const int pf = Lx - 1 - u;
    float p[2];
    {
      const float bfill = first ? m0 : c[B_M];
      const float bn[2] = {left_of_even(m[1], bfill, s_edge_m, g, l), m[0]};
      // lanes q, q+1 are the stripe's forward lanes W-1-q, W-2-q
      const size_t off = (size_t)pf * Wd + (Wd - 2 - q);
      const float2 f = *reinterpret_cast<const float2*>(fm_b + off);
      const float fv[2] = {f.y, f.x};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float score = __fsub_rn(__fadd_rn(fv[e], bn[e]), totb);
        p[e] = (score >= MIN_SPARSE_SCORE && !pad[e])
                   ? expf(fminf(score, 0.0f)) : 0.0f;
      }
      *reinterpret_cast<float2*>(post_b + off) = make_float2(p[1], p[0]);
      const float f_old =
          (first || u == 0) ? 0.0f : bin[(size_t)(u - 1) * BND + B_MEA];
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
    }
    __syncthreads();
    {
      float pre = first ? NEG_BIG : c[B_MEA];  // the max-plus carry
      for (int h = 0; h < g; ++h) pre = fmaxf(pre, s_segmax[h]);
      mea[0] = fmaxf(mea[0], pre);
      mea[1] = fmaxf(mea[1], pre);
      if (l == 31) s_edge_mea[g] = mea[1];
    }
    if (owner) {
      float* o = bout + (size_t)u * BND;
      o[B_M] = m[1];
      o[B_IX] = ix[1];
      o[B_IY] = iy[1];
      o[B_JX] = jx[1];
      o[B_JY] = jy[1];
      o[B_MEA] = mea[1];
      o[6] = o[7] = 0.0f;
    }
  }
  if (owner) mea_out[b] = mea[1];
}

extern "C" int pairhmm_bwd_stripe(const int* xb, const int* yb,
                                  const int* lxb, const int* lyb,
                                  const float* match, const float* insert,
                                  const float* params, const float* tot,
                                  const float* iy0b, const float* jy0b,
                                  const float* bnd_in, const float* fm, int B,
                                  int Lx, int By, int sp, int Wd, int kk,
                                  float* post, float* bnd_out, float* mea,
                                  void* stream) {
  if (Wd % 64 != 0 || Wd < 64 || Wd > 2048 || By % Wd != 0 ||
      (sp > 0) != (bnd_in != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = Wd / 64;
  const size_t smem = sizeof(float) * (size_t)(kk * kk + kk + 11 * nseg);
  pairhmm_bwd_stripe_kernel<<<B, nseg * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      xb, yb, lxb, lyb, match, insert, params, tot, iy0b, jy0b, bnd_in, fm,
      Lx, By, sp, Wd, kk, post, bnd_out, mea);
  return static_cast<int>(cudaGetLastError());
}
