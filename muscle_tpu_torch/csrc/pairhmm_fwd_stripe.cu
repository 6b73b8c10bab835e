// Kernel 5: pair-HMM forward pass on one stripe of W lanes of the Y
// axis, one thread block per pair.
//
// Replaces muscle_tpu/ops/pairhmm_striped.py::_fwd_stripe_kernel
// (launched by _fwd_stripe_call, once per stripe). reference:
// src/fwdflat3.cpp:12-153.
//
// Kernel A's recurrence (pairhmm_fwd.cu) restricted to lanes s*W ..
// s*W+W-1, with what crosses the stripe's left edge read from the
// previous stripe's boundary column, bnd_in (B, Lx, 8) rows [M, IX, IY,
// JX, JY, ...], row i holding DP row i+1 at that stripe's last lane:
//   - the one-lane shift into M folds the five states of the previous
//     stripe's last column at DP row i (DP row 0 from the global closed
//     forms iy0/jy0 when i = 0);
//   - the within-row IY/JY scan takes that column's new row as a carry
//     injected into lane 0, u_0 = LOG_ADD(carry + a_0, c_0), and the M
//     shift of its c operand takes that column's new M.
// Stripe 0 runs the column-0 chains instead. The kernel writes its own
// last column into bnd_out, the final states fend (B, 5) where it holds
// column ly, and its M rows fm (B, Lx, W), which the backward stripe
// reads. Rows past lx are not written (the wrapper zeroes them; nothing
// reads them).
//
// Geometry: W = 64 * nseg lanes, one 64-lane segment per warp (W = 2048:
// 32 warps), the segmented scan, LOG_ADD variants and arithmetic of
// kernel A unchanged, so kernel and plain twin agree bit for bit.
//
// What bounds it on the H100: for the function, operations (~130 f32
// operations per real cell against 4 bytes written per M cell). The
// kernel is latency-bound instead: each DP row is a serial chain with
// four block barriers, and
// the stripes of a pair run one after another, so a batch of B pairs
// keeps B of the 132 SMs busy (B <= 8 on the long-pair path). The design
// keeps the five state rows in registers, the tables in shared memory,
// and reads the boundary column once per row from device memory.
#include "pairhmm_common.cuh"

using namespace ph;

namespace {
constexpr int BND = 8;
enum { B_M, B_IX, B_IY, B_JX, B_JY };
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
                          const float* __restrict__ jy0,
                          const float* __restrict__ bnd_in, int Lx, int By,
                          int s, int Wd, int kk, float* __restrict__ bnd_out,
                          float* __restrict__ fend, float* __restrict__ fm) {
  extern __shared__ float smem[];
  const int nseg = Wd >> 6;
  float* s_match = smem;
  float* s_ins = s_match + kk * kk;
  float* s_edge_c = s_ins + kk;       // comb edge (nseg)
  float* s_edge_m = s_edge_c + nseg;  // m_new edge (nseg)
  float* s_tot = s_edge_m + nseg;     // 4 * nseg
  float* s_carry = s_tot + 4 * nseg;  // 2 * nseg

  const int b = blockIdx.x;
  const int g = threadIdx.x >> 5, l = threadIdx.x & 31;
  for (int k = threadIdx.x; k < kk * kk; k += blockDim.x) s_match[k] = match[k];
  for (int k = threadIdx.x; k < kk; k += blockDim.x) s_ins[k] = insert[k];
  const float tSM = params[TSM], tSI = params[TSI], tSJ = params[TSJ];
  const float tMM = params[TMM], tMI = params[TMI], tMJ = params[TMJ];
  const float tII = params[TII], tIM = params[TIM], tJJ = params[TJJ];
  const float tJM = params[TJM];
  const bool first = s == 0;
  const int lx = lxb[b], ly = lyb[b];
  const int j0 = s * Wd;
  const int* xrow = xb + (size_t)b * Lx;
  const int* yrow = yb + (size_t)b * By + j0;
  const float* bin = first ? nullptr : bnd_in + (size_t)b * Lx * BND;
  float* bout = bnd_out + (size_t)b * Lx * BND;
  float* fm_b = fm + (size_t)b * Lx * Wd;
  __syncthreads();

  const int jl = g * 64 + 2 * l;  // this thread's local lanes jl, jl + 1
  int yc[2];
  float insy[2], m[2], ix[2], iy[2], jx[2], jy[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    yc[e] = yrow[jl + e];
    insy[e] = s_ins[yc[e]];
    m[e] = ix[e] = jx[e] = LOG_ZERO;
    iy[e] = iy0[(size_t)b * By + j0 + jl + e];
    jy[e] = jy0[(size_t)b * By + j0 + jl + e];
  }
  // DP row 0 at the previous stripe's last lane (M, IX, JX are LOG_ZERO)
  const float row0_iy = first ? LOG_ZERO : iy0[(size_t)b * By + j0 - 1];
  const float row0_jy = first ? LOG_ZERO : jy0[(size_t)b * By + j0 - 1];
  const bool owner = g == nseg - 1 && l == 31;  // holds lane W-1

  float ix0 = LOG_ZERO, jx0 = LOG_ZERO;  // column-0 chains (stripe 0)
  for (int i = 0; i < lx; ++i) {
    const int xc = xrow[i];
    const float insx = s_ins[xc];
    const float* mrow = s_match + xc * kk;
    float comb[2], ixn[2], jxn[2], mn[2], aI[2], cI[2], aJ[2], cJ[2];

    // (1) fold of the five predecessors; IX/JX rows
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      comb[e] = log_add5(__fadd_rn(m[e], tMM), __fadd_rn(ix[e], tIM),
                         __fadd_rn(jx[e], tJM), __fadd_rn(iy[e], tIM),
                         __fadd_rn(jy[e], tJM));
      ixn[e] = __fadd_rn(log_add(__fadd_rn(ix[e], tII), __fadd_rn(m[e], tMI)),
                         insx);
      jxn[e] = __fadd_rn(log_add(__fadd_rn(jx[e], tJJ), __fadd_rn(m[e], tMJ)),
                         insx);
    }
    if (l == 31) s_edge_c[g] = comb[1];
    float fill;
    if (first) {
      fill = log_add(__fadd_rn(ix0, tIM), __fadd_rn(jx0, tJM));
    } else {
      // the previous stripe's last column at DP row i
      float pm = LOG_ZERO, pix = LOG_ZERO, pjx = LOG_ZERO;
      float piy = row0_iy, pjy = row0_jy;
      if (i > 0) {
        const float* p = bin + (size_t)(i - 1) * BND;
        pm = p[B_M];
        pix = p[B_IX];
        piy = p[B_IY];
        pjx = p[B_JX];
        pjy = p[B_JY];
      }
      fill = log_add5(__fadd_rn(pm, tMM), __fadd_rn(pix, tIM),
                      __fadd_rn(pjx, tJM), __fadd_rn(piy, tIM),
                      __fadd_rn(pjy, tJM));
    }
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
      if (first && i == 0 && g == 0 && l == 0) mn[0] = __fadd_rn(tSM, e0);
      *reinterpret_cast<float2*>(fm_b + (size_t)i * Wd + jl) =
          make_float2(mn[0], mn[1]);
      if (l == 31) s_edge_m[g] = mn[1];
    }
    __syncthreads();

    // (3) IY/JY within-row scans, segment level; the previous stripe's
    // last column at DP row i+1 fills the M shift and carries into lane 0
    {
      float cm = LOG_ZERO, ciy = LOG_ZERO, cjy = LOG_ZERO;
      if (!first) {
        const float* c = bin + (size_t)i * BND;
        cm = c[B_M];
        ciy = c[B_IY];
        cjy = c[B_JY];
      }
      const float msh[2] = {left_of_even(mn[1], cm, s_edge_m, g, l), mn[0]};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        aI[e] = __fadd_rn(insy[e], tII);
        cI[e] = __fadd_rn(__fadd_rn(msh[e], tMI), insy[e]);
        aJ[e] = __fadd_rn(insy[e], tJJ);
        cJ[e] = __fadd_rn(__fadd_rn(msh[e], tMJ), insy[e]);
      }
      if (!first && g == 0 && l == 0) {
        cI[0] = log_add(__fadd_rn(ciy, aI[0]), cI[0]);
        cJ[0] = log_add(__fadd_rn(cjy, aJ[0]), cJ[0]);
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
    __syncthreads();
    // (4) carry over the segments
    carry_chain(s_tot, s_carry, nseg);
    __syncthreads();

    // (5) combine; new row becomes the state; boundary column out
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      iy[e] = log_add_p(__fadd_rn(s_carry[g], aI[e]), cI[e]);
      jy[e] = log_add_p(__fadd_rn(s_carry[nseg + g], aJ[e]), cJ[e]);
      m[e] = mn[e];
      ix[e] = ixn[e];
      jx[e] = jxn[e];
      if (i == lx - 1 && j0 + jl + e == ly - 1) {
        float* out = fend + (size_t)b * 5;
        out[0] = m[e];
        out[1] = ix[e];
        out[2] = iy[e];
        out[3] = jx[e];
        out[4] = jy[e];
      }
    }
    if (owner) {
      float* o = bout + (size_t)i * BND;
      o[B_M] = m[1];
      o[B_IX] = ix[1];
      o[B_IY] = iy[1];
      o[B_JX] = jx[1];
      o[B_JY] = jy[1];
    }
    ix0 = ix0n;
    jx0 = jx0n;
  }
}

extern "C" int pairhmm_fwd_stripe(const int* xb, const int* yb,
                                  const int* lxb, const int* lyb,
                                  const float* match, const float* insert,
                                  const float* params, const float* iy0,
                                  const float* jy0, const float* bnd_in,
                                  int B, int Lx, int By, int s, int Wd, int kk,
                                  float* bnd_out, float* fend, float* fm,
                                  void* stream) {
  if (Wd % 64 != 0 || Wd < 64 || Wd > 2048 || By % Wd != 0 ||
      (s > 0) != (bnd_in != nullptr) || fm == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nseg = Wd / 64;
  const size_t smem = sizeof(float) * (size_t)(kk * kk + kk + 8 * nseg);
  pairhmm_fwd_stripe_kernel<<<B, nseg * 32, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      xb, yb, lxb, lyb, match, insert, params, iy0, jy0, bnd_in, Lx, By, s,
      Wd, kk, bnd_out, fend, fm);
  return static_cast<int>(cudaGetLastError());
}
