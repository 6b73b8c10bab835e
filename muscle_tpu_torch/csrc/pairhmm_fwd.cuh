// Kernels A and 1E: pair-HMM forward pass, one thread block per pair,
// templated on the emission source (pairhmm_common.cuh): letters and
// their score tables (kernel A, pairhmm_fwd.cu) or a precomputed
// emission lattice (kernel 1E, pairhmm_fwd_emis.cu).
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_fwd_kernel (kernel A: the
// kk=K variant launched by _fwd_pallas_fused; kernel 1E: the kk=None
// variant launched by _fwd_pallas). reference: src/fwdflat3.cpp:12-153.
//
// Per DP row i (1..lx): M from the five states of row i-1 at column
// j-1, IX/JX from row i-1 at column j, IY/JY from the within-row
// log-semiring recurrence u_j = LOG_ADD(u_{j-1} + a_j, c_j), solved by
// the Pallas kernels' segmented scan ("segpoly": Hillis-Steele rounds in
// 64-lane segments, a sequential carry over the segments, one combine
// per lane). Row 0 is the boundary prefix sum. Output: the forward M
// lattice fm (B, Lx, Ly) (rows >= lx and the 64-lane segments past
// column ly are not written; every reader masks cells outside (lx, ly))
// and fend (B, 5), the states [M, IX, IY, JX, JY] at (lx, ly).
//
// What bounds it on the H100: for the function itself, bytes. It writes
// one 4-byte M cell per (pair, row, column), 512 MiB for 512 pairs at
// Lx = Ly = 512 (0.16 ms at 3.35 TB/s), against ~130 f32 operations per
// real cell of the sequential recurrence (~0.12 ms at 67 TFLOP/s for
// the same ragged batch; count in chip_smoke.py). The kernel does
// several times those operations, because it keeps the TPU kernel's
// association: six Hillis-Steele rounds of the degree-8 LOG_ADD per
// scan and lane, products and sums rounded apart (no FMA). Each pair's
// rows are a serial chain with four block barriers per row. The design
// keeps the five state rows in registers (only the M row leaves the
// SM, once, coalesced), gathers emissions from the (K+1)^2 table in
// shared memory (no emission lattice in device memory, unlike the TPU
// path), runs the scan rounds on warp shuffles, and runs one block per
// pair so a 512-pair batch fills all 132 SMs in one wave. Kernel 1E reads
// one coalesced row of the lattice per DP row instead of the tables, so
// it also reads the lattice's real cells once (4 bytes a cell more than
// kernel A, still a bytes-bound function).
//
// What the card measured (tools/torch_ab_probe.py, clock64 marks between
// the row loop's barriers): a row is a latency chain, not an issue
// limit. At 512 lanes a block alone on its SM ran its row (~8,800
// cycles: scans 48 %, fold 26 %, carry chain 16 %) within 12 % of four
// blocks sharing one. So the LOG_ADDs are selects (kBF), which let a
// thread's independent LOG_ADDs overlap, and the row loop does no work on
// segments past column ly. Rows wider than 2048 lanes, whose S segments
// a warp and S * 32-step carry chain made each pair's row a chain on one
// SM, run on the wave schedule instead (pairhmm_wave.cuh).
#pragma once

#include "pairhmm_common.cuh"

using namespace ph;

template <int S, class Src>
__global__ void __launch_bounds__(1024)
pairhmm_fwd_kernel(const typename Src::Args args, const int* __restrict__ lxb,
                   const int* __restrict__ lyb,
                   const float* __restrict__ params, int pstride, int Lx,
                   int Ly, float* __restrict__ fm, float* __restrict__ fend) {
  extern __shared__ float smem[];
  const int nseg = Ly >> 6;
  const int W = blockDim.x >> 5;
  float* s_row = smem + Src::table_floats(args);
  float* s_edge_c = s_row + Ly;      // comb edge (nseg)
  float* s_edge_m = s_edge_c + nseg; // m_new edge (nseg)
  float* s_tot = s_edge_m + nseg;    // 4 * nseg
  float* s_carry = s_tot + 4 * nseg; // 2 * nseg

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  Src src(args, b, Lx, Ly, smem);
  const float* pp = pair_params(params, pstride, b);
  const float tSM = pp[TSM], tSI = pp[TSI], tSJ = pp[TSJ];
  const float tMM = pp[TMM], tMI = pp[TMI], tMJ = pp[TMJ];
  const float tII = pp[TII], tIM = pp[TIM], tJJ = pp[TJJ];
  const float tJM = pp[TJM];
  const int lx = lxb[b], ly = lyb[b];
  // segments that hold real columns: the row loop does no work on the
  // others (the scan runs left to right and the fold reads column j-1,
  // so no real cell reads them; their columns of fm are not written)
  const int nlive = min(nseg, (ly + 63) >> 6);
  float* fm_b = fm + (size_t)b * Lx * Ly;
  __syncthreads();

  int yc[S][2];
  float insy[S][2], m[S][2], ix[S][2], iy[S][2], jx[S][2], jy[S][2];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int g = warp + s * W;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = g * 64 + 2 * l + e;
      yc[s][e] = g < nseg ? src.tag(j) : 0;
      insy[s][e] = g < nseg ? src.insy(j, yc[s][e]) : 0.0f;
      m[s][e] = ix[s][e] = jx[s][e] = LOG_ZERO;
      iy[s][e] = __fadd_rn(insy[s][e], tII);
      jy[s][e] = __fadd_rn(insy[s][e], tJJ);
    }
  }
  // row 0 boundary (reference: src/fwdflat3.cpp:35-93)
  block_cumsum<S>(iy, s_row, Ly, nseg, W, warp, l);
  block_cumsum<S>(jy, s_row, Ly, nseg, W, warp, l);
  const float iy_base = __fsub_rn(tSI, tII), jy_base = __fsub_rn(tSJ, tJJ);
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      iy[s][e] = __fadd_rn(iy_base, iy[s][e]);
      jy[s][e] = __fadd_rn(jy_base, jy[s][e]);
    }

  float ix0 = LOG_ZERO, jx0 = LOG_ZERO;  // column-0 IX/JX chains
  for (int i = 0; i < lx; ++i) {
    src.row(i);
    const float insx = src.insx;
    float comb[S][2], ixn[S][2], jxn[S][2], mn[S][2];
    float aI[S][2], cI[S][2], aJ[S][2], cJ[S][2];

    // (1) fold of the five predecessors; IX/JX rows
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = warp + s * W;
      if (g < nlive) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          comb[s][e] = log_add5<kBF>(
              __fadd_rn(m[s][e], tMM), __fadd_rn(ix[s][e], tIM),
              __fadd_rn(jx[s][e], tJM), __fadd_rn(iy[s][e], tIM),
              __fadd_rn(jy[s][e], tJM));
          ixn[s][e] = __fadd_rn(log_add<kBF>(__fadd_rn(ix[s][e], tII),
                                             __fadd_rn(m[s][e], tMI)), insx);
          jxn[s][e] = __fadd_rn(log_add<kBF>(__fadd_rn(jx[s][e], tJJ),
                                             __fadd_rn(m[s][e], tMJ)), insx);
        }
        if (l == 31) s_edge_c[g] = comb[s][1];
      }
    }
    const float fill = log_add<kBF>(__fadd_rn(ix0, tIM), __fadd_rn(jx0, tJM));
    const float ix0n = i == 0 ? __fadd_rn(tSI, insx)
                              : __fadd_rn(__fadd_rn(ix0, tII), insx);
    const float jx0n = i == 0 ? __fadd_rn(tSJ, insx)
                              : __fadd_rn(__fadd_rn(jx0, tJJ), insx);
    __syncthreads();

    // (2) M row = fold shifted one lane + emission; write it out
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = warp + s * W;
      if (g < nlive) {
        const float left = left_of_even(comb[s][1], fill, s_edge_c, g, l);
        const int j0 = g * 64 + 2 * l;
        const float2 ev = src.emit2(j0, yc[s][0], yc[s][1]);
        mn[s][0] = __fadd_rn(left, ev.x);
        mn[s][1] = __fadd_rn(comb[s][0], ev.y);
        if (i == 0 && g == 0 && l == 0) mn[s][0] = __fadd_rn(tSM, ev.x);
        *reinterpret_cast<float2*>(fm_b + (size_t)i * Ly + j0) =
            make_float2(mn[s][0], mn[s][1]);
        if (l == 31) s_edge_m[g] = mn[s][1];
      }
    }
    __syncthreads();

    // (3) IY/JY within-row scans, segment level
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = warp + s * W;
      if (g < nlive) {
        const float msh[2] = {left_of_even(mn[s][1], LOG_ZERO, s_edge_m, g, l),
                              mn[s][0]};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          aI[s][e] = __fadd_rn(insy[s][e], tII);
          cI[s][e] = __fadd_rn(__fadd_rn(msh[e], tMI), insy[s][e]);
          aJ[s][e] = __fadd_rn(insy[s][e], tJJ);
          cJ[s][e] = __fadd_rn(__fadd_rn(msh[e], tMJ), insy[s][e]);
        }
        seg_scan<kBF>(aI[s], cI[s], l);
        seg_scan<kBF>(aJ[s], cJ[s], l);
        if (l == 31) {
          s_tot[g] = aI[s][1];
          s_tot[nseg + g] = cI[s][1];
          s_tot[2 * nseg + g] = aJ[s][1];
          s_tot[3 * nseg + g] = cJ[s][1];
        }
      }
    }
    __syncthreads();
    // (4) carry over the segments
    carry_chain<kBF>(s_tot, s_carry, nseg, nlive);
    __syncthreads();

    // (5) combine; new row becomes the state
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = warp + s * W;
      if (g < nlive) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          iy[s][e] =
              log_add_p<kBF>(__fadd_rn(s_carry[g], aI[s][e]), cI[s][e]);
          jy[s][e] =
              log_add_p<kBF>(__fadd_rn(s_carry[nseg + g], aJ[s][e]), cJ[s][e]);
          m[s][e] = mn[s][e];
          ix[s][e] = ixn[s][e];
          jx[s][e] = jxn[s][e];
          if (i == lx - 1 && g * 64 + 2 * l + e == ly - 1) {
            float* out = fend + (size_t)b * 5;
            out[0] = m[s][e];
            out[1] = ix[s][e];
            out[2] = iy[s][e];
            out[3] = jx[s][e];
            out[4] = jy[s][e];
          }
        }
      }
    }
    ix0 = ix0n;
    jx0 = jx0n;
  }
}

template <int S, class Src>
static int launch_fwd(const Geometry& geo, int B, cudaStream_t st,
                      const typename Src::Args& args, const int* lxb,
                      const int* lyb, const float* params, int pstride,
                      int Lx, int Ly, float* fm, float* fend) {
  const cudaError_t e = allow_smem(pairhmm_fwd_kernel<S, Src>, geo.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  pairhmm_fwd_kernel<S, Src><<<B, geo.W * 32, geo.smem, st>>>(
      args, lxb, lyb, params, pstride, Lx, Ly, fm, fend);
  return static_cast<int>(cudaGetLastError());
}

// One launch at the geometry of Ly: S = 1..MAX_S (<= 5) segments per warp.
template <class Src, int MAX_S>
static int dispatch_fwd(int B, cudaStream_t st, const typename Src::Args& args,
                        const int* lxb, const int* lyb, const float* params,
                        int pstride, int Lx, int Ly, float* fm, float* fend) {
  const Geometry geo = geometry(Ly, Src::table_floats(args), 8);
  switch (geo.S) {
    case 1:
      return launch_fwd<1, Src>(geo, B, st, args, lxb, lyb, params, pstride, Lx, Ly, fm, fend);
    case 2:
      if constexpr (MAX_S >= 2)
        return launch_fwd<2, Src>(geo, B, st, args, lxb, lyb, params, pstride, Lx, Ly, fm, fend);
      [[fallthrough]];
    case 3:
      if constexpr (MAX_S >= 3)
        return launch_fwd<3, Src>(geo, B, st, args, lxb, lyb, params, pstride, Lx, Ly, fm, fend);
      [[fallthrough]];
    case 4:
      if constexpr (MAX_S >= 4)
        return launch_fwd<4, Src>(geo, B, st, args, lxb, lyb, params, pstride, Lx, Ly, fm, fend);
      [[fallthrough]];
    case 5:
      if constexpr (MAX_S >= 5)
        return launch_fwd<5, Src>(geo, B, st, args, lxb, lyb, params, pstride, Lx, Ly, fm, fend);
      [[fallthrough]];
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
