// Kernels B and 2E: pair-HMM backward pass fused with the posterior
// combine and the MEA score, one thread block per pair, templated on the
// emission source (pairhmm_common.cuh): letters and their score tables
// (kernel B, pairhmm_bwd_post.cu) or the forward-layout emission lattice
// that kernel 1E read (kernel 2E, pairhmm_bwd_post_emis.cu).
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_bwd_post_kernel (kernel B:
// kk=K, launched by _bwd_post_pallas; kernel 2E: kk=None, flip_e=True,
// launched by _bwd_post_pallas_emissions). reference:
// src/bwdflat3.cpp:10-190 (recurrence), src/calcposteriorflat.cpp:4-27
// (combine + 0.01 threshold), src/calcalnscoreflat.cpp:4-32 (MEA).
//
// Layout as in the Pallas kernel: lane q holds forward column Ly-1-q
// (both sequences plainly flipped, so every pair's real lanes end at
// lane Ly-1 and the MEA corner lands in the last lane); padding lanes
// q < Ly-ly carry the column boundary chains. Step u is backward row
// i = Lx-u. Rows u <= u0 = Lx-lx hold the boundary state in the Pallas
// kernel; a block that owns one pair starts at u0 instead and writes
// the rows past lx as zeros. Each step combines the backward M row with
// forward M row Lx-1-u (from kernel A) and the pair's total log-prob
// into exp(F + B - total), zero where the log score is below log(0.01)
// (compared before the exp) or outside (lx, ly), written straight into
// post (B, Lx, Ly); the MEA running row takes the same values.
//
// What bounds it on the H100: for the function itself, bytes. It reads
// the forward M lattice and writes the posterior, 2 x 512 MiB for 512
// pairs at Lx = Ly = 512 (0.32 ms at 3.35 TB/s), against ~146 f32
// operations per real cell (recurrence, posterior, MEA; ~0.13 ms at
// 67 TFLOP/s). As in kernel A, the association-preserving scan does
// several times those operations along a serial row chain. The design
// keeps the state, the MEA row and the scan in registers and warp
// shuffles, reads the forward lattice and writes the posterior once
// each, coalesced, and never materialises the backward lattice. Kernel
// 2E reads the emission lattice through reversed indices, e[b, Lx-u,
// Ly-1-q], one coalesced row per step: the TPU kernel's lane flip
// (_flip_lanes, an exchange-matrix product per 128 lanes) is index
// arithmetic here, and no flipped copy exists.
//
// As for kernel A (pairhmm_fwd.cuh), the card measured a latency chain:
// at 512 lanes a block alone ran its step (~11,000 cycles: terms + scans
// 48 %, posterior + MEA 15 %, M fold 14 %, carry chain 13 %) within 14 %
// of four sharing an SM. So the LOG_ADDs are selects (kBF); rows wider
// than 2048 lanes run on the wave schedule (pairhmm_wave.cuh). The
// padding lanes on the left carry the column boundary chains, so every
// segment works.
#pragma once

#include "pairhmm_common.cuh"

using namespace ph;

template <int S, class Src>
__global__ void __launch_bounds__(1024)
pairhmm_bwd_post_kernel(const typename Src::Args args,
                        const int* __restrict__ lxb,
                        const int* __restrict__ lyb,
                        const float* __restrict__ params, int pstride,
                        const float* __restrict__ tot, int Lx, int Ly,
                        int with_mea, const float* __restrict__ fm,
                        float* __restrict__ post, float* __restrict__ mea_out) {
  extern __shared__ float smem[];
  const int nseg = Ly >> 6;
  const int W = blockDim.x >> 5;
  float* s_row = smem + Src::table_floats(args);
  float* s_edge_m = s_row + Ly;        // M state edge (nseg)
  float* s_edge_iy = s_edge_m + nseg;  // IY edge
  float* s_edge_jy = s_edge_iy + nseg; // JY edge
  float* s_edge_mea = s_edge_jy + nseg;
  float* s_segmax = s_edge_mea + nseg;
  float* s_tot = s_segmax + nseg;      // 4 * nseg
  float* s_carry = s_tot + 4 * nseg;   // 2 * nseg

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  Src src(args, b, Lx, Ly, smem);
  const float* pp = pair_params(params, pstride, b);
  const float tSM = pp[TSM], tSI = pp[TSI], tSJ = pp[TSJ];
  const float tMM = pp[TMM], tMI = pp[TMI], tMJ = pp[TMJ];
  const float tII = pp[TII], tIM = pp[TIM], tJJ = pp[TJJ];
  const float tJM = pp[TJM];
  const float totb = tot[b];
  const int lx = lxb[b], ly = lyb[b];
  const int q0 = Ly - ly;
  const float* fm_b = fm + (size_t)b * Lx * Ly;
  float* post_b = post + (size_t)b * Lx * Ly;
  __syncthreads();

  // rows i > lx of the posterior are zero
  for (size_t k = (size_t)lx * Ly + 4 * threadIdx.x; k < (size_t)Lx * Ly;
       k += 4 * blockDim.x)
    *reinterpret_cast<float4*>(post_b + k) = make_float4(0.f, 0.f, 0.f, 0.f);

  int yc[S][2];
  bool pad[S][2];
  float insy[S][2], m[S][2], ix[S][2], iy[S][2], jx[S][2], jy[S][2];
  float mea[S][2];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int g = warp + s * W;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = g * 64 + 2 * l + e;
      yc[s][e] = g < nseg ? src.tag(Ly - 1 - q) : 0;
      pad[s][e] = q < q0;
      const float raw = g < nseg ? src.insy(Ly - 1 - q, yc[s][e]) : 0.0f;
      insy[s][e] = pad[s][e] ? LOG_ZERO : raw;
      iy[s][e] = pad[s][e] ? 0.0f : __fadd_rn(raw, tII);
      jy[s][e] = pad[s][e] ? 0.0f : __fadd_rn(raw, tJJ);
      mea[s][e] = 0.0f;
    }
  }
  // boundary row B(lx, .): prefix sums from the first real lane
  block_cumsum<S>(iy, s_row, Ly, nseg, W, warp, l);
  block_cumsum<S>(jy, s_row, Ly, nseg, W, warp, l);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int g = warp + s * W;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      iy[s][e] = pad[s][e] ? tSI : __fadd_rn(tSI, iy[s][e]);
      jy[s][e] = pad[s][e] ? tSJ : __fadd_rn(tSJ, jy[s][e]);
    }
    if (g < nseg && l == 31) {
      s_edge_iy[g] = iy[s][1];
      s_edge_jy[g] = jy[s][1];
      s_edge_mea[g] = 0.0f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int g = warp + s * W;
    if (g < nseg) {
      const float shi[2] = {left_of_even(iy[s][1], tSI, s_edge_iy, g, l),
                            iy[s][0]};
      const float shj[2] = {left_of_even(jy[s][1], tSJ, s_edge_jy, g, l),
                            jy[s][0]};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float mr =
            log_add<kBF>(__fadd_rn(__fadd_rn(tMI, shi[e]), insy[s][e]),
                         __fadd_rn(__fadd_rn(tMJ, shj[e]), insy[s][e]));
        m[s][e] = pad[s][e] ? tSM : mr;
        ix[s][e] = pad[s][e] ? tSI : LOG_ZERO;
        jx[s][e] = pad[s][e] ? tSJ : LOG_ZERO;
      }
      if (l == 31) s_edge_m[g] = m[s][1];
    }
  }
  float ix0 = tSI, jx0 = tSJ, m0 = tSM;  // column-0 chains (j = ly)
  __syncthreads();

  const int u0 = Lx - lx;
  for (int u = u0; u < Lx; ++u) {
    if (u > u0) {
      src.row(Lx - u);
      const float insx = src.insx;
      float nm[S][2], nix[S][2], njx[S][2];
      float aI[S][2], cI[S][2], aJ[S][2], cJ[S][2];
      // (1) next-row terms, IX/JX, IY/JY segment scans
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int g = warp + s * W;
        if (g < nseg) {
          const float shm[2] = {left_of_even(m[s][1], m0, s_edge_m, g, l),
                                m[s][0]};
          // lanes q, q+1 are columns Ly-1-q, Ly-2-q
          const float2 ev = src.emit2(Ly - 2 - (g * 64 + 2 * l), yc[s][1],
                                      yc[s][0]);
          const float emit[2] = {ev.y, ev.x};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float er = pad[s][e] ? LOG_ZERO : emit[e];
            nm[s][e] = __fadd_rn(shm[e], er);
            nix[s][e] = __fadd_rn(ix[s][e], insx);
            njx[s][e] = __fadd_rn(jx[s][e], insx);
            ix[s][e] = log_add<kBF>(__fadd_rn(tII, nix[s][e]),
                                    __fadd_rn(tIM, nm[s][e]));
            jx[s][e] = log_add<kBF>(__fadd_rn(tJJ, njx[s][e]),
                                    __fadd_rn(tJM, nm[s][e]));
            aI[s][e] = __fadd_rn(insy[s][e], tII);
            cI[s][e] = __fadd_rn(tIM, nm[s][e]);
            aJ[s][e] = __fadd_rn(insy[s][e], tJJ);
            cJ[s][e] = __fadd_rn(tJM, nm[s][e]);
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
      const float ix0n = __fadd_rn(__fadd_rn(tII, ix0), insx);
      const float jx0n = __fadd_rn(__fadd_rn(tJJ, jx0), insx);
      const float m0n = log_add<kBF>(__fadd_rn(__fadd_rn(tMI, ix0), insx),
                                __fadd_rn(__fadd_rn(tMJ, jx0), insx));
      __syncthreads();
      // (2) carry over the segments
      carry_chain<kBF>(s_tot, s_carry, nseg, nseg);
      __syncthreads();
      // (3) IY/JY rows
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int g = warp + s * W;
        if (g < nseg) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            iy[s][e] =
                log_add_p<kBF>(__fadd_rn(s_carry[g], aI[s][e]), cI[s][e]);
            jy[s][e] = log_add_p<kBF>(__fadd_rn(s_carry[nseg + g], aJ[s][e]),
                                      cJ[s][e]);
          }
          if (l == 31) {
            s_edge_iy[g] = iy[s][1];
            s_edge_jy[g] = jy[s][1];
          }
        }
      }
      __syncthreads();
      // (4) M row
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int g = warp + s * W;
        if (g < nseg) {
          const float shi[2] = {left_of_even(iy[s][1], LOG_ZERO, s_edge_iy, g, l),
                                iy[s][0]};
          const float shj[2] = {left_of_even(jy[s][1], LOG_ZERO, s_edge_jy, g, l),
                                jy[s][0]};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float niy = __fadd_rn(shi[e], insy[s][e]);
            const float njy = __fadd_rn(shj[e], insy[s][e]);
            m[s][e] = log_add5<kBF>(
                __fadd_rn(tMM, nm[s][e]), __fadd_rn(tMI, nix[s][e]),
                __fadd_rn(tMJ, njx[s][e]), __fadd_rn(tMI, niy),
                __fadd_rn(tMJ, njy));
          }
          if (l == 31) s_edge_m[g] = m[s][1];
        }
      }
      ix0 = ix0n;
      jx0 = jx0n;
      m0 = m0n;
      __syncthreads();
    }

    // (5) posterior row Lx-1-u; MEA running row
    const int pf = Lx - 1 - u;
    float p[S][2];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = warp + s * W;
      if (g < nseg) {
        const float bn[2] = {left_of_even(m[s][1], m0, s_edge_m, g, l),
                             m[s][0]};
        const int q = g * 64 + 2 * l;
        // lanes q, q+1 are forward columns Ly-1-q, Ly-2-q
        const size_t off = (size_t)pf * Ly + (Ly - 2 - q);
        const float2 f = *reinterpret_cast<const float2*>(fm_b + off);
        const float fv[2] = {f.y, f.x};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float score = __fsub_rn(__fadd_rn(fv[e], bn[e]), totb);
          p[s][e] = (score >= MIN_SPARSE_SCORE && !pad[s][e])
                        ? expf(fminf(score, 0.0f)) : 0.0f;
        }
        *reinterpret_cast<float2*>(post_b + off) = make_float2(p[s][1], p[s][0]);
        if (with_mea) {
          const float osh = left_of_even(mea[s][1], 0.0f, s_edge_mea, g, l);
          float ev0 = fmaxf(fmaxf(__fadd_rn(osh, p[s][0]), mea[s][0]), 0.0f);
          float ev1 = fmaxf(fmaxf(__fadd_rn(mea[s][0], p[s][1]), mea[s][1]), 0.0f);
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
          mea[s][0] = ev0;
          mea[s][1] = run;
          if (l == 31) s_segmax[g] = run;
        }
      }
    }
    if (with_mea) {
      __syncthreads();
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int g = warp + s * W;
        if (g < nseg) {
          float pre = NEG_BIG;
          for (int h = 0; h < g; ++h) pre = fmaxf(pre, s_segmax[h]);
          mea[s][0] = fmaxf(mea[s][0], pre);
          mea[s][1] = fmaxf(mea[s][1], pre);
          if (l == 31) s_edge_mea[g] = mea[s][1];
        }
      }
    }
  }
  if (with_mea) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (warp + s * W == nseg - 1 && l == 31) mea_out[b] = mea[s][1];
  }
}

template <int S, class Src>
static int launch_bwd_post(const Geometry& geo, int B, cudaStream_t st,
                           const typename Src::Args& args, const int* lxb,
                           const int* lyb, const float* params, int pstride,
                           const float* tot, int Lx, int Ly, int with_mea,
                           const float* fm, float* post, float* mea) {
  const cudaError_t e = allow_smem(pairhmm_bwd_post_kernel<S, Src>, geo.smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  pairhmm_bwd_post_kernel<S, Src><<<B, geo.W * 32, geo.smem, st>>>(
      args, lxb, lyb, params, pstride, tot, Lx, Ly, with_mea, fm, post, mea);
  return static_cast<int>(cudaGetLastError());
}

// One launch at the geometry of Ly: S = 1..MAX_S segments per warp.
template <class Src, int MAX_S>
static int dispatch_bwd_post(int B, cudaStream_t st,
                             const typename Src::Args& args, const int* lxb,
                             const int* lyb, const float* params, int pstride,
                             const float* tot, int Lx, int Ly, int with_mea,
                             const float* fm, float* post, float* mea) {
  const Geometry geo = geometry(Ly, Src::table_floats(args), 11);
  switch (geo.S) {
    case 1:
      return launch_bwd_post<1, Src>(geo, B, st, args, lxb, lyb, params, pstride, tot,
                                     Lx, Ly, with_mea, fm, post, mea);
    case 2:
      return launch_bwd_post<2, Src>(geo, B, st, args, lxb, lyb, params, pstride, tot,
                                     Lx, Ly, with_mea, fm, post, mea);
    case 3:
      return launch_bwd_post<3, Src>(geo, B, st, args, lxb, lyb, params, pstride, tot,
                                     Lx, Ly, with_mea, fm, post, mea);
    case 4:
      return launch_bwd_post<4, Src>(geo, B, st, args, lxb, lyb, params, pstride, tot,
                                     Lx, Ly, with_mea, fm, post, mea);
    case 5:
      return launch_bwd_post<5, Src>(geo, B, st, args, lxb, lyb, params, pstride, tot,
                                     Lx, Ly, with_mea, fm, post, mea);
    case 6:
      if constexpr (MAX_S >= 6)
        return launch_bwd_post<6, Src>(geo, B, st, args, lxb, lyb, params,
                                       pstride, tot, Lx, Ly, with_mea, fm, post, mea);
      [[fallthrough]];
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
