// Kernels 3 and 3K: the legacy pair-HMM backward pass over the reversed
// sequences. This header holds their layout and step and kernel 3K's
// block body, one thread block per pair, templated on the emission
// source (pairhmm_common.cuh): letters and their score tables (kernel
// 3K, pairhmm_bwd_codes.cu, where ops/pairhmm_cuda.py::bwd_codes_geometry
// picks it, at most 2048 lanes: S = 1 segment a warp). The same steps in
// the same layout run on the wide schedule (pairhmm_wave.cuh's backward
// body with kLegacy): kernel 3 (a precomputed emission lattice,
// pairhmm_bwd.cu) at every width, kernel 3K elsewhere. All write
// the reversed backward M lattice RB_M (B, Lx, Ly).
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_bwd_kernel (kernel 3:
// kk=None, launched by _bwd_pallas, the emissions path's legacy route
// beyond FUSED_MAX_LY; kernel 3K: kk=K, launched by _bwd_pallas_fused,
// the letter path's legacy route under MUSCLE_TPU_FUSED=0, with shared
// or per-pair tables). _finish_posteriors combines RB_M with the forward
// M lattice (kernel 1E, or A / 1M for letters) and the MEA row scan
// (kernel 4, mea_scores.cu) scores the posterior.
// reference: src/bwdflat3.cpp:10-190.
//
// Layout: lane v of row u holds RB(u, v) = Bwd(lx-u, ly-v), start-aligned
// as in the Pallas kernel, which reads per-pair roll-flipped inputs:
// e_rev[b, i, j] = e[b, lx-1-i, ly-1-j] for the lattice, and for letters
// the rolled codes xr = roll(x[::-1], lx - Lx), whose position k < lx is
// x[lx-1-k] (likewise y). Those are the same table entries, so the
// kernels read their source through reversed indices (x position lx-u,
// column ly-1-v), and neither e_rev (4.8 GB at 8 pairs of 12288) nor the
// rolled codes exist. Lanes v >= ly take LOG_ZERO emissions and insert
// scores: no lane v < ly depends on them (every dependence runs from
// lower lanes to higher), and _finish_posteriors reads only rows u < lx
// and lanes v < ly. Rows u >= lx are written as zeros; the block body
// does no work on the 64-lane segments past ly in rows u < lx and leaves
// them unwritten, as kernel A does. Step u > 0 is
// kernel B's backward step (pairhmm_bwd_post.cuh) without its padding
// lanes; each step writes shift_fill(M row, column-0 chain) as row u, as
// the Pallas kernel does. The params row is pair b's (pstride 16) or
// shared (pstride 0).
//
// kCorner (kernel 3K for -testfb): one step more, u = lx, which reads x
// position 0 and is not written to RB_M, after which the thread holding
// lane ly-1 writes the five states [M, IX, IY, JX, JY] of row lx there
// (the reversed lattice's far corner, which total_prob_bwd folds with
// the start scores) to corner (B, 5). The caller launches it with
// Lx > lx. Without it the kernel is the same code as before.
//
// What bounds it on the H100: for the function itself, bytes. Kernel 3
// reads the lattice's real cells and writes RB_M (2 x 4 bytes a cell; 8
// pairs of ~9,000 x 9,000 real cells in 12288 x 12288 lattices: ~1.5 ms
// at 3.35 TB/s); kernel 3K reads only the codes and tables and writes
// RB_M (4 bytes a cell). Against that, ~138 f32 operations per real cell
// of the sequential recurrence. As in kernels A and B, the
// association-preserving scan does several times those operations along
// a serial row chain; kernel 3K's block body runs one block per pair (512
// pairs fill the 132 SMs, ~4 blocks an SM), its state rows in registers
// (S = 1 segment a warp up to 2048 lanes; ptxas's counts are printed by
// chip_smoke.py), its emissions gathered from the tables in shared
// memory, as kernel A does. Its rows are bound by the instruction
// throughput of SMs that several blocks share, so its LOG_ADDs are
// selects (kBF: the same operations, the same bits) and it skips the
// segments past ly.
#pragma once

#include "pairhmm_common.cuh"

using namespace ph;

template <int S, class Src, bool kCorner>
__global__ void __launch_bounds__(1024)
pairhmm_bwd_kernel(const typename Src::Args args, const int* __restrict__ lxb,
                   const int* __restrict__ lyb,
                   const float* __restrict__ params, int pstride, int Lx,
                   int Ly, float* __restrict__ rbm,
                   float* __restrict__ corner) {
  extern __shared__ float smem[];
  const int nseg = Ly >> 6;
  const int W = blockDim.x >> 5;
  float* s_row = smem + Src::table_floats(args);
  float* s_edge_m = s_row + Ly;        // M state edge (nseg)
  float* s_edge_iy = s_edge_m + nseg;  // IY edge
  float* s_edge_jy = s_edge_iy + nseg; // JY edge
  float* s_tot = s_edge_jy + nseg;     // 4 * nseg
  float* s_carry = s_tot + 4 * nseg;   // 2 * nseg

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
  // others (no lane below ly depends on them, and the combine reads no
  // cell of RB_M past ly; their lanes of rows u < lx are not written)
  const int nlive = min(nseg, (ly + 63) >> 6);
  float* rb_b = rbm + (size_t)b * Lx * Ly;

  // rows u >= lx are zero
  for (size_t k = (size_t)lx * Ly + 4 * threadIdx.x; k < (size_t)Lx * Ly;
       k += 4 * blockDim.x)
    *reinterpret_cast<float4*>(rb_b + k) = make_float4(0.f, 0.f, 0.f, 0.f);

  __syncthreads();  // the source's tables are in shared memory

  // lane v holds column ly-1-v; lanes v >= ly take LOG_ZERO
  int yc[S][2];
  float insy[S][2], m[S][2], ix[S][2], iy[S][2], jx[S][2], jy[S][2];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int g = warp + s * W;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int v = g * 64 + 2 * l + e2;
      const bool real = g < nseg && v < ly;
      yc[s][e2] = real ? src.tag(ly - 1 - v) : 0;
      insy[s][e2] = real ? src.insy(ly - 1 - v, yc[s][e2]) : LOG_ZERO;
      iy[s][e2] = __fadd_rn(insy[s][e2], tII);
      jy[s][e2] = __fadd_rn(insy[s][e2], tJJ);
    }
  }
  // boundary row u = 0 (i = lx)
  block_cumsum<S>(iy, s_row, Ly, nseg, W, warp, l);
  block_cumsum<S>(jy, s_row, Ly, nseg, W, warp, l);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int g = warp + s * W;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      iy[s][e2] = __fadd_rn(tSI, iy[s][e2]);
      jy[s][e2] = __fadd_rn(tSJ, jy[s][e2]);
    }
    if (g < nseg && l == 31) {
      s_edge_iy[g] = iy[s][1];
      s_edge_jy[g] = jy[s][1];
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
      for (int e2 = 0; e2 < 2; ++e2) {
        m[s][e2] = log_add<kBF>(__fadd_rn(__fadd_rn(tMI, shi[e2]), insy[s][e2]),
                           __fadd_rn(__fadd_rn(tMJ, shj[e2]), insy[s][e2]));
        ix[s][e2] = LOG_ZERO;
        jx[s][e2] = LOG_ZERO;
      }
      if (l == 31) s_edge_m[g] = m[s][1];
    }
  }
  float ix0 = tSI, jx0 = tSJ, m0 = tSM;  // column-0 chains (v = 0)
  __syncthreads();

  for (int u = 0; u < lx + (kCorner ? 1 : 0); ++u) {
    if (u > 0) {
      // emission row u-1 of the reversed lattice: x position lx-u
      src.row(lx - u);
      const float insx = src.insx;
      float nm[S][2], nix[S][2], njx[S][2];
      float aI[S][2], cI[S][2], aJ[S][2], cJ[S][2];
      // (1) next-row terms, IX/JX, IY/JY segment scans
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int g = warp + s * W;
        if (g < nlive) {
          const float shm[2] = {left_of_even(m[s][1], m0, s_edge_m, g, l),
                                m[s][0]};
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int v = g * 64 + 2 * l + e2;
            const float er = v < ly ? src.emit1(ly - 1 - v, yc[s][e2])
                                    : LOG_ZERO;
            nm[s][e2] = __fadd_rn(shm[e2], er);
            nix[s][e2] = __fadd_rn(ix[s][e2], insx);
            njx[s][e2] = __fadd_rn(jx[s][e2], insx);
            ix[s][e2] = log_add<kBF>(__fadd_rn(tII, nix[s][e2]), __fadd_rn(tIM, nm[s][e2]));
            jx[s][e2] = log_add<kBF>(__fadd_rn(tJJ, njx[s][e2]), __fadd_rn(tJM, nm[s][e2]));
            aI[s][e2] = __fadd_rn(insy[s][e2], tII);
            cI[s][e2] = __fadd_rn(tIM, nm[s][e2]);
            aJ[s][e2] = __fadd_rn(insy[s][e2], tJJ);
            cJ[s][e2] = __fadd_rn(tJM, nm[s][e2]);
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
      carry_chain<kBF>(s_tot, s_carry, nseg, nlive);
      __syncthreads();
      // (3) IY/JY rows
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int g = warp + s * W;
        if (g < nlive) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            iy[s][e2] = log_add_p<kBF>(__fadd_rn(s_carry[g], aI[s][e2]), cI[s][e2]);
            jy[s][e2] = log_add_p<kBF>(__fadd_rn(s_carry[nseg + g], aJ[s][e2]), cJ[s][e2]);
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
        if (g < nlive) {
          const float shi[2] = {left_of_even(iy[s][1], LOG_ZERO, s_edge_iy, g, l),
                                iy[s][0]};
          const float shj[2] = {left_of_even(jy[s][1], LOG_ZERO, s_edge_jy, g, l),
                                jy[s][0]};
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const float niy = __fadd_rn(shi[e2], insy[s][e2]);
            const float njy = __fadd_rn(shj[e2], insy[s][e2]);
            m[s][e2] = log_add5<kBF>(__fadd_rn(tMM, nm[s][e2]), __fadd_rn(tMI, nix[s][e2]),
                                __fadd_rn(tMJ, njx[s][e2]), __fadd_rn(tMI, niy),
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
    // (5) row u of RB_M: the M row shifted one lane, the column-0 chain
    // in lane 0
    if (kCorner && u == lx) break;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = warp + s * W;
      if (g < nlive) {
        const float lo = left_of_even(m[s][1], m0, s_edge_m, g, l);
        *reinterpret_cast<float2*>(rb_b + (size_t)u * Ly + g * 64 + 2 * l) =
            make_float2(lo, m[s][0]);
      }
    }
  }
  if constexpr (kCorner) {
    // lane ly-1 of row lx: its thread's element (ly-1) & 1, chosen by a
    // select (a register array takes no run-time index)
    const int c = ly - 1;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = warp + s * W;
      if (g * 64 + 2 * l == (c & ~1)) {
        const bool hi = c & 1;
        float* out = corner + (size_t)b * 5;
        out[0] = hi ? m[s][1] : m[s][0];
        out[1] = hi ? ix[s][1] : ix[s][0];
        out[2] = hi ? iy[s][1] : iy[s][0];
        out[3] = hi ? jx[s][1] : jx[s][0];
        out[4] = hi ? jy[s][1] : jy[s][0];
      }
    }
  }
}


template <int S, class Src, bool kCorner>
static int launch_bwd(const Geometry& geo, int B, cudaStream_t st,
                      const typename Src::Args& args, const int* lxb,
                      const int* lyb, const float* params, int pstride,
                      int Lx, int Ly, float* rbm, float* corner) {
  const cudaError_t err =
      allow_smem(pairhmm_bwd_kernel<S, Src, kCorner>, geo.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pairhmm_bwd_kernel<S, Src, kCorner><<<B, geo.W * 32, geo.smem, st>>>(
      args, lxb, lyb, params, pstride, Lx, Ly, rbm, corner);
  return static_cast<int>(cudaGetLastError());
}

// One launch at the geometry of Ly: S = 1 segment a warp (Ly <= 2048);
// wider rows take the wave (pairhmm_wave.cuh), so any other S is refused.
// A non-null corner (B, 5) takes the kCorner body.
template <class Src>
static int dispatch_bwd(int B, cudaStream_t st, const typename Src::Args& args,
                        const int* lxb, const int* lyb, const float* params,
                        int pstride, int Lx, int Ly, float* rbm,
                        float* corner) {
  const Geometry geo = geometry(Ly, Src::table_floats(args), 9);
  if (geo.S != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (corner)
    return launch_bwd<1, Src, true>(geo, B, st, args, lxb, lyb, params,
                                    pstride, Lx, Ly, rbm, corner);
  return launch_bwd<1, Src, false>(geo, B, st, args, lxb, lyb, params,
                                   pstride, Lx, Ly, rbm, nullptr);
}
