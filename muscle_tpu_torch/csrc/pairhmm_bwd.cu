// Kernel 3: the legacy pair-HMM backward pass over the reversed
// sequences from a precomputed emission lattice, one thread block per
// pair; it writes the reversed backward M lattice RB_M (B, Lx, Ly).
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_bwd_kernel (kk=None,
// launched by _bwd_pallas): the emissions path's legacy route beyond
// FUSED_MAX_LY, where _finish_posteriors combines RB_M with the forward
// M lattice of kernel 1E and the MEA row scan (kernel 4, mea_scores.cu)
// scores the posterior. reference: src/bwdflat3.cpp:10-190.
//
// Layout: lane v of row u holds RB(u, v) = Bwd(lx-u, ly-v), start-aligned
// as in the Pallas kernel, which reads the per-pair roll-flipped lattice
// e_rev[b, i, j] = e[b, lx-1-i, ly-1-j] (and x / y insert scores reversed
// the same way). Those are the same table entries, summed over the
// features in the same order, so this kernel reads e through reversed
// indices and e_rev never exists (4.8 GB at 8 pairs of 12288). Lanes
// v >= ly take LOG_ZERO emissions and insert scores: no lane v < ly
// depends on them (every dependence runs from lower lanes to higher),
// and _finish_posteriors reads only rows u < lx and lanes v < ly. Rows
// u >= lx are written as zeros. Step u > 0 is kernel B's backward step
// (pairhmm_bwd_post.cuh) without its padding lanes; each step writes
// shift_fill(M row, column-0 chain) as row u, as the Pallas kernel does.
//
// What bounds it on the H100: for the function itself, bytes. It reads
// the lattice's real cells and writes RB_M (2 x 4 bytes a cell; 8 pairs of
// ~9,000 x 9,000 real cells in 12288 x 12288 lattices: ~1.5 ms at 3.35
// TB/s), against ~138 f32 operations per real cell of the sequential
// recurrence (~1.3 ms at 67 TFLOP/s). As in kernels A and B, the
// association-preserving scan does several times those operations along
// a serial row chain, one block per pair: 8 pairs occupy 8 of the 132
// SMs. The state rows stay in registers (S = 6 segments a warp at
// Ly = 12288, which spills; ptxas's counts are printed by chip_smoke.py).
#include "pairhmm_common.cuh"

using namespace ph;

template <int S>
__global__ void __launch_bounds__(1024)
pairhmm_bwd_kernel(const float* __restrict__ e, const float* __restrict__ ins_x,
                   const float* __restrict__ ins_y, const int* __restrict__ lxb,
                   const int* __restrict__ lyb,
                   const float* __restrict__ params, int Lx, int Ly,
                   float* __restrict__ rbm) {
  extern __shared__ float smem[];
  const int nseg = Ly >> 6;
  const int W = blockDim.x >> 5;
  float* s_row = smem;
  float* s_edge_m = s_row + Ly;        // M state edge (nseg)
  float* s_edge_iy = s_edge_m + nseg;  // IY edge
  float* s_edge_jy = s_edge_iy + nseg; // JY edge
  float* s_tot = s_edge_jy + nseg;     // 4 * nseg
  float* s_carry = s_tot + 4 * nseg;   // 2 * nseg

  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, l = threadIdx.x & 31;
  const float tSM = params[TSM], tSI = params[TSI], tSJ = params[TSJ];
  const float tMM = params[TMM], tMI = params[TMI], tMJ = params[TMJ];
  const float tII = params[TII], tIM = params[TIM], tJJ = params[TJJ];
  const float tJM = params[TJM];
  const int lx = lxb[b], ly = lyb[b];
  const float* e_b = e + (size_t)b * Lx * Ly;
  const float* insx_b = ins_x + (size_t)b * Lx;
  const float* insy_b = ins_y + (size_t)b * Ly;
  float* rb_b = rbm + (size_t)b * Lx * Ly;

  // rows u >= lx are zero
  for (size_t k = (size_t)lx * Ly + 4 * threadIdx.x; k < (size_t)Lx * Ly;
       k += 4 * blockDim.x)
    *reinterpret_cast<float4*>(rb_b + k) = make_float4(0.f, 0.f, 0.f, 0.f);

  float insy[S][2], m[S][2], ix[S][2], iy[S][2], jx[S][2], jy[S][2];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int g = warp + s * W;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int v = g * 64 + 2 * l + e2;
      insy[s][e2] = (g < nseg && v < ly) ? insy_b[ly - 1 - v] : LOG_ZERO;
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
        m[s][e2] = log_add(__fadd_rn(__fadd_rn(tMI, shi[e2]), insy[s][e2]),
                           __fadd_rn(__fadd_rn(tMJ, shj[e2]), insy[s][e2]));
        ix[s][e2] = LOG_ZERO;
        jx[s][e2] = LOG_ZERO;
      }
      if (l == 31) s_edge_m[g] = m[s][1];
    }
  }
  float ix0 = tSI, jx0 = tSJ, m0 = tSM;  // column-0 chains (v = 0)
  __syncthreads();

  for (int u = 0; u < lx; ++u) {
    if (u > 0) {
      // emission row u-1 of the reversed lattice: x position lx-u
      const float* erow = e_b + (size_t)(lx - u) * Ly;
      const float insx = insx_b[lx - u];
      float nm[S][2], nix[S][2], njx[S][2];
      float aI[S][2], cI[S][2], aJ[S][2], cJ[S][2];
      // (1) next-row terms, IX/JX, IY/JY segment scans
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int g = warp + s * W;
        if (g < nseg) {
          const float shm[2] = {left_of_even(m[s][1], m0, s_edge_m, g, l),
                                m[s][0]};
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int v = g * 64 + 2 * l + e2;
            const float er = v < ly ? erow[ly - 1 - v] : LOG_ZERO;
            nm[s][e2] = __fadd_rn(shm[e2], er);
            nix[s][e2] = __fadd_rn(ix[s][e2], insx);
            njx[s][e2] = __fadd_rn(jx[s][e2], insx);
            ix[s][e2] = log_add(__fadd_rn(tII, nix[s][e2]), __fadd_rn(tIM, nm[s][e2]));
            jx[s][e2] = log_add(__fadd_rn(tJJ, njx[s][e2]), __fadd_rn(tJM, nm[s][e2]));
            aI[s][e2] = __fadd_rn(insy[s][e2], tII);
            cI[s][e2] = __fadd_rn(tIM, nm[s][e2]);
            aJ[s][e2] = __fadd_rn(insy[s][e2], tJJ);
            cJ[s][e2] = __fadd_rn(tJM, nm[s][e2]);
          }
          seg_scan(aI[s], cI[s], l);
          seg_scan(aJ[s], cJ[s], l);
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
      const float m0n = log_add(__fadd_rn(__fadd_rn(tMI, ix0), insx),
                                __fadd_rn(__fadd_rn(tMJ, jx0), insx));
      __syncthreads();
      // (2) carry over the segments
      carry_chain(s_tot, s_carry, nseg);
      __syncthreads();
      // (3) IY/JY rows
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int g = warp + s * W;
        if (g < nseg) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            iy[s][e2] = log_add_p(__fadd_rn(s_carry[g], aI[s][e2]), cI[s][e2]);
            jy[s][e2] = log_add_p(__fadd_rn(s_carry[nseg + g], aJ[s][e2]), cJ[s][e2]);
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
          for (int e2 = 0; e2 < 2; ++e2) {
            const float niy = __fadd_rn(shi[e2], insy[s][e2]);
            const float njy = __fadd_rn(shj[e2], insy[s][e2]);
            m[s][e2] = log_add5(__fadd_rn(tMM, nm[s][e2]), __fadd_rn(tMI, nix[s][e2]),
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
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = warp + s * W;
      if (g < nseg) {
        const float lo = left_of_even(m[s][1], m0, s_edge_m, g, l);
        *reinterpret_cast<float2*>(rb_b + (size_t)u * Ly + g * 64 + 2 * l) =
            make_float2(lo, m[s][0]);
      }
    }
  }
}

template <int S>
static int launch(int W, size_t smem, int B, cudaStream_t st, const float* e,
                  const float* ins_x, const float* ins_y, const int* lxb,
                  const int* lyb, const float* params, int Lx, int Ly,
                  float* rbm) {
  const cudaError_t err = allow_smem(pairhmm_bwd_kernel<S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pairhmm_bwd_kernel<S><<<B, W * 32, smem, st>>>(e, ins_x, ins_y, lxb, lyb,
                                                 params, Lx, Ly, rbm);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pairhmm_bwd(const float* e, const float* ins_x,
                           const float* ins_y, const int* lxb, const int* lyb,
                           const float* params, int B, int Lx, int Ly,
                           float* rbm, void* stream) {
  const Geometry geo = geometry(Ly, 0, 9);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (geo.S) {
    case 1:
      return launch<1>(geo.W, geo.smem, B, st, e, ins_x, ins_y, lxb, lyb,
                       params, Lx, Ly, rbm);
    case 2:
      return launch<2>(geo.W, geo.smem, B, st, e, ins_x, ins_y, lxb, lyb,
                       params, Lx, Ly, rbm);
    case 3:
      return launch<3>(geo.W, geo.smem, B, st, e, ins_x, ins_y, lxb, lyb,
                       params, Lx, Ly, rbm);
    case 4:
      return launch<4>(geo.W, geo.smem, B, st, e, ins_x, ins_y, lxb, lyb,
                       params, Lx, Ly, rbm);
    case 5:
      return launch<5>(geo.W, geo.smem, B, st, e, ins_x, ins_y, lxb, lyb,
                       params, Lx, Ly, rbm);
    case 6:
      return launch<6>(geo.W, geo.smem, B, st, e, ins_x, ins_y, lxb, lyb,
                       params, Lx, Ly, rbm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
