// Shared device code of the pair-HMM kernels (kernels A and B with their
// emission-lattice forms 1E and 2E, pairhmm_fwd*.cu and
// pairhmm_bwd_post*.cu; the legacy backward pairhmm_bwd.cu; the striped
// forms pairhmm_fwd_stripe.cu, pairhmm_bwd_stripe.cu): log-space
// arithmetic, the warp-level lane machinery and the emission sources.
//
// Lane layout. A block owns one pair; its Ly lanes (one DP column each)
// are cut into 64-lane segments, and warp w owns segments w, w + W, ...
// (S of them; W * S >= Ly / 64). Inside a segment, thread l owns the
// two adjacent lanes 2l and 2l+1, so the Hillis-Steele rounds of the
// segmented within-row scan run in registers with __shfl_up_sync, and
// only a one-lane shift across a segment edge goes through shared
// memory.
//
// Arithmetic. Products and sums are rounded separately (__fmul_rn /
// __fadd_rn, never contracted to FMA; the build also passes
// -fmad=false) and the sentinels stay IEEE (no fast math), so the
// kernels repeat the plain torch twins' and the TPU kernels' bits.
#pragma once

#include <cuda_runtime.h>

#define PH_FULL 0xffffffffu

namespace ph {

constexpr float LOG_ZERO = -2e20f;
constexpr float LOG_UNDERFLOW = 7.5f;
constexpr float NEG_BIG = -1e30f;
constexpr float MIN_SPARSE_SCORE = -4.605170185988091f;  // log(0.01)

// params layout (ops/pairhmm_cuda.py P_*)
enum { TSM, TSI, TSJ, TMM, TMI, TMJ, TII, TIM, TJJ, TJM };

// The params row of pair b: one (16,) vector shared by every pair
// (stride 0) or (B, 16) rows, one a pair (stride 16: the per-pair tables
// of the ensembles' replicate batching, muscle_tpu's
// _params_rows_multi). The kernels' prologue reads its ten scores.
__device__ __forceinline__ const float* pair_params(const float* params,
                                                    int stride, int b) {
  return params + (size_t)b * stride;
}

__device__ __forceinline__ float madd(float a, float x, float c) {
  return __fadd_rn(__fmul_rn(a, x), c);
}

// log(1 + e^x) on [0, 7.5]: the reference's 4-segment cubic
// (src/scoretype.h:100-109), coefficients selected first.
__device__ __forceinline__ float logexp1_sel(float x) {
  const bool s1 = x <= 1.0f, s2 = x <= 2.5f, s3 = x <= 4.5f;
  const float c0 = s2 ? (s1 ? -0.009350833524763f : -0.014532321752540f)
                      : (s3 ? -0.004605031767994f : -0.000458661602210f);
  const float c1 = s2 ? (s1 ? 0.130659527668286f : 0.139942324101744f)
                      : (s3 ? 0.063427417320019f : 0.009695946122598f);
  const float c2 = s2 ? (s1 ? 0.498799810682272f : 0.495635523139337f)
                      : (s3 ? 0.695956496475118f : 0.930734667215156f);
  const float c3 = s2 ? (s1 ? 0.693203116424741f : 0.692140569840976f)
                      : (s3 ? 0.514272634594009f : 0.168037164329057f);
  return madd(madd(madd(c0, x, c1), x, c2), x, c3);
}

// `p ? a : b`, always computed as a select. The LOG_ADD variants end in
// `small ? hi : lo + fit`; written as a plain ?:, the compiler makes
// each one a branch around the fit (a convergence region of its own), so
// independent LOG_ADDs of a thread cannot interleave and each fit's
// latency is exposed. With kBranchFree (the striped kernels 5/6) the fit
// runs on every lane and a PTX selp picks: the same operations, so the
// same bits.
__device__ __forceinline__ float select_f(bool p, float a, float b) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t"
      "selp.f32 %0, %1, %2, q;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<int>(p)));
  return r;
}

// The LOG_ADDs of kernels A/B (both schedules), 1M/2M, 1E/2E and 5/6 are
// selects: their rows are latency chains (a block alone on its SM runs
// a 512-lane row within 12-14 % of four sharing one, and selects cut
// kernel A's launch at 512 to 0.78x and a lone block's row to 0.6x on an
// H100 80GB HBM3 at 700 W; tools/torch_ab_probe.py --rung512).
constexpr bool kBF = true;

// LOG_ADD with the reference cubic (M/IX/JX updates, total prob).
template <bool kBranchFree = false>
__device__ __forceinline__ float log_add(float x, float y) {
  const float hi = fmaxf(x, y), lo = fminf(x, y);
  const float d = __fsub_rn(hi, lo);
  const bool small = (lo <= LOG_ZERO) || (d >= LOG_UNDERFLOW);
  const float dc = fminf(fmaxf(d, 0.0f), LOG_UNDERFLOW);
  if (kBranchFree) return select_f(small, hi, __fadd_rn(lo, logexp1_sel(dc)));
  return small ? hi : __fadd_rn(lo, logexp1_sel(dc));
}

template <bool kBranchFree = false>
__device__ __forceinline__ float log_add5(float a, float b, float c, float d,
                                          float e) {
  return log_add<kBranchFree>(
      a, log_add<kBranchFree>(
             b, log_add<kBranchFree>(c, log_add<kBranchFree>(d, e))));
}

// LOG_ADD with the selection-free degree-8 fit, used inside the
// within-row scans (muscle_tpu/ops/pairhmm_pallas.py _log_add_p).
template <bool kBranchFree = false>
__device__ __forceinline__ float log_add_p(float x, float y) {
  const float hi = fmaxf(x, y), lo = fminf(x, y);
  const float d = fminf(__fsub_rn(hi, lo), LOG_UNDERFLOW);
  const bool small = (lo <= LOG_ZERO) || (d >= LOG_UNDERFLOW);
  float r = -6.73338208e-07f;
  r = madd(r, d, 2.39144278e-05f);
  r = madd(r, d, -3.51821887e-04f);
  r = madd(r, d, 2.68814008e-03f);
  r = madd(r, d, -1.01874083e-02f);
  r = madd(r, d, 4.79808334e-03f);
  r = madd(r, d, 1.22831020e-01f);
  r = madd(r, d, 5.00330250e-01f);
  r = madd(r, d, 6.93143978e-01f);
  if (kBranchFree) return select_f(small, hi, __fadd_rn(lo, r));
  return small ? hi : __fadd_rn(lo, r);
}

// Hillis-Steele rounds k = 1..32 of the affine scan inside one 64-lane
// segment; (a[e], c[e]) are lanes 2l+e. Composition of lane j with
// lane j-k: (a_j + a_{j-k}, LOG_ADD_p(c_{j-k} + a_j, c_j)); lanes with
// no partner combine with (0, NEG_BIG) as in the Pallas kernel.
template <bool kBranchFree = false>
__device__ __forceinline__ void seg_scan(float a[2], float c[2], int l) {
  {
    const float a_up = __shfl_up_sync(PH_FULL, a[1], 1);
    const float c_up = __shfl_up_sync(PH_FULL, c[1], 1);
    const bool v0 = l >= 1;
    const float a_p0 = v0 ? a_up : 0.0f, c_p0 = v0 ? c_up : NEG_BIG;
    const float a_p1 = a[0], c_p1 = c[0];
    const float c0n = log_add_p<kBranchFree>(__fadd_rn(c_p0, a[0]), c[0]);
    const float c1n = log_add_p<kBranchFree>(__fadd_rn(c_p1, a[1]), c[1]);
    a[0] = __fadd_rn(a[0], a_p0);
    a[1] = __fadd_rn(a[1], a_p1);
    c[0] = c0n;
    c[1] = c1n;
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {  // k = 2d
    const float a_u0 = __shfl_up_sync(PH_FULL, a[0], d);
    const float a_u1 = __shfl_up_sync(PH_FULL, a[1], d);
    const float c_u0 = __shfl_up_sync(PH_FULL, c[0], d);
    const float c_u1 = __shfl_up_sync(PH_FULL, c[1], d);
    const bool v = l >= d;
    const float c0n =
        log_add_p<kBranchFree>(__fadd_rn(v ? c_u0 : NEG_BIG, a[0]), c[0]);
    const float c1n =
        log_add_p<kBranchFree>(__fadd_rn(v ? c_u1 : NEG_BIG, a[1]), c[1]);
    a[0] = __fadd_rn(a[0], v ? a_u0 : 0.0f);
    a[1] = __fadd_rn(a[1], v ? a_u1 : 0.0f);
    c[0] = c0n;
    c[1] = c1n;
  }
}

// Sequential carry chain over the segment totals of the IY (t = 0) and
// JY (t = 1) scans, run by threads 0 and 1: tot holds
// [a_IY | c_IY | a_JY | c_JY], each nseg long; carry[t * nseg + g] is
// the transform entering segment g (NEG_BIG for g = 0), for g < n (the
// segments that hold real columns).
template <bool kBranchFree = false>
__device__ __forceinline__ void carry_chain(const float* tot, float* carry,
                                            int nseg, int n) {
  const int t = threadIdx.x;
  if (t < 2) {
    const float* ta = tot + 2 * t * nseg;
    const float* tc = ta + nseg;
    float* car = carry + t * nseg;
    float cc = NEG_BIG;
    car[0] = cc;
    for (int g = 0; g + 1 < n; ++g) {
      cc = log_add_p<kBranchFree>(__fadd_rn(cc, ta[g]), tc[g]);
      car[g + 1] = cc;
    }
  }
}

// Value of lane j-1 for the even lane 2l of segment g: the odd lane of
// thread l-1, or the last lane of segment g-1 (edge[g-1]), or `fill`
// left of lane 0. Called by all 32 threads of the warp.
__device__ __forceinline__ float left_of_even(float odd, float fill,
                                              const float* edge, int g,
                                              int l) {
  const float up = __shfl_up_sync(PH_FULL, odd, 1);
  return l > 0 ? up : (g == 0 ? fill : edge[g - 1]);
}

// Full-width Hillis-Steele prefix sum through one shared row (the
// Pallas kernels' _cumsum_lanes): round k adds lane j-k (or 0.0).
template <int S>
__device__ __forceinline__ void block_cumsum(float v[S][2], float* row,
                                             int Ly, int nseg, int W,
                                             int warp, int l) {
  for (int k = 1; k < Ly; k <<= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = warp + s * W;
      if (g < nseg) {
        row[g * 64 + 2 * l] = v[s][0];
        row[g * 64 + 2 * l + 1] = v[s][1];
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int g = warp + s * W;
      if (g < nseg) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = g * 64 + 2 * l + e;
          v[s][e] = __fadd_rn(v[s][e], j >= k ? row[j - k] : 0.0f);
        }
      }
    }
    __syncthreads();
  }
}

// Emission sources. Kernels A and B read their emissions from a source
// that the block sets up once: each lane keeps a tag (the y letter, for
// letters), `row(i)` selects DP row i (x position i, 0-based) and sets
// its x insert score `insx`, `emit2(j, t, u)` gives the emissions of
// columns j and j + 1 of that row (tags t and u; j even), `emit1(j, t)`
// that of column j alone (the legacy backward, which reads columns in
// reverse), and `insy(j, t)` the y insert score of column j. The wave's
// forward body calls `prefetch(i, j)` for row i + 1 right after `row(i)`:
// a source that reads device memory a row may start row i + 1's loads
// there, off the row's dependent chain (LatticeAhead); the others do
// nothing. All sources give the same numbers for the same scores: fed
// the letter lattice match[x_i, y_j] with insert[x_i], insert[y_j], the
// lattice sources reproduce the letter source bit for bit.

// Letters: codes and the (K+1)^2 match / (K+1) insert tables, copied into
// shared memory (kernels A and B, and 3K). The tables are shared by every
// pair (strides 0) or stacked one a pair (match_stride (K+1)^2,
// ins_stride K+1: kernels 1M and 2M); the block of pair b copies its own,
// so the shared memory a block takes is the same.
struct CodeEmission {
  struct Args {
    const int* xb;
    const int* yb;
    const float* match;
    const float* insert;
    int kk;
    int match_stride;
    int ins_stride;
  };
  const int* xrow;
  const int* yrow;
  const float* s_match;
  const float* s_ins;
  const float* mrow;
  int kk;
  float insx;

  __host__ __device__ static int table_floats(const Args& a) {
    return a.kk * a.kk + a.kk;
  }
  __device__ CodeEmission(const Args& a, int b, int Lx, int Ly, float* smem)
      : xrow(a.xb + (size_t)b * Lx), yrow(a.yb + (size_t)b * Ly),
        s_match(smem), s_ins(smem + a.kk * a.kk), mrow(smem), kk(a.kk),
        insx(0.0f) {
    const float* match = a.match + (size_t)b * a.match_stride;
    const float* insert = a.insert + (size_t)b * a.ins_stride;
    for (int k = threadIdx.x; k < kk * kk; k += blockDim.x)
      smem[k] = match[k];
    for (int k = threadIdx.x; k < kk; k += blockDim.x)
      smem[kk * kk + k] = insert[k];
  }
  __device__ int tag(int j) const { return yrow[j]; }
  __device__ float insy(int, int t) const { return s_ins[t]; }
  __device__ void row(int i) {
    const int xc = xrow[i];
    insx = s_ins[xc];
    mrow = s_match + xc * kk;
  }
  __device__ float2 emit2(int, int t, int u) const {
    return make_float2(mrow[t], mrow[u]);
  }
  __device__ float emit1(int, int t) const { return mrow[t]; }
  __device__ void prefetch(int, int) {}
};

// A precomputed (B, Lx, Ly) f32 emission lattice with (B, Lx) x and
// (B, Ly) y insert scores (kernels 1E and 2E, Muscle-3D): one coalesced
// row of the pair's lattice per DP row, nothing in shared memory.
struct LatticeEmission {
  struct Args {
    const float* e;
    const float* ins_x;
    const float* ins_y;
  };
  const float* e_b;
  const float* insx_b;
  const float* insy_b;
  const float* erow;
  int Ly;
  float insx;

  __host__ __device__ static int table_floats(const Args&) { return 0; }
  __device__ LatticeEmission(const Args& a, int b, int Lx, int Ly_, float*)
      : e_b(a.e + (size_t)b * Lx * Ly_), insx_b(a.ins_x + (size_t)b * Lx),
        insy_b(a.ins_y + (size_t)b * Ly_), erow(e_b), Ly(Ly_), insx(0.0f) {}
  __device__ int tag(int) const { return 0; }
  __device__ float insy(int j, int) const { return insy_b[j]; }
  __device__ void row(int i) {
    insx = insx_b[i];
    erow = e_b + (size_t)i * Ly;
  }
  __device__ float2 emit2(int j, int, int) const {
    return *reinterpret_cast<const float2*>(erow + j);
  }
  __device__ float emit1(int j, int) const { return erow[j]; }
  __device__ void prefetch(int, int) {}
};

// The lattice read one DP row ahead (kernel 1E on the wave): the row's
// emissions do not depend on the DP, so `prefetch(i, j)` starts the loads
// of row i's lanes j, j + 1 and its x insert score into registers while
// row i - 1 runs, and `row(i)` takes them. Read at the row, as
// LatticeEmission reads it, each row's load latency sits on the row's
// dependent chain, between the fold and the M row. Measured at
// mega-long's chunk on an H100 80GB HBM3 at 700 W
// (tools/torch_fwd_densify_probe.py --variants): 32.0-32.6 ms, against
// 32.7-33.3 read at the row and 30.0-31.2 with no loads at all, so the
// loads cost the wave 2-7 %; what sets its row is the instruction
// throughput of SMs that hold ~3 of its blocks each (--diagnose).
struct LatticeAhead : LatticeEmission {
  float2 e_next, e_cur;
  float insx_next;

  __device__ LatticeAhead(const Args& a, int b, int Lx, int Ly_, float* sm)
      : LatticeEmission(a, b, Lx, Ly_, sm) {}
  __device__ void prefetch(int i, int j) {
    e_next = __ldg(reinterpret_cast<const float2*>(e_b + (size_t)i * Ly + j));
    insx_next = __ldg(insx_b + i);
  }
  __device__ void row(int) {
    e_cur = e_next;
    insx = insx_next;
  }
  __device__ float2 emit2(int, int, int) const { return e_cur; }
  // forward only: the base's erow is never set here
  float emit1(int, int) const = delete;
};

// Launch geometry shared by kernels A and B: S segments per warp, at
// most 32 warps (S = 5, 160 segments, at Ly = 10240).
struct Geometry {
  int nseg, S, W;
  size_t smem;
};

inline Geometry geometry(int Ly, int table_floats, int extra_rows_nseg) {
  Geometry g;
  g.nseg = Ly / 64;
  g.S = (g.nseg + 31) / 32;
  g.W = (g.nseg + g.S - 1) / g.S;
  g.smem = sizeof(float) *
           (size_t)(table_floats + Ly + extra_rows_nseg * g.nseg);
  return g;
}

// A kernel takes more than 48 KB of dynamic shared memory only when
// asked (kernel B's amino tables and rows pass it above Ly ~ 9.9k).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace ph

extern "C" const char* pairhmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
