// Kernel sw_scores: local affine Smith-Waterman scores of a batch of
// pairs.
//
// Replaces muscle_tpu/ops/sw.py::sw_scores_batch, an XLA scan over the
// rows of A in the JAX package (lax.scan of _sw_score_one under vmap),
// which Super7's default guide tree and -swdistmx run on all pairs
// (reference: src/sw.cpp, src/swdistmx.cpp). For each pair b, with
// H = 0 and F = -inf before row 0, each row r < lx:
//   F = max(F + ext, H + open + ext);
//   Z = max(max(diag + subst[x_r, y_j], F), 0), diag = [0, H[j-1]],
//       Z = 0 at columns j >= ly;
//   E = scan([-inf, (Z + open + ext)[:-1]]), the max-plus scan with
//       decay ext (csrc/dp_rows.cuh, the JAX rounds);
//   H = max(max(Z, E masked to 0 at j >= ly), 0); best = max(best, H).
// The JAX scan also runs the rows r >= lx and the columns j >= ly, where
// H = 0: they cannot raise the maximum, and a column reads only columns
// to its left, so the kernel runs lx rows of min(ly, BY) columns. Its
// plain version is muscle_tpu_torch/ops/sw.py::sw_scores_plain, the same
// adds and maxes in the same order (max is exact, so the reduction's
// order plays no part): the scores agree bit for bit.
//
// What bounds it on the H100: the row's chain, as kernel nw_viterbi
// (csrc/nw_viterbi.cu): it reads the codes and writes B floats; a row is
// ceil(log2(ly)) dependent scan rounds after the F/Z update. The design
// is nw_viterbi's (csrc/dp_rows.cuh): a team of warps a pair, a lane C
// contiguous columns of H and F in registers, the rounds in registers
// and shuffles; each warp's maximum goes to the score by an atomic max
// on the float's bits (the scores are >= +0, so their bit patterns order
// as the floats do).
#include "dp_rows.cuh"

namespace {

constexpr float kOpen = -11.0f;  // ops/sw.py DEFAULT_SW_OPEN
constexpr float kExt = -1.0f;    // ops/sw.py DEFAULT_SW_EXT

// The rest of a row in a team of several warps, after F and Z
// (but its column 0): every warp publishes its H (the last row's) and
// F, then builds the shadow (the warp below's Z and scan input, from its
// H and F and two columns of the warp below that), sets Z[0] and the
// scan input (in v) from the lane below or the shadow's lane 31, and
// runs block_scan: one barrier for the exchange, none for the rounds
// k < 32C.
template <int C, dp::Mode M>
__device__ __forceinline__ void team_row(
    dp::Team<C, M>& tm, const float (&h)[C],
    const float (&f)[C], float (&z)[C], float (&v)[C], float (&sv)[C],
    const float (&e)[C], const float* srow,
    const uint32_t (&ysh)[(C + 3) / 4], int ypp, int h0) {
  const int lane = tm.lane, j0 = tm.j0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    tm.xput(0, j0 + c, h[c]);
    tm.xput(1, j0 + c, f[c]);
  }
  tm.sync();
  float sh[C], sf[C], esh[C];  // the shadow's H, F, subst[x_r, y_h]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sh[c] = tm.xget(0, max(h0 + c, 0));
    sf[c] = tm.xget(1, max(h0 + c, 0));
    esh[c] = srow[dp::code<C>(ysh, c)];
  }
  const float hp1 = tm.xget(0, max(h0 - 1, 0));
  const float hp2 = tm.xget(0, max(h0 - 2, 0));
  const float fp1 = tm.xget(1, max(h0 - 1, 0));
  const float epp = srow[ypp];
  const bool up = lane > 0;
  // Z[0] from H one column to the left
  const float h_up = __shfl_up_sync(dp::kAll, h[C - 1], 1);
  const float h_top = __shfl_sync(dp::kAll, sh[C - 1], dp::kWarp - 1);
  z[0] = fmaxf(fmaxf((j0 == 0 ? 0.0f : (up ? h_up : h_top)) + e[0], f[0]),
               0.0f);
  // the shadow's Z (its column h0 - 1's from the warp below that)
  float sz[C];
#pragma unroll
  for (int c = C - 1; c >= 1; --c)
    sz[c] = fmaxf(fmaxf(sh[c - 1] + esh[c], sf[c]), 0.0f);
  const float sh_up = __shfl_up_sync(dp::kAll, sh[C - 1], 1);
  sz[0] = fmaxf(fmaxf((h0 == 0 ? 0.0f : (up ? sh_up : hp1)) + esh[0], sf[0]),
                0.0f);
  const float zpp = fmaxf(fmaxf(hp2 + epp, fp1), 0.0f);
  // the scan inputs, own and shadow: Z + open + ext one column to the left
  const float z_up = __shfl_up_sync(dp::kAll, z[C - 1], 1);
  const float z_top = __shfl_sync(dp::kAll, sz[C - 1], dp::kWarp - 1);
  const float sz_up = __shfl_up_sync(dp::kAll, sz[C - 1], 1);
#pragma unroll
  for (int c = C - 1; c >= 1; --c) {
    v[c] = z[c - 1] + kOpen + kExt;
    sv[c] = sz[c - 1] + kOpen + kExt;
  }
  v[0] = j0 == 0 ? dp::neg_inf() : (up ? z_up : z_top) + kOpen + kExt;
  sv[0] = h0 == 0 ? dp::neg_inf() : (up ? sz_up : zpp) + kOpen + kExt;
  dp::team_scan(v, sv, tm, kExt);
}

template <int C, dp::Mode M>
__global__ void __launch_bounds__(dp::max_threads(M))
    sw_scores_kernel(const int* __restrict__ xb, const int* __restrict__ yb,
                     const int* __restrict__ lxb, const int* __restrict__ lyb,
                     const float* __restrict__ subst, int K1, int BX, int BY,
                     int blocks, float* __restrict__ scores) {
  extern __shared__ __align__(16) float smem[];
  const int b = static_cast<int>(blockIdx.x) / blocks;
  const int lx = min(lxb[b], BX), width = min(lyb[b], BY);
  if (lx <= 0 || width <= 0) return;  // the whole team: score 0
  float* sub = smem;
  float* edge = smem + dp::table_floats(K1);
  for (int t = threadIdx.x; t < K1 * K1; t += blockDim.x) sub[t] = subst[t];
  __syncthreads();
  dp::Team<C, M> tm;
  if (!dp::join_team(tm, width, edge)) return;
  const int j0 = tm.j0;
  constexpr int kSpan = dp::Team<C, M>::kSpan;
  const int h0 = j0 - kSpan;  // several warps: the shadow's first column
  const bool shadow = M != dp::Mode::kWarp && tm.multi;

  const int* y = yb + static_cast<size_t>(b) * BY;
  uint32_t yc[(C + 3) / 4];   // the code of column j
  uint32_t ysh[(C + 3) / 4];  // several warps: the shadow's, and y_{h0-1}
  int ypp = 0;
#pragma unroll
  for (int q = 0; q < (C + 3) / 4; ++q) yc[q] = ysh[q] = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    if (j < width)
      yc[c >> 2] |= static_cast<uint32_t>(dp::clamp_code(y[j], K1))
                    << (8 * (c & 3));
    if (shadow && h0 + c >= 0)
      ysh[c >> 2] |= static_cast<uint32_t>(dp::clamp_code(y[h0 + c], K1))
                     << (8 * (c & 3));
  }
  if (shadow && h0 >= 1) ypp = dp::clamp_code(y[h0 - 1], K1);

  float h[C], f[C], z[C], v[C];
  float sv[C];  // several warps: the shadow's scan values
  float best = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    h[c] = 0.0f;
    f[c] = dp::neg_inf();
  }
  const int* x = xb + static_cast<size_t>(b) * BX;
  int xn = x[0];
  for (int r = 0; r < lx; ++r) {
    const float* srow = sub + dp::clamp_code(xn, K1) * K1;
    if (r + 1 < lx) xn = x[r + 1];
    float e[C];  // subst[x_r, y_j], in flight while F is updated
#pragma unroll
    for (int c = 0; c < C; ++c) e[c] = srow[dp::code<C>(yc, c)];
#pragma unroll
    for (int c = 0; c < C; ++c) f[c] = fmaxf(f[c] + kExt, h[c] + kOpen + kExt);
#pragma unroll
    for (int c = C - 1; c >= 1; --c)
      z[c] = fmaxf(fmaxf(h[c - 1] + e[c], f[c]), 0.0f);
    bool done = false;
    if constexpr (M != dp::Mode::kWarp) {
      if (shadow) {
        team_row(tm, h, f, z, v, sv, e, srow, ysh, ypp, h0);
        done = true;
      }
    }
    if (!done) {
      float h_left, z_left;
      tm.from_left(h[C - 1], z[C - 1], h_left, z_left);
      z[0] = fmaxf(fmaxf((j0 == 0 ? 0.0f : h_left) + e[0], f[0]), 0.0f);
      // E = scan of Z + open + ext one column to the left
#pragma unroll
      for (int c = C - 1; c >= 1; --c) v[c] = z[c - 1] + kOpen + kExt;
      v[0] = j0 == 0 ? dp::neg_inf() : z_left + kOpen + kExt;
      dp::maxplus_scan(v, tm, kExt);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float hn = fmaxf(fmaxf(z[c], v[c]), 0.0f);
      h[c] = hn;
      best = j0 + c < width ? fmaxf(best, hn) : best;
    }
  }

  for (int o = 16; o > 0; o >>= 1)
    best = fmaxf(best, __shfl_xor_sync(dp::kAll, best, o));
  if (tm.lane == 0)
    atomicMax(reinterpret_cast<int*>(scores) + b, __float_as_int(best));
  // no block leaves while another may still read its edge buffer
  if constexpr (M == dp::Mode::kCluster) dp::cluster_sync();
}

struct Launch {
  const int *xb, *yb, *lxb, *lyb;
  const float* subst;
  int K1, B, BX, BY;
  float* scores;
  cudaStream_t st;

  template <int C, dp::Mode M>
  cudaError_t run(const dp::Geometry& g) const {
    return dp::launch(sw_scores_kernel<C, M>, g, B,
                      dp::smem_bytes(g, K1), st, xb, yb, lxb, lyb, subst,
                      K1, BX, BY, g.blocks, scores);
  }
};

}  // namespace

// xb (B, BX), yb (B, BY) int32 codes, lxb/lyb (B,) int32 lengths, subst
// (K1, K1) f32; scores (B,) f32, zeroed by the caller (each team raises
// its pair's score to its maximum).
extern "C" int sw_scores(const int* xb, const int* yb, const int* lxb,
                         const int* lyb, const float* subst, int K1, int B,
                         int BX, int BY, float* scores, void* stream) {
  if (B < 1 || BX < 1 || BY < 1 || K1 < 1 || K1 > dp::kMaxAlpha)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l{xb, yb, lxb, lyb, subst, K1, B, BX, BY, scores,
           static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dp::dispatch(BY, l));
}

extern "C" const char* sw_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
