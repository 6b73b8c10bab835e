// Kernel sw_scores: local affine Smith-Waterman scores of a batch of
// pairs.
//
// Replaces muscle_tpu/ops/sw.py::sw_scores_batch, an XLA scan over the
// rows of A in the JAX package (lax.scan of _sw_score_one under vmap),
// which Super7's default guide tree and -swdistmx run on all pairs
// (reference: src/sw.cpp, src/swdistmx.cpp). For each pair b (one
// block), with H = 0 and F = -inf before row 0, each row r < lx:
//   F = max(F + ext, H + open + ext);
//   Z = max(max(diag + subst[x_r, y_j], F), 0), diag = [0, H[j-1]],
//       Z = 0 at columns j >= ly;
//   E = scan([-inf, (Z + open + ext)[:-1]]), the max-plus scan with
//       decay ext (csrc/dp_rows.cuh, the JAX rounds);
//   H = max(max(Z, E masked to 0 at j >= ly), 0); best = max(best, H).
// The JAX scan also runs the rows r >= lx, where Z and E are masked to
// 0 and so H = 0: they cannot raise the maximum, and the kernel stops at
// lx. Its plain version is muscle_tpu_torch/ops/sw.py::sw_scores_plain,
// the same adds and maxes in the same order (max is exact, so the
// block's reduction order plays no part): the scores agree bit for bit.
//
// What bounds it on the H100: the row's chain, as kernel nw_viterbi
// (csrc/nw_viterbi.cu): it reads the codes and writes B floats, ~12 +
// 3 * ceil(log2(BY)) operations a cell; a row costs two barriers and
// one a scan round. The simple design: a block a pair, each thread its
// columns' H and F in registers, the table and two row buffers in
// shared memory (the previous row's H and the scan's two rounds'
// buffers rotate through them), so rows up to 20480 lanes fit.
#include "dp_rows.cuh"

namespace {

constexpr float kOpen = -11.0f;  // ops/sw.py DEFAULT_SW_OPEN
constexpr float kExt = -1.0f;    // ops/sw.py DEFAULT_SW_EXT

template <int C>
__global__ void __launch_bounds__(dp::kMaxThreads)
    sw_scores_kernel(const int* __restrict__ xb, const int* __restrict__ yb,
                     const int* __restrict__ lxb, const int* __restrict__ lyb,
                     const float* __restrict__ subst, int K1, int BX, int BY,
                     float* __restrict__ scores) {
  extern __shared__ float smem[];
  const int W = BY;
  float* buf0 = smem;
  float* buf1 = smem + W;
  float* sub = smem + 2 * W;
  float* red = sub + K1 * K1;  // one a warp
  const int T = blockDim.x, tid = threadIdx.x;
  const int b = blockIdx.x;
  const int lx = lxb[b] < BX ? lxb[b] : BX, ly = lyb[b];
  const int* x = xb + static_cast<size_t>(b) * BX;
  const int* y = yb + static_cast<size_t>(b) * BY;
  for (int t = tid; t < K1 * K1; t += T) sub[t] = subst[t];

  float h[C], f[C], z[C];
  int yc[C];
  float best = 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * T + tid;
    yc[c] = j < W ? dp::clamp_code(y[j], K1) : 0;
    h[c] = 0.0f;
    f[c] = dp::neg_inf();
    if (j < W) buf0[j] = 0.0f;
  }
  __syncthreads();

  // hb holds the previous row's H, qb takes the scan's input; the scan's
  // result buffer takes the next input, the other one the new H (each
  // written after a barrier that its last readers passed)
  float* hb = buf0;
  float* qb = buf1;
  for (int r = 0; r < lx; ++r) {
    const float* srow = sub + dp::clamp_code(x[r], K1) * K1;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * T + tid;
      if (j < W) {
        const float diag = j >= 1 ? hb[j - 1] : 0.0f;
        f[c] = fmaxf(f[c] + kExt, h[c] + kOpen + kExt);
        float zz = fmaxf(fmaxf(diag + srow[yc[c]], f[c]), 0.0f);
        zz = j < ly ? zz : 0.0f;
        z[c] = zz;
        if (j + 1 < W) qb[j + 1] = zz + kOpen + kExt;
        if (j == 0) qb[0] = dp::neg_inf();
      }
    }
    __syncthreads();
    float* u = dp::maxplus_scan<C>(qb, hb, W, kExt);
    hb = u == buf0 ? buf1 : buf0;
    qb = u;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * T + tid;
      if (j < W) {
        float hn = fmaxf(z[c], j < ly ? u[j] : 0.0f);
        hn = fmaxf(hn, 0.0f);
        best = fmaxf(best, hn);
        h[c] = hn;
        hb[j] = hn;
      }
    }
    __syncthreads();
  }

  for (int o = 16; o > 0; o >>= 1)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
  if ((tid & 31) == 0) red[tid >> 5] = best;
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < (T + 31) / 32; ++w) best = fmaxf(best, red[w]);
    scores[b] = best;
  }
}

struct Launch {
  const int *xb, *yb, *lxb, *lyb;
  const float* subst;
  int K1, B, BX, BY;
  float* scores;
  cudaStream_t st;
  int threads;

  template <int C>
  cudaError_t run() const {
    const size_t smem = (2 * static_cast<size_t>(BY) +
                         static_cast<size_t>(K1) * K1 + 32) *
                        sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        sw_scores_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    sw_scores_kernel<C><<<B, threads, smem, st>>>(xb, yb, lxb, lyb, subst,
                                                  K1, BX, BY, scores);
    return cudaGetLastError();
  }
};

}  // namespace

// xb (B, BX), yb (B, BY) int32 codes, lxb/lyb (B,) int32 lengths, subst
// (K1, K1) f32; scores (B,) f32.
extern "C" int sw_scores(const int* xb, const int* yb, const int* lxb,
                         const int* lyb, const float* subst, int K1, int B,
                         int BX, int BY, float* scores, void* stream) {
  if (B < 1 || BX < 1 || BY < 1 || K1 < 1 || K1 > dp::kMaxAlpha)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads, cols;
  dp::geometry(BY, &threads, &cols);
  Launch l{xb, yb, lxb, lyb, subst, K1, B, BX, BY, scores,
           static_cast<cudaStream_t>(stream), threads};
  return static_cast<int>(dp::dispatch_cols(cols, l));
}

extern "C" const char* sw_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
