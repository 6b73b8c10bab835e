// Kernel nw_viterbi: global affine Needleman-Wunsch (Viterbi) of a
// batch of pairs, the trace bits of every row and the M/D/I row at each
// pair's length.
//
// Replaces muscle_tpu/ops/nw.py::nw_viterbi_batch, an XLA scan over the
// rows of A in the JAX package (lax.scan of _nw_one under vmap), which
// every ML protein distance of Super6 / UClustPD / -protdists runs
// (reference: src/viterbifastmem.cpp). For each pair b (one block):
//   row 0:  M = (0, NEG, ...), D = NEG, I = [NEG, scan(M + open)[:-1]];
//   row r < BX: bits[b, r, :] = the trace bits of (M, D, I) (M before
//     D by strict >, then I by strict >; gap open before extend by >=);
//     (M, D, I) captured into final[b] when r == lx;
//     best = max(max(M, D), I);
//     M' = [NEG, best[j-1] + subst[x_r, y_{j-1}]];
//     D' = max(M + open, D + ext);
//     I' = [NEG, scan(M' + open)[:-1]], scan the max-plus scan with decay
//     ext (csrc/dp_rows.cuh, the JAX rounds);
//   after the last row, captured if lx == BX; score = max(max(M, D), I)
//   of the captured row at column ly.
// Its plain version is muscle_tpu_torch/ops/nw.py::nw_viterbi_plain,
// the same adds and maxes in the same order: bits, final rows and scores
// agree bit for bit (ptxas contraction is off, -fmad=false).
//
// What bounds it on the H100: neither bytes nor operations but the
// row's chain. It writes B * BX * (BY+1) bytes of bits (9.5 MB for a
// batch of 64 pairs at 384) and does ~10 + 3 * ceil(log2(BY+1))
// operations a cell; a row costs two barriers and one a scan round
// (11 at 385 lanes), and the rows follow one another. The design is the
// simple one: a block a pair with its row in registers (each thread its
// columns' M, D, I), the table (at most 32 x 32) and the scan's two
// buffers in shared memory, the bits stored a byte a thread with a
// warp's bytes neighbouring. It runs at most B blocks, one a pair.
#include <stdint.h>

#include "dp_rows.cuh"

namespace {

constexpr float kOpen = -3.0f;  // ops/nw.py VITERBI_GAP_OPEN
constexpr float kExt = -0.5f;   // ops/nw.py VITERBI_GAP_EXT
constexpr float kNeg = -1e30f;  // ops/nw.py NEG
constexpr unsigned kDM = 0x01, kIM = 0x02, kMD = 0x04, kMI = 0x08;

__device__ __forceinline__ uint8_t row_bits(float m, float d, float i) {
  unsigned b = i > fmaxf(m, d) ? kIM : (d > m ? kDM : 0u);
  if (m + kOpen >= d + kExt) b |= kMD;
  if (m + kOpen >= i + kExt) b |= kMI;
  return static_cast<uint8_t>(b);
}

template <int C>
__global__ void __launch_bounds__(dp::kMaxThreads)
    nw_viterbi_kernel(const int* __restrict__ xb, const int* __restrict__ yb,
                      const int* __restrict__ lxb,
                      const int* __restrict__ lyb,
                      const float* __restrict__ subst, int K1, int BX,
                      int BY, uint8_t* __restrict__ bits,
                      float* __restrict__ final_rows,
                      float* __restrict__ scores) {
  extern __shared__ float smem[];
  const int W = BY + 1;
  float* buf0 = smem;
  float* buf1 = smem + W;
  float* sub = smem + 2 * W;
  const int T = blockDim.x, tid = threadIdx.x;
  const int b = blockIdx.x;
  const int lx = lxb[b], ly = lyb[b];
  const int* x = xb + static_cast<size_t>(b) * BX;
  const int* y = yb + static_cast<size_t>(b) * BY;
  uint8_t* brow = bits + static_cast<size_t>(b) * BX * W;
  float* fin = final_rows + static_cast<size_t>(b) * 3 * W;
  for (int t = tid; t < K1 * K1; t += T) sub[t] = subst[t];

  float m[C], d[C], iv[C];
  int yc[C];  // the code of column j - 1 (column j >= 1)
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * T + tid;
    yc[c] = (j >= 1 && j < W) ? dp::clamp_code(y[j - 1], K1) : 0;
    m[c] = j == 0 ? 0.0f : kNeg;
    d[c] = kNeg;
    if (j < W) buf0[j] = m[c] + kOpen;
  }
  __syncthreads();
  float* u = dp::maxplus_scan<C>(buf0, buf1, W, kExt);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = c * T + tid;
    iv[c] = (j >= 1 && j < W) ? u[j - 1] : kNeg;
  }

  auto capture = [&]() {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * T + tid;
      if (j < W) {
        fin[j] = m[c];
        fin[W + j] = d[c];
        fin[2 * W + j] = iv[c];
        if (j == ly) scores[b] = fmaxf(fmaxf(m[c], d[c]), iv[c]);
      }
    }
  };

  for (int r = 0; r < BX; ++r) {
    // the buffer the scan's result is not in takes best; the other the
    // scan's input (its readers passed the barrier after best)
    float* pb = u == buf0 ? buf1 : buf0;
    float* qb = u;
    const float* srow = sub + dp::clamp_code(x[r], K1) * K1;
    if (r == lx) capture();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * T + tid;
      if (j < W) {
        brow[static_cast<size_t>(r) * W + j] = row_bits(m[c], d[c], iv[c]);
        pb[j] = fmaxf(fmaxf(m[c], d[c]), iv[c]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * T + tid;
      if (j < W) {
        const float mn = j >= 1 ? pb[j - 1] + srow[yc[c]] : kNeg;
        d[c] = fmaxf(m[c] + kOpen, d[c] + kExt);
        m[c] = mn;
        qb[j] = mn + kOpen;
      }
    }
    __syncthreads();
    u = dp::maxplus_scan<C>(qb, pb, W, kExt);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * T + tid;
      iv[c] = (j >= 1 && j < W) ? u[j - 1] : kNeg;
    }
  }
  if (lx == BX) capture();
}

struct Launch {
  const int *xb, *yb, *lxb, *lyb;
  const float* subst;
  int K1, B, BX, BY;
  uint8_t* bits;
  float *final_rows, *scores;
  cudaStream_t st;
  int threads;

  template <int C>
  cudaError_t run() const {
    const size_t smem =
        (2 * static_cast<size_t>(BY + 1) + static_cast<size_t>(K1) * K1) *
        sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(
        nw_viterbi_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    nw_viterbi_kernel<C><<<B, threads, smem, st>>>(
        xb, yb, lxb, lyb, subst, K1, BX, BY, bits, final_rows, scores);
    return cudaGetLastError();
  }
};

}  // namespace

// xb (B, BX), yb (B, BY) int32 codes, lxb/lyb (B,) int32 lengths, subst
// (K1, K1) f32; bits (B, BX, BY+1) uint8, final_rows (B, 3, BY+1) f32
// and scores (B,) f32 (zeroed by the caller: a pair with lx > BX or
// ly > BY keeps zeros, as the plain version's).
extern "C" int nw_viterbi(const int* xb, const int* yb, const int* lxb,
                          const int* lyb, const float* subst, int K1, int B,
                          int BX, int BY, uint8_t* bits, float* final_rows,
                          float* scores, void* stream) {
  if (B < 1 || BX < 1 || BY < 0 || K1 < 1 || K1 > dp::kMaxAlpha)
    return static_cast<int>(cudaErrorInvalidValue);
  int threads, cols;
  dp::geometry(BY + 1, &threads, &cols);
  Launch l{xb, yb, lxb, lyb, subst, K1, B, BX, BY, bits, final_rows, scores,
           static_cast<cudaStream_t>(stream), threads};
  return static_cast<int>(dp::dispatch_cols(cols, l));
}

extern "C" const char* nw_viterbi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
