// One block a pair, the threads over one DP row's columns: the layout
// that kernels nw_viterbi (csrc/nw_viterbi.cu) and sw_scores
// (csrc/sw_scores.cu) share, and the row's max-plus gap scan.
//
// A row of W lanes is held by T threads of C columns each (column
// c * T + t of thread t, so that a warp's stores of one c are
// neighbouring bytes or words): C = 1 up to 1024 lanes, else
// ceil(W / 1024); T = ceil(W / C) rounded up to a warp. C is a template
// argument (each thread keeps its columns' DP state in registers), up
// to kMaxCols; ops/dp_cuda.geometry mirrors this.
//
// The gap scan is the JAX package's Hillis-Steele max-plus scan
// (muscle_tpu/ops/sw.py::_maxplus_scan): round k = 1, 2, 4, ... < W
// takes u'[j] = max(u[j], u[j-k] + k*decay) for j >= k and keeps u[j]
// below k. Each round reads the last round's values, so the rounds go
// through two buffers in shared memory with a barrier between them; the
// adds and maxes are the JAX rounds' own, in their order, so the result
// is bit for bit the plain version's (a running scan gives the same
// maxima but may round a sum differently).
#pragma once

#include <cuda_runtime.h>

namespace dp {

constexpr int kMaxThreads = 1024;
constexpr int kMaxCols = 20;
constexpr int kMaxAlpha = 32;

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

__device__ __forceinline__ int clamp_code(int c, int k1) {
  return c < 0 ? 0 : (c >= k1 ? k1 - 1 : c);
}

// The scan of the W values in src (written by the block before a
// barrier); dst is the second buffer. Returns the buffer holding the
// result; every thread has passed a barrier after the last round.
template <int C>
__device__ __forceinline__ float* maxplus_scan(float* src, float* dst, int W,
                                               float decay) {
  const int T = blockDim.x;
  for (int k = 1; k < W; k *= 2) {
    const float kd = static_cast<float>(k) * decay;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * T + static_cast<int>(threadIdx.x);
      if (j < W) {
        float u = src[j];
        if (j >= k) u = fmaxf(u, src[j - k] + kd);
        dst[j] = u;
      }
    }
    __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// (threads, columns a thread) of a row of W lanes.
inline void geometry(int W, int* threads, int* cols) {
  int c = (W + kMaxThreads - 1) / kMaxThreads;
  if (c < 1) c = 1;
  const int t = (W + c - 1) / c;
  *threads = (t + 31) / 32 * 32;
  *cols = c;
}

// Calls launch.template run<C>() for the C of the row, C in
// 1..kMaxCols; returns cudaErrorInvalidValue beyond.
template <class Launch>
inline cudaError_t dispatch_cols(int C, Launch&& launch) {
  switch (C) {
#define DP_COLS_CASE(n) \
  case n:               \
    return launch.template run<n>();
    DP_COLS_CASE(1) DP_COLS_CASE(2) DP_COLS_CASE(3) DP_COLS_CASE(4)
    DP_COLS_CASE(5) DP_COLS_CASE(6) DP_COLS_CASE(7) DP_COLS_CASE(8)
    DP_COLS_CASE(9) DP_COLS_CASE(10) DP_COLS_CASE(11) DP_COLS_CASE(12)
    DP_COLS_CASE(13) DP_COLS_CASE(14) DP_COLS_CASE(15) DP_COLS_CASE(16)
    DP_COLS_CASE(17) DP_COLS_CASE(18) DP_COLS_CASE(19) DP_COLS_CASE(20)
#undef DP_COLS_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace dp
