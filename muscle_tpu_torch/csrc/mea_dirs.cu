// The MEA direction DP of the device refine joins, one thread block per
// join.
//
// Replaces muscle_tpu/pipeline/devjoin.py::_mea_dirs (an XLA lax.scan,
// not Pallas; in torch it would be a Python loop of ~10 launches per
// row). CalcAlnFlat semantics (reference: src/calcalnflat.cpp:6-46,
// src/best3.h): over the (cc1, cc2) column posterior, row by row,
//
//   b_j = old_j + post[i, j],  x_j = old_{j+1},
//   new = cummax([0, max(b, x)]),  y_j = new_j,
//   dir_j = B (0) if b >= x and b >= y, else X (1) if x >= y, else Y (2),
//
// emitting the 2-bit directions packed 16 to an int32 (column j in bits
// 2(j % 16) of word j / 16; bits past cc2 are 0) and the row-end score
// new_cc2 of every row. Max is exact and each cell has one add
// (__fadd_rn), so the kernel, its plain version
// (ops/devjoin_cuda.py::mea_dirs_plain) and the JAX scan agree bit for
// bit.
//
// What bounds it on the H100: neither bytes (cc1*cc2*4 read, 1/16 of
// that written: ~1 us for 768 x 768) nor operations, but the row chain:
// cc1 dependent rows, each a prefix max over cc2 columns. The design
// keeps the previous row in shared memory, gives each thread 16*WPT
// consecutive columns (a serial local max, then one warp-shuffle scan
// and one scan over the warp totals), and packs each thread's
// directions in registers: four block barriers per row, one block of
// at most 1024 threads.
#include <cuda_runtime.h>

namespace {

template <int WPT>
__global__ void __launch_bounds__(1024)
mea_dirs_kernel(const float* __restrict__ post, int cc1, int cc2,
                int* __restrict__ packed, float* __restrict__ scores) {
  constexpr int E = 16 * WPT;
  extern __shared__ float s_old[];  // blockDim.x * E + 1
  __shared__ float s_warp[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarp = blockDim.x >> 5;
  const int W = (cc2 + 15) >> 4;
  const int j0 = tid * E;
  for (int e = tid; e <= blockDim.x * E; e += blockDim.x) s_old[e] = 0.0f;
  __syncthreads();
  for (int i = 0; i < cc1; ++i) {
    const float* prow = post + (size_t)i * cc2;
    // pass 1: running max of e_j = max(b_j, x_j) over this thread's
    // columns
    float loc[E];
#pragma unroll
    for (int q = 0; q < E; ++q) {
      const int j = j0 + q;
      const float b = __fadd_rn(s_old[j], j < cc2 ? prow[j] : 0.0f);
      const float e = fmaxf(b, s_old[j + 1]);
      loc[q] = q == 0 ? e : fmaxf(loc[q - 1], e);
    }
    // exclusive prefix max over the threads before this one
    float incl = loc[E - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl = fmaxf(incl, up);
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      float w = lane < nwarp ? s_warp[lane] : 0.0f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w = fmaxf(w, up);
      }
      const float before = __shfl_up_sync(0xffffffffu, w, 1);
      if (lane < nwarp) s_warp[lane] = lane == 0 ? 0.0f : before;
    }
    __syncthreads();
    // pass 2: new_{j+1} = max(new_j0, running max), the directions
    const float prefix = fmaxf(fmaxf(0.0f, s_warp[warp]), excl);  // new_j0
    float y = prefix;
#pragma unroll
    for (int w = 0; w < WPT; ++w) {
      unsigned int bits = 0;
#pragma unroll
      for (int q16 = 0; q16 < 16; ++q16) {
        const int q = w * 16 + q16;
        const int j = j0 + q;
        const float b = __fadd_rn(s_old[j], j < cc2 ? prow[j] : 0.0f);
        const float x = s_old[j + 1];
        const float nw = fmaxf(prefix, loc[q]);  // new_{j+1}
        unsigned int d = (b >= x && b >= y) ? 0u : (x >= y ? 1u : 2u);
        if (j >= cc2) d = 0u;
        bits |= d << (2 * q16);
        loc[q] = nw;
        y = nw;
        if (j == cc2 - 1) scores[i] = nw;
      }
      const int word = (j0 >> 4) + w;
      if (word < W) packed[(size_t)i * W + word] = static_cast<int>(bits);
    }
    __syncthreads();  // every thread has read this row's s_old
#pragma unroll
    for (int q = 0; q < E; ++q) s_old[j0 + q + 1] = loc[q];
    __syncthreads();
  }
}

}  // namespace

template <int WPT>
static cudaError_t launch(const float* post, int cc1, int cc2, int threads,
                          int* packed, float* scores, cudaStream_t st) {
  const size_t smem = ((size_t)threads * 16 * WPT + 1) * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      mea_dirs_kernel<WPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  mea_dirs_kernel<WPT><<<1, threads, smem, st>>>(post, cc1, cc2, packed,
                                                  scores);
  return cudaGetLastError();
}

// post: (cc1, cc2) f32; packed: (cc1, ceil(cc2/16)) int32; scores:
// (cc1,) f32. `threads` (a multiple of 32, <= 1024) times 16 * wpt
// columns must cover cc2; wpt is 1, 2 or 4.
extern "C" int mea_dirs(const float* post, int cc1, int cc2, int threads,
                        int wpt, int* packed, float* scores, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  if (wpt == 1) e = launch<1>(post, cc1, cc2, threads, packed, scores, st);
  if (wpt == 2) e = launch<2>(post, cc1, cc2, threads, packed, scores, st);
  if (wpt == 4) e = launch<4>(post, cc1, cc2, threads, packed, scores, st);
  return static_cast<int>(e);
}

extern "C" const char* mea_dirs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
