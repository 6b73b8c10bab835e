// Kernel 4: the MEA score of each pair's posterior by a row scan, one
// thread block per pair.
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_mea_kernel (launched by
// mea_scores_pallas): the last step of the emissions path's legacy route
// (ops/pairhmm_emis_cuda.py), after _finish_posteriors. reference:
// src/calcalnscoreflat.cpp:4-32.
//
// Per row i: e_j = max(old_{j-1} + p_ij, old_j) (old_{-1} = 0), then the
// new row is the inclusive prefix max of max(e, 0) over j. The score is
// the last lane after the last row. The posterior is zero outside
// (lx, ly), so rows past lx leave the row unchanged (old is
// non-decreasing) and the block stops at row lx; every value is an add
// and maxes, exact in any order, so kernel and plain version agree bit
// for bit. Lanes: thread t owns C consecutive lanes (C = 4 * units, one
// float4 a unit); the prefix max runs in registers, then across the warp
// with shuffles, then across the warps through shared memory. Two block
// barriers a row.
//
// What bounds it on the H100: bytes. It reads each real posterior cell
// once (4 bytes, 2-4 operations); one block per pair streams its rows
// serially, so 8 pairs use 8 of the 132 SMs.
#include <cuda_runtime.h>

constexpr int MAX_UNITS = 4;  // float4 units a thread: Ly <= 16384

template <int UNITS>
__global__ void __launch_bounds__(1024)
mea_scores_kernel(const float* __restrict__ post, const int* __restrict__ lxb,
                  int Lx, int Ly, float* __restrict__ out) {
  __shared__ float s_last[1024];  // each thread's last lane of the row
  __shared__ float s_warp[32];    // each warp's row maximum
  const int b = blockIdx.x;
  const int t = threadIdx.x, warp = t >> 5, l = t & 31;
  const int nwarp = blockDim.x >> 5;
  const int lane0 = t * 4 * UNITS;
  const float* p_b = post + (size_t)b * Lx * Ly;
  const int lx = lxb[b];

  float old[4 * UNITS];
#pragma unroll
  for (int k = 0; k < 4 * UNITS; ++k) old[k] = 0.0f;
  s_last[t] = 0.0f;
  __syncthreads();

  for (int i = 0; i < lx; ++i) {
    float v[4 * UNITS];
    const float4* row =
        reinterpret_cast<const float4*>(p_b + (size_t)i * Ly + lane0);
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const float4 q = lane0 + 4 * u < Ly ? row[u]
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * u] = q.x;
      v[4 * u + 1] = q.y;
      v[4 * u + 2] = q.z;
      v[4 * u + 3] = q.w;
    }
    // e_j = max(old_{j-1} + p_j, old_j, 0), then the thread's prefix max
    float left = t == 0 ? 0.0f : s_last[t - 1];
    float run = 0.0f;
#pragma unroll
    for (int k = 0; k < 4 * UNITS; ++k) {
      const float ek = fmaxf(fmaxf(__fadd_rn(left, v[k]), old[k]), 0.0f);
      left = old[k];
      run = fmaxf(run, ek);
      v[k] = run;
    }
    // inclusive prefix max of the thread maxima across the warp, then
    // across the warps
    float inc = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, inc, d);
      if (l >= d) inc = fmaxf(inc, up);
    }
    float before = __shfl_up_sync(0xffffffffu, inc, 1);
    if (l == 0) before = 0.0f;
    if (l == 31) s_warp[warp] = inc;
    __syncthreads();
    for (int w = 0; w < warp; ++w) before = fmaxf(before, s_warp[w]);
#pragma unroll
    for (int k = 0; k < 4 * UNITS; ++k) old[k] = fmaxf(v[k], before);
    s_last[t] = old[4 * UNITS - 1];
    __syncthreads();
  }
  if (t == nwarp * 32 - 1) out[b] = old[4 * UNITS - 1];
}

template <int UNITS>
static int launch(int threads, int B, cudaStream_t st, const float* post,
                  const int* lxb, int Lx, int Ly, float* out) {
  mea_scores_kernel<UNITS><<<B, threads, 0, st>>>(post, lxb, Lx, Ly, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mea_scores(const float* post, const int* lxb, int B, int Lx,
                          int Ly, float* out, void* stream) {
  // Ly % 128 == 0: Ly / 4 float4 units over at most 1024 threads in
  // whole warps, `units` each; lanes past Ly read as zeros, which change
  // no maximum (they carry the row's maximum along)
  const int units = (Ly / 4 + 1023) / 1024;
  if (Ly % 128 || units > MAX_UNITS || Lx < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int busy = (Ly / 4 + units - 1) / units;  // threads with lanes
  const int threads = (busy + 31) / 32 * 32;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (units) {
    case 1:
      return launch<1>(threads, B, st, post, lxb, Lx, Ly, out);
    case 2:
      return launch<2>(threads, B, st, post, lxb, Lx, Ly, out);
    case 3:
      return launch<3>(threads, B, st, post, lxb, Lx, Ly, out);
    case 4:
      return launch<4>(threads, B, st, post, lxb, Lx, Ly, out);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* mea_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
