// Kernel 8: densify a z-tile of the consistency matrix M into its row
// panel, one thread block per (l, l) slab.
//
// Replaces muscle_tpu/ops/sparse.py::_densify_kernel (densify_pallas),
// the fixed-K rows -> dense expansion that feeds the Gram-scheme
// consistency (muscle_tpu/ops/consistency.py::_densify_rowpanel). The
// panel holds, for the t sequences Z of a z-tile and the nb sequences B
// of the family, slab (a, b) = M[Z_a, B_b] at rows a*l.., columns b*l..
// of a (t*l, nb*l) matrix:
//   FLAG_STORE  the store row pids[a, b] densified (P_ZB, Z < B),
//   FLAG_TRANS  its transpose (P_BZ^T, Z > B),
//   FLAG_EYE    the identity (Z = B),
// written as f32 or rounded to bf16 (__float2bfloat16_rn, the round to
// nearest even of torch's .to(torch.bfloat16)).
//
// Every panel cell takes at most one value (column indices are unique
// within a store row), so the kernel and its plain version
// (ops/densify_cuda.py::densify_panel_plain) agree bit for bit.
//
// What bounds it on the H100: bytes. It writes the panel once (t*nb*l*l
// elements, 1.9 GB in bf16 for a z-tile at n = 200, L = 512) and reads
// each slab's K-slot store row (8 B per slot): ~0.6 ms at 3.35 TB/s.
// There is no arithmetic. The design: a block zeroes its slab with
// coalesced row writes, waits at one barrier, then scatters the slab's
// valid slots (one 4- or 2-byte store each, ~5 of K per row). It
// applies the orientation flag as it writes, so no (m, l, l) slab
// stack ever exists in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FLAG_TRANS = 1;
constexpr int FLAG_EYE = 2;

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(256)
densify_panel_kernel(const float* __restrict__ vals,
                     const int* __restrict__ cols,
                     const int* __restrict__ pids,
                     const int* __restrict__ flags, int P1, int L, int K,
                     int nb, T* __restrict__ out) {
  const int slab = blockIdx.x;
  const int a = slab / nb, b = slab - a * nb;
  const int pid = pids[slab], flag = flags[slab];
  const size_t ld = (size_t)nb * L;
  T* base = out + (size_t)a * L * ld + (size_t)b * L;
  for (int i = 0; i < L; ++i) {
    T* row = base + (size_t)i * ld;
    for (int j = threadIdx.x; j < L; j += blockDim.x)
      put(row + j, (flag == FLAG_EYE && i == j) ? 1.0f : 0.0f);
  }
  if (flag == FLAG_EYE || pid < 0 || pid >= P1) return;
  __syncthreads();  // the zeros are written before any value
  const float* v = vals + (size_t)pid * L * K;
  const int* c = cols + (size_t)pid * L * K;
  for (int e = threadIdx.x; e < L * K; e += blockDim.x) {
    const int col = c[e];
    if (col < 0 || col >= L) continue;
    const int i = e / K;
    const size_t off = flag == FLAG_TRANS ? (size_t)col * ld + i
                                          : (size_t)i * ld + col;
    put(base + off, v[e]);
  }
}

}  // namespace

// vals/cols: (P1, L, K) store; pids/flags: (t, nb) int32; out: the
// (t*L, nb*L) panel, f32 (bf16 == 0) or bf16 (bf16 == 1).
extern "C" int densify(const float* vals, const int* cols, const int* pids,
                       const int* flags, int P1, int L, int K, int t, int nb,
                       int bf16, void* out, void* stream) {
  const dim3 grid(t * nb), block(256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    densify_panel_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        vals, cols, pids, flags, P1, L, K, nb,
        static_cast<__nv_bfloat16*>(out));
  else
    densify_panel_kernel<float><<<grid, block, 0, st>>>(
        vals, cols, pids, flags, P1, L, K, nb, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* densify_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
