// Kernel 8: densify a z-tile of the consistency matrix M into its row
// panel, one shared-memory tile a thread block, each panel byte written
// once.
//
// Replaces muscle_tpu/ops/sparse.py::_densify_kernel (densify_pallas),
// the fixed-K rows -> dense expansion that feeds the Gram-scheme
// consistency (muscle_tpu/ops/consistency.py::_densify_rowpanel). The
// panel holds, for the t sequences Z of a z-tile and the nb sequences B
// of the family, slab (a, b) = M[Z_a, B_b] at rows a*L.., columns b*L..
// of a (t*L, nb*L) matrix:
//   FLAG_STORE  the store row pids[a, b] densified (P_ZB, Z < B),
//   FLAG_TRANS  its transpose (P_BZ^T, Z > B),
//   FLAG_EYE    the identity (Z = B),
// written as f32 or rounded to bf16 (__float2bfloat16_rn, the round to
// nearest even of torch's .to(torch.bfloat16)); a pid outside the store
// (< 0 or >= P1) gives zeros.
//
// Every panel cell takes at most one value (column indices are unique
// within a store row), so the kernel and its plain version
// (ops/densify_cuda.py::densify_panel_plain) agree bit for bit; the
// tiled walk below is also run on the CPU, item by item
// (densify_panel_tiled_plain).
//
// What bounds it on the H100: bytes. It writes the panel once (t*nb*L*L
// elements, 1.88 GB in bf16 for a z-tile at n = 200, L = 512: 0.56 ms
// at 3.35 TB/s) and reads each slab's store rows (8 B a slot). There is
// no arithmetic. The design: a work item (one block) is one slab's tile,
// store rows [s0, s0 + R) x store columns [c0, c0 + C) (R x sizeof(T) =
// 128 B, C = min(L, 256): R x C x sizeof(T) <= 32 KB, four blocks an SM;
// fixed below from the dtype, mirrored for the CPU twin by
// ops/densify_cuda.tile_shape). A store item loads its
// first slots, zeroes the tile in shared memory, drops the band's
// valid slots of its columns into it (transposed for FLAG_TRANS: the
// tile is then C output rows of R elements), and writes it out once,
// 16 bytes a thread with neighbouring threads on neighbouring
// addresses, streaming (evict-first: the panel is larger than L2):
// whole 128-byte lines of output rows, each sector written once. The
// band's slots (R x K, contiguous) are read once an item, from device
// memory by the first column tile and from L2 by the others. FLAG_EYE
// items and a pid outside the store read nothing and write zeros (or
// the identity) straight from registers.
//
// Measured on an H100 80GB HBM3 at 700 W (tools/torch_fwd_densify_probe.py,
// the n = 200 bf16 tile): the kernel it replaces, which wrote each
// slab's zeros element by element and then scattered the values over
// them, took 1.42-1.45 ms, of which its zero pass alone 0.63 ms: the
// scatter's partial second writes of the same sectors cost 0.8 ms. This
// kernel: 0.82 ms (64 KB tiles 0.835, 16 KB 1.09; the TMA's bulk
// copies for the write-out 0.82). What is left over the zero pass: the
// slots it reads (all K of each row, 19 % of the panel's bytes at K =
// 24) and each item's load-zero-drop-write sequence.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int FLAG_TRANS = 1;
constexpr int FLAG_EYE = 2;
constexpr int kThreads = 512;
constexpr int kHeld = 4;  // slots a thread loads ahead of the zeroing
// a tile: R = kLineBytes / sizeof(T) store rows (one 128-byte line of a
// transposed output row) x C = min(L, kTileBytes / kLineBytes) columns
constexpr int kLineBytes = 128;
constexpr int kTileBytes = 32 * 1024;
static_assert(kTileBytes <= 48 * 1024, "a tile fits the default smem");

__device__ __forceinline__ float to_t(float v, float) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_t(float v, __nv_bfloat16) {
  return __float2bfloat16_rn(v);
}

// 16 bytes of zeros with element d (of 16 / sizeof(T)) set to 1.0
// (0x3F800000 in f32, 0x3F80 in bf16), or all zeros for d outside
__device__ __forceinline__ uint4 one_at(int d, float) {
  const unsigned one = 0x3F800000u;
  return make_uint4(d == 0 ? one : 0u, d == 1 ? one : 0u, d == 2 ? one : 0u,
                    d == 3 ? one : 0u);
}
__device__ __forceinline__ uint4 one_at(int d, __nv_bfloat16) {
  const unsigned one = d >= 0 && d < 8 ? 0x3F80u << (16 * (d & 1)) : 0u;
  const int w = d >> 1;
  return make_uint4(w == 0 ? one : 0u, w == 1 ? one : 0u, w == 2 ? one : 0u,
                    w == 3 ? one : 0u);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
densify_panel_kernel(const float* __restrict__ vals,
                     const int* __restrict__ cols,
                     const int* __restrict__ pids,
                     const int* __restrict__ flags, int P1, int L, int K,
                     int nb, int R, int C, int nbands, int ntiles,
                     T* __restrict__ out) {
  extern __shared__ uint4 smem[];
  constexpr int VEC = 16 / sizeof(T);  // elements a 16-byte store
  const int item = blockIdx.x;
  const int ct = item % ntiles;
  const int band = (item / ntiles) % nbands;
  const int slab = item / (ntiles * nbands);
  const int a = slab / nb, b = slab - a * nb;
  const int s0 = band * R, c0 = ct * C;
  const int rn = min(R, L - s0), cn = min(C, L - c0);
  const int pid = pids[slab], flag = flags[slab];
  const size_t ld = (size_t)nb * L;
  T* slab_out = out + (size_t)a * L * ld + (size_t)b * L;

  if (flag == FLAG_EYE || pid < 0 || pid >= P1) {
    // zeros, or the identity on the slab's diagonal, from registers
    const int per_row = cn / VEC;
    for (int q = threadIdx.x; q < rn * per_row; q += kThreads) {
      const int r = q / per_row, p = q - r * per_row;
      const int d = flag == FLAG_EYE ? (s0 + r) - (c0 + p * VEC) : -1;
      *reinterpret_cast<uint4*>(slab_out + (size_t)(s0 + r) * ld + c0 +
                                p * VEC) = one_at(d, T());
    }
    return;
  }

  // the tile: FLAG_STORE rn output rows of cn elements (store row i,
  // column c0 + col at i * cn + col); FLAG_TRANS cn output rows of rn
  // (at col * rn + i)
  const bool trans = flag == FLAG_TRANS;
  T* tile = reinterpret_cast<T*>(smem);
  // the band's slots: store rows s0 .. s0 + rn of pair pid, contiguous;
  // a thread's first kHeld slots are loaded before the tile is zeroed,
  // so their latency overlaps the zeroing (rn * K <= kHeld * kThreads
  // for K <= 32, the store's width)
  const size_t base = ((size_t)pid * L + s0) * K;
  const float* v = vals + base;
  const int* c = cols + base;
  const int n_slots = rn * K;
  int held_c[kHeld];
  float held_v[kHeld];
#pragma unroll
  for (int u = 0; u < kHeld; ++u) {
    const int e = threadIdx.x + u * kThreads;
    held_c[u] = e < n_slots ? __ldg(c + e) : -1;
    held_v[u] = e < n_slots ? __ldg(v + e) : 0.0f;
  }
  const int n16 = rn * cn / VEC;
  for (int q = threadIdx.x; q < n16; q += kThreads)
    smem[q] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  auto drop = [&](int e, int cc, float val) {
    const int col = cc - c0;  // an empty slot (-1) falls below 0
    if (col < 0 || col >= cn) return;
    const int i = e / K;
    tile[trans ? col * rn + i : i * cn + col] = to_t(val, T());
  };
#pragma unroll
  for (int u = 0; u < kHeld; ++u)
    drop(threadIdx.x + u * kThreads, held_c[u], held_v[u]);
  for (int e = threadIdx.x + kHeld * kThreads; e < n_slots; e += kThreads)
    drop(e, c[e], v[e]);
  __syncthreads();
  const int nrows = trans ? cn : rn;
  const int per_row = (trans ? rn : cn) / VEC;
  const int r0 = trans ? c0 : s0, col0 = trans ? s0 : c0;
  for (int q = threadIdx.x; q < nrows * per_row; q += kThreads) {
    const int r = q / per_row, p = q - r * per_row;
    __stcs(reinterpret_cast<uint4*>(slab_out + (size_t)(r0 + r) * ld + col0 +
                                    p * VEC),
           smem[q]);
  }
}

template <typename T>
int launch(const float* vals, const int* cols, const int* pids,
           const int* flags, int P1, int L, int K, int t, int nb, T* out,
           cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int R = kLineBytes / sizeof(T);
  if (L % VEC || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int C = L < kTileBytes / kLineBytes ? L : kTileBytes / kLineBytes;
  const size_t smem = (size_t)R * C * sizeof(T);
  const int nbands = (L + R - 1) / R, ntiles = (L + C - 1) / C;
  const size_t items = (size_t)t * nb * nbands * ntiles;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  densify_panel_kernel<T><<<static_cast<unsigned>(items), kThreads, smem,
                            st>>>(vals, cols, pids, flags, P1, L, K, nb, R,
                                  C, nbands, ntiles, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vals/cols: (P1, L, K) store; pids/flags: (t, nb) int32; out: the
// (t*L, nb*L) panel, f32 (bf16 == 0) or bf16 (bf16 == 1).
extern "C" int densify(const float* vals, const int* cols, const int* pids,
                       const int* flags, int P1, int L, int K, int t, int nb,
                       int bf16, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch(vals, cols, pids, flags, P1, L, K, t, nb,
                  static_cast<__nv_bfloat16*>(out), st);
  return launch(vals, cols, pids, flags, P1, L, K, t, nb,
                static_cast<float*>(out), st);
}

extern "C" const char* densify_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
