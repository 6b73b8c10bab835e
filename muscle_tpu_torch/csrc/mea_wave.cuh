// The band machinery of the two MEA wavefronts: `mea_dirs` (mea_dirs.cu,
// the device joins' direction DP) and kernel 4 (mea_scores.cu, the
// emissions path's MEA row scan). Both run the recurrence
//
//   S(i, j) = max(S(i, j-1), S(i-1, j-1) + p(i, j), S(i-1, j))
//
// (S(-1, .) = S(., -1) = 0) as a skewed wavefront over the rows: lane t
// of a warp owns row 32 * band + t and computes column s - t at band step
// s, taking row i-1 from lane t-1 by a shuffle, and lane 0 takes it from
// the band above. This header holds what they share:
//   - the stage ring: a warp's posterior, chunks of CW columns of its 32
//     rows (and a 33rd, the link row), copied by cp.async AHEAD chunks
//     ahead of the window of CW steps that reads them (zeros past the
//     real rows and columns). Lane t reads column j of its row at
//     stage[t][j mod RING_COLS], the first slot kept twice (at its place
//     and past the last slot) so that a window's CW reads are at offsets
//     0..CW-1 from one address; rows are ROW floats apart, a multiple of
//     32, so the 32 lanes (rows t, columns s - t) hit 32 different banks;
//   - the hand-over ring inside a block: warp w-1's lane 31 stores each
//     column's value with its position into a ring of RING 64-bit slots
//     in shared memory; warp w takes HC columns at a time (lane q the
//     slot of the q-th), waiting, all lanes together and napping, while a
//     slot holds another position, and counts the positions it has read
//     (`taken`), which keeps the producer at most RING positions ahead;
//   - the link between rounds of bands: a row in device memory written
//     by the last warp of a round, its count of columns published with
//     st.release.gpu, read by warp 0 of the next round with ld.acquire.gpu
//     and staged as the 33rd stage row with cp.async.cg (past L1, which
//     is not coherent across SMs).
// A wait past `limit` cycles sets `fault` and ends the waiting
// (ops/wavefront.check_waits raises on it).
#pragma once

#include <cuda_runtime.h>

namespace mw {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CW = 16;               // columns a staged chunk, steps a window
constexpr int NCH = 5;               // chunks in a warp's stage ring
constexpr int RING_COLS = CW * NCH;  // columns of the stage ring
constexpr int ROW = RING_COLS + CW;  // floats a stage row: ring + slot 0 again
constexpr int AHEAD = 2;             // chunks in flight past the window's
constexpr int HC = 16;               // columns a take, a wait and a count
constexpr int RING = 128;            // hand-over ring, slots a warp
constexpr unsigned SLEEP_NS = 32;    // a waiting lane's nap
// a window reads columns s0 - 31 .. s0 + CW - 1: three chunks; the two
// in flight take the other slots. The last two are zero when a band
// starts: its lanes read columns -31 .. -1 there before those chunks
// arrive
static_assert(NCH >= AHEAD + 3 && ROW % 32 == 0 && CW % HC == 0 &&
                  RING % HC == 0,
              "ring sizes");

// stage rows a warp: its band's 32 and the link row
constexpr int STAGE_ROWS = 33;
// an empty ring slot: a position no column has
constexpr unsigned long long EMPTY = 0xffffffff00000000ull;

// Shared memory of a block of `warps` warps, bytes: each warp's stage
// rows and hand-over ring, and its `taken` count.
inline size_t smem_bytes(int warps) {
  return (size_t)warps * (sizeof(float) * STAGE_ROWS * ROW +
                          sizeof(unsigned long long) * RING + sizeof(int));
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// 16 bytes to shared memory, of which the first `bytes` (0, 4, .., 16)
// are read and the rest zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// A wait that has run past `limit` cycles sets the fault flag and gives
// up; after that (alive false) no wait of the thread waits.
__device__ __forceinline__ bool timed_out(long long t0, long long limit,
                                          int* fault, bool& alive) {
  if (clock64() - t0 <= limit) return false;
  atomicExch(fault, 1);
  alive = false;
  return true;
}

// The warp's next n <= HC ring slots: lane q < n the slot of position
// first + q (its value in the low word, its position in the high word)
// once it holds that position, the whole warp napping meanwhile.
__device__ __forceinline__ unsigned long long take_slots(
    const volatile unsigned long long* ring, int first, int n, int lane,
    long long limit, int* fault, bool& alive) {
  const bool mine = lane < n;
  const int want = first + lane;
  const volatile unsigned long long* slot = ring + (want & (RING - 1));
  unsigned long long v = mine ? *slot : 0ull;
  if (__any_sync(FULL, mine && (int)(v >> 32) != want) &&
      __all_sync(FULL, alive)) {
    const long long t0 = clock64();
    do {
      __nanosleep(SLEEP_NS);
      if (mine) v = *slot;
      if (__any_sync(FULL, clock64() - t0 > limit)) {
        if (lane == 0) atomicExch(fault, 1);
        alive = false;
        break;
      }
    } while (__any_sync(FULL, mine && (int)(v >> 32) != want));
  }
  return v;
}

// The warp waits, napping, until the consumer has read position
// `need` - 1.
__device__ __forceinline__ void wait_taken(const volatile int* taken,
                                           int need, int lane,
                                           long long limit, int* fault,
                                           bool& alive) {
  if (!__any_sync(FULL, *taken < need) || !__all_sync(FULL, alive)) return;
  const long long t0 = clock64();
  while (__any_sync(FULL, *taken < need)) {
    if (__any_sync(FULL, clock64() - t0 > limit)) {
      if (lane == 0) atomicExch(fault, 1);
      alive = false;
      break;
    }
    __nanosleep(SLEEP_NS);
  }
}

// Chunk c (columns CW c ..) of rows row0 .. row0 + 31 of `post` (rows
// `stride` floats apart) into its slot of the stage ring (slot 0 also
// past the last slot), zeros at rows >= nrows and columns >= ncols;
// kVec: 16-byte copies (stride a multiple of 4, post 16-byte aligned),
// each of a whole group of 4 columns (ncols a multiple of 4: mea_dirs)
// or, kExact, of the group's columns below ncols only (kernel 4). With
// `link`, lane 0 also stages the link row's chunk c (positions base + CW
// c ..) as row 32, once the count says it is written.
template <bool kVec, bool kExact = false>
__device__ __forceinline__ void stage_chunk(
    float* stage, const float* __restrict__ post, int row0, int nrows,
    int ncols, int stride, int c, int lane, const float* link,
    const int* link_count, int base, int& known, long long limit, int* fault,
    bool& alive) {
  const int col0 = c * CW;
  const int slot = (c % NCH) * CW;
  const int copies = slot == 0 ? 2 : 1;
  for (int m = 0; m < copies; ++m) {
    float* dst = stage + (m ? RING_COLS : slot);
    if (kVec) {
#pragma unroll
      for (int k = 0; k < 32 * CW / 4 / 32; ++k) {
        const int e = lane + 32 * k;
        const int r = e / (CW / 4), q = e % (CW / 4) * 4;
        if (kExact) {
          const int cols =
              row0 + r < nrows ? min(max(ncols - col0 - q, 0), 4) : 0;
          cp_async16(
              dst + r * ROW + q,
              post + (cols ? (size_t)(row0 + r) * stride + col0 + q : 0),
              4 * cols);
        } else {
          const bool ok = row0 + r < nrows && col0 + q < ncols;
          cp_async16(dst + r * ROW + q,
                     post + (ok ? (size_t)(row0 + r) * stride + col0 + q : 0),
                     ok ? 16 : 0);
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < CW; ++k) {
        const int e = lane + 32 * k;
        const int r = e / CW, q = e % CW;
        const bool ok = row0 + r < nrows && col0 + q < ncols;
        cp_async(dst + r * ROW + q,
                 post + (ok ? (size_t)(row0 + r) * stride + col0 + q : 0),
                 ok);
      }
    }
    if (link != nullptr && lane == 0 && col0 < ncols) {
      // `known`: the count lane 0 last read (the producer is ahead: one
      // read may cover many chunks)
      const int need = base + min(col0 + CW, ncols);
      if (m == 0 && known < need && alive) {
        const long long t0 = clock64();
        while ((known = ld_acquire(link_count)) < need) {
          if (timed_out(t0, limit, fault, alive)) break;
          __nanosleep(SLEEP_NS);
        }
      }
#pragma unroll
      for (int q = 0; q < CW; q += 4)
        cp_async16(dst + 32 * ROW + q, link + col0 + q, 16);
    }
  }
}

}  // namespace mw
