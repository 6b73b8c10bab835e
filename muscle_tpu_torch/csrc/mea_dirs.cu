// The MEA direction DP of the device joins, as a skewed wavefront over
// the rows: one row a lane, bands of 32 rows a warp, one thread block a
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
// (__fadd_rn), so any order of evaluation gives the same values: the
// kernel, its plain version (ops/devjoin_cuda.py::mea_dirs_plain) and
// the JAX scan agree bit for bit, ties included.
//
// What bounds it on the H100: neither bytes (cc1*cc2*4 read, 1/16 of
// that written: ~1 us for 768 x 768) nor operations, but the chain of
// dependent cells. Cell (i, j) needs new(i-1, j), new(i-1, j+1) and
// new(i, j) only, so cell (i, j) can run at step i + j: the dependency
// floor is ~cc1 + cc2 steps of one cell, not cc1 row scans.
//
// Design. Lane t of a warp owns row i = 32 * band + t and computes
// column j = s - t at band step s, keeping new(i, j) in a register; it
// takes new(i-1, j+1) from lane t-1 by __shfl_up_sync (and new(i-1, j)
// is what it took the step before). Lane 0 takes row i-1 from the band
// above (lane 31 of the warp before). Warps take the bands round-robin
// (MAX_WARPS of 32 rows in flight), so the hand-overs are of two kinds:
//   - inside a round, warp w-1 to warp w through a ring of RING slots in
//     shared memory, one 64-bit slot a column holding the value and its
//     position (band r of a warp writes positions r * cc2 + c - 1 for
//     columns c = 1..cc2). Every HC steps the warp takes the next HC
//     columns at once, lane q the slot of column s + 1 + q, and waits
//     (all lanes together, napping) while a slot holds another
//     position, so no value is read before it is written and no fence
//     or count is on the chain; each step then hands lane 0 its column
//     by a shuffle. Nothing a single lane does diverges: a lane of a
//     warp that waits alone, or reads alone each step, keeps the warp's
//     other lanes from issuing and the whole block crawls (each warp
//     waits on the one before). The warp publishes its count of
//     positions read every HC columns (a store whose value is a
//     position read), and lane 31 (a predicated store a step) never
//     runs more than RING positions ahead of it;
//   - from the last warp of a round to warp 0 of the next, a whole row
//     in device memory (`link`), published with st.release.gpu every
//     LINK_HC columns and staged by warp 0 like a 33rd row of its
//     posterior chunks. Warp 0 starts that band only after its own band
//     of the round before ends, so a ring there could fill and stall
//     every warp of the round in turn (a cycle of waits back to warp
//     0); the row never stalls its producer, and by the time warp 0
//     reads a column the producer has long written it. A later round
//     overwrites a column only after warp 0 read it (the next round's
//     last band reaches column c only after warp 0's band passed c +
//     31 and waited for its copies).
// The posterior reaches a lane through a stage ring in shared memory:
// chunks of CW columns of the band's 32 rows, copied by cp.async AHEAD
// chunks ahead of the window of CW steps that reads them (zeros past
// cc1 and cc2); a lane reads column j of its row at stage[t][j mod
// RING_COLS], where the first slot is kept twice, at its place and past
// the last slot, so that a window's 16 reads are at offsets 0..15 from
// one address; rows are ROW floats apart, a multiple of 32, so the 32
// lanes (rows t, columns s - t) hit 32 different banks. The step is
// short because a warp issues it 32 rows at a time and up to 16 warps
// share the SM's issue slots: a lane shifts each code into its word (a
// funnel shift, stopped after column cc2 - 1) and stores the word at
// its 16th column; it runs the recurrence on every step, since the
// columns before its row starts read zeros (new(i, j) stays 0) and the
// columns after it read zeros too (new stays new(i, cc2), the score,
// which the lane writes after the band with its last partial word). A
// wait past `wait_cycles` sets `fault` and ends the waiting
// (ops/wavefront.check_waits raises on it).
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CW = 16;               // columns a staged chunk, steps a window
constexpr int NCH = 5;               // chunks in a warp's stage ring
constexpr int RING_COLS = CW * NCH;  // columns of the stage ring
constexpr int ROW = RING_COLS + CW;  // floats a stage row: ring + slot 0 again
constexpr int AHEAD = 2;             // chunks in flight past the window's
constexpr int HC = 16;               // columns a take, a wait and a count
constexpr int RING = 128;            // hand-over ring, slots a warp
constexpr int LINK_HC = 128;         // columns a publication of the link row
constexpr int MAX_WARPS = 16;
constexpr unsigned SLEEP_NS = 32;    // a waiting lane's nap
// a window reads columns s0 - 31 .. s0 + CW - 1: three chunks; the two
// in flight take the other slots. The last two are zero when a band
// starts: its lanes read columns -31 .. -1 there before those chunks
// arrive
static_assert(NCH >= AHEAD + 3 && ROW % 32 == 0 && CW % HC == 0 &&
                  RING % HC == 0 && LINK_HC % CW == 0,
              "ring sizes");

// stage rows a warp: its band's 32 and the link row
constexpr int STAGE_ROWS = 33;
// an empty ring slot: a position no column has
constexpr unsigned long long EMPTY = 0xffffffff00000000ull;

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
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

// Chunk c (columns CW c ..) of rows row0 .. row0 + 31 into its slot of
// the stage ring (slot 0 also past the last slot), zeros past cc1 and
// cc2; kVec: 16-byte copies (cc2 a multiple of 4, post 16-byte
// aligned). With `link`, lane 0 also stages the link row's chunk c
// (positions base + CW c ..) as row 32, once the count says it is
// written.
template <bool kVec>
__device__ __forceinline__ void stage_chunk(
    float* stage, const float* __restrict__ post, int row0, int cc1, int cc2,
    int c, int lane, const float* link, const int* link_count, int base,
    int& known, long long limit, int* fault, bool& alive) {
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
        const bool ok = row0 + r < cc1 && col0 + q < cc2;
        cp_async16(dst + r * ROW + q,
                   post + (ok ? (size_t)(row0 + r) * cc2 + col0 + q : 0), ok);
      }
    } else {
#pragma unroll
      for (int k = 0; k < CW; ++k) {
        const int e = lane + 32 * k;
        const int r = e / CW, q = e % CW;
        const bool ok = row0 + r < cc1 && col0 + q < cc2;
        cp_async(dst + r * ROW + q,
                 post + (ok ? (size_t)(row0 + r) * cc2 + col0 + q : 0), ok);
      }
    }
    if (link != nullptr && lane == 0 && col0 < cc2) {
      // `known`: the count lane 0 last read (the producer is far ahead:
      // one read covers many chunks)
      const int need = base + min(col0 + CW, cc2);
      if (m == 0 && known < need && alive) {
        const long long t0 = clock64();
        while ((known = ld_acquire(link_count)) < need) {
          if (timed_out(t0, limit, fault, alive)) break;
          __nanosleep(SLEEP_NS);
        }
      }
#pragma unroll
      for (int q = 0; q < CW; q += 4)
        cp_async16(dst + 32 * ROW + q, link + col0 + q, true);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(MAX_WARPS * 32)
mea_dirs_kernel(const float* __restrict__ post, int cc1, int cc2,
                long long wait_cycles, int* __restrict__ fault, float* link,
                int* __restrict__ packed, float* __restrict__ scores) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  float* stage = smem + (size_t)w * STAGE_ROWS * ROW;
  auto* rings = reinterpret_cast<volatile unsigned long long*>(
      smem + (size_t)W * STAGE_ROWS * ROW);
  volatile unsigned long long* out_ring = rings + w * RING;
  const volatile unsigned long long* in_ring =
      rings + (w > 0 ? w - 1 : 0) * RING;
  volatile int* taken = reinterpret_cast<volatile int*>(rings + W * RING);
  int* link_count = reinterpret_cast<int*>(link + (cc2 + CW - 1) / CW * CW);
  for (int k = lane; k < RING; k += 32) out_ring[k] = EMPTY;
  if (lane == 0) taken[w] = 0;  // taken[k]: positions read of ring k
  if (threadIdx.x == 0) st_release(link_count, 0);
  __syncthreads();
  const int nb = (cc1 + 31) >> 5;
  const int words = (cc2 + 15) >> 4;
  const int steps = cc2 + 31;
  // the step of a window at which this lane's word is complete
  const int kst = (lane + CW - 1) % CW;
  const float* my_row = stage + lane * ROW;
  bool alive = true;

  for (int band = w, r = 0; band < nb; band += W, ++r) {
    const int row0 = band * 32, i = row0 + lane;
    const bool row_ok = i < cc1;
    const bool has_out = band + 1 < nb;
    // the band above: warp w-1's ring in this round, or (warp 0) the
    // link row of the round before; the band below likewise
    const bool ring_in = band > 0 && w > 0, link_in = band > 0 && w == 0;
    const bool ring_out = has_out && w < W - 1;
    const bool link_out = has_out && w == W - 1;
    const int in_base = (w > 0 ? r : r - 1) * cc2;
    const int out_base = r * cc2;
    const float* lk = link_in ? link : nullptr;
    int* prow = packed + (size_t)(row_ok ? i : 0) * words;
    int known = 0;  // the link count lane 0 last read
    // columns -31 .. -1 (the last two slots) read as zeros
#pragma unroll
    for (int q = RING_COLS - 2 * CW; q < RING_COLS; ++q) stage[lane * ROW + q] = 0.0f;
#pragma unroll
    for (int c = 0; c < AHEAD; ++c) {
      stage_chunk<kVec>(stage, post, row0, cc1, cc2, c, lane, lk, link_count,
                        in_base, known, wait_cycles, fault, alive);
      cp_commit();
    }
    float cur = 0.0f;   // new(i, j)
    float oldj = 0.0f;  // new(i-1, j)
    unsigned bits = 0;  // the codes of the word being filled, newest on top
    int jm = lane == 0 ? 0 : RING_COLS - lane;  // (s0 - lane) mod RING_COLS
    for (int s0 = 0; s0 < steps; s0 += CW) {
      __syncwarp();  // the window before is read: its first slot is free
      stage_chunk<kVec>(stage, post, row0, cc1, cc2, s0 / CW + AHEAD, lane,
                        lk, link_count, in_base, known, wait_cycles, fault,
                        alive);
      cp_commit();
      cp_wait<AHEAD>();
      __syncwarp();  // every lane's copies of this window's chunk landed
      const float* pw = my_row + jm;              // column s0 - lane
      // the link row from column s0 (lane 0's place in the stage ring)
      const float* lw = stage + 32 * ROW + s0 % RING_COLS;
      const int jw = s0 + kst - lane;             // the word this window ends
      const bool word_ok = row_ok && jw >= 0 && jw < cc2;
      const int klast = cc2 - 1 - s0 + lane;      // steps k <= klast are real
      const int pout = out_base + s0 - 31;        // lane 31's position at k
      const int k_lo = 31 - s0, k_hi = cc2 + 30 - s0;  // lane 31's real steps
      // Runs of HC steps (one a window). Their waits, takes and counts
      // come first: the steps hold no wait, atomic, fence or branch, so
      // the compiler schedules them freely.
#pragma unroll
      for (int h = 0; h < CW; h += HC) {
        // the band above's next HC columns: lane q holds new(i-1, s0 + h
        // + 1 + q), zeros past cc2 - 1
        const int n = max(0, min(HC, cc2 - s0 - h));
        float hcol = 0.0f;
        if (ring_in && n > 0) {
          const unsigned long long v = take_slots(
              in_ring, in_base + s0 + h, n, lane, wait_cycles, fault, alive);
          hcol = __uint_as_float((unsigned)v);
          if (lane == n - 1) taken[w - 1] = (int)(v >> 32) + 1;
        }
        if (link_in && lane < n) hcol = lw[h + lane];
        // room in the ring for lane 31's columns of this half
        const int last31 = min(s0 + h + HC - 1 - 31, cc2 - 1);
        if (ring_out && last31 >= 0)
          wait_taken(taken + w, out_base + last31 + 1 - RING, lane,
                     wait_cycles, fault, alive);
#pragma unroll
        for (int kk = 0; kk < HC; ++kk) {
          const int k = h + kk;
          const float hin = __shfl_sync(FULL, hcol, kk);
          const float up = __shfl_up_sync(FULL, cur, 1);
          const float x = lane == 0 ? hin : up;
          const float b = __fadd_rn(oldj, pw[k]);
          const float nw = fmaxf(cur, fmaxf(b, x));
          // B if b is the max, else X if x is, else Y (src/best3.h's
          // order)
          const unsigned d = b == nw ? 0u : (x == nw ? 1u : 2u);
          if (k <= klast) bits = __funnelshift_r(bits, d, 2);
          if (k == kst && word_ok) prow[jw >> 4] = (int)bits;
          cur = nw;
          oldj = x;
          // lane 31: new(i, s - 30) to the band below, position pout +
          // k (one predicated store: no branch in the step)
          const bool put = lane == 31 && k >= k_lo && k <= k_hi;
          if (ring_out && put)
            out_ring[(pout + k) & (RING - 1)] =
                (unsigned long long)(unsigned)(pout + k) << 32 |
                __float_as_uint(nw);
          if (link_out && put) link[pout + k - out_base] = nw;
        }
      }
      // the link row's count: every LINK_HC columns and at its end
      const int linked = min(max(s0 + CW - 31, 0), cc2);
      if (link_out && lane == 31 && linked > 0 &&
          ((s0 / CW) % (LINK_HC / CW) == LINK_HC / CW - 1 ||
           (linked == cc2 && s0 - 31 < cc2)))
        st_release(link_count, out_base + linked);
      jm = jm + CW >= RING_COLS ? jm + CW - RING_COLS : jm + CW;
    }
    // the score new(i, cc2) and the last partial word
    if (row_ok) {
      scores[i] = cur;
      if (cc2 % 16) prow[words - 1] = (int)(bits >> (2 * (16 - cc2 % 16)));
    }
    cp_wait<0>();
    __syncwarp();
  }
}

// Dynamic shared memory of a launch of `warps` warps, bytes.
size_t smem_bytes(int warps) {
  return (size_t)warps * (sizeof(float) * STAGE_ROWS * ROW +
                          sizeof(unsigned long long) * RING + sizeof(int));
}

template <bool kVec>
cudaError_t launch(const float* post, int cc1, int cc2, int warps,
                   long long wait_cycles, int* fault, float* link,
                   int* packed, float* scores, cudaStream_t st) {
  const size_t smem = smem_bytes(warps);
  const cudaError_t e = cudaFuncSetAttribute(
      mea_dirs_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  mea_dirs_kernel<kVec><<<1, warps * 32, smem, st>>>(
      post, cc1, cc2, wait_cycles, fault, link, packed, scores);
  return cudaGetLastError();
}

}  // namespace

// post: (cc1, cc2) f32; packed: (cc1, ceil(cc2/16)) int32; scores:
// (cc1,) f32; one block of min(ceil(cc1 / 32), MAX_WARPS) warps, taking
// the bands of 32 rows round-robin; vec: 16-byte staging copies (cc2 % 4
// == 0 and post 16-byte aligned); link: 16 * ceil(cc2 / 16) + 4 floats
// of scratch (the link row, then its count), 16-byte aligned.
extern "C" int mea_dirs(const float* post, int cc1, int cc2, int vec,
                        long long wait_cycles, int* fault, float* link,
                        int* packed, float* scores, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cc1 < 1 || cc2 < 1 || cc2 > INT_MAX - 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int warps = min((cc1 + 31) / 32, MAX_WARPS);
  const cudaError_t e =
      vec ? launch<true>(post, cc1, cc2, warps, wait_cycles, fault, link,
                         packed, scores, st)
          : launch<false>(post, cc1, cc2, warps, wait_cycles, fault, link,
                          packed, scores, st);
  return static_cast<int>(e);
}

extern "C" const char* mea_dirs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
