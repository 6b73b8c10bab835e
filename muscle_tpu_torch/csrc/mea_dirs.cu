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
// The posterior reaches a lane through a stage ring in shared memory
// (mea_wave.cuh, shared with kernel 4, mea_scores.cu, as are the ring's
// takes and waits and the link's staging). The step is
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

#include "mea_wave.cuh"

namespace {

using namespace mw;

constexpr int LINK_HC = 128;         // columns a publication of the link row
constexpr int MAX_WARPS = 16;
static_assert(LINK_HC % CW == 0, "link publication");

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
      stage_chunk<kVec>(stage, post, row0, cc1, cc2, cc2, c, lane, lk,
                        link_count, in_base, known, wait_cycles, fault,
                        alive);
      cp_commit();
    }
    float cur = 0.0f;   // new(i, j)
    float oldj = 0.0f;  // new(i-1, j)
    unsigned bits = 0;  // the codes of the word being filled, newest on top
    int jm = lane == 0 ? 0 : RING_COLS - lane;  // (s0 - lane) mod RING_COLS
    for (int s0 = 0; s0 < steps; s0 += CW) {
      __syncwarp();  // the window before is read: its first slot is free
      stage_chunk<kVec>(stage, post, row0, cc1, cc2, cc2, s0 / CW + AHEAD,
                        lane, lk, link_count, in_base, known, wait_cycles,
                        fault, alive);
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
