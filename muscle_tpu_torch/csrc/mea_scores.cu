// Kernel 4: the MEA score of each pair's posterior, as a skewed
// wavefront of row bands across SMs.
//
// Replaces muscle_tpu/ops/pairhmm_pallas.py::_mea_kernel (launched by
// mea_scores_pallas): the last step of the legacy routes (the emissions
// path's beyond FUSED_MAX_LY, ops/pairhmm_emis_cuda.py; the letter
// path's under MUSCLE_TPU_FUSED=0, ops/pairhmm_cuda.py), after
// _finish_posteriors. reference: src/calcalnscoreflat.cpp:4-32.
//
// The Pallas kernel scans rows: e_j = max(old_{j-1} + p_ij, old_j)
// (old_{-1} = 0), then new = cummax(max(e, 0)); the score is the last
// lane after the last row. That is the cell recurrence S(i, j) =
// max(S(i, j-1), S(i-1, j-1) + p_ij, S(i-1, j)) with zeros before row
// and column 0, the direction DP of mea_dirs.cu without its directions.
// Each cell has one add (__fadd_rn) and otherwise maxes, exact in any
// order, so this schedule gives the plain version's bits
// (ops/pairhmm_emis_cuda.py::mea_scores_plain), ties included. The
// posterior is zero outside (lx, ly), so a row past ly only carries its
// maximum and rows past lx repeat the row before: the score is S(lx-1,
// ly-1), and the kernel reads no row past lx and no column past ly.
//
// What bounds it on the H100: for the function, bytes (each real cell
// read once, 4 bytes, against 4 operations); for a schedule, the chain
// of dependent cells: cell (i, j) needs (i-1, j-1), (i-1, j), (i, j-1)
// only, so it can run at step i + j, and a pair takes ~lx + ly steps,
// not lx row scans.
//
// Design (mea_wave.cuh holds the band machinery it shares with
// mea_dirs). Lane t of a warp owns row 32 * band + t and computes column
// s - t at band step s; lane 0 takes row i-1 from the band above. A
// block is one round of a pair: W warps, bands r W .. r W + W - 1, each
// warp one band, handing its last row to the next warp through the
// shared-memory ring. The next round of the pair is another block, on
// another SM: the round's last row goes through device memory (`links`,
// one row a block, published with st.release.gpu every LINK_HC columns
// and staged by warp 0 of the next round as the 33rd row of its stage
// ring). A block takes a ticket t from an atomic counter and runs round
// t / B of pair t % B, so it waits only on the block of ticket t - B,
// which took its ticket before it (and is running or done): progress
// never depends on which blocks are resident. Rounds past a pair's last
// band end at once. The lane of row lx-1 writes the score after its
// band's last step.
#include <climits>
#include <cuda_runtime.h>

#include "mea_wave.cuh"

namespace {

using namespace mw;

constexpr int LINK_HC = 32;  // columns a publication of a round's last row
constexpr int MAX_WARPS = 16;
static_assert(LINK_HC % CW == 0, "link publication");

__global__ void __launch_bounds__(MAX_WARPS * 32)
mea_scores_kernel(const float* __restrict__ post, const int* __restrict__ lxb,
                  const int* __restrict__ lyb, int B, int Lx, int Ly,
                  long long wait_cycles, int* __restrict__ sync,
                  int* __restrict__ fault, float* links,
                  float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int W = blockDim.x >> 5;
  float* stage = smem + (size_t)w * STAGE_ROWS * ROW;
  auto* rings = reinterpret_cast<volatile unsigned long long*>(
      smem + (size_t)W * STAGE_ROWS * ROW);
  volatile unsigned long long* out_ring = rings + w * RING;
  const volatile unsigned long long* in_ring =
      rings + (w > 0 ? w - 1 : 0) * RING;
  volatile int* taken = reinterpret_cast<volatile int*>(rings + W * RING);
  volatile int* ticket = taken + W;
  for (int k = lane; k < RING; k += 32) out_ring[k] = EMPTY;
  if (lane == 0) taken[w] = 0;  // taken[k]: positions read of ring k
  if (threadIdx.x == 0) *ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int t = *ticket;
  const int r = t / B, b = t % B;
  const int lx = min(lxb[b], Lx), ly = min(lyb[b], Ly);
  const int nb = (lx + 31) >> 5;
  const int band = r * W + w;
  if (lx < 1 || ly < 1) {  // an empty pair scores 0
    if (r == 0 && threadIdx.x == 0) out[b] = 0.0f;
    return;
  }
  if (band >= nb) return;  // past the pair's last band (no barrier follows)
  // the link rows: block t's last row and its count; warp 0 reads block
  // t - B's (the round before)
  int* counts = sync + 1;
  const bool has_out = band + 1 < nb;
  const bool ring_in = w > 0, link_in = w == 0 && r > 0;
  const bool ring_out = has_out && w < W - 1;
  const bool link_out = has_out && w == W - 1;
  const float* lk = link_in ? links + (size_t)(t - B) * Ly : nullptr;
  const int* lk_count = link_in ? counts + (t - B) : nullptr;
  float* link_o = links + (size_t)t * Ly;
  int* count_o = counts + t;
  const float* post_b = post + (size_t)b * Lx * Ly;
  const int row0 = band * 32, i = row0 + lane;
  const int steps = ly + 31;
  const float* my_row = stage + lane * ROW;
  bool alive = true;
  int known = 0;  // the link count lane 0 last read
  // columns -31 .. -1 (the last two slots) read as zeros
#pragma unroll
  for (int q = RING_COLS - 2 * CW; q < RING_COLS; ++q)
    stage[lane * ROW + q] = 0.0f;
#pragma unroll
  for (int c = 0; c < AHEAD; ++c) {
    stage_chunk<true, true>(stage, post_b, row0, lx, ly, Ly, c, lane, lk,
                            lk_count, 0, known, wait_cycles, fault, alive);
    cp_commit();
  }
  float cur = 0.0f;   // S(i, j)
  float oldj = 0.0f;  // S(i-1, j)
  int jm = lane == 0 ? 0 : RING_COLS - lane;  // (s0 - lane) mod RING_COLS
  for (int s0 = 0; s0 < steps; s0 += CW) {
    __syncwarp();  // the window before is read: its first slot is free
    stage_chunk<true, true>(stage, post_b, row0, lx, ly, Ly, s0 / CW + AHEAD,
                            lane, lk, lk_count, 0, known, wait_cycles, fault,
                            alive);
    cp_commit();
    cp_wait<AHEAD>();
    __syncwarp();  // every lane's copies of this window's chunk landed
    const float* pw = my_row + jm;  // column s0 - lane
    // the link row from column s0 (lane 0's place in the stage ring)
    const float* lw = stage + 32 * ROW + s0 % RING_COLS;
    const int pout = s0 - 31;                  // lane 31's column at k
    const int k_lo = 31 - s0, k_hi = ly + 30 - s0;  // lane 31's real steps
    // Runs of HC steps. Their waits and takes come first: the steps hold
    // no wait, atomic, fence or branch.
#pragma unroll
    for (int h = 0; h < CW; h += HC) {
      // the band above's next HC columns: lane q holds S(i-1, s0 + h + q),
      // zeros past ly - 1
      const int n = max(0, min(HC, ly - s0 - h));
      float hcol = 0.0f;
      if (ring_in && n > 0) {
        const unsigned long long v = take_slots(in_ring, s0 + h, n, lane,
                                                wait_cycles, fault, alive);
        hcol = __uint_as_float((unsigned)v);
        if (lane == n - 1) taken[w - 1] = (int)(v >> 32) + 1;
      }
      if (link_in && lane < n) hcol = lw[h + lane];
      // room in the ring for lane 31's columns of this run
      const int last31 = min(s0 + h + HC - 1 - 31, ly - 1);
      if (ring_out && last31 >= 0)
        wait_taken(taken + w, last31 + 1 - RING, lane, wait_cycles, fault,
                   alive);
#pragma unroll
      for (int kk = 0; kk < HC; ++kk) {
        const int k = h + kk;
        const float hin = __shfl_sync(FULL, hcol, kk);
        const float up = __shfl_up_sync(FULL, cur, 1);
        const float x = lane == 0 ? hin : up;
        cur = fmaxf(cur, fmaxf(__fadd_rn(oldj, pw[k]), x));
        oldj = x;
        // lane 31: S(i, s - 31) to the band below (one predicated store:
        // no branch in the step)
        const bool put = lane == 31 && k >= k_lo && k <= k_hi;
        if (ring_out && put)
          out_ring[(pout + k) & (RING - 1)] =
              (unsigned long long)(unsigned)(pout + k) << 32 |
              __float_as_uint(cur);
        if (link_out && put) link_o[pout + k] = cur;
      }
    }
    // the link row's count: every LINK_HC columns and at its end
    const int linked = min(max(s0 + CW - 31, 0), ly);
    if (link_out && lane == 31 && linked > 0 &&
        ((s0 / CW) % (LINK_HC / CW) == LINK_HC / CW - 1 ||
         (linked == ly && s0 - 31 < ly)))
      st_release(count_o, linked);
    jm = jm + CW >= RING_COLS ? jm + CW - RING_COLS : jm + CW;
  }
  if (i == lx - 1) out[b] = cur;  // S(lx-1, ly-1)
  cp_wait<0>();
}

}  // namespace

// post: (B, Lx, Ly) f32, zero outside each pair's (lx, ly); lxb, lyb:
// (B,) int32; out: (B,) f32. `warps` warps a block (bands a round, at
// most MAX_WARPS), B * ceil(ceil(Lx / 32) / warps) blocks; sync: 1 + that
// many int32, zeroed (the ticket, each block's link count); links: that
// many rows of Ly floats (each block's last row). Ly a multiple of 16,
// post 16-byte aligned. A wait past `wait_cycles` sets *fault.
extern "C" int mea_scores(const float* post, const int* lxb, const int* lyb,
                          int B, int Lx, int Ly, int warps,
                          long long wait_cycles, int* sync, int* fault,
                          float* links, float* out, void* stream) {
  if (B < 1 || Lx < 1 || Ly < 16 || Ly % 16 || warps < 1 ||
      warps > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rounds = ((Lx + 31) / 32 + warps - 1) / warps;
  if (rounds * B > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = mw::smem_bytes(warps) + sizeof(int);  // + the ticket
  const cudaError_t e = cudaFuncSetAttribute(
      mea_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  mea_scores_kernel<<<(int)(rounds * B), warps * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      post, lxb, lyb, B, Lx, Ly, wait_cycles, sync, fault, links, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mea_scores_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
