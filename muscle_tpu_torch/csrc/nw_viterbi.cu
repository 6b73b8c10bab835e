// Kernel nw_viterbi: global affine Needleman-Wunsch (Viterbi) of a
// batch of pairs, the trace bits of every row and the M/D/I row at each
// pair's length.
//
// Replaces muscle_tpu/ops/nw.py::nw_viterbi_batch, an XLA scan over the
// rows of A in the JAX package (lax.scan of _nw_one under vmap), which
// every ML protein distance of Super6 / UClustPD / -protdists runs
// (reference: src/viterbifastmem.cpp). For each pair b:
//   row 0:  M = (0, NEG, ...), D = NEG, I = [NEG, scan(M + open)[:-1]];
//   row r < lx: bits[b, r, :] = the trace bits of (M, D, I) (M before
//     D by strict >, then I by strict >; gap open before extend by >=);
//     best = max(max(M, D), I);
//     M' = [NEG, best[j-1] + subst[x_r, y_{j-1}]];
//     D' = max(M + open, D + ext);
//     I' = [NEG, scan(M' + open)[:-1]], scan the max-plus scan with decay
//     ext (csrc/dp_rows.cuh, the JAX rounds), taken here as the scan of
//     [-inf, (M' + open)[:-1]] (the same terms: the -inf adds nothing);
//   final[b] = (M, D, I) after lx rows; score = max(max(M, D), I) of it
//     at column ly.
// Its plain version is muscle_tpu_torch/ops/nw.py::nw_viterbi_plain,
// the same adds and maxes in the same order: the bits of rows < lx and
// columns <= ly, the final rows' columns <= ly and the scores agree bit
// for bit (ptxas contraction is off, -fmad=false). Bit rows >= lx and
// the bit and final columns > ly are left unwritten: the host's path
// walk reads none of them (ops/nw.py::_traceback). A pair with lx > BX
// or ly > BY is skipped (its final rows and score keep the caller's
// zeros).
//
// What bounds it on the H100: neither bytes nor operations but the
// row's chain: a row is ceil(log2(ly + 1)) dependent scan rounds after
// the M/D/I update, and the rows follow one another. The design
// (csrc/dp_rows.cuh): a team of warps a pair, a lane C contiguous
// columns of M, D, I in registers, the scan's rounds in registers and
// shuffles (one warp a pair up to 128 lanes: no barrier at all; a block
// of warps up to 4096, each also running the warp below's columns so
// that a row has one barrier to exchange it and one a round k >= 128; a
// cluster beyond),
// the substitution table in shared memory, the bits stored from the
// registers as aligned words (store_bits). Each pair runs lx rows of its
// ly + 1 columns.
#include <stdint.h>

#include "dp_rows.cuh"

namespace {

constexpr float kOpen = -3.0f;  // ops/nw.py VITERBI_GAP_OPEN
constexpr float kExt = -0.5f;   // ops/nw.py VITERBI_GAP_EXT
constexpr float kNeg = -1e30f;  // ops/nw.py NEG
constexpr unsigned kDM = 0x01, kIM = 0x02, kMD = 0x04, kMI = 0x08;

__device__ __forceinline__ uint32_t row_bits(float m, float d, float i) {
  unsigned b = i > fmaxf(m, d) ? kIM : (d > m ? kDM : 0u);
  if (m + kOpen >= d + kExt) b |= kMD;
  if (m + kOpen >= i + kExt) b |= kMI;
  return b;
}

// A lane's C bits bytes (packed four to a word, column c in byte c % 4
// of word c / 4) at bits[at ..], `real` of them (<= 0: none) below the
// pair's width: as aligned words where the lane's columns are all real
// (the row stride is odd, so the words are the packed ones shifted by
// the address's misalignment, and the bytes before the first aligned
// word and after the last go one by one), else byte by byte.
template <int C>
__device__ __forceinline__ void store_bits(uint8_t* bits, size_t at,
                                           const uint32_t (&pk)[(C + 3) / 4],
                                           int real) {
  if (real <= 0) return;
  if (C < 4 || real < C) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (c < real) bits[at + c] = static_cast<uint8_t>(pk[c >> 2] >> (8 * (c & 3)));
    return;
  }
  if constexpr (C >= 4) {
    const int s = static_cast<int>(at & 3);  // bytes past a word boundary
    if (s == 0) {
      uint32_t* w = reinterpret_cast<uint32_t*>(bits + at);
#pragma unroll
      for (int q = 0; q < C / 4; ++q) w[q] = pk[q];
      return;
    }
    const int head = 4 - s;  // columns 0 .. head - 1 before the first word
    uint32_t* w = reinterpret_cast<uint32_t*>(bits + at + head);
#pragma unroll
    for (int q = 0; q + 1 < C / 4; ++q)
      w[q] = __funnelshift_r(pk[q], pk[q + 1], 8 * head);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if (c < head) bits[at + c] = static_cast<uint8_t>(pk[0] >> (8 * c));
#pragma unroll
    for (int c = C - 3; c < C; ++c)
      if (c >= C - s)
        bits[at + c] = static_cast<uint8_t>(pk[c >> 2] >> (8 * (c & 3)));
  }
}

// The rest of a row in a team of several warps, after best (in v)
// and M' (in m, but its column 0): every warp publishes its best, then
// builds the shadow (the warp below's M' and scan input, from its best
// and two columns of the warp below that), sets M'[0] and the scan input
// (in v) from the lane below or the shadow's lane 31, and runs
// block_scan: one barrier for the exchange, none for the rounds k < 32C.
template <int C, dp::Mode M>
__device__ __forceinline__ void team_row(
    dp::Team<C, M>& tm, float (&v)[C], float (&m)[C],
    float (&sv)[C], const float (&e)[C], const float* srow,
    const uint32_t (&ysh)[(C + 3) / 4], int ypp, int h0) {
  const int lane = tm.lane, j0 = tm.j0;
#pragma unroll
  for (int c = 0; c < C; ++c) tm.xput(0, j0 + c, v[c]);
  tm.sync();
  float sb[C], esh[C];  // the shadow's best and subst[x_r, y_{h-1}]
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sb[c] = tm.xget(0, max(h0 + c, 0));
    esh[c] = srow[dp::code<C>(ysh, c)];
  }
  const float bp1 = tm.xget(0, max(h0 - 1, 0));
  const float bp2 = tm.xget(0, max(h0 - 2, 0));
  const float epp = srow[ypp];
  const bool up = lane > 0;
  // M'[0] from best one column to the left
  const float b_up = __shfl_up_sync(dp::kAll, v[C - 1], 1);
  const float b_top = __shfl_sync(dp::kAll, sb[C - 1], dp::kWarp - 1);
  m[0] = j0 == 0 ? kNeg : (up ? b_up : b_top) + e[0];
  // the shadow's M'
  float sm[C];
#pragma unroll
  for (int c = C - 1; c >= 1; --c) sm[c] = sb[c - 1] + esh[c];
  const float sb_up = __shfl_up_sync(dp::kAll, sb[C - 1], 1);
  sm[0] = h0 == 0 ? kNeg : (up ? sb_up : bp1) + esh[0];
  // the scan inputs, own and shadow: M' + open one column to the left
  const float m_up = __shfl_up_sync(dp::kAll, m[C - 1], 1);
  const float m_top = __shfl_sync(dp::kAll, sm[C - 1], dp::kWarp - 1);
  const float sm_up = __shfl_up_sync(dp::kAll, sm[C - 1], 1);
#pragma unroll
  for (int c = C - 1; c >= 1; --c) {
    v[c] = m[c - 1] + kOpen;
    sv[c] = sm[c - 1] + kOpen;
  }
  v[0] = j0 == 0 ? dp::neg_inf() : (up ? m_up : m_top) + kOpen;
  sv[0] = h0 == 0 ? dp::neg_inf() : (up ? sm_up : bp2 + epp) + kOpen;
  dp::team_scan(v, sv, tm, kExt);
}

template <int C, dp::Mode M>
__global__ void __launch_bounds__(dp::max_threads(M))
    nw_viterbi_kernel(const int* __restrict__ xb, const int* __restrict__ yb,
                      const int* __restrict__ lxb,
                      const int* __restrict__ lyb,
                      const float* __restrict__ subst, int K1, int BX,
                      int BY, int blocks, uint8_t* __restrict__ bits,
                      float* __restrict__ final_rows,
                      float* __restrict__ scores) {
  extern __shared__ __align__(16) float smem[];
  const int b = static_cast<int>(blockIdx.x) / blocks;
  const int lx = lxb[b], ly = lyb[b];
  if (lx < 0 || ly < 0 || lx > BX || ly > BY) return;  // the whole team
  const int W = BY + 1;
  float* sub = smem;
  float* edge = smem + dp::table_floats(K1);
  for (int t = threadIdx.x; t < K1 * K1; t += blockDim.x) sub[t] = subst[t];
  __syncthreads();
  dp::Team<C, M> tm;
  if (!dp::join_team(tm, ly + 1, edge)) return;
  const int j0 = tm.j0, width = tm.width;
  constexpr int kSpan = dp::Team<C, M>::kSpan;
  const int h0 = j0 - kSpan;  // several warps: the shadow's first column

  const int* y = yb + static_cast<size_t>(b) * BY;
  uint32_t yc[(C + 3) / 4];  // the code of column j - 1 (column j >= 1)
#pragma unroll
  for (int q = 0; q < (C + 3) / 4; ++q) yc[q] = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    if (j >= 1 && j < width)
      yc[c >> 2] |= static_cast<uint32_t>(dp::clamp_code(y[j - 1], K1))
                    << (8 * (c & 3));
  }

  // a team of several warps: the codes of the shadow's columns (the
  // same lane's of the warp below), y_{h-1}, and y_{h0-2} for lane 0
  const bool shadow = M != dp::Mode::kWarp && tm.multi;
  uint32_t ysh[(C + 3) / 4];
  int ypp = 0;
#pragma unroll
  for (int q = 0; q < (C + 3) / 4; ++q) ysh[q] = 0;
  if (shadow) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if (h0 + c >= 1)
        ysh[c >> 2] |= static_cast<uint32_t>(dp::clamp_code(y[h0 + c - 1], K1))
                       << (8 * (c & 3));
    if (h0 >= 2) ypp = dp::clamp_code(y[h0 - 2], K1);
  }

  float m[C], d[C], v[C];  // v: I, and between the updates best and M'
  float sv[C];             // several warps: the shadow's scan values
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c, h = h0 + c;
    m[c] = j == 0 ? 0.0f : kNeg;
    d[c] = kNeg;
    v[c] = j == 0 ? dp::neg_inf() : (j == 1 ? 0.0f : kNeg) + kOpen;
    sv[c] = h == 0 ? dp::neg_inf() : (h == 1 ? 0.0f : kNeg) + kOpen;
  }
  if constexpr (M != dp::Mode::kWarp) {
    if (shadow)
      dp::team_scan(v, sv, tm, kExt);
    else
      dp::maxplus_scan(v, tm, kExt);
  } else {
    dp::maxplus_scan(v, tm, kExt);
  }
  if (j0 == 0) v[0] = kNeg;

  const int* x = xb + static_cast<size_t>(b) * BX;
  const size_t out = static_cast<size_t>(b) * BX * W + j0;
  const int real = width - j0;  // this lane's columns below the width
  int xn = lx > 0 ? x[0] : 0;
  for (int r = 0; r < lx; ++r) {
    const float* srow = sub + dp::clamp_code(xn, K1) * K1;
    if (r + 1 < lx) xn = x[r + 1];
    float e[C];  // subst[x_r, y_{j-1}], in flight while the bits go out
#pragma unroll
    for (int c = 0; c < C; ++c) e[c] = srow[dp::code<C>(yc, c)];
    uint32_t pk[(C + 3) / 4];
#pragma unroll
    for (int q = 0; q < (C + 3) / 4; ++q) pk[q] = 0;
#pragma unroll
    for (int c = 0; c < C; ++c)
      pk[c >> 2] |= row_bits(m[c], d[c], v[c]) << (8 * (c & 3));
    store_bits<C>(bits, out + static_cast<size_t>(r) * W, pk, real);

    // best into v, D', then M' from best one column to the left
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float best = fmaxf(fmaxf(m[c], d[c]), v[c]);
      d[c] = fmaxf(m[c] + kOpen, d[c] + kExt);
      v[c] = best;
    }
#pragma unroll
    for (int c = C - 1; c >= 1; --c)
      m[c] = v[c - 1] + e[c];
    if constexpr (M != dp::Mode::kWarp) {
      if (shadow) {
        team_row(tm, v, m, sv, e, srow, ysh, ypp, h0);
        if (j0 == 0) v[0] = kNeg;
        continue;
      }
    }
    float best_left, m_left;
    tm.from_left(v[C - 1], m[C - 1], best_left, m_left);
    m[0] = j0 == 0 ? kNeg : best_left + e[0];
    // I' = scan of M' + open one column to the left
#pragma unroll
    for (int c = C - 1; c >= 1; --c) v[c] = m[c - 1] + kOpen;
    v[0] = j0 == 0 ? dp::neg_inf() : m_left + kOpen;
    dp::maxplus_scan(v, tm, kExt);
    if (j0 == 0) v[0] = kNeg;
  }

  float* fin = final_rows + static_cast<size_t>(b) * 3 * W;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    if (j < width) {
      fin[j] = m[c];
      fin[W + j] = d[c];
      fin[2 * W + j] = v[c];
      if (j == ly) scores[b] = fmaxf(fmaxf(m[c], d[c]), v[c]);
    }
  }
  // no block leaves while another may still read its edge buffer
  if constexpr (M == dp::Mode::kCluster) dp::cluster_sync();
}

struct Launch {
  const int *xb, *yb, *lxb, *lyb;
  const float* subst;
  int K1, B, BX, BY;
  uint8_t* bits;
  float *final_rows, *scores;
  cudaStream_t st;

  template <int C, dp::Mode M>
  cudaError_t run(const dp::Geometry& g) const {
    return dp::launch(nw_viterbi_kernel<C, M>, g, B,
                      dp::smem_bytes(g, K1), st, xb, yb, lxb, lyb, subst,
                      K1, BX, BY, g.blocks, bits, final_rows, scores);
  }
};

}  // namespace

// xb (B, BX), yb (B, BY) int32 codes, lxb/lyb (B,) int32 lengths, subst
// (K1, K1) f32; bits (B, BX, BY+1) uint8, final_rows (B, 3, BY+1) f32
// and scores (B,) f32 (zeroed by the caller: a pair with lx > BX or
// ly > BY keeps zeros). Writes each pair's bit rows < lx and columns
// <= ly, its final columns <= ly and its score; nothing else.
extern "C" int nw_viterbi(const int* xb, const int* yb, const int* lxb,
                          const int* lyb, const float* subst, int K1, int B,
                          int BX, int BY, uint8_t* bits, float* final_rows,
                          float* scores, void* stream) {
  if (B < 1 || BX < 1 || BY < 0 || K1 < 1 || K1 > dp::kMaxAlpha)
    return static_cast<int>(cudaErrorInvalidValue);
  Launch l{xb, yb, lxb, lyb, subst, K1, B, BX, BY, bits, final_rows, scores,
           static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dp::dispatch(BY + 1, l));
}

extern "C" const char* nw_viterbi_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
