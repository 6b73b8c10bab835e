// Kernels pairhmm_fwd_exact and pairhmm_bwd_exact: the pair-HMM forward
// and (reversed) backward lattices in the reference binary's sequential
// LOG_ADD order, the MUSCLE_TPU_EXACT_ASSOC=1 mode.
//
// They replace no Pallas kernel: in the JAX package this mode is an XLA
// scan (muscle_tpu/ops/pairhmm.py: `_forward_scan` / `make_fwd_step` and
// `_backward_scan` / `make_bwd_step` with EXACT_ASSOC, their within-row
// chains `_row_affine_scan_exact(_bwd)`, row 0's `_seq_chain(_bwd)`),
// which its scan backend runs for every pair-HMM pass. Their plain
// versions are ops/pairhmm.py::fwd_exact_wave / bwd_exact_wave.
//
// Arithmetic. Each cell is the plain version's expression, term for term:
// adds are __fadd_rn, and each Horner step of LOG_ADD's cubic is one f32
// FMA (__fmaf_rn). The plain version (ops/logspace.py::logexp1) takes
// each step in double and rounds it once to f32, which is how it emulates
// the FMA that XLA contracts on the CPU; tools/exact_fma_proof.py checks
// every f32 argument in [0, 7.5] and finds the FMA's bits equal to that
// double step's at every one, so kernel, plain version and the JAX scan
// agree bit for bit with no f64 work on the card.
//
// What bounds it: bytes (8 a real cell: the M lattice written, the
// emission read) against ~130-140 f32 operations a cell, so operations
// (~0.1 ms for 512 pairs at 512 x 512 on an H100). For a schedule, the
// chain of dependent cells: cell (i, j) takes (i-1, j-1), (i-1, j) and
// (i, j-1) only, so it can run at step i + j, and a pair takes ~lx + ly
// steps; beyond that, the issue time of the cells' instructions, which
// the design keeps few: a LOG_ADD is ~14 (its segment's coefficients one
// 16-byte shared-memory load indexed by one FMA, the underflow test and
// the select in one predicate), and a run of HC steps has no branch.
//
// Design (the wavefront of row bands of kernel 4, mea_scores.cu). Lane t
// of a warp owns DP row 32 band + t + 1 and computes column s - t at band
// step s: the row above's states come from lane t - 1 by __shfl_up_sync
// (its cell of step s - 1), the diagonal is the lane's previous "up", the
// left cell its own last cell, so a band runs with no block barrier.
// Lane 0 takes the row above from the band above, HC columns a take
// (lane q the q-th, broadcast by __shfl_sync a step): inside a block from
// the band above's hand-over ring in shared memory, between blocks from
// the round above's last row in device memory (`links`, read at L2 a take
// ahead); each state of each column is a 64-bit slot holding its value
// and its column + 1, written by one store, so a reader waits for the
// slots that hold its columns and no fence or count is needed. The
// ring's consumer counts the columns it has used (`taken`), which keeps
// its producer at most RING columns ahead. Band 0's lane 0 computes row
// 0's column s itself at step s (the forward's IY / JY chains, the
// backward's M / IY / JY chain with its LOG_ADD). A block is one round of
// W bands of one pair; it takes a ticket t from an atomic counter and
// runs round t / B of pair t % B, so it waits only on the block of ticket
// t - B, which took its ticket before it: progress never depends on which
// blocks are resident. A block does no work past its pair's lx rows and
// ly columns (bands past lx exit at once, a band runs ly + 32 steps). A
// warp puts its M cells into a tile of 32 rows x MC columns in shared
// memory and writes CWM columns of it at a time row-wise, so a warp's
// store is contiguous. A wait past `wait_cycles` sets *fault and gives up
// (ops/wavefront.check_waits raises on it).
//
// Emission sources (pairhmm_common.cuh): codes with one match table or
// one a pair (the letters, the ensembles' per-pair tables), or a
// (B, Lx, Ly) lattice (Muscle-3D). The backward reads either through
// reversed positions (x position lx - u, y position ly - v), so no
// reversed copy is built.
//
// Outputs: the forward writes fm[b, i-1, j-1] = F_M(i, j) for 1 <= i <=
// lx, 1 <= j <= ly and the five states at (lx, ly); the backward writes
// rbm[b, u, v] = RB_M(u, v) for u <= lx, v <= ly (inside the array) and
// the five states at (lx, ly). Other cells are left unwritten.
#include <climits>

#include "mea_wave.cuh"
#include "pairhmm_common.cuh"

namespace {

constexpr int MAX_WARPS = 4;   // bands a round (warps a block)
constexpr int HC = 8;          // steps a run: columns a take from above
constexpr int RING = 128;      // hand-over ring of a warp, columns
constexpr int MC = 64;         // columns of a warp's M tile (a ring)
constexpr int CWM = 16;        // columns a write of the M tile
// A tile window [c0, c0 + CWM) is complete after lane 31's step c0 + CWM
// + 30 (+1 in the forward, whose lattice column is j - 1) and written at
// the end of the first run past it, before lane 0 reaches column c0 + MC.
static_assert(CWM + 31 + HC < MC && MC % CWM == 0 && CWM == 16, "M tile");
static_assert(RING >= 2 * HC + 32 && (RING & (RING - 1)) == 0, "ring");
// Shared memory a block asks for at least: with the ~96 registers a
// thread the kernels take, more than 3 blocks would share an SM and
// leave too little L1 for the lattice's reads (32 rows a warp): 4 or 5
// blocks an SM made mega-long's chunk up to 30-50 % slower on an H100
// (tools/torch_exact_probe.py --variants: no-smem-floor, 4-blocks)
constexpr size_t SMEM_FLOOR = 58 * 1024;

using mw::FULL;
typedef unsigned long long u64;

__host__ __device__ constexpr float f32c(double c) {
  return static_cast<float>(c);
}

constexpr float LZ = -2e20f;

// The reference's 4-segment cubic for log(1 + e^x) on [0, 7.5]
// (src/scoretype.h:100-109), x in [0, 1], (1, 2.5], (2.5, 4.5], (4.5,
// 7.5], the coefficients rounded to f32 as the plain version rounds them
// (double -> f32).
#define CUBIC0 f32c(-0.009350833524763), f32c(0.130659527668286), \
               f32c(0.498799810682272), f32c(0.693203116424741)
#define CUBIC1 f32c(-0.014532321752540), f32c(0.139942324101744), \
               f32c(0.495635523139337), f32c(0.692140569840976)
#define CUBIC2 f32c(-0.004605031767994), f32c(0.063427417320019), \
               f32c(0.695956496475118), f32c(0.514272634594009)
#define CUBIC3 f32c(-0.000458661602210), f32c(0.009695946122598), \
               f32c(0.930734667215156), f32c(0.168037164329057)
// Its segment's row for each k = ceil(2x) in 0..15: every segment bound
// is a multiple of 1/2, so k selects the segment the plain version's
// (x > 1) + (x > 2.5) + (x > 4.5) selects. Each block copies the table
// to shared memory; a LOG_ADD reads one 16-byte row.
constexpr int CUBIC_ROWS = 16;
__device__ const float kCubic[4 * CUBIC_ROWS] = {
    CUBIC0, CUBIC0, CUBIC0,                  // k = 0, 1, 2: [0, 1]
    CUBIC1, CUBIC1, CUBIC1,                  // 3-5: (1, 2.5]
    CUBIC2, CUBIC2, CUBIC2, CUBIC2,          // 6-9: (2.5, 4.5]
    CUBIC3, CUBIC3, CUBIC3, CUBIC3, CUBIC3,  // 10-15: (4.5, 7.5]
    CUBIC3};

// ceil(2x) for x in [0, 7.5] (x above clamped to 7.5): one FMA rounded
// up onto 1.5 * 2^23, where f32 steps by one, read back as an integer
__device__ __forceinline__ int cubic_row(float x) {
  const float big = 12582912.0f;  // 1.5 * 2^23
  return __float_as_int(__fmaf_ru(fminf(x, 7.5f), 2.0f, big)) -
         __float_as_int(big);
}

// `hi` where LOG_ADD underflows (lo <= f32(-2e20) or d >= 7.5), else
// `sum`: the test and the select in one predicate (a plain ?: lets the
// compiler branch around the cubic).
__device__ __forceinline__ float pick(float lo, float d, float hi,
                                      float sum) {
  float r;
  asm("{\n\t.reg .pred p;\n\t"
      "setp.le.f32 p, %1, 0fE12D78EC;\n\t"
      "setp.ge.or.f32 p, %2, 0f40F00000, p;\n\t"
      "selp.f32 %0, %3, %4, p;\n\t}"
      : "=f"(r)
      : "f"(lo), "f"(d), "f"(hi), "f"(sum));
  return r;
}

// LOG_ADD with the reference's underflow clamps (ops/logspace.py::log_add)
// for finite x, y: where the result is not `hi`, d lies in [0, 7.5), so
// the plain version's clamp of d to [0, 7.5] is the identity there and is
// left out; the cubic runs on every lane.
__device__ __forceinline__ float lsum(float x, float y, const float4* cubic) {
  const float hi = fmaxf(x, y), lo = fminf(x, y);
  const float d = __fsub_rn(hi, lo);
  const float4 c = cubic[cubic_row(d)];
  const float r =
      __fmaf_rn(__fmaf_rn(__fmaf_rn(c.x, d, c.y), d, c.z), d, c.w);
  return pick(lo, d, hi, __fadd_rn(lo, r));
}

// right fold in the reference's association (src/scoretype.h:137-140)
__device__ __forceinline__ float lsum5(float a, float b, float c, float d,
                                       float e, const float4* cubic) {
  return lsum(a, lsum(b, lsum(c, lsum(d, e, cubic), cubic), cubic), cubic);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// r[k] = (a == b ? x[k] : y[k]) for k < N (N = 1, 2, 3, 5): selects
// under one predicate (no branch)
template <int N>
__device__ __forceinline__ void sel_eq(int a, int b, const float (&x)[N],
                                       const float (&y)[N], float (&r)[N]) {
  static_assert(N == 1 || N == 2 || N == 3 || N == 5, "sel_eq");
  if constexpr (N == 1) {
    asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\t"
        "selp.f32 %0, %3, %4, p;\n\t}"
        : "=f"(r[0])
        : "r"(a), "r"(b), "f"(x[0]), "f"(y[0]));
  } else if constexpr (N == 2) {
    asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %2, %3;\n\t"
        "selp.f32 %0, %4, %6, p;\n\tselp.f32 %1, %5, %7, p;\n\t}"
        : "=f"(r[0]), "=f"(r[1])
        : "r"(a), "r"(b), "f"(x[0]), "f"(x[1]), "f"(y[0]), "f"(y[1]));
  } else if constexpr (N == 3) {
    asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %3, %4;\n\t"
        "selp.f32 %0, %5, %8, p;\n\tselp.f32 %1, %6, %9, p;\n\t"
        "selp.f32 %2, %7, %10, p;\n\t}"
        : "=f"(r[0]), "=f"(r[1]), "=f"(r[2])
        : "r"(a), "r"(b), "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(y[0]),
          "f"(y[1]), "f"(y[2]));
  } else {
    asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %5, %6;\n\t"
        "selp.f32 %0, %7, %12, p;\n\tselp.f32 %1, %8, %13, p;\n\t"
        "selp.f32 %2, %9, %14, p;\n\tselp.f32 %3, %10, %15, p;\n\t"
        "selp.f32 %4, %11, %16, p;\n\t}"
        : "=f"(r[0]), "=f"(r[1]), "=f"(r[2]), "=f"(r[3]), "=f"(r[4])
        : "r"(a), "r"(b), "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]),
          "f"(x[4]), "f"(y[0]), "f"(y[1]), "f"(y[2]), "f"(y[3]), "f"(y[4]));
  }
}

__device__ __forceinline__ float sel_eq(int a, int b, float x, float y) {
  float r[1];
  sel_eq<1>(a, b, {x}, {y}, r);
  return r[0];
}

// 64-bit hand-over slots: a state's value and its column + 1 (0: empty)
__device__ __forceinline__ u64 slot_of(float v, int col) {
  return (u64)(unsigned)(col + 1) << 32 | __float_as_uint(v);
}

// A float stored only where p (one predicated store: no branch).
__device__ __forceinline__ void st_global_if(bool p, float* a, float v) {
  asm volatile("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %0, 0;\n\t"
               "@q st.global.f32 [%1], %2;\n\t}" ::"r"((int)p),
               "l"(a), "f"(v));
}

// a link slot read at L2 (L1 is not coherent across SMs)
__device__ __forceinline__ u64 ld_link(const u64* a) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(a));
  return v;
}

struct Scores {
  float tSM, tSI, tSJ, tMM, tMI, tMJ, tII, tIM, tJJ, tJM;
  __device__ explicit Scores(const float* p)
      : tSM(p[ph::TSM]), tSI(p[ph::TSI]), tSJ(p[ph::TSJ]), tMM(p[ph::TMM]),
        tMI(p[ph::TMI]), tMJ(p[ph::TMJ]), tII(p[ph::TII]), tIM(p[ph::TIM]),
        tJJ(p[ph::TJJ]), tJM(p[ph::TJM]) {}
};

// states [M, IX, IY, JX, JY]; the forward hands all five on
enum { SM = 0, SIX = 1, SIY = 2, SJX = 3, SJY = 4, NS = 5 };
// the backward hands on M, IX, JX (the row above as it reads it)
enum { BM = 0, BIX = 1, BJX = 2, BN = 3 };

template <bool B>
struct Tag {
  static constexpr bool value = B;
};

// Shared memory of a block of W warps handing NH states on, in floats:
// the cubic's table, each warp's M tile (32 x MC) and hand-over ring (NH
// x RING 64-bit slots), the rings' reads and the ticket, then the
// emission source's tables.
constexpr int TILES_AT = 4 * CUBIC_ROWS;
__host__ __device__ constexpr int rings_at(int W) {
  return TILES_AT + W * 32 * MC;
}
__host__ __device__ constexpr int taken_at(int W, int NH) {
  return rings_at(W) + W * NH * RING * 2;
}
__host__ __device__ constexpr int tables_at(int W, int NH) {
  return taken_at(W, NH) + ((W + 1 + 3) & ~3);
}

// The band machinery of one warp: where its row above comes from, where
// its last row goes, and the waits on both.
template <int NH>
struct Band {
  int lane, w, W, band, nb, r, ly, LW;
  bool row0_in, ring_in, link_in, ring_out, link_out, alive;
  const volatile u64* rin;  // the ring of warp w - 1: [NH][RING]
  volatile u64* rout;       // this warp's ring
  volatile int* taken;      // taken[k]: columns of ring k read and used
  const u64* lin;           // the round above's last row: [NH][Ly + 1]
  u64* lout;                // this round's last row (the last warp)
  long long limit;
  int* fault;
  u64 hcol[NH], pre[NH];    // lane q: the row above at column s0 + q

  // The warp's band of block `t` (round t / B) of a pair of lx rows and
  // ly columns; false past the pair's last band.
  __device__ bool init(float* smem, int t, int B, int Ly, int lx, int ly_,
                       long long wait_cycles, int* fault_, u64* links) {
    lane = threadIdx.x & 31;
    w = threadIdx.x >> 5;
    W = blockDim.x >> 5;
    r = t / B;
    ly = ly_;
    LW = Ly + 1;
    nb = max(1, (lx + 31) >> 5);
    band = r * W + w;
    if (band >= nb) return false;
    const bool has_out = band + 1 < nb;
    row0_in = band == 0;
    ring_in = w > 0;
    link_in = w == 0 && r > 0;
    ring_out = has_out && w < W - 1;
    link_out = has_out && w == W - 1;
    alive = true;
    u64* rings = reinterpret_cast<u64*>(smem + rings_at(W));
    rin = rings + (w > 0 ? w - 1 : 0) * NH * RING;
    rout = rings + w * NH * RING;
    taken = reinterpret_cast<volatile int*>(smem + taken_at(W, NH));
    const size_t row = (size_t)NH * LW;
    lin = links + (link_in ? (size_t)(t - B) * row : 0);
    lout = links + (link_out ? (size_t)t * row : 0);
    limit = wait_cycles;
    fault = fault_;
    return true;
  }

  __device__ void read_ring(u64* v, int c0) const {
#pragma unroll
    for (int k = 0; k < NH; ++k)
      v[k] = rin[k * RING + ((c0 + lane) & (RING - 1))];
  }

  __device__ void read_link(u64* v, int c0) const {
#pragma unroll
    for (int k = 0; k < NH; ++k) v[k] = ld_link(lin + k * LW + c0 + lane);
  }

  // Lane q < n: until v holds the NH slots of column c0 + q (re-read
  // while a slot holds another column, the warp napping meanwhile).
  __device__ void settle(u64* v, int c0, int n, bool from_ring) {
    const unsigned want = c0 + lane + 1;
    auto short_of = [&] {
      bool bad = false;
#pragma unroll
      for (int k = 0; k < NH; ++k) bad |= (unsigned)(v[k] >> 32) != want;
      return lane < n && bad;
    };
    if (!__any_sync(FULL, short_of()) || !__all_sync(FULL, alive)) return;
    const long long t0 = clock64();
    do {
      __nanosleep(mw::SLEEP_NS);
      if (lane < n) {
        if (from_ring)
          read_ring(v, c0);
        else
          read_link(v, c0);
      }
      if (__any_sync(FULL, clock64() - t0 > limit)) {
        if (lane == 0) atomicExch(fault, 1);
        alive = false;
        break;
      }
    } while (__any_sync(FULL, short_of()));
  }

  __device__ void start() {
    if (link_in && lane < min(HC, ly + 1)) read_link(pre, 0);
  }

  // Before the run of steps s0 .. s0 + HC - 1: the row above's columns
  // s0 .. into hcol, and room in this warp's ring for its lane 31's.
  __device__ void take(int s0) {
    const int n = max(0, min(HC, ly + 1 - s0));
    if (ring_in) {
      // the previous run's columns are read and used: their slots are free
      if (lane == 0) taken[w - 1] = min(s0, ly + 1);
      if (lane < n) read_ring(hcol, s0);
      settle(hcol, s0, n, true);
    } else if (link_in) {
#pragma unroll
      for (int k = 0; k < NH; ++k) hcol[k] = pre[k];
      settle(hcol, s0, n, false);
      const int s1 = s0 + HC;
      if (lane < min(HC, ly + 1 - s1)) read_link(pre, s1);  // a take ahead
    }
    if (ring_out) {
      const int last = min(s0 + HC - 32, ly);  // lane 31's last column
      if (last >= RING)
        mw::wait_taken(taken + w, last + 1 - RING, lane, limit, fault, alive);
    }
  }

  // the row above's state k at lane 0's column s0 + kk
  __device__ float above(int k, int kk) const {
    return __uint_as_float(__shfl_sync(FULL, (unsigned)hcol[k], kk));
  }

  // lane 31's states at its column c = s - 31 to the band below, as
  // plain stores (each slot tagged, so their order is free): as volatile
  // PTX stores, which the compiler keeps in place, a lone band's step
  // took ~20 % longer on an H100 (PERF.md §6)
  __device__ void put(const float* c, int s) {
    const int col = s - 31;
    const bool p = lane == 31 && (unsigned)col <= (unsigned)ly;
    const int at = p ? col : 0;
    u64 v[NH];
#pragma unroll
    for (int k = 0; k < NH; ++k) v[k] = slot_of(c[k], col);
    if (p && ring_out) {
      u64* r = const_cast<u64*>(rout) + (at & (RING - 1));
#pragma unroll
      for (int k = 0; k < NH; ++k) r[k * RING] = v[k];
    }
    if (p && link_out) {
#pragma unroll
      for (int k = 0; k < NH; ++k) lout[at + k * LW] = v[k];
    }
  }
};

// Columns [c0, c0 + CWM) of rows 0 .. nrows - 1 of a warp's M tile to
// out rows row0 .. (row stride `stride`), columns below ncols: 16-byte
// copies, a lane 4 columns of a row, where the rows are 16-byte aligned
// and the window whole (out 16-byte aligned); else lanes 0-15 one row,
// 16-31 the next, a float each.
__device__ __forceinline__ void flush_tile(const float* tile, float* out,
                                           int row0, int nrows, int c0,
                                           int ncols, int stride, int lane) {
  __syncwarp();
  if ((stride & 3) == 0 && c0 + CWM <= ncols) {
    const int q = (lane & 3) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int rr = 8 * k + (lane >> 2);
      if (rr < nrows)
        *reinterpret_cast<float4*>(out + (size_t)(row0 + rr) * stride +
                                   c0 + q) =
            *reinterpret_cast<const float4*>(tile + rr * MC +
                                             ((c0 + q) & (MC - 1)));
    }
  } else {
    const int col = c0 + (lane & 15);
    if (col < ncols) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int rr = 2 * k + (lane >> 4);
        if (rr < nrows)
          out[(size_t)(row0 + rr) * stride + col] =
              tile[rr * MC + (col & (MC - 1))];
      }
    }
  }
  __syncwarp();
}

// The block's ticket (one atomic a block), with the cubic copied, its
// warps' rings emptied and their reads zeroed first.
template <int NH>
__device__ __forceinline__ int take_ticket(float* smem, int* sync) {
  const int W = blockDim.x >> 5;
  for (int k = threadIdx.x; k < 4 * CUBIC_ROWS; k += blockDim.x)
    smem[k] = kCubic[k];
  u64* rings = reinterpret_cast<u64*>(smem + rings_at(W));
  for (int k = threadIdx.x; k < W * NH * RING; k += blockDim.x) rings[k] = 0;
  volatile int* taken =
      reinterpret_cast<volatile int*>(smem + taken_at(W, NH));
  if (threadIdx.x < W) taken[threadIdx.x] = 0;
  if (threadIdx.x == 0) taken[W] = atomicAdd(sync, 1);
  __syncthreads();
  return taken[W];
}

// A pair with no x rows: row 0 alone, in order.
template <typename Src>
__device__ void fwd_row0_only(const Src& src, const Scores& sc, int ly,
                              float* fend) {
  float iy = LZ, jy = LZ;
  for (int j = 1; j <= ly; ++j) {
    const float e = src.insy(j - 1, src.tag(j - 1));
    iy = j == 1 ? add(sc.tSI, e) : add(add(iy, sc.tII), e);
    jy = j == 1 ? add(sc.tSJ, e) : add(add(jy, sc.tJJ), e);
  }
  const float e5[NS] = {LZ, LZ, iy, LZ, jy};
#pragma unroll
  for (int k = 0; k < NS; ++k) fend[k] = e5[k];
}

template <typename Src>
__global__ void __launch_bounds__(MAX_WARPS * 32)
fwd_exact_kernel(typename Src::Args args, const int* __restrict__ lxb,
                 const int* __restrict__ lyb, const float* params,
                 int pstride, int B, int Lx, int Ly, long long wait_cycles,
                 int* sync, int* fault, u64* links, float* __restrict__ fm,
                 float* __restrict__ fend) {
  extern __shared__ __align__(16) float smem[];
  const int t = take_ticket<NS>(smem, sync);
  const int b = t % B;
  Src src(args, b, Lx, Ly, smem + tables_at(blockDim.x >> 5, NS));
  __syncthreads();  // the source's tables, copied by every thread
  const int lx = min(lxb[b], Lx);
  Band<NS> bd;
  if (!bd.init(smem, t, B, Ly, lx, min(lyb[b], Ly), wait_cycles, fault,
               links))
    return;  // past the pair's last band (no barrier follows)
  const Scores sc(ph::pair_params(params, pstride, b));
  const int lane = bd.lane, ly = bd.ly;
  if (lx == 0) {
    if (lane == 0) fwd_row0_only(src, sc, ly, fend + b * NS);
    return;
  }
  const float4* cubic = reinterpret_cast<const float4*>(smem);
  float* tile = smem + TILES_AT + bd.w * 32 * MC;
  const int row0 = bd.band * 32, i = row0 + lane + 1;
  const bool live = i <= lx;
  if (live) src.row(i - 1);
  const float insx = src.insx;
  float* fm_b = fm + (size_t)b * Lx * Ly;
  const int nrows = min(32, lx - row0);
  // the lane of row lx reaches column ly at step end_step (warp-uniform)
  const int end_lane = lx - 1 - row0;
  const int end_step = end_lane < 32 ? ly + end_lane : -1;
  float lf[NS];   // the lane's cell of the step before (its left)
#pragma unroll
  for (int k = 0; k < NS; ++k) lf[k] = LZ;
  // the M fold of this step, from the row above of the step before (its
  // diagonal): computed a step ahead, as soon as that row is in, so its
  // four dependent LOG_ADDs overlap the next step's shuffles and LOG_ADDs
  float mf = LZ;
  float r0iy = LZ, r0jy = LZ;  // band 0: row 0's IY, JY at lane 0's column
  int flushed = 0;             // fm columns written from the tile
  bd.start();

  // A run of HC steps, in four instances: band 0 (row 0 its row above)
  // or not, with the end state's step or not, so that no step branches.
  // Each step's terms come in the order their inputs arrive: its own
  // row's (IY, JY) first, then the row above's (IX, JX, the next fold).
  auto run = [&](int s0, auto row0_tag, auto end_tag) {
    constexpr bool kRow0 = decltype(row0_tag)::value;
    constexpr bool kEnd = decltype(end_tag)::value;
#pragma unroll
    for (int kk = 0; kk < HC; ++kk) {
      const int s = s0 + kk, j = s - lane;
      const int jc = min(max(j - 1, 0), max(ly - 1, 0));  // y position
      const int tg = src.tag(jc);
      const float em = src.emit1(jc, tg), iny = src.insy(jc, tg);
      const float iy = add(
          lsum(add(lf[SIY], sc.tII), add(lf[SM], sc.tMI), cubic), iny);
      const float jy = add(
          lsum(add(lf[SJY], sc.tJJ), add(lf[SM], sc.tMJ), cubic), iny);
      float hin[NS];
      if constexpr (kRow0) {
        // row 0 (src/fwdflat3.cpp:35-93): M, IX, JX zero; IY(0, 1) = tSI +
        // ins(y0), IY(0, j) = (IY(0, j-1) + tII) + ins(y_{j-1}); JY alike
        r0iy = s == 0 ? LZ : s == 1 ? add(sc.tSI, iny)
                                    : add(add(r0iy, sc.tII), iny);
        r0jy = s == 0 ? LZ : s == 1 ? add(sc.tSJ, iny)
                                    : add(add(r0jy, sc.tJJ), iny);
        hin[SM] = hin[SIX] = hin[SJX] = LZ;
        hin[SIY] = r0iy;
        hin[SJY] = r0jy;
      } else {
#pragma unroll
        for (int k = 0; k < NS; ++k) hin[k] = bd.above(k, kk);
      }
      float up[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const float a = __shfl_up_sync(FULL, lf[k], 1);
        up[k] = lane == 0 ? hin[k] : a;
      }
      const float ix = add(
          lsum(add(up[SIX], sc.tII), add(up[SM], sc.tMI), cubic), insx);
      const float jx = add(
          lsum(add(up[SJX], sc.tJJ), add(up[SM], sc.tMJ), cubic), insx);
      // M(1, 1) = tSM + emit (src/fwdflat3.cpp:110-111)
      const float cm = add(sel_eq((i - 1) | (j - 1), 0, sc.tSM, mf), em);
      // the next step's fold: this row above is its diagonal
      mf = lsum5(add(up[SM], sc.tMM), add(up[SIX], sc.tIM),
                 add(up[SJX], sc.tJM), add(up[SIY], sc.tIM),
                 add(up[SJY], sc.tJM), cubic);
      // column 0: IX/JX extend down the first column, M, IY, JY zero
      const float ix0 = sel_eq(i, 1, add(sc.tSI, insx),
                               add(add(up[SIX], sc.tII), insx));
      const float jx0 = sel_eq(i, 1, add(sc.tSJ, insx),
                               add(add(up[SJX], sc.tJJ), insx));
      float c[NS];
      sel_eq<NS>(j, 0, {LZ, ix0, LZ, jx0, LZ}, {cm, ix, iy, jx, jy}, c);
      tile[lane * MC + ((j - 1) & (MC - 1))] = c[SM];
      bd.put(c, s);
      if constexpr (kEnd) {
        if (s == end_step && lane == end_lane) {
#pragma unroll
          for (int k = 0; k < NS; ++k) fend[b * NS + k] = c[k];
        }
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) lf[k] = c[k];
    }
  };

  const int nsteps = ly + 32;
  for (int s0 = 0; s0 < nsteps; s0 += HC) {
    bd.take(s0);
    const bool end_here = (unsigned)(end_step - s0) < (unsigned)HC;
    if (bd.row0_in) {
      if (end_here)
        run(s0, Tag<true>(), Tag<true>());
      else
        run(s0, Tag<true>(), Tag<false>());
    } else if (end_here) {
      run(s0, Tag<false>(), Tag<true>());
    } else {
      run(s0, Tag<false>(), Tag<false>());
    }
    const int s_end = s0 + HC - 1;
    // lattice column c of lane 31 is written at step c + 32
    while (flushed < ly && s_end >= flushed + CWM + 31) {
      flush_tile(tile, fm_b, row0, nrows, flushed, ly, Ly, lane);
      flushed += CWM;
    }
  }
  for (; flushed < ly; flushed += CWM)
    flush_tile(tile, fm_b, row0, nrows, flushed, ly, Ly, lane);
}

// A pair with no x rows: row 0 alone, in order.
template <typename Src>
__device__ void bwd_row0_only(const Src& src, const Scores& sc, int ly,
                              int Ly, float* rb, float* far,
                              const float4* cubic) {
  float iy = sc.tSI, jy = sc.tSJ, m = sc.tSM, ix = sc.tSI, jx = sc.tSJ;
  rb[0] = m;
  for (int v = 1; v <= ly; ++v) {
    const float e = src.insy(ly - v, src.tag(ly - v));
    const float nyi = add(iy, e), nyj = add(jy, e);
    iy = add(sc.tII, nyi);
    jy = add(sc.tJJ, nyj);
    m = lsum(add(sc.tMI, nyi), add(sc.tMJ, nyj), cubic);
    ix = jx = LZ;
    if (v < Ly) rb[v] = m;
  }
  const float e5[NS] = {m, ix, iy, jx, jy};
#pragma unroll
  for (int k = 0; k < NS; ++k) far[k] = e5[k];
}

template <typename Src>
__global__ void __launch_bounds__(MAX_WARPS * 32)
bwd_exact_kernel(typename Src::Args args, const int* __restrict__ lxb,
                 const int* __restrict__ lyb, const float* params,
                 int pstride, int B, int Lx, int Ly, long long wait_cycles,
                 int* sync, int* fault, u64* links, float* __restrict__ rbm,
                 float* __restrict__ far) {
  extern __shared__ __align__(16) float smem[];
  const int t = take_ticket<BN>(smem, sync);
  const int b = t % B;
  Src src(args, b, Lx, Ly, smem + tables_at(blockDim.x >> 5, BN));
  __syncthreads();  // the source's tables, copied by every thread
  const int lx = min(lxb[b], Lx);
  Band<BN> bd;
  if (!bd.init(smem, t, B, Ly, lx, min(lyb[b], Ly), wait_cycles, fault,
               links))
    return;  // past the pair's last band (no barrier follows)
  const Scores sc(ph::pair_params(params, pstride, b));
  const int lane = bd.lane, ly = bd.ly;
  const float4* cubic = reinterpret_cast<const float4*>(smem);
  float* rb = rbm + (size_t)b * Lx * Ly;
  if (lx == 0) {
    if (lane == 0) bwd_row0_only(src, sc, ly, Ly, rb, far + b * NS, cubic);
    return;
  }
  float* tile = smem + TILES_AT + bd.w * 32 * MC;
  const int row0 = bd.band * 32, u = row0 + lane + 1;
  const bool live = u <= lx;
  if (live) src.row(lx - u);
  const float insx = src.insx;
  // rows u = row0 + 1 .. of the band that lie inside the pair and the array
  const int nrows = min(32, min(lx, Lx - 1) - row0);
  const int ncols = min(ly + 1, Ly);
  const int end_lane = lx - 1 - row0;
  const int end_step = end_lane < 32 ? ly + end_lane : -1;
  float cur[BN] = {LZ, LZ, LZ};
  float dm = 0.0f, liy = LZ, ljy = LZ;
  // band 0: row 0's IY, JY chains (IY(0, 0) = tSI, JY(0, 0) = tSJ)
  float r0iy = sc.tSI, r0jy = sc.tSJ;
  int flushed = 0;  // rbm columns written from the tile
  bd.start();

  // A run of HC steps in four instances, as the forward's, each step's
  // terms in the order their inputs arrive: its own row's and the
  // diagonal's (IY, JY, the fold's two innermost terms) before the row
  // above's (IX, JX, the rest of the fold).
  auto run = [&](int s0, auto row0_tag, auto end_tag) {
    constexpr bool kRow0 = decltype(row0_tag)::value;
    constexpr bool kEnd = decltype(end_tag)::value;
#pragma unroll
    for (int kk = 0; kk < HC; ++kk) {
      const int s = s0 + kk, v = s - lane;
      const int yc = min(max(ly - v, 0), max(ly - 1, 0));  // y position
      const int tg = src.tag(yc);
      const float em = src.emit1(yc, tg), iny = src.insy(yc, tg);
      const float nm = add(dm, em);
      const float nyi = add(liy, iny), nyj = add(ljy, iny);
      const float iy = lsum(add(sc.tII, nyi), add(sc.tIM, nm), cubic);
      const float jy = lsum(add(sc.tJJ, nyj), add(sc.tJM, nm), cubic);
      const float inner = lsum(add(sc.tMI, nyi), add(sc.tMJ, nyj), cubic);
      float hin[BN];
      if constexpr (kRow0) {
        // row u = 0 (i = LX): IY(0,v) = tII + (IY(0,v-1) + ins(yr_{v-1})),
        // M(0,v) = LOG_ADD(tMI + (IY + ins), tMJ + (JY + ins)), M(0,0) =
        // tSM; IX, JX are tSI, tSJ at v = 0 and zero beyond
        const float ny0i = add(r0iy, iny), ny0j = add(r0jy, iny);
        const float m = lsum(add(sc.tMI, ny0i), add(sc.tMJ, ny0j), cubic);
        const bool v0 = s == 0;
        r0iy = v0 ? r0iy : add(sc.tII, ny0i);
        r0jy = v0 ? r0jy : add(sc.tJJ, ny0j);
        sel_eq<BN>(s, 0, {sc.tSM, sc.tSI, sc.tSJ}, {m, LZ, LZ}, hin);
        st_global_if(lane == 0 && s <= ly && s < Ly, rb + min(s, Ly - 1),
                     hin[BM]);
      } else {
#pragma unroll
        for (int k = 0; k < BN; ++k) hin[k] = bd.above(k, kk);
      }
      float up[BN];
#pragma unroll
      for (int k = 0; k < BN; ++k) {
        const float a = __shfl_up_sync(FULL, cur[k], 1);
        up[k] = lane == 0 ? hin[k] : a;
      }
      const float nix = add(up[BIX], insx), njx = add(up[BJX], insx);
      // column 0 (j = LY): IX = tII + (IX + Emit_x), M = LOG_ADD(tMI + ..,
      // tMJ + ..), IY, JY zero; the same LOG_ADD as the inner IX's
      float arg[2];
      sel_eq<2>(v, 0, {add(sc.tMI, nix), add(sc.tMJ, njx)},
                {add(sc.tII, nix), add(sc.tIM, nm)}, arg);
      const float l1 = lsum(arg[0], arg[1], cubic);
      const float jx = lsum(add(sc.tJJ, njx), add(sc.tJM, nm), cubic);
      // the fold lsum5(tMM + nm, tMI + nix, tMJ + njx, tMI + nyi, tMJ +
      // nyj), its innermost LOG_ADD taken above
      const float mf = lsum(
          add(sc.tMM, nm),
          lsum(add(sc.tMI, nix), lsum(add(sc.tMJ, njx), inner, cubic), cubic),
          cubic);
      float c5[NS];  // [M, IX, IY, JX, JY]
      sel_eq<NS>(v, 0, {l1, add(sc.tII, nix), LZ, add(sc.tJJ, njx), LZ},
                 {mf, l1, iy, jx, jy}, c5);
      const float c[BN] = {c5[SM], c5[SIX], c5[SJX]};
      tile[lane * MC + (v & (MC - 1))] = c[BM];
      bd.put(c, s);
      if constexpr (kEnd) {
        if (s == end_step && lane == end_lane) {
#pragma unroll
          for (int k = 0; k < NS; ++k) far[b * NS + k] = c5[k];
        }
      }
      dm = up[BM];
      liy = c5[SIY];
      ljy = c5[SJY];
#pragma unroll
      for (int k = 0; k < BN; ++k) cur[k] = c[k];
    }
  };

  const int nsteps = ly + 32;
  for (int s0 = 0; s0 < nsteps; s0 += HC) {
    bd.take(s0);
    const bool end_here = (unsigned)(end_step - s0) < (unsigned)HC;
    if (bd.row0_in) {
      if (end_here)
        run(s0, Tag<true>(), Tag<true>());
      else
        run(s0, Tag<true>(), Tag<false>());
    } else if (end_here) {
      run(s0, Tag<false>(), Tag<true>());
    } else {
      run(s0, Tag<false>(), Tag<false>());
    }
    const int s_end = s0 + HC - 1;
    // column v of lane 31 is written at step v + 31
    while (flushed < ncols && s_end >= flushed + CWM + 30) {
      flush_tile(tile, rb, row0 + 1, nrows, flushed, ncols, Ly, lane);
      flushed += CWM;
    }
  }
  for (; flushed < ncols; flushed += CWM)
    flush_tile(tile, rb, row0 + 1, nrows, flushed, ncols, Ly, lane);
}

template <bool kFwd, typename Src>
int launch(const typename Src::Args& args, int B, int warps, cudaStream_t st,
           const int* lxb, const int* lyb, const float* params, int per_pair,
           int Lx, int Ly, long long wait_cycles, int* sync, int* fault,
           u64* links, float* lat, float* ends) {
  if (B == 0) return 0;
  if (warps < 1 || warps > MAX_WARPS || Lx < 1 || Ly < 1)
    return cudaErrorInvalidValue;
  const long long rounds = ((Lx + 31) / 32 + warps - 1) / warps;
  if (rounds * B > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = kFwd ? &fwd_exact_kernel<Src> : &bwd_exact_kernel<Src>;
  // at least SMEM_FLOOR a block, so at most 3 blocks an SM
  const size_t need =
      sizeof(float) * ((size_t)tables_at(warps, kFwd ? NS : BN) +
                       Src::table_floats(args));
  const size_t smem = need > SMEM_FLOOR ? need : SMEM_FLOOR;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(int)(rounds * B), warps * 32, smem, st>>>(
      args, lxb, lyb, params, per_pair ? 16 : 0, B, Lx, Ly, wait_cycles, sync,
      fault, links, lat, ends);
  return cudaGetLastError();
}

template <bool kFwd>
int dispatch(int source, const int* xb, const int* yb, const float* match,
             const float* insert, int kk, int per_pair_tables, const float* e,
             const float* ins_x, const float* ins_y, const int* lxb,
             const int* lyb, const float* params, int per_pair, int B,
             int Lx, int Ly, int warps, long long wait_cycles, int* sync,
             int* fault, u64* links, float* lat, float* ends, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (source == 0) {
    const ph::CodeEmission::Args a{xb, yb, match, insert, kk,
                                   per_pair_tables ? kk * kk : 0,
                                   per_pair_tables ? kk : 0};
    return launch<kFwd, ph::CodeEmission>(a, B, warps, st, lxb, lyb, params,
                                          per_pair, Lx, Ly, wait_cycles, sync,
                                          fault, links, lat, ends);
  }
  const ph::LatticeEmission::Args a{e, ins_x, ins_y};
  return launch<kFwd, ph::LatticeEmission>(a, B, warps, st, lxb, lyb, params,
                                           per_pair, Lx, Ly, wait_cycles,
                                           sync, fault, links, lat, ends);
}

}  // namespace

// source 0: codes xb (B, Lx), yb (B, Ly) with match (K+1)^2 / insert (K+1)
// tables, shared or one a pair (per_pair_tables); source 1: the lattice
// e (B, Lx, Ly) with ins_x (B, Lx), ins_y (B, Ly). params (16,) or
// (B, 16) (per_pair). `warps` bands a round (a block), B * ceil(ceil(Lx /
// 32) / warps) blocks; sync: one int32, zeroed (the ticket); links: a row
// of 5 x (Ly + 1) 64-bit slots a block, zeroed (its last row, by its
// ticket). A wait past `wait_cycles` sets *fault. Writes fm (B, Lx, Ly)
// and fend (B, 5).
extern "C" int pairhmm_fwd_exact(int source, const int* xb, const int* yb,
                                 const float* match, const float* insert,
                                 int kk, int per_pair_tables, const float* e,
                                 const float* ins_x, const float* ins_y,
                                 const int* lxb, const int* lyb,
                                 const float* params, int per_pair, int B,
                                 int Lx, int Ly, int warps,
                                 long long wait_cycles, int* sync, int* fault,
                                 u64* links, float* fm, float* fend,
                                 void* stream) {
  return dispatch<true>(source, xb, yb, match, insert, kk, per_pair_tables,
                        e, ins_x, ins_y, lxb, lyb, params, per_pair, B, Lx,
                        Ly, warps, wait_cycles, sync, fault, links, fm, fend,
                        stream);
}

// The same arguments, link rows of 3 x (Ly + 1) slots; writes rbm (B, Lx,
// Ly) = RB_M(u, v) and far (B, 5) = the states at RB(lx, ly).
extern "C" int pairhmm_bwd_exact(int source, const int* xb, const int* yb,
                                 const float* match, const float* insert,
                                 int kk, int per_pair_tables, const float* e,
                                 const float* ins_x, const float* ins_y,
                                 const int* lxb, const int* lyb,
                                 const float* params, int per_pair, int B,
                                 int Lx, int Ly, int warps,
                                 long long wait_cycles, int* sync, int* fault,
                                 u64* links, float* rbm, float* far,
                                 void* stream) {
  return dispatch<false>(source, xb, yb, match, insert, kk, per_pair_tables,
                         e, ins_x, ins_y, lxb, lyb, params, per_pair, B, Lx,
                         Ly, warps, wait_cycles, sync, fault, links, rbm, far,
                         stream);
}
