// The hand-over of kernels 5 and 6 (pairhmm_fwd_stripe.cu,
// pairhmm_bwd_stripe.cu): one launch runs every stripe of every pair of
// a batch as a skewed wavefront of groups.
//
// A group is one pair and G consecutive 64-lane segments of its padded
// row (one warp a segment, G dividing the W / 64 segments of a stripe,
// so a group never straddles a stripe edge). Group k of a pair needs
// from group k - 1, at each DP row (or backward step), only a few values
// of that row: the edge of the row's fold and M, and either the IY/JY
// chain carry leaving its last segment or, at a stripe edge, its last
// column. So group k runs row i as soon as group k - 1 has published row
// i, and the groups of a pair run at once on as many SMs, a few rows
// apart.
//
// The hand-over buffer in device memory holds one record a row for each
// group's right neighbour. The group's last thread writes its record
// with __stcg after each row and, every R rows and after its last,
// publishes the count of rows done with st.release.gpu (the release
// orders the records before it). Warp 0 of the consumer takes up to 32
// published records at a time: lane 0 polls the count with
// ld.acquire.gpu, __syncwarp orders the acquire before the lanes' loads,
// and lane k loads the record of row base + k with __ldcg (L1 is not
// coherent across SMs), to be handed out by shuffles row by row.
//
// Forward progress does not depend on which blocks are resident: each
// block takes a ticket from an atomic counter, and ticket t is group
// t / B of pair t % B, so a block waits only on a block that took its
// ticket before it (and is running or done). The wrapper zeroes the
// ticket, the counters and the records before each launch; the kernel
// allocates nothing. A wait longer than `wait_ns` (device clock) sets a
// fault flag that the wrapper keeps for the device and lets the block
// run on: every block then ends, and the orchestration raises on the
// flag, so a deadlock surfaces as an error, never as a silent pass or
// a hang.
#pragma once

#include <climits>
#include <cuda_runtime.h>

namespace wf {

// sync buffer: [ticket, progress[B * groups]]
enum { TICKET = 0, PROGRESS = 1 };

constexpr int RING = 32;  // records warp 0 holds, one a lane

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ long long clock_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Rows the producer has published once it has published more than
// `need`; on a wait past `wait_ns` (or after an earlier one: `wait_ns`
// is then 0), INT_MAX with the fault flag set.
__device__ __forceinline__ int wait_past(const int* progress, int need,
                                         long long& wait_ns, int* fault) {
  int v = ld_acquire(progress);
  if (v > need) return v;
  if (wait_ns <= 0) return INT_MAX;
  const long long t0 = clock_ns();
  while ((v = ld_acquire(progress)) <= need) {
    if (clock_ns() - t0 > wait_ns) {
      atomicExch(fault, 1);
      wait_ns = 0;
      return INT_MAX;
    }
    __nanosleep(100);
  }
  return v;
}

// The block's ticket -> (pair, group): group t / B of pair t % B.
__device__ __forceinline__ int take_ticket(int* sync) {
  __shared__ int s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(sync + TICKET, 1);
  __syncthreads();
  return s_ticket;
}

// A record: one row's hand-over, four floats (kernel 5) or eight
// (kernel 6), written and read past L1.
struct Rec4 {
  float4 v;
};
struct Rec8 {
  float4 v0, v1;
};
__device__ __forceinline__ Rec4 ldcg(const Rec4* p) { return {__ldcg(&p->v)}; }
__device__ __forceinline__ Rec8 ldcg(const Rec8* p) {
  return {__ldcg(&p->v0), __ldcg(&p->v1)};
}
__device__ __forceinline__ void stcg(Rec4* p, const Rec4& r) {
  __stcg(&p->v, r.v);
}
__device__ __forceinline__ void stcg(Rec8* p, const Rec8& r) {
  __stcg(&p->v0, r.v0);
  __stcg(&p->v1, r.v1);
}

// Field f of the record of row `row` from warp 0's window (all of warp
// 0 calls it; the lane holding that row hands it out).
__device__ __forceinline__ float field(const float4& v, int f, int src) {
  const float x = f == 0 ? v.x : f == 1 ? v.y : f == 2 ? v.z : v.w;
  return __shfl_sync(0xffffffffu, x, src);
}

// Warp 0's window on the left group's records: lane k holds the record
// of row base + k for base + k < ready. `refill(i, end, lane)` (all of
// warp 0, at a row i == ready) waits until row i is published and takes
// in what is (at most RING rows, none at or past `end`).
template <typename Rec>
struct Window {
  const int* progress;
  const Rec* recs;
  int* fault;
  long long wait_ns;
  int base, ready;
  Rec rec;

  __device__ Window(const int* progress_, const Rec* recs_, int* fault_,
                    long long wait_ns_, int start)
      : progress(progress_), recs(recs_), fault(fault_), wait_ns(wait_ns_),
        base(start), ready(start), rec() {}

  __device__ void refill(int i, int end, int lane) {
    int avail = 0;
    if (lane == 0) avail = wait_past(progress, i, wait_ns, fault);
    __syncwarp();
    avail = __shfl_sync(0xffffffffu, avail, 0);
    base = i;
    ready = min(min(avail, end), i + RING);
    if (base + lane < ready) rec = ldcg(recs + base + lane);
  }
};

// The producer's side: after row i (rows counted from `start`), every
// `every` rows and after the last (`end` - 1), publish i + 1.
__device__ __forceinline__ void publish(int* progress, int i, int start,
                                        int end, int every) {
  if ((i + 1 - start) % every == 0 || i + 1 == end) st_release(progress, i + 1);
}

}  // namespace wf
