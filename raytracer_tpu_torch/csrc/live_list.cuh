// Lists of live lanes built on the device, shared by the BVH walk
// (bvh_walk.cu) and the culled sweep (cull_sweep.cu), so that neither
// wrapper runs a torch op per launch. A block of kListThreads threads takes
// a run of kListRun lanes of a bool mask (lane first + k·kListThreads +
// thread, k < kListPer: each load coalesced), ranks the live ones by
// ballots and a prefix of the warps' counts, in ascending lane order, and
// writes them to the run of the list that thread 0's reserve(count)
// returns.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kListThreads = 256;
constexpr int kListPer = 8;  // lanes a thread takes a run
constexpr int kListRun = kListThreads * kListPer;

// The run of lanes [first, first + kListRun) below `end`: the live ones go
// to live[at + rank], at = reserve(their count) (called by thread 0, once),
// and dead(lane) is called on each masked one. Returns the count to every
// thread; every thread of the block calls it, and it ends on a barrier.
template <class Reserve, class Dead>
__device__ __forceinline__ int list_run(const uint8_t* __restrict__ act,
                                        int first, int end,
                                        int* __restrict__ live,
                                        Reserve reserve, Dead dead) {
  constexpr int kWarps = kListThreads / 32;
  __shared__ int before[kListPer][kWarps];
  __shared__ int s_at, s_total;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int mine = first + threadIdx.x;
  bool on[kListPer];
  unsigned ballot[kListPer];
#pragma unroll
  for (int k = 0; k < kListPer; ++k) {
    const int r = mine + k * kListThreads;
    on[k] = r < end && act[r];
    if (r < end && !on[k]) dead(r);
    ballot[k] = __ballot_sync(0xffffffffu, on[k]);
    if (lane == 0) before[k][warp] = __popc(ballot[k]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kListPer; ++k)
      for (int w = 0; w < kWarps; ++w) {
        const int c = before[k][w];
        before[k][w] = total;
        total += c;
      }
    s_total = total;
    s_at = reserve(total);
  }
  __syncthreads();
  const int at = s_at, total = s_total;
#pragma unroll
  for (int k = 0; k < kListPer; ++k)
    if (on[k])
      live[at + before[k][warp] + __popc(ballot[k] & below)] =
          mine + k * kListThreads;
  __syncthreads();  // before[], s_at and s_total are free for the next run
  return total;
}

}  // namespace
