// What the brute-force searches (tri_trace.cu, mat_trace.cu) share: the
// misses of masked rays, a block's even share of the live-ray list, and the
// sweep of a packed table staged tile by tile into shared memory by bulk
// copies on mbarriers, double-buffered. Thread 0 starts each copy with the
// bytes it expects; every thread waits on the barrier's phase before it
// reads the tile. Hopper's bulk-copy engine computes the addresses, so the
// copy costs the threads no registers or index arithmetic.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A barrier that completes once one arrival and the expected bytes have
// come. Initialise before any thread waits on it (then fence and
// __syncthreads).
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from `src` into `dst`, completing on `bar`, which expects them.
__device__ __forceinline__ void load_tile(float4* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(b)
      : "memory");
}

// The misses of the masked rays among this block's `block_rays` of the n
// rays (the grid covers N at block_rays a block): t = +inf and idx 0 in
// nearest mode, not occluded in any-hit mode.
template <bool kOcclusion>
__device__ __forceinline__ void write_masked_misses(
    const uint8_t* active, int n, int block_rays, float* t_out, int* i_out,
    uint8_t* occ_out) {
  if (active == nullptr) return;
  const int end = min(n, (static_cast<int>(blockIdx.x) + 1) * block_rays);
  for (int r = blockIdx.x * block_rays + threadIdx.x; r < end;
       r += blockDim.x) {
    if (active[r]) continue;
    if (kOcclusion) {
      occ_out[r] = 0;
    } else {
      t_out[r] = CUDART_INF_F;
      i_out[r] = 0;
    }
  }
}

// This block's share of the live rays, [*first, *first + count) of the
// list: an even split over at least `spread` blocks, in whole warps, at
// most `block_rays` (the grid covers N at block_rays a block, so the
// shares cover every live ray). `n_live` (on the device) counts the list;
// null means every one of the n rays is live.
__device__ __forceinline__ int live_share(const int* n_live, int n,
                                          int spread, int block_rays,
                                          int* first) {
  const int total = n_live == nullptr ? n : *n_live;
  int per = max((total + static_cast<int>(gridDim.x) - 1) /
                    static_cast<int>(gridDim.x),
                (total + spread - 1) / spread);
  per = min(block_rays, (per + 31) & ~31);
  *first = blockIdx.x * per;
  return min(per, total - *first);
}

// Sweeps a packed table of `tp` rows of kRowVec float4s, a tile of kTile
// rows at a time, through the two buffers of `tile` (2 × kTile × kRowVec
// float4s of shared memory) on the barriers `full[2]`: thread 0 starts the
// copy of tile i+1 while the block runs `body(rows, first_row, count)` on
// tile i. Before each tile every thread votes with `sweeping()`; a thread
// that does not sweep skips `body`, and once none of the block sweeps the
// sweep ends (thread 0 first waits for the copy in flight, so none
// outlives the block). The vote is also the barrier that keeps a buffer
// in place until every thread has read it. Call with every thread of the
// block.
template <int kRowVec, int kTile, class Sweeping, class Body>
__device__ __forceinline__ void sweep_tiles(const float* rows, int tp,
                                            float4* tile, uint64_t* full,
                                            Sweeping sweeping, Body body) {
  constexpr uint32_t kRowBytes = kRowVec * 16;
  constexpr int kBuf = kTile * kRowVec;  // float4s a buffer
  const int ntiles = (tp + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    mbar_init_fence();
  }
  for (int i = 0; i < ntiles; ++i) {
    const bool mine = sweeping();
    if (!__syncthreads_or(mine)) {
      if (threadIdx.x == 0 && i > 0) mbar_wait(&full[i & 1], (i >> 1) & 1);
      return;  // tile i is in flight since step i-1: wait for it, then exit
    }
    if (threadIdx.x == 0) {
      if (i == 0)
        load_tile(tile, rows, min(kTile, tp) * kRowBytes, &full[0]);
      if (i + 1 < ntiles)
        load_tile(tile + ((i + 1) & 1) * kBuf,
                  rows + static_cast<size_t>(i + 1) * kTile * kRowVec * 4,
                  min(kTile, tp - (i + 1) * kTile) * kRowBytes,
                  &full[(i + 1) & 1]);
    }
    mbar_wait(&full[i & 1], (i >> 1) & 1);
    if (mine)
      body(tile + (i & 1) * kBuf, i * kTile, min(kTile, tp - i * kTile));
  }
}

}  // namespace
