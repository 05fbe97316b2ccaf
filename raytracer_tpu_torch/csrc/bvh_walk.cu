// Threaded BVH walk of the live rays, in persistent warps, in nearest and
// in any-hit mode.
//
// Replaces the XLA while_loop of raytracer_tpu/accel/bvh.py::bvh_walk (the
// reference has no Pallas kernel for it); its plain torch version is
// accel/bvh.py::bvh_walk, which the card runs as a host-driven loop of ~30
// torch ops per step. Same contract, bit for bit:
//   - inv_d = |d| > 1e-12 ? 1/d (IEEE division) : 1e12, octant from d < 0;
//   - per step: slab test tn = max(max over axes of min(t0, t1), t_min),
//     tf = min over axes of max(t0, t1) (min/max propagate NaN as torch's
//     do); the box is hit when tn <= tf, tf > t_min and tn < bound (best_t;
//     max_t in any-hit mode);
//   - a hit node's listed triangles are tested and folded into (best_t,
//     best_idx) lexicographically on (t, id): the lowest id among the
//     step's t-minima, and (t, id) across steps. An inner node lists none
//     (its plain row is all sentinels: the degenerate zero triangle, a
//     miss with the highest id, which never changes the fold). A node's
//     misses fold (inf, its lowest listed id), which changes best_idx only
//     while best_t is inf: the plain walk's sentinel-padded row does that;
//   - the next node is the hit or miss link of the ray's octant; in any-hit
//     mode a ray parks once best_t < max_t; at most n_nodes + 1 steps;
//   - a masked ray returns (inf, n_tris) without a step.
//
// What bounds it on this card: bytes by the count (the live rays once, the
// tables once a launch), but in fact the latency of each ray's chain of
// dependent loads (node row → link → leaf rows → next node row): a launch
// of few live rays lasts about as long as its longest walk, ~0.6 µs a
// step (PERF.md). The design (after a first one of one ray a thread over
// every lane of N):
//   - Only live rays take slots. With a mask, a first kernel lists the
//     live rays and writes the masked ones' misses: a block takes 2,048
//     lanes, ranks its live ones (live_list.cuh) and reserves their run of
//     the list with one atomic. The list lives in a buffer from the
//     wrapper and its length on the device, so the host builds nothing and
//     reads nothing back. A run holds the live lanes of 2,048 neighbouring
//     pixels of one tile in order, whose walks run alike. (Listing them
//     with torch ops cost ~0.1 ms of device time a launch; scanning N in
//     the walk's own warps, 32 lanes or 256 a fetch, cost more: PERF.md.)
//   - Persistent warps (Aila & Laine, HPG 2009): the grid is as many
//     blocks as the card holds at once, and a warp takes its next 32 live
//     rays from an atomic counter once all its rays have finished, so a
//     long walk holds up its own warp only.
//   - The counters (the walk's next ray, its warps out, the list's length)
//     live with the table, and the walk's last warp out sets them back to
//     0 for the next launch.
//   - One ray a thread (2 and 3, their walks interleaved, measured slower:
//     PERF.md). A node is two 16-byte rows (box min | first slot, box max
//     | count), its link one 8-byte load issued with them, and a leaf's
//     triangles contiguous 48-byte rows (tri_row.cuh's layout) whose loads
//     go out kRows at a time.
//   - A hit leaf's triangles run Möller–Trumbore in stages (mt_staged.cuh):
//     a warp runs the leaf tests of each of its lanes that stands on a hit
//     leaf, and most tests end after u·det, 22 of the 46 operations. Only
//     hits fold; the misses' fold is the node's lowest id while best_t is
//     inf, for a hit leaf as for a missed node.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py). No multiply-add contraction.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "live_list.cuh"
#include "mt_staged.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;  // leaf rows whose loads go out together

// torch.minimum / torch.maximum: a NaN operand gives NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float inv_dir(float d) {
  return fabsf(d) > 1e-12f ? __fdiv_rn(1.0f, d) : 1e12f;
}

// The listed triangles of a hit leaf, `cnt` rows from `s`, tested in stages
// kRows at a time, whose loads go out together: hits fold into (bt, bi).
__device__ __forceinline__ void test_leaf(const float4* s, int cnt, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float t_min,
                                          float& bt, int& bi) {
  const float lim = t_min >= 0.0f ? 0.0f : -CUDART_INF_F;
  bool occl = false;  // unused: the walk folds (t, id) in both modes
  int k = 0;
  for (; k + kRows <= cnt; k += kRows, s += 3 * kRows) {
    float4 row[3 * kRows];
#pragma unroll
    for (int q = 0; q < 3 * kRows; ++q) row[q] = __ldg(s + q);
    test_staged<kRows, false>(row, ox, oy, oz, dx, dy, dz, 0.0f, t_min, lim,
                              bt, bi, occl);
  }
  for (; k < cnt; ++k, s += 3) {
    const float4 row[3] = {__ldg(s), __ldg(s + 1), __ldg(s + 2)};
    test_staged<1, false>(row, ox, oy, oz, dx, dy, dz, 0.0f, t_min, lim, bt,
                          bi, occl);
  }
}

// One ray's whole walk → (t_out, i_out)[ray].
template <bool kOcclusion>
__device__ __forceinline__ void walk_ray(
    int ray, const float* __restrict__ orig, const float* __restrict__ dir,
    const float* __restrict__ max_t, const float4* __restrict__ nodes,
    const int* __restrict__ minid, const int2* __restrict__ links,
    const float4* __restrict__ slots, int nn, int n_tris, float t_min,
    float* __restrict__ t_out, int* __restrict__ i_out) {
  const size_t r = 3 * static_cast<size_t>(ray);
  const float ox = __ldg(orig + r), oy = __ldg(orig + r + 1),
              oz = __ldg(orig + r + 2);
  const float dx = __ldg(dir + r), dy = __ldg(dir + r + 1),
              dz = __ldg(dir + r + 2);
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  const int2* lk = links + static_cast<size_t>(
      (dx < 0.0f) | ((dy < 0.0f) << 1) | ((dz < 0.0f) << 2)) * nn;
  const float mt = kOcclusion ? max_t[ray] : 0.0f;
  float bt = CUDART_INF_F;
  int bi = n_tris;
  int node = 0;
  for (int it = 0; it <= nn && node < nn; ++it) {
    const float4 a = __ldg(nodes + 2 * node);
    const float4 b = __ldg(nodes + 2 * node + 1);
    const int2 l = __ldg(lk + node);
    const int m = __ldg(minid + node);
    const float t0x = (a.x - ox) * ix, t1x = (b.x - ox) * ix;
    const float t0y = (a.y - oy) * iy, t1y = (b.y - oy) * iy;
    const float t0z = (a.z - oz) * iz, t1z = (b.z - oz) * iz;
    const float tn = nan_max(
        nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                nan_min(t0z, t1z)),
        t_min);
    const float tf = nan_min(
        nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)), nan_max(t0z, t1z));
    const float bound = kOcclusion ? mt : bt;
    const bool hit = tn <= tf && tf > t_min && tn < bound;
    if (hit)
      test_leaf(slots + 3 * static_cast<size_t>(__float_as_int(a.w)),
                __float_as_int(b.w), ox, oy, oz, dx, dy, dz, t_min, bt, bi);
    // the misses' fold, a hit leaf's as a missed node's
    if (bt == CUDART_INF_F && m < bi) bi = m;
    node = (kOcclusion && bt < mt) ? nn : (hit ? l.x : l.y);
  }
  t_out[ray] = bt;
  i_out[ray] = bi;
}

// The live lanes of `act` → their run of `live` (live_list.cuh: one run
// and one atomic on `n_live` a block), and the masked lanes' misses.
__global__ void __launch_bounds__(kListThreads)
bvh_live_list_kernel(const uint8_t* __restrict__ act, int n, int n_tris,
                     int* __restrict__ live, int* __restrict__ n_live,
                     float* __restrict__ t_out, int* __restrict__ i_out) {
  list_run(
      act, blockIdx.x * kListRun, n, live,
      [=](int count) { return count > 0 ? atomicAdd(n_live, count) : 0; },
      [=](int r) {
        t_out[r] = CUDART_INF_F;
        i_out[r] = n_tris;
      });
}

template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ orig,    // [N,3]
                const float* __restrict__ dir,     // [N,3]
                const int* __restrict__ live,      // live ray ids or null
                const float* __restrict__ max_t,   // [N] (any-hit only)
                const float4* __restrict__ nodes,  // [nn, 2] rows
                const int* __restrict__ minid,     // [nn]
                const int2* __restrict__ links,    // [8 * nn] hit, miss
                const float4* __restrict__ slots,  // [T, 3] rows
                int* __restrict__ counter,         // next, out, list length
                int n, int nn, int n_tris, float t_min,
                float* __restrict__ t_out, int* __restrict__ i_out) {
  const int total = live == nullptr ? n : counter[2];
  const int lane = threadIdx.x & 31;
  for (;;) {
    // this warp's next 32 live rays: lane l takes entry first + l of the
    // list; a lane past the list's end waits at the next fetch
    int first = 0;
    if (lane == 0) first = atomicAdd(counter, 32);
    first = __shfl_sync(0xffffffffu, first, 0);
    if (first >= total) break;
    const int j = first + lane;
    if (j < total)
      walk_ray<kOcclusion>(live == nullptr ? j : live[j], orig, dir, max_t,
                           nodes, minid, links, slots, nn, n_tris, t_min,
                           t_out, i_out);
  }
  // the launch's last warp out sets the counters back to 0 for the next
  // launch: every other warp has read the list's length and made its last
  // fetch before it counted itself out
  if (lane == 0) {
    __threadfence();
    if (atomicAdd(counter + 1, 1) ==
        static_cast<int>(gridDim.x) * (kThreads / 32) - 1) {
      atomicExch(counter, 0);
      atomicExch(counter + 1, 0);
      atomicExch(counter + 2, 0);
    }
  }
}

// The persistent grid: as many blocks as the card holds at once (at most
// one per kThreads rays), counted once per process.
template <bool kOcclusion>
int grid_blocks(int n) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bvh_walk_kernel<kOcclusion>, kThreads, 0);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  return min(resident, (n + kThreads - 1) / kThreads);
}

template <bool kOcclusion>
void launch(const void* orig, const void* dir, const void* act,
            const void* max_t, const void* nodes, const void* minid,
            const void* links, const void* slots, void* counter, void* live,
            int n, int nn, int n_tris, float t_min, void* t_out, void* i_out,
            cudaStream_t s) {
  int* ctr = static_cast<int*>(counter);
  if (act != nullptr) {
    bvh_live_list_kernel<<<(n + kListRun - 1) / kListRun, kListThreads, 0,
                           s>>>(
        static_cast<const uint8_t*>(act), n, n_tris, static_cast<int*>(live),
        ctr + 2, static_cast<float*>(t_out), static_cast<int*>(i_out));
  }
  bvh_walk_kernel<kOcclusion><<<grid_blocks<kOcclusion>(n), kThreads, 0, s>>>(
      static_cast<const float*>(orig), static_cast<const float*>(dir),
      act != nullptr ? static_cast<const int*>(live) : nullptr,
      static_cast<const float*>(max_t), static_cast<const float4*>(nodes),
      static_cast<const int*>(minid), static_cast<const int2*>(links),
      static_cast<const float4*>(slots), ctr, n, nn, n_tris, t_min,
      static_cast<float*>(t_out), static_cast<int*>(i_out));
}

}  // namespace

// Plain C entry for ctypes. `nodes`: [nn, 8] f32, `minid`: [nn] i32,
// `links`: [8 * nn, 2] i32 and `slots`: [T, 12] f32, the tables of
// ops/bvh_walk.pack_bvh_table and accel/bvh.build_bvh; `act` (null: every
// ray live) and `max_t` (given in any-hit mode, occlusion != 0) may be
// null. `live` is [N] i32 of scratch for the list when `act` is given.
// `counter` is the table's three device ints, 0 before a launch and 0
// again after it: one launch at a time may use them. Launches on
// `stream` (the list kernel, then the walk), does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" int rt_bvh_walk(const void* orig, const void* dir, const void* act,
                           const void* max_t, const void* nodes,
                           const void* minid, const void* links,
                           const void* slots, void* counter, void* live,
                           int n, int nn, int n_tris, float t_min,
                           int occlusion, void* t_out, void* i_out,
                           void* stream) {
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (occlusion)
    launch<true>(orig, dir, act, max_t, nodes, minid, links, slots, counter,
                 live, n, nn, n_tris, t_min, t_out, i_out, s);
  else
    launch<false>(orig, dir, act, max_t, nodes, minid, links, slots, counter,
                  live, n, nn, n_tris, t_min, t_out, i_out, s);
  return static_cast<int>(cudaGetLastError());
}
