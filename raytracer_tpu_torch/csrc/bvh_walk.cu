// Threaded BVH walk — one ray per thread, the whole stackless walk inside
// the kernel, in nearest and in any-hit mode.
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
//     miss with the highest id, which never changes the fold). A missed
//     leaf folds (inf, its lowest listed id), which changes best_idx only
//     while best_t is inf: the plain walk's sentinel-padded row does that;
//   - the next node is the hit or miss link of the ray's octant; in any-hit
//     mode a ray parks once best_t < max_t; at most n_nodes + 1 steps.
//
// What bounds it on this card: like the grid walk, the latency of a ray's
// chain of dependent loads (node row → link → leaf rows), not bytes or
// arithmetic. The design keeps each step's loads few and wide: a node is
// two 16-byte rows (box min | first slot, box max | count), its links one
// 8-byte load issued with them, and a leaf's triangles contiguous 48-byte
// rows (tri_row.cuh) whose loads go out together.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py). No multiply-add contraction.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tri_row.cuh"

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

__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ orig,    // [N,3]
                const float* __restrict__ dir,     // [N,3]
                const uint8_t* __restrict__ act,   // [N] bool or null
                const float* __restrict__ max_t,   // [N] (occlusion only)
                const float4* __restrict__ nodes,  // [nn, 2] rows
                const int* __restrict__ minid,     // [nn]
                const int2* __restrict__ links,    // [8 * nn] hit, miss
                const float4* __restrict__ slots,  // [T, 3] rows
                int n, int nn, int n_tris, float t_min, int occlusion,
                float* __restrict__ t_out, int* __restrict__ i_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  float bt = CUDART_INF_F;
  int bi = n_tris;
  if (act == nullptr || act[r]) {
    const float ox = orig[3 * r], oy = orig[3 * r + 1], oz = orig[3 * r + 2];
    const float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
    const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
    const int2* lk = links + static_cast<size_t>(
        (dx < 0.0f) | ((dy < 0.0f) << 1) | ((dz < 0.0f) << 2)) * nn;
    const float mt = occlusion ? max_t[r] : 0.0f;
    int node = 0;
    for (int it = 0; it <= nn && node < nn; ++it) {
      const float4 a = __ldg(nodes + 2 * node);
      const float4 b = __ldg(nodes + 2 * node + 1);
      const int2 l = __ldg(lk + node);
      const float t0x = (a.x - ox) * ix, t1x = (b.x - ox) * ix;
      const float t0y = (a.y - oy) * iy, t1y = (b.y - oy) * iy;
      const float t0z = (a.z - oz) * iz, t1z = (b.z - oz) * iz;
      const float tn = nan_max(
          nan_max(nan_max(nan_min(t0x, t1x), nan_min(t0y, t1y)),
                  nan_min(t0z, t1z)),
          t_min);
      const float tf = nan_min(
          nan_min(nan_max(t0x, t1x), nan_max(t0y, t1y)), nan_max(t0z, t1z));
      const float bound = occlusion ? mt : bt;
      const bool hit = tn <= tf && tf > t_min && tn < bound;
      if (hit) {
        // the leaf's rows, kRows at a time: all their loads go out together
        const int cnt = __float_as_int(b.w);
        const float4* s = slots + 3 * static_cast<size_t>(__float_as_int(a.w));
        int k = 0;
        for (; k + kRows <= cnt; k += kRows, s += 3 * kRows) {
          float4 row[3 * kRows];
#pragma unroll
          for (int q = 0; q < 3 * kRows; ++q) row[q] = __ldg(s + q);
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            test_row(row[3 * j], row[3 * j + 1], row[3 * j + 2], ox, oy, oz,
                     dx, dy, dz, t_min, bt, bi);
        }
        for (; k < cnt; ++k, s += 3)
          test_row(__ldg(s), __ldg(s + 1), __ldg(s + 2), ox, oy, oz, dx, dy,
                   dz, t_min, bt, bi);
      } else if (bt == CUDART_INF_F) {
        const int m = __ldg(minid + node);
        if (m < bi) bi = m;
      }
      node = (occlusion && bt < mt) ? nn : (hit ? l.x : l.y);
    }
  }
  t_out[r] = bt;
  i_out[r] = bi;
}

}  // namespace

// Plain C entry for ctypes. `nodes`: [nn, 8] f32, `minid`: [nn] i32,
// `links`: [8 * nn, 2] i32 and `slots`: [T, 12] f32, the tables of
// ops/bvh_walk.pack_bvh_table and accel/bvh.build_bvh; `act` and `max_t`
// may be null. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int rt_bvh_walk(const void* orig, const void* dir, const void* act,
                           const void* max_t, const void* nodes,
                           const void* minid, const void* links,
                           const void* slots, int n, int nn, int n_tris,
                           float t_min, int occlusion, void* t_out,
                           void* i_out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  bvh_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(orig), static_cast<const float*>(dir),
      static_cast<const uint8_t*>(act), static_cast<const float*>(max_t),
      static_cast<const float4*>(nodes), static_cast<const int*>(minid),
      static_cast<const int2*>(links), static_cast<const float4*>(slots), n,
      nn, n_tris, t_min, occlusion, static_cast<float*>(t_out),
      static_cast<int*>(i_out));
  return static_cast<int>(cudaGetLastError());
}
