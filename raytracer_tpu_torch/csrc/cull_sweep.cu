// Culled-list triangle sweep: every ray of a list is tested against the
// list's triangles, nearest or any hit.
//
// Port-only: the reference keeps this sweep in XLA
// (raytracer_tpu/accel/cull.py::_dense_nearest and ::_dense_occluded, a
// chunked broadcast Möller–Trumbore over a per-tile culled id list; no
// pallas_call). Same contract: over the first min(count, cap) ids of a
// ray's list, the nearest hit with t > t_min, ties to the lowest id
// (nearest), or any hit with t < max_t (any-hit); a lane whose `active` byte
// is 0 (outside the mesh AABB, or masked by the caller) misses with
// (inf, n_tris). A list that overflowed its cap is truncated at cap, as
// the reference truncates it.
//
// What bounds it: operations. Every live lane runs Möller–Trumbore on every
// id of its list (46 fp32 operations a test); the bytes are the rays, the
// ids and each listed row once. The design:
//   - one CTA per (list, slice of kThreads lanes): the lanes of a list share
//     its ids, so the CTA stages them into shared memory kChunk rows at a
//     time (48-byte packed rows v0|e1|e2|id|0|0, csrc/tri_row.cuh; 6 KiB a
//     chunk) and every thread reads each staged row as a broadcast;
//   - the loop runs to the list's count, not to cap: an empty list costs a
//     launch slot only, and a CTA whose lanes are all inactive or all done
//     (any-hit) leaves at the next chunk;
//   - any-hit lanes stop testing at their first occluder.
// Every t comes from test_row, in the operation order of
// geometry.triangle_tuv, and the fold is the lexicographic (t, id) minimum,
// so the kernel equals the plain version (ops/cull_sweep.py) bit for bit
// and gives the grid walk's (csrc/grid_walk.cu) hits on rays whose list
// holds every triangle they can hit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tri_row.cuh"

namespace {

constexpr int kThreads = 256;  // lanes of one list per CTA
constexpr int kChunk = 128;    // rows staged per step: 128 × 48 B = 6 KiB

template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
cull_sweep_kernel(const float* __restrict__ orig,     // [N,3]
                  const float* __restrict__ dir,      // [N,3]
                  const uint8_t* __restrict__ act,    // [N] bool
                  const float* __restrict__ max_t,    // [N] (any-hit only)
                  const int* __restrict__ ids,        // [n_lists, cap]
                  const int* __restrict__ counts,     // [n_lists]
                  const float4* __restrict__ rows,    // [n_tris + 1, 3]
                  int tile, int cap, int n_tris, float t_min,
                  float* __restrict__ t_out, int* __restrict__ i_out,
                  uint8_t* __restrict__ occ_out) {
  __shared__ float4 s_rows[3 * kChunk];
  const int list = blockIdx.y;
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  const bool in_tile = lane < tile;
  const size_t r = static_cast<size_t>(list) * tile + lane;
  bool live = in_tile && act[r];
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float mt = 0.0f;
  if (live) {
    ox = orig[3 * r];
    oy = orig[3 * r + 1];
    oz = orig[3 * r + 2];
    dx = dir[3 * r];
    dy = dir[3 * r + 1];
    dz = dir[3 * r + 2];
    if (kOcclusion) mt = max_t[r];
  }
  float bt = CUDART_INF_F;
  int bi = n_tris;
  const int count = min(counts[list], cap);
  const int* lid = ids + static_cast<size_t>(list) * cap;
  for (int k0 = 0; k0 < count; k0 += kChunk) {
    // a barrier too: every thread is done with the last chunk's rows
    if (!__syncthreads_or(live)) break;
    const int m = min(kChunk, count - k0);
    for (int q = threadIdx.x; q < 3 * m; q += kThreads) {
      const int id = __ldg(lid + k0 + q / 3);
      s_rows[q] = __ldg(rows + 3 * static_cast<size_t>(id) + q % 3);
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < m; ++j) {
        test_row(s_rows[3 * j], s_rows[3 * j + 1], s_rows[3 * j + 2], ox, oy,
                 oz, dx, dy, dz, t_min, bt, bi);
        if (kOcclusion && bt < mt) {
          live = false;
          break;
        }
      }
    }
  }
  if (!in_tile) return;
  if (kOcclusion) {
    occ_out[r] = bt < mt;
  } else {
    t_out[r] = bt;
    i_out[r] = bi;
  }
}

}  // namespace

// Plain C entry for ctypes. `rows`: [n_tris + 1, 12] f32, the packed rows of
// accel/cull.build_cull; `ids`: [n_lists, cap] i32 and `counts`: [n_lists]
// i32, each list's ascending ids and its true count; rays list by list,
// `tile` lanes each. Nearest writes t_out/i_out, any-hit (`occlusion` != 0,
// `max_t` given) occ_out. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" int rt_cull_sweep(const void* orig, const void* dir,
                             const void* act, const void* max_t,
                             const void* ids, const void* counts,
                             const void* rows, int n_lists, int tile, int cap,
                             int n_tris, float t_min, int occlusion,
                             void* t_out, void* i_out, void* occ_out,
                             void* stream) {
  if (n_lists <= 0 || tile <= 0) return 0;
  const dim3 grid((tile + kThreads - 1) / kThreads, n_lists);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const float*>(orig);
  const auto* d = static_cast<const float*>(dir);
  const auto* a = static_cast<const uint8_t*>(act);
  const auto* mx = static_cast<const float*>(max_t);
  const auto* li = static_cast<const int*>(ids);
  const auto* lc = static_cast<const int*>(counts);
  const auto* rw = static_cast<const float4*>(rows);
  if (occlusion)
    cull_sweep_kernel<true><<<grid, kThreads, 0, s>>>(
        o, d, a, mx, li, lc, rw, tile, cap, n_tris, t_min, nullptr, nullptr,
        static_cast<uint8_t*>(occ_out));
  else
    cull_sweep_kernel<false><<<grid, kThreads, 0, s>>>(
        o, d, a, mx, li, lc, rw, tile, cap, n_tris, t_min,
        static_cast<float*>(t_out), static_cast<int*>(i_out), nullptr);
  return static_cast<int>(cudaGetLastError());
}
