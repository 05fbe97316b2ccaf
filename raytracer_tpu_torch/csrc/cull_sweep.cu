// Culled-list triangle sweep: every live ray of a list is tested against
// the list's triangles, nearest or any hit, over per-list live-ray lists.
//
// Port-only: the reference keeps this sweep in XLA
// (raytracer_tpu/accel/cull.py::_dense_nearest and ::_dense_occluded, a
// chunked broadcast Möller–Trumbore over a per-tile culled id list; no
// pallas_call). Same contract: over the first min(count, cap) ids of a
// ray's list, the nearest hit with t > t_min, ties to the lowest id
// (nearest), or any hit with t < max_t (any-hit); a lane whose `active` byte
// is 0 (outside the mesh AABB, or masked by the caller) misses with
// (inf, n_tris). A live lane that hits nothing returns (inf, the lowest id
// of its list), or (inf, n_tris) when its list is empty: the lexicographic
// (t, id) fold of tri_row.cuh over misses. A list that overflowed its cap
// is truncated at cap, as the reference truncates it.
//
// What bounds it: operations. Every live lane runs Möller–Trumbore on every
// id of its list (46 fp32 operations a test, one instruction each without
// contraction); the bytes are the live rays, the ids and each listed row
// once. The design (after a first one of one CTA per 256 consecutive
// lanes of a list, live or not, each running test_row to its end):
//   - Only live lanes take slots. With a mask, a first kernel lists each
//     list's live lanes, ascending, at the front of the list's own segment
//     of a scratch buffer (live[j·tile, j·tile + n_live[j])), and their
//     count: a block a list, run by run of 2,048 lanes (live_list.cuh).
//     The host builds nothing and reads nothing back. (Listing them with
//     torch ops, a prefix sum and a scatter, cost ~0.1 ms of device time a
//     launch: PERF.md.) The sweep's launch is the upper bound, n_lists ×
//     ceil(tile / kThreads) CTAs: CTA b of list j takes the list's live
//     lanes [b·kThreads, (b+1)·kThreads), one a thread
//     (ops/cull_sweep.cta_shares mirrors the table). Every CTA first writes
//     the misses of the masked lanes among lanes [b·kThreads,
//     (b+1)·kThreads) of its list (every lane's, for an empty list); a CTA
//     past its list's live count, or of an empty list, then leaves before
//     it stages anything.
//   - The CTA stages the list's 48-byte rows (v0|e1|e2|id|0|0, tri_row.cuh)
//     into shared memory kChunk at a time; a thread reads each staged row
//     as three float4 broadcasts and tests kSteps rows at once, their
//     chains independent. (2 to 4 rays a thread, each staged row serving
//     them all, measured slower: PERF.md.)
//   - Möller–Trumbore in stages (mt_staged.cuh, the brute-force search's
//     exits of tri_trace.cu): most tests end after u·det, 22 of the 46
//     operations, and only tests that can still hit take the reciprocal.
//   - The fold runs on hits only; a lane that never hits takes its list's
//     lowest id at the end (the CTA's minimum over the ids it stages), which
//     is what the fold of every miss gives.
//   - Any-hit: a ray stops at the end of the chunk in which it meets its
//     first occluder (a check after each row measured slower, as in
//     tri_trace.cu), and the CTA stops staging chunks once none of its
//     threads sweeps.
// Every quantity is computed in the operation order of
// geometry.triangle_tuv, so the kernel equals the plain version
// (ops/cull_sweep.py) bit for bit and gives the grid walk's
// (csrc/grid_walk.cu) hits on rays whose list holds every triangle they can
// hit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "live_list.cuh"
#include "mt_staged.cuh"

namespace {

constexpr int kThreads = 128;  // live lanes a CTA takes, one a thread
constexpr int kChunk = 256;    // rows staged per step: 256 × 48 B = 12 KiB
constexpr int kSteps = 2;      // rows a thread tests at once

// Each list's live lanes of `act`, ascending, at the front of its segment
// of `live` (a block a list, live_list.cuh), and their count.
__global__ void __launch_bounds__(kListThreads)
cull_live_list_kernel(const uint8_t* __restrict__ act, int tile,
                      int* __restrict__ live, int* __restrict__ n_live) {
  const int base = blockIdx.x * tile;
  int held = 0;  // the list's live lanes so far, the same in every thread
  for (int lo = 0; lo < tile; lo += kListRun)
    held += list_run(
        act, base + lo, base + tile, live,
        [=](int) { return base + held; }, [](int) {});
  if (threadIdx.x == 0) n_live[blockIdx.x] = held;
}

template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
cull_sweep_kernel(const float* __restrict__ orig,     // [N,3]
                  const float* __restrict__ dir,      // [N,3]
                  const uint8_t* __restrict__ act,    // [N] bool or null
                  const int* __restrict__ live,       // [N] or null
                  const int* __restrict__ n_live,     // [n_lists] or null
                  const float* __restrict__ max_t,    // [N] (any-hit only)
                  const int* __restrict__ ids,        // [n_lists, cap]
                  const int* __restrict__ counts,     // [n_lists]
                  const float4* __restrict__ rows,    // [n_tris + 1, 3]
                  int tile, int cap, int n_tris, float t_min,
                  float* __restrict__ t_out, int* __restrict__ i_out,
                  uint8_t* __restrict__ occ_out) {
  __shared__ float4 s_rows[3 * kChunk];
  __shared__ int s_minid;
  const int tid = threadIdx.x;
  const int list = blockIdx.y;
  const int lo = blockIdx.x * kThreads;  // this CTA's share of the list
  const size_t base = static_cast<size_t>(list) * tile;
  const int count = min(counts[list], cap);

  // the misses of the masked lanes among lanes [lo, lo + kThreads) of the
  // list; every lane's when the list is empty
  const int q = lo + tid;
  if (q < tile && (count == 0 || (act != nullptr && !act[base + q]))) {
    if (kOcclusion) {
      occ_out[base + q] = 0;
    } else {
      t_out[base + q] = CUDART_INF_F;
      i_out[base + q] = n_tris;
    }
  }
  if (count == 0) return;
  // the list's live lanes are live[base, base + its live count); this
  // CTA's are [base + lo, base + lo + mine)
  const int mine =
      min(kThreads, (n_live == nullptr ? tile : n_live[list]) - lo);
  if (mine <= 0) return;  // block-uniform, before any barrier

  // this thread's live lane: entry base + lo + tid of the list
  const int e = static_cast<int>(base) + lo + tid;
  const int lane = tid >= mine ? -1 : live == nullptr ? e : live[e];
  bool sweep = lane >= 0;
  const size_t r = 3 * static_cast<size_t>(sweep ? lane : 0);
  const float ox = sweep ? __ldg(orig + r) : 0.0f;
  const float oy = sweep ? __ldg(orig + r + 1) : 0.0f;
  const float oz = sweep ? __ldg(orig + r + 2) : 0.0f;
  const float dx = sweep ? __ldg(dir + r) : 0.0f;
  const float dy = sweep ? __ldg(dir + r + 1) : 0.0f;
  const float dz = sweep ? __ldg(dir + r + 2) : 0.0f;
  const float mt = (kOcclusion && sweep) ? max_t[lane] : 0.0f;
  float bt = CUDART_INF_F;
  int bi = n_tris;
  bool occl = false;
  // t·det of det's sign must exceed this for the test to be able to hit
  const float lim = t_min >= 0.0f ? 0.0f : -CUDART_INF_F;

  if (tid == 0) s_minid = n_tris;
  const int* lid = ids + static_cast<size_t>(list) * cap;
  for (int k0 = 0; k0 < count; k0 += kChunk) {
    // a barrier too: every thread is done with the last chunk's rows (and
    // thread 0's s_minid is in place)
    if (kOcclusion) {
      if (!__syncthreads_or(sweep)) break;
    } else {
      __syncthreads();
    }
    const int m = min(kChunk, count - k0);
    int low = n_tris;
    for (int k = tid; k < 3 * m; k += kThreads) {
      const int id = __ldg(lid + k0 + k / 3);
      s_rows[k] = __ldg(rows + 3 * static_cast<size_t>(id) + k % 3);
      low = min(low, id);
    }
    if (!kOcclusion) atomicMin(&s_minid, low);
    __syncthreads();
    if (!sweep) continue;
    // kSteps rows a step, then the chunk's last row alone
    int j = 0;
    for (; j + kSteps <= m; j += kSteps)
      test_staged<kSteps, kOcclusion>(s_rows + 3 * j, ox, oy, oz, dx, dy, dz,
                                      mt, t_min, lim, bt, bi, occl);
    for (; j < m; ++j)
      test_staged<1, kOcclusion>(s_rows + 3 * j, ox, oy, oz, dx, dy, dz, mt,
                                 t_min, lim, bt, bi, occl);
    sweep = sweep && !occl;  // an occluded ray stops at the chunk's end
  }
  if (!kOcclusion) __syncthreads();  // every thread's atomicMin is in
  if (lane < 0) return;
  if (kOcclusion) {
    occ_out[lane] = occl ? 1 : 0;
  } else {
    t_out[lane] = bt;
    // a lane that never hit: the fold of its misses, the lowest id
    i_out[lane] = bt == CUDART_INF_F ? s_minid : bi;
  }
}

}  // namespace

// Plain C entry for ctypes. `rows`: [n_tris + 1, 12] f32, the packed rows of
// accel/cull.build_cull, 16-byte aligned; `ids`: [n_lists, cap] i32 and
// `counts`: [n_lists] i32, each list's ids and its true count; rays list by
// list, `tile` lanes each. With `act`, `live` [N] and `n_live` [n_lists]
// i32 are scratch for each list's live lanes and their count; without it
// all three are null and every lane is live. Nearest writes t_out/i_out,
// any-hit (`occlusion` != 0, `max_t` given) occ_out. Launches on `stream`
// (the list kernel, then the sweep), does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int rt_cull_sweep(const void* orig, const void* dir,
                             const void* act, void* live, void* n_live,
                             const void* max_t,
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
  const auto* l = static_cast<const int*>(live);
  const auto* p = static_cast<const int*>(n_live);
  if (a != nullptr)
    cull_live_list_kernel<<<n_lists, kListThreads, 0, s>>>(
        a, tile, static_cast<int*>(live), static_cast<int*>(n_live));
  const auto* mx = static_cast<const float*>(max_t);
  const auto* li = static_cast<const int*>(ids);
  const auto* lc = static_cast<const int*>(counts);
  const auto* rw = static_cast<const float4*>(rows);
  if (occlusion)
    cull_sweep_kernel<true><<<grid, kThreads, 0, s>>>(
        o, d, a, l, p, mx, li, lc, rw, tile, cap, n_tris, t_min, nullptr,
        nullptr, static_cast<uint8_t*>(occ_out));
  else
    cull_sweep_kernel<false><<<grid, kThreads, 0, s>>>(
        o, d, a, l, p, mx, li, lc, rw, tile, cap, n_tris, t_min,
        static_cast<float*>(t_out), static_cast<int*>(i_out), nullptr);
  return static_cast<int>(cudaGetLastError());
}
