// Grid DDA walk — Amanatides–Woo traversal of a uniform grid with
// Möller–Trumbore on every listed triangle of every visited cell.
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas_walk.py::_make_walk_kernel
// (and the XLA while-loop walk raytracer_tpu/accel/grid.py::grid_walk at
// fanout 1, skip 0). Same contract: start from the walk_init state, fold
// candidates lexicographically on (t, id), park after the fold and before
// the advance (nearest: best_t <= min(tmax); occlusion: best_t < max_t or
// min(tmax) > max_t), step along the axis of min(tmax) with ties x < y < z,
// stop at grid exit or after max_iters steps.
//
// What bounds it on this card: neither bytes nor arithmetic but the latency
// of a lane's chain of candidate loads. One thread walks one lane, in pixel
// order; of a 1080p ray set 1–22% of lanes walk, ~60–110 candidates each,
// and a warp runs as long as its longest walk (the sparse sets' time is
// their longest walks). A loop that learns a cell's end from a sentinel
// slot of the padded [ncells, C, 10] table (13 MB for config4's blob) pays
// two dependent L2 trips per candidate: its id, then its other nine
// floats. The design:
//   - a known trip count: the walk reads the table built once per grid by
//     ops/walk.pack_cell_table: per cell its (offset, count), and its listed
//     triangles packed once as 48-byte rows v0|e1|e2|id|0|0 (1.6 MB for
//     config4's blob). Nothing waits on a sentinel;
//   - kRows rows per step of the candidate loop: their 3·kRows 16-byte
//     loads go out together, then the tests run; the next cell's (offset,
//     count) load goes out before this cell's tests.
// Per-block lists of the walking lanes, and warps staging a shared cell's
// rows in shared memory, were both slower on the card (PERF.md §6): the
// warps that walk are mostly full already, and a warp's lanes stand in
// several cells.
// The fold is a minimum over (t, id), so the test order does not change the
// winner, and every t comes from the same expressions as
// geometry.triangle_tuv: the kernel equals the plain walk bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py). No
// multiply-add contraction: each product and sum below rounds as the plain
// torch version's separate ops do, in the same order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tri_row.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 3;  // candidate rows whose loads go out together

// Walk lane r from its entry state → (best_t, best_idx).
__device__ __forceinline__ void walk_lane(
    int r, const float* __restrict__ orig, const float* __restrict__ dir,
    const int* __restrict__ cell0, const float* __restrict__ tmax0,
    const int* __restrict__ step0, const float* __restrict__ tdelta0,
    const float* __restrict__ max_t, const int2* __restrict__ cells,
    const float4* __restrict__ slots, int nx, int ny, int nz, float t_min,
    int max_iters, int occlusion, float& bt, int& bi) {
  const float ox = orig[3 * r], oy = orig[3 * r + 1], oz = orig[3 * r + 2];
  const float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
  int cx = cell0[3 * r], cy = cell0[3 * r + 1], cz = cell0[3 * r + 2];
  float tmx = tmax0[3 * r], tmy = tmax0[3 * r + 1], tmz = tmax0[3 * r + 2];
  const int sx = step0[3 * r], sy = step0[3 * r + 1], sz = step0[3 * r + 2];
  const float tdx = tdelta0[3 * r], tdy = tdelta0[3 * r + 1],
              tdz = tdelta0[3 * r + 2];
  const float mt = occlusion ? max_t[r] : 0.0f;

  int2 cc = __ldg(cells + (cx * ny + cy) * nz + cz);  // offset, count
  for (int it = 0; it < max_iters; ++it) {
    // the cell after this one: its (offset, count) load goes out before
    // this cell's candidates are tested (the step does not depend on them)
    const float m = fminf(fminf(tmx, tmy), tmz);
    int ncx = cx, ncy = cy, ncz = cz;
    if (tmx == m)
      ncx += sx;
    else if (tmy == m)
      ncy += sy;
    else
      ncz += sz;
    const bool out = ncx < 0 || ncx >= nx || ncy < 0 || ncy >= ny ||
                     ncz < 0 || ncz >= nz;
    const int2 nc =
        out ? make_int2(0, 0) : __ldg(cells + (ncx * ny + ncy) * nz + ncz);

    // the cell's rows, kRows at a time: all their loads go out together
    const float4* s = slots + 3 * static_cast<size_t>(cc.x);
    int k = 0;
    for (; k + kRows <= cc.y; k += kRows, s += 3 * kRows) {
      float4 row[3 * kRows];
#pragma unroll
      for (int q = 0; q < 3 * kRows; ++q) row[q] = __ldg(s + q);
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        test_row(row[3 * j], row[3 * j + 1], row[3 * j + 2], ox, oy, oz, dx,
                 dy, dz, t_min, bt, bi);
    }
    for (; k < cc.y; ++k, s += 3)
      test_row(__ldg(s), __ldg(s + 1), __ldg(s + 2), ox, oy, oz, dx, dy, dz,
               t_min, bt, bi);

    const bool parked = occlusion ? (bt < mt || m > mt) : (bt <= m);
    if (parked || out) break;
    if (tmx == m)
      tmx += tdx;
    else if (tmy == m)
      tmy += tdy;
    else
      tmz += tdz;
    cx = ncx;
    cy = ncy;
    cz = ncz;
    cc = nc;
  }
}

__global__ void __launch_bounds__(kThreads)
grid_walk_kernel(const float* __restrict__ orig,     // [N,3]
                 const float* __restrict__ dir,      // [N,3]
                 const int* __restrict__ cell0,      // [N,3]
                 const float* __restrict__ tmax0,    // [N,3]
                 const int* __restrict__ step0,      // [N,3]
                 const float* __restrict__ tdelta0,  // [N,3]
                 const uint8_t* __restrict__ act0,   // [N] bool
                 const float* __restrict__ best_t0,  // [N]
                 const int* __restrict__ best_i0,    // [N]
                 const float* __restrict__ max_t,    // [N] (occlusion only)
                 const int2* __restrict__ cells,     // [ncells] offset, count
                 const float4* __restrict__ slots,   // [n_slots, 3]
                 int n, int nx, int ny, int nz, float t_min, int max_iters,
                 int occlusion, float* __restrict__ t_out,
                 int* __restrict__ i_out) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  float bt = best_t0[r];
  int bi = best_i0[r];
  if (act0[r])
    walk_lane(r, orig, dir, cell0, tmax0, step0, tdelta0, max_t, cells, slots,
              nx, ny, nz, t_min, max_iters, occlusion, bt, bi);
  t_out[r] = bt;
  i_out[r] = bi;
}

}  // namespace

// Plain C entry for ctypes. `cells`: [ncells, 2] i32 (offset, count) and
// `slots`: [n_slots, 12] f32, the table of ops/walk.pack_cell_table.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 on success).
extern "C" int rt_grid_walk(const void* orig, const void* dir,
                            const void* cell0, const void* tmax0,
                            const void* step0, const void* tdelta0,
                            const void* act0, const void* best_t0,
                            const void* best_i0, const void* max_t,
                            const void* cells, const void* slots, int n,
                            int nx, int ny, int nz, float t_min, int max_iters,
                            int occlusion, void* t_out, void* i_out,
                            void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  grid_walk_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(orig), static_cast<const float*>(dir),
      static_cast<const int*>(cell0), static_cast<const float*>(tmax0),
      static_cast<const int*>(step0), static_cast<const float*>(tdelta0),
      static_cast<const uint8_t*>(act0), static_cast<const float*>(best_t0),
      static_cast<const int*>(best_i0), static_cast<const float*>(max_t),
      static_cast<const int2*>(cells), static_cast<const float4*>(slots), n,
      nx, ny, nz, t_min, max_iters, occlusion, static_cast<float*>(t_out),
      static_cast<int*>(i_out));
  return static_cast<int>(cudaGetLastError());
}
