// Grid DDA walk — one thread per ray, Amanatides–Woo traversal of a uniform
// grid with Möller–Trumbore on every candidate of every visited cell.
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas_walk.py::_make_walk_kernel
// (and the XLA while-loop walk raytracer_tpu/accel/grid.py::grid_walk at
// fanout 1, skip 0). Same contract: start from the walk_init state, fold
// candidates lexicographically on (t, id), park after the fold and before
// the advance (nearest: best_t <= min(tmax); occlusion: best_t < max_t or
// min(tmax) > max_t), step along the axis of min(tmax) with ties x < y < z,
// stop at grid exit or after max_iters steps.
//
// What bounds it on this card: not arithmetic, but the latency of scattered
// candidate reads — each candidate is a 40-byte v0|e1|e2|id row of the
// [ncells, C, 10] f32 table, fetched from L2 (the whole table of a 20k-tri
// mesh is ~13 MB and stays resident in the 50 MB L2). The design answers
// that in two ways:
//   - lane order: rays launch in pixel order (row-major, or screen blocks
//     with RenderOptions.tile_block), so the 32 threads of a warp are
//     neighbouring pixels that visit the same cells and read the same rows
//     (one L2 sector serves the whole warp);
//   - early stop: cells fill front to back and sentinel slots (id == n_tris,
//     the zero triangle) always miss, so a thread stops reading a cell at
//     its first sentinel. At mean fill ~13 of 128 slots this skips ~90% of
//     the table traffic, and it is exact: a sentinel can never win the fold.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py). No
// multiply-add contraction: each product and sum below rounds as the plain
// torch version's separate ops do, in the same order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kDetEps = 1e-8f;
constexpr int kThreads = 128;

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
                 const float* __restrict__ soa,      // [ncells, C, 10]
                 int n, int nx, int ny, int nz, int cap, int n_tris,
                 float t_min, int max_iters, int occlusion,
                 float* __restrict__ t_out, int* __restrict__ i_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;

  float bt = best_t0[r];
  int bi = best_i0[r];
  if (act0[r]) {
    const float ox = orig[3 * r], oy = orig[3 * r + 1], oz = orig[3 * r + 2];
    const float dx = dir[3 * r], dy = dir[3 * r + 1], dz = dir[3 * r + 2];
    int cx = cell0[3 * r], cy = cell0[3 * r + 1], cz = cell0[3 * r + 2];
    float tmx = tmax0[3 * r], tmy = tmax0[3 * r + 1], tmz = tmax0[3 * r + 2];
    const int sx = step0[3 * r], sy = step0[3 * r + 1], sz = step0[3 * r + 2];
    const float tdx = tdelta0[3 * r], tdy = tdelta0[3 * r + 1],
                tdz = tdelta0[3 * r + 2];
    const float mt = occlusion ? max_t[r] : 0.0f;
    const float sentinel = static_cast<float>(n_tris);

    for (int it = 0; it < max_iters; ++it) {
      const float* row =
          soa + static_cast<size_t>((cx * ny + cy) * nz + cz) * cap * 10;
      for (int k = 0; k < cap; ++k) {
        const float* s = row + 10 * k;
        const float idf = __ldg(s + 9);
        if (idf == sentinel) break;  // slots fill front to back
        const float v0x = __ldg(s), v0y = __ldg(s + 1), v0z = __ldg(s + 2);
        const float e1x = __ldg(s + 3), e1y = __ldg(s + 4), e1z = __ldg(s + 5);
        const float e2x = __ldg(s + 6), e2y = __ldg(s + 7), e2z = __ldg(s + 8);
        // Möller–Trumbore in the op order of geometry.triangle_tuv
        const float pvx = dy * e2z - dz * e2y;
        const float pvy = dz * e2x - dx * e2z;
        const float pvz = dx * e2y - dy * e2x;
        const float det = e1x * pvx + e1y * pvy + e1z * pvz;
        const bool det_ok = fabsf(det) > kDetEps;
        const float inv = det_ok ? 1.0f / det : 0.0f;
        const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
        const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv;
        const float qvx = tvy * e1z - tvz * e1y;
        const float qvy = tvz * e1x - tvx * e1z;
        const float qvz = tvx * e1y - tvy * e1x;
        const float v = (dx * qvx + dy * qvy + dz * qvz) * inv;
        const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv;
        const bool hit = det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                         u + v <= 1.0f && t > t_min;
        const float tc = hit ? t : CUDART_INF_F;
        const int ic = static_cast<int>(idf);
        // lexicographic (t, id) fold: lowest id wins exact-t ties
        if (tc < bt || (tc == bt && ic < bi)) {
          bt = tc;
          bi = ic;
        }
      }
      const float m = fminf(fminf(tmx, tmy), tmz);
      const bool parked = occlusion ? (bt < mt || m > mt) : (bt <= m);
      if (parked) break;
      if (tmx == m) {
        cx += sx;
        tmx += tdx;
      } else if (tmy == m) {
        cy += sy;
        tmy += tdy;
      } else {
        cz += sz;
        tmz += tdz;
      }
      if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz)
        break;
    }
  }
  t_out[r] = bt;
  i_out[r] = bi;
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" int rt_grid_walk(const void* orig, const void* dir,
                            const void* cell0, const void* tmax0,
                            const void* step0, const void* tdelta0,
                            const void* act0, const void* best_t0,
                            const void* best_i0, const void* max_t,
                            const void* soa, int n, int nx, int ny, int nz,
                            int cap, int n_tris, float t_min, int max_iters,
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
      static_cast<const float*>(soa), n, nx, ny, nz, cap, n_tris, t_min,
      max_iters, occlusion, static_cast<float*>(t_out),
      static_cast<int*>(i_out));
  return static_cast<int>(cudaGetLastError());
}
