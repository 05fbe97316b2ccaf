// Möller–Trumbore on one packed triangle row, for the grid DDA over its
// packed candidate table (grid_walk.cu); the BVH walk (bvh_walk.cu) and the
// culled-list sweep (cull_sweep.cu) read the same rows and run the same
// arithmetic in stages (mt_staged.cuh). A row is 48 bytes, v0|e1|e2|id|0|0
// as three float4, and every expression follows geometry.triangle_tuv in
// its operation order (built without multiply-add contraction,
// kernels/build.py), so each kernel equals its plain torch version bit for
// bit.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kRowDetEps = 1e-8f;

// Möller–Trumbore on one triangle (v0, e1 = v1 - v0, e2 = v2 - v0) in the
// op order of geometry.triangle_tuv → its hit distance, +inf on a miss
// (never NaN: every comparison with a NaN fails, so the test misses).
__device__ __forceinline__ float tri_row_t(float v0x, float v0y, float v0z,
                                           float e1x, float e1y, float e1z,
                                           float e2x, float e2y, float e2z,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float t_min) {
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool det_ok = fabsf(det) > kRowDetEps;
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
  return hit ? t : CUDART_INF_F;
}

// tri_row_t on one packed row (v0 = a.xyz, e1 = (a.w, b.x, b.y),
// e2 = (b.z, b.w, c.x), id = c.y), folded into (bt, bi)
// lexicographically: the lowest id wins exact-t ties.
__device__ __forceinline__ void test_row(float4 a, float4 b, float4 c,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float t_min, float& bt, int& bi) {
  const int ic = static_cast<int>(c.y);
  const float tc = tri_row_t(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, ox,
                             oy, oz, dx, dy, dz, t_min);
  if (tc < bt || (tc == bt && ic < bi)) {
    bt = tc;
    bi = ic;
  }
}

}  // namespace
