// Brute-force triangle search — one thread per ray, Möller–Trumbore against
// every triangle of a [9, Tp] planar table, nearest or any-hit.
//
// Replaces the TPU kernels raytracer_tpu/ops/pallas_trace.py::
// _make_nearest_kernel (K3a, launched by tri_nearest) and
// _make_occluded_kernel (K3b, launched by tri_occluded). Same contract:
// triangles as rows v0|e1|e2 × xyz of a [9, Tp] table whose padding
// triangles are degenerate (det 0, never a hit); Möller–Trumbore in the op
// order of the reference's _mt_tile; nearest folds with strict `<` in
// ascending triangle order, so the first index wins exact-t ties, and
// returns t = +inf, idx 0 on a miss; any-hit is true when some t lies in
// (t_min, max_t). One addition: a lane masked out by `active` returns a
// miss (not occluded) and tests no triangle.
//
// What bounds it on this card: operations. Every live ray tests every
// triangle (46 fp32 operations each, as chip_smoke.py counts them), while
// the table it reads is small (0.74 MB at 20,480 triangles, resident in
// L2) and shared by all rays. The design answers that:
//   - the block stages a tile of 512 triangles (9 × 512 × 4 B = 18 KB of
//     static shared memory) with coalesced row reads, once for its 256
//     rays; every thread then sweeps the tile from shared memory, all lanes
//     of a warp on the same triangle (broadcast reads, no bank conflicts);
//   - masked lanes never sweep, and in any-hit mode a lane stops at its
//     first occluder. The block stops loading tiles as soon as none of its
//     lanes is still sweeping (a block-wide vote), so a block of masked or
//     finished lanes costs next to nothing.
// It does no culling: a live ray pays for all T triangles. Speed is for a
// later change (an acceleration structure is the grid walk's job).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py). No multiply-add contraction: each
// product and sum rounds as the plain torch version's separate ops do, in
// the same order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kDetEps = 1e-8f;
constexpr int kThreads = 256;
constexpr int kTile = 512;  // triangles staged per step

template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
tri_trace_kernel(const float* __restrict__ orig,      // [N,3]
                 const float* __restrict__ dir,       // [N,3]
                 const float* __restrict__ max_t,     // [N] (any-hit only)
                 const uint8_t* __restrict__ active,  // [N] bool or null
                 const float* __restrict__ tris,      // [9, Tp]
                 int n, int tp, float t_min,
                 float* __restrict__ t_out, int* __restrict__ i_out,
                 uint8_t* __restrict__ occ_out) {
  __shared__ float s[9][kTile];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < n;
  bool sweeping = in_range && (active == nullptr || active[r]);

  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float mt = 0.0f;
  if (sweeping) {
    ox = orig[3 * r];
    oy = orig[3 * r + 1];
    oz = orig[3 * r + 2];
    dx = dir[3 * r];
    dy = dir[3 * r + 1];
    dz = dir[3 * r + 2];
    if (kOcclusion) mt = max_t[r];
  }
  float bt = CUDART_INF_F;
  int bi = 0;
  bool occluded = false;

  for (int base = 0; base < tp; base += kTile) {
    // Every thread reaches this vote, sweeping or not. It is the barrier
    // that keeps the previous tile in place until all lanes have read it,
    // and it ends the sweep of the whole block at once.
    if (!__syncthreads_or(sweeping)) break;
    const int cnt = min(kTile, tp - base);
    for (int k = threadIdx.x; k < 9 * kTile; k += kThreads) {
      const int row = k / kTile, col = k % kTile;
      if (col < cnt)
        s[row][col] = __ldg(tris + static_cast<size_t>(row) * tp + base + col);
    }
    __syncthreads();
    if (!sweeping) continue;
    for (int j = 0; j < cnt; ++j) {
      const float v0x = s[0][j], v0y = s[1][j], v0z = s[2][j];
      const float e1x = s[3][j], e1y = s[4][j], e1z = s[5][j];
      const float e2x = s[6][j], e2y = s[7][j], e2z = s[8][j];
      // Möller–Trumbore in the op order of _mt_tile / triangle_tuv
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
      if (kOcclusion) {
        if (tc < mt) {
          occluded = true;
          sweeping = false;
          break;
        }
      } else if (tc < bt) {  // strict: the first index wins exact-t ties
        bt = tc;
        bi = base + j;
      }
    }
  }
  if (!in_range) return;
  if (kOcclusion) {
    occ_out[r] = occluded ? 1 : 0;
  } else {
    t_out[r] = bt;
    i_out[r] = bi;
  }
}

}  // namespace

// Plain C entry for ctypes. Nearest mode (occlusion 0) writes t_out/i_out,
// any-hit mode (occlusion 1) reads max_t and writes occ_out (bool bytes).
// `active` may be null (every lane live). Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int rt_tri_trace(const void* orig, const void* dir,
                            const void* max_t, const void* active,
                            const void* tris, int n, int tp, float t_min,
                            int occlusion, void* t_out, void* i_out,
                            void* occ_out, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const float*>(orig);
  const auto* d = static_cast<const float*>(dir);
  const auto* m = static_cast<const float*>(max_t);
  const auto* a = static_cast<const uint8_t*>(active);
  const auto* tr = static_cast<const float*>(tris);
  if (occlusion) {
    tri_trace_kernel<true><<<blocks, kThreads, 0, s>>>(
        o, d, m, a, tr, n, tp, t_min, nullptr, nullptr,
        static_cast<uint8_t*>(occ_out));
  } else {
    tri_trace_kernel<false><<<blocks, kThreads, 0, s>>>(
        o, d, m, a, tr, n, tp, t_min, static_cast<float*>(t_out),
        static_cast<int*>(i_out), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
