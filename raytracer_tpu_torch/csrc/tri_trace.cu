// Brute-force triangle search: Möller–Trumbore of every live ray against
// every triangle, nearest or any-hit.
//
// Replaces the TPU kernels raytracer_tpu/ops/pallas_trace.py::
// _make_nearest_kernel (K3a, launched by tri_nearest) and
// _make_occluded_kernel (K3b, launched by tri_occluded). Same contract:
// triangles as the [9, Tp] planar table v0|e1|e2 × xyz whose padding
// triangles are degenerate (det 0, never a hit); Möller–Trumbore in the op
// order of the reference's _mt_tile; nearest folds with strict `<` in
// ascending triangle order, so the first index wins exact-t ties, and
// returns t = +inf, idx 0 on a miss; any-hit is true when some t lies in
// (t_min, max_t). One addition: a lane masked out by `active` returns a
// miss (not occluded) and tests no triangle.
//
// What bounds it on this card: instructions. Every live ray tests every
// triangle (46 fp32 operations each, as chip_smoke.py counts them), while
// the table (0.98 MB packed at 20,480 triangles) stays in L2 and is shared
// by all rays. Built without multiply-add contraction, each operation is
// one instruction, so the fp32 instruction rate (128 lanes × 132 SMs ×
// clock) sets a ceiling near 2× that bound. The design spends as few
// instructions as it can on tests that miss:
//   - Only live rays take slots. With a mask the wrapper lists the active
//     rays (a prefix sum and a scatter on the device, no host sync); the
//     blocks split the list evenly, in whole warps, over at least `spread`
//     blocks (4 per SM), so a bounce with few live rays still spreads over
//     the card instead of sweeping every triangle with near-empty warps.
//     Each block also writes the misses of the masked rays in its share of
//     N.
//   - 128 threads, 3 rays a thread in nearest mode and 1 in any-hit mode
//     (1–4 measured in each), each thread keeping its rays' origin,
//     direction and best hit (or max_t) in registers.
//   - The wrapper packs the table into rows v0|e1|e2|0,0,0 (48 bytes, three
//     float4: tri_row.cuh's layout without the id), and the block stages it
//     a tile of 256 triangles (12 KB) at a time, one cp.async.bulk per tile
//     on an mbarrier, double-buffered: thread 0 starts tile i+1 while the
//     block sweeps tile i (bulk_copy.cuh, shared with mat_trace.cu). A
//     triangle is three float4 shared-memory broadcasts, each serving the
//     thread's rays.
//   - Möller–Trumbore's quantities come one after another, and the test
//     goes on only while it can still hit, with det's sign applied (an
//     exact negation) to u·det, v·det and t·det: after pv and det, not
//     where |det| ≤ eps (or NaN); after tv and u·det = tv·pv (22 of the 46
//     operations), not where |det| ≤ 2^64 and u·det is below -2^-80 (u ≤
//     -2^-144 whatever 1/det rounds to), above |det|·(1 + 2^-20) (u > 1),
//     or NaN; after qv, v·det and t·det, not where t·det is ≤ 0 (t_min ≥
//     0; only a NaN or -inf where t_min < 0), nor on v·det's sign as on
//     u's, nor, in any-hit mode, where u·det + v·det exceeds |det|·(1 +
//     2^-20) (u + v > 1). Most tests end at u: no triangle lies in the
//     wedge u ≥ 0 of most rays. The thresholds and their proofs are
//     mat_trace.cu's, whose u, v and t are likewise x·(1/det). The others
//     take __frcp_rn(det), correctly rounded as the plain version's 1/det,
//     and the reference's epilogue as it is. Every quantity is computed in
//     _mt_tile's order, so a kept test equals the plain version's and a
//     skipped one misses in it too: the plain version, which has no such
//     stages (tests hold the stages to its epilogue), equals the kernel
//     bit for bit.
//   - An any-hit ray stops at the end of the tile in which it meets its
//     first occluder, a thread once none of its rays sweeps, and the block
//     stops loading tiles once no thread of it sweeps (a block-wide vote
//     before each tile). Stopping each ray at the occluder itself, with a
//     check after every triangle, measured slower: the check and a mask
//     that changes inside the loop cost more than the tests they save.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py). No multiply-add contraction: each
// product and sum rounds as the plain torch version's separate ops do, in
// the same order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr float kDetEps = 1e-8f;
// Below |det| = 2^64, 1/det rounds to at least 2^-64 in magnitude, so a
// u·det or v·det of det's other sign and at least 2^-80 gives u or v ≤
// -2^-144: negative, not a rounded -0.
constexpr float kDetBig = 0x1p64f;
constexpr float kUvTiny = 0x1p-80f;
// There, u·det (or u·det + v·det, each ≥ -2^-80 of det's sign) above
// |det|·(1 + 2^-20), each side rounded once, exceeds |det|·(1 + 2^-21), so
// u (or u + v, three roundings and at most 2^-51 of underflow later)
// rounds above 1.
constexpr float kUvCut = 0x1.00001p0f;
constexpr int kThreads = 128;
// rays a thread in each mode (1–4 measured in each)
constexpr int kRaysNearest = 3;
constexpr int kRaysAnyHit = 1;
constexpr int kTile = 256;                     // triangles staged per step
constexpr int kRowVec = 3;                     // float4s a packed triangle

template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
tri_trace_kernel(const float* __restrict__ orig,      // [N,3]
                 const float* __restrict__ dir,       // [N,3]
                 const int* __restrict__ live,        // live ray ids or null
                 const int* __restrict__ n_live,      // their count or null
                 const float* __restrict__ max_t,     // [N] (any-hit only)
                 const uint8_t* __restrict__ active,  // [N] bool or null
                 const float* __restrict__ rows,      // [Tp, 12] packed
                 int n, int tp, int spread, float t_min,
                 float* __restrict__ t_out, int* __restrict__ i_out,
                 uint8_t* __restrict__ occ_out) {
  constexpr int kRays = kOcclusion ? kRaysAnyHit : kRaysNearest;
  constexpr int kBlockRays = kThreads * kRays;
  __shared__ __align__(128) float4 tile[2 * kTile * kRowVec];
  __shared__ __align__(8) uint64_t full[2];
  const int tid = threadIdx.x;

  write_masked_misses<kOcclusion>(active, n, kBlockRays, t_out, i_out,
                                  occ_out);
  int first;
  const int count = live_share(n_live, n, spread, kBlockRays, &first);
  if (count <= 0) return;  // block-uniform, before any barrier

  // Slot k of this thread holds the block's live ray tid + k·kThreads.
  int ray[kRays];
  bool sweep[kRays];
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float mt[kRays], best[kRays];
  int bi[kRays];
  bool occl[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int j = tid + k * kThreads;
    ray[k] = j >= count ? -1 : live == nullptr ? first + j : live[first + j];
    sweep[k] = ray[k] >= 0;
    const size_t r = 3 * static_cast<size_t>(sweep[k] ? ray[k] : 0);
    ox[k] = sweep[k] ? __ldg(orig + r) : 0.0f;
    oy[k] = sweep[k] ? __ldg(orig + r + 1) : 0.0f;
    oz[k] = sweep[k] ? __ldg(orig + r + 2) : 0.0f;
    dx[k] = sweep[k] ? __ldg(dir + r) : 0.0f;
    dy[k] = sweep[k] ? __ldg(dir + r + 1) : 0.0f;
    dz[k] = sweep[k] ? __ldg(dir + r + 2) : 0.0f;
    mt[k] = (kOcclusion && sweep[k]) ? max_t[ray[k]] : 0.0f;
    best[k] = CUDART_INF_F;
    bi[k] = 0;
    occl[k] = false;
  }
  // t·det of det's sign must exceed this for the test to be able to hit.
  const float lim = t_min >= 0.0f ? 0.0f : -CUDART_INF_F;

  const auto sweeping = [&] {
    bool any = false;
#pragma unroll
    for (int k = 0; k < kRays; ++k) any = any || sweep[k];
    return any;
  };
  sweep_tiles<kRowVec, kTile>(rows, tp, tile, full, sweeping, [&](
      const float4* buf, int base, int cnt) {
    for (int j = 0; j < cnt; ++j) {
      // v0x v0y v0z e1x | e1y e1z e2x e2y | e2z 0 0 0
      const float4 a = buf[j * kRowVec], b = buf[j * kRowVec + 1],
                   c = buf[j * kRowVec + 2];
      const float v0x = a.x, v0y = a.y, v0z = a.z;
      const float e1x = a.w, e1y = b.x, e1z = b.y;
      const float e2x = b.z, e2y = b.w, e2z = c.x;
      // Möller–Trumbore in the op order of _mt_tile / triangle_tuv, in
      // stages; each skip is an exact miss (see the header). The first two
      // stages run for all of the thread's rays without a branch, so their
      // chains interleave, and the triangle ends there when none goes on.
      float det[kRays], un[kRays], pvx[kRays], pvy[kRays], pvz[kRays];
      float tvx[kRays], tvy[kRays], tvz[kRays];
      bool go[kRays];
      bool any = false;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        pvx[k] = dy[k] * e2z - dz[k] * e2y;
        pvy[k] = dz[k] * e2x - dx[k] * e2z;
        pvz[k] = dx[k] * e2y - dy[k] * e2x;
        det[k] = e1x * pvx[k] + e1y * pvy[k] + e1z * pvz[k];
        tvx[k] = ox[k] - v0x;
        tvy[k] = oy[k] - v0y;
        tvz[k] = oz[k] - v0z;
        un[k] = tvx[k] * pvx[k] + tvy[k] * pvy[k] + tvz[k] * pvz[k];
        const float ad = fabsf(det[k]);
        const float uns = det[k] > 0.0f ? un[k] : -un[k];
        go[k] = sweep[k] && ad > kDetEps &&
                (ad > kDetBig || (uns >= -kUvTiny && uns <= ad * kUvCut));
        any = any || go[k];
      }
      if (!any) continue;
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        if (!go[k]) continue;
        const float ad = fabsf(det[k]);
        const bool pos = det[k] > 0.0f, small = !(ad > kDetBig);
        const float uns = pos ? un[k] : -un[k];
        const float qvx = tvy[k] * e1z - tvz[k] * e1y;
        const float qvy = tvz[k] * e1x - tvx[k] * e1z;
        const float qvz = tvx[k] * e1y - tvy[k] * e1x;
        const float vn = dx[k] * qvx + dy[k] * qvy + dz[k] * qvz;
        const float tn = e2x * qvx + e2y * qvy + e2z * qvz;
        const float vns = pos ? vn : -vn, tns = pos ? tn : -tn;
        if (!(tns > lim)) continue;
        if (small && !(vns >= -kUvTiny &&
                       !(kOcclusion && uns + vns > ad * kUvCut)))
          continue;
        // the reference's epilogue
        const float inv = __frcp_rn(det[k]);
        const float u = un[k] * inv, v = vn * inv, t = tn * inv;
        if (!(u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
              t > t_min))
          continue;
        if (kOcclusion) {
          occl[k] = occl[k] || t < mt[k];
        } else if (t < best[k]) {  // strict: the first index wins exact-t ties
          best[k] = t;
          bi[k] = base + j;
        }
      }
    }
    if (kOcclusion) {  // an occluded ray stops at the end of the tile
#pragma unroll
      for (int k = 0; k < kRays; ++k) sweep[k] = sweep[k] && !occl[k];
    }
  });
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    if (ray[k] < 0) continue;
    if (kOcclusion) {
      occ_out[ray[k]] = occl[k] ? 1 : 0;
    } else {
      t_out[ray[k]] = best[k];
      i_out[ray[k]] = bi[k];
    }
  }
}

}  // namespace

// Plain C entry for ctypes. `rows` is the packed table [tp, 12]
// (pack_tri_rows), 16-byte aligned. With `active`, `live` lists the active
// rays in ascending order and `n_live` (on the device) counts them; without
// it both are null and every ray is live. The live rays are split evenly
// over at least `spread` blocks. Nearest mode (occlusion 0) writes
// t_out/i_out, any-hit mode (occlusion 1) reads max_t and writes occ_out
// (bool bytes). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int rt_tri_trace(const void* orig, const void* dir,
                            const void* live, const void* n_live,
                            const void* max_t, const void* active,
                            const void* rows, int n, int tp, int spread,
                            float t_min, int occlusion, void* t_out,
                            void* i_out, void* occ_out, void* stream) {
  if (n <= 0) return 0;
  const int block_rays = kThreads * (occlusion ? kRaysAnyHit : kRaysNearest);
  const int blocks = (n + block_rays - 1) / block_rays;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const float*>(orig);
  const auto* d = static_cast<const float*>(dir);
  const auto* l = static_cast<const int*>(live);
  const auto* c = static_cast<const int*>(n_live);
  const auto* m = static_cast<const float*>(max_t);
  const auto* a = static_cast<const uint8_t*>(active);
  const auto* w = static_cast<const float*>(rows);
  spread = spread > 0 ? spread : 1;
  if (occlusion) {
    tri_trace_kernel<true><<<blocks, kThreads, 0, s>>>(
        o, d, l, c, m, a, w, n, tp, spread, t_min, nullptr, nullptr,
        static_cast<uint8_t*>(occ_out));
  } else {
    tri_trace_kernel<false><<<blocks, kThreads, 0, s>>>(
        o, d, l, c, m, a, w, n, tp, spread, t_min, static_cast<float*>(t_out),
        static_cast<int*>(i_out), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
