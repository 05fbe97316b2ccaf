// Möller–Trumbore in stages on packed triangle rows, shared by the searches
// over culled lists (cull_sweep.cu) and BVH leaves (bvh_walk.cu). A row is
// 48 bytes, v0|e1|e2|id|0|0 as three float4 (tri_row.cuh's layout). Each
// quantity is computed in the operation order of geometry.triangle_tuv
// (tri_row.cuh's test_row), built without multiply-add contraction
// (kernels/build.py), and the test stops where it provably misses, so its
// hits are test_row's bit for bit. The exits and their thresholds are the
// brute-force search's (tri_trace.cu, whose u, v and t are likewise
// x·(1/det)).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kDetEps = 1e-8f;
// The exits' thresholds, tri_trace.cu's (proved there): below |det| =
// 2^64, 1/det rounds to at least 2^-64 in magnitude, so a u·det or v·det of
// det's other sign and at least 2^-80 gives u or v ≤ -2^-144 (negative,
// not a rounded -0); and u·det (or u·det + v·det, each ≥ -2^-80 of det's
// sign) above |det|·(1 + 2^-20), each side rounded once, gives a u (or
// u + v) that rounds above 1.
constexpr float kDetBig = 0x1p64f;
constexpr float kUvTiny = 0x1p-80f;
constexpr float kUvCut = 0x1.00001p0f;

// Möller–Trumbore of one ray against kSteps packed rows at `r` (row s: v0 =
// a.xyz, e1 = (a.w, b.x, b.y), e2 = (b.z, b.w, c.x), id = c.y, with a, b,
// c = r[3s], r[3s + 1], r[3s + 2]), each quantity in the operation order of
// geometry.triangle_tuv: pv = d × e2, det = e1·pv, tv = o − v0, u·det =
// tv·pv, qv = tv × e1, v·det = d·qv, t·det = e2·qv, and u, v, t = each
// times 1/det. A test goes on only while it can still hit, det's sign
// applied (an exact negation) to u·det, v·det and t·det:
//   - not where |det| ≤ eps (or NaN): the plain version's invalid det;
//   - after u·det, not where |det| ≤ 2^64 and u·det is below -2^-80 (u <
//     0) or above |det|·(1 + 2^-20) (u > 1), or NaN (u is then NaN, whose
//     comparisons fail);
//   - after qv, not where t·det is ≤ lim (t_min ≥ 0: lim = 0, so t ≤ 0 or
//     NaN, never > t_min; t_min < 0: lim = -inf, only NaN), nor, where
//     |det| ≤ 2^64, on v·det as on u·det (v < 0), nor, in any-hit mode,
//     where u·det + v·det exceeds |det|·(1 + 2^-20) (u + v > 1).
// A test that goes on runs the plain version's epilogue on the same
// values, so a kept test equals test_row's and a skipped one misses in it
// too. The rows' first stages run without a branch, so their chains
// interleave. Hits fold into (bt, bi) lexicographically on (t, id), as
// test_row folds them (a minimum: the order of the tests does not matter);
// any-hit sets `occl` where t < mt.
template <int kSteps, bool kOcclusion>
__device__ __forceinline__ void test_staged(const float4* r, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float mt,
                                            float t_min, float lim, float& bt,
                                            int& bi, bool& occl) {
  float e1x[kSteps], e1y[kSteps], e1z[kSteps], e2x[kSteps], e2y[kSteps],
      e2z[kSteps], idf[kSteps];
  float det[kSteps], un[kSteps], tvx[kSteps], tvy[kSteps], tvz[kSteps];
  bool go[kSteps];
  bool any = false;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const float4 a = r[3 * s], b = r[3 * s + 1], c = r[3 * s + 2];
    e1x[s] = a.w;
    e1y[s] = b.x;
    e1z[s] = b.y;
    e2x[s] = b.z;
    e2y[s] = b.w;
    e2z[s] = c.x;
    idf[s] = c.y;
    const float pvx = dy * e2z[s] - dz * e2y[s];
    const float pvy = dz * e2x[s] - dx * e2z[s];
    const float pvz = dx * e2y[s] - dy * e2x[s];
    det[s] = e1x[s] * pvx + e1y[s] * pvy + e1z[s] * pvz;
    tvx[s] = ox - a.x;
    tvy[s] = oy - a.y;
    tvz[s] = oz - a.z;
    un[s] = tvx[s] * pvx + tvy[s] * pvy + tvz[s] * pvz;
    const float ad = fabsf(det[s]);
    const float uns = det[s] > 0.0f ? un[s] : -un[s];
    go[s] = ad > kDetEps &&
            (ad > kDetBig || (uns >= -kUvTiny && uns <= ad * kUvCut));
    any = any || go[s];
  }
  if (!any) return;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (!go[s]) continue;
    const float ad = fabsf(det[s]);
    const bool pos = det[s] > 0.0f, small = !(ad > kDetBig);
    const float uns = pos ? un[s] : -un[s];
    const float qvx = tvy[s] * e1z[s] - tvz[s] * e1y[s];
    const float qvy = tvz[s] * e1x[s] - tvx[s] * e1z[s];
    const float qvz = tvx[s] * e1y[s] - tvy[s] * e1x[s];
    const float vn = dx * qvx + dy * qvy + dz * qvz;
    const float tn = e2x[s] * qvx + e2y[s] * qvy + e2z[s] * qvz;
    const float vns = pos ? vn : -vn, tns = pos ? tn : -tn;
    if (!(tns > lim)) continue;
    if (small &&
        !(vns >= -kUvTiny && !(kOcclusion && uns + vns > ad * kUvCut)))
      continue;
    // the plain version's epilogue
    const float inv = 1.0f / det[s];
    const float u = un[s] * inv, v = vn * inv, t = tn * inv;
    if (!(u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
          t > t_min))
      continue;
    if (kOcclusion) {
      occl = occl || t < mt;
      continue;
    }
    const int ic = static_cast<int>(idf[s]);
    if (t < bt || (t == bt && ic < bi)) {
      bt = t;
      bi = ic;
    }
  }
}

}  // namespace
