// Brute-force triangle search as a linear expansion, nearest or any-hit:
// per ray and triangle the non-zero terms of four dots of the ray's
// features with the triangle's weights, then Möller–Trumbore's validity
// tests.
//
// Replaces the TPU kernels raytracer_tpu/ops/mat_trace.py::
// _make_nearest_kernel (K4a, launched by mat_nearest) and
// _make_occluded_kernel (K4b, launched by mat_occluded). Same function:
// feats [N,16] (f = [d, o×d, o, 1, 0…], ray_features) times weights
// [16, 4·Tp] (columns det|u|v|t per block of bt triangles,
// build_tri_weights), then the reference's _epilogue (|det| > eps, u, v, t
// by one reciprocal, the barycentric and t > t_min tests) and a strict `<`
// fold in ascending triangle order (the first index wins exact-t ties; a
// miss is t = +inf, idx 0), or any t below max_t. Two additions: a lane
// masked out by `active` returns a miss (not occluded) and tests nothing,
// and so does a ray with a non-finite feature among f0…f9 (the full
// product's NaN makes every such ray miss; see the plain version).
//
// The weights have structural zeros: det uses rows 0–2, u and v rows 0–5,
// t rows 6–9, and row 9 multiplies the constant feature 1. The kernel reads
// the table packed per triangle as those 19 coefficients plus one zero (80
// bytes, pack_mat_table) and sums only the non-zero terms, in ascending row
// order, with row 9 as an add (1·w == w exactly). Dropping a term f·0 from
// a sum of finite terms changes at most the sign of a zero sum, which no
// test of the epilogue reads. No tensor cores and no library product: TF32,
// even split 3×TF32, rounds the dots otherwise and reorders winners, so
// every term is an fp32 product on the CUDA cores (built --fmad=false: no
// contraction) and the plain torch version, which sums the same terms in
// the same order, equals the kernel bit for bit.
//
// What bounds it on this card: instructions. Every live ray tests
// every triangle; the table (1.6 MB packed at 20,480 triangles) stays in
// L2. The function needs 39 fp32 operations per test (33 for the dots,
// 6 for the epilogue, as chip_smoke.py counts them for the bound); without
// multiply-add contraction each is one instruction, so the fp32 instruction rate
// (128 lanes × 132 SMs × clock) sets a ceiling near 2× that bound. The
// design spends its instructions on those terms:
//   - Only live rays take slots. With a mask the wrapper lists the active
//     rays (a prefix sum and a scatter on the device, no host sync) and
//     their count stays on the device; the blocks split the list evenly,
//     in whole warps, over at least `spread` blocks (4 per SM), so a
//     bounce with few live rays still spreads over the card instead of
//     sweeping every triangle with near-empty warps. Each block also
//     writes the misses of the masked rays in its share of N.
//   - 128 threads, kRays = 3 rays a thread (2–6 measured), each thread
//     keeping its rays' nine used features in registers; a ray with a
//     non-finite feature sweeps nothing.
//   - The block stages the packed table a tile of 256 triangles (20 KB) at
//     a time, one cp.async.bulk per tile signalled on an mbarrier, double
//     buffered: thread 0 starts tile i+1 while the block sweeps tile i. No
//     per-element index arithmetic. The staging and the live-ray split are
//     bulk_copy.cuh's, shared with tri_trace.cu.
//   - A triangle's row is 5 float4 shared-memory broadcasts, each serving
//     kRays tests.
//   - The reciprocal and the epilogue only where the test can hit. The
//     four sums come first; with det's sign applied (an exact negation),
//     a test misses whatever 1/det rounds to where |det| ≤ eps; where
//     t_min ≥ 0 and t·det is ≤ 0 or NaN (t = (t·det)·(1/det) is then ≤ 0
//     or NaN; where t_min < 0 only a NaN or -inf is skipped so); and
//     where |det| ≤ 2^64 and u·det or v·det is below -2^-80 or NaN (u or
//     v is then negative or NaN). Most tests miss so: no triangle lies in
//     the wedge u, v ≥ 0 of most rays. In any-hit mode also where u·det +
//     v·det exceeds |det|·(1 + 2^-20) (u + v > 1): there it leaves fewer
//     lanes of a warp in the epilogue (scattered shadow rays diverge);
//     in nearest mode it cost more than it saved. The others take
//     __frcp_rn(det),
//     correctly rounded as the plain version's 1/det, and the reference's
//     epilogue as it is, so the result is the plain version's, which has
//     no such prefilter (tests hold the prefilter to its epilogue).
//   - An any-hit ray stops at its first occluder, a thread once none of
//     its rays sweeps, and the block stops loading tiles once no thread of
//     it sweeps (a block-wide vote).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py). No multiply-add contraction.

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
// There, with u·det, v·det ≥ -2^-80 of det's sign, a sum above
// |det|·(1 + 2^-20) (each side rounded once) exceeds |det|·(1 + 2^-21), so
// u + v, three roundings and at most 2^-51 of underflow later, rounds
// above 1.
constexpr float kUvSumCut = 0x1.00001p0f;
constexpr int kThreads = 128;
constexpr int kRays = 3;                       // rays a thread
constexpr int kBlockRays = kThreads * kRays;
constexpr int kTile = 256;                     // triangles staged per step
constexpr int kFeat = 16;                      // feature columns of feats
constexpr int kRow = 20;                       // floats per packed triangle
constexpr int kRowVec = kRow / 4;

template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
mat_trace_kernel(const float* __restrict__ feats,     // [N,16]
                 const int* __restrict__ live,        // live ray ids or null
                 const int* __restrict__ n_live,      // their count or null
                 const float* __restrict__ max_t,     // [N] (any-hit only)
                 const uint8_t* __restrict__ active,  // [N] bool or null
                 const float* __restrict__ rows,      // [Tp, 20] packed
                 int n, int tp, int spread, float t_min,
                 float* __restrict__ t_out, int* __restrict__ i_out,
                 uint8_t* __restrict__ occ_out) {
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
  float f[kRays][9];
  float mt[kRays], best[kRays];
  int bi[kRays];
  bool occl[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int j = tid + k * kThreads;
    ray[k] = j >= count ? -1 : live == nullptr ? first + j : live[first + j];
    bool finite = ray[k] >= 0;
    const float* src = feats + static_cast<size_t>(finite ? ray[k] : 0) * kFeat;
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      f[k][c] = finite ? __ldg(src + c) : 0.0f;
      finite = finite && isfinite(f[k][c]);
    }
    finite = finite && ray[k] >= 0 && isfinite(__ldg(src + 9));
    sweep[k] = finite;
    mt[k] = (kOcclusion && ray[k] >= 0) ? max_t[ray[k]] : 0.0f;
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
      // det0 det1 det2 u0 | u1 u2 u3 u4 | u5 v0 v1 v2 | v3 v4 v5 t6 |
      // t7 t8 t9 0
      const float4 a = buf[j * kRowVec], b = buf[j * kRowVec + 1],
                   c = buf[j * kRowVec + 2], d = buf[j * kRowVec + 3],
                   e = buf[j * kRowVec + 4];
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        if (!sweep[k]) continue;
        const float* x = f[k];
        const float det = x[0] * a.x + x[1] * a.y + x[2] * a.z;
        const float tn = x[6] * d.w + x[7] * e.x + x[8] * e.y + e.z;
        const float un = x[0] * a.w + x[1] * b.x + x[2] * b.y + x[3] * b.z +
                         x[4] * b.w + x[5] * c.x;
        const float vn = x[0] * c.y + x[1] * c.z + x[2] * c.w + x[3] * d.x +
                         x[4] * d.y + x[5] * d.z;
        // The exact misses, before the reciprocal (see the header).
        const bool pos = det > 0.0f;
        const float ad = fabsf(det);
        const float tns = pos ? tn : -tn, uns = pos ? un : -un,
                    vns = pos ? vn : -vn;
        if (!(ad > kDetEps && tns > lim &&
              (ad > kDetBig ||
               (uns >= -kUvTiny && vns >= -kUvTiny &&
                !(kOcclusion && uns + vns > ad * kUvSumCut)))))
          continue;
        // the reference's _epilogue
        const float inv = __frcp_rn(det);
        const float u = un * inv, v = vn * inv, t = tn * inv;
        if (!(u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
              t > t_min))
          continue;
        if (kOcclusion) {
          if (t < mt[k]) {
            occl[k] = true;
            sweep[k] = false;
          }
        } else if (t < best[k]) {  // strict: the first index wins exact-t ties
          best[k] = t;
          bi[k] = base + j;
        }
      }
      if (kOcclusion && !sweeping()) break;
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

// Plain C entry for ctypes. `rows` is the packed table [tp, 20]
// (pack_mat_table), 16-byte aligned. With `active`, `live` lists the active
// rays in ascending order and `n_live` (on the device) counts them; without
// it both are null and every ray is live. The live rays are split evenly
// over at least `spread` blocks. Nearest mode (occlusion 0) writes
// t_out/i_out, any-hit mode (occlusion 1) reads max_t and writes occ_out
// (bool bytes). Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int rt_mat_trace(const void* feats, const void* live,
                            const void* n_live, const void* max_t,
                            const void* active, const void* rows, int n,
                            int tp, int spread, float t_min, int occlusion,
                            void* t_out, void* i_out, void* occ_out,
                            void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kBlockRays - 1) / kBlockRays;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(feats);
  const auto* l = static_cast<const int*>(live);
  const auto* c = static_cast<const int*>(n_live);
  const auto* m = static_cast<const float*>(max_t);
  const auto* a = static_cast<const uint8_t*>(active);
  const auto* w = static_cast<const float*>(rows);
  spread = spread > 0 ? spread : 1;
  if (occlusion) {
    mat_trace_kernel<true><<<blocks, kThreads, 0, s>>>(
        f, l, c, m, a, w, n, tp, spread, t_min, nullptr, nullptr,
        static_cast<uint8_t*>(occ_out));
  } else {
    mat_trace_kernel<false><<<blocks, kThreads, 0, s>>>(
        f, l, c, m, a, w, n, tp, spread, t_min, static_cast<float*>(t_out),
        static_cast<int*>(i_out), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
