// Brute-force triangle search as a linear expansion — one thread per ray:
// four 10-term dots of the ray's features with each triangle's weights,
// then Möller–Trumbore's validity tests; nearest or any-hit.
//
// Replaces the TPU kernels raytracer_tpu/ops/mat_trace.py::
// _make_nearest_kernel (K4a, launched by mat_nearest) and
// _make_occluded_kernel (K4b, launched by mat_occluded). Same function:
// feats [N,16] (f = [d, o×d, o, 1, 0…], ray_features) times weights
// [16, 4·Tp] (columns det|u|v|t per block of bt triangles,
// build_tri_weights), then the reference's _epilogue (|det| > eps, u, v, t
// by one reciprocal, the barycentric and t > t_min tests) and a strict `<`
// fold in ascending triangle order (the first index wins exact-t ties; a
// miss is t = +inf, idx 0), or any t below max_t. One addition: a lane
// masked out by `active` returns a miss (not occluded) and tests nothing.
//
// The reference runs the product on the TPU's matrix unit at HIGHEST
// precision. Here every term is a full fp32 product on the CUDA cores,
// summed in the order k = 0…9 — no TF32 and no tensor cores, whose
// rounding reorders winners — so the plain torch version, which sums the
// same terms in the same order, reproduces the kernel bit for bit.
//
// What bounds it on this card: operations. Every live ray tests every
// triangle. The function needs 39 fp32 operations per test (the dots over
// the weights' non-zero rows only, 33, plus 6 for the epilogue, as
// chip_smoke.py counts them for the bound); this kernel executes 82 (76
// for the four full 10-term dots). The weight table is 5.2 MB at 20,480
// triangles, resident in L2 and shared by all rays. The design answers
// that:
//   - a ray's 10 features live in registers;
//   - the block stages a tile of 256 triangles' 4 × 10 coefficients
//     (40 KB of static shared memory, triangle-major, 160 B each) with
//     coalesced reads of the weight columns, once for its 256 rays; each
//     thread then reads a triangle's 40 coefficients as 10 float4
//     broadcasts (all lanes of a warp on the same triangle), so the shared
//     memory pipe issues 10 loads per test against 82 arithmetic ops;
//   - as in tri_trace.cu, masked lanes never sweep, an any-hit lane stops
//     at its first occluder, and the block stops loading tiles once no lane
//     of it is sweeping (a block-wide vote).
// The dots include the weights' structural zeros (det uses 3 of the 10
// rows, u and v 6, t 4), as the TPU kernel's product does; skipping them
// is left to a later design.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py). No multiply-add contraction.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kDetEps = 1e-8f;
constexpr int kThreads = 256;
constexpr int kTile = 256;   // triangles staged per step
constexpr int kFeat = 16;    // feature columns of feats and rows of weights
constexpr int kUsed = 10;    // of which the dots use the first 10
constexpr int kCoef = 4 * kUsed;  // coefficients per triangle (det|u|v|t)

// The dot of the 10 features with one quantity's coefficients, k = 0…9.
__device__ __forceinline__ float dot10(const float* f, const float* w) {
  float acc = f[0] * w[0];
#pragma unroll
  for (int k = 1; k < kUsed; ++k) acc = acc + f[k] * w[k];
  return acc;
}

template <bool kOcclusion>
__global__ void __launch_bounds__(kThreads)
mat_trace_kernel(const float* __restrict__ feats,     // [N,16]
                 const float* __restrict__ max_t,     // [N] (any-hit only)
                 const uint8_t* __restrict__ active,  // [N] bool or null
                 const float* __restrict__ weights,   // [16, 4·Tp]
                 int n, int tp, int bt, float t_min,
                 float* __restrict__ t_out, int* __restrict__ i_out,
                 uint8_t* __restrict__ occ_out) {
  __shared__ float4 s4[kTile * kCoef / 4];  // [kTile][40] floats
  float* s = reinterpret_cast<float*>(s4);
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = r < n;
  bool sweeping = in_range && (active == nullptr || active[r]);

  float f[kUsed];
#pragma unroll
  for (int k = 0; k < kUsed; ++k)
    f[k] = sweeping ? feats[static_cast<size_t>(r) * kFeat + k] : 0.0f;
  const float mt = (kOcclusion && sweeping) ? max_t[r] : 0.0f;
  const size_t ncols = static_cast<size_t>(4) * tp;
  float best = CUDART_INF_F;
  int bi = 0;
  bool occluded = false;

  for (int base = 0; base < tp; base += kTile) {
    // Every thread reaches this vote, sweeping or not: the barrier before
    // the tile is overwritten, and the block-wide end of the sweep.
    if (!__syncthreads_or(sweeping)) break;
    const int cnt = min(kTile, tp - base);
    for (int e = threadIdx.x; e < kTile * kCoef; e += kThreads) {
      const int jj = e % kTile, c = e / kTile;  // c = quantity · 10 + row
      if (jj < cnt) {
        const int j = base + jj, q = c / kUsed, k = c % kUsed;
        const int b = j / bt;  // the weight block of triangle j
        const size_t col = static_cast<size_t>(4 * b + q) * bt + (j - b * bt);
        s[jj * kCoef + c] = __ldg(weights + k * ncols + col);
      }
    }
    __syncthreads();
    if (!sweeping) continue;
    for (int j = 0; j < cnt; ++j) {
      float4 w4[kCoef / 4];
#pragma unroll
      for (int i = 0; i < kCoef / 4; ++i) w4[i] = s4[j * (kCoef / 4) + i];
      const float* w = reinterpret_cast<const float*>(w4);
      const float det = dot10(f, w);
      const float un = dot10(f, w + kUsed);
      const float vn = dot10(f, w + 2 * kUsed);
      const float tn = dot10(f, w + 3 * kUsed);
      // the reference's _epilogue
      const bool det_ok = fabsf(det) > kDetEps;
      const float inv = det_ok ? 1.0f / det : 0.0f;
      const float u = un * inv, v = vn * inv, t = tn * inv;
      const bool hit = det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                       u + v <= 1.0f && t > t_min;
      const float tc = hit ? t : CUDART_INF_F;
      if (kOcclusion) {
        if (tc < mt) {
          occluded = true;
          sweeping = false;
          break;
        }
      } else if (tc < best) {  // strict: the first index wins exact-t ties
        best = tc;
        bi = base + j;
      }
    }
  }
  if (!in_range) return;
  if (kOcclusion) {
    occ_out[r] = occluded ? 1 : 0;
  } else {
    t_out[r] = best;
    i_out[r] = bi;
  }
}

}  // namespace

// Plain C entry for ctypes. `tp` triangles in weight blocks of `bt` (tp a
// multiple of bt). Nearest mode (occlusion 0) writes t_out/i_out, any-hit
// mode (occlusion 1) reads max_t and writes occ_out (bool bytes). `active`
// may be null. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int rt_mat_trace(const void* feats, const void* max_t,
                            const void* active, const void* weights, int n,
                            int tp, int bt, float t_min, int occlusion,
                            void* t_out, void* i_out, void* occ_out,
                            void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const float*>(feats);
  const auto* m = static_cast<const float*>(max_t);
  const auto* a = static_cast<const uint8_t*>(active);
  const auto* w = static_cast<const float*>(weights);
  if (occlusion) {
    mat_trace_kernel<true><<<blocks, kThreads, 0, s>>>(
        f, m, a, w, n, tp, bt, t_min, nullptr, nullptr,
        static_cast<uint8_t*>(occ_out));
  } else {
    mat_trace_kernel<false><<<blocks, kThreads, 0, s>>>(
        f, m, a, w, n, tp, bt, t_min, static_cast<float*>(t_out),
        static_cast<int*>(i_out), nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
