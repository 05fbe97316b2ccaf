// Fused Whitted forward — one thread per pixel renders the whole Whitted tree
// of its pixel: raygen, the winner search over the scene's spheres, planes and
// ≤64 flat triangles, Phong with one shadow any-hit per light, fresnel, and
// the depth-first mirror/glass recursion. With a plan buffer it also writes,
// per recursion node, the winner id (−1 = miss) and the per-light occlusion
// bitmask.
//
// Replaces the TPU kernel raytracer_tpu/ops/fused.py::FusedWhitted._kernel
// (emit_plan=True/False; pallas_call in _render). Same contract, expression
// for expression: strict `<` winner search in sphere < plane < triangle
// order; the shadow test over all primitives from the side-biased origin with
// max_t = dist; the specular term NOT masked by the shadow; occlusion bits
// and plan planes written for every node of the tree, including misses,
// mirror/glass hits and subtrees the pixel's path never reaches (every pixel
// evaluates D+1 nodes without glass, 2^(D+1)−1 with glass); `w·bg` at
// max_depth; the refract child's path gains bit 1 << depth; eps added to the
// origin's x; RGB clamped to [0, 1].
//
// What bounds it on this card: arithmetic. A pixel writes 12 bytes of RGB
// (plus 8 per plan node) and reads nothing but the scene, which every block
// stages once in shared memory (four live tables plus static plane/triangle/
// material data — a few hundred bytes to a few KB); the work per pixel is
// thousands of fp32 ops per node (the search and one shadow sweep per light
// over every primitive). The design answers that only by keeping every
// operand on chip: scene in shared memory (a warp reads the same word, a
// broadcast), ray state in registers, the recursion on an explicit
// per-thread stack (one level per depth). The stack is indexed by the
// runtime depth, so it lives in local memory (L1-cached); with glass at
// depth 5 that is the six-level frame of reflect/refract rays. ptxas -v
// (CUDA 12.8, sm_90a): without glass 61 registers, a 512-byte stack frame
// (the 32-level chain), no spills; with glass 69 registers, a 264-byte
// frame, no spills. Not tuned. Specialising per scene (NVRTC or
// templates over the primitive counts) and pruning dead subtrees are later
// work; both must keep the plan contract above.
//
// Baked and param mode are the same kernel: the caller passes the live tables
// (bind writes into them) and the counts come from the scene, never from the
// table heights (an absent primitive kind keeps one zero row).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py). No
// multiply-add contraction: each product and sum rounds as the plain torch
// version's separate ops do, in the same order.

#include "whitted_common.cuh"

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 4;

__device__ bool occluded(const SceneView& s, const float* o, const float* d,
                         float max_t) {
  for (int i = 0; i < s.ns; ++i)
    if (sphere_t(o, d, s.sph + 4 * i, s.t_min) < max_t) return true;
  for (int i = 0; i < s.np; ++i)
    if (plane_t(o, d, s.pln + 9 * i, s.t_min) < max_t) return true;
  for (int i = 0; i < s.nt; ++i)
    if (tri_t(o, d, s.tri + 12 * i, s.t_min) < max_t) return true;
  return false;
}

// One node of the tree: the winner search and one shadow any-hit per light
// (on every lane: the plan records them all), then the shared node shading
// → n.rad (this node's radiance without its children), and when the node
// has children: the reflect ray (ro, rd) with weight wr and, with glass, the
// refract ray (to, td) with weight wt.
template <bool kGlass>
__device__ void eval_node(const SceneView& s, const float* o, const float* d,
                          bool leaf, const float* bg, int* win_out,
                          int* occ_out, Node& n) {
  // winner search (strict < keeps sphere < plane < triangle order)
  float best_t = CUDART_INF_F;
  int win = -1;
  for (int i = 0; i < s.ns; ++i) {
    const float ti = sphere_t(o, d, s.sph + 4 * i, s.t_min);
    if (ti < best_t) { best_t = ti; win = i; }
  }
  for (int i = 0; i < s.np; ++i) {
    const float ti = plane_t(o, d, s.pln + 9 * i, s.t_min);
    if (ti < best_t) { best_t = ti; win = s.ns + i; }
  }
  for (int i = 0; i < s.nt; ++i) {
    const float ti = tri_t(o, d, s.tri + 12 * i, s.t_min);
    if (ti < best_t) { best_t = ti; win = s.ns + s.np + i; }
  }
  if (win_out) *win_out = win;
  node_surface(s, o, d, win, best_t, n);

  // one shadow any-hit per light from the side-biased origin
  const float side = n.din < 0.0f ? 1.0f : -1.0f;
  float so[3];
  for (int k = 0; k < 3; ++k) so[k] = n.p[k] + side * s.bias * n.nrm[k];
  int occ = 0;
  for (int li = 0; li < s.nl; ++li) {
    const LightDir l = light_dir(s.lgt + 6 * li, n.p);
    occ |= static_cast<int>(occluded(s, so, l.ldir, l.dist)) << li;
  }
  if (occ_out) *occ_out = occ;
  node_shade<kGlass, true>(s, d, occ, leaf, bg, n);
}

template <bool kGlass>
__global__ void __launch_bounds__(kBlockX * kBlockY)
fused_whitted_kernel(const float* __restrict__ sph_g,
                     const float* __restrict__ pln_g,
                     const float* __restrict__ mat_g,
                     const float* __restrict__ lgt_g,
                     const float* __restrict__ stat_g,
                     const int* __restrict__ ids_g,
                     const float* __restrict__ cam_g, int ns, int np, int nt,
                     int nm, int nl, int max_depth, float t_min, float bias,
                     float bg_r, float bg_g, float bg_b, int width, int height,
                     int row0, int rows, float eps, float* __restrict__ img,
                     int* __restrict__ plan) {
  extern __shared__ float smem[];
  const float* cam;
  const SceneView s =
      stage_scene(smem, sph_g, pln_g, mat_g, lgt_g, stat_g, ids_g, cam_g, ns,
                  np, nt, nm, nl, t_min, bias, &cam);
  __syncthreads();

  const int col = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (col >= width || r >= rows) return;
  const float bg[3] = {bg_r, bg_g, bg_b};

  // raygen (full-image projection)
  float o[3], d[3];
  eye_ray(cam, row0 + r, col, width, height, eps, o, d);

  const size_t plane_px = static_cast<size_t>(rows) * width;
  const size_t px = static_cast<size_t>(r) * width + col;
  const int n_nodes = kGlass ? (1 << (max_depth + 1)) - 1 : max_depth + 1;

  // explicit depth-first stack: per level, the node's own radiance and the
  // weights and rays of its children still to fold in
  constexpr int kLevels = kGlass ? kGlassLevels : kChainLevels;
  float srad[kLevels][3];
  float swr[kLevels];
  float sto[kGlass ? kGlassLevels : 1][3], stdir[kGlass ? kGlassLevels : 1][3];
  float swt[kGlass ? kGlassLevels : 1];
  unsigned on_refract = 0;  // bit b: level b is in its refract subtree
  int depth = 0, path = 0;
  float c[3];
  for (;;) {
    const int node = (kGlass ? (1 << depth) - 1 : depth) + path;
    int* win_out = plan ? plan + node * plane_px + px : nullptr;
    int* occ_out = plan ? plan + (n_nodes + node) * plane_px + px : nullptr;
    const bool leaf = depth == max_depth;
    Node n;
    eval_node<kGlass>(s, o, d, leaf, bg, win_out, occ_out, n);
    if (!leaf) {  // descend into the reflect child
      for (int k = 0; k < 3; ++k) {
        srad[depth][k] = n.rad[k];
        o[k] = n.ro[k];
        d[k] = n.rd[k];
      }
      swr[depth] = n.wr;
      if constexpr (kGlass) {
        for (int k = 0; k < 3; ++k) {
          sto[depth][k] = n.to[k];
          stdir[depth][k] = n.td[k];
        }
        swt[depth] = n.wt;
        on_refract &= ~(1u << depth);
      }
      ++depth;
      continue;
    }
    // a leaf: fold its radiance up until a refract child is still to visit
    for (int k = 0; k < 3; ++k) c[k] = n.rad[k];
    bool next = false;
    while (depth > 0) {
      const int b = depth - 1;
      if (kGlass && ((on_refract >> b) & 1u)) {
        for (int k = 0; k < 3; ++k) srad[b][k] += swt[b] * c[k];
        on_refract &= ~(1u << b);
        path -= 1 << b;
      } else {
        for (int k = 0; k < 3; ++k) srad[b][k] += swr[b] * c[k];
        if constexpr (kGlass) {  // now the refract child, at the same depth
          on_refract |= 1u << b;
          path += 1 << b;
          for (int k = 0; k < 3; ++k) {
            o[k] = sto[b][k];
            d[k] = stdir[b][k];
          }
          next = true;
          break;
        }
      }
      for (int k = 0; k < 3; ++k) c[k] = srad[b][k];
      depth = b;
    }
    if (!next) break;
  }
  float* out = img + 3 * px;
  for (int k = 0; k < 3; ++k) out[k] = fminf(fmaxf(c[k], 0.0f), 1.0f);
}

}  // namespace

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success). `plan` may be null (no plan).
extern "C" int rt_fused_whitted(
    const void* sph, const void* pln, const void* mat, const void* lgt,
    const void* stat, const void* ids, const void* cam, int ns, int np,
    int nt, int nm, int nl, int max_depth, int glass, float t_min, float bias,
    float bg_r, float bg_g, float bg_b, int width, int height, int row0,
    int rows, float eps, void* img, void* plan, void* stream) {
  if (rows <= 0 || width <= 0) return 0;
  if (max_depth < 0 || max_depth >= (glass ? kGlassLevels : kChainLevels))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scene_smem_bytes(ns, np, nt, nm, nl);
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (rows + kBlockY - 1) / kBlockY);
  auto kern = glass ? fused_whitted_kernel<true> : fused_whitted_kernel<false>;
  kern<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sph), static_cast<const float*>(pln),
      static_cast<const float*>(mat), static_cast<const float*>(lgt),
      static_cast<const float*>(stat), static_cast<const int*>(ids),
      static_cast<const float*>(cam), ns, np, nt, nm, nl, max_depth, t_min,
      bias, bg_r, bg_g, bg_b, width, height, row0, rows, eps,
      static_cast<float*>(img), static_cast<int*>(plan));
  return static_cast<int>(cudaGetLastError());
}
