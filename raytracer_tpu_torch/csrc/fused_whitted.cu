// Fused Whitted forward — one thread per pixel renders the Whitted tree of
// its pixel: raygen, the winner search over the scene's spheres, planes and
// ≤64 flat triangles, Phong with one shadow any-hit per light, fresnel, and
// the depth-first mirror/glass recursion. Three output modes (a template
// parameter), by what the caller reads:
//   image      RGB only. Visits only the live nodes: a child only where its
//              parent is a valid mirror/glass hit (reflect) or a valid glass
//              hit with a refracted ray (refract), the edges whose weight is
//              not a structural zero; shadow sweeps only on diffuse hits and
//              only toward lights in front of the surface (ldn > 0: the
//              occlusion bit is read only as vis·ldn).
//   live plan  RGB and, for the live nodes only, the plan entries (winner
//              id, −1 = miss; per-light occlusion bitmask) that the train
//              kernel reads: the winners, and the occlusion bits of diffuse
//              hits toward lights with ldn ≥ 0 (it reads a bit only as
//              vis·ldn and, at the tie ldn = 0, in ldn's gradient). Other
//              bits are 0; dead nodes' entries are left unwritten.
//   full plan  RGB and every node's plan entries (the reference's contract):
//              every node of the tree is evaluated, including misses and the
//              subtrees the pixel's path never reaches (D+1 nodes without
//              glass, 2^(D+1)−1 with glass); Phong only where the node's
//              radiance reaches the pixel.
//
// Replaces the TPU kernel raytracer_tpu/ops/fused.py::FusedWhitted._kernel
// (emit_plan=True/False; pallas_call in _render). Same contract, expression
// for expression: strict `<` winner search in sphere < plane < triangle
// order; the shadow test over all primitives from the side-biased origin with
// max_t = dist; the specular term NOT masked by the shadow; `w·bg` at
// max_depth; the refract child's path gains bit 1 << depth; eps added to the
// origin's x; RGB clamped to [0, 1]. The fold adds a node's children in the
// reference's order (reflect, then refract); a pruned child adds nothing
// where the reference adds 0·c, so the three modes give the same image up to
// the sign of a zero, which the final clamp erases.
//
// What bounds it on this card: arithmetic. A pixel writes 12 bytes of RGB
// (plus 8 per plan node written) and reads nothing but the scene, which every
// block stages once in shared memory (a few hundred bytes to a few KB); the
// work per node is the search over every primitive, and per shadow sweep a
// test per primitive up to the first occluder. The design answers that by
// doing only the work the output needs (the modes above) and keeping every
// operand on chip: scene in shared memory (a warp reads the same word, a
// broadcast), ray state in registers, the recursion on an explicit
// per-thread stack indexed by the runtime depth (local memory, L1-cached).
// Without glass the stack holds kChainLevels levels; deeper levels (max_depth
// > kChainLevels) go to a scratch buffer the wrapper allocates, [levels, 4,
// pixels], so no depth is refused. With glass (depth ≤ 5) six levels of
// reflect/refract rays. Each warp covers 8 × 4 pixels: a square-ish warp
// keeps neighbouring pixels, whose trees are alike, in one warp, so fewer
// lanes idle while the busiest one walks its tree.
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

constexpr int kThreads = 128;  // a block: 4 warps stacked vertically
constexpr int kWarpW = 8;      // a warp: 8 × 4 pixels; a block 8 × 16
constexpr int kImage = 0, kLivePlan = 1, kFullPlan = 2;

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

// One node of the tree: the winner search, the shadow any-hits the mode
// needs (see the top), then the shared node shading → n.rad (this node's
// radiance without its children), and when the node has children: the
// reflect ray (ro, rd) with weight wr and, with glass, the refract ray
// (to, td) with weight wt. `live`: the node's radiance reaches the pixel.
template <bool kGlass, int kMode>
__device__ void eval_node(const SceneView& s, const float* o, const float* d,
                          bool leaf, bool live, const float* bg, int* win_out,
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
  if constexpr (kMode != kImage) *win_out = win;
  node_surface(s, o, d, win, best_t, n);

  // one shadow any-hit per light from the side-biased origin
  int occ = 0;
  if (kMode == kFullPlan || n.diff) {
    const float side = n.din < 0.0f ? 1.0f : -1.0f;
    float so[3];
    for (int k = 0; k < 3; ++k) so[k] = n.p[k] + side * s.bias * n.nrm[k];
    for (int li = 0; li < s.nl; ++li) {
      const LightDir l = light_dir(s.lgt + 6 * li, n.p);
      const float mld = dot3(l.ldir, n.nrm);
      if (kMode == kImage && !(mld > 0.0f)) continue;
      if (kMode == kLivePlan && mld < 0.0f) continue;
      occ |= static_cast<int>(occluded(s, so, l.ldir, l.dist)) << li;
    }
  }
  if constexpr (kMode != kImage) *occ_out = occ;
  node_shade<kGlass, kMode == kFullPlan>(s, d, occ, leaf, bg, n, live);
}

// A stack level: the node's own radiance (0..2) and its reflect weight (3).
// With kDeep (a chain deeper than kLevels), the levels past kLevels live in
// the scratch buffer.
template <int kLevels, bool kDeep>
struct Stack {
  float on[kLevels][4];
  float* deep;  // this pixel's [levels − kLevels, 4] slots, stride `stride`
  size_t stride;
  __device__ __forceinline__ float& at(int b, int k) {
    if (kDeep && b >= kLevels)
      return deep[(static_cast<size_t>(b - kLevels) * 4 + k) * stride];
    return on[b][k];
  }
};

template <bool kGlass, int kMode, bool kDeep>
__global__ void __launch_bounds__(kThreads)
fused_whitted_kernel(const float* __restrict__ sph_g,
                     const float* __restrict__ pln_g,
                     const float* __restrict__ mat_g,
                     const float* __restrict__ lgt_g,
                     const float* __restrict__ stat_g,
                     const int* __restrict__ ids_g,
                     const float* __restrict__ cam_g, int ns, int np, int nt,
                     int nm, int nl, int max_depth, float t_min, float bias,
                     float bg_r, float bg_g, float bg_b, int width, int height,
                     int row0, int rows, float eps,
                     float* __restrict__ img, int* __restrict__ plan,
                     float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const float* cam;
  const SceneView s =
      stage_scene(smem, sph_g, pln_g, mat_g, lgt_g, stat_g, ids_g, cam_g, ns,
                  np, nt, nm, nl, t_min, bias, &cam);
  __syncthreads();

  // the block is a kWarpW-wide tile of kThreads / kWarpW rows
  const int tid = threadIdx.x;
  const int col = blockIdx.x * kWarpW + tid % kWarpW;
  const int r = blockIdx.y * (kThreads / kWarpW) + tid / kWarpW;
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
  Stack<kGlass ? kGlassLevels : kChainLevels, kDeep> st;
  st.deep = scratch + px;
  st.stride = plane_px;
  float sto[kGlass ? kGlassLevels : 1][3], stdir[kGlass ? kGlassLevels : 1][3];
  float swt[kGlass ? kGlassLevels : 1];
  unsigned on_refract = 0;  // bit b: level b is in its refract subtree
  unsigned todo_t = 0;      // bit b: level b's refract child is still to visit
  unsigned live_t = 0;      // bit b: that refract child is live
  bool live = true;         // the current node's radiance reaches the pixel
  int depth = 0, path = 0;
  float c[3];
  for (;;) {
    const int node = (kGlass ? (1 << depth) - 1 : depth) + path;
    int* win_out = kMode != kImage ? plan + node * plane_px + px : nullptr;
    int* occ_out =
        kMode != kImage ? plan + (n_nodes + node) * plane_px + px : nullptr;
    const bool leaf = depth == max_depth;
    Node n;
    eval_node<kGlass, kMode>(s, o, d, leaf, live, bg, win_out, occ_out, n);
    const bool on_r = n.valid && (n.mir || n.gls);
    const bool on_t = kGlass && n.valid && n.gls && n.t_ok;
    // the children visited: every one in the full plan, the live ones else
    const bool go_r = !leaf && (kMode == kFullPlan || on_r);
    const bool go_t = kGlass && !leaf && (kMode == kFullPlan || on_t);
    if (go_r) {  // descend into the reflect child
      for (int k = 0; k < 3; ++k) {
        st.at(depth, k) = n.rad[k];
        o[k] = n.ro[k];
        d[k] = n.rd[k];
      }
      st.at(depth, 3) = n.wr;
      if constexpr (kGlass) {
        for (int k = 0; k < 3; ++k) {
          sto[depth][k] = n.to[k];
          stdir[depth][k] = n.td[k];
        }
        swt[depth] = n.wt;
        const unsigned bit = 1u << depth;
        on_refract &= ~bit;
        todo_t = go_t ? (todo_t | bit) : (todo_t & ~bit);
        live_t = (live && on_t) ? (live_t | bit) : (live_t & ~bit);
      }
      live = live && on_r;
      ++depth;
      continue;
    }
    // no child to visit: fold its radiance up until a refract child is
    // still to visit
    for (int k = 0; k < 3; ++k) c[k] = n.rad[k];
    bool next = false;
    while (depth > 0) {
      const int b = depth - 1;
      const unsigned bit = kGlass ? 1u << b : 0u;  // glass: b < kGlassLevels
      if (kGlass && (on_refract & bit)) {
        for (int k = 0; k < 3; ++k) st.at(b, k) += swt[b] * c[k];
        on_refract &= ~bit;
        path -= 1 << b;
      } else {
        const float w = st.at(b, 3);
        for (int k = 0; k < 3; ++k) st.at(b, k) += w * c[k];
        if (kGlass && (todo_t & bit)) {  // now the refract child
          on_refract |= bit;
          todo_t &= ~bit;
          path += 1 << b;
          for (int k = 0; k < 3; ++k) {
            o[k] = sto[b][k];
            d[k] = stdir[b][k];
          }
          live = (live_t & bit) != 0;
          next = true;
          break;
        }
      }
      for (int k = 0; k < 3; ++k) c[k] = st.at(b, k);
      depth = b;
    }
    if (!next) break;
  }
  float* out = img + 3 * px;
  for (int k = 0; k < 3; ++k) out[k] = fminf(fmaxf(c[k], 0.0f), 1.0f);
}

template <int kMode>
void* pick(bool glass, bool deep) {
  if (glass)
    return reinterpret_cast<void*>(fused_whitted_kernel<true, kMode, false>);
  return deep ? reinterpret_cast<void*>(fused_whitted_kernel<false, kMode, true>)
              : reinterpret_cast<void*>(fused_whitted_kernel<false, kMode, false>);
}

}  // namespace

// Stack levels a launch keeps in the scratch buffer, per pixel (4 floats
// each): 0 unless a glass-free tree is deeper than the on-chip stack.
extern "C" int rt_fused_whitted_deep_levels(int max_depth, int glass) {
  return glass ? 0 : (max_depth > kChainLevels ? max_depth - kChainLevels : 0);
}

// Plain C entry for ctypes. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success). `mode`: 0 image, 1 live plan, 2
// full plan; `plan` ([2·n_nodes, rows, width] i32) is read only in the plan
// modes. `scratch`: [rt_fused_whitted_deep_levels, 4, rows, width] f32, or
// null when that is 0.
extern "C" int rt_fused_whitted(
    const void* sph, const void* pln, const void* mat, const void* lgt,
    const void* stat, const void* ids, const void* cam, int ns, int np,
    int nt, int nm, int nl, int max_depth, int glass, float t_min, float bias,
    float bg_r, float bg_g, float bg_b, int width, int height, int row0,
    int rows, float eps, int mode, void* img, void* plan,
    void* scratch, void* stream) {
  if (rows <= 0 || width <= 0) return 0;
  if (max_depth < 0 || (glass && max_depth >= kGlassLevels) || mode < kImage ||
      mode > kFullPlan || (mode != kImage && !plan) ||
      (rt_fused_whitted_deep_levels(max_depth, glass) > 0 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scene_smem_bytes(ns, np, nt, nm, nl);
  if (smem > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int tile_h = kThreads / kWarpW;
  const dim3 grid((width + kWarpW - 1) / kWarpW, (rows + tile_h - 1) / tile_h);
  const bool deep = rt_fused_whitted_deep_levels(max_depth, glass) > 0;
  void* kern = mode == kImage       ? pick<kImage>(glass, deep)
               : mode == kLivePlan  ? pick<kLivePlan>(glass, deep)
                                    : pick<kFullPlan>(glass, deep);
  const float* sph_f = static_cast<const float*>(sph);
  const float* pln_f = static_cast<const float*>(pln);
  const float* mat_f = static_cast<const float*>(mat);
  const float* lgt_f = static_cast<const float*>(lgt);
  const float* stat_f = static_cast<const float*>(stat);
  const int* ids_i = static_cast<const int*>(ids);
  const float* cam_f = static_cast<const float*>(cam);
  float* img_f = static_cast<float*>(img);
  int* plan_i = static_cast<int*>(plan);
  float* scratch_f = static_cast<float*>(scratch);
  void* args[] = {&sph_f, &pln_f, &mat_f, &lgt_f, &stat_f, &ids_i, &cam_f,
                  &ns, &np, &nt, &nm, &nl, &max_depth, &t_min, &bias, &bg_r,
                  &bg_g, &bg_b, &width, &height, &row0, &rows, &eps, &img_f,
                  &plan_i, &scratch_f};
  const cudaError_t err =
      cudaLaunchKernel(kern, grid, dim3(kThreads), args, smem,
                       static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
