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
// (CUDA 12.8, sm_90a): without glass 64 registers, a 528-byte stack frame
// (the 32-level chain) and 8 bytes of spills; with glass 77 registers, a
// 264-byte frame, no spills. Not tuned. Specialising per scene (NVRTC or
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

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kDetEps = 1e-8f;
constexpr int kBlockX = 32;
constexpr int kBlockY = 4;
constexpr int kGlassLevels = 6;    // MAX_GLASS_DEPTH + 1
constexpr int kChainLevels = 32;   // KERNEL_MAX_LEVELS (no glass)
constexpr int kSmemBytes = 48 * 1024;
constexpr int kReflection = 1;
constexpr int kReflectionAndRefraction = 2;

// The packed scene, staged in shared memory.
struct SceneView {
  const float* sph;    // [ns, 4] center | radius
  const float* pln;    // [np, 9] point | normal | albedo2
  const float* mat;    // [nm, 7] albedo | kd | ks | spec_n | ior
  const float* lgt;    // [nl, 6] pos | intensity
  const float* pstat;  // [np, 8] tangent | bitangent | checker_scale | checker
  const float* tri;    // [nt, 12] v0 | e1 | e2 | normal
  const int* mid;      // [ns + np + nt] material id per primitive
  const int* mtype;    // [nm]
  int ns, np, nt, nl;
  float t_min, bias;
};

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ float sphere_t(const float* o, const float* d,
                                          const float* s, float t_min) {
  const float L[3] = {o[0] - s[0], o[1] - s[1], o[2] - s[2]};
  const float r = s[3];
  const float a = dot3(d, d);
  const float b = 2.0f * dot3(d, L);
  const float c0 = dot3(L, L) - r * r;
  const float disc = b * b - 4.0f * a * c0;
  const bool has = disc >= 0.0f;
  float sq = sqrtf(fmaxf(has ? disc : 1.0f, 1e-12f));
  sq = has ? sq : 0.0f;
  const float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
  const float t0 = q / a;
  const bool okq = fabsf(q) > 1e-12f;
  const float t1 = okq ? c0 / q : -CUDART_INF_F;
  const float tlo = fminf(t0, t1);
  const float thi = fmaxf(t0, t1);
  const float t = tlo > t_min ? tlo : (thi > t_min ? thi : CUDART_INF_F);
  return has ? t : CUDART_INF_F;
}

__device__ __forceinline__ float plane_t(const float* o, const float* d,
                                         const float* pl, float t_min) {
  const float* n = pl + 3;
  const float denom = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];
  const bool valid = fabsf(denom) > kDetEps;
  const float num = (pl[0] - o[0]) * n[0] + (pl[1] - o[1]) * n[1] +
                    (pl[2] - o[2]) * n[2];
  const float t = valid ? num / denom : -CUDART_INF_F;
  return (valid && t > t_min) ? t : CUDART_INF_F;
}

__device__ __forceinline__ float tri_t(const float* o, const float* d,
                                       const float* tr, float t_min) {
  const float* v0 = tr;
  const float* e1 = tr + 3;
  const float* e2 = tr + 6;
  const float pv[3] = {d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
                       d[0] * e2[1] - d[1] * e2[0]};
  const float det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2];
  bool ok = fabsf(det) > kDetEps;
  const float inv = ok ? 1.0f / det : 0.0f;
  const float tv[3] = {o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]};
  const float u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv;
  const float qv[3] = {tv[1] * e1[2] - tv[2] * e1[1],
                       tv[2] * e1[0] - tv[0] * e1[2],
                       tv[0] * e1[1] - tv[1] * e1[0]};
  const float v = dot3(d, qv) * inv;
  const float t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv;
  ok = ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
       t > t_min;
  return ok ? t : CUDART_INF_F;
}

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

// One node of the tree: search, shade, fresnel and the child rays.
// → rad (this node's radiance without its children), and when the node has
// children: the reflect ray (ro, rd) with weight wr and, with glass, the
// refract ray (to, td) with weight wt.
template <bool kGlass>
__device__ void eval_node(const SceneView& s, const float* o, const float* d,
                          bool leaf, const float* bg, int* win_out,
                          int* occ_out, float* rad, float* ro, float* rd,
                          float& wr, float* to, float* td, float& wt) {
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
  const bool valid = win >= 0;
  if (win_out) *win_out = win;
  const float tt = valid ? best_t : 0.0f;
  const float p[3] = {o[0] + tt * d[0], o[1] + tt * d[1], o[2] + tt * d[2]};

  // winner attributes (miss: zero normal/albedo, spec_n = ior = 1)
  float nrm[3] = {0.0f, 0.0f, 0.0f}, alb[3] = {0.0f, 0.0f, 0.0f};
  float kd = 0.0f, ks = 0.0f, spec_n = 1.0f, ior = 1.0f;
  bool mir = false, gls = false;
  if (valid) {
    const int m = s.mid[win];
    const float* mt = s.mat + 7 * m;
    alb[0] = mt[0]; alb[1] = mt[1]; alb[2] = mt[2];
    if (win < s.ns) {
      const float* c = s.sph + 4 * win;
      const float inv_r = 1.0f / c[3];
      for (int k = 0; k < 3; ++k) nrm[k] = (p[k] - c[k]) * inv_r;
    } else if (win < s.ns + s.np) {
      const int j = win - s.ns;
      const float* pl = s.pln + 9 * j;
      const float* st = s.pstat + 8 * j;
      nrm[0] = pl[3]; nrm[1] = pl[4]; nrm[2] = pl[5];
      if (st[7] != 0.0f) {
        const float rel[3] = {p[0] - pl[0], p[1] - pl[1], p[2] - pl[2]};
        const float u = dot3(rel, st) * st[6];
        const float v = dot3(rel, st + 3) * st[6];
        const bool pat = (u - floorf(u) > 0.5f) != (v - floorf(v) > 0.5f);
        if (pat) { alb[0] = pl[6]; alb[1] = pl[7]; alb[2] = pl[8]; }
      }
    } else {
      const float* tr = s.tri + 12 * (win - s.ns - s.np);
      nrm[0] = tr[9]; nrm[1] = tr[10]; nrm[2] = tr[11];
    }
    kd = mt[3]; ks = mt[4]; spec_n = mt[5]; ior = mt[6];
    mir = s.mtype[m] == kReflection;
    gls = s.mtype[m] == kReflectionAndRefraction;
  }
  for (int k = 0; k < 3; ++k) rad[k] = valid ? 0.0f : bg[k];

  // Phong + one shadow any-hit per light, for every lane
  const float din = dot3(d, nrm);
  const float side = din < 0.0f ? 1.0f : -1.0f;
  float so[3];
  for (int k = 0; k < 3; ++k) so[k] = p[k] + side * s.bias * nrm[k];
  float lamt[3] = {0.0f, 0.0f, 0.0f}, spec[3] = {0.0f, 0.0f, 0.0f};
  int occ_acc = 0;
  for (int li = 0; li < s.nl; ++li) {
    const float* lpos = s.lgt + 6 * li;
    const float* lint = lpos + 3;
    const float lvec[3] = {lpos[0] - p[0], lpos[1] - p[1], lpos[2] - p[2]};
    const float d2 = dot3(lvec, lvec);
    float dist = sqrtf(fmaxf(d2, 1e-12f));
    dist = d2 > 0.0f ? dist : 0.0f;
    const float il = 1.0f / fmaxf(dist, 1e-12f);
    const float ldir[3] = {lvec[0] * il, lvec[1] * il, lvec[2] * il};
    const float ldn = fmaxf(0.0f, dot3(ldir, nrm));
    const bool shadowed = occluded(s, so, ldir, dist);
    occ_acc |= static_cast<int>(shadowed) << li;
    const float vis = shadowed ? 0.0f : 1.0f;
    const float mld = dot3(ldir, nrm);
    float rl[3];
    for (int k = 0; k < 3; ++k) rl[k] = -ldir[k] + 2.0f * mld * nrm[k];
    const float base = -dot3(rl, d);
    const float pw = base > 0.0f ? powf(fmaxf(base, 1e-7f), spec_n) : 0.0f;
    for (int k = 0; k < 3; ++k) {
      lamt[k] += vis * ldn * lint[k];
      spec[k] += pw * lint[k];
    }
  }
  if (occ_out) *occ_out = occ_acc;
  const bool is_diff = valid && !mir && !gls;
  for (int k = 0; k < 3; ++k) {
    const float local = lamt[k] * alb[k] * kd + spec[k] * ks;
    rad[k] += is_diff ? local : 0.0f;
  }

  // fresnel kr (kr = 1 on total internal reflection)
  const float cosi = fminf(fmaxf(din, -1.0f), 1.0f);
  const bool entering = cosi <= 0.0f;
  const float etai = entering ? 1.0f : ior;
  const float etat = entering ? ior : 1.0f;
  const float s2 = fmaxf(1.0f - cosi * cosi, 0.0f);
  const float sq2 = s2 > 0.0f ? sqrtf(fmaxf(s2, 1e-12f)) : 0.0f;
  const float sint = etai / etat * sq2;
  const bool no_tir = sint < 1.0f;
  const float c2 = fmaxf(1.0f - sint * sint, 0.0f);
  const float cost = no_tir ? sqrtf(fmaxf(c2, 1e-12f)) : 0.0f;
  const float cosa = fabsf(cosi);
  const float den1 = etat * cosa + etai * cost;
  const float den2 = etai * cosa + etat * cost;
  const float rs = no_tir ? (etat * cosa - etai * cost) / den1 : 0.0f;
  const float rp = no_tir ? (etai * cosa - etat * cost) / den2 : 0.0f;
  const float kr = no_tir ? 0.5f * (rs * rs + rp * rp) : 1.0f;

  if (leaf) {
    // children would exceed max_depth → each returns bg
    const float w = (valid && mir) ? kr : ((valid && gls) ? 1.0f : 0.0f);
    for (int k = 0; k < 3; ++k) rad[k] += w * bg[k];
    return;
  }

  // reflect child (weight kr on mirror and glass lanes)
  float rdw[3];
  for (int k = 0; k < 3; ++k) rdw[k] = d[k] - 2.0f * din * nrm[k];
  const float rinv = rsqrtf(fmaxf(dot3(rdw, rdw), 1e-12f));
  for (int k = 0; k < 3; ++k) rd[k] = rdw[k] * rinv;
  const float rside = dot3(rd, nrm) < 0.0f ? -1.0f : 1.0f;
  for (int k = 0; k < 3; ++k) ro[k] = p[k] + rside * s.bias * nrm[k];
  wr = (valid && (mir || gls)) ? kr : 0.0f;

  if constexpr (kGlass) {
    // refract child (weight 1 − kr where the refraction exists)
    const bool ent_t = din < 0.0f;
    const float cosa_t = fabsf(fminf(fmaxf(din, -1.0f), 1.0f));
    const float etai_t = ent_t ? 1.0f : ior;
    const float etat_t = ent_t ? ior : 1.0f;
    float n_o[3];
    for (int k = 0; k < 3; ++k) n_o[k] = ent_t ? nrm[k] : -nrm[k];
    const float eta = etai_t / etat_t;
    const float kk = 1.0f - eta * eta * (1.0f - cosa_t * cosa_t);
    const bool t_ok = kk >= 0.0f;
    const float sqk = t_ok ? sqrtf(fmaxf(kk, 1e-12f)) : 0.0f;
    for (int k = 0; k < 3; ++k)
      td[k] = t_ok ? eta * d[k] + (eta * cosa_t - sqk) * n_o[k] : 0.0f;
    const float tn2 = dot3(td, td);
    const float tinv = t_ok ? 1.0f / sqrtf(fmaxf(tn2, 1e-12f)) : 1.0f;
    for (int k = 0; k < 3; ++k) td[k] = td[k] * tinv;
    const float tside = dot3(td, nrm) < 0.0f ? -1.0f : 1.0f;
    for (int k = 0; k < 3; ++k) to[k] = p[k] + tside * s.bias * nrm[k];
    wt = (valid && gls && t_ok) ? 1.0f - kr : 0.0f;
  }
}

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n; i += blockDim.x * blockDim.y) dst[i] = src[i];
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
  SceneView s;
  float* f = smem;
  float* sph = f;  f += 4 * ns;
  float* pln = f;  f += 9 * np;
  float* mat = f;  f += 7 * nm;
  float* lgt = f;  f += 6 * nl;
  float* stat = f; f += 8 * np + 12 * nt;
  float* cam = f;  f += 14;
  int* ids = reinterpret_cast<int*>(f);
  stage(sph, sph_g, 4 * ns);
  stage(pln, pln_g, 9 * np);
  stage(mat, mat_g, 7 * nm);
  stage(lgt, lgt_g, 6 * nl);
  stage(stat, stat_g, 8 * np + 12 * nt);
  stage(cam, cam_g, 14);
  stage(ids, ids_g, ns + np + nt + nm);
  __syncthreads();
  s.sph = sph; s.pln = pln; s.mat = mat; s.lgt = lgt;
  s.pstat = stat; s.tri = stat + 8 * np;
  s.mid = ids; s.mtype = ids + ns + np + nt;
  s.ns = ns; s.np = np; s.nt = nt; s.nl = nl;
  s.t_min = t_min; s.bias = bias;

  const int col = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (col >= width || r >= rows) return;
  const float bg[3] = {bg_r, bg_g, bg_b};

  // raygen (full-image projection)
  const float rowf = static_cast<float>(row0 + r);
  const float colf = static_cast<float>(col);
  const float scale = cam[12], aspect = cam[13];
  const float x = (2.0f * (colf + 0.5f) / static_cast<float>(width) - 1.0f) *
                  aspect * scale;
  const float y =
      (1.0f - 2.0f * (rowf + 0.5f) / static_cast<float>(height)) * scale;
  float dw[3];
  for (int k = 0; k < 3; ++k)
    dw[k] = x * cam[3 + 3 * k] + y * cam[4 + 3 * k] - cam[5 + 3 * k];
  const float inv = rsqrtf(dot3(dw, dw));
  float o[3] = {cam[0] + eps, cam[1], cam[2]};
  float d[3] = {dw[0] * inv, dw[1] * inv, dw[2] * inv};

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
    float rad[3], ro[3], rd[3], to[3], td[3], wr = 0.0f, wt = 0.0f;
    eval_node<kGlass>(s, o, d, leaf, bg, win_out, occ_out, rad, ro, rd, wr,
                      to, td, wt);
    if (!leaf) {  // descend into the reflect child
      for (int k = 0; k < 3; ++k) {
        srad[depth][k] = rad[k];
        o[k] = ro[k];
        d[k] = rd[k];
      }
      swr[depth] = wr;
      if constexpr (kGlass) {
        for (int k = 0; k < 3; ++k) {
          sto[depth][k] = to[k];
          stdir[depth][k] = td[k];
        }
        swt[depth] = wt;
        on_refract &= ~(1u << depth);
      }
      ++depth;
      continue;
    }
    // a leaf: fold its radiance up until a refract child is still to visit
    for (int k = 0; k < 3; ++k) c[k] = rad[k];
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
  const int floats = 4 * ns + 9 * np + 7 * nm + 6 * nl + 8 * np + 12 * nt + 14;
  const size_t smem = 4 * static_cast<size_t>(floats + ns + np + nt + nm);
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
