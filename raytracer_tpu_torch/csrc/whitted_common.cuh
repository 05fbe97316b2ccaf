// Device helpers shared by the fused Whitted forward (fused_whitted.cu) and
// the fused train kernel (fused_train.cu): the packed scene staged in shared
// memory, the ray–primitive intersection distances, and the shading of one
// tree node once its winner is known, which both kernels compute from the
// same code (built without multiply-add contraction, see kernels/build.py):
// the forward after its winner search and shadow sweep, the train kernel
// under the recorded plan.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr float kDetEps = 1e-8f;
constexpr int kReflection = 1;
constexpr int kReflectionAndRefraction = 2;
constexpr int kGlassLevels = 6;    // MAX_GLASS_DEPTH + 1
constexpr int kChainLevels = 32;   // KERNEL_MAX_LEVELS (no glass)
constexpr int kSmemBytes = 48 * 1024;

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

// Shared-memory bytes of the staged scene (floats, then the int ids).
__host__ __device__ inline size_t scene_smem_bytes(int ns, int np, int nt,
                                                   int nm, int nl) {
  const int floats = 4 * ns + 9 * np + 7 * nm + 6 * nl + 8 * np + 12 * nt + 14;
  return 4 * static_cast<size_t>(floats + ns + np + nt + nm);
}

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

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < n; i += blockDim.x * blockDim.y) dst[i] = src[i];
}

// Copy the scene into the block's shared memory (every thread takes part;
// the caller synchronises) → the view over it and the camera
// (pos | c2w | scale, aspect).
__device__ inline SceneView stage_scene(
    float* smem, const float* sph_g, const float* pln_g, const float* mat_g,
    const float* lgt_g, const float* stat_g, const int* ids_g,
    const float* cam_g, int ns, int np, int nt, int nm, int nl, float t_min,
    float bias, const float** cam_out) {
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
  s.sph = sph; s.pln = pln; s.mat = mat; s.lgt = lgt;
  s.pstat = stat; s.tri = stat + 8 * np;
  s.mid = ids; s.mtype = ids + ns + np + nt;
  s.ns = ns; s.np = np; s.nt = nt; s.nl = nl;
  s.t_min = t_min; s.bias = bias;
  *cam_out = cam;
  return s;
}

// The primary ray of pixel (row, col) of the full-image projection.
__device__ __forceinline__ void eye_ray(const float* cam, int row, int col,
                                        int width, int height, float eps,
                                        float* o, float* d) {
  const float rowf = static_cast<float>(row);
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
  o[0] = cam[0] + eps; o[1] = cam[1]; o[2] = cam[2];
  for (int k = 0; k < 3; ++k) d[k] = dw[k] * inv;
}

// The direction from surface point p to a light, and the distance.
struct LightDir {
  float lvec[3], d2, dist, il, ldir[3];
};

__device__ __forceinline__ LightDir light_dir(const float* lpos,
                                              const float* p) {
  LightDir l;
  for (int k = 0; k < 3; ++k) l.lvec[k] = lpos[k] - p[k];
  l.d2 = dot3(l.lvec, l.lvec);
  const float dist = sqrtf(fmaxf(l.d2, 1e-12f));
  l.dist = l.d2 > 0.0f ? dist : 0.0f;
  l.il = 1.0f / fmaxf(l.dist, 1e-12f);
  for (int k = 0; k < 3; ++k) l.ldir[k] = l.lvec[k] * l.il;
  return l;
}

// One node of the Whitted tree once its winner is known: the surface, its
// Phong shading, fresnel and the child rays, with the intermediates the
// train kernel's adjoint reads. A miss (win < 0) has a zero normal and
// albedo, spec_n = ior = 1, and radiance bg.
struct Node {
  bool valid, mir, gls, diff, pat;
  int m;  // material id
  float p[3], nrm[3], alb[3], inv_r, kd, ks, spec_n, ior, din;
  float lamt[3], spec[3];  // Phong sums (diffuse hits)
  float rad[3];            // the node's radiance without its children
  // fresnel
  bool entering, no_tir;
  float cosi, etai, etat, s2, sq2, sint, c2, cost, cosa, den1, den2, rs, rp,
      kr;
  // the reflect child, weight wr
  float rdw[3], rr, rinv, rd[3], rside, ro[3], wr;
  // the refract child (glass), weight wt
  bool ent_t, t_ok;
  float cosa_t, etai_t, etat_t, n_o[3], eta, kk, sqk, td0[3], tn2, tinv,
      td[3], tside, to[3], wt;
};

// The winner's surface at distance t along (o, d): hit point, normal, albedo
// (a checker plane's albedo2 where its pattern is set) and material.
__device__ __forceinline__ void node_surface(const SceneView& s,
                                             const float* o, const float* d,
                                             int win, float t, Node& n) {
  n.valid = win >= 0;
  const float tt = n.valid ? t : 0.0f;
  for (int k = 0; k < 3; ++k) {
    n.p[k] = o[k] + tt * d[k];
    n.nrm[k] = 0.0f;
    n.alb[k] = 0.0f;
  }
  n.m = 0;
  n.inv_r = 0.0f;
  n.kd = n.ks = 0.0f;
  n.spec_n = n.ior = 1.0f;
  n.mir = n.gls = n.pat = false;
  if (n.valid) {
    n.m = s.mid[win];
    const float* mt = s.mat + 7 * n.m;
    n.alb[0] = mt[0]; n.alb[1] = mt[1]; n.alb[2] = mt[2];
    if (win < s.ns) {
      const float* c = s.sph + 4 * win;
      n.inv_r = 1.0f / c[3];
      for (int k = 0; k < 3; ++k) n.nrm[k] = (n.p[k] - c[k]) * n.inv_r;
    } else if (win < s.ns + s.np) {
      const int j = win - s.ns;
      const float* pl = s.pln + 9 * j;
      const float* st = s.pstat + 8 * j;
      n.nrm[0] = pl[3]; n.nrm[1] = pl[4]; n.nrm[2] = pl[5];
      if (st[7] != 0.0f) {
        const float rel[3] = {n.p[0] - pl[0], n.p[1] - pl[1], n.p[2] - pl[2]};
        const float u = dot3(rel, st) * st[6];
        const float v = dot3(rel, st + 3) * st[6];
        n.pat = (u - floorf(u) > 0.5f) != (v - floorf(v) > 0.5f);
        if (n.pat) { n.alb[0] = pl[6]; n.alb[1] = pl[7]; n.alb[2] = pl[8]; }
      }
    } else {
      const float* tr = s.tri + 12 * (win - s.ns - s.np);
      n.nrm[0] = tr[9]; n.nrm[1] = tr[10]; n.nrm[2] = tr[11];
    }
    n.kd = mt[3]; n.ks = mt[4]; n.spec_n = mt[5]; n.ior = mt[6];
    n.mir = s.mtype[n.m] == kReflection;
    n.gls = s.mtype[n.m] == kReflectionAndRefraction;
  }
  n.diff = n.valid && !n.mir && !n.gls;
  n.din = dot3(d, n.nrm);
}

// Phong of a diffuse hit under the shadow bits `occ` (bit l: light l
// occluded; the specular term is not shadowed), fresnel kr (1 on total
// internal reflection), the w·bg of a mirror or glass leaf, and below
// max_depth the child rays: with kAll on every lane (the forward kernel
// records the plan of every node, reached or not), else only on the hits
// whose children are reached (mirror and glass; refraction where it
// exists).
template <bool kGlass, bool kAll>
__device__ __forceinline__ void node_shade(const SceneView& s, const float* d,
                                           int occ, bool leaf,
                                           const float* bg, Node& n) {
  for (int k = 0; k < 3; ++k) {
    n.rad[k] = n.valid ? 0.0f : bg[k];
    n.lamt[k] = n.spec[k] = 0.0f;
  }
  if (n.diff) {
    for (int li = 0; li < s.nl; ++li) {
      const float* lpos = s.lgt + 6 * li;
      const float* lint = lpos + 3;
      const LightDir l = light_dir(lpos, n.p);
      const float ldn = fmaxf(0.0f, dot3(l.ldir, n.nrm));
      const float vis = ((occ >> li) & 1) ? 0.0f : 1.0f;
      const float mld = dot3(l.ldir, n.nrm);
      float rl[3];
      for (int k = 0; k < 3; ++k) rl[k] = -l.ldir[k] + 2.0f * mld * n.nrm[k];
      const float base = -dot3(rl, d);
      const float pw =
          base > 0.0f ? powf(fmaxf(base, 1e-7f), n.spec_n) : 0.0f;
      for (int k = 0; k < 3; ++k) {
        n.lamt[k] += vis * ldn * lint[k];
        n.spec[k] += pw * lint[k];
      }
    }
    for (int k = 0; k < 3; ++k)
      n.rad[k] += n.lamt[k] * n.alb[k] * n.kd + n.spec[k] * n.ks;
  }

  n.cosi = fminf(fmaxf(n.din, -1.0f), 1.0f);
  n.entering = n.cosi <= 0.0f;
  n.etai = n.entering ? 1.0f : n.ior;
  n.etat = n.entering ? n.ior : 1.0f;
  n.s2 = fmaxf(1.0f - n.cosi * n.cosi, 0.0f);
  n.sq2 = n.s2 > 0.0f ? sqrtf(fmaxf(n.s2, 1e-12f)) : 0.0f;
  n.sint = n.etai / n.etat * n.sq2;
  n.no_tir = n.sint < 1.0f;
  n.c2 = fmaxf(1.0f - n.sint * n.sint, 0.0f);
  n.cost = n.no_tir ? sqrtf(fmaxf(n.c2, 1e-12f)) : 0.0f;
  n.cosa = fabsf(n.cosi);
  n.den1 = n.etat * n.cosa + n.etai * n.cost;
  n.den2 = n.etai * n.cosa + n.etat * n.cost;
  n.rs = n.no_tir ? (n.etat * n.cosa - n.etai * n.cost) / n.den1 : 0.0f;
  n.rp = n.no_tir ? (n.etai * n.cosa - n.etat * n.cost) / n.den2 : 0.0f;
  n.kr = n.no_tir ? 0.5f * (n.rs * n.rs + n.rp * n.rp) : 1.0f;

  n.wr = n.wt = 0.0f;
  n.t_ok = false;
  if (leaf) {  // children would exceed max_depth: each returns bg
    const float w =
        (n.valid && n.mir) ? n.kr : ((n.valid && n.gls) ? 1.0f : 0.0f);
    for (int k = 0; k < 3; ++k) n.rad[k] += w * bg[k];
    return;
  }
  if (kAll || n.mir || n.gls) {
    for (int k = 0; k < 3; ++k) n.rdw[k] = d[k] - 2.0f * n.din * n.nrm[k];
    n.rr = dot3(n.rdw, n.rdw);
    n.rinv = rsqrtf(fmaxf(n.rr, 1e-12f));
    for (int k = 0; k < 3; ++k) n.rd[k] = n.rdw[k] * n.rinv;
    n.rside = dot3(n.rd, n.nrm) < 0.0f ? -1.0f : 1.0f;
    for (int k = 0; k < 3; ++k) n.ro[k] = n.p[k] + n.rside * s.bias * n.nrm[k];
    n.wr = (n.valid && (n.mir || n.gls)) ? n.kr : 0.0f;
  }
  if (kGlass && (kAll || n.gls)) {
    n.ent_t = n.din < 0.0f;
    n.cosa_t = fabsf(fminf(fmaxf(n.din, -1.0f), 1.0f));
    n.etai_t = n.ent_t ? 1.0f : n.ior;
    n.etat_t = n.ent_t ? n.ior : 1.0f;
    for (int k = 0; k < 3; ++k) n.n_o[k] = n.ent_t ? n.nrm[k] : -n.nrm[k];
    n.eta = n.etai_t / n.etat_t;
    n.kk = 1.0f - n.eta * n.eta * (1.0f - n.cosa_t * n.cosa_t);
    n.t_ok = n.kk >= 0.0f;
    n.sqk = n.t_ok ? sqrtf(fmaxf(n.kk, 1e-12f)) : 0.0f;
    for (int k = 0; k < 3; ++k)
      n.td0[k] = n.t_ok ? n.eta * d[k] + (n.eta * n.cosa_t - n.sqk) * n.n_o[k]
                        : 0.0f;
    n.tn2 = dot3(n.td0, n.td0);
    n.tinv = n.t_ok ? 1.0f / sqrtf(fmaxf(n.tn2, 1e-12f)) : 1.0f;
    for (int k = 0; k < 3; ++k) n.td[k] = n.td0[k] * n.tinv;
    n.tside = dot3(n.td, n.nrm) < 0.0f ? -1.0f : 1.0f;
    for (int k = 0; k < 3; ++k) n.to[k] = n.p[k] + n.tside * s.bias * n.nrm[k];
    n.wt = (n.valid && n.gls && n.t_ok) ? 1.0f - n.kr : 0.0f;
  }
}

}  // namespace
