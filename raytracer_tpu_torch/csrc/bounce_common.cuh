// Device helpers of a wavefront bounce's shading, shared by K6's forward
// launches (bounce_shade.cu) and K7's adjoint (bounce_adjoint.cu): the
// launch arguments (the wavefront and the scene's tables, read at each
// call), and trace.surface_at, shade_diffuse's view of a light,
// geometry.fresnel / refract / spawn_origin as the torch bounce computes
// them, operation for operation (see bounce_shade.cu).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kKindNone = 0;  // core/types.py's KIND_* codes
constexpr int kKindSphere = 1;
constexpr int kKindPlane = 2;
constexpr int kKindTriangle = 3;
constexpr int kDiffuse = 0;  // and its material codes
constexpr int kMirror = 1;
constexpr int kGlass = 2;
constexpr int kPlanLights = 32;  // bits of the occlusion bitmask

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 operator*(float s, V3 a) {
  return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 operator/(V3 a, float s) {
  return {a.x / s, a.y / s, a.z / s};
}

// safemath.dot: (x·x + y·y) + z·z, one rounding an operation
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 where(bool c, V3 a, V3 b) { return c ? a : b; }

// torch.maximum / torch.minimum: a NaN operand is the result
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// safemath.normalize: n2 > 1e-12 decides unless `valid` is given
__device__ __forceinline__ V3 normalize_if(V3 v, bool valid) {
  const float n2 = dot(v, v);
  return v * (valid ? 1.0f / sqrtf(n2) : 1.0f);
}
__device__ __forceinline__ V3 normalize(V3 v) {
  return normalize_if(v, dot(v, v) > 1e-12f);
}

// safemath.safe_sqrt(x, valid)
__device__ __forceinline__ float safe_sqrt(float x, bool valid) {
  return valid ? sqrtf(tmax(x, 1e-12f)) : 0.0f;
}

__device__ __forceinline__ V3 ld3(const float* p, size_t i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
__device__ __forceinline__ void st3(float* p, size_t i, V3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

// Every input and output of both launches. Tables are the scene's,
// read at each call; null table pointers belong to empty groups.
struct ShadeArgs {
  // the wavefront: o, d, thr [n,3] f32, alive [n] bool, the winner's
  // kind, idx [n] i32
  const float *o, *d, *thr;
  const uint8_t* alive;
  const int *kind, *idx;
  // spheres: center [ns,3], radius [ns], mat_id [ns]
  const float *sph_c, *sph_r;
  const int* sph_mat;
  // planes: point, normal, tangent, bitangent [np,3], mat_id, checker
  // [np] i32, checker_scale [np], albedo2 [np,3]
  const float *pl_p, *pl_n, *pl_tan, *pl_bit;
  const int *pl_mat, *pl_chk;
  const float *pl_scale, *pl_alb2;
  // meshes: verts [V,3], tris [nt,3] i32, normals [V,3] (null: flat),
  // mat_id [nt], uvs [V,2] (null: none), checker [nt] i32,
  // checker_scale [nt], albedo2 [nt,3]
  const float* verts;
  const int* tris;
  const float* normals;
  const int* me_mat;
  const float* uvs;
  const int* me_chk;
  const float *me_scale, *me_alb2;
  // materials: mtype [M] i32, albedo [M,3], kd, ks, spec_n, ior [M]
  const int* m_type;
  const float *m_alb, *m_kd, *m_ks, *m_spec, *m_ior;
  // lights: pos, intensity [nl,3]
  const float *l_pos, *l_int;
  // surface's outputs: the shadow origin [n,3], each light's direction
  // [nl,n,3], distance [nl,n] and search mask [nl,n] bool; is_diff [n]
  float *sorig, *ldir, *dist;
  uint8_t *oactive, *is_diff;
  // shade's inputs and outputs: the shadow bits [nl,n] bool; the radiance
  // [n,3] to add into, or (null) the terms [2 or 3,n,3]; the child
  // buffers [k·n,3] and [k·n] (null on the last bounce); the plan planes
  // [n] i32 (null unless recorded)
  const uint8_t* shadowed;
  float *radiance, *terms;
  float *c_o, *c_d, *c_thr;
  uint8_t* c_alive;
  int *win, *occ;
  int n, ns, np, nt, nl, is_last, glass;
  float t_min, bias;
  V3 bg;
};

// What trace.surface_at gives a lane, and where its values came from:
// the recomputed t (0 on a demoted lane), whether the recompute missed,
// the material row, and the albedo's table (kAlbMaterial, kAlbPlane: the
// plane's albedo2, kAlbMesh: the triangle's).
struct Surf {
  bool valid, lost;
  float t;
  V3 p, n, albedo;
  int mat, alb_src, mtype;
  float kd, ks, spec_n, ior;
};
constexpr int kAlbMaterial = 0, kAlbPlane = 1, kAlbMesh = 2;

// geometry.sphere_t
__device__ __forceinline__ float sphere_t(V3 o, V3 d, V3 c, float r,
                                          float t_min) {
  const V3 L = o - c;
  const float a = dot(d, d);
  const float b = 2.0f * dot(d, L);
  const float c0 = dot(L, L) - r * r;
  const float disc = b * b - 4.0f * a * c0;
  const bool has_root = disc >= 0.0f && r > 0.0f;
  const float sq = safe_sqrt(disc, has_root);
  const float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
  const float t0 = fabsf(a) > 1e-12f ? q / a : 0.0f;
  const float t1 = fabsf(q) > 1e-12f ? c0 / q : -CUDART_INF_F;
  const float tlo = tmin(t0, t1);
  const float thi = tmax(t0, t1);
  const float t = tlo > t_min ? tlo : (thi > t_min ? thi : CUDART_INF_F);
  return has_root ? t : CUDART_INF_F;
}

// geometry.plane_t
__device__ __forceinline__ float plane_t(V3 o, V3 d, V3 p0, V3 pn,
                                         float t_min) {
  const float denom = dot(pn, d);
  const bool valid = fabsf(denom) > 1e-8f;
  const float t = valid ? dot(p0 - o, pn) / denom : -CUDART_INF_F;
  return (valid && t > t_min) ? t : CUDART_INF_F;
}

// geometry.triangle_tuv → t (+inf on a miss), u, v
__device__ __forceinline__ float triangle_tuv(V3 o, V3 d, V3 v0, V3 e1,
                                              V3 e2, float t_min, float& u,
                                              float& v) {
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  const bool det_ok = fabsf(det) > 1e-8f;
  const float inv = det_ok ? 1.0f / det : 0.0f;
  const V3 tvec = o - v0;
  u = dot(tvec, pvec) * inv;
  const V3 qvec = cross(tvec, e1);
  v = dot(d, qvec) * inv;
  const float t = dot(e2, qvec) * inv;
  const bool hit = det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                   u + v <= 1.0f && t > t_min;
  return hit ? t : CUDART_INF_F;
}

// trace._checker
__device__ __forceinline__ bool checker(float u, float v, float scale) {
  const float fu = u * scale - floorf(u * scale);
  const float fv = v * scale - floorf(v * scale);
  return (fu > 0.5f) != (fv > 0.5f);
}

// trace.surface_at on lane r: only the winner's group is computed, the
// value torch.where keeps from that group's branch. A recompute that
// misses demotes the lane (lost) and takes t = 0.
__device__ Surf surface_of(const ShadeArgs& a, int r, V3 o, V3 d) {
  const int kind = a.kind[r];
  const int i = a.idx[r];
  bool lost = false;
  float t = 0.0f;
  V3 nrm = V3{};
  int mat = 0;
  bool chk = false;
  V3 calb = V3{};
  int src = kAlbMaterial;
  if (kind == kKindSphere && a.ns) {
    const V3 c = ld3(a.sph_c, i);
    const float rad = __ldg(a.sph_r + i);
    const float tk = sphere_t(o, d, c, rad, a.t_min);
    lost = !isfinite(tk);
    t = lost ? 0.0f : tk;
    const V3 p = o + t * d;
    nrm = fabsf(rad) > 1e-12f ? (p - c) / rad : V3{};
    mat = __ldg(a.sph_mat + i);
  } else if (kind == kKindPlane && a.np) {
    const V3 p0 = ld3(a.pl_p, i);
    const V3 pn = ld3(a.pl_n, i);
    const float tk = plane_t(o, d, p0, pn, a.t_min);
    lost = !isfinite(tk);
    t = lost ? 0.0f : tk;
    const V3 q = (o + t * d) - p0;
    const bool pattern = checker(dot(q, ld3(a.pl_tan, i)),
                                 dot(q, ld3(a.pl_bit, i)),
                                 __ldg(a.pl_scale + i));
    nrm = pn;
    mat = __ldg(a.pl_mat + i);
    chk = __ldg(a.pl_chk + i) > 0;
    calb = pattern ? ld3(a.pl_alb2, i) : ld3(a.m_alb, mat);
    src = pattern ? kAlbPlane : kAlbMaterial;
  } else if (kind == kKindTriangle && a.nt) {
    const int t0 = __ldg(a.tris + 3 * i), t1 = __ldg(a.tris + 3 * i + 1),
              t2 = __ldg(a.tris + 3 * i + 2);
    const V3 v0 = ld3(a.verts, t0);
    const V3 e1 = ld3(a.verts, t1) - v0;
    const V3 e2 = ld3(a.verts, t2) - v0;
    float u, v;
    const float tk = triangle_tuv(o, d, v0, e1, e2, a.t_min, u, v);
    lost = !isfinite(tk);
    t = lost ? 0.0f : tk;
    const float w = 1.0f - u - v;
    if (a.normals)
      nrm = normalize(w * ld3(a.normals, t0) + u * ld3(a.normals, t1) +
                      v * ld3(a.normals, t2));
    else
      nrm = normalize(cross(e1, e2));
    mat = __ldg(a.me_mat + i);
    if (a.uvs) {
      const float* st = a.uvs;
      const float s = w * __ldg(st + 2 * t0) + u * __ldg(st + 2 * t1) +
                      v * __ldg(st + 2 * t2);
      const float tt = w * __ldg(st + 2 * t0 + 1) +
                       u * __ldg(st + 2 * t1 + 1) + v * __ldg(st + 2 * t2 + 1);
      const bool pattern = checker(s, tt, __ldg(a.me_scale + i));
      chk = __ldg(a.me_chk + i) > 0;
      calb = pattern ? ld3(a.me_alb2, i) : ld3(a.m_alb, mat);
      src = pattern ? kAlbMesh : kAlbMaterial;
    }
  }
  Surf s;
  s.valid = kind != kKindNone && !lost;
  s.lost = lost;
  s.t = t;
  s.p = o + t * d;
  s.n = nrm;
  s.albedo = chk ? calb : ld3(a.m_alb, mat);
  s.mat = mat;
  s.alb_src = chk ? src : kAlbMaterial;
  s.mtype = __ldg(a.m_type + mat);
  s.kd = __ldg(a.m_kd + mat);
  s.ks = __ldg(a.m_ks + mat);
  s.spec_n = __ldg(a.m_spec + mat);
  s.ior = __ldg(a.m_ior + mat);
  return s;
}

// shade_diffuse's view of light li from point p with normal n
struct ToLight {
  V3 dir;
  float dist, ldn;
};

__device__ __forceinline__ ToLight to_light(const ShadeArgs& a, int li, V3 p,
                                            V3 n) {
  const V3 lvec = ld3(a.l_pos, li) - p;
  const float d2 = dot(lvec, lvec);
  ToLight l;
  l.dist = safe_sqrt(d2, d2 > 0.0f);
  l.dir = lvec / tmax(l.dist, 1e-12f);
  l.ldn = tmax(dot(l.dir, n), 0.0f);
  return l;
}

// geometry.spawn_origin
__device__ __forceinline__ V3 spawn_origin(V3 p, V3 n, V3 out_dir,
                                           float bias) {
  const float side = 1.0f - 2.0f * (dot(out_dir, n) < 0.0f ? 1.0f : 0.0f);
  return p + (side * bias) * n;
}

// geometry.fresnel
__device__ __forceinline__ float fresnel(V3 i, V3 n, float ior) {
  const float cosi = tmin(tmax(dot(i, n), -1.0f), 1.0f);
  const bool entering = cosi <= 0.0f;
  const float etai = entering ? 1.0f : ior;
  const float etat = entering ? ior : 1.0f;
  const float x = 1.0f - cosi * cosi;
  const float sint = etai / etat * safe_sqrt(tmax(x, 0.0f), x > 0.0f);
  const bool no_tir = sint < 1.0f;
  const float cost = safe_sqrt(tmax(1.0f - sint * sint, 0.0f), no_tir);
  const float cosi_a = cosi >= 0.0f ? cosi : -cosi;
  const float rs = no_tir ? (etat * cosi_a - etai * cost) /
                                (etat * cosi_a + etai * cost)
                          : 0.0f;
  const float rp = no_tir ? (etai * cosi_a - etat * cost) /
                                (etai * cosi_a + etat * cost)
                          : 0.0f;
  return no_tir ? 0.5f * (rs * rs + rp * rp) : 1.0f;
}

// geometry.refract, then normalize(tdir, valid=t_ok) → the unit direction
__device__ __forceinline__ V3 refract(V3 i, V3 n, float ior, bool& ok) {
  const float cosi = tmin(tmax(dot(i, n), -1.0f), 1.0f);
  const bool entering = cosi < 0.0f;
  const float cosi_a = cosi >= 0.0f ? cosi : -cosi;
  const float etai = entering ? 1.0f : ior;
  const float etat = entering ? ior : 1.0f;
  const V3 n_o = entering ? n : -n;
  const float eta = etai / etat;
  const float k = 1.0f - eta * eta * (1.0f - cosi_a * cosi_a);
  ok = k >= 0.0f;
  const V3 tdir = eta * i + (eta * cosi_a - safe_sqrt(k, ok)) * n_o;
  return normalize_if(where(ok, tdir, V3{}), ok);
}


// The wavefront and the scene's tables from the C entries' pointer list,
// in ShadeArgs' field order (o … l_int); advances `p` past them.
inline void read_wave_tables(ShadeArgs& a, const void* const*& p) {
  auto f = [&p]() { return static_cast<const float*>(*p++); };
  auto i = [&p]() { return static_cast<const int*>(*p++); };
  auto b = [&p]() { return static_cast<const uint8_t*>(*p++); };
  a.o = f(); a.d = f(); a.thr = f(); a.alive = b(); a.kind = i();
  a.idx = i();
  a.sph_c = f(); a.sph_r = f(); a.sph_mat = i();
  a.pl_p = f(); a.pl_n = f(); a.pl_tan = f(); a.pl_bit = f();
  a.pl_mat = i(); a.pl_chk = i(); a.pl_scale = f(); a.pl_alb2 = f();
  a.verts = f(); a.tris = i(); a.normals = f(); a.me_mat = i();
  a.uvs = f(); a.me_chk = i(); a.me_scale = f(); a.me_alb2 = f();
  a.m_type = i(); a.m_alb = f(); a.m_kd = f(); a.m_ks = f();
  a.m_spec = f(); a.m_ior = f();
  a.l_pos = f(); a.l_int = f();
}

}  // namespace
