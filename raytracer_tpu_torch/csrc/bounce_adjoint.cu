// K7, the adjoint of a recorded bounce's shading: the backward of the
// autograd Function whose forward is K6's shade launch
// (ops/bounce_shade.shade_recorded). Given the cotangents of the bounce's
// outputs (the per-lane miss, diffuse and, on the last bounce, leaf terms;
// the child's o, d and thr) it writes the cotangents of the bounce's o, d
// and thr, and per-block partial sums of the gradients of K2's table set:
// sphere center and radius, plane point, normal and albedo2, material
// albedo, kd, ks, spec_n and ior, light pos and intensity. A second launch
// (the partial-row sum K2 uses, rt_fused_train_reduce) adds the blocks'
// rows in a fixed order: no float atomics, so a step's gradients are equal
// from run to run.
//
// It replaces no TPU kernel: on the TPU the shading's backward is XLA's.
// On the card the torch bounce under autograd is ~500 plain torch ops a
// bounce, recorded twice (the forward and the checkpoint's recompute),
// then their backward nodes.
//
// What it computes is torch.autograd's backward of the torch bounce
// (renderer.bounce_step: ops/trace.surface_at, ops/shade.shade_diffuse,
// geometry.fresnel, renderer._spawn) on a glass-free scene, expression for
// expression, in its gradient conventions: torch.maximum / minimum send
// half of the cotangent to each operand at a tie (clip at a bound 0.5,
// the sphere's t0 == t1), where(c >= 0, x, −x) has slope 1 at 0, the
// where selects pass the cotangent to the branch kept, the safemath
// guards' dead branches (safe_sqrt, safe_div, safe_pow, normalize at zero
// length) take none, and pow's base takes none where the exponent is 0. A
// lane whose recompute missed (demoted by surface_at, t = 0) takes no
// cotangent through t. Triangle hits recompute t, u and v from the
// winner's row: their cotangents reach o and d only (the mesh tables are
// not in the set; the dispatch rule keeps scenes whose mesh requires grad
// on the torch bounce). Each lane's work is only its winner's group: the
// torch bounce's other groups take zero cotangents there. A lane whose
// incoming cotangents are all zero adds nothing and writes zeros (the
// safemath guards keep every intermediate finite, so torch's products
// with those zeros are zero too).
//
// Layout: a thread takes lanes k, k + T, … (T threads in the launch, at
// most kAdjBlocks blocks), and keeps its gradient sums in a column of
// shared memory (float j of thread t at acc[j · kAdjThreads + t]), as K2
// does; a launch covers one window of the table floats (whole rows), and
// the wrapper launches once a window when the set outgrows one.
//
// Bound: bytes. Per lane the ray (o, d, thr: 36 B), the winner (8 B),
// alive and the shadow bits (1 + L B), the cotangents (24–36 B of terms,
// 36 B of children) and o, d, thr's cotangents (36 B): ~150 B a lane.
//
// Build: as bounce_shade.cu (kernels/build.py; --fmad=false).

#include "bounce_common.cuh"

namespace {

constexpr int kAdjThreads = 128;
constexpr int kAdjWarps = kAdjThreads / 32;
// blocks of one launch at most: whole waves on the H100's 132 SMs
constexpr int kAdjBlocks = 16 * 132;
// shared memory a block may take on Hopper (227 KB, dynamic only), and
// what it may take without opting in
constexpr int kAdjSmemBytes = 232448;
constexpr int kAdjDefaultSmem = 48 * 1024;
constexpr int kMaxRow = 9;  // the widest table row (a plane's)
// rows of the gradient vector: sphere center | radius, plane point |
// normal | albedo2, material albedo | kd | ks | spec_n | ior, light pos |
// intensity
constexpr int kSphRow = 4, kPlnRow = 9, kMatRow = 7, kLgtRow = 6;

// d max(x, c)/dx under torch.maximum's tie rule (also max(c, x))
__device__ __forceinline__ float tie_max(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

// d clip(x, lo, hi)/dx = d min(max(x, lo), hi)/dx
__device__ __forceinline__ float tie_clip(float x, float lo, float hi) {
  const float m = fmaxf(x, lo);
  return tie_max(x, lo) * (m < hi ? 1.0f : (m == hi ? 0.5f : 0.0f));
}

// A thread's gradient sums for the window [lo, lo + n) of table floats:
// float j of the window at g[(1 + j − lo) · kAdjThreads] (g[0] is the
// reduction's unused loss column), and past them a row-wide sink for rows
// outside the window.
struct Grads {
  float* g;
  int lo, n;
  __device__ __forceinline__ float* row(int base) const {
    const unsigned k = static_cast<unsigned>(base - lo);
    return g + (1 + (k < static_cast<unsigned>(n) ? k : n)) * kAdjThreads;
  }
};
__device__ __forceinline__ bool nonzero(V3 v) {
  return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f;
}

__device__ __forceinline__ void add(float* row, int k, float v) {
  row[k * kAdjThreads] += v;
}
__device__ __forceinline__ void add3(float* row, int k, V3 v) {
  add(row, k, v.x);
  add(row, k + 1, v.y);
  add(row, k + 2, v.z);
}

struct AdjArgs {
  ShadeArgs a;  // the wavefront, the tables, the shadow bits, the counts
  // the outputs' cotangents, null where autograd has none: the terms [2
  // or 3, n, 3], the child's o, d, thr [n, 3]
  const float *g_terms, *g_co, *g_cd, *g_ct;
  // o, d, thr's cotangents [n, 3] (null: not wanted), the blocks' partial
  // rows [blocks, 1 + gn]
  float *go, *gd, *gthr, *partial;
  int g0, gn;
  int off_pln, off_mat, off_lgt;  // the spheres' rows start at 0
};

// safemath.normalize(v)'s backward (valid: the lane's n2 > 1e-12): v ·
// (1 / sqrt(n2)), the reciprocal and the sqrt each by its own rule
__device__ __forceinline__ V3 normalize_bwd(V3 v, V3 g, bool valid) {
  if (!valid) return g;
  const float s = sqrtf(dot(v, v));
  const float inv = 1.0f / s;
  const float g_n2 = -dot(g, v) * (inv * inv) / (2.0f * s);
  return g * inv + (2.0f * g_n2) * v;
}

// geometry.sphere_t's backward at a finite t
__device__ void sphere_t_bwd(V3 o, V3 d, V3 c, float r, float t_min,
                             float g_t, V3& g_o, V3& g_d, V3& g_c,
                             float& g_r) {
  const V3 L = o - c;
  const float a = dot(d, d);
  const float b = 2.0f * dot(d, L);
  const float c0 = dot(L, L) - r * r;
  const float disc = b * b - 4.0f * a * c0;  // has_root holds
  const float sq = sqrtf(tmax(disc, 1e-12f));
  const float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
  const bool ok_a = fabsf(a) > 1e-12f, ok_q = fabsf(q) > 1e-12f;
  const float t0 = ok_a ? q / a : 0.0f;
  const float t1 = ok_q ? c0 / q : -CUDART_INF_F;
  const bool lo = tmin(t0, t1) > t_min;
  const float g_lo = lo ? g_t : 0.0f, g_hi = lo ? 0.0f : g_t;
  float g_t0, g_t1;  // minimum's and maximum's: half each at a tie
  if (t0 < t1) {
    g_t0 = g_lo;
    g_t1 = g_hi;
  } else if (t1 < t0) {
    g_t0 = g_hi;
    g_t1 = g_lo;
  } else {
    g_t0 = g_t1 = 0.5f * g_lo + 0.5f * g_hi;
  }
  float g_q = 0.0f, g_a = 0.0f, g_c0 = 0.0f;
  if (ok_a) {
    g_q += g_t0 / a;
    g_a -= g_t0 * q / (a * a);
  }
  if (ok_q) {
    g_c0 += g_t1 / q;
    g_q -= g_t1 * c0 / (q * q);
  }
  float g_b = -0.5f * g_q;
  const float g_sq = (b >= 0.0f ? -0.5f : 0.5f) * g_q;
  const float g_disc = g_sq / (2.0f * sq) * tie_max(disc, 1e-12f);
  g_b += 2.0f * b * g_disc;
  g_a -= 4.0f * c0 * g_disc;
  g_c0 -= 4.0f * a * g_disc;
  const V3 g_L = (2.0f * g_c0) * L + (2.0f * g_b) * d;
  g_r -= 2.0f * r * g_c0;
  g_d = g_d + (2.0f * g_b) * L + (2.0f * g_a) * d;
  g_o = g_o + g_L;
  g_c = g_c - g_L;
}

// geometry.plane_t's backward at a finite t
__device__ void plane_t_bwd(V3 o, V3 d, V3 p0, V3 pn, float g_t, V3& g_o,
                            V3& g_d, V3& g_p0, V3& g_pn) {
  const float denom = dot(pn, d);
  const V3 w = p0 - o;
  const float num = dot(w, pn);
  const float g_num = g_t / denom;
  const float g_den = -g_t * num / (denom * denom);
  g_p0 = g_p0 + g_num * pn;
  g_o = g_o - g_num * pn;
  g_pn = g_pn + g_num * w + g_den * d;
  g_d = g_d + g_den * pn;
}

// geometry.triangle_tuv's backward for the cotangents of t, u and v
__device__ void triangle_tuv_bwd(V3 o, V3 d, V3 v0, V3 e1, V3 e2, float g_t,
                                 float g_u, float g_v, V3& g_o, V3& g_d) {
  const V3 pvec = cross(d, e2);
  const float det = dot(e1, pvec);
  const bool det_ok = fabsf(det) > 1e-8f;
  const float inv = det_ok ? 1.0f / det : 0.0f;
  const V3 tvec = o - v0;
  const V3 qvec = cross(tvec, e1);
  const float g_inv =
      g_u * dot(tvec, pvec) + g_v * dot(d, qvec) + g_t * dot(e2, qvec);
  const float g_uu = g_u * inv, g_vv = g_v * inv, g_tt = g_t * inv;
  V3 g_tvec = g_uu * pvec;
  V3 g_pvec = g_uu * tvec;
  const V3 g_qvec = g_vv * d + g_tt * e2;
  g_d = g_d + g_vv * qvec;
  g_tvec = g_tvec + cross(e1, g_qvec);  // qvec = tvec × e1
  if (det_ok) g_pvec = g_pvec + (-g_inv / (det * det)) * e1;
  g_d = g_d + cross(e2, g_pvec);  // pvec = d × e2
  g_o = g_o + g_tvec;
}

// geometry.fresnel's backward: adds the cotangents of i, n and ior for
// kr's cotangent g_kr
__device__ void fresnel_bwd(V3 i, V3 n, float ior, float g_kr, V3& g_i,
                            V3& g_n, float& g_ior) {
  const float x = dot(i, n);
  const float cosi = tmin(tmax(x, -1.0f), 1.0f);
  const bool entering = cosi <= 0.0f;
  const float etai = entering ? 1.0f : ior;
  const float etat = entering ? ior : 1.0f;
  const float x1 = 1.0f - cosi * cosi;
  const float s2 = tmax(x1, 0.0f);
  const float sq2 = safe_sqrt(s2, x1 > 0.0f);
  const float ratio = etai / etat;
  const float sint = ratio * sq2;
  if (!(sint < 1.0f)) return;  // total internal reflection: kr = 1
  const float y = 1.0f - sint * sint;
  const float c2 = tmax(y, 0.0f);
  const float cost = sqrtf(tmax(c2, 1e-12f));
  const float cosa = cosi >= 0.0f ? cosi : -cosi;
  const float num1 = etat * cosa - etai * cost;
  const float den1 = etat * cosa + etai * cost;
  const float num2 = etai * cosa - etat * cost;
  const float den2 = etai * cosa + etat * cost;
  // kr = 0.5 · (rs² + rp²)
  const float g_rs = g_kr * (num1 / den1), g_rp = g_kr * (num2 / den2);
  const float g_num1 = g_rs / den1, g_den1 = -g_rs * num1 / (den1 * den1);
  const float g_num2 = g_rp / den2, g_den2 = -g_rp * num2 / (den2 * den2);
  float g_etat = (g_num1 + g_den1) * cosa + (g_den2 - g_num2) * cost;
  float g_etai = (g_den1 - g_num1) * cost + (g_num2 + g_den2) * cosa;
  const float g_cosa = (g_num1 + g_den1) * etat + (g_num2 + g_den2) * etai;
  const float g_cost = (g_den1 - g_num1) * etai + (g_den2 - g_num2) * etat;
  const float g_c2 = g_cost / (2.0f * cost) * tie_max(c2, 1e-12f);
  const float g_sint = -2.0f * sint * (g_c2 * tie_max(y, 0.0f));
  g_etai += g_sint * sq2 / etat;
  g_etat -= g_sint * sq2 * etai / (etat * etat);
  float g_cosi = cosi >= 0.0f ? g_cosa : -g_cosa;
  if (x1 > 0.0f) {
    const float g_s2 = g_sint * ratio / (2.0f * sq2) * tie_max(s2, 1e-12f);
    g_cosi -= 2.0f * cosi * (g_s2 * tie_max(x1, 0.0f));
  }
  g_ior += entering ? g_etat : g_etai;
  const float g_x = g_cosi * tie_clip(x, -1.0f, 1.0f);
  g_i = g_i + g_x * n;
  g_n = g_n + g_x * i;
}

// What the shading's backward hands the surface's: the cotangents of
// surface_at's outputs, and those of o and d so far.
struct SurfGrad {
  V3 p, n, albedo;
  float kd, ks, spec_n, ior;
  V3 o, d;
};

// shade_diffuse's backward on a diffuse lane (the Phong sums under the
// shadow bits) for the local term's cotangent g_loc: adds the lights'
// rows and the cotangents of d, p, n, the albedo, kd, ks and spec_n.
__device__ void phong_bwd(const AdjArgs& A, int r, V3 d, const Surf& s,
                          V3 g_loc, V3 light_amt, V3 spec, SurfGrad& g,
                          const Grads& acc) {
  const ShadeArgs& a = A.a;
  // local = (light_amt · albedo) · kd + spec · ks
  const V3 la_alb = light_amt * s.albedo;
  g.kd += dot(g_loc, la_alb);
  const V3 g_la_alb = g_loc * s.kd;
  const V3 g_la = g_la_alb * s.albedo;
  g.albedo = g.albedo + g_la_alb * light_amt;
  const V3 g_spec = g_loc * s.ks;
  g.ks += dot(g_loc, spec);
  for (int li = 0; li < a.nl; ++li) {
    float* gl = acc.row(A.off_lgt + kLgtRow * li);
    const V3 lint = ld3(a.l_int, li);
    const float vis =
        a.shadowed[static_cast<size_t>(li) * a.n + r] ? 0.0f : 1.0f;
    const V3 lvec = ld3(a.l_pos, li) - s.p;
    const float d2 = dot(lvec, lvec);
    const float dist = safe_sqrt(d2, d2 > 0.0f);
    const float den = tmax(dist, 1e-12f);
    const V3 ldir = lvec / den;
    const float mld = dot(ldir, s.n);
    const float ldn = tmax(mld, 0.0f);
    const V3 nl = -ldir;
    const float cn = dot(nl, s.n);
    const V3 rv = nl - (2.0f * cn) * s.n;  // reflect(−ldir, n)
    const float base = -dot(rv, d);
    const float bm = tmax(base, 1e-7f);
    const float pw = base > 0.0f ? powf(bm, s.spec_n) : 0.0f;
    // light_amt += (vis · ldn) · lint; spec += pw · lint
    add3(gl, 3, g_la * (vis * ldn) + g_spec * pw);
    const float g_ldn = vis * dot(g_la, lint);
    const float g_pw = dot(g_spec, lint);
    float g_base = 0.0f;
    if (base > 0.0f) {  // safe_pow: pow(max(base, 1e-7), spec_n)
      const float g_bm =
          s.spec_n == 0.0f ? 0.0f
                           : g_pw * s.spec_n * powf(bm, s.spec_n - 1.0f);
      g.spec_n += g_pw * (pw * logf(bm));
      g_base = g_bm * tie_max(base, 1e-7f);
    }
    const V3 g_rv = -g_base * d;
    g.d = g.d - g_base * rv;
    V3 g_nl = g_rv;
    const float g_cn = -2.0f * dot(g_rv, s.n);
    g.n = g.n - (2.0f * cn) * g_rv;
    g_nl = g_nl + g_cn * s.n;
    g.n = g.n + g_cn * nl;
    V3 g_ldir = -g_nl;
    const float g_mld = g_ldn * tie_max(mld, 0.0f);
    g_ldir = g_ldir + g_mld * s.n;
    g.n = g.n + g_mld * ldir;
    // ldir = lvec / max(dist, 1e-12); dist = safe_sqrt(|lvec|²)
    V3 g_lvec = g_ldir / den;
    const float g_dist = -dot(g_ldir, lvec) / (den * den) *
                         tie_max(dist, 1e-12f);
    if (d2 > 0.0f) {
      const float g_d2 = g_dist / (2.0f * dist) * tie_max(d2, 1e-12f);
      g_lvec = g_lvec + (2.0f * g_d2) * lvec;
    }
    add3(gl, 0, g_lvec);
    g.p = g.p - g_lvec;
  }
}

// trace.surface_at's backward: the winner's table rows, and the
// cotangents of o and d
__device__ void surface_bwd(const AdjArgs& A, int r, V3 o, V3 d,
                            const Surf& s, SurfGrad& g, const Grads& acc) {
  const ShadeArgs& a = A.a;
  const int kind = a.kind[r], i = a.idx[r];
  if (kind == kKindNone) {  // p = o; nothing else reads a table
    g.o = g.o + g.p;
    return;
  }
  float* gm = acc.row(A.off_mat + kMatRow * s.mat);
  if (s.alb_src == kAlbMaterial)
    add3(gm, 0, g.albedo);
  else if (s.alb_src == kAlbPlane)
    add3(acc.row(A.off_pln + kPlnRow * i), 6, g.albedo);
  add(gm, 3, g.kd);
  add(gm, 4, g.ks);
  add(gm, 5, g.spec_n);
  add(gm, 6, g.ior);
  // p = o + t · d
  g.o = g.o + g.p;
  g.d = g.d + s.t * g.p;
  float g_t = dot(g.p, d);
  if (kind == kKindSphere) {
    const V3 c = ld3(a.sph_c, i);
    const float rad = __ldg(a.sph_r + i);
    V3 g_c = V3{};
    float g_r = 0.0f;
    if (fabsf(rad) > 1e-12f) {  // n = (o + t·d − c) / r
      const V3 g_q = g.n / rad;
      g_r -= dot(g.n, s.p - c) / (rad * rad);
      g_c = g_c - g_q;
      g.o = g.o + g_q;
      g.d = g.d + s.t * g_q;
      g_t += dot(g_q, d);
    }
    if (!s.lost) sphere_t_bwd(o, d, c, rad, a.t_min, g_t, g.o, g.d, g_c, g_r);
    float* gs = acc.row(kSphRow * i);
    add3(gs, 0, g_c);
    add(gs, 3, g_r);
  } else if (kind == kKindPlane) {
    V3 g_p0 = V3{}, g_pn = g.n;
    if (!s.lost)
      plane_t_bwd(o, d, ld3(a.pl_p, i), ld3(a.pl_n, i), g_t, g.o, g.d, g_p0,
                  g_pn);
    float* gp = acc.row(A.off_pln + kPlnRow * i);
    add3(gp, 0, g_p0);
    add3(gp, 3, g_pn);
  } else if (kind == kKindTriangle) {
    const int t0 = __ldg(a.tris + 3 * i), t1 = __ldg(a.tris + 3 * i + 1),
              t2 = __ldg(a.tris + 3 * i + 2);
    const V3 v0 = ld3(a.verts, t0);
    const V3 e1 = ld3(a.verts, t1) - v0;
    const V3 e2 = ld3(a.verts, t2) - v0;
    float g_u = 0.0f, g_v = 0.0f;
    if (a.normals) {  // n = normalize(w·n0 + u·n1 + v·n2), w = 1 − u − v
      float u, v;
      triangle_tuv(o, d, v0, e1, e2, a.t_min, u, v);
      const float w = 1.0f - u - v;
      const V3 n0 = ld3(a.normals, t0), n1 = ld3(a.normals, t1),
               n2 = ld3(a.normals, t2);
      const V3 sum = w * n0 + u * n1 + v * n2;
      const V3 g_sum = normalize_bwd(sum, g.n, dot(sum, sum) > 1e-12f);
      const float g_w = dot(g_sum, n0);
      g_u = dot(g_sum, n1) - g_w;
      g_v = dot(g_sum, n2) - g_w;
    }
    triangle_tuv_bwd(o, d, v0, e1, e2, s.lost ? 0.0f : g_t, g_u, g_v, g.o,
                     g.d);
  }
}

// One lane: the bounce's forward recomputed as K6's shade launch computes
// it, then its backward.
__device__ void lane_adjoint(const AdjArgs& A, int r, const Grads& acc) {
  const ShadeArgs& a = A.a;
  const size_t n = a.n;
  const V3 zero = V3{};
  const V3 g_miss = A.g_terms ? ld3(A.g_terms, r) : zero;
  const V3 g_diff = A.g_terms ? ld3(A.g_terms, n + r) : zero;
  const V3 g_leaf = A.g_terms && a.is_last ? ld3(A.g_terms, 2 * n + r)
                                           : zero;
  const V3 g_co = A.g_co ? ld3(A.g_co, r) : zero;
  const V3 g_cd = A.g_cd ? ld3(A.g_cd, r) : zero;
  const V3 g_ct = A.g_ct ? ld3(A.g_ct, r) : zero;
  if (!(nonzero(g_miss) || nonzero(g_diff) || nonzero(g_leaf) ||
        nonzero(g_co) || nonzero(g_cd) || nonzero(g_ct))) {
    // all zero: so is every cotangent the lane would write or add
    if (A.go) st3(A.go, r, zero);
    if (A.gd) st3(A.gd, r, zero);
    if (A.gthr) st3(A.gthr, r, zero);
    return;
  }
  const V3 o = ld3(a.o, r), d = ld3(a.d, r), thr = ld3(a.thr, r);
  const bool alive = a.alive[r];
  const Surf s = surface_of(a, r, o, d);
  const bool valid = s.valid && alive;
  SurfGrad g = {};
  V3 g_thr = zero;
  if (alive && !s.valid) g_thr = g_miss * a.bg;  // where(miss, thr·bg, 0)

  if (valid && s.mtype == kDiffuse) {  // where(is_diff, thr·local, 0)
    V3 light_amt = zero, spec = zero;
    for (int li = 0; li < a.nl; ++li) {
      const ToLight l = to_light(a, li, s.p, s.n);
      const bool sh = a.shadowed[static_cast<size_t>(li) * a.n + r];
      const V3 lint = ld3(a.l_int, li);
      light_amt = light_amt + ((sh ? 0.0f : 1.0f) * l.ldn) * lint;
      const V3 nl = -l.dir;
      const V3 rv = nl - (2.0f * dot(nl, s.n)) * s.n;
      const float base = -dot(rv, d);
      const float pw =
          base > 0.0f ? powf(tmax(base, 1e-7f), s.spec_n) : 0.0f;
      spec = spec + pw * lint;
    }
    g_thr = g_thr + g_diff * (light_amt * s.albedo * s.kd + spec * s.ks);
    phong_bwd(A, r, d, s, g_diff * thr, light_amt, spec, g, acc);
  }

  const bool is_mirror = valid && s.mtype == kMirror;
  const bool is_glass = valid && s.mtype == kGlass;
  float g_kr = 0.0f;
  if (a.is_last) {  // (thr · w) · bg, w = where(mirror, kr, glass)
    const V3 g_w3 = g_leaf * a.bg;
    if (is_mirror) {
      g_thr = g_thr + g_w3 * fresnel(d, s.n, s.ior);
      g_kr = dot(g_w3, thr);
    } else if (is_glass) {
      g_thr = g_thr + g_w3;
    }
  } else {
    // where(spec, thr · kr, 0)
    if (is_mirror || is_glass) {
      g_thr = g_thr + g_ct * fresnel(d, s.n, s.ior);
      g_kr = dot(g_ct, thr);
    }
    // the reflection: o' = p + (side · bias) · n, d' = normalize(d −
    // (2 d·n) · n)
    const float dn = dot(d, s.n);
    const V3 rv = d - (2.0f * dn) * s.n;
    const bool rv_ok = dot(rv, rv) > 1e-12f;
    const V3 rdir = normalize_if(rv, rv_ok);
    const float side = 1.0f - 2.0f * (dot(rdir, s.n) < 0.0f ? 1.0f : 0.0f);
    g.p = g.p + g_co;
    g.n = g.n + (side * a.bias) * g_co;
    const V3 g_rv = normalize_bwd(rv, g_cd, rv_ok);
    g.d = g.d + g_rv;
    const float g_dn = -2.0f * dot(g_rv, s.n);
    g.n = g.n - (2.0f * dn) * g_rv;
    g.d = g.d + g_dn * s.n;
    g.n = g.n + g_dn * d;
  }
  if (g_kr != 0.0f) fresnel_bwd(d, s.n, s.ior, g_kr, g.d, g.n, g.ior);
  surface_bwd(A, r, o, d, s, g, acc);
  if (A.go) st3(A.go, r, g.o);
  if (A.gd) st3(A.gd, r, g.d);
  if (A.gthr) st3(A.gthr, r, g_thr);
}

__global__ void __launch_bounds__(kAdjThreads)
bounce_adjoint_kernel(const AdjArgs A) {
  extern __shared__ float acc[];
  const int tid = threadIdx.x;
  float* col = acc + tid;
  const int n_out = A.gn + 1;
  for (int j = 0; j < n_out + kMaxRow; ++j) col[j * kAdjThreads] = 0.0f;
  const Grads g{col, A.g0, A.gn};
  // a fixed assignment: thread k of the launch takes lanes k, k + T, …
  const int T = gridDim.x * kAdjThreads;
  for (int r = blockIdx.x * kAdjThreads + tid; r < A.a.n; r += T)
    lane_adjoint(A, r, g);
  // the block's sums, in a fixed order: per float a shuffle tree over
  // each warp's lanes into its lane 0's slot, then the warps in turn
  const int lane = tid & 31;
  for (int j = 0; j < n_out; ++j) {
    float v = col[j * kAdjThreads];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) col[j * kAdjThreads] = v;
  }
  __syncthreads();
  for (int j = tid; j < n_out; j += kAdjThreads) {
    float v = acc[j * kAdjThreads];
    for (int w = 1; w < kAdjWarps; ++w) v += acc[j * kAdjThreads + 32 * w];
    A.partial[static_cast<size_t>(blockIdx.x) * n_out + j] = v;
  }
}

}  // namespace

// Rows of `partial` a launch over `n` lanes writes: a block a kAdjThreads
// lanes, at most kAdjBlocks.
extern "C" int rt_bounce_adjoint_blocks(int n) {
  const long long blocks =
      (static_cast<long long>(n) + kAdjThreads - 1) / kAdjThreads;
  return static_cast<int>(blocks < kAdjBlocks ? (blocks > 0 ? blocks : 1)
                                              : kAdjBlocks);
}

// Plain C entry for ctypes: one launch of K7 on `stream` for the window
// [g0, g0 + gn) of the gradient vector (whole table rows; the spheres',
// planes', materials' and lights' rows in turn, 4, 9, 7 and 6 floats).
// `ptrs` lists ShadeArgs' wavefront and tables (o … l_int, as
// rt_bounce_shade), then shadowed, the terms' cotangents, the child's o,
// d and thr cotangents, o, d and thr's cotangents out, and partial
// [rt_bounce_adjoint_blocks(n), 1 + gn]; null cotangents in are zeros,
// null ones out are not written. `ints`: n, ns, np, nt, nl, is_last, nm,
// g0, gn; `floats`: t_min, bias and the background's rgb. Does not
// synchronise; returns cudaGetLastError() (0 on success).
extern "C" int rt_bounce_adjoint(const void* const* ptrs, const int* ints,
                                 const float* floats, void* stream) {
  AdjArgs A = {};
  ShadeArgs& a = A.a;
  const void* const* p = ptrs;
  read_wave_tables(a, p);
  auto f = [&p]() { return static_cast<const float*>(*p++); };
  auto wf = [&p]() { return static_cast<float*>(const_cast<void*>(*p++)); };
  a.shadowed = static_cast<const uint8_t*>(*p++);
  A.g_terms = f(); A.g_co = f(); A.g_cd = f(); A.g_ct = f();
  A.go = wf(); A.gd = wf(); A.gthr = wf(); A.partial = wf();
  a.n = ints[0]; a.ns = ints[1]; a.np = ints[2]; a.nt = ints[3];
  a.nl = ints[4]; a.is_last = ints[5];
  const int nm = ints[6];
  A.g0 = ints[7]; A.gn = ints[8];
  a.t_min = floats[0]; a.bias = floats[1];
  a.bg = {floats[2], floats[3], floats[4]};
  A.off_pln = kSphRow * a.ns;
  A.off_mat = A.off_pln + kPlnRow * a.np;
  A.off_lgt = A.off_mat + kMatRow * nm;
  const int n_grads = A.off_lgt + kLgtRow * a.nl;
  auto row_start = [&](int j) {  // j starts a table row (or ends the last)
    if (j <= A.off_pln) return j % kSphRow == 0;
    if (j <= A.off_mat) return (j - A.off_pln) % kPlnRow == 0;
    if (j <= A.off_lgt) return (j - A.off_mat) % kMatRow == 0;
    return (j - A.off_lgt) % kLgtRow == 0;
  };
  if (a.n <= 0 || A.g0 < 0 || A.gn < 1 ||
      A.g0 + A.gn > n_grads || !row_start(A.g0) || !row_start(A.g0 + A.gn))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * kAdjThreads * (A.gn + 1 + kMaxRow);
  if (smem > kAdjSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kAdjDefaultSmem) {  // past 48 KB a block must opt in
    const cudaError_t err = cudaFuncSetAttribute(
        bounce_adjoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  bounce_adjoint_kernel<<<rt_bounce_adjoint_blocks(a.n), kAdjThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(A);
  return static_cast<int>(cudaGetLastError());
}
