// Fused train kernel — one thread per pixel replays the pixel's Whitted tree
// from the recorded plan (per node: the winner id, −1 = miss, and the
// per-light shadow bitmask), forms the pixel's L2 loss
// Σ_k (clip(rad_k, 0, 1) − target_k)² and its gradient with respect to the
// four live tables (sph [S,4] center|radius, pln [P,9] point|normal|albedo2,
// mat [M,7] albedo|kd|ks|spec_n|ior, lgt [L,6] pos|intensity). A second small
// kernel sums the per-block partials in a fixed order: no float atomics, so
// the loss and gradients are equal from run to run.
//
// Replaces the TPU kernel raytracer_tpu/ops/fused.py::FusedWhitted._kernel
// (train=True; pallas_call in _train_vg), which traces jax.value_and_grad of
// the closed-form replay tree inside its body. CUDA has no value_and_grad:
// the adjoint here is written by hand, expression for expression against the
// forward, which is the forward kernel's own node shading (whitted_common.cuh:
// node_surface, node_shade) under the plan: the winner's t recomputed, a
// recompute that misses demoting the node to a miss; the specular term not
// shadowed; w·bg at max_depth. Ties take the reference's
// gradients: max/min and clip send half to each side when the operands are
// equal, |x| has slope 1 at 0.
//
// Per pixel, two sweeps over the node store (one slot per tree node, indexed
// as the plan: node (depth b, path p) at 2^b − 1 + p with glass, b without):
//   1. top-down in node order: evaluate each live node (a node is live when
//      every edge above it is a mirror/glass reflection or an existing glass
//      refraction of a valid hit — the nodes whose radiance reaches the pixel
//      through a weight of the reference's where-selects), keep its own
//      radiance and child weights, write its children's rays and path
//      weights; then bottom-up, fold each child's subtree radiance into its
//      parent in the forward kernel's order (reflect, then refract).
//   2. bottom-up in reverse node order (children before parents): recompute
//      the node from its stored ray, take its cotangent (path weight × the
//      pixel's dL/drad), fold in the children's subtree radiances (dL/dkr)
//      and incoming-ray adjoints, accumulate the table gradients, and leave
//      the node's own incoming-ray adjoint in its slot for the parent. The
//      eye ray depends on no table, so the root's adjoint is dropped.
// Dead nodes (weight 0 through a structural zero) contribute exactly 0 to the
// loss and the gradients, and are skipped.
//
// What bounds it on this card: neither its bytes nor its arithmetic come
// near the card's rates. A pixel reads 8 bytes per live plan node and 12 of
// target, and writes nothing but its share of a [n_blocks, 1 + G] partial
// (G = the tables' floats); the work is one intersection recompute, the
// shading and the fresnel/ray algebra per live node, forward and backward.
// The node store (12 floats per node: 63 nodes with glass, 32 without) and
// the G gradient accumulators are indexed at run time, so they live in
// local memory (L1/L2-cached): ptxas -v (CUDA 12.8, sm_90a) gives 94
// registers and a 2,448-byte stack frame without glass, 122 and 4,056 bytes
// with glass, no spills. Not tuned: a first kernel that is right.
//
// Build: as fused_whitted.cu (kernels/build.py; --fmad=false).

#include "whitted_common.cuh"

namespace {

constexpr int kTrainBlockX = 32;
constexpr int kTrainBlockY = 4;
constexpr int kTrainThreads = kTrainBlockX * kTrainBlockY;
constexpr int kTrainWarps = kTrainThreads / 32;
constexpr int kMaxGrads = 256;  // TRAIN_MAX_GRADS
constexpr int kReduceThreads = 256;

// d max(x, c)/dx with the reference's tie rule (also max(c, x)).
__device__ __forceinline__ float tie_max(float x, float c) {
  return x > c ? 1.0f : (x == c ? 0.5f : 0.0f);
}

// d clip(x, lo, hi)/dx = d min(max(x, lo), hi)/dx.
__device__ __forceinline__ float tie_clip(float x, float lo, float hi) {
  const float m = fmaxf(x, lo);
  return tie_max(x, lo) * (m < hi ? 1.0f : (m == hi ? 0.5f : 0.0f));
}

// d|x|/dx, slope 1 at 0.
__device__ __forceinline__ float sgn1(float x) { return x >= 0.0f ? 1.0f : -1.0f; }

// Offsets of the four tables in the gradient vector (padded table heights).
struct GradOff {
  int sph, pln, mat, lgt;
};

// Adjoint of sphere_t at a finite t: adds dL/do, dL/dd and the sphere's
// center/radius gradients (gs[0..3]) for dL/dt = tb.
__device__ void sphere_t_bwd(const float* o, const float* d, const float* sp,
                             float t_min, float tb, float* ob, float* db,
                             float* gs) {
  const float L[3] = {o[0] - sp[0], o[1] - sp[1], o[2] - sp[2]};
  const float r = sp[3];
  const float a = dot3(d, d);
  const float b = 2.0f * dot3(d, L);
  const float c0 = dot3(L, L) - r * r;
  const float disc = b * b - 4.0f * a * c0;  // ≥ 0: the hit exists
  const float sq = sqrtf(fmaxf(disc, 1e-12f));
  const float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
  const float t0 = q / a;
  const bool okq = fabsf(q) > 1e-12f;
  const float t1 = okq ? c0 / q : -CUDART_INF_F;
  const float tlo = fminf(t0, t1);
  const float thi = fmaxf(t0, t1);
  const float tlob = tlo > t_min ? tb : 0.0f;
  const float thib = tlo > t_min ? 0.0f : tb;
  float t0b = 0.0f, t1b = 0.0f;
  if (t0 < t1) {
    t0b += tlob; t1b += thib;
  } else if (t1 < t0) {
    t1b += tlob; t0b += thib;
  } else {
    t0b += 0.5f * (tlob + thib); t1b += 0.5f * (tlob + thib);
  }
  float qb = 0.0f, c0b = 0.0f;
  if (okq) {
    c0b += t1b / q;
    qb -= t1b * t1 / q;
  }
  qb += t0b / a;
  float ab = -t0b * t0 / a;
  float bb = -0.5f * qb;
  const float sqb = (b >= 0.0f ? -0.5f : 0.5f) * qb;
  const float discb = sqb * 0.5f / sq * tie_max(disc, 1e-12f);
  bb += 2.0f * b * discb;
  ab -= 4.0f * c0 * discb;
  c0b -= 4.0f * a * discb;
  for (int k = 0; k < 3; ++k) {
    const float Lb = 2.0f * L[k] * c0b + 2.0f * d[k] * bb;
    db[k] += 2.0f * L[k] * bb + 2.0f * d[k] * ab;
    ob[k] += Lb;
    gs[k] -= Lb;
  }
  gs[3] -= 2.0f * r * c0b;
}

// Adjoint of plane_t at a finite t: dL/do, dL/dd, point and normal (gp[0..5]).
__device__ void plane_t_bwd(const float* o, const float* d, const float* pl,
                            float tb, float* ob, float* db, float* gp) {
  const float* n = pl + 3;
  const float denom = d[0] * n[0] + d[1] * n[1] + d[2] * n[2];
  const float num = (pl[0] - o[0]) * n[0] + (pl[1] - o[1]) * n[1] +
                    (pl[2] - o[2]) * n[2];
  const float t = num / denom;
  const float numb = tb / denom;
  const float denomb = -tb * t / denom;
  for (int k = 0; k < 3; ++k) {
    gp[k] += numb * n[k];
    ob[k] -= numb * n[k];
    gp[3 + k] += numb * (pl[k] - o[k]) + denomb * d[k];
    db[k] += denomb * n[k];
  }
}

// Adjoint of tri_t at a finite t (baked geometry): dL/do and dL/dd.
__device__ void tri_t_bwd(const float* o, const float* d, const float* tr,
                          float tb, float* ob, float* db) {
  const float* v0 = tr;
  const float* e1 = tr + 3;
  const float* e2 = tr + 6;
  const float pv[3] = {d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
                       d[0] * e2[1] - d[1] * e2[0]};
  const float det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2];
  const float inv = 1.0f / det;
  const float tv[3] = {o[0] - v0[0], o[1] - v0[1], o[2] - v0[2]};
  const float qv[3] = {tv[1] * e1[2] - tv[2] * e1[1],
                       tv[2] * e1[0] - tv[0] * e1[2],
                       tv[0] * e1[1] - tv[1] * e1[0]};
  const float s = e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2];
  const float sb = tb * inv;
  const float detb = -(tb * s) * inv * inv;
  const float qvb[3] = {sb * e2[0], sb * e2[1], sb * e2[2]};
  const float pvb[3] = {detb * e1[0], detb * e1[1], detb * e1[2]};
  // qv = tv × e1 → d(qv·g)/dtv = e1 × g; pv = d × e2 → d(pv·g)/dd = e2 × g
  ob[0] += e1[1] * qvb[2] - e1[2] * qvb[1];
  ob[1] += e1[2] * qvb[0] - e1[0] * qvb[2];
  ob[2] += e1[0] * qvb[1] - e1[1] * qvb[0];
  db[0] += e2[1] * pvb[2] - e2[2] * pvb[1];
  db[1] += e2[2] * pvb[0] - e2[0] * pvb[2];
  db[2] += e2[0] * pvb[1] - e2[1] * pvb[0];
}

// What a node hands its children in the forward.
struct NodeOut {
  float local[3];           // the node's radiance without its children
  float ro[3], rd[3], wr;   // reflect child: ray and weight
  float to[3], td[3], wt;   // refract child (glass)
  bool live_r, live_t;
};

// What the backward of a node takes from its children.
struct NodeAdj {
  float c[3];          // dL / d(the node's subtree radiance)
  float Rr[3], Rt[3];  // the children's subtree radiances
  float ar[6], at[6];  // the children's incoming-ray adjoints (o, d)
};

// One node of the replay tree: the plan's winner with its t recomputed (a
// recompute that misses demotes the node to a miss), then the shared node
// shading under the recorded shadow bits. Forward (kBwd false): fills `out`.
// Backward: recomputes the same forward, then adds the node's table
// gradients to `g` and writes dL/d(o, d) of its incoming ray to `ain` (zeros
// when the node is not a valid hit).
template <bool kGlass, bool kBwd>
__device__ void train_node(const SceneView& s, const float* o, const float* d,
                           int win, int occ, bool leaf, const float* bg,
                           NodeOut& out, const NodeAdj* adj, float* g,
                           const GradOff& go, float* ain) {
  const int ns = s.ns, np = s.np;
  float t = CUDART_INF_F;
  if (win >= 0) {
    if (win < ns)
      t = sphere_t(o, d, s.sph + 4 * win, s.t_min);
    else if (win < ns + np)
      t = plane_t(o, d, s.pln + 9 * (win - ns), s.t_min);
    else
      t = tri_t(o, d, s.tri + 12 * (win - ns - np), s.t_min);
  }
  out.wr = out.wt = 0.0f;
  out.live_r = out.live_t = false;
  if constexpr (kBwd) {
    for (int k = 0; k < 6; ++k) ain[k] = 0.0f;
  }
  if (!(t < CUDART_INF_F)) {  // a miss, or a recompute that misses
    for (int k = 0; k < 3; ++k) out.local[k] = bg[k];
    return;
  }
  Node n;
  node_surface(s, o, d, win, t, n);
  node_shade<kGlass, false>(s, d, occ, leaf, bg, n);
  for (int k = 0; k < 3; ++k) out.local[k] = n.rad[k];
  if (!leaf && !n.diff) {
    for (int k = 0; k < 3; ++k) {
      out.ro[k] = n.ro[k];
      out.rd[k] = n.rd[k];
    }
    out.wr = n.wr;
    out.live_r = true;
    if (kGlass && n.gls && n.t_ok) {
      for (int k = 0; k < 3; ++k) {
        out.to[k] = n.to[k];
        out.td[k] = n.td[k];
      }
      out.wt = n.wt;
      out.live_t = true;
    }
  }
  if constexpr (!kBwd) return;

  // ---- backward -----------------------------------------------------------
  const float* c = adj->c;
  const float* nrm = n.nrm;
  float pb[3] = {0.0f, 0.0f, 0.0f}, nb[3] = {0.0f, 0.0f, 0.0f};
  float db[3] = {0.0f, 0.0f, 0.0f}, ob[3] = {0.0f, 0.0f, 0.0f};
  float albb[3] = {0.0f, 0.0f, 0.0f};
  float kdb = 0.0f, ksb = 0.0f, snb = 0.0f, iorb = 0.0f, dinb = 0.0f;
  float* gm = g + go.mat + 7 * n.m;
  if (n.diff) {
    float lamtb[3], specb[3];
    for (int k = 0; k < 3; ++k) {
      lamtb[k] = c[k] * n.alb[k] * n.kd;
      albb[k] += c[k] * n.lamt[k] * n.kd;
      kdb += c[k] * n.lamt[k] * n.alb[k];
      specb[k] = c[k] * n.ks;
      ksb += c[k] * n.spec[k];
    }
    for (int li = 0; li < s.nl; ++li) {
      const float* lpos = s.lgt + 6 * li;
      const float* lint = lpos + 3;
      float* gl = g + go.lgt + 6 * li;
      const LightDir l = light_dir(lpos, n.p);
      const float mld = dot3(l.ldir, nrm);
      const float ldn = fmaxf(0.0f, mld);
      const float vis = ((occ >> li) & 1) ? 0.0f : 1.0f;
      float rl[3];
      for (int k = 0; k < 3; ++k) rl[k] = -l.ldir[k] + 2.0f * mld * nrm[k];
      const float base = -dot3(rl, d);
      const float bm = fmaxf(base, 1e-7f);
      const float pw = base > 0.0f ? powf(bm, n.spec_n) : 0.0f;
      float ldnb = 0.0f, pwb = 0.0f;
      for (int k = 0; k < 3; ++k) {
        gl[3 + k] += lamtb[k] * vis * ldn + specb[k] * pw;
        ldnb += lamtb[k] * lint[k];
        pwb += specb[k] * lint[k];
      }
      ldnb *= vis;
      float baseb = 0.0f;
      if (base > 0.0f) {
        snb += pwb * pw * logf(bm);
        baseb = pwb * n.spec_n * powf(bm, n.spec_n - 1.0f) *
                tie_max(base, 1e-7f);
      }
      float ldirb[3];
      float mldb = ldnb * tie_max(mld, 0.0f);
      for (int k = 0; k < 3; ++k) {
        const float rlb = -baseb * d[k];
        db[k] -= baseb * rl[k];
        ldirb[k] = -rlb;
        mldb += 2.0f * rlb * nrm[k];
        nb[k] += 2.0f * mld * rlb;
      }
      for (int k = 0; k < 3; ++k) {
        ldirb[k] += mldb * nrm[k];
        nb[k] += mldb * l.ldir[k];
      }
      float lvecb[3];
      float ilb = 0.0f;
      for (int k = 0; k < 3; ++k) {
        lvecb[k] = ldirb[k] * l.il;
        ilb += ldirb[k] * l.lvec[k];
      }
      const float distb = -ilb * l.il * l.il * tie_max(l.dist, 1e-12f);
      if (l.d2 > 0.0f) {
        const float d2b = distb * 0.5f / l.dist * tie_max(l.d2, 1e-12f);
        for (int k = 0; k < 3; ++k) lvecb[k] += 2.0f * d2b * l.lvec[k];
      }
      for (int k = 0; k < 3; ++k) {
        gl[k] += lvecb[k];
        pb[k] -= lvecb[k];
      }
    }
  } else {
    float krb = 0.0f;
    if (leaf) {
      if (n.mir) krb += c[0] * bg[0] + c[1] * bg[1] + c[2] * bg[2];
    } else {
      // reflect child: weight kr, ray (ro, rd)
      krb += c[0] * adj->Rr[0] + c[1] * adj->Rr[1] + c[2] * adj->Rr[2];
      const float* rob = adj->ar;
      const float* rdb = adj->ar + 3;
      float rdwb[3], rinvb = 0.0f;
      for (int k = 0; k < 3; ++k) {
        pb[k] += rob[k];
        nb[k] += n.rside * s.bias * rob[k];
        rdwb[k] = rdb[k] * n.rinv;
        rinvb += rdb[k] * n.rdw[k];
      }
      const float rrb = rinvb * (-0.5f) * n.rinv / fmaxf(n.rr, 1e-12f) *
                        tie_max(n.rr, 1e-12f);
      for (int k = 0; k < 3; ++k) rdwb[k] += 2.0f * rrb * n.rdw[k];
      for (int k = 0; k < 3; ++k) {
        db[k] += rdwb[k];
        dinb -= 2.0f * rdwb[k] * nrm[k];
        nb[k] -= 2.0f * n.din * rdwb[k];
      }
      if (kGlass && n.t_ok) {
        // refract child: weight 1 − kr, ray (to, td)
        krb -= c[0] * adj->Rt[0] + c[1] * adj->Rt[1] + c[2] * adj->Rt[2];
        const float* tob = adj->at;
        const float* tdb = adj->at + 3;
        float td0b[3], tinvb = 0.0f;
        for (int k = 0; k < 3; ++k) {
          pb[k] += tob[k];
          nb[k] += n.tside * s.bias * tob[k];
          td0b[k] = tdb[k] * n.tinv;
          tinvb += tdb[k] * n.td0[k];
        }
        const float tsq = sqrtf(fmaxf(n.tn2, 1e-12f));
        const float tn2b = -tinvb * n.tinv * n.tinv * 0.5f / tsq *
                           tie_max(n.tn2, 1e-12f);
        for (int k = 0; k < 3; ++k) td0b[k] += 2.0f * tn2b * n.td0[k];
        const float h = n.eta * n.cosa_t - n.sqk;
        float etab = 0.0f, hb = 0.0f;
        for (int k = 0; k < 3; ++k) {
          db[k] += n.eta * td0b[k];
          etab += td0b[k] * d[k];
          hb += td0b[k] * n.n_o[k];
          nb[k] += (n.ent_t ? h : -h) * td0b[k];
        }
        etab += hb * n.cosa_t;
        float cosa_tb = hb * n.eta;
        const float kkb = -hb * 0.5f / n.sqk * tie_max(n.kk, 1e-12f);
        const float sc = 1.0f - n.cosa_t * n.cosa_t;
        etab -= 2.0f * n.eta * kkb * sc;
        cosa_tb += 2.0f * n.cosa_t * kkb * n.eta * n.eta;
        const float etai_tb = etab / n.etat_t;
        const float etat_tb = -etab * n.eta / n.etat_t;
        iorb += n.ent_t ? etat_tb : etai_tb;
        dinb += cosa_tb * sgn1(n.cosi) * tie_clip(n.din, -1.0f, 1.0f);
      }
    }
    if (n.no_tir && krb != 0.0f) {
      const float rsb = krb * n.rs;
      const float rpb = krb * n.rp;
      const float num1b = rsb / n.den1, den1b = -rsb * n.rs / n.den1;
      const float num2b = rpb / n.den2, den2b = -rpb * n.rp / n.den2;
      float etatb = (num1b + den1b) * n.cosa + (den2b - num2b) * n.cost;
      float etaib = (den1b - num1b) * n.cost + (num2b + den2b) * n.cosa;
      const float cosab = (num1b + den1b) * n.etat + (num2b + den2b) * n.etai;
      const float costb = (den1b - num1b) * n.etai + (den2b - num2b) * n.etat;
      const float c2b = costb * 0.5f / n.cost * tie_max(n.c2, 1e-12f);
      const float sintb =
          -2.0f * n.sint * c2b * tie_max(1.0f - n.sint * n.sint, 0.0f);
      const float ratio = n.etai / n.etat;
      const float ratiob = sintb * n.sq2;
      const float sq2b = sintb * ratio;
      etaib += ratiob / n.etat;
      etatb -= ratiob * ratio / n.etat;
      float cosib = cosab * sgn1(n.cosi);
      if (n.s2 > 0.0f) {
        const float s2b = sq2b * 0.5f / n.sq2 * tie_max(n.s2, 1e-12f);
        cosib -= 2.0f * n.cosi * s2b * tie_max(1.0f - n.cosi * n.cosi, 0.0f);
      }
      iorb += n.entering ? etatb : etaib;
      dinb += cosib * tie_clip(n.din, -1.0f, 1.0f);
    }
  }
  for (int k = 0; k < 3; ++k) {
    db[k] += dinb * nrm[k];
    nb[k] += dinb * d[k];
  }
  // winner attributes → the tables
  if (n.pat) {
    float* ga2 = g + go.pln + 9 * (win - ns) + 6;
    for (int k = 0; k < 3; ++k) ga2[k] += albb[k];
  } else {
    for (int k = 0; k < 3; ++k) gm[k] += albb[k];
  }
  gm[3] += kdb;
  gm[4] += ksb;
  gm[5] += snb;
  gm[6] += iorb;
  if (win < ns) {
    float* gs = g + go.sph + 4 * win;
    const float* cc = s.sph + 4 * win;
    float invrb = 0.0f;
    for (int k = 0; k < 3; ++k) {
      pb[k] += nb[k] * n.inv_r;
      gs[k] -= nb[k] * n.inv_r;
      invrb += nb[k] * (n.p[k] - cc[k]);
    }
    gs[3] -= invrb * n.inv_r * n.inv_r;
  } else if (win < ns + np) {
    float* gp = g + go.pln + 9 * (win - ns);
    for (int k = 0; k < 3; ++k) gp[3 + k] += nb[k];
  }
  // p = o + t·d, t recomputed from (o, d) and the winner's table row
  float tb = 0.0f;
  for (int k = 0; k < 3; ++k) {
    ob[k] += pb[k];
    db[k] += t * pb[k];
    tb += pb[k] * d[k];
  }
  if (win < ns)
    sphere_t_bwd(o, d, s.sph + 4 * win, s.t_min, tb, ob, db,
                 g + go.sph + 4 * win);
  else if (win < ns + np)
    plane_t_bwd(o, d, s.pln + 9 * (win - ns), tb, ob, db,
                g + go.pln + 9 * (win - ns));
  else
    tri_t_bwd(o, d, s.tri + 12 * (win - ns - np), tb, ob, db);
  for (int k = 0; k < 3; ++k) {
    ain[k] = ob[k];
    ain[3 + k] = db[k];
  }
}

__device__ __forceinline__ int node_depth(bool glass, int node) {
  return glass ? 31 - __clz(node + 1) : node;
}

// One pixel: replay, loss and gradients. g[0] += loss, g[1 + j] += dL/d
// (table float j).
template <bool kGlass>
__device__ void train_pixel(const SceneView& s, const float* o0,
                            const float* d0, const int* plan, size_t plane_px,
                            size_t px, int max_depth, const float* bg,
                            const float* tgt, float* g, const GradOff& go) {
  constexpr int kNodes = kGlass ? (1 << kGlassLevels) - 1 : kChainLevels;
  const int n_nodes = kGlass ? (1 << (max_depth + 1)) - 1 : max_depth + 1;
  // the node store: incoming ray (then its adjoint), path weight, subtree
  // radiance, child weights
  float ray[kNodes][6], pw[kNodes], R[kNodes][3], wr[kNodes], wt[kNodes];
  uint64_t live = 1;
  for (int k = 0; k < 3; ++k) {
    ray[0][k] = o0[k];
    ray[0][3 + k] = d0[k];
  }
  pw[0] = 1.0f;

  // sweep 1: the forward, top-down
  for (int node = 0; node < n_nodes; ++node) {
    if (!((live >> node) & 1)) continue;
    const int depth = node_depth(kGlass, node);
    const int off = kGlass ? (1 << depth) - 1 : depth;
    const int win = plan[node * plane_px + px];
    const int occ = plan[(n_nodes + node) * plane_px + px];
    const bool leaf = depth == max_depth;
    NodeOut out;
    train_node<kGlass, false>(s, ray[node], ray[node] + 3, win, occ, leaf,
                              bg, out, nullptr, nullptr, go, nullptr);
    for (int k = 0; k < 3; ++k) R[node][k] = out.local[k];
    wr[node] = out.wr;
    wt[node] = out.wt;
    if (out.live_r) {
      const int ch = kGlass ? node + off + 1 : node + 1;
      live |= uint64_t(1) << ch;
      for (int k = 0; k < 3; ++k) {
        ray[ch][k] = out.ro[k];
        ray[ch][3 + k] = out.rd[k];
      }
      pw[ch] = pw[node] * out.wr;
    }
    if (kGlass && out.live_t) {
      const int ch = node + off + 1 + (1 << depth);
      live |= uint64_t(1) << ch;
      for (int k = 0; k < 3; ++k) {
        ray[ch][k] = out.to[k];
        ray[ch][3 + k] = out.td[k];
      }
      pw[ch] = pw[node] * out.wt;
    }
  }
  // subtree radiances, bottom-up, in the forward kernel's order
  for (int node = n_nodes - 1; node >= 0; --node) {
    if (!((live >> node) & 1)) continue;
    const int depth = node_depth(kGlass, node);
    if (depth == max_depth) continue;
    const int off = kGlass ? (1 << depth) - 1 : depth;
    const int chr = kGlass ? node + off + 1 : node + 1;
    if ((live >> chr) & 1)
      for (int k = 0; k < 3; ++k) R[node][k] += wr[node] * R[chr][k];
    if (kGlass) {
      const int cht = node + off + 1 + (1 << depth);
      if ((live >> cht) & 1)
        for (int k = 0; k < 3; ++k) R[node][k] += wt[node] * R[cht][k];
    }
  }

  // the pixel's loss and dL/drad
  float croot[3];
  float loss = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float dk = fminf(fmaxf(R[0][k], 0.0f), 1.0f) - tgt[k];
    loss += dk * dk;
    croot[k] = 2.0f * dk * tie_clip(R[0][k], 0.0f, 1.0f);
  }
  g[0] += loss;
  if (croot[0] == 0.0f && croot[1] == 0.0f && croot[2] == 0.0f) return;

  // sweep 2: the adjoint, children before parents
  float* gt = g + 1;
  for (int node = n_nodes - 1; node >= 0; --node) {
    if (!((live >> node) & 1)) continue;
    const int depth = node_depth(kGlass, node);
    const int off = kGlass ? (1 << depth) - 1 : depth;
    const bool leaf = depth == max_depth;
    NodeAdj adj;
    for (int k = 0; k < 3; ++k) {
      adj.c[k] = pw[node] * croot[k];
      adj.Rr[k] = adj.Rt[k] = 0.0f;
    }
    for (int k = 0; k < 6; ++k) adj.ar[k] = adj.at[k] = 0.0f;
    if (!leaf) {
      const int chr = kGlass ? node + off + 1 : node + 1;
      if ((live >> chr) & 1) {
        for (int k = 0; k < 3; ++k) adj.Rr[k] = R[chr][k];
        for (int k = 0; k < 6; ++k) adj.ar[k] = ray[chr][k];
      }
      if (kGlass) {
        const int cht = node + off + 1 + (1 << depth);
        if ((live >> cht) & 1) {
          for (int k = 0; k < 3; ++k) adj.Rt[k] = R[cht][k];
          for (int k = 0; k < 6; ++k) adj.at[k] = ray[cht][k];
        }
      }
    }
    const int win = plan[node * plane_px + px];
    const int occ = plan[(n_nodes + node) * plane_px + px];
    float od[6], ain[6];
    for (int k = 0; k < 6; ++k) od[k] = ray[node][k];
    NodeOut out;
    train_node<kGlass, true>(s, od, od + 3, win, occ, leaf, bg, out, &adj, gt,
                             go, ain);
    for (int k = 0; k < 6; ++k) ray[node][k] = ain[k];
  }
}

// ---- kernels ---------------------------------------------------------------

template <bool kGlass>
__global__ void __launch_bounds__(kTrainThreads)
fused_train_kernel(const float* __restrict__ sph_g,
                   const float* __restrict__ pln_g,
                   const float* __restrict__ mat_g,
                   const float* __restrict__ lgt_g,
                   const float* __restrict__ stat_g,
                   const int* __restrict__ ids_g,
                   const float* __restrict__ cam_g, GradOff go, int n_grads,
                   int ns, int np, int nt, int nm, int nl, int max_depth,
                   float t_min, float bias, float bg_r, float bg_g, float bg_b,
                   int width, int height, int row0, int rows, float eps,
                   const int* __restrict__ plan,
                   const float* __restrict__ target,
                   float* __restrict__ partial) {
  extern __shared__ float smem[];
  __shared__ float red[kTrainWarps][kMaxGrads + 1];
  const float* cam;
  const SceneView s =
      stage_scene(smem, sph_g, pln_g, mat_g, lgt_g, stat_g, ids_g, cam_g, ns,
                  np, nt, nm, nl, t_min, bias, &cam);
  __syncthreads();

  const int n_out = n_grads + 1;
  float g[kMaxGrads + 1];
  for (int j = 0; j < n_out; ++j) g[j] = 0.0f;
  const int col = blockIdx.x * kTrainBlockX + threadIdx.x;
  const int r = blockIdx.y * kTrainBlockY + threadIdx.y;
  if (col < width && r < rows) {  // threads past the band add nothing
    const float bg[3] = {bg_r, bg_g, bg_b};
    float o[3], d[3];
    eye_ray(cam, row0 + r, col, width, height, eps, o, d);
    const size_t px = static_cast<size_t>(r) * width + col;
    train_pixel<kGlass>(s, o, d, plan, static_cast<size_t>(rows) * width, px,
                        max_depth, bg, target + 3 * px, g, go);
  }
  // the block's sums, in a fixed order: a shuffle tree per warp, then the
  // warps in turn
  const int tid = threadIdx.y * kTrainBlockX + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int j = 0; j < n_out; ++j) {
    float v = g[j];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][j] = v;
  }
  __syncthreads();
  const size_t block = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  for (int j = tid; j < n_out; j += kTrainThreads) {
    float v = red[0][j];
    for (int w = 1; w < kTrainWarps; ++w) v += red[w][j];
    partial[block * n_out + j] = v;
  }
}

// out[j] = Σ_b partial[b, j]: one block per column, each thread a strided
// run of blocks in order, then a fixed tree.
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials(const float* __restrict__ partial, int n_blocks, int n_out,
                float* __restrict__ out) {
  __shared__ float buf[kReduceThreads];
  const int j = blockIdx.x;
  float v = 0.0f;
  for (int b = threadIdx.x; b < n_blocks; b += kReduceThreads)
    v += partial[static_cast<size_t>(b) * n_out + j];
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int half = kReduceThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = buf[0];
}

}  // namespace

// Number of blocks (rows of `partial`) a launch over a band uses.
extern "C" int rt_fused_train_blocks(int width, int rows) {
  return ((width + kTrainBlockX - 1) / kTrainBlockX) *
         ((rows + kTrainBlockY - 1) / kTrainBlockY);
}

// Plain C entry for ctypes. Launches the train kernel and the reduction on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 on
// success). `hs, hp, hm, hl`: the tables' heights (padded); `plan`:
// [2·n_nodes, rows, width] i32; `target`: [rows, width, 3] f32; `partial`:
// [rt_fused_train_blocks(width, rows), 1 + G] f32 scratch; `out`: [1 + G]
// f32, the loss then the four tables' gradients in order.
extern "C" int rt_fused_train(
    const void* sph, const void* pln, const void* mat, const void* lgt,
    const void* stat, const void* ids, const void* cam, int hs, int hp, int hm,
    int hl, int ns, int np, int nt, int nm, int nl, int max_depth, int glass,
    float t_min, float bias, float bg_r, float bg_g, float bg_b, int width,
    int height, int row0, int rows, float eps, const void* plan,
    const void* target, void* partial, void* out, void* stream) {
  if (rows <= 0 || width <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (max_depth < 0 || max_depth >= (glass ? kGlassLevels : kChainLevels))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nl > 32) return static_cast<int>(cudaErrorInvalidValue);
  GradOff go;
  go.sph = 0;
  go.pln = 4 * hs;
  go.mat = go.pln + 9 * hp;
  go.lgt = go.mat + 7 * hm;
  const int n_grads = go.lgt + 6 * hl;
  if (n_grads > kMaxGrads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scene_smem_bytes(ns, np, nt, nm, nl);
  const size_t red = sizeof(float) * kTrainWarps * (kMaxGrads + 1);
  if (smem + red > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTrainBlockX, kTrainBlockY);
  const dim3 grid((width + kTrainBlockX - 1) / kTrainBlockX,
                  (rows + kTrainBlockY - 1) / kTrainBlockY);
  const int n_blocks = static_cast<int>(grid.x * grid.y);
  auto st = static_cast<cudaStream_t>(stream);
  auto kern = glass ? fused_train_kernel<true> : fused_train_kernel<false>;
  kern<<<grid, block, smem, st>>>(
      static_cast<const float*>(sph), static_cast<const float*>(pln),
      static_cast<const float*>(mat), static_cast<const float*>(lgt),
      static_cast<const float*>(stat), static_cast<const int*>(ids),
      static_cast<const float*>(cam), go, n_grads, ns, np, nt, nm, nl,
      max_depth, t_min, bias, bg_r, bg_g, bg_b, width, height, row0, rows, eps,
      static_cast<const int*>(plan), static_cast<const float*>(target),
      static_cast<float*>(partial));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_partials<<<n_grads + 1, kReduceThreads, 0, st>>>(
      static_cast<const float*>(partial), n_blocks, n_grads + 1,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
