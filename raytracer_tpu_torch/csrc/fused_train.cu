// Fused train kernel — a thread replays its pixels' Whitted trees (several
// pixels per thread in a large frame) from the recorded plan (per node: the
// winner id, −1 = miss, and the per-light shadow bitmask), forms each
// pixel's L2 loss
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
// One launch accumulates one window of table floats (an offset and a count,
// whole table rows). The window is the whole table whenever the block's
// gradient sums fit the 227 KB of shared memory beside the scene (about 440
// table floats): one launch. Past that the wrapper launches once per window,
// each replaying the whole tree, so no table size is refused; the loss comes
// from the first window's launch.
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
// loss and the gradients, and are skipped; their plan entries are never read
// (the forward's live-plan mode leaves them unwritten). Without glass a
// node's children form a chain, so the live nodes are a prefix: a count.
//
// What bounds it on this card: neither its bytes nor its arithmetic come
// near the card's rates. A pixel reads 8 bytes per live plan node and 12 of
// target; the work is one intersection recompute, the shading and the
// fresnel/ray algebra per live node, forward and backward. Done per pixel,
// the work around the adjoint (zeroing a window of gradient accumulators in
// local memory, a shuffle tree per window float, a partial row per 128
// pixels) took half of config2's time and a fifth of config3's on the H100
// (PERF.md §6). The design:
//   - the gradient sums live in shared memory, a column per thread (float j
//     of thread t at acc[j · kTrainThreads + t]: a warp's 32 lanes hit 32
//     banks whichever floats they add to). Each thread adds its own pixels
//     in its own column, in pixel order: no atomics, and the sums' order is
//     fixed by the data;
//   - a launch has at most kTrainBlocks blocks (whole waves on 132 SMs) and
//     each thread replays the pixels k, k + T, … (T threads in the launch),
//     so the zeroing, the block's sums (a shuffle tree per float per warp,
//     then the warps in turn) and the partial rows are paid per block, not
//     per pixel: at 1080p 3,168 partial rows, not 16,200;
//   - the reduction reads partial rows with a warp on 32 consecutive floats,
//     32 rows of a column in parallel and 8 rows' loads in flight, then a
//     fixed tree.
// The glass kernel wants ~148 registers with the pixel loop (127 with one
// pixel per thread); kTrainMinBlocks caps it at 128 (60 bytes of spills) to
// keep 4 blocks per SM. On config3 it stays a few percent slower than one
// pixel per thread with local-memory sums; neither bank conflicts nor the
// shared memory's share of L1 explained it (PERF.md §6).
// The node store (12 floats per node: 63 nodes with glass, kChainLevels
// without; deeper chain nodes in a scratch buffer the wrapper allocates,
// [nodes, 12, pixels]) is indexed at run time and stays in local memory
// (L1-cached): with pruning most pixels touch one or two nodes.
//
// Build: as fused_whitted.cu (kernels/build.py; --fmad=false).

#include "whitted_common.cuh"

namespace {

constexpr int kTrainThreads = 128;
constexpr int kTrainWarps = kTrainThreads / 32;
// 4 blocks per SM: at most 128 registers a thread (the glass kernel would
// take 148, and 3 blocks)
constexpr int kTrainMinBlocks = 4;
// blocks of one launch: whole waves on the H100's 132 SMs
constexpr int kTrainBlocks = 24 * 132;
// shared memory a block may take on Hopper (227 KB, dynamic only)
constexpr int kTrainSmemBytes = 232448;
constexpr int kReduceX = 32, kReduceY = 32, kReduceLoads = 8;

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

constexpr int kMaxRow = 9;  // the widest table row (a plane's)

// A table row's accumulators in a thread's column of the shared gradient
// sums: float k of the row at p[k · kTrainThreads].
struct AccRow {
  float* p;
  __device__ __forceinline__ float& operator[](int k) const {
    return p[k * kTrainThreads];
  }
  __device__ __forceinline__ AccRow operator+(int k) const {
    return {p + k * kTrainThreads};
  }
};

// A thread's accumulators for the launch's window [lo, lo + n) of table
// floats, which holds whole table rows: g[0] the loss, float 1 + j − lo of
// the column the gradient of table float j, and past them a row-wide sink.
struct GradWin {
  float* g;  // the thread's column: float j at g[j · kTrainThreads]
  int lo, n;
  // the accumulators of the table row that starts at float `base` (the
  // sink when the row lies outside the window)
  __device__ __forceinline__ AccRow row(int base) const {
    const unsigned k = static_cast<unsigned>(base - lo);
    return {g + (1 + (k < static_cast<unsigned>(n) ? k : n)) * kTrainThreads};
  }
};

// Adjoint of sphere_t at a finite t: adds dL/do, dL/dd and the sphere's
// center/radius gradients (gs[0..3]) for dL/dt = tb.
__device__ void sphere_t_bwd(const float* o, const float* d, const float* sp,
                             float t_min, float tb, float* ob, float* db,
                             AccRow gs) {
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
                            float tb, float* ob, float* db, AccRow gp) {
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
                           NodeOut& out, const NodeAdj* adj, GradWin g,
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
  const AccRow gm = g.row(go.mat + 7 * n.m);
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
      const AccRow gl = g.row(go.lgt + 6 * li);
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
    const AccRow ga2 = g.row(go.pln + 9 * (win - ns)) + 6;
    for (int k = 0; k < 3; ++k) ga2[k] += albb[k];
  } else {
    for (int k = 0; k < 3; ++k) gm[k] += albb[k];
  }
  gm[3] += kdb;
  gm[4] += ksb;
  gm[5] += snb;
  gm[6] += iorb;
  if (win < ns) {
    const AccRow gs = g.row(go.sph + 4 * win);
    const float* cc = s.sph + 4 * win;
    float invrb = 0.0f;
    for (int k = 0; k < 3; ++k) {
      pb[k] += nb[k] * n.inv_r;
      gs[k] -= nb[k] * n.inv_r;
      invrb += nb[k] * (n.p[k] - cc[k]);
    }
    gs[3] -= invrb * n.inv_r * n.inv_r;
  } else if (win < ns + np) {
    const AccRow gp = g.row(go.pln + 9 * (win - ns));
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
                 g.row(go.sph + 4 * win));
  else if (win < ns + np)
    plane_t_bwd(o, d, s.pln + 9 * (win - ns), tb, ob, db,
                g.row(go.pln + 9 * (win - ns)));
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

// The node store: per tree node its incoming ray (then that ray's adjoint,
// 0..5), path weight (6), subtree radiance (7..9) and child weights (10, 11).
// With kDeep (a chain longer than kNodes), the nodes past kNodes live in the
// scratch buffer.
template <int kNodes, bool kDeep>
struct NodeStore {
  float on[kNodes][12];
  float* deep;  // this pixel's [nodes − kNodes, 12] slots, stride `stride`
  size_t stride;
  __device__ __forceinline__ float& at(int node, int f) {
    if (kDeep && node >= kNodes)
      return deep[(static_cast<size_t>(node - kNodes) * 12 + f) * stride];
    return on[node][f];
  }
};
constexpr int kPw = 6, kR = 7, kWr = 10, kWt = 11;

// One pixel: replay, loss and gradients. g.g[0] += loss, and the window's
// table floats += their dL/d.
template <bool kGlass, bool kDeep>
__device__ void train_pixel(const SceneView& s, const float* o0,
                            const float* d0, const int* plan, size_t plane_px,
                            size_t px, int max_depth, const float* bg,
                            const float* tgt, GradWin g, const GradOff& go,
                            float* scratch) {
  const int n_nodes = kGlass ? (1 << (max_depth + 1)) - 1 : max_depth + 1;
  NodeStore<kGlass ? (1 << kGlassLevels) - 1 : kChainLevels, kDeep> st;
  st.deep = scratch + px;
  st.stride = plane_px;
  // live nodes: a bit per node with glass, the length of the chain without
  uint64_t live = 1;
  int n_live = 1;
  auto is_live = [&](int node) {
    return kGlass ? ((live >> node) & 1) != 0 : node < n_live;
  };
  for (int k = 0; k < 3; ++k) {
    st.at(0, k) = o0[k];
    st.at(0, 3 + k) = d0[k];
  }
  st.at(0, kPw) = 1.0f;

  // sweep 1: the forward, top-down
  for (int node = 0; node < n_nodes; ++node) {
    if (!is_live(node)) continue;
    const int depth = node_depth(kGlass, node);
    const int off = kGlass ? (1 << depth) - 1 : depth;
    const int win = plan[node * plane_px + px];
    const int occ = plan[(n_nodes + node) * plane_px + px];
    const bool leaf = depth == max_depth;
    float od[6];
    for (int k = 0; k < 6; ++k) od[k] = st.at(node, k);
    NodeOut out;
    train_node<kGlass, false>(s, od, od + 3, win, occ, leaf, bg, out, nullptr,
                              g, go, nullptr);
    for (int k = 0; k < 3; ++k) st.at(node, kR + k) = out.local[k];
    st.at(node, kWr) = out.wr;
    st.at(node, kWt) = out.wt;
    const float pw = st.at(node, kPw);
    if (out.live_r) {
      const int ch = kGlass ? node + off + 1 : node + 1;
      if (kGlass)
        live |= uint64_t(1) << ch;
      else
        n_live = ch + 1;
      for (int k = 0; k < 3; ++k) {
        st.at(ch, k) = out.ro[k];
        st.at(ch, 3 + k) = out.rd[k];
      }
      st.at(ch, kPw) = pw * out.wr;
    }
    if (kGlass && out.live_t) {
      const int ch = node + off + 1 + (1 << depth);
      live |= uint64_t(1) << ch;
      for (int k = 0; k < 3; ++k) {
        st.at(ch, k) = out.to[k];
        st.at(ch, 3 + k) = out.td[k];
      }
      st.at(ch, kPw) = pw * out.wt;
    }
  }
  // subtree radiances, bottom-up, in the forward kernel's order
  for (int node = n_nodes - 1; node >= 0; --node) {
    if (!is_live(node)) continue;
    const int depth = node_depth(kGlass, node);
    if (depth == max_depth) continue;
    const int off = kGlass ? (1 << depth) - 1 : depth;
    const int chr = kGlass ? node + off + 1 : node + 1;
    if (is_live(chr)) {
      const float w = st.at(node, kWr);
      for (int k = 0; k < 3; ++k) st.at(node, kR + k) += w * st.at(chr, kR + k);
    }
    if (kGlass) {
      const int cht = node + off + 1 + (1 << depth);
      if (is_live(cht)) {
        const float w = st.at(node, kWt);
        for (int k = 0; k < 3; ++k)
          st.at(node, kR + k) += w * st.at(cht, kR + k);
      }
    }
  }

  // the pixel's loss and dL/drad
  float croot[3];
  float loss = 0.0f;
  for (int k = 0; k < 3; ++k) {
    const float rk = st.at(0, kR + k);
    const float dk = fminf(fmaxf(rk, 0.0f), 1.0f) - tgt[k];
    loss += dk * dk;
    croot[k] = 2.0f * dk * tie_clip(rk, 0.0f, 1.0f);
  }
  g.g[0] += loss;
  if (croot[0] == 0.0f && croot[1] == 0.0f && croot[2] == 0.0f) return;

  // sweep 2: the adjoint, children before parents
  for (int node = n_nodes - 1; node >= 0; --node) {
    if (!is_live(node)) continue;
    const int depth = node_depth(kGlass, node);
    const int off = kGlass ? (1 << depth) - 1 : depth;
    const bool leaf = depth == max_depth;
    NodeAdj adj;
    const float pw = st.at(node, kPw);
    for (int k = 0; k < 3; ++k) {
      adj.c[k] = pw * croot[k];
      adj.Rr[k] = adj.Rt[k] = 0.0f;
    }
    for (int k = 0; k < 6; ++k) adj.ar[k] = adj.at[k] = 0.0f;
    if (!leaf) {
      const int chr = kGlass ? node + off + 1 : node + 1;
      if (is_live(chr)) {
        for (int k = 0; k < 3; ++k) adj.Rr[k] = st.at(chr, kR + k);
        for (int k = 0; k < 6; ++k) adj.ar[k] = st.at(chr, k);
      }
      if (kGlass) {
        const int cht = node + off + 1 + (1 << depth);
        if (is_live(cht)) {
          for (int k = 0; k < 3; ++k) adj.Rt[k] = st.at(cht, kR + k);
          for (int k = 0; k < 6; ++k) adj.at[k] = st.at(cht, k);
        }
      }
    }
    const int win = plan[node * plane_px + px];
    const int occ = plan[(n_nodes + node) * plane_px + px];
    float od[6], ain[6];
    for (int k = 0; k < 6; ++k) od[k] = st.at(node, k);
    NodeOut out;
    train_node<kGlass, true>(s, od, od + 3, win, occ, leaf, bg, out, &adj, g,
                             go, ain);
    for (int k = 0; k < 6; ++k) st.at(node, k) = ain[k];
  }
}

// ---- kernels ---------------------------------------------------------------

// Shared-memory float offset of the gradient rows, past the staged scene.
__host__ __device__ inline int acc_offset(int ns, int np, int nt, int nm,
                                          int nl) {
  return static_cast<int>((scene_smem_bytes(ns, np, nt, nm, nl) + 15) / 16 * 4);
}

template <bool kGlass, bool kDeep>
__global__ void __launch_bounds__(kTrainThreads, kTrainMinBlocks)
fused_train_kernel(const float* __restrict__ sph_g,
                   const float* __restrict__ pln_g,
                   const float* __restrict__ mat_g,
                   const float* __restrict__ lgt_g,
                   const float* __restrict__ stat_g,
                   const int* __restrict__ ids_g,
                   const float* __restrict__ cam_g, GradOff go, int g0,
                   int gn, int ns, int np, int nt, int nm, int nl,
                   int max_depth, float t_min, float bias, float bg_r,
                   float bg_g, float bg_b, int width, int height, int row0,
                   int rows, float eps, const int* __restrict__ plan,
                   const float* __restrict__ target,
                   float* __restrict__ partial, float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const float* cam;
  const SceneView s =
      stage_scene(smem, sph_g, pln_g, mat_g, lgt_g, stat_g, ids_g, cam_g, ns,
                  np, nt, nm, nl, t_min, bias, &cam);
  // the gradient sums (GradWin), a column per thread: float j of thread t
  // at acc[j · kTrainThreads + t], so a warp's 32 lanes hit 32 banks
  // whichever floats they add to
  float* acc = smem + acc_offset(ns, np, nt, nm, nl);
  const int tid = threadIdx.x;
  float* g = acc + tid;
  for (int j = 0; j < gn + 1 + kMaxRow; ++j) g[j * kTrainThreads] = 0.0f;
  __syncthreads();

  const GradWin gw{g, g0, gn};
  const float bg[3] = {bg_r, bg_g, bg_b};
  const int n_px = rows * width;
  // a fixed assignment: thread k of the launch replays pixels k, k + T, …
  const int T = gridDim.x * kTrainThreads;
  for (int px = blockIdx.x * kTrainThreads + tid; px < n_px; px += T) {
    const int r = px / width, col = px - r * width;
    float o[3], d[3];
    eye_ray(cam, row0 + r, col, width, height, eps, o, d);
    train_pixel<kGlass, kDeep>(s, o, d, plan, static_cast<size_t>(n_px),
                               static_cast<size_t>(px), max_depth, bg,
                               target + 3 * static_cast<size_t>(px), gw, go,
                               scratch);
  }

  // the block's sums, in a fixed order: per float, a shuffle tree over each
  // warp's lanes into its lane 0's slot, then the warps in turn
  const int lane = tid & 31, warp = tid >> 5;
  const int n_out = gn + 1;
  for (int j = 0; j < n_out; ++j) {
    float v = g[j * kTrainThreads];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) g[j * kTrainThreads] = v;
  }
  __syncthreads();
  for (int j = tid; j < n_out; j += kTrainThreads) {
    float v = acc[j * kTrainThreads];
    for (int w = 1; w < kTrainWarps; ++w) v += acc[j * kTrainThreads + 32 * w];
    partial[static_cast<size_t>(blockIdx.x) * n_out + j] = v;
  }
}

// Σ_b partial[b, j]: a block of kReduceX columns × kReduceY threads; thread
// (x, y) adds rows y, y + kReduceY, … of column j in order (a warp reads 32
// consecutive floats of a row; kReduceLoads rows in flight), then a fixed
// tree over y. Column 0 (the
// loss) goes to *loss_out when that is not null, column j ≥ 1 to
// grad_out[j − 1].
__global__ void __launch_bounds__(kReduceX * kReduceY)
reduce_partials(const float* __restrict__ partial, int n_blocks, int n_out,
                float* __restrict__ loss_out, float* __restrict__ grad_out) {
  __shared__ float buf[kReduceY][kReduceX + 1];
  const int x = threadIdx.x, y = threadIdx.y;
  const int j = blockIdx.x * kReduceX + x;
  float v = 0.0f;
  if (j < n_out) {
    // kReduceLoads rows' loads in flight, added in row order
    int b = y;
    for (; b + (kReduceLoads - 1) * kReduceY < n_blocks;
         b += kReduceLoads * kReduceY) {
      float r[kReduceLoads];
#pragma unroll
      for (int q = 0; q < kReduceLoads; ++q)
        r[q] = partial[static_cast<size_t>(b + q * kReduceY) * n_out + j];
#pragma unroll
      for (int q = 0; q < kReduceLoads; ++q) v += r[q];
    }
    for (; b < n_blocks; b += kReduceY)
      v += partial[static_cast<size_t>(b) * n_out + j];
  }
  buf[y][x] = v;
  __syncthreads();
  for (int half = kReduceY / 2; half > 0; half >>= 1) {
    if (y < half) buf[y][x] += buf[y + half][x];
    __syncthreads();
  }
  if (y == 0 && j < n_out) {
    if (j > 0)
      grad_out[j - 1] = buf[0][x];
    else if (loss_out)
      *loss_out = buf[0][x];
  }
}

}  // namespace

// Number of blocks (rows of `partial`) a launch over a band uses: one per
// kTrainThreads pixels, at most kTrainBlocks (then each thread replays
// several pixels).
extern "C" int rt_fused_train_blocks(int width, int rows) {
  const long long px = static_cast<long long>(width) * rows;
  const long long blocks = (px + kTrainThreads - 1) / kTrainThreads;
  return static_cast<int>(blocks < kTrainBlocks ? blocks : kTrainBlocks);
}

// Nodes per pixel a launch keeps in the scratch buffer (12 floats each): 0
// unless a glass-free tree is deeper than the on-chip node store.
extern "C" int rt_fused_train_deep_nodes(int max_depth, int glass) {
  return glass ? 0
               : (max_depth + 1 > kChainLevels ? max_depth + 1 - kChainLevels
                                               : 0);
}

// Plain C entry for ctypes. Launches the train kernel on `stream` for the
// window [g0, g0 + gn) of the gradient vector (whole table rows; the scene
// and kTrainThreads rows of (1 + gn + kMaxRow) | 1 floats must fit
// kTrainSmemBytes of shared memory), writing one row of `partial` per block;
// rt_fused_train_reduce then sums them. Does not synchronise; returns
// cudaGetLastError() (0 on success). `hs, hp, hm, hl`: the tables' heights
// (padded); `plan`: [2·n_nodes, rows, width] i32 (only the live nodes'
// entries are read); `target`: [rows, width, 3] f32; `partial`:
// [rt_fused_train_blocks(width, rows), 1 + gn] f32 scratch; `scratch`:
// [rt_fused_train_deep_nodes, 12, rows, width] f32, or null when that is 0.
extern "C" int rt_fused_train(
    const void* sph, const void* pln, const void* mat, const void* lgt,
    const void* stat, const void* ids, const void* cam, int hs, int hp, int hm,
    int hl, int ns, int np, int nt, int nm, int nl, int max_depth, int glass,
    float t_min, float bias, float bg_r, float bg_g, float bg_b, int width,
    int height, int row0, int rows, float eps, const void* plan,
    const void* target, int g0, int gn, void* partial, void* scratch,
    void* stream) {
  if (rows <= 0 || width <= 0 ||
      static_cast<long long>(rows) * width >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_depth < 0 || (glass && max_depth >= kGlassLevels) ||
      (rt_fused_train_deep_nodes(max_depth, glass) > 0 && !scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nl > 32) return static_cast<int>(cudaErrorInvalidValue);
  GradOff go;
  go.sph = 0;
  go.pln = 4 * hs;
  go.mat = go.pln + 9 * hp;
  go.lgt = go.mat + 7 * hm;
  const int n_grads = go.lgt + 6 * hl;
  auto row_start = [&](int j) {  // j starts a table row (or ends the last)
    if (j <= go.pln) return j % 4 == 0;
    if (j <= go.mat) return (j - go.pln) % 9 == 0;
    if (j <= go.lgt) return (j - go.mat) % 7 == 0;
    return (j - go.lgt) % 6 == 0;
  };
  if (g0 < 0 || gn < 1 || g0 + gn > n_grads || !row_start(g0) ||
      !row_start(g0 + gn))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      sizeof(float) * (acc_offset(ns, np, nt, nm, nl) +
                       static_cast<size_t>(kTrainThreads) * (gn + 1 + kMaxRow));
  if (smem > kTrainSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = rt_fused_train_blocks(width, rows);
  auto kern = glass ? fused_train_kernel<true, false>
                    : (rt_fused_train_deep_nodes(max_depth, glass) > 0
                           ? fused_train_kernel<false, true>
                           : fused_train_kernel<false, false>);
  if (smem > kSmemBytes) {  // past 48 KB a block must opt in
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<n_blocks, kTrainThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sph), static_cast<const float*>(pln),
      static_cast<const float*>(mat), static_cast<const float*>(lgt),
      static_cast<const float*>(stat), static_cast<const int*>(ids),
      static_cast<const float*>(cam), go, g0, gn, ns, np, nt, nm, nl,
      max_depth, t_min, bias, bg_r, bg_g, bg_b, width, height, row0, rows, eps,
      static_cast<const int*>(plan), static_cast<const float*>(target),
      static_cast<float*>(partial), static_cast<float*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry for ctypes: Σ over the `n_blocks` rows of `partial` [n_blocks,
// n_out] on `stream`; column 0 (the loss) to *loss_out unless that is null,
// column j ≥ 1 to grad_out[j − 1]. Returns cudaGetLastError().
extern "C" int rt_fused_train_reduce(const void* partial, int n_blocks,
                                     int n_out, void* loss_out,
                                     void* grad_out, void* stream) {
  if (n_blocks < 1 || n_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  reduce_partials<<<(n_out + kReduceX - 1) / kReduceX, dim3(kReduceX, kReduceY),
                    0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), n_blocks, n_out,
      static_cast<float*>(loss_out), static_cast<float*>(grad_out));
  return static_cast<int>(cudaGetLastError());
}
