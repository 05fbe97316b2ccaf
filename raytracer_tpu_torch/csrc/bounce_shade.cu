// K6, the fused forward shading of one wavefront bounce: what
// renderer.bounce_step computes around its searches, in two launches a
// bounce, for a bounce that autograd does not record, and for a recorded
// glass-free one whose shade launch is the forward of K7's autograd
// Function (bounce_adjoint.cu, ops/bounce_shade.shade_recorded):
//   1. surface (shade_surface_kernel): ops/trace.surface_at (the
//      recomputed t and its knife-edge demotion, the point, the normal of a
//      sphere, a plane or a flat or smooth triangle, the checker albedo of a
//      plane or a uv mesh, the material), then shade_diffuse's shadow
//      set-up: the biased shadow origin and each light's direction,
//      distance and search mask (a diffuse hit that faces the light), and
//      the diffuse mask;
//   2. the shadow searches run between the two, as tracer calls;
//   3. shade (shade_finish_kernel): the surface again, the Phong sums under
//      each light's shadow bit, the miss, diffuse and last-bounce mirror /
//      glass leaf terms, geometry.fresnel, and the children of
//      renderer._spawn (the reflection, and on a glass scene the
//      refraction half of the doubled buffer); the plan planes when a plan
//      is recorded. Where the wavefront's lanes are its pixels, the terms
//      are added into the radiance in the renderer's order (miss, diffuse,
//      leaf); otherwise they are written per lane for the renderer's fold.
// It replaces no TPU kernel: on the TPU the shading is XLA's, fused by the
// compiler. On the card the same shading as plain torch ops is ~500
// launches a bounce, each a pass over the wavefront.
//
// Bound: bytes. Per lane the ray (o, d, thr; 36 B), the winner (8 B), the
// masks, the shadow rays (12 + 16 B a light), the radiance and the child
// (37 B a child), plus the gathered table rows of the winner (small
// tables, L2-resident; the mesh's vertex rows for triangle lanes). The
// second launch recomputes the surface rather than reading a stored one:
// the recompute is a few dozen operations a lane on data the first launch
// pulled into L2, where a stored surface record would add ~60 B a lane
// written and read. On config4's 1080p d4 frame (H100 80GB HBM3, 700 W):
// 0.299 device ms for the frame's two bounces, 78% of the bytes' bound,
// where the torch ops took ~12.3.
//
// Every value is computed in the torch bounce's operations, order and
// rounding: ops/safemath's per-component dot and cross ((x + y) + z),
// normalize as v * (1 / sqrt(n2)), safe_sqrt / safe_div / safe_pow with
// their guards, torch.maximum / minimum (a NaN operand wins), and
// torch.where's selections. The kernel is built without multiply-add
// contraction (kernels/build.py), and torch's sqrt, division and pow on
// the card round as sqrtf, / and powf do here, so the kernel equals the
// torch bounce bit for bit on the card (tests/test_torch_bounce_shade.py).
// The torch bounce is the twin: it is what every CPU bounce runs, and
// every recorded bounce K7 does not cover.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py).

#include "bounce_common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
shade_surface_kernel(const ShadeArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.n) return;
  const V3 o = ld3(a.o, r), d = ld3(a.d, r);
  const Surf s = surface_of(a, r, o, d);
  const bool is_diff = s.valid && a.alive[r] && s.mtype == kDiffuse;
  // the shadow origin: + bias·N when the viewing ray hits the front face
  const float front = dot(d, s.n) < 0.0f ? 1.0f : 0.0f;
  st3(a.sorig, r, s.p + ((2.0f * front - 1.0f) * a.bias) * s.n);
  for (int li = 0; li < a.nl; ++li) {
    const ToLight l = to_light(a, li, s.p, s.n);
    const size_t j = static_cast<size_t>(li) * a.n + r;
    st3(a.ldir, j, l.dir);
    a.dist[j] = l.dist;
    a.oactive[j] = is_diff && l.ldn > 0.0f;
  }
  a.is_diff[r] = is_diff;
}

__global__ void __launch_bounds__(kThreads)
shade_finish_kernel(const ShadeArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.n) return;
  const V3 o = ld3(a.o, r), d = ld3(a.d, r), thr = ld3(a.thr, r);
  const bool alive = a.alive[r];
  const Surf s = surface_of(a, r, o, d);
  const bool valid = s.valid && alive;

  // leaves: a miss takes the background, a diffuse hit local Phong
  const V3 miss = where(alive && !s.valid, thr * a.bg, V3{});
  const bool is_diff = valid && s.mtype == kDiffuse;
  V3 light_amt = V3{}, spec = V3{};
  int occ = 0;
  for (int li = 0; li < a.nl; ++li) {
    const ToLight l = to_light(a, li, s.p, s.n);
    const bool shadowed = a.shadowed[static_cast<size_t>(li) * a.n + r];
    if (li < kPlanLights) occ |= static_cast<int>(shadowed) << li;
    const V3 lint = ld3(a.l_int, li);
    light_amt = light_amt + ((shadowed ? 0.0f : 1.0f) * l.ldn) * lint;
    const V3 nl = -l.dir;
    const V3 rv = nl - (2.0f * dot(nl, s.n)) * s.n;  // reflect(-ldir, n)
    const float base = -dot(rv, d);
    const float pw =
        base > 0.0f ? powf(tmax(base, 1e-7f), s.spec_n) : 0.0f;  // safe_pow
    spec = spec + pw * lint;
  }
  const V3 local = light_amt * s.albedo * s.kd + spec * s.ks;
  const V3 diffuse = where(is_diff, thr * local, V3{});

  const bool is_mirror = valid && s.mtype == kMirror;
  const bool is_glass = valid && s.mtype == kGlass;
  const float kr = fresnel(d, s.n, s.ior);
  // the last bounce's children would return the background: mirror
  // kr·bg, glass 1·bg
  const float w = is_mirror ? kr : (is_glass ? 1.0f : 0.0f);
  const V3 leaf = thr * w * a.bg;
  if (a.radiance) {
    V3 rad = ld3(a.radiance, r) + miss;
    rad = rad + diffuse;
    if (a.is_last) rad = rad + leaf;
    st3(a.radiance, r, rad);
  } else {
    st3(a.terms, r, miss);
    st3(a.terms, static_cast<size_t>(a.n) + r, diffuse);
    if (a.is_last) st3(a.terms, 2 * static_cast<size_t>(a.n) + r, leaf);
  }
  if (a.win) {  // renderer._plan_win and the occlusion bitmask
    const int kind = a.kind[r], i = a.idx[r];
    const int win = kind == kKindSphere     ? i
                    : kind == kKindPlane    ? i + a.ns
                    : kind == kKindTriangle ? i + a.ns + a.np
                                            : -1;
    a.win[r] = alive ? win : -1;
    a.occ[r] = occ;
  }
  if (a.is_last) return;

  // renderer._spawn: the reflection, then on a glass scene the refraction
  // in the second half of the children
  const bool spec_hit = is_mirror || is_glass;
  const V3 rdir = normalize(d - (2.0f * dot(d, s.n)) * s.n);
  st3(a.c_o, r, spawn_origin(s.p, s.n, rdir, a.bias));
  st3(a.c_d, r, rdir);
  st3(a.c_thr, r, where(spec_hit, thr * kr, V3{}));
  a.c_alive[r] = spec_hit;
  if (!a.glass) return;
  bool t_ok;
  const V3 tdir = refract(d, s.n, s.ior, t_ok);
  const bool alive_t = is_glass && t_ok;
  const size_t c = static_cast<size_t>(a.n) + r;
  st3(a.c_o, c, spawn_origin(s.p, s.n, tdir, a.bias));
  st3(a.c_d, c, tdir);
  st3(a.c_thr, c, where(alive_t, thr * (1.0f - kr), V3{}));
  a.c_alive[c] = alive_t;
}

}  // namespace

// Plain C entry for ctypes: one launch of K6 on `stream`, `half` 0 the
// surface, 1 the shade. `ptrs` lists ShadeArgs' pointers in its field
// order (o … occ), `ints` n, ns, np, nt, nl, is_last, glass, `floats`
// t_min, bias and the background's rgb; the host arrays are read before
// the launch. Does not synchronise; returns cudaGetLastError() (0 on
// success).
extern "C" int rt_bounce_shade(int half, const void* const* ptrs,
                               const int* ints, const float* floats,
                               void* stream) {
  ShadeArgs a = {};
  const void* const* p = ptrs;
  read_wave_tables(a, p);
  auto b = [&p]() { return static_cast<const uint8_t*>(*p++); };
  auto wf = [&p]() { return static_cast<float*>(const_cast<void*>(*p++)); };
  auto wi = [&p]() { return static_cast<int*>(const_cast<void*>(*p++)); };
  auto wb = [&p]() {
    return static_cast<uint8_t*>(const_cast<void*>(*p++));
  };
  a.sorig = wf(); a.ldir = wf(); a.dist = wf(); a.oactive = wb();
  a.is_diff = wb();
  a.shadowed = b(); a.radiance = wf(); a.terms = wf();
  a.c_o = wf(); a.c_d = wf(); a.c_thr = wf(); a.c_alive = wb();
  a.win = wi(); a.occ = wi();
  a.n = ints[0]; a.ns = ints[1]; a.np = ints[2]; a.nt = ints[3];
  a.nl = ints[4]; a.is_last = ints[5]; a.glass = ints[6];
  a.t_min = floats[0]; a.bias = floats[1];
  a.bg = {floats[2], floats[3], floats[4]};
  if (a.n <= 0) return 0;
  const int blocks = (a.n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (half == 0)
    shade_surface_kernel<<<blocks, kThreads, 0, s>>>(a);
  else
    shade_finish_kernel<<<blocks, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
