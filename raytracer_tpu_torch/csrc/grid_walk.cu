// Grid DDA walk — Amanatides–Woo traversal of a uniform grid with
// Möller–Trumbore on every listed triangle of every visited cell.
//
// Replaces the TPU kernel raytracer_tpu/ops/pallas_walk.py::_make_walk_kernel
// (and the XLA while-loop walk raytracer_tpu/accel/grid.py::grid_walk at
// fanout 1, skip 0). Same contract: start from the walk_init state, fold
// candidates lexicographically on (t, id), park after the fold and before
// the advance (nearest: best_t <= min(tmax); occlusion: best_t < max_t or
// min(tmax) > max_t), step along the axis of min(tmax) with ties x < y < z,
// stop at grid exit or after max_iters steps.
//
// What bounds it on this card: neither bytes nor arithmetic but the latency
// of a lane's chain of candidate loads. One thread walks one lane, in pixel
// order; of a 1080p ray set 1–22% of lanes walk, ~60–110 candidates each,
// and a warp runs as long as its longest walk (the sparse sets' time is
// their longest walks). A loop that learns a cell's end from a sentinel
// slot of the padded [ncells, C, 10] table (13 MB for config4's blob) pays
// two dependent L2 trips per candidate: its id, then its other nine
// floats. The design:
//   - a known trip count: the walk reads the table built once per grid by
//     ops/walk.pack_cell_table: per cell its (offset, count), and its listed
//     triangles packed once as 48-byte rows v0|e1|e2|id|0|0 (1.6 MB for
//     config4's blob). Nothing waits on a sentinel;
//   - kRows rows per step of the candidate loop: their 3·kRows 16-byte
//     loads go out together, then the tests run; the next cell's (offset,
//     count) load goes out before this cell's tests.
// Per-block lists of the walking lanes, and warps staging a shared cell's
// rows in shared memory, were both slower on the card (PERF.md §6): the
// warps that walk are mostly full already, and a warp's lanes stand in
// several cells.
// The fold is a minimum over (t, id), so the test order does not change the
// winner, and every t comes from the same expressions as
// geometry.triangle_tuv: the kernel equals the plain walk bit for bit.
//
// One entry, rt_grid_search, the fused search: one launch does all of a
// GridTracer.nearest or GridTracer.occluded call. Per lane, in registers:
//   1. the dense sphere and plane tests over the tracer's tables (read
//      through pointers at each call), on every lane whatever `active`
//      says: ops/trace.dense_nearest / dense_occluded;
//   2. on active lanes, the overflow seed, then the slab entry, the first
//      cell, tmax, step and tdelta of accel/grid.walk_init;
//   3. the walk (walk_lane), on lanes that are active and inside the grid;
//   4. the merge: nearest writes the Hit (kind, idx i32; t f32), occlusion
//      the bool occ | (t_walk < max_t).
// A lane the dense tests already find occluded skips 2-3: its bit is set
// whatever the walk finds.
// Its rules, each that of the torch composition it replaces, bit for bit:
//   ties go to the first index of a group (torch.min), then spheres <
//   planes < triangles (strict < at each merge), triangles by (t, id);
//   geometry.sphere_t keeps its radius > 0 term, and its
//   torch.minimum / maximum propagate NaN (nan_min / nan_max here; fminf
//   would drop one), as do walk_init's amax / amin and clamp; a hit
//   distance is never NaN (a failed comparison misses), so the minimum
//   over a group needs no NaN rule; the reciprocal is 1e12 where
//   |d| <= 1e-12, and nan_to_num zeroes a NaN or infinite cell
//   coordinate. The composition it equals is torch's on the card, whose
//   sqrt and division round correctly as sqrtf and / do here; the CPU's
//   sqrt (MKL) can be an ulp off.
// The dense tests cost the card little beside the walk: they read 24-29
// bytes a lane and write 1-12 (config4 1080p d4 on the H100: 1.46 device
// ms a frame for the whole search, against 1.36 for the walk alone before
// they joined it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -Xcompiler -fPIC -c, then one -shared link of all
//        sources (kernels/build.py). No
// multiply-add contraction: each product and sum below rounds as the plain
// torch version's separate ops do, in the same order.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tri_row.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 3;  // candidate rows whose loads go out together

constexpr int kKindSphere = 1;  // core/types.py's KIND_* codes
constexpr int kKindPlane = 2;
constexpr int kKindTriangle = 3;

// One lane's ray and DDA entry state.
struct Lane {
  float ox, oy, oz, dx, dy, dz;
  int cx, cy, cz;
  float tmx, tmy, tmz;
  int sx, sy, sz;
  float tdx, tdy, tdz;
};

// Every input and output of the search.
struct WalkArgs {
  const float* orig;    // [N,3]
  const float* dir;     // [N,3]
  const uint8_t* act;   // [N] bool; null = all active
  const float* max_t;   // [N] (occlusion only)
  const int2* cells;    // [ncells] offset, count
  const float4* slots;  // [n_slots, 3]
  int n, nx, ny, nz, max_iters, occlusion;
  float t_min;
  const float* sph_c;     // [ns,3]
  const float* sph_r;     // [ns]
  const float* pl_p;      // [np,3]
  const float* pl_n;      // [np,3]
  int ns, np;
  const float* bmin;      // [3] grid box min
  const float* cell_size; // [3]
  const float* inv_cell;  // [3]
  const float* ov_v0;     // [n_ov,3] overflow triangles
  const float* ov_e1;     // [n_ov,3]
  const float* ov_e2;     // [n_ov,3]
  const int* ov_ids;      // [n_ov]
  int n_ov, n_tris;
  // outputs: nearest's Hit (t, idx, kind), occlusion's bool
  float* t_out;
  int* i_out;
  int* kind_out;
  uint8_t* occ_out;
};

// Walk lane `s` from its entry state → (best_t, best_idx).
__device__ __forceinline__ void walk_lane(
    const Lane& s, float mt, const int2* __restrict__ cells,
    const float4* __restrict__ slots, int nx, int ny, int nz, float t_min,
    int max_iters, int occlusion, float& bt, int& bi) {
  const float ox = s.ox, oy = s.oy, oz = s.oz;
  const float dx = s.dx, dy = s.dy, dz = s.dz;
  int cx = s.cx, cy = s.cy, cz = s.cz;
  float tmx = s.tmx, tmy = s.tmy, tmz = s.tmz;
  const int sx = s.sx, sy = s.sy, sz = s.sz;
  const float tdx = s.tdx, tdy = s.tdy, tdz = s.tdz;

  int2 cc = __ldg(cells + (cx * ny + cy) * nz + cz);  // offset, count
  for (int it = 0; it < max_iters; ++it) {
    // the cell after this one: its (offset, count) load goes out before
    // this cell's candidates are tested (the step does not depend on them)
    const float m = fminf(fminf(tmx, tmy), tmz);
    int ncx = cx, ncy = cy, ncz = cz;
    if (tmx == m)
      ncx += sx;
    else if (tmy == m)
      ncy += sy;
    else
      ncz += sz;
    const bool out = ncx < 0 || ncx >= nx || ncy < 0 || ncy >= ny ||
                     ncz < 0 || ncz >= nz;
    const int2 nc =
        out ? make_int2(0, 0) : __ldg(cells + (ncx * ny + ncy) * nz + ncz);

    // the cell's rows, kRows at a time: all their loads go out together
    const float4* p = slots + 3 * static_cast<size_t>(cc.x);
    int k = 0;
    for (; k + kRows <= cc.y; k += kRows, p += 3 * kRows) {
      float4 row[3 * kRows];
#pragma unroll
      for (int q = 0; q < 3 * kRows; ++q) row[q] = __ldg(p + q);
#pragma unroll
      for (int j = 0; j < kRows; ++j)
        test_row(row[3 * j], row[3 * j + 1], row[3 * j + 2], ox, oy, oz, dx,
                 dy, dz, t_min, bt, bi);
    }
    for (; k < cc.y; ++k, p += 3)
      test_row(__ldg(p), __ldg(p + 1), __ldg(p + 2), ox, oy, oz, dx, dy, dz,
               t_min, bt, bi);

    const bool parked = occlusion ? (bt < mt || m > mt) : (bt <= m);
    if (parked || out) break;
    if (tmx == m)
      tmx += tdx;
    else if (tmy == m)
      tmy += tdy;
    else
      tmz += tdz;
    cx = ncx;
    cy = ncy;
    cz = ncz;
    cc = nc;
  }
}

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fminf(a, b);
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : fmaxf(a, b);
}

// geometry.sphere_t in its op order (safe_sqrt, safe_div and the
// radius > 0 term included) → t, +inf on a miss.
__device__ __forceinline__ float dense_sphere_t(const Lane& l, float cx,
                                                float cy, float cz, float r,
                                                float t_min) {
  const float Lx = l.ox - cx, Ly = l.oy - cy, Lz = l.oz - cz;
  const float a = l.dx * l.dx + l.dy * l.dy + l.dz * l.dz;
  const float b = 2.0f * (l.dx * Lx + l.dy * Ly + l.dz * Lz);
  const float c0 = (Lx * Lx + Ly * Ly + Lz * Lz) - r * r;
  const float disc = b * b - 4.0f * a * c0;
  const bool has_root = disc >= 0.0f && r > 0.0f;
  const float sq = has_root ? sqrtf(fmaxf(disc, 1e-12f)) : 0.0f;
  const float q = -0.5f * (b + (b >= 0.0f ? sq : -sq));
  const float t0 = fabsf(a) > 1e-12f ? q / a : 0.0f;
  const float t1 = fabsf(q) > 1e-12f ? c0 / q : -CUDART_INF_F;
  const float tlo = nan_min(t0, t1);
  const float thi = nan_max(t0, t1);
  const float t = tlo > t_min ? tlo : (thi > t_min ? thi : CUDART_INF_F);
  return has_root ? t : CUDART_INF_F;
}

// geometry.plane_t in its op order → t, +inf on a miss.
__device__ __forceinline__ float dense_plane_t(const Lane& l, const float* p,
                                               const float* nv, float t_min) {
  const float nx = __ldg(nv), ny = __ldg(nv + 1), nz = __ldg(nv + 2);
  const float denom = nx * l.dx + ny * l.dy + nz * l.dz;
  const bool valid = fabsf(denom) > kRowDetEps;
  const float num = (__ldg(p) - l.ox) * nx + (__ldg(p + 1) - l.oy) * ny +
                    (__ldg(p + 2) - l.oz) * nz;
  const float t = valid ? num / denom : -CUDART_INF_F;
  return (valid && t > t_min) ? t : CUDART_INF_F;
}

// walk_init's reciprocal of a direction component.
__device__ __forceinline__ float recip(float d) {
  return fabsf(d) > 1e-12f ? 1.0f / d : 1e12f;
}

// The rest of walk_init on one axis, once the entry distance is known:
// the first cell, step, tdelta and tmax.
__device__ __forceinline__ void axis_entry(float o, float d, float inv,
                                           float bmin, float cs, float ic,
                                           int res, float s, int& cell,
                                           int& step, float& tdelta,
                                           float& tmax) {
  const float p = o + s * d;
  float cf = (p - bmin) * ic;
  if (!isfinite(cf)) cf = 0.0f;  // nan_to_num(nan=0, posinf=0, neginf=0)
  float fl = floorf(cf);
  fl = fl < 0.0f ? 0.0f : fl;
  fl = fminf(fl, static_cast<float>(res - 1));
  cell = static_cast<int>(fl);
  step = d > 0.0f ? 1 : -1;
  tdelta = fabsf(cs * inv);
  const float nb = bmin + static_cast<float>(cell + (step > 0 ? 1 : 0)) * cs;
  tmax = fabsf(d) > 1e-12f ? (nb - o) * inv : CUDART_INF_F;
}

// The search on lane r.
__device__ __forceinline__ void search_lane(const WalkArgs& a, int r) {
  Lane l;
  l.ox = a.orig[3 * r];
  l.oy = a.orig[3 * r + 1];
  l.oz = a.orig[3 * r + 2];
  l.dx = a.dir[3 * r];
  l.dy = a.dir[3 * r + 1];
  l.dz = a.dir[3 * r + 2];
  const float mt = a.occlusion ? a.max_t[r] : 0.0f;

  // 1. the dense tests, every lane
  float t_best = CUDART_INF_F;
  int kind = 0, idx = 0;
  bool occ = false;
  if (a.ns) {
    float tb = CUDART_INF_F;
    int ib = 0;
    for (int j = 0; j < a.ns; ++j) {
      const float* c = a.sph_c + 3 * j;
      const float t = dense_sphere_t(l, __ldg(c), __ldg(c + 1), __ldg(c + 2),
                                     __ldg(a.sph_r + j), a.t_min);
      occ = occ || t < mt;
      if (t < tb) {
        tb = t;
        ib = j;
      }
    }
    if (tb < t_best) {
      t_best = tb;
      kind = kKindSphere;
      idx = ib;
    }
  }
  if (a.np) {
    float tb = CUDART_INF_F;
    int ib = 0;
    for (int j = 0; j < a.np; ++j) {
      const float t =
          dense_plane_t(l, a.pl_p + 3 * j, a.pl_n + 3 * j, a.t_min);
      occ = occ || t < mt;
      if (t < tb) {
        tb = t;
        ib = j;
      }
    }
    if (tb < t_best) {
      t_best = tb;
      kind = kKindPlane;
      idx = ib;
    }
  }
  if (a.occlusion && occ) {  // set whatever the walk would find
    a.occ_out[r] = 1;
    return;
  }

  // 2. walk_init on active lanes: the overflow seed (first index on ties),
  // then the slab entry
  float bt = CUDART_INF_F;
  int bi = a.n_tris;
  const bool active = a.act == nullptr || a.act[r];
  if (active) {
    int arg = 0;
    for (int j = 0; j < a.n_ov; ++j) {
      const float* v = a.ov_v0 + 3 * j;
      const float* e = a.ov_e1 + 3 * j;
      const float* f = a.ov_e2 + 3 * j;
      const float t = tri_row_t(__ldg(v), __ldg(v + 1), __ldg(v + 2),
                                __ldg(e), __ldg(e + 1), __ldg(e + 2),
                                __ldg(f), __ldg(f + 1), __ldg(f + 2), l.ox,
                                l.oy, l.oz, l.dx, l.dy, l.dz, a.t_min);
      if (t < bt) {
        bt = t;
        arg = j;
      }
    }
    if (bt != CUDART_INF_F) bi = __ldg(a.ov_ids + arg);

    const float o[3] = {l.ox, l.oy, l.oz};
    const float d[3] = {l.dx, l.dy, l.dz};
    const int res[3] = {a.nx, a.ny, a.nz};
    float inv[3], bmin[3], cs[3];
    float tlo = 0.0f, thi = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      bmin[k] = __ldg(a.bmin + k);
      cs[k] = __ldg(a.cell_size + k);
      const float bmax = bmin[k] + cs[k] * static_cast<float>(res[k]);
      inv[k] = recip(d[k]);
      const float t0 = (bmin[k] - o[k]) * inv[k];
      const float t1 = (bmax - o[k]) * inv[k];
      const float lo = nan_min(t0, t1), hi = nan_max(t0, t1);
      tlo = k == 0 ? lo : nan_max(tlo, lo);  // amax
      thi = k == 0 ? hi : nan_min(thi, hi);  // amin
    }
    // torch.clamp(tlo, min=0) keeps a NaN, which then fails both tests
    const float t_entry = tlo < 0.0f ? 0.0f : tlo;
    if (thi >= t_entry && thi > 0.0f) {
      const float s = t_entry + 1e-5f;
      int cell[3], step[3];
      float tdelta[3], tmax[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        axis_entry(o[k], d[k], inv[k], bmin[k], cs[k], __ldg(a.inv_cell + k),
                   res[k], s, cell[k], step[k], tdelta[k], tmax[k]);
      l.cx = cell[0];
      l.cy = cell[1];
      l.cz = cell[2];
      l.tmx = tmax[0];
      l.tmy = tmax[1];
      l.tmz = tmax[2];
      l.sx = step[0];
      l.sy = step[1];
      l.sz = step[2];
      l.tdx = tdelta[0];
      l.tdy = tdelta[1];
      l.tdz = tdelta[2];
      // 3. the walk
      walk_lane(l, mt, a.cells, a.slots, a.nx, a.ny, a.nz, a.t_min,
                a.max_iters, a.occlusion, bt, bi);
    }
  }

  // 4. the merge: strict <, so exact-t ties stay with spheres and planes
  if (a.occlusion) {
    a.occ_out[r] = bt < mt;
    return;
  }
  if (bt < t_best) {
    t_best = bt;
    kind = kKindTriangle;
    idx = bi;
  }
  a.kind_out[r] = kind;
  a.i_out[r] = idx;
  a.t_out[r] = t_best;
}

__global__ void __launch_bounds__(kThreads)
grid_walk_kernel(const WalkArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r < a.n) search_lane(a, r);
}

}  // namespace

// Plain C entry for ctypes: the search of one GridTracer call. `cells`:
// [ncells, 2] i32 (offset, count) and `slots`: [n_slots, 12] f32, the table
// of ops/walk.pack_cell_table. `act` may be null (every lane active).
// Nearest (occlusion = 0) → kind_out, i_out [N] i32 and t_out [N] f32;
// occlusion (max_t given) → occ_out [N] bool. The spheres: sph_c [ns,3],
// sph_r [ns]; the planes: pl_p, pl_n [np,3]; the grid's box: bmin,
// cell_size, inv_cell [3]; its overflow list: ov_v0, ov_e1, ov_e2 [n_ov,3],
// ov_ids [n_ov] i32. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" int rt_grid_search(
    const void* orig, const void* dir, const void* act, const void* max_t,
    const void* cells, const void* slots, const void* sph_c,
    const void* sph_r, const void* pl_p, const void* pl_n, const void* bmin,
    const void* cell_size, const void* inv_cell, const void* ov_v0,
    const void* ov_e1, const void* ov_e2, const void* ov_ids, int n, int nx,
    int ny, int nz, int ns, int np, int n_ov, int n_tris, float t_min,
    int max_iters, int occlusion, void* kind_out, void* i_out, void* t_out,
    void* occ_out, void* stream) {
  if (n <= 0) return 0;
  WalkArgs a = {};
  a.orig = static_cast<const float*>(orig);
  a.dir = static_cast<const float*>(dir);
  a.act = static_cast<const uint8_t*>(act);
  a.max_t = static_cast<const float*>(max_t);
  a.cells = static_cast<const int2*>(cells);
  a.slots = static_cast<const float4*>(slots);
  a.n = n;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.max_iters = max_iters;
  a.occlusion = occlusion;
  a.t_min = t_min;
  a.sph_c = static_cast<const float*>(sph_c);
  a.sph_r = static_cast<const float*>(sph_r);
  a.pl_p = static_cast<const float*>(pl_p);
  a.pl_n = static_cast<const float*>(pl_n);
  a.ns = ns;
  a.np = np;
  a.bmin = static_cast<const float*>(bmin);
  a.cell_size = static_cast<const float*>(cell_size);
  a.inv_cell = static_cast<const float*>(inv_cell);
  a.ov_v0 = static_cast<const float*>(ov_v0);
  a.ov_e1 = static_cast<const float*>(ov_e1);
  a.ov_e2 = static_cast<const float*>(ov_e2);
  a.ov_ids = static_cast<const int*>(ov_ids);
  a.n_ov = n_ov;
  a.n_tris = n_tris;
  a.t_out = static_cast<float*>(t_out);
  a.i_out = static_cast<int*>(i_out);
  a.kind_out = static_cast<int*>(kind_out);
  a.occ_out = static_cast<uint8_t*>(occ_out);
  const int blocks = (n + kThreads - 1) / kThreads;
  grid_walk_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
