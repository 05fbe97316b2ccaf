"""Nearest-hit search, occlusion, and surface recomputation (counterpart of
`raytracer_tpu/ops/trace.py`).

The *search* for the winning primitive is integer-only and runs under
`torch.no_grad()`: it returns `(kind, idx)`. The surface quantities (t,
normal, uv, albedo) are recomputed from the single gathered winner per ray in
`surface_at`, so a later autograd pass differentiates the recompute, never
the argmin sweep. Ties go sphere < plane < triangle (strict `<` per group),
then to the lower index.
"""

import dataclasses

import torch

from raytracer_tpu_torch.core.types import (KIND_NONE, KIND_PLANE,
                                            KIND_SPHERE, KIND_TRIANGLE, Scene)
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops.dgather import pgather, tselect
from raytracer_tpu_torch.ops.safemath import cross, dot, normalize, safe_div

INF = geom.INF


def _tri_chunks(v0, e1, e2, chunk: int):
    for s in range(0, v0.shape[0], chunk):
        yield s, v0[s:s + chunk], e1[s:s + chunk], e2[s:s + chunk]


def _tri_nearest(orig, direc, v0, e1, e2, t_min, chunk):
    """Streaming min-reduce over chunks of the (v0, e1, e2) [T, 3] triangles
    → (best_t, best_i) per ray."""
    n = orig.shape[0]
    bt = torch.full((n,), INF, dtype=torch.float32, device=orig.device)
    bi = torch.zeros((n,), dtype=torch.int32, device=orig.device)
    for off, cv0, ce1, ce2 in _tri_chunks(v0, e1, e2, chunk):
        ts, _, _ = geom.triangle_hits(orig, direc, cv0, ce1, ce2, t_min)
        tc, ic = torch.min(ts, dim=1)  # first index on ties
        better = tc < bt
        bt = torch.where(better, tc, bt)
        bi = torch.where(better, ic.to(torch.int32) + off, bi)
    return bt, bi


def _tri_occluded(orig, direc, v0, e1, e2, t_min, max_t, chunk):
    """Any triangle hit with t in (t_min, max_t), chunk by chunk → bool
    [N]."""
    occ = torch.zeros((orig.shape[0],), dtype=torch.bool, device=orig.device)
    for _, cv0, ce1, ce2 in _tri_chunks(v0, e1, e2, chunk):
        ts, _, _ = geom.triangle_hits(orig, direc, cv0, ce1, ce2, t_min)
        occ |= torch.any(ts < max_t[:, None], dim=1)
    return occ


@dataclasses.dataclass
class Hit:
    """Per-ray hit record: kind/idx are the integer results of the search; t
    is the winning distance (+inf on miss)."""
    kind: torch.Tensor  # [N] i32 — KIND_NONE/SPHERE/PLANE/TRIANGLE
    idx: torch.Tensor   # [N] i32 — index within its primitive group
    t: torch.Tensor     # [N] f32


def _merge(best_t, kind, idx, tb, ib, k):
    better = tb < best_t
    return (torch.where(better, tb, best_t), torch.where(better, k, kind),
            torch.where(better, ib.to(torch.int32), idx))


def merge_triangles(base: Hit, tb, ib) -> Hit:
    """A tracer's triangle winners (tb, ib) merged into the dense search's
    sphere/plane hits `base`; strict <, so exact-t ties go to spheres and
    planes."""
    t, kind, idx = _merge(base.t, base.kind, base.idx, tb, ib, KIND_TRIANGLE)
    return Hit(kind=kind, idx=idx, t=t)


@torch.no_grad()
def dense_nearest(orig, direc, t_min: float, sph_c, sph_r, pl_p, pl_n,
                  tris=None) -> Hit:
    """Nearest hit over sphere (sph_c [Ns,3], sph_r [Ns]) and plane (pl_p,
    pl_n [Np,3]) tables and a triangle search: `tris` is None (no
    triangles) or a callable () → (best_t, best_i) per ray. The one dense
    search, over a scene (`nearest_hit`) or a shard's arrays
    (parallel/tracer.py)."""
    n = orig.shape[0]
    dev = orig.device
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    kind = torch.full((n,), KIND_NONE, dtype=torch.int32, device=dev)
    idx = torch.zeros((n,), dtype=torch.int32, device=dev)
    if sph_c.shape[0]:
        ts = geom.sphere_hits(orig, direc, sph_c, sph_r, t_min)
        tb, ib = torch.min(ts, dim=1)
        best_t, kind, idx = _merge(best_t, kind, idx, tb, ib, KIND_SPHERE)
    if pl_p.shape[0]:
        ts = geom.plane_hits(orig, direc, pl_p, pl_n, t_min)
        tb, ib = torch.min(ts, dim=1)
        best_t, kind, idx = _merge(best_t, kind, idx, tb, ib, KIND_PLANE)
    if tris is not None:
        tb, ib = tris()
        best_t, kind, idx = _merge(best_t, kind, idx, tb, ib, KIND_TRIANGLE)
    return Hit(kind=kind, idx=idx, t=best_t)


@torch.no_grad()
def dense_occluded(orig, direc, max_t, t_min: float, sph_c, sph_r, pl_p,
                   pl_n, tris=None):
    """Any hit with t in (t_min, max_t) over the tables of `dense_nearest`
    → bool [N]; `tris` is None or a callable () → the triangles' bool [N]
    any-hit."""
    occ = torch.zeros((orig.shape[0],), dtype=torch.bool, device=orig.device)
    if sph_c.shape[0]:
        ts = geom.sphere_hits(orig, direc, sph_c, sph_r, t_min)
        occ |= torch.any(ts < max_t[:, None], dim=1)
    if pl_p.shape[0]:
        ts = geom.plane_hits(orig, direc, pl_p, pl_n, t_min)
        occ |= torch.any(ts < max_t[:, None], dim=1)
    if tris is not None:
        occ |= tris()
    return occ


@torch.no_grad()
def nearest_hit(scene: Scene, orig, direc, t_min: float, tri_chunk: int,
                active=None) -> Hit:
    """Nearest hit over all groups (dense search). `active` is accepted for
    tracer-interface uniformity and ignored: dense search has no per-lane
    trip count to cut."""
    del active
    sp, pl, me = scene.spheres, scene.planes, scene.meshes
    tris = None
    if me.count:
        def tris():
            return _tri_nearest(orig, direc, *me.tri_soa(), t_min, tri_chunk)
    return dense_nearest(orig, direc, t_min, sp.center, sp.radius, pl.point,
                         pl.normal, tris)


@torch.no_grad()
def occluded(scene: Scene, orig, direc, max_t, t_min: float,
             tri_chunk: int, active=None):
    """Any-hit with t in (t_min, max_t) → bool [N]. Shadow-ray test (SPEC);
    tests all objects including transparent ones. `active` ignored (dense)."""
    del active
    sp, pl, me = scene.spheres, scene.planes, scene.meshes
    tris = None
    if me.count:
        def tris():
            return _tri_occluded(orig, direc, *me.tri_soa(), t_min, max_t,
                                 tri_chunk)
    return dense_occluded(orig, direc, max_t, t_min, sp.center, sp.radius,
                          pl.point, pl.normal, tris)


@dataclasses.dataclass
class Surface:
    """Surface properties of the winning hit (per ray)."""
    valid: torch.Tensor   # [N] bool
    t: torch.Tensor       # [N] f32
    p: torch.Tensor       # [N,3] hit point
    n: torch.Tensor       # [N,3] geometric/shading normal (unit, unflipped)
    albedo: torch.Tensor  # [N,3] effective diffuse color (checker applied)
    mtype: torch.Tensor   # [N] i32
    kd: torch.Tensor      # [N]
    ks: torch.Tensor      # [N]
    spec_n: torch.Tensor  # [N]
    ior: torch.Tensor     # [N]


def _checker(u, v, scale):
    fu = u * scale - torch.floor(u * scale)
    fv = v * scale - torch.floor(v * scale)
    return (fu > 0.5) ^ (fv > 0.5)


def surface_at(scene: Scene, orig, direc, hit: Hit, t_min: float) -> Surface:
    """Recompute t/normal/uv/material of the winner from the gathered
    primitive parameters (kind/idx are fixed integer inputs). The small
    sphere, plane and material tables are read through `pgather`/`tselect`;
    the mesh tables keep the native gather (their rows are many).

    A search may claim a hit whose recompute here misses (t = inf) on a
    knife-edge candidate: such a lane is demoted to a miss. Its recomputed
    t is replaced by 0 before anything is derived from it, so its point,
    normal and albedo stay finite: the forward masks them, and the
    backward's zero cotangents then meet no inf (0 · inf = NaN gradients at
    config3 1024² d4 otherwise)."""
    n_rays = orig.shape[0]
    dev = orig.device
    lost = torch.zeros((n_rays,), dtype=torch.bool, device=dev)

    def finite_t(tk, m):
        """A kind's recomputed t on its lanes `m`, 0 elsewhere and where
        the recompute missed (recorded in `lost`)."""
        nonlocal lost
        ok = torch.isfinite(tk)
        lost = lost | (m & ~ok)
        return torch.where(m & ok, tk, 0.0)

    t = torch.zeros((n_rays,), dtype=torch.float32, device=dev)
    nrm = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    mat_id = torch.zeros((n_rays,), dtype=torch.int32, device=dev)
    checker_mask = torch.zeros((n_rays,), dtype=torch.bool, device=dev)
    checker_albedo = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)

    if scene.spheres.count:
        sp = scene.spheres
        m = hit.kind == KIND_SPHERE
        i = torch.where(m, hit.idx, 0)
        # pgather = table[i] with a sort-free backward: these per-lane
        # gathers from few-row tables otherwise backward as an
        # index_put_ of every lane's cotangent (ops/dgather.py)
        c = pgather(sp.center, i)
        r = pgather(sp.radius, i)
        ts = finite_t(geom.sphere_t(orig, direc, c, r, t_min), m)
        p = orig + ts[:, None] * direc
        ns = safe_div(p - c, r[:, None], valid=torch.abs(r[:, None]) > 1e-12)
        t = torch.where(m, ts, t)
        nrm = torch.where(m[:, None], ns, nrm)
        mat_id = torch.where(m, tselect(sp.mat_id, i), mat_id)

    if scene.planes.count:
        pl = scene.planes
        m = hit.kind == KIND_PLANE
        i = torch.where(m, hit.idx, 0)
        p0 = pgather(pl.point, i)
        pn = pgather(pl.normal, i)
        tp = finite_t(geom.plane_t(orig, direc, p0, pn, t_min), m)
        p = orig + tp[:, None] * direc
        u = dot(p - p0, pgather(pl.tangent, i))
        v = dot(p - p0, pgather(pl.bitangent, i))
        pattern = _checker(u, v, pgather(pl.checker_scale, i))
        # SPEC: albedo_eff = c1 if pattern==0 else c2 — per-plane color pair
        # (material albedo, albedo2)
        pmat = tselect(pl.mat_id, i)
        calb = torch.where(pattern[:, None], pgather(pl.albedo2, i),
                           pgather(scene.materials.albedo, pmat))
        t = torch.where(m, tp, t)
        nrm = torch.where(m[:, None], pn, nrm)
        mat_id = torch.where(m, pmat, mat_id)
        is_checker = m & (tselect(pl.checker, i) > 0)
        checker_mask = checker_mask | is_checker
        checker_albedo = torch.where(is_checker[:, None], calb, checker_albedo)

    if scene.meshes.count:
        me = scene.meshes
        m = hit.kind == KIND_TRIANGLE
        i = torch.where(m, hit.idx, 0)
        tri = me.tris[i]
        v0 = me.verts[tri[:, 0]]
        e1 = me.verts[tri[:, 1]] - v0
        e2 = me.verts[tri[:, 2]] - v0
        tt, u, v = geom.triangle_tuv(orig, direc, v0, e1, e2, t_min)
        tt = finite_t(tt, m)
        if me.smooth:
            n0, n1, n2 = (me.normals[tri[:, k]] for k in range(3))
            nt = normalize((1.0 - u - v)[:, None] * n0 + u[:, None] * n1
                           + v[:, None] * n2)
        else:
            nt = normalize(cross(e1, e2))
        t = torch.where(m, tt, t)
        nrm = torch.where(m[:, None], nt, nrm)
        mat_id = torch.where(m, me.mat_id[i], mat_id)
        if me.has_uv:
            # barycentric st from the winner's vertex uvs (SPEC "Mesh UV");
            # the checker pattern is the plane formula on (s, t)
            st0, st1, st2 = (me.uvs[tri[:, k]] for k in range(3))
            st = ((1.0 - u - v)[:, None] * st0 + u[:, None] * st1
                  + v[:, None] * st2)
            pattern = _checker(st[:, 0], st[:, 1], me.checker_scale[i])
            is_chk = m & (me.checker[i] > 0)
            calb = torch.where(pattern[:, None], me.albedo2[i],
                               pgather(scene.materials.albedo, me.mat_id[i]))
            checker_mask = checker_mask | is_chk
            checker_albedo = torch.where(is_chk[:, None], calb, checker_albedo)

    valid = (hit.kind != KIND_NONE) & ~lost
    p = orig + t[:, None] * direc
    mats = scene.materials
    albedo = torch.where(checker_mask[:, None], checker_albedo,
                         pgather(mats.albedo, mat_id))
    return Surface(valid=valid, t=t, p=p, n=nrm, albedo=albedo,
                   mtype=tselect(mats.mtype, mat_id),
                   kd=pgather(mats.kd, mat_id), ks=pgather(mats.ks, mat_id),
                   spec_n=pgather(mats.spec_n, mat_id),
                   ior=pgather(mats.ior, mat_id))
