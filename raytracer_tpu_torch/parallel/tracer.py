"""Winner-search backends across ranks: primitive-sharded and ring
(counterpart of `raytracer_tpu/parallel/tracer.py`).

The winner search (integer results, outside autograd: ops/trace.py) is the
only stage that touches every primitive, so it is the only stage that
shards. The differentiable surface recompute gathers the winner from the
replicated scene, so gradients are the same under every tracer: the sharded
paths change where the search runs, not the math.

`TraceGeom` is the search-only SoA (triangles expanded to v0/e1/e2): what is
padded, split over the 'prims' ranks, or rotated around the ring. Padding
uses primitives that can never win. Local results are (t, kind, idx) with
shard-local ids; `_globalize` makes them ids into the padded full scene and
`_fold_hit` merges them in the single-device tie order: t, then sphere <
plane < triangle, then the lower id.
"""

import dataclasses

import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.types import (KIND_NONE, KIND_PLANE,
                                            KIND_SPHERE, KIND_TRIANGLE, Scene)
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops import trace as trace_ops

INF = geom.INF

_FIELDS = ("sph_c", "sph_r", "pl_p", "pl_n", "tri_v0", "tri_e1", "tri_e2")


@dataclasses.dataclass
class TraceGeom:
    """Search-only geometry SoA (detached tensors on one device)."""

    sph_c: torch.Tensor   # [Ns, 3]
    sph_r: torch.Tensor   # [Ns]
    pl_p: torch.Tensor    # [Np, 3]
    pl_n: torch.Tensor    # [Np, 3]
    tri_v0: torch.Tensor  # [T, 3]
    tri_e1: torch.Tensor  # [T, 3]
    tri_e2: torch.Tensor  # [T, 3]

    def tensors(self):
        return [getattr(self, f) for f in _FIELDS]

    def shard(self, sizes, s: int) -> "TraceGeom":
        """Shard `s` of a padded geometry, `sizes` = (spheres, planes,
        triangles) per shard."""
        ns, npl, nt = sizes
        return TraceGeom(*(x[s * n:(s + 1) * n] for x, n in zip(
            self.tensors(), (ns, ns, npl, npl, nt, nt, nt))))


def build_trace_geom(scene: Scene) -> TraceGeom:
    """The search geometry of a device scene (detached f32)."""
    sp, pl, me = scene.spheres, scene.planes, scene.meshes
    if me.count:
        v0, e1, e2 = me.tri_soa()
    else:
        v0 = e1 = e2 = torch.zeros((0, 3), dtype=torch.float32,
                                   device=sp.center.device)
    return TraceGeom(*(x.detach().to(torch.float32) for x in (
        sp.center, sp.radius, pl.point, pl.normal, v0, e1, e2)))


def ceil_to(x: int, m: int) -> int:
    """The least multiple of m that is ≥ x (x ≥ 0)."""
    return -(-x // m) * m


def pad_trace_geom(g: TraceGeom, p: int) -> TraceGeom:
    """Pad each group to a multiple of p shards with primitives that cannot
    win: radius −1 spheres (`sphere_t` masks r ≤ 0), zero-normal planes and
    zero-area triangles (always a miss)."""

    def pad(a, n, fill):
        extra = n - a.shape[0]
        if extra <= 0:
            return a
        return torch.cat([a, a.new_full((extra,) + tuple(a.shape[1:]),
                                        fill)])

    ns = ceil_to(g.sph_c.shape[0], p)
    npl = ceil_to(g.pl_p.shape[0], p)
    nt = ceil_to(g.tri_v0.shape[0], p)
    return TraceGeom(pad(g.sph_c, ns, 0.0), pad(g.sph_r, ns, -1.0),
                     pad(g.pl_p, npl, 0.0), pad(g.pl_n, npl, 0.0),
                     pad(g.tri_v0, nt, 0.0), pad(g.tri_e1, nt, 0.0),
                     pad(g.tri_e2, nt, 0.0))


def shard_sizes(g: TraceGeom, p: int):
    """(spheres, planes, triangles) per shard of a padded geometry."""
    return (g.sph_c.shape[0] // p, g.pl_p.shape[0] // p,
            g.tri_v0.shape[0] // p)


@dataclasses.dataclass
class ShardBVH:
    """A shard's BVH (`accel.bvh.stacked_shard`) and the walk's table over
    the shard's triangles (`ops.bvh_walk.pack_bvh_table`). Every shard of
    one `build_stacked_bvh` has tensors of the same shapes."""

    bvh: object
    table: object

    def tensors(self):
        b, t = self.bvh, self.table
        return [b.aabb6, b.links2, b.leaf_tris, t.nodes, t.minid, t.slots]

    def with_tensors(self, xs, g: TraceGeom) -> "ShardBVH":
        """The same trees' metadata over received tensors `xs` (in
        `tensors()` order) and the geometry `g` they arrived with."""
        aabb6, links2, leaf, nodes, minid, slots = xs
        return ShardBVH(
            dataclasses.replace(self.bvh, aabb6=aabb6, links2=links2,
                                leaf_tris=leaf),
            dataclasses.replace(self.table, soa=(g.tri_v0, g.tri_e1,
                                                 g.tri_e2),
                                nodes=nodes, minid=minid, slots=slots))


def _local_nearest(g: TraceGeom, orig, direc, t_min: float, tri_chunk: int,
                   accel: ShardBVH | None = None,
                   active=None) -> trace_ops.Hit:
    """Nearest hit over a TraceGeom → Hit with shard-local ids: the dense
    search, with the triangles walked through the shard's BVH when `accel`
    is given. `active` parks lanes of the BVH walk only."""
    tris = None
    if g.tri_v0.shape[0]:
        if accel is not None:
            def tris():
                from raytracer_tpu_torch.ops.bvh_walk import bvh_trace

                return bvh_trace(accel.bvh, accel.table, orig, direc, t_min,
                                 active=active)
        else:
            def tris():
                return trace_ops._tri_nearest(orig, direc, g.tri_v0,
                                              g.tri_e1, g.tri_e2, t_min,
                                              tri_chunk)
    return trace_ops.dense_nearest(orig, direc, t_min, g.sph_c, g.sph_r,
                                   g.pl_p, g.pl_n, tris)


def _local_occluded(g: TraceGeom, orig, direc, max_t, t_min: float,
                    tri_chunk: int, accel: ShardBVH | None = None,
                    active=None):
    """Any hit with t in (t_min, max_t) over a TraceGeom → bool [N]."""
    tris = None
    if g.tri_v0.shape[0]:
        if accel is not None:
            def tris():
                from raytracer_tpu_torch.ops.bvh_walk import bvh_trace

                tb, _ = bvh_trace(accel.bvh, accel.table, orig, direc, t_min,
                                  occlusion_max_t=max_t, active=active)
                return tb < max_t
        else:
            def tris():
                return trace_ops._tri_occluded(orig, direc, g.tri_v0,
                                               g.tri_e1, g.tri_e2, t_min,
                                               max_t, tri_chunk)
    return trace_ops.dense_occluded(orig, direc, max_t, t_min, g.sph_c,
                                    g.sph_r, g.pl_p, g.pl_n, tris)


def _globalize(hit: trace_ops.Hit, sizes, shard: int) -> trace_ops.Hit:
    """Shard-local ids → ids into the padded full scene."""
    off = torch.where(
        hit.kind == KIND_SPHERE, shard * sizes[0],
        torch.where(hit.kind == KIND_PLANE, shard * sizes[1],
                    torch.where(hit.kind == KIND_TRIANGLE, shard * sizes[2],
                                0)))
    return dataclasses.replace(hit, idx=hit.idx + off.to(torch.int32))


def _fold_hit(best: trace_ops.Hit, hit: trace_ops.Hit) -> trace_ops.Hit:
    """Lexicographic (t, kind, idx) min: the single-device tie order. Exact
    t ties across shards are real: a ray through a shared triangle edge (a
    wall quad's diagonal) meets both triangles at one t, and the two may
    sit in different shards."""
    tie = hit.t == best.t
    better = (hit.t < best.t) | (tie & ((hit.kind < best.kind)
                                        | ((hit.kind == best.kind)
                                           & (hit.idx < best.idx))))
    return trace_ops.Hit(kind=torch.where(better, hit.kind, best.kind),
                         idx=torch.where(better, hit.idx, best.idx),
                         t=torch.where(better, hit.t, best.t))


def _combine_gathered(t_all, kind_all, idx_all) -> trace_ops.Hit:
    """[P, N] partial hits → each ray's winner in (t, kind, idx) order."""
    best = trace_ops.Hit(kind=kind_all[0], idx=idx_all[0], t=t_all[0])
    for p in range(1, t_all.shape[0]):
        best = _fold_hit(best, trace_ops.Hit(kind=kind_all[p], idx=idx_all[p],
                                             t=t_all[p]))
    return best


def _miss(n: int, device) -> trace_ops.Hit:
    return trace_ops.Hit(
        kind=torch.full((n,), KIND_NONE, dtype=torch.int32, device=device),
        idx=torch.zeros((n,), dtype=torch.int32, device=device),
        t=torch.full((n,), INF, dtype=torch.float32, device=device))


class ShardTracer:
    """Primitive sharding: each rank searches its shard of the padded
    TraceGeom; the partial (t, kind, idx) are all-gathered over the prims
    group (one i32 gather, t carried as its bits) and min-combined."""

    # every rank of the prims group has to search each bounce together:
    # renderer.render_rays keeps the fixed depth for such a tracer
    collective_search = True

    def __init__(self, local_geom: TraceGeom, mesh, sizes,
                 accel: ShardBVH | None = None):
        self._g = local_geom
        self._mesh = mesh
        self._sizes = sizes  # (spheres, planes, triangles) per shard
        self._accel = accel
        self.device = local_geom.sph_c.device

    @torch.no_grad()
    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        p = self._mesh.shape["prims"]
        hit = _globalize(_local_nearest(self._g, orig, direc, t_min,
                                        tri_chunk, self._accel, active),
                         self._sizes, self._mesh.prim)
        n = orig.shape[0]
        mine = torch.stack([hit.t.view(torch.int32), hit.kind, hit.idx])
        out = mine.new_empty((p * 3, n))
        dist.all_gather_into_tensor(out, mine, group=self._mesh.prims_group)
        out = out.reshape(p, 3, n)
        return _combine_gathered(out[:, 0].contiguous().view(torch.float32),
                                 out[:, 1], out[:, 2])

    @torch.no_grad()
    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        occ = _local_occluded(self._g, orig, direc, max_t, t_min, tri_chunk,
                              self._accel, active).to(torch.int32)
        dist.all_reduce(occ, group=self._mesh.prims_group)
        return occ > 0


class RingTracer:
    """Ring primitive streaming: the rays stay; each rank's shard (and its
    BVH tables) travels around the prims ring, one step per shard, and a
    running min-hit folds each step's result. Only one shard is resident at
    a time, for scenes larger than one device's memory."""

    collective_search = True  # as ShardTracer's

    def __init__(self, local_geom: TraceGeom, mesh, sizes,
                 accel: ShardBVH | None = None):
        self._g = local_geom
        self._mesh = mesh
        self._sizes = sizes
        self._accel = accel
        self.device = local_geom.sph_c.device
        p, me, grp = mesh.shape["prims"], mesh.prim, mesh.prims_group
        self._next = dist.get_global_rank(grp, (me + 1) % p)
        self._prev = dist.get_global_rank(grp, (me - 1) % p)

    def _rotate(self, g: TraceGeom, accel: ShardBVH | None):
        """Send (g, accel) to the next rank, receive the previous rank's."""
        xs = g.tensors() + (accel.tensors() if accel is not None else [])
        recv = [torch.empty_like(x) for x in xs]
        grp = self._mesh.prims_group
        ops = []
        for x, r in zip(xs, recv):
            if x.numel():  # every shard has the same shapes
                ops.append(dist.P2POp(dist.isend, x.contiguous(), self._next,
                                      grp))
                ops.append(dist.P2POp(dist.irecv, r, self._prev, grp))
        for w in dist.batch_isend_irecv(ops) if ops else ():
            w.wait()
        g2 = TraceGeom(*recv[:len(_FIELDS)])
        acc2 = (accel.with_tensors(recv[len(_FIELDS):], g2)
                if accel is not None else None)
        return g2, acc2

    @torch.no_grad()
    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        p, me = self._mesh.shape["prims"], self._mesh.prim
        g, accel = self._g, self._accel
        best = _miss(orig.shape[0], orig.device)
        for step in range(p):
            owner = (me - step) % p  # whose shard this rank holds now
            hit = _local_nearest(g, orig, direc, t_min, tri_chunk, accel,
                                 active)
            best = _fold_hit(best, _globalize(hit, self._sizes, owner))
            if step + 1 < p:
                g, accel = self._rotate(g, accel)
        return best

    @torch.no_grad()
    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        p = self._mesh.shape["prims"]
        g, accel = self._g, self._accel
        occ = torch.zeros((orig.shape[0],), dtype=torch.bool,
                          device=orig.device)
        for step in range(p):
            occ |= _local_occluded(g, orig, direc, max_t, t_min, tri_chunk,
                                   accel, active)
            if step + 1 < p:
                g, accel = self._rotate(g, accel)
        return occ
