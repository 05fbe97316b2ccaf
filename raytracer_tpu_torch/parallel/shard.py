"""Multi-device rendering: pixel-tile data parallelism × primitive sharding
(counterpart of `raytracer_tpu/parallel/shard.py`).

`render_sharded` runs on every rank of an `RtMesh`:
- the image's rays split into equal blocks over 'tiles' (data parallel: no
  communication in the forward but the final all_gather of the image);
- the winner search shards the primitives over 'prims' through a
  ShardTracer (all_gather + min-combine) or a RingTracer (send/recv around
  the ring), or runs a replicated tracer (e.g. the grid) on every rank;
- the surface recompute and the shading read the replicated scene, so a
  loss of the gathered image backpropagates to every rank's scene the
  single-device gradient: each rank differentiates its own block, and the
  scene's gradients are summed over 'tiles' in the backward.
"""

import dataclasses

import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.types import Camera, RenderOptions, Scene
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops.safemath import clamp01
from raytracer_tpu_torch.parallel import tracer as tr
from raytracer_tpu_torch.parallel.mesh import RtMesh
from raytracer_tpu_torch.renderer import (_same_device, needs_grad,
                                          render_rays, use_compact)


def rank_lanes(n_pix: int, n_tiles: int) -> int:
    """Each tiles rank's share of the frame's pixels, rounded up to a
    multiple of 8 lanes: the one split of pixels over ranks."""
    return tr.ceil_to(-(-n_pix // n_tiles), 8)


def shard_layout(n_pix: int, n_tiles: int, tile_rays: int):
    """(per_dev, inner): each tiles rank's lanes (`rank_lanes` rounded up
    to a multiple of inner) and its wavefront tile width, as the reference
    lays them out."""
    per_dev = rank_lanes(n_pix, n_tiles)
    inner = min(tile_rays, per_dev)
    return tr.ceil_to(per_dev, inner), inner


def primary_dirs(camera: Camera, opts: RenderOptions, n_pad: int):
    """The frame's ray directions [n_pad, 3], pixel order, padded with −z
    rays."""
    dirs = geom.raygen(camera.c2w, camera.fov_deg, opts.width, opts.height)
    n_pix = dirs.shape[0]
    if n_pad != n_pix:
        dirs = torch.cat([dirs, dirs.new_tensor([[0.0, 0.0, -1.0]]).expand(
            n_pad - n_pix, 3)])
    return dirs


def build_sharded_accel(scene: Scene, n_prims: int, leaf_size: int = 8):
    """Host build of the per-shard BVH stack for `render_sharded(accel=…)`
    (a host or device scene), over the triangle split `pad_trace_geom`
    makes for `n_prims` ranks → `accel.bvh.build_stacked_bvh`'s dict (host
    arrays; each rank takes its own shard)."""
    g = tr.pad_trace_geom(tr.build_trace_geom(scene.to("cpu")), n_prims)
    return _stack(g, n_prims, leaf_size)


def _stack(g: tr.TraceGeom, n_prims: int, leaf_size: int = 8) -> dict:
    """`build_stacked_bvh` over a padded geometry's triangles (read back to
    the host)."""
    from raytracer_tpu_torch.accel.bvh import build_stacked_bvh

    return build_stacked_bvh(*(x.cpu().numpy() for x in (
        g.tri_v0, g.tri_e1, g.tri_e2)), n_prims, leaf_size=leaf_size)


def local_accel(stacked: dict, g: tr.TraceGeom, shard: int,
                device) -> tr.ShardBVH:
    """Shard `shard` of a stacked BVH on `device`, with the walk's table over
    the shard's geometry `g`."""
    from raytracer_tpu_torch.accel.bvh import stacked_shard
    from raytracer_tpu_torch.ops.bvh_walk import pack_bvh_table

    bvh = stacked_shard(stacked, shard, device)
    return tr.ShardBVH(bvh, pack_bvh_table(bvh, g.tri_v0, g.tri_e1,
                                           g.tri_e2))


def rank_tracer(scene: Scene, mesh: RtMesh, ring: bool = False, accel=None,
                *, device):
    """This rank's ShardTracer or RingTracer over its shard of the device
    scene's primitives. `accel`: None (dense search), "bvh" (build the
    per-shard BVHs here) or `build_sharded_accel`'s dict."""
    p = mesh.shape["prims"]
    g_full = tr.pad_trace_geom(tr.build_trace_geom(scene), p)
    sizes = tr.shard_sizes(g_full, p)
    g = g_full.shard(sizes, mesh.prim)
    if accel not in (None, "bvh") and not isinstance(accel, dict):
        raise ValueError(f"unknown accel {accel!r}")
    acc = None
    if accel is not None and sizes[2]:
        stacked = _stack(g_full, p) if accel == "bvh" else accel
        if stacked["tris_per_shard"] != sizes[2]:
            raise ValueError("the stacked BVH was built for another split")
        acc = local_accel(stacked, g, mesh.prim, device)
    cls = tr.RingTracer if ring else tr.ShardTracer
    return cls(g, mesh, sizes, accel=acc)


class _AllReduceGrad(torch.autograd.Function):
    """Identity in the forward; the backward sums the gradients of all the
    inputs over a group, in one all_reduce. Every rank of the group must
    run the backward."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.metas = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        flat = torch.cat([
            (g if g is not None else torch.zeros(s, dtype=dt, device=dev))
            .reshape(-1) for g, (s, dt, dev) in zip(grads, ctx.metas)])
        dist.all_reduce(flat, group=ctx.group)
        parts = flat.split([s.numel() for s, _, _ in ctx.metas])
        return (None, *(x.view(s) for x, (s, _, _) in zip(parts,
                                                           ctx.metas)))


class _GatherTiles(torch.autograd.Function):
    """All-gather of each tiles rank's [per_dev, C] block → [T·per_dev, C].
    The backward keeps this rank's block of the incoming gradient: every
    rank takes the same loss of the same gathered image, so the block is
    this rank's whole share (a reduce-scatter would count it T times)."""

    @staticmethod
    def forward(ctx, x, group, index):
        n = dist.get_world_size(group)
        ctx.rows = (index * x.shape[0], (index + 1) * x.shape[0])
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.detach().contiguous(),
                                    group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows[0]:ctx.rows[1]], None, None


def _flatten(obj):
    """Dataclass tree → (its non-dataclass fields in field order,
    rebuild(new leaves) → the same tree over them)."""
    leaves, parts = [], []
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        if dataclasses.is_dataclass(x):
            sub, rebuild_sub = _flatten(x)
            parts.append((f.name, len(sub), rebuild_sub))
            leaves += sub
        else:
            parts.append((f.name, 1, None))
            leaves.append(x)

    def rebuild(new):
        it = iter(new)
        kw = {}
        for name, n, rebuild_sub in parts:
            vals = [next(it) for _ in range(n)]
            kw[name] = rebuild_sub(vals) if rebuild_sub else vals[0]
        return dataclasses.replace(obj, **kw)

    return leaves, rebuild


def _sum_grads_over(group, *objs):
    """The scene/camera trees with every tensor that requires grad passed
    through one `_AllReduceGrad` over `group`."""
    def wanted(x):
        return isinstance(x, torch.Tensor) and x.requires_grad

    flats = [_flatten(obj) for obj in objs]
    outs = iter(_AllReduceGrad.apply(group, *(
        x for leaves, _ in flats for x in leaves if wanted(x))))
    return tuple(rebuild([next(outs) if wanted(x) else x for x in leaves])
                 for leaves, rebuild in flats)


def render_sharded(scene: Scene, camera: Camera, opts: RenderOptions,
                   mesh: RtMesh, ring: bool = False, count_rays: bool = False,
                   accel=None, tracer=None, *, device):
    """Full-image render on every rank of `mesh` → (image [H, W, 3] on
    `device`, rays_traced[, dropped]), the same on every rank.

    Each tiles rank renders its block of `per_dev` lanes (`shard_layout`)
    in wavefront tiles of `inner` rays through `renderer.render_rays`; the
    image is all-gathered over 'tiles'; `rays_traced` (and, with compaction
    on, the dropped-lane count) is summed over 'tiles' only, because the
    prims ranks of a tile trace the same lanes. `opts.remat_tiles` and
    `opts.tile_block` do not apply.

    The search: `tracer`, a replicated tracer on `device` (e.g.
    `accel.grid.GridTracer`: pure pixel-tile data parallelism, every rank
    builds it from the same scene), or else this rank's ShardTracer
    (RingTracer with `ring`) over its primitive shard, walking a per-shard
    BVH with `accel="bvh"` (or a prebuilt `build_sharded_accel` dict).

    Differentiable: `loss(image).backward()` on every rank gives every
    rank's scene and camera tensors the single-device gradient.
    """
    device = torch.device(device)
    if tracer is not None and not _same_device(tracer.device, device):
        raise ValueError(f"tracer lives on {tracer.device}, render asked for "
                         f"{device}")
    scene = scene.to(device)
    camera = camera.to(device)
    compact = use_compact(scene, opts)
    n_pix = opts.height * opts.width
    per_dev, inner = shard_layout(n_pix, mesh.shape["tiles"], opts.tile_rays)
    grad = needs_grad(scene, camera)
    if grad:
        scene, camera = _sum_grads_over(mesh.tiles_group, scene, camera)
    if tracer is None:
        tracer = rank_tracer(scene, mesh, ring, accel, device=device)
    lo = mesh.tile * per_dev
    traced = torch.zeros((), dtype=torch.float32, device=device)
    dropped = torch.zeros((), dtype=torch.float32, device=device)
    rads = []
    with torch.set_grad_enabled(grad):
        dirs = primary_dirs(camera, opts, per_dev * mesh.shape["tiles"])
        dirs = dirs[lo:lo + per_dev]
        orig = camera.pos[None, :].expand(inner, 3)
        for s in range(0, per_dev, inner):
            rad, inc, *drop = render_rays(scene, orig, dirs[s:s + inner],
                                          opts, count_rays, tracer=tracer)
            rads.append(rad)
            traced = traced + inc
            if compact:
                dropped = dropped + drop[0]
        full = _GatherTiles.apply(torch.cat(rads), mesh.tiles_group,
                                  mesh.tile)
    img = clamp01(full[:n_pix]).reshape(opts.height, opts.width, 3)
    counts = torch.stack([traced, dropped])
    dist.all_reduce(counts, group=mesh.tiles_group)
    if compact:
        return img, counts[0], counts[1]
    return img, counts[0]
