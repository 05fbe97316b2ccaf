"""Wavefront Whitted renderer (counterpart of `raytracer_tpu/renderer.py`).

The recursive `castRay` becomes a loop over bounce depth carrying per-ray
state (origin, dir, throughput, alive); radiance accumulates as
Σ_depth throughput · leaf_value (docs/SPEC.md "Wavefront equivalence").

Glass scenes double the ray buffer per bounce ([reflect | refract] children
concatenated); the pixel of buffer slot i is `i mod n_pixels`, so folding a
[k·n0, 3] buffer back to pixels is a reshape + sum.

Compacted wavefronts (`opts.compact_cap`, `use_compact`): once a bounce's
buffer is wider than the cap (cap·tile lanes, 8-lane aligned), its lanes are
partitioned alive-first (stable, two prefix sums) and only the first `cap`
are kept; `dropped` counts alive lanes that did not fit (0 ⇒ exact). Each
kept lane carries its slot in the uncompacted buffer, so the fold writes
every lane back to that slot (unique slots, no atomics) and sums the same
[k, n0, 3] buffer as the uncompacted wavefront: the compacted image is the
uncompacted one bit for bit when nothing is dropped, and reruns are equal.

The image is processed in tiles of `opts.tile_rays` primary rays, one after
another, which bounds device memory at any resolution. With
`opts.tile_block` the tiles are screen blocks instead of row-major runs, so
neighbouring lanes of a walk are neighbouring pixels.

Gradients: the winner searches run under `torch.no_grad()` on detached
rays and return integers; everything else is ordinary torch, so autograd
differentiates the surface recompute and the shading. A render whose scene
and camera hold no tensor that requires grad builds no graph. When one does,
`opts.remat_tiles` recomputes each tile in the backward instead of keeping
its activations: `remat_policy="plan"` records the tile's plan (the winner
ids and shadow bits) once under `no_grad` and checkpoints only the shading
replay of that plan, so the backward never re-runs a search; `"full"`
checkpoints the whole tile, searches included.

The bounce loop ends at the first child wavefront with no live lane: after
each bounce that spawns children it reads one bool back from the device
(`rt.alive`). A bounce with no live lane adds exactly zero to every
radiance, ray count and gradient, so the result is the fixed-depth loop's
bit for bit. Three loops read nothing and keep their depth: a plan replay
(`ops/replay.PlanTracer`) runs the bounces its plan holds, a tracer whose
searches are collectives (`collective_search`, `parallel/tracer.py`)
runs every bounce on every rank, and `render(record_plan=True)` records
every bounce's planes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from raytracer_tpu_torch.core.types import (DIFFUSE_AND_GLOSSY, KIND_PLANE,
                                            KIND_SPHERE, KIND_TRIANGLE,
                                            REFLECTION,
                                            REFLECTION_AND_REFRACTION, Camera,
                                            RenderOptions, Scene)
from raytracer_tpu_torch.ops import bounce_shade as BS
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops.dgather import permute_take
from raytracer_tpu_torch.ops.safemath import clamp01, normalize
from raytracer_tpu_torch.ops.shade import (check_plan_lights, shade_diffuse,
                                           shadow_search)
from raytracer_tpu_torch.ops.trace import nearest_hit, surface_at
from raytracer_tpu_torch.utils.profiling import (count_compaction,
                                                 count_lanes, counting, span)

_REMAT_POLICIES = ("plan", "full")


def use_compact(scene: Scene, opts: RenderOptions) -> bool:
    """Does this (scene, opts) pair run compacted wavefronts? Glass scenes
    compact to stop the per-bounce buffer doubling; fractional caps (< 1)
    also compact single-child (mirror) wavefronts."""
    return opts.compact_cap is not None and (scene.has_glass
                                             or opts.compact_cap < 1)


def _cap_lanes(cap: float, n0: int) -> int:
    """Lane budget of a compacted wavefront of `n0` primary rays (8-lane
    aligned)."""
    return max(8, _ceil_to(int(round(cap * n0)), 8))


def _fold(x, n0, slot=None, n_slots=0):
    """[w, C] buffer → per-pixel [n0, C] by summing each pixel's child
    slots. Uncompacted (`slot` None) lane i is slot i of a [k·n0] buffer;
    compacted lane i sits at slot `slot[i]` of the `n_slots`-wide
    uncompacted buffer, and is written back there first (slots are unique:
    no atomics, the same sum in the same order). A fold by slot is the
    span `rt.fold`."""
    if slot is None:
        return x.reshape(-1, n0, x.shape[-1]).sum(dim=0)
    with span("rt.fold"):
        return _fold(x.new_zeros((n_slots, x.shape[-1])).index_put((slot,), x),
                     n0)


def partition(alive, cap: int):
    """The stable alive-first permutation of a wavefront, cut to `cap`
    lanes: two prefix sums and one scatter of lane ids to unique slots, no
    sort and no host sync → (order [cap], pos [n], kept [cap], dropped):
    lane order[j] goes to slot j, lane i to slot pos[i]; kept marks slots
    that hold an alive lane; dropped (0-dim f32) counts alive lanes past the
    cap."""
    n = alive.shape[0]
    ai = alive.to(torch.int32)
    c_alive = torch.cumsum(ai, 0, dtype=torch.int32)
    n_alive = c_alive[-1]
    pos = torch.where(alive, c_alive - 1,
                      n_alive + torch.cumsum(1 - ai, 0, dtype=torch.int32) - 1)
    order = torch.empty_like(pos).index_put_(
        (pos,), torch.arange(n, dtype=torch.int32, device=alive.device))
    order = order[:cap]
    kept = torch.arange(cap, device=alive.device) < n_alive
    dropped = torch.clamp(n_alive - cap, min=0).to(torch.float32)
    return order, pos, kept, dropped


def _compact(state, slot, cap: int):
    """Keep the first `cap` lanes of the alive-first partition → (state',
    slot', dropped)."""
    o, d, thr, alive = state
    order, pos, kept, dropped = partition(alive, cap)
    return ((permute_take(o, order, pos), permute_take(d, order, pos),
             permute_take(thr, order, pos), kept), slot[order], dropped)


def _plan_win(scene: Scene, hit, alive):
    """A bounce's plan plane: the fused-prim winner index [N] i32 (spheres,
    then planes, then triangles; −1 = miss or dead lane), the encoding that
    ops/replay.PlanTracer decodes."""
    ns, npl = scene.spheres.count, scene.planes.count
    win = torch.where(
        hit.kind == KIND_SPHERE, hit.idx,
        torch.where(hit.kind == KIND_PLANE, hit.idx + ns,
                    torch.where(hit.kind == KIND_TRIANGLE,
                                hit.idx + ns + npl, -1)))
    return torch.where(alive, win, -1).to(torch.int32)


def bounce_step(scene: Scene, state, opts: RenderOptions, n0: int,
                is_last: bool, count_rays: bool = False, tracer=None,
                plan_out: list | None = None, slot=None, n_slots: int = 0,
                depth: int = 0, radiance=None):
    """One wavefront bounce: trace + shade + spawn children.

    `state` = (o, d, thr, alive) ray buffers on one device. Returns (terms,
    new_state, traced_inc): `terms` are the per-pixel [n0,3] radiance
    contributions of this bounce in accumulation order; `new_state` is the
    child wavefront (None when `is_last`); `traced_inc` counts live trace
    lanes (a 0-dim f32 tensor; 0 unless `count_rays`). `plan_out` (a list)
    receives this bounce's plan node: (winner plane, occlusion bitmask
    plane), each [len(o)] i32.

    Compacted wavefronts pass `slot` [len(o)] i32, each lane's slot in this
    bounce's uncompacted buffer of `n_slots` lanes: terms fold by slot
    (each fold the span `rt.fold`, on the torch and the K6 path alike), and
    `new_state` gains a 5th element, the children's slots.

    On a CUDA device a bounce that autograd does not record shades through
    K6 (`_fused_bounce`), bit for bit what the torch ops below compute.
    There `radiance` [n0,3], the caller's accumulator, takes the terms in
    place when the lanes are the pixels (no `slot`, `n0` lanes), and
    `terms` is then empty.

    While a profiler records, the bounce's live search lanes are counted
    under `depth` (utils/profiling.count_lanes).
    """
    fused = BS.fused_shading(scene, state, radiance)
    if fused:
        state = (*(x.contiguous() for x in state[:3]), state[3])
    o, d, thr, alive = state
    # `active=alive` lets walk-based tracers park dead lanes before step 0
    # instead of walking their zero-normal "reflections"
    with torch.no_grad(), span("rt.search"):
        od, dd = o.detach(), d.detach()
        if tracer is None:
            hit = nearest_hit(scene, od, dd, opts.t_min, opts.tri_chunk,
                              active=alive)
        else:
            hit = tracer.nearest(od, dd, opts.t_min, opts.tri_chunk,
                                 active=alive)
    if fused:
        return _fused_bounce(scene, state, hit, opts, n0, is_last,
                             count_rays, tracer, plan_out, slot, n_slots,
                             depth, radiance)
    bg = torch.tensor(opts.background, dtype=torch.float32, device=o.device)
    occ_out = None
    if plan_out is not None:
        win = _plan_win(scene, hit, alive)
        occ_out = []
    with span("rt.surface"):
        surf = surface_at(scene, o, d, hit, opts.t_min)
    valid = surf.valid & alive

    # leaves: miss → background
    miss = alive & ~surf.valid
    terms = [_fold(torch.where(miss[:, None], thr * bg, 0.0), n0, slot,
                   n_slots)]

    # leaves: diffuse hit → local Phong (branchless; masked after)
    is_diff = valid & (surf.mtype == DIFFUSE_AND_GLOSSY)
    with span("rt.shade"):
        local, searched = shade_diffuse(scene, surf, d, opts.bias,
                                        opts.t_min, opts.tri_chunk,
                                        tracer=tracer, active=is_diff,
                                        occ_out=occ_out)
    if plan_out is not None:
        plan_out.append((win, occ_out[0]))
    terms.append(_fold(torch.where(is_diff[:, None], thr * local, 0.0), n0,
                       slot, n_slots))
    traced_inc = _count(scene, alive, searched, is_diff, count_rays, depth)

    # specular branches
    is_mirror = valid & (surf.mtype == REFLECTION)
    is_glass = valid & (surf.mtype == REFLECTION_AND_REFRACTION)
    spec = is_mirror | is_glass
    kr = geom.fresnel(d, surf.n, surf.ior)

    if is_last:
        # children would exceed max_depth → each returns background
        # immediately: mirror contributes kr·bg, glass kr·bg + (1−kr)·bg
        # (kr==1 exactly on TIR, so glass always totals 1·bg)
        w = torch.where(is_mirror, kr,
                        is_glass.to(torch.float32))
        terms.append(_fold(thr * w[:, None] * bg, n0, slot, n_slots))
        return terms, None, traced_inc

    with span("rt.spawn"):
        return _spawn(scene, state, surf, spec, is_glass, kr, terms,
                      traced_inc, opts, slot, n_slots)


def _count(scene, alive, searched, is_diff, count_rays, depth):
    """The bounce's traced rays (0-dim f32; 0 unless `count_rays`) and,
    while a profiler records, its live search lanes (`count_lanes`)."""
    traced_inc = torch.zeros((), dtype=torch.float32, device=alive.device)
    if count_rays or counting():
        # one sum for both counts: the traced rays (alive lanes, and each
        # diffuse hit once a light) and each search's live lanes
        with span("rt.count"):
            lanes = torch.stack([alive, *searched, is_diff]).sum(dim=1)
            if count_rays:
                traced_inc = (lanes[0] + lanes[-1] * scene.lights.count).to(
                    torch.float32)
            count_lanes(depth, lanes[:-1], alive.shape[0])
    return traced_inc


def _fused_bounce(scene, state, hit, opts, n0, is_last, count_rays, tracer,
                  plan_out, slot, n_slots, depth, radiance):
    """`bounce_step` after its search, through K6 (ops/bounce_shade): the
    surface and the shadow set-up in one launch, the shadow searches as
    the torch bounce makes them (one tracer call a light, in light order,
    the same rays and masks), then the shading, the children and the plan
    planes in a second launch. Same returns, bit for bit."""
    o, d, thr, alive = state
    if plan_out is not None:
        check_plan_lights(scene)
    tables = BS.scene_tables(scene, o.device)
    with span("rt.surface"):
        sorig, ldir, dist, oactive, is_diff = BS.surface_cuda(
            tables, o, d, alive, hit, opts)
    searched = list(oactive)
    direct = slot is None and o.shape[0] == n0 and radiance is not None
    with span("rt.shade"):
        shadowed = [shadow_search(scene, tracer, sorig, ldir[li], dist[li],
                                  opts.t_min, opts.tri_chunk, searched[li])
                    for li in range(scene.lights.count)]
        shadowed = (torch.stack(shadowed) if shadowed else
                    oactive.new_zeros(oactive.shape))
        with span("rt.shade.fused"):
            terms, children, planes = BS.shade_cuda(
                tables, o, d, thr, alive, hit, shadowed, opts,
                is_last=is_last, glass=scene.has_glass,
                radiance=radiance if direct else None,
                plan=plan_out is not None)
    if plan_out is not None:
        plan_out.append(planes)
    terms = [] if direct else [_fold(t, n0, slot, n_slots) for t in terms]
    traced_inc = _count(scene, alive, searched, is_diff, count_rays, depth)
    if is_last:
        return terms, None, traced_inc
    if slot is not None:  # child c of slot s: slot s + c·n_slots
        children += ((torch.cat([slot, slot + n_slots]) if scene.has_glass
                      else slot),)
    return terms, children, traced_inc


def _spawn(scene, state, surf, spec, is_glass, kr, terms, traced_inc, opts,
           slot, n_slots):
    o, d, thr, alive = state
    rdir = normalize(geom.reflect(d, surf.n))
    rorig = geom.spawn_origin(surf.p, surf.n, rdir, opts.bias)
    thr_r = torch.where(spec[:, None], thr * kr[:, None], 0.0)
    if scene.has_glass:
        tdir, t_ok = geom.refract(d, surf.n, surf.ior)
        tdir = normalize(tdir, valid=t_ok)
        torig = geom.spawn_origin(surf.p, surf.n, tdir, opts.bias)
        alive_t = is_glass & t_ok
        thr_t = torch.where(alive_t[:, None], thr * (1.0 - kr[:, None]), 0.0)
        new_state = (torch.cat([rorig, torig]), torch.cat([rdir, tdir]),
                     torch.cat([thr_r, thr_t]), torch.cat([spec, alive_t]))
        if slot is not None:  # child c of slot s: slot s + c·n_slots
            new_state += (torch.cat([slot, slot + n_slots]),)
    else:
        new_state = (rorig, rdir, thr_r, spec)
        if slot is not None:
            new_state += (slot,)
    return terms, new_state, traced_inc


def render_rays(scene: Scene, orig, direc, opts: RenderOptions,
                count_rays: bool = False, tracer=None,
                record_plan: bool = False, *, every_bounce: bool = False):
    """Trace a wavefront of primary rays to radiance [N,3] (unclamped).

    `scene` is a device scene (`Scene.to`) on the rays' device; `tracer`
    overrides the winner-search backend (accel.grid.GridTracer, or a
    replayed plan: ops/replay.PlanTracer). Returns (radiance, rays_traced)
    where rays_traced counts every live trace lane (primary + secondary +
    shadow) — the rays/s numerator. `record_plan=True` appends the plan,
    one plane per bounce in lane order: (radiance, traced, wins, occs). On a
    glass scene bounce b's planes are 2^b·N wide (the doubled buffer), or
    as wide as the compacted wavefront. With compaction on
    (`use_compact`), `dropped` (0-dim f32: alive lanes lost to the cap)
    comes last: (radiance, traced[, wins, occs], dropped).

    Only a buffer's static width decides whether a bounce compacts. The
    first compaction numbers the lanes by their uncompacted slots; before
    it slot i is lane i. Each compaction is the span `rt.compact`; while a
    profiler records it also counts, under the depth of the bounce that
    runs the compacted wavefront, the live lanes kept, the cap and the
    live lanes dropped (`utils/profiling.count_compaction`), and every
    later bounce folds its terms by slot (`rt.fold`).

    After each bounce that spawns children the loop reads back whether the
    child wavefront (compacted, if the bounce compacted) holds a live lane,
    and ends if it holds none: the plan then holds only the bounces that
    ran. It reads nothing and keeps its depth for a plan replay (a tracer
    with `bounces`: it runs as many bounces as the plan holds), for a
    tracer whose searches are collectives (`collective_search`: a rank that
    stopped alone would leave its peers waiting), and with `every_bounce`
    (`render(record_plan=True)`: a dead bounce's occlusion plane holds what
    the sphere and plane tests found on its dead lanes' rays, which only
    running it gives).
    """
    if getattr(tracer, "per_trace_cursor", False):
        # depth-aware tracers (accel.cull.CullTracer) map their call counter
        # to bounce depths: a fresh counter per call keeps the mapping right
        # across tiles and in a remat recompute
        tracer = tracer.fresh()
    n0 = orig.shape[0]
    dev = orig.device
    radiance = torch.zeros((n0, 3), dtype=torch.float32, device=dev)
    state = (orig, direc, torch.ones((n0, 3), dtype=torch.float32, device=dev),
             torch.ones((n0,), dtype=torch.bool, device=dev))
    traced = torch.zeros((), dtype=torch.float32, device=dev)
    plan = [] if record_plan else None
    compact = use_compact(scene, opts)
    cap = _cap_lanes(opts.compact_cap, n0) if compact else 0
    dropped = torch.zeros((), dtype=torch.float32, device=dev)
    slot, n_slots = None, n0
    n_bounces = min(opts.max_depth + 1,
                    getattr(tracer, "bounces", opts.max_depth + 1))
    read_alive = not (every_bounce or hasattr(tracer, "bounces")
                      or getattr(tracer, "collective_search", False))
    for depth in range(n_bounces):
        # the bounce's own time: the folds and the radiance sums
        with span(f"rt.bounce.{depth}"):
            terms, state, inc = bounce_step(
                scene, state, opts, n0, is_last=depth == opts.max_depth,
                count_rays=count_rays, tracer=tracer, plan_out=plan,
                slot=slot, n_slots=n_slots, depth=depth, radiance=radiance)
            for t in terms:
                radiance = radiance + t
            traced = traced + inc
        if state is None:
            break
        if slot is not None:
            *state, slot = state
        if scene.has_glass:
            n_slots *= 2
        if compact and state[0].shape[0] > cap:
            if slot is None:
                slot = torch.arange(state[0].shape[0], dtype=torch.int32,
                                    device=dev)
            with span("rt.compact"):
                state, slot, drop = _compact(tuple(state), slot, cap)
                count_compaction(depth + 1, state[3], cap, drop)
            dropped = dropped + drop
        state = tuple(state)
        if read_alive:
            with span("rt.alive"):
                if not bool(state[3].any()):
                    break
    out = (radiance, traced)
    if record_plan:
        out += (tuple(w for w, _ in plan), tuple(o for _, o in plan))
    return out + (dropped,) if compact else out


def needs_grad(*objs) -> bool:
    """Is autograd on, and does any tensor leaf of these scenes/cameras
    require grad?"""
    if not torch.is_grad_enabled():
        return False
    for obj in objs:
        for f in dataclasses.fields(obj):
            x = getattr(obj, f.name)
            if dataclasses.is_dataclass(x):
                if needs_grad(x):
                    return True
            elif isinstance(x, torch.Tensor) and x.requires_grad:
                return True
    return False


def _plan_remat_tile(scene, orig, direc, opts, count_rays, tracer):
    """One tile under the "plan" policy → render_rays' (radiance, traced[,
    dropped]): the searches run once, under no_grad, recording the tile's
    plan; autograd sees only the checkpointed shading replay of that plan.
    The replay's PlanTracer is built inside the checkpointed function, so
    the backward's recompute gets fresh cursors. A compacted tile's planes
    are in its compacted lane order; the replay recomputes the same alive
    masks from the same values, hence the same compaction. The record ends
    where the tile's lanes die, and the replay runs the bounces it
    recorded, reading nothing back."""
    from raytracer_tpu_torch.ops.replay import PlanTracer

    with torch.no_grad(), span("rt.record"):
        _, traced, wins, occs, *drop = render_rays(
            scene, orig, direc, opts, count_rays, tracer=tracer,
            record_plan=True)
    ns, npl = scene.spheres.count, scene.planes.count

    def replay(o, d):  # the forward, and the backward's recompute
        with span("rt.replay"):
            return render_rays(scene, o, d, opts,
                               tracer=PlanTracer(wins, occs, ns, npl))[0]

    return (checkpoint(replay, orig, direc, use_reentrant=False), traced,
            *drop)


def render_tile(scene, orig, direc, opts, count_rays, tracer, remat):
    """`render_rays` of one tile, under `opts.remat_policy` when `remat`."""
    if not remat:
        return render_rays(scene, orig, direc, opts, count_rays,
                           tracer=tracer)
    if opts.remat_policy == "plan":
        return _plan_remat_tile(scene, orig, direc, opts, count_rays, tracer)
    return checkpoint(render_rays, scene, orig, direc, opts, count_rays,
                      tracer, use_reentrant=False)


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def block_perm(rows: int, width: int, bh: int, bw: int):
    """Screen-block tile permutation → (perm [n_pad], inv [rows·width]) np.

    perm[i] = source pixel of permuted lane i (row-major within bh×bw
    blocks, blocks row-major over a ceil-padded block grid); out-of-frame
    lanes point at index rows·width (an appended dummy dir). inv gathers the
    flat radiance back to pixel order: rad_px = rad_flat[inv]."""
    brows, bcols = -(-rows // bh), -(-width // bw)
    r = (np.arange(brows)[:, None] * bh
         + np.arange(bh)[None, :])                       # [brows, bh]
    c = (np.arange(bcols)[:, None] * bw
         + np.arange(bw)[None, :])                       # [bcols, bw]
    rr = r[:, None, :, None]
    cc = c[None, :, None, :]
    perm = np.where((rr < rows) & (cc < width), rr * width + cc,
                    rows * width).reshape(-1).astype(np.int32)
    valid = perm < rows * width
    inv = np.empty((rows * width,), np.int32)
    inv[perm[valid]] = np.arange(perm.shape[0], dtype=np.int32)[valid]
    return perm, inv


def _same_device(a, b) -> bool:
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def tile_dirs(camera: Camera, opts: RenderOptions, row0: int, rows: int,
              blocks: bool = True):
    """The band's primary directions in `render`'s tile order → (dirs
    [n_pad, 3], inv_order [rows·W] or None, tile, n_pix), on the device of
    `camera` (a device camera). Tiles are `tile` consecutive lanes: screen
    blocks when `blocks` and `opts.tile_block` matches the tile exactly
    (`inv_order` gathers lanes back to pixel order), else pixel-order runs;
    padding lanes take the direction (0, 0, -1)."""
    w = opts.width
    n_pix = rows * w
    device = camera.c2w.device
    dirs = geom.raygen(camera.c2w, camera.fov_deg, w, opts.height, row0=row0,
                       rows=rows)
    tile = min(opts.tile_rays, _ceil_to(n_pix, 8))
    # block order engages only when the block matches the tile exactly;
    # otherwise flat tiles (identical images either way)
    block = (opts.tile_block if blocks and opts.tile_block is not None
             and n_pix > tile
             and opts.tile_block[0] * opts.tile_block[1] == tile else None)
    inv_order = None
    dummy = torch.tensor([[0.0, 0.0, -1.0]], dtype=torch.float32,
                         device=device)
    if block is not None:
        perm, inv = block_perm(rows, w, *block)
        dirs = torch.cat([dirs, dummy])[torch.from_numpy(perm).to(device)]
        inv_order = torch.from_numpy(inv).to(device)
    else:
        n_pad = _ceil_to(n_pix, tile)
        if n_pad != n_pix:
            dirs = torch.cat([dirs, dummy.expand(n_pad - n_pix, 3)])
    return dirs, inv_order, tile, n_pix


def render(scene: Scene, camera: Camera, opts: RenderOptions, *, device,
           count_rays: bool = False, tracer=None, row0: int = 0,
           rows: int | None = None, record_plan: bool = False):
    """Render → (image [rows,W,3] f32 in [0,1] on `device`, rays_traced).

    `scene` and `camera` may be host (numpy) or already on `device`; the
    tracer (if any) must have been built for `device`. `row0`/`rows` render
    a horizontal band of the full-image projection (defaults: whole image).
    Differentiable in the scene's and camera's tensors that require grad
    (see the module docstring for `opts.remat_tiles`/`remat_policy`).

    `record_plan=True` appends the band's plan: per bounce, the winner
    plane and the occlusion bitmask plane, each [rows·W] i32 in pixel order
    → (img, traced, wins, occs). Scenes whose planes would not be per pixel
    raise ValueError: glass (the buffer doubles per bounce) and compacted
    wavefronts (lanes are permuted).

    With compaction on (`use_compact`) → (img, traced, dropped): `dropped`
    (0-dim f32 on `device`) counts alive lanes lost to the cap, 0 when the
    image is exact. Several tiles are then strided (slot j of tile k is
    pixel j·ntiles + k) so that every tile samples the whole band, and
    `opts.tile_block` is not used.
    """
    if record_plan and scene.has_glass:
        raise ValueError("record_plan on a glass scene: uncompacted glass "
                         "planes would not be per pixel")
    if record_plan and opts.compact_cap is not None:
        raise ValueError("record_plan with compact_cap: compacted planes "
                         "are in permuted lane order, not per pixel")
    if opts.remat_policy not in _REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {_REMAT_POLICIES}, "
                         f"got {opts.remat_policy!r}")
    device = torch.device(device)
    if tracer is not None and not _same_device(tracer.device, device):
        raise ValueError(f"tracer lives on {tracer.device}, render asked for "
                         f"{device}")
    scene = scene.to(device)
    camera = camera.to(device)
    h, w = opts.height, opts.width
    rows = h if rows is None else rows
    compact = use_compact(scene, opts)
    dirs, inv_order, tile, n_pix = tile_dirs(camera, opts, row0, rows,
                                             blocks=not compact)
    ntiles = dirs.shape[0] // tile
    strided = compact and ntiles > 1
    if strided:  # tile k holds pixels k, k + ntiles, k + 2·ntiles, …
        dirs = dirs.reshape(tile, ntiles, 3).transpose(0, 1).reshape(-1, 3)
    orig = camera.pos[None, :].expand(tile, 3)
    grad = needs_grad(scene, camera)
    remat = opts.remat_tiles and not record_plan and grad

    rads, wins, occs = [], [], []
    traced = torch.zeros((), dtype=torch.float32, device=device)
    dropped = torch.zeros((), dtype=torch.float32, device=device)
    # with nothing to differentiate, autograd's per-op bookkeeping is off
    with torch.set_grad_enabled(grad):
        for s in range(0, dirs.shape[0], tile):
            if record_plan:
                rad, inc, w_t, o_t = render_rays(
                    scene, orig, dirs[s:s + tile], opts, count_rays,
                    tracer=tracer, record_plan=True, every_bounce=True)
                wins.append(w_t)
                occs.append(o_t)
            else:
                rad, inc, *drop = render_tile(
                    scene, orig, dirs[s:s + tile], opts, count_rays, tracer,
                    remat)
                if compact:
                    dropped = dropped + drop[0]
            rads.append(rad)
            traced = traced + inc
    rad = torch.cat(rads)
    if strided:  # back to pixel order
        rad = rad.reshape(ntiles, tile, 3).transpose(0, 1).reshape(-1, 3)
    if inv_order is not None:
        rad = rad[inv_order]  # block order → pixel order
    img = clamp01(rad[:n_pix]).reshape(rows, w, 3)
    if compact:
        return img, traced, dropped
    if not record_plan:
        return img, traced

    def pixel_order(planes):  # per tile → [n_pix] in pixel order
        x = torch.cat(planes)
        if inv_order is not None:
            x = x[inv_order]
        return x[:n_pix]

    n_bounces = opts.max_depth + 1
    return (img, traced,
            tuple(pixel_order([t[b] for t in wins]) for b in range(n_bounces)),
            tuple(pixel_order([t[b] for t in occs]) for b in range(n_bounces)))


def render_banded(scene: Scene, camera: Camera, opts: RenderOptions, *,
                  device, tracer=None, count_rays: bool = False,
                  band_rows: int | None = None):
    """Full-frame render as a sequence of horizontal bands.

    Same output as `render` (bands are slices of the full-frame projection).
    On the card a band bounds nothing that the tiles do not already bound,
    so the default is one band of the whole frame. With compaction on →
    (img, traced, dropped), `dropped` summed over the bands.
    """
    with span("rt.frame"):
        band_rows = opts.height if band_rows is None else min(band_rows,
                                                              opts.height)
        device = torch.device(device)
        scene = scene.to(device)
        camera = camera.to(device)
        imgs = []
        sums = None
        for r0 in range(0, opts.height, band_rows):
            rb = min(band_rows, opts.height - r0)
            img, *counts = render(scene, camera, opts, device=device,
                                  count_rays=count_rays, tracer=tracer,
                                  row0=r0, rows=rb)
            imgs.append(img)
            sums = counts if sums is None else [a + b for a, b in zip(sums,
                                                                      counts)]
        return (torch.cat(imgs), *sums)


def render_ssaa(scene: Scene, camera: Camera, opts: RenderOptions, *,
                device, factor: int = 2, tracer=None, count_rays: bool = False,
                band_rows: int | None = None):
    """Supersampled render → (image [H,W,3], rays_traced): trace a factor×
    frame through the same projection and box-average factor² subsamples per
    pixel. The average is taken after the [0,1] clamp, like accumulating
    clamped castRay results into a big framebuffer.

    `band_rows` is in rows of the output image; on the card a band only
    bounds memory, so the default is one band of the whole frame. With
    compaction on → (img, traced, dropped), `dropped` summed over the bands.
    """
    with span("rt.frame"):
        if factor < 1:
            raise ValueError(f"ssaa factor must be ≥ 1, got {factor}")
        hi = dataclasses.replace(opts, width=opts.width * factor,
                                 height=opts.height * factor)
        band_rows = opts.height if band_rows is None else min(band_rows,
                                                              opts.height)
        device = torch.device(device)
        scene = scene.to(device)
        camera = camera.to(device)
        imgs = []
        sums = None
        for r0 in range(0, opts.height, band_rows):
            rb = min(band_rows, opts.height - r0)
            img, *counts = render(scene, camera, hi, device=device,
                                  count_rays=count_rays, tracer=tracer,
                                  row0=r0 * factor, rows=rb * factor)
            imgs.append(img.reshape(rb, factor, opts.width, factor, 3)
                        .mean(dim=(1, 3)))
            sums = counts if sums is None else [a + b for a, b in zip(sums,
                                                                      counts)]
        return (torch.cat(imgs), *sums)


def render_image(scene: Scene, camera: Camera, opts: RenderOptions, *,
                 device, tracer=None):
    """Convenience: the image alone ([H,W,3] f32 in [0,1] on `device`)."""
    return render_banded(scene, camera, opts, device=device, tracer=tracer)[0]


def as_leaf(x, device) -> torch.Tensor:
    """A fresh f32 leaf on `device` that requires grad, holding x's values
    (an array-like or a tensor, which is detached first)."""
    t = x.detach() if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x, np.float32))
    return t.to(device=device, dtype=torch.float32).clone().requires_grad_(
        True)


def value_and_grad_bands(band_fn, params, opts, target, bands, *, device):
    """Σ over `bands` [(row0, rows), ...] of Σ (band_fn(leaves, row0, rows)
    − target[row0:row0+rows])² / (H·W·3) → (loss [] f32, {name:
    gradient}): `band_fn` renders an image band, `target` is the full
    [H, W, 3] frame, each band's gradients are taken on their own and
    summed. `params` {name: array-like} becomes fresh leaves on
    `device`."""
    device = torch.device(device)
    leaves = {k: as_leaf(v, device) for k, v in params.items()}
    target = (target if isinstance(target, torch.Tensor)
              else torch.from_numpy(np.array(target, np.float32)))
    target = target.detach().to(device=device, dtype=torch.float32)
    # a device tensor: torch on CUDA divides by a Python number as a
    # product with its rounded reciprocal
    denom = torch.tensor(float(opts.width * opts.height * 3),
                         dtype=torch.float32, device=device)
    val = torch.zeros((), dtype=torch.float32, device=device)
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    for r0, rb in bands:
        with torch.enable_grad():
            img = band_fn(leaves, r0, rb)
            loss = ((img - target[r0:r0 + rb]) ** 2).sum() / denom
            with span("rt.backward"):
                g = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        val = val + loss.detach()
        for k, gk in zip(leaves, g):
            if gk is not None:
                grads[k] += gk
    return val, grads


def value_and_grad_banded(apply_params, params, scene: Scene, camera: Camera,
                          opts: RenderOptions, target, *, device, tracer=None,
                          band_rows: int | None = None):
    """Pixel-L2 inverse-rendering loss and gradients, band by band.

    loss(params) = Σ_px (render(apply_params(scene, params)) − target)²
                   / (H·W·3),
    taken per horizontal band of `band_rows` rows (default: one band of the
    whole frame), each band's gradients summed. `apply_params(scene,
    params) -> Scene` grafts the parameters ({name: tensor}, fresh leaves on
    `device`) into the device copy of `scene`. → (loss [] f32, {name:
    gradient}) on `device`.
    """
    with span("rt.value_and_grad"):
        band_rows = opts.height if band_rows is None else min(band_rows,
                                                              opts.height)
        device = torch.device(device)
        dscene, dcam = scene.to(device), camera.to(device)

        def band(leaves, r0, rb):
            return render(apply_params(dscene, leaves), dcam, opts,
                          device=device, tracer=tracer, row0=r0, rows=rb)[0]

        bands = [(r0, min(band_rows, opts.height - r0))
                 for r0 in range(0, opts.height, band_rows)]
        return value_and_grad_bands(band, params, opts, target, bands,
                                    device=device)
