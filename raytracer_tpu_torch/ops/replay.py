"""Plan replay: differentiate shading against a recorded winner-search plan
(counterpart of `raytracer_tpu/ops/replay.py`).

A training step's backward needs only the integer outputs of the winner
searches: per bounce, the fused-prim winner index of every lane and the
per-light occlusion bits. Two planners produce them: the wavefront itself
(`renderer.render(record_plan=True)`, whose walks then never enter autograd)
and the fused forward (`FusedWhitted.render_plan`, mesh-free scenes).
`PlanTracer` feeds a plan back through the unchanged wavefront bounce loop in
place of a tracer, so autograd over a replay render differentiates only the
shading recompute.

Plan encoding: winner −1 = miss (or a dead lane), [0, Ns) spheres, [Ns,
Ns+Np) planes, then triangles; occlusion bit l set = light l occluded.

Glass plans with `opts.compact_cap` replay compacted (`_replay_render_
compact`): the plan's winners alone fix which lanes spawn children, so the
whole chain of compactions is derived from the plan before the replay runs
(`_plan_compaction`), and the differentiated replay runs at the capped width
with precomputed permutations.
"""

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from raytracer_tpu_torch import renderer
from raytracer_tpu_torch.core.types import (KIND_NONE, KIND_PLANE,
                                            KIND_SPHERE, KIND_TRIANGLE,
                                            REFLECTION,
                                            REFLECTION_AND_REFRACTION)
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops.dgather import permute_take
from raytracer_tpu_torch.ops.safemath import clamp01
from raytracer_tpu_torch.ops.trace import Hit


class PlanTracer:
    """Replays a recorded plan through the tracer interface.

    Holds one winner plane and one occlusion plane per bounce, each as wide
    as that bounce's wavefront. Stateful cursors sequence the calls: the
    bounce loop calls `nearest` once per bounce and `occluded` once per
    light within it, in the order the plan was written. A PlanTracer is
    good for one pass over the bounces: build a fresh one for each replay
    (a checkpointed replay builds its own inside the checkpointed
    function, so the backward's recompute starts from bounce 0).
    """

    stateful_cursor = True

    def __init__(self, wins, occs, n_spheres: int, n_planes: int):
        self._wins = [w.reshape(-1) for w in wins]
        self._occs = [o.reshape(-1) for o in occs]
        self._ns = int(n_spheres)
        self._np = int(n_planes)
        self._bounce = -1
        self._light = 0

    @staticmethod
    def for_plan(plan, n_spheres: int, n_planes: int,
                 max_depth: int | None = None, glass: bool = False):
        """Build from a (win_planes, occ_planes) pair whose planes cover
        exactly the rays about to be traced.

        Glass plans carry one plane per recursion NODE, ordered by (bounce,
        path prefix p); the uncompacted wavefront's bounce-b buffer is the
        p-ordered concatenation of that bounce's 2^b node planes (child slot
        = c·2^b·n + parent slot under the [reflect | refract] concat), so
        they are concatenated here."""
        wins, occs = plan
        if not glass:
            return PlanTracer(list(wins), list(occs), n_spheres, n_planes)
        if max_depth is None:
            raise ValueError("a glass plan needs max_depth")
        bw, bo, off = [], [], 0
        for b in range(max_depth + 1):
            k = 1 << b
            bw.append(torch.cat([wins[off + p].reshape(-1)
                                 for p in range(k)]))
            bo.append(torch.cat([occs[off + p].reshape(-1)
                                 for p in range(k)]))
            off += k
        return PlanTracer(bw, bo, n_spheres, n_planes)

    def _hit_from_win(self, win):
        miss = win < 0
        is_s = ~miss & (win < self._ns)
        is_p = ~miss & ~is_s & (win < self._ns + self._np)
        kind = torch.where(miss, KIND_NONE,
                           torch.where(is_s, KIND_SPHERE,
                                       torch.where(is_p, KIND_PLANE,
                                                   KIND_TRIANGLE)))
        idx = torch.where(is_s, win,
                          torch.where(is_p, win - self._ns,
                                      torch.clamp(win - self._ns - self._np,
                                                  min=0)))
        # t is never read on the replay path (surface_at recomputes it);
        # keep the miss/hit split so a `t < inf` check agrees
        t = torch.where(miss, torch.inf, 1.0).to(torch.float32)
        return Hit(kind=kind.to(torch.int32), idx=idx.to(torch.int32), t=t)

    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        self._bounce += 1
        self._light = 0
        if self._bounce >= len(self._wins):
            raise RuntimeError("replay exhausted: more nearest() calls than "
                               "plan bounces")
        win = self._wins[self._bounce]
        if win.shape[0] != orig.shape[0]:
            raise ValueError(f"plan width {win.shape[0]} != wavefront width "
                             f"{orig.shape[0]}")
        return self._hit_from_win(win)

    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        li = self._light
        self._light += 1
        occ = self._occs[self._bounce]
        if occ.shape[0] != orig.shape[0]:
            raise ValueError(f"plan width {occ.shape[0]} != wavefront width "
                             f"{orig.shape[0]}")
        return ((occ >> li) & 1).to(torch.bool)


def _prim_flags(scene):
    """Bool tables over the fused prim index (spheres, planes, triangles):
    (is_spec, is_glass), which winners spawn a reflected and a refracted
    child."""
    mids = torch.cat([scene.spheres.mat_id.reshape(-1),
                      scene.planes.mat_id.reshape(-1),
                      scene.meshes.mat_id.reshape(-1)]).long()
    kinds = scene.materials.mtype[mids]
    is_gls = kinds == REFLECTION_AND_REFRACTION
    return (kinds == REFLECTION) | is_gls, is_gls


@torch.no_grad()
def _plan_compaction(plan, scene, n0: int, max_depth: int, cap: int):
    """The compaction chain of a glass plan, derived from the plan alone.

    `plan` = (win, occ) node planes [n0] each, in (bounce, path prefix)
    order. A lane spawns a reflected child on any specular winner and a
    refracted one on a glass winner; total internal reflection is not in
    the plan, so the refracted lanes are a superset of the alive ones (the
    extra lanes ride with zero throughput). → (planes, compacts, dropped):
    - planes: per bounce b, (win, occ, slot) in that bounce's compacted lane
      order; `slot` is each lane's slot in the uncompacted 2^b·n0 buffer
      (its pixel is slot mod n0);
    - compacts: per bounce b < max_depth, None or (order, pos, kept) to
      apply to bounce b's children;
    - dropped: plan-alive lanes lost to the cap (0-dim f32).
    """
    wins, occs = plan
    spec_tab, gls_tab = _prim_flags(scene)
    dev = wins[0].device
    cur_slots = torch.arange(n0, dtype=torch.int32, device=dev)
    cur_alive = torch.ones((n0,), dtype=torch.bool, device=dev)
    planes, compacts = [], []
    dropped = torch.zeros((), dtype=torch.float32, device=dev)
    off = 0
    for b in range(max_depth + 1):
        k = 1 << b
        # the bounce's node planes in path-prefix order = its uncompacted
        # slot order (PlanTracer.for_plan)
        win_b = torch.cat([wins[off + p].reshape(-1) for p in range(k)])
        occ_b = torch.cat([occs[off + p].reshape(-1) for p in range(k)])
        off += k
        planes.append((win_b[cur_slots], occ_b[cur_slots], cur_slots))
        if b == max_depth:
            break
        w_lane = planes[-1][0]
        hit = cur_alive & (w_lane >= 0)
        wsafe = torch.clamp(w_lane, min=0)
        child_slots = torch.cat([cur_slots, cur_slots + k * n0])
        child_alive = torch.cat([hit & spec_tab[wsafe], hit & gls_tab[wsafe]])
        if child_slots.shape[0] > cap:
            order, pos, kept, drop = renderer.partition(child_alive, cap)
            cur_slots = child_slots[order]
            cur_alive = child_alive[order] & kept
            compacts.append((order, pos, kept))
            dropped = dropped + drop
        else:
            cur_slots, cur_alive = child_slots, child_alive
            compacts.append(None)
    return planes, compacts, dropped


def _replay_compact_tile(scene, orig, tdirs, opts, win_nodes, occ_nodes,
                         cap):
    """One tile's plan-compacted bounce loop → (radiance [tile, 3],
    dropped)."""
    tile = tdirs.shape[0]
    opts1 = dataclasses.replace(opts, compact_cap=None)
    planes, compacts, dropped = _plan_compaction(
        (win_nodes, occ_nodes), scene, tile, opts.max_depth, cap)
    tracer = PlanTracer([p[0] for p in planes], [p[1] for p in planes],
                        scene.spheres.count, scene.planes.count)
    dev = tdirs.device
    radiance = torch.zeros((tile, 3), dtype=torch.float32, device=dev)
    state = (orig, tdirs, torch.ones((tile, 3), dtype=torch.float32,
                                     device=dev),
             torch.ones((tile,), dtype=torch.bool, device=dev))
    slot = None
    for b in range(opts.max_depth + 1):
        terms, state, _ = renderer.bounce_step(
            scene, state, opts1, tile, is_last=b == opts.max_depth,
            tracer=tracer, slot=slot, n_slots=tile << b)
        for t in terms:
            radiance = radiance + t
        if state is None:
            break
        if slot is not None:
            *state, slot = state
        if compacts[b] is not None:
            order, pos, kept = compacts[b]
            o, d, thr, alive = state
            state = (permute_take(o, order, pos), permute_take(d, order, pos),
                     permute_take(thr, order, pos), alive[order] & kept)
            slot = planes[b + 1][2]
        # without a compaction the children keep the slots spawn gave them
        # (None: lane order is slot order)
        state = tuple(state)
    return radiance, dropped


def _replay_render_compact(scene, camera, opts, plan, row0: int, rows: int,
                           device):
    """Glass replay at plan-compacted width → (img, traced ≡ 0, dropped).

    The band is one tile when it fits `opts.tile_rays`, else strided tiles
    as the compacted wavefront renders them (slot j of tile k is pixel
    j·ntiles + k), each deriving its own compaction chain from its slice of
    the plan. Tiles are checkpointed when gradients are needed and
    `opts.remat_tiles` is set: the plan is an input, so both remat policies
    recompute only the shading."""
    w = opts.width
    n_pix = rows * w
    tile = min(opts.tile_rays, renderer._ceil_to(n_pix, 8))
    n_pad = renderer._ceil_to(n_pix, tile)
    ntiles = n_pad // tile
    cap = renderer._cap_lanes(opts.compact_cap, tile)
    wins = [_pad_plane(x, n_pix, n_pad, -1, device) for x in plan[0]]
    occs = [_pad_plane(x, n_pix, n_pad, 0, device) for x in plan[1]]
    dirs = geom.raygen(camera.c2w, camera.fov_deg, w, opts.height,
                       row0=row0, rows=rows)
    if n_pad != n_pix:
        dirs = torch.cat([dirs, torch.tensor(
            [[0.0, 0.0, -1.0]], dtype=torch.float32,
            device=device).expand(n_pad - n_pix, 3)])

    def strided(x):  # [n_pad, ...] pixel order → [ntiles, tile, ...]
        return x.reshape(tile, ntiles, *x.shape[1:]).transpose(0, 1)

    dirs = strided(dirs)
    wins = [strided(x) for x in wins]
    occs = [strided(x) for x in occs]
    orig = camera.pos[None, :].expand(tile, 3)
    remat = (opts.remat_tiles and ntiles > 1
             and renderer.needs_grad(scene, camera))
    rads = []
    dropped = torch.zeros((), dtype=torch.float32, device=device)
    for k in range(ntiles):
        args = (scene, orig, dirs[k].contiguous(), opts,
                [x[k].contiguous() for x in wins],
                [x[k].contiguous() for x in occs], cap)
        rad, drop = (checkpoint(_replay_compact_tile, *args,
                                use_reentrant=False) if remat
                     else _replay_compact_tile(*args))
        rads.append(rad)
        dropped = dropped + drop
    rad = torch.stack(rads, dim=1).reshape(n_pad, 3)  # back to pixel order
    img = clamp01(rad[:n_pix]).reshape(rows, w, 3)
    return img, torch.zeros((), dtype=torch.float32, device=device), dropped


def _pad_plane(x, n_pix: int, n_pad: int, fill, device):
    x = x.reshape(-1).to(device=device, dtype=torch.int32)
    if x.shape[0] != n_pix:
        raise ValueError(f"plan plane of {x.shape[0]} entries for a band of "
                         f"{n_pix} pixels")
    if n_pad == n_pix:
        return x
    return torch.cat([x, torch.full((n_pad - n_pix,), fill, dtype=x.dtype,
                                    device=device)])


def replay_render(scene, camera, opts, plan, row0: int = 0,
                  rows: int | None = None, tile_rays: int | None = None, *,
                  device):
    """Render a band by replaying `plan` → (image [rows, W, 3], traced).

    `plan` = (win_planes, occ_planes), band-local and in pixel order: one
    plane per bounce from `renderer.render(record_plan=True)`, or one per
    recursion node from `FusedWhitted.render_plan` (glass scenes:
    2^(D+1)−1 nodes, concatenated per bounce by `PlanTracer.for_plan`).
    `tile_rays=None` replays the band as one tile; an int replays it in
    tiles of that many lanes, each its slice of every plane, checkpointed
    when gradients are needed and `opts.remat_tiles` is set (the backward
    holds one tile's activations). Pad lanes replay a miss (−1/0) and are
    cut off. `traced` is 0: a replay traces no ray.

    A glass plan with `opts.compact_cap` set replays compacted, in tiles of
    `opts.tile_rays` (`tile_rays` is not read) → (image, traced, dropped):
    `dropped` counts plan-alive lanes lost to the cap, 0 when exact.
    """
    device = torch.device(device)
    scene = scene.to(device)
    camera = camera.to(device)
    rows = opts.height - row0 if rows is None else rows
    if opts.compact_cap is not None and scene.has_glass:
        return _replay_render_compact(scene, camera, opts, plan, row0, rows,
                                      device)
    w, h = opts.width, opts.height
    n_pix = rows * w
    glass = bool(scene.has_glass)
    ns, npl = scene.spheres.count, scene.planes.count
    full = renderer._ceil_to(n_pix, 8)
    tile = full if tile_rays is None else min(int(tile_rays), full)
    n_pad = renderer._ceil_to(n_pix, tile)
    # the replay runs uncompacted: plan planes are slot-indexed, and glass
    # buffers double per bounce exactly as the plan's node tree
    opts1 = dataclasses.replace(opts, compact_cap=None, tile_rays=tile)
    wins = [_pad_plane(x, n_pix, n_pad, -1, device) for x in plan[0]]
    occs = [_pad_plane(x, n_pix, n_pad, 0, device) for x in plan[1]]

    dirs = geom.raygen(camera.c2w, camera.fov_deg, w, h, row0=row0,
                       rows=rows)
    if n_pad != n_pix:
        dirs = torch.cat([dirs, torch.tensor(
            [[0.0, 0.0, -1.0]], dtype=torch.float32,
            device=device).expand(n_pad - n_pix, 3)])
    orig = camera.pos[None, :].expand(tile, 3)
    remat = (opts.remat_tiles and n_pad > tile
             and renderer.needs_grad(scene, camera))

    def tile_fn(o, d, w_sl, o_sl):
        tracer = PlanTracer.for_plan((w_sl, o_sl), ns, npl,
                                     max_depth=opts.max_depth, glass=glass)
        return renderer.render_rays(scene, o, d, opts1, tracer=tracer)[0]

    rads = []
    for s in range(0, n_pad, tile):
        w_sl = [x[s:s + tile] for x in wins]
        o_sl = [x[s:s + tile] for x in occs]
        if remat:
            rads.append(checkpoint(tile_fn, orig, dirs[s:s + tile], w_sl,
                                   o_sl, use_reentrant=False))
        else:
            rads.append(tile_fn(orig, dirs[s:s + tile], w_sl, o_sl))
    img = clamp01(torch.cat(rads)[:n_pix]).reshape(rows, w, 3)
    return img, torch.zeros((), dtype=torch.float32, device=device)


def replay_band_vg(params, scene, camera, target, plan, r0: int, *,
                   apply_params, opts, rb: int, tile=None, device,
                   dropped: list | None = None):
    """Loss and gradients of one band by replay → (loss, {name: grad}):
    Σ (replay_render(apply_params(scene, leaves)) − target[band])² / (H·W·3)
    and its gradient for each of `params` (fresh leaves on `device`).
    `plan` covers the band (`rb` rows from `r0`); `target` is the full
    [H, W, 3] frame. A compacted glass replay appends the band's `dropped`
    count (a 0-dim device tensor) to the list `dropped` when one is given.
    """
    device = torch.device(device)
    dscene, dcam = scene.to(device), camera.to(device)

    def band(leaves, row0, rows):
        img, _, *drop = replay_render(apply_params(dscene, leaves), dcam, opts,
                                      plan, row0=row0, rows=rows,
                                      tile_rays=tile, device=device)
        if drop and dropped is not None:
            dropped.append(drop[0].detach())
        return img

    return renderer.value_and_grad_bands(band, params, opts, target,
                                         [(r0, rb)], device=device)


def value_and_grad_replay(apply_params, params, scene, camera, opts, target,
                          fused_builder, band_rows: int | None = None,
                          tile_rays: int | None = None, *, device,
                          dropped: list | None = None):
    """Pixel-L2 loss and gradients by fused-plan replay (mesh-free scenes).

    Per band: `fused_builder(params)` → a `FusedWhitted` (param mode, the
    current parameters bound) whose `render_plan` records the band's plan on
    its device (K1's full plan on the card), then `replay_band_vg`
    differentiates the shading replay of that plan. Band gradients are
    summed. Matches `renderer.value_and_grad_banded` up to the fused-vs-
    wavefront knife-edge winners. Glass scenes with `opts.compact_cap`
    replay compacted; each band's `dropped` count goes to the list
    `dropped` when one is given.
    """
    band_rows = opts.height if band_rows is None else band_rows
    fused = fused_builder(params)
    val, grads = None, None
    for r0 in range(0, opts.height, band_rows):
        rb = min(band_rows, opts.height - r0)
        _, wins, occs = fused.render_plan(row0=r0, rows=rb)
        v, g = replay_band_vg(params, scene, camera, target, (wins, occs),
                              r0, apply_params=apply_params, opts=opts,
                              rb=rb, tile=tile_rays, device=device,
                              dropped=dropped)
        val = v if val is None else val + v
        grads = g if grads is None else {k: grads[k] + g[k] for k in g}
    return val, grads
