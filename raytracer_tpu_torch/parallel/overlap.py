"""Bounce-pipelined backward: a gradient all_reduce per bounce (counterpart
of `raytracer_tpu/parallel/overlap.py`).

The plain data-parallel step (`overlap=False`: one autograd backward, then
one all_reduce of every scene gradient) leaves the all_reduce exposed at the
end of the backward. Here the backward is written out bounce by bounce, in
reverse depth order, by recomputation: the forward (under no_grad) saves
only each bounce's ray state (o, d, thr, alive); the backward re-runs one
bounce at a time from its saved state, with `alive` frozen from the
forward, and takes `torch.autograd.grad` of its radiance terms and its
children's (o, d, thr) with respect to the scene's float tensors and the
bounce's own (o, d, thr). Each bounce's scene gradient goes out at once as
an async all_reduce over 'tiles', free to run while the earlier bounces'
backward computes; the handles are waited on when the sweep ends. The
winner search is integer-only, so no gradient flows through the search's
collectives.

Scope: gradients with respect to the scene's float tensors (geometry,
materials, lights); the camera is fixed. Each rank renders its whole pixel
block as one wavefront.
"""

import numpy as np
import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.types import Camera, RenderOptions, Scene
from raytracer_tpu_torch.ops.safemath import clamp01
from raytracer_tpu_torch.parallel.mesh import RtMesh
from raytracer_tpu_torch.parallel.shard import (_flatten, primary_dirs,
                                                rank_lanes, rank_tracer)
from raytracer_tpu_torch.renderer import bounce_step


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating)


def float_partition(tree):
    """Split a dataclass tree (a Scene) into (float leaves, other leaves,
    rebuild): rebuild(floats, others) restores the tree. The
    differentiable-parameter view of a scene: float tensors (or arrays) on
    one side; integer tables and flags on the other."""
    leaves, rebuild_all = _flatten(tree)
    is_f = [_is_float(x) for x in leaves]
    floats = tuple(x for x, f in zip(leaves, is_f) if f)
    others = tuple(x for x, f in zip(leaves, is_f) if not f)

    def rebuild(floats_new, others_new):
        fi, oi = iter(floats_new), iter(others_new)
        return rebuild_all([next(fi) if f else next(oi) for f in is_f])

    return floats, others, rebuild


def _flat(grads, like):
    """Gradients (None where unused) → one flat f32 vector."""
    return torch.cat([(g if g is not None else torch.zeros_like(x))
                      .reshape(-1) for g, x in zip(grads, like)])


def loss_and_grad_overlapped(scene: Scene, camera: Camera,
                             opts: RenderOptions, mesh: RtMesh, target,
                             ring: bool = False, overlap: bool = True, *,
                             device):
    """One call of `make_loss_and_grad(...)(scene, target)`."""
    step = make_loss_and_grad(scene, camera, opts, mesh, ring=ring,
                              overlap=overlap, device=device)
    return step(scene, target)


def make_loss_and_grad(template: Scene, camera: Camera, opts: RenderOptions,
                       mesh: RtMesh, ring: bool = False,
                       overlap: bool = False, *, device):
    """Build once → `step(scene, target) -> (loss, grad_scene)`, run on every
    rank of `mesh`; `template` fixes the layout (primitive counts, the
    scene's structure), later scenes must match it.

    loss = Σ_px (clamp(render(scene)) − target)² / (H·W·3) (a 0-dim f32 on
    `device`, summed over 'tiles'); grad_scene is a Scene of the same
    structure with the loss's gradient in every float tensor and zeros in
    the integer ones, the same on every rank. The search is this rank's
    ShardTracer (RingTracer with `ring`). The default, `overlap=False`,
    runs the forward through one autograd backward and one all_reduce at
    the end. `overlap=True` runs the per-bounce sweep of this module's
    docstring, kept for parity with the reference: on an H100 it has been
    slower than the plain backward at every size measured (PERF.md), since
    its recompute costs more than the all_reduce of the scene's floats that
    it hides.
    """
    device = torch.device(device)
    camera = camera.to(device)
    n_tiles = mesh.shape["tiles"]
    h, w = opts.height, opts.width
    n_pix = h * w
    per_dev = rank_lanes(n_pix, n_tiles)
    lo = mesh.tile * per_dev
    group = mesh.tiles_group
    with torch.no_grad():
        dirs = primary_dirs(camera, opts, per_dev * n_tiles)[lo:lo + per_dev]
        orig = camera.pos[None, :].expand(per_dev, 3)
    pix_mask = ((lo + torch.arange(per_dev, device=device)) < n_pix)[:, None]
    # a device tensor: torch on CUDA divides by a Python number as a
    # product with its rounded reciprocal
    denom = torch.tensor(float(n_pix * 3), dtype=torch.float32, device=device)
    depths = opts.max_depth + 1
    n_floats = len(float_partition(template)[0])

    def step(scene: Scene, target):
        scene = scene.to(device)
        floats, others, rebuild = float_partition(scene)
        if len(floats) != n_floats:
            raise ValueError("scene does not match the template's structure")
        floats = tuple(f.detach() for f in floats)
        tracer = rank_tracer(scene, mesh, ring, device=device)
        tgt = (target if isinstance(target, torch.Tensor)
               else torch.from_numpy(np.array(target, np.float32)))
        tgt = tgt.detach().to(device, torch.float32).reshape(-1, 3)
        tgt = torch.cat([tgt, tgt.new_zeros((per_dev * n_tiles - n_pix, 3))])
        tgt = tgt[lo:lo + per_dev]

        def bounce(d, fl, fstate, alive):
            """Bounce d → (radiance terms, child state or None)."""
            terms, nstate, _ = bounce_step(
                rebuild(fl, others), tuple(fstate) + (alive,), opts, per_dev,
                is_last=d == depths - 1, tracer=tracer, depth=d)
            return terms, nstate

        def forward(fl, saved=None):
            fstate = (orig, dirs, torch.ones((per_dev, 3), dtype=torch.float32,
                                             device=device))
            alive = torch.ones((per_dev,), dtype=torch.bool, device=device)
            rad = torch.zeros((per_dev, 3), dtype=torch.float32,
                              device=device)
            for d in range(depths):
                if saved is not None:
                    saved.append((fstate, alive))
                terms, nstate = bounce(d, fl, fstate, alive)
                for t in terms:
                    rad = rad + t
                if nstate is not None:
                    fstate, alive = nstate[:3], nstate[3]
            return rad

        def local_loss(rad):
            e = (clamp01(rad) - tgt) * pix_mask
            return (e * e).sum() / denom

        if not overlap:
            fl = tuple(f.clone().requires_grad_(True) for f in floats)
            with torch.enable_grad():
                lval = local_loss(forward(fl))
                g = torch.autograd.grad(lval, fl, allow_unused=True)
            flat = torch.cat([lval.detach().reshape(1), _flat(g, fl)])
            dist.all_reduce(flat, group=group)
            return flat[0], _unflatten(flat[1:], floats, others, rebuild)

        # forward: keep only each bounce's ray state
        saved = []
        with torch.no_grad():
            rad = forward(floats, saved)
        rad.requires_grad_(True)
        with torch.enable_grad():
            lval = local_loss(rad)
            (cot_rad,) = torch.autograd.grad(lval, rad)
        loss = lval.detach().reshape(1)
        works = [dist.all_reduce(loss, group=group, async_op=True)]
        # backward: reverse bounce sweep, an all_reduce per bounce
        parts, cot_state = [], None
        for d in reversed(range(depths)):
            fstate_d, alive_d = saved[d]
            fl = tuple(f.detach().requires_grad_(True) for f in floats)
            st = tuple(x.detach().requires_grad_(True) for x in fstate_d)
            with torch.enable_grad():
                terms, nstate = bounce(d, fl, st, alive_d)
                outs = list(terms) + (list(nstate[:3]) if nstate is not None
                                      else [])
                cots = [cot_rad] * len(terms) + (list(cot_state)
                                                 if nstate is not None else [])
                keep = [i for i, o in enumerate(outs) if o.requires_grad]
                g = torch.autograd.grad([outs[i] for i in keep], fl + st,
                                        grad_outputs=[cots[i] for i in keep],
                                        allow_unused=True)
            part = _flat(g[:len(fl)], fl)
            works.append(dist.all_reduce(part, group=group, async_op=True))
            parts.append(part)
            cot_state = tuple(gi if gi is not None else torch.zeros_like(x)
                              for gi, x in zip(g[len(fl):], st))
        for wk in works:
            wk.wait()
        return loss[0], _unflatten(sum(parts), floats, others, rebuild)

    return step


def _unflatten(flat, floats, others, rebuild) -> Scene:
    """A flat gradient vector → a Scene of gradients (zeros in the integer
    tensors)."""
    grads, k = [], 0
    for f in floats:
        grads.append(flat[k:k + f.numel()].view(f.shape))
        k += f.numel()
    zeros = tuple(torch.zeros_like(o) if isinstance(o, torch.Tensor) else o
                  for o in others)
    return rebuild(grads, zeros)
