"""Closed loop of training steps, what one `cli optimize` user does on the
headline scene: `renderer.value_and_grad_banded` (the "plan" remat: the
searches record under no_grad, autograd replays the shading) for the
spheres' centers and the materials' albedos, then `torch.optim.Adam`.

The target is the configuration's frame with the centers moved by a
seed-drawn offset and the albedos scaled by seed-drawn factors; the
program renders it in set-up, the reference again when it judges. Set-up
builds one step object and drives its first three steps through the
window's own call; the window goes on with the same object. Once the
window has closed the reference follows those three steps: its loss and
gradient at the configuration's parameters and at each state the
program's steps reached, and Adam over the gradients that the program's
optimizer got (`reference/train.follow`)."""

import sys
import time

import numpy as np

from portbench import harness, scenes, views, window
from portbench.reference import compare, counts

FIRST_STEPS = 3


def target_tables(cfg: dict, seed: int, traffic: dict):
    """The target's (centers, albedos), drawn from the seed."""
    rng = np.random.default_rng([seed, 3])
    c0 = np.asarray(cfg["spheres"]["center"], np.float32)
    a0 = np.asarray(cfg["materials"]["albedo"], np.float32)
    off = rng.uniform(-traffic["center_offset"], traffic["center_offset"], c0.shape)
    lo, hi = traffic["albedo_scale"]
    return ((c0 + off).astype(np.float32),
            (a0 * rng.uniform(lo, hi, a0.shape)).astype(np.float32))


def with_params(scene, p):
    """The parameters grafted into a program scene."""
    import dataclasses

    return scene.replace(
        spheres=dataclasses.replace(scene.spheres, center=p["center"]),
        materials=dataclasses.replace(scene.materials, albedo=p["albedo"]))


def moved(tracer, scene):
    """`tracer` searching `scene`'s spheres and planes. The port's tracers
    keep the spheres they were built with, so each step swaps the current
    scene's into a copy; the mesh's packed tables are kept."""
    import copy

    from raytracer_tpu_torch.core.types import Meshes

    if not hasattr(tracer, "_base"):
        raise TypeError(f"{type(tracer).__name__} keeps no dense base to move")
    t = copy.copy(tracer)
    t._base = scene.replace(meshes=Meshes.empty()).to(tracer.device)
    return t


class Trainer:
    """The training step: its parameters, Adam's state and the target."""

    def __init__(self, r: harness.Run, dscene, dcam, opts, tracer, target):
        import torch

        from raytracer_tpu_torch.renderer import value_and_grad_banded

        self.vg = value_and_grad_banded
        self.r, self.dscene, self.dcam, self.opts = r, dscene, dcam, opts
        self.base, self.target = tracer, target
        self.params = {"center": dscene.spheres.center.clone().requires_grad_(True),
                       "albedo": dscene.materials.albedo.clone().requires_grad_(True)}
        self.opt = torch.optim.Adam(list(self.params.values()), lr=r.traffic["lr"])

    def step(self):
        params = {k: v.detach() for k, v in self.params.items()}
        dev = self.dscene.spheres.center.device
        # the searches see the spheres where the parameters now put them
        tracer = moved(self.base, with_params(self.dscene, params))
        if "half_batch" in self.r.faults:    # the loss over the top half, its mean
            from raytracer_tpu_torch.renderer import render, value_and_grad_bands

            def band(leaves, r0, rb):
                return render(with_params(self.dscene, leaves), self.dcam, self.opts,
                              device=dev, tracer=tracer, row0=r0, rows=rb)[0]

            loss, grads = value_and_grad_bands(band, params, self.opts, self.target,
                                               [(0, self.opts.height // 2)], device=dev)
            loss, grads = 2 * loss, {k: 2 * g for k, g in grads.items()}
        else:
            loss, grads = self.vg(with_params, params, self.dscene, self.dcam, self.opts,
                                  self.target, device=dev, tracer=tracer)
        if "stale_state" in self.r.faults:   # a step that leaves the state as it was
            return loss
        for k, p in self.params.items():
            p.grad = grads[k]
        self.opt.step()
        return loss

    def first_steps(self, steps: int) -> dict:
        """`steps` steps through the window's own call → {"losses", "grads",
        "states": each step's loss, the gradient as the optimizer got it
        (worked out from Adam's first moment before and after the step),
        and the parameters the step started from; "change": the parameters
        after the steps less those before} on the host."""
        import torch

        beta1 = self.opt.param_groups[0]["betas"][0]
        out = {"losses": [], "grads": [], "states": []}
        prev = {k: torch.zeros_like(p) for k, p in self.params.items()}
        for _ in range(steps):
            out["states"].append({k: v.detach().clone() for k, v in self.params.items()})
            out["losses"].append(float(self.step()))
            m = {k: self.opt.state[p]["exp_avg"].detach().clone()
                 if p in self.opt.state else torch.zeros_like(p)
                 for k, p in self.params.items()}
            out["grads"].append({k: (m[k] - beta1 * prev[k]) / (1 - beta1) for k in m})
            prev = m
        out["change"] = {k: v.detach() - out["states"][0][k]
                         for k, v in self.params.items()}
        return to_host(out)


def to_host(x):
    """`x` with every tensor in it moved to the host."""
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, list):
        return [to_host(v) for v in x]
    return x.cpu() if hasattr(x, "cpu") else x


def target_frame(r: harness.Run, dscene, opts, tracer) -> tuple:
    """(the camera on the card, the program's render of the seed's target)."""
    import torch

    from raytracer_tpu_torch.renderer import render_banded

    dev = dscene.spheres.center.device
    dcam = scenes.port_camera(views.still(r.cfg)).to(dev)
    tc, ta = target_tables(r.cfg, r.seed, r.traffic)
    tscene = with_params(dscene, {"center": torch.from_numpy(tc).to(dev),
                                  "albedo": torch.from_numpy(ta).to(dev)})
    with torch.no_grad():
        return dcam, render_banded(tscene, dcam, opts, device=dev,
                                   tracer=moved(tracer, tscene))[0]


def run(r: harness.Run) -> dict:
    import torch

    from raytracer_tpu_torch.accel.grid import GridTracer, build_grid

    dev = torch.device(r.device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    if r.cfg["tracer"] != "grid":
        raise ValueError(f"{r.cell}: the training traffic walks a grid, not "
                         f"{r.cfg['tracer']!r}")
    with r.span("entry.scene_build"):
        scene, opts = scenes.port_scene(r.cfg)
        grid = build_grid(scene.meshes.verts, scene.meshes.tris, device=dev)
        dscene = scene.to(dev)
        tracer = GridTracer(dscene, grid, dev)
    rays = counts.frame_rays(r.counts())
    dcam, target = target_frame(r, dscene, opts, tracer)
    trainer = Trainer(r, dscene, dcam, opts, tracer, target)
    prog = trainer.first_steps(FIRST_STEPS)
    sync()
    setup_s = time.perf_counter() - r.started

    loop = window.closed_loop(lambda k: trainer.step(), r.seconds, sync,
                              trace_at=r.traffic["trace_after"] if r.trace else None,
                              trace_units=r.traffic["trace_steps"], device=dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    n = len(loop["times"])
    e2e = {"train_rays_per_s": n * rays / loop["span"], "setup_s": setup_s}
    del trainer, tracer, grid, dscene, target
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = follow_steps(r.cfg, r.seed, r.traffic, dev, prog)
    numbers = compare.train_numbers(prog, ref)
    checks = compare.judge(numbers, r.limits)
    ok = compare.passed(checks)
    print(f"{r.cell}: {n} steps in {loop['span']:.4f} s, {rays} forward rays a step "
          f"(reference count), host {loop['host']}; losses {prog['losses']} against "
          f"{ref['losses']}; numbers {numbers}; the reference took "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr, flush=True)
    return {"correct": ok, "attempted": n, "failed": 0 if ok else 1, "e2e": e2e,
            "checks": checks, "trace": loop["trace"],
            "device": harness.device_info(r, peak)}


def reference(cfg: dict, seed: int, traffic: dict, device, dtype=None) -> tuple:
    """(the reference, the view, its own render of the seed's target)."""
    import torch

    from portbench.reference.whitted import Reference

    ref = Reference(scenes.plain_scene(cfg), device, dtype or torch.float32)
    tc, ta = target_tables(cfg, seed, traffic)
    view = views.still(cfg)
    with torch.no_grad():
        target = ref.image(view, {"center": torch.from_numpy(tc).to(device, ref.dtype),
                                  "albedo": torch.from_numpy(ta).to(device, ref.dtype)})
    return ref, view, target


def follow_steps(cfg: dict, seed: int, traffic: dict, device, prog: dict) -> dict:
    """The reference along the program's first steps (`Trainer.first_steps`):
    from the configuration's parameters, then from each state the program's
    steps reached, against its own render of the seed's target."""
    from portbench.reference.train import follow

    ref, view, target = reference(cfg, seed, traffic, device)
    out = follow(ref, view, target, {"center": ref.sph_c, "albedo": ref.albedo},
                 prog["states"][1:], prog["grads"], traffic["lr"])
    return to_host(out)


def own_steps(cfg: dict, seed: int, traffic: dict, device, dtype=None,
              half_rows: bool = False) -> dict:
    """The reference's own first steps, in `Trainer.first_steps`'s form:
    the control (`dtype` bfloat16), the planted fault "half of the batch
    left out" (`half_rows`), or an independent trajectory."""
    from portbench.reference.train import adam_steps

    ref, view, target = reference(cfg, seed, traffic, device, dtype)
    out = adam_steps(ref, view, {"center": ref.sph_c, "albedo": ref.albedo}, target,
                     FIRST_STEPS, traffic["lr"], half_rows=half_rows)
    return to_host(out)
