"""Closed loop of frames through `renderer.render_banded`, what one `cli
render` user does: each frame a seed-drawn sub-pixel view of the
configuration, one after another.

Set-up builds the scene and the tracer and warms up on views of another
stream. A seed-drawn sample of the window's frames is kept, and once the
window has closed the reference renders their views again and judges
them."""

import sys
import time

import numpy as np

from portbench import harness, scenes, views, window
from portbench.reference import compare, counts


class Sample:
    """A uniform sample of `k` of the window's frames (reservoir sampling
    drawn from the seed): (index, view, image) each."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.kept, self.seen = k, np.random.default_rng([seed, 1]), [], 0

    def offer(self, view, img):
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append((self.seen - 1, view, img.clone()))
            return
        j = int(self.rng.integers(self.seen))
        if j < self.k:
            self.kept[j] = (self.seen - 1, view, img.clone())


def run(r: harness.Run) -> dict:
    import torch

    from raytracer_tpu_torch.renderer import render_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer

    dev = torch.device(r.device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    with r.span("entry.scene_build"):
        scene, opts = scenes.port_scene(r.cfg)
        tracer = build_tracer(scene, r.cfg["tracer"], dev)
        dscene = scene.to(dev)
    rays = counts.frame_rays(r.counts())

    def frame(view):
        img, *rest = render_banded(dscene, scenes.port_camera(view), opts,
                                   device=dev, tracer=tracer)
        if "stale_frame" in r.faults and frame.last is not None:
            img = frame.last                 # the previous frame returned again
        if "half_frame" in r.faults:
            img = img.clone()
            img[img.shape[0] // 2:] = 0.0    # half the rows never rendered
        if "altered" in r.faults:
            img = img.clone()                # an answer altered where it is made:
            h, w = img.shape[0] // 4, img.shape[1] // 4
            img[:h, :w] = (img[:h, :w] + 0.05).clamp(0.0, 1.0)
        frame.last = img
        return img, rest

    frame.last = None
    warm = views.Views(r.cfg, [r.seed, 2], r.traffic["jitter_px"])
    for _ in range(r.traffic["warmup"]):
        frame(warm.next())
    sync()
    setup_s = time.perf_counter() - r.started

    seq = views.Views(r.cfg, r.seed, r.traffic["jitter_px"])
    sample = Sample(r.traffic["judged_frames"], r.seed)
    dropped = torch.zeros((), device=dev)

    def unit(k):
        nonlocal dropped
        view = seq.next()
        img, rest = frame(view)
        if len(rest) > 1:                    # a compacted wavefront's dropped lanes
            dropped = dropped + rest[1]
        sample.offer(view, img)

    loop = window.closed_loop(unit, r.seconds, sync,
                              trace_at=r.traffic["trace_after"] if r.trace else None,
                              trace_units=r.traffic["trace_frames"], device=dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    n = len(loop["times"])
    e2e = {"render_rays_per_s": n * rays / loop["span"],
           "frame_ms_p95": 1e3 * window.p95(loop["times"]), "setup_s": setup_s}
    kept = [(i, v, img.cpu()) for i, v, img in sample.kept]
    dropped = float(dropped)
    del tracer, dscene, sample
    if cuda:
        torch.cuda.empty_cache()

    from portbench.reference.whitted import Reference

    t_ref = time.perf_counter()
    ref = Reference(scenes.plain_scene(r.cfg), dev)
    readings = [compare.image_numbers(img, ref.image(v).cpu()) for _, v, img in kept]
    checks = compare.judge(compare.worst(readings), r.limits)
    ok = compare.passed(checks)
    failed = sum(not compare.passed(compare.judge(x, r.limits)) for x in readings)
    print(f"{r.cell}: {n} frames in {loop['span']:.4f} s, {rays} rays a frame "
          f"(reference count), judged frames {[i for i, _, _ in kept]}, dropped "
          f"lanes {dropped:g}, host {loop['host']}, readings {readings}; the reference took "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr, flush=True)
    return {"correct": ok, "attempted": n, "failed": failed,
            "e2e": e2e, "checks": checks, "trace": loop["trace"],
            "device": harness.device_info(r, peak)}
