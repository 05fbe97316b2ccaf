"""Closed loop of frames split over the cards of one host through the
program's frame service (`raytracer_tpu_torch/parallel/frames.py`), what a
`cli render --cards N` user does for each frame: each frame a seed-drawn
sub-pixel view of the configuration, one after another.

Rank 0 runs in this process, timed by `window.closed_loop` and profiled as
in the one-card loop; ranks 1 … N−1 are processes started by the program's
`spawn_ranks`, each serving its block of every frame until rank 0 stops
them. A rank that fails ends the run (no result). After the window, and
outside it, rank 0 gathers every rank's span aggregate, lane counters and
peak memory (`run.ranks`, which the `parallel.*` readers read). The judged
frames are rank 0's gathered images, against the reference's render of
their views."""

import contextlib
import os
import sys
import time

from portbench import harness, multicard, scenes, views, window
from portbench.loops.render import Sample
from portbench.reference import compare, counts

END_S = 120.0   # the other ranks' exit after the stop


def serve_rank(device, cfg: dict, faults: list):
    """A rank other than 0 (a `spawn_ranks` target): build the scene and
    serve frames until rank 0 stops, then print its tally. The planted
    fault `stale_band` makes the last rank hand in its block of the frame
    before; `skip_gather` leaves out the image's all-gather on every rank."""
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel.frames import ShardedFrames

    if "stale_band" in faults and dist.get_rank() == dist.get_world_size() - 1:
        _plant_stale_band()
    scene, opts = scenes.port_scene(cfg)
    tally = multicard.Tally().start()
    with _skipping_gather(faults):
        ShardedFrames(scene, opts, device=device).serve()
    _print_tally(dist.get_rank(), tally.stop())


def _print_tally(rank: int, samples: list):
    print(f"rank {rank} tally (wall s, bands, band s, cpu s, preempted, waits): "
          f"{samples}", file=sys.stderr, flush=True)


def _plant_stale_band():
    """The rank's wavefront (one tile a rank) answers with the radiance it
    computed for the frame before."""
    from raytracer_tpu_torch.parallel import shard

    real, last = shard.render_rays, []

    def stale(*args, **kw):
        out = real(*args, **kw)
        last.append(out)
        return last.pop(0) if len(last) > 1 else out

    shard.render_rays = stale


@contextlib.contextmanager
def _skipping_gather(faults):
    """With the planted fault `skip_gather`, every all-gather into a tensor
    does nothing: the gathered image is whatever its freshly allocated
    memory held (on the card, the memory of the frame before)."""
    import torch.distributed as dist

    if "skip_gather" not in faults:
        yield
        return
    real = dist.all_gather_into_tensor
    dist.all_gather_into_tensor = lambda *args, **kw: None
    try:
        yield
    finally:
        dist.all_gather_into_tensor = real


def _abandon(rank: int, code: int):
    print(f"rank {rank} exited {code}; the other ranks were stopped and the "
          "run is abandoned", file=sys.stderr, flush=True)
    os._exit(1)


def run(r: harness.Run) -> dict:
    import torch
    import torch.distributed as dist

    # a program without the frame service fails here, before any process
    from raytracer_tpu_torch.parallel import frames

    world = r.cfg["layout"]["tiles"] * r.cfg["layout"]["prims"]
    if world != r.chips:
        raise ValueError(f"{r.config_name} lays its frame over {world} cards; "
                         f"the cell has {r.chips}")
    kind = torch.device(r.device).type
    cuda = kind == "cuda"
    with frames.spawn_ranks(world, serve_rank, [r.cfg, sorted(r.faults)],
                            device_type=kind, ranks=range(1, world)) as others, \
            _skipping_gather(r.faults):
        others.watch(_abandon)
        dev = frames.join(0, world, others.address, kind)
        sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
        scene, opts = scenes.port_scene(r.cfg)
        tally = multicard.Tally().start()
        service = frames.ShardedFrames(scene, opts, device=dev)
        rays = counts.frame_rays(r.counts())

        warm = views.Views(r.cfg, [r.seed, 2], r.traffic["jitter_px"])
        for _ in range(r.traffic["warmup"]):
            service.frame(scenes.port_camera(warm.next()))
        sync()
        setup_s = time.perf_counter() - r.started

        seq = views.Views(r.cfg, r.seed, r.traffic["jitter_px"])
        sample = Sample(r.traffic["judged_frames"], r.seed)

        def unit(k):
            view = seq.next()
            sample.offer(view, service.frame(scenes.port_camera(view)))

        window_at = time.time()
        trace_at = r.traffic["trace_after"] if r.trace else None
        loop = window.closed_loop(unit, r.seconds, sync, trace_at=trace_at,
                                  trace_units=r.traffic["trace_frames"], device=dev)
        r.frame_s = loop["times"][:trace_at]   # rank 0's untraced frames
        r.ranks = service.stop()
        _print_tally(0, tally.stop())
        print(f"window from wall {window_at:.3f} s", file=sys.stderr, flush=True)
        # NCCL tears a group down with every rank: this one first, then
        # the others can exit
        dist.destroy_process_group()
        code = others.wait(END_S)
        if code:
            raise RuntimeError(f"a rank exited {code} after the stop")
    n = len(loop["times"])
    e2e = {"render_rays_per_s": n * rays / loop["span"],
           "frame_ms_p95": 1e3 * window.p95(loop["times"]), "setup_s": setup_s}
    peak = max(s["peak_bytes"] for s in r.ranks)
    kept = [(i, v, img.cpu()) for i, v, img in sample.kept]
    del service, sample
    if cuda:
        torch.cuda.empty_cache()

    from portbench.reference.whitted import Reference

    t_ref = time.perf_counter()
    ref = Reference(scenes.plain_scene(r.cfg), dev)
    readings = [compare.image_numbers(img, ref.image(v).cpu()) for _, v, img in kept]
    checks = compare.judge(compare.worst(readings), r.limits)
    ok = compare.passed(checks)
    failed = sum(not compare.passed(compare.judge(x, r.limits)) for x in readings)
    print(f"{r.cell}: {n} frames in {loop['span']:.4f} s on {world} ranks, {rays} rays "
          f"a frame (reference count), judged frames {[i for i, _, _ in kept]}, host "
          f"{loop['host']}, per rank (frames, peak bytes) "
          f"{[(s['frames'], s['peak_bytes']) for s in r.ranks]}, readings {readings}; "
          f"the reference took {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr, flush=True)
    return {"correct": ok, "attempted": n, "failed": failed,
            "e2e": e2e, "checks": checks, "trace": loop["trace"],
            "device": harness.device_info(r, peak)}
