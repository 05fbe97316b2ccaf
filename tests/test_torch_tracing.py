"""The port's own spans and lane counters (utils/profiling.span,
count_lanes) and the benchmark's readers of them (portbench/spans.py).

Config4 at 32×18 on the CPU, in the screen-block layout of 16×32 tiles
(two tiles, 448 padding lanes), so that the lane counts include padding.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, scenes, views
from portbench.profiler import Trace
from portbench.reference.counts import count_frame
from portbench.reference.whitted import Reference
from raytracer_tpu_torch import cli as tcli
from raytracer_tpu_torch.renderer import (block_perm, render_banded,
                                          value_and_grad_banded)
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils.hostload import build_tracer

torch.set_num_threads(2)

W, H, DEPTH, BLOCK = 32, 18, 4, (16, 32)
EPS_US = 0.01  # slack of the trace's microsecond timestamps


def _cfg():
    return scenes.resized(scenes.load_config("config4_mesh"), W, H, DEPTH)


def _scene():
    cfg = _cfg()
    scene, opts = scenes.port_scene(cfg)
    cam = scenes.port_camera(views.still(cfg))
    return cfg, scene, cam, opts, build_tracer(scene, "grid",
                                               torch.device("cpu"))


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One depth-4 frame in the block layout under torch.profiler → (cfg,
    scene, camera, opts, tracer, the trace's complete events, counters)."""
    cfg, scene, cam, opts, tracer = _scene()
    opts = dataclasses.replace(opts, tile_rays=BLOCK[0] * BLOCK[1],
                               tile_block=BLOCK)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        render_banded(scene, cam, opts, device="cpu", tracer=tracer)
    path = str(tmp_path_factory.mktemp("trace") / "frame.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    return cfg, scene, cam, opts, tracer, events, profiling.counters()


def _named(events, name):
    return [e for e in events if e["name"] == name]


def _inside(e, outer):
    return (e["tid"] == outer["tid"] and e["ts"] >= outer["ts"] - EPS_US
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + EPS_US)


def _ran(count):
    """[bounces run at each depth] from `count(name)` of the `rt.bounce.<d>`
    spans: every tile runs bounce 0, and a tile ends its loop at the first
    bounce whose children hold no live lane."""
    ran = [count(f"rt.bounce.{d}") for d in range(DEPTH + 1)]
    tiles = len(block_perm(H, W, *BLOCK)[0]) // (BLOCK[0] * BLOCK[1])
    assert ran[0] == tiles
    assert all(a >= b for a, b in zip(ran, ran[1:]))
    return ran


def test_a_frame_trace_nests_each_bounce_search_and_shadow(traced):
    _, scene, _, _, _, events, _ = traced
    frames = _named(events, "rt.frame")
    assert len(frames) == 1
    frame = frames[0]
    ran = _ran(lambda name: len(_named(events, name)))
    assert ran[1] > 0 and ran[DEPTH] == 0   # the mirror's bounce, no deeper
    searches = _named(events, "rt.search")
    shadows = _named(events, "rt.shadow")
    for d in range(DEPTH + 1):
        for b in _named(events, f"rt.bounce.{d}"):
            assert _inside(b, frame)
            assert sum(_inside(s, b) for s in searches) == 1
            assert sum(_inside(s, b) for s in shadows) == scene.lights.count
    assert len(shadows) == sum(ran) * scene.lights.count
    # one read of the children's lanes after each bounce that spawns them
    reads = _named(events, "rt.alive")
    assert len(reads) == sum(ran) - ran[DEPTH]
    assert all(_inside(r, frame) for r in reads)
    aten = [e for e in events
            if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    assert aten and all(_inside(e, frame) for e in aten)


class _Untouchable:
    def __getattr__(self, name):
        raise AssertionError(f"count_lanes touched the mask: .{name}")


def test_off_the_profiler_spans_enter_no_range_and_lanes_are_not_counted(
        traced, monkeypatch):
    _, scene, cam, opts, tracer, events, _ = traced

    def no_range(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not torch.autograd._profiler_enabled()
    profiling.reset()
    with profiling.span("rt.test"):
        profiling.count_lanes(0, _Untouchable(), 1)
    render_banded(scene, cam, opts, device="cpu", tracer=tracer)
    assert profiling.counters() == {}
    seen = profiling.spans()
    assert seen["rt.test"]["count"] == 1 and seen["rt.frame"]["count"] == 1
    ran = _ran(lambda name: seen.get(name, {"count": 0})["count"])
    # the bounces the profiled frame ran
    assert ran == [len(_named(events, f"rt.bounce.{d}"))
                   for d in range(DEPTH + 1)]
    assert seen["rt.search"]["count"] == sum(ran)
    assert seen["rt.shadow"]["count"] == sum(ran) * scene.lights.count
    assert seen["rt.alive"]["count"] == sum(ran) - ran[DEPTH]
    frame = seen["rt.frame"]
    assert 0 < frame["first_ns"] == frame["total_ns"]


def test_live_lanes_match_the_reference_counts_and_padding(traced):
    cfg, scene, _, _, _, events, counters = traced
    ref = count_frame(cfg, "cpu")
    perm, _ = block_perm(H, W, *BLOCK)
    n_pad = int((perm >= H * W).sum())
    assert n_pad > 0
    # the padding lanes all trace the tile layout's dummy ray: the camera's
    # position, direction (0, 0, -1)
    pad = {}
    plain = Reference(scenes.plain_scene(cfg), "cpu")
    o = torch.tensor(cfg["camera"]["pos"], dtype=torch.float32)
    plain.trace(o[None].expand(n_pad, 3).contiguous(),
                torch.tensor([[0.0, 0.0, -1.0]]).expand(n_pad, 3).contiguous(),
                torch.arange(n_pad), n_pad, counts=pad)

    def at(seq, d, zero=0):
        return seq[d] if d < len(seq) else zero

    lights = scene.lights.count
    ran = _ran(lambda name: len(_named(events, name)))
    tile = BLOCK[0] * BLOCK[1]
    for d in range(DEPTH + 1):
        want_near = at(ref["nearest"], d) + at(pad["nearest"], d)
        want = sum(at(ref["shadow"], d, [0] * lights)) \
            + sum(at(pad["shadow"], d, [0] * lights))
        if not ran[d]:
            # a bounce that did not run: the reference holds no lane there
            assert f"nearest.b{d}" not in counters
            assert want_near == want == 0, d
            continue
        live, sent = counters[f"nearest.b{d}"]
        assert sent == ran[d] * tile
        assert live == want_near > 0
        live_s, sent_s = counters[f"shadow.b{d}"]
        assert sent_s == ran[d] * tile * lights
        assert abs(live_s - want) <= max(0.005 * want, 2), (d, live_s, want)
    assert len(ref["nearest"]) < DEPTH + 1   # later bounces hold no lane


def test_cli_render_trace_holds_the_program_spans(tmp_path):
    d = str(tmp_path / "trace")
    with contextlib.redirect_stdout(io.StringIO()):
        tcli.main(["render", "--config", "config4", "--width", str(W),
                   "--height", str(H), "--max-depth", "1", "--trace", d,
                   "--device", "cpu", "--out", str(tmp_path / "t.ppm")])
    names = {e["name"] for e in profiling.trace_events(d)}
    assert {"rt.frame", "rt.bounce.0", "rt.bounce.1", "rt.search",
            "rt.shadow", "rt.surface", "rt.shade", "rt.spawn"} <= names


def test_a_plan_remat_step_spans_record_replay_and_backward(tmp_path):
    cfg, scene, cam, opts, tracer = _scene()
    opts = dataclasses.replace(opts, max_depth=1, width=W // 2, height=H // 2,
                               tile_rays=W * H // 4)
    assert opts.remat_tiles and opts.remat_policy == "plan"
    dscene = scene.to("cpu")
    params = {"center": dscene.spheres.center.clone(),
              "albedo": dscene.materials.albedo.clone()}

    def apply(s, p):
        return s.replace(
            spheres=dataclasses.replace(s.spheres, center=p["center"]),
            materials=dataclasses.replace(s.materials, albedo=p["albedo"]))

    target = torch.zeros((H // 2, W // 2, 3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, grads = value_and_grad_banded(apply, params, dscene, cam, opts,
                                            target, device="cpu",
                                            tracer=tracer)
    assert float(loss) > 0 and torch.isfinite(grads["albedo"]).all()
    prof.export_chrome_trace(str(tmp_path / "step.pt.trace.json"))
    n = {k: 0 for k in ("rt.value_and_grad", "rt.record", "rt.replay",
                        "rt.backward")}
    for e in profiling.trace_events(str(tmp_path)):
        if e["name"] in n:
            n[e["name"]] += 1
    # one tile: the replay runs in the forward and in the backward's recompute
    assert n == {"rt.value_and_grad": 1, "rt.record": 1, "rt.replay": 2,
                 "rt.backward": 1}


def test_counters_add_up_each_bounce_and_reset_clears_them():
    profiling.reset()
    first = torch.tensor([5, 2, 3])
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("rt.test"):
            profiling.count_lanes(0, first, 10)
            profiling.count_lanes(0, torch.tensor([1, 1, 0]), 10)
            profiling.count_lanes(1, torch.tensor([4, 0, 0]), 6)
    assert first.tolist() == [5, 2, 3]   # the caller's sums stay its own
    assert profiling.counters() == {"nearest.b0": (6, 20),
                                    "shadow.b0": (6, 40),
                                    "nearest.b1": (4, 6),
                                    "shadow.b1": (0, 12)}
    # the host aggregate stops at the first span under a profiler, until
    # a reset
    with profiling.span("rt.after"):
        pass
    assert profiling.spans() == {}
    profiling.reset()
    assert profiling.counters() == {} and profiling.spans() == {}
    with profiling.span("rt.after"):
        pass
    assert profiling.spans()["rt.after"]["count"] == 1


def _trace(rt_spans, launches, kernels):
    """A Chrome trace of one profiled unit [0, 1000] µs: `rt_spans` [(name,
    ts, dur)] on thread 1, runtime calls `launches` [(ts, correlation)] on
    thread 1, device `kernels` [(ts, dur, correlation)]."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.unit",
           "ts": 0.0, "dur": 1000.0, "tid": 1}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a,
            "dur": dur, "tid": 1} for n, a, dur in rt_spans]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": a, "dur": 1.0, "tid": 1, "args": {"correlation": c}}
           for a, c in launches]
    ev += [{"ph": "X", "cat": "kernel", "name": f"k{c}", "ts": a, "dur": dur,
            "tid": 7, "args": {"correlation": c}} for a, dur, c in kernels]
    return Trace(ev)


@pytest.mark.parametrize("name,want", [
    ("search.device_ms_per_frame", 0.030),   # k1 under rt.search, k3 rt.shadow
    ("shade.device_ms_per_frame", 0.020),    # k2: in the frame, not searching
    ("replay.record_device_ms", None),       # k5 is the lane count's
])
def test_readers_match_device_time_to_the_enclosing_span(name, want):
    tr = _trace([("rt.frame", 100.0, 500.0), ("rt.bounce.0", 110.0, 300.0),
                 ("rt.search", 120.0, 50.0), ("rt.shadow", 300.0, 50.0),
                 ("rt.count", 360.0, 20.0)],
                [(130.0, 1), (200.0, 2), (310.0, 3), (700.0, 4), (365.0, 5)],
                [(140.0, 10.0, 1), (210.0, 20.0, 2), (320.0, 20.0, 3),
                 (710.0, 40.0, 4), (370.0, 5.0, 5)])
    got = harness.load_module("metrics", f"{name}.py").read(tr, None)
    if want is None:
        assert got is None
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    # the parent program has no spans: nothing to read, nothing raised
    bare = _trace([], [(130.0, 1)], [(140.0, 10.0, 1)])
    assert harness.load_module("metrics", f"{name}.py").read(bare, None) \
        is None


@pytest.mark.parametrize("name,span_name", [
    ("frame_loop.host_ms_per_frame", "rt.frame"),
    ("replay.backward_host_ms", "rt.backward"),
    ("frame_loop.alive_wait_ms", "rt.alive"),
])
def test_host_readers_take_the_untraced_units_of_the_aggregate(
        name, span_name, monkeypatch):
    # before the profiler: the first took 2 s, ten more 70 ms each; the
    # traced unit holds one such span
    tr = _trace([(span_name, 100.0, 500.0)], [], [])
    agg = {span_name: {"count": 11, "total_ns": 2_000_000_000 + 700_000_000,
                       "first_ns": 2_000_000_000}}
    monkeypatch.setattr(profiling, "spans", lambda: agg)
    reader = harness.load_module("metrics", f"{name}.py")
    np.testing.assert_allclose(reader.read(tr, None), 70.0, rtol=1e-6)
    # only the first ran: nothing to read
    agg[span_name]["count"] = 1
    assert reader.read(tr, None) is None
    # the parent program keeps no aggregate: nothing read, nothing raised
    monkeypatch.delattr(profiling, "spans")
    assert reader.read(tr, None) is None


def test_frame_loop_readers_count_a_frames_bounces_and_reads(monkeypatch):
    # a frame of two bounces, each followed by a read; a third bounce ends
    # after the profiled unit, outside its window
    tr = _trace([("rt.frame", 100.0, 500.0), ("rt.bounce.0", 110.0, 200.0),
                 ("rt.alive", 310.0, 5.0), ("rt.bounce.1", 320.0, 200.0),
                 ("rt.alive", 530.0, 5.0), ("rt.bounce.2", 900.0, 200.0)],
                [], [])
    bounces = harness.load_module("metrics", "frame_loop.bounces_per_frame.py")
    assert bounces.read(tr, None) == 2.0
    wait = harness.load_module("metrics", "frame_loop.alive_wait_ms.py")
    # before the profiler: the first read took 1 ms, nine more 0.25 ms each
    monkeypatch.setattr(profiling, "spans", lambda: {
        "rt.alive": {"count": 10, "total_ns": 1_000_000 + 2_250_000,
                     "first_ns": 1_000_000}})
    np.testing.assert_allclose(wait.read(tr, None), 0.5, rtol=1e-6)
    # the parent program has no such spans: nothing read, nothing raised
    bare = _trace([("rt.frame", 100.0, 500.0)], [], [])
    monkeypatch.setattr(profiling, "spans", lambda: {})
    assert bounces.read(bare, None) is None and wait.read(bare, None) is None
