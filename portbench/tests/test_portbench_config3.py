"""The cell `config3-render-1024-d4-compact` at a tiny size on the CPU:
a sound run is correct; each planted fault, the configuration at a cap
that drops live lanes, and the control (the reference in bfloat16) each
read not correct under the cell's limits; the compaction layer's readers
read the program's spans and counter, and nothing where the program has
none."""

import json
import os
import time

import numpy as np
import pytest
import torch

from portbench import harness, scenes, views
from portbench.profiler import Trace
from portbench.reference import compare
from portbench.reference.whitted import Reference

CELL, CONFIG = "config3-render-1024-d4-compact", "config3_cornell"
SIZE, DEPTH = 64, 4
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READERS = ("compact.fold_device_ms_per_frame",
           "compact.partition_device_ms_per_frame", "compact.kept_live_share")


def limits():
    with open(os.path.join(HERE, "workloads", f"{CELL}.json")) as f:
        return json.load(f)["limits"]


def tiny(cap=None):
    cfg = scenes.resized(scenes.load_config(CONFIG), SIZE, SIZE, DEPTH)
    if cap is not None:
        cfg = dict(cfg, opts=dict(cfg["opts"], compact_cap=cap))
    return cfg


def run_cell(cfg, faults=(), trace=False, seed=2**31 + 11):
    # a window of one frame after set-up (untraced): the judged frame is
    # the window's first, whatever the host's speed
    run = harness.Run(CELL, seed, 0.0, trace, torch.device("cpu"),
                      time.perf_counter(), cfg=cfg, faults=faults)
    return harness.execute(run)


@pytest.mark.parametrize("fault,cap", [
    ("", None),              # sound: the configuration's cap, 0.5
    ("stale_frame", None),
    ("half_frame", None),
    ("altered", None),
    ("", 0.2),               # a cap that drops live lanes
])
def test_fault_is_caught(fault, cap):
    result, checks = run_cell(tiny(cap), [fault] if fault else [])
    sound = not fault and cap is None
    assert result["correct"] is sound, checks
    json.dumps(result)   # the result line is plain JSON
    e2e, _ = harness.metrics_of(harness.benchmark(), CELL)
    assert list(result["metrics"]) == [m["name"] for m in e2e]


def test_the_dropping_cap_drops_lanes():
    from raytracer_tpu_torch.renderer import render_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer

    drops = {}
    for cap in (None, 0.2):
        cfg = tiny(cap)
        scene, opts = scenes.port_scene(cfg)
        tracer = build_tracer(scene, cfg["tracer"], "cpu")
        _, _, dropped = render_banded(scene, scenes.port_camera(views.still(cfg)),
                                      opts, device="cpu", tracer=tracer)
        drops[cap] = float(dropped)
    assert drops[None] == 0 and drops[0.2] > 0, drops


def test_control_fails_the_limits():
    """The reference in bfloat16, put in the program's place."""
    cfg = tiny()
    view = views.Views(cfg, 3, 0.5).next()
    plain = scenes.plain_scene(cfg)
    got = compare.image_numbers(Reference(plain, "cpu", torch.bfloat16).image(view).float(),
                                Reference(plain, "cpu").image(view))
    assert not compare.passed(compare.judge(got, limits())), got


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
    ("compact.fold_device_ms_per_frame", 0.030),        # k2 and k3 under rt.fold
    ("compact.partition_device_ms_per_frame", 0.040),   # k4 under rt.compact
])
def test_device_readers_match_device_time_to_their_span(name, want):
    reader = harness.load_module("metrics", f"{name}.py")
    tr = _trace([("rt.frame", 100.0, 800.0), ("rt.bounce.1", 110.0, 300.0),
                 ("rt.search", 120.0, 50.0), ("rt.fold", 200.0, 50.0),
                 ("rt.fold", 300.0, 50.0), ("rt.compact", 500.0, 100.0)],
                [(130.0, 1), (210.0, 2), (310.0, 3), (510.0, 4)],
                [(140.0, 10.0, 1), (220.0, 10.0, 2), (320.0, 20.0, 3),
                 (520.0, 40.0, 4)])
    np.testing.assert_allclose(reader.read(tr, None), want, rtol=1e-6)
    # the parent program has no `rt.fold`; a frame that never compacts has
    # neither span: nothing to read, nothing raised
    bare = _trace([("rt.frame", 100.0, 800.0), ("rt.bounce.0", 110.0, 300.0)],
                  [(130.0, 1)], [(140.0, 10.0, 1)])
    assert reader.read(bare, None) is None


def test_kept_live_share_reads_the_traced_frames_compactions(monkeypatch):
    from raytracer_tpu_torch.utils import profiling

    profiling.reset()
    result, checks = run_cell(tiny(), trace=True)
    assert result["correct"], checks
    got = profiling.compactions()
    assert sorted(got) == [f"compact.b{d}" for d in range(1, DEPTH + 1)]
    kept = sum(k for k, _, _ in got.values())
    cap = sum(c for _, c, _ in got.values())
    assert sum(x for _, _, x in got.values()) == 0 and 0 < kept < cap
    share = result["metrics"]["compact.kept_live_share"]
    assert share["unit"] == "%"
    np.testing.assert_allclose(share["value"], 100.0 * kept / cap, rtol=1e-12)
    # the CPU trace holds no device time: the device readers read nothing
    assert set(result["metrics"]) == {"compact.kept_live_share"}
    reader = harness.load_module("metrics", "compact.kept_live_share.py")
    # nothing compacted since the counts were cleared: nothing to read
    profiling.reset()
    assert reader.read(None, None) is None
    # the parent program keeps no compaction counter: nothing read or raised
    monkeypatch.delattr(profiling, "compactions")
    assert reader.read(None, None) is None


def test_the_cell_reports_its_metrics():
    bench = harness.benchmark()
    e2e, layer = harness.metrics_of(bench, CELL)
    assert {m["name"] for m in e2e} == {"render_rays_per_s", "frame_ms_p95", "setup_s"}
    assert {m["name"] for m in layer} == set(READERS)
    for m in layer:
        assert m["layer"] == "compaction" and m["moves"] == "render_rays_per_s"
        assert os.path.isfile(os.path.join(HERE, "metrics", f"{m['name']}.py"))
