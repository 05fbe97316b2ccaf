"""The harness's arithmetic and its layout, on the CPU."""

import json
import os
import shutil
import statistics
import subprocess
import sys

import pytest

from portbench import harness, profiler, window
from portbench.reference.counts import walk_bytes

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def _event(name, ts_us, dur_us, cat, **args):
    return {"ph": "X", "name": name, "ts": ts_us, "dur": dur_us, "cat": cat,
            "args": args, "tid": 1}


def test_idle_share_is_the_union_of_device_intervals():
    events = [_event(profiler.SPAN, 0, 100, "user_annotation"),
              _event(profiler.SPAN, 100, 100, "user_annotation"),
              _event("k1", 10, 30, "kernel", correlation=1),
              _event("k2", 20, 40, "kernel", correlation=2),     # overlaps k1
              _event("copy", 120, 10, "gpu_memcpy", correlation=3),
              _event("set", 180, 40, "gpu_memset", correlation=4),  # past the window
              _event("aten::mul", 60, 50, "cpu_op")]
    tr = profiler.Trace(events)
    assert tr.units == 2
    assert tr.window_s() == pytest.approx(200e-6)
    assert tr.busy_s() == pytest.approx((50 + 10 + 20) * 1e-6)
    assert tr.idle_share() == pytest.approx(1 - 80 / 200)
    gaps = dict(tr.idle_gaps())
    # the gap 60..120 is labelled by the host operation at its midpoint
    assert gaps["aten::mul"] == pytest.approx(60e-6)
    assert sum(gaps.values()) == pytest.approx(120e-6)


def test_p95_counts_every_frame():
    steady = [0.010] * 19
    stalled = steady[:10] + [0.500] + steady[10:]
    assert window.p95(stalled) > window.p95(steady + [0.010])
    # the median of chunks of 5 frames does not see the stall
    chunks = lambda t: statistics.median(statistics.median(t[i:i + 5])
                                         for i in range(0, len(t), 5))
    assert chunks(stalled) == chunks(steady + [0.010])


def test_walk_bytes_do_not_depend_on_launches_or_padding():
    counts = {"nearest": [1000, 40], "shadow": [[600, 300], [10, 0]], "triangles": 20}
    # the same frame traced in more launches: empty searches, padding lanes
    padded = {"nearest": [1000, 40, 0, 0], "shadow": [[600, 300], [10, 0], [0, 0], [0, 0]],
              "triangles": 20}
    assert walk_bytes(padded) == walk_bytes(counts)
    assert walk_bytes(counts) == (1000 + 40 + 600 + 300 + 10) * 32 + 5 * 20 * 36


def test_cell_files_agree_with_the_benchmark():
    for w in harness.benchmark()["workloads"]:
        with open(os.path.join(PKG, "workloads", f"{w['name']}.json")) as f:
            own = json.load(f)
        assert {k: own[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}


def test_no_card_means_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "config4-render-1080p-d4", "--seed", str(2**31 + 3),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == harness.NO_DEVICE_EXIT
    assert out.stdout == ""


def test_a_cell_is_added_by_new_files_only(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files (and entries in BENCHMARK.json) are found and run."""
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    before = {p: open(p, "rb").read() for p in
              (str(x) for x in (tmp_path / "portbench").rglob("*") if x.is_file())}
    new = tmp_path / "portbench"
    cfg = json.loads((new / "configs" / "config3_cornell.json").read_text())
    cfg["name"] = "cornell_small"
    (new / "configs" / "cornell_small.json").write_text(json.dumps(cfg))
    traffic = json.loads((new / "traffic" / "subpixel_frames.json").read_text())
    (new / "traffic" / "still_frames.json").write_text(json.dumps(dict(traffic, jitter_px=0.0)))
    (new / "workloads" / "cornell-still.json").write_text(json.dumps(
        {"config": "cornell_small", "traffic": "still_frames", "chips": 1, "why": "a test",
         "limits": {"px_off": 0.01}}))
    (new / "metrics" / "frame_loop.frames_seen.py").write_text(
        "def read(trace, run):\n    return 42.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "cornell_small", "source": "test", "reduced": [],
                             "file": "portbench/configs/cornell_small.json", "why": "test"})
    bench["workloads"].append({"name": "cornell-still", "config": "cornell_small",
                               "traffic": "still_frames", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("render_rays_per_s", "frame_ms_p95"):
            m["workloads"].append("cornell-still")
    bench["per_layer"].append({"name": "frame_loop.frames_seen", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "frame loop", "moves": "render_rays_per_s",
                               "workloads": ["cornell-still"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    script = (
        "import json, time, torch\n"
        "from portbench import harness, scenes\n"
        "cfg = scenes.resized(scenes.load_config('cornell_small'), 32, 32, 2)\n"
        "run = harness.Run('cornell-still', 9, 0.3, True, torch.device('cpu'),\n"
        "                  time.perf_counter(), cfg=cfg)\n"
        "res, checks = harness.execute(run)\n"
        "print(json.dumps({'res': res, 'e2e': [m['name'] for m in\n"
        "    harness.metrics_of(harness.benchmark(), 'cornell-still')[0]]}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert isinstance(got["res"]["correct"], bool)
    assert got["res"]["metrics"]["frame_loop.frames_seen"]["value"] == 42.0
    assert set(got["e2e"]) == {"render_rays_per_s", "frame_ms_p95", "setup_s"}
    for path, data in before.items():
        assert open(path, "rb").read() == data, f"{path} was edited"
