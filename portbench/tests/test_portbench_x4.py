"""The 4-card cell on the CPU: its loop on 4 gloo ranks at a tiny frame,
sound and with a planted fault; its configuration against the one-card
one; a program without the frame service; the `parallel.*` readers on a
synthetic trace."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from portbench import harness, multicard, scenes
from portbench.reference import counts

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
CELL = "config4-render-1080p-d4-x4"
FAIL_FAST_S = 60.0   # a tree without the frame service fails in seconds


@pytest.mark.parametrize("fault", ["", "stale_band", "skip_gather"])
def test_loop_on_four_ranks(fault, monkeypatch):
    """One judged frame of the window on 4 gloo ranks: correct when sound,
    not correct when the last rank hands in its block of the frame before
    or when no rank gathers the image; every rank's aggregates reach the
    run, and rank 0's untraced frame times."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cfg = scenes.resized(scenes.load_config("config4_mesh_x4"), 64, 36, 4)
    run = harness.Run(CELL, 2**31 + 23, 0.0, False, torch.device("cpu"),
                      time.perf_counter(), cfg=cfg, faults=[fault] if fault else [])
    result, checks = harness.execute(run)
    assert result["correct"] is (not fault), checks
    json.dumps(result)
    e2e, _ = harness.metrics_of(harness.benchmark(), CELL)
    assert list(result["metrics"]) == [m["name"] for m in e2e]
    assert [s["rank"] for s in run.ranks] == [0, 1, 2, 3]
    assert len(multicard.band_ms(run)) == 4
    assert len(run.frame_s) == result["attempted"]


def test_configuration_is_config4_on_four_cards():
    """The scene tables and options are config4_mesh's, its frozen count
    too; the layout is the one `render_sharded` makes on the cell's cards."""
    from raytracer_tpu_torch.parallel.shard import rank_lanes, shard_layout

    one, four = scenes.load_config("config4_mesh"), scenes.load_config("config4_mesh_x4")
    for key in ("spheres", "planes", "materials", "lights", "camera", "opts", "mesh",
                "precision", "tracer", "reduced"):
        assert four[key] == one[key], key
    assert counts.load_counts("config4_mesh_x4", four, "cpu") == \
        counts.load_counts("config4_mesh", one, "cpu")
    lay, op = four["layout"], four["opts"]
    with open(os.path.join(PKG, "workloads", f"{CELL}.json")) as f:
        assert lay["tiles"] * lay["prims"] == lay["cards"] == json.load(f)["chips"]
    n_pix = op["width"] * op["height"]
    assert rank_lanes(n_pix, lay["tiles"]) == lay["rank_lanes"] == n_pix // 4
    assert shard_layout(n_pix, lay["tiles"], op["tile_rays"]) == (lay["rank_lanes"],) * 2


def _rank_processes_in(path: str) -> list:
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            if os.readlink(f"/proc/{pid}/cwd").startswith(path):
                found.append(pid)
        except OSError:
            pass
    return found


def test_program_without_the_frame_service_fails_at_once(tmp_path):
    """With a program tree that has no `parallel/frames.py` (the tree
    before the cell), the cell's run exits non-zero within seconds and
    leaves no process behind."""
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copytree(os.path.join(ROOT, "raytracer_tpu_torch"),
                    tmp_path / "raytracer_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    os.remove(tmp_path / "raytracer_tpu_torch" / "parallel" / "frames.py")
    shutil.copytree(os.path.join(ROOT, "assets"), tmp_path / "assets")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    script = (
        "import time, torch\n"
        "from portbench import harness, scenes\n"
        f"cfg = scenes.resized(scenes.load_config('config4_mesh_x4'), 32, 18, 2)\n"
        f"run = harness.Run({CELL!r}, 5, 0.2, False, torch.device('cpu'),\n"
        "                  time.perf_counter(), cfg=cfg)\n"
        "harness.execute(run)\n"
        "print('ran')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert time.monotonic() - t0 < FAIL_FAST_S
    assert out.returncode != 0 and "ran" not in out.stdout
    assert "frames" in out.stderr, out.stderr[-2000:]
    assert _rank_processes_in(str(tmp_path)) == []


def _agg(ms_each, count):
    """A span aggregate of `count` spans: the first 100 ms, then `ms_each`."""
    first = 100_000_000
    return {"count": count, "total_ns": first + int(ms_each * 1e6) * (count - 1),
            "first_ns": first}


def test_band_readers():
    slowest = harness.load_module("metrics", "parallel.band_ms_slowest.py")
    balance = harness.load_module("metrics", "parallel.band_balance.py")
    run = types.SimpleNamespace(ranks=[
        {"spans": {"rt.band": _agg(ms, 11)}} for ms in (5.0, 30.0, 40.0, 25.0)])
    assert multicard.band_ms(run) == pytest.approx([5.0, 30.0, 40.0, 25.0])
    assert slowest.read(None, run) == pytest.approx(40.0)
    assert balance.read(None, run) == pytest.approx(100.0 * 25.0 / 40.0)
    # a program without the spans, or a run that gathered nothing
    for empty in (types.SimpleNamespace(), types.SimpleNamespace(ranks=[
            {"spans": {}}] * 4), types.SimpleNamespace(ranks=[
            {"spans": {"rt.band": _agg(5.0, 1)}}] * 4)):
        assert slowest.read(None, empty) is None
        assert balance.read(None, empty) is None


def _ranks(band_ms, alive=()):
    """Aggregates of ranks with 11 bands of `band_ms` each, rank 0 one
    bounce a band, the others two, and `alive` ms a read (one a band)."""
    out = []
    for r, ms in enumerate(band_ms):
        spans = {"rt.band": _agg(ms, 11), "rt.bounce.0": _agg(1.0, 11)}
        if r:
            spans["rt.bounce.1"] = _agg(1.0, 11)
        if alive:
            spans["rt.alive"] = _agg(alive[r], 11)
        out.append({"rank": r, "spans": spans})
    return out


def test_collective_reader_is_rank_0s_frame_less_its_band():
    coll = harness.load_module("metrics", "parallel.collective_ms_per_frame.py")
    run = types.SimpleNamespace(ranks=_ranks((5.0, 30.0, 40.0, 25.0)),
                                frame_s=[0.044, 0.046, 0.045])
    assert coll.read(None, run) == pytest.approx(45.0 - 5.0)
    for empty in (types.SimpleNamespace(ranks=run.ranks),
                  types.SimpleNamespace(ranks=run.ranks, frame_s=[]),
                  types.SimpleNamespace(frame_s=run.frame_s)):
        assert coll.read(None, empty) is None


def test_slowest_rank_readers():
    """The bounces and the `rt.alive` wait a frame of the rank whose band
    is longest (rank 2 here), from its aggregate."""
    bounces = harness.load_module("metrics", "parallel.bounces_slowest.py")
    alive = harness.load_module("metrics", "parallel.alive_wait_ms_slowest.py")
    run = types.SimpleNamespace(ranks=_ranks((5.0, 30.0, 40.0, 25.0),
                                             alive=(0.5, 1.0, 3.0, 2.0)))
    assert bounces.read(None, run) == pytest.approx(2.0)
    assert alive.read(None, run) == pytest.approx(3.0)
    run.ranks[1]["spans"]["rt.band"] = _agg(50.0, 11)   # now rank 1 is slowest
    assert alive.read(None, run) == pytest.approx(1.0)
    run = types.SimpleNamespace(ranks=_ranks((5.0, 30.0, 40.0, 25.0)))
    assert alive.read(None, run) is None                # no rt.alive spans
    for empty in (types.SimpleNamespace(), types.SimpleNamespace(ranks=[
            {"spans": {}}] * 4)):
        assert bounces.read(None, empty) is None
        assert alive.read(None, empty) is None


def test_tally_samples_a_rank_until_stopped():
    tally = multicard.Tally(every_s=0.01).start()
    time.sleep(0.05)
    samples = tally.stop()
    assert len(samples) >= 2 and all(len(x) == 6 for x in samples)
    assert [x[0] for x in samples] == sorted(x[0] for x in samples)
