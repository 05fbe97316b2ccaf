"""The multi-card frame service (raytracer_tpu_torch/parallel/frames.py) on
gloo ranks on the CPU: `ShardedFrames` over (tiles 4 × prims 1) and (tiles 2
× prims 1) against one device's `render_banded`, the stop flag, the spans
every rank hands rank 0, a rank that fails, and `cli render --cards`.

Every group starts once for the module (`spawn_ranks`, targets in
tests/torch_frames_worker.py), all at the fixture's start; the tests read
what rank 0 wrote, and compute the single-device references meanwhile.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import cli as tcli
from raytracer_tpu_torch.parallel import frames
from raytracer_tpu_torch.renderer import render_banded
from raytracer_tpu_torch.utils.hostload import build_tracer
from tests import torch_frames_worker as W

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120.0   # a group's whole run (~10 s alone)
SPANS = ("rt.view", "rt.band", "rt.gather", "rt.reduce")


class Groups:
    """The module's rank groups and `cli render` runs, started at once."""

    def __init__(self, out):
        self.dirs = {k: str(out / k) for k in ("t4", "t2", "fail", "cli")}
        for d in self.dirs.values():
            os.makedirs(d)
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OMP_NUM_THREADS", "1")
            self.ranks = {
                "t4": frames.spawn_ranks(4, W.frames_case, [self.dirs["t4"]],
                                         device_type="cpu"),
                "t2": frames.spawn_ranks(2, W.frames_case, [self.dirs["t2"]],
                                         device_type="cpu"),
                "fail": frames.spawn_ranks(4, W.failing_case,
                                           [self.dirs["fail"]],
                                           device_type="cpu")}
            self.started = time.monotonic()
            self.cli = {n: self._cli(n, os.path.join(self.dirs["cli"],
                                                     f"cards{n}.png"), ROOT)
                        for n in (1, 4)}
            # a relative --out typed in another directory than the package's
            self.cli["rel"] = self._cli(2, "rel.png", self.dirs["cli"])
        self.cli_outs = {}
        self.codes, self.ended = {}, {}

    @staticmethod
    def _cli(cards: int, out: str, cwd: str):
        path = [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
        return subprocess.Popen(
            [sys.executable, "-m", "raytracer_tpu_torch.cli", "render",
             "--config", "config4", "--width", str(W.W), "--height",
             str(W.H), "--cards", str(cards), "--device", "cpu", "--out", out],
            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    def wait(self, name: str) -> int:
        if name not in self.codes:
            self.codes[name] = self.ranks[name].wait(WAIT_S)
            self.ended[name] = time.monotonic()
        return self.codes[name]

    def images(self, name: str):
        assert self.wait(name) == 0, f"group {name} exited {self.codes[name]}"
        return np.load(os.path.join(self.dirs[name], "images.npy"))

    def report(self, name: str) -> list:
        assert self.wait(name) == 0
        with open(os.path.join(self.dirs[name], "report.json")) as f:
            return json.load(f)

    def close(self):
        for r in self.ranks.values():
            r.__exit__(None, None, None)
        for p in self.cli.values():
            if p.poll() is None:
                p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    g = Groups(tmp_path_factory.mktemp("frames"))
    yield g
    g.close()


@pytest.fixture(scope="module")
def want():
    """One device's `render_banded` of each view, with the grid."""
    scene, cam, opts = W.config4_small()
    tracer = build_tracer(scene, "grid", torch.device("cpu"))
    return [render_banded(scene, v, opts, device="cpu", tracer=tracer)[0].numpy()
            for v in W.views(cam)]


@pytest.mark.parametrize("view", range(len(W.YAWS)))
@pytest.mark.parametrize("layout", ["t4", "t2"])
def test_gathered_frame_equals_one_device(groups, want, layout, view):
    """Each view's gathered image on (tiles 4|2 × prims 1) equals one
    device's render of it bit for bit; the views differ, so each frame's
    view came through the broadcast."""
    got = groups.images(layout)
    assert got.shape == (len(W.YAWS), W.H, W.W, 3)
    np.testing.assert_array_equal(got[view], want[view])
    assert not np.array_equal(want[view], want[(view + 1) % len(want)])


@pytest.mark.parametrize("layout,world", [("t4", 4), ("t2", 2)])
def test_stop_ends_every_serve(groups, layout, world):
    """rank 0's stop ends each other rank's `serve()` after the frames it
    asked for, and every rank exits cleanly."""
    assert groups.wait(layout) == 0
    for r in range(1, world):
        with open(os.path.join(groups.dirs[layout], f"served_r{r}.json")) as f:
            assert json.load(f) == {"frames": len(W.YAWS)}
    assert all(p.exitcode == 0 for p in groups.ranks[layout].procs.values())


def test_spans_of_every_rank_reach_rank_0(groups):
    """The four multi-card spans are in rank 0's collected aggregates, one
    entry per rank: a view a frame and the stop's, a band, a gather and a
    reduce a frame; and each rank's bounces."""
    report = groups.report("t4")
    assert [r["rank"] for r in report] == [0, 1, 2, 3]
    for name in SPANS:
        per_rank = [r["spans"].get(name) for r in report]
        assert all(per_rank), name
        want_n = len(W.YAWS) + (name == "rt.view")
        assert [s["count"] for s in per_rank] == [want_n] * 4, name
        assert all(s["total_ns"] >= s["first_ns"] > 0 for s in per_rank)
    for r in report:
        assert r["frames"] == len(W.YAWS) and r["peak_bytes"] == 0
        assert r["spans"]["rt.bounce.0"]["count"] == len(W.YAWS)


def test_failing_rank_stops_the_group(groups):
    """A rank that raises mid-frame exits with an error; the launcher kills
    the ranks blocked in the frame's collectives and returns non-zero well
    inside its time limit, with no rank left running."""
    code = groups.wait("fail")
    assert code not in (0, frames.TIMEOUT_EXIT)
    assert groups.ended["fail"] - groups.started < WAIT_S
    procs = groups.ranks["fail"].procs
    assert procs[W.FAIL_RANK].exitcode == 1
    assert all(p.exitcode is not None for p in procs.values())
    assert not os.path.exists(os.path.join(groups.dirs["fail"], "images.npy"))


def test_watch_reports_a_failed_rank():
    """`Ranks.watch` calls back with the rank and its exit code when a rank
    fails, from its own thread (rank 0's main thread may be blocked in a
    collective then)."""
    seen = threading.Event()
    got = []
    with frames.spawn_ranks(1, W.raising_case, device_type="cpu") as ranks:
        ranks.watch(lambda rank, code: (got.append((rank, code)), seen.set()))
        assert seen.wait(WAIT_S)
    assert got == [(0, 1)]
    assert ranks.procs[0].exitcode == 1


def _cli_out(groups, name) -> str:
    """The `cli render` run's output, once it has exited with 0."""
    p = groups.cli[name]
    if name not in groups.cli_outs:
        groups.cli_outs[name] = p.communicate(timeout=WAIT_S)[0]
    assert p.returncode == 0, groups.cli_outs[name][-3000:]
    return groups.cli_outs[name]


def test_cli_cards_writes_the_one_card_image(groups):
    outs = {n: _cli_out(groups, n) for n in (1, 4)}
    with open(os.path.join(groups.dirs["cli"], "cards4.png"), "rb") as f:
        four = f.read()
    with open(os.path.join(groups.dirs["cli"], "cards1.png"), "rb") as f:
        assert f.read() == four
    assert "on 4 ranks" in outs[4]


def test_cli_cards_writes_a_relative_out_where_it_was_typed(groups):
    """`--out rel.png` typed in another directory than the package's lands
    there, whatever directory the ranks run in."""
    assert "on 2 ranks" in _cli_out(groups, "rel")
    assert not os.path.exists(os.path.join(ROOT, "rel.png"))
    _cli_out(groups, 1)
    with open(os.path.join(groups.dirs["cli"], "cards1.png"), "rb") as f:
        one = f.read()
    with open(os.path.join(groups.dirs["cli"], "rel.png"), "rb") as f:
        assert f.read() == one


@pytest.mark.parametrize("flags", [
    ["--resilient"], ["--ssaa", "2"], ["--compact", "0.5"],
    ["--tile-block", "16x32"], ["--tracer", "bvh"], ["--device", "cuda:1"]],
    ids=lambda f: f[0].lstrip("-"))
def test_cli_cards_refuses_what_it_cannot_split(flags):
    with pytest.raises(SystemExit) as e:
        tcli.main(["render", "--config", "config4", "--cards", "2",
                   "--out", "unused.png", *flags])
    assert "--cards 2" in str(e.value.code)


def test_cli_cards_refuses_a_scene_without_mesh():
    with pytest.raises(SystemExit) as e:
        tcli.main(["render", "--config", "config2", "--cards", "2",
                   "--device", "cpu", "--out", "unused.png"])
    assert "has no mesh" in str(e.value.code)
