"""PyTorch port: `cli optimize --supervise` on the CPU — children that crash
every 3 steps (`--fault-after-steps`) are restarted with `--resume` and end
with the losses of an uncrashed supervised run (tests/test_elastic.py:89's
rtol 1e-6), for the autograd and the `--kernel` trainers; every trainer flag
reaches the child; a child that finds no GPU is not restarted.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import cli as tcli
from raytracer_tpu_torch.utils.hostload import NO_DEVICE_EXIT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """Child processes (workers, supervised children) start torch with two
    threads, as this process runs: the suite runs several files at once."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


@pytest.mark.parametrize("flags", [[], ["--kernel"]],
                         ids=["autograd", "kernel"])
def test_optimize_supervised_survives_crashes(tmp_path, capfd, flags):
    def run(ck, out, *extra):
        tcli.main(["optimize", *flags, "--steps", "8", "--lr", "5e-2",
                   "--ckpt-every", "2", "--log-every", "1", "--device",
                   "cpu", "--checkpoint", str(tmp_path / ck), "--supervise",
                   "--out", str(tmp_path / out), *extra])
        o, e = capfd.readouterr()
        steps = {}
        for ln in o.splitlines():          # later children win on re-run
            if ln.startswith('{"step"'):   # steps (exact resume: the same)
                d = json.loads(ln)
                steps[d["step"]] = d["loss"]
        return steps, e

    crashed, err = run("ck1", "a.ppm", "--fault-after-steps", "3")
    assert err.count("restarting with --resume") >= 2
    assert err.count("injected fault after 3 steps") >= 2
    assert sorted(crashed) == list(range(8))
    clean, err2 = run("ck2", "b.ppm")
    assert "restarting" not in err2
    assert sorted(clean) == list(range(8))
    for s in range(8):
        np.testing.assert_allclose(crashed[s], clean[s], rtol=1e-6)


def test_supervisor_forwards_every_trainer_flag(tmp_path, monkeypatch):
    """The child gets each trainer flag (`--kernel` among them), absolute
    paths, and `--resume` from the first restart on."""
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append((cmd, kw))
        return subprocess.CompletedProcess(cmd, 43 if len(cmds) == 1 else 0)

    monkeypatch.setattr(subprocess, "run", fake_run)
    monkeypatch.chdir(tmp_path)
    tcli.main(["optimize", "--kernel", "--steps", "7", "--lr", "0.03",
               "--ckpt-every", "3", "--log-every", "2", "--checkpoint", "ck",
               "--out", "r.png", "--supervise", "--fault-after-steps", "2",
               "--device", "cuda:1"])
    assert len(cmds) == 2
    (first, kw), (second, _) = cmds
    assert first[:4] == [sys.executable, "-m", "raytracer_tpu_torch.cli",
                         "optimize"]
    assert kw["cwd"] == ROOT

    def opt(cmd, flag):
        return cmd[cmd.index(flag) + 1]

    want = {"--preset": "spheres", "--steps": "7", "--lr": "0.03",
            "--ckpt-every": "3", "--log-every": "2", "--device": "cuda:1",
            "--fault-after-steps": "2", "--out": str(tmp_path / "r.png"),
            "--checkpoint": str(tmp_path / "ck")}
    for flag, value in want.items():
        assert opt(first, flag) == value, flag
    assert "--kernel" in first and "--plan" not in first
    assert "--supervise" not in first
    assert "--resume" not in first and second == first + ["--resume"]


def test_supervised_child_needs_the_card_unless_told(tmp_path):
    """Without `--device cpu` on a machine without a GPU the child exits
    with "no CUDA device" and is not restarted."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    r = subprocess.run(
        [sys.executable, "-m", "raytracer_tpu_torch.cli", "optimize",
         "--steps", "1", "--checkpoint", str(tmp_path / "ck"), "--supervise",
         "--out", str(tmp_path / "x.ppm")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stderr.count("no CUDA device") == 1
    assert f"exit {NO_DEVICE_EXIT}); not restarting" in r.stderr
    assert not (tmp_path / "x.ppm").exists()
