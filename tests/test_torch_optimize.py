"""PyTorch port: `cli optimize`'s trainers on the CPU — autograd through the
wavefront (no flag) against the JAX CLI's losses step for step, the
fused-plan replay (`--plan`) against it, and mesh training (`--preset
mesh`) lowering its loss. (`--kernel`: tests/test_torch_fused_train.py.)
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

from raytracer_tpu import cli as jcli
from raytracer_tpu_torch import cli as tcli
from raytracer_tpu_torch.io.image import load_ppm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    text = out.getvalue()
    return [json.loads(line)["loss"] for line in text.splitlines()
            if line.startswith('{"step"')], text


def test_cli_optimize_autograd_and_plan_match_reference(tmp_path):
    steps = ["--steps", "10", "--log-every", "1"]
    want, _ = _run(jcli.main, ["optimize", *steps, "--out",
                               str(tmp_path / "ref.png")])
    have, text = _run(tcli.main, ["optimize", *steps, "--device", "cpu",
                                  "--out", str(tmp_path / "port.ppm")])
    assert len(want) == len(have) == 10
    # Adam in two libraries over ten steps: the losses part by the updates'
    # rounding only
    np.testing.assert_allclose(have, want, rtol=1e-4)
    assert have[9] < 0.5 * have[0]
    assert "recovered albedos" in text
    assert load_ppm(str(tmp_path / "port.ppm")).shape == (128, 128, 3)
    plan, _ = _run(tcli.main, ["optimize", "--plan", *steps, "--device",
                               "cpu", "--out", str(tmp_path / "plan.ppm")])
    np.testing.assert_allclose(plan[0], have[0], rtol=1e-5)
    np.testing.assert_allclose(plan, have, rtol=1e-4)


def test_cli_optimize_mesh_lowers_the_loss(tmp_path):
    losses, text = _run(tcli.main, [
        "optimize", "--preset", "mesh", "--steps", "5", "--log-every", "1",
        "--device", "cpu", "--out", str(tmp_path / "m.ppm")])
    assert len(losses) == 5 and losses[-1] < losses[0]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    vis = [float(m) for m in re.findall(r"visible (\d+\.\d+)", text)]
    assert len(vis) == 2 and vis[1] < vis[0]  # init → recovered
    assert load_ppm(str(tmp_path / "m.ppm")).shape == (96, 96, 3)


def test_cli_optimize_mesh_recovers_geometry(tmp_path):
    """tests/test_grads.py::test_inverse_mesh_preset_recovers_geometry in
    the port, its thresholds: 30 steps lower the loss by a fifth and the
    camera-visible vertex error by 15%."""
    losses, text = _run(tcli.main, [
        "optimize", "--preset", "mesh", "--steps", "30", "--log-every", "1",
        "--device", "cpu", "--out", str(tmp_path / "m.ppm")])
    assert losses[-1] < 0.8 * losses[0]
    vis = [float(m) for m in re.findall(r"visible (\d+\.\d+)", text)]
    assert len(vis) == 2 and vis[1] < 0.85 * vis[0]


def test_cli_optimize_needs_the_card_unless_told(tmp_path):
    cmd = [sys.executable, "-m", "raytracer_tpu_torch.cli", "optimize",
           "--steps", "1", "--out", str(tmp_path / "x.ppm")]
    for flags in ([], ["--plan"], ["--preset", "mesh"]):
        if torch.cuda.is_available():
            break
        r = subprocess.run(cmd + flags, cwd=ROOT, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode != 0 and "no CUDA device" in r.stderr, flags
        assert not (tmp_path / "x.ppm").exists()
