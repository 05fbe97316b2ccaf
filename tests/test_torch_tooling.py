"""PyTorch port: the tooling on the CPU — checkpoint/resume of `cli
optimize` (tests/test_checkpoint.py's standard, for the four trainers: no
flag, `--kernel`, `--plan` and `--preset mesh`), the profiler trace and `top_ops`, `timed`, and the
render flags `--tile-block`, `--grid`, `--tracer grid-pallas` and the
refusals of `--resilient`; the builders' required device.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from raytracer_tpu import cli as jcli
from raytracer_tpu_torch import cli as tcli
from raytracer_tpu_torch.accel.bvh import build_bvh
from raytracer_tpu_torch.accel.grid import build_grid
from raytracer_tpu_torch.io.image import load_ppm, to_u8
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.renderer import render_banded
from raytracer_tpu_torch.utils import checkpoint, profiling
from raytracer_tpu_torch.utils.hostload import build_tracer

torch.set_num_threads(2)

RESUME_RTOL = 1e-6  # tests/test_elastic.py:89's standard for exact resume


def _run(main, argv):
    """`main(argv)` in-process → ({step: loss}, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    text = out.getvalue()
    steps = {}
    for line in text.splitlines():
        if line.startswith('{"step"'):
            d = json.loads(line)
            steps[d["step"]] = d["loss"]
    return steps, text


def _ckpt(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_state_close(a, b):
    """Two checkpoints' contents (nested dicts, lists and tensors) equal at
    RESUME_RTOL."""
    if isinstance(a, torch.Tensor):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RESUME_RTOL,
                                   atol=0)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_state_close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_state_close(x, y)
    elif isinstance(a, float):
        np.testing.assert_allclose(a, b, rtol=RESUME_RTOL)
    else:
        assert a == b


# trainer flags, steps of the first run, steps in all, --lr
TRAINERS = {"spheres": ([], 5, 8, "5e-2"),
            "kernel": (["--kernel"], 5, 8, "5e-2"),
            "plan": (["--plan"], 3, 5, "5e-2"),
            "mesh": (["--preset", "mesh"], 3, 5, None)}


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Each trainer run twice — `first` steps, then `--resume` to `total` —
    and once straight through `total`, with --ckpt-every 2 → {name: (first
    run's losses, resumed run's losses and stdout, uninterrupted losses,
    both checkpoint dirs)}."""
    out = {}
    for name, (flags, first, total, lr) in TRAINERS.items():
        d = tmp_path_factory.mktemp(name)
        base = ["optimize", *flags, "--log-every", "1", "--ckpt-every", "2",
                "--device", "cpu", *(["--lr", lr] if lr else [])]
        ck, ck2 = str(d / "ck"), str(d / "ck2")
        s1, _ = _run(tcli.main, base + ["--steps", str(first), "--checkpoint",
                                        ck, "--out", str(d / "a.ppm")])
        s2, text = _run(tcli.main, base + ["--steps", str(total), "--resume",
                                           "--checkpoint", ck, "--out",
                                           str(d / "b.ppm")])
        s3, _ = _run(tcli.main, base + ["--steps", str(total), "--checkpoint",
                                        ck2, "--out", str(d / "c.ppm")])
        out[name] = (s1, s2, text, s3, ck, ck2)
    return out


@pytest.mark.parametrize("name", list(TRAINERS))
def test_resume_continues_the_uninterrupted_run(resumed, name):
    """Run → stop → --resume continues at the next step with the state of
    an uninterrupted run: losses step for step and the last checkpoint's
    parameters, Adam moments and (mesh) schedule at rtol 1e-6."""
    _, first, total, _ = TRAINERS[name]
    s1, s2, text, s3, ck, ck2 = resumed[name]
    last = first - 1
    assert sorted(s1) == list(range(first))
    assert f"resumed from step {last} at {os.path.abspath(ck)}" in text
    assert sorted(s2) == list(range(first, total))
    assert sorted(s3) == list(range(total))
    for i in range(total):
        np.testing.assert_allclose((s1 | s2)[i], s3[i], rtol=RESUME_RTOL)
    # the newest two checkpoints stay: the last step and the one before
    want_files = [f"step_{total - 2 - total % 2:08d}.pt",
                  f"step_{total - 1:08d}.pt"]
    assert sorted(os.listdir(ck)) == sorted(os.listdir(ck2)) == want_files
    a = _ckpt(os.path.join(ck, want_files[-1]))
    b = _ckpt(os.path.join(ck2, want_files[-1]))
    assert a["step"] == b["step"] == total - 1
    assert ("scheduler" in a) == (name == "mesh")
    _assert_state_close(a, b)


def test_resumed_losses_match_the_jax_cli(resumed, tmp_path):
    """The 8 losses of the stopped-and-resumed spheres run against the JAX
    CLI's uninterrupted run (tests/test_torch_optimize.py's rtol 1e-4)."""
    s1, s2, *_ = resumed["spheres"]
    want, _ = _run(jcli.main, ["optimize", "--steps", "8", "--lr", "5e-2",
                               "--log-every", "1", "--out",
                               str(tmp_path / "ref.png")])
    have = s1 | s2
    assert sorted(want) == sorted(have) == list(range(8))
    np.testing.assert_allclose([have[i] for i in range(8)],
                               [want[i] for i in range(8)], rtol=1e-4)


def test_restore_fills_the_optimizers_own_leaves(tmp_path):
    """`checkpoint.restore` writes into the leaves the optimizer holds and
    loads its state; `latest` finds the newest step."""
    p = {"w": torch.zeros(3, requires_grad=True)}
    opt = torch.optim.Adam([p["w"]], lr=0.1)
    p["w"].grad = torch.ones(3)
    opt.step()
    for step in (0, 2, 4):
        checkpoint.save(str(tmp_path), step, p, {"optimizer": opt})
    assert sorted(os.listdir(tmp_path)) == ["step_00000002.pt",
                                            "step_00000004.pt"]
    q = {"w": torch.zeros(3, requires_grad=True)}
    opt2 = torch.optim.Adam([q["w"]], lr=0.1)
    leaf = q["w"]
    step, path = checkpoint.latest(str(tmp_path))
    assert step == 4
    assert checkpoint.restore(path, q, {"optimizer": opt2}, "cpu") == 4
    assert q["w"] is leaf and torch.equal(leaf, p["w"].detach())
    assert torch.equal(opt2.state[leaf]["exp_avg"],
                       opt.state[p["w"]]["exp_avg"])
    assert checkpoint.latest(str(tmp_path / "none")) is None


# ------------------------------------------------------------- profiling ----


def test_trace_writes_a_trace_that_top_ops_ranks(tmp_path):
    d = str(tmp_path / "trace")
    _, text = _run(tcli.main, [
        "render", "--config", "config4", "--width", "32", "--height", "18",
        "--max-depth", "1", "--trace", d, "--device", "cpu", "--out",
        str(tmp_path / "t.ppm")])
    assert f"device trace written to {d}" in text
    rows = profiling.top_ops(d, k=10, device_only=False)
    assert len(rows) == 10
    assert [r[1] for r in rows] == sorted((r[1] for r in rows),
                                          reverse=True)
    aten = [r for r in rows if r[0].startswith("aten::")]
    assert aten and all(secs > 0 and n >= 1 for _, secs, n in aten)
    assert profiling.top_ops(d, device_only=True) == []  # no card here
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        printed = profiling.print_top_ops(d, k=3, device_only=False)
    assert printed == rows[:3] and "# top-3 total" in buf.getvalue()


def test_top_ops_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.top_ops(str(tmp_path))


# ----------------------------------------------------------------- flags ----


def _cli_image(tmp_path, tag, *flags):
    out = str(tmp_path / f"{tag}.ppm")
    tcli.main(["render", "--config", "config4", "--width", "32", "--height",
               "18", "--max-depth", "1", "--device", "cpu", "--out", out,
               *flags])
    return load_ppm(out)


def test_tile_block_grid_and_grid_pallas_render_the_grid_image(tmp_path):
    """`--tile-block 6x32` (3 tiles) is bit-equal to the flat frame, and
    `--grid` and `--tracer grid-pallas` render the grid tracer's image."""
    scene, cam, opts = presets.PRESETS["config4"]()
    opts = dataclasses.replace(opts, width=32, height=18, max_depth=1)
    tracer = build_tracer(scene, "grid", "cpu")
    flat = dataclasses.replace(opts, tile_rays=6 * 32)
    block = dataclasses.replace(opts, tile_rays=6 * 32, tile_block=(6, 32))
    a, ra = render_banded(scene, cam, flat, device="cpu", tracer=tracer,
                          count_rays=True)
    b, rb = render_banded(scene, cam, block, device="cpu", tracer=tracer,
                          count_rays=True)
    assert torch.equal(a, b) and float(ra) == float(rb)
    with contextlib.redirect_stdout(io.StringIO()):
        want = _cli_image(tmp_path, "grid", "--tracer", "grid")
        for tag, flags in (("block", ["--tile-block", "6x32"]),
                           ("alias", ["--grid"]),
                           ("gp", ["--tracer", "grid-pallas"])):
            np.testing.assert_array_equal(_cli_image(tmp_path, tag, *flags),
                                          want, err_msg=tag)
    # the grid image is the one a flat in-process render writes
    np.testing.assert_array_equal(np.round(want * 255.0).astype(np.uint8),
                                  to_u8(a))


@pytest.mark.parametrize("flags,msg", [
    (["--trace", "x"], "--resilient does not support --trace "
                       "(workers are separate processes)"),
    (["--tracer", "fused"], "--resilient does not support --tracer fused "
                            "(the fused megakernel replaces the banded "
                            "renderer the workers run)")])
def test_resilient_refuses_trace_and_fused(flags, msg):
    with pytest.raises(SystemExit) as e:
        tcli.main(["render", "--config", "config1", "--resilient",
                   "--device", "cpu", *flags])
    assert str(e.value) == msg


@pytest.mark.parametrize("build", [build_grid, build_bvh])
def test_builders_need_a_device(build):
    scene = presets.PRESETS["config4"]()[0]
    verts = np.asarray(scene.meshes.verts)
    tris = np.asarray(scene.meshes.tris)[:64]
    with pytest.raises(TypeError, match="device"):
        build(verts, tris)
    assert build(verts, tris, device="cpu") is not None
