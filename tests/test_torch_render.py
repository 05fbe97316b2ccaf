"""PyTorch port: the wavefront renderer on the CPU against the committed
goldens (tests/test_forward_golden.py's tolerance) and, per pixel, against
the JAX renderer on the same scene.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracer_tpu.accel.grid import GridTracer as RefGridTracer
from raytracer_tpu.renderer import render as ref_render
from raytracer_tpu_torch.accel.grid import GridTracer
from raytracer_tpu_torch.io.image import load_ppm
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.renderer import render, render_banded
from raytracer_tpu_torch.utils.hostload import build_tracer
from tests.helpers import assert_images_close
from tests.torch_cases import port, subdiv3_config4

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")


@pytest.mark.parametrize("name,w,h", [("config1", 256, 256),
                                      ("config2", 96, 96),
                                      ("config3", 96, 96),   # glass doubling
                                      ("config7", 128, 128),
                                      ("config4", 192, 108)])
def test_golden(name, w, h):
    want = load_ppm(os.path.join(GOLDEN, f"{name}_{w}x{h}.ppm"))
    scene, cam, opts = presets.PRESETS[name]()
    opts = dataclasses.replace(opts, width=w, height=h)
    tracer = build_tracer(scene, "auto", "cpu")
    img, _ = render(scene, cam, opts, device="cpu", tracer=tracer)
    assert img.dtype == torch.float32
    assert_images_close(img.numpy(), want, tol=0.004, max_bad_frac=0.004,
                        name=name)


@pytest.fixture(scope="module")
def mesh_case():
    scene, cam, opts = subdiv3_config4()
    pscene, pcam, popts = port(scene, cam, opts)
    return scene, cam, opts, pscene, pcam, popts, GridTracer.build(pscene, "cpu")


def test_matches_reference_render_per_pixel(mesh_case):
    scene, cam, opts, pscene, pcam, popts, tracer = mesh_case
    want = np.asarray(ref_render(scene, cam, opts,
                                 tracer=RefGridTracer.build(scene))[0])
    got, _ = render(pscene, pcam, popts, device="cpu", tracer=tracer)
    assert_images_close(got.numpy(), want, tol=1e-4, max_bad_frac=0.004,
                        name="config4-subdiv3")


def test_render_banded_equals_render(mesh_case):
    *_, pscene, pcam, popts, tracer = mesh_case
    full, traced = render(pscene, pcam, popts, device="cpu", tracer=tracer,
                          count_rays=True)
    banded, btraced = render_banded(pscene, pcam, popts, device="cpu",
                                    tracer=tracer, count_rays=True,
                                    band_rows=13)
    assert torch.equal(banded, full)
    assert float(btraced) == float(traced) > popts.width * popts.height


def test_tile_block_order_equals_flat_tiles(mesh_case):
    *_, pscene, pcam, popts, tracer = mesh_case
    flat = dataclasses.replace(popts, tile_rays=640, tile_block=None)
    block = dataclasses.replace(popts, tile_rays=640, tile_block=(16, 40))
    a, _ = render(pscene, pcam, flat, device="cpu", tracer=tracer)
    b, _ = render(pscene, pcam, block, device="cpu", tracer=tracer)
    assert torch.equal(a, b)


def test_render_rejects_unported_compaction(mesh_case):
    """Compaction is ported: a fractional cap compacts the mirror bounces of
    the mesh scene to the uncompacted image bit for bit; what stays refused
    is a plan recorded from compacted (permuted) lanes."""
    *_, pscene, pcam, popts, tracer = mesh_case
    ocap = dataclasses.replace(popts, compact_cap=0.5)
    with pytest.raises(ValueError, match="compact_cap"):
        render(pscene, pcam, ocap, device="cpu", tracer=tracer,
               record_plan=True)
    img, traced, dropped = render(pscene, pcam, ocap, device="cpu",
                                  tracer=tracer, count_rays=True)
    full, ftraced = render(pscene, pcam, popts, device="cpu", tracer=tracer,
                           count_rays=True)
    assert float(dropped) == 0.0
    assert float(traced) == float(ftraced)
    assert torch.equal(img, full)


def test_cli_render(tmp_path):
    out = str(tmp_path / "c1.ppm")
    cmd = [sys.executable, "-m", "raytracer_tpu_torch.cli", "render",
           "--config", "config1", "--width", "64"]
    r = subprocess.run(cmd + ["--device", "cpu", "--out", out], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "config1: 64x64 depth=0" in r.stdout and "rays/s" in r.stdout
    assert load_ppm(out).shape == (64, 64, 3)
    if not torch.cuda.is_available():
        # the default device is cuda, and it does not fall back to the CPU
        r = subprocess.run(cmd + ["--out", str(tmp_path / "x.ppm")], cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert "no CUDA device" in r.stderr
        assert not (tmp_path / "x.ppm").exists()
