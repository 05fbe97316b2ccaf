"""PyTorch port: scene model, presets and io against the JAX reference."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracer_tpu.io.obj import load_obj as ref_load_obj
from raytracer_tpu.models import presets as ref_presets
from raytracer_tpu_torch.core.types import Camera, Scene, scene_from_arrays
from raytracer_tpu_torch.io.image import load_ppm, save_png, save_ppm
from raytracer_tpu_torch.io.obj import load_obj
from raytracer_tpu_torch.models import presets

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ("spheres", "planes", "meshes", "materials", "lights")


def _assert_same_arrays(ref, got):
    """Every field of a port dataclass equals the reference's, bit for bit."""
    for f in dataclasses.fields(got):
        a, b = np.asarray(getattr(ref, f.name)), np.asarray(getattr(got, f.name))
        assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=f.name)


def _assert_same_scene(ref, got):
    assert isinstance(got, Scene)
    assert got.has_glass == ref.has_glass
    for name in TABLES:
        _assert_same_arrays(getattr(ref, name), getattr(got, name))


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_preset_equals_reference(name):
    ref, got = ref_presets.PRESETS[name](), presets.PRESETS[name]()
    assert len(ref) == len(got)
    *ref_scenes, ref_cam, ref_opts = ref
    *scenes, cam, opts = got
    for r, g in zip(ref_scenes, scenes):
        _assert_same_scene(r, g)
    _assert_same_arrays(ref_cam, cam)
    # config4's and config3's tile is one frame on the card (PERF.md);
    # every other option is the reference's
    skip = {"config4": {"tile_rays", "tile_block"},
            "config3": {"tile_rays"}}.get(name, set())
    for f in dataclasses.fields(opts):
        if f.name not in skip:
            assert getattr(opts, f.name) == getattr(ref_opts, f.name), f.name


def test_scene_from_arrays_round_trip():
    scene, cam, _ = ref_presets.config3_cornell()
    got = scene_from_arrays(scene)
    _assert_same_scene(scene, got)
    gcam = scene_from_arrays(cam)
    assert isinstance(gcam, Camera)
    _assert_same_arrays(cam, gcam)
    # and back through the device copy: tensors hold the same bits
    dev = got.to("cpu")
    for name in TABLES:
        for f in dataclasses.fields(getattr(dev, name)):
            x = getattr(getattr(dev, name), f.name)
            assert isinstance(x, torch.Tensor)
            np.testing.assert_array_equal(
                x.numpy(), np.asarray(getattr(getattr(scene, name), f.name)))
    with pytest.raises(TypeError):
        scene_from_arrays(object())


def test_load_obj_equals_reference():
    path = os.path.join(ROOT, "assets", "blob.obj")
    ref, got = ref_load_obj(path), load_obj(path)
    for a, b in zip(ref, got):
        if a is None:
            assert b is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(b, a)


def test_ppm_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((7, 5, 3)).astype(np.float32)
    path = str(tmp_path / "x.ppm")
    save_ppm(path, torch.from_numpy(img))
    back = load_ppm(path)
    assert back.shape == img.shape
    assert np.abs(back - img).max() <= 0.5 / 255 + 1e-6


def test_png_writes_valid_file(tmp_path):
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(1)
    img = rng.random((6, 9, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    save_png(path, img)
    back = np.asarray(pil.open(path).convert("RGB"), np.float32) / 255.0
    assert back.shape == img.shape
    assert np.abs(back - img).max() <= 0.5 / 255 + 1e-6


def test_port_imports_no_jax():
    code = ("import sys; import raytracer_tpu_torch, raytracer_tpu_torch.cli, "
            "raytracer_tpu_torch.renderer, raytracer_tpu_torch.ops.walk; "
            "assert 'jax' not in sys.modules, 'jax imported'; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
