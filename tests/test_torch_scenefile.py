"""PyTorch port: the scene text format across both packages, supersampling,
and the CLI's `--scene`, `export` and `--tracer fused` on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu.io import scenefile as ref_scenefile
from raytracer_tpu.models import presets as ref_presets
from raytracer_tpu.renderer import render_ssaa as ref_render_ssaa
from raytracer_tpu_torch import cli
from raytracer_tpu_torch.io import scenefile
from raytracer_tpu_torch.io.image import load_ppm
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.ops import fused
from raytracer_tpu_torch.renderer import (render_banded, render_image,
                                          render_ssaa)
from tests.helpers import assert_images_close
from tests.test_torch_scene import _assert_same_arrays, _assert_same_scene
from tests.torch_cases import port

torch.set_num_threads(2)

CONFIGS = ["config1", "config2", "config3", "config7"]


def _assert_same_load(ref, got):
    (rs, rc, ro), (gs, gc, go) = ref, got
    _assert_same_scene(rs, gs)
    _assert_same_arrays(rc, gc)
    for f in dataclasses.fields(go):
        assert getattr(go, f.name) == getattr(ro, f.name), f.name


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_file_loads_in_port(name, tmp_path):
    path = str(tmp_path / f"{name}.txt")
    ref_scenefile.save_scene(path, *ref_presets.PRESETS[name]())
    _assert_same_load(ref_scenefile.load_scene(path),
                      scenefile.load_scene(path))


@pytest.mark.parametrize("name", CONFIGS)
def test_port_file_loads_in_reference(name, tmp_path):
    path = str(tmp_path / f"{name}.txt")
    scenefile.save_scene(path, *presets.PRESETS[name]())
    with open(path) as f:
        mine = f.read()
    ref_path = str(tmp_path / f"{name}_ref.txt")
    ref_scenefile.save_scene(ref_path, *ref_presets.PRESETS[name]())
    with open(ref_path) as f:
        assert f.read() == mine  # same text, byte for byte
    _assert_same_load(ref_scenefile.load_scene(path),
                      scenefile.load_scene(path))


def test_render_ssaa_matches_reference():
    scene, cam, opts = ref_presets.config1_sphere_plane()
    opts = dataclasses.replace(opts, width=32, height=32)
    want, want_rays = ref_render_ssaa(scene, cam, opts, factor=2,
                                      count_rays=True)
    got, rays = render_ssaa(*port(scene, cam, opts), device="cpu", factor=2,
                            count_rays=True)
    assert got.shape == (32, 32, 3)
    assert_images_close(got.numpy(), np.asarray(want), tol=1e-4,
                        max_bad_frac=0.004, name="ssaa2")
    assert float(rays) == float(want_rays)
    # bands of the supersampled frame concatenate to the one-band image
    banded, _ = render_ssaa(*port(scene, cam, opts), device="cpu", factor=2,
                            band_rows=7)
    np.testing.assert_allclose(banded.numpy(), got.numpy(), atol=1e-6,
                               rtol=0)


def test_render_image_is_render_banded():
    scene, cam, opts = presets.config2_mirror_spheres()
    opts = dataclasses.replace(opts, width=24, height=16)
    img = render_image(scene, cam, opts, device="cpu")
    want, _ = render_banded(scene, cam, opts, device="cpu")
    assert torch.equal(img, want)


def test_cli_render_fused_cpu(tmp_path, capsys):
    out = str(tmp_path / "c2.ppm")
    cli.main(["render", "--config", "config2", "--width", "40", "--height",
              "24", "--tracer", "fused", "--device", "cpu", "--out", out])
    printed = capsys.readouterr().out
    assert "config2: 40x24 depth=2" in printed and "fused kernel" in printed
    img = load_ppm(out)
    scene, cam, opts = presets.config2_mirror_spheres()
    opts = dataclasses.replace(opts, width=40, height=24)
    want = fused.FusedWhitted(scene, cam, opts, device="cpu").render()
    assert img.shape == (24, 40, 3)
    assert np.abs(img - want.numpy()).max() <= 0.5 / 255 + 1e-6


def test_cli_render_fused_ssaa_and_mesh_refusal(tmp_path, capsys):
    out = str(tmp_path / "c1.ppm")
    cli.main(["render", "--config", "config1", "--width", "16", "--tracer",
              "fused", "--ssaa", "2", "--device", "cpu", "--out", out])
    assert "ssaa=2" in capsys.readouterr().out
    assert load_ppm(out).shape == (16, 16, 3)
    with pytest.raises(SystemExit, match="not tiny"):
        cli.main(["render", "--config", "config4", "--width", "16",
                  "--tracer", "fused", "--device", "cpu", "--out", out])


def test_cli_export_then_render_scene(tmp_path, capsys):
    txt = str(tmp_path / "c1.txt")
    cli.main(["export", "--config", "config1", "--out", txt])
    _assert_same_load(presets.config1_sphere_plane(),
                      scenefile.load_scene(txt))
    out = str(tmp_path / "s.ppm")
    cli.main(["render", "--scene", txt, "--width", "24", "--device", "cpu",
              "--ssaa", "2", "--out", out])
    printed = capsys.readouterr().out
    assert f"{txt}: 24x24 depth=0 ssaa=2" in printed
    scene, cam, opts = presets.config1_sphere_plane()
    want, _ = render_ssaa(scene, cam, dataclasses.replace(
        opts, width=24, height=24), device="cpu", factor=2)
    assert np.abs(load_ppm(out) - want.numpy()).max() <= 0.5 / 255 + 1e-6
