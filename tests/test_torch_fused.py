"""PyTorch port: the fused Whitted forward (`raytracer_tpu_torch/ops/fused.py`)
against the JAX `FusedWhitted` in Pallas interpret mode.

The same numpy-built scenes go through both packages. On the CPU the port
renders with its plain torch version (`fused_whitted_plain`); the CUDA kernel
is held against that version on the card (tests/test_torch_kernels.py,
chip_smoke.py). Tolerances are tests/test_fused.py's; plan planes may differ
on knife-edge pixels only (≤0.5% per plane, chip_smoke.py's ID_MAX_DIFF).
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu.models import presets
from raytracer_tpu.ops import fused as jfused
from raytracer_tpu_torch.ops import fused as tfused
from tests.helpers import assert_images_close
from tests.torch_cases import port

torch.set_num_threads(2)

PLAN_MAX_DIFF = 0.005


def _pair(scene, cam, opts, param_inputs=False):
    ref = jfused.FusedWhitted(scene, cam, opts, interpret=True,
                              param_inputs=param_inputs)
    got = tfused.FusedWhitted(*port(scene, cam, opts), device="cpu",
                              param_inputs=param_inputs)
    return ref, got


def assert_plans_close(ref, got, n_nodes):
    """Win and occ planes equal except on ≤0.5% of pixels per plane."""
    for kind, want, have in (("win", ref[1], got[1]), ("occ", ref[2], got[2])):
        assert len(want) == len(have) == n_nodes, (kind, len(want), len(have))
        for k, (a, b) in enumerate(zip(want, have)):
            a = np.asarray(a)
            b = b.numpy()
            assert a.shape == b.shape and b.dtype == np.int32
            frac = float((a != b).mean())
            assert frac <= PLAN_MAX_DIFF, f"{kind} plane {k}: {frac:.4%} differ"


def _opts(name, w, h, depth):
    scene, cam, opts = presets.PRESETS[name]()
    return scene, cam, dataclasses.replace(opts, width=w, height=h,
                                           max_depth=depth)


def test_config1_render_and_plan():
    scene, cam, opts = _opts("config1", 64, 64, 0)
    ref, got = _pair(scene, cam, opts)
    img = got.render()
    assert img.shape == (64, 64, 3) and img.dtype == torch.float32
    assert_images_close(img.numpy(), np.asarray(ref.render()), tol=1e-5,
                        max_bad_frac=0.002, name="config1")
    want, have = ref.render_plan(), got.render_plan()
    assert_images_close(have[0].numpy(), np.asarray(want[0]), tol=1e-5,
                        max_bad_frac=0.002, name="config1 plan")
    assert_plans_close(want, have, 1)
    assert torch.equal(have[0], img)  # the plan does not change the image


def test_config2_mirror_checker_plan():
    scene, cam, opts = _opts("config2", 48, 48, 2)
    ref, got = _pair(scene, cam, opts)
    want, have = ref.render_plan(), got.render_plan()
    img, want_img = have[0].numpy(), np.asarray(want[0])
    assert_images_close(img, want_img, tol=1e-2, max_bad_frac=0.0005,
                        name="config2")
    assert np.abs(img - want_img).mean() < 1e-4
    assert_plans_close(want, have, 3)
    assert torch.equal(got.render(), have[0])


def test_config5_param_mode_after_bind():
    init, target, cam, opts = presets.config5_inverse()
    opts = dataclasses.replace(opts, width=32, height=32)
    ref, got = _pair(init, cam, opts, param_inputs=True)
    center = np.asarray(target.spheres.center) + np.float32(0.05)
    albedo = np.asarray(target.materials.albedo)
    for fw in (ref, got):
        fw.bind(center=center, albedo=albedo)
    want, have = ref.render_plan(), got.render_plan()
    # XLA:CPU contracts multiply-adds into FMAs, the port rounds each op:
    # a few specular pixels differ by ~2e-5; a wrong table read is O(0.1)
    assert_images_close(have[0].numpy(), np.asarray(want[0]), tol=1e-4,
                        max_bad_frac=0.002, name="config5 bound")
    assert_plans_close(want, have, 1)
    # the bound values moved the image: it is not the init scene's
    init_img = tfused.FusedWhitted(*port(init, cam, opts),
                                   device="cpu").render()
    assert float((have[0] - init_img).abs().max()) > 0.1


def test_band_split_concatenates_to_full_frame():
    scene, cam, opts = _opts("config2", 40, 37, 1)
    fw = tfused.FusedWhitted(*port(scene, cam, opts), device="cpu")
    full_img, full_win, full_occ = fw.render_plan()
    bands = [fw.render_plan(row0=r0, rows=rows)
             for r0, rows in ((0, 13), (13, 5), (18, 19))]
    np.testing.assert_allclose(torch.cat([b[0] for b in bands]).numpy(),
                               full_img.numpy(), atol=1e-6, rtol=0)
    for k in range(2):
        assert torch.equal(torch.cat([b[1][k] for b in bands]), full_win[k])
        assert torch.equal(torch.cat([b[2][k] for b in bands]), full_occ[k])
    assert torch.equal(fw.render(row0=13, rows=5), bands[1][0])
    with pytest.raises(ValueError, match="outside"):
        fw.render(row0=30, rows=10)


def test_supported_gate():
    for name in ("config1", "config2", "config3"):
        assert tfused.supported(port(*presets.PRESETS[name]())[0])
    case4 = port(*presets.config4_mesh(use_obj=False))
    assert not tfused.supported(case4[0])
    with pytest.raises(ValueError, match="tiny"):
        tfused.FusedWhitted(*case4, device="cpu")


def test_glass_depth_cap():
    scene, cam, opts = _opts("config3", 8, 8, tfused.MAX_GLASS_DEPTH + 1)
    with pytest.raises(ValueError, match="capped"):
        tfused.FusedWhitted(*port(scene, cam, opts), device="cpu")
    ok = dataclasses.replace(opts, max_depth=tfused.MAX_GLASS_DEPTH)
    fw = tfused.FusedWhitted(*port(scene, cam, ok), device="cpu")
    assert fw.n_nodes == 63


def test_plan_light_cap_and_bind_without_param_mode():
    scene, cam, opts = _opts("config1", 8, 8, 0)
    pscene, pcam, popts = port(scene, cam, opts)
    fw = tfused.FusedWhitted(pscene, pcam, popts, device="cpu")
    with pytest.raises(ValueError, match="param_inputs"):
        fw.bind(center=np.zeros((1, 3), np.float32))
    from raytracer_tpu_torch.core.types import Lights

    many = pscene.replace(lights=Lights.build(
        np.tile(pscene.lights.pos, (33, 1)),
        np.tile(pscene.lights.intensity, (33, 1)) / 33))
    fw = tfused.FusedWhitted(many, pcam, popts, device="cpu")
    assert fw.render().shape == (8, 8, 3)  # no plan: any light count
    with pytest.raises(ValueError, match="int32 bits"):
        fw.render_plan()


def _bind_values(ref, rng):
    ns, np_, nm, nl = (ref._psph.shape[0], ref._ppln.shape[0],
                       ref._pmat.shape[0], ref._plgt.shape[0])
    u = lambda *shape: rng.uniform(0.1, 0.9, shape).astype(np.float32)
    return dict(center=u(ns, 3), radius=u(ns), albedo=u(nm, 3), kd=u(nm),
                ks=u(nm), spec_n=u(nm), ior=u(nm), plane_point=u(np_, 3),
                plane_normal=u(np_, 3), plane_albedo2=u(np_, 3),
                light_pos=u(nl, 3), light_intensity=u(nl, 3))


@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config5"])
def test_tables_and_bind_equal_reference(name):
    if name == "config5":
        scene, _, cam, opts = presets.config5_inverse()
    else:
        scene, cam, opts = presets.PRESETS[name]()
    opts = dataclasses.replace(opts, width=16, height=16)
    ref, got = _pair(scene, cam, opts, param_inputs=True)

    def check():
        for attr, tab in (("_psph", got.sph), ("_ppln", got.pln),
                          ("_pmat", got.mat), ("_plgt", got.lgt)):
            want = np.asarray(getattr(ref, attr))
            have = tab.numpy()
            assert have.dtype == want.dtype == np.float32, attr
            assert have.shape == want.shape, (attr, have.shape, want.shape)
            assert np.array_equal(have.view(np.int32), want.view(np.int32)), \
                attr

    check()
    if name == "config3":  # no planes: one zero row, count 0
        assert got.pln.shape == (1, 9) and not got.pln.any()
        assert got.counts[1] == 0
    vals = _bind_values(ref, np.random.default_rng(7))
    ref.bind(**vals)
    assert got.bind(**vals) is got
    check()


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: this checks the CPU-only refusal")
    scene, cam, opts = _opts("config1", 8, 8, 0)
    before = tfused.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfused.FusedWhitted(*port(scene, cam, opts), device="cuda")
    assert tfused.launches == before


LIVE_KEYS = ("live", "live_s", "live_p", "live_t", "live_diffuse",
             "live_leaf", "reflect", "refract")


@pytest.mark.parametrize("name,w,h,depth", [("config2", 32, 24, 2),
                                            ("config3", 24, 24, 4)])
def test_search_live_counts_equal_replay(name, w, h, depth):
    """The forward's search counts the same live nodes (those whose radiance
    reaches a pixel) as the train replay of its own plan; the shadow tests
    of the three kernel modes nest (image ⊆ live plan ⊆ full plan)."""
    scene, cam, opts = _opts(name, w, h, depth)
    fw = tfused.FusedWhitted(*port(scene, cam, opts), device="cpu",
                             param_inputs=True)
    search, replay = {}, {}
    img, plan = tfused.fused_whitted_plain(fw, 0, h, emit_plan=True,
                                           stats=search)
    n = fw.n_nodes
    tfused.fused_train_plain(fw, 0, h, plan[:n], plan[n:], img,
                             stats=replay)
    for key in LIVE_KEYS:
        assert int(search.get(key, 0)) == int(replay.get(key, 0)), key
    assert 0 < int(search["reflect"]) and int(search["live"]) < n * h * w
    for kind in "spt":
        lit, live, full = (int(search.get(f"{p}shadow_{kind}", 0))
                           for p in ("lit_", "live_", ""))
        assert lit <= live <= full, kind
    assert int(search["live_shadow_s"]) < int(search["shadow_s"])
