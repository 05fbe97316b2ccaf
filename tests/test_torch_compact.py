"""PyTorch port: compacted wavefronts (`opts.compact_cap`) against the
uncompacted wavefront and the JAX reference (tests/test_compact.py's
cases), the plan-compacted glass replay against the reference's, and
`cli render --compact`.

The port folds a compacted lane back to its slot of the uncompacted buffer,
so with nothing dropped its image equals the uncompacted one bit for bit;
against the reference (which folds by a scatter-add on pixel ids) the
reference test's atol 1e-5 holds.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core.types import (DIFFUSE_AND_GLOSSY, REFLECTION,
                                      REFLECTION_AND_REFRACTION, Camera,
                                      Lights, Planes, RenderOptions, Spheres,
                                      make_scene)
from raytracer_tpu.models import presets as ref_presets
from raytracer_tpu.models.presets import _mats
from raytracer_tpu.ops import dgather as ref_dgather
from raytracer_tpu.ops import replay as ref_replay
from raytracer_tpu.renderer import render as ref_render
from raytracer_tpu_torch.io.image import load_ppm
from raytracer_tpu_torch.ops import fused as F
from raytracer_tpu_torch.ops import replay as R
from raytracer_tpu_torch.ops.dgather import permute_take
from raytracer_tpu_torch.renderer import (as_leaf, partition, render,
                                          render_banded, render_ssaa)
from tests.torch_cases import port, tt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5  # tests/test_compact.py: fold association only


def _cornell(side, depth=4, tile=None):
    scene, cam, opts = ref_presets.PRESETS["config3"]()
    opts = dataclasses.replace(opts, width=side, height=side, max_depth=depth,
                               tile_rays=tile or side * side)
    return scene, cam, opts


def _cap(opts, cap, **kw):
    return dataclasses.replace(opts, compact_cap=cap, **kw)


@pytest.mark.parametrize("cap", [1, 0.5])
def test_compact_matches_default(cap):
    scene, cam, opts = _cornell(32)
    ps, pc, po = port(scene, cam, opts)
    ref, n_ref = render(ps, pc, po, device="cpu", count_rays=True)
    img, n, drop = render(ps, pc, _cap(po, cap), device="cpu",
                          count_rays=True)
    assert float(drop) == 0.0
    assert float(n) == float(n_ref)  # the same live-lane count
    assert torch.equal(img, ref)     # slots fold as the uncompacted buffer
    want, _, want_drop = ref_render(scene, cam, _cap(opts, cap))
    assert float(want_drop) == 0.0
    np.testing.assert_allclose(img.numpy(), np.asarray(want), atol=ATOL)


def test_compact_multi_tile_and_bands():
    """8 strided tiles, bands of 8 rows and supersampling: the one-tile
    image, dropped summed over the bands."""
    scene, cam, opts = _cornell(32)
    ps, pc, po = port(scene, cam, opts)
    one, _, d1 = render(ps, pc, _cap(po, 1), device="cpu")
    strided, _, d8 = render(ps, pc, _cap(po, 1, tile_rays=128), device="cpu")
    banded, _, db = render_banded(ps, pc, _cap(po, 1, tile_rays=128),
                                  device="cpu", band_rows=8)
    assert float(d1) == float(d8) == float(db) == 0.0
    assert torch.equal(strided, one)
    assert torch.equal(banded, one)
    aa, _, da = render_ssaa(ps, pc, _cap(dataclasses.replace(
        po, width=16, height=16), 1, tile_rays=128), device="cpu",
        band_rows=8)
    want, _ = render_ssaa(ps, pc, dataclasses.replace(po, width=16,
                                                      height=16),
                          device="cpu")
    assert float(da) == 0.0 and torch.equal(aa, want)
    # against the reference's one-tile frame (its own scanned tiles part
    # from that by up to 5.2e-5 at this size: XLA's per-context association)
    want1 = ref_render(scene, cam, _cap(opts, 1))[0]
    np.testing.assert_allclose(strided.numpy(), np.asarray(want1), atol=ATOL)


@pytest.mark.parametrize("policy", ["plan", "full"])
def test_compact_gradients_match(policy):
    """tests/test_compact.py::test_compact_gradients_match, under both remat
    policies: d mean(img²) / d sphere centers with compaction equals the
    uncompacted gradient (rtol 1e-4, atol 1e-7)."""
    scene, cam, opts = _cornell(24, depth=3, tile=144)  # 4 tiles
    ps, pc, po = port(scene, cam, opts)
    po = dataclasses.replace(po, remat_policy=policy)

    def grad(o):
        c = as_leaf(ps.spheres.center, "cpu")
        sc = ps.to("cpu")
        sc = sc.replace(spheres=dataclasses.replace(sc.spheres, center=c))
        out = render(sc, pc, o, device="cpu")
        (out[0] ** 2).mean().backward()
        return c.grad, out

    g_ref, _ = grad(po)
    g_cmp, out = grad(_cap(po, 1))
    assert float(out[2]) == 0.0
    assert float(g_ref.abs().max()) > 0
    np.testing.assert_allclose(g_cmp.numpy(), g_ref.numpy(), rtol=1e-4,
                               atol=1e-7)


def _mirror_scene():
    mats = _mats(
        [(REFLECTION, (0, 0, 0), 0.0, 0.0, 25.0, 1.0),
         (DIFFUSE_AND_GLOSSY, (0.5, 0.3, 0.2), 0.8, 0.1, 10.0, 1.3)])
    scene = make_scene(
        spheres=Spheres.build([(0.0, 0.0, -6.0)], [1.0], [0]),
        planes=Planes.build([(0.0, -2.0, 0.0)], [(0.0, 1.0, 0.0)],
                            [(1.0, 0.0, 0.0)], [(0.0, 0.0, 1.0)], [1]),
        materials=mats,
        lights=Lights.build([(0.0, 6.0, 0.0)], [(1.0, 1.0, 1.0)]))
    cam = Camera.build(pos=(0.0, 0.0, 1.0), fov_deg=50.0)
    return scene, cam, RenderOptions(width=32, height=32, max_depth=2,
                                     tile_rays=1024)


def test_fractional_compact_mirror_scene():
    """A fractional cap compacts single-child (mirror) wavefronts: exact at
    0.5, and a starving cap reports the reference's drop count."""
    scene, cam, base = _mirror_scene()
    ps, pc, po = port(scene, cam, base)
    ref, n_ref = render(ps, pc, po, device="cpu", count_rays=True)
    img, n, drop = render(ps, pc, _cap(po, 0.5), device="cpu",
                          count_rays=True)
    assert float(drop) == 0.0
    assert float(n) == float(n_ref)
    assert torch.equal(img, ref)
    tiny = _cap(base, 1 / 1024)
    _, _, drop2 = render(ps, pc, _cap(po, 1 / 1024), device="cpu")
    want2 = ref_render(scene, cam, tiny)[2]
    assert float(drop2) > 0.0
    assert float(drop2) == float(want2)


def test_compact_overflow_reported():
    """A frame-filling glass sphere spawns 2 alive children per pixel at
    bounce 0: cap 1 drops lanes (the reference's count), cap 2 does not."""
    mats = _mats(
        [(REFLECTION_AND_REFRACTION, (0, 0, 0), 0.0, 0.0, 25.0, 1.5),
         (DIFFUSE_AND_GLOSSY, (0.5, 0.5, 0.5), 0.8, 0.1, 10.0, 1.3)])
    scene = make_scene(
        spheres=Spheres.build([(0.0, 0.0, -4.0)], [3.2], [0]),
        planes=Planes.build([(0.0, -3.5, 0.0)], [(0.0, 1.0, 0.0)],
                            [(1.0, 0.0, 0.0)], [(0.0, 0.0, 1.0)], [1]),
        materials=mats,
        lights=Lights.build([(0.0, 6.0, 0.0)], [(1.0, 1.0, 1.0)]))
    cam = Camera.build(pos=(0.0, 0.0, 1.0), fov_deg=50.0)
    opts = RenderOptions(width=32, height=32, max_depth=2, tile_rays=1024,
                         compact_cap=1)
    ps, pc, po = port(scene, cam, opts)
    _, _, drop1 = render(ps, pc, po, device="cpu")
    want1 = ref_render(scene, cam, opts)[2]
    assert float(drop1) > 0.0 and float(drop1) == float(want1)
    img2, _, drop2 = render(ps, pc, _cap(po, 2), device="cpu")
    assert float(drop2) == 0.0
    full, _ = render(ps, pc, _cap(po, None), device="cpu")
    assert torch.equal(img2, full)


@pytest.mark.parametrize("side", [256, pytest.param(512,
                                                    marks=pytest.mark.slow)])
def test_config3_shipping_cap_exact(side):
    """config3 at the shipping cap 0.5 (its preset's 16,384-ray strided
    tiles) drops no alive lane."""
    from raytracer_tpu_torch.models import presets

    scene, cam, opts = presets.PRESETS["config3"]()
    opts = dataclasses.replace(opts, width=side, height=side,
                               compact_cap=0.5)
    img, _, dropped = render(scene, cam, opts, device="cpu")
    assert float(dropped) == 0.0, (
        f"shipping cap 0.5 dropped {float(dropped)} alive lanes at {side}²")
    assert bool(torch.isfinite(img).all())


# --------------------------------------------------------------------------
# the compaction's pieces against the reference's

def _alive(n, seed):
    return np.random.default_rng(seed).random(n) < 0.3


@pytest.mark.parametrize("cap", [24, 64, 100])
def test_partition_matches_reference(cap):
    alive = _alive(100, 5)
    want = ref_replay._partition(jnp.asarray(alive), cap)
    got = partition(torch.from_numpy(alive), cap)
    for w, g, name in zip(want, got, ("order", "pos", "kept", "dropped")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_permute_take_matches_reference_vjp():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(100, 3)).astype(np.float32)
    ct = rng.normal(size=(24, 3)).astype(np.float32)
    order, pos, _, _ = ref_replay._partition(jnp.asarray(_alive(100, 5)), 24)
    want, vjp = jax.vjp(lambda a: ref_dgather.permute_take(a, order, pos),
                        jnp.asarray(x))
    (g_want,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = permute_take(xt, tt(order), tt(pos))
    got.backward(torch.from_numpy(ct))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(g_want))
    assert float(xt.grad.abs().sum()) > 0


def _glass_plan(side, depth, row0=0, rows=None):
    """config3's plan from the port's plain fused forward: (port scene,
    camera, options, (wins, occs), image), mesh-free (fused) scene."""
    scene, cam, opts = _cornell(side, depth)
    ps, pc, po = port(scene, cam, opts)
    img, wins, occs = F.FusedWhitted(ps, pc, po, device="cpu",
                                     param_inputs=True).render_plan(row0,
                                                                    rows)
    return scene, cam, opts, (wins, occs), img


def test_plan_compaction_matches_reference():
    scene, cam, opts, (wins, occs), _ = _glass_plan(16, 3)
    n0 = 256
    cap = 128
    rw = [jnp.asarray(w.reshape(-1).numpy()) for w in wins]
    ro = [jnp.asarray(o.reshape(-1).numpy()) for o in occs]
    planes, compacts, dropped = ref_replay._plan_compaction(
        (rw, ro), scene, n0, opts.max_depth, cap)
    ps = port(scene, cam, opts)[0].to("cpu")
    gp, gc, gd = R._plan_compaction(
        ([w.reshape(-1) for w in wins], [o.reshape(-1) for o in occs]), ps,
        n0, opts.max_depth, cap)
    assert float(gd) == float(dropped) == 0.0
    assert sum(c is not None for c in gc) >= 2  # compactions happen
    for b, ((w0, o0, p0), (w1, o1, s1)) in enumerate(zip(planes, gp)):
        np.testing.assert_array_equal(w1.numpy(), np.asarray(w0))
        np.testing.assert_array_equal(o1.numpy(), np.asarray(o0))
        np.testing.assert_array_equal((s1 % n0).numpy(), np.asarray(p0))
    for c0, c1 in zip(compacts, gc):
        assert (c0 is None) == (c1 is None)
        if c0 is not None:
            for a, b in zip(c0, c1):
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_compact_replay_equals_uncompacted_replay():
    """The plan-compacted replay (8 strided tiles) renders the uncompacted
    replay's image bit for bit, and K1's image to the fused standard."""
    scene, cam, opts, plan, img = _glass_plan(32, 4)
    ps, pc, po = port(scene, cam, opts)
    full, _ = R.replay_render(ps, pc, po, plan, device="cpu")
    comp, traced, dropped = R.replay_render(
        ps, pc, _cap(po, 0.5, tile_rays=128), plan, device="cpu")
    assert float(dropped) == 0.0 and float(traced) == 0.0
    assert torch.equal(comp, full)
    diff = (comp - img).abs().amax(dim=-1)
    assert float((diff > 1.0 / 255).float().mean()) <= 0.001


class _FixedPlan:
    """A planner for value_and_grad_replay that hands out one fixed plan
    (full-frame node planes [H, W]), band by band, to either package."""

    def __init__(self, wins, occs, conv):
        self.wins, self.occs, self.conv = wins, occs, conv

    def render_plan(self, row0=0, rows=None):
        sl = slice(row0, None if rows is None else row0 + rows)
        return (None, tuple(self.conv(w[sl]) for w in self.wins),
                tuple(self.conv(o[sl]) for o in self.occs))


def _with_params(s, p):
    return s.replace(spheres=dataclasses.replace(s.spheres, center=p["center"]),
                     materials=dataclasses.replace(s.materials,
                                                   albedo=p["albedo"]))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_glass_replay_vg_compact_matches_reference():
    """Glass value_and_grad_replay with compaction (cap 0.5, 2 bands, 2
    strided tiles each), the port's and the reference's fed one plan made
    by the port's plain fused forward: loss rtol 1e-5, gradients within
    2e-4 of their max. Depth 1: the reference's glass replay gradient does
    not compile in reasonable time on the CPU past that. The reference runs
    op by op: its jitted band program renders one pixel of this frame
    differently from its own op-by-op run (by 0.81, a knife edge of the
    recompute), as its jitted `_band_vg` does on the mesh scene
    (tests/test_torch_grads.py)."""
    scene, cam, opts, (wins, occs), img = _glass_plan(16, 1)
    opts = _cap(opts, 0.5, tile_rays=64)
    ps, pc, po = port(scene, cam, opts)
    target = (img * 0.9).numpy()
    params = {"center": np.asarray(scene.spheres.center),
              "albedo": np.asarray(scene.materials.albedo)}
    wins = [w.numpy() for w in wins]
    occs = [o.numpy() for o in occs]
    with jax.disable_jit():
        want_v, want_g = ref_replay.value_and_grad_replay(
            _with_params, params, scene, cam, opts, jnp.asarray(target),
            lambda p: _FixedPlan(wins, occs, jnp.asarray), band_rows=8)
    drops = []
    got_v, got_g = R.value_and_grad_replay(
        _with_params, params, ps, pc, po, torch.from_numpy(target),
        lambda p: _FixedPlan(wins, occs, torch.from_numpy), band_rows=8,
        device="cpu", dropped=drops)
    assert len(drops) == 2 and all(float(d) == 0.0 for d in drops)
    assert abs(float(got_v) - float(want_v)) <= 1e-5 * abs(float(want_v))
    for k in params:
        assert float(np.abs(np.asarray(want_g[k])).max()) > 0, k
        assert _rel(got_g[k], want_g[k]) <= 2e-4, k
    # and the port's compacted step equals its uncompacted step
    v2, g2 = R.value_and_grad_replay(
        _with_params, params, ps, pc, _cap(po, None), torch.from_numpy(target),
        lambda p: _FixedPlan(wins, occs, torch.from_numpy), band_rows=8,
        device="cpu")
    assert abs(float(v2) - float(got_v)) <= 1e-5 * abs(float(v2))
    for k in params:
        assert _rel(got_g[k], g2[k]) <= 2e-4, k


def test_cli_render_compact(tmp_path):
    out = str(tmp_path / "c3.ppm")
    cmd = [sys.executable, "-m", "raytracer_tpu_torch.cli", "render",
           "--config", "config3", "--compact", "0.5", "--width", "64",
           "--device", "cpu", "--out", out]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "config3: 64x64 depth=4" in r.stdout
    assert "WARNING" not in r.stdout
    ps, pc, po = port(*_cornell(64))
    want, _ = render(ps, pc, po, device="cpu")
    np.testing.assert_allclose(load_ppm(out), want.numpy(), atol=1 / 255 + 1e-6)
    # a starving cap warns
    r = subprocess.run(cmd[:7] + ["0.01"] + cmd[8:], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "WARNING: compaction dropped" in r.stdout
