"""PyTorch port: the fused train step on its own — finite differences, band
linearity, input checks, the reference's gradient conventions at ties, and
`cli optimize`'s refusals.

Imports neither jax nor the JAX package (the cross-package checks are in
tests/test_torch_fused_train.py; a file of its own so that `--dist
loadfile` runs the two side by side). On the CPU the step's gradients come
from the plain version (`fused_train_plain`, torch autograd over the replay
tree); the CUDA kernel is held against it on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import cli
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.ops import fused as F

torch.set_num_threads(2)


def _fw(name, w, h, depth):
    scene, cam, opts = presets.PRESETS[name]()
    opts = dataclasses.replace(opts, width=w, height=h, max_depth=depth)
    fw = F.FusedWhitted(scene, cam, opts, device="cpu", param_inputs=True)
    return fw, scene, (fw.render() * 0.9).contiguous()


@pytest.mark.parametrize("name,w,h,depth,probes", [
    ("config2", 64, 48, 1, [("albedo", (0, 0)), ("center", (0, 1))]),
    # the glass box at depth 4 (31 nodes): sphere 1 is glass, so its center
    # reaches the loss through refraction and fresnel at every level
    ("config3", 32, 32, 4, [("albedo", (1, 1)), ("center", (1, 0))]),
])
def test_step_matches_central_differences(name, w, h, depth, probes):
    """Central differences of the whole step (bind → plan → loss), the plan
    re-recorded at every probe, against its analytic gradient; the
    reference's tolerance (tests/test_fused_vjp.py)."""
    fw, scene, target = _fw(name, w, h, depth)
    center = np.array(scene.spheres.center, np.float32)
    albedo = np.array(scene.materials.albedo, np.float32)

    def loss_at(c, a):
        fw.bind(center=c, albedo=a)
        return float(fw.plan_value_and_grad(target)[0])

    fw.bind(center=center, albedo=albedo)
    _, g, _ = fw.plan_value_and_grad(target)
    eps = 3e-4
    for key, (i, k) in probes:
        hi = {"center": center.copy(), "albedo": albedo.copy()}
        lo = {"center": center.copy(), "albedo": albedo.copy()}
        hi[key][i, k] += eps
        lo[key][i, k] -= eps
        fd = (loss_at(hi["center"], hi["albedo"])
              - loss_at(lo["center"], lo["albedo"])) / (2 * eps)
        got = float(g["sph" if key == "center" else "mat"][i, k])
        assert abs(got - fd) <= 0.05 * abs(fd) + 2e-3, (key, i, k, got, fd)


def _float64_replay(fw, plan, target):
    """The step's loss and gradients in float64: the port's replay tree on
    float64 copies of the tables and the eye rays, under the same plan."""
    h, n = fw.opts.height, fw.n_nodes
    leaves = tuple(t.detach().double().requires_grad_(True)
                   for t in (fw.sph, fw.pln, fw.mat, fw.lgt))
    o, d = F._eye_rays(fw, 0, h, 0.0)
    rad = F._tree(fw, F._Prims(fw, leaves), tuple(x.double() for x in o),
                  tuple(x.double() for x in d),
                  plan_in=([x.reshape(-1) for x in plan[:n]],
                           [x.reshape(-1) for x in plan[n:]]))
    t = target.reshape(-1, 3).double()
    loss = sum(((F._clip(rad[k], 0.0, 1.0) - t[:, k]) ** 2).sum()
               for k in range(3))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss), {k: torch.zeros_like(x) if g is None else g
                         for k, g, x in zip(("sph", "pln", "mat", "lgt"),
                                            grads, leaves)}


@pytest.mark.parametrize("name,w,h,depth,center_tol,radius_tol", [
    ("config2", 64, 48, 1, 1e-3, 1e-3),
    ("config3", 32, 32, 4, 8e-4, 1.5e-3),
])
def test_step_matches_a_float64_replay(name, w, h, depth, center_tol,
                                       radius_tol):
    """The f32 step against the same replay in float64. Plane, material
    and light gradients agree to 1e-5 of each table's max (read: ≤1.6e-6).
    The sphere centers and radii, each against its own max, are held just
    above the f32 error read here (config2 7.0e-4 and 8.3e-4, config3 6.2e-4
    and 1.29e-3): near silhouettes and in sharp specular lobes f32 rounding
    is amplified (tests/test_torch_fused_train.py)."""
    fw, _, target = _fw(name, w, h, depth)
    _, plan = F.fused_whitted_plain(fw, 0, h, emit_plan=True)
    n = fw.n_nodes
    loss, g = F.fused_train_plain(fw, 0, h, plan[:n], plan[n:], target)
    want_loss, want = _float64_replay(fw, plan, target)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    parts = [("centers", g["sph"][:, :3], want["sph"][:, :3], center_tol),
             ("radii", g["sph"][:, 3], want["sph"][:, 3], radius_tol)]
    parts += [(k, g[k], want[k], 1e-5) for k in ("pln", "mat", "lgt")]
    for part, have, exact, tol in parts:
        scale = float(exact.abs().max())
        if part == "pln" and not fw.counts[1]:
            assert scale == 0.0 and float(have.abs().max()) == 0.0
            continue
        err = float((have.double() - exact).abs().max())
        assert err <= tol * scale, (part, err / scale)


def test_every_table_class_gets_a_gradient():
    fw, _, target = _fw("config2", 64, 48, 1)
    _, g, _ = fw.plan_value_and_grad(target)
    assert float(g["pln"].abs().max()) > 0        # plane point/normal/albedo2
    assert float(g["lgt"].abs().max()) > 0        # light pos/intensity
    assert float(g["mat"][:, 3:5].abs().max()) > 0  # kd/ks
    assert float(g["sph"][:, 3].abs().max()) > 0  # radius


def test_bands_sum_to_the_full_frame():
    fw, _, target = _fw("config2", 40, 37, 1)
    full_loss, full_g, _ = fw.plan_value_and_grad(target)
    parts = [fw.plan_value_and_grad(target[r0:r0 + n], row0=r0, rows=n)
             for r0, n in ((0, 13), (13, 24))]
    np.testing.assert_allclose(sum(float(p[0]) for p in parts),
                               float(full_loss), rtol=1e-5)
    for k, want in full_g.items():
        have = parts[0][1][k] + parts[1][1][k]
        scale = float(want.abs().max())
        np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)
    assert torch.equal(parts[1][2], fw.render(row0=13, rows=24))


def test_step_checks_its_inputs():
    fw, _, target = _fw("config2", 16, 12, 1)
    with pytest.raises(ValueError, match="band"):  # a full frame for a band
        fw.plan_value_and_grad(target, row0=4, rows=8)
    with pytest.raises(ValueError, match="band"):
        fw.plan_value_and_grad(target[..., :2])
    scene, cam, opts = presets.PRESETS["config2"]()
    opts = dataclasses.replace(opts, width=16, height=12)
    baked = F.FusedWhitted(scene, cam, opts, device="cpu")
    with pytest.raises(ValueError, match="param_inputs"):
        baked.plan_value_and_grad(target)


def test_tie_gradients_follow_the_reference():
    """jax.grad's values at the ties (jax 0.9): clip(x, 0, 1) at 0 and at 1
    → 0.5, maximum(0, x) at 0 → 0.5, |x| at 0 → 1.0; torch.clamp would give
    1.0 and torch.abs 0.0."""
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    F._clip(x, 0.0, 1.0).sum().backward()
    assert x.grad.tolist() == [0.5, 0.5]
    for fn, want in ((lambda v: F._max(v, 0.0), 0.5), (F._abs, 1.0)):
        x = torch.tensor(0.0, requires_grad=True)
        fn(x).backward()
        assert float(x.grad) == want


@pytest.mark.parametrize("argv,item", [
    (["optimize", "--device", "cpu"], "item 5"),
    (["optimize", "--kernel", "--preset", "mesh", "--device", "cpu"],
     "item 10"),
])
def test_cli_optimize_names_what_is_not_ported(argv, item):
    with pytest.raises(SystemExit, match=item):
        cli.main(argv)
