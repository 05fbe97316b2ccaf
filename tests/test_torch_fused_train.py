"""PyTorch port: the fused train step against the JAX reference.

The same plan — recorded by the JAX `FusedWhitted.render_plan` in Pallas
interpret mode and carried across through numpy — goes into the reference's
train kernel (`_train_vg`, interpret mode: jax.value_and_grad traced inside
the kernel body) and into the port's plain version (`fused_train_plain`:
torch autograd over the same replay tree). The port's CUDA kernel is held
against that plain version on the card (tests/test_torch_kernels.py,
chip_smoke.py); its adjoint is checked against finite differences in
tests/test_torch_fused_train_fd.py.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from raytracer_tpu import cli as jcli
from raytracer_tpu.models import presets
from raytracer_tpu.ops import fused as jfused
from raytracer_tpu.renderer import render as jrender
from raytracer_tpu_torch import cli as tcli
from raytracer_tpu_torch.ops import fused as tfused
from tests.torch_cases import port

torch.set_num_threads(2)

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4  # of each table's largest entry
# The sphere table's gradient runs through the recomputed t (dt/dc grows as
# 1/sqrt(disc) toward a silhouette) and through sharp specular lobes
# (spec_n up to 60), where f32 rounding is amplified: on these frames both
# versions sit 2e-4 to 8e-4 of its max from a float64 replay of the same plan
# (tests/test_torch_fused_train_fd.py holds the port to that replay), so
# they cannot agree to 1e-4. The centers and the radii are each held against
# their own largest entry, just above the gap read here (XLA:CPU contracts
# multiply-adds into FMAs, the port rounds every op): config5 centers
# 6.3e-4, radii 1.02e-3; config2 centers 1.05e-3, radii 1.50e-3.
SPHERE_TOL = {"config5": (8e-4, 1.3e-3), "config2": (1.3e-3, 2e-3)}
def _reference_and_port(scene, cam, opts, target, bind=None):
    """→ (reference loss, grads), (port loss, grads), port object: both
    trained on the reference's plan."""
    ref = jfused.FusedWhitted(scene, cam, opts, interpret=True,
                              param_inputs=True)
    fw = tfused.FusedWhitted(*port(scene, cam, opts), device="cpu",
                             param_inputs=True)
    if bind:
        ref.bind(**bind)
        fw.bind(**bind)
    _, wins, occs = ref.render_plan()
    h = opts.height
    want = ref._train_vg(0, h, 0.0, ref._psph, ref._ppln, ref._pmat,
                         ref._plgt, wins, occs, target)
    to_t = lambda planes: [torch.from_numpy(np.array(x)) for x in planes]
    got = tfused.fused_train_plain(fw, 0, h, to_t(wins), to_t(occs),
                                   torch.from_numpy(np.array(target)))
    return want, got, fw


def _case(name):
    if name == "config5":
        init, goal, cam, opts = presets.config5_inverse()
        target = np.asarray(jrender(goal, cam, opts)[0])
        bind = dict(center=np.asarray(goal.spheres.center) + np.float32(0.05),
                    albedo=np.full((3, 3), 0.4, np.float32))
        return init, cam, opts, target, bind
    scene, cam, opts = presets.PRESETS["config2"]()
    opts = dataclasses.replace(opts, width=64, height=48, max_depth=1)
    target = np.asarray(jrender(scene, cam, opts)[0]) * np.float32(0.9)
    return scene, cam, opts, target, None


@pytest.mark.parametrize("name", ["config5", "config2"])
def test_train_plain_matches_reference_on_its_plan(name):
    scene, cam, opts, target, bind = _case(name)
    (l0, g0), (l1, g1), fw = _reference_and_port(scene, cam, opts, target,
                                                 bind)
    np.testing.assert_allclose(float(l1), float(l0), rtol=LOSS_RTOL)
    center_tol, radius_tol = SPHERE_TOL[name]
    for k in ("sph", "pln", "mat", "lgt"):
        want, have = np.asarray(g0[k]), g1[k].numpy()
        assert have.shape == want.shape and have.dtype == np.float32, k
        groups = ([("centers", want[:, :3], have[:, :3], center_tol),
                   ("radii", want[:, 3], have[:, 3], radius_tol)]
                  if k == "sph" else [(k, want, have, GRAD_TOL)])
        for part, a, b, tol in groups:
            scale = np.abs(a).max()
            assert scale > 0, part
            np.testing.assert_allclose(b / scale, a / scale, rtol=0,
                                       atol=tol, err_msg=part)
    # own-loss consistency: the step's loss is the L2 of its own image
    loss, _, img = fw.plan_value_and_grad(target)
    own = float(((img.double() - torch.from_numpy(np.array(target)).double())
                 ** 2).sum())
    np.testing.assert_allclose(float(loss), own, rtol=1e-4)


def _losses(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return [json.loads(line)["loss"] for line in out.getvalue().splitlines()
            if line.startswith('{"step"')]


def test_cli_optimize_kernel_matches_reference(tmp_path):
    steps = ["--steps", "10", "--log-every", "1"]
    want = _losses(jcli.main, ["optimize", "--kernel", *steps, "--out",
                               str(tmp_path / "ref.png")])
    have = _losses(tcli.main, ["optimize", "--kernel", *steps, "--device",
                               "cpu", "--out", str(tmp_path / "port.png")])
    assert len(want) == len(have) == 10
    np.testing.assert_allclose(have, want, rtol=1e-3)
    assert have[9] < 0.5 * have[0]
    assert (tmp_path / "port.png").stat().st_size > 0
