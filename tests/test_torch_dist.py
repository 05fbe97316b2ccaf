"""PyTorch port, multi-device layer on 4 gloo ranks on the CPU: sharded
renders (tests/test_dist.py's cases), the bounce-pipelined backward
(tests/test_overlap.py's) and the sharded fused step
(tests/test_fused_vjp.py::test_kernel_vg_sharded_matches_single_device)
against the single-device port and the JAX package.

One group of 4 processes (tests/torch_dist_worker.py, jax-free) is started
once for the module, over a `file://` store in a temporary directory, and
runs every case; the tests here read the results it writes, each rank's on
its own, and compute the single-device and JAX references meanwhile.
"""

import dataclasses
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from raytracer_tpu.models import presets as ref_presets
from raytracer_tpu.parallel.mesh import make_rt_mesh as ref_make_rt_mesh
from raytracer_tpu.parallel.shard import render_sharded as ref_render_sharded
from raytracer_tpu_torch.accel.grid import GridTracer
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.ops.fused import FusedWhitted
from raytracer_tpu_torch.renderer import as_leaf, render
from tests import torch_dist_worker as W
from tests.helpers import assert_images_close

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
WORLD = 4
TIMEOUT_S = 300  # the whole group took ~11 s alone


class Group:
    """The worker processes of one gloo group and what they wrote."""

    def __init__(self, out_dir):
        self.dir = str(out_dir)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(WORLD),
             os.path.join(self.dir, "store"), self.dir],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
        self.logs = None

    def wait(self):
        """Each rank's (exit code, output); a rank past the deadline is
        killed."""
        if self.logs is None:
            deadline = time.monotonic() + TIMEOUT_S
            self.logs = []
            for p in self.procs:
                try:
                    out, _ = p.communicate(
                        timeout=max(1.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, _ = p.communicate()
                    out += f"\n[killed after {TIMEOUT_S} s]"
                self.logs.append((p.returncode, out))
        return self.logs

    def result(self, case: str, rank: int = 0) -> dict:
        logs = self.wait()
        path = os.path.join(self.dir, f"{case}_r{rank}")
        if os.path.exists(path + ".npz"):
            with np.load(path + ".npz") as z:
                return dict(z)
        if os.path.exists(path + ".err"):
            with open(path + ".err") as f:
                pytest.fail(f"{case} raised on rank {rank}:\n{f.read()}")
        rc, out = logs[rank]
        pytest.fail(f"{case}: rank {rank} wrote nothing (exit {rc}):\n"
                    f"{out[-4000:]}")

    def every_rank(self, case: str):
        return [self.result(case, r) for r in range(WORLD)]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = Group(tmp_path_factory.mktemp("torch_dist"))
    yield g
    g.wait()


def assert_ranks_equal(results):
    for r, res in enumerate(results[1:], 1):
        for k, v in results[0].items():
            np.testing.assert_array_equal(res[k], v, err_msg=f"rank {r} {k}")


@pytest.fixture(scope="module")
def single_config2():
    scene, cam, opts = W.config2_small()
    img, traced = render(scene, cam, opts, device="cpu", count_rays=True)
    return img.numpy(), float(traced)


# first in the file: the JAX references compile while the group runs
@pytest.mark.parametrize("ring", [False, True], ids=["t2p2", "t2p2r"])
def test_layout_matches_reference_render_sharded(group, ring):
    """The port's (2, 2) layouts against JAX `render_sharded` on 4 of the 8
    simulated devices, at tests/test_torch_render.py's standard."""
    scene, cam, opts = ref_presets.config2_mirror_spheres()
    opts = dataclasses.replace(opts, width=64, height=48, tile_rays=256)
    mesh = ref_make_rt_mesh(tiles=2, prims=2, devices=jax.devices()[:4])
    want = np.asarray(ref_render_sharded(scene, cam, opts, mesh,
                                         ring=ring)[0])
    got = group.result(W.layout_name(2, 2, ring))["img"]
    assert_images_close(got, want, tol=1e-4, max_bad_frac=0.004,
                        name=f"t2p2 ring={ring}")


@pytest.mark.parametrize("t,p,ring", W.LAYOUTS,
                         ids=[W.layout_name(*x) for x in W.LAYOUTS])
def test_layout_equals_single_device(group, single_config2, t, p, ring):
    """Every layout's image on every rank equals the single-device render
    bit for bit (the ring's too: its fold keeps the same tie order)."""
    res = group.every_rank(W.layout_name(t, p, ring))
    assert_ranks_equal(res)
    np.testing.assert_array_equal(res[0]["img"], single_config2[0])


def test_ray_count_matches_single_device(group, single_config2):
    traced = float(group.result(W.layout_name(2, 2, False))["traced"])
    assert traced == pytest.approx(single_config2[1], rel=1e-6)


def test_grid_tracer_as_data_parallelism(group):
    """The replicated GridTracer on a (2, 2) layout == the single-device
    grid render, bit for bit, and the same ray count."""
    scene, cam, opts = W.bumpy_config4()
    tracer = GridTracer.build(scene, "cpu")
    want, traced = render(scene, cam, opts, device="cpu", tracer=tracer,
                          count_rays=True)
    res = group.every_rank("grid")
    assert_ranks_equal(res)
    np.testing.assert_array_equal(res[0]["img"], want.numpy())
    assert float(res[0]["traced"]) == float(traced)


def test_lanes_dying_at_different_depths(group):
    """bumpy config4 to depth 4 on a (2, 2) layout, whose tiles' lanes die
    after bounce 0 or 1: every tracer's frame finishes and equals the
    single-device render bit for bit. The collective tracers (ShardTracer,
    RingTracer) run every bounce of every tile and read nothing back; the
    replicated grid ends each tile at its first bounce with no live child,
    each rank on its own."""
    scene, cam, opts = W.bumpy_config4()
    opts = dataclasses.replace(opts, max_depth=4)
    tracer = GridTracer.build(scene, "cpu")
    want = {"grid": render(scene, cam, opts, device="cpu", tracer=tracer,
                           count_rays=True),
            "shard": render(scene, cam, opts, device="cpu",
                            count_rays=True)}
    want["ring"] = want["shard"]
    res = group.every_rank("depths")
    for name in ("shard", "ring", "grid"):
        assert_ranks_equal([{k: v for k, v in r.items() if k == f"img_{name}"}
                            for r in res])
        np.testing.assert_array_equal(res[0][f"img_{name}"],
                                      want[name][0].numpy(), err_msg=name)
        assert float(res[0][f"traced_{name}"]) == float(want[name][1])
    tiles = res[0]["bounces_shard"][0]
    for r in res:
        for name in ("shard", "ring"):
            assert r[f"bounces_{name}"].tolist() == [tiles] * 5, name
            assert int(r[f"reads_{name}"]) == 0, name
        b = r["bounces_grid"].tolist()
        assert b[0] == tiles and b[2:] == [0, 0, 0]
        assert int(r["reads_grid"]) == b[0] + b[1]
    # some tiles end after bounce 0, others after bounce 1
    assert 0 < sum(int(r["bounces_grid"][1]) for r in res) < tiles * WORLD


def test_compacted_glass_equals_single_device(group):
    scene, cam, opts = presets.config3_cornell()
    opts = dataclasses.replace(opts, width=32, height=24, max_depth=3,
                               tile_rays=256, compact_cap=1)
    want, _, dropped = render(scene, cam, opts, device="cpu")
    res = group.every_rank("glass")
    assert_ranks_equal(res)
    assert float(dropped) == 0.0 and float(res[0]["dropped"]) == 0.0
    np.testing.assert_allclose(res[0]["img"], want.numpy(), atol=1e-6)


@pytest.mark.parametrize("ring", [False, True], ids=["shard", "ring"])
def test_stacked_bvh_sharded_render(group, ring):
    """Per-shard BVHs (accel="bvh") reproduce the dense sharded render
    (tests/test_bvh.py::test_stacked_bvh_sharded_render's standard)."""
    res = group.every_rank("bvh")
    assert_ranks_equal(res)
    assert_images_close(res[0][f"ring{int(ring)}"], res[0]["dense"],
                        tol=1e-6, max_bad_frac=0.001, name=f"ring={ring}")


def test_sharded_grads_equal_single_device(group):
    """loss(render_sharded(...)).backward() on every rank gives every rank
    the single-device gradient of the sphere centers."""
    scene, cam, opts = W.config2_small(32, 32)
    c = as_leaf(scene.spheres.center, "cpu")
    sc = scene.to("cpu")
    sc = sc.replace(spheres=dataclasses.replace(sc.spheres, center=c))
    loss = ((render(sc, cam, opts, device="cpu")[0] - 0.25) ** 2).mean()
    loss.backward()
    want = c.grad.numpy().astype(np.float64)
    assert np.abs(want).max() > 1e-6
    for r, res in enumerate(group.every_rank("grads")):
        assert not np.isnan(res["grad"]).any()
        np.testing.assert_allclose(float(res["loss"]), loss.item(), rtol=1e-6)
        np.testing.assert_allclose(res["grad"], want, rtol=1e-4, atol=1e-8,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("case", list(W.overlap_cases()))
def test_overlap_equals_plain_backward(group, case):
    """The per-bounce sweep against one backward (tests/test_overlap.py's
    tolerances), the same on every rank, with non-trivial gradients."""
    res = group.every_rank(case)
    assert_ranks_equal(res)
    z = res[0]
    np.testing.assert_allclose(float(z["loss_o"]), float(z["loss_f"]),
                               rtol=1e-6, atol=1e-12)
    go = sorted(k for k in z if k.startswith("go_"))
    assert go and len(go) == sum(k.startswith("gf_") for k in z)
    for k in go:
        np.testing.assert_allclose(z[k], z["gf_" + k[3:]], rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert any(np.abs(z[k]).max(initial=0.0) > 1e-6 for k in go)
    # the loss is the MSE of the sharded render against its target
    mse = float(z["mse"])
    assert abs(float(z["loss_o"]) - mse) <= 1e-6 * mse


def test_sharded_fused_step_matches_single_device(group):
    """plan_value_and_grad_sharded on 4 tiles (the plain K1/K2) against the
    single-device step: loss rtol 1e-5, each table within 1e-4 of its
    max."""
    scene, cam, opts = W.fused_case()
    res = group.every_rank("fused")
    assert_ranks_equal(res)
    z = res[0]
    fw = FusedWhitted(scene, cam, opts, device="cpu", param_inputs=True)
    loss, grads, _ = fw.plan_value_and_grad(torch.from_numpy(z["target"]))
    np.testing.assert_allclose(float(z["loss"]), float(loss), rtol=1e-5)
    for k in ("sph", "pln", "mat", "lgt"):
        want = grads[k].numpy()
        scale = np.abs(want).max() + 1e-9
        np.testing.assert_allclose(z[k] / scale, want / scale, atol=1e-4,
                                   err_msg=k)


def test_every_rank_exits_cleanly(group):
    for r, (rc, out) in enumerate(group.wait()):
        assert rc == 0, f"rank {r} exited {rc}:\n{out[-4000:]}"
