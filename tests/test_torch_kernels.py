"""PyTorch port: the CUDA kernels (grid walk, fused Whitted forward) against
their plain torch versions.

The `cuda` tests need an NVIDIA GPU and skip elsewhere. This file imports
neither jax nor the JAX package, so it also runs on a machine that has only
PyTorch — without the repository's conftest, which imports jax:

    python -m pytest tests/test_torch_kernels.py -m cuda -q --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.accel.grid import GridTracer, walk_init
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.ops import fused as F
from raytracer_tpu_torch.ops import walk as W
from raytracer_tpu_torch.ops.geometry import raygen

torch.set_num_threads(2)

# string condition: evaluated when the test runs, not at import
NEEDS_GPU = pytest.mark.skipif("not torch.cuda.is_available()",
                               reason="needs an NVIDIA GPU")


def _rays(cam, device, w=256, h=160):
    c = cam.to(device)
    dirs = raygen(c.c2w, c.fov_deg, w, h)
    return c.pos[None, :].expand_as(dirs).contiguous(), dirs


def assert_walks_agree(t0, i0, t1, i1):
    """The standard of tests/torch_cases.assert_walks_agree, repeated here:
    without the conftest, `tests.` imports can resolve to another package
    named `tests` on the machine's path."""
    t0, t1, i0, i1 = (np.asarray(x) for x in (t0, t1, i0, i1))
    fin = np.isfinite(t0)
    assert (fin == np.isfinite(t1)).all(), "hit/miss sets differ"
    np.testing.assert_allclose(t1[fin], t0[fin], rtol=2e-6)
    assert (i0 != i1).mean() <= 0.005, "winner ids differ beyond knife edges"


def test_kernel_wrapper_rejects_cpu_tensors():
    scene, cam, opts = presets.config4_mesh()
    tracer = GridTracer.build(scene, "cpu")
    orig, dirs = _rays(cam, "cpu", 8, 4)
    state = walk_init(tracer._grid, orig, dirs, opts.t_min)
    with pytest.raises(ValueError, match="CUDA"):
        W.grid_walk_cuda(tracer._grid, tracer._table, orig, dirs, state,
                         opts.t_min)


@pytest.fixture(scope="module")
def cuda_case():
    scene, cam, opts = presets.config4_mesh()
    tracer = GridTracer.build(scene, "cuda")
    orig, dirs = _rays(cam, "cuda")
    return tracer, orig, dirs, opts


def _kernel_and_plain(tracer, orig, dirs, t_min, max_t=None, active=None):
    g, table = tracer._grid, tracer._table
    state = walk_init(g, orig, dirs, t_min, active)
    before = W.launches
    got = W.grid_walk_cuda(g, table, orig, dirs, state, t_min, max_t)
    assert W.launches == before + 1
    want = W.grid_walk_plain(g, table, orig, dirs, state, t_min, max_t)
    torch.cuda.synchronize()
    return [x.cpu() for x in want], [x.cpu() for x in got]


@pytest.mark.cuda
@NEEDS_GPU
def test_kernel_nearest_matches_plain(cuda_case):
    tracer, orig, dirs, opts = cuda_case
    (t0, i0), (t1, i1) = _kernel_and_plain(tracer, orig, dirs, opts.t_min)
    assert_walks_agree(t0, i0, t1, i1)
    assert int(torch.isfinite(t0).sum()) > 1000  # scene sanity


@pytest.mark.cuda
@NEEDS_GPU
def test_kernel_occlusion_matches_plain(cuda_case):
    tracer, orig, dirs, opts = cuda_case
    mx = torch.full_like(orig[:, 0], 6.0)
    (t0, _), (t1, _) = _kernel_and_plain(tracer, orig, dirs, opts.t_min,
                                         max_t=mx)
    assert torch.equal(t0 < 6.0, t1 < 6.0)


@pytest.mark.cuda
@NEEDS_GPU
def test_kernel_active_mask_matches_plain(cuda_case):
    tracer, orig, dirs, opts = cuda_case
    gen = torch.Generator().manual_seed(3)
    act = (torch.rand(orig.shape[0], generator=gen) > 0.5).to("cuda")
    (t0, i0), (t1, i1) = _kernel_and_plain(tracer, orig, dirs, opts.t_min,
                                           active=act)
    assert_walks_agree(t0, i0, t1, i1)
    off = ~act.cpu()
    assert bool(torch.isinf(t1[off]).all())
    assert bool((i1[off] == tracer._grid.n_tris).all())


@pytest.mark.cuda
@NEEDS_GPU
def test_kernel_wrapper_rejects_bad_inputs(cuda_case):
    tracer, orig, dirs, opts = cuda_case
    g, table = tracer._grid, tracer._table
    state = walk_init(g, orig, dirs, opts.t_min)
    with pytest.raises(ValueError, match="contiguous"):
        W.grid_walk_cuda(g, table, orig, dirs.t().contiguous().t(),
                         state, opts.t_min)
    with pytest.raises(ValueError, match="float32"):
        W.grid_walk_cuda(g, table, orig.double(), dirs, state, opts.t_min)
    with pytest.raises(ValueError, match="shape"):
        W.grid_walk_cuda(g, table[:-1], orig, dirs, state, opts.t_min)


# --- fused Whitted forward ----------------------------------------------------

PX_TOL = 1.0 / 255.0    # image: ≤0.1% of pixels off by more than one level
PX_BAD = 0.001
PLAN_MAX_DIFF = 0.005   # plan planes: knife-edge pixels only


def _fused_case(name, w, h, depth=None):
    if name == "config5":
        scene, _, cam, opts = presets.config5_inverse()
    else:
        scene, cam, opts = presets.PRESETS[name]()
    opts = dataclasses.replace(opts, width=w, height=h)
    if depth is not None:
        opts = dataclasses.replace(opts, max_depth=depth)
    return scene, cam, opts


def assert_fused_agree(want, got):
    """Kernel vs plain render_plan output: the image and every plan plane."""
    (i0, w0, o0), (i1, w1, o1) = want, got
    diff = (i1 - i0).abs().amax(dim=-1)
    assert float((diff > PX_TOL).float().mean()) <= PX_BAD, float(diff.max())
    for a, b in zip(w0 + o0, w1 + o1):
        assert float((a != b).float().mean()) <= PLAN_MAX_DIFF


def test_fused_kernel_wrapper_rejects_cpu_objects():
    scene, cam, opts = _fused_case("config1", 8, 8)
    fw = F.FusedWhitted(scene, cam, opts, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        F.fused_whitted_cuda(fw, 0, 8)


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("name,w,h,depth", [("config1", 96, 64, None),
                                            ("config2", 96, 64, None),
                                            ("config3", 64, 64, 3),
                                            ("config5", 64, 48, None)])
def test_fused_kernel_matches_plain(name, w, h, depth):
    fw = F.FusedWhitted(*_fused_case(name, w, h, depth), device="cuda")
    before = F.launches
    got = fw.render_plan()
    assert F.launches == before + 1
    want = F.fused_whitted_plain(fw, 0, h, 0.0, emit_plan=True)
    n = fw.n_nodes
    want = (want[0], tuple(want[1][:n]), tuple(want[1][n:]))
    torch.cuda.synchronize()
    assert got[0].shape == (h, w, 3) and len(got[1]) == n
    assert_fused_agree(want, got)
    assert torch.equal(fw.render(), got[0])


@pytest.mark.cuda
@NEEDS_GPU
def test_fused_kernel_band_with_row_offset():
    fw = F.FusedWhitted(*_fused_case("config2", 80, 60), device="cuda")
    full = fw.render_plan()
    band = fw.render_plan(row0=17, rows=23)
    torch.cuda.synchronize()
    assert torch.equal(band[0], full[0][17:40])
    for a, b in zip(band[1] + band[2], full[1] + full[2]):
        assert torch.equal(a, b[17:40])
    want = F.fused_whitted_plain(fw, 17, 23, 0.0, emit_plan=True)
    n = fw.n_nodes
    assert_fused_agree((want[0], tuple(want[1][:n]), tuple(want[1][n:])),
                       band)


@pytest.mark.cuda
@NEEDS_GPU
def test_fused_kernel_bind_between_launches():
    init, target, cam, opts = presets.config5_inverse()
    opts = dataclasses.replace(opts, width=64, height=64)
    fw = F.FusedWhitted(init, cam, opts, device="cuda", param_inputs=True)
    ptrs = [t.data_ptr() for t in (fw.sph, fw.pln, fw.mat, fw.lgt)]
    first = fw.render()
    fw.bind(center=target.spheres.center, albedo=target.materials.albedo)
    bound = fw.render()
    assert [t.data_ptr() for t in (fw.sph, fw.pln, fw.mat, fw.lgt)] == ptrs
    want = F.FusedWhitted(target, cam, opts, device="cuda").render()
    torch.cuda.synchronize()
    assert float((bound - first).abs().max()) > 0.1
    assert torch.equal(bound, want)  # same tables, same kernel: same bits
