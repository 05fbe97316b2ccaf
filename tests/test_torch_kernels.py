"""PyTorch port: the CUDA kernels (grid walk, fused Whitted forward in its
three modes, fused train, the brute-force triangle searches, the BVH walk)
against their plain torch versions, and raygen's pixel coordinates on the
card against the CPU's.

The `cuda` tests need an NVIDIA GPU and skip elsewhere. This file imports
neither jax nor the JAX package, so it also runs on a machine that has only
PyTorch — without the repository's conftest, which imports jax:

    python -m pytest tests/test_torch_kernels.py -m cuda -q --noconftest
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.accel.bvh import BVHTracer, bvh_walk
from raytracer_tpu_torch.accel.grid import GridTracer, walk_init
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.ops import bvh_walk as BW
from raytracer_tpu_torch.ops import fused as F
from raytracer_tpu_torch.ops import mat_trace as MT
from raytracer_tpu_torch.ops import pallas_trace as PT
from raytracer_tpu_torch.ops import walk as W
from raytracer_tpu_torch.ops.geometry import pixel_coords, raygen

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


def _walk_rays(tracer, kind, orig, dirs, t_min):
    """"sparse": the case's primaries with 40 scattered lanes active, 20 of
    them rays that hit the mesh; "incoherent": 20,000 rays from random
    points around the grid's box in random directions, all active."""
    rng = np.random.default_rng(11)
    if kind == "sparse":
        hits = torch.isfinite(W.grid_walk_reference(
            tracer._grid, tracer._table, orig, dirs, t_min)[0]).cpu().numpy()
        act = np.zeros(orig.shape[0], bool)
        for pool in (np.flatnonzero(hits), np.flatnonzero(~hits)):
            act[rng.choice(pool, 20, replace=False)] = True
        return orig, dirs, torch.from_numpy(act).to("cuda")
    g = tracer._grid
    lo = g.bmin.cpu().numpy()
    ext = (g.cell_size * torch.tensor(g.res, dtype=torch.float32,
                                      device=g.cell_size.device)).cpu().numpy()
    o = lo + ext * rng.uniform(-0.25, 1.25, (20000, 3))
    d = rng.normal(size=(20000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cuda = lambda a: torch.from_numpy(a.astype(np.float32)).to("cuda")
    return cuda(o), cuda(d), None


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("kind", ["sparse", "incoherent"])
@pytest.mark.parametrize("mode", ["nearest", "occlusion"])
def test_kernel_sparse_and_incoherent_rays_match_plain(cuda_case, kind, mode):
    """Segments with few walking lanes, and rays whose warps scatter over
    the grid, in both modes."""
    tracer, orig, dirs, opts = cuda_case
    o, d, act = _walk_rays(tracer, kind, orig, dirs, opts.t_min)
    mx = None
    if mode == "occlusion":
        gen = torch.Generator().manual_seed(12)
        mx = (0.5 + 8.0 * torch.rand(o.shape[0], generator=gen)).to("cuda")
    (t0, i0), (t1, i1) = _kernel_and_plain(tracer, o, d, opts.t_min, mx, act)
    if mode == "occlusion":
        assert torch.equal(t0 < mx.cpu(), t1 < mx.cpu())
        assert int((t0 < mx.cpu()).sum()) > 0
    else:
        assert_walks_agree(t0, i0, t1, i1)
        assert int(torch.isfinite(t0).sum()) >= (20 if kind == "sparse"
                                                 else 500)
    if act is not None:
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
    for short in (dataclasses.replace(table, cells=table.cells[:-1]),
                  dataclasses.replace(table,
                                      slots=table.slots[:, :10].contiguous())):
        with pytest.raises(ValueError, match="shape"):
            W.grid_walk_cuda(g, short, orig, dirs, state, opts.t_min)


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
    before = F.plan_launches
    got = fw.render_plan()
    assert F.plan_launches == before + 1
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


# --- fused train kernel -------------------------------------------------------

# The kernel and autograd sum a band's pixels in different orders: loss to
# rtol 1e-4, each gradient table within 1e-3 of its largest entry.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3


def _train_case(name, w, h, depth=None, device="cuda"):
    fw = F.FusedWhitted(*_fused_case(name, w, h, depth), device=device,
                        param_inputs=True)
    target = (fw.render() * 0.9).contiguous()
    return fw, target


def assert_train_agree(want, got):
    (l0, g0), (l1, g1) = want, got
    np.testing.assert_allclose(float(l1), float(l0), rtol=TRAIN_LOSS_RTOL)
    for k in ("sph", "pln", "mat", "lgt"):
        a, b = g0[k].cpu(), g1[k].cpu()
        assert a.shape == b.shape, k
        scale = float(a.abs().max()) + 1e-12
        assert float((a - b).abs().max()) <= TRAIN_GRAD_TOL * scale, k


def _train_kernel_and_plain(fw, target, row0=0, rows=None, launches=1):
    rows = fw.opts.height - row0 if rows is None else rows
    img, plan = F.fused_whitted_cuda(fw, row0, rows, mode="plan")
    band = target[row0:row0 + rows].contiguous()
    before = F.train_launches
    got = F.fused_train_cuda(fw, row0, rows, plan, band)
    assert F.train_launches == before + launches
    n = fw.n_nodes
    want = F.fused_train_plain(fw, row0, rows, plan[:n], plan[n:], band)
    torch.cuda.synchronize()
    own = float(((img.double() - band.double()) ** 2).sum())
    np.testing.assert_allclose(float(got[0]), own, rtol=TRAIN_LOSS_RTOL)
    return want, got


def test_fused_train_wrapper_rejects_cpu_objects():
    fw, target = _train_case("config5", 8, 8, device="cpu")
    _, plan = F.fused_whitted_plain(fw, 0, 8, emit_plan=True)
    before = F.train_launches
    with pytest.raises(ValueError, match="CUDA"):
        F.fused_train_cuda(fw, 0, 8, plan, target)
    assert F.train_launches == before


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("name,w,h,depth", [("config2", 96, 64, 2),
                                            ("config3", 64, 64, 4)])
def test_fused_train_kernel_matches_plain(name, w, h, depth):
    fw, target = _train_case(name, w, h, depth)
    assert_train_agree(*_train_kernel_and_plain(fw, target))


@pytest.mark.cuda
@NEEDS_GPU
def test_fused_train_kernel_band_with_row_offset():
    fw, target = _train_case("config2", 80, 60, 2)
    assert_train_agree(*_train_kernel_and_plain(fw, target, 17, 23))


@pytest.mark.cuda
@NEEDS_GPU
def test_fused_train_kernel_bind_between_launches():
    init, goal, cam, opts = presets.config5_inverse()
    opts = dataclasses.replace(opts, width=64, height=64)
    target = F.FusedWhitted(goal, cam, opts, device="cuda").render()
    fw = F.FusedWhitted(init, cam, opts, device="cuda", param_inputs=True)
    first, _, _ = fw.plan_value_and_grad(target)
    fw.bind(center=np.asarray(goal.spheres.center) + np.float32(0.03),
            albedo=goal.materials.albedo)
    want, got = _train_kernel_and_plain(fw, target.contiguous())
    assert_train_agree(want, got)
    assert float(got[0]) < 0.5 * float(first)  # the bound values moved it


@pytest.mark.cuda
@NEEDS_GPU
def test_fused_train_kernel_is_deterministic():
    fw, target = _train_case("config3", 64, 64, 4)
    runs = [fw.plan_value_and_grad(target) for _ in range(2)]
    torch.cuda.synchronize()
    (l0, g0, _), (l1, g1, _) = runs
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("row0,rows", [(0, None), (101, 333)])
def test_fused_train_kernel_replays_several_pixels_per_thread(row0, rows):
    """config2 600×500 d2: 300,000 pixels (199,800 in the band), more than
    the launch's threads, and no multiple of the 128-thread block: each
    thread replays several pixels and the last ones fewer. Held to the plain
    version, and two runs bit-equal."""
    fw, target = _train_case("config2", 600, 500, 2)
    want, got = _train_kernel_and_plain(fw, target, row0, rows)
    assert_train_agree(want, got)
    rows = 500 - row0 if rows is None else rows
    _, plan = F.fused_whitted_cuda(fw, row0, rows, mode="plan")
    band = target[row0:row0 + rows].contiguous()
    again = F.fused_train_cuda(fw, row0, rows, plan, band)
    torch.cuda.synchronize()
    assert torch.equal(again[0], got[0])
    for k in got[1]:
        assert torch.equal(again[1][k], got[1][k]), k


# --- the forward's modes, the gradient windows, deep chains ------------------

def _bound_config5(w, h):
    init, goal, cam, opts = presets.config5_inverse()
    opts = dataclasses.replace(opts, width=w, height=h)
    fw = F.FusedWhitted(init, cam, opts, device="cuda", param_inputs=True)
    target = F.FusedWhitted(goal, cam, opts, device="cuda").render()
    fw.bind(center=np.asarray(goal.spheres.center) + np.float32(0.05),
            albedo=np.full((3, 3), 0.4, np.float32))
    return fw, target.contiguous()


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("name,w,h,depth", [("config1", 96, 64, None),
                                            ("config2", 96, 64, None),
                                            ("config3", 64, 64, 4),
                                            ("config5", 64, 48, None)])
def test_fused_image_mode_equals_full_plan_image(name, w, h, depth):
    """Tracing only the live nodes changes no pixel (the sign of a zero
    aside, which torch.equal ignores); config5 after a bind."""
    if name == "config5":
        fw, _ = _bound_config5(w, h)
    else:
        fw = F.FusedWhitted(*_fused_case(name, w, h, depth), device="cuda")
    before = (F.launches, F.plan_launches)
    img = fw.render()
    full = fw.render_plan()[0]
    assert (F.launches, F.plan_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(img, full)


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("name,w,h,depth", [("config5", 64, 48, None),
                                            ("config2", 96, 64, 2),
                                            ("config3", 64, 64, 4)])
def test_live_plan_step_equals_full_plan_step(name, w, h, depth):
    """The training step on the live plan gives the loss, gradients and
    image of the step on the full plan, bit for bit."""
    if name == "config5":
        fw, target = _bound_config5(w, h)
    else:
        fw, target = _train_case(name, w, h, depth)
    img, plan = F.fused_whitted_cuda(fw, 0, h, mode="plan")
    want = F.fused_train_cuda(fw, 0, h, plan, target)
    before = F.live_plan_launches
    loss, grads, img_l = fw.plan_value_and_grad(target)
    assert F.live_plan_launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(img_l, img)
    assert torch.equal(loss, want[0])
    for k in want[1]:
        assert torch.equal(grads[k], want[1][k]), k


def test_grad_windows_hold_whole_rows():
    """The train kernel's windows: whole table rows, ≤ the window's floats
    each, covering every float once, in order."""
    fw = F.FusedWhitted(*presets.many_spheres(width=8, height=8),
                        device="cpu")
    tables = (fw.sph, fw.pln, fw.mat, fw.lgt)
    windows = F.grad_windows(tables, 256)
    assert windows == [(0, 255), (255, 90)]  # 120 + 9 + 18·7 | 12·7 + 6
    starts = np.cumsum([0] + [t.shape[1] for t in tables
                              for _ in range(t.shape[0])])
    assert windows[0][0] == 0 and sum(gn for _, gn in windows) == 345
    for (g0, gn), (nxt, _) in zip(windows, windows[1:] + [(345, 0)]):
        assert 0 < gn <= 256 and g0 + gn == nxt
        assert g0 in starts and g0 + gn in starts
    small = F.FusedWhitted(*_fused_case("config2", 8, 8), device="cpu")
    assert F.grad_windows((small.sph, small.pln, small.mat, small.lgt),
                          256) == [(0, 12 + 9 + 28 + 12)]


@pytest.mark.parametrize("case", ["config2", "config3", "spheres"])
def test_train_launch_plan_is_one_window_when_table_fits(case):
    """The train kernel's window fills the block's shared memory beside the
    scene (a column of 1 + window + 9 floats per thread) and holds the whole
    table of every preset and of the 345-float scene: one launch."""
    scene, cam, opts = (presets.many_spheres(width=8, height=8)
                        if case == "spheres" else _fused_case(case, 8, 8))
    fw = F.FusedWhitted(scene, cam, opts, device="cpu")
    tables = (fw.sph, fw.pln, fw.mat, fw.lgt)
    n = sum(t.numel() for t in tables)
    window = F.train_window(fw)
    scene_bytes = -(-F._smem_bytes(fw) // 16) * 16
    cols = lambda w: F.TRAIN_THREADS * 4 * (1 + w + 9)
    assert scene_bytes + cols(window) <= F.TRAIN_SMEM_BYTES
    assert scene_bytes + cols(window + 1) > F.TRAIN_SMEM_BYTES
    assert window >= n
    assert F.grad_windows(tables, window) == [(0, n)]


@pytest.mark.parametrize("capacity", [128, 16])
def test_walk_table_packs_cell_soa(capacity):
    """The kernel's table lists each cell's triangles once, in cell_soa's
    order, with the cell's offset and count; its rows are 12 floats (three
    16-byte loads). Capacity 16 spills config4's blob into the overflow."""
    scene, _, _ = presets.config4_mesh()
    tracer = GridTracer.build(scene, "cpu", capacity=capacity)
    g, table = tracer._grid, tracer._table
    soa = g.cell_soa
    assert table.soa is soa or torch.equal(table.soa, soa)
    counts = (soa[..., 9] != g.n_tris).sum(dim=1)
    offs, cnt = table.cells[:, 0].long(), table.cells[:, 1].long()
    assert table.cells.dtype == torch.int32 and torch.equal(cnt, counts)
    assert torch.equal(offs, torch.cumsum(counts, 0) - counts)
    assert table.slots.shape == (int(counts.sum()), 12)
    assert bool((table.slots[:, 10:] == 0).all())
    for c in range(soa.shape[0]):
        k = int(counts[c])
        assert torch.equal(table.slots[offs[c]:offs[c] + k, :10], soa[c, :k])
        assert bool((soa[c, k:, 9] == g.n_tris).all())
    if capacity == 16:
        assert g.overflow.shape[0] > 0 and int(counts.max()) == 16


@pytest.mark.cuda
@NEEDS_GPU
def test_fused_train_kernel_without_table_cap():
    """345 table floats, past a 256-float gradient window: one launch,
    held to the plain version."""
    fw = F.FusedWhitted(*presets.many_spheres(), device="cuda",
                        param_inputs=True)
    assert sum(t.numel() for t in (fw.sph, fw.pln, fw.mat, fw.lgt)) == 345
    target = (fw.render() * 0.9).contiguous()
    before = F.train_launches
    want, got = _train_kernel_and_plain(fw, target, launches=1)
    assert F.train_launches == before + 1
    assert_train_agree(want, got)
    again = F.fused_train_cuda(fw, 0, fw.opts.height,
                               F.fused_whitted_cuda(fw, 0, fw.opts.height,
                                                    mode="plan")[1], target)
    assert torch.equal(again[0], got[0])
    for k in got[1]:
        assert torch.equal(again[1][k], got[1][k]), k


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("case", ["config2", "mirror_hall"])
def test_fused_kernels_at_depth_40(case):
    """Glass-free max_depth 40 (41 nodes, past the 32 on-chip levels): the
    forward's full plan and image, and the train kernel, against the plain
    versions."""
    w, h = (64, 64) if case == "config2" else (48, 32)
    scene, cam, opts = (_fused_case("config2", w, h, 40) if case == "config2"
                        else presets.mirror_hall(w, h, 40))
    fw = F.FusedWhitted(scene, cam, opts, device="cuda", param_inputs=True)
    got = fw.render_plan()
    want = F.fused_whitted_plain(fw, 0, h, 0.0, emit_plan=True)
    n = fw.n_nodes
    assert n == 41
    assert_fused_agree((want[0], tuple(want[1][:n]), tuple(want[1][n:])),
                       got)
    assert torch.equal(fw.render(), got[0])
    target = (got[0] * 0.9).contiguous()
    assert_train_agree(*_train_kernel_and_plain(fw, target))
    if case == "mirror_hall":  # the deep levels were reached
        stats = {}
        F.fused_whitted_plain(fw, 0, h, stats=stats)
        assert int(stats["live_leaf"]) > h * w // 4


# --- brute-force triangle search (K3: tri_trace.cu, K4: mat_trace.cu) --------

MODULES = {"tri": PT, "mat": MT}


def _brute_launch(kind, case, max_t=None, active=None, plain=False):
    """One nearest (max_t None) or any-hit search of the case's rays, by
    the kernel or its plain version."""
    pt, mt, orig, dirs, opts = case
    if kind == "tri":
        if max_t is None:
            fn = PT.tri_nearest_plain if plain else PT.tri_nearest_cuda
            return fn(orig, dirs, pt._tri, opts.t_min, active)
        fn = PT.tri_occluded_plain if plain else PT.tri_occluded_cuda
        return fn(orig, dirs, max_t, pt._tri, opts.t_min, active)
    feats = MT.ray_features(orig, dirs, mt._center)
    if max_t is None:
        fn = MT.mat_nearest_plain if plain else MT.mat_nearest_cuda
        return fn(feats, mt._w, opts.t_min, active=active)
    fn = MT.mat_occluded_plain if plain else MT.mat_occluded_cuda
    return fn(feats, max_t, mt._w, opts.t_min, active=active)


def test_brute_kernel_wrappers_reject_cpu_tensors():
    scene, cam, opts = presets.config4_mesh()
    orig, dirs = _rays(cam, "cpu", 8, 4)
    case = (PT.PallasTracer(scene, "cpu"), MT.MatTracer(scene, "cpu"), orig,
            dirs, opts)
    before = [(m.launches, m.occluded_launches) for m in MODULES.values()]
    for kind in MODULES:
        for max_t in (None, torch.full((32,), 6.0)):
            with pytest.raises(ValueError, match="CUDA"):
                _brute_launch(kind, case, max_t)
    assert [(m.launches, m.occluded_launches)
            for m in MODULES.values()] == before


@pytest.fixture(scope="module")
def brute_case():
    """config4's blob (20,480 triangles) and 256×160 primaries less 77, a
    ray count that is not a multiple of the kernels' 256-thread block."""
    scene, cam, opts = presets.config4_mesh()
    orig, dirs = _rays(cam, "cuda")
    return (PT.PallasTracer(scene, "cuda"), MT.MatTracer(scene, "cuda"),
            orig[:-77].contiguous(), dirs[:-77].contiguous(), opts)


def _mask(n, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(n, generator=gen) > 0.3).to("cuda")


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("kind", ["tri", "mat"])
@pytest.mark.parametrize("masked", [False, True])
def test_brute_nearest_kernel_matches_plain(brute_case, kind, masked):
    act = _mask(brute_case[2].shape[0]) if masked else None
    mod = MODULES[kind]
    before = mod.launches
    t1, i1 = _brute_launch(kind, brute_case, active=act)
    assert mod.launches == before + 1
    t0, i0 = _brute_launch(kind, brute_case, active=act, plain=True)
    torch.cuda.synchronize()
    # every product and sum in the plain version's order, a correctly
    # rounded reciprocal: bit for bit
    assert torch.equal(t1, t0) and torch.equal(i1, i0)
    assert int(torch.isfinite(t0).sum()) > 1000  # scene sanity
    if masked:
        assert bool(torch.isinf(t1[~act]).all())
        assert bool((i1[~act] == 0).all())


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("kind", ["tri", "mat"])
@pytest.mark.parametrize("max_t", [4.0, 6.0, 100.0])
def test_brute_occluded_kernel_matches_plain(brute_case, kind, max_t):
    n = brute_case[2].shape[0]
    act = _mask(n, seed=6)
    mx = torch.full((n,), max_t, device="cuda")
    mod = MODULES[kind]
    before = mod.occluded_launches
    got = _brute_launch(kind, brute_case, mx, act)
    assert mod.occluded_launches == before + 1
    want = _brute_launch(kind, brute_case, mx, act, plain=True)
    torch.cuda.synchronize()
    assert got.dtype == torch.bool
    assert torch.equal(got, want)
    assert not bool(got[~act].any())


@pytest.mark.cuda
@NEEDS_GPU
def test_brute_kernel_wrappers_reject_bad_inputs(brute_case):
    pt, mt, orig, dirs, opts = brute_case
    t_min, n = opts.t_min, orig.shape[0]
    mx = torch.full((n,), 6.0, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        PT.tri_nearest_cuda(orig, dirs.t().contiguous().t(), pt._tri, t_min)
    with pytest.raises(ValueError, match="float32"):
        PT.tri_nearest_cuda(orig.double(), dirs, pt._tri, t_min)
    with pytest.raises(ValueError, match="shape"):
        PT.tri_nearest_cuda(orig, dirs, pt._tri[:8], t_min)
    with pytest.raises(ValueError, match="shape"):
        PT.tri_occluded_cuda(orig, dirs, mx[:-1], pt._tri, t_min)
    with pytest.raises(ValueError, match="bool"):
        PT.tri_nearest_cuda(orig, dirs, pt._tri, t_min,
                            torch.ones((n,), dtype=torch.int32, device="cuda"))
    feats = MT.ray_features(orig, dirs, mt._center)
    with pytest.raises(ValueError, match="contiguous"):
        MT.mat_nearest_cuda(feats.t().contiguous().t(), mt._w, t_min)
    with pytest.raises(ValueError, match="float32"):
        MT.mat_occluded_cuda(feats, mx.double(), mt._w, t_min)
    with pytest.raises(ValueError, match="shape"):
        MT.mat_nearest_cuda(feats[:, :10].contiguous(), mt._w, t_min)
    with pytest.raises(ValueError, match="blocks"):
        MT.mat_nearest_cuda(feats, mt._w, t_min, bt=3000)


def _torch_cases():
    """tests/torch_cases.py loaded by its path: without the conftest, a
    `tests.` import can resolve to another package named `tests`."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "_torch_cases", os.path.join(os.path.dirname(__file__),
                                     "torch_cases.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mat_both(feats, w, bt, t_min, max_t=None, active=None, table=None):
    """K4a (max_t None) or K4b and its plain version on the same inputs,
    the kernel's launch counted → (kernel's, plain's)."""
    occl = max_t is not None
    before = MT.occluded_launches if occl else MT.launches
    if occl:
        got = MT.mat_occluded_cuda(feats, max_t, w, t_min, bt, active, table)
        want = MT.mat_occluded_plain(feats, max_t, w, t_min, bt, active)
    else:
        got = MT.mat_nearest_cuda(feats, w, t_min, bt, active, table)
        want = MT.mat_nearest_plain(feats, w, t_min, bt, active)
    torch.cuda.synchronize()
    assert (MT.occluded_launches if occl else MT.launches) == before + 1
    return got, want


def _assert_search_equal(got, want, active=None):
    """Bit-equal outputs; masked lanes miss."""
    if isinstance(got, tuple):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert int(torch.isfinite(want[0]).sum()) > 100
        if active is not None:
            assert bool(torch.isinf(got[0][~active]).all())
            assert not bool(got[1][~active].any())
    else:
        assert got.dtype == torch.bool and torch.equal(got, want)
        assert bool(want.any())
        if active is not None:
            assert not bool(got[~active].any())


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("max_t", [None, 6.0])
@pytest.mark.parametrize("masked", [None, 0.3, 0.97])
@pytest.mark.parametrize("t_min", ["preset", 0.0])
def test_mat_kernels_equal_plain(brute_case, max_t, masked, t_min):
    """K4 bit for bit at 40,883 rays (not a multiple of a block's 384),
    all live, with 30% of the lanes masked, and with 97% masked (the live
    rays spread over blocks of one warp), at the preset's t_min and at 0."""
    _, mt, orig, dirs, opts = brute_case
    t_min = opts.t_min if t_min == "preset" else t_min
    feats = MT.ray_features(orig, dirs, mt._center)
    n = feats.shape[0]
    act = None
    if masked is not None:
        gen = torch.Generator().manual_seed(7)
        act = (torch.rand(n, generator=gen) > masked).to("cuda")
    mx = None if max_t is None else torch.full((n,), max_t, device="cuda")
    got, want = _mat_both(feats, mt._w, MT.BT, t_min, mx, act, mt._table)
    _assert_search_equal(got, want, act)


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("max_t", [None, 6.0])
def test_mat_kernels_equal_plain_on_a_ragged_table(brute_case, max_t):
    """config4's blob in weight blocks of 300: 20,700 triangles (220
    padding ones), not a multiple of the kernel's 256-triangle tile."""
    _, mt, orig, dirs, opts = brute_case
    w, center = MT.build_tri_weights(*(a.cpu().numpy() for a in mt._soa),
                                     bt=300)
    w = w.cuda()
    assert (w.shape[1] // 4) % 256 != 0
    feats = MT.ray_features(orig, dirs, center.cuda())
    n = feats.shape[0]
    act = _mask(n, seed=8)
    mx = None if max_t is None else torch.full((n,), max_t, device="cuda")
    got, want = _mat_both(feats, w, 300, opts.t_min, mx, act,
                          MT.pack_mat_table(w, 300))
    _assert_search_equal(got, want, act)


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("t_min", [1e-4, 0.0, -1.0])
def test_mat_kernels_equal_plain_on_edge_rays(t_min):
    """tests/torch_cases.mat_edge_case: t·det == 0, det = ±0 and |det| at
    eps, non-finite features (misses), a table of 300 triangles (one tile
    and 44 rows)."""
    w, bt, feats = _torch_cases().mat_edge_case()
    w, feats = w.cuda(), feats.cuda()
    finite = torch.isfinite(feats[:, :10]).all(dim=1)
    got, want = _mat_both(feats, w, bt, t_min)
    _assert_search_equal(got, want)
    assert bool(torch.isinf(got[0][~finite]).all())
    for mx in (6.0, float("inf")):
        max_t = torch.full((feats.shape[0],), mx, device="cuda")
        got, want = _mat_both(feats, w, bt, t_min, max_t)
        _assert_search_equal(got, want)
        assert not bool(got[~finite].any())


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_live_rays_lists_the_active_ids_in_order(n):
    """The brute-force wrappers' live list (kernels/build.live_rays): the
    active ids ascending, their count on the device, no host sync."""
    from raytracer_tpu_torch.kernels.build import live_rays

    assert live_rays(None) == (None, None)
    gen = torch.Generator().manual_seed(n)
    act = torch.rand(n, generator=gen) > 0.6
    live, n_live = live_rays(act)
    ids = torch.nonzero(act).squeeze(1)
    assert live.dtype == torch.int32 and live.shape == (n + 1,)
    assert n_live.dtype == torch.int32 and n_live.shape == (min(n, 1),)
    if n:
        assert int(n_live) == ids.numel()
    assert torch.equal(live[:ids.numel()].long(), ids)


def _tri_both(orig, dirs, tri, t_min, max_t=None, active=None):
    """K3a (max_t None) or K3b and its plain version on the same inputs,
    the kernel's launch counted → (kernel's, plain's)."""
    occl = max_t is not None
    before = PT.occluded_launches if occl else PT.launches
    if occl:
        got = PT.tri_occluded_cuda(orig, dirs, max_t, tri, t_min, active)
        want = PT.tri_occluded_plain(orig, dirs, max_t, tri, t_min, active)
    else:
        got = PT.tri_nearest_cuda(orig, dirs, tri, t_min, active)
        want = PT.tri_nearest_plain(orig, dirs, tri, t_min, active)
    torch.cuda.synchronize()
    assert (PT.occluded_launches if occl else PT.launches) == before + 1
    return got, want


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("max_t", [None, 6.0])
@pytest.mark.parametrize("masked", [None, 0.3, 0.97])
@pytest.mark.parametrize("t_min", ["preset", 0.0, -1.0])
def test_tri_kernels_equal_plain(brute_case, max_t, masked, t_min):
    """K3 bit for bit at 40,883 rays (not a multiple of a block's 384),
    all live, with 30% of the lanes masked, and with 97% masked (the live
    rays spread over blocks of one warp), at the preset's t_min, at 0 and
    at -1 (t·det's stage then drops only NaN and -inf)."""
    pt, _, orig, dirs, opts = brute_case
    t_min = opts.t_min if t_min == "preset" else t_min
    n = orig.shape[0]
    act = None
    if masked is not None:
        gen = torch.Generator().manual_seed(7)
        act = (torch.rand(n, generator=gen) > masked).to("cuda")
    mx = None if max_t is None else torch.full((n,), max_t, device="cuda")
    got, want = _tri_both(orig, dirs, pt._tri, t_min, mx, act)
    _assert_search_equal(got, want, act)


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("max_t", [None, 6.0])
def test_tri_kernels_equal_plain_on_a_ragged_table(brute_case, max_t):
    """config4's blob packed in blocks of 300: 20,700 triangles (220
    padding ones), not a multiple of the kernel's 256-triangle tile."""
    pt, _, orig, dirs, opts = brute_case
    tri = PT.pack_tris(pt._tri[0:3].T, pt._tri[3:6].T, pt._tri[6:9].T,
                       bt=300)
    assert tri.shape[1] == 20_700
    n = orig.shape[0]
    act = _mask(n, seed=8)
    mx = None if max_t is None else torch.full((n,), max_t, device="cuda")
    got, want = _tri_both(orig, dirs, tri, opts.t_min, mx, act)
    _assert_search_equal(got, want, act)


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("t_min", [1e-4, 0.0, -1.0])
def test_tri_kernels_equal_plain_on_edge_rays(t_min):
    """tests/torch_cases.tri_edge_case: t·det == 0, det = ±0 and |det| at
    eps, non-finite origins and directions, a table of 300 triangles (one
    tile and 44 rows)."""
    orig, dirs, tri = (x.cuda() for x in _torch_cases().tri_edge_case())
    got, want = _tri_both(orig, dirs, tri, t_min)
    _assert_search_equal(got, want)
    for mx in (6.0, float("inf")):
        max_t = torch.full((orig.shape[0],), mx, device="cuda")
        got, want = _tri_both(orig, dirs, tri, t_min, max_t)
        _assert_search_equal(got, want)


@pytest.mark.cuda
@NEEDS_GPU
def test_mat_kernel_wrappers_reject_stale_tables(brute_case):
    _, mt, orig, dirs, opts = brute_case
    feats = MT.ray_features(orig, dirs, mt._center)
    w, table, t_min = mt._w, mt._table, opts.t_min
    before = (MT.launches, MT.occluded_launches)
    with pytest.raises(ValueError, match="stale"):
        MT.mat_nearest_cuda(feats, w.clone(), t_min, MT.BT, None, table)
    with pytest.raises(ValueError, match="shape"):
        MT.mat_nearest_cuda(feats, w, t_min, MT.BT, None, dataclasses.replace(
            table, rows=table.rows[:-1]))
    with pytest.raises(ValueError, match="float32"):
        MT.mat_nearest_cuda(feats, w, t_min, MT.BT, None, dataclasses.replace(
            table, rows=table.rows.double()))
    flat = torch.empty(table.rows.numel() + 1, device="cuda")
    shifted = flat[1:].view(table.rows.shape)
    shifted.copy_(table.rows)
    with pytest.raises(ValueError, match="aligned"):
        MT.mat_occluded_cuda(feats, torch.full_like(feats[:, 0], 6.0), w,
                             t_min, MT.BT, None, dataclasses.replace(
                                 table, rows=shifted))
    w2 = w.clone()
    t2 = MT.pack_mat_table(w2)
    w2.mul_(1.0)  # changed in place since it was packed
    with pytest.raises(ValueError, match="stale"):
        MT.mat_nearest_cuda(feats, w2, t_min, MT.BT, None, t2)
    assert (MT.launches, MT.occluded_launches) == before


@pytest.mark.cuda
@NEEDS_GPU
def test_raygen_pixel_coords_equal_cpu():
    """At 1920×1080 the pixel coordinates on the card equal the CPU's bit
    for bit. Dividing by the width as a Python number, as raygen did, gives
    the product with the rounded reciprocal on the card: an ulp off."""
    w, h, f32 = 1920, 1080, torch.float32
    old = (torch.arange(w, dtype=f32, device="cuda") + 0.5) / w
    assert not torch.equal(old.cpu(), (torch.arange(w, dtype=f32) + 0.5) / w)
    for row0, rows in ((0, h), (517, 100)):
        i0, j0 = pixel_coords(w, h, row0, rows, "cpu")
        i1, j1 = pixel_coords(w, h, row0, rows, "cuda")
        assert torch.equal(i1.cpu(), i0) and torch.equal(j1.cpu(), j0)


# --------------------------------------------------------------------------
# the BVH walk (csrc/bvh_walk.cu) against its plain version, bit for bit

def test_bvh_kernel_wrapper_rejects_cpu_tensors():
    scene, cam, _ = presets.config4_mesh()
    tracer = BVHTracer.build(scene, "cpu")
    orig, dirs = _rays(cam, "cpu", 8, 4)
    before = BW.launches
    with pytest.raises(ValueError, match="CUDA"):
        BW.bvh_walk_cuda(tracer._bvh, tracer._table, orig, dirs, 1e-4)
    assert BW.launches == before


def test_bvh_table_packs_leaves():
    """The kernel's table: every leaf's listed triangles once, in node
    order, each node's first slot and count, and its lowest listed id."""
    scene = presets.config4_mesh()[0]
    tracer = BVHTracer.build(scene, "cpu")
    b, table = tracer._bvh, tracer._table
    leaf = b.leaf_tris
    listed = leaf != b.n_tris
    bits = table.nodes[:, [3, 7]].contiguous().view(torch.int32)
    assert torch.equal(bits[:, 1], listed.sum(dim=1).to(torch.int32))
    assert torch.equal(bits[:, 0], (torch.cumsum(bits[:, 1], 0)
                                    - bits[:, 1]).to(torch.int32))
    assert torch.equal(table.nodes[:, [0, 1, 2, 4, 5, 6]], b.aabb6)
    assert torch.equal(table.slots[:, 9].long(), leaf[listed].long())
    v0, e1, _ = table.soa
    assert torch.equal(table.slots[:, 0:3], v0[leaf[listed].long()])
    assert torch.equal(table.slots[:, 3:6], e1[leaf[listed].long()])
    inner = ~listed.any(dim=1)
    assert bool((table.minid[inner] == b.n_tris).all())
    assert torch.equal(table.minid[~inner],
                       torch.where(listed, leaf, b.n_tris)[~inner].amin(1))


@pytest.fixture(scope="module")
def bvh_case():
    scene, cam, opts = presets.config4_mesh()
    return BVHTracer.build(scene, "cuda"), *_rays(cam, "cuda"), opts


def _bvh_both(tracer, orig, dirs, t_min, max_t=None, active=None):
    b, table = tracer._bvh, tracer._table
    before = BW.launches
    got = BW.bvh_walk_cuda(b, table, orig, dirs, t_min, max_t, active)
    assert BW.launches == before + 1
    want = bvh_walk(b, *table.soa, orig, dirs, t_min, max_t, active)
    torch.cuda.synchronize()
    return [x.cpu() for x in want], [x.cpu() for x in got]


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("mode", ["nearest", "occlusion"])
@pytest.mark.parametrize("masked", [False, True])
def test_bvh_kernel_equals_plain(bvh_case, mode, masked):
    """Primaries and incoherent rays around the blob: hits, t and ids (of
    hits and misses) bit-equal to the plain walk."""
    tracer, orig, dirs, opts = bvh_case
    rng = np.random.default_rng(13)
    n = 20000
    o2 = torch.from_numpy((rng.normal(size=(n, 3)) * 1.5 + np.array(
        [0.0, 0.0, -5.0])).astype(np.float32)).to("cuda")
    d2 = rng.normal(size=(n, 3))
    d2 = torch.from_numpy((d2 / np.linalg.norm(d2, axis=1, keepdims=True))
                          .astype(np.float32)).to("cuda")
    o = torch.cat([orig, o2]).contiguous()
    d = torch.cat([dirs, d2]).contiguous()
    mx = torch.full_like(o[:, 0], 6.0) if mode == "occlusion" else None
    act = _mask(o.shape[0], seed=9) if masked else None
    (t0, i0), (t1, i1) = _bvh_both(tracer, o, d, opts.t_min, mx, act)
    assert torch.equal(t1, t0) and torch.equal(i1, i0)
    assert int(torch.isfinite(t0).sum()) > 1000  # scene sanity
    if masked:
        off = ~act.cpu()
        assert bool(torch.isinf(t1[off]).all())
        assert bool((i1[off] == tracer._bvh.n_tris).all())


@pytest.mark.cuda
@NEEDS_GPU
def test_bvh_kernel_matches_grid_walk(bvh_case, cuda_case):
    """The BVH and grid kernels find the same hits on the primaries (the
    cross-backend standard)."""
    tracer, orig, dirs, opts = bvh_case
    grid = cuda_case[0]
    tb, ib = BW.bvh_walk_cuda(tracer._bvh, tracer._table, orig, dirs,
                              opts.t_min)
    tg, ig = W.grid_walk(grid._grid, grid._table, orig, dirs, opts.t_min)
    torch.cuda.synchronize()
    fin = torch.isfinite(tg)
    assert torch.equal(fin, torch.isfinite(tb))
    assert_walks_agree(tg[fin].cpu(), ig[fin].cpu(), tb[fin].cpu(),
                       ib[fin].cpu())


@pytest.mark.cuda
@NEEDS_GPU
def test_bvh_kernel_wrapper_rejects_bad_inputs(bvh_case):
    tracer, orig, dirs, opts = bvh_case
    b, table = tracer._bvh, tracer._table
    with pytest.raises(ValueError, match="contiguous"):
        BW.bvh_walk_cuda(b, table, orig, dirs.t().contiguous().t(),
                         opts.t_min)
    with pytest.raises(ValueError, match="float32"):
        BW.bvh_walk_cuda(b, table, orig.double(), dirs, opts.t_min)
    with pytest.raises(ValueError, match="shape"):
        BW.bvh_walk_cuda(b, table, orig, dirs, opts.t_min,
                         torch.full_like(orig[:-1, 0], 6.0))
    with pytest.raises(ValueError, match="bool"):
        BW.bvh_walk_cuda(b, table, orig, dirs, opts.t_min,
                         active=torch.ones_like(orig[:, 0]))
