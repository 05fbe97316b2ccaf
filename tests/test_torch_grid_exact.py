"""PyTorch port: exact (separating-axis) grid binning against the JAX
reference (`accel/satbin.py` and `build_grid(exact=True)`, byte for byte)
and the exact grid's walk and frame against the bounding-box grid's
(tests/test_grid.py's exact-binning cases).
"""

import numpy as np
import pytest
import torch

import raytracer_tpu.utils.native as ref_native
import raytracer_tpu_torch.utils.native as native
from raytracer_tpu.accel import satbin as ref_satbin
from raytracer_tpu.accel.grid import GridTracer as RefGridTracer
from raytracer_tpu.accel.grid import build_grid as ref_build_grid
from raytracer_tpu.renderer import render as ref_render
from raytracer_tpu_torch.accel import satbin
from raytracer_tpu_torch.accel.grid import GridTracer, build_grid
from raytracer_tpu_torch.ops import walk as W
from raytracer_tpu_torch.renderer import render
from tests.helpers import assert_images_close
from tests.torch_cases import port, subdiv3_config4

torch.set_num_threads(2)

GRID_FIELDS = ("bmin", "inv_cell", "cell_size", "cell_tris", "overflow",
               "ov_v0", "ov_e1", "ov_e2", "cell_soa")


@pytest.fixture(scope="module")
def mesh_case():
    return subdiv3_config4()


def _mesh(scene):
    return np.asarray(scene.meshes.verts), np.asarray(scene.meshes.tris)


def test_tri_cells_overlap_matches_reference():
    """Random triangles against random boxes: the same overlap verdicts,
    and some of each."""
    rng = np.random.default_rng(4)
    centers = rng.uniform(-1, 1, size=(200, 3))
    half = np.array([0.1, 0.15, 0.2])
    kept = 0
    for _ in range(20):
        v = rng.uniform(-1, 1, size=(3, 3))
        want = ref_satbin.tri_cells_overlap(v[0], v[1], v[2], centers, half)
        got = satbin.tri_cells_overlap(v[0], v[1], v[2], centers, half)
        np.testing.assert_array_equal(got, want)
        kept += int(got.sum())
    assert 0 < kept < 20 * 200


def test_exact_excludes_diagonal_corner_cell():
    """A thin anti-diagonal sliver touches the boxes of all 4 cells of a 2×2
    grid but misses the far corner cell (tests/test_grid.py's case)."""
    v0 = np.array([0.0, 1.0, 0.0])
    v1 = np.array([1.0, 0.0, 0.0])
    v2 = np.array([0.98, -0.02, 0.0])
    half = np.array([0.255, 0.255, 0.5])
    centers = np.array([[0.255, 0.255, 0.0], [0.765, 0.255, 0.0],
                        [0.255, 0.765, 0.0], [0.765, 0.765, 0.0]])
    keep = satbin.tri_cells_overlap(v0, v1, v2, centers, half)
    assert keep[1] and keep[2] and not keep[3]


@pytest.mark.parametrize("capacity", [128, 4])
def test_bin_exact_equals_reference(mesh_case, capacity):
    verts, tris = _mesh(mesh_case[0])
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64)
    bmin = verts.min(axis=0) - 0.01
    cell = (verts.max(axis=0) + 0.01 - bmin) / np.array([5, 6, 7])
    want = ref_satbin.bin_exact(verts, tris, bmin, cell, (5, 6, 7), capacity)
    got = satbin.bin_exact(verts, tris, bmin, cell, (5, 6, 7), capacity)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(b, a)
    if capacity == 4:
        assert got[1].shape[0] > 0  # the spill path is exercised


@pytest.mark.parametrize("builder,capacity", [("native", 128), ("native", 16),
                                              ("numpy", 128), ("numpy", 16)])
def test_build_grid_exact_equals_reference(mesh_case, monkeypatch, builder,
                                           capacity):
    """Byte-equal exact grids from the native SAT build and from the NumPy
    one (no native library)."""
    verts, tris = _mesh(mesh_case[0])
    if builder == "native":
        assert native.native_lib() is not None
        assert native.native_lib().has_grid_sat
    else:
        monkeypatch.setattr(native, "native_lib", lambda: None)
        monkeypatch.setattr(ref_native, "native_lib", lambda: None)
    want = ref_build_grid(verts, tris, capacity=capacity, density=0.125,
                          exact=True)
    got = build_grid(verts, tris, capacity=capacity, exact=True,
                     device="cpu")
    assert (got.res, got.capacity, got.n_tris) == (want.res, want.capacity,
                                                   want.n_tris)
    for f in GRID_FIELDS:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


def test_exact_binning_subset_and_coverage(mesh_case):
    """Exact cells list a subset of the box-binned cells' triangles (or of
    their spill), every triangle stays listed, and occupancy falls."""
    verts, tris = _mesh(mesh_case[0])
    t = tris.shape[0]
    ga = build_grid(verts, tris, capacity=16, exact=False, device="cpu")
    gx = build_grid(verts, tris, capacity=16, exact=True, device="cpu")
    ct_a, ct_x = ga.cell_tris.numpy(), gx.cell_tris.numpy()
    spill = set(ga.overflow.tolist())
    for c in range(ct_a.shape[0]):
        assert set(ct_x[c].tolist()) - {t} <= (set(ct_a[c].tolist()) - {t}
                                               ) | spill
    listed = (set(ct_x.ravel().tolist()) - {t}) | set(gx.overflow.tolist())
    assert listed == set(range(t))
    assert (ct_x < t).sum() < (ct_a < t).sum()


def test_exact_grid_walk_and_frame(mesh_case):
    """The exact grid's walk finds the box grid's hits (t bit-equal, ids
    equal but on exact-t ties across cell boundaries), and its frame is the
    box grid's and the reference's exact-grid frame (the goldens'
    standard)."""
    scene, cam, opts = mesh_case
    ps, pc, po = port(scene, cam, opts)
    box = GridTracer.build(ps, "cpu")
    exact = GridTracer.build(ps, "cpu", exact=True)
    from raytracer_tpu_torch.ops.geometry import raygen

    dirs = raygen(pc.to("cpu").c2w, pc.fov_deg, po.width, po.height)
    orig = torch.from_numpy(np.asarray(cam.pos, np.float32))[None].expand_as(
        dirs).contiguous()
    ta, ia = W.grid_walk(box._grid, box._table, orig, dirs, po.t_min)
    tx, ix = W.grid_walk(exact._grid, exact._table, orig, dirs, po.t_min)
    fin = torch.isfinite(ta)
    assert torch.equal(fin, torch.isfinite(tx)) and int(fin.sum()) > 100
    assert torch.equal(ta[fin], tx[fin])
    assert float((ia[fin] != ix[fin]).float().mean()) <= 0.005
    img_a, _ = render(ps, pc, po, device="cpu", tracer=box)
    img_x, _ = render(ps, pc, po, device="cpu", tracer=exact)
    assert_images_close(img_x.numpy(), img_a.numpy(), tol=0.004,
                        max_bad_frac=0.004, name="exact vs box grid")
    want = np.asarray(ref_render(scene, cam, opts, tracer=RefGridTracer.build(
        scene, exact=True))[0])
    assert_images_close(img_x.numpy(), want, tol=1e-4, max_bad_frac=0.004,
                        name="exact grid vs reference")


def test_config4_exact_grid_build():
    """config4's blob: the exact grid lists fewer candidates per cell at the
    default build and keeps every triangle."""
    from raytracer_tpu_torch.models import presets

    scene = presets.PRESETS["config4"]()[0]
    box = GridTracer.build(scene, "cpu")._grid
    exact = GridTracer.build(scene, "cpu", exact=True)._grid
    t = exact.n_tris
    n_box = int((box.cell_tris < t).sum())
    n_exact = int((exact.cell_tris < t).sum())
    assert n_exact < n_box
    listed = set(exact.cell_tris[exact.cell_tris < t].tolist())
    assert listed | set(exact.overflow.tolist()) == set(range(t))
    # the kernel's packed table holds exactly the listed rows
    assert W.pack_cell_table(exact).slots.shape[0] == n_exact
