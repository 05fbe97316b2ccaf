"""PyTorch port: the brute-force triangle search (`ops/pallas_trace.py`, the
K3 kernels) against the JAX reference.

The plain torch version, which `tri_nearest`/`tri_occluded` run on a CPU
tensor, is held against the reference's Pallas kernels in interpret mode (as
tests/test_pallas.py runs them); `PallasTracer` against the reference's
tracer; renders through it against the port's grid render and the JAX
default render. The CUDA kernels are held against the plain version in
tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

from raytracer_tpu.io import meshgen
from raytracer_tpu.ops import geometry as rgeom
from raytracer_tpu.ops import pallas_trace as RPT
from raytracer_tpu.renderer import render as ref_render
from raytracer_tpu_torch.accel.grid import GridTracer
from raytracer_tpu_torch.ops import pallas_trace as PT
from raytracer_tpu_torch.renderer import render
from tests.helpers import assert_images_close
from tests.torch_cases import assert_walks_agree, bumpy_config4, port, tt

torch.set_num_threads(2)
T_MIN = 1e-4


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(RPT, "_INTERPRET", True)


@pytest.fixture(scope="module")
def tri_soa():
    """tests/test_pallas.py's mesh: the subdiv-2 bumpy sphere at z = −4."""
    verts, tris = meshgen.bumpy_sphere(subdiv=2, radius=1.3)
    verts = verts + np.array([0, 0, -4], np.float32)
    v0 = verts[tris[:, 0]]
    return v0, verts[tris[:, 1]] - v0, verts[tris[:, 2]] - v0


@pytest.fixture(scope="module")
def rays():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(300, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.zeros((300, 3), np.float32), d.astype(np.float32)


@pytest.mark.parametrize("bt", [128, 512])
def test_pack_tris_equals_reference(tri_soa, bt):
    want = np.asarray(RPT.pack_tris(*tri_soa, bt=bt))
    got = PT.pack_tris(*(torch.from_numpy(a) for a in tri_soa), bt=bt)
    assert got.dtype == torch.float32 and got.shape[1] % bt == 0
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [300, 77])  # 77: not a multiple of a block
def test_tri_nearest_matches_reference(tri_soa, rays, n):
    orig, d = rays[0][:n], rays[1][:n]
    tb0, ib0 = RPT.tri_nearest(orig, d, RPT.pack_tris(*tri_soa, bt=128),
                               t_min=T_MIN, br=64, bt=128, interpret=True)
    tb1, ib1 = PT.tri_nearest(tt(orig), tt(d), PT.pack_tris(*tri_soa), T_MIN)
    tb0, ib0 = np.asarray(tb0), np.asarray(ib0)
    hits = np.isfinite(tb0)
    assert 0 < hits.sum() < n  # hits and misses both
    np.testing.assert_array_equal(np.isfinite(tb1.numpy()), hits)
    np.testing.assert_allclose(tb1.numpy()[hits], tb0[hits], rtol=1e-6)
    # ids exact, 0 on a miss (the reference's init)
    np.testing.assert_array_equal(ib1.numpy(), ib0)
    assert ib1.dtype == torch.int32


def test_tri_occluded_matches_reference(tri_soa, rays):
    orig, d = rays
    tri0 = RPT.pack_tris(*tri_soa, bt=128)
    tri1 = PT.pack_tris(*tri_soa)
    for max_t in (2.0, 5.0, 100.0):
        mx = np.full((orig.shape[0],), max_t, np.float32)
        want = np.asarray(RPT.tri_occluded(orig, d, mx, tri0, t_min=T_MIN,
                                           br=64, bt=128, interpret=True))
        got = PT.tri_occluded(tt(orig), tt(d), tt(mx), tri1, T_MIN)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


def test_active_mask_only_turns_masked_lanes_into_misses(tri_soa, rays):
    orig, d = (tt(a) for a in rays)
    tri = PT.pack_tris(*tri_soa)
    act = torch.from_numpy(np.random.default_rng(1).random(300) > 0.5)
    t_all, i_all = PT.tri_nearest(orig, d, tri, T_MIN)
    t_act, i_act = PT.tri_nearest(orig, d, tri, T_MIN, active=act)
    assert torch.equal(t_act[act], t_all[act])
    assert torch.equal(i_act[act], i_all[act])
    assert bool(torch.isinf(t_act[~act]).all())
    assert bool((i_act[~act] == 0).all())
    mx = torch.full((300,), 100.0)
    o_all = PT.tri_occluded(orig, d, mx, tri, T_MIN)
    o_act = PT.tri_occluded(orig, d, mx, tri, T_MIN, active=act)
    assert torch.equal(o_act[act], o_all[act]) and bool(o_all[~act].any())
    assert not bool(o_act[~act].any())


@pytest.fixture(scope="module")
def mesh_case():
    scene, cam, opts = bumpy_config4(2, 64, 36)
    pscene, pcam, popts = port(scene, cam, opts)
    dirs = rgeom.raygen(cam.pos, cam.c2w, cam.fov_deg, opts.width,
                        opts.height)
    orig = np.broadcast_to(np.asarray(cam.pos), dirs.shape)
    return scene, cam, opts, pscene, pcam, popts, orig, np.asarray(dirs)


def test_tracer_matches_reference_tracer(mesh_case):
    scene, _, opts, pscene, _, _, orig, dirs = mesh_case
    ref = RPT.PallasTracer(scene, br=64, bt=128)
    tr = PT.PallasTracer(pscene, "cpu")
    h0 = ref.nearest(orig, dirs, opts.t_min, opts.tri_chunk)
    h1 = tr.nearest(tt(orig), tt(dirs), opts.t_min, opts.tri_chunk)
    assert_walks_agree(h0.t, h0.idx, h1.t, h1.idx)
    np.testing.assert_array_equal(h1.kind.numpy(), np.asarray(h0.kind))
    mx = np.full((orig.shape[0],), 6.0, np.float32)
    o0 = np.asarray(ref.occluded(orig, dirs, mx, opts.t_min, opts.tri_chunk))
    o1 = tr.occluded(tt(orig), tt(dirs), tt(mx), opts.t_min, opts.tri_chunk)
    np.testing.assert_array_equal(o1.numpy(), o0)
    # masked lanes become misses; the live ones keep their hits
    act = torch.from_numpy(np.random.default_rng(2).random(orig.shape[0])
                           > 0.5)
    h2 = tr.nearest(tt(orig), tt(dirs), opts.t_min, opts.tri_chunk,
                    active=act)
    assert torch.equal(h2.t[act], h1.t[act])
    assert torch.equal(h2.idx[act], h1.idx[act])
    tri = h1.kind == 3  # KIND_TRIANGLE: masked triangle hits turn to misses
    assert bool(tri[~act].any()) and not bool((h2.kind[~act] == 3).any())


def test_render_matches_grid_and_reference(mesh_case):
    scene, cam, opts, pscene, pcam, popts, _, _ = mesh_case
    img, _ = render(pscene, pcam, popts, device="cpu",
                    tracer=PT.PallasTracer(pscene, "cpu"))
    grid, _ = render(pscene, pcam, popts, device="cpu",
                     tracer=GridTracer.build(pscene, "cpu"))
    assert_images_close(img.numpy(), grid.numpy(), tol=1e-6,
                        max_bad_frac=0.001, name="pallas vs grid")
    want = np.asarray(ref_render(scene, cam, opts)[0])  # dense search
    assert_images_close(img.numpy(), want, tol=1e-4, max_bad_frac=0.004,
                        name="pallas vs reference")
