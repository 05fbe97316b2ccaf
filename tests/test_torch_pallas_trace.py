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
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops import pallas_trace as PT
from raytracer_tpu_torch.renderer import render
from tests.helpers import assert_images_close
from tests.torch_cases import (assert_walks_agree, bumpy_config4, port,
                               tri_edge_case, tt)

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


# --- the kernel's packed rows and its staged tests ---------------------------


def test_pack_tri_rows_are_the_planar_table(tri_soa):
    tri = PT.pack_tris(*(torch.from_numpy(a) for a in tri_soa), bt=300)
    rows = PT.pack_tri_rows(tri)
    assert rows.dtype == torch.float32 and rows.is_contiguous()
    assert rows.shape == (tri.shape[1], 12)
    assert torch.equal(rows[:, :9], tri.T) and not bool(rows[:, 9:].any())


# special values of det, t·det, u·det, v·det: zeros of both signs, around
# eps, denormal, huge, infinite, NaN, and around the kernel's 2^64 and
# 2^-80 thresholds
_EPS = np.float32(1e-8)
_BIG, _TINY = np.float32(2.0 ** 64), np.float32(2.0 ** -80)
_UP, _DOWN = np.float32(np.inf), np.float32(0)
_SPECIAL = np.array([0.0, _EPS, np.nextafter(_EPS, _UP), 1e-45, 1e-30,
                     1e-3, 0.5, 1.0, 3.0, 1e30, 3e38, np.inf, np.nan, _BIG,
                     np.nextafter(_BIG, _UP), np.nextafter(_BIG, _DOWN),
                     _TINY, np.nextafter(_TINY, _UP),
                     np.nextafter(_TINY, _DOWN), 2.0 ** -100, 2.0 ** -60],
                    np.float32)


def _quantities():
    """(det, t·det, u·det, v·det) over the special values, random draws,
    and u or u + v next to 1 (u·det = |det|·(1 + δ), or v·det = (|det| -
    u·det)·(1 + δ), δ from ±2^-26 to ±2^-18), with det's sign applied."""
    s = np.concatenate([_SPECIAL, -_SPECIAL])
    rng = np.random.default_rng(1)
    mags = (10.0 ** rng.uniform(-12, 12, 300)).astype(np.float32)
    uv = np.concatenate([s, mags, -mags])
    grid = np.meshgrid(s, s, s, np.concatenate([s, uv[-40:]]),
                       indexing="ij")
    parts = [[torch.from_numpy(g.ravel()) for g in grid],
             [torch.from_numpy(rng.choice(uv, 200_000)) for _ in range(4)]]
    m = 200_000
    for which in ("u", "u+v"):
        dd = (rng.uniform(0.05, 20, m) * rng.choice([-1, 1], m)).astype(
            np.float32)
        delta = rng.choice([-1, 1], m) * 2.0 ** -rng.integers(18, 27, m)
        if which == "u":
            uu = (np.abs(dd) * (1 + delta)).astype(np.float32)
            vv = np.zeros(m, np.float32)
        else:
            uu = (np.abs(dd) * rng.uniform(0, 1, m)).astype(np.float32)
            vv = ((np.abs(dd) - uu) * (1 + delta)).astype(np.float32)
        sg = np.sign(dd).astype(np.float32)
        parts.append([torch.from_numpy(a) for a in (
            dd, sg * rng.uniform(0.1, 5, m).astype(np.float32), sg * uu,
            sg * vv)])
    return [torch.cat(x) for x in zip(*parts)]


# each threshold of the stages, weakened: where it applies, a test that
# hits is then skipped
_WEAKER = {"DET_EPS": 2e-8, "UV_TINY": 2.0 ** -110, "DET_BIG": float("inf"),
           "UV_CUT": 1.0}


@pytest.mark.parametrize("t_min", [1e-4, 0.0, -0.0, -1.0, float("nan")])
def test_kernel_stages_drop_only_misses(t_min, monkeypatch):
    """csrc/tri_trace.cu goes on with a test only while it can hit: |det|
    > eps; then, where |det| ≤ 2^64, u·det of det's sign in [-2^-80,
    |det|·(1 + 2^-20)]; then t·det of det's sign above 0 (t_min ≥ 0) or
    -inf (else) and v·det ≥ -2^-80 (in any-hit mode also u·det + v·det ≤
    |det|·(1 + 2^-20)). Where it stops, the reference's epilogue misses, so
    the plain version needs no such stages to stay equal to the kernel;
    and each threshold is sharp enough that a weaker one drops a hit."""
    from raytracer_tpu_torch.ops.mat_trace import _epilogue

    det, tn, un, vn = _quantities()
    t = _epilogue(det[:, None], un[:, None], vn[:, None], tn[:, None],
                  t_min)[:, 0]
    hit = torch.isfinite(t)
    tns = torch.where(det > 0, tn, -tn)
    masks = {}
    for occl in (False, True):
        past_det, past_u, kept = PT.stage_masks(det, un, vn, tn, t_min, occl)
        masks[occl] = kept
        assert bool((kept <= past_u).all())
        assert bool((past_u <= past_det).all())
        assert bool(torch.isinf(t[~kept]).all())
        assert bool((t[~kept] > 0).all())
        assert bool((~kept).any()) and bool(kept.any())
        if t_min == t_min:  # a NaN t_min misses everywhere
            assert int(hit[kept].sum()) > 1000
            for name, weaker in _WEAKER.items():
                with monkeypatch.context() as m:
                    m.setattr(PT, name, weaker)
                    weak = PT.stage_masks(det, un, vn, tn, t_min, occl)[2]
                assert bool((hit & ~weak).any()), name
    assert int((masks[False] & ~masks[True]).sum()) > 1000
    # t's stage is sharp: hits with t·det of det's sign at the smallest
    # denormal (t_min ≤ 0), and below 0 (t_min < 0)
    if t_min <= 0:
        assert bool((hit & (tns > 0) & (tns <= 1e-44)).any())
    if t_min < 0:
        assert bool((hit & (tns < 0)).any())


@pytest.mark.parametrize("t_min", [1e-4, 0.0, -1.0])
def test_kernel_stages_on_edge_rays(t_min):
    """`tri_stages` on tests/torch_cases.tri_edge_case (t·det == 0, det =
    ±0 and |det| at eps, non-finite rays): its t is the plain version's bit
    for bit, and every test it stops misses."""
    orig, dirs, tri = tri_edge_case()
    v0, e1, e2 = tri[0:3].T, tri[3:6].T, tri[6:9].T
    want, _, _ = geom.triangle_hits(orig, dirs, v0, e1, e2, t_min)
    assert int(torch.isfinite(want).sum()) > 1000
    for occl in (False, True):
        past_det, past_u, kept, t = PT.tri_stages(orig, dirs, v0, e1, e2,
                                                  t_min, occl)
        assert torch.equal(t, want)
        assert bool(torch.isinf(want[~kept]).all())
        # every stage drops tests here
        assert bool((~past_det).any()) and bool((past_det & ~past_u).any())
        assert bool((past_u & ~kept).any())
