"""PyTorch port: the linear-expansion triangle search (`ops/mat_trace.py`, the
K4 kernels) against the JAX reference.

The plain torch version, which `mat_nearest`/`mat_occluded` run on a CPU
tensor, is held against the reference's Pallas kernels in interpret mode (as
tests/test_mat_trace.py runs them). The two sum the features' products in
different orders (the reference: one f32 matrix product, XLA's order; the
port: k = 0…9, the CUDA kernel's order), so the raw search t differs by
rounding and the standard is tests/test_mat_trace.py's: winner ids and
hit/miss flips on at most 0.5% of rays (knife edges). `MatTracer` finalizes
the winner's t with `triangle_tuv`, which is held to rtol 2e-6. The CUDA
kernels are held against the plain version in tests/test_torch_kernels.py.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from raytracer_tpu.ops import geometry as rgeom
from raytracer_tpu.ops import mat_trace as RMT
from raytracer_tpu.renderer import render as ref_render
from raytracer_tpu_torch import cli
from raytracer_tpu_torch.accel.grid import GridTracer
from raytracer_tpu_torch.io.image import load_ppm
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.ops import mat_trace as MT
from raytracer_tpu_torch.ops.pallas_trace import PallasTracer, fold_nearest
from raytracer_tpu_torch.renderer import render
from raytracer_tpu_torch.utils.hostload import build_tracer
from tests.helpers import assert_images_close
from tests.torch_cases import (assert_walks_agree, bumpy_config4,
                               mat_edge_case, port, tt)

torch.set_num_threads(2)
BT = 512  # tests/test_mat_trace.py's weight block
KNIFE = 0.005  # share of rays whose id or hit/miss may differ
# The raw search t against the reference's: the two sum the same products
# in different orders. The largest relative gap read on these rays is
# 3.2e-7 (ids all equal); held to the cross-backend 2e-6.
SEARCH_RTOL = 2e-6


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(RMT, "_INTERPRET", True)


@pytest.fixture(scope="module")
def case():
    """tests/test_mat_trace.py's scene: config4 with the subdiv-3 bumpy
    sphere, its 64×40 primary rays; the reference's tracer and the port's."""
    scene, cam, opts = bumpy_config4(3, 64, 40)
    pscene, pcam, popts = port(scene, cam, opts)
    dirs = np.asarray(rgeom.raygen(cam.pos, cam.c2w, cam.fov_deg,
                                   opts.width, opts.height))
    orig = np.broadcast_to(np.asarray(cam.pos), dirs.shape).copy()
    ref = RMT.MatTracer.build(scene, bt=BT)
    tr = MT.MatTracer(pscene, "cpu")
    return scene, opts, pscene, ref, tr, orig, dirs


def _soa(scene):
    return tuple(np.asarray(a) for a in scene.meshes.tri_soa())


@pytest.mark.parametrize("bt", [64, BT, MT.BT])
def test_build_tri_weights_equals_reference(case, bt):
    soa = _soa(case[0])
    w0, c0 = RMT.build_tri_weights(*soa, bt=bt)
    w1, c1 = MT.build_tri_weights(*soa, bt=bt)
    assert w1.dtype == c1.dtype == torch.float32
    np.testing.assert_array_equal(w1.numpy(), np.asarray(w0))
    np.testing.assert_array_equal(c1.numpy(), np.asarray(c0))


def test_ray_features_match_reference(case):
    _, _, _, ref, tr, orig, dirs = case
    rng = np.random.default_rng(0)
    o = (orig + rng.normal(0, 2, orig.shape)).astype(np.float32)
    want = np.asarray(RMT.ray_features(o, dirs, ref._center))
    got = MT.ray_features(tt(o), tt(dirs), tr._center)
    assert got.shape == (o.shape[0], 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _search_both(case, max_t=None, rays=slice(None)):
    scene, opts, _, ref, _, orig, dirs = case
    orig, dirs = orig[rays], dirs[rays]
    w0, c0 = RMT.build_tri_weights(*_soa(scene), bt=BT)
    w1, c1 = MT.build_tri_weights(*_soa(scene), bt=BT)
    f0 = RMT.ray_features(orig, dirs, c0)
    f1 = MT.ray_features(tt(orig), tt(dirs), c1)
    t_min = float(opts.t_min)
    if max_t is None:
        return (RMT.mat_nearest(f0, w0, t_min=t_min, bt=BT, interpret=True),
                MT.mat_nearest(f1, w1, t_min, BT))
    mx = np.full((orig.shape[0],), max_t, np.float32)
    return (RMT.mat_occluded(f0, mx, w0, t_min=t_min, bt=BT, interpret=True),
            MT.mat_occluded(f1, tt(mx), w1, t_min, BT))


# 77 rays across the mesh: not a multiple of a block
@pytest.mark.parametrize("rays", [slice(None), slice(1300, 1377)])
def test_mat_nearest_matches_reference(case, rays):
    (t0, i0), (t1, i1) = _search_both(case, rays=rays)
    t0, i0, t1, i1 = np.asarray(t0), np.asarray(i0), t1.numpy(), i1.numpy()
    fin = np.isfinite(t0)
    assert fin.sum() > 20 and i1.dtype == np.int32
    assert (fin != np.isfinite(t1)).mean() <= KNIFE
    both = fin & np.isfinite(t1)
    np.testing.assert_allclose(t1[both], t0[both], rtol=SEARCH_RTOL)
    assert (i1[both] != i0[both]).mean() <= KNIFE
    assert (i1[~np.isfinite(t1)] == 0).all()  # 0 on a miss


@pytest.mark.parametrize("max_t", [5.5, 6.0, 100.0])
def test_mat_occluded_matches_reference(case, max_t):
    o0, o1 = _search_both(case, max_t=max_t)
    assert o1.dtype == torch.bool and 0 < np.asarray(o0).sum()
    assert (o1.numpy() != np.asarray(o0)).mean() <= KNIFE


def test_finalize_matches_reference(case):
    _, opts, _, ref, tr, orig, dirs = case
    tb, ib = MT.mat_nearest(MT.ray_features(tt(orig), tt(dirs), tr._center),
                            tr._w, opts.t_min)
    want = np.asarray(ref._finalize(orig, dirs, tb.numpy(), ib.numpy(),
                                    opts.t_min))
    got = tr._finalize(tt(orig), tt(dirs), tb, ib, opts.t_min).numpy()
    fin = np.isfinite(want)
    assert fin.sum() > 100
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=2e-6)


def test_tracer_matches_reference_tracer(case):
    _, opts, _, ref, tr, orig, dirs = case
    h0 = ref.nearest(orig, dirs, opts.t_min, opts.tri_chunk)
    h1 = tr.nearest(tt(orig), tt(dirs), opts.t_min, opts.tri_chunk)
    assert_walks_agree(h0.t, h0.idx, h1.t, h1.idx)
    assert (h1.kind.numpy() != np.asarray(h0.kind)).mean() <= KNIFE
    mx = np.full((orig.shape[0],), 6.0, np.float32)
    o0 = np.asarray(ref.occluded(orig, dirs, mx, opts.t_min, opts.tri_chunk))
    o1 = tr.occluded(tt(orig), tt(dirs), tt(mx), opts.t_min, opts.tri_chunk)
    assert (o1.numpy() != o0).mean() <= KNIFE
    # masked lanes become misses; the live ones keep their hits
    act = torch.from_numpy(np.random.default_rng(2).random(orig.shape[0])
                           > 0.5)
    h2 = tr.nearest(tt(orig), tt(dirs), opts.t_min, opts.tri_chunk,
                    active=act)
    assert torch.equal(h2.t[act], h1.t[act])
    assert torch.equal(h2.idx[act], h1.idx[act])
    tri = h1.kind == 3  # KIND_TRIANGLE: masked triangle hits turn to misses
    assert bool(tri[~act].any()) and not bool((h2.kind[~act] == 3).any())
    o2 = tr.occluded(tt(orig), tt(dirs), tt(mx), opts.t_min, opts.tri_chunk,
                     active=act)
    assert torch.equal(o2[act], o1[act])


def test_render_matches_grid_and_reference():
    scene, cam, opts = bumpy_config4(2, 64, 36)
    pscene, pcam, popts = port(scene, cam, opts)
    img, _ = render(pscene, pcam, popts, device="cpu",
                    tracer=MT.MatTracer(pscene, "cpu"))
    grid, _ = render(pscene, pcam, popts, device="cpu",
                     tracer=GridTracer.build(pscene, "cpu"))
    assert_images_close(img.numpy(), grid.numpy(), tol=1e-4,
                        max_bad_frac=0.004, name="mat vs grid")
    want = np.asarray(ref_render(scene, cam, opts)[0])  # dense search
    assert_images_close(img.numpy(), want, tol=1e-4, max_bad_frac=0.004,
                        name="mat vs reference")


def test_build_tracer_kinds():
    pscene = port(*bumpy_config4(2, 8, 8))[0]
    assert isinstance(build_tracer(pscene, "pallas", "cpu"), PallasTracer)
    assert isinstance(build_tracer(pscene, "mat", "cpu"), MT.MatTracer)
    nomesh = presets.config1_sphere_plane()[0]
    assert build_tracer(nomesh, "mat", "cpu") is None


@pytest.mark.parametrize("kind", ["pallas", "mat"])
def test_cli_render(tmp_path, kind):
    out = str(tmp_path / f"c4_{kind}.ppm")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["render", "--config", "config4", "--tracer", kind,
                  "--width", "32", "--height", "18", "--max-depth", "1",
                  "--device", "cpu", "--out", out])
    assert "config4: 32x18 depth=1" in buf.getvalue()
    img = load_ppm(out)
    assert img.shape == (18, 32, 3) and img.std() > 0.01


# --- the zero-skipping search against the full product -----------------------


@pytest.mark.parametrize("bt", [300, BT])
def test_pack_mat_table_rows_are_the_nonzero_weights(case, bt):
    soa = _soa(case[0])
    w, _ = MT.build_tri_weights(*soa, bt=bt)
    table = MT.pack_mat_table(w, bt)
    tp, n_tris = w.shape[1] // 4, soa[0].shape[0]
    assert tp > n_tris  # padding triangles at both block sizes
    assert table.rows.dtype == torch.float32
    assert table.rows.shape == (tp, 20) and table.rows.is_contiguous()
    j = np.arange(tp)
    col = 4 * bt * (j // bt) + j % bt
    wn = w.numpy()
    det, u, v, t = (wn[:, col + q * bt] for q in range(4))
    # every entry left out is zero, in every column
    assert not det[3:].any() and not u[6:].any() and not v[6:].any()
    assert not t[:6].any() and not t[10:].any()
    want = np.concatenate([det[:3].T, u[:6].T, v[:6].T, t[6:10].T,
                           np.zeros((tp, 1), np.float32)], axis=1)
    np.testing.assert_array_equal(table.rows.numpy(), want)
    assert not table.rows[n_tris:].any()  # padding triangles
    assert table.rows[:n_tris, :3].abs().sum(1).min() > 0  # det rows live


def test_checked_table_refuses_stale_and_misshapen_tables(case):
    soa = _soa(case[0])
    w, _ = MT.build_tri_weights(*soa, bt=BT)
    table = MT.pack_mat_table(w, BT)
    assert MT.checked_table(w, BT, table) is table
    assert torch.equal(MT.checked_table(w, BT).rows, table.rows)
    with pytest.raises(ValueError, match="stale"):
        MT.checked_table(w.clone(), BT, table)  # other weights
    w2, _ = MT.build_tri_weights(*soa, bt=256)
    with pytest.raises(ValueError, match="stale"):
        MT.checked_table(w2, 256, table)  # other blocks
    with pytest.raises(ValueError, match="shape"):
        MT.checked_table(w, BT, dataclasses.replace(table,
                                                    rows=table.rows[:-1]))
    with pytest.raises(ValueError, match="float32"):
        MT.checked_table(w, BT, dataclasses.replace(
            table, rows=table.rows.double()))
    w.add_(0.0)  # an in-place change of the weights makes the table stale
    with pytest.raises(ValueError, match="stale"):
        MT.checked_table(w, BT, table)


def _full_search(feats, w, t_min, bt, max_t=None):
    """The search as the full 10-term product (k = 0…9 in order, every
    row, the zeros included), the reference's epilogue and the folds."""
    tp = w.shape[1] // 4
    qs = []
    for q in range(4):
        cols = torch.cat([w[:, (4 * b + q) * bt:(4 * b + q + 1) * bt]
                          for b in range(tp // bt)], dim=1)
        acc = feats[:, 0:1] * cols[0:1]
        for k in range(1, 10):
            acc = acc + feats[:, k:k + 1] * cols[k:k + 1]
        qs.append(acc)
    ts = MT._epilogue(*qs, t_min)
    if max_t is None:
        n = feats.shape[0]
        return fold_nearest(ts, 0, torch.full((n,), float("inf")),
                            torch.zeros((n,), dtype=torch.int32))
    return (ts < max_t[:, None]).any(dim=1)


def _case_feats(case):
    _, _, _, _, tr, orig, dirs = case
    return tr._w, MT.BT, MT.ray_features(tt(orig), tt(dirs), tr._center)


@pytest.mark.parametrize("rays", ["case", "edge"])
@pytest.mark.parametrize("t_min", [1e-4, 0.0, -1.0])
def test_zero_skipping_search_equals_full_product(case, rays, t_min):
    w, bt, feats = _case_feats(case) if rays == "case" else mat_edge_case()
    t1, i1 = MT.mat_nearest_plain(feats, w, t_min, bt)
    t0, i0 = _full_search(feats, w, t_min, bt)
    assert torch.equal(t1, t0) and torch.equal(i1, i0)
    assert int(torch.isfinite(t0).sum()) > 100
    finite = torch.isfinite(feats[:, :10]).all(dim=1)
    if rays == "edge":  # non-finite features: misses, in both
        assert int((~finite).sum()) > 50
        assert bool(torch.isinf(t1[~finite]).all())
        assert not bool(i1[~finite].any())
    for mx in (6.0, float("inf")):
        max_t = torch.full((feats.shape[0],), mx)
        o1 = MT.mat_occluded_plain(feats, max_t, w, t_min, bt)
        o0 = _full_search(feats, w, t_min, bt, max_t)
        assert torch.equal(o1, o0) and bool(o0.any())
        assert not bool(o1[~finite].any())


# special values of det, t·det, u·det, v·det: zeros of both signs, around
# eps, denormal, huge, infinite, NaN, and around the kernel's 2^64 and
# 2^-80 thresholds
_EPS = np.float32(1e-8)
_BIG, _TINY = np.float32(2.0 ** 64), np.float32(2.0 ** -80)
_SUM_CUT = np.float32(1 + 2.0 ** -20)
_UP, _DOWN = np.float32(np.inf), np.float32(0)
_SPECIAL = np.array([0.0, _EPS, np.nextafter(_EPS, _UP), 1e-45, 1e-30,
                     1e-3, 0.5, 1.0, 3.0, 1e30, 3e38, np.inf, np.nan, _BIG,
                     np.nextafter(_BIG, _UP), np.nextafter(_BIG, _DOWN),
                     _TINY, np.nextafter(_TINY, _UP),
                     np.nextafter(_TINY, _DOWN), 2.0 ** -100, 2.0 ** -60],
                    np.float32)


@pytest.mark.parametrize("t_min", [1e-4, 0.0, -0.0, -1.0, float("nan")])
def test_kernel_prefilter_drops_only_misses(t_min):
    """csrc/mat_trace.cu takes the reciprocal and the epilogue only where
    |det| > eps, t·det of det's sign exceeds 0 (t_min ≥ 0) or -inf (else),
    and, where |det| ≤ 2^64, u·det and v·det of det's sign are ≥ -2^-80
    (in any-hit mode also their sum ≤ |det|·(1 + 2^-20)). Where it skips,
    the reference's epilogue misses, so the plain version needs no such
    prefilter to stay equal to the kernel."""
    s = np.concatenate([_SPECIAL, -_SPECIAL])
    rng = np.random.default_rng(1)
    mags = (10.0 ** rng.uniform(-12, 12, 300)).astype(np.float32)
    uv = np.concatenate([s, mags, -mags])
    grid = np.meshgrid(s, s, s, np.concatenate([s, uv[-40:]]),
                       indexing="ij")
    det, tn, un, vn = (torch.from_numpy(g.ravel()) for g in grid)
    # and random draws of all four, signs and magnitudes mixed
    draws = [torch.from_numpy(rng.choice(uv, 200_000)) for _ in range(4)]
    # and u + v next to 1: v·det = (|det| - u·det)·(1 + δ), δ from ±2^-26
    # to ±2^-18, with t·det in front
    m = 200_000
    dd = (rng.uniform(0.05, 20, m) * rng.choice([-1, 1], m)).astype(np.float32)
    uu = (np.abs(dd) * rng.uniform(0, 1, m)).astype(np.float32)
    delta = rng.choice([-1, 1], m) * 2.0 ** -rng.integers(18, 27, m)
    vv = ((np.abs(dd) - uu) * (1 + delta)).astype(np.float32)
    sg = np.sign(dd).astype(np.float32)
    edge = [torch.from_numpy(a) for a in
            (dd, sg * rng.uniform(0.1, 5, m).astype(np.float32), sg * uu,
             sg * vv)]
    det, tn, un, vn = (torch.cat([x, y, z]) for x, y, z in
                       zip((det, tn, un, vn), draws, edge))
    lim = 0.0 if t_min >= 0 else float("-inf")
    pos = det > 0
    tns, uns, vns = (torch.where(pos, x, -x) for x in (tn, un, vn))
    ad = det.abs()
    keep = (ad > _EPS) & (tns > lim) & (
        (ad > _BIG) | ((uns >= -_TINY) & (vns >= -_TINY)))
    # any-hit mode: also u·det + v·det > |det|·(1 + 2^-20) skips
    keep_any = keep & ((ad > _BIG) | ~(uns + vns > ad * _SUM_CUT))
    t = MT._epilogue(det[:, None], un[:, None], vn[:, None], tn[:, None],
                     t_min)[:, 0]
    for kept in (keep, keep_any):
        assert bool(torch.isinf(t[~kept]).all())
        assert bool((t[~kept] > 0).all())
        assert bool((~kept).any()) and bool(kept.any())
        if t_min == t_min:  # a NaN t_min misses everywhere
            assert int(torch.isfinite(t[kept]).sum()) > 1000
    assert int((keep & ~keep_any).sum()) > 1000
