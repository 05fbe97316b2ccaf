"""PyTorch port: the BVH build, its threaded walk and `BVHTracer` against the
JAX reference and brute force (tests/test_bvh.py's cases), and `cli render
--tracer bvh`.

The walk compared here is the plain torch version (`accel.bvh.bvh_walk`,
what `ops/bvh_walk.bvh_trace` runs on a CPU tensor); the CUDA kernel is held
against it in tests/test_torch_kernels.py. Against the reference the
cross-backend standard holds on hits: the same hit/miss sets, t at rtol
2e-6, winner ids equal except on knife edges. The reference's walk runs op
by op (`jax.disable_jit`): its jitted while_loop contracts multiply-adds,
which moved one hit of the 96×54 primaries by 2.3e-6 relative, while op by
op it equals the port's walk bit for bit. A miss's id is not compared: the
reference's loop folds the last node's leaf into every parked lane while
other lanes still walk, so its miss ids depend on the batch; the port's
parked lanes keep theirs.
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

import raytracer_tpu.utils.native as ref_native
import raytracer_tpu_torch.utils.native as native
from raytracer_tpu.accel.bvh import BVHTracer as RefBVHTracer
from raytracer_tpu.accel.bvh import build_bvh as ref_build_bvh
from raytracer_tpu.accel.bvh import bvh_walk as ref_bvh_walk
from raytracer_tpu.ops import geometry as rgeom
from raytracer_tpu.renderer import render as ref_render
from raytracer_tpu_torch.accel.bvh import BVHTracer, build_bvh, bvh_walk
from raytracer_tpu_torch.core.types import Planes, Spheres, scene_from_arrays
from raytracer_tpu_torch.io.image import load_ppm
from raytracer_tpu_torch.kernels.build import warp_work
from raytracer_tpu_torch.ops import trace as trace_ops
from raytracer_tpu_torch.ops.bvh_walk import bvh_trace, pack_bvh_table
from raytracer_tpu_torch.renderer import as_leaf, render
from raytracer_tpu_torch.utils.hostload import build_tracer
from tests.helpers import assert_images_close
from tests.torch_cases import bumpy_config4, port

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_MIN = 1e-4


def assert_hits_agree(t0, i0, t1, i1):
    """Identical hit/miss sets, hit distances at rtol 2e-6, winner ids of
    hits equal on all but 0.5% of them (knife edges)."""
    t0, t1, i0, i1 = (np.asarray(x) for x in (t0, t1, i0, i1))
    fin = np.isfinite(t0)
    assert (fin == np.isfinite(t1)).all(), "hit/miss sets differ"
    np.testing.assert_allclose(t1[fin], t0[fin], rtol=2e-6)
    assert (i0[fin] != i1[fin]).mean() <= 0.005, "winner ids differ"


@pytest.fixture(scope="module")
def mesh_scene():
    """tests/test_bvh.py's scene: config4 with a subdiv-3 bumpy sphere, at
    96×54, depth 2."""
    return bumpy_config4(3, 96, 54)


def _mesh(scene):
    return np.asarray(scene.meshes.verts), np.asarray(scene.meshes.tris)


def _soa(verts, tris):
    v0 = verts[tris[:, 0]]
    return v0, verts[tris[:, 1]] - v0, verts[tris[:, 2]] - v0


@pytest.mark.parametrize("builder", ["native", "numpy", "sah", "leaf1"])
def test_build_bvh_equals_reference(mesh_scene, monkeypatch, builder):
    """Byte-equal trees: the native median build, the NumPy median build
    (no native library) and binned SAH (NumPy only)."""
    verts, tris = _mesh(mesh_scene[0])
    if builder == "native":
        assert native.native_lib() is not None
        assert native.native_lib().has_bvh
    if builder == "numpy":
        monkeypatch.setattr(native, "native_lib", lambda: None)
        monkeypatch.setattr(ref_native, "native_lib", lambda: None)
    sah = builder == "sah"
    leaf = 1 if builder == "leaf1" else 8
    want = ref_build_bvh(verts, tris, leaf_size=leaf, pregather=False,
                         sah=sah)
    got = build_bvh(verts, tris, leaf_size=leaf, sah=sah, device="cpu")
    assert (got.n_nodes, got.capacity, got.n_tris) == (
        want.n_nodes, want.capacity, want.n_tris)
    for name in ("aabb6", "links2", "leaf_tris"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_bvh_build_covers_all_tris(mesh_scene):
    verts, tris = _mesh(mesh_scene[0])
    b = build_bvh(verts, tris, leaf_size=8, device="cpu")
    t = tris.shape[0]
    assert set(b.leaf_tris.reshape(-1).tolist()) - {t} == set(range(t))
    lk = b.links2.numpy()
    assert lk.min() >= 0 and lk.max() <= b.n_nodes
    table = pack_bvh_table(b, *(torch.from_numpy(x)
                                for x in _soa(verts, tris)))
    counts = table.nodes[:, 7].contiguous().view(torch.int32)
    assert int(counts.sum()) == t == table.slots.shape[0]


def test_bvh_walk_unit_cases():
    verts = np.array([[-1, -1, -3], [1, -1, -3], [0, 1, -3]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    b = build_bvh(verts, tris, leaf_size=4, device="cpu")
    orig = torch.tensor([[0.0, 0.0, 0.0],    # hit head-on
                         [0.0, 0.0, -5.0],   # behind, shooting away
                         [5.0, 5.0, 0.0],    # misses the root box
                         [0.0, 0.0, -2.9]])  # origin inside the box
    direc = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    t, i = bvh_walk(b, *(torch.from_numpy(x) for x in _soa(verts, tris)),
                    orig, direc, T_MIN)
    assert float(t[0]) == pytest.approx(3.0, abs=1e-5)
    assert np.isinf(float(t[1])) and np.isinf(float(t[2]))
    assert float(t[3]) == pytest.approx(0.1, abs=1e-5)
    assert int(i[0]) == 0


def _walk_both(scene, orig, d, max_t=None, active=None):
    """The reference's bvh_walk (op by op) and the port's plain walk on one
    tree."""
    ref = RefBVHTracer.build(scene, pregather=False)
    got = BVHTracer.build(scene_from_arrays(scene), "cpu")
    with jax.disable_jit():
        want = ref_bvh_walk(
            ref._bvh, *ref._soa, jnp.asarray(orig), jnp.asarray(d), T_MIN,
            occlusion_max_t=None if max_t is None else jnp.asarray(max_t),
            active=None if active is None else jnp.asarray(active))
    have = bvh_trace(got._bvh, got._table, torch.from_numpy(orig),
                     torch.from_numpy(d), T_MIN,
                     None if max_t is None else torch.from_numpy(max_t),
                     None if active is None else torch.from_numpy(active))
    return want, have, got


def test_bvh_all_octants(mesh_scene):
    """The same rays in all 8 direction-sign combinations through the mesh:
    the reference's walk and brute force."""
    scene = mesh_scene[0]
    rng = np.random.default_rng(11)
    base_d = np.abs(rng.normal(size=(64, 3))) + 0.05
    center = np.array([0.0, -0.1, -5.5])
    for o in range(8):
        sign = np.array([1 - 2 * ((o >> a) & 1) for a in range(3)])
        d = base_d * sign
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        orig = (center - d * 4.0).astype(np.float32)
        (t0, i0), (t1, i1), tracer = _walk_both(scene, orig, d)
        assert_hits_agree(t0, i0, t1, i1)
        assert np.isfinite(np.asarray(t1)).mean() > 0.5
        mesh_only = scene_from_arrays(scene).replace(
            spheres=Spheres.empty(), planes=Planes.empty()).to("cpu")
        brute = trace_ops.nearest_hit(mesh_only, torch.from_numpy(orig),
                                      torch.from_numpy(d), T_MIN, 256)
        assert_hits_agree(brute.t, brute.idx, t1, i1)


def _random_rays(n, seed):
    rng = np.random.default_rng(seed)
    orig = (rng.normal(size=(n, 3)) * 2 + np.array([0, 0, -5.5])).astype(
        np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return orig, d


@pytest.mark.parametrize("mode", ["nearest", "occlusion"])
def test_bvh_walk_matches_reference_and_brute(mesh_scene, mode):
    scene, cam, opts = mesh_scene
    dirs = np.asarray(rgeom.raygen(cam.pos, cam.c2w, cam.fov_deg, opts.width,
                                   opts.height))
    o_cam = np.broadcast_to(np.asarray(cam.pos, np.float32), dirs.shape)
    o_rnd, d_rnd = _random_rays(512, 3)
    orig = np.ascontiguousarray(np.concatenate([o_cam, o_rnd]))
    d = np.ascontiguousarray(np.concatenate([dirs, d_rnd]))
    max_t = (np.full(orig.shape[:1], 4.0, np.float32) if mode == "occlusion"
             else None)
    (t0, i0), (t1, i1), tracer = _walk_both(scene, orig, d, max_t)
    if max_t is None:
        assert_hits_agree(t0, i0, t1, i1)
        assert np.isfinite(np.asarray(t1)).sum() > 300
        hit = tracer.nearest(torch.from_numpy(orig), torch.from_numpy(d),
                             T_MIN, 512)
        want = trace_ops.nearest_hit(port(scene, cam, opts)[0].to("cpu"),
                                     torch.from_numpy(orig),
                                     torch.from_numpy(d), T_MIN, 512)
        assert_hits_agree(want.t, want.kind * 100000 + want.idx, hit.t,
                          hit.kind * 100000 + hit.idx)
    else:
        np.testing.assert_array_equal(np.asarray(t1) < max_t,
                                      np.asarray(t0) < max_t)
        mt = torch.from_numpy(max_t)
        got = tracer.occluded(torch.from_numpy(orig), torch.from_numpy(d), mt,
                              T_MIN, 512)
        want = trace_ops.occluded(port(scene, cam, opts)[0].to("cpu"),
                                  torch.from_numpy(orig), torch.from_numpy(d),
                                  mt, T_MIN, 512)
        assert torch.equal(got, want)
        assert 0 < int(got.sum()) < got.shape[0]


def test_bvh_active_mask_parks_lanes(mesh_scene):
    """active=False lanes return (inf, n_tris); active lanes are unchanged,
    in both modes."""
    scene = mesh_scene[0]
    orig, d = _random_rays(256, 7)
    act = np.random.default_rng(7).random(256) < 0.5
    (_, _), (t_full, i_full), tracer = _walk_both(scene, orig, d)
    (t0, i0), (t1, i1), _ = _walk_both(scene, orig, d, active=act)
    a = torch.from_numpy(act)
    assert torch.equal(t1[a], t_full[a]) and torch.equal(i1[a], i_full[a])
    assert bool(torch.isinf(t1[~a]).all())
    assert bool((i1[~a] == tracer._bvh.n_tris).all())
    assert_hits_agree(t0, i0, t1, i1)
    mt = torch.full((256,), 4.0)
    o, dd = torch.from_numpy(orig), torch.from_numpy(d)
    full = tracer.occluded(o, dd, mt, T_MIN, 512)
    masked = tracer.occluded(o, dd, mt, T_MIN, 512, active=a)
    assert torch.equal(masked[a], full[a])


def test_bvh_render_matches_reference(mesh_scene):
    scene, cam, opts = mesh_scene
    want = np.asarray(ref_render(scene, cam, opts,
                                 tracer=RefBVHTracer.build(scene))[0])
    ps, pc, po = port(scene, cam, opts)
    got, _ = render(ps, pc, po, device="cpu",
                    tracer=BVHTracer.build(ps, "cpu"))
    assert_images_close(got.numpy(), want, tol=1e-4, max_bad_frac=0.004,
                        name="bvh")


@pytest.mark.parametrize("leaf", [8, 1])
def test_bvh_render_equals_brute(mesh_scene, leaf):
    """tests/test_bvh.py: the BVH frame equals the dense search's, leaves of
    8 and of 1 triangle (the deepest tree)."""
    ps, pc, po = port(*mesh_scene)
    ref, n_ref = render(ps, pc, po, device="cpu", count_rays=True)
    img, n = render(ps, pc, po, device="cpu", count_rays=True,
                    tracer=BVHTracer.build(ps, "cpu", leaf_size=leaf))
    assert float(n) == float(n_ref)
    assert_images_close(img.numpy(), ref.numpy(), tol=1e-6,
                        max_bad_frac=0.001, name=f"bvh-leaf{leaf}")


def test_bvh_gradients_match_brute(mesh_scene):
    """The winner recompute does not depend on the search: loss gradients
    for vertices and albedos through the BVH equal the dense search's."""
    ps, pc, po = port(*mesh_scene)
    po = dataclasses.replace(po, width=48, height=27, max_depth=1)
    tracer = BVHTracer.build(ps, "cpu")

    def grads(tr):
        v = as_leaf(ps.meshes.verts, "cpu")
        a = as_leaf(ps.materials.albedo, "cpu")
        sc = ps.to("cpu")
        sc = sc.replace(meshes=dataclasses.replace(sc.meshes, verts=v),
                        materials=dataclasses.replace(sc.materials, albedo=a))
        img, _ = render(sc, pc, po, device="cpu", tracer=tr)
        (img ** 2).sum().backward()
        return v.grad.numpy(), a.grad.numpy()

    gv_ref, ga_ref = grads(None)
    gv, ga = grads(tracer)
    assert np.abs(gv_ref).max() > 0 and np.abs(ga_ref).max() > 0
    np.testing.assert_allclose(ga, ga_ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gv, gv_ref, rtol=1e-3, atol=1e-5)


def test_bvh_sah_agrees_with_median(mesh_scene):
    """SAH tree: no more nodes than the median tree, every triangle listed,
    the same hits."""
    verts, tris = _mesh(mesh_scene[0])
    bm = build_bvh(verts, tris, leaf_size=8, sah=False, device="cpu")
    bs = build_bvh(verts, tris, leaf_size=8, sah=True, device="cpu")
    assert bs.n_nodes <= bm.n_nodes
    t = tris.shape[0]
    leaf = bs.leaf_tris.numpy()
    assert set(leaf[leaf != t].tolist()) == set(range(t))
    soa = [torch.from_numpy(x) for x in _soa(verts, tris)]
    orig, d = (torch.from_numpy(x) for x in _random_rays(512, 5))
    tm, im = bvh_walk(bm, *soa, orig, d, T_MIN)
    ts, is_ = bvh_walk(bs, *soa, orig, d, T_MIN)
    fin = torch.isfinite(tm)
    assert torch.equal(fin, torch.isfinite(ts))
    assert torch.equal(tm[fin], ts[fin]) and torch.equal(im[fin], is_[fin])


@pytest.mark.parametrize("builder", ["port", "reference"])
def test_bvh_sah_degenerate_centroids(builder):
    """All-coincident centroids: SAH falls back to the median split, and
    the two packages build the same tree."""
    v = np.array([[0, 0, -3], [1, 0, -3], [0, 1, -3]], np.float32)
    verts = np.concatenate([v] * 17)
    tris = np.arange(51).reshape(17, 3).astype(np.int32)
    b = build_bvh(verts, tris, leaf_size=2, sah=True, device="cpu")
    leaf = b.leaf_tris.numpy()
    assert set(leaf[leaf != 17].tolist()) == set(range(17))
    if builder == "reference":
        want = ref_build_bvh(verts, tris, leaf_size=2, pregather=False,
                             sah=True)
        np.testing.assert_array_equal(leaf, np.asarray(want.leaf_tris))
        np.testing.assert_array_equal(b.links2.numpy(),
                                      np.asarray(want.links2))


def test_build_tracer_bvh():
    from raytracer_tpu_torch.models import presets

    scene = presets.PRESETS["config4"]()[0]
    tr = build_tracer(scene, "bvh", "cpu")
    assert isinstance(tr, BVHTracer) and tr._bvh.n_tris == scene.meshes.count
    assert build_tracer(presets.PRESETS["config1"]()[0], "bvh", "cpu") is None


def test_cli_render_bvh(tmp_path):
    """`cli render --tracer bvh` on config4 192×108 d4 against the golden
    (tests/test_forward_golden.py's standard) and against the grid frame."""
    out = str(tmp_path / "c4.ppm")
    cmd = [sys.executable, "-m", "raytracer_tpu_torch.cli", "render",
           "--config", "config4", "--tracer", "bvh", "--width", "192",
           "--height", "108", "--device", "cpu", "--out", out]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "config4: 192x108 depth=4" in r.stdout and "rays/s" in r.stdout
    got = load_ppm(out)
    want = load_ppm(os.path.join(ROOT, "tests", "golden",
                                 "config4_192x108.ppm"))
    assert_images_close(got, want, tol=0.004, max_bad_frac=0.004,
                        name="config4 bvh")


def _warp_sum(slots):
    """Σ over groups of 32 consecutive slots of 32 × the group's largest
    entry, the last group padded with zeros (a loop, as a warp runs)."""
    total = 0
    for g in range(0, len(slots), 32):
        total += 32 * max(slots[g:g + 32])
    return total


@pytest.mark.parametrize("mode", ["nearest", "occlusion"])
@pytest.mark.parametrize("order", ["lanes", "live"])
def test_bvh_walk_warp_steps(mesh_scene, mode, order):
    """The walk's counters against a loop over lanes: each lane walked
    alone gives its steps and tests, `lane_steps` holds each lane's, and
    `warp_work` of them in a slot order (all lanes, or the active ones in
    ascending order) is Σ over groups of 32 slots of 32 × the group's
    longest walk. Passing `stats` leaves the outputs bit-equal."""
    tracer = BVHTracer.build(scene_from_arrays(mesh_scene[0]), "cpu")
    b, table = tracer._bvh, tracer._table
    n = 100
    orig, d = (torch.from_numpy(x) for x in _random_rays(n, 11))
    act = torch.from_numpy(np.random.default_rng(11).random(n) < 0.6)
    mt = torch.full((n,), 4.0) if mode == "occlusion" else None
    stats = {}
    got = bvh_walk(b, *table.soa, orig, d, T_MIN, mt, act, stats=stats)
    want = bvh_walk(b, *table.soa, orig, d, T_MIN, mt, act)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    steps, tests = [], 0
    for i in range(n):
        one = {}
        if bool(act[i]):
            bvh_walk(b, *table.soa, orig[i:i + 1], d[i:i + 1], T_MIN,
                     None if mt is None else mt[i:i + 1], stats=one)
        steps.append(one.get("steps", 0))
        tests += one.get("tests", 0)
    assert stats["lane_steps"].tolist() == steps
    assert stats["steps"] == sum(steps) and stats["tests"] == tests
    assert stats["max_steps"] == max(steps)
    lane_steps = stats["lane_steps"]
    slots = steps if order == "lanes" else [
        s for s, a in zip(steps, act.tolist()) if a]
    warp = warp_work(lane_steps if order == "lanes" else lane_steps[act])
    assert warp == _warp_sum(slots)
    assert warp > stats["steps"] > 0
