"""PyTorch port, multi-device layer in one process: the primitive padding,
the shard-id and tie-order merges of the sharded tracers, the per-shard BVH
stack and the shard-local searches against the JAX package
(`raytracer_tpu/parallel/tracer.py`, `accel/bvh.py:build_stacked_bvh`),
and the layout's arithmetic. The multi-rank paths are in
tests/test_torch_dist.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.bvh import build_stacked_bvh as ref_stacked
from raytracer_tpu.core.types import as_jax
from raytracer_tpu.ops import trace as ref_trace
from raytracer_tpu.parallel import tracer as ref_tr
from raytracer_tpu_torch.accel.bvh import build_stacked_bvh, stacked_shard
from raytracer_tpu_torch.core.types import KIND_NONE, KIND_TRIANGLE
from raytracer_tpu_torch.ops import trace as trace_ops
from raytracer_tpu_torch.parallel import tracer as tr
from raytracer_tpu_torch.parallel.overlap import float_partition
from raytracer_tpu_torch.parallel.shard import (build_sharded_accel,
                                                local_accel, shard_layout)
from tests.torch_cases import bumpy_config4, port, tt

torch.set_num_threads(2)

T_MIN = 1e-4


def random_hits(rng, p: int, n: int):
    """[p, n] partial hits with many exact ties: t from 5 values (+inf on
    the misses), kinds 0–3, ids 0–5 → (t, kind, idx) numpy arrays."""
    kind = rng.integers(0, 4, (p, n)).astype(np.int32)
    t = rng.choice(np.float32([0.5, 1.0, 1.0 + 2 ** -23, 2.0, 3.0]),
                   (p, n)).astype(np.float32)
    t = np.where(kind == KIND_NONE, np.float32(np.inf), t)
    idx = np.where(kind == KIND_NONE, 0, rng.integers(0, 6, (p, n)))
    return t, kind, idx.astype(np.int32)


def assert_hit_equal(got, want):
    for k in ("kind", "idx", "t"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_hit_matches_reference(seed):
    rng = np.random.default_rng(seed)
    t, kind, idx = random_hits(rng, 2, 4000)
    got = tr._fold_hit(trace_ops.Hit(tt(kind[0]), tt(idx[0]), tt(t[0])),
                       trace_ops.Hit(tt(kind[1]), tt(idx[1]), tt(t[1])))
    want = ref_tr._fold_hit(
        ref_trace.Hit(kind=jnp.asarray(kind[0]), idx=jnp.asarray(idx[0]),
                      t=jnp.asarray(t[0])),
        ref_trace.Hit(kind=jnp.asarray(kind[1]), idx=jnp.asarray(idx[1]),
                      t=jnp.asarray(t[1])))
    assert_hit_equal(got, want)
    # exact t ties are decided by kind, then id: the single-device order
    tie = (t[0] == t[1]) & (kind[0] != KIND_NONE)
    assert tie.sum() > 100


@pytest.mark.parametrize("p", [2, 4, 8])
def test_combine_gathered_matches_reference(p):
    rng = np.random.default_rng(p)
    t, kind, idx = random_hits(rng, p, 3000)
    got = tr._combine_gathered(tt(t), tt(kind), tt(idx))
    want = ref_tr._combine_gathered(jnp.asarray(t), jnp.asarray(kind),
                                    jnp.asarray(idx))
    assert_hit_equal(got, want)


@pytest.mark.parametrize("shard", [0, 1, 3])
def test_globalize_matches_reference(shard):
    rng = np.random.default_rng(shard)
    t, kind, idx = random_hits(rng, 1, 2000)
    sizes = (2, 3, 57)
    got = tr._globalize(trace_ops.Hit(tt(kind[0]), tt(idx[0]), tt(t[0])),
                        sizes, shard)
    want = ref_tr._globalize(
        ref_trace.Hit(kind=jnp.asarray(kind[0]), idx=jnp.asarray(idx[0]),
                      t=jnp.asarray(t[0])), sizes, shard)
    assert_hit_equal(got, want)


@pytest.fixture(scope="module")
def bumpy():
    scene, cam, opts = bumpy_config4(2, 32, 20)
    return scene, port(scene, cam, opts)[0]


@pytest.mark.parametrize("p", [1, 3, 4])
def test_pad_trace_geom_matches_reference(bumpy, p):
    scene, pscene = bumpy
    want = ref_tr.pad_trace_geom(ref_tr.build_trace_geom(as_jax(scene)), p)
    got = tr.pad_trace_geom(tr.build_trace_geom(pscene.to("cpu")), p)
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(),
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)
    assert got.tri_v0.shape[0] % p == 0 and got.sph_r.shape[0] % p == 0


@pytest.mark.parametrize("n_shards", [2, 4])
def test_build_stacked_bvh_matches_reference(bumpy, n_shards):
    _, pscene = bumpy
    g = tr.pad_trace_geom(tr.build_trace_geom(pscene.to("cpu")), n_shards)
    arrs = [g.tri_v0.numpy(), g.tri_e1.numpy(), g.tri_e2.numpy()]
    got = build_stacked_bvh(*arrs, n_shards)
    want = ref_stacked(*arrs, n_shards)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
    # build_sharded_accel builds the same stack from the scene
    via_scene = build_sharded_accel(pscene, n_shards)
    for k in want:
        np.testing.assert_array_equal(np.asarray(via_scene[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.fixture(scope="module")
def shard_rays(bumpy):
    """Primary and scattered rays toward the bumpy sphere."""
    rng = np.random.default_rng(7)
    n = 1500
    o = rng.normal(size=(n, 3)) * 2 + np.array([0.0, 0.0, -5.5])
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    max_t = rng.uniform(0.5, 6.0, n)
    return (tt(o.astype(np.float32)), tt(d.astype(np.float32)),
            tt(max_t.astype(np.float32)))


@pytest.mark.parametrize("shard", [0, 2])
def test_local_dense_search_matches_reference(bumpy, shard_rays, shard):
    """The dense shard-local searches against the reference's run op by op,
    on shard `shard` of 3: the same kinds, ids and t; the same
    occlusion."""
    scene, pscene = bumpy
    o, d, mx = shard_rays
    g = tr.pad_trace_geom(tr.build_trace_geom(pscene.to("cpu")), 3)
    sizes = tr.shard_sizes(g, 3)
    gs = g.shard(sizes, shard)
    rg = ref_tr.pad_trace_geom(ref_tr.build_trace_geom(as_jax(scene)), 3)
    rs = ref_tr.TraceGeom(*(np.asarray(getattr(rg, f.name))[
        shard * n:(shard + 1) * n] for f, n in zip(
            dataclasses.fields(rg), (sizes[0], sizes[0], sizes[1], sizes[1],
                                     sizes[2], sizes[2], sizes[2]))))
    ro, rd, rmx = (jnp.asarray(x.numpy()) for x in (o, d, mx))
    got = tr._local_nearest(gs, o, d, T_MIN, 256)
    with jax.disable_jit():  # jitted, XLA:CPU contracts multiply-adds
        want = ref_tr._local_nearest(rs, ro, rd, T_MIN, 256)
        want_occ = ref_tr._local_occluded(rs, ro, rd, rmx, T_MIN, 256)
    assert_hit_equal(got, want)
    assert (got.kind.numpy() == KIND_TRIANGLE).sum() > 50
    occ = tr._local_occluded(gs, o, d, mx, T_MIN, 256)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))


@pytest.mark.parametrize("shard", [0, 3])
def test_local_bvh_search_equals_dense(bumpy, shard_rays, shard):
    """A shard's own BVH walk against the dense search of the same shard:
    the same t and occlusion, ids equal except on exact t ties."""
    _, pscene = bumpy
    o, d, mx = shard_rays
    g = tr.pad_trace_geom(tr.build_trace_geom(pscene.to("cpu")), 4)
    sizes = tr.shard_sizes(g, 4)
    gs = g.shard(sizes, shard)
    acc = local_accel(build_sharded_accel(pscene, 4), gs, shard, "cpu")
    dense = tr._local_nearest(gs, o, d, T_MIN, 256)
    walked = tr._local_nearest(gs, o, d, T_MIN, 256, accel=acc)
    np.testing.assert_array_equal(walked.t.numpy(), dense.t.numpy())
    np.testing.assert_array_equal(walked.kind.numpy(), dense.kind.numpy())
    hit = dense.kind.numpy() == KIND_TRIANGLE
    assert hit.sum() > 50
    assert (walked.idx.numpy() != dense.idx.numpy())[hit].mean() <= 0.005
    np.testing.assert_array_equal(
        tr._local_occluded(gs, o, d, mx, T_MIN, 256, accel=acc).numpy(),
        tr._local_occluded(gs, o, d, mx, T_MIN, 256).numpy())


def test_stacked_shard_is_a_walkable_tree(bumpy):
    """Every shard's tree lists each of its triangles once, its links stay
    inside [0, n_nodes], and all shards' tables have one shape (the ring
    sends them from rank to rank)."""
    _, pscene = bumpy
    st = build_sharded_accel(pscene, 4)
    ts = st["tris_per_shard"]
    g = tr.pad_trace_geom(tr.build_trace_geom(pscene.to("cpu")), 4)
    shapes = set()
    for s in range(4):
        bvh = stacked_shard(st, s, "cpu")
        ids = bvh.leaf_tris.numpy().ravel()
        assert sorted(ids[ids != ts].tolist()) == list(range(ts))
        assert bvh.links2.min() >= 0 and bvh.links2.max() <= bvh.n_nodes
        acc = local_accel(st, g.shard(tr.shard_sizes(g, 4), s), s, "cpu")
        shapes.add(tuple(tuple(x.shape) for x in acc.tensors()))
    assert len(shapes) == 1


@pytest.mark.parametrize("n_pix,tiles,tile_rays,want", [
    (3072, 4, 256, (768, 256)), (3072, 1, 256, (3072, 256)),
    (2560, 4, 256, (768, 256)), (1998, 4, 16384, (504, 504)),
    (2073600, 1, 2073600, (2073600, 2073600))])
def test_shard_layout(n_pix, tiles, tile_rays, want):
    """Each tiles rank's lanes (8-aligned, a multiple of its tile) and tile
    width, as the reference's render_sharded lays them out."""
    per_dev, inner = shard_layout(n_pix, tiles, tile_rays)
    assert (per_dev, inner) == want
    assert per_dev % 8 == 0 and per_dev % inner == 0
    assert per_dev * tiles >= n_pix


def test_float_partition_round_trips(bumpy):
    _, pscene = bumpy
    scene = pscene.to("cpu")
    floats, others, rebuild = float_partition(scene)
    assert all(x.is_floating_point() for x in floats)
    assert not any(isinstance(x, torch.Tensor) and x.is_floating_point()
                   for x in others)
    back = rebuild(floats, others)
    assert back.has_glass == scene.has_glass
    assert back.spheres.center is scene.spheres.center
    assert back.meshes.tris is scene.meshes.tris
    doubled = rebuild([2 * x for x in floats], others)
    assert torch.equal(doubled.lights.pos, 2 * scene.lights.pos)


def test_make_rt_mesh_needs_a_process_group():
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel.mesh import make_rt_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        make_rt_mesh()


@pytest.mark.parametrize("device", ["meta", "cuda"])
def test_init_distributed_refuses_other_devices(device, tmp_path):
    """Only an indexed CUDA device (NCCL) or the CPU (gloo) forms a group;
    nothing is initialized on a refusal."""
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel.mesh import init_distributed

    with pytest.raises(ValueError):
        init_distributed("file://" + str(tmp_path / "store"), 1, 0,
                         device=device)
    assert not dist.is_initialized()
