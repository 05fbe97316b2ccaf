"""Shared inputs for the PyTorch port's tests (tests/test_torch_*.py).

The same numpy-made scenes and rays go through the JAX reference and the
port: reference objects are built here and carried across with
`raytracer_tpu_torch.core.types.scene_from_arrays`.
"""

import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.core.types import RenderOptions, scene_from_arrays


def bumpy_config4(subdiv: int, width: int, height: int):
    """Reference config4 with a bumpy sphere of `subdiv` in place of the
    blob (as tests/test_pallas.py and tests/test_pallas_walk.py build it),
    at width×height, depth 2, one tile."""
    from raytracer_tpu.core.types import Meshes
    from raytracer_tpu.io import meshgen
    from raytracer_tpu.models import presets

    scene, cam, opts = presets.config4_mesh(use_obj=False)
    verts, tris = meshgen.bumpy_sphere(subdiv=subdiv, radius=1.3)
    verts = verts + np.array([0.0, -0.1, -5.5], np.float32)
    scene = scene.replace(meshes=Meshes.build(
        verts, tris, np.zeros((tris.shape[0],), np.int32),
        normals=meshgen.vertex_normals(verts, tris)))
    opts = dataclasses.replace(opts, width=width, height=height, max_depth=2,
                               tile_rays=width * height, tile_block=None)
    return scene, cam, opts


def subdiv3_config4():
    """`bumpy_config4` at subdiv 3, 64×40 (tests/test_pallas_walk.py's)."""
    return bumpy_config4(3, 64, 40)


def port(scene, cam, opts):
    """Reference (scene, camera, options) → the port's, bit-equal arrays."""
    return (scene_from_arrays(scene), scene_from_arrays(cam),
            RenderOptions(**dataclasses.asdict(opts)))


def tt(x):
    """Reference array (numpy or jax) → CPU tensor, same bits."""
    return torch.from_numpy(np.array(x))


def assert_walks_agree(t0, i0, t1, i1):
    """The cross-backend walk standard (tests/test_pallas_walk.py): identical
    hit/miss sets, hit distances at rtol 2e-6, winner ids equal on all but
    0.5% of rays (knife edges)."""
    t0, t1, i0, i1 = (np.asarray(x) for x in (t0, t1, i0, i1))
    fin = np.isfinite(t0)
    assert (fin == np.isfinite(t1)).all(), "hit/miss sets differ"
    np.testing.assert_allclose(t1[fin], t0[fin], rtol=2e-6)
    assert (i0 != i1).mean() <= 0.005, "winner ids differ beyond knife edges"


def mat_edge_case(seed=0, n_tris=240, n_rays=3000):
    """A mesh of small-integer triangles, a third of them in z planes with
    n = (0, 0, 16), and rays that reach every branch of the epilogue:
    origins on those planes (t·det == 0 exactly), directions parallel to
    them (det = ±0) or at |det| just at, above and below eps, random rays
    toward the mesh, and non-finite features (inf, -inf, nan in f0…f9).
    For the linear-expansion search (`ops/mat_trace.py`) → (weights, their
    bt, feats [n_rays, 16]), CPU tensors."""
    from raytracer_tpu_torch.ops import mat_trace as MT

    rng = np.random.default_rng(seed)
    v0 = rng.integers(-6, 7, (n_tris, 3)).astype(np.float32)
    e1 = rng.integers(-4, 5, (n_tris, 3)).astype(np.float32)
    e2 = rng.integers(-4, 5, (n_tris, 3)).astype(np.float32)
    flat = n_tris // 3
    e1[:flat], e2[:flat] = (4, 0, 0), (0, 4, 0)
    bt = 100  # 240 triangles: 60 padding ones
    w, center = MT.build_tri_weights(v0, e1, e2, bt=bt)
    pick = rng.integers(0, flat, n_rays)
    o = v0[pick] + np.concatenate(
        [rng.uniform(0, 4, (n_rays, 2)), np.zeros((n_rays, 1))], 1)
    o[:, 2] += np.where(rng.random(n_rays) < 0.4, 0.0,
                        rng.integers(-3, 4, n_rays))
    d = rng.normal(size=(n_rays, 3))
    dz = np.float32(1e-8) / 16  # |det| = 16·|dz| = eps exactly
    up, down = np.nextafter(dz, np.float32(1)), np.nextafter(dz, np.float32(0))
    special = np.array([0.0, -0.0, dz, -dz, up, -up, down, -down, 1e-9,
                        -1e-9, 1e-7, -1e-7], np.float32)
    par = rng.random(n_rays) < 0.5
    d[par, 2] = special[rng.integers(0, special.size, int(par.sum()))]
    toward = rng.random(n_rays) < 0.2  # generic rays at the mesh
    d[toward] = v0[rng.integers(0, n_tris, int(toward.sum()))] - o[toward]
    feats = MT.ray_features(tt(o.astype(np.float32)),
                            tt(d.astype(np.float32)), center)
    bad = rng.random(n_rays) < 0.05
    cols = rng.integers(0, 10, int(bad.sum()))
    vals = np.array([np.inf, -np.inf, np.nan], np.float32)
    feats[torch.from_numpy(np.nonzero(bad)[0]), torch.from_numpy(cols)] = \
        torch.from_numpy(vals[rng.integers(0, 3, cols.size)])
    return w, bt, feats


def tri_edge_case(seed=0, n_tris=240, n_rays=3000):
    """Small-integer triangles, a third of them in z planes with e1 = (4,
    0, 0), e2 = (0, 4, 0) (det = -16·dz exactly), and rays that reach
    every stage of the brute-force search (`ops/pallas_trace.py`): origins
    on those planes (t·det == 0 exactly), directions parallel to them (det
    = ±0) or with |det| just at, above and below eps, random rays toward
    the mesh, and non-finite origins and directions (inf, -inf, nan in one
    component) → (orig [n_rays, 3], dirs [n_rays, 3], the [9, 300] planar
    table of `pack_tris(..., bt=100)`: 60 padding triangles), CPU
    tensors."""
    from raytracer_tpu_torch.ops import pallas_trace as PT

    rng = np.random.default_rng(seed)
    v0 = rng.integers(-6, 7, (n_tris, 3)).astype(np.float32)
    e1 = rng.integers(-4, 5, (n_tris, 3)).astype(np.float32)
    e2 = rng.integers(-4, 5, (n_tris, 3)).astype(np.float32)
    flat = n_tris // 3
    e1[:flat], e2[:flat] = (4, 0, 0), (0, 4, 0)
    pick = rng.integers(0, flat, n_rays)
    o = v0[pick] + np.concatenate(
        [rng.uniform(0, 4, (n_rays, 2)), np.zeros((n_rays, 1))], 1)
    o[:, 2] += np.where(rng.random(n_rays) < 0.4, 0.0,
                        rng.integers(-3, 4, n_rays))
    d = rng.normal(size=(n_rays, 3))
    dz = np.float32(1e-8) / 16  # |det| = 16·|dz| = eps exactly
    up, down = np.nextafter(dz, np.float32(1)), np.nextafter(dz, np.float32(0))
    special = np.array([0.0, -0.0, dz, -dz, up, -up, down, -down, 1e-9,
                        -1e-9, 1e-7, -1e-7], np.float32)
    par = rng.random(n_rays) < 0.5
    d[par, 2] = special[rng.integers(0, special.size, int(par.sum()))]
    toward = rng.random(n_rays) < 0.2  # generic rays at the mesh
    d[toward] = v0[rng.integers(0, n_tris, int(toward.sum()))] - o[toward]
    o, d = o.astype(np.float32), d.astype(np.float32)
    vals = np.array([np.inf, -np.inf, np.nan], np.float32)
    for x in (o, d):
        bad = np.nonzero(rng.random(n_rays) < 0.03)[0]
        x[bad, rng.integers(0, 3, bad.size)] = vals[rng.integers(0, 3,
                                                                bad.size)]
    return tt(o), tt(d), PT.pack_tris(v0, e1, e2, bt=100)
