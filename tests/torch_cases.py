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
