"""PyTorch port: geometry, search, surface and shading ops against the JAX
reference on the same numpy-seeded inputs.

Standard: float results at rtol 2e-6 (atol 1e-6 for components that cross
zero, where a relative bound means nothing); kinds and ids exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.models import presets as ref_presets
from raytracer_tpu.ops import geometry as rgeom
from raytracer_tpu.ops import shade as rshade
from raytracer_tpu.ops import trace as rtrace
from raytracer_tpu_torch.core.types import scene_from_arrays
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops import shade, trace
from tests.torch_cases import subdiv3_config4, tt

torch.set_num_threads(2)

RTOL, ATOL = 2e-6, 1e-6


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
        return
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32) + [0.0, 0.5, 1.0]
    d = rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _camera_rays(scene, cam, w, h, n_rand, seed=0):
    """Primary rays of the camera at w×h plus random rays (numpy, f32)."""
    d = np.asarray(rgeom.raygen(cam.pos, cam.c2w, cam.fov_deg, w, h))
    o = np.broadcast_to(np.asarray(cam.pos), d.shape)
    ro, rd = _rays(n_rand, seed)
    return (np.concatenate([o, ro]).astype(np.float32),
            np.concatenate([d, rd]).astype(np.float32))


GEOM_CASES = ["sphere", "plane", "triangle", "reflect", "refract", "fresnel",
              "spawn_origin"]


@pytest.mark.parametrize("case", GEOM_CASES)
def test_geometry_matches_reference(case):
    rng = np.random.default_rng(7)
    o, d = _rays(512, seed=1)
    n = rng.normal(size=(512, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    if case == "sphere":
        c = rng.normal(0, 2, (6, 3)).astype(np.float32)
        r = rng.uniform(0.2, 1.5, (6,)).astype(np.float32)
        args = (o, d, c, r, 1e-4)
        fr, fp = rgeom.sphere_hits, geom.sphere_hits
    elif case == "plane":
        p = rng.normal(0, 2, (4, 3)).astype(np.float32)
        args = (o, d, p, n[:4], 1e-4)
        fr, fp = rgeom.plane_hits, geom.plane_hits
    elif case == "triangle":
        v0 = rng.normal(0, 1.5, (40, 3)).astype(np.float32)
        e1 = rng.normal(0, 1.0, (40, 3)).astype(np.float32)
        e2 = rng.normal(0, 1.0, (40, 3)).astype(np.float32)
        args = (o, d, v0, e1, e2, 1e-4)
        fr, fp = rgeom.triangle_hits, geom.triangle_hits
    elif case == "reflect":
        args, fr, fp = (d, n), rgeom.reflect, geom.reflect
    elif case == "refract":
        ior = rng.uniform(1.1, 2.0, (512,)).astype(np.float32)
        args, fr, fp = (d, n, ior), rgeom.refract, geom.refract
    elif case == "fresnel":
        ior = rng.uniform(1.1, 2.0, (512,)).astype(np.float32)
        args, fr, fp = (d, n, ior), rgeom.fresnel, geom.fresnel
    else:
        args = (o, n, d, 1e-4)
        fr, fp = rgeom.spawn_origin, geom.spawn_origin
    want = fr(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                for a in args])
    got = fp(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a
               for a in args])
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    if case == "triangle":
        # barycentrics mean something on hits only (on a near-zero det they
        # are a huge, ill-conditioned quotient that is discarded)
        hit = np.isfinite(np.asarray(want[0]))
        assert hit.sum() > 100
        want = (want[0],) + tuple(np.asarray(w)[hit] for w in want[1:])
        got = (got[0],) + tuple(g.numpy()[hit] for g in got[1:])
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("row0,rows", [(0, None), (7, 9)])
def test_raygen_matches_reference(row0, rows):
    _, cam, _ = ref_presets.config4_mesh(use_obj=False)
    want = rgeom.raygen(cam.pos, cam.c2w, cam.fov_deg, 40, 30, row0=row0,
                        rows=rows)
    got = geom.raygen(tt(cam.c2w), tt(cam.fov_deg), 40, 30, row0=row0,
                      rows=rows)
    _close(got, want)


@pytest.mark.parametrize("name", ["config2", "config3"])
def test_nearest_and_occluded_match_reference(name):
    scene, cam, opts = ref_presets.PRESETS[name]()
    pscene = scene_from_arrays(scene).to("cpu")
    o, d = _camera_rays(scene, cam, 48, 48, 1024)
    hit = rtrace.nearest_hit(scene, jnp.asarray(o), jnp.asarray(d),
                             opts.t_min, opts.tri_chunk)
    phit = trace.nearest_hit(pscene, torch.from_numpy(o), torch.from_numpy(d),
                             opts.t_min, opts.tri_chunk)
    assert (np.asarray(hit.kind) != 0).sum() > 1000  # scene sanity
    _close(phit.kind, hit.kind)
    _close(phit.idx, hit.idx)
    _close(phit.t, hit.t)
    max_t = np.random.default_rng(3).uniform(0.5, 12.0, o.shape[:1]).astype(
        np.float32)
    occ = rtrace.occluded(scene, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(max_t), opts.t_min, opts.tri_chunk)
    pocc = trace.occluded(pscene, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(max_t), opts.t_min, opts.tri_chunk)
    _close(pocc, occ)


def _surface_case(name):
    if name == "config4-subdiv3":
        scene, cam, opts = subdiv3_config4()
    else:
        scene, cam, opts = ref_presets.PRESETS[name]()
    o, d = _camera_rays(scene, cam, 40, 32, 256, seed=5)
    hit = rtrace.nearest_hit(scene, jnp.asarray(o), jnp.asarray(d),
                             opts.t_min, opts.tri_chunk)
    return scene, opts, o, d, hit


@pytest.mark.parametrize("name", ["config2", "config4-subdiv3", "config7"])
def test_surface_at_matches_reference(name):
    """config2: plane checker; config4: smooth normals; config7: UV checker."""
    scene, opts, o, d, hit = _surface_case(name)
    pscene = scene_from_arrays(scene).to("cpu")
    want = rtrace.surface_at(scene, jnp.asarray(o), jnp.asarray(d), hit,
                             opts.t_min)
    phit = trace.Hit(kind=tt(hit.kind), idx=tt(hit.idx), t=tt(hit.t))
    got = trace.surface_at(pscene, torch.from_numpy(o),
                           torch.from_numpy(d), phit, opts.t_min)
    for f in ("valid", "t", "p", "n", "albedo", "mtype", "kd", "ks", "spec_n",
              "ior"):
        _close(getattr(got, f), getattr(want, f))


def test_shade_diffuse_matches_reference():
    scene, opts, o, d, hit = _surface_case("config2")
    pscene = scene_from_arrays(scene).to("cpu")
    surf = rtrace.surface_at(scene, jnp.asarray(o), jnp.asarray(d), hit,
                             opts.t_min)
    want, _ = rshade.shade_diffuse(scene, surf, jnp.asarray(d), opts.bias,
                                   opts.t_min, opts.tri_chunk)
    psurf = trace.Surface(**{k: tt(getattr(surf, k)) for k in (
        "valid", "t", "p", "n", "albedo", "mtype", "kd", "ks", "spec_n",
        "ior")})
    got, _ = shade.shade_diffuse(pscene, psurf, torch.from_numpy(d),
                                 opts.bias, opts.t_min, opts.tri_chunk)
    _close(got, want)
