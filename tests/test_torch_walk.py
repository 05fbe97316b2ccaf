"""PyTorch port: grid build and the grid DDA walk against the JAX reference.

The plain torch walk (`grid_walk`, the walk of the CUDA kernel's plain
twin) is held against the reference's XLA `grid_walk` and its Pallas twin
`pallas_grid_walk` (interpret mode, as tests/test_pallas_walk.py runs it),
to the cross-backend standard of `tests.torch_cases.assert_walks_agree`.
The CUDA kernel is held against the plain composition in
tests/test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.grid import GridTracer as RefGridTracer
from raytracer_tpu.accel.grid import grid_walk as ref_grid_walk
from raytracer_tpu.models import presets as ref_presets
from raytracer_tpu.ops import geometry as rgeom
from raytracer_tpu.ops import pallas_walk as PW
from raytracer_tpu_torch.accel.grid import GridTracer
from raytracer_tpu_torch.core.types import scene_from_arrays
from raytracer_tpu_torch.ops import walk as W
from tests.torch_cases import assert_walks_agree, port, subdiv3_config4, tt

torch.set_num_threads(2)

GRID_FIELDS = ("bmin", "inv_cell", "cell_size", "cell_tris", "overflow",
               "ov_v0", "ov_e1", "ov_e2", "cell_soa")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(PW, "_INTERPRET", True)


def _build_both(name, capacity):
    if name == "subdiv3":
        scene = subdiv3_config4()[0]
    else:
        scene = ref_presets.config4_mesh()[0]
    kw = {} if capacity is None else {"capacity": capacity}
    ref = RefGridTracer.build(scene, **kw)
    got = GridTracer.build(scene_from_arrays(scene), "cpu", **kw)
    return ref, got


@pytest.mark.parametrize("name,capacity", [("subdiv3", None),
                                           ("blob", None), ("subdiv3", 4)])
def test_build_grid_equals_reference(name, capacity):
    ref, got = _build_both(name, capacity)
    rg, g = ref._grid, got._grid
    if capacity == 4:
        assert rg.overflow.shape[0] > 0  # the spill path is exercised
    assert (g.res, g.capacity, g.n_tris) == (rg.res, rg.capacity, rg.n_tris)
    for f in GRID_FIELDS:
        a, b = np.asarray(getattr(rg, f)), getattr(g, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.fixture(scope="module")
def walk_inputs():
    scene, cam, opts = subdiv3_config4()
    ref = RefGridTracer.build(scene)
    got = GridTracer.build(port(scene, cam, opts)[0], "cpu")
    dirs = rgeom.raygen(cam.pos, cam.c2w, cam.fov_deg, opts.width, opts.height)
    orig = jnp.broadcast_to(jnp.asarray(cam.pos), dirs.shape)
    return ref, got, orig, dirs, opts


def _walk_both(ref, got, orig, dirs, t_min, max_t=None, active=None):
    v0, e1, e2 = ref._soa
    want = ref_grid_walk(ref._grid, v0, e1, e2, orig, dirs, t_min,
                         occlusion_max_t=max_t, active=active)
    o, d = tt(orig), tt(dirs)
    have = W.grid_walk(got._grid, got._table, o, d, t_min,
                       occlusion_max_t=None if max_t is None else tt(max_t),
                       active=None if active is None else tt(active))
    return want, have


def test_nearest_matches_reference_walk(walk_inputs):
    ref, got, orig, dirs, opts = walk_inputs
    (t0, i0), (t1, i1) = _walk_both(ref, got, orig, dirs, opts.t_min)
    assert_walks_agree(t0, i0, t1, i1)
    assert np.isfinite(np.asarray(t0)).sum() > 100  # scene sanity


def test_occlusion_matches_reference_walk(walk_inputs):
    ref, got, orig, dirs, opts = walk_inputs
    mx = jnp.full(orig.shape[:1], 6.0, jnp.float32)
    (o0, _), (o1, _) = _walk_both(ref, got, orig, dirs, opts.t_min, max_t=mx)
    np.testing.assert_array_equal(o1.numpy() < 6.0, np.asarray(o0) < 6.0)


def test_active_mask_contract(walk_inputs):
    """Masked-out lanes return exact misses; live lanes match the reference."""
    ref, got, orig, dirs, opts = walk_inputs
    act = jnp.asarray(np.random.default_rng(3).random(orig.shape[0]) > 0.5)
    (t0, i0), (t1, i1) = _walk_both(ref, got, orig, dirs, opts.t_min,
                                    active=act)
    assert_walks_agree(t0, i0, t1, i1)
    off = ~np.asarray(act)
    assert np.isinf(t1.numpy()[off]).all()
    assert (i1.numpy()[off] == got._grid.n_tris).all()


def test_overflow_seed_matches_reference():
    """A tiny capacity forces overflow spill: spilled triangles come from the
    walk_init brute seed and must still be found."""
    scene, cam, opts = subdiv3_config4()
    ref = RefGridTracer.build(scene, capacity=4)
    got = GridTracer.build(port(scene, cam, opts)[0], "cpu", capacity=4)
    assert got._grid.overflow.shape[0] > 0
    dirs = rgeom.raygen(cam.pos, cam.c2w, cam.fov_deg, 32, 24)
    orig = jnp.broadcast_to(jnp.asarray(cam.pos), dirs.shape)
    (t0, i0), (t1, i1) = _walk_both(ref, got, orig, dirs, opts.t_min)
    assert_walks_agree(t0, i0, t1, i1)


@pytest.mark.parametrize("mode", ["nearest", "occlusion"])
def test_matches_pallas_walk(walk_inputs, mode):
    """Against the TPU kernel itself (interpret mode), with an active mask,
    on every third ray (interpret mode is slow)."""
    ref, got, orig, dirs, opts = walk_inputs
    orig, dirs = orig[::3], dirs[::3]
    act = jnp.asarray(np.random.default_rng(4).random(orig.shape[0]) > 0.25)
    mx = (jnp.full(orig.shape[:1], 6.0, jnp.float32) if mode == "occlusion"
          else None)
    t0, i0 = PW.pallas_grid_walk(ref._grid, PW.pack_cell_table(ref._grid),
                                 orig, dirs, opts.t_min, occlusion_max_t=mx,
                                 active=act)
    t1, i1 = W.grid_walk(got._grid, got._table, tt(orig), tt(dirs),
                         opts.t_min,
                         occlusion_max_t=None if mx is None else tt(mx),
                         active=tt(act))
    if mode == "occlusion":
        np.testing.assert_array_equal(t1.numpy() < 6.0, np.asarray(t0) < 6.0)
    else:
        assert_walks_agree(t0, i0, t1, i1)


def test_walk_on_unsupported_device_raises(walk_inputs):
    _, got, orig, dirs, opts = walk_inputs
    with pytest.raises(ValueError):
        W.grid_walk(got._grid, got._table, tt(orig).to("meta"),
                    tt(dirs).to("meta"), opts.t_min)
