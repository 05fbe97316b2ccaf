"""PyTorch port: plan recording and replay (`render(record_plan=True)`,
`ops/replay.py`).

The recorded plan planes are held to the JAX renderer's (the same
integers); a replay of a plan is held to the render that recorded it, and
the replay's gradients to the wavefront's autograd (tests/test_replay.py's
standards): K1's plain version as the planner for mesh-free scenes, the
wavefront itself for mesh scenes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu.accel.grid import GridTracer as RefGridTracer
from raytracer_tpu.models import presets as jpresets
from raytracer_tpu.renderer import render as jrender
from raytracer_tpu_torch.accel.grid import GridTracer
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.ops.fused import FusedWhitted
from raytracer_tpu_torch.ops.replay import (PlanTracer, replay_band_vg,
                                            replay_render,
                                            value_and_grad_replay)
from raytracer_tpu_torch.renderer import render, value_and_grad_banded
from tests.torch_cases import port, subdiv3_config4

torch.set_num_threads(2)

RES = 64


def _rel(a, b):
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-9)


# --------------------------------------------------------------------------
# the plan against the JAX renderer's

def _mesh_case():
    scene, cam, opts = subdiv3_config4()
    return scene, cam, opts, RefGridTracer.build(scene), "grid"


def _uv_case():
    scene, cam, opts = jpresets.config7_uv_quad()
    return scene, cam, dataclasses.replace(opts, width=RES,
                                           height=RES), None, None


@pytest.mark.parametrize("case", ["config4-subdiv3", "config7"])
def test_plan_planes_match_reference(case):
    scene, cam, opts, jtracer, kind = {"config4-subdiv3": _mesh_case,
                                       "config7": _uv_case}[case]()
    _, _, jw, jo = jrender(scene, cam, opts, tracer=jtracer,
                           record_plan=True)
    ps, pc, po = port(scene, cam, opts)
    tracer = GridTracer.build(ps, "cpu") if kind else None
    img, traced, tw, to = render(ps, pc, po, device="cpu", tracer=tracer,
                                 count_rays=True, record_plan=True)
    assert len(tw) == len(to) == opts.max_depth + 1
    for b, (a, w) in enumerate(zip(jw, tw)):
        assert w.dtype == torch.int32 and w.shape == (opts.width
                                                      * opts.height,)
        assert np.array_equal(w.numpy(), np.asarray(a)), f"wins {b}"
    for b, (a, o) in enumerate(zip(jo, to)):
        assert np.array_equal(o.numpy(), np.asarray(a)), f"occs {b}"
    assert int((tw[0] >= 0).sum()) > 0 and float(traced) > 0


def test_record_plan_refuses_uncompacted_glass():
    scene, cam, opts = presets.PRESETS["config3"]()
    opts = dataclasses.replace(opts, width=16, height=16, max_depth=2)
    with pytest.raises(ValueError, match="glass"):
        render(scene, cam, opts, device="cpu", record_plan=True)


# --------------------------------------------------------------------------
# the wavefront as its own planner (mesh scene)

@pytest.fixture(scope="module")
def mesh():
    ps, pc, po = port(*subdiv3_config4())
    tracer = GridTracer.build(ps, "cpu")
    img, _, wins, occs = render(ps, pc, po, device="cpu", tracer=tracer,
                                record_plan=True)
    return ps, pc, po, tracer, img, (wins, occs)


@pytest.mark.parametrize("how", ["single", "banded", "tiled", "blocks"])
def test_replay_image_matches_wavefront(mesh, how):
    ps, pc, po, tracer, img, plan = mesh
    if how == "single":
        got = replay_render(ps, pc, po, plan, device="cpu")[0]
    elif how == "tiled":  # 2560 lanes in tiles of 512 and 1000 (padded)
        got = replay_render(ps, pc, po, plan, tile_rays=512, device="cpu")[0]
        odd = replay_render(ps, pc, po, plan, tile_rays=1000,
                            device="cpu")[0]
        assert torch.equal(odd, got)
    elif how == "banded":  # per-band plans, recorded and replayed apart
        parts = []
        for r0, rb in ((0, 13), (13, 27)):
            _, _, w, o = render(ps, pc, po, device="cpu", tracer=tracer,
                                row0=r0, rows=rb, record_plan=True)
            parts.append(replay_render(ps, pc, po, (w, o), row0=r0, rows=rb,
                                       device="cpu")[0])
        got = torch.cat(parts)
    else:  # recorded in 16×32 screen blocks, returned in pixel order
        blocks = dataclasses.replace(po, tile_rays=512, tile_block=(16, 32))
        _, _, w, o = render(ps, pc, blocks, device="cpu", tracer=tracer,
                            record_plan=True)
        assert all(torch.equal(a, b) for a, b in zip(w + o,
                                                     plan[0] + plan[1]))
        got = replay_render(ps, pc, po, (w, o), device="cpu")[0]
    assert got.shape == img.shape
    assert float((got - img).abs().max()) <= 2e-5


def _with_params(s, p):
    return s.replace(
        spheres=dataclasses.replace(s.spheres, center=p["center"]),
        materials=dataclasses.replace(s.materials, albedo=p["albedo"]))


def test_waveplan_replay_vg_matches_standard_mesh():
    """tests/test_replay.py::test_waveplan_replay_vg_matches_standard_mesh:
    the wavefront-planner replay's loss and gradients equal autograd through
    the wavefront (screen-block tiles, the walks in the forward)."""
    scene, cam, opts = subdiv3_config4()
    ps, pc, po = port(scene, cam, dataclasses.replace(
        opts, width=64, height=48, tile_rays=1024, tile_block=(16, 64)))
    tracer = GridTracer.build(ps, "cpu")
    target = render(ps, pc, po, device="cpu", tracer=tracer)[0] * 0.9
    p0 = {"center": ps.spheres.center, "albedo": ps.materials.albedo}
    v_std, g_std = value_and_grad_banded(
        _with_params, p0, ps, pc, dataclasses.replace(po, remat_tiles=False),
        target, device="cpu", tracer=tracer)
    _, _, wins, occs = render(ps, pc, po, device="cpu", tracer=tracer,
                              record_plan=True)
    v_w, g_w = replay_band_vg(p0, ps, pc, target, (wins, occs), 0,
                              apply_params=_with_params, opts=po,
                              rb=po.height, device="cpu")
    np.testing.assert_allclose(float(v_w), float(v_std), rtol=1e-5)
    for k in p0:
        assert float(g_std[k].abs().max()) > 0, k
        assert _rel(g_w[k], g_std[k]) <= 2e-4, k


def test_plan_tracer_guards(mesh):
    ps, _, po, _, _, (wins, occs) = mesh
    tr = PlanTracer(wins, occs, ps.spheres.count, ps.planes.count)
    o = torch.zeros((wins[0].shape[0], 3))
    for _ in range(len(wins)):
        tr.nearest(o, o, 1e-4, 64)
    with pytest.raises(RuntimeError, match="exhausted"):
        tr.nearest(o, o, 1e-4, 64)
    tr = PlanTracer(wins, occs, ps.spheres.count, ps.planes.count)
    with pytest.raises(ValueError, match="width"):
        tr.nearest(o[:8], o[:8], 1e-4, 64)


# --------------------------------------------------------------------------
# K1's plain version as the planner (mesh-free scenes)

@pytest.mark.parametrize("name,depth", [("config2", 2), ("config3", 2)])
def test_fused_plan_replays_to_fused_image(name, depth):
    scene, cam, opts = presets.PRESETS[name]()
    opts = dataclasses.replace(opts, width=48, height=40, max_depth=depth)
    img, wins, occs = FusedWhitted(scene, cam, opts,
                                   device="cpu").render_plan()
    assert len(wins) == ((1 << (depth + 1)) - 1 if scene.has_glass
                         else depth + 1)
    got = replay_render(scene, cam, opts, (wins, occs), device="cpu")[0]
    diff = (got - img).abs().amax(dim=-1)
    # the fused standard (PERF.md): ≤0.1% of pixels off by >1/255
    assert float((diff > 1.0 / 255).float().mean()) <= 0.001
    assert float(diff.median()) <= 1e-6


@pytest.fixture(scope="module")
def c2():
    scene, cam, opts = presets.PRESETS["config2"]()
    opts = dataclasses.replace(opts, width=RES, height=RES)
    target = render(scene, cam, opts, device="cpu")[0] * 0.9
    return scene, cam, opts, target


_CLASSES = {  # class -> (scene field, bind keyword)
    "center": ("spheres", "center"), "radius": ("spheres", "radius"),
    "albedo": ("materials", "albedo"), "ks": ("materials", "ks"),
    "spec_n": ("materials", "spec_n"), "plane_point": ("planes", "point"),
    "plane_albedo2": ("planes", "albedo2"), "light_pos": ("lights", "pos"),
    "light_intensity": ("lights", "intensity")}


@pytest.mark.parametrize("cls", sorted(_CLASSES))
def test_replay_grads_every_param_class(c2, cls):
    """tests/test_replay.py::test_replay_grads_every_param_class: per class,
    bind() feeds the param-mode planner and the replay gradients agree with
    the banded wavefront's."""
    scene, cam, opts, target = c2
    group, field = _CLASSES[cls]

    def apply_c(s, p):
        return s.replace(**{group: dataclasses.replace(
            getattr(s, group), **{field: p[cls]})})

    params = {cls: np.asarray(getattr(getattr(scene, group), field))}
    v1, g1 = value_and_grad_banded(apply_c, params, scene, cam, opts, target,
                                   device="cpu")
    fw = FusedWhitted(scene, cam, opts, device="cpu", param_inputs=True)
    v2, g2 = value_and_grad_replay(apply_c, params, scene, cam, opts, target,
                                   lambda p: fw.bind(**{cls: p[cls]}),
                                   device="cpu")
    assert abs(float(v1) - float(v2)) <= 1e-4 * abs(float(v1)) + 1e-8, cls
    assert float(g1[cls].abs().max()) > 0, cls
    assert _rel(g2[cls], g1[cls]) <= 2e-3, cls


def test_replay_tiled_and_banded_grads(c2):
    """Replay in bands of 24 rows and tiles of 512 lanes: the gradients of
    the banded wavefront (tests/test_replay.py::test_replay_tiled)."""
    scene, cam, opts, target = c2
    params = {"center": np.asarray(scene.spheres.center),
              "albedo": np.asarray(scene.materials.albedo)}
    v1, g1 = value_and_grad_banded(_with_params, params, scene, cam, opts,
                                   target, device="cpu")
    fw = FusedWhitted(scene, cam, opts, device="cpu", param_inputs=True)
    v2, g2 = value_and_grad_replay(
        _with_params, params, scene, cam, opts, target,
        lambda p: fw.bind(center=p["center"], albedo=p["albedo"]),
        band_rows=24, tile_rays=512, device="cpu")
    assert abs(float(v1) - float(v2)) <= 1e-4 * abs(float(v1)) + 1e-8
    for k in g1:
        assert _rel(g2[k], g1[k]) <= 2e-3, k
