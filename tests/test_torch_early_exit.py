"""The bounce loop's early exit (`renderer.render_rays`): the loop ends at
the first child wavefront with no live lane, and everything the renderer
returns stays the fixed-depth loop's bit for bit.

`fixed_render_rays` is the loop with no early exit, written here from
`renderer.bounce_step`. Each test swaps it in for `renderer.render_rays`,
so the same public call gives the fixed-depth result to compare with.
Scenes: config4 at 32×18, depth 4, in tiles of 192 lanes (lanes die after
the mirror's bounce, sooner in tiles that do not see it), with the grid,
BVH and culled-sweep tracers; config3's glass at 24×24 in tiles of 96
lanes, compacted and not (some tiles' lanes live to `max_depth`).
"""

import dataclasses

import pytest
import torch

from raytracer_tpu_torch import renderer
from raytracer_tpu_torch.accel.cull import CullTracer
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.ops.replay import replay_render
from raytracer_tpu_torch.renderer import (render, render_banded,
                                          value_and_grad_banded)
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils.hostload import build_tracer

torch.set_num_threads(2)

DEPTH = 4


def fixed_render_rays(scene, orig, direc, opts, count_rays=False,
                      tracer=None, record_plan=False, *, every_bounce=False):
    """`renderer.render_rays` with every one of the `max_depth + 1` bounces
    run, whatever lives."""
    if getattr(tracer, "per_trace_cursor", False):
        tracer = tracer.fresh()
    n0, dev = orig.shape[0], orig.device
    f32 = dict(dtype=torch.float32, device=dev)
    radiance = torch.zeros((n0, 3), **f32)
    state = (orig, direc, torch.ones((n0, 3), **f32),
             torch.ones((n0,), dtype=torch.bool, device=dev))
    traced = torch.zeros((), **f32)
    dropped = torch.zeros((), **f32)
    plan = [] if record_plan else None
    compact = renderer.use_compact(scene, opts)
    cap = renderer._cap_lanes(opts.compact_cap, n0) if compact else 0
    slot, n_slots = None, n0
    for depth in range(opts.max_depth + 1):
        terms, state, inc = renderer.bounce_step(
            scene, state, opts, n0, is_last=depth == opts.max_depth,
            count_rays=count_rays, tracer=tracer, plan_out=plan, slot=slot,
            n_slots=n_slots, depth=depth)
        for t in terms:
            radiance = radiance + t
        traced = traced + inc
        if state is None:
            break
        if slot is not None:
            *state, slot = state
        if scene.has_glass:
            n_slots *= 2
        if compact and state[0].shape[0] > cap:
            if slot is None:
                slot = torch.arange(state[0].shape[0], dtype=torch.int32,
                                    device=dev)
            state, slot, drop = renderer._compact(tuple(state), slot, cap)
            dropped = dropped + drop
        state = tuple(state)
    out = (radiance, traced)
    if record_plan:
        out += (tuple(w for w, _ in plan), tuple(o for _, o in plan))
    return out + (dropped,) if compact else out


def fixed(monkeypatch, fn, *args, **kwargs):
    """`fn(*args, **kwargs)` through the fixed-depth loop."""
    with monkeypatch.context() as m:
        m.setattr(renderer, "render_rays", fixed_render_rays)
        return fn(*args, **kwargs)


def bounces_run():
    """{depth: bounces run} and the `rt.alive` reads since the last reset,
    from the program's span aggregate."""
    seen = profiling.spans()
    runs = {d: seen[f"rt.bounce.{d}"]["count"] for d in range(DEPTH + 1)
            if f"rt.bounce.{d}" in seen}
    return runs, seen.get("rt.alive", {"count": 0})["count"]


def assert_reads_follow_the_bounces(runs, reads):
    """One read after each bounce that spawned children: every bounce run
    but those at `max_depth`."""
    assert reads == sum(runs.values()) - runs.get(DEPTH, 0)


@pytest.fixture(scope="module")
def config4():
    scene, cam, opts = presets.PRESETS["config4"]()
    opts = dataclasses.replace(opts, width=32, height=18, max_depth=DEPTH,
                               tile_rays=192, tile_block=None)
    grid = build_tracer(scene, "grid", "cpu")
    tracers = {"grid": grid, "bvh": build_tracer(scene, "bvh", "cpu"),
               "cull": CullTracer(scene, "cpu", inner=grid, cap=20480)}
    return scene, cam, opts, tracers


def config3(cap):
    scene, cam, opts = presets.PRESETS["config3"]()
    return scene, cam, dataclasses.replace(opts, width=24, height=24,
                                           max_depth=DEPTH, tile_rays=96,
                                           compact_cap=cap)


@pytest.mark.parametrize("kind", ["grid", "bvh", "cull"])
def test_mesh_render_ends_early_and_equals_the_fixed_depth(config4, kind,
                                                           monkeypatch):
    scene, cam, opts, tracers = config4
    tiles = opts.width * opts.height // opts.tile_rays
    profiling.reset()
    img, traced = render(scene, cam, opts, device="cpu",
                         tracer=tracers[kind], count_rays=True)
    runs, reads = bounces_run()
    want, want_traced = fixed(monkeypatch, render, scene, cam, opts,
                              device="cpu", tracer=tracers[kind],
                              count_rays=True)
    assert torch.equal(img, want)
    assert float(traced) == float(want_traced) > opts.width * opts.height
    # no ray of the scene reaches depth 2: no tile runs bounces 2–4
    assert runs == {0: tiles, 1: runs[1]} and 0 < runs[1] <= tiles
    assert_reads_follow_the_bounces(runs, reads)


@pytest.mark.parametrize("cap", [None, 1.0, 0.25], ids=["uncompacted",
                                                        "cap1", "cap0.25"])
def test_glass_render_equals_the_fixed_depth(cap, monkeypatch):
    scene, cam, opts = config3(cap)
    profiling.reset()
    img, traced, *drop = render_banded(scene, cam, opts, device="cpu",
                                       count_rays=True)
    runs, reads = bounces_run()
    want, want_traced, *want_drop = fixed(
        monkeypatch, render_banded, scene, cam, opts, device="cpu",
        count_rays=True)
    assert torch.equal(img, want)
    assert float(traced) == float(want_traced)
    assert [float(x) for x in drop] == [float(x) for x in want_drop]
    if cap == 0.25:
        assert float(drop[0]) > 0   # the cap loses lanes, the same ones
    # lanes inside the glass live to max_depth: tiles that hold such a
    # lane run every bounce (compacted tiles are strided over the whole
    # band, so all of them), the others end early
    tiles = opts.width * opts.height // opts.tile_rays
    if cap is None:
        assert 0 < runs[DEPTH] < tiles
    else:
        assert runs == {d: tiles for d in range(DEPTH + 1)}
    assert_reads_follow_the_bounces(runs, reads)


def test_recorded_plan_keeps_every_bounce(config4, monkeypatch):
    scene, cam, opts, tracers = config4
    img, traced, wins, occs = render(scene, cam, opts, device="cpu",
                                     tracer=tracers["grid"], record_plan=True,
                                     count_rays=True)
    w_img, w_traced, w_wins, w_occs = fixed(
        monkeypatch, render, scene, cam, opts, device="cpu",
        tracer=tracers["grid"], record_plan=True, count_rays=True)
    assert len(wins) == len(occs) == DEPTH + 1
    assert torch.equal(img, w_img) and float(traced) == float(w_traced)
    for a, b in zip(wins + occs, w_wins + w_occs):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    assert all(bool((w < 0).all()) for w in wins[2:])   # dead bounces


def _with_params(s, p):
    return s.replace(
        spheres=dataclasses.replace(s.spheres, center=p["center"]),
        materials=dataclasses.replace(s.materials, albedo=p["albedo"]))


@pytest.mark.parametrize("policy", ["plan", "full"])
def test_remat_step_equals_the_fixed_depth(config4, policy, monkeypatch):
    """A value_and_grad_banded step: the loss and the gradients bit-equal.
    Under "plan" the record reads and ends early and its replay (forward
    and the backward's recompute) runs the recorded bounces with no read;
    under "full" the recompute reads and ends as the forward did."""
    scene, cam, opts, tracers = config4
    opts = dataclasses.replace(opts, remat_tiles=True, remat_policy=policy)
    tiles = opts.width * opts.height // opts.tile_rays
    target = render(scene, cam, opts, device="cpu",
                    tracer=tracers["grid"])[0] * 0.9
    p0 = {"center": scene.spheres.center, "albedo": scene.materials.albedo}
    args = (_with_params, p0, scene, cam, opts, target)
    profiling.reset()
    loss, grads = value_and_grad_banded(*args, device="cpu",
                                        tracer=tracers["grid"])
    runs, reads = bounces_run()
    w_loss, w_grads = fixed(monkeypatch, value_and_grad_banded, *args,
                            device="cpu", tracer=tracers["grid"])
    assert float(loss) == float(w_loss) > 0
    for k in p0:
        assert float(grads[k].abs().max()) > 0, k
        assert torch.equal(grads[k], w_grads[k]), k
    passes = 3 if policy == "plan" else 2   # record, replay, recompute
    assert runs == {0: passes * tiles, 1: runs[1]}
    assert 0 < runs[1] <= passes * tiles
    # "plan": the record reads after each of its bounces, the replays
    # never; "full": the forward and the recompute both read (checkpoint
    # ends a recompute at its last saved tensor, before its last read)
    ran = (runs[0] + runs[1]) // passes
    if policy == "plan":
        assert reads == ran
    else:
        assert ran < reads < 2 * ran


def test_a_plan_replay_reads_nothing(config4):
    scene, cam, opts, tracers = config4
    _, _, wins, occs = render(scene, cam, opts, device="cpu",
                              tracer=tracers["grid"], record_plan=True)
    profiling.reset()
    img = replay_render(scene, cam, opts, (wins, occs), tile_rays=192,
                        device="cpu")[0]
    runs, reads = bounces_run()
    tiles = opts.width * opts.height // 192
    assert reads == 0 and runs == {d: tiles for d in range(DEPTH + 1)}
    assert float(img.max()) > 0
