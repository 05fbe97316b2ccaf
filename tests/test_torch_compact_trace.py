"""The compacted wavefront's spans and counters (renderer.render_rays,
utils/profiling.count_compaction, compactions): `rt.fold` around each fold
by slot, and each compaction's kept, capped and dropped lanes.

Config3's glass box at 64², depth 4, on the CPU: at cap 0.5 every live
lane fits, at cap 0.2 some are dropped. The counts are held to a plain
count of each compaction's input, and config4 (mirror, uncompacted) to
the spans and counters it had before compaction was traced.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import scenes, views
from raytracer_tpu_torch import renderer
from raytracer_tpu_torch.renderer import render_banded
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils.hostload import build_tracer

torch.set_num_threads(2)

SIZE, DEPTH = 64, 4
EPS_US = 0.01  # slack of the trace's microsecond timestamps


def _setup(name, w, h, cap="keep"):
    cfg = scenes.resized(scenes.load_config(name), w, h, DEPTH)
    scene, opts = scenes.port_scene(cfg)
    if cap != "keep":
        opts = dataclasses.replace(opts, compact_cap=cap)
    cam = scenes.port_camera(views.still(cfg))
    return scene, cam, opts, build_tracer(scene, "grid", torch.device("cpu"))


def _events(prof):
    return [e for e in prof.events() if e.name.startswith("rt.")]


def _inside(e, outer):
    return (e.time_range.start >= outer.time_range.start - EPS_US
            and e.time_range.end <= outer.time_range.end + EPS_US)


def _frame(name, w, h, cap="keep"):
    """One frame under torch.profiler → (image, rt.* events, compactions(),
    counters(), the plain count of each compaction's input: [(live lanes,
    cap)] in call order)."""
    scene, cam, opts, tracer = _setup(name, w, h, cap)
    seen = []
    compact = renderer._compact

    def counted(state, slot, cap_lanes):
        seen.append((int(state[3].sum()), cap_lanes))
        return compact(state, slot, cap_lanes)

    profiling.reset()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(renderer, "_compact", counted)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            img, *_ = render_banded(scene, cam, opts, device="cpu",
                                    tracer=tracer)
    out = (img, _events(prof), profiling.compactions(), profiling.counters(),
           seen)
    profiling.reset()
    return out


@pytest.fixture(scope="module", params=[0.5, 0.2], ids=["cap0.5", "cap0.2"])
def compacted(request):
    return request.param, _frame("config3_cornell", SIZE, SIZE,
                                 request.param)


def test_compactions_match_a_plain_count(compacted):
    cap, (_, _, got, counters, seen) = compacted
    assert len(seen) == DEPTH   # bounces 1..4 each run a compacted wavefront
    want = {f"compact.b{d + 1}": (min(n, c), c, max(n - c, 0))
            for d, (n, c) in enumerate(seen)}
    assert got == want
    dropped = sum(x[2] for x in got.values())
    assert (dropped == 0) if cap == 0.5 else (dropped > 0)
    # kept apart from the lane counters, which sum every entry they hold
    assert counters and all(k.startswith(("nearest.b", "shadow.b"))
                            for k in counters)


def test_fold_ranges_sit_only_in_compacted_bounces(compacted):
    _, (_, events, _, _, seen) = compacted
    folds = [e for e in events if e.name == "rt.fold"]
    bounces = {d: [e for e in events if e.name == f"rt.bounce.{d}"]
               for d in range(DEPTH + 1)}
    assert all(len(bounces[d]) == 1 for d in bounces)
    # bounce 0 runs the primaries uncompacted; each later bounce folds its
    # terms by slot: the miss and the diffuse leaves, and at the last
    # depth the specular leaf
    assert not any(_inside(f, bounces[0][0]) for f in folds)
    for d in range(1, DEPTH + 1):
        assert sum(_inside(f, bounces[d][0]) for f in folds) == \
            2 + (d == DEPTH), d
    assert len(folds) == 2 * DEPTH + 1
    compacts = [e for e in events if e.name == "rt.compact"]
    assert len(compacts) == len(seen) == DEPTH


@pytest.mark.parametrize("name,w,h,cap", [
    ("config4_mesh", 48, 27, "keep"),      # mirror, never compacted
    ("config3_cornell", 32, 32, None),     # glass, the doubling buffer
])
def test_an_uncompacted_frame_has_no_fold_range_and_no_compaction(
        name, w, h, cap):
    img, events, got, counters, seen = _frame(name, w, h, cap)
    names = {e.name for e in events}
    assert "rt.fold" not in names and "rt.compact" not in names
    assert got == {} and seen == []
    # the lane counters hold only the searches' kinds, one pair a bounce
    ran = sorted(int(n.rsplit(".", 1)[1]) for n in names
                 if n.startswith("rt.bounce."))
    assert set(counters) == {f"{k}.b{d}" for d in ran
                             for k in ("nearest", "shadow")}
    # with no profiler: the same image, and nothing counted
    scene, cam, opts, tracer = _setup(name, w, h, cap)
    again = render_banded(scene, cam, opts, device="cpu", tracer=tracer)[0]
    assert torch.equal(img, again)
    assert profiling.counters() == {} and profiling.compactions() == {}


def test_the_image_is_the_same_with_and_without_the_profiler(compacted):
    cap, (img, *_) = compacted
    scene, cam, opts, tracer = _setup("config3_cornell", SIZE, SIZE, cap)
    profiling.reset()
    plain, _, dropped = render_banded(scene, cam, opts, device="cpu",
                                      tracer=tracer)
    assert torch.equal(img, plain)
    assert profiling.compactions() == {}
    assert (float(dropped) == 0) == (cap == 0.5)


class _Untouchable:
    def __getattr__(self, name):
        raise AssertionError(f"count_compaction touched the mask: .{name}")


def test_compaction_counts_add_up_only_under_a_profiler_and_reset_clears():
    profiling.reset()
    profiling.count_compaction(1, _Untouchable(), 8, _Untouchable())
    assert profiling.compactions() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("rt.test"):
            profiling.count_compaction(1, torch.tensor([1, 1, 0, 0]), 4,
                                       torch.tensor(0.0))
            profiling.count_compaction(1, torch.tensor([1, 1, 1, 1]), 4,
                                       torch.tensor(3.0))
            profiling.count_compaction(2, torch.tensor([1, 0]), 2,
                                       torch.tensor(0.0))
    assert profiling.compactions() == {"compact.b1": (6, 8, 3),
                                       "compact.b2": (1, 2, 0)}
    assert profiling.counters() == {}
    profiling.reset()
    assert profiling.compactions() == {}
