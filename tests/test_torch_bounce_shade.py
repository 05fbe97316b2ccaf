"""PyTorch port: K6, the fused forward shading of a bounce
(`csrc/bounce_shade.cu` through `ops/bounce_shade.py`), against the torch
bounce of `renderer.bounce_step`, its twin.

On the card every bounce of each case runs both ways from the same state
(`Checked`, swapped in for `renderer.bounce_step`): the radiance, the ray
count, the children (o, d, thr, alive and slots), the masks the lane
counts sum, and the plan planes bit for bit; then whole frames both ways.
On the CPU (tier 1): which bounces reach K6, and the wrappers' refusals.

The `cuda` tests need an NVIDIA GPU and skip elsewhere. This file imports
neither jax nor the JAX package, so it also runs on a machine that has only
PyTorch — without the repository's conftest, which imports jax:

    python -m pytest tests/test_torch_bounce_shade.py -m cuda -q --noconftest
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import renderer
from raytracer_tpu_torch.accel.bvh import BVHTracer
from raytracer_tpu_torch.accel.grid import GridTracer
from raytracer_tpu_torch.core.types import KIND_SPHERE, Meshes, Planes, Spheres
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.ops import bounce_shade as BS
from raytracer_tpu_torch.ops.trace import Hit, surface_at
from raytracer_tpu_torch.renderer import render, value_and_grad_banded

torch.set_num_threads(2)

# string condition: evaluated when the test runs, not at import
NEEDS_GPU = pytest.mark.skipif("not torch.cuda.is_available()",
                               reason="needs an NVIDIA GPU")

BOUNCE_STEP = renderer.bounce_step
COUNT = renderer._count


@contextlib.contextmanager
def torch_bounce():
    """Every bounce in the block takes the torch bounce, as a bounce that
    autograd records does."""
    real = BS.fused_shading
    BS.fused_shading = lambda *a, **k: False
    try:
        yield
    finally:
        BS.fused_shading = real


def bits_equal(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


class Checked:
    """`renderer.bounce_step` for `monkeypatch`: each bounce runs through
    the torch bounce, then through K6 (two launches), from the same state,
    and every output must be equal bit for bit: the radiance (or the folded
    terms of a caller that passes none), the ray count, the child state,
    the masks `renderer._count` sums, the plan node. Returns K6's."""

    def __init__(self):
        self.bounces = 0

    def __call__(self, scene, state, opts, n0, is_last, count_rays=False,
                 tracer=None, plan_out=None, slot=None, n_slots=0, depth=0,
                 radiance=None):
        masks = []

        def count(scene, alive, searched, is_diff, *rest):
            masks.append([alive, *searched, is_diff])
            return COUNT(scene, alive, searched, is_diff, *rest)

        kw = dict(count_rays=count_rays, tracer=tracer, slot=slot,
                  n_slots=n_slots, depth=depth)
        rad_t = None if radiance is None else radiance.clone()
        plan_t = None if plan_out is None else []
        renderer._count = count
        try:
            with torch_bounce():
                t_terms, t_state, t_inc = BOUNCE_STEP(
                    scene, state, opts, n0, is_last, plan_out=plan_t,
                    radiance=rad_t, **kw)
            before = BS.launches
            f_terms, f_state, f_inc = BOUNCE_STEP(
                scene, state, opts, n0, is_last, plan_out=plan_out,
                radiance=radiance, **kw)
        finally:
            renderer._count = COUNT
        assert BS.launches == before + 2
        if radiance is None:
            assert len(f_terms) == len(t_terms)
            assert all(bits_equal(a, b) for a, b in zip(f_terms, t_terms))
        else:
            for t in f_terms:
                radiance = radiance + t
            for t in t_terms:
                rad_t = rad_t + t
            assert bits_equal(radiance, rad_t)
        assert bits_equal(f_inc, t_inc)
        assert (f_state is None) == (t_state is None)
        if f_state is not None:
            assert len(f_state) == len(t_state)
            assert all(bits_equal(a, b) for a, b in zip(f_state, t_state))
        assert len(masks) == 2 and len(masks[0]) == len(masks[1])
        assert all(bits_equal(a, b) for a, b in zip(*masks))
        if plan_out is not None:
            assert all(bits_equal(a, b)
                       for a, b in zip(plan_out[-1], plan_t[-1]))
        self.bounces += 1
        return f_terms, f_state, f_inc


def frames_agree(monkeypatch, scene, cam, opts, tracer, plan=False):
    """Every bounce of the frame `Checked`, then the frame through K6 and
    through the torch bounce: the image, the ray count (and the dropped
    lanes, the plan planes) equal bit for bit → the bounces checked."""
    checked = Checked()
    kw = dict(device="cuda", tracer=tracer, count_rays=True,
              record_plan=plan)
    with torch.no_grad():
        with monkeypatch.context() as m:
            m.setattr(renderer, "bounce_step", checked)
            render(scene, cam, opts, **kw)
        got = render(scene, cam, opts, **kw)
        with torch_bounce():
            want = render(scene, cam, opts, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, tuple):
            assert len(a) == len(b)
            assert all(bits_equal(x, y) for x, y in zip(a, b))
        else:
            assert bits_equal(a, b)
    assert checked.bounces > 0
    return checked.bounces


def config4(w, h, depth=4, **opt_kw):
    scene, cam, opts = presets.config4_mesh()
    opts = dataclasses.replace(opts, width=w, height=h, max_depth=depth,
                               tile_rays=w * h, **opt_kw)
    return scene, cam, opts


def small_case(**opt_kw):
    """config2 (mirror spheres over a checker plane, no mesh) at 16×9 d2:
    quick CPU bounces."""
    scene, cam, opts = presets.config2_mirror_spheres()
    return scene, cam, dataclasses.replace(opts, width=16, height=9,
                                           max_depth=2, **opt_kw)


def scene_case(case):
    """config4 (or config7's uv quad) at 480×270 d4 under a variant →
    (scene, camera, opts, the scene the tracer is built from)."""
    if case == "uv_mesh":
        scene, cam, opts = presets.config7_uv_quad()
        opts = dataclasses.replace(opts, width=480, height=270,
                                   tile_rays=480 * 270)
        return scene, cam, opts, scene
    scene, cam, opts = config4(480, 270)
    built = scene
    if case == "no_sphere":
        scene = built = scene.replace(spheres=Spheres.empty())
    elif case == "no_plane":
        scene = built = scene.replace(planes=Planes.empty())
    elif case == "flat_mesh":
        me = scene.meshes
        scene = built = scene.replace(meshes=Meshes.build(
            me.verts, me.tris, me.mat_id))
    elif case == "moved":
        # the tables swapped after the tracer was built, as the training
        # loop's steps swap theirs: K6 reads the scene it is given
        sp, mats = scene.spheres, scene.materials
        scene = scene.replace(
            spheres=dataclasses.replace(
                sp, center=sp.center + np.float32([0.08, -0.05, 0.1])),
            materials=dataclasses.replace(mats, albedo=mats.albedo * 0.9,
                                          ks=mats.ks * 1.1))
    return scene, cam, opts, built


# --- tier 1: which bounces reach K6 ------------------------------------------

def _k6_refused(*a, **k):
    raise AssertionError("a bounce reached K6")


@pytest.mark.parametrize("case", ["render", "record_plan", "grad"])
def test_cpu_bounces_never_reach_k6(monkeypatch, case):
    """A CPU bounce runs the torch bounce, whatever autograd records."""
    monkeypatch.setattr(BS, "surface_cuda", _k6_refused)
    monkeypatch.setattr(BS, "shade_cuda", _k6_refused)
    scene, cam, opts = small_case()
    if case == "grad":
        loss, g = value_and_grad_banded(
            lambda s, p: s.replace(materials=dataclasses.replace(
                s.materials, albedo=p["albedo"])),
            {"albedo": scene.materials.albedo}, scene, cam, opts,
            np.zeros((9, 16, 3), np.float32), device="cpu")
        assert bool(torch.isfinite(g["albedo"]).all())
        return
    with torch.no_grad():
        out = render(scene, cam, opts, device="cpu",
                     record_plan=case == "record_plan")
    assert out[0].shape == (9, 16, 3)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_bounces_autograd_records_never_reach_k6(monkeypatch, remat):
    """With the rule's device test taken as passed (so K6 would run where
    autograd records nothing), a differentiable render under grad with a
    leaf that requires grad reaches neither wrapper, forward or backward
    recompute (K7's rule keeps its own device test:
    tests/test_torch_bounce_adjoint.py); the same render under no_grad
    does (the control)."""
    monkeypatch.setattr(BS, "surface_cuda", _k6_refused)
    monkeypatch.setattr(BS, "shade_cuda", _k6_refused)
    monkeypatch.setattr(BS, "fused_shading", lambda scene, state, r=None:
                        not BS.autograd_records(scene, state, r))
    scene, cam, opts = small_case(remat_tiles=remat != "none",
                                  remat_policy="full")

    def apply(s, p):
        return s.replace(spheres=dataclasses.replace(s.spheres,
                                                     center=p["c"]))

    loss, g = value_and_grad_banded(
        apply, {"c": scene.spheres.center}, scene, cam, opts,
        np.zeros((9, 16, 3), np.float32), device="cpu")
    assert bool(torch.isfinite(g["c"]).all())
    with torch.no_grad(), pytest.raises(AssertionError, match="reached K6"):
        render(scene, cam, opts, device="cpu")


@pytest.mark.parametrize("case", ["no_grad", "grad_no_leaf", "scene_leaf",
                                  "ray_leaf", "radiance_leaf"])
def test_autograd_records(case):
    """The rule's autograd half: a bounce is recorded only with grad mode
    on and a float tensor it reads that requires grad."""
    scene = small_case()[0].to("cpu")
    o, d = torch.zeros((4, 3)), torch.ones((4, 3))
    state = (o, d, torch.ones((4, 3)), torch.ones((4,), dtype=torch.bool))
    radiance = torch.zeros((4, 3))
    if case == "scene_leaf":
        scene = scene.replace(lights=dataclasses.replace(
            scene.lights, pos=scene.lights.pos.clone().requires_grad_()))
    elif case == "ray_leaf":
        state = (d.clone().requires_grad_(), *state[1:])
    elif case == "radiance_leaf":
        radiance.requires_grad_()
    want = case not in ("no_grad", "grad_no_leaf")
    with torch.set_grad_enabled(case != "no_grad"):
        assert BS.autograd_records(scene, state, radiance) == want
        assert not BS.fused_shading(scene, state, radiance)  # the CPU
    with torch.no_grad():
        assert not BS.autograd_records(scene, state, radiance)


@pytest.mark.parametrize("half", ["surface", "shade"])
def test_k6_wrappers_reject_cpu_tensors(half):
    scene, _, opts = small_case()
    scene = scene.to("cpu")
    n = 4
    o, d = torch.zeros((n, 3)), torch.ones((n, 3))
    alive = torch.ones((n,), dtype=torch.bool)
    hit = Hit(kind=torch.zeros((n,), dtype=torch.int32),
              idx=torch.zeros((n,), dtype=torch.int32), t=torch.zeros((n,)))
    tables = BS.scene_tables(scene, torch.device("cpu"))
    before = BS.launches
    with pytest.raises(ValueError, match="CUDA"):
        if half == "surface":
            BS.surface_cuda(tables, o, d, alive, hit, opts)
        else:
            BS.shade_cuda(tables, o, d, torch.ones((n, 3)), alive, hit,
                          torch.zeros((2, n), dtype=torch.bool), opts,
                          is_last=False, glass=False)
    assert BS.launches == before


# --- on the card: K6 against the torch bounce --------------------------------

@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("plan", [False, True])
def test_config4_1080p_frame(monkeypatch, plan):
    """config4's 1080p d4 frame through the grid: both bounces (the early
    exit's; with the plan, every bounce to max_depth)."""
    scene, cam, opts = presets.config4_mesh()
    tracer = GridTracer.build(scene, "cuda")
    n = frames_agree(monkeypatch, scene, cam, opts, tracer, plan)
    assert n == (opts.max_depth + 1 if plan else 2)


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("case", ["no_sphere", "no_plane", "flat_mesh",
                                  "uv_mesh", "moved"])
def test_scene_tables(monkeypatch, case):
    scene, cam, opts, built = scene_case(case)
    tracer = GridTracer.build(built, "cuda")
    frames_agree(monkeypatch, scene, cam, opts, tracer)


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("tracer", ["grid", "bvh", "dense"])
def test_tracers(monkeypatch, tracer):
    scene, cam, opts = config4(320, 180)
    tr = {"grid": lambda: GridTracer.build(scene, "cuda"),
          "bvh": lambda: BVHTracer.build(scene, "cuda"),
          "dense": lambda: None}[tracer]()
    frames_agree(monkeypatch, scene, cam, opts, tr)


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("cap", [None, 0.5])
def test_config3_glass(monkeypatch, cap):
    """Glass doubles the buffer each bounce (terms folded by the renderer
    past bounce 0); at cap 0.5 the wavefront compacts and the terms fold
    by slot."""
    scene, cam, opts = presets.config3_cornell()
    opts = dataclasses.replace(opts, width=128, height=128, max_depth=4,
                               tile_rays=128 * 128, compact_cap=cap)
    tracer = GridTracer.build(scene, "cuda")
    assert frames_agree(monkeypatch, scene, cam, opts, tracer) >= 3


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("case", ["config4_d1", "config3_d2"])
def test_last_bounce(monkeypatch, case):
    """The last bounce's mirror and glass leaves, on lanes still alive."""
    if case == "config4_d1":
        scene, cam, opts = config4(480, 270, depth=1)
    else:
        scene, cam, opts = presets.config3_cornell()
        opts = dataclasses.replace(opts, width=128, height=128, max_depth=2,
                                   tile_rays=128 * 128)
    tracer = GridTracer.build(scene, "cuda")
    assert frames_agree(monkeypatch, scene, cam, opts,
                        tracer) == opts.max_depth + 1


def _bounce_both(scene, state, opts, tracer, is_last, plan=True):
    """One bounce `Checked`, with the radiance and without it."""
    n0 = state[0].shape[0]
    for radiance in (torch.zeros((n0, 3), device="cuda"), None):
        with torch.no_grad():
            Checked()(scene, state, opts, n0, is_last, count_rays=True,
                      tracer=tracer, plan_out=[] if plan else None,
                      radiance=radiance)


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("case", ["all_dead", "all_miss"])
@pytest.mark.parametrize("is_last", [False, True])
def test_dead_and_missing_wavefronts(case, is_last):
    scene, cam, opts = config4(96, 54)
    tracer = GridTracer.build(scene, "cuda")
    dscene, dcam = scene.to("cuda"), cam.to("cuda")
    n = 96 * 54
    dirs = renderer.tile_dirs(dcam, opts, 0, 54)[0]
    alive = torch.ones((n,), dtype=torch.bool, device="cuda")
    if case == "all_dead":
        alive = ~alive
    else:  # straight up from above the scene: nothing is hit
        dirs = torch.nn.functional.normalize(
            dirs * torch.tensor([0.01, 0.0, 0.01], device="cuda")
            + torch.tensor([0.0, 1.0, 0.0], device="cuda"), dim=1)
    orig = (dcam.pos + torch.tensor([0.0, 20.0, 0.0], device="cuda")
            )[None].expand(n, 3) if case == "all_miss" else \
        dcam.pos[None].expand(n, 3)
    state = (orig, dirs, torch.rand((n, 3), device="cuda"), alive)
    if case == "all_miss":
        hit = tracer.nearest(orig.contiguous(), dirs, opts.t_min, 4096)
        assert bool((hit.kind == 0).all())
    _bounce_both(dscene, state, opts, tracer, is_last)


class ClaimedSphere:
    """A tracer whose nearest search claims sphere 0 on every fourth lane,
    hit or not: the lanes whose recompute misses are demoted (a plan's
    knife edge, the case that gave NaN gradients at config3 1024² d4)."""

    def __init__(self, inner):
        self.inner, self.device = inner, inner.device

    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        hit = self.inner.nearest(orig, direc, t_min, tri_chunk, active)
        claim = torch.arange(orig.shape[0], device=orig.device) % 4 == 0
        return Hit(kind=torch.where(claim, KIND_SPHERE, hit.kind),
                   idx=torch.where(claim, 0, hit.idx), t=hit.t)

    def occluded(self, *a, **k):
        return self.inner.occluded(*a, **k)


@pytest.mark.cuda
@NEEDS_GPU
def test_knife_edge_demoted_lanes():
    scene, cam, opts = config4(96, 54)
    tracer = ClaimedSphere(GridTracer.build(scene, "cuda"))
    dscene, dcam = scene.to("cuda"), cam.to("cuda")
    n = 96 * 54
    dirs = renderer.tile_dirs(dcam, opts, 0, 54)[0]
    orig = dcam.pos[None].expand(n, 3).contiguous()
    with torch.no_grad():
        hit = tracer.nearest(orig, dirs, opts.t_min, 4096)
        surf = surface_at(dscene, orig, dirs, hit, opts.t_min)
    assert int(((hit.kind == KIND_SPHERE) & ~surf.valid).sum()) > 100
    state = (orig, dirs, torch.ones((n, 3), device="cuda"),
             torch.ones((n,), dtype=torch.bool, device="cuda"))
    for is_last in (False, True):
        _bounce_both(dscene, state, opts, tracer, is_last)
