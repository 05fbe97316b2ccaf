"""PyTorch port: K7, the adjoint of a recorded bounce's shading
(`csrc/bounce_adjoint.cu` through `ops/bounce_shade.shade_recorded`),
against torch.autograd of the torch bounce of `renderer.bounce_step`, its
twin.

On the card each case runs one bounce both ways from the same state and
the same search answers, with o, d, thr and every table of K7's set as
leaves, once for each of the bounce's outputs under a seeded cotangent:
the leaves' gradients must agree within the tolerances below; then whole
`value_and_grad_banded` steps both ways under both remat policies, and a
step twice, bit for bit. On the CPU (tier 1): which bounces K7's rule
takes, that no CPU bounce reaches a kernel, that the module imports
without CUDA, and the autograd Function's plumbing with its two launches
played by the torch bounce (`Emulated`).

Tolerances (the reason: the two compute the same expressions in float32,
in other orders): per lane, K7 fuses what torch's backward computes op by
op, so a cotangent of o, d or thr differs by rounding, |Δ| ≤ LANE_RTOL ·
|torch| + LANE_ATOL · max |torch|; a table's gradient is a sum over every
lane that torch adds by a one-hot product and K7 thread by thread, then
by blocks, so |Δ| ≤ TABLE_RTOL · max |torch| over that table.

The `cuda` tests need an NVIDIA GPU and skip elsewhere. This file imports
neither jax nor the JAX package, so it also runs on a machine that has only
PyTorch — without the repository's conftest, which imports jax:

    python -m pytest tests/test_torch_bounce_adjoint.py -m cuda -q --noconftest
"""

import contextlib
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracer_tpu_torch import renderer
from raytracer_tpu_torch.accel.grid import GridTracer
from raytracer_tpu_torch.core.types import (KIND_SPHERE, Lights, Materials,
                                            Meshes, Planes, Scene, Spheres)
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.ops import bounce_shade as BS
from raytracer_tpu_torch.ops.safemath import dot, maximum, safe_sqrt
from raytracer_tpu_torch.ops.trace import Hit, surface_at
from raytracer_tpu_torch.renderer import value_and_grad_banded

torch.set_num_threads(2)

# string condition: evaluated when the test runs, not at import
NEEDS_GPU = pytest.mark.skipif("not torch.cuda.is_available()",
                               reason="needs an NVIDIA GPU")

LANE_RTOL, LANE_ATOL = 1e-3, 1e-4
TABLE_RTOL = 1e-3

# K7's table set, as (group, field), in `scene_tables`' order
TABLES = (("spheres", "center"), ("spheres", "radius"), ("planes", "point"),
          ("planes", "normal"), ("planes", "albedo2"),
          ("materials", "albedo"), ("materials", "kd"), ("materials", "ks"),
          ("materials", "spec_n"), ("materials", "ior"), ("lights", "pos"),
          ("lights", "intensity"))
# their places in `scene_tables`' list
SLOTS = (0, 1, 3, 4, 10, 20, 21, 22, 23, 24, 25, 26)


@contextlib.contextmanager
def torch_bounce():
    """Every bounce in the block takes the torch bounce, recorded or not."""
    real = BS.fused_shading, BS.adjoint_shading
    BS.fused_shading = BS.adjoint_shading = lambda *a, **k: False
    try:
        yield
    finally:
        BS.fused_shading, BS.adjoint_shading = real


def bits_equal(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def with_params(scene, p):
    """Sphere centers and material albedos grafted in: the training cell's
    parameters."""
    return scene.replace(
        spheres=dataclasses.replace(scene.spheres, center=p["center"]),
        materials=dataclasses.replace(scene.materials, albedo=p["albedo"]))


def with_leaves(dscene):
    """`dscene` with every non-empty table of K7's set a fresh leaf →
    (scene, {"group.field": leaf})."""
    leaves, groups = {}, {}
    for g, f in TABLES:
        x = getattr(getattr(dscene, g), f)
        if x.shape[0]:
            leaf = x.detach().clone().requires_grad_()
            leaves[f"{g}.{f}"] = leaf
            groups.setdefault(g, {})[f] = leaf
    return dscene.replace(**{g: dataclasses.replace(getattr(dscene, g), **kw)
                             for g, kw in groups.items()}), leaves


def config4(w, h, depth=4, **opt_kw):
    scene, cam, opts = presets.config4_mesh()
    return scene, cam, dataclasses.replace(opts, width=w, height=h,
                                           max_depth=depth, tile_rays=w * h,
                                           **opt_kw)


def small_case(**opt_kw):
    """config2 (mirror spheres over a checker plane, no mesh) at 16×9 d2:
    quick CPU bounces."""
    scene, cam, opts = presets.config2_mirror_spheres()
    return scene, cam, dataclasses.replace(opts, width=16, height=9,
                                           max_depth=2, **opt_kw)


def leaf_scene(case):
    """The scene of `small_case` (or config3's glass box) with one tensor
    a leaf that requires grad."""
    if case == "glass":
        scene = presets.config3_cornell()[0].to("cpu")
        return scene.replace(spheres=dataclasses.replace(
            scene.spheres, center=scene.spheres.center.clone()
            .requires_grad_()))
    scene = small_case()[0].to("cpu")
    if case in ("none", "ray"):
        return scene
    if case in ("mesh.verts", "mesh.albedo2"):
        me = presets.config4_mesh()[0].meshes.to("cpu")
        scene = scene.replace(meshes=me)
    group, field = {"mesh.verts": ("meshes", "verts"),
                    "mesh.albedo2": ("meshes", "albedo2")}.get(
        case, tuple(case.split(".")))
    table = getattr(scene, group)
    return scene.replace(**{group: dataclasses.replace(table, **{
        field: getattr(table, field).clone().float().requires_grad_()})})


# --- tier 1: which bounces K7's rule takes -----------------------------------

COVERED = [f"{g}.{f}" for g, f in TABLES] + ["ray"]
KEPT = ["none", "glass", "planes.tangent", "planes.bitangent",
        "planes.checker_scale", "mesh.verts", "mesh.albedo2"]


@pytest.mark.parametrize("case", COVERED + KEPT)
def test_adjoint_rule(case):
    """K7's rule: autograd records the bounce, no glass, every scene tensor
    that requires grad in K7's set. On CPU rays it never engages."""
    scene = leaf_scene(case)
    n = 4
    o = torch.zeros((n, 3), requires_grad=case == "ray")
    state = (o, torch.ones((n, 3)), torch.ones((n, 3)),
             torch.ones((n,), dtype=torch.bool))
    assert BS.adjoint_covers(scene, state) == (case in COVERED)
    assert not BS.adjoint_shading(scene, state)  # the CPU
    with torch.no_grad():
        assert not BS.adjoint_covers(scene, state)


def _refused(*a, **k):
    raise AssertionError("a bounce reached a kernel")


@pytest.mark.parametrize("remat", ["none", "plan", "full"])
def test_cpu_bounces_never_reach_k7(monkeypatch, remat):
    """A CPU training step runs the torch bounce, forward and backward,
    under each remat policy."""
    for name in ("surface_cuda", "shade_cuda", "shade_recorded",
                 "adjoint_cuda"):
        monkeypatch.setattr(BS, name, _refused)
    scene, cam, opts = small_case(remat_tiles=remat != "none",
                                  remat_policy="full" if remat == "full"
                                  else "plan")
    before = BS.adjoint_launches
    loss, g = value_and_grad_banded(
        with_params, {"center": scene.spheres.center,
                      "albedo": scene.materials.albedo}, scene, cam, opts,
        np.zeros((9, 16, 3), np.float32), device="cpu")
    assert all(bool(torch.isfinite(v).all()) for v in g.values())
    assert float(g["center"].abs().max()) > 0
    assert BS.adjoint_launches == before


def test_module_imports_without_cuda():
    """Importing the wrapper and the renderer builds and loads nothing."""
    code = ("import raytracer_tpu_torch.renderer, "
            "raytracer_tpu_torch.ops.bounce_shade as B, "
            "raytracer_tpu_torch.kernels.build as b; "
            "assert b._lib is None and B.adjoint_launches == 0; print('ok')")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_adjoint_wrapper_rejects_cpu_tensors():
    scene, _, opts = small_case()
    scene = scene.to("cpu")
    n = 4
    hit = Hit(kind=torch.zeros((n,), dtype=torch.int32),
              idx=torch.zeros((n,), dtype=torch.int32), t=torch.zeros((n,)))
    tables = BS.scene_tables(scene, torch.device("cpu"))
    before = BS.adjoint_launches
    with pytest.raises(ValueError, match="CUDA"):
        BS.adjoint_cuda(tables, torch.zeros((n, 3)), torch.ones((n, 3)),
                        torch.ones((n, 3)), torch.ones((n,), dtype=torch.bool),
                        hit, torch.zeros((2, n), dtype=torch.bool), opts,
                        torch.ones((2, n, 3)), (None,) * 3, is_last=False)
    assert BS.adjoint_launches == before


@pytest.mark.parametrize("rows, cap, want", [
    ([4, 9, 7, 7, 6, 6], 440, [(0, 39)]),
    ([9] * 100, 440, [(0, 432), (432, 432), (864, 36)]),
    ([7, 7, 7], 14, [(0, 14), (14, 7)]),
])
def test_windows(rows, cap, want):
    """K7's windows hold whole rows and cover every float once."""
    assert BS._windows(rows, cap) == want


# --- tier 1: the Function's plumbing, its launches played by torch -----------

_EMPTY = {0: (0, 3), 1: (0,), 3: (0, 3), 4: (0, 3), 5: (0, 3), 6: (0, 3),
          9: (0,), 10: (0, 3), 11: (0, 3), 13: (0, 3), 15: (0, 2), 17: (0,),
          18: (0, 3), 25: (0, 3), 26: (0, 3)}


def scene_of(tabs):
    """The glass-free Scene whose `scene_tables` list `tabs` is."""
    dev = next(x.device for x in tabs if x is not None)
    t = [x if x is not None else
         torch.zeros(_EMPTY.get(j, (0, 3) if j == 12 else (0,)),
                     dtype=torch.float32 if j in _EMPTY else torch.int32,
                     device=dev)
         for j, x in enumerate(tabs)]
    return Scene(Spheres(*t[0:3]), Planes(*t[3:11]), Meshes(*t[11:19]),
                 Materials(*t[19:25]), Lights(*t[25:27]), has_glass=False)


class Answers:
    """A tracer that answers a bounce's searches: `nearest` the given hit,
    `occluded` each light's bits in light order."""

    def __init__(self, device, hit, shadowed):
        self.device, self._hit, self._shadowed = device, hit, shadowed
        self._light = 0

    def nearest(self, *args, **kw):
        return self._hit

    def occluded(self, *args, **kw):
        self._light += 1
        return self._shadowed[self._light - 1]


class Emulated:
    """K6's surface and shade launches and K7 played by the torch bounce
    on any device, for `monkeypatch`: the Function's plumbing (its saved
    inputs, its outputs, the gradients' places) runs on the CPU."""

    def __init__(self):
        self.inside = False
        self.adjoints = 0

    def adjoint_shading(self, scene, state, radiance=None):
        return not self.inside and BS.adjoint_covers(scene, state, radiance)

    def bounce(self, tabs, o, d, thr, alive, hit, shadowed, opts, is_last,
               plan):
        plan_out = [] if plan else None
        self.inside = True
        try:
            terms, child, _ = renderer.bounce_step(
                scene_of(tabs), (o, d, thr, alive), opts, o.shape[0],
                is_last, tracer=Answers(o.device, hit, shadowed),
                plan_out=plan_out)
        finally:
            self.inside = False
        return (torch.stack(terms), child,
                tuple(plan_out[0]) if plan else None)

    def surface_cuda(self, tables, o, d, alive, hit, opts):
        scene = scene_of(tables[0])
        surf = surface_at(scene, o, d, hit, opts.t_min)
        is_diff = surf.valid & alive & (surf.mtype == 0)
        front = (dot(d, surf.n) < 0).to(torch.float32)
        sorig = surf.p + (2.0 * front - 1.0)[:, None] * opts.bias * surf.n
        ldirs, dists, acts = [], [], []
        for li in range(scene.lights.count):
            lvec = scene.lights.pos[li][None, :] - surf.p
            d2 = dot(lvec, lvec)
            dist = safe_sqrt(d2, valid=d2 > 0)
            ldir = lvec / maximum(dist, 1e-12)[:, None]
            ldirs.append(ldir)
            dists.append(dist)
            acts.append(is_diff & (maximum(dot(ldir, surf.n), 0.0) > 0))
        n = o.shape[0]
        stack = lambda xs, shape, dt: (torch.stack(xs) if xs else
                                       torch.zeros(shape, dtype=dt))
        return (sorig, stack(ldirs, (0, n, 3), torch.float32),
                stack(dists, (0, n), torch.float32),
                stack(acts, (0, n), torch.bool), is_diff)

    def shade_cuda(self, tables, o, d, thr, alive, hit, shadowed, opts, *,
                   is_last, glass, radiance=None, plan=False):
        assert radiance is None and not glass
        return self.bounce(tables[0], o, d, thr, alive, hit, shadowed, opts,
                           is_last, plan)

    def adjoint_cuda(self, tables, o, d, thr, alive, hit, shadowed, opts,
                     g_terms, g_children, *, is_last, rays=(True,) * 3):
        tabs = list(tables[0])
        with torch.enable_grad():
            rays_in = [x.detach().requires_grad_() for x in (o, d, thr)]
            for j in SLOTS:
                if tabs[j] is not None:
                    tabs[j] = tabs[j].detach().requires_grad_()
            terms, child, _ = self.bounce(tabs, *rays_in, alive, hit,
                                          shadowed, opts, is_last, False)
            outs = [terms] + ([] if is_last else list(child[:3]))
            pairs = [(x, g) for x, g in zip(outs, (g_terms, *g_children))
                     if g is not None]
            wrt = rays_in + [tabs[j] for j in SLOTS if tabs[j] is not None]
            got = torch.autograd.grad([x for x, _ in pairs], wrt,
                                      [g for _, g in pairs],
                                      allow_unused=True)
        got = [torch.zeros_like(w) if g is None else g
               for w, g in zip(wrt, got)]
        by_slot = dict(zip([j for j in SLOTS if tabs[j] is not None],
                           got[3:]))
        def rows(*slots):  # the group's rows, K7's layout
            if slots[0] not in by_slot:
                return None
            return torch.cat([by_slot[j].reshape(by_slot[j].shape[0], -1)
                              for j in slots], 1).reshape(-1)

        vec = torch.cat([r for r in (rows(0, 1), rows(3, 4, 10),
                                     rows(20, 21, 22, 23, 24), rows(25, 26))
                         if r is not None])
        self.adjoints += 1
        return (*(g if want else None for g, want in zip(got[:3], rays)),
                vec)

    def patch(self, monkeypatch):
        for name in ("adjoint_shading", "surface_cuda", "shade_cuda",
                     "adjoint_cuda"):
            monkeypatch.setattr(BS, name, getattr(self, name))


def _step(scene, cam, opts, params, target, tracer=None):
    return value_and_grad_banded(with_params, params, scene, cam, opts,
                                 target, device="cpu", tracer=tracer)


@pytest.mark.parametrize("case", ["config2", "config4_mesh"])
@pytest.mark.parametrize("remat", ["none", "plan", "full"])
def test_recorded_plumbing(monkeypatch, case, remat):
    """A CPU training step through the Function (its launches played by
    the torch bounce, `Emulated`) equals the torch bounce's step: every
    recorded bounce took the Function, and its gradients land on the
    right leaves, through each remat policy's checkpoint."""
    kw = dict(remat_tiles=remat != "none",
              remat_policy="full" if remat == "full" else "plan")
    if case == "config2":
        scene, cam, opts = small_case(**kw)
        tracer = None
    else:
        scene, cam, opts = config4(32, 18, **kw)
        tracer = GridTracer.build(scene, "cpu")
    params = {"center": scene.spheres.center,
              "albedo": scene.materials.albedo}
    target = np.full((opts.height, opts.width, 3), 0.3, np.float32)
    want_l, want_g = _step(scene, cam, opts, params, target, tracer)
    emu = Emulated()
    emu.patch(monkeypatch)
    got_l, got_g = _step(scene, cam, opts, params, target, tracer)
    assert emu.adjoints >= 2
    assert bits_equal(got_l, want_l)
    for k in params:
        scale = float(want_g[k].abs().max())
        assert scale > 0
        assert float((got_g[k] - want_g[k]).abs().max()) <= 1e-5 * scale, k


def test_recorded_plumbing_every_table(monkeypatch):
    """Every table of K7's set, and a camera leaf through o and d, get the
    torch bounce's gradients through the Function."""
    scene, cam, opts = small_case(remat_tiles=False)
    dscene, dcam = scene.to("cpu"), cam.to("cpu")
    target = torch.full((9, 16, 3), 0.3)

    def grads():
        s, leaves = with_leaves(dscene)
        pos = dcam.pos.clone().requires_grad_()
        cam_l = dataclasses.replace(dcam, pos=pos)
        img = renderer.render(s, cam_l, opts, device="cpu")[0]
        loss = ((img - target) ** 2).sum()
        wrt = [*leaves.values(), pos]
        return dict(zip([*leaves, "camera.pos"],
                        torch.autograd.grad(loss, wrt, allow_unused=True)))

    want = grads()
    emu = Emulated()
    emu.patch(monkeypatch)
    got = grads()
    assert emu.adjoints >= 2
    assert set(got) == set(want) and len(got) == len(TABLES) + 1
    for k in want:
        w, g = want[k], got[k]
        assert (w is None) == (g is None), k
        if w is not None:
            tol = 1e-5 * max(float(w.abs().max()), 1e-12)
            assert float((g - w).abs().max()) <= tol, k


def test_recorded_plumbing_plan_planes(monkeypatch):
    """A differentiable render that records its plan: the Function's
    integer outputs (the plan planes) and its gradients equal the torch
    bounce's."""
    scene, cam, opts = small_case(remat_tiles=False)
    dscene, dcam = scene.to("cpu"), cam.to("cpu")

    def run():
        s, leaves = with_leaves(dscene)
        img, _, wins, occs = renderer.render(s, dcam, opts, device="cpu",
                                             record_plan=True)
        g = torch.autograd.grad(img.sum(), leaves["materials.albedo"])[0]
        return img.detach(), wins, occs, g

    want = run()
    emu = Emulated()
    emu.patch(monkeypatch)
    got = run()
    assert emu.adjoints == opts.max_depth + 1
    assert bits_equal(got[0], want[0])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        assert bits_equal(a, b)
    scale = float(want[3].abs().max())
    assert float((got[3] - want[3]).abs().max()) <= 1e-5 * scale


# --- on the card: K7 against torch.autograd of the torch bounce --------------

def bounce_outputs(scene, state, opts, tracer, is_last, k7):
    """One bounce of `state` → {output name: tensor}, through K6 + K7
    (`k7`) or the torch bounce."""
    n = state[0].shape[0]
    with contextlib.nullcontext() if k7 else torch_bounce():
        terms, child, _ = renderer.bounce_step(scene, state, opts, n,
                                               is_last, tracer=tracer)
    outs = {"miss": terms[0], "diffuse": terms[1]}
    if is_last:
        outs["leaf"] = terms[2]
    else:
        outs.update(child_o=child[0], child_d=child[1], child_thr=child[2])
    return outs


def bounce_grads(dscene, state, opts, tracer, is_last, k7, output, seed):
    """The gradients of ⟨`output`, a seeded cotangent⟩ for o, d, thr and
    K7's tables → {name: gradient}, zeros where none reaches."""
    scene, leaves = with_leaves(dscene)
    rays = {k: x.detach().clone().requires_grad_()
            for k, x in zip(("o", "d", "thr"), state[:3])}
    before = BS.adjoint_launches
    outs = bounce_outputs(scene, (*rays.values(), state[3]), opts, tracer,
                          is_last, k7)
    gen = torch.Generator(device=outs[output].device).manual_seed(seed)
    cot = torch.randn(outs[output].shape, generator=gen,
                      device=outs[output].device)
    wrt = {**rays, **leaves}
    got = torch.autograd.grad(outs[output], list(wrt.values()), cot,
                              allow_unused=True)
    torch.cuda.synchronize()
    assert BS.adjoint_launches - before == (2 * k7_windows(dscene) if k7
                                            else 0)
    return {k: torch.zeros_like(w) if g is None else g
            for (k, w), g in zip(wrt.items(), got)}


def k7_windows(dscene) -> int:
    """The windows of table floats K7 launches once each."""
    rows = ([4] * dscene.spheres.count + [9] * dscene.planes.count
            + [7] * dscene.materials.mtype.shape[0]
            + [6] * dscene.lights.count)
    return len(BS._windows(rows, BS.ADJ_WINDOW))


def assert_grads_close(tag, got, want):
    for k, w in want.items():
        g = got[k]
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert bool(torch.isfinite(g).all()), f"{tag} {k}: not finite"
        if k in ("o", "d", "thr"):
            ok = bool(((g - w).abs() <= LANE_RTOL * w.abs()
                       + LANE_ATOL * scale).all())
        else:
            ok = err <= TABLE_RTOL * scale
        assert ok, f"{tag} {k}: max |Δ| {err:.3g} of max {scale:.3g}"


def compare_bounce(dscene, state, opts, tracer, is_last):
    """Every output's VJP both ways (fresh leaves, the same cotangent)."""
    names = (["miss", "diffuse", "leaf"] if is_last else
             ["miss", "diffuse", "child_o", "child_d", "child_thr"])
    for i, name in enumerate(names):
        got = bounce_grads(dscene, state, opts, tracer, is_last, True, name,
                           i)
        want = bounce_grads(dscene, state, opts, tracer, is_last, False,
                            name, i)
        assert_grads_close(name, got, want)


class ClaimedSphere:
    """A tracer whose nearest search claims sphere 0 on every fourth lane,
    hit or not: the lanes whose recompute misses are demoted (a plan's
    knife edge)."""

    def __init__(self, inner):
        self.inner, self.device = inner, inner.device

    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        hit = self.inner.nearest(orig, direc, t_min, tri_chunk, active)
        claim = torch.arange(orig.shape[0], device=orig.device) % 4 == 0
        return Hit(kind=torch.where(claim, KIND_SPHERE, hit.kind),
                   idx=torch.where(claim, 0, hit.idx), t=hit.t)

    def occluded(self, *a, **k):
        return self.inner.occluded(*a, **k)


def wavefront(scene, cam, opts, tracer, depth):
    """The state bounce `depth` of the frame shades (its children chain
    through K6 under no_grad) → (device scene, state)."""
    dscene, dcam = scene.to("cuda"), cam.to("cuda")
    dirs = renderer.tile_dirs(dcam, opts, 0, opts.height)[0]
    n = dirs.shape[0]
    state = (dcam.pos[None].expand(n, 3).contiguous(), dirs,
             torch.ones((n, 3), device="cuda"),
             torch.ones((n,), dtype=torch.bool, device="cuda"))
    with torch.no_grad():
        for _ in range(depth):
            _, state, _ = renderer.bounce_step(dscene, state, opts, n, False,
                                               tracer=tracer)
    return dscene, state


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("case", ["bounce0", "bounce1", "last", "zero_thr",
                                  "dead", "knife_edge"])
def test_config4_lanes(case):
    """config4 at 480×270: its primaries (misses, the mesh's and the
    floor's diffuse hits, the mirror), the mirror's children, a last
    bounce, lanes of zero throughput, dead lanes, demoted lanes."""
    scene, cam, opts = config4(480, 270)
    tracer = GridTracer.build(scene, "cuda")
    dscene, state = wavefront(scene, cam, opts, tracer,
                              1 if case == "bounce1" else 0)
    o, d, thr, alive = state
    n = o.shape[0]
    every3 = torch.arange(n, device="cuda") % 3 == 0
    if case == "zero_thr":
        thr = torch.where(every3[:, None], 0.0, thr)
    elif case == "dead":
        alive = alive & ~every3
    elif case == "knife_edge":
        tracer = ClaimedSphere(tracer)
        with torch.no_grad():
            hit = tracer.nearest(o, d, opts.t_min, 4096)
            surf = surface_at(dscene, o, d, hit, opts.t_min)
        assert int(((hit.kind == KIND_SPHERE) & ~surf.valid).sum()) > 100
    compare_bounce(dscene, (o, d, thr, alive), opts, tracer,
                   is_last=case == "last")


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("depth", [0, 1])
def test_config5_wavefront(depth):
    """config5's mesh-free scene (diffuse spheres, a checker plane) at
    256×256, the dense search."""
    scene, _, cam, opts = presets.config5_inverse()
    opts = dataclasses.replace(opts, width=256, height=256,
                               tile_rays=256 * 256)
    dscene, state = wavefront(scene, cam, opts, None, depth)
    compare_bounce(dscene, state, opts, None, is_last=False)
    compare_bounce(dscene, state, opts, None, is_last=True)


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("depth", [0, 1])
def test_many_spheres_windows(depth):
    """48 spheres (every fourth a mirror), each with its own material:
    543 table floats, two of K7's windows."""
    scene, cam, opts = presets.many_spheres(48, 256, 192)
    opts = dataclasses.replace(opts, tile_rays=256 * 192)
    dscene, state = wavefront(scene, cam, opts, None, depth)
    assert k7_windows(dscene) == 2
    compare_bounce(dscene, state, opts, None, is_last=depth == 1)


def step(scene, cam, opts, tracer, target, k7):
    """A `value_and_grad_banded` step for the centers and the albedos →
    (loss, grads, K7 launches)."""
    p = {"center": scene.spheres.center, "albedo": scene.materials.albedo}
    BS.adjoint_launches = 0
    with contextlib.nullcontext() if k7 else torch_bounce():
        loss, g = value_and_grad_banded(with_params, p, scene, cam, opts,
                                        target, device="cuda", tracer=tracer)
    torch.cuda.synchronize()
    return loss, g, BS.adjoint_launches


@pytest.mark.cuda
@NEEDS_GPU
@pytest.mark.parametrize("policy", ["plan", "full"])
def test_step_against_torch_replay(policy):
    """A config4 training step at 480×270 d4 through K7 and through the
    torch bounce: the loss bit for bit (K6's forward is the torch bounce's),
    the gradients within the tables' tolerance; K7 ran on both bounces;
    two runs bit for bit."""
    scene, cam, opts = config4(480, 270, remat_tiles=True,
                               remat_policy=policy)
    tracer = GridTracer.build(scene, "cuda")
    with torch.no_grad():
        target = renderer.render(scene, cam, opts, device="cuda",
                                 tracer=tracer)[0] * 0.9
    loss, g, launches = step(scene, cam, opts, tracer, target, True)
    want_l, want_g, none = step(scene, cam, opts, tracer, target, False)
    assert launches == 4 and none == 0, (launches, none)
    assert bits_equal(loss, want_l), (float(loss), float(want_l))
    for k in g:
        scale = float(want_g[k].abs().max())
        err = float((g[k] - want_g[k]).abs().max())
        assert scale > 0 and err <= TABLE_RTOL * scale, (k, err, scale)
    loss2, g2, _ = step(scene, cam, opts, tracer, target, True)
    assert bits_equal(loss2, loss)
    assert all(bits_equal(g2[k], g[k]) for k in g)
