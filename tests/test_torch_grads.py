"""PyTorch port: gradients of the wavefront render against `jax.grad` of
the JAX renderer (tests/test_grads.py's parameter classes and scenes),
central differences in the port, the banded value-and-grad, the
remat policies, and the differentiable pieces it is built from (`pgather`,
`vertex_normals_torch`).

Each JAX reference is computed once per module.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.accel.grid import GridTracer as RefGridTracer
from raytracer_tpu.io.meshgen import vertex_normals_jnp
from raytracer_tpu.models import presets as jpresets
from raytracer_tpu import renderer as jrenderer
from raytracer_tpu.renderer import render as jrender
from raytracer_tpu_torch.accel.grid import GridTracer
from raytracer_tpu_torch.io.meshgen import icosphere, vertex_normals_torch
from raytracer_tpu_torch.models import presets
from raytracer_tpu_torch.ops.dgather import pgather, tselect
from raytracer_tpu_torch.renderer import (as_leaf, render,
                                          value_and_grad_banded)
from tests.test_grads import PARAMS, RES
from tests.torch_cases import port, subdiv3_config4

torch.set_num_threads(2)

# port vs jax.grad on the same scene: both recompute the same shading, in
# f32, but XLA:CPU contracts multiply-adds into FMAs and torch rounds every
# op, so the two part at the few-ulp level of each term
GRAD_TOL = 2e-4  # × each gradient's largest entry


def _set(scene, group, field, value):
    return scene.replace(**{group: dataclasses.replace(
        getattr(scene, group), **{field: value})})


def _rel(have, want):
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(have, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# --------------------------------------------------------------------------
# config5 at 32²: tests/test_grads.py's parameter classes

@pytest.fixture(scope="module")
def inverse():
    """jax.grad and the port's autograd of the pixel loss, every class of
    PARAMS at once. (tests/test_grads.py's edge mask keeps no sphere pixel
    at this size — its gradients there are exactly 0 — so the loss here is
    unmasked.)"""
    init, target, cam, opts = jpresets.config5_inverse()
    opts = dataclasses.replace(opts, width=RES, height=RES)
    timg = jrender(target, cam, opts)[0]
    leaves = {(g, f): jnp.asarray(getattr(getattr(init, g), f))
              for g, f, _, _ in PARAMS}

    def jloss(vals):
        s = init
        for (g, f), v in vals.items():
            s = _set(s, g, f, v)
        return jnp.mean((jrender(s, cam, opts)[0] - timg) ** 2)

    want = jax.grad(jloss)(leaves)
    pinit, pcam, popts = port(init, cam, opts)
    tleaves = {k: as_leaf(v, "cpu") for k, v in leaves.items()}
    tim = torch.from_numpy(np.array(timg))

    def frame(vals, record=False):
        s = pinit.to("cpu")
        for (g, f), v in vals.items():
            s = _set(s, g, f, v)
        return render(s, pcam, popts, device="cpu", record_plan=record)

    loss = ((frame(tleaves)[0] - tim) ** 2).mean()
    have = dict(zip(tleaves, torch.autograd.grad(loss,
                                                 list(tleaves.values()))))
    return want, have, frame, tleaves, tim


@pytest.mark.parametrize("group,field,eps,rtol", PARAMS,
                         ids=[f"{g}.{f}" for g, f, _, _ in PARAMS])
def test_grad_matches_jax(inverse, group, field, eps, rtol):
    want, have, _, _, _ = inverse
    w, h = np.asarray(want[(group, field)]), have[(group, field)].numpy()
    assert np.isfinite(h).all() and np.abs(w).max() > 0
    assert _rel(h, w) <= GRAD_TOL, (group, field, _rel(h, w))


def _plan(out):
    """A recorded plan → [pixels, 2·bounces] (winners, shadow bits)."""
    return torch.stack(list(out[2]) + list(out[3]), dim=1)


@pytest.mark.parametrize("group,field,eps,rtol", PARAMS,
                         ids=[f"{g}.{f}" for g, f, _, _ in PARAMS])
def test_grad_matches_finite_diff(inverse, group, field, eps, rtol):
    """Central differences in the port, at tests/test_grads.py's probes and
    tolerances, of Σ keep·(img − target)²: `keep` drops the pixels whose
    plan (winner or shadow bit) flips between the probes, where autograd's
    gradient is zero by design."""
    _, _, frame, leaves, tim = inverse
    vals = {k: v.detach() for k, v in leaves.items()}
    x0 = vals[(group, field)]
    with torch.no_grad():
        base = _plan(frame(vals, record=True))
    rng = np.random.default_rng(0)
    picks = rng.choice(x0.numel(), size=min(4, x0.numel()), replace=False)
    for k in picks:
        imgs, keep = [], (base >= -1).all(dim=1)
        for sign in (1.0, -1.0):
            x = x0.clone().reshape(-1)
            x[k] += sign * eps
            with torch.no_grad():
                out = frame({**vals, (group, field): x.reshape(x0.shape)},
                            record=True)
            imgs.append(out[0].double())
            keep &= (_plan(out) == base).all(dim=1)
        keep = keep.reshape(RES, RES, 1)
        t64 = tim.double()
        fd = float(((((imgs[0] - t64) ** 2) - ((imgs[1] - t64) ** 2))
                    * keep).sum()) / (2 * eps)
        leaf = as_leaf(x0, "cpu")
        with torch.enable_grad():
            img = frame({**vals, (group, field): leaf})[0]
            g = torch.autograd.grad((((img - tim) ** 2) * keep).sum(),
                                    leaf)[0]
        ad = float(g.reshape(-1)[k])
        assert ad == pytest.approx(fd, rel=rtol, abs=5e-5), (group, field, k)
        assert bool(keep.any())


# --------------------------------------------------------------------------
# triangle vertices, the camera, the uv checker's albedo2

def _triangle_scene():
    from raytracer_tpu.core.types import (Camera as JCamera, Lights,
                                          Materials, Meshes, RenderOptions,
                                          make_scene)

    verts = np.array([[-1.5, -1.0, -4.0], [1.5, -1.0, -4.0],
                      [0.0, 1.4, -4.2]], np.float32)
    scene = make_scene(
        meshes=Meshes.build(verts, np.array([[0, 1, 2]], np.int32), [0]),
        materials=Materials.build([0], [(0.6, 0.3, 0.2)], [0.8], [0.1],
                                  [25.0], [1.3]),
        lights=Lights.build([(0.0, 4.0, 0.0)], [(1.0, 1.0, 1.0)]))
    return scene, JCamera.build(fov_deg=60.0), RenderOptions(
        width=RES, height=RES, max_depth=0)


def _verts_case():
    scene, cam, opts = _triangle_scene()

    def jloss(v):
        img = jrender(_set(scene, "meshes", "verts", v), cam, opts)[0]
        return jnp.mean((img - 0.3) ** 2)

    ps, pc, po = port(scene, cam, opts)

    def tloss(v):
        img = render(_set(ps.to("cpu"), "meshes", "verts", v), pc, po,
                     device="cpu")[0]
        return ((img - 0.3) ** 2).mean()

    return jnp.asarray(scene.meshes.verts), jloss, tloss, [(2, 2)], 0.08, 5e-5


def _camera_case():
    init, target, cam, opts = jpresets.config5_inverse()
    opts = dataclasses.replace(opts, width=RES, height=RES)
    timg = jrender(target, cam, opts)[0]

    def jloss(fov):
        c = dataclasses.replace(cam, fov_deg=fov)
        return jnp.mean((jrender(init, c, opts)[0] - timg) ** 2)

    ps, pc, po = port(init, cam, opts)
    tim = torch.from_numpy(np.array(timg))

    def tloss(fov):
        c = dataclasses.replace(pc.to("cpu"), fov_deg=fov)
        return ((render(ps, c, po, device="cpu")[0] - tim) ** 2).mean()

    return jnp.asarray(cam.fov_deg), jloss, tloss, [()], 0.05, 5e-5


def _albedo2_case():
    scene, cam, opts = jpresets.config7_uv_quad()
    opts = dataclasses.replace(opts, width=RES, height=RES, max_depth=0)

    def jloss(a2):
        img = jrender(_set(scene, "meshes", "albedo2", a2), cam, opts)[0]
        return jnp.mean((img - 0.25) ** 2)

    ps, pc, po = port(scene, cam, opts)

    def tloss(a2):
        img = render(_set(ps.to("cpu"), "meshes", "albedo2", a2), pc, po,
                     device="cpu")[0]
        return ((img - 0.25) ** 2).mean()

    return (jnp.asarray(scene.meshes.albedo2), jloss, tloss, [(0, 0), (1, 1)],
            0.02, 5e-6)


@pytest.mark.parametrize("case", ["verts", "camera_fov", "albedo2"])
def test_grad_param_class_matches_jax_and_finite_diff(case):
    x0, jloss, tloss, probes, rtol, atol = {
        "verts": _verts_case, "camera_fov": _camera_case,
        "albedo2": _albedo2_case}[case]()
    want = np.asarray(jax.grad(jloss)(x0), np.float64)
    leaf = as_leaf(x0, "cpu")
    have = torch.autograd.grad(tloss(leaf), leaf)[0].numpy()
    assert np.isfinite(have).all() and np.abs(want).max() > 0
    assert _rel(have, want) <= GRAD_TOL, _rel(have, want)
    eps = 1e-3
    with torch.no_grad():
        for k in probes:
            hi, lo = leaf.detach().clone(), leaf.detach().clone()
            hi[k] += eps
            lo[k] -= eps
            fd = (float(tloss(hi)) - float(tloss(lo))) / (2 * eps)
            assert float(have[k]) == pytest.approx(fd, rel=rtol, abs=atol), k


# --------------------------------------------------------------------------
# banded value-and-grad on a mesh scene

def _with_params(scene, p):
    return scene.replace(
        spheres=dataclasses.replace(scene.spheres, center=p["center"]),
        materials=dataclasses.replace(scene.materials, albedo=p["albedo"]))


@pytest.fixture(scope="module")
def mesh_vg():
    """JAX's band value-and-grad over the whole frame, run op by op
    (`_band_vg` unjitted). Jitted, XLA:CPU fuses this mirror-sphere scene's
    recompute into a program whose loss parts from its own op-by-op run by
    1.1e-4 relative (the mirror's center gradient by a third); the op-by-op
    run equals numpy's L2 of the rendered image, and the port's to 4e-7."""
    scene, cam, opts = subdiv3_config4()
    tracer = RefGridTracer.build(scene)
    target = np.asarray(jrender(scene, cam, opts, tracer=tracer)[0]) \
        * np.float32(0.9)
    p0 = {"center": np.asarray(scene.spheres.center),
          "albedo": np.asarray(scene.materials.albedo)}
    jv, jg = jrenderer._band_vg.__wrapped__(
        {k: jnp.asarray(v) for k, v in p0.items()}, scene, cam, tracer,
        jnp.asarray(target), 0, apply_params=_with_params, opts=opts,
        rows=opts.height)
    ps, pc, po = port(scene, cam, opts)
    return (float(jv), {k: np.asarray(v) for k, v in jg.items()}, ps, pc, po,
            GridTracer.build(ps, "cpu"), target, p0)


def test_value_and_grad_banded_matches_jax(mesh_vg):
    jv, jg, ps, pc, po, tracer, target, p0 = mesh_vg
    v, g = value_and_grad_banded(_with_params, p0, ps, pc, po, target,
                                 device="cpu", tracer=tracer, band_rows=16)
    np.testing.assert_allclose(float(v), jv, rtol=1e-5)
    for k in jg:
        assert _rel(g[k].numpy(), jg[k]) <= GRAD_TOL, (k, _rel(g[k], jg[k]))


def test_value_and_grad_banded_matches_whole_frame(mesh_vg):
    _, _, ps, pc, po, tracer, target, p0 = mesh_vg
    v_full, g_full = value_and_grad_banded(_with_params, p0, ps, pc, po,
                                           target, device="cpu",
                                           tracer=tracer)
    v_band, g_band = value_and_grad_banded(_with_params, p0, ps, pc, po,
                                           target, device="cpu",
                                           tracer=tracer, band_rows=13)
    np.testing.assert_allclose(float(v_band), float(v_full), rtol=1e-5)
    for k in g_full:
        np.testing.assert_allclose(g_band[k].numpy(), g_full[k].numpy(),
                                   rtol=1e-4, atol=1e-7, err_msg=k)


# --------------------------------------------------------------------------
# remat policies (tests/test_plan_remat.py in the port alone)

def _scene_grads(name, policy, remat=True):
    scene, cam, opts = presets.PRESETS[name]()
    opts = dataclasses.replace(opts, width=48, height=48, tile_rays=768,
                               remat_policy=policy, remat_tiles=remat)
    tracer = GridTracer.build(scene, "cpu") if scene.meshes.count else None
    dscene = scene.to("cpu")
    leaves = {}
    for group in ("spheres", "planes", "meshes", "materials", "lights"):
        table = getattr(dscene, group)
        for f in dataclasses.fields(table):
            x = getattr(table, f.name)
            if x.is_floating_point() and x.numel():
                leaves[(group, f.name)] = as_leaf(x, "cpu")
    s = dscene
    for (g, f), v in leaves.items():
        s = _set(s, g, f, v)
    img, _ = render(s, cam, opts, device="cpu", tracer=tracer)
    loss = (img ** 2).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return float(loss.detach()), {k: (torch.zeros_like(v) if g is None else g)
                         for (k, v), g in zip(leaves.items(), grads)}


@pytest.mark.parametrize("name", ["config2", "config3", "config4"])
def test_plan_remat_matches_full_and_noremat(name):
    lp, gp = _scene_grads(name, "plan")
    lf, gf = _scene_grads(name, "full")
    lo, go = _scene_grads(name, "plan", remat=False)
    assert lp == lf == lo
    assert any(float(g.abs().max()) > 0 for g in gp.values())
    for k in gp:
        a, b, c = gp[k], gf[k], go[k]
        scale = float(a.abs().max()) + 1e-6
        assert float((a - b).abs().max()) <= 1e-5 * scale + 1e-6, k
        assert float((a - c).abs().max()) <= 2e-3 * scale + 1e-6, k


def test_render_without_grad_leaves_builds_no_graph():
    scene, cam, opts = presets.PRESETS["config2"]()
    opts = dataclasses.replace(opts, width=24, height=24)
    img, traced = render(scene, cam, opts, device="cpu", count_rays=True)
    assert not img.requires_grad and img.grad_fn is None
    assert not traced.requires_grad


def test_remat_policy_must_be_known():
    scene, cam, opts = presets.PRESETS["config1"]()
    opts = dataclasses.replace(opts, width=8, height=8, remat_policy="none")
    with pytest.raises(ValueError):
        render(scene, cam, opts, device="cpu")


# --------------------------------------------------------------------------
# pgather / tselect and vertex_normals_torch

@pytest.mark.parametrize("k,cols", [(3, 3), (16, 3), (5, None), (100, 3)])
def test_pgather_matches_indexing(k, cols):
    rng = np.random.default_rng(k)
    shape = (k,) if cols is None else (k, cols)
    table = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, k, 257).astype(np.int32))
    ct = torch.from_numpy(rng.standard_normal(
        (257,) + shape[1:]).astype(np.float32))
    a, b = table.clone().requires_grad_(True), table.clone().requires_grad_(
        True)
    ya, yb = pgather(a, idx), b[idx]
    assert torch.equal(ya, yb)  # forward: the same values
    (ga,), (gb,) = (torch.autograd.grad(y, x, ct) for y, x in ((ya, a),
                                                                (yb, b)))
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-5, atol=1e-5)
    ints = torch.from_numpy(rng.integers(0, 3, k).astype(np.int32))
    assert torch.equal(tselect(ints, idx), ints[idx])


@pytest.fixture(scope="module")
def ico():
    verts, tris = icosphere(subdiv=2, radius=1.2)
    rng = np.random.default_rng(7)
    verts = (verts + 0.05 * rng.standard_normal(verts.shape)).astype(
        np.float32)
    ct = rng.standard_normal(verts.shape).astype(np.float32)
    return verts, tris, ct


def test_vertex_normals_torch_matches_jnp(ico):
    verts, tris, ct = ico
    want, vjp = jax.vjp(lambda v: vertex_normals_jnp(v, jnp.asarray(tris)),
                        jnp.asarray(verts))
    (gwant,) = vjp(jnp.asarray(ct))
    v = as_leaf(verts, "cpu")
    have = vertex_normals_torch(v, torch.from_numpy(tris))
    (ghave,) = torch.autograd.grad(have, v, torch.from_numpy(ct))
    np.testing.assert_allclose(have.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert _rel(ghave.numpy(), gwant) <= GRAD_TOL, _rel(ghave, gwant)


def test_vertex_normals_torch_keeps_a_zero_sum():
    # a vertex no triangle uses sums to zero and keeps it (÷ 1), as JAX's
    verts = torch.tensor([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [5, 5, 5]])
    n = vertex_normals_torch(verts, torch.tensor([[0, 1, 2]]))
    assert torch.equal(n[3], torch.zeros(3))
    np.testing.assert_allclose(n[:3].numpy(), [[0, 0, 1]] * 3)
    want = np.asarray(vertex_normals_jnp(jnp.asarray(verts.numpy()),
                                         jnp.asarray([[0, 1, 2]])))
    np.testing.assert_allclose(n.numpy(), want)



@pytest.mark.parametrize("kind", ["sphere", "plane"])
def test_demoted_hit_keeps_gradients_finite(kind):
    """A claimed hit whose recompute misses (a plan's knife edge) is a miss
    in the forward, and its lane's zero cotangents meet no inf in the
    backward. Before surface_at kept the demoted lane's t finite, a
    sphere's normal there was inf and fresnel's dot product made the scene
    gradients NaN (config3 1024² d4 glass); the plane case holds a plane's
    demoted lane to the same."""
    from raytracer_tpu_torch.core.types import KIND_PLANE, KIND_SPHERE
    from raytracer_tpu_torch.ops import geometry as geom
    from raytracer_tpu_torch.ops.trace import Hit, surface_at

    scene = presets.PRESETS["config2"]()[0].to("cpu")
    c = as_leaf(scene.spheres.center, "cpu")
    pt = as_leaf(scene.planes.point, "cpu")
    sc = scene.replace(
        spheres=dataclasses.replace(scene.spheres, center=c),
        planes=dataclasses.replace(scene.planes, point=pt))
    # lane 0 hits sphere 0 / plane 0; lane 1 is claimed to but misses
    # (a ray away from the sphere; parallel to the plane)
    o = torch.zeros((2, 3))
    if kind == "sphere":
        d = torch.stack([(c[0] / c[0].norm()).detach(),
                         -(c[0] / c[0].norm()).detach()])
        k = KIND_SPHERE
    else:
        n = scene.planes.normal[0]
        tang = scene.planes.tangent[0]
        d = torch.stack([-n, tang])
        o = (pt[0] + n).detach().expand(2, 3).contiguous()
        k = KIND_PLANE
    hit = Hit(kind=torch.full((2,), k, dtype=torch.int32),
              idx=torch.zeros((2,), dtype=torch.int32),
              t=torch.ones((2,)))
    surf = surface_at(sc, o, d, hit, 1e-4)
    assert surf.valid.tolist() == [True, False]
    assert bool(torch.isfinite(surf.n).all() and torch.isfinite(surf.p).all()
                and torch.isfinite(surf.albedo).all())
    kr = geom.fresnel(d, surf.n, surf.ior)
    loss = (torch.where(surf.valid, kr, 0.0)
            + torch.where(surf.valid[:, None], surf.albedo, 0.0).sum(-1)
            + torch.where(surf.valid[:, None], surf.p, 0.0).sum(-1)).sum()
    gc, gp = torch.autograd.grad(loss, [c, pt])
    assert bool(torch.isfinite(gc).all() and torch.isfinite(gp).all())
    assert float(gc.abs().max() + gp.abs().max()) > 0
