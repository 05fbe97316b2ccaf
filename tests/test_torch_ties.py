"""PyTorch port: gradients at exact ties against jax.grad of the JAX
package's functions, on the same numpy inputs.

The reference's `jnp.maximum` and `jnp.clip` send half the gradient to each
side when the operands are equal, and `jnp.abs` has slope 1 at 0. Each case
puts some lanes exactly on such a tie (a radiance of exactly 0 or 1,
cos θ = ±1 or 0, ldn = 0, a squared distance of exactly 1e-12, a pow base
of exactly 1e-7) beside ordinary lanes, and holds torch autograd of Σ out·cot
to jax.grad of the same sum. A gradient that took the whole slope at a tie
would be off by a factor of 2 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracer_tpu.core.types import Lights
from raytracer_tpu.models import presets as ref_presets
from raytracer_tpu.ops import geometry as rgeom
from raytracer_tpu.ops import safemath as rsm
from raytracer_tpu.ops import shade as rshade
from raytracer_tpu.ops import trace as rtrace
from raytracer_tpu_torch.core.types import scene_from_arrays
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops import safemath as sm
from raytracer_tpu_torch.ops import shade, trace

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
F32 = np.float32


def _f32(*rows):
    return np.asarray(rows, F32)


def _grads(jfn, tfn, args, seed=0):
    """(jax.grad, torch autograd) of Σ out·cot w.r.t. every argument."""
    rng = np.random.default_rng(seed)
    out = np.asarray(jfn(*[jnp.asarray(a) for a in args]))
    cot = rng.uniform(0.5, 1.5, out.shape).astype(F32)
    want = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot),
                    argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True) for a in args]
    got = tfn(*leaves)
    np.testing.assert_allclose(got.detach().numpy(), out, rtol=RTOL,
                               atol=ATOL)
    have = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), leaves)
    return [np.asarray(w) for w in want], [h.numpy() for h in have]


def _incident():
    """Normals on the axes, so that cos θ = ±1 and 0 are exact in f32:
    i = −n, i = n, i ⟂ n, and three ordinary directions."""
    n = _f32((0, 1, 0), (0, 1, 0), (0, 1, 0), (1, 0, 0), (0, 0, -1),
             (0, 1, 0))
    i = _f32((0, -1, 0), (0, 1, 0), (1, 0, 0), (0.6, -0.8, 0.0),
             (0.28, 0.0, 0.96), (0.0, -0.6, 0.8))
    return i, n


def _case(name):
    """→ (JAX function, torch function, numpy arguments)."""
    if name == "safe_sqrt":
        return (rsm.safe_sqrt, sm.safe_sqrt,
                [_f32(1e-12, 4.0, 2.5e-3, 1e-12)])
    if name == "norm":
        # f32(1e-6)² is exactly f32(1e-12)
        return (rsm.norm, sm.norm, [_f32((1e-6, 0, 0), (0.3, -2, 1),
                                         (0, 0, 1e-6))])
    if name == "safe_pow":
        return (rsm.safe_pow, sm.safe_pow,
                [_f32(1e-7, 0.5, -0.3, 1e-7), _f32(1, 25, 10, 0.5)])
    if name == "clamp01":
        return (rsm.clamp01, sm.clamp01, [_f32(0, 1, 0.5, -0.2, 1.3, 1)])
    i, n = _incident()
    ior = _f32(1.5, 1.3, 1.4, 1.5, 2.0, 1.1)
    if name == "refract":
        return (lambda *a: rgeom.refract(*a)[0],
                lambda *a: geom.refract(*a)[0], [i, n, ior])
    if name == "fresnel":
        return rgeom.fresnel, geom.fresnel, [i, n, ior]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["safe_sqrt", "norm", "safe_pow", "clamp01",
                                  "refract", "fresnel"])
def test_tie_gradients_match_jax(name):
    jfn, tfn, args = _case(name)
    want, have = _grads(jfn, tfn, args)
    for k, (w, h) in enumerate(zip(want, have)):
        np.testing.assert_allclose(h, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name}: argument {k}")


def _shade_case():
    """config1's sphere and plane under two lights placed so that lane 0
    sees light 0 exactly in its tangent plane (ldn = 0) and lane 1 sits at a
    squared distance of exactly 1e-12 from light 1; lane 2 is ordinary."""
    scene, _, opts = ref_presets.config1_sphere_plane()
    a = F32(1e-6)
    p = _f32((4, 0, -3), (0, 1, -8), (-3, -1, -4))
    n = _f32((0, 1, 0), (0, 0, 1), (0.6, 0.8, 0))
    lights = Lights.build([(9.0, 0.0, -3.0), (a, 1.0, -8.0)],
                          [(0.9, 0.8, 0.7), (0.5, 0.6, 0.4)])
    scene = scene.replace(lights=lights)
    d = _f32((-0.6, 0.0, -0.8), (0.0, -0.6, -0.8), (0.36, -0.48, -0.8))
    albedo = _f32((0.6, 0.25, 0.2), (0.5, 0.5, 0.5), (0.3, 0.7, 0.1))
    kd, ks, spec_n = _f32(0.8, 0.7, 0.9), _f32(0.2, 0.3, 0.1), _f32(25, 10, 60)
    return scene, opts, [p, n, d, albedo, kd, ks, spec_n]


def test_shade_diffuse_tie_gradients_match_jax():
    scene, opts, args = _shade_case()
    pscene = scene_from_arrays(scene).to("cpu")
    m = args[0].shape[0]
    fixed = dict(valid=np.ones(m, bool), t=np.ones(m, F32),
                 mtype=np.zeros(m, np.int32), ior=np.full(m, 1.3, F32))

    def jfn(p, n, d, albedo, kd, ks, spec_n):
        surf = rtrace.Surface(p=p, n=n, albedo=albedo, kd=kd, ks=ks,
                              spec_n=spec_n,
                              **{k: jnp.asarray(v) for k, v in fixed.items()})
        return rshade.shade_diffuse(scene, surf, d, opts.bias, opts.t_min,
                                    opts.tri_chunk)[0]

    def tfn(p, n, d, albedo, kd, ks, spec_n):
        surf = trace.Surface(p=p, n=n, albedo=albedo, kd=kd, ks=ks,
                             spec_n=spec_n,
                             **{k: torch.from_numpy(v)
                                for k, v in fixed.items()})
        return shade.shade_diffuse(pscene, surf, d, opts.bias, opts.t_min,
                                   opts.tri_chunk)[0]

    want, have = _grads(jfn, tfn, args)
    names = ("p", "n", "in_dir", "albedo", "kd", "ks", "spec_n")
    for name, w, h in zip(names, want, have):
        np.testing.assert_allclose(h, w, rtol=RTOL, atol=ATOL, err_msg=name)
