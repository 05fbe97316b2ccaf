"""Local Phong shading with shadow rays (docs/SPEC.md DIFFUSE_AND_GLOSSY
branch); counterpart of `raytracer_tpu/ops/shade.py`.

Genre-exact quirks kept: specular is not shadow-masked and not multiplied by
albedo; shadow rays test all objects including transparent ones.
"""

import torch

from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.ops import trace as trace_ops
from raytracer_tpu_torch.ops.geometry import reflect
from raytracer_tpu_torch.ops.safemath import dot, maximum, safe_pow, safe_sqrt


def shade_diffuse(scene: Scene, surf, in_dir, bias: float, t_min: float,
                  tri_chunk: int, tracer=None, active=None):
    """Phong local radiance [N,3] for rays hitting diffuse/glossy surfaces.

    Computed for *all* rays (branchless); the caller masks by material type.
    `tracer` overrides the occlusion backend. `active` [N] bool marks the
    lanes whose result the caller keeps; walk-based backends park the others.
    Returns rgb [N,3]. (The reference also returns a shadow-ray count that
    its renderer discards; the renderer counts shadow rays itself.)
    """
    p, n = surf.p, surf.n
    # shadow origin: + bias·N when the viewing ray hits the front face (SPEC)
    front = (dot(in_dir, n) < 0).to(torch.float32)
    sorig = p + (2.0 * front - 1.0)[:, None] * bias * n

    light_amt = torch.zeros_like(p)
    spec = torch.zeros_like(p)
    for li in range(scene.lights.count):
        lpos = scene.lights.pos[li]
        lint = scene.lights.intensity[li]
        lvec = lpos[None, :] - p
        d2 = dot(lvec, lvec)
        dist = safe_sqrt(d2, valid=d2 > 0)
        ldir = lvec / maximum(dist, 1e-12)[:, None]
        ldn = maximum(dot(ldir, n), 0.0)
        # lanes facing away from the light (ldn == 0) park their shadow walk:
        # the occlusion bit only ever enters as vis·ldn, so masking them is
        # exact and roughly halves the walk's live set on curved geometry
        lit = (ldn > 0).detach()
        oactive = lit if active is None else (active & lit)
        if tracer is None:
            shadowed = trace_ops.occluded(scene, sorig, ldir, dist, t_min,
                                          tri_chunk, active=oactive)
        else:
            shadowed = tracer.occluded(sorig, ldir, dist, t_min, tri_chunk,
                                       active=oactive)
        vis = (~shadowed).to(torch.float32)
        light_amt = light_amt + (vis * ldn)[:, None] * lint[None, :]
        r = reflect(-ldir, n)
        spec = spec + safe_pow(-dot(r, in_dir), surf.spec_n)[:, None] * lint[None, :]
    rgb = light_amt * surf.albedo * surf.kd[:, None] + spec * surf.ks[:, None]
    return rgb
