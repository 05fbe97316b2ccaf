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
from raytracer_tpu_torch.utils.profiling import span

# The occlusion bitmask packs one bit per light into an int32.
MAX_PLAN_LIGHTS = 32


def check_plan_lights(scene: Scene) -> None:
    """Raise ValueError unless the scene's lights fit the occlusion
    bitmask of a recorded plan."""
    if scene.lights.count > MAX_PLAN_LIGHTS:
        raise ValueError("the occlusion bitmask packs into int32: at most "
                         f"{MAX_PLAN_LIGHTS} lights, got "
                         f"{scene.lights.count}")


def shadow_search(scene: Scene, tracer, so, sd, sm, t_min: float,
                  tri_chunk: int, active):
    """One light's shadow search (`rt.shadow`, under no_grad): occluded
    below `sm` along `sd` from `so` → bool [N], by `tracer` or, when it is
    None, the dense search over `scene`. `active` marks the lanes whose
    bit the caller keeps."""
    with torch.no_grad(), span("rt.shadow"):
        if tracer is None:
            return trace_ops.occluded(scene, so, sd, sm, t_min, tri_chunk,
                                      active=active)
        return tracer.occluded(so, sd, sm, t_min, tri_chunk, active=active)


def shade_diffuse(scene: Scene, surf, in_dir, bias: float, t_min: float,
                  tri_chunk: int, tracer=None, active=None,
                  occ_out: list | None = None):
    """Phong local radiance [N,3] for rays hitting diffuse/glossy surfaces.

    Computed for *all* rays (branchless); the caller masks by material type.
    `tracer` overrides the occlusion backend. `active` [N] bool marks the
    lanes whose result the caller keeps; walk-based backends park the others.
    `occ_out` (a list) receives this bounce's per-light occlusion bitmask
    [N] i32 (bit l set = light l occluded; ≤32 lights): the plan encoding
    that ops/replay.PlanTracer reads back. The shadow searches run under
    `torch.no_grad()` on detached rays, each light's in an `rt.shadow` span.
    Returns (rgb [N,3], [each light's [N] bool mask of the lanes its shadow
    search answers]), the masks for the renderer's lane counts. (The
    reference returns a shadow-ray count there, which its renderer
    discards.)
    """
    if occ_out is not None:
        check_plan_lights(scene)
        occ_acc = torch.zeros(surf.p.shape[:1], dtype=torch.int32,
                              device=surf.p.device)
    p, n = surf.p, surf.n
    # shadow origin: + bias·N when the viewing ray hits the front face (SPEC)
    front = (dot(in_dir, n) < 0).to(torch.float32)
    sorig = p + (2.0 * front - 1.0)[:, None] * bias * n

    light_amt = torch.zeros_like(p)
    spec = torch.zeros_like(p)
    searched = []
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
        searched.append(oactive)
        shadowed = shadow_search(scene, tracer, sorig.detach(), ldir.detach(),
                                 dist.detach(), t_min, tri_chunk, oactive)
        if occ_out is not None:
            occ_acc = occ_acc | (shadowed.to(torch.int32) << li)
        vis = (~shadowed).to(torch.float32)
        light_amt = light_amt + (vis * ldn)[:, None] * lint[None, :]
        r = reflect(-ldir, n)
        spec = spec + safe_pow(-dot(r, in_dir), surf.spec_n)[:, None] * lint[None, :]
    rgb = light_amt * surf.albedo * surf.kd[:, None] + spec * surf.ks[:, None]
    if occ_out is not None:
        occ_out.append(occ_acc)
    return rgb, searched
