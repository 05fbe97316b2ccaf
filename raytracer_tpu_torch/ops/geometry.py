"""Vectorized intersection + optics ops (docs/SPEC.md "Intersections",
"Optics"); counterpart of `raytracer_tpu/ops/geometry.py`.

Rays are [N,3]; primitive packs broadcast to [N,P] candidate-t matrices.
Misses are +inf so a plain `min` reduce finds the nearest hit.
"""

import math

import numpy as np
import torch

from raytracer_tpu_torch.ops.safemath import (abs1, clip, cross, dot, maximum,
                                              normalize, safe_div, safe_sqrt)

INF = math.inf
_DET_EPS = 1e-8


# ---------------------------------------------------------------------------
# Intersections
# ---------------------------------------------------------------------------

def sphere_t(orig, direc, center, radius, t_min):
    """Nearest positive hit distance over the leading broadcast shape.

    orig/direc/center: [..., 3]; radius: [...]. Returns t [...] (+inf miss).
    """
    L = orig - center
    a = dot(direc, direc)
    b = 2.0 * dot(direc, L)
    c0 = dot(L, L) - radius * radius
    disc = b * b - 4.0 * a * c0
    # radius > 0: r<=0 marks padding spheres; for r=0 fp cancellation on huge
    # |L| could otherwise produce phantom roots
    has_root = (disc >= 0) & (radius > 0)
    sq = safe_sqrt(disc, valid=has_root)
    q = -0.5 * (b + torch.where(b >= 0, sq, -sq))
    t0 = safe_div(q, a)
    t1 = safe_div(c0, q, valid=torch.abs(q) > 1e-12, fallback=-INF)
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)
    t = torch.where(tlo > t_min, tlo, torch.where(thi > t_min, thi, INF))
    return torch.where(has_root, t, INF)


def sphere_hits(orig, direc, centers, radii, t_min):
    """[N,3] rays × [Ns] spheres → t [N,Ns]."""
    return sphere_t(orig[:, None, :], direc[:, None, :], centers[None, :, :],
                    radii[None, :], t_min)


def plane_t(orig, direc, point, normal, t_min):
    """Infinite plane hit distance; broadcast elementwise; +inf on miss."""
    denom = dot(normal, direc)
    valid = torch.abs(denom) > _DET_EPS
    t = safe_div(dot(point - orig, normal), denom, valid=valid, fallback=-INF)
    return torch.where(valid & (t > t_min), t, INF)


def plane_hits(orig, direc, points, normals, t_min):
    """[N,3] rays × [Np] planes → t [N,Np]."""
    return plane_t(orig[:, None, :], direc[:, None, :], points[None, :, :],
                   normals[None, :, :], t_min)


def triangle_tuv(orig, direc, v0, e1, e2, t_min):
    """Möller–Trumbore, no backface culling, elementwise over broadcast shape.

    Returns (t, u, v); t=+inf on miss.
    """
    pvec = cross(direc, e2)
    det = dot(e1, pvec)
    valid = torch.abs(det) > _DET_EPS
    inv = safe_div(torch.ones_like(det), det, valid=valid)
    tvec = orig - v0
    u = dot(tvec, pvec) * inv
    qvec = cross(tvec, e1)
    v = dot(direc, qvec) * inv
    t = dot(e2, qvec) * inv
    valid = valid & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > t_min)
    return torch.where(valid, t, INF), u, v


def triangle_hits(orig, direc, v0, e1, e2, t_min):
    """[N,3] rays × [T] triangles → (t, u, v) each [N,T]."""
    return triangle_tuv(orig[:, None, :], direc[:, None, :], v0[None, :, :],
                        e1[None, :, :], e2[None, :, :], t_min)


# ---------------------------------------------------------------------------
# Optics (docs/SPEC.md "Optics helpers")
# ---------------------------------------------------------------------------

def reflect(i, n):
    return i - 2.0 * dot(i, n)[..., None] * n


def refract(i, n, ior):
    """Returns (t_dir, valid). valid=False on total internal reflection."""
    cosi = clip(dot(i, n), -1.0, 1.0)
    entering = cosi < 0
    cosi_a = abs1(cosi)
    etai = torch.where(entering, 1.0, ior)
    etat = torch.where(entering, ior, 1.0)
    n_o = torch.where(entering[..., None], n, -n)
    eta = etai / etat
    k = 1.0 - eta * eta * (1.0 - cosi_a * cosi_a)
    valid = k >= 0
    tdir = eta[..., None] * i + (eta * cosi_a - safe_sqrt(k, valid))[..., None] * n_o
    return torch.where(valid[..., None], tdir, 0.0), valid


def fresnel(i, n, ior):
    """Unpolarized Fresnel reflectance kr; kr=1 on TIR."""
    cosi = clip(dot(i, n), -1.0, 1.0)
    entering = cosi <= 0
    etai = torch.where(entering, 1.0, ior)
    etat = torch.where(entering, ior, 1.0)
    sint = etai / etat * safe_sqrt(maximum(1.0 - cosi * cosi, 0.0),
                                   valid=(1.0 - cosi * cosi) > 0)
    no_tir = sint < 1.0
    cost = safe_sqrt(maximum(1.0 - sint * sint, 0.0), valid=no_tir)
    cosi_a = abs1(cosi)
    rs = safe_div(etat * cosi_a - etai * cost, etat * cosi_a + etai * cost,
                  valid=no_tir)
    rp = safe_div(etai * cosi_a - etat * cost, etai * cosi_a + etat * cost,
                  valid=no_tir)
    kr = 0.5 * (rs * rs + rp * rp)
    return torch.where(no_tir, kr, 1.0)


def spawn_origin(p, n, out_dir, bias):
    """Child/shadow ray origin offset along the normal (SPEC castRay rules)."""
    side = 1.0 - 2.0 * (dot(out_dir, n) < 0).to(torch.float32)
    return p + side[..., None] * bias * n


def pixel_coords(width: int, height: int, row0: int, rows: int, device):
    """Normalised pixel centres of a band → (i [width], j [rows]) f32:
    (k + 0.5) / width and (k + row0 + 0.5) / height.

    The divisors are device tensors: torch on CUDA divides by a Python
    number as a product with its rounded reciprocal, an ulp off the true
    quotient unless the divisor is a power of two; a tensor divisor gives
    the quotient on every device.
    """
    f32 = torch.float32
    w = torch.tensor(float(width), dtype=f32, device=device)
    h = torch.tensor(float(height), dtype=f32, device=device)
    i = (torch.arange(width, dtype=f32, device=device) + 0.5) / w
    j = (torch.arange(rows, dtype=f32, device=device) + float(row0) + 0.5) / h
    return i, j


def raygen(c2w, fov_deg, width, height, row0: int = 0,
           rows: int | None = None):
    """Camera ray directions, row-major → [rows·width, 3] f32 on c2w's device.

    `row0`/`rows` select a horizontal band of the full-image projection.
    (The reference's first argument, the camera position, is unused there.)
    """
    rows = height if rows is None else rows
    dev = c2w.device
    f32 = torch.float32
    fov = torch.as_tensor(fov_deg, dtype=f32, device=dev)
    scale = torch.tan(torch.deg2rad(fov / 2.0))
    aspect = float(np.float32(width) / np.float32(height))
    i, j = pixel_coords(width, height, row0, rows, dev)
    x = (2.0 * i - 1.0) * aspect * scale                 # [W]
    y = (1.0 - 2.0 * j) * scale                          # [rows]
    xx = x[None, :].expand(rows, width)
    yy = y[:, None].expand(rows, width)
    d_cam = torch.stack([xx, yy, -torch.ones_like(xx)], dim=-1).reshape(-1, 3)
    # explicit per-column rotate, as the reference does (not a matmul)
    m = c2w.to(f32)
    d_world = (d_cam[:, 0:1] * m[:, 0][None, :]
               + d_cam[:, 1:2] * m[:, 1][None, :]
               + d_cam[:, 2:3] * m[:, 2][None, :])
    return normalize(d_world, valid=torch.ones(d_world.shape[:-1],
                                               dtype=torch.bool, device=dev))
