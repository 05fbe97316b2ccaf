"""NaN-safe primitives (counterpart of `raytracer_tpu/ops/safemath.py`).

`torch.where(valid, f(x), fallback)` still backpropagates NaN from the dead
branch when `f` is non-differentiable there (sqrt(0), 1/0, pow(0, n),
normalize(0)). Every op here uses the double-where guard: clamp the argument
on the dead branch *before* the primal op so both the value and the gradient
stay finite. Forward values equal the unguarded forms on the lanes kept.

Gradients at ties follow the reference (JAX): `maximum`/`minimum` against a
constant send half the gradient each way when the operands are equal
(`torch.clamp` sends all of it to x), so `clip` gives 0.5 at a bound; `abs1`
has slope 1 at 0 (`torch.abs`: 0). Forward values are clamp's and abs's.
"""

import torch

_EPS = 1e-12
_CONSTS = {}


def const(c, like):
    """The f32 scalar tensor `c` on `like`'s device (cached)."""
    key = (like.device, float(c))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(float(c), dtype=torch.float32,
                                        device=like.device)
    return t


def maximum(x, c):
    return torch.maximum(x, const(c, x))


def minimum(x, c):
    return torch.minimum(x, const(c, x))


def clip(x, lo, hi):
    return minimum(maximum(x, lo), hi)


def abs1(x):
    return torch.where(x >= 0, x, -x)


def safe_sqrt(x, valid=None):
    """sqrt with finite gradient; `valid` marks lanes whose value is used."""
    if valid is None:
        valid = x > 0
    x_safe = torch.where(valid, x, 1.0)
    return torch.where(valid, torch.sqrt(maximum(x_safe, _EPS)), 0.0)


def safe_div(num, den, valid=None, fallback=0.0):
    if valid is None:
        valid = torch.abs(den) > _EPS
    den_safe = torch.where(valid, den, 1.0)
    return torch.where(valid, num / den_safe, fallback)


# dot and cross are written out per component, one rounding per op in a
# fixed order, so every device computes them alike and the CUDA kernels
# (built without multiply-add contraction) reproduce them exactly.
def dot(a, b):
    """Batched 3-vector dot over the last axis: (x·x + y·y) + z·z."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def norm(v):
    return torch.sqrt(maximum(dot(v, v), _EPS))


def normalize(v, valid=None):
    """Unit vector with finite grad at ‖v‖→0 (dead lanes keep v)."""
    n2 = dot(v, v)
    if valid is None:
        valid = n2 > _EPS
    n2_safe = torch.where(valid, n2, 1.0)
    inv = torch.where(valid, 1.0 / torch.sqrt(n2_safe), 1.0)
    return v * inv[..., None]


def safe_pow(base, exponent):
    """pow(max(0,base), e) with finite grad at base<=0."""
    b = maximum(base, 1e-7)
    return torch.where(base > 0, torch.pow(b, exponent), 0.0)


def clamp01(x):
    return clip(x, 0.0, 1.0)
