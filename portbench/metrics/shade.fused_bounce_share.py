"""shade.fused_bounce_share (%): the program's `rt.shade.fused` ranges (a
bounce's shading launch of its fused kernel) that start and end inside the
profiled frames, over its `rt.bounce.<d>` ranges there, × 100: the share of
the bounces whose shading ran fused. 0 where bounces ran and none was
fused; None where no bounce ran in the window."""

import re

BOUNCE = re.compile(r"rt\.bounce\.\d+")
FUSED = "rt.shade.fused"


def share(trace):
    """The share of the bounces inside the profiled units that ran fused,
    in %, or None where none ran."""
    if trace.window is None or not trace.units:
        return None
    t0, t1 = trace.window
    inside = [name for name, a, b, _ in trace.host if t0 <= a and b <= t1]
    bounces = sum(1 for name in inside if BOUNCE.fullmatch(name))
    if not bounces:
        return None
    return 100.0 * sum(1 for name in inside if name == FUSED) / bounces


def read(trace, run):
    return share(trace)
