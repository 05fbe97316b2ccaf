"""shade.adjoint_bounce_share.train (%): the program's `rt.shade.adjoint`
ranges (a recorded bounce's backward through its hand-written adjoint)
that start and end inside the profiled steps, over the replayed bounces
there × 100. A replayed bounce counts once: an `rt.bounce.<d>` range
inside an `rt.replay` range that starts outside every `rt.backward` range
(the replay's forward; the checkpoint's recompute under `rt.backward`
replays the same bounces again). None where no adjoint range or no
replayed bounce is in the window."""

import re

BOUNCE = re.compile(r"rt\.bounce\.\d+")
ADJOINT = "rt.shade.adjoint"


def _inside(t, ranges) -> bool:
    return any(a <= t <= b for a, b in ranges)


def read(trace, run):
    if trace.window is None or not trace.units:
        return None
    t0, t1 = trace.window
    inside = [(name, a, b) for name, a, b, _ in trace.host if t0 <= a and b <= t1]
    adjoints = sum(1 for name, _, _ in inside if name == ADJOINT)
    backward = [(a, b) for name, a, b in inside if name == "rt.backward"]
    replays = [(a, b) for name, a, b in inside
               if name == "rt.replay" and not _inside(a, backward)]
    bounces = sum(1 for name, a, b in inside
                  if BOUNCE.fullmatch(name) and any(x <= a and b <= y for x, y in replays))
    if not adjoints or not bounces:
        return None
    return 100.0 * adjoints / bounces
