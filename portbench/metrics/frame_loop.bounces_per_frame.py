"""frame_loop.bounces_per_frame: the program's `rt.bounce.<d>` ranges that
start and end inside the profiled frames, over the frames: the bounces a
frame's tiles ran, summed over its tiles."""

import re

BOUNCE = re.compile(r"rt\.bounce\.\d+")


def read(trace, run):
    if trace.window is None or not trace.units:
        return None
    t0, t1 = trace.window
    n = sum(1 for name, a, b, _ in trace.host
            if BOUNCE.fullmatch(name) and t0 <= a and b <= t1)
    return n / trace.units if n else None
