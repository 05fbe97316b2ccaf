"""walk.k5_roofline: the grid walk K5's share of its roofline over the
profiled frames, in %: the least time the card could take for the frame's
triangle searches, over K5's device time per frame.

The least time is the larger of operations over 67 TFLOP/s (fp32) and
bytes over 3.35 TB/s (NVIDIA's H100 SXM data sheet). The bytes are what the
inputs need, whatever implements the search: each needed ray's 24 B in and
8 B out, and the mesh's triangles once, per search, from the reference's
counts (`reference/counts.walk_bytes`). Operations depend on the path a
walk takes and are not counted, so the bytes bound it: a lower bound on the
time, and the share cannot pass 100% unless the count is wrong."""

import re

from portbench.reference.counts import walk_bytes

PEAK_BYTES_PER_S = 3.35e12
KERNEL = re.compile(r"\bgrid_walk_kernel\b")


def read(trace, run):
    k5 = sum(b - a for n, a, b, _, _ in trace.in_window() if KERNEL.search(n))
    if not k5 or not trace.units:
        return None
    bound = walk_bytes(run.counts()) / PEAK_BYTES_PER_S
    return 100.0 * bound / (k5 / trace.units)
