"""shade.device_ms_per_frame: device milliseconds per profiled frame of
the operations launched under the program's `rt.frame` range but not under
`rt.search`, `rt.shadow` or `rt.count` (the lane sums, which run only
while the profiler records): ray generation, the surfaces, shading, the
children's spawn, the folds and the frame's assembly."""

from portbench.spans import COUNT, SEARCH, per_unit_ms


def read(trace, run):
    return per_unit_ms(trace, lambda names: "rt.frame" in names
                       and not any(n in SEARCH or n == COUNT for n in names))
