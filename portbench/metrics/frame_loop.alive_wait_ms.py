"""frame_loop.alive_wait_ms: host milliseconds a frame of the program's
`rt.alive` spans, the reads of whether a bounce's children hold a live
lane (each waits for the card to finish the bounce), over the frames
before the profiler started, the first span left out, from the program's
span aggregate; as many spans a frame as the traced frames hold."""

from portbench.spans import ranges, untraced_ms


def read(trace, run):
    ms = untraced_ms(trace, "rt.alive")
    per_unit = len(ranges(trace, "rt.alive")) / trace.units if trace.units else 0
    return ms * per_unit if ms is not None and per_unit else None
