"""frame_loop.host_ms_per_frame: the host milliseconds a frame of the
program's `rt.frame` span, `render_banded`'s entry to its return (the
harness then waits for the card), over the frames before the profiler
started, the first left out: the host's time to issue a frame, from the
program's span aggregate, since the profiler slows every frame from its
first on. It holds any wait for the card inside the frame too."""

from portbench.spans import untraced_ms


def read(trace, run):
    return untraced_ms(trace, "rt.frame")
