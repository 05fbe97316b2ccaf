"""frame_loop.launches_per_frame: device kernels launched in the profiled
frames, over the frames."""


def read(trace, run):
    n = sum(1 for _, _, _, cat, _ in trace.in_window() if cat == "kernel")
    return n / trace.units if n and trace.units else None
