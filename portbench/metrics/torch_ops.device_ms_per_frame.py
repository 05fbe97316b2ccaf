"""torch_ops.device_ms_per_frame: device milliseconds per profiled frame of
every device operation (kernels, copies, sets) that is not one of the
program's hand-written kernels, those named by `__global__` in its CUDA
sources."""

import re

from portbench.profiler import port_kernels


def read(trace, run):
    own = [re.compile(rf"\b{k}\b") for k in port_kernels()]
    ms = sum(b - a for n, a, b, _, _ in trace.in_window()
             if not any(p.search(n) for p in own)) * 1e3
    return ms / trace.units if ms > 0 and trace.units else None
