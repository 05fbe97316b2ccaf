"""device.idle.train: the device's idle share over the profiled steps of a
train cell, in %: 1 − the union of kernel, copy and set intervals over the
window from the first profiled unit's start to the last one's end."""


def read(trace, run):
    idle = trace.idle_share()
    return None if idle is None else 100.0 * idle
