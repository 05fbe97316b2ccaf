"""replay.record_device_ms: device milliseconds per profiled step of the
operations launched under the program's `rt.record` range: the plan's
recording under no_grad, its searches included."""

from portbench.spans import per_unit_ms


def read(trace, run):
    return per_unit_ms(trace, lambda names: "rt.record" in names)
