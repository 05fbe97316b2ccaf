"""replay.backward_host_ms: host milliseconds a step of the program's
`rt.backward` span, the `torch.autograd.grad` call on the caller's thread
(the backward's recompute and its gradient, dispatched and waited for),
over the steps before the profiler started, the first left out, from the
program's span aggregate; as many spans a step as the traced steps hold."""

from portbench.spans import ranges, untraced_ms


def read(trace, run):
    ms = untraced_ms(trace, "rt.backward")
    per_unit = len(ranges(trace, "rt.backward")) / trace.units if trace.units else 0
    return ms * per_unit if ms is not None and per_unit else None
