"""replay.backward_device_ms: device milliseconds per profiled step of the
operations launched under the autograd engine's backward ranges
(`autograd::engine::evaluate_function: …`): the checkpointed replay's
recompute and its backward. A device operation is matched to the host call
that launched it by the trace's correlation ids."""

import bisect

RANGE = "autograd::engine::evaluate_function"


def _merged(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read(trace, run):
    per_tid = {}
    for name, a, b, tid in trace.host:
        if name.startswith(RANGE):
            per_tid.setdefault(tid, []).append((a, b))
    ranges = {tid: _merged(s) for tid, s in per_tid.items()}
    starts = {tid: [a for a, _ in r] for tid, r in ranges.items()}
    launched = set()
    for _, a, _, tid, corr in trace.runtime:
        if tid in ranges and corr is not None:
            i = bisect.bisect_right(starts[tid], a) - 1
            if i >= 0 and a <= ranges[tid][i][1]:
                launched.add(corr)
    ms = sum(b - a for _, a, b, _, corr in trace.in_window() if corr in launched) * 1e3
    return ms / trace.units if ms > 0 and trace.units else None
