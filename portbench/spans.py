"""The program's own spans in the traced run: the `rt.*` ranges that
`raytracer_tpu_torch/utils/profiling.span` enters while a profiler records
(host events of the trace, category `user_annotation`).

A device operation belongs to the spans that enclose the runtime call that
launched it, on the launching thread, matched by the trace's correlation
ids, the way `replay.backward_device_ms` matches the autograd engine's
ranges. Where the program has no such spans, every reading here is empty.
"""

PREFIX = "rt."
SEARCH = ("rt.search", "rt.shadow")   # each bounce's nearest, each light's shadow
COUNT = "rt.count"                     # the lane sums: work of the yardstick


def ranges(trace, name: str) -> list:
    """[(start, end)] in seconds of the host ranges called `name`."""
    return [(a, b) for n, a, b, _ in trace.host if n == name]


def enclosing(trace) -> dict:
    """{correlation id: the names of the `rt.*` ranges around the runtime
    call that launched it, outermost first}, for calls inside one."""
    per_tid = {}
    for name, a, b, tid in trace.host:
        if name.startswith(PREFIX):
            per_tid.setdefault(tid, []).append((a, b, name))
    calls = {}
    for _, a, _, tid, corr in trace.runtime:
        if corr is not None and tid in per_tid:
            calls.setdefault(tid, []).append((a, corr))
    out = {}
    for tid, spans in per_tid.items():
        spans.sort(key=lambda s: (s[0], -s[1]))   # parents before children
        stack, i = [], 0
        for t, corr in sorted(calls.get(tid, [])):
            while i < len(spans) and spans[i][0] <= t:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack:
                out[corr] = tuple(s[2] for s in stack)
    return out


def per_unit_ms(trace, keep):
    """Device milliseconds per profiled unit, in the window, of the
    operations whose enclosing span names satisfy `keep(names)`, or None
    where nothing matched."""
    under = enclosing(trace)
    ms = 1e3 * sum(b - a for _, a, b, _, corr in trace.in_window()
                   if corr in under and keep(under[corr]))
    return ms / trace.units if ms > 0 and trace.units else None


def untraced_ms(trace, name: str):
    """Mean host milliseconds of the program's `name` spans after the first
    and before the profiler started, from the program's aggregate
    (`utils/profiling.spans`, which stops at the first span the profiler
    records: the profiler slows the process after its session too); None
    where the program keeps no such aggregate or no such span ran."""
    from raytracer_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    agg = read().get(name) if read is not None else None
    if not agg or agg["count"] < 2:
        return None
    return 1e-6 * (agg["total_ns"] - agg["first_ns"]) / (agg["count"] - 1)
