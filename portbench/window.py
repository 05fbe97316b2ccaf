"""The measured window: a closed loop of frames or steps, each waiting for
the one before it, timed on the host clock from its start to the
`torch.cuda.synchronize()` after it."""

import contextlib
import os
import resource
import statistics
import time

from portbench import profiler


def closed_loop(unit, seconds: float, sync, trace_at=None, trace_units: int = 0,
                device=None) -> dict:
    """Run `unit(k)` for k = 0, 1, … until `seconds` have passed since the
    first one started (the unit in flight finishes) → {"times": [s per unit],
    "span": first start to last end, "trace": the `profiler.Trace` of units
    trace_at … trace_at + trace_units − 1, or None, "host": this process's
    CPU seconds, involuntary and voluntary context switches in the window,
    its CPUs, the load average and the units ended in each 10 s of it}. The traced units run
    under the profiler even where the window has closed."""
    times, ends, trace = [], [], None
    holder, stack = None, contextlib.ExitStack()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t_first = time.perf_counter()
    k = 0
    while True:
        if trace_at is not None and k == trace_at:
            holder = stack.enter_context(profiler.profiled(device))
        t0 = time.perf_counter()
        if holder is not None and trace is None:
            with profiler.unit_span():
                unit(k)
                sync()
        else:
            unit(k)
            sync()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        ends.append(t1 - t_first)
        k += 1
        if holder is not None and trace is None and k == trace_at + trace_units:
            stack.close()
            trace = holder.trace
            t1 = time.perf_counter()
        tracing = trace_at is not None and trace is None
        if t1 - t_first >= seconds and not tracing:
            break
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    host = {"cpu_s": ru1.ru_utime + ru1.ru_stime - ru0.ru_utime - ru0.ru_stime,
            "preempted": ru1.ru_nivcsw - ru0.ru_nivcsw, "waits": ru1.ru_nvcsw - ru0.ru_nvcsw,
            "cpus": len(os.sched_getaffinity(0)), "load": os.getloadavg()[0],
            "per_10s": [sum(int(e // 10) == b for e in ends)
                        for b in range(int(ends[-1] // 10) + 1)]}
    return {"times": times, "span": t1 - t_first, "trace": trace, "host": host}


def p95(times) -> float:
    """The 95th percentile of every unit's time (inclusive quantiles)."""
    if len(times) < 2:
        return times[0]
    return statistics.quantiles(times, n=20, method="inclusive")[18]
