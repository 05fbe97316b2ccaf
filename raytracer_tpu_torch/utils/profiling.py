"""Profiling hooks (counterpart of `raytracer_tpu/utils/profiling.py`) on
torch.profiler, and the program's own spans and lane counters.

`xprof_trace` writes a Chrome/Perfetto trace (`*.pt.trace.json`, open it in
https://ui.perfetto.dev or chrome://tracing) and `top_ops` ranks the events
of the traces under a directory. The device is always explicit: nothing
here looks for a GPU by itself.

`span(name)` marks a layer of the program. While a torch.profiler
records, the span is a `record_function` range in the same trace as the
kernels it launches (their runtime calls fall inside it, so a kernel is
matched to its span by correlation id). Until a span first runs under a
profiler, each span adds its host time to a per-name aggregate
(`spans()`): torch's profiler leaves the process slower after its session
(an H100 config4 1080p frame ~93 ms after it, ~71 ms in a process it never
ran in), so the aggregate holds only host times the profiler has not
touched. While a profiler records, `count_lanes`
adds a bounce's live and dispatched search lanes to device-side counts
(`counters()`); otherwise it does nothing. The names the renderer uses:
`rt.frame`, `rt.bounce.<d>`, `rt.search`, `rt.shadow`, `rt.surface`,
`rt.shade`, `rt.shade.fused` (a bounce's shading launch of K6, once a
fused bounce), `rt.spawn`, `rt.count` (the lane sums), `rt.compact`,
`rt.value_and_grad`, `rt.record`, `rt.replay`, `rt.backward`, and across
cards `rt.view` (a frame's view from rank 0), `rt.band` (a rank's own
block), `rt.gather` (the image's all-gather), `rt.reduce` (the counts'
all-reduce); lane kinds `nearest.b<d>` and `shadow.b<d>`. A trace tells units (frames, steps)
apart by their order.
"""

import collections
import contextlib
import glob
import gzip
import json
import os
import threading
import time

import torch

# Chrome-trace categories of the work the card itself runs
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_SPANS: dict = {}   # name → [count, total ns, first ns]
_PROFILED = False   # a span has run under a profiler since the last reset
_LANES: dict = {}   # (depth, lights) → [live lanes [1 + lights], dispatched]
_LOCK = threading.Lock()  # spans end on autograd's threads too


@contextlib.contextmanager
def xprof_trace(logdir: str, *, device):
    """Profile the block: CPU activity, plus the card's kernels and copies
    when `device` is a CUDA device. On exit the trace is written under
    `logdir` as `<host>_<pid>.<ns>.pt.trace.json`. Yields the
    `torch.profiler.profile` object (its `key_averages()` and events).

    The caller synchronizes the card before the block ends, or its last
    kernels fall outside the trace. One session per process: a second
    session in the same process has read no device time on the card."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def counting() -> bool:
    """Whether a torch.profiler session records, so that spans enter
    ranges and `count_lanes` counts."""
    return torch.autograd._profiler_enabled()


class span:
    """Context manager: the block is the layer `name`.

    While a torch.profiler records, enters
    `torch.profiler.record_function(name)`, and the host aggregate stops
    until `reset()`. With no profiler recording only the gate check and
    the host aggregate remain: `record_function` costs microseconds even
    then.
    """

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _PROFILED
        self._rf = None
        if counting():
            _PROFILED = True
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        if self._rf is not None:
            self._rf.__exit__(*exc)
        elif not _PROFILED:
            with _LOCK:
                agg = _SPANS.get(self.name)
                if agg is None:
                    _SPANS[self.name] = [1, dt, dt]
                else:
                    agg[0] += 1
                    agg[1] += dt
        return False


def count_lanes(depth: int, live, width: int) -> None:
    """While a profiler records: add bounce `depth`'s live lanes to its
    device-side counts, with no host sync. `live` [1 + lights] holds the
    nearest search's, then each light's shadow search's; each search
    dispatched `width` lanes. Otherwise nothing: no kernel, no count."""
    if not counting():
        return
    key = (depth, live.shape[0] - 1)
    with _LOCK:
        c = _LANES.get(key)
        if c is None:
            _LANES[key] = [live.clone(), width]
        else:
            c[0].add_(live)
            c[1] += width


def spans() -> dict:
    """{name: {"count", "total_ns", "first_ns"}}: each span's host time
    over every thread from the last `reset()` until a span first ran under
    a profiler; "first_ns" is its first end's."""
    with _LOCK:
        return {k: {"count": n, "total_ns": t, "first_ns": f}
                for k, (n, t, f) in _SPANS.items()}


def counters() -> dict:
    """{kind: (live lanes, dispatched lanes)} counted by `count_lanes`
    since the last `reset()`: `nearest.b<d>` and `shadow.b<d>` (every
    light's); reads the device counts back."""
    with _LOCK:
        lanes = [(k, live, sent) for k, (live, sent) in _LANES.items()]
    out = {}
    for (depth, lights), live, sent in lanes:
        near, *shadow = live.tolist()
        for kind, n, m in ((f"nearest.b{depth}", near, sent),
                           (f"shadow.b{depth}", sum(shadow), sent * lights)):
            a, b = out.get(kind, (0, 0))
            out[kind] = (a + n, b + m)
    return out


def reset() -> None:
    """Clear the span aggregates and the lane counts; the aggregates take
    spans again."""
    global _PROFILED
    _PROFILED = False
    with _LOCK:
        _SPANS.clear()
        _LANES.clear()


def trace_events(trace_dir: str) -> list:
    """The complete ("X") events of every trace file under `trace_dir`."""
    files = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                  recursive=True)
        + glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json.gz"),
                    recursive=True))
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json under {trace_dir}")
    events = []
    for f in files:
        with (gzip.open if f.endswith(".gz") else open)(f, "rt") as fh:
            events += [e for e in json.load(fh).get("traceEvents", [])
                       if e.get("ph") == "X" and "dur" in e]
    return events


def top_ops(trace_dir: str, k: int = 20, device_only: bool = True):
    """Rank the events of the traces under `trace_dir` by total duration
    (descending) → [(name, total_seconds, count)]. `device_only` keeps the
    card's kernels, copies and sets (drops the host's ops and runtime
    calls)."""
    total = collections.Counter()
    counts = collections.Counter()
    for e in trace_events(trace_dir):
        if device_only and e.get("cat", "").lower() not in DEVICE_CATS:
            continue
        total[e["name"]] += float(e["dur"]) / 1e6  # µs in the trace
        counts[e["name"]] += 1
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:k]
    return [(name, secs, counts[name]) for name, secs in ranked]


def print_top_ops(trace_dir: str, k: int = 20, device_only: bool = True):
    rows = top_ops(trace_dir, k=k, device_only=device_only)
    tot = sum(r[1] for r in rows)
    for name, secs, n in rows:
        print(f"{secs * 1e3:10.3f} ms  x{n:<6} {name[:110]}")
    print(f"# top-{k} total: {tot * 1e3:.2f} ms")
    return rows
