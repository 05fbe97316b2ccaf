"""Profiling and timing hooks (counterpart of
`raytracer_tpu/utils/profiling.py`) on torch.profiler.

`xprof_trace` writes a Chrome/Perfetto trace (`*.pt.trace.json`, open it in
https://ui.perfetto.dev or chrome://tracing) and `top_ops` ranks the events
of the traces under a directory. `Timer` and `timed` are wall clocks that
wait for the card. The device is always explicit: nothing here looks for a
GPU by itself.
"""

import collections
import contextlib
import glob
import gzip
import json
import os
import time

import torch

# Chrome-trace categories of the work the card itself runs
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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


class Timer:
    """Wall-clock timer of a block that waits on exit for the work queued
    on `device` (a CUDA device is synchronized; the CPU runs eagerly)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.t0 = None
        self.elapsed = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.elapsed = time.perf_counter() - self.t0


def _block(out):
    """Wait for every CUDA device that holds a tensor of `out` (a tensor or
    nested tuples, lists and dicts of them)."""
    devices, todo = set(), [out]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            devices.add(x.device)
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (tuple, list)):
            todo.extend(x)
    for d in devices:
        _sync(d)
    return out


def timed(fn, *args, repeats: int = 3, inner: int | None = None):
    """Best-of-N amortized wall time of fn(*args), after a warm-up →
    (last output, seconds).

    Issues `inner` back-to-back calls and waits once for the devices of the
    outputs: robust against the jitter of asynchronous launches (one
    synchronize per call can under- or over-state sub-ms work). No
    device→host readbacks. `inner` auto-scales so that one repeat costs
    ~0.5 s (long calls get inner=1)."""
    _block(fn(*args))  # warm-up: kernel builds, allocator growth
    t0 = time.perf_counter()
    out = _block(fn(*args))  # calibration run
    t_cal = time.perf_counter() - t0
    if inner is None:
        inner = max(1, min(8, int(0.5 / max(t_cal, 1e-4))))
    best = t_cal
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        _block(out)
        best = min(best, (time.perf_counter() - t0) / inner)
    return out, best


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
