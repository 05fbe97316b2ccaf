"""The traced run's reading of the profiler: torch.profiler over a bounded
run of frames or steps inside the window, its Chrome trace written to
`portbench/_cache/trace/` and read back.

The interval arithmetic (device categories, the union of device intervals,
the idle share) is copied from the repository's `chip_smoke.idle_share` and
`raytracer_tpu_torch/utils/profiling.py`, so that the program cannot change
the yardstick.
"""

import bisect
import collections
import contextlib
import glob
import json
import math
import os
import re

# Chrome-trace categories of the work the card itself runs
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "portbench.unit"   # the harness's span around each profiled frame or step
NAME_CHARS = 160          # names in the breakdown are cut to this many characters
HERE = os.path.dirname(os.path.abspath(__file__))
TRACE_DIR = os.path.join(HERE, "_cache", "trace")
CSRC = os.path.join(os.path.dirname(HERE), "raytracer_tpu_torch", "csrc")


@contextlib.contextmanager
def profiled(device):
    """Profile the block (host activity, and the card's when `device` is a
    CUDA device); yields a holder whose `.trace` is the `Trace` once the
    block has ended, written to TRACE_DIR/trace.json. The caller synchronizes
    the card before the block ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    holder = type("Holder", (), {"trace": None})()
    os.makedirs(TRACE_DIR, exist_ok=True)
    with profile(activities=acts) as prof:
        yield holder
    path = os.path.join(TRACE_DIR, "trace.json")
    prof.export_chrome_trace(path)
    holder.trace = Trace.load(path)


def unit_span():
    """The span that marks one profiled frame or step."""
    import torch

    return torch.profiler.record_function(SPAN)


def port_kernels() -> set:
    """Names of the program's hand-written kernels (`__global__` functions
    in its CUDA sources)."""
    names = set()
    for path in glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")):
        with open(path) as f:
            src = f.read()
        names |= set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                src))
    return names


def short_name(name: str) -> str:
    """A device operation's name cut to NAME_CHARS characters, ending with
    the functors and kernels it names (what tells templated kernels
    apart)."""
    if len(name) <= NAME_CHARS:
        return name
    tags = []
    for t in re.findall(r"\w*(?:Functor|kernel_impl|_kernel|Op)\w*", name):
        if t not in tags:
            tags.append(t)
    tail = " .. " + " ".join(tags)
    return name[:max(40, NAME_CHARS - len(tail))] + tail[:NAME_CHARS - 40]


def union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


class Trace:
    """A Chrome trace's complete events, split into device intervals, host
    operations and runtime calls; times in seconds."""

    def __init__(self, events: list):
        ev = [e for e in events if e.get("ph") == "X" and "dur" in e]
        sec = lambda e: (float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6)
        self.device = [(e["name"], *sec(e), e.get("cat", "").lower(),
                        e.get("args", {}).get("correlation"))
                       for e in ev if e.get("cat", "").lower() in DEVICE_CATS]
        self.host = [(e["name"], *sec(e), e.get("tid")) for e in ev
                     if e.get("cat", "").lower() in ("cpu_op", "user_annotation",
                                                     "python_function")]
        self.runtime = [(e["name"], *sec(e), e.get("tid"),
                         e.get("args", {}).get("correlation"))
                        for e in ev if e.get("cat", "").lower() == "cuda_runtime"]
        units = [(a, b) for name, a, b, _ in self.host if name == SPAN]
        self.units = len(units)
        self.window = (min(a for a, _ in units), max(b for _, b in units)) if units else None

    @staticmethod
    def load(path: str) -> "Trace":
        with open(path) as f:
            return Trace(json.load(f).get("traceEvents", []))

    def in_window(self):
        """Device intervals clipped to the profiled units' window."""
        if self.window is None:
            return []
        t0, t1 = self.window
        return [(n, max(a, t0), min(b, t1), cat, corr) for n, a, b, cat, corr in self.device
                if b > t0 and a < t1]

    def window_s(self) -> float:
        return self.window[1] - self.window[0] if self.window else 0.0

    def busy_s(self) -> float:
        return union((a, b) for _, a, b, _, _ in self.in_window())

    def idle_share(self):
        """1 − busy / window, or None where nothing ran on the device."""
        busy = self.busy_s()
        return 1.0 - busy / self.window_s() if busy > 0 else None

    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time."""
        total = collections.Counter()
        for n, a, b, _, _ in self.in_window():
            total[n] += b - a
        return [[short_name(n), s] for n, s in total.most_common(k)]

    def idle_gaps(self, k: int = 10) -> list:
        """[[host operation, seconds]]: the device's idle time inside the
        window, summed by the innermost host operation running at each
        gap's midpoint, the largest first."""
        if self.window is None:
            return []
        spans = sorted((a, b) for _, a, b, _, _ in self.in_window())
        gaps, end = [], self.window[0]
        for a, b in spans:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        mids = [0.5 * (g0 + g1) for g0, g1 in gaps]
        inner = [(-math.inf, "(no host operation)")] * len(gaps)
        for n, a, b, _ in self.host:
            if n == SPAN:
                continue
            for i in range(bisect.bisect_left(mids, a), bisect.bisect_right(mids, b)):
                inner[i] = max(inner[i], (a, n))   # the latest start: the innermost
        total = collections.Counter()
        for (_, n), (g0, g1) in zip(inner, gaps):
            total[n] += g1 - g0
        return [[short_name(n), s] for n, s in total.most_common(k)]
