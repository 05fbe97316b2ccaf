"""Readings of a cell whose frame is split over cards, from every rank's
span aggregate, which the loop gathers from the program after the window
(`run.ranks`: `raytracer_tpu_torch/parallel/frames.ShardedFrames.report`),
and from rank 0's untraced frame times (`run.frame_s`). Where the program
has no such spans, every reading here is None."""

import re
import resource
import threading
import time

BOUNCE = re.compile(r"rt\.bounce\.\d+")


def _mean_ms(agg):
    """Mean host milliseconds of an aggregate's spans, the first left out."""
    return 1e-6 * (agg["total_ns"] - agg["first_ns"]) / (agg["count"] - 1)


def band_ms(run):
    """[each rank's mean host milliseconds of its `rt.band` span a frame],
    the first frame left out, by rank, from the aggregates (on rank 0 the
    frames before its profiler started; elsewhere every frame), or None."""
    per_rank = getattr(run, "ranks", None)
    if not per_rank:
        return None
    out = []
    for stats in per_rank:
        agg = stats["spans"].get("rt.band")
        if not agg or agg["count"] < 2:
            return None
        out.append(_mean_ms(agg))
    return out


def slowest(run):
    """The aggregates of the rank whose band takes longest, or None."""
    per_rank = band_ms(run)
    if not per_rank:
        return None
    return run.ranks[max(range(len(per_rank)), key=per_rank.__getitem__)]["spans"]


def bounces_slowest(run):
    """The slowest rank's `rt.bounce.<d>` spans over its `rt.band` spans:
    the bounces its block runs a frame, or None."""
    spans = slowest(run)
    if spans is None:
        return None
    n = sum(agg["count"] for name, agg in spans.items() if BOUNCE.fullmatch(name))
    return n / spans["rt.band"]["count"] if n else None


def alive_ms_slowest(run):
    """The slowest rank's host milliseconds a frame in `rt.alive`, the reads
    that wait for its card to end a bounce: their mean (the first left
    out) × as many as it makes a frame, or None."""
    spans = slowest(run)
    agg = spans.get("rt.alive") if spans is not None else None
    if not agg or agg["count"] < 2:
        return None
    return _mean_ms(agg) * agg["count"] / spans["rt.band"]["count"]


def collective_ms(run):
    """Rank 0's mean host milliseconds a frame outside its own `rt.band`:
    its untraced frames' mean time (`run.frame_s`, start to synchronize)
    less its band's mean. That holds the view's broadcast, the gather, the
    counts' reduce, and the wait in them for the slowest rank. None where
    either is missing."""
    per_rank, times = band_ms(run), getattr(run, "frame_s", None)
    if not per_rank or not times:
        return None
    return 1e3 * sum(times) / len(times) - per_rank[0]


class Tally:
    """A rank's progress through the run, sampled from a thread every
    `every_s` seconds: (wall time, `rt.band` spans and their host seconds,
    the process's CPU seconds, involuntary and voluntary context switches),
    for telling which rank or host slows a stretch of the window."""

    def __init__(self, every_s: float = 5.0):
        self.every_s, self.samples = every_s, []
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, name="tally", daemon=True)

    def _sample(self):
        from raytracer_tpu_torch.utils import profiling

        band = getattr(profiling, "spans", dict)().get("rt.band") or {}
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.samples.append((round(time.time(), 3), band.get("count", 0),
                             round(1e-9 * band.get("total_ns", 0), 4),
                             round(ru.ru_utime + ru.ru_stime, 2), ru.ru_nivcsw,
                             ru.ru_nvcsw))

    def _run(self):
        while not self._done.is_set():
            self._sample()
            self._done.wait(self.every_s)

    def start(self):
        self._thread.start()
        return self

    def stop(self) -> list:
        self._done.set()
        self._thread.join()
        self._sample()
        return self.samples
