"""frame_loop.live_lane_share: the live lanes over the dispatched lanes of
every search of the profiled frames, in %, by the program's lane counter
(`utils/profiling.count_lanes`, which counts only while the profiler
records): each bounce's nearest search (its alive lanes) and each light's
shadow search (the lanes it has to answer)."""


def read(trace, run):
    from raytracer_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    counts = counters() if counters is not None else {}
    live = sum(n for n, _ in counts.values())
    sent = sum(m for _, m in counts.values())
    return 100.0 * live / sent if sent else None
