"""compact.kept_live_share (%): the live lanes that the compactions of the
profiled frames kept, over the lanes they kept room for (the cap), × 100,
by the program's compaction counter (`utils/profiling.compactions`, which
counts only while the profiler records). None where the program keeps no
such counter or nothing was compacted."""


def read(trace, run):
    from raytracer_tpu_torch.utils import profiling

    compactions = getattr(profiling, "compactions", None)
    counts = compactions() if compactions is not None else {}
    kept = sum(k for k, _, _ in counts.values())
    cap = sum(c for _, c, _ in counts.values())
    return 100.0 * kept / cap if cap else None
