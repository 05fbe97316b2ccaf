"""parallel.band_ms_slowest: the largest, over ranks, of a rank's mean host
milliseconds a frame in the program's `rt.band` span (its own block, from
the view to the entry of the gather), untraced, the first frame left out:
the rank that sets the frame's pace."""

from portbench.multicard import band_ms


def read(trace, run):
    per_rank = band_ms(run)
    return max(per_rank) if per_rank else None
