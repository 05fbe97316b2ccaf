"""parallel.band_balance (%): the mean over ranks of a rank's `rt.band`
milliseconds a frame (as `parallel.band_ms_slowest` reads them) over the
slowest rank's, × 100: 100% is a split in which every rank works as long
as the slowest."""

from portbench.multicard import band_ms


def read(trace, run):
    per_rank = band_ms(run)
    if not per_rank or max(per_rank) <= 0:
        return None
    return 100.0 * sum(per_rank) / len(per_rank) / max(per_rank)
