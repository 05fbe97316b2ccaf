"""parallel.alive_wait_ms_slowest: the host milliseconds a frame that the
rank whose block takes longest spends in `rt.alive`, the reads of whether
a bounce's children hold a live lane (each waits for its card to end the
bounce): the mean of its untraced spans, the first left out, × as many as
it makes a frame, from its aggregate."""

from portbench.multicard import alive_ms_slowest


def read(trace, run):
    return alive_ms_slowest(run)
