"""parallel.collective_ms_per_frame: rank 0's mean host milliseconds a
frame outside its own block, on its untraced frames: the frame's time
(start to synchronize) less its `rt.band` span's. It holds the view's
broadcast (`rt.view`), the image's all-gather (`rt.gather`), the counts'
all-reduce (`rt.reduce`) and their wait for the slowest rank: rank 0's
block is the lightest, so the wait is most of it."""

from portbench.multicard import collective_ms


def read(trace, run):
    return collective_ms(run)
