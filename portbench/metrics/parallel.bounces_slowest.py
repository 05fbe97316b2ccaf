"""parallel.bounces_slowest: the bounces a frame of the rank whose block
takes longest (`parallel.band_ms_slowest`'s rank), from its `rt.bounce.<d>`
spans over its `rt.band` spans in its aggregate: each bounce costs that
rank's host a round of launches whatever its lanes."""

from portbench.multicard import bounces_slowest


def read(trace, run):
    return bounces_slowest(run)
