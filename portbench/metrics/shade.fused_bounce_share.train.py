"""shade.fused_bounce_share.train (%): `shade.fused_bounce_share` over the
profiled training steps: the bounces of the plan's record, of the replay
and of its recompute in the backward, of which the record's run fused."""

from portbench.harness import load_module


def read(trace, run):
    return load_module("metrics", "shade.fused_bounce_share.py").share(trace)
