"""compact.partition_device_ms_per_frame: device milliseconds per profiled
frame of the operations launched under the program's `rt.compact` ranges:
each compaction's alive-first partition, the takes of the kept lanes and
their slots, and the program's counts of it while the profiler records.
None where the program has no such span."""

from portbench.spans import per_unit_ms

COMPACT = "rt.compact"


def read(trace, run):
    return per_unit_ms(trace, lambda names: COMPACT in names)
