"""compact.fold_device_ms_per_frame: device milliseconds per profiled frame
of the operations launched under the program's `rt.fold` ranges: each fold
of a compacted bounce's term back to pixels by slot (the zeroed buffer of
the uncompacted width, the scatter into it, the sum over each pixel's
slots). None where the program has no such span."""

from portbench.spans import per_unit_ms

FOLD = "rt.fold"


def read(trace, run):
    return per_unit_ms(trace, lambda names: FOLD in names)
