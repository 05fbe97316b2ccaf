"""search.device_ms_per_frame: device milliseconds per profiled frame of
the operations launched under the program's `rt.search` (each bounce's
nearest search) or `rt.shadow` (each light's shadow search) ranges: the
grid walk K5, the dense sphere and plane search and the merge."""

from portbench.spans import SEARCH, per_unit_ms


def read(trace, run):
    return per_unit_ms(trace, lambda names: any(n in SEARCH for n in names))
