"""entry.first_unit_s: the host seconds of the process's first unit, by the
program's own span aggregates (`utils/profiling.spans`): its first
`rt.value_and_grad` where the cell trains, else its first `rt.frame`. The
first unit pays the lazy initialisation of everything it runs, so its time
above a warm unit's is set-up."""


def read(trace, run):
    from raytracer_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    seen = spans()
    for name in ("rt.value_and_grad", "rt.frame"):
        if name in seen:
            return seen[name]["first_ns"] * 1e-9
    return None
