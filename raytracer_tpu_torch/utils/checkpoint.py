"""Checkpoints of the inverse-rendering loop on `torch.save` (the reference
keeps them with orbax, `raytracer_tpu/cli.py:253-275`).

A checkpoint `<dir>/step_<n>.pt` holds the step, every parameter leaf and the
`state_dict` of each stateful object the trainer names (the Adam optimizer;
for the mesh preset also its LambdaLR schedule, whose step count sets the
decay: without it a resumed run restarts the decay and departs from the
uninterrupted trajectory). Each save is synchronous and atomic (a temporary
file, flushed to disk, then `os.replace`): the loop's supervisor restarts
children that died at any instant, so a save must be whole once `save`
returns and never half-written. The newest `KEEP` checkpoints stay.
"""

import os
import re

import torch

KEEP = 2
_NAME = re.compile(r"step_(\d+)\.pt")


def _steps(ckdir: str) -> list:
    """[(step, path)] of the checkpoints in `ckdir`, oldest first."""
    if not os.path.isdir(ckdir):
        return []
    found = []
    for name in os.listdir(ckdir):
        m = _NAME.fullmatch(name)
        if m:
            found.append((int(m.group(1)), os.path.join(ckdir, name)))
    return sorted(found)


def latest(ckdir: str):
    """(step, path) of the newest checkpoint in `ckdir`, or None."""
    found = _steps(ckdir)
    return found[-1] if found else None


def save(ckdir: str, step: int, params: dict, states: dict) -> str:
    """Write step `step`: `params` {name: tensor} and `states` {name: object
    with `state_dict()`}; drop all but the newest KEEP → the path."""
    os.makedirs(ckdir, exist_ok=True)
    path = os.path.join(ckdir, f"step_{step:08d}.pt")
    blob = {"step": step,
            "params": {k: v.detach() for k, v in params.items()},
            **{k: obj.state_dict() for k, obj in states.items()}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(blob, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    for _, old in _steps(ckdir)[:-KEEP]:
        os.remove(old)
    return path


def restore(path: str, params: dict, states: dict, device) -> int:
    """Load a checkpoint into the same leaf tensors `params` (the ones the
    optimizer holds) and into each of `states` → its step."""
    blob = torch.load(path, map_location=device, weights_only=True)
    with torch.no_grad():
        for k, v in params.items():
            v.copy_(blob["params"][k])
    for k, obj in states.items():
        obj.load_state_dict(blob[k])
    return int(blob["step"])
