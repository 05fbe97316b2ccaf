"""The comparison that decides `correct`: the numbers computed from the
program's outputs and the reference's, each held to its limit."""

import math
import statistics

import numpy as np
import torch

# a pixel is off when a channel differs by more than one 8-bit level
LEVEL = 1.0 / 255.0


def image_numbers(prog, ref) -> dict:
    """Numbers of one frame: `px_off`, the share of pixels off by more than
    a level in some channel, and `mean_abs`, the mean absolute difference
    over every channel."""
    a = torch.as_tensor(prog).float()
    b = torch.as_tensor(ref).to(a.device).float()
    diff = (a - b).abs()
    return {"px_off": float((diff.amax(-1) > LEVEL).float().mean()),
            "mean_abs": float(diff.mean())}


def worst(readings: list) -> dict:
    """The largest of each number over several readings."""
    return {k: max(r[k] for r in readings) for k in readings[0]}


def leaf_norms(tables: dict) -> dict:
    """{(table, row): L2 norm} of each row of each [rows, 3] table: the
    leaves of the training comparison (a sphere's center, a material's
    albedo)."""
    out = {}
    for name, t in tables.items():
        t = torch.as_tensor(t).double().reshape(t.shape[0], -1)
        for row in range(t.shape[0]):
            out[(name, row)] = float(t[row].norm())
    return out


def gap_by_leaf(prog: dict, ref: dict, keep) -> float:
    """The worst leaf's |‖prog‖ − ‖ref‖| over the larger of the reference's
        norm of that leaf and of the median kept leaf (0 where both sides are
    all zero)."""
    med = statistics.median(ref[k] for k in keep)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0
               else (0.0 if prog[k] == 0 else math.inf) for k in keep)


def train_numbers(prog: dict, ref: dict, skip_share: float = 1e-3) -> dict:
    """Numbers of the first training steps. `prog` and `ref` each hold
    "losses" and "grads" (each step's loss and gradient, {name: table}) and
    "change" (the parameters after the steps less those before).

    - `loss_gap`: the worst step's |L − L_ref| / L_ref;
    - `grad_gap`: `gap_by_leaf` of the first step's gradient norms;
    - `change_gap`: `gap_by_leaf` of the change's norms.
    Besides, not compared: `loss_gap_1`, the first step's loss gap, and
    `grad_gap_later`, the worst later step's gradient gap. The sphere
    center's gradient after a step reads as far apart between the
    reference in float32 and in float64 at one state as between the
    program and the reference (0.1–0.4), so it is printed, not held.
    Leaves whose first reference gradient is under `skip_share` of the
    median leaf's are left out (the mirror's albedo, which shades nothing)."""
    g_ref = leaf_norms(ref["grads"][0])
    med = statistics.median(g_ref.values())
    keep = [k for k, v in g_ref.items() if v >= skip_share * med]
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]
    grads = [gap_by_leaf(leaf_norms(a), leaf_norms(b), keep)
             for a, b in zip(prog["grads"], ref["grads"])]
    return {"loss_gap": max(losses), "grad_gap": grads[0],
            "change_gap": gap_by_leaf(leaf_norms(prog["change"]),
                                      leaf_norms(ref["change"]), keep),
            "loss_gap_1": losses[0], "grad_gap_later": max(grads[1:], default=0.0)}


def judge(numbers: dict, limits: dict) -> list:
    """[(name, value, limit)] of each number that has a limit, in the
    limits' order; a number passes when it is at most its limit."""
    return [(k, float(numbers[k]), float(limits[k])) for k in limits]


def passed(checks: list) -> bool:
    return all(np.isfinite(v) and v <= lim for _, v, lim in checks)
