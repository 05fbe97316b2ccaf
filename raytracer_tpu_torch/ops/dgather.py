"""Gathers with a scatter-free backward (counterpart of
`raytracer_tpu/ops/dgather.py`: `tselect`, `pgather` and `permute_take`).

The differentiable recompute (ops/trace.surface_at) gathers per-lane rows
from tiny scene tables — sphere centers [Ns,3], material albedos [M,3],
plane frames [Np,3]. The backward of a plain `table[idx]` is an
`index_put_(accumulate=True)` of N ≈ 2M lane cotangents into those few
rows, which torch on CUDA runs as a sort of the indices and a pass over
each row's run of duplicates.

`pgather(table, idx)` equals `table[idx]` in the forward; its backward
builds the one-hot mask [N, K] and reduces `onehotᵀ @ ct` — one dense
product, no sort and no scatter. Only for small K (the mask costs N·K):
bigger tables (mesh vertices) keep the native gather.

`permute_take(x, order, pos)` equals `x[order]` for the compaction of a
wavefront (renderer._compact); its backward is a gather by the inverse map
`pos`, not a scatter of the cotangents.
"""

import torch

# Tables at or below this row count take the one-hot backward; above it the
# native gather. 0 sends every table to the native gather.
SMALL_TABLE_ROWS = 64


def tselect(table, idx):
    """`table[idx]` for integer and bool tables (no gradient). The
    reference's select chain over ≤8 rows is a TPU gather workaround; on the
    card one gather kernel is the cheaper form of the same values."""
    return table[idx]


class _OneHotGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape = table.shape
        return table[idx]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        k = ctx.shape[0]
        onehot = (idx[:, None] == torch.arange(k, dtype=idx.dtype,
                                               device=idx.device)[None, :])
        ct2 = ct.reshape(idx.shape[0], -1)
        g = onehot.to(ct2.dtype).T @ ct2
        return g.reshape(ctx.shape), None


def pgather(table, idx):
    """`table[idx]` with a one-hot-reduce backward for small float tables.

    `idx` is 1-D int; `table` has rank ≥ 1. Tables with more than
    SMALL_TABLE_ROWS rows, non-float tables, and tables outside autograd
    take the native gather (the forward value is the same either way).
    """
    if (table.shape[0] > SMALL_TABLE_ROWS or not table.is_floating_point()
            or not (torch.is_grad_enabled() and table.requires_grad)):
        return table[idx]
    return _OneHotGather.apply(table, idx)


class _PermuteTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, order, pos):
        ctx.save_for_backward(pos)
        ctx.cap = order.shape[0]
        return x[order]

    @staticmethod
    def backward(ctx, ct):
        (pos,) = ctx.saved_tensors
        kept = pos < ctx.cap
        g = ct[torch.where(kept, pos, 0)]
        g = torch.where(kept.reshape((-1,) + (1,) * (g.ndim - 1)), g, 0.0)
        return g, None, None


def permute_take(x, order, pos):
    """`x[order]`, where `order` [cap] is an injective prefix of a lane
    permutation and `pos` [n = len(x)] its inverse: `order[pos[i]] == i`
    wherever `pos[i] < cap` (both from one prefix sum, renderer.partition).
    The backward is the gather `g[i] = ct[pos[i]]` where `pos[i] < cap`, 0
    elsewhere. `order` and `pos` get no gradient."""
    return _PermuteTake.apply(x, order, pos)
