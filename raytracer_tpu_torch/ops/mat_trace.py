"""Brute-force triangle search as a linear expansion: nearest (K4a) or
any-hit (K4b). The CUDA kernel (`csrc/mat_trace.cu`) and its plain torch
version, behind one dispatcher, and the tracer built on them.

Counterpart of `raytracer_tpu/ops/mat_trace.py`. Möller–Trumbore's four
triple products are each a dot of per-triangle constants with the 10-dim
ray feature vector f = [d, o×d, o, 1] (o recentred on the mesh's AABB
centre):

    det   =  d·(−n)                              n = e1×e2
    u·det =  (o×d)·e2 + d·(v0×e2)
    v·det = −(o×d)·e1 − d·(v0×e1)
    t·det =  o·n − (v0·n)

so the search over N rays × T triangles is `feats [N,16] · weights [16,4·Tp]`
(columns det|u|v|t per block of `bt` triangles, `build_tri_weights`)
followed by MT's validity tests and a min-fold. The reference runs the full
product on the TPU's matrix unit. Here both versions sum only the weights'
non-zero rows, in ascending order: det rows 0–2, u·det and v·det rows 0–5,
t·det rows 6–8 and then row 9 as an add (feature 9 is the constant 1 of
`ray_features`, and 1·w == w). The dropped terms are f·0: from finite
features they change at most the sign of a zero sum, which the epilogue
never reads, so the results are the full product's. A non-finite feature
among f0…f9 makes the full product NaN in every quantity (each has a zero
row), a miss; here such a ray is treated as masked: a miss, no tests.

The kernel reads the weights packed per triangle (`pack_mat_table`: the
19 non-zero coefficients and one zero, 80 bytes a row), built once per
tracer and held in `MatTracer._table`. On the card it skips the
reciprocal and the epilogue where they miss whatever 1/det rounds to
(|det| ≤ eps; t·det of det's other sign or 0 when t_min ≥ 0; u·det or v·det
below -2^-80 against det's sign); the plain version computes the whole
epilogue, which gives the same result there (tests hold the kernel's
prefilter to it). The kernel's reciprocal is correctly rounded, as
the plain version's 1/det, and every product and sum is a separate fp32
operation in the same order, so on one device the two agree bit for bit.
The search's t reassociates MT's arithmetic (~1e-6 relative), so
`MatTracer` finalizes: it recomputes the winner's t with
`geometry.triangle_tuv`, the value every other tracer returns.

`active` masks lanes as in `ops/pallas_trace.py`: a masked lane returns
t = +inf, idx 0, not occluded, and costs no triangle work.
"""

import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.core.types import Meshes, Scene
from raytracer_tpu_torch.kernels.build import check_arg, launch_search
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops import trace as trace_ops
from raytracer_tpu_torch.ops.pallas_trace import (count_tests, fold_nearest,
                                                  fold_occluded, lane_chunks)
from raytracer_tpu_torch.ops.safemath import cross

DET_EPS = 1e-8
INF = geom.INF
_F = 16  # feature columns (10 used, padded as the reference pads them)
_USED = 10
# The non-zero weight rows of each quantity, in summation order; t·det adds
# row 9 (against the constant feature 1) after rows 6–8.
_ROWS = (range(0, 3), range(0, 6), range(0, 6), range(6, 9))
_ROW = 20  # floats per packed triangle: det 3 | u 6 | v 6 | t 4 | 0
BT = 2048  # triangles per weight block (the reference's default)

# Kernel launches since the last reset: nearest (K4a) and any-hit (K4b).
# Incremented only where a kernel is launched.
launches = 0
occluded_launches = 0

# The plain version's chunks: [rays, tris] tensors of at most 2^24 elements.
_RAY_CHUNK = 1 << 13
_TRI_CHUNK = 2048


def build_tri_weights(v0, e1, e2, bt: int = BT):
    """Host build: triangle SoA → (weights [16, 4·Tp] f32, center [3] f32),
    CPU tensors.

    Weight columns are packed per block of `bt` triangles as [det | u | v |
    t] × bt, so a block's columns slice into quantity planes. Padding
    triangles get all-zero columns (det 0 ⇒ never valid). Host math in f64
    from the f32 inputs, rounded once at the end, as the reference does.
    """
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    t = v0.shape[0]
    if t == 0:
        raise ValueError("weights of an empty mesh")
    v1, v2 = v0 + e1, v0 + e2
    vmin = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
    vmax = np.maximum(np.maximum(v0, v1), v2).max(axis=0)
    center = (vmin + vmax) * 0.5
    v0c = v0 - center

    n = np.cross(e1, e2)
    cols = {
        "det": np.concatenate(
            [-n, np.zeros((t, 3)), np.zeros((t, 3)), np.zeros((t, 1))], 1),
        "u": np.concatenate(
            [np.cross(v0c, e2), e2, np.zeros((t, 3)), np.zeros((t, 1))], 1),
        "v": np.concatenate(
            [-np.cross(v0c, e1), -e1, np.zeros((t, 3)), np.zeros((t, 1))], 1),
        "t": np.concatenate(
            [np.zeros((t, 3)), np.zeros((t, 3)), n,
             -(v0c * n).sum(1, keepdims=True)], 1),
    }
    tp = max(-(-t // bt), 1) * bt
    w = np.zeros((_F, 4 * tp), np.float32)
    for b in range(tp // bt):
        lo, hi = b * bt, min((b + 1) * bt, t)
        for q, name in enumerate(("det", "u", "v", "t")):
            if hi > lo:
                w[:_USED, (4 * b + q) * bt:(4 * b + q) * bt + (hi - lo)] = \
                    cols[name][lo:hi].T.astype(np.float32)
    return torch.from_numpy(w), torch.from_numpy(center.astype(np.float32))


@dataclasses.dataclass(frozen=True)
class MatTable:
    """The kernel's packed weights (`pack_mat_table`): `rows` [Tp, 20] f32,
    per triangle det rows 0–2 | u rows 0–5 | v rows 0–5 | t rows 6–9 | 0,
    read as five 16-byte loads; `bt` and `source` name the weight table it
    was packed from (its storage, version, shape and device), so a table
    that no longer matches its weights is refused."""

    rows: torch.Tensor
    bt: int
    source: tuple


def _source(weights) -> tuple:
    return (weights.data_ptr(), weights._version, tuple(weights.shape),
            str(weights.device))


def pack_mat_table(weights, bt: int = BT) -> MatTable:
    """The packed table of a [16, 4·Tp] weight table, on its device: each
    triangle's non-zero coefficients in one contiguous 80-byte row (padding
    triangles' rows are all zero, as their columns are)."""
    tp = _table_size(weights, bt)
    if weights.dtype != torch.float32 or weights.shape[0] != _F:
        raise ValueError(f"weights must be f32 [{_F}, 4·Tp], got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    j = torch.arange(tp, device=weights.device)
    col = 4 * bt * (j // bt) + j % bt  # the det column of triangle j
    parts = [weights[rows.start:rows.stop + (q == 3), col + q * bt].T
             for q, rows in enumerate(_ROWS)]
    parts.append(weights.new_zeros((tp, 1)))
    return MatTable(rows=torch.cat(parts, dim=1).contiguous(), bt=bt,
                    source=_source(weights))


def ray_features(orig, direc, center):
    """[N,3]×2 → [N,16] f32 feature rows [d, o×d, o, 1, 0…] (o recentred)."""
    o = orig - center[None, :]
    ones = torch.ones((orig.shape[0], 1), dtype=torch.float32,
                      device=orig.device)
    f = torch.cat([direc, cross(o, direc), o, ones], dim=1)
    return torch.nn.functional.pad(f, (0, _F - _USED))


@torch.no_grad()
def mat_nearest(feats, weights, t_min, bt: int = BT, active=None,
                table=None):
    """Nearest hit over the weight table → (t_search [N] f32, idx [N] i32;
    +inf and 0 on a miss). t_search is the search's value; `MatTracer`
    recomputes the canonical t from idx. `table` is the weights' packed
    table for the kernel (packed here when None)."""
    if feats.device.type == "cpu":
        return mat_nearest_plain(feats, weights, t_min, bt, active)
    if feats.device.type != "cuda":
        raise ValueError(f"mat_nearest runs on cpu or cuda, not {feats.device}")
    return mat_nearest_cuda(feats.contiguous(), weights, t_min, bt, active,
                            table)


@torch.no_grad()
def mat_occluded(feats, max_t, weights, t_min, bt: int = BT, active=None,
                 table=None):
    """Any hit with t in (t_min, max_t) per ray → bool [N]."""
    if feats.device.type == "cpu":
        return mat_occluded_plain(feats, max_t, weights, t_min, bt, active)
    if feats.device.type != "cuda":
        raise ValueError(f"mat_occluded runs on cpu or cuda, not "
                         f"{feats.device}")
    return mat_occluded_cuda(feats.contiguous(), max_t.contiguous(), weights,
                             t_min, bt, active, table)


def mat_nearest_cuda(feats, weights, t_min, bt: int = BT, active=None,
                     table=None):
    """Launch the nearest kernel (K4a) on the current stream over `table`,
    the packed `weights` (packed now when None). Raises on any input the
    kernel does not take, on a table packed from other weights, and on a
    refused launch."""
    return _launch(feats, None, weights, t_min, bt, active, table)


def mat_occluded_cuda(feats, max_t, weights, t_min, bt: int = BT,
                      active=None, table=None):
    """Launch the any-hit kernel (K4b) on the current stream."""
    return _launch(feats, max_t, weights, t_min, bt, active, table)


def _table_size(weights, bt: int) -> int:
    """Tp of a [16, 4·Tp] weight table laid out in blocks of `bt`."""
    ncols = weights.shape[-1]
    if bt <= 0 or ncols % (4 * bt):
        raise ValueError(f"weights with {ncols} columns are not blocks of "
                         f"4 × {bt}")
    return ncols // 4


def checked_table(weights, bt: int, table=None) -> MatTable:
    """`table` if it is the packed form of `weights` in blocks of `bt`, as
    the kernel takes it; a new one when None. Raises ValueError on a table
    packed from other weights or before they changed (stale), and on rows
    of another type, shape or device (`launch_search` refuses misaligned
    ones)."""
    if table is None:
        return pack_mat_table(weights, bt)
    if table.bt != bt or table.source != _source(weights):
        raise ValueError("stale packed table: packed from other weights "
                         f"(bt {table.bt}) than these (bt {bt}), or they "
                         "changed since")
    check_arg("table.rows", table.rows, torch.float32,
              (_table_size(weights, bt), _ROW), weights.device)
    return table


def _launch(feats, max_t, weights, t_min, bt, active, table):
    global launches, occluded_launches
    n = feats.shape[0]
    dev = feats.device
    if dev.type != "cuda":
        raise ValueError(f"the mat kernels need CUDA tensors, got {dev}")
    if n >= (1 << 31) // _F:
        raise ValueError(f"too many rays for one launch: {n}")
    f32 = torch.float32
    tp = _table_size(weights, bt)
    check_arg("feats", feats, f32, (n, _F), dev)
    check_arg("weights", weights, f32, (_F, 4 * tp), dev)
    table = checked_table(weights, bt, table)
    out, launched = launch_search("rt_mat_trace", (feats,), max_t, active,
                                  table.rows, tp, t_min)
    if launched and max_t is None:
        launches += 1
    elif launched:
        occluded_launches += 1
    return out


def _quantity(f, wq, rows):
    """Σ_k f[:, k] · wq[k] over a quantity's non-zero weight rows, in
    ascending order (the kernel's order) → [m, c]."""
    acc = f[:, rows[0]:rows[0] + 1] * wq[rows[0]:rows[0] + 1]
    for k in rows[1:]:
        acc = acc + f[:, k:k + 1] * wq[k:k + 1]
    return acc


def _epilogue(det, un, vn, tn, t_min):
    """The reference's `_epilogue`: MT's validity tests → t (+inf misses)."""
    ok = torch.abs(det) > DET_EPS
    inv = torch.where(ok, 1.0, 0.0) / torch.where(ok, det, 1.0)
    u = un * inv
    v = vn * inv
    t = tn * inv
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > t_min)
    return torch.where(ok, t, INF)


def _candidates(f, weights, tp: int, bt: int, t_min):
    """Candidate t's of rays `f` [m, 16] in triangle chunks → (first id,
    [m, c] t's), chunks inside one weight block."""
    for b in range(tp // bt):
        for s in range(0, bt, _TRI_CHUNK):
            e = min(s + _TRI_CHUNK, bt)
            q = [weights[:, (4 * b + k) * bt + s:(4 * b + k) * bt + e]
                 for k in range(4)]
            det, un, vn, tn = (_quantity(f, w, rows)
                               for w, rows in zip(q, _ROWS))
            tn = tn + q[3][9:10]  # row 9 against the constant feature 1
            yield b * bt + s, _epilogue(det, un, vn, tn, t_min)


def _sweeping(feats, active):
    """The lanes that sweep: `active` ones whose features f0…f9 are all
    finite (None: all of them). The others miss without a test, as the
    full product's NaN makes them miss."""
    finite = torch.isfinite(feats[:, :_USED]).all(dim=1)
    if active is None:
        return None if bool(finite.all()) else finite
    return active.to(feats.device) & finite


@torch.no_grad()
def mat_nearest_plain(feats, weights, t_min, bt: int = BT, active=None):
    """The plain version of `mat_nearest`, on any device."""
    n, dev = feats.shape[0], feats.device
    tp = _table_size(weights, bt)
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    for lanes in lane_chunks(n, _sweeping(feats, active), _RAY_CHUNK, dev):
        f = feats[lanes]
        bt_, bi = best_t[lanes], best_i[lanes]
        for off, ts in _candidates(f, weights, tp, bt, t_min):
            bt_, bi = fold_nearest(ts, off, bt_, bi)
        best_t[lanes], best_i[lanes] = bt_, bi
    return best_t, best_i


@torch.no_grad()
def mat_occluded_plain(feats, max_t, weights, t_min, bt: int = BT,
                       active=None, stats=None):
    """The plain version of `mat_occluded`, on any device. With a `stats`
    dict, adds "tests": the ray–triangle tests the kernel's early exit
    leaves (as `pallas_trace.tri_occluded_plain` counts them)."""
    n, dev = feats.shape[0], feats.device
    tp = _table_size(weights, bt)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    for lanes in lane_chunks(n, _sweeping(feats, active), _RAY_CHUNK, dev):
        f, mx = feats[lanes], max_t[lanes]
        hit, tests = occ[lanes], None
        for off, ts in _candidates(f, weights, tp, bt, t_min):
            hit, tests = fold_occluded(ts, mx, off, hit, tests, stats)
        occ[lanes] = hit
        count_tests(stats, tests, hit, tp)
    return occ


class MatTracer:
    """Tracer: the linear-expansion triangle sweep (the K4 kernels on the
    card) + dense spheres/planes, on one device.

    Nearest hits are finalized: the search's winner id indexes the exact
    triangle SoA and `geometry.triangle_tuv` recomputes the canonical f32
    hit distance, so Hit.t matches the other tracers bit for bit off knife
    edges.
    """

    def __init__(self, scene: Scene, device):
        self.device = torch.device(device)
        self._base = scene.replace(meshes=Meshes.empty()).to(self.device)
        v0, e1, e2 = (np.asarray(a, np.float32)
                      for a in scene.meshes.tri_soa())
        w, c = build_tri_weights(v0, e1, e2)
        self._w, self._center = w.to(self.device), c.to(self.device)
        self._table = pack_mat_table(self._w)
        self._soa = tuple(torch.from_numpy(a).to(self.device)
                          for a in (v0, e1, e2))

    @staticmethod
    def build(scene: Scene, device) -> "MatTracer":
        return MatTracer(scene, device)

    def _finalize(self, orig, direc, tb, ib, t_min):
        """Exact-MT recompute of the winner's t (the canonical fp value)."""
        v0, e1, e2 = self._soa
        hit = torch.isfinite(tb)
        idx = torch.where(hit, ib, 0)
        te, _, _ = geom.triangle_tuv(orig, direc, v0[idx], e1[idx], e2[idx],
                                     t_min)
        return torch.where(hit & torch.isfinite(te), te, INF)

    @torch.no_grad()
    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        base = trace_ops.nearest_hit(self._base, orig, direc, t_min, tri_chunk)
        feats = ray_features(orig, direc, self._center)
        tb, ib = mat_nearest(feats, self._w, t_min, BT, active, self._table)
        tb = self._finalize(orig, direc, tb, ib, t_min)
        return trace_ops.merge_triangles(base, tb, ib)

    @torch.no_grad()
    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        occ = trace_ops.occluded(self._base, orig, direc, max_t, t_min,
                                 tri_chunk)
        feats = ray_features(orig, direc, self._center)
        return occ | mat_occluded(feats, max_t, self._w, t_min, BT, active,
                                  self._table)
