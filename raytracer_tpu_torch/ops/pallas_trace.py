"""Brute-force triangle search: every ray against every triangle, nearest
(K3a) or any-hit (K3b). The CUDA kernel (`csrc/tri_trace.cu`) and its plain
torch version, behind one dispatcher, and the tracer built on them.

Counterpart of `raytracer_tpu/ops/pallas_trace.py` (the TPU kernels
`_make_nearest_kernel` and `_make_occluded_kernel`). Same contract:
- triangles enter as the [9, Tp] planar table of `pack_tris` (rows
  v0|e1|e2 × xyz, padded with degenerate triangles that never hit);
- Möller–Trumbore in the op order of the reference's `_mt_tile` (which is
  `geometry.triangle_tuv`'s);
- `tri_nearest` → (t [N] f32, +inf on a miss; idx [N] i32, 0 on a miss),
  the first index winning exact-t ties;
- `tri_occluded` → bool [N], true when any t lies in (t_min, max_t).

Unlike the reference, both take an `active` mask, as the walk does: a
masked lane returns t = +inf, idx 0 and not occluded, and costs no triangle
work. The renderer reads masked lanes' results nowhere.

`tri_nearest`/`tri_occluded` dispatch on the rays' device: a CUDA tensor
launches the kernel (or raises; there is no fallback), a CPU tensor runs the
plain version. The kernel reads the table packed per triangle
(`pack_tri_rows`: v0|e1|e2 in a 48-byte row, packed at each launch) and
takes Möller–Trumbore's quantities in stages, going on only while the test
can still hit (`tri_stages` mirrors them: |det| > eps, then u's sign and
u ≤ 1 from u·det, then t's and v's signs before the reciprocal). Where it
stops, the plain version's full epilogue misses too (tests hold the stages
to it). The kernel is built without multiply-add contraction, computes
every quantity in the plain version's order and takes a correctly rounded
reciprocal, so its t equals the plain version's bit for bit on the same
device.
"""

import torch

from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.kernels.build import check_arg, launch_search
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops import trace as trace_ops
from raytracer_tpu_torch.ops.safemath import cross, dot

DET_EPS = 1e-8  # the kernels' |det| threshold (geometry's _DET_EPS)
INF = geom.INF
_ROW = 12  # floats per packed triangle: v0 | e1 | e2 | 0, 0, 0
# The kernel's stage thresholds (csrc/tri_trace.cu): below |det| = 2^64 a
# u·det or v·det of det's other sign and at least 2^-80 makes u or v
# negative, and u·det (or, in any-hit mode, u·det + v·det) above
# |det|·(1 + 2^-20) makes u (or u + v) round above 1.
DET_BIG = 2.0 ** 64
UV_TINY = 2.0 ** -80
UV_CUT = 1.0 + 2.0 ** -20

# Kernel launches since the last reset: nearest (K3a) and any-hit (K3b).
# Incremented only where a kernel is launched; callers that must show the
# kernel ran set them to 0 and read them.
launches = 0
occluded_launches = 0

# The plain version's chunks: [rays, tris] candidate tensors of at most
# 2^25 elements (128 MiB each in f32).
_RAY_CHUNK = 1 << 14
_TRI_CHUNK = 2048


def pack_tris(v0, e1, e2, bt: int = 512) -> torch.Tensor:
    """Triangle SoA ([T,3] each) → [9, Tp] f32 planar table on v0's device,
    Tp = T rounded up to a multiple of `bt` (at least one block), the
    padding all-zero (degenerate) triangles."""
    v0, e1, e2 = (torch.as_tensor(a, dtype=torch.float32) for a in (v0, e1, e2))
    t = v0.shape[0]
    tp = max(-(-t // bt), 1) * bt
    planar = torch.zeros((9, tp), dtype=torch.float32, device=v0.device)
    planar[:, :t] = torch.cat([v0.T, e1.T, e2.T])
    return planar


def lane_chunks(n: int, active, chunk: int, device):
    """The lanes a plain version must compute, in chunks of ≤ `chunk`:
    slices of all N lanes, or index tensors of the active ones."""
    if active is None:
        return [slice(s, min(s + chunk, n)) for s in range(0, n, chunk)]
    lanes = torch.nonzero(active.to(device)).squeeze(1)
    return [lanes[s:s + chunk] for s in range(0, lanes.shape[0], chunk)]


def fold_nearest(ts, off, bt, bi):
    """Fold a [m, c] block of candidate t's (columns = triangle ids off…)
    into the running (bt, bi): first index among the block's minima, then
    strict `<`, so the lowest id wins exact-t ties overall."""
    tc = ts.amin(dim=1)
    col = torch.arange(ts.shape[1], dtype=torch.int32, device=ts.device)
    ic = torch.where(ts <= tc[:, None], col, ts.shape[1]).amin(dim=1) + off
    better = tc < bt
    return torch.where(better, tc, bt), torch.where(better, ic, bi)


@torch.no_grad()
def tri_nearest(orig, direc, tri_planar, t_min, active=None):
    """Nearest triangle hit of every ray → (t [N] f32, idx [N] i32)."""
    if orig.device.type == "cpu":
        return tri_nearest_plain(orig, direc, tri_planar, t_min, active)
    if orig.device.type != "cuda":
        raise ValueError(f"tri_nearest runs on cpu or cuda, not {orig.device}")
    return tri_nearest_cuda(orig.contiguous(), direc.contiguous(), tri_planar,
                            t_min, active)


@torch.no_grad()
def tri_occluded(orig, direc, max_t, tri_planar, t_min, active=None):
    """Any triangle hit with t in (t_min, max_t) per ray → bool [N]."""
    if orig.device.type == "cpu":
        return tri_occluded_plain(orig, direc, max_t, tri_planar, t_min,
                                  active)
    if orig.device.type != "cuda":
        raise ValueError(f"tri_occluded runs on cpu or cuda, not {orig.device}")
    return tri_occluded_cuda(orig.contiguous(), direc.contiguous(),
                             max_t.contiguous(), tri_planar, t_min, active)


def tri_nearest_cuda(orig, direc, tri_planar, t_min, active=None):
    """Launch the nearest kernel (K3a) on the current stream. Raises on any
    input the kernel does not take and on a refused launch."""
    return _launch(orig, direc, None, tri_planar, t_min, active)


def tri_occluded_cuda(orig, direc, max_t, tri_planar, t_min, active=None):
    """Launch the any-hit kernel (K3b) on the current stream."""
    return _launch(orig, direc, max_t, tri_planar, t_min, active)


def pack_tri_rows(tri_planar) -> torch.Tensor:
    """The kernel's packed table of a [9, Tp] planar table, on its device:
    [Tp, 12] f32, each triangle v0|e1|e2 and three zeros in one contiguous
    48-byte row (three 16-byte loads)."""
    rows = tri_planar.new_zeros((tri_planar.shape[1], _ROW))
    rows[:, :9] = tri_planar.T
    return rows


def _launch(orig, direc, max_t, tri_planar, t_min, active):
    global launches, occluded_launches
    n = orig.shape[0]
    dev = orig.device
    if dev.type != "cuda":
        raise ValueError(f"the triangle kernels need CUDA tensors, got {dev}")
    if n >= (1 << 31) // 3:
        raise ValueError(f"too many rays for one launch: {n}")
    f32 = torch.float32
    tp = tri_planar.shape[-1]
    check_arg("orig", orig, f32, (n, 3), dev)
    check_arg("direc", direc, f32, (n, 3), dev)
    check_arg("tri_planar", tri_planar, f32, (9, tp), dev)
    out, launched = launch_search("rt_tri_trace", (orig, direc), max_t,
                                  active, pack_tri_rows(tri_planar), tp,
                                  t_min)
    if launched and max_t is None:
        launches += 1
    elif launched:
        occluded_launches += 1
    return out


def tri_stages(orig, direc, v0, e1, e2, t_min, occlusion: bool):
    """The kernel's stages of each ray–triangle test (csrc/tri_trace.cu),
    mirrored in torch: [N,3] rays × [T,3] triangles → (past_det, past_u,
    into_rcp, t), each [N, T]: `stage_masks` of Möller–Trumbore's
    quantities, and t as the plain version computes it (+inf on a miss).
    Every quantity is computed in the kernel's (and the plain version's)
    order."""
    o, d = orig[:, None, :], direc[:, None, :]
    v0, e1, e2 = v0[None], e1[None], e2[None]
    pv = cross(d, e2)
    det = dot(e1, pv)
    tv = o - v0
    un = dot(tv, pv)
    qv = cross(tv, e1)
    vn = dot(d, qv)
    tn = dot(e2, qv)
    past_det, past_u, into_rcp = stage_masks(det, un, vn, tn, t_min,
                                             occlusion)
    inv = torch.where(past_det, 1.0, 0.0) / torch.where(past_det, det, 1.0)
    u, v, t = un * inv, vn * inv, tn * inv
    hit = (past_det & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
           & (t > t_min))
    return past_det, past_u, into_rcp, torch.where(hit, t, INF)


def stage_masks(det, un, vn, tn, t_min, occlusion: bool):
    """The kernel's stage predicates on det, u·det, v·det and t·det →
    (past_det, past_u, into_rcp): the tests with |det| > eps; of those,
    the ones u·det leaves (|det| > 2^64, or u·det of det's sign in
    [-2^-80, |det|·(1 + 2^-20)]); of those, the ones t·det (of det's sign
    above 0 where t_min ≥ 0, else above -inf) and v·det (as u·det, and in
    any-hit mode u·det + v·det at most |det|·(1 + 2^-20)) leave, which take
    the reciprocal and the epilogue. A test outside `into_rcp` misses in
    the epilogue (tests/test_torch_pallas_trace.py)."""
    ad = torch.abs(det)
    past_det = ad > DET_EPS
    pos, small = det > 0, ~(ad > DET_BIG)
    uns, vns, tns = (torch.where(pos, x, -x) for x in (un, vn, tn))
    past_u = past_det & (~small | ((uns >= -UV_TINY) & ~(uns > ad * UV_CUT)))
    v_ok = vns >= -UV_TINY
    if occlusion:
        v_ok = v_ok & ~(uns + vns > ad * UV_CUT)
    lim = 0.0 if t_min >= 0 else -INF
    return past_det, past_u, past_u & (tns > lim) & (~small | v_ok)


def _tri_chunks(tri_planar):
    tp = tri_planar.shape[1]
    v0, e1, e2 = tri_planar[0:3].T, tri_planar[3:6].T, tri_planar[6:9].T
    for s in range(0, tp, _TRI_CHUNK):
        yield s, v0[s:s + _TRI_CHUNK], e1[s:s + _TRI_CHUNK], e2[s:s + _TRI_CHUNK]


@torch.no_grad()
def tri_nearest_plain(orig, direc, tri_planar, t_min, active=None):
    """The plain version of `tri_nearest`, on any device."""
    n, dev = orig.shape[0], orig.device
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    for lanes in lane_chunks(n, active, _RAY_CHUNK, dev):
        o, d = orig[lanes], direc[lanes]
        bt, bi = best_t[lanes], best_i[lanes]
        for off, v0, e1, e2 in _tri_chunks(tri_planar):
            ts, _, _ = geom.triangle_hits(o, d, v0, e1, e2, t_min)
            bt, bi = fold_nearest(ts, off, bt, bi)
        best_t[lanes], best_i[lanes] = bt, bi
    return best_t, best_i


@torch.no_grad()
def tri_occluded_plain(orig, direc, max_t, tri_planar, t_min, active=None,
                       stats=None):
    """The plain version of `tri_occluded`, on any device. With a `stats`
    dict, adds "tests": the ray–triangle tests the kernel's early exit
    leaves, each live lane's triangles up to its first occluder."""
    n, dev = orig.shape[0], orig.device
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    for lanes in lane_chunks(n, active, _RAY_CHUNK, dev):
        o, d, mx = orig[lanes], direc[lanes], max_t[lanes]
        hit, tests = occ[lanes], None
        for off, v0, e1, e2 in _tri_chunks(tri_planar):
            ts, _, _ = geom.triangle_hits(o, d, v0, e1, e2, t_min)
            hit, tests = fold_occluded(ts, mx, off, hit, tests, stats)
        occ[lanes] = hit
        count_tests(stats, tests, hit, tri_planar.shape[1])
    return occ


def fold_occluded(ts, mx, off, hit, tests, stats):
    """Fold a [m, c] block of candidate t's (triangle ids off…) into the
    running any-hit bits; with `stats`, also each lane's test count up to
    its first occluder."""
    below = ts < mx[:, None]
    now = below.any(dim=1)
    if stats is not None:
        first = below.to(torch.int32).argmax(dim=1) + off + 1
        tests = torch.where(now & ~hit, first, 0 if tests is None else tests)
    return hit | now, tests


def count_tests(stats, tests, hit, n_tris: int):
    """Add a chunk's tests to `stats`: the counted ones of occluded lanes,
    all `n_tris` of the others."""
    if stats is not None:
        stats["tests"] = stats.get("tests", 0) + int(
            torch.where(hit, tests, n_tris).sum())


class PallasTracer(trace_ops.MeshTracer):
    """Tracer: brute-force triangles (the K3 kernels on the card) + dense
    spheres/planes, on one device. The name is the reference's."""

    def __init__(self, scene: Scene, device):
        super().__init__(scene, device)
        self._tri = pack_tris(*scene.meshes.tri_soa()).to(self.device)

    def _triangles(self, orig, direc, t_min, max_t, active):
        if max_t is None:
            return tri_nearest(orig, direc, self._tri, t_min, active)
        return tri_occluded(orig, direc, max_t, self._tri, t_min, active)
