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
plain version. The kernel is built without multiply-add contraction, so its
t equals the plain version's bit for bit on the same device.
"""

import torch

from raytracer_tpu_torch.core.types import Meshes, Scene
from raytracer_tpu_torch.kernels.build import check_arg, launch_search
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops import trace as trace_ops

DET_EPS = 1e-8  # the kernels' |det| threshold (geometry's _DET_EPS)
INF = geom.INF

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
                                  active, tri_planar, (tp,), t_min)
    if launched and max_t is None:
        launches += 1
    elif launched:
        occluded_launches += 1
    return out


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


class PallasTracer:
    """Tracer: brute-force triangles (the K3 kernels on the card) + dense
    spheres/planes, on one device. The name is the reference's."""

    def __init__(self, scene: Scene, device):
        self.device = torch.device(device)
        # spheres and planes stay in the dense search
        self._base = scene.replace(meshes=Meshes.empty()).to(self.device)
        self._tri = pack_tris(*scene.meshes.tri_soa()).to(self.device)

    @torch.no_grad()
    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        base = trace_ops.nearest_hit(self._base, orig, direc, t_min, tri_chunk)
        tb, ib = tri_nearest(orig, direc, self._tri, t_min, active)
        return trace_ops.merge_triangles(base, tb, ib)

    @torch.no_grad()
    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        occ = trace_ops.occluded(self._base, orig, direc, max_t, t_min,
                                 tri_chunk)
        return occ | tri_occluded(orig, direc, max_t, self._tri, t_min, active)
