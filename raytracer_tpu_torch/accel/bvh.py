"""BVH acceleration: host build → per-octant threaded links → stackless walk
(counterpart of `raytracer_tpu/accel/bvh.py`).

- Host build (NumPy, or the native library's median build when it loads):
  median split on the widest centroid axis, or binned SAH (`sah=True`,
  NumPy only); leaves hold at most `leaf_size` triangles, sentinel-padded
  with id n_tris. The arrays equal the reference build's byte for byte.
- Threaded traversal, no stack: each node has a hit link (the next node
  when its box is hit) and a miss link (where to go when it is not), for
  each of the 8 ray-direction octants, so that a ray visits the near child
  first and its best hit prunes the far one.
- The walk is integer-only and runs under `torch.no_grad()`; gradients come
  from recomputing the winner (ops/trace.surface_at). `bvh_walk` here is its
  plain torch version; `ops/bvh_walk.py` holds the CUDA kernel and
  `bvh_trace`, which picks one of the two by the rays' device.

`build_stacked_bvh` builds one tree per primitive shard for the sharded
and ring tracers (parallel/tracer.py). Not ported: the pregathered leaf
layout `leaf_soa` (a TPU gather-count layout; the kernel reads its own
packed table, ops/bvh_walk.pack_bvh_table).
"""

import dataclasses
import math

import numpy as np
import torch

from raytracer_tpu_torch.core.types import Scene
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops import trace as trace_ops

INF = math.inf
# lanes per chunk of the plain walk: bounds its [lanes, C, 3] gathers
_REF_CHUNK = 1 << 20


@dataclasses.dataclass
class BVHData:
    """Threaded-BVH tensors on one device + static metadata."""

    aabb6: torch.Tensor      # [n_nodes, 6] f32 box min | max
    links2: torch.Tensor     # [8 * n_nodes, 2] i32 hit | miss link per
    #                          octant (row octant · n_nodes + node)
    leaf_tris: torch.Tensor  # [n_nodes, C] i32 triangle ids, sentinel n_tris
    n_nodes: int             # link sentinel value = n_nodes (walk done)
    capacity: int            # C
    n_tris: int              # sentinel id (= index of the degenerate pad tri)


def _pack_fused(amin, amax, hit, miss):
    """Boxes [n, 6] and links [8n, 2], packed at build."""
    aabb6 = np.concatenate([np.asarray(amin, np.float32),
                            np.asarray(amax, np.float32)], axis=1)
    links2 = np.stack([np.asarray(hit).reshape(-1),
                       np.asarray(miss).reshape(-1)], axis=1)
    return aabb6, links2


_SAH_BINS = 16


def _sah_split(c, bmin, bmax, leaf_size):
    """Binned SAH over a node's triangles → (axis, mid_offset, perm).

    c/bmin/bmax: [k,3] centroids and per-triangle boxes. 16 centroid bins
    per axis, the split plane minimising Σ count · surface area of the two
    children (Wald 2007). A node whose centroids coincide on every axis
    takes the median split."""
    k = c.shape[0]
    best = (None, None, np.inf)  # (axis, bin, cost)
    binned = {}
    for ax in range(3):
        lo, hi = c[:, ax].min(), c[:, ax].max()
        if hi <= lo:
            continue
        b = np.minimum(((c[:, ax] - lo) * (_SAH_BINS / (hi - lo))).astype(
            np.int64), _SAH_BINS - 1)
        binned[ax] = b
        counts = np.bincount(b, minlength=_SAH_BINS)
        bn_min = np.full((_SAH_BINS, 3), np.inf)
        bn_max = np.full((_SAH_BINS, 3), -np.inf)
        np.minimum.at(bn_min, b, bmin)
        np.maximum.at(bn_max, b, bmax)

        def area(mn, mx):
            d = np.maximum(mx - mn, 0.0)
            return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

        lmin = np.minimum.accumulate(bn_min, axis=0)
        lmax = np.maximum.accumulate(bn_max, axis=0)
        rmin = np.minimum.accumulate(bn_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(bn_max[::-1], axis=0)[::-1]
        nl = np.cumsum(counts)[:-1]                 # after bin i, i=0..B-2
        nr = k - nl
        cost = np.where(
            (nl > 0) & (nr > 0),
            nl * area(lmin[:-1], lmax[:-1]) + nr * area(rmin[1:], rmax[1:]),
            np.inf)
        i = int(np.argmin(cost))
        if cost[i] < best[2]:
            best = (ax, i, float(cost[i]))
    if best[0] is None:  # fully degenerate node: median on the widest axis
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        perm = np.argsort(c[:, ax], kind="stable")
        return ax, k // 2, perm
    ax, i, _ = best
    go_right = binned[ax] > i
    perm = np.argsort(go_right, kind="stable")  # left block first, stable
    return ax, int(k - go_right.sum()), perm


def _build_numpy(verts, tris, leaf_size: int, sah: bool):
    """The NumPy build → (amin [n,3] f64, amax, leaf [n,C] i32, hit [8n],
    miss [8n] i32)."""
    t = tris.shape[0]
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64)
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    cent = (tmin + tmax) * 0.5

    aabb_min, aabb_max, left, right, axis, leaf_rows = [], [], [], [], [], []
    order = np.arange(t)

    def alloc() -> int:
        aabb_min.append(np.zeros(3))
        aabb_max.append(np.zeros(3))
        left.append(-1)
        right.append(-1)
        axis.append(0)
        leaf_rows.append(np.full((leaf_size,), t, np.int32))
        return len(aabb_min) - 1

    # depth-first with an explicit stack: deep meshes must not hit Python's
    # recursion limit
    root = alloc()
    stack = [(root, 0, t)]
    while stack:
        node, lo, hi = stack.pop()
        ids = order[lo:hi]
        aabb_min[node] = tmin[ids].min(axis=0)
        aabb_max[node] = tmax[ids].max(axis=0)
        if hi - lo <= leaf_size:
            leaf_rows[node][: hi - lo] = ids.astype(np.int32)
            continue
        c = cent[ids]
        if sah:
            ax, mid_off, perm = _sah_split(c, tmin[ids], tmax[ids], leaf_size)
        else:
            ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            perm = np.argsort(c[:, ax], kind="stable")  # deterministic
            mid_off = (hi - lo) // 2
        axis[node] = ax
        order[lo:hi] = ids[perm]
        mid = lo + mid_off
        l, r = alloc(), alloc()
        left[node], right[node] = l, r
        stack.append((r, mid, hi))
        stack.append((l, lo, mid))

    n = len(aabb_min)
    ax_arr = np.asarray(axis, np.int32)
    l_arr = np.asarray(left, np.int32)
    r_arr = np.asarray(right, np.int32)
    # per-octant threading: octant bit a is 1 when dir[a] < 0; at a node
    # split on axis a the near child is `left` (lower centroids) for a
    # positive direction. hit descends near-first, miss escapes the subtree.
    hit = np.full((8, n), n, np.int32)
    miss = np.full((8, n), n, np.int32)
    for o in range(8):
        tstack = [(root, n)]
        while tstack:
            node, escape = tstack.pop()
            if l_arr[node] < 0:  # leaf: after its triangles, escape
                hit[o, node] = escape
                miss[o, node] = escape
                continue
            bit = (o >> ax_arr[node]) & 1
            near = l_arr[node] if bit == 0 else r_arr[node]
            far = r_arr[node] if bit == 0 else l_arr[node]
            hit[o, node] = near
            miss[o, node] = escape
            tstack.append((far, escape))
            tstack.append((near, far))
    return (np.stack(aabb_min), np.stack(aabb_max), np.stack(leaf_rows),
            hit.reshape(-1), miss.reshape(-1))


def build_bvh(verts, tris, leaf_size: int = 8, sah: bool = False, *,
              device) -> BVHData:
    """Host-side build from concrete arrays; tensors land on `device`.

    Median split on the widest centroid axis (the native build when the
    library loads, else NumPy), or binned SAH (`sah=True`, NumPy only: a
    better tree on unevenly spread geometry, the same walk). Vertices round
    through f32 first, so both builders read the same values."""
    t = np.asarray(tris).shape[0]
    return _to_device(*_build_arrays(verts, tris, leaf_size, sah),
                      leaf_size, t, device)


def _build_arrays(verts, tris, leaf_size: int, sah: bool = False):
    """The host build → (aabb_min [n, 3], aabb_max [n, 3], leaf_tris [n, C],
    hit_link [8n], miss_link [8n]) numpy arrays."""
    from raytracer_tpu_torch.utils.native import native_lib

    t = np.asarray(tris).shape[0]
    if t == 0:
        raise ValueError("BVH over an empty mesh")
    if t >= (1 << 24):
        # the kernel's table carries ids as f32, exact only below 2^24
        raise ValueError(f"BVH supports < 2^24 triangles, got {t}")
    verts = np.asarray(verts, np.float32)
    lib = None if sah else native_lib()
    if lib is not None and lib.has_bvh:
        return lib.bvh_build(verts, np.asarray(tris, np.int32), leaf_size)
    return _build_numpy(verts, np.asarray(tris), leaf_size, sah)


def _to_device(amin, amax, leaf, hit, miss, leaf_size: int, n_tris: int,
               device) -> BVHData:
    aabb6, links2 = _pack_fused(amin, amax, hit, miss)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return BVHData(aabb6=dev(aabb6), links2=dev(links2.astype(np.int32)),
                   leaf_tris=dev(np.asarray(leaf, np.int32)),
                   n_nodes=aabb6.shape[0], capacity=leaf_size, n_tris=n_tris)


def build_stacked_bvh(v0, e1, e2, n_shards: int, leaf_size: int = 8):
    """Per-shard BVHs over equal contiguous triangle chunks → stacked host
    arrays (the reference's `build_stacked_bvh`, array for array).

    For the primitive-sharded and ring tracers (parallel/tracer.py): the
    padded (v0, e1, e2) [T, 3] SoA splits into `n_shards` equal chunks (the
    split `parallel.tracer.pad_trace_geom` makes over the prims ranks); each
    chunk gets its own BVH with LOCAL triangle ids, and the trees are padded
    to a common node count so that every shard's tables have one shape (the
    ring sends them from rank to rank). Shorter trees' done-sentinel links
    are remapped to the common n_nodes; pad nodes carry inverted boxes
    (never hit) and sentinel links and leaves, so no walk reaches them.

    → {"aabb_min", "aabb_max": [S, n, 3] f32, "leaf_tris": [S, n, C] i32,
    "hit_link", "miss_link": [S, 8n] i32, "n_nodes": n, "capacity": C,
    "tris_per_shard": T / S}. `stacked_shard` turns shard s into a BVHData.
    """
    v0 = np.asarray(v0, np.float32)
    t_total = v0.shape[0]
    if t_total % n_shards:
        raise ValueError(f"{t_total} triangles do not split into {n_shards} "
                         "equal shards: pad them first")
    ts = t_total // n_shards
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    parts = []
    for s in range(n_shards):
        sl = slice(s * ts, (s + 1) * ts)
        # a vertex soup per chunk: triangle i is (i, i + ts, i + 2·ts)
        verts = np.concatenate([v0[sl], v0[sl] + e1[sl], v0[sl] + e2[sl]])
        tris = np.stack([np.arange(ts), np.arange(ts) + ts,
                         np.arange(ts) + 2 * ts], axis=1).astype(np.int32)
        parts.append(_build_arrays(verts, tris, leaf_size))

    n_max = max(p[0].shape[0] for p in parts)
    S = n_shards
    amin = np.full((S, n_max, 3), 1.0, np.float32)   # inverted box
    amax = np.full((S, n_max, 3), -1.0, np.float32)  # (min > max: no hit)
    leaf = np.full((S, n_max, leaf_size), ts, np.int32)
    hit = np.full((S, 8 * n_max), n_max, np.int32)
    miss = np.full((S, 8 * n_max), n_max, np.int32)
    for s, (p_min, p_max, p_leaf, p_hit, p_miss) in enumerate(parts):
        n = p_min.shape[0]
        amin[s, :n] = p_min
        amax[s, :n] = p_max
        leaf[s, :n] = p_leaf
        for out, lk in ((hit, p_hit), (miss, p_miss)):
            lk = np.asarray(lk).reshape(8, n)
            lk = np.where(lk == n, n_max, lk)  # done-sentinel → common one
            out[s] = np.pad(lk, ((0, 0), (0, n_max - n)),
                            constant_values=n_max).reshape(-1)
    return {"aabb_min": amin, "aabb_max": amax, "leaf_tris": leaf,
            "hit_link": hit, "miss_link": miss, "n_nodes": n_max,
            "capacity": leaf_size, "tris_per_shard": ts}


def stacked_shard(stacked: dict, s: int, device) -> BVHData:
    """Shard `s` of `build_stacked_bvh`'s arrays as a BVHData on `device`
    over that shard's local triangle ids."""
    return _to_device(*(stacked[k][s] for k in (
        "aabb_min", "aabb_max", "leaf_tris", "hit_link", "miss_link")),
        stacked["capacity"], stacked["tris_per_shard"], device)


def _pad_soa(v0, e1, e2):
    """Append the degenerate zero triangle (always a miss) at index T."""
    z = v0.new_zeros((1, 3))
    return torch.cat([v0, z]), torch.cat([e1, z]), torch.cat([e2, z])


@torch.no_grad()
def bvh_walk(bvh: BVHData, v0, e1, e2, orig, direc, t_min,
             occlusion_max_t=None, active=None, stats=None):
    """Stackless threaded walk, plain torch → (best_t [N] f32, best_idx [N]
    i32); (v0, e1, e2) [T, 3] is the mesh's Möller–Trumbore layout.

    Per step a walking lane tests its node's box (slab test, entry clamped
    to t_min; a box counts as hit when it is entered before the bound:
    best_t, or max_t in any-hit mode), tests the node's leaf triangles if
    it is hit (an inner node's row is all sentinels), folds the lowest id
    among the step's t-minima into (best_t, best_idx) lexicographically, and
    follows the hit or miss link of its octant. With `occlusion_max_t` [N]
    a lane parks as soon as best_t < max_t (best_t < max_t then means
    occluded). `active` [N] bool parks lanes before the first step: they
    return t = +inf and idx = n_tris. At most n_nodes + 1 steps, as the
    reference's loop. The loop runs on the walking lanes only, so it reads
    their count back from the device each step.

    With a `stats` dict, adds the work the kernel does on these rays:
    "steps" (node visits of walking lanes), "tests" (listed triangles of
    the visited nodes whose box was hit), "max_steps" (the longest walk)
    and sets "lane_steps", this call's node visits of each lane ([N] i64;
    `kernels.build.warp_work` turns them into what warps run).
    """
    n = orig.shape[0]
    dev = orig.device
    nn = bvh.n_nodes
    v0p, e1p, e2p = _pad_soa(v0, e1, e2)
    inv_d = torch.where(torch.abs(direc) > 1e-12, torch.reciprocal(direc),
                        1e12)
    octant = ((direc[:, 0] < 0).to(torch.int64)
              | ((direc[:, 1] < 0).to(torch.int64) << 1)
              | ((direc[:, 2] < 0).to(torch.int64) << 2))
    link_base = octant * nn
    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), bvh.n_tris, dtype=torch.int32, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    if active is not None:
        node = torch.where(active, node, nn)
    lanes = torch.nonzero(node < nn).squeeze(1)
    if stats is not None:
        lane_steps = torch.zeros((n,), dtype=torch.int64, device=dev)
    for s in range(0, lanes.shape[0], _REF_CHUNK):
        idx = lanes[s:s + _REF_CHUNK]
        for _ in range(nn + 1):
            if idx.shape[0] == 0:
                break
            nc = node[idx]
            box = bvh.aabb6[nc]
            o, d, inv = orig[idx], direc[idx], inv_d[idx]
            t0 = (box[:, :3] - o) * inv
            t1 = (box[:, 3:] - o) * inv
            tn = torch.clamp(torch.minimum(t0, t1).amax(dim=1), min=t_min)
            tf = torch.maximum(t0, t1).amin(dim=1)
            bt, bi = best_t[idx], best_i[idx]
            bound = bt if occlusion_max_t is None else occlusion_max_t[idx]
            hit_box = (tn <= tf) & (tf > t_min) & (tn < bound)
            tids = bvh.leaf_tris[nc]                            # [n, C]
            ts, _, _ = geom.triangle_tuv(o[:, None, :], d[:, None, :],
                                         v0p[tids], e1p[tids], e2p[tids],
                                         t_min)
            ts = torch.where(hit_box[:, None], ts, INF)
            tc = ts.amin(dim=1)
            # the lowest id among the step's t-minima, then the
            # lexicographic (t, id) fold across steps
            ic = torch.where(ts <= tc[:, None], tids, bvh.n_tris).amin(dim=1)
            better = (tc < bt) | ((tc == bt) & (ic < bi))
            bt = torch.where(better, tc, bt)
            best_t[idx] = bt
            best_i[idx] = torch.where(better, ic, bi)
            if stats is not None:
                listed = (tids != bvh.n_tris) & hit_box[:, None]
                stats["steps"] = stats.get("steps", 0) + idx.shape[0]
                stats["tests"] = stats.get("tests", 0) + int(listed.sum())
                lane_steps[idx] += 1
            lk = bvh.links2[link_base[idx] + nc]
            nxt = torch.where(hit_box, lk[:, 0], lk[:, 1]).to(torch.int64)
            if occlusion_max_t is not None:
                nxt = torch.where(bt < occlusion_max_t[idx], nn, nxt)
            node[idx] = nxt
            idx = idx[nxt < nn]
    if stats is not None:
        stats["lane_steps"] = lane_steps
        stats["max_steps"] = max(stats.get("max_steps", 0),
                                 int(lane_steps.max()) if n else 0)
    return best_t, best_i


class BVHTracer(trace_ops.MeshTracer):
    """Tracer: BVH-walked triangles + dense spheres/planes, on one device.

    Built on host from a concrete scene (`BVHTracer.build(scene, device)`).
    The walk is the CUDA kernel on the card and the plain version on the CPU
    (ops/bvh_walk.bvh_trace).
    """

    def __init__(self, scene: Scene, bvh: BVHData, device):
        from raytracer_tpu_torch.ops.bvh_walk import pack_bvh_table

        super().__init__(scene, device)
        self._bvh = bvh
        v0, e1, e2 = scene.meshes.to(self.device).tri_soa()
        self._table = pack_bvh_table(bvh, v0, e1, e2)

    @staticmethod
    def build(scene: Scene, device, leaf_size: int = 8,
              sah: bool = False) -> "BVHTracer":
        bvh = build_bvh(np.asarray(scene.meshes.verts),
                        np.asarray(scene.meshes.tris), leaf_size=leaf_size,
                        sah=sah, device=device)
        return BVHTracer(scene, bvh, device)

    def _triangles(self, orig, direc, t_min, max_t, active):
        from raytracer_tpu_torch.ops.bvh_walk import bvh_trace

        tb, ib = bvh_trace(self._bvh, self._table, orig, direc, t_min,
                           occlusion_max_t=max_t, active=active)
        return (tb, ib) if max_t is None else tb < max_t
