"""Per-tile culled triangle sweep (counterpart of `raytracer_tpu/accel/cull.py`).

Instead of walking a grid per ray, cull once per list of rays (a tile) and
test the survivors against every ray of the list:

  1. clip every ray to the mesh AABB (`_segments`, the slab test of
     `grid.walk_init`) and take the union AABB of the clipped segments;
  2. overlap-test all T triangle AABBs against it;
  3. compact the survivors to a `cap`-slot ascending id list (a cumsum and
     a searchsorted per list, `tile_ids`), with the true count beside it;
  4. sweep the list with Möller–Trumbore (`ops/cull_sweep.py`: the CUDA
     kernel on the card, the plain version on the CPU).

The reference culls per call; here steps 1–3 run for many lists at once: a
call of n = g·tile lanes is g lists of `tile` consecutive lanes, each list
built exactly as the reference's call over those lanes builds it.

Exactness: a triangle a ray can hit lies inside the mesh AABB, so its hit
point is on the ray's clipped segment, inside the list's AABB and inside
the triangle's own AABB: the list is a superset of every possible winner,
and the sweep's lexicographic (t, id) minimum equals the grid walk's —
unless the list overflows `cap`. Then the ids past cap are dropped and the
render is wrong; `cull_audit` computes the exact per-tile counts that gate
it.

Only depth-0 calls are culled by default (`cull_depths=(0,)`); the other
calls go to the inner tracer (the grid walk, K5). The tracer's call cursor
maps calls to depths; `renderer.render_rays` resets it per call through the
`per_trace_cursor` protocol (`fresh()`).

The hybrid (`HybridBand`, `render_partitioned`, `hybrid_image`) sweeps the
tiles whose culled lists fit cap ("thin") and walks the rest ("fat"). The
reference scans each class's tiles in one compiled program; here each class
is one wavefront over its tiles' lanes (radiance is lane-local and the d0
lists are per tile, so the image equals the per-tile scan's).
"""

import copy
import dataclasses

import numpy as np
import torch

from raytracer_tpu_torch.ops import cull_sweep as CS
from raytracer_tpu_torch.ops import trace as trace_ops
from raytracer_tpu_torch.ops.safemath import clamp01, dot
from raytracer_tpu_torch.ops.walk import pack_rows

# the reference's defaults (its RT_CULL_CAP and RT_CULL_CHUNK); the chunk
# only rounds cap here (the kernel and the plain version stage 128 rows)
CAP = 1024
CHUNK = 128
_BIG = 3.4e38


@dataclasses.dataclass
class CullData:
    """The cull's tensors on one device."""

    rows: torch.Tensor    # [T+1, 12] f32 v0|e1|e2|id|0|0; sentinel row at T
    tri_lo: torch.Tensor  # [T, 3] f32 per-triangle AABB min
    tri_hi: torch.Tensor  # [T, 3] f32 per-triangle AABB max
    bmin: torch.Tensor    # [3] f32 mesh AABB min (padded)
    bmax: torch.Tensor    # [3] f32 mesh AABB max (padded)
    n_tris: int           # T, the sentinel id
    cap: int              # culled-list capacity, whole chunks
    chunk: int            # the reference's block width (rounds cap)

    @property
    def soa(self) -> torch.Tensor:
        """[T+1, 9] v0|e1|e2 rows, the reference's layout."""
        return self.rows[:, :9]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def build_cull(scene, device, cap: int = CAP, chunk: int = CHUNK) -> CullData:
    """Host build from a concrete scene; tensors land on `device`. `cap`
    is rounded up to whole `chunk`s, as the reference rounds it."""
    cap = -(-cap // chunk) * chunk
    v0, e1, e2 = (np.asarray(_host(a), np.float32)
                  for a in scene.meshes.tri_soa())
    t = v0.shape[0]
    if t == 0:
        raise ValueError("cull over an empty mesh")
    if t >= 1 << 24:
        # ids ride as f32 in column 9 of the packed rows
        raise ValueError(f"cull supports < 2^24 triangles, got {t}")
    v1, v2 = v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2)
    hi = np.maximum(np.maximum(v0, v1), v2)
    bmin = lo.min(axis=0)
    bmax = hi.max(axis=0)
    pad = 1e-4 * float(np.linalg.norm(bmax - bmin)) + 1e-6
    soa = np.concatenate([v0, e1, e2], axis=1)                  # [T, 9]
    soa = np.concatenate([soa, np.zeros((1, 9), np.float32)])   # sentinel
    ids = np.arange(t + 1, dtype=np.float32)[:, None]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return CullData(
        rows=pack_rows(dev(np.concatenate([soa, ids], axis=1))),
        tri_lo=dev(lo), tri_hi=dev(hi), bmin=dev(bmin - pad),
        bmax=dev(bmax + pad), n_tris=t, cap=cap, chunk=chunk)


def _segments(cd: CullData, orig, direc, t_min, max_t=None, active=None):
    """Clip rays to the mesh AABB → (seg_lo, seg_hi [N,3], inside [N]).

    `max_t` (occlusion) also clips at the light distance. Inactive lanes
    and lanes that miss the box have inside=False: they stay out of the
    list's AABB and miss."""
    inv_d = torch.where(direc.abs() > 1e-12, 1.0 / direc, 1e12)
    t0 = (cd.bmin[None, :] - orig) * inv_d
    t1 = (cd.bmax[None, :] - orig) * inv_d
    tlo = torch.clamp(torch.minimum(t0, t1).amax(dim=1), min=0.0)
    thi = torch.maximum(t0, t1).amin(dim=1)
    if max_t is not None:
        thi = torch.minimum(thi, max_t)
    inside = (thi >= tlo) & (thi > t_min)
    if active is not None:
        inside = inside & active
    # a small t pad absorbs the slab test's rounding at the box faces
    eps = 1e-4 * (thi - tlo) + 1e-5
    p0 = orig + (tlo - eps)[:, None] * direc
    p1 = orig + (thi + eps)[:, None] * direc
    return torch.minimum(p0, p1), torch.maximum(p0, p1), inside


def _overlap(cd: CullData, seg_lo, seg_hi, inside):
    """[g, tile, 3] segments, [g, tile] inside → [g, T] bool: the triangles
    whose AABB overlaps each list's union AABB."""
    lo = torch.where(inside[..., None], seg_lo, _BIG).amin(dim=1)    # [g, 3]
    hi = torch.where(inside[..., None], seg_hi, -_BIG).amax(dim=1)
    return ((cd.tri_lo[None] <= hi[:, None]).all(dim=2)
            & (cd.tri_hi[None] >= lo[:, None]).all(dim=2))


def _count_overlap(cd: CullData, seg_lo, seg_hi, inside):
    """Each list's true survivor count → [g] i32."""
    return _overlap(cd, seg_lo, seg_hi, inside).sum(dim=1, dtype=torch.int32)


def tile_ids(cd: CullData, seg_lo, seg_hi, inside):
    """Union-AABB cull and compaction of g lists at once ([g, tile, 3]
    segments, [g, tile] inside) → (ids [g, cap] i32, count [g] i32).

    Each row of ids is ascending; slots past the count hold the sentinel T
    (the first index whose cumsum reaches the slot: past the end, T).
    `count` is the TRUE number of survivors: above cap the list is cut."""
    overlap = _overlap(cd, seg_lo, seg_hi, inside)
    cs = torch.cumsum(overlap, dim=1, dtype=torch.int32)
    q = torch.arange(1, cd.cap + 1, dtype=torch.int32, device=cs.device)
    ids = torch.searchsorted(cs, q.expand(cs.shape[0], cd.cap).contiguous())
    return ids.to(torch.int32), cs[:, -1].contiguous()


class CullTracer(trace_ops.MeshTracer):
    """Tracer: the culled sweep for the calls of `cull_depths`, the inner
    tracer (the grid walk by default) for the others, on one device.

    A call of n lanes is n / `tile` lists of `tile` consecutive lanes
    (`tile=None`: one list per call), so lane i of a culled call must be
    lane i of its tile: uncompacted wavefronts only. The searches run
    under no_grad and return (kind, idx, t).
    """

    per_trace_cursor = True

    def __init__(self, scene, device, inner=None, cap: int = CAP,
                 cull_depths=(0,), tile: int | None = None):
        super().__init__(scene, device)
        if inner is None:
            from raytracer_tpu_torch.accel.grid import GridTracer

            inner = GridTracer.build(scene, self.device)
        self._inner = inner
        self._cd = build_cull(scene, self.device, cap)
        self._depths = tuple(cull_depths)
        self._tile = tile
        self._n_nearest = 0  # the call cursor (reset by fresh())

    @staticmethod
    def build(scene, device, **kw) -> "CullTracer":
        return CullTracer(scene, device, **kw)

    def fresh(self) -> "CullTracer":
        """This tracer with its call cursor at depth 0."""
        obj = copy.copy(self)
        obj._n_nearest = 0
        return obj

    def _triangles(self, orig, direc, t_min, max_t, active):
        n = orig.shape[0]
        tile = n if self._tile is None else self._tile
        if n % tile:
            raise ValueError(f"a culled call of {n} lanes is not whole lists "
                             f"of {tile}: lanes must stay in tile order")
        g = n // tile
        seg_lo, seg_hi, inside = _segments(self._cd, orig, direc, t_min,
                                           max_t, active)
        ids, counts = tile_ids(self._cd, seg_lo.reshape(g, tile, 3),
                               seg_hi.reshape(g, tile, 3),
                               inside.reshape(g, tile))
        rays = (orig.contiguous(), direc.contiguous())
        if max_t is None:
            return CS.cull_nearest(rays, ids, counts, self._cd.rows, tile,
                                   t_min, inside)
        return CS.cull_occluded(rays, ids, counts, self._cd.rows, tile, t_min,
                                inside, max_t.contiguous())

    @torch.no_grad()
    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        depth = self._n_nearest
        self._n_nearest += 1
        if depth not in self._depths:
            return self._inner.nearest(orig, direc, t_min, tri_chunk,
                                       active=active)
        return super().nearest(orig, direc, t_min, tri_chunk, active)

    @torch.no_grad()
    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        depth = self._n_nearest - 1  # a depth's shadows follow its nearest
        if depth not in self._depths:
            return self._inner.occluded(orig, direc, max_t, t_min, tri_chunk,
                                        active=active)
        return super().occluded(orig, direc, max_t, t_min, tri_chunk, active)


# ---------------------------------------------------------------------------
# Audit: exact per-tile survivor counts (the cap gate)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _audit_counts(cd: CullData, scene, inner, orig, dirs_tiles, t_min,
                  tri_chunk, bias):
    """Per-tile d0 survivor counts (exact) and per-light shadow-list upper
    bounds for k tiles ([k, tile, 3] directions from `orig` [tile, 3], a
    device scene) → (d0 [k] i32, shadow [k, L] i32). The d0 nearest for
    the shadow origins runs once over all k tiles' lanes."""
    k, tile, _ = dirs_tiles.shape
    flat = dirs_tiles.reshape(-1, 3)
    oflat = orig[:1].expand(flat.shape[0], 3).contiguous()
    hit = inner.nearest(oflat, flat, t_min, tri_chunk)
    valid = torch.isfinite(hit.t)
    p = oflat + torch.where(valid, hit.t, 0.0)[:, None] * flat

    def count(lo, hi, inside):
        return _count_overlap(cd, lo.reshape(k, tile, 3),
                              hi.reshape(k, tile, 3), inside.reshape(k, tile))

    d0 = count(*_segments(cd, oflat, flat, t_min))
    # the shade bias offsets the shadow origin by ±bias·n: pad both ways
    pad = float(np.float32(2.0 * bias))
    shadow = []
    for li in range(scene.lights.count):
        lvec = scene.lights.pos[li][None, :] - p
        dist = torch.sqrt(torch.clamp(dot(lvec, lvec), min=1e-24))
        ldir = lvec / dist[:, None]
        lo, hi, inside = _segments(cd, p, ldir, t_min, max_t=dist,
                                   active=valid)
        shadow.append(count(lo - pad, hi + pad, inside))
    shadow = (torch.stack(shadow, dim=1) if shadow else
              torch.zeros((k, 0), dtype=torch.int32, device=flat.device))
    return d0, shadow


def _band_tiles(scene, camera, opts, row0, rows, device):
    """`render`'s uncompacted tiling of a band → (device scene, dirs [k,
    tile, 3], orig [tile, 3], inv_order, tile, n_pix, rows)."""
    from raytracer_tpu_torch.renderer import tile_dirs

    dscene, dcam = scene.to(device), camera.to(device)
    rows = opts.height - row0 if rows is None else rows
    dirs, inv_order, tile, n_pix = tile_dirs(dcam, opts, row0, rows)
    orig = dcam.pos[None, :].expand(tile, 3)
    return dscene, dirs.reshape(-1, tile, 3), orig, inv_order, tile, n_pix, \
        rows


def _audit_band(scene, camera, opts, device, row0, rows, cap, inner):
    """Audit one band in `render`'s tiles → (CullTracer with one list per
    tile, `_band_tiles`' tuple, `cull_audit`'s dict)."""
    device = torch.device(device)
    band = _band_tiles(scene, camera, opts, row0, rows, device)
    dscene, dirs, orig, _, tile, _, _ = band
    tracer = CullTracer(scene, device, inner=inner, cap=cap, tile=tile)
    cd = tracer._cd
    d0, shadow = _audit_counts(cd, dscene, tracer._inner, orig, dirs,
                               opts.t_min, opts.tri_chunk, opts.bias)
    audit = {"d0": d0.cpu().numpy(), "shadow": shadow.cpu().numpy(),
             "cap": cd.cap, "n_tris": cd.n_tris, "tile": tile,
             "n_tiles": dirs.shape[0]}
    return tracer, band, audit


def cull_audit(scene, camera, opts, *, device, row0: int = 0,
               rows: int | None = None, cap: int = CAP, inner=None) -> dict:
    """Per-tile culled-list sizes of one band → dict of numpy arrays.

    The tiles are `render`'s (flat or screen blocks, padded with its dummy
    direction). 'd0' [n_tiles] is the EXACT survivor count of each tile's
    d0 nearest call; 'shadow' [n_tiles, L] bounds each d0 per-light
    occlusion call from above (the audit unions over all valid d0 hits, the
    real call over the lit diffuse ones: a superset AABB). Gate: every
    count ≤ cap (`thin_tiles`) ⇒ the culled render is exact."""
    return _audit_band(scene, camera, opts, device, row0, rows, cap,
                       inner)[2]


def thin_tiles(audit: dict) -> np.ndarray:
    """The tiles whose d0 count and every shadow bound fit cap → bool
    [n_tiles]: the culled sweep is exact on them."""
    cap = audit["cap"]
    return (audit["d0"] <= cap) & (audit["shadow"] <= cap).all(axis=1)


# ---------------------------------------------------------------------------
# Partitioned hybrid: the culled sweep for thin tiles, the walk for fat ones
# ---------------------------------------------------------------------------

class HybridBand:
    """One band with its tiles split by the audit at build time: tiles
    whose d0 count and every shadow bound fit cap ("thin") run the culled
    sweep at d0 (a `CullTracer` with one list per tile), the others
    ("fat") the inner walk everywhere. Exactness does not depend on the
    split: thin tiles are gated by the exact d0 count and a superset
    shadow bound. Rebuild when the camera or the scene moves.

    `counts` holds the audit ({'d0', 'shadow' (max over lights), 'thin'},
    numpy); `n_thin`, `n_tiles` its sizes. The attributes `scene`, `orig`,
    `thin_dirs`, `fat_dirs`, `cull`, `inner`, `order`, `inv_order`,
    `opts`, `rows`, `n_pix` are `hybrid_image`'s arguments."""

    def __init__(self, scene, camera, opts, *, device, row0: int = 0,
                 rows: int | None = None, inner=None, cap: int = CAP):
        device = torch.device(device)
        self.cull, band, audit = _audit_band(scene, camera, opts, device,
                                             row0, rows, cap, inner)
        (self.scene, dirs, self.orig, self.inv_order, _, self.n_pix,
         self.rows) = band
        self.inner = self.cull._inner
        self.opts = opts
        d0, shadow = audit["d0"], audit["shadow"]
        thin = thin_tiles(audit)
        self.counts = {"d0": d0, "shadow": shadow.max(
            axis=1, initial=0), "thin": thin}
        self.n_thin, self.n_tiles = int(thin.sum()), int(thin.size)
        thin_idx = np.nonzero(thin)[0]
        fat_idx = np.nonzero(~thin)[0]
        self.thin_dirs = dirs[torch.from_numpy(thin_idx).to(device)]
        self.fat_dirs = dirs[torch.from_numpy(fat_idx).to(device)]
        # class order → tile order
        self.order = torch.from_numpy(
            np.argsort(np.concatenate([thin_idx, fat_idx]))).to(device)

    def image(self, scene=None, eps=0.0, count_rays: bool = False):
        """`hybrid_image` of this band → (img [rows, W, 3], traced).
        `scene` (a device scene, e.g. with parameters grafted) defaults to
        the band's; `eps` is added to the ray origins."""
        return hybrid_image(self.scene if scene is None else scene,
                            self.orig + eps, self.thin_dirs, self.fat_dirs,
                            self.cull, self.inner, self.order,
                            self.inv_order, self.opts, self.rows, self.n_pix,
                            count_rays)

    def __call__(self, eps=0.0):
        return self.image(eps=eps)[0]


def render_partitioned(scene, camera, opts, *, device, row0: int = 0,
                       rows: int | None = None, inner=None, cap: int = CAP,
                       count_rays: bool = False,
                       counts_out: dict | None = None):
    """Band render, per-tile hybrid (a `HybridBand` audited for this call)
    → (img, traced). `counts_out` receives the audit (`HybridBand.counts`)."""
    band = HybridBand(scene, camera, opts, device=device, row0=row0, rows=rows,
                      inner=inner, cap=cap)
    if counts_out is not None:
        counts_out.update(band.counts)
    return band.image(count_rays=count_rays)


def hybrid_image(scene, orig, thin_dirs, fat_dirs, cull_tr, inner, order,
                 inv_order, opts, rows: int, n_pix: int,
                 count_rays: bool = False):
    """The fixed-partition band body → (img [rows, W, 3], traced),
    differentiable in the device `scene`'s (and `orig`'s) tensors that
    require grad, under `opts`' remat policy. Each class is one wavefront
    over its tiles' lanes ([k, tile, 3] directions from `orig` [tile, 3]);
    `order` puts the classes' tiles back in tile order and `inv_order`
    (or None) the lanes in pixel order."""
    from raytracer_tpu_torch.renderer import needs_grad, render_tile

    grad = needs_grad(scene) or (torch.is_grad_enabled()
                                 and orig.requires_grad)
    parts = []
    traced = torch.zeros((), dtype=torch.float32, device=orig.device)
    with torch.set_grad_enabled(grad):
        for dirs, tracer in ((thin_dirs, cull_tr), (fat_dirs, inner)):
            k, tile, _ = dirs.shape
            if k:
                rad, inc, *_ = render_tile(
                    scene, orig.repeat(k, 1), dirs.reshape(-1, 3), opts,
                    count_rays, tracer, opts.remat_tiles and grad)
                parts.append(rad.reshape(k, tile, 3))
                traced = traced + inc
        rad = torch.cat(parts)[order].reshape(-1, 3)
        if inv_order is not None:
            rad = rad[inv_order]
        return clamp01(rad[:n_pix]).reshape(rows, opts.width, 3), traced
