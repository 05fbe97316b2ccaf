"""Grid DDA walk: the CUDA kernel (`csrc/grid_walk.cu`) and its plain torch
twin.

Counterpart of `raytracer_tpu/ops/pallas_walk.py` (`pallas_grid_walk`, the
TPU kernel `_make_walk_kernel`) and of the XLA `accel.grid.grid_walk` at
fanout 1, skip 0: same traversal and tie semantics, in nearest and in
occlusion (any-hit) mode.

The kernel has one entry, `grid_search_cuda`: what `GridTracer.nearest`
and `GridTracer.occluded` launch on the card, the dense sphere and plane
tests, `walk_init`, the walk and the merge in one launch. Its twin is that
composition of torch ops, on any device: the dense search, then
`grid_walk` (`walk_init` and `grid_walk_plain`), then the merge; the
kernel equals it bit for bit on the card. On the CPU it is what
`GridTracer` runs.
"""

import dataclasses

import torch

from raytracer_tpu_torch.accel import grid as grid_mod
from raytracer_tpu_torch.kernels.build import check_arg
from raytracer_tpu_torch.ops import geometry as geom

# Kernel launches since the last reset. Incremented only where the kernel
# is launched; callers that must show the kernel ran set it to 0 and read
# it.
launches = 0

# Lanes per chunk of the plain version: bounds its [lanes, C, 10] candidate
# gather (~5 KB per lane at C = 128).
_REF_CHUNK = 1 << 16


@dataclasses.dataclass(frozen=True)
class WalkTable:
    """The walk's candidate tables, built once per grid
    (`pack_cell_table`), on the grid's device:
    - `soa`: `cell_soa [ncells, C, 10]` f32, v0|e1|e2|id per slot, the
      sentinel-padded rows that the plain version gathers;
    - `cells`: [ncells, 2] i32, each cell's offset into `slots` and its
      count of listed triangles (the kernel's trip count);
    - `slots`: [n_slots, 12] f32, every cell's listed triangles packed once,
      in cell order and in `cell_soa`'s slot order: v0|e1|e2|id|0|0, rows of
      48 bytes that the kernel reads as three 16-byte loads."""

    soa: torch.Tensor
    cells: torch.Tensor
    slots: torch.Tensor


def pack_rows(rows):
    """[n, 10] f32 rows v0|e1|e2|id → the [n, 12] packed rows v0|e1|e2|id|0|0
    that `csrc/tri_row.cuh` reads as three 16-byte loads (the grid walk's
    cell slots, the BVH's leaf slots, the culled sweep's table)."""
    return torch.cat([rows, rows.new_zeros((rows.shape[0], 2))],
                     dim=1).contiguous()


def pack_cell_table(grid: grid_mod.GridData) -> WalkTable:
    """The walk's tables from `grid.cell_soa`, whose cells fill front to
    back (listed triangles, then sentinel slots with id = n_tris)."""
    soa = grid.cell_soa
    ncells = grid.res[0] * grid.res[1] * grid.res[2]
    if soa.dtype != torch.float32 or tuple(soa.shape) != (
            ncells, grid.capacity, 10):
        raise ValueError(f"cell_soa must be f32 [{ncells}, {grid.capacity}, "
                         f"10], got {soa.dtype} {tuple(soa.shape)}")
    soa = soa.contiguous()
    listed = soa[..., 9] != grid.n_tris
    counts = listed.sum(dim=1)
    slot = torch.arange(grid.capacity, device=soa.device)
    if not torch.equal(listed, slot[None, :] < counts[:, None]):
        raise ValueError("cell_soa: a sentinel slot precedes a listed one")
    slots = pack_rows(soa[listed])  # row-major: cell by cell, slots in order
    cells = torch.stack([torch.cumsum(counts, 0) - counts, counts], dim=1)
    return WalkTable(soa=soa, cells=cells.to(torch.int32).contiguous(),
                     slots=slots)


def _max_iters(grid):
    nx, ny, nz = grid.res
    return nx + ny + nz + 2


@torch.no_grad()
def grid_walk(grid: grid_mod.GridData, table, orig, direc, t_min,
              occlusion_max_t=None, active=None):
    """Plain DDA walk over all rays, from `walk_init` → (best_t [N] f32,
    best_idx [N] i32), on the CPU or the card.

    With `occlusion_max_t` [N] given, lanes park as soon as any hit below
    max_t is found (any-hit mode); best_t < max_t then means occluded.
    `active` [N] bool masks lanes out of the walk: they return t = +inf and
    idx = n_tris.
    """
    if orig.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grid_walk runs on cpu or cuda, not {orig.device}")
    state = grid_mod.walk_init(grid, orig, direc, t_min, active)
    return grid_walk_plain(grid, table, orig, direc, state, t_min,
                           occlusion_max_t)


def grid_search_cuda(base, grid, table, orig, direc, t_min, max_t=None,
                     active=None):
    """One launch of the fused search on the current stream: what
    `trace_ops.nearest_hit(base, ...)` (or `occluded`), `grid_walk` and the
    merge compute together, bit for bit. `base` is the tracer's mesh-less
    scene, its sphere and plane tables read at this call. Nearest (`max_t`
    None) → `trace_ops.Hit`; occlusion → bool [N], occluded below `max_t`.
    `active` [N] bool (or None: all) masks lanes out of the walk; the dense
    tests run on every lane.

    The host's cost is the point of this entry: it checks what varies from
    call to call (the rays, the mask, `max_t`, the sphere and plane tables:
    device, dtype, shape, made contiguous first) and takes the grid and
    its table as GridTracer built them."""
    global launches
    from raytracer_tpu_torch.kernels.build import load_library
    from raytracer_tpu_torch.ops.trace import Hit

    n, dev = orig.shape[0], orig.device
    if dev.type != "cuda":
        raise ValueError(f"grid_search_cuda needs CUDA rays, got {dev}")
    if n >= (1 << 31) // 3:
        raise ValueError(f"too many rays for one launch: {n}")
    f32 = torch.float32
    orig, direc = orig.contiguous(), direc.contiguous()
    sp, pl = base.spheres, base.planes
    sph_c, sph_r = sp.center.contiguous(), sp.radius.contiguous()
    pl_p, pl_n = pl.point.contiguous(), pl.normal.contiguous()
    ns, np_ = sph_c.shape[0], pl_p.shape[0]
    args = [("orig", orig, f32, (n, 3)), ("direc", direc, f32, (n, 3)),
            ("spheres.center", sph_c, f32, (ns, 3)),
            ("spheres.radius", sph_r, f32, (ns,)),
            ("planes.point", pl_p, f32, (np_, 3)),
            ("planes.normal", pl_n, f32, (np_, 3))]
    if active is not None:
        active = active.contiguous()
        args.append(("active", active, torch.bool, (n,)))
    occl = max_t is not None
    if occl:
        max_t = max_t.contiguous()
        args.append(("max_t", max_t, f32, (n,)))
    for name, x, dt, shape in args:
        check_arg(name, x, dt, shape, dev)
    if occl:
        kind = idx = t = None
        occ = torch.empty((n,), dtype=torch.bool, device=dev)
    else:
        kind = torch.empty((n,), dtype=torch.int32, device=dev)
        idx = torch.empty((n,), dtype=torch.int32, device=dev)
        t = torch.empty((n,), dtype=f32, device=dev)
        occ = None
    if n:
        nx, ny, nz = grid.res
        ptr = lambda x: None if x is None else x.data_ptr()
        rc = load_library().rt_grid_search(
            orig.data_ptr(), direc.data_ptr(), ptr(active), ptr(max_t),
            table.cells.data_ptr(), table.slots.data_ptr(), sph_c.data_ptr(),
            sph_r.data_ptr(), pl_p.data_ptr(), pl_n.data_ptr(),
            grid.bmin.data_ptr(), grid.cell_size.data_ptr(),
            grid.inv_cell.data_ptr(), grid.ov_v0.data_ptr(),
            grid.ov_e1.data_ptr(), grid.ov_e2.data_ptr(),
            grid.overflow.data_ptr(), n, nx, ny, nz, ns, np_,
            grid.overflow.shape[0], grid.n_tris, float(t_min),
            _max_iters(grid), int(occl), ptr(kind), ptr(idx), ptr(t),
            ptr(occ), torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"grid search kernel launch failed: CUDA "
                               f"error {rc}")
        launches += 1
    return occ if occl else Hit(kind=kind, idx=idx, t=t)


@torch.no_grad()
def grid_walk_plain(grid: grid_mod.GridData, table, orig, direc, state,
                    t_min, occlusion_max_t=None, stats=None):
    """Plain torch walk from a `walk_init` state (the walk of the kernel's
    twin): the vectorised form of the reference's XLA walk at
    fanout 1, skip 0. Each DDA iteration gathers the [lanes, C, 10]
    `table.soa` rows of the still-walking lanes only, in chunks of
    `_REF_CHUNK` lanes.

    With a `stats` dict, adds the work the kernel does on these rays:
    "visits" (cell visits of walking lanes), "candidates" (the listed
    triangles of the visited cells, which the kernel tests) and
    "lane_candidates" ([N] int64, the candidates of each lane).
    """
    best_t, best_i, cell, tmax, step, tdelta, act = state
    best_t, best_i = best_t.clone(), best_i.clone()
    cell, tmax = cell.clone(), tmax.clone()
    nx, ny, nz = grid.res
    resv = torch.tensor([nx, ny, nz], dtype=torch.int32, device=orig.device)
    lanes = torch.nonzero(act).squeeze(1)
    for s in range(0, lanes.shape[0], _REF_CHUNK):
        idx = lanes[s:s + _REF_CHUNK]
        for _ in range(_max_iters(grid)):
            if idx.shape[0] == 0:
                break
            c = cell[idx]
            cid = (c[:, 0] * ny + c[:, 1]) * nz + c[:, 2]
            rows = table.soa[cid]                              # [n, C, 10]
            if stats is not None:
                listed = (rows[..., 9] != grid.n_tris).sum(dim=1)
                stats["visits"] = stats.get("visits", 0) + idx.shape[0]
                stats["candidates"] = stats.get("candidates", 0) + listed.sum()
                stats.setdefault("lane_candidates", torch.zeros(
                    orig.shape[0], dtype=torch.int64,
                    device=orig.device)).index_add_(0, idx, listed)
            o, d = orig[idx], direc[idx]
            ts, _, _ = geom.triangle_tuv(o[:, None, :], d[:, None, :],
                                         rows[..., 0:3], rows[..., 3:6],
                                         rows[..., 6:9], t_min)
            tids = rows[..., 9].to(torch.int32)
            tc = ts.amin(dim=1)
            # lowest id among the t-minima, then the lexicographic fold
            ic = torch.where(ts <= tc[:, None], tids, grid.n_tris).amin(dim=1)
            bt, bi = best_t[idx], best_i[idx]
            better = (tc < bt) | ((tc == bt) & (ic < bi))
            bt = torch.where(better, tc, bt)
            bi = torch.where(better, ic, bi)
            best_t[idx] = bt
            best_i[idx] = bi

            tm = tmax[idx]
            m = tm.amin(dim=1)
            if occlusion_max_t is not None:
                mt = occlusion_max_t[idx]
                parked = (bt < mt) | (m > mt)
            else:
                parked = bt <= m
            axis = torch.argmin(tm, dim=1)  # first minimum: ties x < y < z
            onehot = torch.nn.functional.one_hot(axis, 3).to(torch.int32)
            cell_n = c + onehot * step[idx]
            tmax_n = tm + onehot.to(torch.float32) * tdelta[idx]
            out = ((cell_n < 0) | (cell_n >= resv[None, :])).any(dim=1)
            adv = ~parked
            cell[idx] = torch.where(adv[:, None], cell_n, c)
            tmax[idx] = torch.where(adv[:, None], tmax_n, tm)
            idx = idx[adv & ~out]
    return best_t, best_i

