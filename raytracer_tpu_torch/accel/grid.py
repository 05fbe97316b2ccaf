"""Uniform-grid acceleration: host build → flat tensors → DDA walk
(counterpart of `raytracer_tpu/accel/grid.py`).

- Host build (NumPy, or the native library when it loads): triangle AABBs →
  a fixed-capacity cell table `cell_tris[ncells, C]` (sentinel-padded), with
  the triangles of cells that overflow C spilled into a small global
  `overflow` list that every walk brute-forces once. The arrays equal the
  reference build's byte for byte.
- `cell_soa [ncells, C, 10]`: each listed triangle pre-gathered as
  v0|e1|e2|id rows; sentinel slots hold the zero triangle (always a miss)
  with id = n_tris, and slots fill front to back.
- The walk itself (Amanatides–Woo DDA per ray) is `ops/walk.py`: the CUDA
  kernel on the card, its plain torch version on the CPU.
"""

import dataclasses
import math

import numpy as np
import torch

from raytracer_tpu_torch.core.types import Meshes, Scene
from raytracer_tpu_torch.ops import geometry as geom
from raytracer_tpu_torch.ops import trace as trace_ops

INF = math.inf
# the reference's tuned build (GridTracer.build defaults): coarse cells with
# many slots
CAPACITY = 128
DENSITY = 0.125


@dataclasses.dataclass
class GridData:
    """Grid tensors on one device + static layout metadata."""

    bmin: torch.Tensor       # [3] f32 grid AABB min
    inv_cell: torch.Tensor   # [3] f32 1/cell_size
    cell_size: torch.Tensor  # [3] f32
    cell_tris: torch.Tensor  # [ncells, C] i32 — triangle ids, sentinel = n_tris
    overflow: torch.Tensor   # [O] i32 — spilled triangle ids (may be empty)
    ov_v0: torch.Tensor      # [O,3] f32 — overflow tri SoA pre-gathered
    ov_e1: torch.Tensor      # [O,3]
    ov_e2: torch.Tensor      # [O,3]
    cell_soa: torch.Tensor   # [ncells, C, 10] f32 v0|e1|e2|id per slot
    res: tuple               # (nx, ny, nz)
    capacity: int            # C
    n_tris: int              # sentinel id (= index of the degenerate pad tri)


def build_grid(verts, tris, capacity: int = CAPACITY,
               device="cpu") -> GridData:
    """Host-side grid build from concrete arrays; tensors land on `device`.
    Cells that list more than `capacity` triangles spill into `overflow`."""
    # f32-first: the native builder's ABI is f32; rounding here keeps the two
    # builders byte-identical even for f64 input
    verts = np.asarray(np.asarray(verts, np.float32), np.float64)
    tris = np.asarray(tris, np.int64)
    t = tris.shape[0]
    if t == 0:
        raise ValueError("grid over empty mesh")
    if t >= (1 << 24):
        # ids ride as f32 in column 9 of cell_soa, exact only below 2^24
        raise ValueError(f"grid supports < 2^24 triangles, got {t}")
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]

    bmin = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
    bmax = np.maximum(np.maximum(v0, v1), v2).max(axis=0)
    extent = np.maximum(bmax - bmin, 1e-6)
    pad = 1e-4 * np.linalg.norm(extent)
    bmin -= pad
    bmax += pad
    extent = bmax - bmin

    # Cleary/Wald heuristic: cells ∝ cbrt(density·T) scaled by extent shape
    base = (DENSITY * t) ** (1.0 / 3.0)
    r = np.maximum(1, np.minimum(
        64, np.round(base * extent / (extent.prod() ** (1.0 / 3.0)))
    )).astype(np.int64)
    nx, ny, nz = (int(x) for x in r)
    cell = extent / np.array([nx, ny, nz], np.float64)

    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    lo = np.clip(((tmin - bmin) / cell).astype(np.int64), 0,
                 np.array([nx - 1, ny - 1, nz - 1]))
    hi = np.clip(((tmax - bmin) / cell).astype(np.int64), 0,
                 np.array([nx - 1, ny - 1, nz - 1]))

    from raytracer_tpu_torch.utils.native import native_lib

    lib = native_lib()
    if lib is not None:
        cell_tris, ov = lib.grid_build(verts.astype(np.float32), tris, bmin,
                                       cell, (nx, ny, nz), capacity)
    else:
        ncells = nx * ny * nz
        lists: list[list[int]] = [[] for _ in range(ncells)]
        for i in range(t):
            for cx in range(lo[i, 0], hi[i, 0] + 1):
                for cy in range(lo[i, 1], hi[i, 1] + 1):
                    for cz in range(lo[i, 2], hi[i, 2] + 1):
                        lists[(cx * ny + cy) * nz + cz].append(i)

        cell_tris = np.full((ncells, capacity), t, np.int32)  # sentinel = t
        overflow: set[int] = set()
        for c, ids in enumerate(lists):
            cell_tris[c, : min(len(ids), capacity)] = ids[:capacity]
            overflow.update(ids[capacity:])
        ov = np.asarray(sorted(overflow), np.int32)
    f32 = np.float32
    z3 = np.zeros((0, 3), f32)
    ov_v0 = v0[ov].astype(f32) if len(ov) else z3
    ov_e1 = (v1 - v0)[ov].astype(f32) if len(ov) else z3
    ov_e2 = (v2 - v0)[ov].astype(f32) if len(ov) else z3

    # [ncells, C, 10] rows of v0|e1|e2|id; edges subtracted IN f32, as
    # Meshes.tri_soa computes them, so every backend sees the same bits
    soa_rows = np.concatenate(
        [v0.astype(f32), v1.astype(f32) - v0.astype(f32),
         v2.astype(f32) - v0.astype(f32)], axis=1)   # [T, 9]
    soa_rows = np.concatenate([soa_rows, np.zeros((1, 9), f32)])
    ids_col = np.arange(t + 1, dtype=f32)[:, None]
    soa_rows = np.concatenate([soa_rows, ids_col], axis=1)  # [T+1, 10]
    cell_soa = soa_rows[np.minimum(cell_tris, t)]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return GridData(
        bmin=dev(bmin.astype(f32)), inv_cell=dev((1.0 / cell).astype(f32)),
        cell_size=dev(cell.astype(f32)), cell_tris=dev(cell_tris),
        overflow=dev(ov), ov_v0=dev(ov_v0), ov_e1=dev(ov_e1), ov_e2=dev(ov_e2),
        cell_soa=dev(cell_soa), res=(nx, ny, nz), capacity=capacity, n_tris=t)


@torch.no_grad()
def walk_init(grid: GridData, orig, direc, t_min, active=None):
    """Shared DDA entry state (overflow brute seed + slab entry + first cell).

    The kernel and its plain version both start from this state.
    → (best_t [N], best_i [N] i32, cell [N,3] i32, tmax [N,3], step [N,3] i32,
       tdelta [N,3], active [N] bool), all contiguous.
    """
    n = orig.shape[0]
    dev = orig.device
    nx, ny, nz = grid.res
    resv = torch.tensor([nx, ny, nz], dtype=torch.int32, device=dev)

    best_t = torch.full((n,), INF, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), grid.n_tris, dtype=torch.int32, device=dev)

    # overflow list: brute once (tiny)
    if grid.overflow.shape[0]:
        ts, _, _ = geom.triangle_hits(orig, direc, grid.ov_v0, grid.ov_e1,
                                      grid.ov_e2, t_min)
        if active is not None:  # parked lanes must return miss/INF (contract)
            ts = torch.where(active[:, None], ts, INF)
        best_t, arg = torch.min(ts, dim=1)
        best_i = torch.where(torch.isinf(best_t), grid.n_tris,
                             grid.overflow[arg])

    # ray/AABB slab entry
    bmax = grid.bmin + grid.cell_size * resv.to(torch.float32)
    inv_d = torch.where(torch.abs(direc) > 1e-12, 1.0 / direc, 1e12)
    t0 = (grid.bmin[None, :] - orig) * inv_d
    t1 = (bmax[None, :] - orig) * inv_d
    tlo = torch.minimum(t0, t1).amax(dim=1)
    thi = torch.maximum(t0, t1).amin(dim=1)
    t_entry = torch.clamp(tlo, min=0.0)
    inside = (thi >= t_entry) & (thi > 0)
    if active is not None:
        inside &= active

    p_entry = orig + (t_entry + 1e-5)[:, None] * direc
    cellf = (p_entry - grid.bmin[None, :]) * grid.inv_cell[None, :]
    # lanes outside the grid may carry inf/nan here; they never walk
    cellf = torch.nan_to_num(cellf, nan=0.0, posinf=0.0, neginf=0.0)
    cell = torch.minimum(torch.clamp(torch.floor(cellf), min=0.0),
                         (resv - 1).to(torch.float32)).to(torch.int32)
    step = torch.where(direc > 0, 1, -1).to(torch.int32)
    tdelta = torch.abs(grid.cell_size[None, :] * inv_d)
    next_bound = (grid.bmin[None, :]
                  + (cell + (step > 0).to(torch.int32)).to(torch.float32)
                  * grid.cell_size[None, :])
    tmax = torch.where(torch.abs(direc) > 1e-12,
                       (next_bound - orig) * inv_d, INF)
    return (best_t.contiguous(), best_i.to(torch.int32).contiguous(),
            cell.contiguous(), tmax.contiguous(), step.contiguous(),
            tdelta.contiguous(), inside.contiguous())


class GridTracer:
    """Tracer: grid-walked triangles + dense spheres/planes, on one device.

    Built on host from a concrete scene (`GridTracer.build(scene, device)`).
    """

    def __init__(self, scene: Scene, grid: GridData, device):
        from raytracer_tpu_torch.ops.walk import pack_cell_table

        self.device = torch.device(device)
        # spheres and planes stay in the dense search; triangles are walked
        self._base = scene.replace(meshes=Meshes.empty()).to(self.device)
        self._grid = grid
        self._table = pack_cell_table(grid)

    @staticmethod
    def build(scene: Scene, device, capacity: int = CAPACITY) -> "GridTracer":
        grid = build_grid(np.asarray(scene.meshes.verts),
                          np.asarray(scene.meshes.tris), capacity=capacity,
                          device=device)
        return GridTracer(scene, grid, device)

    @torch.no_grad()
    def nearest(self, orig, direc, t_min, tri_chunk, active=None):
        from raytracer_tpu_torch.ops.walk import grid_walk

        # spheres + planes via the dense search on a mesh-less scene
        base = trace_ops.nearest_hit(self._base, orig, direc, t_min, tri_chunk)
        tb, ib = grid_walk(self._grid, self._table, orig, direc, t_min,
                           active=active)
        return trace_ops.merge_triangles(base, tb, ib)

    @torch.no_grad()
    def occluded(self, orig, direc, max_t, t_min, tri_chunk, active=None):
        from raytracer_tpu_torch.ops.walk import grid_walk

        occ = trace_ops.occluded(self._base, orig, direc, max_t, t_min,
                                 tri_chunk)
        tb, _ = grid_walk(self._grid, self._table, orig, direc, t_min,
                          occlusion_max_t=max_t, active=active)
        return occ | (tb < max_t)
