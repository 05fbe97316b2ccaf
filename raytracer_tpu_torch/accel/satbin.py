"""Exact triangle–cell binning via the separating-axis test (SAT); a copy
of `raytracer_tpu/accel/satbin.py` (numpy only, kept here so that this
package never imports the JAX one).

The naive grid build bins a triangle into every cell its AABB touches, which
over-fills cells along a triangle's diagonal (a long thin diagonal triangle
touches O(n²) cell AABBs but overlaps only O(n) cells). Exact binning shrinks
cell occupancy, which directly shrinks the walk's per-DDA-step HBM gather
(`cell_tris[cid]` reads all `capacity` slots, occupied or not) and lets a
smaller capacity run without overflow spill.

Correctness: a ray hit point lies ON its triangle, so the cell containing the
hit point geometrically overlaps the triangle and is always listed — the DDA
parking rule (`best_t <= tmax_min`) therefore still finds every hit. Touching
counts as overlap (all separation comparisons are strict), so boundary hit
points are safe.

Byte-identity with the native builder (native/gridbuild.cpp:rt_grid_build_sat)
relies on both sides computing the same f64 expression trees in the same
association order; the native object is compiled with -ffp-contract=off so
GCC cannot fuse a*b+c into FMAs that NumPy does not use.
"""

import numpy as np


def tri_cells_overlap(v0, v1, v2, centers, half):
    """SAT overlap of ONE triangle (f64 [3] verts) vs many boxes.

    centers: [K,3] f64 box centers; half: [3] f64 half-extents.
    Returns [K] bool, True where the triangle overlaps (touching counts).
    Mirrors the scalar loop in native/gridbuild.cpp — keep in sync.
    """
    w0 = v0[None, :] - centers          # [K,3]
    w1 = v1[None, :] - centers
    w2 = v2[None, :] - centers
    e0 = v1 - v0
    e1 = v2 - v1
    e2 = v0 - v2

    sep = np.zeros(centers.shape[0], bool)

    def axis_test(lx, ly, lz):
        # generic dot in fixed association order: (x*lx + y*ly) + z*lz
        p0 = (w0[:, 0] * lx + w0[:, 1] * ly) + w0[:, 2] * lz
        p1 = (w1[:, 0] * lx + w1[:, 1] * ly) + w1[:, 2] * lz
        p2 = (w2[:, 0] * lx + w2[:, 1] * ly) + w2[:, 2] * lz
        r = (half[0] * abs(lx) + half[1] * abs(ly)) + half[2] * abs(lz)
        lo = np.minimum(p0, np.minimum(p1, p2))
        hi = np.maximum(p0, np.maximum(p1, p2))
        return (lo > r) | (hi < -r)

    for ex, ey, ez in (e0, e1, e2):
        sep |= axis_test(0.0, -ez, ey)      # X × e
        sep |= axis_test(ez, 0.0, -ex)      # Y × e
        sep |= axis_test(-ey, ex, 0.0)      # Z × e

    # triangle plane vs box: n = e0 × e1 (not normalized)
    nx = e0[1] * e1[2] - e0[2] * e1[1]
    ny = e0[2] * e1[0] - e0[0] * e1[2]
    nz = e0[0] * e1[1] - e0[1] * e1[0]
    sep |= axis_test(nx, ny, nz)
    return ~sep


def bin_exact(verts, tris, bmin, cell, res, capacity):
    """Python fallback SAT grid bin → (cell_tris [ncells,C] i32, overflow i32).

    verts f64 [V,3] (f32-rounded upstream), tris i64 [T,3]; bmin/cell f64 [3];
    res (nx,ny,nz). Semantics identical to rt_grid_build_sat: ascending tri
    ids per cell, candidate cells from the tri AABB clamped to the grid,
    cx-major candidate order, sorted unique overflow.
    """
    nx_, ny_, nz_ = res
    resm1 = np.array([nx_ - 1, ny_ - 1, nz_ - 1])
    half = cell * 0.5
    t = tris.shape[0]
    p0 = verts[tris[:, 0]]
    p1 = verts[tris[:, 1]]
    p2 = verts[tris[:, 2]]
    tmin = np.minimum(np.minimum(p0, p1), p2)
    tmax = np.maximum(np.maximum(p0, p1), p2)
    lo = np.clip(((tmin - bmin) / cell).astype(np.int64), 0, resm1)
    hi = np.clip(((tmax - bmin) / cell).astype(np.int64), 0, resm1)

    ncells = nx_ * ny_ * nz_
    cell_tris = np.full((ncells, capacity), t, np.int32)
    counts = np.zeros(ncells, np.int32)
    overflow: set[int] = set()
    for i in range(t):
        cx = np.arange(lo[i, 0], hi[i, 0] + 1)
        cy = np.arange(lo[i, 1], hi[i, 1] + 1)
        cz = np.arange(lo[i, 2], hi[i, 2] + 1)
        gx, gy, gz = np.meshgrid(cx, cy, cz, indexing="ij")
        idx = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)  # [K,3]
        centers = bmin[None, :] + (idx + 0.5) * cell[None, :]
        keep = tri_cells_overlap(p0[i], p1[i], p2[i], centers, half)
        for cx_, cy_, cz_ in idx[keep]:
            c = (cx_ * ny_ + cy_) * nz_ + cz_
            if counts[c] < capacity:
                cell_tris[c, counts[c]] = i
                counts[c] += 1
            else:
                overflow.add(i)
    ov = np.asarray(sorted(overflow), np.int32)
    return cell_tris, ov
