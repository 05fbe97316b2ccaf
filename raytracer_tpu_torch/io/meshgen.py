"""Procedural mesh generation (NumPy, host-side cold path) and smooth
vertex normals; counterpart of `raytracer_tpu/io/meshgen.py`
(`vertex_normals_torch` is the twin of its `vertex_normals_jnp`).

The reference's benchmark mesh is a ~10k-triangle bunny OBJ (BASELINE config 4).
This box has zero network egress and the reference mount is empty, so the
framework ships a deterministic procedural stand-in of the same scale: a
subdivided icosphere ("blob" with smooth vertex normals) and a trefoil-knot tube.
Both exceed/meet the 10k-triangle bar and exercise exactly the same device paths
(OBJ load → flat SoA tensors → grid-accelerated MT traversal).
"""

import numpy as np
import torch


def icosphere(subdiv: int = 5, radius: float = 1.0) -> tuple[np.ndarray, np.ndarray]:
    """Subdivided icosahedron → (verts [V,3] f32, tris [T,3] i32).

    subdiv=5 → 20·4^5 = 20480 tris; subdiv=4 → 5120.
    """
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)

    for _ in range(subdiv):
        edge_mid: dict[tuple[int, int], int] = {}
        vlist = list(verts)

        def midpoint(a: int, b: int) -> int:
            key = (a, b) if a < b else (b, a)
            if key not in edge_mid:
                m = vlist[a] + vlist[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(vlist)
                vlist.append(m)
            return edge_mid[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.array(vlist)
        faces = np.array(new_faces, np.int64)

    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def bumpy_sphere(subdiv: int = 4, radius: float = 1.0, bump: float = 0.12,
                 freq: float = 5.0) -> tuple[np.ndarray, np.ndarray]:
    """Icosphere displaced by a smooth trigonometric field — an organic 'bunny
    stand-in' with silhouette curvature (not just a perfect sphere)."""
    v, f = icosphere(subdiv, 1.0)
    d = 1.0 + bump * (np.sin(freq * v[:, 0]) * np.sin(freq * v[:, 1])
                      + np.cos(freq * v[:, 2]))
    return (v * d[:, None] * radius).astype(np.float32), f


def vertex_normals(verts: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals."""
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    n = np.zeros_like(verts, np.float64)
    for k in range(3):
        np.add.at(n, tris[:, k], fn)
    norm = np.linalg.norm(n, axis=1, keepdims=True)
    norm[norm == 0] = 1.0
    return (n / norm).astype(np.float32)


def vertex_normals_torch(verts, tris):
    """Differentiable twin of `vertex_normals` (torch tensors): inverse
    rendering over mesh geometry re-derives the smooth normals from the
    moving vertices inside the loss, so shading gradients reach `verts`
    through the normals too. Face normals (area-weighted) are summed per
    vertex with `index_add_`; a vertex whose sum is zero keeps it (divided
    by 1), as the reference's rule has it."""
    tris = tris.long()
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0)  # area-weighted
    n = torch.zeros_like(verts)
    for k in range(3):
        n.index_add_(0, tris[:, k], fn)
    norm = torch.linalg.vector_norm(n, dim=1, keepdim=True)
    return n / torch.where(norm == 0, 1.0, norm)


def quad(p00, p10, p11, p01) -> tuple[np.ndarray, np.ndarray]:
    """Two triangles for the quad with corners in CCW order → (verts[4,3], tris[2,3])."""
    verts = np.array([p00, p10, p11, p01], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, tris


def merge(parts: list[tuple[np.ndarray, np.ndarray]]):
    """Concatenate (verts, tris) parts with index offsetting → (verts, tris, part_id
    per triangle)."""
    vs, ts, pid = [], [], []
    off = 0
    for i, (v, t) in enumerate(parts):
        vs.append(v)
        ts.append(t + off)
        pid.append(np.full((t.shape[0],), i, np.int32))
        off += v.shape[0]
    return (np.concatenate(vs).astype(np.float32),
            np.concatenate(ts).astype(np.int32), np.concatenate(pid))
