"""The benchmark's own Wavefront OBJ reader: `v`, `vn` and triangle or
polygon `f` lines (`a`, `a//n`, `a/t`, `a/t/n`, negative indices; fans
triangulated). Normals are kept when every corner names the normal of its
own vertex, as the repository's exports write them."""

import numpy as np


def read_obj(path: str):
    """→ (verts [V,3] f32, tris [T,3] i32, normals [V,3] f32 or None)."""
    verts, norms, tris, aligned = [], [], [], True
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                norms.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                corners = []
                for c in parts[1:]:
                    fields = c.split("/")
                    vi = int(fields[0])
                    vi = vi - 1 if vi > 0 else len(verts) + vi
                    ni = int(fields[2]) if len(fields) > 2 and fields[2] else 0
                    ni = ni - 1 if ni > 0 else (len(norms) + ni if ni else -1)
                    aligned &= ni == vi
                    corners.append(vi)
                for k in range(1, len(corners) - 1):
                    tris.append([corners[0], corners[k], corners[k + 1]])
    v = np.asarray(verts, np.float32).reshape(-1, 3)
    normals = None
    if norms and aligned and len(norms) == len(verts):
        normals = np.asarray(norms, np.float32).reshape(-1, 3)
    return v, np.asarray(tris, np.int32).reshape(-1, 3), normals
