"""Benchmark scene presets — the scene data of `raytracer_tpu/models/presets.py`
(the five configs of BASELINE.json:6-12, plus configs 6 and 7).

Reference analog: the hard-coded scene built in `main()` (SURVEY §1 L5). The
reference mount was empty, so the exact constants here are ours; they are the
shared ground truth for the JAX renderer, the NumPy oracle and the C++ oracle
(docs/SPEC.md), and the golden images in tests/golden/.

1. config1_sphere_plane   — single sphere + plane, 1 light, 256², no recursion
2. config2_mirror_spheres — 3 spheres + checker plane, shadows + 2-bounce, 512²
3. config3_cornell        — Cornell box (tri-mesh walls) + mirror/glass, 1024²
4. config4_mesh           — ~20k-tri procedural mesh, grid traversal, 4 bounces, 1080p
5. config5_inverse        — inverse-rendering setup (positions + albedos)
"""

import dataclasses
import os

import numpy as np

from raytracer_tpu_torch.core.types import (
    DIFFUSE_AND_GLOSSY, REFLECTION, REFLECTION_AND_REFRACTION, Camera, Lights,
    Materials, Meshes, Planes, RenderOptions, Spheres, make_scene)
from raytracer_tpu_torch.io import meshgen

CHECKER_C1 = (0.815, 0.235, 0.031)
CHECKER_C2 = (0.937, 0.937, 0.231)

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets")


def _mats(rows):
    """rows: list of (mtype, albedo, kd, ks, spec_n, ior)."""
    return Materials.build(
        [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows],
        [r[3] for r in rows], [r[4] for r in rows], [r[5] for r in rows])


def config1_sphere_plane():
    """BASELINE config 1: single sphere + plane, 1 point light, 256², no recursion."""
    mats = _mats([
        (DIFFUSE_AND_GLOSSY, (0.60, 0.25, 0.20), 0.8, 0.2, 25.0, 1.3),  # sphere
        (DIFFUSE_AND_GLOSSY, (0.50, 0.50, 0.50), 0.8, 0.1, 10.0, 1.3),  # plane
    ])
    scene = make_scene(
        spheres=Spheres.build([(0.0, 0.0, -5.0)], [1.5], [0]),
        planes=Planes.build([(0.0, -2.0, 0.0)], [(0.0, 1.0, 0.0)],
                            [(1.0, 0.0, 0.0)], [(0.0, 0.0, 1.0)], [1]),
        materials=mats,
        lights=Lights.build([(-3.0, 6.0, 1.0)], [(0.9, 0.9, 0.9)]),
    )
    cam = Camera.build(pos=(0.0, 0.5, 1.0), fov_deg=60.0)
    opts = RenderOptions(width=256, height=256, max_depth=0)
    return scene, cam, opts


def config2_mirror_spheres():
    """BASELINE config 2: 3 spheres + checkerboard plane, shadows + 2-bounce, 512²."""
    mats = _mats([
        (DIFFUSE_AND_GLOSSY, (0.65, 0.15, 0.15), 0.8, 0.2, 25.0, 1.3),   # red
        (DIFFUSE_AND_GLOSSY, (0.15, 0.25, 0.65), 0.8, 0.3, 60.0, 1.3),   # blue
        (REFLECTION,         (0.0, 0.0, 0.0),    0.0, 0.0, 25.0, 12.0),  # mirror
        (DIFFUSE_AND_GLOSSY, CHECKER_C1,         0.8, 0.1, 10.0, 1.3),   # floor
    ])
    scene = make_scene(
        spheres=Spheres.build(
            [(-2.2, -0.5, -7.0), (2.3, -0.6, -6.0), (0.0, 0.2, -9.0)],
            [1.0, 0.9, 1.7], [0, 1, 2]),
        planes=Planes.build([(0.0, -1.5, 0.0)], [(0.0, 1.0, 0.0)],
                            [(1.0, 0.0, 0.0)], [(0.0, 0.0, 1.0)], [3],
                            checker=[1], checker_scale=[0.5],
                            albedo2=[CHECKER_C2]),
        materials=mats,
        lights=Lights.build([(-4.0, 7.0, 0.0), (4.0, 6.0, -2.0)],
                            [(0.7, 0.7, 0.7), (0.45, 0.45, 0.45)]),
    )
    cam = Camera.build(pos=(0.0, 0.8, 2.0), fov_deg=55.0)
    opts = RenderOptions(width=512, height=512, max_depth=2,
                         tile_rays=65536)
    return scene, cam, opts


def _cornell_mesh():
    """Cornell box interior: x,y ∈ [-2,2], z ∈ [-8,-4]; open front."""
    parts, colors = [], []
    # floor (normal up)
    parts.append(meshgen.quad((-2, -2, -4), (2, -2, -4), (2, -2, -8), (-2, -2, -8)))
    colors.append(0)
    # ceiling
    parts.append(meshgen.quad((-2, 2, -8), (2, 2, -8), (2, 2, -4), (-2, 2, -4)))
    colors.append(0)
    # back wall
    parts.append(meshgen.quad((-2, -2, -8), (2, -2, -8), (2, 2, -8), (-2, 2, -8)))
    colors.append(0)
    # left wall (red)
    parts.append(meshgen.quad((-2, -2, -4), (-2, -2, -8), (-2, 2, -8), (-2, 2, -4)))
    colors.append(1)
    # right wall (green)
    parts.append(meshgen.quad((2, -2, -8), (2, -2, -4), (2, 2, -4), (2, 2, -8)))
    colors.append(2)
    verts, tris, pid = meshgen.merge(parts)
    mat_of_part = np.asarray(colors, np.int32)
    return verts, tris, mat_of_part[pid]


def config3_cornell():
    """BASELINE config 3: Cornell box (tri-mesh walls) + mirror & glass spheres,
    refraction, 1024²."""
    mats = _mats([
        (DIFFUSE_AND_GLOSSY, (0.75, 0.73, 0.70), 0.8, 0.05, 10.0, 1.3),  # 0 white
        (DIFFUSE_AND_GLOSSY, (0.63, 0.065, 0.05), 0.8, 0.05, 10.0, 1.3),  # 1 red
        (DIFFUSE_AND_GLOSSY, (0.14, 0.45, 0.091), 0.8, 0.05, 10.0, 1.3),  # 2 green
        (REFLECTION,         (0.0, 0.0, 0.0),    0.0, 0.0, 25.0, 12.0),   # 3 mirror
        (REFLECTION_AND_REFRACTION, (0.0, 0.0, 0.0), 0.0, 0.0, 25.0, 1.5),  # 4 glass
    ])
    verts, tris, tri_mat = _cornell_mesh()
    scene = make_scene(
        spheres=Spheres.build([(-0.95, -1.15, -6.7), (0.95, -1.2, -5.6)],
                              [0.85, 0.8], [3, 4]),
        meshes=Meshes.build(verts, tris, tri_mat),
        materials=mats,
        lights=Lights.build([(0.0, 1.85, -6.0)], [(1.0, 1.0, 1.0)]),
    )
    cam = Camera.build(pos=(0.0, 0.0, 0.0), fov_deg=50.0)
    opts = RenderOptions(width=1024, height=1024, max_depth=4,
                         remat_tiles=False)
    return scene, cam, opts


def config4_mesh(use_obj: bool = True):
    """BASELINE config 4: ~20k-triangle procedural mesh ('bunny stand-in' — zero
    network egress, see io/meshgen.py) + mirror sphere + checker floor,
    4 bounces, 1080p."""
    from raytracer_tpu_torch.io.obj import load_obj

    path = os.path.join(_ASSETS, "blob.obj")
    if use_obj and os.path.exists(path):
        verts, tris, normals, _ = load_obj(path)
    else:
        verts, tris = meshgen.bumpy_sphere(subdiv=5, radius=1.3)
        normals = meshgen.vertex_normals(verts, tris)
    verts = verts + np.array([0.0, -0.1, -5.5], np.float32)

    mats = _mats([
        (DIFFUSE_AND_GLOSSY, (0.55, 0.48, 0.36), 0.8, 0.25, 40.0, 1.3),  # mesh
        (REFLECTION,         (0.0, 0.0, 0.0),    0.0, 0.0, 25.0, 12.0),  # mirror
        (DIFFUSE_AND_GLOSSY, CHECKER_C1,         0.8, 0.1, 10.0, 1.3),   # floor
    ])
    scene = make_scene(
        spheres=Spheres.build([(2.6, -0.4, -7.2)], [1.1], [1]),
        planes=Planes.build([(0.0, -1.5, 0.0)], [(0.0, 1.0, 0.0)],
                            [(1.0, 0.0, 0.0)], [(0.0, 0.0, 1.0)], [2],
                            checker=[1], checker_scale=[0.5],
                            albedo2=[CHECKER_C2]),
        meshes=Meshes.build(verts, tris, np.zeros((tris.shape[0],), np.int32),
                            normals=normals),
        materials=mats,
        lights=Lights.build([(-4.0, 7.0, 0.0), (4.0, 6.0, -2.0)],
                            [(0.7, 0.7, 0.7), (0.45, 0.45, 0.45)]),
    )
    cam = Camera.build(pos=(0.0, 0.6, 1.2), fov_deg=50.0)
    # one tile per 1080p frame: on the card a tile bounds memory only, and
    # the reference's 5120-ray screen-block tiles (a TPU VMEM choice) cost
    # ~300x in per-tile host dispatch — measured on an H100 80GB HBM3
    # (700 W): 25.5 s per frame at 5120 vs 0.069 s at one tile (PERF.md)
    opts = RenderOptions(width=1920, height=1080, max_depth=4,
                         tile_rays=1920 * 1080)
    return scene, cam, opts


def config5_inverse():
    """BASELINE config 5: inverse rendering — recover sphere positions + albedos
    from a target image via pixel-loss gradients. Returns
    (scene_init, scene_target, camera, opts)."""
    def build(centers, albedos):
        mats = _mats([
            (DIFFUSE_AND_GLOSSY, albedos[0], 0.8, 0.1, 25.0, 1.3),
            (DIFFUSE_AND_GLOSSY, albedos[1], 0.8, 0.1, 25.0, 1.3),
            (DIFFUSE_AND_GLOSSY, (0.5, 0.5, 0.5), 0.8, 0.0, 10.0, 1.3),
        ])
        return make_scene(
            spheres=Spheres.build(centers, [1.0, 0.8], [0, 1]),
            planes=Planes.build([(0.0, -1.5, 0.0)], [(0.0, 1.0, 0.0)],
                                [(1.0, 0.0, 0.0)], [(0.0, 0.0, 1.0)], [2]),
            materials=mats,
            lights=Lights.build([(-3.0, 6.0, 1.0)], [(0.9, 0.9, 0.9)]),
        )

    # Init close enough that interior-shading gradients dominate: visibility
    # (silhouette) gradients are zero by design (docs/SPEC.md), so recovery is
    # well-posed only when init and target silhouettes overlap substantially.
    target = build([(-1.2, -0.3, -6.0), (1.4, -0.5, -5.2)],
                   [(0.7, 0.15, 0.1), (0.1, 0.2, 0.7)])
    init = build([(-1.05, -0.4, -5.88), (1.28, -0.4, -5.35)],
                 [(0.4, 0.4, 0.4), (0.4, 0.4, 0.4)])
    cam = Camera.build(pos=(0.0, 0.5, 1.0), fov_deg=60.0)
    opts = RenderOptions(width=128, height=128, max_depth=0)
    return init, target, cam, opts


def config6_inverse_mesh():
    """Inverse rendering over MESH GEOMETRY: recover the vertex positions of a
    bumpy blob from a target render, starting from the smooth icosphere with
    the same topology. The C13 capability at mesh scale — gradients flow to
    `Meshes.verts` through both the hit recompute (ops/trace.surface_at) and
    the differentiable smooth normals (io/meshgen.vertex_normals_jnp), which
    the optimizer must re-derive from the moving vertices inside the loss.
    Returns (scene_init, scene_target, camera, opts)."""
    def build(verts, tris):
        mats = _mats([
            (DIFFUSE_AND_GLOSSY, (0.62, 0.45, 0.3), 0.8, 0.15, 25.0, 1.3),
            (DIFFUSE_AND_GLOSSY, (0.5, 0.5, 0.5), 0.8, 0.0, 10.0, 1.3),
        ])
        return make_scene(
            meshes=Meshes.build(verts, tris,
                                np.zeros((tris.shape[0],), np.int32),
                                normals=meshgen.vertex_normals(verts, tris)),
            planes=Planes.build([(0.0, -1.5, 0.0)], [(0.0, 1.0, 0.0)],
                                [(1.0, 0.0, 0.0)], [(0.0, 0.0, 1.0)], [1]),
            materials=mats,
            lights=Lights.build([(-3.0, 6.0, 1.0), (3.0, 4.0, 0.5)],
                                [(0.75, 0.75, 0.75), (0.4, 0.4, 0.4)]),
        )

    off = np.array([0.0, -0.1, -4.2], np.float32)
    # same icosphere topology: init and target differ ONLY in vertex positions
    # (bump small enough that silhouettes overlap — visibility gradients are
    # zero by design, docs/SPEC.md, so shading gradients must carry recovery)
    tv, tris = meshgen.bumpy_sphere(subdiv=2, radius=1.2, bump=0.08)
    iv, _ = meshgen.icosphere(subdiv=2, radius=1.2)
    target = build(tv + off, tris)
    init = build(iv + off, tris)
    cam = Camera.build(pos=(0.0, 0.4, 1.0), fov_deg=55.0)
    opts = RenderOptions(width=96, height=96, max_depth=0)
    return init, target, cam, opts


def config7_uv_quad():
    """UV-checkered mesh demo (SURVEY §1 L1 `getSurfaceProperties` → UV;
    §2.2 Mesh row "barycentrics kept for normals/UV"): a tilted two-triangle
    quad with vertex st coords and an st-checker albedo, plus a mirror sphere
    that reflects the pattern and a point light — the genre's textured-mesh
    demo in config-3 style. Golden-tested against both oracles."""
    mats = _mats([
        (DIFFUSE_AND_GLOSSY, (0.85, 0.3, 0.1), 0.8, 0.15, 25.0, 1.3),  # quad
        (REFLECTION,         (0.0, 0.0, 0.0),  0.0, 0.0, 25.0, 12.0),  # mirror
        (DIFFUSE_AND_GLOSSY, (0.45, 0.45, 0.5), 0.8, 0.05, 10.0, 1.3),  # floor
    ])
    # quad in the z=-6 plane tilted back 30°, spanning ~[-2,2]²
    c, s = np.cos(np.pi / 6), np.sin(np.pi / 6)
    corners = np.array([(-2.0, -1.4, 0.0), (2.0, -1.4, 0.0),
                        (2.0, 2.6, 0.0), (-2.0, 2.6, 0.0)], np.float32)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    verts = corners @ rot.T + np.array([0.0, 0.0, -6.0], np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uvs = np.array([(0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0)],
                   np.float32)
    scene = make_scene(
        spheres=Spheres.build([(1.6, -0.7, -4.2)], [0.8], [1]),
        planes=Planes.build([(0.0, -1.5, 0.0)], [(0.0, 1.0, 0.0)],
                            [(1.0, 0.0, 0.0)], [(0.0, 0.0, 1.0)], [2]),
        meshes=Meshes.build(verts, tris, [0, 0], uvs=uvs, checker=[1, 1],
                            checker_scale=[4.0, 4.0],
                            albedo2=[CHECKER_C2, CHECKER_C2]),
        materials=mats,
        lights=Lights.build([(-3.0, 5.0, 1.0), (3.0, 4.0, -1.0)],
                            [(0.8, 0.8, 0.8), (0.4, 0.4, 0.4)]),
    )
    cam = Camera.build(pos=(0.0, 0.3, 1.0), fov_deg=55.0)
    opts = RenderOptions(width=512, height=512, max_depth=2)
    return scene, cam, opts


# Scenes beyond the reference's presets, for the fused kernels' limits.

def many_spheres(n: int = 30, width: int = 96, height: int = 64):
    """n spheres on a grid, each with its own material (every fourth a
    mirror), over a plane that shares sphere 0's, under one light, depth 2:
    4n + 7n + 9 + 6 fused-path table floats (345 at n = 30, more than one
    train-kernel gradient window holds). Returns (scene, camera, opts)."""
    rng = np.random.default_rng(11)
    cols = int(np.ceil(np.sqrt(n)))
    centers = [((i % cols - cols / 2) * 1.1, (i // cols) * 0.9 - 1.0,
                -7.0 - 0.3 * (i % 3)) for i in range(n)]
    mtypes = [REFLECTION if i % 4 == 3 else DIFFUSE_AND_GLOSSY
              for i in range(n)]
    mats = Materials.build(mtypes, rng.uniform(0.1, 0.9, (n, 3)), [0.8] * n,
                           rng.uniform(0.05, 0.3, n), [25.0] * n, [1.3] * n)
    scene = make_scene(
        spheres=Spheres.build(centers, rng.uniform(0.3, 0.45, n), range(n)),
        planes=Planes.build([(0.0, -1.5, 0.0)], [(0.0, 1.0, 0.0)],
                            [(1.0, 0.0, 0.0)], [(0.0, 0.0, 1.0)], [0]),
        materials=mats,
        lights=Lights.build([(-3.0, 6.0, 1.0)], [(0.9, 0.9, 0.9)]))
    cam = Camera.build(pos=(0.0, 0.5, 1.0), fov_deg=60.0)
    return scene, cam, RenderOptions(width=width, height=height, max_depth=2)


def mirror_hall(width: int, height: int, max_depth: int):
    """config2 between two mirror planes, its floor and a ceiling above the
    lights: most rays bounce until max_depth, so a deep tree keeps nearly
    every level live. Returns (scene, camera, opts)."""
    scene, cam, opts = config2_mirror_spheres()
    mirror = 2  # config2's mirror material
    scene = scene.replace(planes=Planes.build(
        [(0.0, -1.5, 0.0), (0.0, 8.0, 0.0)], [(0.0, 1.0, 0.0),
                                              (0.0, -1.0, 0.0)],
        [(1.0, 0.0, 0.0)] * 2, [(0.0, 0.0, 1.0)] * 2, [mirror, mirror]))
    return scene, cam, dataclasses.replace(opts, width=width, height=height,
                                           max_depth=max_depth)


PRESETS = {
    "config1": config1_sphere_plane,
    "config2": config2_mirror_spheres,
    "config3": config3_cornell,
    "config4": config4_mesh,
    "config5": config5_inverse,
    "config6": config6_inverse_mesh,   # (init, target, cam, opts), like 5
    "config7": config7_uv_quad,
}


def get_preset(name: str):
    return PRESETS[name]()
