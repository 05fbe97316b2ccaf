"""Scene / camera / options — struct-of-arrays dataclasses, no polymorphism.

Counterpart of `raytracer_tpu/core/types.py`. Scenes are built as host numpy
dataclasses (cold path, bit-equal to the reference's presets); `.to(device)`
returns the same dataclass with torch tensor leaves on `device`, which is
what the renderer consumes. Material dispatch stays branchless (`where`
blends over the material codes below).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Material type codes (docs/SPEC.md "Materials")
DIFFUSE_AND_GLOSSY = 0
REFLECTION = 1
REFLECTION_AND_REFRACTION = 2

# Primitive kind codes carried in hit records
KIND_NONE = 0
KIND_SPHERE = 1
KIND_PLANE = 2
KIND_TRIANGLE = 3


def _f32(x):
    return np.asarray(x, np.float32)


def _i32(x):
    return np.asarray(x, np.int32)


def _leaf_to(x, device):
    """numpy array or tensor → tensor on `device`, dtype kept (f32 / i32)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class _Table:
    """Mixin: `.to(device)` maps every array field to a tensor on `device`."""

    def to(self, device):
        return dataclasses.replace(self, **{
            f.name: _leaf_to(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class Spheres(_Table):
    center: np.ndarray  # [Ns, 3] f32
    radius: np.ndarray  # [Ns]    f32
    mat_id: np.ndarray  # [Ns]    i32

    @staticmethod
    def build(center, radius, mat_id) -> "Spheres":
        return Spheres(_f32(center).reshape(-1, 3), _f32(radius).reshape(-1),
                       _i32(mat_id).reshape(-1))

    @staticmethod
    def empty() -> "Spheres":
        return Spheres.build(np.zeros((0, 3)), np.zeros((0,)), np.zeros((0,)))

    @property
    def count(self) -> int:
        return self.center.shape[0]


@dataclasses.dataclass
class Planes(_Table):
    """Infinite-plane pack with optional checkerboard albedo (SPEC: Plane)."""

    point: np.ndarray          # [Np, 3] f32
    normal: np.ndarray         # [Np, 3] f32 unit
    tangent: np.ndarray        # [Np, 3] f32 unit (u axis for checker uv)
    bitangent: np.ndarray      # [Np, 3] f32 unit (v axis)
    mat_id: np.ndarray         # [Np]    i32
    checker: np.ndarray        # [Np]    i32 0/1
    checker_scale: np.ndarray  # [Np]    f32
    albedo2: np.ndarray        # [Np, 3] f32 second checker color

    @staticmethod
    def build(point, normal, tangent, bitangent, mat_id, checker=None,
              checker_scale=None, albedo2=None) -> "Planes":
        point = _f32(point).reshape(-1, 3)
        n = point.shape[0]
        if checker is None:
            checker = np.zeros((n,), np.int32)
        if checker_scale is None:
            checker_scale = np.ones((n,), np.float32)
        if albedo2 is None:
            albedo2 = np.zeros((n, 3), np.float32)
        return Planes(point, _f32(normal).reshape(-1, 3),
                      _f32(tangent).reshape(-1, 3), _f32(bitangent).reshape(-1, 3),
                      _i32(mat_id).reshape(-1), _i32(checker).reshape(-1),
                      _f32(checker_scale).reshape(-1), _f32(albedo2).reshape(-1, 3))

    @staticmethod
    def empty() -> "Planes":
        z3 = np.zeros((0, 3))
        z = np.zeros((0,))
        return Planes.build(z3, z3, z3, z3, z)

    @property
    def count(self) -> int:
        return self.point.shape[0]


@dataclasses.dataclass
class Meshes(_Table):
    """Triangle soup (all meshes flattened), vertex-aligned normals and uvs."""

    verts: np.ndarray     # [V, 3] f32
    tris: np.ndarray      # [T, 3] i32
    normals: np.ndarray   # [V, 3] f32 vertex normals, or [0,3] for flat shading
    mat_id: np.ndarray    # [T]    i32
    uvs: np.ndarray       # [V, 2] f32 per-vertex texture coords, or [0,2]
    checker: np.ndarray   # [T]    i32 0/1 — st-checker albedo on this triangle
    checker_scale: np.ndarray  # [T] f32 — checker frequency in st units
    albedo2: np.ndarray   # [T, 3] f32 — second checker color

    @staticmethod
    def build(verts, tris, mat_id, normals=None, uvs=None, checker=None,
              checker_scale=None, albedo2=None) -> "Meshes":
        tris = _i32(tris).reshape(-1, 3)
        t = tris.shape[0]
        if normals is None:
            normals = np.zeros((0, 3), np.float32)
        if uvs is None:
            uvs = np.zeros((0, 2), np.float32)
        if checker is None:
            checker = np.zeros((t,), np.int32)
        if checker_scale is None:
            checker_scale = np.ones((t,), np.float32)
        if albedo2 is None:
            albedo2 = np.zeros((t, 3), np.float32)
        return Meshes(_f32(verts).reshape(-1, 3), tris,
                      _f32(normals).reshape(-1, 3), _i32(mat_id).reshape(-1),
                      _f32(uvs).reshape(-1, 2), _i32(checker).reshape(-1),
                      _f32(checker_scale).reshape(-1),
                      _f32(albedo2).reshape(-1, 3))

    @staticmethod
    def empty() -> "Meshes":
        return Meshes.build(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0,)))

    @property
    def count(self) -> int:
        return self.tris.shape[0]

    @property
    def smooth(self) -> bool:
        return self.normals.shape[0] > 0

    @property
    def has_uv(self) -> bool:
        return self.uvs.shape[0] > 0

    def tri_soa(self):
        """Gather (v0, e1, e2) [T,3] each — the Möller–Trumbore layout."""
        v0 = self.verts[self.tris[:, 0]]
        v1 = self.verts[self.tris[:, 1]]
        v2 = self.verts[self.tris[:, 2]]
        return v0, v1 - v0, v2 - v0


@dataclasses.dataclass
class Materials(_Table):
    mtype: np.ndarray   # [M] i32 (0 diffuse/glossy, 1 mirror, 2 glass)
    albedo: np.ndarray  # [M, 3] f32
    kd: np.ndarray      # [M] f32
    ks: np.ndarray      # [M] f32
    spec_n: np.ndarray  # [M] f32 specular exponent
    ior: np.ndarray     # [M] f32 index of refraction

    @staticmethod
    def build(mtype, albedo, kd, ks, spec_n, ior) -> "Materials":
        return Materials(_i32(mtype).reshape(-1), _f32(albedo).reshape(-1, 3),
                         _f32(kd).reshape(-1), _f32(ks).reshape(-1),
                         _f32(spec_n).reshape(-1), _f32(ior).reshape(-1))


@dataclasses.dataclass
class Lights(_Table):
    pos: np.ndarray        # [L, 3] f32
    intensity: np.ndarray  # [L, 3] f32

    @staticmethod
    def build(pos, intensity) -> "Lights":
        return Lights(_f32(pos).reshape(-1, 3), _f32(intensity).reshape(-1, 3))

    @property
    def count(self) -> int:
        return self.pos.shape[0]


@dataclasses.dataclass
class Scene:
    """Whole scene. `has_glass` decides whether the wavefront ray buffers
    double per bounce (glass spawns a refraction child)."""

    spheres: Spheres
    planes: Planes
    meshes: Meshes
    materials: Materials
    lights: Lights
    has_glass: bool = False

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Scene":
        """The tensor copy of this scene on `device` (what the renderer uses)."""
        return Scene(self.spheres.to(device), self.planes.to(device),
                     self.meshes.to(device), self.materials.to(device),
                     self.lights.to(device), has_glass=self.has_glass)


def make_scene(spheres=None, planes=None, meshes=None, materials=None,
               lights=None) -> Scene:
    spheres = spheres if spheres is not None else Spheres.empty()
    planes = planes if planes is not None else Planes.empty()
    meshes = meshes if meshes is not None else Meshes.empty()
    if materials is None or lights is None:
        raise ValueError("a scene needs materials and lights")
    has_glass = bool(np.any(np.asarray(materials.mtype)
                            == REFLECTION_AND_REFRACTION))
    return Scene(spheres, planes, meshes, materials, lights, has_glass=has_glass)


@dataclasses.dataclass
class Camera(_Table):
    """Pinhole camera: position + camera-to-world rotation + vertical fov."""

    pos: np.ndarray      # [3] f32
    c2w: np.ndarray      # [3,3] f32 rotation (columns: right, up, -forward)
    fov_deg: np.ndarray  # [] f32 vertical field of view

    @staticmethod
    def build(pos=(0.0, 0.0, 0.0), c2w=None, fov_deg=90.0) -> "Camera":
        if c2w is None:
            c2w = np.eye(3)
        return Camera(_f32(pos).reshape(3), _f32(c2w).reshape(3, 3),
                      _f32(fov_deg).reshape(()))

    @staticmethod
    def look_at(eye, target, up=(0.0, 1.0, 0.0), fov_deg=90.0) -> "Camera":
        eye = np.asarray(eye, np.float64)
        fwd = np.asarray(target, np.float64) - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float64))
        right = right / np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        c2w = np.stack([right, true_up, -fwd], axis=1)  # maps (x, y, -1) → world
        return Camera.build(eye, c2w, fov_deg)


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Static render options; the same fields and defaults as the reference.

    `remat_tiles` and `remat_policy` ("plan" or "full") set how a
    differentiable render recomputes its tiles in the backward (renderer.py).
    `compact_cap` turns on wavefront compaction (renderer.use_compact):
    glass wavefronts, and any wavefront under a fractional cap, keep at most
    cap × the tile's primary lanes per bounce.
    """

    width: int = 256
    height: int = 256
    max_depth: int = 4
    bias: float = 1e-4
    t_min: float = 1e-4
    background: tuple = (0.235294, 0.67451, 0.843137)
    tile_rays: int = 16384   # primary rays per wavefront tile
    remat_tiles: bool = True
    remat_policy: str = "plan"
    tri_chunk: int = 1024    # triangles per step of the dense triangle search
    compact_cap: float | None = None
    tile_block: tuple | None = None  # (bh, bw) screen-block tile order:
    # tiles become bh×bw pixel blocks (bh·bw == tile_rays) instead of flat
    # row-major runs — neighbouring lanes are neighbouring pixels, which
    # keeps a grid walk's rays coherent. Radiance is identical per pixel.


_TABLES = {"spheres": Spheres, "planes": Planes, "meshes": Meshes,
           "materials": Materials, "lights": Lights}


def _carry(cls, obj):
    return cls(**{f.name: np.asarray(getattr(obj, f.name))
                  for f in dataclasses.fields(cls)})


def scene_from_arrays(obj):
    """Carry a reference `Scene` or `Camera` (numpy leaves, read by attribute
    name so no reference type is imported) across to this package's objects
    with bit-equal arrays."""
    if hasattr(obj, "spheres"):
        return Scene(**{name: _carry(cls, getattr(obj, name))
                        for name, cls in _TABLES.items()},
                     has_glass=bool(obj.has_glass))
    if hasattr(obj, "c2w"):
        return _carry(Camera, obj)
    raise TypeError(f"not a scene or camera: {type(obj).__name__}")
