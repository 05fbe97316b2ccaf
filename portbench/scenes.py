"""Configurations: `configs/<name>.json` → the plain scene that the
reference reads, and the program's scene, camera and options.

Both sides are given the same data: the tables of the file and the same
raw mesh file, which each side reads with its own reader (the program's is
part of what the benchmark measures). The mesh file is held to the
checksum in the configuration, so the yardstick cannot move under it.
"""

import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_config(name: str) -> dict:
    """The configuration `name`, its mesh file checked against its
    checksum."""
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    mesh = cfg.get("mesh")
    if mesh and "obj" in mesh:
        with open(os.path.join(ROOT, mesh["obj"]), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != mesh["sha256"]:
            raise ValueError(f"{mesh['obj']}: sha256 {digest}, the configuration "
                             f"{name} was written for {mesh['sha256']}")
    return cfg


def _mesh_arrays(mesh: dict, read_obj):
    """(verts f32 [V,3], tris i32 [T,3], normals or None, mat i32 [T])."""
    if "obj" in mesh:
        verts, tris, normals = read_obj(os.path.join(ROOT, mesh["obj"]))[:3]
        verts = verts + np.asarray(mesh["translate"], np.float32)
        mat = np.full((tris.shape[0],), mesh["mat"], np.int32)
        return verts.astype(np.float32), tris, normals, mat
    return (np.asarray(mesh["verts"], np.float32), np.asarray(mesh["tris"], np.int32),
            None, np.asarray(mesh["mat"], np.int32))


def plain_scene(cfg: dict) -> dict:
    """The scene as plain numpy tables, the mesh read by the reference's
    own OBJ reader (`portbench.reference.whitted.Reference` takes it)."""
    from portbench.reference.obj import read_obj

    out = {k: cfg[k] for k in ("spheres", "planes", "materials", "lights", "opts")}
    out["mesh"] = None
    if cfg.get("mesh"):
        verts, tris, normals, mat = _mesh_arrays(cfg["mesh"], read_obj)
        out["mesh"] = {"verts": verts, "tris": tris, "normals": normals, "mat": mat}
    return out


def port_scene(cfg: dict):
    """The program's (Scene, RenderOptions) for the configuration; the mesh
    read by the program's own OBJ loader."""
    from raytracer_tpu_torch.core.types import (Lights, Materials, Meshes,
                                                Planes, RenderOptions, Spheres,
                                                make_scene)
    from raytracer_tpu_torch.io.obj import load_obj

    sp, pl, ma, li = cfg["spheres"], cfg["planes"], cfg["materials"], cfg["lights"]
    meshes = None
    if cfg.get("mesh"):
        verts, tris, normals, mat = _mesh_arrays(
            cfg["mesh"], lambda path: load_obj(path))
        meshes = Meshes.build(verts, tris, mat, normals=normals)
    planes = None
    if pl["mat"]:
        planes = Planes.build(pl["point"], pl["normal"], pl["tangent"], pl["bitangent"],
                              pl["mat"], checker=pl["checker"],
                              checker_scale=pl["scale"], albedo2=pl["albedo2"])
    scene = make_scene(
        spheres=Spheres.build(sp["center"], sp["radius"], sp["mat"]) if sp["mat"] else None,
        planes=planes, meshes=meshes,
        materials=Materials.build(ma["mtype"], ma["albedo"], ma["kd"], ma["ks"],
                                  ma["spec_n"], ma["ior"]),
        lights=Lights.build(li["pos"], li["intensity"]))
    op = cfg["opts"]
    opts = RenderOptions(width=op["width"], height=op["height"],
                         max_depth=op["max_depth"], bias=op["bias"], t_min=op["t_min"],
                         background=tuple(op["background"]), tile_rays=op["tile_rays"],
                         remat_tiles=op["remat_tiles"], compact_cap=op["compact_cap"])
    return scene, opts


def port_camera(view: dict):
    """The program's Camera of a view (`views.view`)."""
    from raytracer_tpu_torch.core.types import Camera

    return Camera.build(pos=view["pos"], c2w=view["c2w"], fov_deg=view["fov"])


def resized(cfg: dict, width: int, height: int, max_depth: int | None = None) -> dict:
    """The configuration at another frame size (tests run tiny frames)."""
    opts = dict(cfg["opts"], width=width, height=height,
                tile_rays=min(cfg["opts"]["tile_rays"], width * height))
    if max_depth is not None:
        opts["max_depth"] = max_depth
    return dict(cfg, opts=opts)

