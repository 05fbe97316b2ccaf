"""One rank of the port's multi-rank CPU checks (tests/test_torch_dist.py).

    python tests/torch_dist_worker.py RANK WORLD STORE_FILE OUT_DIR

Joins a gloo group of WORLD ranks through a `file://` store, runs every
case below on the port's `parallel/` package, and writes each case's
results as OUT_DIR/<case>_r<RANK>.npz (or the traceback as
<case>_r<RANK>.err, and goes on with the next case). Imports no JAX: the
test compares these results with the single-device port and with the JAX
package.
"""

import dataclasses
import os
import sys
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from raytracer_tpu_torch.core.types import Meshes  # noqa: E402
from raytracer_tpu_torch.io import meshgen  # noqa: E402
from raytracer_tpu_torch.models import presets  # noqa: E402
from raytracer_tpu_torch.parallel.mesh import (init_distributed,  # noqa: E402
                                               make_rt_mesh)

DEV = "cpu"
# (tiles, prims, ring) layouts of the image cases
LAYOUTS = [(4, 1, False), (2, 2, False), (1, 4, False), (2, 2, True),
           (1, 4, True)]


def layout_name(t, p, ring):
    return f"layout_t{t}p{p}{'r' if ring else ''}"


def config2_small(w=64, h=48, **kw):
    scene, cam, opts = presets.config2_mirror_spheres()
    return scene, cam, dataclasses.replace(opts, width=w, height=h,
                                           tile_rays=256, **kw)


def bumpy_config4():
    """config4 with a subdivision-3 bumpy sphere for the blob, 64×40 d2, 256-ray
    tiles (tests/torch_cases.subdiv3_config4's scene, built here jax-free)."""
    scene, cam, opts = presets.config4_mesh(use_obj=False)
    verts, tris = meshgen.bumpy_sphere(subdiv=3, radius=1.3)
    verts = verts + np.array([0.0, -0.1, -5.5], np.float32)
    scene = scene.replace(meshes=Meshes.build(
        verts, tris, np.zeros((tris.shape[0],), np.int32),
        normals=meshgen.vertex_normals(verts, tris)))
    return scene, cam, dataclasses.replace(opts, width=64, height=40,
                                           max_depth=2, tile_rays=256)


def overlap_cases():
    """name → (scene, cam, opts, ring): tests/test_overlap.py's cases."""
    c1, cam1, o1 = presets.config1_sphere_plane()
    c2, cam2, o2 = presets.config2_mirror_spheres()
    c3, cam3, o3 = presets.config3_cornell()
    return {
        "overlap_mirror": (c2, cam2, dataclasses.replace(
            o2, width=64, height=64, max_depth=2), False),
        "overlap_glass": (c3, cam3, dataclasses.replace(
            o3, width=48, height=48, max_depth=2), False),
        "overlap_ring": (c2, cam2, dataclasses.replace(
            o2, width=64, height=64, max_depth=1), True),
        "overlap_uneven": (c1, cam1, dataclasses.replace(
            o1, width=54, height=37, max_depth=1), False),
    }


def fused_case():
    scene, cam, opts = presets.PRESETS["config2"]()
    return scene, cam, dataclasses.replace(opts, width=96, height=64)


def run_cases(out_dir: str, rank: int):
    from raytracer_tpu_torch.accel.grid import GridTracer
    from raytracer_tpu_torch.ops.fused import FusedWhitted
    from raytracer_tpu_torch.parallel.overlap import (
        float_partition, loss_and_grad_overlapped, make_loss_and_grad)
    from raytracer_tpu_torch.parallel.shard import render_sharded
    from raytracer_tpu_torch.renderer import as_leaf, render

    def case(name, fn):
        try:
            out = fn()
        except Exception:  # recorded for the test of this case; go on
            with open(os.path.join(out_dir, f"{name}_r{rank}.err"), "w") as f:
                f.write(traceback.format_exc())
            return
        np.savez(os.path.join(out_dir, f"{name}_r{rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})

    meshes = {}

    def mesh(t, p):  # every rank creates the same groups in the same order
        if (t, p) not in meshes:
            meshes[(t, p)] = make_rt_mesh(tiles=t, prims=p)
        return meshes[(t, p)]

    scene2, cam2, opts2 = config2_small()
    for t, p, ring in LAYOUTS:
        def layout(t=t, p=p, ring=ring):
            img, traced = render_sharded(scene2, cam2, opts2, mesh(t, p),
                                         ring=ring, count_rays=True,
                                         device=DEV)
            return {"img": img, "traced": traced}
        case(layout_name(t, p, ring), layout)

    scene4, cam4, opts4 = bumpy_config4()

    def grid():
        tracer = GridTracer.build(scene4, DEV)
        img, traced = render_sharded(scene4, cam4, opts4, mesh(2, 2),
                                     tracer=tracer, count_rays=True,
                                     device=DEV)
        return {"img": img, "traced": traced}
    case("grid", grid)

    def bvh():
        out = {"dense": render_sharded(scene4, cam4, opts4, mesh(2, 2),
                                       device=DEV)[0]}
        for ring in (False, True):
            out[f"ring{int(ring)}"] = render_sharded(
                scene4, cam4, opts4, mesh(2, 2), ring=ring, accel="bvh",
                device=DEV)[0]
        return out
    case("bvh", bvh)

    def depths():
        """bumpy config4 to depth 4: the mirror sphere's lanes die after
        bounce 1, the others' after bounce 0. Each search's bounces run
        (the span aggregate's `rt.bounce.<d>` counts) and reads (`rt.alive`)
        on this rank."""
        from raytracer_tpu_torch.utils import profiling

        opts = dataclasses.replace(opts4, max_depth=4)
        out = {}
        for name, kw in (("shard", {}), ("ring", {"ring": True}),
                         ("grid", {"tracer": GridTracer.build(scene4, DEV)})):
            profiling.reset()
            img, traced = render_sharded(scene4, cam4, opts, mesh(2, 2),
                                         count_rays=True, device=DEV, **kw)
            seen = profiling.spans()
            out[f"img_{name}"] = img
            out[f"traced_{name}"] = traced
            out[f"bounces_{name}"] = np.array(
                [seen.get(f"rt.bounce.{d}", {"count": 0})["count"]
                 for d in range(opts.max_depth + 1)])
            out[f"reads_{name}"] = np.array(
                seen.get("rt.alive", {"count": 0})["count"])
        return out
    case("depths", depths)

    def glass():
        scene, cam, opts = presets.config3_cornell()
        opts = dataclasses.replace(opts, width=32, height=24, max_depth=3,
                                   tile_rays=256, compact_cap=1)
        img, traced, dropped = render_sharded(scene, cam, opts, mesh(4, 1),
                                              device=DEV)
        return {"img": img, "dropped": dropped}
    case("glass", glass)

    def grads():
        scene, cam, opts = config2_small(32, 32)
        c = as_leaf(scene.spheres.center, DEV)
        sc = scene.to(DEV)
        sc = sc.replace(spheres=dataclasses.replace(sc.spheres, center=c))
        img = render_sharded(sc, cam, opts, mesh(2, 2), device=DEV)[0]
        loss = ((img - 0.25) ** 2).mean()
        loss.backward()
        return {"loss": loss.detach(), "grad": c.grad}
    case("grads", grads)

    for name, (scene, cam, opts, ring) in overlap_cases().items():
        def overlap(scene=scene, cam=cam, opts=opts, ring=ring):
            m = mesh(2, 2)
            img = render_sharded(scene, cam, opts, m, device=DEV)[0]
            target = img * 0.9
            out = {"mse": ((img - target) ** 2).mean()}
            plain = make_loss_and_grad(scene, cam, opts, m, ring=ring,
                                       overlap=False, device=DEV)
            for tag, (loss, g) in (
                    ("o", loss_and_grad_overlapped(scene, cam, opts, m,
                                                   target, ring=ring,
                                                   device=DEV)),
                    ("f", plain(scene, target))):
                fl, _, _ = float_partition(g)
                out[f"loss_{tag}"] = loss
                for i, x in enumerate(fl):
                    out[f"g{tag}_{i}"] = x
            return out
        case(name, overlap)

    def fused():
        scene, cam, opts = fused_case()
        target = render(scene, cam, opts, device=DEV)[0] * 0.9
        fw = FusedWhitted(scene, cam, opts, device=DEV, param_inputs=True)
        loss, g = fw.plan_value_and_grad_sharded(target, mesh(4, 1))
        return {"loss": loss, "target": target, **g}
    case("fused", fused)


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, out_dir = sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)  # the ranks share the test machine's cores
    init_distributed("file://" + store, world, rank, device=DEV)
    try:
        run_cases(out_dir, rank)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
