"""Host-side scene/tracer loading for the entry points: the CLI, its
supervised children and the band workers (counterpart of
`raytracer_tpu/utils/hostload.py`).

Preset-vs-scenefile loading with width/height/depth overrides, the
mesh-gated choice of the winner-search backend, and the device check. Scenes
build as host numpy dataclasses; the tracer is built for an explicit device.
"""

import dataclasses
import os
import sys

# the directory that holds the package: child processes run there
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# exit codes of an entry point that cannot start: it finds no device of the
# kind asked for, or argparse refused its arguments. The supervisor and the
# band driver stop on them instead of retrying
NO_DEVICE_EXIT, USAGE_EXIT = 3, 2


def cli_device(name: str):
    """`torch.device(name)`; exits with NO_DEVICE_EXIT when it names CUDA and
    no CUDA device is available (never falls back to the CPU)."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {name}: no CUDA device is available (pass --device "
              "cpu to run on the CPU)", file=sys.stderr, flush=True)
        raise SystemExit(NO_DEVICE_EXIT)
    return dev


def load_scene_cli(config: str = "", scene_path: str = "", width: int = 0,
                   height: int = 0, max_depth: int | None = None):
    """(scene, camera, opts) from a preset name or a scene text file."""
    if scene_path:
        from raytracer_tpu_torch.io.scenefile import load_scene

        scene, cam, opts = load_scene(scene_path)
    else:
        from raytracer_tpu_torch.models import presets

        scene, cam, opts = presets.PRESETS[config]()
    if width:
        opts = dataclasses.replace(opts, width=width, height=height or width)
    if max_depth is not None:
        opts = dataclasses.replace(opts, max_depth=max_depth)
    return scene, cam, opts


def build_tracer(scene, kind: str, device):
    """Winner-search backend for `kind` in {auto, none, grid, grid-pallas,
    bvh, pallas, mat} on `device`; None when the scene has no mesh (the dense
    search covers analytic primitives). `grid-pallas` is the reference's grid
    walk through its kernel; here the grid tracer always walks through the
    kernel on the card (and its plain version on the CPU), so it is `grid`.
    The `fused` backend is not built here: it replaces the whole renderer,
    not the tracer (cli.cmd_render handles it)."""
    if kind not in ("auto", "none", "grid", "grid-pallas", "bvh", "pallas",
                    "mat"):
        raise ValueError(f"unknown tracer kind: {kind!r}")
    if not scene.meshes.count or kind == "none":
        return None
    if kind == "bvh":
        from raytracer_tpu_torch.accel.bvh import BVHTracer

        return BVHTracer.build(scene, device)
    if kind == "pallas":
        from raytracer_tpu_torch.ops.pallas_trace import PallasTracer

        return PallasTracer(scene, device)
    if kind == "mat":
        from raytracer_tpu_torch.ops.mat_trace import MatTracer

        return MatTracer.build(scene, device)
    from raytracer_tpu_torch.accel.grid import GridTracer

    return GridTracer.build(scene, device)
