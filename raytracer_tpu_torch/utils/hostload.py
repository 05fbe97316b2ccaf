"""Host-side scene/tracer loading for the CLI (counterpart of
`raytracer_tpu/utils/hostload.py`).

Preset-vs-scenefile loading with width/height/depth overrides, and the
mesh-gated choice of the winner-search backend. Scenes build as host numpy
dataclasses; the tracer is built for an explicit device.
"""

import dataclasses

# tracer kinds of the reference that this package does not have, and why
_NOT_PORTED = {
    "grid-pallas": "nothing: on this card the grid walk IS the CUDA kernel "
                   "(--tracer grid)",
}


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
    """Winner-search backend for `kind` in {auto, none, grid, bvh, pallas,
    mat} on `device`; None when the scene has no mesh (the dense search covers
    analytic primitives). The `fused` backend is not built here: it replaces
    the whole renderer, not the tracer (cli.cmd_render handles it)."""
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"tracer {kind!r} is not ported yet: "
                                  f"{_NOT_PORTED[kind]}")
    if kind not in ("auto", "none", "grid", "bvh", "pallas", "mat"):
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
