"""Ranks of the frame-service checks (tests/test_torch_frames.py): targets
of `raytracer_tpu_torch.parallel.frames.spawn_ranks` on the CPU (gloo).
Imports no JAX. Rank 0 writes what the test reads into OUT_DIR."""

import json
import os

import numpy as np
import torch.distributed as dist

from raytracer_tpu_torch.core.types import Camera
from raytracer_tpu_torch.parallel import shard
from raytracer_tpu_torch.parallel.frames import ShardedFrames
from raytracer_tpu_torch.utils.hostload import load_scene_cli

W, H, DEPTH = 64, 36, 4
YAWS = (0.0, 0.021, -0.034)   # three views, turned about the camera's up axis
FAIL_RANK, FAIL_FRAME = 2, 1  # failing_case: the rank that raises, and when


def config4_small():
    return load_scene_cli("config4", "", W, H, DEPTH)


def views(cam) -> list:
    out = []
    for yaw in YAWS:
        c, s = np.cos(yaw), np.sin(yaw)
        turn = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        out.append(Camera.build(cam.pos, np.asarray(cam.c2w, np.float64) @ turn,
                                cam.fov_deg))
    return out


def frames_case(device, out_dir: str):
    """Rank 0 renders the three views and stops the others; every rank
    writes what its `serve()` or `stop()` returned."""
    scene, cam, opts = config4_small()
    frames = ShardedFrames(scene, opts, device=device)
    rank = dist.get_rank()
    if rank:
        frames.serve()
        with open(os.path.join(out_dir, f"served_r{rank}.json"), "w") as f:
            json.dump({"frames": frames.frames}, f)
        return
    imgs = [frames.frame(v).numpy() for v in views(cam)]
    report = frames.stop()
    np.save(os.path.join(out_dir, "images.npy"), np.stack(imgs))
    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f)


def failing_case(device, out_dir: str):
    """frames_case, but rank FAIL_RANK raises in frame FAIL_FRAME."""
    if dist.get_rank() == FAIL_RANK:
        real, calls = shard.render_rays, []

        def render_rays(*args, **kw):
            calls.append(1)
            if len(calls) > FAIL_FRAME:
                raise RuntimeError(f"planted failure in frame {FAIL_FRAME}")
            return real(*args, **kw)

        shard.render_rays = render_rays
    frames_case(device, out_dir)


def raising_case(device):
    """A rank that fails as soon as it has joined."""
    raise RuntimeError("planted failure after the join")
