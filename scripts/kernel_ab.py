"""The BVH walk (csrc/bvh_walk.cu) and the culled sweep (csrc/cull_sweep.cu)
of several source trees, timed on one card in turns.

    python3 scripts/kernel_ab.py --parent DIR [--variant DIR ...] [--rounds 1]

DIR is another checkout of the repository (e.g. `git archive <commit>`
unpacked into a directory that .gitignore lists). The script runs one
process per tree and turn, in the order parent, this tree, the variants,
the variants again in reverse, this tree, parent (`--rounds` times), each
of which builds its tree's kernels and, at config4 1920×1080 d4 on cuda:0,
with this tree's `chip_smoke.py` helpers (the same yardstick for every
tree):
- records the BVH walk's calls of one `--tracer bvh` frame
  (`render_banded` with `BVHTracer`) and the culled sweep's of one
  `HybridBand` frame (32×160 screen blocks, cap 1024);
- times the `--tracer bvh`, `HybridBand` and grid frames (`frame_times`),
  before any profiler session;
- times each kernel's calls whole (`bvh_times`, `cull_times`): the
  kernel's own device ms by the profiler, every device interval of the
  calls, CUDA events around them and the host's time to issue them.
Each process prints one JSON line; the last lines compare the trees.

    python3 scripts/kernel_ab.py --tree DIR

runs one such process. Needs a CUDA device; imports neither jax nor the
JAX package.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMES = ("kernel_ms", "device_ms", "events_ms", "host_ms")
FRAMES = ("bvh_frame_s", "hybrid_frame_s", "grid_frame_s")


def smoke():
    """This tree's chip_smoke.py (its timing helpers), loaded by path; they
    import the package of whichever tree leads sys.path."""
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one_tree(tree: str) -> dict:
    """Build and time one tree's two kernels (see the module docstring)."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import dataclasses

    import torch

    cs = smoke()
    from raytracer_tpu_torch.accel.bvh import BVHTracer
    from raytracer_tpu_torch.accel.cull import HybridBand
    from raytracer_tpu_torch.kernels import build
    from raytracer_tpu_torch.ops import bvh_walk as BW
    from raytracer_tpu_torch.ops import cull_sweep as CS
    from raytracer_tpu_torch.renderer import render_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli

    assert os.path.dirname(os.path.dirname(os.path.dirname(
        build.__file__))) == tree, build.__file__
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device available")
    device = torch.device("cuda", 0)
    _, build_s = build.build_library()
    build.load_library()
    scene, cam, opts = load_scene_cli("config4")
    grid = build_tracer(scene, "auto", device)
    bvh = BVHTracer.build(scene, device)
    out = {"tree": tree, "card": cs.card_line(), "build_s": build_s}

    def bvh_frame():
        return render_banded(scene, cam, opts, device=device, tracer=bvh)

    block = dataclasses.replace(opts, tile_rays=32 * 160,
                                tile_block=(32, 160))
    band = HybridBand(scene, cam, block, device=device, inner=grid, cap=1024)
    # the frames first, before any profiler session in this process
    out["bvh_frame_s"] = cs.frame_times(bvh_frame)[0]
    out["hybrid_frame_s"] = cs.frame_times(band)[0]
    out["grid_frame_s"] = cs.frame_times(lambda: render_banded(
        scene, cam, opts, device=device, tracer=grid))[0]

    with cs.recording(BW, ("bvh_walk_cuda",)) as rec:
        bvh_frame()
    out["bvh"] = cs.bvh_times(rec["bvh_walk_cuda"])
    with cs.recording(CS, ("cull_nearest", "cull_occluded")) as rec:
        band()
    out["cull"] = cs.cull_times([("nearest", a) for a in rec["cull_nearest"]]
                                + [("occluded", a)
                                   for a in rec["cull_occluded"]])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="the other tree: run the trees in turns")
    ap.add_argument("--variant", action="append", default=[],
                    help="a further tree, run in turns with the two")
    ap.add_argument("--tree", help="time one tree in this process")
    ap.add_argument("--rounds", type=int, default=1,
                    help="rounds of turns: parent, this, variants, and back")
    args = ap.parse_args()
    if args.tree:
        print(json.dumps(one_tree(args.tree)), flush=True)
        return 0
    if not args.parent:
        ap.error("--parent or --tree")
    trees = [os.path.abspath(t) for t in (args.parent, HERE, *args.variant)]
    runs = []
    for tree in (trees + trees[::-1]) * args.rounds:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--tree", tree], capture_output=True,
                              text=True, cwd=HERE)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    for tree in trees:
        mine = [r for r in runs if r["tree"] == tree]
        for key in ("bvh", "cull"):
            print(f"{tree}: {key} over {len(mine[0][key]['each_ms'])} "
                  "launches, ms: " + "; ".join(
                      f"{t} " + ", ".join(f"{r[key][t]:.4f}" for r in mine)
                      for t in TIMES))
        for key in FRAMES:
            print(f"{tree}: {key} " + ", ".join(f"{r[key]:.4f}"
                                                 for r in mine))
    print(runs[0]["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
