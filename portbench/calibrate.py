"""Readings that the correctness limits are set from, on the card at the
cells' own sizes (not part of a benchmark run):

    python3 -m portbench.calibrate <out> counts
        the reference's ray counts of every configuration, written to
        <out>/counts/<config>.json (the frozen copies live in
        portbench/reference/counts/);
    python3 -m portbench.calibrate <out> program <cell> <seed>,<seed>,...
        sound runs of the program: a short window per seed, its numbers;
    python3 -m portbench.calibrate <out> control <cell> <seed>,<seed>,...
        the control, the reference in bfloat16 in the program's place, and
        for a training cell the planted fault "half of the batch left out"
        (the reference's loss over the top half, its mean); a step that
        leaves the state unchanged reads 1 by construction;
    python3 -m portbench.calibrate <out> look <cell> <seed>,<seed>,...
        a training cell's first steps on four independent trajectories:
        the program as the window runs it, the program with its BVH walk
        in place of the grid, the reference in float32 and in float64; each
        step's loss and gradient, component by component, and the numbers
        of each pair; besides, what one grid tracer's build costs against
        the moved copy that each step makes.

Each prints one JSON line per seed and writes them all to
<out>/calib_<what>_<cell>.json.
"""

import json
import os
import sys
import time

from portbench import harness, scenes, views


def _write(out: str, name: str, rows: list) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, name), "w") as f:
        json.dump(rows, f, indent=1)


def counts(out: str, device) -> None:
    from portbench.reference.counts import count_frame, frame_rays, walk_bytes

    os.makedirs(os.path.join(out, "counts"), exist_ok=True)
    for name in sorted(os.listdir(os.path.join(harness.HERE, "configs"))):
        name = name[:-5]
        t0 = time.perf_counter()
        c = count_frame(scenes.load_config(name), device)
        with open(os.path.join(out, "counts", f"{name}.json"), "w") as f:
            json.dump(c, f)
        print(json.dumps({"config": name, "counts": c, "rays": frame_rays(c),
                          "walk_bytes": walk_bytes(c),
                          "seconds": time.perf_counter() - t0}), flush=True)


def program(out: str, cell: str, seeds: list, device) -> None:
    rows = []
    for seed in seeds:
        run = harness.Run(cell, seed, 2.0, False, device, time.perf_counter())
        result, checks = harness.execute(run)
        rows.append({"seed": seed, "numbers": {n: v for n, v, _ in checks},
                     "correct": result["correct"], "metrics": result["metrics"]})
        print(json.dumps(rows[-1]), flush=True)
    _write(out, f"calib_program_{cell}.json", rows)


def control(out: str, cell: str, seeds: list, device) -> None:
    import torch

    from portbench.reference import compare
    from portbench.reference.whitted import Reference

    run = harness.Run(cell, seeds[0], 0.0, False, device, time.perf_counter())
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        if run.traffic["loop"] == "train":
            from portbench.loops import train

            row = {"seed": seed}
            for name, kw in (("control", {"dtype": torch.bfloat16}),
                             ("half_batch", {"half_rows": True})):
                own = train.own_steps(run.cfg, seed, run.traffic, device, **kw)
                ref = train.follow_steps(run.cfg, seed, run.traffic, device, own)
                row[name] = compare.train_numbers(own, ref)
        else:
            plain = scenes.plain_scene(run.cfg)
            f32, bf16 = Reference(plain, device), Reference(plain, device, torch.bfloat16)
            seq = views.Views(run.cfg, seed, run.traffic["jitter_px"])
            vs = [seq.next() for _ in range(run.traffic["judged_frames"])]
            row = {"seed": seed, "control": compare.worst(
                [compare.image_numbers(bf16.image(v).float(), f32.image(v)) for v in vs])}
        row["seconds"] = time.perf_counter() - t0
        rows.append(row)
        print(json.dumps(row), flush=True)
    _write(out, f"calib_control_{cell}.json", rows)


def look(out: str, cell: str, seeds: list, device) -> None:
    import torch

    from portbench.loops import train
    from portbench.reference import compare
    from raytracer_tpu_torch.accel.bvh import BVHTracer
    from raytracer_tpu_torch.accel.grid import GridTracer, build_grid

    run = harness.Run(cell, seeds[0], 0.0, False, device, time.perf_counter())
    scene, opts = scenes.port_scene(run.cfg)
    grid = build_grid(scene.meshes.verts, scene.meshes.tris, device=device)
    dscene = scene.to(device)
    tracers = {"grid": GridTracer(dscene, grid, device),
               "bvh": BVHTracer.build(scene, device)}
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    cost = {}
    for name, make in (("build", lambda: GridTracer(dscene, grid, device)),
                       ("moved", lambda: train.moved(tracers["grid"], dscene))):
        make()
        sync()
        t0 = time.perf_counter()
        for _ in range(20):
            make()
        sync()
        cost[name + "_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    print(json.dumps({"tracer_cost": cost}), flush=True)
    rows = [{"tracer_cost": cost}]
    for seed in seeds:
        t0 = time.perf_counter()
        r = harness.Run(cell, seed, 0.0, False, device, time.perf_counter())
        dcam, target = train.target_frame(r, dscene, opts, tracers["grid"])
        runs = {name: train.Trainer(r, dscene, dcam, opts, t, target).first_steps(
            train.FIRST_STEPS) for name, t in tracers.items()}
        for name, dtype in (("ref32", torch.float32), ("ref64", torch.float64)):
            runs[name] = train.own_steps(r.cfg, seed, r.traffic, device, dtype)
        pairs = {f"{a}-{b}": compare.train_numbers(runs[a], runs[b]) for a, b in
                 (("grid", "ref32"), ("bvh", "ref32"), ("ref32", "ref64"),
                  ("grid", "bvh"), ("bvh", "ref64"), ("grid", "ref64"))}
        followed = compare.train_numbers(
            runs["grid"], train.follow_steps(r.cfg, seed, r.traffic, device, runs["grid"]))
        steps = {name: [{"loss": x["losses"][s],
                         "grad": {k: v.double().flatten().tolist()
                                  for k, v in x["grads"][s].items()}}
                        for s in range(train.FIRST_STEPS)] for name, x in runs.items()}
        change = {name: {k: v.double().flatten().tolist() for k, v in x["change"].items()}
                  for name, x in runs.items()}
        target_c, _ = train.target_tables(r.cfg, seed, r.traffic)
        rows.append({"seed": seed, "pairs": pairs, "followed": followed, "steps": steps,
                     "change": change, "target_center": target_c.tolist(),
                     "seconds": time.perf_counter() - t0})
        print(json.dumps({"seed": seed, "pairs": pairs, "followed": followed}), flush=True)
    _write(out, f"calib_look_{cell}.json", rows)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("calibrate reads the card: no CUDA card found", file=sys.stderr)
        return harness.NO_DEVICE_EXIT
    device = torch.device("cuda", 0)
    out, what = argv[0], argv[1]
    if what == "counts":
        counts(out, device)
    else:
        seeds = [int(s) for s in argv[3].split(",")]
        {"program": program, "control": control, "look": look}[what](out, argv[2], seeds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
