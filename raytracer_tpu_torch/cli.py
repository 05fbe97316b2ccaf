"""CLI entry points (counterpart of `raytracer_tpu/cli.py`: `render`,
`optimize` and `export`).

  python -m raytracer_tpu_torch.cli render --config config4 --out c4.png
  python -m raytracer_tpu_torch.cli render --config config2 --tracer fused \\
      --width 1920 --height 1080 --out c2.png
  python -m raytracer_tpu_torch.cli render --config config1 --width 64 \\
      --device cpu --out c1.ppm
  python -m raytracer_tpu_torch.cli render --config config3 --compact 0.5 \\
      --out c3.png
  python -m raytracer_tpu_torch.cli render --config config4 --tracer bvh \\
      --out c4.png
  python -m raytracer_tpu_torch.cli export --config config2 --out my.txt
  python -m raytracer_tpu_torch.cli render --scene my.txt --out my.png
  python -m raytracer_tpu_torch.cli optimize --steps 30 --out r.png
  python -m raytracer_tpu_torch.cli optimize --plan --steps 30 --out r.png
  python -m raytracer_tpu_torch.cli optimize --kernel --steps 30 --out r.png
  python -m raytracer_tpu_torch.cli optimize --preset mesh --steps 30 \\
      --out m.png
  python -m raytracer_tpu_torch.cli render --config config4 \\
      --tile-block 270x480 --trace traces/ --out c4.png
  python -m raytracer_tpu_torch.cli render --config config4 --resilient \\
      --out c4.png
  python -m raytracer_tpu_torch.cli render --config config4 --cards 4 \\
      --out c4.png
  python -m raytracer_tpu_torch.cli optimize --kernel --steps 200 \\
      --checkpoint ck/ --supervise --out r.png

`--device` defaults to `cuda`; on a machine without a GPU that fails rather
than running on the CPU.
"""

import argparse
import contextlib
import dataclasses
import os
import sys
import time

_CONFIGS = ["config1", "config2", "config3", "config4", "config7"]
CARDS_TIMEOUT_S = 3600.0   # `render --cards`: the ranks' whole run


def _save(path: str, img):
    from raytracer_tpu_torch.io.image import save_png, save_ppm

    if path.endswith(".ppm"):
        save_ppm(path, img)
    else:
        save_png(path, img)
    print("wrote", path)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tile_block(text: str):
    """"BHxBW" → (bh, bw)."""
    try:
        bh, bw = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"want BHxBW, got {text!r}") from None
    if bh < 1 or bw < 1:
        raise argparse.ArgumentTypeError(f"want positive sizes, got {text!r}")
    return bh, bw


def _row_span(text: str):
    """"A-B" → (a, b): image rows [a, b)."""
    try:
        a, b = (int(x) for x in text.split("-"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"want A-B, got {text!r}") from None
    return a, b


def _render_resilient(args, kind: str):
    """`render --resilient`: the frame through band worker processes
    (utils/elastic.py); this process touches no device."""
    from raytracer_tpu_torch.utils.elastic import Faults, render_resilient

    if args.trace:
        raise SystemExit("--resilient does not support --trace "
                         "(workers are separate processes)")
    if kind == "fused":
        raise SystemExit("--resilient does not support --tracer fused "
                         "(the fused megakernel replaces the banded "
                         "renderer the workers run)")
    t0 = time.perf_counter()
    img, rep = render_resilient(
        config=args.config if not args.scene else "", scene_path=args.scene,
        width=args.width, height=args.height, max_depth=args.max_depth,
        tracer=kind, ssaa=args.ssaa, min_rows=args.min_rows,
        device=args.device,
        faults=Faults(countdown_file=args.fault_countdown,
                      rows=args.fault_rows))
    dt = time.perf_counter() - t0
    name = args.scene or args.config
    aa = f" ssaa={args.ssaa}" if args.ssaa > 1 else ""
    print(f"{name}: {img.shape[1]}x{img.shape[0]}{aa} resilient on "
          f"{args.device} in {dt:.2f}s — {rep.bands_ok} bands ok, "
          f"{rep.bands_failed} failed, {rep.retries} retries, "
          f"{rep.rays:.3g} rays")
    if rep.failed_rows:
        print("zero-filled rows:", rep.failed_rows)
    _save(args.out, img)


def _render_cards(args, kind: str):
    """`render --cards N`: the frame split over N ranks of this host
    (parallel/frames.py), one process a card, rank 0 writing the image;
    this process only launches them."""
    from raytracer_tpu_torch.parallel.frames import spawn_ranks
    from raytracer_tpu_torch.utils.hostload import (NO_DEVICE_EXIT,
                                                    load_scene_cli)

    n = args.cards
    refused = [flag for flag, on in (
        ("--resilient", args.resilient), ("--trace", args.trace),
        ("--ssaa", args.ssaa > 1), ("--compact", args.compact),
        ("--tile-block", args.tile_block)) if on]
    if refused:
        raise SystemExit(f"--cards {n} does not support {', '.join(refused)}")
    if kind not in ("auto", "grid", "grid-pallas"):
        raise SystemExit(f"--cards {n} searches the mesh with the grid "
                         f"replicated on every card; --tracer {kind} is not "
                         "supported (use --tracer grid or auto)")
    import torch

    device_type = torch.device(args.device).type
    if device_type not in ("cuda", "cpu") or torch.device(args.device).index:
        raise SystemExit(f"--cards {n} takes --device cuda (cuda:0 … "
                         f"cuda:{n - 1}) or cpu, not {args.device}")
    if device_type == "cuda" and torch.cuda.device_count() < n:
        print(f"--cards {n}: {torch.cuda.device_count()} CUDA card(s) here",
              file=sys.stderr, flush=True)
        raise SystemExit(NO_DEVICE_EXIT)
    scene, _, _ = load_scene_cli(args.config if not args.scene else "",
                                 args.scene)
    if not scene.meshes.count:
        raise SystemExit(f"--cards {n} splits a mesh scene; "
                         f"{args.scene or args.config} has no mesh")
    spec = {k: getattr(args, k) for k in ("config", "width", "height",
                                          "max_depth")}
    # the ranks may resolve paths elsewhere than the directory typed in
    spec["out"] = os.path.abspath(args.out)
    spec["scene"] = os.path.abspath(args.scene) if args.scene else ""
    t0 = time.perf_counter()
    with spawn_ranks(n, _cards_rank, [spec],
                     device_type=device_type) as ranks:
        code = ranks.wait(CARDS_TIMEOUT_S)
    if code:
        print(f"--cards {n}: a rank failed (exit {code}); the others were "
              "stopped", file=sys.stderr, flush=True)
        raise SystemExit(code)
    print(f"--cards {n}: {time.perf_counter() - t0:.2f}s with the ranks' "
          "start")


def _cards_rank(device, spec: dict):
    """One rank of `render --cards N` (a `spawn_ranks` target): its block of
    the frame; rank 0 also writes the gathered image."""
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel.frames import ShardedFrames
    from raytracer_tpu_torch.utils.hostload import load_scene_cli

    scene, cam, opts = load_scene_cli(
        spec["config"] if not spec["scene"] else "", spec["scene"],
        spec["width"], spec["height"], spec["max_depth"])
    t0 = time.perf_counter()
    frames = ShardedFrames(scene, opts, device=device)
    if dist.get_rank():
        frames.serve()
        return
    img = frames.frame(cam)
    _sync(device)
    dt = time.perf_counter() - t0
    frames.stop()
    n = dist.get_world_size()
    print(f"{spec['scene'] or spec['config']}: {opts.width}x{opts.height} "
          f"depth={opts.max_depth} on {n} ranks ({device.type}, a block of "
          f"rows each) in {dt:.2f}s (tracer and kernel builds included)",
          flush=True)
    _save(spec["out"], img.cpu().numpy())


def cmd_render(args):
    from raytracer_tpu_torch.utils.hostload import (build_tracer, cli_device,
                                                    load_scene_cli)

    s = args.ssaa
    if s < 1:
        raise SystemExit(f"--ssaa must be ≥ 1, got {s}")
    if (args.fault_countdown or args.fault_rows) and not args.resilient:
        raise SystemExit("--fault-countdown and --fault-rows drill the band "
                         "workers of --resilient")
    kind = "grid" if args.grid else args.tracer
    if args.cards < 1:
        raise SystemExit(f"--cards must be ≥ 1, got {args.cards}")
    if args.cards > 1:
        return _render_cards(args, kind)
    if args.resilient:
        return _render_resilient(args, kind)
    device = cli_device(args.device)
    scene, cam, opts = load_scene_cli(args.config if not args.scene else "",
                                      args.scene, args.width, args.height,
                                      args.max_depth)
    if args.tile_block:
        bh, bw = args.tile_block
        opts = dataclasses.replace(opts, tile_rays=bh * bw,
                                   tile_block=(bh, bw))
    if args.scene:
        args.config = args.scene
    aa = f" ssaa={s}" if s > 1 else ""

    @contextlib.contextmanager
    def traced():
        """The render's context: a profiler trace with --trace."""
        if not args.trace:
            yield
            return
        from raytracer_tpu_torch.utils.profiling import xprof_trace

        with xprof_trace(args.trace, device=device):
            yield
        print(f"device trace written to {args.trace} (*.pt.trace.json: open "
              "in https://ui.perfetto.dev or chrome://tracing)")

    if kind == "fused":
        from raytracer_tpu_torch.ops import fused

        if not fused.supported(scene):
            raise SystemExit("--tracer fused: the scene's mesh is not tiny "
                             f"(≤{fused.MAX_FUSED_TRIS} flat triangles without "
                             "UVs); use --tracer auto")
        hi = dataclasses.replace(opts, width=opts.width * s,
                                 height=opts.height * s) if s > 1 else opts
        t0 = time.perf_counter()
        fw = fused.FusedWhitted(scene, cam, hi, device=device)
        with traced():
            img = fw.render()
            if s > 1:
                img = img.reshape(opts.height, s, opts.width, s, 3).mean(
                    dim=(1, 3))
            _sync(device)
        img = img.cpu().numpy()
        dt = time.perf_counter() - t0
        print(f"{args.config}: {opts.width}x{opts.height} "
              f"depth={opts.max_depth}{aa} on {device} in {dt:.2f}s (fused "
              f"kernel, with compile)")
        _save(args.out, img)
        return

    from raytracer_tpu_torch.renderer import (render_banded, render_ssaa,
                                              use_compact)

    if args.compact:
        opts = dataclasses.replace(opts, compact_cap=args.compact)
    t0 = time.perf_counter()
    tracer = build_tracer(scene, kind, device)
    with traced():
        if s > 1:
            img, rays, *dropped = render_ssaa(
                scene, cam, opts, device=device, factor=s, tracer=tracer,
                count_rays=True)
        else:
            img, rays, *dropped = render_banded(
                scene, cam, opts, device=device, tracer=tracer,
                count_rays=True)
        _sync(device)
    img = img.cpu().numpy()
    dt = time.perf_counter() - t0
    rays = float(rays)
    if use_compact(scene, opts) and float(dropped[0]) > 0:
        print(f"WARNING: compaction dropped {float(dropped[0]):.0f} alive "
              "lanes — image is missing radiance; raise --compact")
    print(f"{args.config}: {opts.width}x{opts.height} depth={opts.max_depth}"
          f"{aa} on {device} in {dt:.2f}s (tracer and kernel builds "
          f"included) — {rays:.3g} rays, {rays / dt:.3g} rays/s")
    _save(args.out, img)


def _spheres_trainer(args, device):
    """config5: recover the two spheres' centers and albedos with Adam →
    (params {name: leaf}, step() → loss, params → final scene, report,
    camera, opts, {name: the stateful objects a checkpoint saves})."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.models import presets
    from raytracer_tpu_torch.ops.safemath import clip
    from raytracer_tpu_torch.renderer import (as_leaf, render,
                                              value_and_grad_banded)

    init, target, cam, opts = presets.config5_inverse()
    timg, _ = render(target, cam, opts, device=device)
    dinit = init.to(device)
    params = {"center": as_leaf(init.spheres.center, device),
              "albedo": as_leaf(init.materials.albedo, device)}
    opt = torch.optim.Adam(list(params.values()),
                           lr=args.lr if args.lr is not None else 1e-2)

    def apply_params(scene, p):
        # clip with jnp.clip's gradient at the bounds (ops/safemath.py)
        return scene.replace(
            spheres=dataclasses.replace(scene.spheres, center=p["center"]),
            materials=dataclasses.replace(
                scene.materials, albedo=clip(p["albedo"], 0.0, 1.0)))

    if args.kernel:
        # the param-mode forward records the live plan, the train kernel
        # returns the loss and the analytic gradients with respect to the
        # bound values, applied to the raw parameters (as the reference
        # applies them)
        from raytracer_tpu_torch.ops import fused

        fw = fused.FusedWhitted(init, cam, opts, device=device,
                                param_inputs=True)
        n3 = opts.width * opts.height * 3
        ns = init.spheres.count
        nm = np.asarray(init.materials.albedo).shape[0]

        def grads(p):
            with torch.no_grad():
                fw.bind(center=p["center"], albedo=p["albedo"].clamp(0.0, 1.0))
            lsum, g, _ = fw.plan_value_and_grad(timg)
            return lsum / n3, {"center": g["sph"][:ns, 0:3] / n3,
                               "albedo": g["mat"][:nm, 0:3] / n3}
    elif args.plan:
        # K1's full plan (render_plan) per band, then autograd over the
        # shading replay of that plan, 4 gradient bands as the reference
        from raytracer_tpu_torch.ops import fused
        from raytracer_tpu_torch.ops.replay import value_and_grad_replay

        fw = fused.FusedWhitted(init, cam, opts, device=device,
                                param_inputs=True)

        def builder(p):
            return fw.bind(center=p["center"],
                           albedo=p["albedo"].detach().clamp(0.0, 1.0))

        def grads(p):
            return value_and_grad_replay(
                apply_params, p, dinit, cam, opts, timg, builder,
                band_rows=max(64, opts.height // 4), device=device)
    else:
        # torch autograd over the wavefront render (searches under no_grad)
        def grads(p):
            return value_and_grad_banded(apply_params, p, dinit, cam, opts,
                                         timg, device=device)

    def step():
        val, g = grads(params)
        for k, v in params.items():
            v.grad = g[k]
        opt.step()
        return val

    def report(p):
        c = p["center"].detach().cpu().numpy()
        a = p["albedo"].detach().clamp(0.0, 1.0).cpu().numpy()
        print("recovered centers:\n", c)
        print("recovered albedos:\n", a)

    return (params, step, lambda p: apply_params(dinit, p), report, cam, opts,
            {"optimizer": opt})


def _mesh_trainer(args, device):
    """config6: recover the blob's vertices as displacements along the
    init's radial directions, the smooth normals re-derived from the moving
    vertices every step (`vertex_normals_torch`); Adam with the reference's
    decayed step lr·0.5^(step/80). Returns what `_spheres_trainer` does."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.io.meshgen import (vertex_normals,
                                                vertex_normals_torch)
    from raytracer_tpu_torch.models import presets
    from raytracer_tpu_torch.renderer import (as_leaf, render,
                                              value_and_grad_banded)

    init, target, cam, opts = presets.config6_inverse_mesh()
    timg, _ = render(target, cam, opts, device=device)
    dinit = init.to(device)
    iverts = dinit.meshes.verts
    rdirs = iverts - iverts.mean(dim=0)
    rdirs = rdirs / torch.linalg.vector_norm(rdirs, dim=1, keepdim=True)
    tris = dinit.meshes.tris
    params = {"disp": as_leaf(np.zeros((iverts.shape[0],), np.float32),
                              device)}
    # the pixel loss is noisy in geometry (winner ids flip as vertices
    # move): a decayed step settles where a constant one oscillates
    opt = torch.optim.Adam(list(params.values()),
                           lr=args.lr if args.lr is not None else 2e-3)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda i: 0.5 ** (i / 80))

    def apply_params(scene, p):
        v = iverts + p["disp"][:, None] * rdirs
        return scene.replace(meshes=dataclasses.replace(
            scene.meshes, verts=v, normals=vertex_normals_torch(v, tris)))

    def step():
        val, g = value_and_grad_banded(apply_params, params, dinit, cam, opts,
                                       timg, device=device)
        params["disp"].grad = g["disp"]
        opt.step()
        sched.step()
        return val

    def report(p):
        tv = np.asarray(target.meshes.verts)
        tr = np.asarray(init.meshes.tris)
        for tag, disp in (("init", torch.zeros_like(p["disp"])),
                          ("recovered", p["disp"].detach())):
            with torch.no_grad():
                v = apply_params(dinit, {"disp": disp}).meshes.verts
            v = v.cpu().numpy()
            n = vertex_normals(v, tr)
            vis = (n * (np.asarray(cam.pos)[None] - v)).sum(1) > 0
            err = np.abs(v - tv)
            print(f"{tag}: vertex L1 visible {err[vis].mean():.5f} "
                  f"hidden {err[~vis].mean():.5f}")

    # the schedule's step count is the decay's: a checkpoint keeps it
    return (params, step, lambda p: apply_params(dinit, p), report, cam, opts,
            {"optimizer": opt, "scheduler": sched})


def _supervise_argv(args) -> list:
    """The supervised child's command: this optimize run without
    `--supervise`, every trainer flag forwarded."""
    cmd = [sys.executable, "-m", "raytracer_tpu_torch.cli", "optimize",
           "--preset", args.preset, "--steps", str(args.steps),
           "--out", os.path.abspath(args.out),
           "--checkpoint", os.path.abspath(args.checkpoint),
           "--ckpt-every", str(args.ckpt_every),
           "--log-every", str(args.log_every), "--device", args.device]
    if args.lr is not None:
        cmd += ["--lr", repr(args.lr)]
    if args.plan:
        cmd += ["--plan"]
    if args.kernel:
        cmd += ["--kernel"]
    if args.fault_after_steps:
        cmd += ["--fault-after-steps", str(args.fault_after_steps)]
    return cmd


def _supervise_optimize(args):
    """Auto-restart supervisor: run the checkpointed optimize loop as a
    child process, re-launched with --resume after every crash, until it
    completes or --max-restarts is spent. Resume is exact (the checkpoint
    holds the parameters and the optimizer's and schedule's state), so a
    supervised run that crashed ends where an uncrashed one does. A child
    that cannot start (no CUDA device, bad arguments) is not restarted.
    There is no wait before a restart: a CUDA context ends with its
    process."""
    import subprocess

    from raytracer_tpu_torch.utils.hostload import (NO_DEVICE_EXIT, ROOT,
                                                    USAGE_EXIT)

    if not args.checkpoint:
        raise SystemExit("--supervise requires --checkpoint")
    base = _supervise_argv(args)
    for attempt in range(args.max_restarts + 1):
        cmd = base + (["--resume"] if (attempt or args.resume) else [])
        r = subprocess.run(cmd, cwd=ROOT)
        if r.returncode == 0:
            if attempt:
                print(f"# supervised optimize finished after {attempt} "
                      f"restart(s)", file=sys.stderr)
            return
        if r.returncode in (NO_DEVICE_EXIT, USAGE_EXIT):
            raise SystemExit(f"supervised optimize: the child cannot run "
                             f"(exit {r.returncode}); not restarting")
        if attempt == args.max_restarts:
            break
        print(f"# optimize child exit {r.returncode}; restarting with "
              f"--resume ({attempt + 1}/{args.max_restarts})",
              file=sys.stderr, flush=True)
    raise SystemExit("supervised optimize: restart budget exhausted")


def cmd_optimize(args):
    """Inverse rendering with Adam; one {"step", "loss"} JSON line per
    logged step, then the recovered image and parameters.

    - spheres (config5, centers + albedos), without a flag: torch autograd
      over the wavefront render (`renderer.value_and_grad_banded`);
    - `--plan`: K1's full plan per band, autograd over its shading replay
      (`ops/replay.value_and_grad_replay`);
    - `--kernel`: K1's live plan and the fused train kernel K2
      (`FusedWhitted.plan_value_and_grad`), no autograd;
    - `--preset mesh` (config6): vertex displacements through the wavefront
      with differentiable smooth normals.

    `--checkpoint DIR` saves the run every `--ckpt-every` steps and at the
    last (utils/checkpoint.py) and `--resume` continues from the newest
    checkpoint there. `--supervise` runs the loop as a child process that
    is restarted with `--resume` after a crash; `--fault-after-steps N`
    makes each process exit with code 43 after N steps (a drill).
    """
    import json

    import torch

    from raytracer_tpu_torch.renderer import render
    from raytracer_tpu_torch.utils import checkpoint
    from raytracer_tpu_torch.utils.hostload import cli_device

    if args.preset == "mesh" and (args.kernel or args.plan):
        raise SystemExit("--kernel and --plan train the spheres preset "
                         "(mesh-free, fused); --preset mesh trains through "
                         "the wavefront")
    if args.kernel and args.plan:
        raise SystemExit("--kernel and --plan are two trainers: pick one")
    if args.ckpt_every < 1:
        raise SystemExit(f"--ckpt-every must be ≥ 1, got {args.ckpt_every}")
    if args.supervise:
        return _supervise_optimize(args)
    device = cli_device(args.device)
    make = _mesh_trainer if args.preset == "mesh" else _spheres_trainer
    params, step, final, report, cam, opts, states = make(args, device)
    start = 0
    if args.checkpoint and args.resume:
        found = checkpoint.latest(args.checkpoint)
        if found is not None:
            last = checkpoint.restore(found[1], params, states, device)
            start = last + 1
            print(f"resumed from step {last} at "
                  f"{os.path.abspath(args.checkpoint)}")
    for done, i in enumerate(range(start, args.steps)):
        if args.fault_after_steps and done >= args.fault_after_steps:
            print(f"# injected fault after {done} steps (process step {i})",
                  file=sys.stderr, flush=True)
            sys.stdout.flush()  # os._exit drops buffered output
            os._exit(43)
        val = step()
        if i % args.log_every == 0 or i == args.steps - 1:
            print(json.dumps({"step": i, "loss": float(val)}))
        if args.checkpoint and (i % args.ckpt_every == 0
                                or i == args.steps - 1):
            checkpoint.save(args.checkpoint, i, params, states)
    with torch.no_grad():
        img, _ = render(final(params), cam, opts, device=device)
    _sync(device)
    report(params)
    _save(args.out, img.cpu().numpy())


def cmd_export(args):
    """Dump a preset as an editable scene text file (render --scene reads it)."""
    from raytracer_tpu_torch.io.scenefile import save_scene
    from raytracer_tpu_torch.models import presets

    scene, cam, opts = presets.PRESETS[args.config]()
    save_scene(args.out, scene, cam, opts)
    print("wrote", args.out)


def main(argv=None):
    p = argparse.ArgumentParser(prog="raytracer_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render")
    pr.add_argument("--config", default="config2", choices=_CONFIGS)
    pr.add_argument("--scene", default="",
                    help="render a scene text file instead of a preset "
                         "(format: docs/SPEC.md / io/scenefile.py)")
    pr.add_argument("--out", default="out.png")
    pr.add_argument("--width", type=int, default=0)
    pr.add_argument("--height", type=int, default=0)
    pr.add_argument("--max-depth", type=int, default=None)
    pr.add_argument("--grid", action="store_true",
                    help="(deprecated) alias for --tracer grid")
    pr.add_argument("--tracer", default="auto",
                    choices=["auto", "none", "grid", "bvh", "pallas",
                             "grid-pallas", "mat", "fused"],
                    help="mesh winner-search backend (auto = grid when the "
                         "scene has triangles; none = dense search; grid = "
                         "the uniform grid's walk kernel (grid-pallas: the "
                         "same); bvh = "
                         "threaded BVH walk (accel/bvh.py); pallas = "
                         "brute-force kernel over all triangles "
                         "(ops/pallas_trace.py); mat = linear-expansion "
                         "sweep over all triangles (ops/mat_trace.py); "
                         "fused = the single-kernel forward for scenes "
                         "without big meshes, glass included)")
    pr.add_argument("--compact", type=float, default=0,
                    help="wavefront lane compaction cap: keep at most N × "
                         "the tile's primary lanes per bounce instead of "
                         "doubling glass buffers (0 = off); warns if any "
                         "alive lane is dropped")
    pr.add_argument("--ssaa", type=int, default=1,
                    help="supersampling factor: trace an N× frame and "
                         "box-average N² subsamples per pixel")
    pr.add_argument("--trace", default="",
                    help="write a torch.profiler trace of the render to "
                         "this dir (*.pt.trace.json; Perfetto or "
                         "chrome://tracing)")
    pr.add_argument("--tile-block", default=None, type=_tile_block,
                    help="scan tiles as BHxBW screen blocks (sets tile_rays"
                         "=BH*BW); bit-identical images")
    pr.add_argument("--resilient", action="store_true",
                    help="elastic mode: render bands in re-dispatchable "
                         "worker processes with split-retry "
                         "(utils/elastic.py)")
    pr.add_argument("--min-rows", type=int, default=8,
                    help="resilient mode: smallest band split before a "
                         "piece is declared failed and zero-filled")
    pr.add_argument("--fault-countdown", default="",
                    help="resilient drill: band workers exit 41 while the "
                         "count in this file is > 0 (each decrements it)")
    pr.add_argument("--fault-rows", default=None, type=_row_span,
                    help="resilient drill: band workers that meet image "
                         "rows A-B exit 42")
    pr.add_argument("--cards", type=int, default=1,
                    help="split the frame over N cards of this host, one "
                         "process each (cuda:0 … cuda:N-1; N gloo ranks "
                         "with --device cpu): a block of rows a card, the "
                         "mesh searched by the grid on every card, the "
                         "image gathered and written by rank 0 "
                         "(parallel/frames.py)")
    pr.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    pr.set_defaults(fn=cmd_render)

    po = sub.add_parser("optimize")
    po.add_argument("--preset", default="spheres",
                    choices=["spheres", "mesh"],
                    help="spheres = config5 (centers + albedos); mesh = "
                         "config6 (vertex displacements)")
    po.add_argument("--steps", type=int, default=200)
    po.add_argument("--lr", type=float, default=None,
                    help="Adam learning rate (default 1e-2; mesh 2e-3, "
                         "halved every 80 steps)")
    po.add_argument("--out", default="recovered.png")
    po.add_argument("--checkpoint", default="",
                    help="checkpoint dir (enables saving)")
    po.add_argument("--resume", action="store_true",
                    help="resume from the newest checkpoint")
    po.add_argument("--ckpt-every", type=int, default=25)
    po.add_argument("--log-every", type=int, default=10)
    po.add_argument("--plan", action="store_true",
                    help="replay training step: the fused forward records "
                         "the plan, autograd differentiates only the "
                         "shading replay (spheres preset)")
    po.add_argument("--kernel", action="store_true",
                    help="fused training step: the forward kernel records "
                         "the plan, the train kernel returns the loss and "
                         "the analytic gradients (spheres preset)")
    po.add_argument("--supervise", action="store_true",
                    help="elastic mode: run the loop as a child process and "
                         "restart it with --resume after crashes (requires "
                         "--checkpoint)")
    po.add_argument("--max-restarts", type=int, default=20)
    po.add_argument("--fault-after-steps", type=int, default=0,
                    help="drill: each process exits with code 43 after N "
                         "steps")
    po.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    po.set_defaults(fn=cmd_optimize)

    pe = sub.add_parser("export")
    pe.add_argument("--config", default="config2", choices=_CONFIGS)
    pe.add_argument("--out", default="scene.txt")
    pe.set_defaults(fn=cmd_export)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
