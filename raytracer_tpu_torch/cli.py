"""CLI entry points (counterpart of `raytracer_tpu/cli.py`: `render`,
`optimize` and `export`).

  python -m raytracer_tpu_torch.cli render --config config4 --out c4.png
  python -m raytracer_tpu_torch.cli render --config config2 --tracer fused \\
      --width 1920 --height 1080 --out c2.png
  python -m raytracer_tpu_torch.cli render --config config1 --width 64 \\
      --device cpu --out c1.ppm
  python -m raytracer_tpu_torch.cli export --config config2 --out my.txt
  python -m raytracer_tpu_torch.cli render --scene my.txt --out my.png
  python -m raytracer_tpu_torch.cli optimize --steps 30 --out r.png
  python -m raytracer_tpu_torch.cli optimize --plan --steps 30 --out r.png
  python -m raytracer_tpu_torch.cli optimize --kernel --steps 30 --out r.png
  python -m raytracer_tpu_torch.cli optimize --preset mesh --steps 30 \\
      --out m.png

`--device` defaults to `cuda`; on a machine without a GPU that fails rather
than running on the CPU.
"""

import argparse
import dataclasses
import time

_CONFIGS = ["config1", "config2", "config3", "config4", "config7"]


def _save(path: str, img):
    from raytracer_tpu_torch.io.image import save_png, save_ppm

    if path.endswith(".ppm"):
        save_ppm(path, img)
    else:
        save_png(path, img)
    print("wrote", path)


def _device(name: str):
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available "
                         "(pass --device cpu to render on the CPU)")
    return dev


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_render(args):
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli

    device = _device(args.device)
    scene, cam, opts = load_scene_cli(args.config if not args.scene else "",
                                      args.scene, args.width, args.height,
                                      args.max_depth)
    if args.scene:
        args.config = args.scene
    s = args.ssaa
    if s < 1:
        raise SystemExit(f"--ssaa must be ≥ 1, got {s}")
    aa = f" ssaa={s}" if s > 1 else ""
    if args.tracer == "fused":
        from raytracer_tpu_torch.ops import fused

        if not fused.supported(scene):
            raise SystemExit("--tracer fused: the scene's mesh is not tiny "
                             f"(≤{fused.MAX_FUSED_TRIS} flat triangles without "
                             "UVs); use --tracer auto")
        hi = dataclasses.replace(opts, width=opts.width * s,
                                 height=opts.height * s) if s > 1 else opts
        t0 = time.perf_counter()
        fw = fused.FusedWhitted(scene, cam, hi, device=device)
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

    from raytracer_tpu_torch.renderer import render_banded, render_ssaa

    t0 = time.perf_counter()
    tracer = build_tracer(scene, args.tracer, device)
    if s > 1:
        img, traced = render_ssaa(scene, cam, opts, device=device, factor=s,
                                  tracer=tracer, count_rays=True)
    else:
        img, traced = render_banded(scene, cam, opts, device=device,
                                    tracer=tracer, count_rays=True)
    _sync(device)
    img = img.cpu().numpy()
    dt = time.perf_counter() - t0
    rays = float(traced)
    print(f"{args.config}: {opts.width}x{opts.height} depth={opts.max_depth}"
          f"{aa} on {device} in {dt:.2f}s (tracer and kernel builds "
          f"included) — {rays:.3g} rays, {rays / dt:.3g} rays/s")
    _save(args.out, img)


def _spheres_trainer(args, device):
    """config5: recover the two spheres' centers and albedos with Adam →
    (params {name: leaf}, step() → loss, params → final scene, report,
    camera, opts)."""
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

    return params, step, lambda p: apply_params(dinit, p), report, cam, opts


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

    return params, step, lambda p: apply_params(dinit, p), report, cam, opts


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
    """
    import json

    import torch

    from raytracer_tpu_torch.renderer import render

    if args.preset == "mesh" and (args.kernel or args.plan):
        raise SystemExit("--kernel and --plan train the spheres preset "
                         "(mesh-free, fused); --preset mesh trains through "
                         "the wavefront")
    if args.kernel and args.plan:
        raise SystemExit("--kernel and --plan are two trainers: pick one")
    device = _device(args.device)
    make = _mesh_trainer if args.preset == "mesh" else _spheres_trainer
    params, step, final, report, cam, opts = make(args, device)
    for i in range(args.steps):
        val = step()
        if i % args.log_every == 0 or i == args.steps - 1:
            print(json.dumps({"step": i, "loss": float(val)}))
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
    pr.add_argument("--tracer", default="auto",
                    choices=["auto", "none", "grid", "pallas", "mat",
                             "fused"],
                    help="mesh winner-search backend (auto = grid when the "
                         "scene has triangles; none = dense search; pallas = "
                         "brute-force kernel over all triangles "
                         "(ops/pallas_trace.py); mat = linear-expansion "
                         "sweep over all triangles (ops/mat_trace.py); "
                         "fused = the single-kernel forward for scenes "
                         "without big meshes, glass included)")
    pr.add_argument("--ssaa", type=int, default=1,
                    help="supersampling factor: trace an N× frame and "
                         "box-average N² subsamples per pixel")
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
    po.add_argument("--log-every", type=int, default=10)
    po.add_argument("--plan", action="store_true",
                    help="replay training step: the fused forward records "
                         "the plan, autograd differentiates only the "
                         "shading replay (spheres preset)")
    po.add_argument("--kernel", action="store_true",
                    help="fused training step: the forward kernel records "
                         "the plan, the train kernel returns the loss and "
                         "the analytic gradients (spheres preset)")
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
