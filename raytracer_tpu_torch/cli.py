"""CLI entry points (counterpart of `raytracer_tpu/cli.py`: `render`,
`optimize --kernel` and `export`).

  python -m raytracer_tpu_torch.cli render --config config4 --out c4.png
  python -m raytracer_tpu_torch.cli render --config config2 --tracer fused \\
      --width 1920 --height 1080 --out c2.png
  python -m raytracer_tpu_torch.cli render --config config1 --width 64 \\
      --device cpu --out c1.ppm
  python -m raytracer_tpu_torch.cli export --config config2 --out my.txt
  python -m raytracer_tpu_torch.cli render --scene my.txt --out my.png
  python -m raytracer_tpu_torch.cli optimize --kernel --steps 30 --out r.png

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


def cmd_optimize(args):
    """Inverse rendering (config5): recover the two spheres' centers and
    albedos from a target image, one fused training step per iteration —
    bind the parameters, render the plan, and take the loss and gradients
    from the train kernel (`FusedWhitted.plan_value_and_grad`) — with Adam.
    Prints one {"step", "loss"} JSON line per logged step."""
    import json

    import numpy as np
    import torch

    from raytracer_tpu_torch.models import presets
    from raytracer_tpu_torch.ops import fused
    from raytracer_tpu_torch.renderer import render

    if args.preset == "mesh":
        raise SystemExit("optimize --preset mesh: mesh training (ROADMAP "
                         "item 10) is not ported yet")
    if not args.kernel:
        raise SystemExit("optimize without --kernel: the wavefront autograd "
                         "trainer (ROADMAP item 5) is not ported yet; pass "
                         "--kernel for the fused train kernel")
    device = _device(args.device)
    init, target, cam, opts = presets.config5_inverse()
    timg, _ = render(target, cam, opts, device=device)
    fw = fused.FusedWhitted(init, cam, opts, device=device,
                            param_inputs=True)
    n3 = opts.width * opts.height * 3
    ns = init.spheres.count
    nm = np.asarray(init.materials.albedo).shape[0]
    leaf = lambda a: torch.tensor(np.asarray(a, np.float32), device=device,
                                  requires_grad=True)
    center, albedo = leaf(init.spheres.center), leaf(init.materials.albedo)
    opt = torch.optim.Adam([center, albedo],
                           lr=args.lr if args.lr is not None else 1e-2)
    for i in range(args.steps):
        with torch.no_grad():
            fw.bind(center=center, albedo=albedo.clamp(0.0, 1.0))
        lsum, g, _ = fw.plan_value_and_grad(timg)
        # the gradients with respect to the bound values, applied to the
        # raw parameters (as the reference applies them)
        center.grad = g["sph"][:ns, 0:3] / n3
        albedo.grad = g["mat"][:nm, 0:3] / n3
        opt.step()
        if i % args.log_every == 0 or i == args.steps - 1:
            print(json.dumps({"step": i, "loss": float(lsum / n3)}))
    c = center.detach().cpu().numpy()
    a = albedo.detach().clamp(0.0, 1.0).cpu().numpy()
    final = init.replace(
        spheres=dataclasses.replace(init.spheres, center=c),
        materials=dataclasses.replace(init.materials, albedo=a))
    img, _ = render(final, cam, opts, device=device)
    _sync(device)
    print("recovered centers:\n", c)
    print("recovered albedos:\n", a)
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
                         "config6 (not ported yet)")
    po.add_argument("--steps", type=int, default=200)
    po.add_argument("--lr", type=float, default=None,
                    help="Adam learning rate (default 1e-2)")
    po.add_argument("--out", default="recovered.png")
    po.add_argument("--log-every", type=int, default=10)
    po.add_argument("--kernel", action="store_true",
                    help="fused training step: the forward kernel records "
                         "the plan, the train kernel returns the loss and "
                         "the analytic gradients (the only trainer ported)")
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
