"""CLI entry points (counterpart of `raytracer_tpu/cli.py`: `render` and
`export`).

  python -m raytracer_tpu_torch.cli render --config config4 --out c4.png
  python -m raytracer_tpu_torch.cli render --config config2 --tracer fused \\
      --width 1920 --height 1080 --out c2.png
  python -m raytracer_tpu_torch.cli render --config config1 --width 64 \\
      --device cpu --out c1.ppm
  python -m raytracer_tpu_torch.cli export --config config2 --out my.txt
  python -m raytracer_tpu_torch.cli render --scene my.txt --out my.png

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
                    choices=["auto", "none", "grid", "fused"],
                    help="mesh winner-search backend (auto = grid when the "
                         "scene has triangles; none = dense search; fused = "
                         "the single-kernel forward for scenes without big "
                         "meshes, glass included)")
    pr.add_argument("--ssaa", type=int, default=1,
                    help="supersampling factor: trace an N× frame and "
                         "box-average N² subsamples per pixel")
    pr.add_argument("--device", default="cuda",
                    help="torch device to render on (default cuda)")
    pr.set_defaults(fn=cmd_render)

    pe = sub.add_parser("export")
    pe.add_argument("--config", default="config2", choices=_CONFIGS)
    pe.add_argument("--out", default="scene.txt")
    pe.set_defaults(fn=cmd_export)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
