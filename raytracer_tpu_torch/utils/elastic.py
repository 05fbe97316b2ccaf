"""Elastic band-level recovery (counterpart of `raytracer_tpu/utils/elastic.py`):
subprocess band renders with split-retry and fault injection.

Render steps are stateless and idempotent, so recovery is re-dispatching the
failed rows from scratch in a fresh process: whatever killed a worker (a
kernel fault, a lost CUDA context, the OOM killer) dies with it. The driver

1. renders each horizontal band in its own python process, one at a time;
2. on a band failure splits the band in half and retries each piece,
   recursing down to `min_rows`;
3. after a final whole-piece retry, zero-fills and reports the pieces that
   still fail: a partial frame with a failure report beats no frame.

The default is one band of the whole frame, as `renderer.render_banded`'s:
on the card a band bounds only memory, and the split on failure makes the
pieces. (The reference sizes its bands by a TPU program-size budget.) There
is no wait before a retry: a CUDA context ends with its process.

Fault injection for tests and drills is explicit (`Faults`): the driver
forwards it to every worker's argv, and the worker acts on it before it
loads the scene or touches a device.
- `countdown_file`: decrement the integer in the file and exit 41 while it
  was > 0 ("the first K workers crash"; the workers run one at a time),
  which exercises the split and re-dispatch deterministically.
- `rows=(a, b)`: exit 42 whenever the worker's band meets image rows [a, b),
  a permanently poisoned region, which exercises the zero-fill.

Driver: `python -m raytracer_tpu_torch.cli render --resilient …` or
`render_resilient(...)` below. The driver never touches a device: it starts
workers with an explicit `--device` and assembles numpy bands. A worker that
finds no CUDA device exits with `hostload.NO_DEVICE_EXIT` (it never falls
back to the CPU), and the driver then stops instead of retrying.
"""

import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np

COUNTDOWN_EXIT, ROWS_EXIT = 41, 42


@dataclasses.dataclass(frozen=True)
class Faults:
    """Injected worker faults (tests and drills; see the module docstring)."""

    countdown_file: str = ""
    rows: tuple | None = None  # (a, b): image rows [a, b)

    def argv(self) -> list:
        out = []
        if self.countdown_file:
            out += ["--fault-countdown", os.path.abspath(self.countdown_file)]
        if self.rows is not None:
            out += ["--fault-rows", f"{self.rows[0]}-{self.rows[1]}"]
        return out


@dataclasses.dataclass
class BandReport:
    """Outcome log of one resilient render."""

    bands_ok: int = 0
    bands_failed: int = 0          # zero-filled terminal failures
    retries: int = 0               # worker launches beyond the first per piece
    failed_rows: list = dataclasses.field(default_factory=list)  # (row0, rows)
    rays: float = 0.0


# ---------------------------------------------------------------- driver ----


def _worker_cmd(config, scene_path, width, height, max_depth, tracer, ssaa,
                device, faults):
    """A band worker's argv, less the band (`--row0`, `--rows`, `--npz`)."""
    cmd = [sys.executable, "-m", "raytracer_tpu_torch.utils.elastic",
           "--width", str(width), "--height", str(height),
           "--tracer", tracer, "--ssaa", str(ssaa), "--device", str(device),
           *faults.argv()]
    if scene_path:
        cmd += ["--scene", os.path.abspath(scene_path)]
    else:
        cmd += ["--config", config]
    if max_depth is not None:
        cmd += ["--max-depth", str(max_depth)]
    return cmd


def _run_band(base_cmd, row0, rows, timeout):
    """One worker launch → (img [rows,W,3] | None, rays)."""
    from raytracer_tpu_torch.utils.hostload import (NO_DEVICE_EXIT, ROOT,
                                                    USAGE_EXIT)

    fd, path = tempfile.mkstemp(suffix=".npz", prefix="rt_band_")
    os.close(fd)
    try:
        cmd = base_cmd + ["--row0", str(row0), "--rows", str(rows),
                          "--npz", path]
        try:
            r = subprocess.run(cmd, cwd=ROOT, timeout=timeout,
                               capture_output=True, text=True)
        except subprocess.TimeoutExpired:
            sys.stderr.write(f"# band {row0}+{rows}: timeout {timeout}s\n")
            return None, 0.0
        if r.returncode in (NO_DEVICE_EXIT, USAGE_EXIT):
            # no retry can succeed: the worker cannot start at all
            raise RuntimeError(f"band worker cannot run (exit {r.returncode})"
                               f": {(r.stderr or '').strip()[-2000:]}")
        if r.returncode != 0:
            tail = (r.stderr or "").strip().splitlines()[-3:]
            sys.stderr.write(f"# band {row0}+{rows}: worker exit "
                             f"{r.returncode}" +
                             ("".join("\n#   " + ln for ln in tail)) + "\n")
            return None, 0.0
        with np.load(path) as z:
            return np.asarray(z["img"], np.float32), float(z["rays"])
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def render_resilient(config: str = "", scene_path: str = "",
                     width: int = 0, height: int = 0,
                     max_depth: int | None = None, tracer: str = "auto",
                     ssaa: int = 1, band_rows: int | None = None,
                     min_rows: int = 8, *, device, faults: Faults | None = None,
                     band_timeout: float = 1800.0):
    """Full-frame render through re-dispatchable band subprocesses on
    `device` (a name the workers pass to `torch.device`).

    Returns (img [H,W,3] f32, BandReport). Bands that succeed equal the same
    rows of `renderer.render_banded` (`render_ssaa` when ssaa > 1) bit for
    bit; failed pieces are zero-filled and listed in the report.
    `band_rows` defaults to the whole frame (see the module docstring)."""
    from raytracer_tpu_torch.utils.hostload import load_scene_cli

    if min_rows < 1:
        raise ValueError(f"min_rows must be >= 1, got {min_rows}")
    if ssaa < 1:
        raise ValueError(f"ssaa must be >= 1, got {ssaa}")
    _, _, opts = load_scene_cli(config, scene_path, width, height, max_depth)
    height, width = opts.height, opts.width
    band_rows = height if band_rows is None else band_rows
    base_cmd = _worker_cmd(config, scene_path, width, height, max_depth,
                           tracer, ssaa, device, faults or Faults())

    img = np.zeros((height, width, 3), np.float32)
    rep = BandReport()

    def do_piece(row0, rows):
        band, rays = _run_band(base_cmd, row0, rows, band_timeout)
        if band is None:
            rep.retries += 1
            if rows >= 2 * min_rows:
                half = -(-rows // 2)
                sys.stderr.write(f"# band {row0}+{rows}: splitting -> "
                                 f"{half}/{rows - half}\n")
                do_piece(row0, half)
                do_piece(row0 + half, rows - half)
                return
            band, rays = _run_band(base_cmd, row0, rows, band_timeout)
        if band is None:  # terminal size, last try failed
            rep.bands_failed += 1
            rep.failed_rows.append((row0, rows))
            sys.stderr.write(f"# band {row0}+{rows}: FAILED - zero-filled\n")
            return
        img[row0:row0 + rows] = band
        rep.bands_ok += 1
        rep.rays += rays

    for r0 in range(0, height, band_rows):
        do_piece(r0, min(band_rows, height - r0))
    return img, rep


# ---------------------------------------------------------------- worker ----


def _maybe_inject_fault(row0: int, rows: int, countdown_file: str,
                        fault_rows: str):
    """Test and drill hooks; they run before the worker touches a device."""
    if countdown_file and os.path.exists(countdown_file):
        with open(countdown_file) as f:
            k = int(f.read().strip() or 0)
        if k > 0:
            with open(countdown_file, "w") as f:
                f.write(str(k - 1))
            sys.stderr.write(f"# injected fault (countdown {k}->{k - 1})\n")
            sys.stderr.flush()
            os._exit(COUNTDOWN_EXIT)
    if fault_rows:
        a, b = (int(x) for x in fault_rows.split("-"))
        if row0 < b and row0 + rows > a:
            sys.stderr.write(f"# injected fault (rows {a}-{b})\n")
            sys.stderr.flush()
            os._exit(ROWS_EXIT)


def _worker_main(args):
    _maybe_inject_fault(args.row0, args.rows, args.fault_countdown,
                        args.fault_rows)

    from raytracer_tpu_torch.utils.hostload import (build_tracer, cli_device,
                                                    load_scene_cli)

    device = cli_device(args.device)
    from raytracer_tpu_torch.renderer import render

    scene, cam, opts = load_scene_cli(args.config, args.scene, args.width,
                                      args.height, args.max_depth)
    tracer = build_tracer(scene, args.tracer, device)
    f = args.ssaa
    if f > 1:
        # the ssaa× band: the hi-res slice of the same projection, box-
        # averaged, exactly as renderer.render_ssaa does per band
        hi = dataclasses.replace(opts, width=opts.width * f,
                                 height=opts.height * f)
        img, traced, *_ = render(scene, cam, hi, device=device,
                                 count_rays=True, tracer=tracer,
                                 row0=args.row0 * f, rows=args.rows * f)
        img = img.reshape(args.rows, f, opts.width, f, 3).mean(dim=(1, 3))
    else:
        img, traced, *_ = render(scene, cam, opts, device=device,
                                 count_rays=True, tracer=tracer,
                                 row0=args.row0, rows=args.rows)
    np.savez(args.npz, img=img.cpu().numpy(), rays=float(traced))


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="raytracer_tpu_torch.utils.elastic",
        description="band worker for resilient rendering (internal)")
    p.add_argument("--config", default="")
    p.add_argument("--scene", default="")
    p.add_argument("--row0", type=int, required=True)
    p.add_argument("--rows", type=int, required=True)
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--max-depth", type=int, default=None)
    p.add_argument("--tracer", default="auto")
    p.add_argument("--ssaa", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    p.add_argument("--npz", required=True)
    p.add_argument("--fault-countdown", default="",
                   help="drill: exit 41 while the count in this file is > 0")
    p.add_argument("--fault-rows", default="",
                   help="drill: exit 42 when the band meets rows A-B")
    _worker_main(p.parse_args(argv))


if __name__ == "__main__":
    main()
