"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from raytracer_tpu_torch/csrc (one nvcc per source,
in parallel) and prints their ptxas register/spill report. Then, per kernel:

- grid walk (K5): kernel vs plain version on config4's rays at 1920×1080,
  the config4 and config7 goldens on the card, and the main path
  (load_scene_cli → build_tracer("auto") → render_banded) on config4 at
  1920×1080, depth 4, checking that the walk kernel carried it;
- fused Whitted forward (K1): kernel vs plain version (image and plan
  planes) on config2 1920×1080 d2, config3 1024² d4 (glass, 31 nodes) and
  config5 128² in param mode after a bind; the config1/config2/config3
  goldens through the fused path; the main path `cli render --tracer fused`
  on config2 1080p d2 and config3 1024² d4, checking that the fused kernel
  carried it; kernel, plain and wavefront times on those two frames.

A JSON line lists each kernel's launches on its main path, error, times and
bound (the least time the card could take: operations over 67 TFLOP/s fp32
or bytes over 3.35 TB/s, whichever is larger). Any failure raises; the last
line is `{"ok": true, "device": {...}}` only on success. Exits non-zero
without a result when no CUDA device is available.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
OUT = os.path.join(ROOT, "smoke_out")  # images the main path writes
T_RTOL = 2e-6        # hit distances: FMA-contraction noise only
ID_MAX_DIFF = 0.005  # winner ids may differ on knife edges only
IMG_TOL, IMG_BAD = 0.004, 0.004  # goldens: ±1/255 class, ≤0.4% bad pixels
# glass goldens through the fused path: four fresnel factors grow association
# noise (the reference's own fused tolerance, tests/test_fused.py)
GLASS_TOL, GLASS_BAD, GLASS_MEAN = 0.01, 0.004, 1e-3
PX_TOL, PX_BAD = 1.0 / 255.0, 0.001  # fused kernel vs plain: ≤0.1% off >1/255
PEAK_OPS = 67e12     # H100 SXM fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s

# fp32 operations of the fused kernel per piece, counted from
# csrc/fused_whitted.cu (add, sub, mul, div, min, max, sqrt, rsqrt, floor,
# abs: 1 each; powf: 3; comparisons and selects: 0):
#   sphere/plane/tri: one intersection test; pixel: raygen + final clamp;
#   node: hit point, winner attributes (counted as a sphere's normal),
#   din, shadow origin, Phong combine, fresnel;
#   light: per-light shading less its shadow sweep; leaf: w·bg;
#   reflect/refract: a child ray plus folding its radiance into the parent.
K1_OPS = {"sphere": 33, "plane": 14, "tri": 46, "pixel": 39, "node": 73,
          "light": 55, "leaf": 6, "reflect": 35, "refract": 56}
# grid walk: Möller–Trumbore per tested candidate; DDA step per cell visit
K5_OPS = {"candidate": 46, "visit": 3}
# walk bytes per ray: orig, dir, cell, tmax, step, tdelta (12 each), active
# (1), best_t/best_i in (8), t/idx out (8); occlusion adds max_t (4)
K5_RAY_BYTES, K5_OCCL_BYTES = 89, 4


def _phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn()` over `reps` runs (after a warm-up)."""
    import torch

    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float):
    """The least time the card could take → (ms, "operations" | "bytes")."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare_walks(name, ref, got, max_t=None):
    """Hold a kernel walk to its plain version; → max |Δt| on hits."""
    import torch

    (t0, i0), (t1, i1) = ref, got
    fin0, fin1 = torch.isfinite(t0), torch.isfinite(t1)
    n_flip = int((fin0 != fin1).sum())
    both = fin0 & fin1
    dt = (t1[both] - t0[both]).abs()
    rel = float((dt / t0[both].abs().clamp(min=1e-30)).max()) if dt.numel() else 0.0
    id_diff = float((i0 != i1).float().mean())
    msg = (f"{name}: {t0.shape[0]} rays, {int(fin0.sum())} hits, "
           f"hit/miss flips {n_flip}, max rel dt {rel:.3g}, "
           f"id diff {id_diff:.5f}")
    if max_t is not None:
        occ_diff = int(((t0 < max_t) != (t1 < max_t)).sum())
        msg += f", occlusion diffs {occ_diff}"
        assert occ_diff == 0, msg
    print(msg, flush=True)
    assert n_flip == 0, msg
    assert rel <= T_RTOL, msg
    assert id_diff <= ID_MAX_DIFF, msg
    return float(dt.max()) if dt.numel() else 0.0


def walk_ray_sets(scene, cam, opts, tracer, device):
    """config4's rays at the main path's size: the 1080p primaries in pixel
    order, their mirror reflections (bounce 1), and the shadow rays of their
    diffuse hits toward each light."""
    import torch

    from raytracer_tpu_torch.core.types import DIFFUSE_AND_GLOSSY, REFLECTION
    from raytracer_tpu_torch.ops import geometry as geom
    from raytracer_tpu_torch.ops.safemath import dot, normalize, safe_sqrt
    from raytracer_tpu_torch.ops.trace import surface_at

    dscene, dcam = scene.to(device), cam.to(device)
    dirs = geom.raygen(dcam.c2w, dcam.fov_deg, opts.width, opts.height)
    orig = dcam.pos[None, :].expand_as(dirs).contiguous()
    with torch.no_grad():
        hit = tracer.nearest(orig, dirs, opts.t_min, opts.tri_chunk)
        surf = surface_at(dscene, orig, dirs, hit, opts.t_min)
    sets = [("primary", orig, dirs, None, None)]
    mirror = surf.valid & (surf.mtype == REFLECTION)
    rdir = normalize(geom.reflect(dirs, surf.n))
    rorig = geom.spawn_origin(surf.p, surf.n, rdir, opts.bias)
    sets.append(("reflection", rorig, rdir, None, mirror))
    diff = surf.valid & (surf.mtype == DIFFUSE_AND_GLOSSY)
    front = (dot(dirs, surf.n) < 0).to(torch.float32)
    sorig = surf.p + (2.0 * front - 1.0)[:, None] * opts.bias * surf.n
    for li in range(scene.lights.count):
        lvec = dscene.lights.pos[li][None, :] - surf.p
        d2 = dot(lvec, lvec)
        dist = safe_sqrt(d2, valid=d2 > 0)
        ldir = lvec / dist.clamp(min=1e-12)[:, None]
        lit = dot(ldir, surf.n) > 0
        sets.append((f"shadow{li}", sorig, ldir, dist, diff & lit))
    return sets


def kernel_phase(scene, cam, opts, tracer, device):
    """Kernel vs plain version on the config4 ray sets → (max |Δt|, ms,
    plain ms). The times walk the four sets the render walks once, in
    launches of the render's tile size, from precomputed walk_init states."""
    import torch

    from raytracer_tpu_torch.accel.grid import walk_init
    from raytracer_tpu_torch.ops import walk as W

    grid, table = tracer._grid, tracer._table
    sets = walk_ray_sets(scene, cam, opts, tracer, device)
    sets.append(("primary-occl6", sets[0][1], sets[0][2],
                 torch.full_like(sets[0][1][:, 0], 6.0), None))
    err = 0.0
    for name, o, d, mx, act in sets:
        o, d = o.contiguous(), d.contiguous()
        state = walk_init(grid, o, d, opts.t_min, act)
        got = W.grid_walk_cuda(grid, table, o, d, state, opts.t_min, mx)
        ref = W.grid_walk_reference(grid, table, o, d, opts.t_min, mx, act)
        torch.cuda.synchronize()
        err = max(err, compare_walks(name, ref, got, mx))
        if act is not None:
            assert bool(torch.isinf(got[0][~act]).all()), f"{name}: masked lane hit"

    tile = opts.tile_rays
    pieces = []
    for _, o, d, mx, act in sets[:-1]:  # the four sets the render walks
        for s in range(0, o.shape[0], tile):
            pieces.append((o[s:s + tile].contiguous(), d[s:s + tile].contiguous(),
                           None if mx is None else mx[s:s + tile].contiguous(),
                           None if act is None else act[s:s + tile]))
    states = [walk_init(grid, o, d, opts.t_min, a)
              for o, d, _, a in pieces]

    def run_kernel():
        for (o, d, mx, _), st in zip(pieces, states):
            W.grid_walk_cuda(grid, table, o, d, st, opts.t_min, mx)

    def run_plain():
        for (o, d, mx, _), st in zip(pieces, states):
            W.grid_walk_plain(grid, table, o, d, st, opts.t_min, mx)

    ms = cuda_ms(run_kernel, 5)
    plain_ms = cuda_ms(run_plain, 1)
    # the bound: the work these rays need, counted with the plain walk
    stats = {}
    for (o, d, mx, _), st in zip(pieces, states):
        W.grid_walk_plain(grid, table, o, d, st, opts.t_min, mx, stats=stats)
    cands, visits = float(stats["candidates"]), float(stats["visits"])
    ops = K5_OPS["candidate"] * cands + K5_OPS["visit"] * visits
    nbytes = sum(table.numel() * 4 + o.shape[0] * (
        K5_RAY_BYTES + (K5_OCCL_BYTES if mx is not None else 0))
        for o, _, mx, _ in pieces)
    b_ms, b_by = bound_ms(ops, nbytes)
    print(f"walk over {sum(p[0].shape[0] for p in pieces)} rays in "
          f"{len(pieces)} launches of ≤{tile}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms; {visits:.6g} cell visits, {cands:.6g} "
          f"candidates tested, {ops:.6g} ops, {nbytes:.6g} bytes "
          f"(table {table.numel() * 4} B per launch) → bound {b_ms:.4f} ms "
          f"({b_by})", flush=True)
    return err, ms, plain_ms, b_ms, b_by


def golden_phase(name, w, h, device):
    import dataclasses

    import numpy as np

    from raytracer_tpu_torch.io.image import load_ppm
    from raytracer_tpu_torch.renderer import render_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli

    scene, cam, opts = load_scene_cli(name)
    opts = dataclasses.replace(opts, width=w, height=h)
    tracer = build_tracer(scene, "auto", device)
    img, _ = render_banded(scene, cam, opts, device=device, tracer=tracer)
    got = img.cpu().numpy().astype(np.float64)
    want = load_ppm(os.path.join(GOLDEN, f"{name}_{w}x{h}.ppm"))
    diff = np.abs(got - want).max(axis=-1)
    bad = float((diff > IMG_TOL).mean())
    print(f"golden {name} {w}x{h}: {bad:.4%} pixels > {IMG_TOL} "
          f"(max {diff.max():.4f})", flush=True)
    assert bad <= IMG_BAD, f"{name}: {bad:.4%} bad pixels"


def fused_ops(fw, pixels: int, stats) -> float:
    """Operations of one fused render of `pixels` pixels: every pixel
    evaluates every node; shadow sweeps counted as the plain version saw
    the kernel's early exits (`stats`)."""
    ns, np_, nt, _, nl = fw.counts
    n = fw.n_nodes
    leaves = (1 << fw.opts.max_depth) if fw.has_glass else 1
    child = K1_OPS["reflect"] + (K1_OPS["refract"] if fw.has_glass else 0)
    search = (K1_OPS["sphere"] * ns + K1_OPS["plane"] * np_
              + K1_OPS["tri"] * nt)
    per_px = (K1_OPS["pixel"] + n * (search + K1_OPS["node"]
                                     + nl * K1_OPS["light"])
              + leaves * K1_OPS["leaf"] + (n - leaves) * child)
    shadow = sum(K1_OPS[kind] * float(stats.get("shadow_" + k, 0))
                 for k, kind in (("s", "sphere"), ("p", "plane"),
                                 ("t", "tri")))
    return pixels * per_px + shadow


def fused_case(name, device, w=0, h=0, depth=None):
    from raytracer_tpu_torch.ops import fused as F
    from raytracer_tpu_torch.utils.hostload import load_scene_cli

    scene, cam, opts = load_scene_cli(name, width=w, height=h,
                                      max_depth=depth)
    return F.FusedWhitted(scene, cam, opts, device=device), (scene, cam, opts)


def fused_compare(name, fw) -> float:
    """Kernel vs plain render_plan on the card → max |Δ| of the image."""
    import torch

    from raytracer_tpu_torch.ops import fused as F

    h, w, n = fw.opts.height, fw.opts.width, fw.n_nodes
    img, wins, occs = fw.render_plan()
    want, plan = F.fused_whitted_plain(fw, 0, h, emit_plan=True)
    torch.cuda.synchronize()
    assert tuple(img.shape) == (h, w, 3) and len(wins) == len(occs) == n
    assert bool(torch.isfinite(img).all()), f"{name}: non-finite pixels"
    diff = (img - want).abs().amax(dim=-1)
    bad = float((diff > PX_TOL).float().mean())
    err = float(diff.max())
    win = max(float((a != b).float().mean()) for a, b in zip(wins, plan[:n]))
    occ = max(float((a != b).float().mean()) for a, b in zip(occs, plan[n:]))
    msg = (f"{name} {w}x{h} d{fw.opts.max_depth} ({n} nodes): "
           f"{bad:.5%} pixels off >1/255, max |d| {err:.3g}, worst win "
           f"plane {win:.5%}, worst occ plane {occ:.5%}")
    print(msg, flush=True)
    assert bad <= PX_BAD, msg
    assert win <= ID_MAX_DIFF and occ <= ID_MAX_DIFF, msg
    return err


def fused_golden(name, w, h, device, tol, max_bad, max_mean=None):
    """The fused image, quantized as the CLI writes it, against the 8-bit
    golden (unquantized, the golden's own rounding alone would put the mean
    at ~1e-3)."""
    from raytracer_tpu_torch.io.image import load_ppm, to_u8

    fw, _ = fused_case(name, device, w, h)
    got = to_u8(fw.render()) / 255.0
    want = load_ppm(os.path.join(GOLDEN, f"{name}_{w}x{h}.ppm"))
    diff = abs(got - want).max(axis=-1)
    bad = float((diff > tol).mean())
    mean = float(abs(got - want).mean())
    msg = (f"fused golden {name} {w}x{h} d{fw.opts.max_depth}: {bad:.4%} "
           f"pixels > {tol} (max {diff.max():.4f}, mean {mean:.2e})")
    print(msg, flush=True)
    assert bad <= max_bad, msg
    assert max_mean is None or mean < max_mean, msg


def fused_main_path(device):
    """`cli render --tracer fused` on config2 1080p d2 and config3 1024² d4,
    in-process → {frame: launches}."""
    import torch

    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.io.image import load_ppm
    from raytracer_tpu_torch.ops import fused as F

    os.makedirs(OUT, exist_ok=True)
    runs = [("config2 1920x1080 d2", (1080, 1920), [
                "render", "--config", "config2", "--width", "1920",
                "--height", "1080", "--max-depth", "2", "--tracer", "fused",
                "--out", os.path.join(OUT, "config2_fused.ppm")]),
            ("config3 1024x1024 d4", (1024, 1024), [
                "render", "--config", "config3", "--tracer", "fused",
                "--out", os.path.join(OUT, "config3_fused.ppm")])]
    for _, _, argv in runs:  # warm-up
        cli.main(argv)
    torch.cuda.synchronize()
    launches = {}
    for tag, (h, w), argv in runs:
        F.launches = 0
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[tag] = F.launches
        print(f"main path: cli render {tag} --tracer fused: {dt:.4f} s wall "
              f"(image written), {F.launches} fused launches", flush=True)
        assert F.launches > 0, f"{tag}: the fused kernel never launched"
        img = load_ppm(argv[-1])
        assert img.shape == (h, w, 3), img.shape
        assert img.std() > 0.01, f"{tag}: a flat image"
    return launches


def fused_times(tag, fw, case, device):
    """Kernel, plain and wavefront times of one full frame → (ms, plain ms,
    bound ms, bound_by)."""
    import dataclasses

    import torch

    from raytracer_tpu_torch.ops import fused as F
    from raytracer_tpu_torch.renderer import render_banded

    h, w = fw.opts.height, fw.opts.width
    ms = cuda_ms(fw.render, 5)
    plain_ms = cuda_ms(lambda: F.fused_whitted_plain(fw, 0, h), 1)
    stats = {}
    F.fused_whitted_plain(fw, 0, h, stats=stats)
    ops = fused_ops(fw, h * w, stats)
    nbytes = 12 * h * w  # the RGB written once; the scene is a few KB
    b_ms, b_by = bound_ms(ops, nbytes)
    scene, cam, opts = case
    tile = min(h * w, 1 << 18) if scene.has_glass else h * w
    wopts = dataclasses.replace(opts, tile_rays=tile, tile_block=None)
    render_banded(scene, cam, wopts, device=device)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_banded(scene, cam, wopts, device=device)
    torch.cuda.synchronize()
    wf_ms = (time.perf_counter() - t0) * 1e3
    print(f"{tag}: fused kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}: {ops:.6g} ops, {nbytes} bytes); "
          f"wavefront render_banded {wf_ms:.3f} ms (tile {tile} rays, "
          f"context only)", flush=True)
    return ms, plain_ms, b_ms, b_by


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from raytracer_tpu_torch.kernels import build
    from raytracer_tpu_torch.models import presets
    from raytracer_tpu_torch.ops import fused as F
    from raytracer_tpu_torch.ops import walk as W
    from raytracer_tpu_torch.renderer import render_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    _phase("card")
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}", flush=True)

    _phase("build")
    path, build_s = build.build_library()
    build.load_library()
    print(f"built {os.path.relpath(path)} in {build_s:.2f} s", flush=True)
    for line in build.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(line.strip())

    _phase("kernel vs plain version, config4 rays at 1920x1080")
    scene, cam, opts = load_scene_cli("config4")
    t0 = time.perf_counter()
    tracer = build_tracer(scene, "auto", device)
    g = tracer._grid
    print(f"grid res {g.res}, capacity {g.capacity}, {g.n_tris} tris, "
          f"{g.overflow.shape[0]} overflow, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    err, ms, plain_ms, walk_bound, walk_by = kernel_phase(
        scene, cam, opts, tracer, device)

    _phase("goldens on the card")
    golden_phase("config4", 192, 108, device)
    golden_phase("config7", 128, 128, device)

    _phase("main path: config4 1920x1080 depth 4")
    render_banded(scene, cam, opts, device=device, tracer=tracer,
                  count_rays=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    W.launches = 0
    t0 = time.perf_counter()
    img, traced = render_banded(scene, cam, opts, device=device,
                                tracer=tracer, count_rays=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = W.launches
    rays = float(traced)
    print(f"config4 {opts.width}x{opts.height} depth {opts.max_depth}: "
          f"{dt:.4f} s, {rays:.6g} rays, {rays / dt:.6g} rays/s, "
          f"{launches} walk launches, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    assert launches > 0, "the main path never launched the walk kernel"
    assert tuple(img.shape) == (opts.height, opts.width, 3), img.shape
    assert bool(torch.isfinite(img).all()), "non-finite pixels"
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0

    _phase("fused kernel vs plain version on the card")
    fused_err = 0.0
    frames = {}
    for tag, name, w, h, depth in (
            ("config2 1920x1080 d2", "config2", 1920, 1080, 2),
            ("config3 1024x1024 d4", "config3", 0, 0, None)):
        fw, case = fused_case(name, device, w, h, depth)
        fused_err = max(fused_err, fused_compare(name, fw))
        frames[tag] = (fw, case)
    init, target, cam5, opts5 = presets.config5_inverse()
    fw5 = F.FusedWhitted(init, cam5, opts5, device=device, param_inputs=True)
    first = fw5.render()
    fw5.bind(center=target.spheres.center, albedo=target.materials.albedo)
    assert float((fw5.render() - first).abs().max()) > 0.1, "bind moved nothing"
    fused_err = max(fused_err, fused_compare("config5 (bound)", fw5))

    _phase("goldens on the card through the fused path")
    fused_golden("config1", 256, 256, device, IMG_TOL, IMG_BAD)
    fused_golden("config2", 256, 256, device, IMG_TOL, IMG_BAD)
    fused_golden("config3", 96, 96, device, GLASS_TOL, GLASS_BAD, GLASS_MEAN)

    _phase("main path: cli render --tracer fused")
    fused_launches = sum(fused_main_path(device).values())

    _phase("fused kernel times")
    fused_ms = fused_plain_ms = fused_bound = 0.0
    fused_by = set()
    for tag, (fw, case) in frames.items():
        k_ms, p_ms, b_ms, b_by = fused_times(tag, fw, case, device)
        fused_ms += k_ms
        fused_plain_ms += p_ms
        fused_bound += b_ms
        fused_by.add(b_by)
    print(f"fused kernel over both main-path frames: {fused_ms:.3f} ms, "
          f"plain {fused_plain_ms:.3f} ms, bound {fused_bound:.4f} ms",
          flush=True)

    print(json.dumps({"kernels": [{
        "name": "grid_walk", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/grid_walk.cu",
        "replaces": "raytracer_tpu/ops/pallas_walk.py:111",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": walk_bound, "bound_by": walk_by,
        "library_ms": None}, {
        "name": "fused_whitted", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/fused_whitted.cu",
        "replaces": "raytracer_tpu/ops/fused.py:326",
        "launches": fused_launches, "max_abs_err": fused_err,
        "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": fused_bound,
        "bound_by": "/".join(sorted(fused_by)), "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
