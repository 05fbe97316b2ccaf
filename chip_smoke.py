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
  carried it; kernel, plain and wavefront times on those two frames;
- fused train kernel (K2): kernel vs plain version (loss and the four
  gradient tables, on the same plan) at config5 128² (bound off target),
  config2 1920×1080 d2 and config3 1024² d4, its loss against the L2 of its
  own forward image, and two runs bit-equal; central differences of two
  parameters at config2 256² d2 and config3 96² d4; the main path
  `cli optimize --kernel --steps 30` on config5 128², checking that the loss
  falls and that it made 30 train and 30 forward launches; kernel, training
  step (forward + train) and plain times on the two bench frames.

A JSON line lists each kernel's launches on its main paths, error, times and
bound (the least time the card could take: operations over 67 TFLOP/s fp32
or bytes over 3.35 TB/s, whichever is larger, for the work of all the
frames a kernel's times cover). Any failure raises; the last
line is `{"ok": true, "device": {...}}` only on success. Exits non-zero
without a result when no CUDA device is available.
"""

import contextlib
import io
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
# train kernel vs plain: the two sum a frame's pixels in different orders
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-4, 1e-3  # loss; × each table's max
FD_EPS = 3e-4        # central differences (tests/test_fused_vjp.py's step)
PLAIN_BAND_PX = 1 << 17  # autograd sub-bands of the plain train version
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
# fp32 operations of the train kernel, counted from csrc/fused_train.cu by
# the same rules, as (forward, backward) per piece. The function needs one
# forward and one backward of every live node, so the bound counts a piece
# as forward + backward (the kernel recomputes the forward in its second
# sweep, a choice of its own that the bound does not count); pixel:
# raygen, the loss and dL/drad.
#   node: hit point and din; their adjoints and the attribute gradients;
#   sphere/plane/tri: the winner's t recompute and its normal (plane: with
#   the checker) and their adjoints; light: one light's Phong term of a
#   diffuse node; diffuse: its combine; fresnel: kr of a mirror/glass node;
#   reflect/refract: a child ray.
K2_OPS = {"pixel": 55, "node": (11, 34), "sphere": (40, 131),
          "plane": (33, 87), "tri": (46, 113), "light": (60, 156),
          "diffuse": (12, 33), "fresnel": (33, 60), "reflect": (33, 61),
          "refract": (50, 92)}
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
    """Kernel, plain and wavefront times of one full frame, and the work
    the kernel must do there → (ms, plain ms, ops, bytes)."""
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
    return ms, plain_ms, ops, nbytes


def train_ops(fw, pixels: int, stats) -> float:
    """Operations of one train launch over `pixels` pixels, with the live
    nodes of this run's plan (`stats` from the plain version)."""
    n = lambda k: float(stats.get(k, 0))
    cost = lambda piece: sum(K2_OPS[piece])
    hits = n("live_s") + n("live_p") + n("live_t")
    diffuse = n("live_diffuse")
    return (pixels * K2_OPS["pixel"] + hits * cost("node")
            + n("live_s") * cost("sphere") + n("live_p") * cost("plane")
            + n("live_t") * cost("tri")
            + diffuse * (cost("diffuse") + fw.counts[4] * cost("light"))
            + (hits - diffuse) * cost("fresnel")
            + n("reflect") * cost("reflect") + n("refract") * cost("refract"))


def train_bytes(fw, pixels: int, stats) -> float:
    """Bytes a train launch must move: 8 of plan per live node, 12 of
    target per pixel, the tables in and their gradients out."""
    tables = sum(t.numel() for t in (fw.sph, fw.pln, fw.mat, fw.lgt))
    return 8.0 * float(stats["live"]) + 12.0 * pixels + 8.0 * (tables + 1)


def train_case(name, device, w=0, h=0, depth=None):
    """A param-mode fused object and its target: config5's init bound off
    target against the goal's image; otherwise 0.9 × its own image."""
    import numpy as np

    from raytracer_tpu_torch.models import presets
    from raytracer_tpu_torch.ops import fused as F
    from raytracer_tpu_torch.utils.hostload import load_scene_cli

    if name == "config5":
        init, goal, cam, opts = presets.config5_inverse()
        fw = F.FusedWhitted(init, cam, opts, device=device, param_inputs=True)
        target = F.FusedWhitted(goal, cam, opts, device=device).render()
        fw.bind(center=np.asarray(goal.spheres.center) + np.float32(0.05),
                albedo=np.full((3, 3), 0.4, np.float32))
        return fw, target.contiguous()
    scene, cam, opts = load_scene_cli(name, width=w, height=h,
                                      max_depth=depth)
    fw = F.FusedWhitted(scene, cam, opts, device=device, param_inputs=True)
    return fw, (fw.render() * 0.9).contiguous()


def train_plain(fw, target, plan, stats=None):
    from raytracer_tpu_torch.ops import fused as F

    n = fw.n_nodes
    return F.fused_train_plain(
        fw, 0, fw.opts.height, plan[:n], plan[n:], target,
        band_rows=max(1, PLAIN_BAND_PX // fw.opts.width), stats=stats)


def train_compare(tag, fw, target):
    """Train kernel vs plain version on one plan, the kernel's loss against
    the L2 of its own forward image, and two kernel runs bit for bit →
    (max |Δ| over the gradient tables, plain ms)."""
    import torch

    from raytracer_tpu_torch.ops import fused as F

    h = fw.opts.height
    img, plan = F.fused_whitted_cuda(fw, 0, h, emit_plan=True)
    got = F.fused_train_cuda(fw, 0, h, plan, target)
    again = F.fused_train_cuda(fw, 0, h, plan, target)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    want = train_plain(fw, target, plan)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    own = float(((img.double() - target.double()) ** 2).sum())
    lk, lp = float(got[0]), float(want[0])

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    errs = {k: rel(got[1][k], want[1][k]) for k in want[1]}
    radius = rel(got[1]["sph"][:, 3], want[1]["sph"][:, 3])
    err = max(float((got[1][k] - want[1][k]).abs().max()) for k in want[1])
    same = torch.equal(got[0], again[0]) and all(
        torch.equal(got[1][k], again[1][k]) for k in got[1])
    msg = (f"{tag} ({fw.n_nodes} nodes): loss kernel {lk:.7g}, plain "
           f"{lp:.7g}, own image {own:.7g}; gradient error / table max "
           + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
           + f" (sphere radii / their max {radius:.2e}); two runs "
           f"bit-equal: {same}; plain {plain_ms:.1f} ms")
    print(msg, flush=True)
    assert all(torch.isfinite(got[1][k]).all() for k in got[1]), msg
    assert abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp), msg
    assert abs(lk - own) <= TRAIN_LOSS_RTOL * abs(own), msg
    assert max(errs.values()) <= TRAIN_GRAD_TOL, msg
    assert same, msg
    return err, plain_ms


def train_fd(tag, fw, target, probes):
    """Central differences of the forward's own image loss (float64 on the
    host, the plan re-recorded at each probe) against the train kernel's
    gradient. Pixels whose plan flips between the probes (silhouettes) are
    left out of both sides: the kernel gets them as misses."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops import fused as F

    h, n = fw.opts.height, fw.n_nodes
    base = {"center": fw.sph[:fw.counts[0], :3].cpu().numpy().copy(),
            "albedo": fw.mat[:fw.counts[3], :3].cpu().numpy().copy()}
    t64 = target.double()

    def frame(params):
        fw.bind(**params)
        img, plan = F.fused_whitted_cuda(fw, 0, h, emit_plan=True)
        return img.double(), plan

    _, plan0 = frame(base)
    for key, (i, k) in probes:
        hi = {a: v.copy() for a, v in base.items()}
        lo = {a: v.copy() for a, v in base.items()}
        hi[key][i, k] += FD_EPS
        lo[key][i, k] -= FD_EPS
        (ih, ph), (il, pl_) = frame(hi), frame(lo)
        keep = ((ph == plan0) & (pl_ == plan0)).all(dim=0)
        fd = float((((ih - t64) ** 2 - (il - t64) ** 2).sum(-1)
                    * keep).sum()) / (2 * FD_EPS)
        fw.bind(**base)
        plan = plan0.clone()
        plan[:n, ~keep] = -1
        plan[n:, ~keep] = 0
        _, g = F.fused_train_cuda(fw, 0, h, plan, target)
        got = float(g["sph" if key == "center" else "mat"][i, k])
        msg = (f"{tag}: d loss / d {key}[{i}, {k}]: kernel {got:.6g}, "
               f"central difference {fd:.6g} ({int((~keep).sum())} "
               "pixels whose plan flips left out)")
        print(msg, flush=True)
        assert abs(got - fd) <= 0.05 * abs(fd) + 2e-3, msg
        assert np.isfinite(got), msg
    torch.cuda.synchronize()


def optimize_main_path():
    """`cli optimize --kernel --steps 30` on config5 128², after a 2-step
    warm-up → (forward launches, train launches)."""
    import torch

    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.io.image import load_ppm
    from raytracer_tpu_torch.ops import fused as F

    out_path = os.path.join(OUT, "recovered.ppm")
    argv = ["optimize", "--kernel", "--steps", "30", "--log-every", "1",
            "--out", out_path]
    with contextlib.redirect_stdout(io.StringIO()):  # warm-up, 2 steps
        cli.main(argv[:2] + ["--steps", "2", "--out", out_path])
    torch.cuda.synchronize()
    buf = io.StringIO()
    F.launches = F.train_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k2 = F.launches, F.train_launches
    text = buf.getvalue()
    losses = [json.loads(line)["loss"] for line in text.splitlines()
              if line.startswith('{"step"')]
    print(text, end="")
    print(f"main path: cli optimize --kernel --steps 30 (config5 128x128): "
          f"{dt:.4f} s wall, {k1} forward launches, {k2} train launches; "
          f"loss step 0 {losses[0]:.6g}, step 9 {losses[9]:.6g}, min "
          f"{min(losses):.6g}, step 29 {losses[-1]:.6g}", flush=True)
    assert len(losses) == 30, len(losses)
    assert losses[9] <= 0.5 * losses[0], losses
    assert k1 == 30 and k2 == 30, (k1, k2)
    img = load_ppm(out_path)
    assert img.shape == (128, 128, 3) and img.std() > 0.01, img.shape
    return k1, k2


def train_times(tag, fw, target):
    """Kernel and training-step times of one full frame, and the work the
    train kernel must do there → (ms, step ms, ops, bytes)."""
    from raytracer_tpu_torch.ops import fused as F

    h, w = fw.opts.height, fw.opts.width
    _, plan = F.fused_whitted_cuda(fw, 0, h, emit_plan=True)
    ms = cuda_ms(lambda: F.fused_train_cuda(fw, 0, h, plan, target), 5)
    step_ms = cuda_ms(lambda: fw.plan_value_and_grad(target), 5)
    stats = {}
    train_plain(fw, target, plan, stats=stats)
    ops, nbytes = train_ops(fw, h * w, stats), train_bytes(fw, h * w, stats)
    b_ms, b_by = bound_ms(ops, nbytes)
    counts = ", ".join(f"{k} {int(v)}" for k, v in sorted(stats.items()))
    print(f"{tag}: train kernel {ms:.3f} ms, training step (forward + train) "
          f"{step_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: {ops:.6g} ops, "
          f"{nbytes:.6g} bytes; {counts})", flush=True)
    return ms, step_ms, ops, nbytes


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

    _phase("fused train kernel vs plain version on the card")
    train_err = 0.0
    train_frames = {}
    for tag, name, w, h, depth in (
            ("config5 128x128 d0 (bound)", "config5", 0, 0, None),
            ("config2 1920x1080 d2", "config2", 1920, 1080, 2),
            ("config3 1024x1024 d4", "config3", 0, 0, None)):
        fw, target = train_case(name, device, w, h, depth)
        err_k, p_ms = train_compare(tag, fw, target)
        train_err = max(train_err, err_k)
        if name != "config5":
            train_frames[tag] = (fw, target, p_ms)

    _phase("fused train kernel against central differences")
    for tag, name, w, h, depth, probes in (
            ("config2 256x256 d2", "config2", 256, 256, 2,
             [("albedo", (0, 0)), ("center", (0, 1))]),
            ("config3 96x96 d4", "config3", 96, 96, 4,
             [("albedo", (1, 1)), ("center", (1, 0))])):
        fw, target = train_case(name, device, w, h, depth)
        train_fd(tag, fw, target, probes)

    _phase("main path: cli optimize --kernel")
    opt_fwd, train_launches = optimize_main_path()

    _phase("fused kernel times")
    fused_ms = fused_plain_ms = fused_ops_n = fused_bytes = 0.0
    for tag, (fw, case) in frames.items():
        k_ms, p_ms, ops, nbytes = fused_times(tag, fw, case, device)
        fused_ms += k_ms
        fused_plain_ms += p_ms
        fused_ops_n += ops
        fused_bytes += nbytes
    fused_bound, fused_by = bound_ms(fused_ops_n, fused_bytes)
    print(f"fused kernel over both main-path frames: {fused_ms:.3f} ms, "
          f"plain {fused_plain_ms:.3f} ms, bound {fused_bound:.4f} ms "
          f"({fused_by})", flush=True)

    _phase("fused train kernel times")
    train_ms = train_step_ms = train_plain_ms = train_ops_n = 0.0
    train_bytes_n = 0.0
    for tag, (fw, target, p_ms) in train_frames.items():
        k_ms, s_ms, ops, nbytes = train_times(tag, fw, target)
        train_ms += k_ms
        train_step_ms += s_ms
        train_plain_ms += p_ms
        train_ops_n += ops
        train_bytes_n += nbytes
    train_bound, train_by = bound_ms(train_ops_n, train_bytes_n)
    print(f"train kernel over both bench frames: {train_ms:.3f} ms, training "
          f"step {train_step_ms:.3f} ms, plain {train_plain_ms:.3f} ms, bound "
          f"{train_bound:.4f} ms ({train_by})", flush=True)

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
        "launches": fused_launches + opt_fwd, "max_abs_err": fused_err,
        "ms": fused_ms, "plain_ms": fused_plain_ms, "bound_ms": fused_bound,
        "bound_by": fused_by, "library_ms": None}, {
        "name": "fused_train", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/fused_train.cu",
        "replaces": "raytracer_tpu/ops/fused.py:326 (train)",
        "launches": train_launches, "max_abs_err": train_err,
        "ms": train_ms, "plain_ms": train_plain_ms, "bound_ms": train_bound,
        "bound_by": train_by, "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
