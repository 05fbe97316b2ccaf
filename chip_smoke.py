"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from raytracer_tpu_torch/csrc (one nvcc per source,
in parallel) and prints their ptxas register/spill report. Then, per kernel:

- grid walk (K5): its one entry (`grid_search_cuda`, one launch a
  GridTracer search) over every search of the main path's config4
  1920×1080 d4 frame, each bit for bit against the plain composition it
  replaces (dense sphere/plane search, walk_init, the plain walk, the
  merge), each search's walking lanes, cell visits, candidates and the
  lane efficiency of its candidate loops, the searches' time against the
  composition's and the bound; the config4 and config7 goldens on the
  card, and the main path (load_scene_cli → build_tracer("auto") →
  render_banded) on config4 at 1920×1080, depth 4, checking that the fused
  entry carried every search, with the frame's K5 time read from the
  profiler. Alone: `kernel_alone()`;
- the fused shading of a bounce (K6, csrc/bounce_shade.cu), after the
  main path's frame: each of its bounces through K6 and through the torch
  bounce from the same state and the same search answers, bit for bit
  (radiance, ray count, children, plan planes); its surface and shade
  launches timed whole (`call_times`) beside the bound (bytes / 3.35
  TB/s) and the torch bounce's time; its launches on the main paths (a
  render frame, a training step's record) and a frame's device
  operations. Alone: `shade_alone()`;
- the adjoint of a recorded bounce (K7, csrc/bounce_adjoint.cu), the
  backward of K6's shade launch in a config4 1080p d4 training step: the
  step's two replayed bounces' K7 calls, as the step made them, timed
  whole (`call_times`) beside the bound (bytes / 3.35 TB/s), against the
  plain autograd twin's backward of the torch bounce on the same inputs
  and cotangents (its gradients held to K7's), its launches a step, and
  the step both ways by CUDA events. Alone: `adjoint_alone()`;
- fused Whitted forward (K1), in its three modes (image: the live nodes
  only; live plan; full plan): the full plan vs the plain version (image
  and plan planes) on config1 256², config2 1920×1080 d2, config3 1024² d4
  (glass, 31 nodes) and config5 128² in param mode after a bind, and on
  each of them the image mode's and the live plan's image equal to the full
  plan's; the config1/config2/config3 goldens through the fused path; the
  main paths `cli render --tracer fused` (image mode) and
  `FusedWhitted.render_plan` (full plan) on config2 1080p d2 and config3
  1024² d4, checking that each mode carried its path; each mode's time and
  bound on those two frames, and plain and wavefront times;
- fused train kernel (K2): kernel vs plain version (loss and the four
  gradient tables, on the same full plan) at config5 128² (bound off
  target), config2 1920×1080 d2 and config3 1024² d4, its loss against the
  L2 of its own forward image, two runs bit-equal, and the training step on
  the live plan (`plan_value_and_grad`) bit-equal to the step on the full
  plan; a 30-sphere scene of 345 table floats (one launch) and
  glass-free max_depth 40 (config2 256², and config2 between two mirror
  planes, whose chains pass the kernels' on-chip levels), K1 and K2 against
  the plain versions; central differences of two parameters at config2
  256² d2 and config3 96² d4; the main path `cli optimize --kernel --steps
  30` on config5 128², checking that the loss falls and that it made 30
  train and 30 live-plan launches; kernel (and its reduction alone),
  training step (live plan + train) and plain times on the two bench
  frames;
- brute-force triangle searches (K3: tri_nearest/tri_occluded, K4:
  mat_nearest/mat_occluded): kernel vs plain version on config4's 1080p ray
  sets (K3 and K4 bit for bit, asserted), the two against each other and
  against the grid walk; the config4 golden through `--tracer
  pallas` and `--tracer mat`; the main path `cli render --config config4
  --tracer pallas|mat` at 1920×1080, depth 4, checking that all four
  kernels carried it and that each image matches the grid path's frame;
  kernel and plain times over one frame's launches, beside the bound and
  the `--fmad=false` instruction ceiling; the shares of K3's tests that
  pass each of its stages (past det, past u, into the reciprocal) over
  that frame; K3's and K4's registers and spills from the build (no
  spills).

- wavefront training (the walk K5 and K1's full plan as planners): the
  config4 1920×1080 d4 fwd+bwd step — `render(record_plan=True)` with the
  grid walk, then `replay_band_vg` for the sphere centers and material
  albedos against the grid frame × 0.9 — its time split into record and
  replay value-and-grad (CUDA events), walk launches, traced rays and
  fwd+bwd rays/s, peak memory, the plan's bytes; the replay's image against the grid frame, the step against autograd
  through the wavefront (remat off), and two runs; one step under
  torch.profiler (top ops; in a process of its own); central differences
  at config4 256×144 d4; K1's full plan replayed to K1's image (config2
  1080p d2, config3 256² d4 glass); the main paths `cli optimize` without
  a flag, `--plan` and `--preset mesh` (30 steps each).

- multi-device (`raytracer_tpu_torch/parallel/`), at world size = the card
  count, one rank per card over NCCL (a one-rank group in this process at
  one card, else one spawned process per card): `render_sharded` of config4
  1920×1080 d4 with the replicated grid tracer (tiles = world size; image
  and ray count equal to the single-device frame bit for bit, K5 launched)
  and with per-shard BVHs (prims = world size; against the single-device
  `--tracer bvh` frame: differing pixels counted, the golden standard
  held; the BVH walk launched), each timed against the single-device
  frame in turns; `plan_value_and_grad_sharded` (K1's live plan and K2 on
  each rank's band) at config2 1080p d2 and config3 1024² d4 against
  `plan_value_and_grad`; `make_loss_and_grad` at config2 1080p d2,
  overlapped against the plain backward and against the single-device
  autograd loss, both step times.

- tooling, through the CLI a user calls: `cli render --config config4
  --tile-block 270x480` (16 tiles) and `32x160` (408 tiles) at 1920×1080
  d4, each image (and the rays) bit-equal to the main-path frame, 5
  frames in turns against the one-tile frame; `cli render --trace` in a
  process of its own (top device ops, the frame's device-idle share: 1 −
  the union of kernel, copy and set intervals over the traced window)
  and a warm frame traced likewise; `cli render --resilient` without a
  fault and with a countdown of 1 (band worker processes), each bit-equal
  to the main-path frame, and the parts of a fresh process's frame (import,
  CUDA context, grid build, first and second frame: `cold_start`); `cli optimize --kernel --supervise` (config5
  128², 8 steps) with children that crash every 3 steps against an
  uncrashed supervised run (rtol 1e-6, ≥2 restarts), and `cli optimize`
  stopped at 5 steps and `--resume`d to 8 against 8 straight. The launches
  of child processes are counted through a `sitecustomize.py` written to
  smoke_out/counthook/; alone: `tooling_alone()`.

- the culled sweep (`accel/cull.py`, csrc/cull_sweep.cu) on the main
  path's scene and grid frame at config4 1920×1080 d4 in 32×160 screen
  blocks, cap 1024 (the reference's hybrid rung): `cull_audit` (thin/fat
  tiles, the largest counts, its time); the sweep kernel on the hybrid
  frame's calls (the thin tiles' d0 nearest and each light's shadows) bit
  for bit against its plain version and equal to the grid walk on the
  same rays, its calls timed whole (`call_times`: the kernel's and every
  device op's time by the profiler, each launch's, CUDA events, the
  host's time) beside its bound (the rays' bytes on live lanes only), the
  plain version's and the grid tracer's (K5) on the same calls, its tests
  over the warp tests of lane and of live-list order, the CTAs each
  launch starts and those that stage rows; the hybrid's gate in
  turns:
  the whole culled d0 call against the grid tracer's call, and
  `HybridBand` 5 frames against the grid frame (image within 2e-7, rays,
  two runs);
  `render_partitioned` bit-equal to it; the hybrid fwd+bwd step
  (`hybrid_image` under autograd) against the grid step (loss rtol 1e-6,
  gradients rtol 1e-4, atol 1e-7), its time and peak memory;
  `render(tracer=CullTracer)` at 480×270 against the grid render; the
  overflow drill at 192×108, cap 128 (the audit flags it, the image
  diverges). Alone: `cull_alone()`.

- the BVH walk (csrc/bvh_walk.cu) against its plain version (bit for bit)
  and against the grid walk on config4's 1080p ray sets; the main path
  `cli render --config config4 --tracer bvh` at 1920×1080 d4 (launches,
  image vs the grid frame); that frame's 15 calls timed whole (`call_times`) against
  the bound (the rays' bytes on live lanes only, beside the first
  count's, which charged them to every lane), with each launch's live
  rays and longest walk, and the node steps over the warp steps of lane
  and of live-list order. Alone: `bvh_alone()`.

Before the kernels, raygen's pixel coordinates at 1920×1080 on the card are
held to the CPU's bit for bit.

A JSON line lists each kernel's launches on its main paths (per path under
"main_paths" for K5, K1, K2 and the BVH walk), error, times and
bound (the least time the card could take: operations over 67 TFLOP/s fp32
or bytes over 3.35 TB/s, whichever is larger, for the work of all the
frames a kernel's times cover); K1 has one entry per mode, the culled
sweep one with its paths. The BVH walk's and the culled sweep's ms are the
profiler's sums of the kernel's own intervals. Any failure
raises; the last
line is `{"ok": true, "device": {...}}` only on success. Exits non-zero
without a result when no CUDA device is available.
"""

import contextlib
import io
import json
import os
import re
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
ALL_OPS = 1 << 30    # `top_ops`'s k: every name in the trace

# fp32 operations of the fused kernel per piece, counted from
# csrc/fused_whitted.cu (add, sub, mul, div, min, max, sqrt, rsqrt, floor,
# abs: 1 each; powf: 3; comparisons and selects: 0):
#   sphere/plane/tri: one intersection test; pixel: raygen + final clamp;
#   node: hit point, winner attributes (counted as a sphere's normal),
#   din, shadow origin, Phong combine, fresnel;
#   light_dir: the direction and distance to one light (a shadow sweep's
#   ray); phong: the rest of one light's Phong term; leaf: w·bg;
#   reflect/refract: a child ray plus folding its radiance into the parent.
K1_OPS = {"sphere": 33, "plane": 14, "tri": 46, "pixel": 39, "node": 73,
          "light_dir": 15, "phong": 40, "leaf": 6, "reflect": 35,
          "refract": 56}
K1_MODES = ("image", "live_plan", "plan")
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
# the grid walk K5's fused search, counted from csrc/grid_walk.cu (fp32
# operations as K1_OPS counts them): per lane, the dense test of a sphere
# (35) and of a plane (15); per active lane, walk_init's slab entry and
# first cell (80) and a Möller–Trumbore test per overflow triangle; per
# tested candidate Möller–Trumbore (46), per cell visit a DDA step (3)
K5_OPS = {"sphere": 35, "plane": 15, "init": 80, "candidate": 46, "visit": 3}
# its bytes: per lane orig + dir in (24), a mask (1), a shadow search's
# max_t in and bool out (5) or a nearest search's kind, idx and t out (12);
# per launch each listed triangle once, 40 bytes (v0|e1|e2|id) whatever the
# layout, as each overflow triangle, the sphere (16) and plane (24) tables
# and the grid's box (36): every lane reads the same few bytes, which come
# from memory once
K5_LANE_BYTES, K5_MASK_BYTES, K5_OCCL_BYTES, K5_NEAREST_BYTES = 24, 1, 5, 12
K5_SLOT_BYTES, K5_SPHERE_BYTES, K5_PLANE_BYTES, K5_BOX_BYTES = 40, 16, 24, 36
# K6, the fused shading of a bounce (csrc/bounce_shade.cu), its bytes per
# lane: the surface launch reads o, d (24), the winner's kind and idx (8)
# and alive (1), and writes the shadow origin (12), each light's
# direction, distance and search mask (17) and the diffuse mask (1); the
# shade launch reads o, d, thr (36), kind, idx (8), alive (1) and each
# light's shadow bit (1), reads and writes the radiance (24), and writes
# each child's o, d, thr and alive (37) and the plan planes (8) when
# recorded; per launch every scene table once
K6_SURFACE_LANE, K6_SURFACE_LIGHT = 46, 17
K6_SHADE_LANE, K6_SHADE_LIGHT, K6_CHILD, K6_PLAN = 69, 1, 37, 8
# K7, the adjoint of a recorded bounce (csrc/bounce_adjoint.cu), its bytes
# per lane: o, d, thr (36), kind, idx (8), alive (1) and each light's
# shadow bit (1) read; 12 a cotangent of a term or of the child's o, d or
# thr read, 12 a cotangent of o, d or thr written; per launch every scene
# table once and a partial row a block
K7_LANE, K7_LIGHT, K7_VEC = 45, 1, 12
# brute-force searches, per ray–triangle test: K3 is the walk's
# Möller–Trumbore (csrc/tri_trace.cu). K4 counts what the function needs,
# not the kernel's 76 + 6: build_tri_weights leaves 3 of the 10 weight rows
# non-zero for det, 6 for u and for v, 4 for t, one of them against the
# constant feature 1 (an add, no product): det 3 mul + 2 add, u and v 6 + 5
# each, t 3 + 3, then the epilogue (abs, div, 3 mul, u + v: 6) → 39
BRUTE_OPS = {"tri": 46, "mat": 39}
# K4 against another tracer (its search t reassociates MT): hit/miss flips
# and other winners each on at most this share of rays, and as many
# occlusion differences (read on an H100 80GB HBM3, 700 W: 1 flip and 2
# other winners of 2,073,600 primaries, 1 occlusion difference)
CROSS_MAX = 1e-4
# ray bytes in and out per launch: K3 reads orig + dir (24), K4 the feature
# row (64); nearest writes t + idx (8), any-hit reads max_t (4) and writes a
# bool (1); a mask adds 1
BRUTE_RAY_IN = {"tri": 24, "mat": 64}
BRUTE_OUT = {"nearest": 8, "occluded": 5}
# kernels' JSON names, their wrappers (module, nearest, any-hit), and the
# TPU kernels they replace
BRUTE = {"tri": ("raytracer_tpu_torch.ops.pallas_trace", "tri_nearest",
                 "tri_occluded", "raytracer_tpu_torch/csrc/tri_trace.cu",
                 "raytracer_tpu/ops/pallas_trace.py", (74, 94)),
         "mat": ("raytracer_tpu_torch.ops.mat_trace", "mat_nearest",
                 "mat_occluded", "raytracer_tpu_torch/csrc/mat_trace.cu",
                 "raytracer_tpu/ops/mat_trace.py", (126, 147))}


def _phase(name):
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: bool = True) -> float:
    """Mean device milliseconds of `fn()` over `reps` runs (after a warm-up
    run unless `warmup` is false)."""
    import torch

    if warmup:
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_intervals(fn, key: str = "", expect=None) -> list:
    """(name, device ms) of every device interval (kernels, copies, sets)
    in one run of `fn()` traced by torch.profiler (`utils/profiling`), in
    launch order, after a warm-up run. A trace that holds no interval whose
    name contains `key`, or not `expect` of them, is taken again (four
    times at most): a profiler session after the first in a process now and
    then records no device time. Raises if none does."""
    import tempfile

    import torch

    from raytracer_tpu_torch.utils.profiling import (DEVICE_CATS,
                                                     trace_events,
                                                     xprof_trace)

    fn()
    torch.cuda.synchronize()
    os.makedirs(OUT, exist_ok=True)
    for _ in range(5):
        with tempfile.TemporaryDirectory(dir=OUT) as d:
            with xprof_trace(d, device="cuda"):
                fn()
                torch.cuda.synchronize()
            events = sorted((e["ts"], e["name"], float(e["dur"]) / 1e3)
                            for e in trace_events(d)
                            if e.get("cat", "").lower() in DEVICE_CATS)
        n = sum(key in name for _, name, _ in events)
        if n and (expect is None or n == expect):
            return [(name, ms) for _, name, ms in events]
    raise RuntimeError(f"the profiler recorded {n} {key} launches, expected "
                       f"{expect or 'some'}")


def profile_launches(fn, key: str, expect=None) -> list:
    """Device milliseconds of each kernel whose name contains `key`, in
    launch order, in one run of `fn()` (`device_intervals`)."""
    return [ms for name, ms in device_intervals(fn, key, expect)
            if key in name]


def host_ms(fn, reps: int = 5) -> float:
    """Host milliseconds to issue `fn()` (no synchronize in the window, the
    device idle at its start), mean of `reps` runs after a warm-up."""
    import torch

    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e3


def call_times(calls, key: str) -> dict:
    """A kernel's recorded calls (`calls`: one thunk a call, each launching
    the kernel whose name contains `key` once) timed whole: "each_ms" and
    "kernel_ms", the kernel's own device intervals by the profiler and
    their sum; "device_ms" and "device_ops", every device interval of the
    calls (the kernel's and the wrapper's other kernels, torch ops, copies
    and sets); "events_ms", CUDA events around the calls (mean of 5 after
    a warm-up); "host_ms", the host's time to issue them (`host_ms`);
    "source", "profiler". Where no profiler session of this process
    records device time, each call's CUDA-event window (mean of 5) stands
    in for its device time, and "source" says "events"."""
    run = lambda: [c() for c in calls]
    out = {"events_ms": cuda_ms(run, 5), "host_ms": host_ms(run),
           "source": "profiler"}
    try:
        events = device_intervals(run, key, len(calls))
    except RuntimeError as e:
        print(f"{e}: each call's CUDA-event window stands in for its device "
              "time", flush=True)
        each = [cuda_ms(c, 5) for c in calls]
        return {**out, "each_ms": each, "kernel_ms": sum(each),
                "device_ms": sum(each), "device_ops": None,
                "source": "events"}
    each = [ms for name, ms in events if key in name]
    return {**out, "each_ms": each, "kernel_ms": sum(each),
            "device_ms": sum(ms for _, ms in events),
            "device_ops": len(events)}


def fmt_call(t: dict) -> str:
    """One line of `call_times`' numbers."""
    if t["source"] == "events":
        return (f"the whole call {t['device_ms']:.4f} ms by each call's CUDA "
                f"events (the profiler recorded no device time), "
                f"{t['events_ms']:.4f} ms by CUDA events around the calls, "
                f"{t['host_ms']:.4f} ms of host time to issue them")
    return (f"the whole call {t['device_ms']:.4f} ms of device time by the "
            f"profiler ({t['device_ops']} device ops; the kernel "
            f"{t['kernel_ms']:.4f} ms of it), {t['events_ms']:.4f} ms by "
            f"CUDA events around the calls, {t['host_ms']:.4f} ms of host "
            f"time to issue them")


def profile_ms(fn, key: str) -> float:
    """Device milliseconds of one run of `fn()` spent in kernels whose names
    contain `key` (`profile_launches`' sum)."""
    return sum(profile_launches(fn, key))


def bound_ms(ops: float, nbytes: float):
    """The least time the card could take → (ms, "operations" | "bytes")."""
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def instruction_rate() -> float:
    """fp32 instructions the card runs per second: 128 lanes per SM per
    clock at the card's maximum SM clock (nvidia-smi)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 128.0 * sms * mhz * 1e6


def print_ptxas(keys):
    """Print the registers and spills of every kernel entry whose mangled
    name contains one of `keys`, from the last build's `-Xptxas -v`."""
    from raytracer_tpu_torch.kernels import build

    for key in keys:
        for entry, regs, st, ld in ptxas_report(build.build_log, key):
            print(f"{entry}: {regs} registers, spill stores {st} B, spill "
                  f"loads {ld} B", flush=True)


def ptxas_report(log: str, key: str):
    """(entry, registers, spill store bytes, spill load bytes) of every
    kernel entry whose mangled name contains `key`, from `-Xptxas -v`."""
    rows, entry, spills = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry, spills = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry is not None:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            if key in entry:
                rows.append((entry, int(m.group(1)), *(spills or (0, 0))))
            entry = None
    return rows


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


def lane_efficiency(cands):
    """The share of lane slots that the candidate loops keep busy in the
    kernel's lane order (a warp = 32 consecutive lanes of a launch, in
    pixel order), as (Σ candidates, Σ 32 × the warp's most). `cands` [N]:
    each lane's candidates (0 where a lane does not walk)."""
    import torch

    key = torch.arange(cands.shape[0], device=cands.device) // 32
    most = torch.zeros(int(key.max()) + 1, dtype=cands.dtype,
                       device=cands.device)
    most.scatter_reduce_(0, key, cands, "amax")
    return float(cands.sum()), 32.0 * float(most.sum())


def k5_reset():
    """Set K5's launch count to 0."""
    from raytracer_tpu_torch.ops import walk as W

    W.launches = 0


def k5_searches(path: str) -> int:
    """K5's launches since `k5_reset()`: one a GridTracer search on `path`."""
    from raytracer_tpu_torch.ops import walk as W

    return W.launches


def frame_searches(scene, cam, opts, tracer, device):
    """The main path's config4 frame (`render_banded`) with a copy of every
    search it makes → [(orig, dirs, t_min, max_t or None, active or None)],
    in call order: per tile and bounce the nearest, then each light's
    shadow search."""
    import torch

    from raytracer_tpu_torch.ops import walk as W
    from raytracer_tpu_torch.renderer import render_banded

    calls, real = [], W.grid_search_cuda

    def keep(base, grid, table, orig, direc, t_min, max_t=None, active=None):
        calls.append(tuple(x.clone() if torch.is_tensor(x) else x
                           for x in (orig, direc, t_min, max_t, active)))
        return real(base, grid, table, orig, direc, t_min, max_t, active)

    W.grid_search_cuda = keep
    try:
        render_banded(scene, cam, opts, device=device, tracer=tracer)
    finally:
        W.grid_search_cuda = real
    torch.cuda.synchronize()
    return calls


def composed_search(tracer, o, d, t_min, mx, act):
    """What one GridTracer search computes as separate plain ops on the
    card: the dense sphere and plane search, then the plain walk and the
    merge → Hit or bool."""
    from raytracer_tpu_torch.ops import trace as TR
    from raytracer_tpu_torch.ops import walk as W

    sp, pl, g, table = (tracer._base.spheres, tracer._base.planes,
                        tracer._grid, tracer._table)
    tb, ib = W.grid_walk(g, table, o, d, t_min, mx, act)
    if mx is None:
        base = TR.dense_nearest(o, d, t_min, sp.center, sp.radius, pl.point,
                                pl.normal)
        return TR.merge_triangles(base, tb, ib)
    occ = TR.dense_occluded(o, d, mx, t_min, sp.center, sp.radius, pl.point,
                            pl.normal)
    return occ | (tb < mx)


def search_equal(got, want) -> bool:
    """Hits (kind, idx, t's bits) or occlusion bits equal on every lane."""
    import torch

    if torch.is_tensor(want):
        return torch.equal(got, want)
    return (torch.equal(got.kind, want.kind)
            and torch.equal(got.idx, want.idx)
            and torch.equal(got.t.view(torch.int32), want.t.view(torch.int32)))


def grid_search(tracer, o, d, t_min, mx, act):
    """One GridTracer search, K5's one launch on the card → Hit (`mx`
    None) or bool. The tracer's dense base holds no mesh, so no triangle
    chunk is read."""
    if mx is None:
        return tracer.nearest(o, d, t_min, None, act)
    return tracer.occluded(o, d, mx, t_min, None, act)


def kernel_phase(scene, cam, opts, tracer, device):
    """K5 (`grid_search_cuda`, what every GridTracer search launches on the
    card) over the searches of the main path's config4 frame → (max |Δt|
    against the plain composition, ms, plain ms, bound ms, bound by). Each
    search is held bit for bit to the plain composition (dense search,
    walk_init, the plain walk, the merge); each search's work is reported
    (lanes that walk, cell visits, candidates, the lane efficiency of the
    candidate loops). Times: the fused searches and the plain composition
    over the frame's searches (CUDA events), and the fused searches timed
    whole (`call_times`)."""
    import torch

    from raytracer_tpu_torch.accel.grid import walk_init
    from raytracer_tpu_torch.ops import trace as TR
    from raytracer_tpu_torch.ops import walk as W

    grid, table, base = tracer._grid, tracer._table, tracer._base
    calls = frame_searches(scene, cam, opts, tracer, device)
    assert calls and len(calls) % 3 == 0, len(calls)
    fused = [lambda c=c: W.grid_search_cuda(base, grid, table, c[0], c[1],
                                            c[2], c[3], c[4]) for c in calls]
    err = 0.0
    for k, (c, run) in enumerate(zip(calls, fused)):
        o, d, t_min, mx, act = c
        name = (f"search {k} ({'shadow' if mx is not None else 'nearest'}, "
                f"{o.shape[0]} lanes, "
                f"{o.shape[0] if act is None else int(act.sum())} active)")
        got = run()
        want = composed_search(tracer, o, d, t_min, mx, act)
        torch.cuda.synchronize()
        if mx is None:
            hit = torch.isfinite(got.t)
            if bool(hit.any()):
                err = max(err, float((got.t[hit] - want.t[hit]).abs().max()))
            what = f"{int(hit.sum())} hits"
        else:
            what = f"{int(got.sum())} occluded"
        same = search_equal(got, want)
        print(f"{name}: {what}; bit-equal to the plain composition: {same}",
              flush=True)
        assert same, f"{name}: fused != the plain composition"

    ms = cuda_ms(lambda: [f() for f in fused], 5)
    plain_ms = cuda_ms(lambda: [composed_search(tracer, *c) for c in calls],
                       1)
    whole = call_times(fused, "grid_walk_kernel")
    print(f"the fused searches timed whole: {fmt_call(whole)}", flush=True)
    if whole["device_ops"] is not None:
        assert whole["device_ops"] == len(calls), whole  # one launch a search

    # the bound: the work these searches need, the walk's counted with the
    # plain walk on the lanes the fused entry walks (active, in the grid,
    # and, for a shadow search, not occluded by a sphere or plane)
    sp, pl = base.spheres, base.planes
    ns, np_ = sp.center.shape[0], pl.point.shape[0]
    listed = int((grid.cell_soa[..., 9] != grid.n_tris).sum())
    per_launch = (listed * K5_SLOT_BYTES + ns * K5_SPHERE_BYTES
                  + np_ * K5_PLANE_BYTES + K5_BOX_BYTES
                  + grid.overflow.shape[0] * K5_SLOT_BYTES)
    ops = nbytes = 0.0
    for k, (o, d, t_min, mx, act) in enumerate(calls):
        n = o.shape[0]
        walk_act = torch.ones(n, dtype=torch.bool, device=device) \
            if act is None else act
        if mx is not None:
            walk_act = walk_act & ~TR.dense_occluded(
                o, d, mx, t_min, sp.center, sp.radius, pl.point, pl.normal)
        st = walk_init(grid, o, d, t_min, walk_act)
        stats = {}
        W.grid_walk_plain(grid, table, o, d, st, t_min, mx, stats=stats)
        n_act, walking = int(walk_act.sum()), int(st[6].sum())
        per_lane = stats.get("lane_candidates", torch.zeros(
            n, dtype=torch.int64, device=device))
        busy, slots = lane_efficiency(per_lane)
        v, c = float(stats.get("visits", 0)), float(stats.get("candidates", 0))
        ops += (n * (ns * K5_OPS["sphere"] + np_ * K5_OPS["plane"])
                + n_act * (K5_OPS["init"]
                           + grid.overflow.shape[0] * K5_OPS["candidate"])
                + K5_OPS["candidate"] * c + K5_OPS["visit"] * v)
        nbytes += per_launch + n * (
            K5_LANE_BYTES + (act is not None) * K5_MASK_BYTES
            + (K5_OCCL_BYTES if mx is not None else K5_NEAREST_BYTES))
        print(f"search {k}: {walking} of {n} lanes walk ({n_act} active), "
              f"{v:.6g} cell visits, {c:.6g} candidates; lane efficiency of "
              f"the candidate loops in the warps that walk (32 lanes in pixel "
              f"order) {busy / slots if slots else 0.0:.1%}", flush=True)
    b_ms, b_by = bound_ms(ops, nbytes)
    print(f"fused searches of the config4 {opts.width}x{opts.height} "
          f"d{opts.max_depth} frame: {len(calls)} launches over "
          f"{sum(c[0].shape[0] for c in calls)} lanes: kernel {ms:.4f} ms; "
          f"the plain composition {plain_ms:.3f} ms; {ops:.6g} ops, "
          f"{nbytes:.6g} bytes ({listed} listed triangles, {per_launch} B of tables per "
          f"launch) → bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound",
          flush=True)
    return err, ms, plain_ms, b_ms, b_by


def golden_phase(name, w, h, device, kind="auto"):
    import dataclasses

    import numpy as np

    from raytracer_tpu_torch.io.image import load_ppm
    from raytracer_tpu_torch.renderer import render_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli

    scene, cam, opts = load_scene_cli(name)
    opts = dataclasses.replace(opts, width=w, height=h)
    tracer = build_tracer(scene, kind, device)
    img, _ = render_banded(scene, cam, opts, device=device, tracer=tracer)
    got = img.cpu().numpy().astype(np.float64)
    want = load_ppm(os.path.join(GOLDEN, f"{name}_{w}x{h}.ppm"))
    diff = np.abs(got - want).max(axis=-1)
    bad = float((diff > IMG_TOL).mean())
    print(f"golden {name} {w}x{h} (tracer {kind}): {bad:.4%} pixels > "
          f"{IMG_TOL} (max {diff.max():.4f})", flush=True)
    assert bad <= IMG_BAD, f"{name}: {bad:.4%} bad pixels"


def k1_work(fw, pixels: int, stats, mode: str):
    """Operations and bytes one K1 launch in `mode` needs over `pixels`
    pixels, from the plain version's search-mode counts of this frame
    (`stats`, see ops/fused._tree; each shadow sweep stops at its first
    occluder, as the kernel's does):
    - image: the live nodes' searches, their hits' shading and child rays,
      the diffuse hits' lights and the sweeps toward the lights in front of
      them; 12 B of RGB per pixel;
    - live_plan: the same, plus the sweeps toward the lights at the tie
      ldn = 0 (the train kernel reads those bits); 8 B per live node more;
    - plan: every node's search, sweeps and child rays, Phong on the live
      diffuse nodes only; 8 B per node more."""
    ns, np_, nt, _, nl = fw.counts
    n = lambda k: float(stats.get(k, 0))
    search = (K1_OPS["sphere"] * ns + K1_OPS["plane"] * np_
              + K1_OPS["tri"] * nt)
    sweeps = lambda pre: sum(K1_OPS[kind] * n(pre + "shadow_" + k)
                             for k, kind in (("s", "sphere"), ("p", "plane"),
                                             ("t", "tri")))
    phong = n("live_diffuse") * nl * K1_OPS["phong"]
    if mode == "plan":
        nodes = float(fw.n_nodes * pixels)
        leaves = pixels * float((1 << fw.opts.max_depth) if fw.has_glass
                                else 1)
        child = K1_OPS["reflect"] + (K1_OPS["refract"] if fw.has_glass
                                     else 0)
        ops = (nodes * (search + K1_OPS["node"] + nl * K1_OPS["light_dir"])
               + sweeps("") + phong + leaves * K1_OPS["leaf"]
               + (nodes - leaves) * child)
        return pixels * K1_OPS["pixel"] + ops, 12.0 * pixels + 8.0 * nodes
    hits = n("live_s") + n("live_p") + n("live_t")
    ops = (pixels * K1_OPS["pixel"] + n("live") * search
           + hits * K1_OPS["node"] + phong + n("live_leaf") * K1_OPS["leaf"]
           + n("reflect") * K1_OPS["reflect"]
           + n("refract") * K1_OPS["refract"])
    if mode == "image":
        ops += n("live_diffuse") * nl * K1_OPS["light_dir"] + sweeps("lit_")
        return ops, 12.0 * pixels
    ops += n("live_diffuse") * nl * K1_OPS["light_dir"] + sweeps("live_")
    return ops, 12.0 * pixels + 8.0 * n("live")


def fused_case(name, device, w=0, h=0, depth=None):
    from raytracer_tpu_torch.ops import fused as F
    from raytracer_tpu_torch.utils.hostload import load_scene_cli

    scene, cam, opts = load_scene_cli(name, width=w, height=h,
                                      max_depth=depth)
    return F.FusedWhitted(scene, cam, opts, device=device), (scene, cam, opts)


def fused_compare(name, fw) -> dict:
    """The full plan vs the plain render_plan on the card, and the image
    and live-plan modes' images equal to the full plan's → {mode: max |Δ|
    of its image against the plain version's}."""
    import torch

    from raytracer_tpu_torch.ops import fused as F

    h, w, n = fw.opts.height, fw.opts.width, fw.n_nodes
    img, wins, occs = fw.render_plan()
    want, plan = F.fused_whitted_plain(fw, 0, h, emit_plan=True)
    image = fw.render()
    live = F.fused_whitted_cuda(fw, 0, h, mode="live_plan")[0]
    torch.cuda.synchronize()
    assert tuple(img.shape) == (h, w, 3) and len(wins) == len(occs) == n
    assert bool(torch.isfinite(img).all()), f"{name}: non-finite pixels"
    diff = (img - want).abs().amax(dim=-1)
    bad = float((diff > PX_TOL).float().mean())
    err = float(diff.max())
    win = max(float((a != b).float().mean()) for a, b in zip(wins, plan[:n]))
    occ = max(float((a != b).float().mean()) for a, b in zip(occs, plan[n:]))
    # torch.equal compares values: the sign of a zero does not count
    same = torch.equal(image, img), torch.equal(live, img)
    msg = (f"{name} {w}x{h} d{fw.opts.max_depth} ({n} nodes): full plan "
           f"{bad:.5%} pixels off >1/255, max |d| {err:.3g}, worst win "
           f"plane {win:.5%}, worst occ plane {occ:.5%}; image mode and live "
           f"plan equal to the full plan's image: {same[0]}, {same[1]}")
    print(msg, flush=True)
    assert bad <= PX_BAD, msg
    assert win <= ID_MAX_DIFF and occ <= ID_MAX_DIFF, msg
    assert all(same), msg
    return {"image": float((image - want).abs().max()),
            "live_plan": float((live - want).abs().max()), "plan": err}


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
    in-process → {frame: image-mode launches}."""
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
        F.launches = F.live_plan_launches = F.plan_launches = 0
        t0 = time.perf_counter()
        cli.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[tag] = F.launches
        print(f"main path: cli render {tag} --tracer fused: {dt:.4f} s wall "
              f"(image written), {F.launches} image-mode launches", flush=True)
        assert F.launches > 0, f"{tag}: the fused kernel never launched"
        assert F.live_plan_launches == F.plan_launches == 0, tag
        img = load_ppm(argv[-1])
        assert img.shape == (h, w, 3), img.shape
        assert img.std() > 0.01, f"{tag}: a flat image"
    return launches


def plan_main_path(frames):
    """`FusedWhitted.render_plan()` on the main-path frames (config2 1080p
    d2, config3 1024² d4), after a warm-up → full-plan launches."""
    import torch

    from raytracer_tpu_torch.ops import fused as F

    for fw, _ in frames.values():
        fw.render_plan()
    torch.cuda.synchronize()
    F.launches = F.live_plan_launches = F.plan_launches = 0
    for tag, (fw, _) in frames.items():
        t0 = time.perf_counter()
        img, wins, occs = fw.render_plan()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        print(f"main path: FusedWhitted.render_plan() {tag}: {dt * 1e3:.3f} "
              f"ms wall, {len(wins)} win and {len(occs)} occ planes",
              flush=True)
        assert float(img.std()) > 0.01, f"{tag}: a flat image"
    launches = F.plan_launches
    print(f"main path: {launches} full-plan launches", flush=True)
    assert launches == len(frames) and F.launches == 0, launches
    return launches


def fused_times(tag, fw, case, device):
    """Each K1 mode's time on one full frame (the mean of two readings, the
    modes timed in turn forward, then backward, so that none is always
    first), the plain version's and the wavefront's times, and the work
    each mode must do there → ({mode: (ms, ops, bytes)}, {mode: plain
    ms})."""
    import dataclasses

    import torch

    from raytracer_tpu_torch.ops import fused as F
    from raytracer_tpu_torch.renderer import render_banded

    h, w = fw.opts.height, fw.opts.width
    stats = {}
    F.fused_whitted_plain(fw, 0, h, stats=stats)
    torch.cuda.synchronize()
    reads = {mode: [] for mode in K1_MODES}
    for order in (K1_MODES, K1_MODES[::-1]):
        for mode in order:
            reads[mode].append(cuda_ms(
                lambda: F.fused_whitted_cuda(fw, 0, h, mode=mode), 5))
    res = {mode: (sum(reads[mode]) / 2, *k1_work(fw, h * w, stats, mode))
           for mode in K1_MODES}
    plain = {"image": cuda_ms(lambda: F.fused_whitted_plain(fw, 0, h), 1)}
    plain["live_plan"] = plain["plan"] = cuda_ms(
        lambda: F.fused_whitted_plain(fw, 0, h, emit_plan=True), 1)
    scene, cam, opts = case
    tile = min(h * w, 1 << 18) if scene.has_glass else h * w
    wopts = dataclasses.replace(opts, tile_rays=tile, tile_block=None)
    render_banded(scene, cam, wopts, device=device)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_banded(scene, cam, wopts, device=device)
    torch.cuda.synchronize()
    wf_ms = (time.perf_counter() - t0) * 1e3
    counts = ", ".join(f"{k} {int(v)}" for k, v in sorted(stats.items()))
    print(f"{tag} ({fw.n_nodes} nodes per pixel; {counts}):", flush=True)
    for mode in K1_MODES:
        ms, ops, nbytes = res[mode]
        b_ms, b_by = bound_ms(ops, nbytes)
        print(f"  {mode}: kernel {ms:.4f} ms (forward, backward order: "
              f"{reads[mode][0]:.4f}, {reads[mode][1]:.4f}), bound "
              f"{b_ms:.4f} ms ({b_by}: "
              f"{ops:.6g} ops, {nbytes:.6g} bytes), {b_ms / ms:.1%} of bound;"
              f" plain {plain[mode]:.3f} ms", flush=True)
    print(f"  wavefront render_banded {wf_ms:.3f} ms (tile {tile} rays, "
          "context only)", flush=True)
    return res, plain


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
    img, plan = F.fused_whitted_cuda(fw, 0, h, mode="plan")
    before = F.train_launches
    got = F.fused_train_cuda(fw, 0, h, plan, target)
    launches = F.train_launches - before
    again = F.fused_train_cuda(fw, 0, h, plan, target)
    step = fw.plan_value_and_grad(target)  # the live plan, then K2
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
    live = (torch.equal(step[0], got[0]) and torch.equal(step[2], img)
            and all(torch.equal(step[1][k], got[1][k]) for k in got[1]))
    msg = (f"{tag} ({fw.n_nodes} nodes, {launches} train launches): loss "
           f"kernel {lk:.7g}, plain {lp:.7g}, own image {own:.7g}; gradient "
           "error / table max "
           + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
           + f" (sphere radii / their max {radius:.2e}); two runs "
           f"bit-equal: {same}; the live-plan step bit-equal to the "
           f"full-plan step: {live}; plain {plain_ms:.1f} ms")
    print(msg, flush=True)
    assert all(torch.isfinite(got[1][k]).all() for k in got[1]), msg
    assert abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp), msg
    assert abs(lk - own) <= TRAIN_LOSS_RTOL * abs(own), msg
    assert max(errs.values()) <= TRAIN_GRAD_TOL, msg
    assert same and live, msg
    assert launches == len(F.grad_windows((fw.sph, fw.pln, fw.mat, fw.lgt),
                                          F.train_window(fw))), msg
    return err, plain_ms


def limit_case(name, device):
    """A param-mode fused object past the kernels' old limits and its target
    (0.9 × its own image): "spheres", 30 spheres of 345 table floats at
    256×192 d2; "config2" at 256² d40; "mirror_hall", config2 between two
    mirror planes at 256² d40, where most chains reach depth 40."""
    from raytracer_tpu_torch.models import presets
    from raytracer_tpu_torch.ops import fused as F
    from raytracer_tpu_torch.utils.hostload import load_scene_cli

    if name == "spheres":
        case = presets.many_spheres(30, 256, 192)
    elif name == "mirror_hall":
        case = presets.mirror_hall(256, 256, 40)
    else:
        case = load_scene_cli(name, width=256, height=256, max_depth=40)
    fw = F.FusedWhitted(*case, device=device, param_inputs=True)
    return fw, (fw.render() * 0.9).contiguous()


def repairs_phase(device):
    """K2 over 345 table floats (one launch), and K1 (full plan, image,
    live plan) and K2 at glass-free max_depth 40, against the plain
    versions → (K1 errors by mode, K2 error)."""
    from raytracer_tpu_torch.ops import fused as F

    fw, target = limit_case("spheres", device)
    n_grads = sum(t.numel() for t in (fw.sph, fw.pln, fw.mat, fw.lgt))
    assert n_grads == 345, n_grads
    before = F.train_launches
    F.fused_train_cuda(fw, 0, fw.opts.height,
                       F.fused_whitted_cuda(fw, 0, fw.opts.height,
                                            mode="plan")[1], target)
    launches = F.train_launches - before
    print(f"K2 launches for the {n_grads}-float scene: {launches} (window "
          f"{F.train_window(fw)} table floats)", flush=True)
    assert launches == 1, launches
    k2_err, _ = train_compare(f"30 spheres, {n_grads} table floats, 256x192 "
                              "d2", fw, target)
    k1_err = {m: 0.0 for m in K1_MODES}
    for name in ("config2", "mirror_hall"):
        fw, target = limit_case(name, device)
        for m, e in fused_compare(f"{name} d40", fw).items():
            k1_err[m] = max(k1_err[m], e)
        k2_err = max(k2_err, train_compare(f"{name} 256x256 d40", fw,
                                           target)[0])
        stats = {}
        F.fused_whitted_plain(fw, 0, 256, stats=stats)
        print(f"{name} d40: {int(stats['live'])} live nodes, "
              f"{int(stats['live_leaf'])} live hits at depth 40, of "
              f"{256 * 256} pixels", flush=True)
    return k1_err, k2_err


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
        img, plan = F.fused_whitted_cuda(fw, 0, h, mode="plan")
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
    warm-up → (live-plan launches, train launches)."""
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
    F.launches = F.live_plan_launches = F.plan_launches = 0
    F.train_launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1, k2 = F.live_plan_launches, F.train_launches
    text = buf.getvalue()
    losses = [json.loads(line)["loss"] for line in text.splitlines()
              if line.startswith('{"step"')]
    print(text, end="")
    print(f"main path: cli optimize --kernel --steps 30 (config5 128x128): "
          f"{dt:.4f} s wall, {k1} live-plan launches, {k2} train launches; "
          f"loss step 0 {losses[0]:.6g}, step 9 {losses[9]:.6g}, min "
          f"{min(losses):.6g}, step 29 {losses[-1]:.6g}", flush=True)
    assert len(losses) == 30, len(losses)
    assert losses[9] <= 0.5 * losses[0], losses
    assert k1 == 30 and k2 == 30 and F.plan_launches == 0, (k1, k2)
    img = load_ppm(out_path)
    assert img.shape == (128, 128, 3) and img.std() > 0.01, img.shape
    return k1, k2


def train_times(tag, fw, target):
    """Kernel and training-step times of one full frame (the reduction also
    alone, and the train kernel as the rest), and the work the train kernel
    must do there → (ms, step ms, ops, bytes). The step is
    `plan_value_and_grad` (the live plan, then K2); the step on the full
    plan (render_plan's K1, then K2) is timed beside it."""
    import torch

    from raytracer_tpu_torch.kernels.build import load_library
    from raytracer_tpu_torch.ops import fused as F

    h, w = fw.opts.height, fw.opts.width
    _, plan = F.fused_whitted_cuda(fw, 0, h, mode="live_plan")
    ms = cuda_ms(lambda: F.fused_train_cuda(fw, 0, h, plan, target), 5)
    # the reduction alone, on partial rows of this frame's shape
    lib = load_library()
    n_blocks = lib.rt_fused_train_blocks(w, h)
    n_out = 1 + sum(t.numel() for t in (fw.sph, fw.pln, fw.mat, fw.lgt))
    partial = torch.zeros((n_blocks, n_out), device=target.device)
    out = torch.empty((n_out,), device=target.device)
    stream = torch.cuda.current_stream(target.device).cuda_stream
    red_ms = cuda_ms(lambda: lib.rt_fused_train_reduce(
        partial.data_ptr(), n_blocks, n_out, out.data_ptr(),
        out[1:].data_ptr(), stream), 20)
    step_ms = cuda_ms(lambda: fw.plan_value_and_grad(target), 5)
    full_ms = cuda_ms(lambda: F.fused_train_cuda(
        fw, 0, h, F.fused_whitted_cuda(fw, 0, h, mode="plan")[1], target), 5)
    stats = {}  # the plain replay reads every node: the full plan
    train_plain(fw, target, F.fused_whitted_cuda(fw, 0, h, mode="plan")[1],
                stats=stats)
    ops, nbytes = train_ops(fw, h * w, stats), train_bytes(fw, h * w, stats)
    b_ms, b_by = bound_ms(ops, nbytes)
    counts = ", ".join(f"{k} {int(v)}" for k, v in sorted(stats.items()))
    print(f"{tag}: K2 {ms:.4f} ms = train kernel {ms - red_ms:.4f} ms + "
          f"reduction {red_ms:.4f} ms (timed alone over {n_blocks} partial "
          f"rows of {n_out} floats), training step (live plan + train) "
          f"{step_ms:.4f} ms, on the full plan {full_ms:.4f} ms; "
          f"bound {b_ms:.4f} ms ({b_by}: {ops:.6g} ops, {nbytes:.6g} bytes; "
          f"{counts})", flush=True)
    return ms, step_ms, ops, nbytes


def raygen_check(device):
    """raygen's pixel coordinates at 1920×1080 on the card against the
    CPU's, bit for bit; and how many whole directions differ (not held:
    tan and the normalisation may round apart)."""
    import torch

    from raytracer_tpu_torch.ops.geometry import pixel_coords, raygen

    w, h = 1920, 1080
    i0, j0 = pixel_coords(w, h, 0, h, "cpu")
    i1, j1 = pixel_coords(w, h, 0, h, device)
    di, dj = int((i1.cpu() != i0).sum()), int((j1.cpu() != j0).sum())
    c2w = torch.eye(3)
    dirs = (raygen(c2w.to(device), 60.0, w, h).cpu() != raygen(c2w, 60.0, w, h))
    half = torch.deg2rad(torch.tensor(30.0))
    tan_same = bool(torch.tan(half.to(device)).cpu() == torch.tan(half))
    print(f"raygen pixel coordinates {w}x{h}, card vs CPU: {di} of {w} "
          f"columns and {dj} of {h} rows differ; directions at fov 60: "
          f"{int(dirs.any(dim=1).sum())} of {w * h} differ (tan(30°) "
          f"equal: {tan_same})", flush=True)
    assert di == 0 and dj == 0, "pixel coordinates differ from the CPU's"


def brute_search(kind, tracer, o, d, mx, act, t_min, plain=False):
    """One K3 ("tri") or K4 ("mat") search of a ray set, by the kernel's
    wrapper or its plain version: nearest when `mx` is None (→ (t, idx)),
    else any-hit below `mx` (→ bool)."""
    from raytracer_tpu_torch.ops import mat_trace as MT
    from raytracer_tpu_torch.ops import pallas_trace as PT

    sfx = "_plain" if plain else "_cuda"
    if kind == "tri":
        if mx is None:
            return getattr(PT, "tri_nearest" + sfx)(o, d, tracer._tri, t_min,
                                                     act)
        return getattr(PT, "tri_occluded" + sfx)(o, d, mx, tracer._tri,
                                                  t_min, act)
    f = MT.ray_features(o, d, tracer._center)
    table = () if plain else (tracer._table,)
    if mx is None:
        return getattr(MT, "mat_nearest" + sfx)(f, tracer._w, t_min, MT.BT,
                                                 act, *table)
    return getattr(MT, "mat_occluded" + sfx)(f, mx, tracer._w, t_min, MT.BT,
                                              act, *table)


def compare_cross(name, ref, got):
    """Nearest hits of two tracers, one of them K4, whose search t
    reassociates MT's arithmetic: hit/miss flips and differing winners on
    ≤CROSS_MAX of rays each (knife edges); where both hit the same
    triangle, t at rtol 2e-6."""
    import torch

    (t0, i0), (t1, i1) = ref, got
    fin0, fin1 = torch.isfinite(t0), torch.isfinite(t1)
    both = fin0 & fin1
    same = both & (i0 == i1)
    flips = int((fin0 != fin1).sum())
    ids = int((both & (i0 != i1)).sum())
    dt = (t1[same] - t0[same]).abs() / t0[same].abs().clamp(min=1e-30)
    rel = float(dt.max()) if dt.numel() else 0.0
    n = t0.shape[0]
    msg = (f"{name}: {n} rays, hit/miss flips {flips}, other winner on "
           f"{ids} hits, max rel dt on the same winner {rel:.3g}")
    print(msg, flush=True)
    assert flips <= CROSS_MAX * n and ids <= CROSS_MAX * n, msg
    assert rel <= T_RTOL, msg


def brute_phase(scene, cam, opts, grid_tracer, device):
    """K3 and K4 vs their plain versions on config4's ray sets at 1920×1080
    (walk_ray_sets, with their masks, and primary-occl6), against each other
    and against the grid walk → {kind: {mode: kernel vs plain: max |Δt|
    on hits (nearest), lanes that differ (any-hit)}}."""
    import torch

    from raytracer_tpu_torch.ops import walk as W
    from raytracer_tpu_torch.ops.mat_trace import MatTracer
    from raytracer_tpu_torch.ops.pallas_trace import PallasTracer

    t_start = time.perf_counter()
    tracers = {"tri": PallasTracer(scene, device),
               "mat": MatTracer(scene, device)}
    sets = walk_ray_sets(scene, cam, opts, grid_tracer, device)
    sets.append(("primary-occl6", sets[0][1], sets[0][2],
                 torch.full_like(sets[0][1][:, 0], 6.0), None))
    err = {k: {"nearest": 0.0, "occluded": 0.0} for k in tracers}
    grid, table = grid_tracer._grid, grid_tracer._table
    for name, o, d, mx, act in sets:
        o, d = o.contiguous(), d.contiguous()
        walk = W.grid_walk(grid, table, o, d, opts.t_min, mx, act)
        lanes = o.shape[0] if act is None else int(act.sum())
        got = {}
        for kind, tr in tracers.items():
            k = brute_search(kind, tr, o, d, mx, act, opts.t_min)
            p = brute_search(kind, tr, o, d, mx, act, opts.t_min, plain=True)
            torch.cuda.synchronize()
            tag = f"{name} ({lanes} live lanes) {kind} kernel vs plain"
            if mx is None:
                e = compare_walks(tag, p, k)
                err[kind]["nearest"] = max(err[kind]["nearest"], e)
                same = torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
                print(f"  bit-equal: {same}", flush=True)
                # K3 and K4 compute every quantity in their plain versions'
                # order (csrc/tri_trace.cu, csrc/mat_trace.cu): bit for bit
                assert same, f"{tag}: not bit-equal"
                if act is not None:
                    assert bool(torch.isinf(k[0][~act]).all()), tag
                    assert bool((k[1][~act] == 0).all()), tag
            else:
                diffs = int((k != p).sum())
                print(f"{tag}: {int(p.sum())} occluded, {diffs} differ",
                      flush=True)
                err[kind]["occluded"] = max(err[kind]["occluded"],
                                            float(diffs))
                assert diffs == 0, tag
                if act is not None:
                    assert not bool(k[~act].any()), f"{tag}: masked lane hit"
            got[kind] = k
        if mx is None:  # the three tracers against each other, hits' ids
            tw, iw = walk
            walk_hits = (tw, torch.where(torch.isfinite(tw), iw, 0))
            compare_walks(f"{name} tri kernel vs grid walk", walk_hits,
                          got["tri"])
            fin = tracers["mat"]._finalize(o, d, *got["mat"], opts.t_min)
            compare_cross(f"{name} mat (finalized) vs tri", got["tri"],
                          (fin, got["mat"][1]))
            compare_cross(f"{name} mat (finalized) vs walk", walk_hits,
                          (fin, got["mat"][1]))
        else:
            occ_w = walk[0] < mx
            d_tri = int((got["tri"] != occ_w).sum())
            d_mat = int((got["mat"] != occ_w).sum())
            msg = (f"{name} occlusion vs grid walk: tri {d_tri}, mat "
                   f"{d_mat} differ of {o.shape[0]}")
            print(msg, flush=True)
            assert d_tri == 0 and d_mat <= CROSS_MAX * o.shape[0], msg
    print(f"brute-force comparison phase: {time.perf_counter() - t_start:.1f} "
          "s", flush=True)
    return err


@contextlib.contextmanager
def recording(mod, names):
    """Record the arguments of every call of `mod`'s kernel wrappers
    `names` (as the dispatchers call them), to replay a frame's launches."""
    calls = {n: [] for n in names}
    saved = {n: getattr(mod, n) for n in names}

    def recorder(n):
        def call(*args):
            calls[n].append(args)
            return saved[n](*args)
        return call

    for n in names:
        setattr(mod, n, recorder(n))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(mod, n, fn)


def brute_main_path(grid_img):
    """`cli render --config config4 --tracer pallas|mat` at 1920×1080, depth
    4, in-process, after a warm-up whose kernel launches are recorded; each
    image against the grid path's frame → ({kind: (nearest launches, any-hit
    launches)}, {kind: recorded calls})."""
    import importlib

    import numpy as np
    import torch

    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.io.image import load_ppm, to_u8

    os.makedirs(OUT, exist_ok=True)
    want = to_u8(grid_img) / 255.0
    launches, calls = {}, {}
    for kind, cli_kind in (("tri", "pallas"), ("mat", "mat")):
        mod = importlib.import_module(BRUTE[kind][0])
        near, occ = BRUTE[kind][1] + "_cuda", BRUTE[kind][2] + "_cuda"
        out = os.path.join(OUT, f"config4_{cli_kind}.ppm")
        argv = ["render", "--config", "config4", "--tracer", cli_kind,
                "--out", out]
        with recording(mod, (near, occ)) as rec, \
                contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv)  # warm-up
        torch.cuda.synchronize()
        os.remove(out)
        buf = io.StringIO()
        mod.launches = mod.occluded_launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[kind] = (mod.launches, mod.occluded_launches)
        text = buf.getvalue()
        print(text, end="")
        rays = float(re.search(r"— (\S+) rays", text).group(1))
        got = load_ppm(out)
        assert got.shape == want.shape, got.shape
        bad_px = int((np.abs(got - want).max(axis=-1) > IMG_TOL).sum())
        bad = bad_px / (got.shape[0] * got.shape[1])
        msg = (f"main path: cli render config4 1920x1080 d4 --tracer "
               f"{cli_kind}: {dt:.4f} s wall (image written), {rays:.6g} "
               f"rays, {rays / dt:.6g} rays/s; {launches[kind][0]} nearest, "
               f"{launches[kind][1]} any-hit launches; vs the grid path's "
               f"frame {bad_px} pixels ({bad:.4%}) off by > {IMG_TOL}")
        print(msg, flush=True)
        assert min(launches[kind]) > 0, f"{msg}: a kernel never launched"
        assert bad <= IMG_BAD, msg
        calls[kind] = rec
    return launches, calls


def brute_times(kind, calls):
    """Kernel and plain times over one frame's recorded launches, and the
    bound from the work they need → {mode: (ms, plain ms, bound ms, by)}."""
    import importlib

    mod = importlib.import_module(BRUTE[kind][0])
    res = {}
    lanes_per_s = instruction_rate()
    for mode, name in (("nearest", BRUTE[kind][1]),
                       ("occluded", BRUTE[kind][2])):
        args = calls[name + "_cuda"]
        kern, plain = getattr(mod, name + "_cuda"), getattr(mod, name + "_plain")
        # the plain versions take the wrappers' arguments up to `active`
        # (the mat wrappers add the packed table after it)
        n_plain = 5 + (mode == "occluded")
        ms = cuda_ms(lambda: [kern(*a) for a in args], 3)
        plain_ms = cuda_ms(lambda: [plain(*a[:n_plain]) for a in args], 1,
                           warmup=False)
        tests = nbytes = lanes = 0
        stats = {}
        for a in args:  # the table: 3rd (tri) / 4th (mat) plain arg from last
            table = a[n_plain - (3 if kind == "tri" else 4)]
            act = a[n_plain - 1]
            n = a[0].shape[0]
            tp = table.shape[1] // (1 if kind == "tri" else 4)
            live = n if act is None else int(act.sum())
            lanes += live
            if mode == "nearest":
                tests += live * tp
            else:
                plain(*a[:n_plain], stats=stats)
            nbytes += table.numel() * 4 + n * (
                BRUTE_RAY_IN[kind] + BRUTE_OUT[mode] + (act is not None))
        tests = stats.get("tests", tests)
        ops = BRUTE_OPS[kind] * float(tests)
        b_ms, b_by = bound_ms(ops, nbytes)
        # without multiply-add contraction each operation is an instruction
        ceiling = ops / lanes_per_s * 1e3
        if kind == "tri":  # the same tests, counted through the stages
            assert tri_stage_shares(name, mode, args) == tests, tests
        print(f"{name}: {len(args)} launches of one config4 1080p d4 frame, "
              f"{lanes} live lanes, {tests:.6g} ray-triangle tests: kernel "
              f"{ms:.3f} ms, plain {plain_ms:.1f} ms; {ops:.6g} ops, "
              f"{nbytes:.6g} bytes → bound {b_ms:.4f} ms ({b_by}); "
              f"--fmad=false instruction ceiling {ceiling:.4f} ms (one fp32 "
              f"instruction per operation at {lanes_per_s:.6g} lanes/s)",
              flush=True)
        res[mode] = (ms, plain_ms, b_ms, b_by)
    return res


def tri_stage_shares(name, mode, args):
    """The shares of K3's ray–triangle tests over a frame's recorded calls
    that pass each of the kernel's stages (ops/pallas_trace.tri_stages):
    |det| > eps, u's tests, and into the reciprocal and the epilogue. An
    any-hit ray's tests are counted up to its first occluder, the work the
    function needs (the kernel finishes the tile) → the number of tests."""
    import torch

    from raytracer_tpu_torch.ops import pallas_trace as PT

    counts = torch.zeros(4, dtype=torch.float64, device=args[0][0].device)
    for a in args:
        (o, d, tri, t_min, act), mx = ((a, None) if mode == "nearest" else
                                       ((*a[:2], *a[3:]), a[2]))
        for lanes in PT.lane_chunks(o.shape[0], act, PT._RAY_CHUNK, o.device):
            oo, dd = o[lanes], d[lanes]
            left = None if mx is None else torch.ones_like(mx[lanes],
                                                           dtype=torch.bool)
            for _, v0, e1, e2 in PT._tri_chunks(tri):
                stages = PT.tri_stages(oo, dd, v0, e1, e2, t_min,
                                       mx is not None)
                *masks, ts = stages
                if mx is None:
                    run = torch.ones_like(masks[0])
                else:  # tests up to and with the first occluder
                    below = ts < mx[lanes][:, None]
                    col = torch.arange(ts.shape[1], device=ts.device)
                    first = torch.where(below.any(dim=1),
                                        below.to(torch.int32).argmax(dim=1),
                                        ts.shape[1])
                    run = left[:, None] & (col[None, :] <= first[:, None])
                    left = left & ~below.any(dim=1)
                counts += torch.stack([run.sum(dtype=torch.float64)] + [
                    (m & run).sum(dtype=torch.float64) for m in masks])
    tests, *passed = counts.tolist()
    print(f"{name}: stages of its {tests:.6g} ray-triangle tests: past det "
          f"{passed[0] / tests:.4%}, past u {passed[1] / tests:.4%}, into "
          f"the reciprocal {passed[2] / tests:.4%}", flush=True)
    return tests


# wavefront training (config4 fwd+bwd): the replay against the grid frame,
# the replay step against autograd through the wavefront (remat off), and
# two runs against each other (tests/test_replay.py's mesh standard)
REPLAY_IMG_TOL = 2e-5
VG_LOSS_RTOL, VG_GRAD_TOL = 1e-5, 2e-4  # loss; × each gradient's max
RERUN_GRAD_TOL = 1e-6                   # × each gradient's max
TRAIN_STEPS = 5                         # timed steps after a warm-up
FRAMES = 5                              # timed config4 forward frames


def with_params(scene, p):
    """The config5 parameter classes (sphere centers, material albedos)
    grafted into a scene: the reference bench's `_with_params`."""
    import dataclasses

    return scene.replace(
        spheres=dataclasses.replace(scene.spheres, center=p["center"]),
        materials=dataclasses.replace(scene.materials, albedo=p["albedo"]))


def waveplan_record(dscene, cam, opts, tracer, device):
    """The step's first part: the grid-walked render records the plan
    under no_grad → (image, traced rays, (wins, occs))."""
    import torch

    from raytracer_tpu_torch.renderer import render

    with torch.no_grad():
        img, traced, wins, occs = render(dscene, cam, opts, device=device,
                                         tracer=tracer, count_rays=True,
                                         record_plan=True)
    return img, traced, (wins, occs)


def waveplan_vg(p0, dscene, cam, opts, target, plan, device):
    """The step's second part: autograd over the shading replay."""
    from raytracer_tpu_torch.ops.replay import replay_band_vg

    return replay_band_vg(p0, dscene, cam, target, plan, 0,
                          apply_params=with_params, opts=opts,
                          rb=opts.height, device=device)


def max_rel(a, b):
    """max |a − b| over max |b|, per gradient table → the worst."""
    return max(float((a[k] - b[k]).abs().max())
               / max(float(b[k].abs().max()), 1e-30) for k in b)


def step_times(dscene, cam, opts, tracer, target, p0, device):
    """Mean device ms per step over TRAIN_STEPS steps (CUDA events), split
    into the recording render and the replay value-and-grad → (record ms,
    vg ms, traced rays per step)."""
    import torch

    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
          for _ in range(TRAIN_STEPS)]
    traced = None
    for e in ev:
        e[0].record()
        _, traced, plan = waveplan_record(dscene, cam, opts, tracer, device)
        e[1].record()
        waveplan_vg(p0, dscene, cam, opts, target, plan, device)
        e[2].record()
    torch.cuda.synchronize()
    rec = sum(e[0].elapsed_time(e[1]) for e in ev) / TRAIN_STEPS
    vg = sum(e[1].elapsed_time(e[2]) for e in ev) / TRAIN_STEPS
    return rec, vg, float(traced)


def waveplan_phase(scene, cam, opts, tracer, frame, device):
    """config4 1080p d4 fwd+bwd through the wavefront planner (the
    reference bench's `_phase_bwd_waveplan`): the grid walk (K5) records the
    plan under no_grad, autograd differentiates only the shading replay for
    the sphere centers and material albedos, target = grid frame × 0.9.
    → K5 launches per step."""
    import torch

    from raytracer_tpu_torch.ops.replay import replay_render
    from raytracer_tpu_torch.renderer import value_and_grad_banded

    print(card_line(), flush=True)
    dscene = scene.to(device)
    target = frame * 0.9
    p0 = {"center": dscene.spheres.center, "albedo": dscene.materials.albedo}
    n3 = opts.width * opts.height * 3

    # warm-up, then one step with the walk's launches counted
    _, _, plan = waveplan_record(dscene, cam, opts, tracer, device)
    waveplan_vg(p0, dscene, cam, opts, target, plan, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k5_reset()
    t0 = time.perf_counter()
    img, traced, plan = waveplan_record(dscene, cam, opts, tracer, device)
    loss, grads = waveplan_vg(p0, dscene, cam, opts, target, plan, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5 = k5_searches("config4 1080p d4 fwd+bwd step")
    peak = torch.cuda.max_memory_allocated() / 2**20
    plan_bytes = sum(x.numel() * x.element_size() for planes in plan
                     for x in planes)
    assert k5 > 0, "the training step never launched the walk kernel"

    # where the step's time goes
    rec, vg, rays = step_times(dscene, cam, opts, tracer, target, p0, device)
    step_ms = rec + vg
    print(f"config4 {opts.width}x{opts.height} d{opts.max_depth} fwd+bwd "
          f"(wavefront-planner replay; center {tuple(p0['center'].shape)}, "
          f"albedo {tuple(p0['albedo'].shape)}): step {step_ms:.3f} ms = "
          f"record {rec:.3f} + replay vg {vg:.3f} (CUDA events, mean of "
          f"{TRAIN_STEPS} after a warm-up); one step {wall:.4f} s wall; "
          f"{k5} walk launches per step; {rays:.6g} traced rays per step, "
          f"{rays / (step_ms / 1e3):.6g} fwd+bwd rays/s; peak "
          f"{peak:.1f} MiB; plan {plan_bytes} bytes ({len(plan[0])} "
          f"bounces × 2 planes)", flush=True)

    # the replay's image is the grid frame's
    with torch.no_grad():
        rimg = replay_render(dscene, cam, opts, plan, device=device)[0]
    d_img = float((rimg - frame).abs().max())
    print(f"replay image vs the grid frame: max |d| {d_img:.3g} (limit "
          f"{REPLAY_IMG_TOL})", flush=True)
    assert d_img <= REPLAY_IMG_TOL, d_img

    # against autograd through the wavefront with the walks in the graph's
    # forward (remat off: the reference's plain jax.value_and_grad)
    import dataclasses

    plain = dataclasses.replace(opts, remat_tiles=False)
    v_ref, g_ref = value_and_grad_banded(with_params, p0, dscene, cam, plain,
                                         target, device=device, tracer=tracer)
    d_loss = abs(float(loss) - float(v_ref)) / abs(float(v_ref))
    d_grad = max_rel(grads, g_ref)
    print(f"replay step vs value_and_grad_banded (remat off): loss "
          f"{float(loss):.9g} vs {float(v_ref):.9g} (rel {d_loss:.3g}, limit "
          f"{VG_LOSS_RTOL}), gradients within {d_grad:.3g} of each max "
          f"(limit {VG_GRAD_TOL})", flush=True)
    assert d_loss <= VG_LOSS_RTOL and d_grad <= VG_GRAD_TOL, (d_loss, d_grad)
    del g_ref

    # two runs
    _, _, plan2 = waveplan_record(dscene, cam, opts, tracer, device)
    loss2, grads2 = waveplan_vg(p0, dscene, cam, opts, target, plan2, device)
    same_plan = all(torch.equal(a, b) for x, y in zip(plan, plan2)
                    for a, b in zip(x, y))
    d_rerun = max_rel(grads2, grads)
    print(f"two runs: plans equal {same_plan}, losses {float(loss):.9g} and "
          f"{float(loss2):.9g}, gradients within {d_rerun:.3g} of each max "
          f"(limit {RERUN_GRAD_TOL})", flush=True)
    assert float(loss2) == float(loss) and d_rerun <= RERUN_GRAD_TOL
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads.values())
    print(f"loss {float(loss):.6g} (= Σ/{n3}), |d center| max "
          f"{float(grads['center'].abs().max()):.6g}, |d albedo| max "
          f"{float(grads['albedo'].abs().max()):.6g}", flush=True)
    return k5


def profile_step():
    """One config4 1080p d4 training step under torch.profiler, in a
    process of its own (a second profiler session in one process read no
    device time): prints the device busy time and the top ops by their own
    device time."""
    import tempfile

    import torch

    from raytracer_tpu_torch.renderer import render
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli
    from raytracer_tpu_torch.utils.profiling import top_ops, xprof_trace

    device = torch.device("cuda", 0)
    scene, cam, opts = load_scene_cli("config4")
    tracer = build_tracer(scene, "auto", device)
    dscene = scene.to(device)
    with torch.no_grad():
        target = render(dscene, cam, opts, device=device,
                        tracer=tracer)[0] * 0.9
    p0 = {"center": dscene.spheres.center, "albedo": dscene.materials.albedo}

    def step():
        _, _, plan = waveplan_record(dscene, cam, opts, tracer, device)
        waveplan_vg(p0, dscene, cam, opts, target, plan, device)
        torch.cuda.synchronize()

    step()
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT) as d:
        with xprof_trace(d, device=device) as prof:
            t0 = time.perf_counter()
            step()
            wall = (time.perf_counter() - t0) * 1e3
        kernels = top_ops(d, k=ALL_OPS)
    # device busy: the kernels' own times (an op's device time is its
    # kernels', so ops and kernels are not summed together)
    busy = sum(secs for _, secs, _ in kernels) * 1e3
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")), key=dev, reverse=True)
    print(f"profiled step: {wall:.1f} ms wall (profiler on), "
          f"{sum(n for _, _, n in kernels)} kernels, device busy "
          f"{busy:.1f} ms; top ops by own device time:")
    for e in ops[:12]:
        print(f"  {e.key}: {dev(e) / 1e3:.3f} ms in {e.count} calls")


def profile_phase():
    out = subprocess.run(
        [sys.executable, "-c", "import chip_smoke; chip_smoke.profile_step()"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    print(out.stdout, end="", flush=True)
    assert out.returncode == 0, out.stderr[-4000:]


def edge_mask(*imgs, thresh=0.02):
    """Pixels ≥2 px from any edge in all the images (tests/test_grads.py's
    `_interior_mask`): central differences flip pixels at silhouettes and
    shadow edges, where autograd's gradient is zero by design."""
    import numpy as np

    mask = np.ones(imgs[0].shape[:2], bool)
    for img in imgs:
        a = img.max(axis=-1)
        edge = np.zeros_like(a, bool)
        d = np.abs(np.diff(a, axis=0)) > thresh
        edge[:-1] |= d
        edge[1:] |= d
        d = np.abs(np.diff(a, axis=1)) > thresh
        edge[:, :-1] |= d
        edge[:, 1:] |= d
        for _ in range(2):  # dilate
            e2 = edge.copy()
            e2[:-1] |= edge[1:]
            e2[1:] |= edge[:-1]
            e2[:, :-1] |= edge[:, 1:]
            e2[:, 1:] |= edge[:, :-1]
            edge = e2
        mask &= ~edge
    assert mask.mean() > 0.3, "the edge mask ate the image"
    return mask


def waveplan_fd(device):
    """Central differences of the masked pixel loss Σ mask·(img − target)²
    (float64 on the host) against the replay's autograd gradient, at config4
    256×144 d4 with the grid walk, for 2 sphere-center and 2 albedo
    coordinates."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops.replay import replay_render
    from raytracer_tpu_torch.renderer import as_leaf, render
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli

    scene, cam, opts = load_scene_cli("config4", width=256, height=144)
    tracer = build_tracer(scene, "auto", device)
    dscene = scene.to(device)
    base = {"center": dscene.spheres.center.clone(),
            "albedo": dscene.materials.albedo.clone()}
    with torch.no_grad():
        img0 = render(dscene, cam, opts, device=device, tracer=tracer)[0]
        target = (img0 * 0.9).double()
    mask = torch.from_numpy(edge_mask(img0.cpu().numpy(),
                                      target.cpu().numpy())).to(device)

    def loss64(params):
        with torch.no_grad():
            img = render(with_params(dscene, params), cam, opts,
                         device=device, tracer=tracer)[0].double()
        return float((((img - target) ** 2).sum(-1) * mask).sum())

    _, _, plan = waveplan_record(dscene, cam, opts, tracer, device)
    leaves = {k: as_leaf(v, device) for k, v in base.items()}
    with torch.enable_grad():
        img = replay_render(with_params(dscene, leaves), cam, opts, plan,
                            device=device)[0]
        loss = (((img - target.float()) ** 2).sum(-1) * mask).sum()
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
    for key, (i, k) in (("center", (0, 0)), ("center", (0, 1)),
                        ("albedo", (0, 0)), ("albedo", (2, 1))):
        hi = {a: v.clone() for a, v in base.items()}
        lo = {a: v.clone() for a, v in base.items()}
        hi[key][i, k] += FD_EPS
        lo[key][i, k] -= FD_EPS
        fd = (loss64(hi) - loss64(lo)) / (2 * FD_EPS)
        got = float(grads[key][i, k])
        msg = (f"config4 256x144 d4: d loss / d {key}[{i}, {k}]: replay "
               f"autograd {got:.6g}, central difference {fd:.6g} "
               f"({int((~mask).sum())} edge pixels masked)")
        print(msg, flush=True)
        assert np.isfinite(got) and abs(got - fd) <= 0.05 * abs(fd) + 2e-3, msg


def fused_replay_phase(frame2, device):
    """K1's full plan replays to K1's image: config2 1080p d2 (`frame2`, the
    main path's (FusedWhitted, (scene, camera, opts))) and config3 256² d4
    (glass: the node planes concatenated per bounce)."""
    import torch

    from raytracer_tpu_torch.ops.replay import replay_render

    for name, (fw, (scene, cam, opts)) in (
            ("config2", frame2),
            ("config3", fused_case("config3", device, 256, 256, 4))):
        tag = f"{name} {opts.width}x{opts.height} d{opts.max_depth}"
        img, wins, occs = fw.render_plan()
        with torch.no_grad():
            rimg = replay_render(scene, cam, opts, (wins, occs),
                                 device=device)[0]
        diff = (rimg - img).abs().amax(dim=-1)
        bad = float((diff > PX_TOL).float().mean())
        msg = (f"{tag}: replay of K1's full plan ({len(wins)} node planes) "
               f"vs K1's image: {bad:.5%} pixels off >1/255 (limit "
               f"{PX_BAD:.1%}), max |d| {float(diff.max()):.3g}")
        print(msg, flush=True)
        assert bad <= PX_BAD, msg


def cli_losses(argv):
    """`cli.main(argv)` in-process → (losses, stdout, wall s)."""
    import torch

    from raytracer_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    text = buf.getvalue()
    return ([json.loads(line)["loss"] for line in text.splitlines()
             if line.startswith('{"step"')], text, dt)


def trainers_main_path():
    """`cli optimize` without a flag, `--plan` (config5 128²) and
    `--preset mesh` (config6 96²), 30 steps each after a 2-step warm-up →
    full-plan launches of `--plan`."""

    from raytracer_tpu_torch.ops import fused as F

    os.makedirs(OUT, exist_ok=True)
    runs = {}
    for tag, flags in (("autograd", []), ("plan", ["--plan"]),
                       ("mesh", ["--preset", "mesh"])):
        argv = ["optimize", *flags, "--log-every", "1", "--out",
                os.path.join(OUT, f"optimize_{tag}.ppm")]
        cli_losses(argv + ["--steps", "2"])  # warm-up
        F.launches = F.live_plan_launches = F.plan_launches = 0
        losses, text, dt = cli_losses(argv + ["--steps", "30"])
        runs[tag] = (losses, text, dt, F.plan_launches)
        print(f"main path: cli optimize {' '.join(flags) or '(no flag)'} "
              f"--steps 30: {dt:.4f} s wall; loss step 0 {losses[0]:.9g}, "
              f"step 9 {losses[9]:.6g}, step 29 {losses[-1]:.6g}; "
              f"{F.plan_launches} full-plan launches", flush=True)
        assert len(losses) == 30, (tag, len(losses))
    losses = runs["autograd"][0]
    assert losses[9] <= 0.5 * losses[0], losses
    plan_losses, _, _, plan_launches = runs["plan"]
    d0 = abs(plan_losses[0] - losses[0]) / losses[0]
    print(f"--plan step-0 loss vs the unflagged: rel {d0:.3g} (limit 1e-5)",
          flush=True)
    assert d0 <= 1e-5, d0
    assert plan_launches > 0, "optimize --plan never launched K1's full plan"
    mesh_losses, text, _, _ = runs["mesh"]
    vis = [float(m) for m in re.findall(r"visible (\d+\.\d+)", text)]
    print(f"--preset mesh: visible-vertex L1 {vis[0]} → {vis[1]}",
          flush=True)
    assert mesh_losses[-1] < mesh_losses[0], mesh_losses
    assert len(vis) == 2 and vis[1] < vis[0], vis
    return plan_launches


# glass compaction (config3 1024² d4 at the shipping cap) and the BVH walk
COMPACT_CAP = 0.5
COMPACT_ATOL = 1e-5   # against the uncompacted frame (tests/test_compact.py)
REF_TILE = 16384      # the reference's config3 tile, 64 strided tiles
GLASS_STEPS = 3       # timed glass fwd+bwd steps after a warm-up
# the glass step's cap: the plan-alive share of the band that holds the
# spheres (rows 512–767) reaches 0.54 at its first glass bounce, so 4 bands
# at cap 0.5 drop lanes there; cap 1 is exact for every band
GLASS_CAP = 1.0
# BVH walk operations: Möller–Trumbore per tested triangle (the walk's); per
# node step the slab test: 6 sub, 6 mul, 6 per-axis min/max, 3 max and 2
# min over the axes (csrc/bvh_walk.cu)
BVH_OPS = {"test": 46, "step": 23}
# bytes per launch, counted as the culled sweep's are: the tables once, per
# node its two 16-byte rows, its lowest id and its 8 octants' links (8 bytes
# each), per triangle its 40 bytes (v0|e1|e2|id); per live lane orig + dir
# in (24) and, any-hit, max_t (4); per lane t + idx out (8) and the mask
# byte where given. BVH_OLD_RAY_BYTES: the first count, which charged
# orig + dir + t + idx to every lane (printed beside the new bound).
BVH_NODE_BYTES, BVH_TRI_BYTES = 32 + 4 + 64, 40
BVH_LIVE_BYTES = {"nearest": 24, "occluded": 28}
BVH_LANE_BYTES, BVH_OLD_RAY_BYTES = 8, 32


def frame_times(fn, n=FRAMES):
    """Host seconds of `n` runs of `fn()`, each ended by a synchronize,
    after a warm-up → (median, all, peak MiB of the timed runs)."""
    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (sorted(times)[n // 2], times,
            torch.cuda.max_memory_allocated() / 2**20)


def compact_phase(device):
    """C1: config3 1024² d4 through the wavefront with compacted lanes.
    The main path `cli render --config config3 --compact 0.5` (grid walk K5
    on the Cornell walls); then render_banded compacted against the
    uncompacted frame (≤ COMPACT_ATOL), against K1's image (the fused
    standard) and against itself (two runs bit-equal); frame times at the
    preset's strided tiles and at one tile per frame, compacted and not.
    → (K5 launches of the main path, the compacted frame)."""
    import dataclasses

    import torch

    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.io.image import load_ppm, to_u8
    from raytracer_tpu_torch.ops import fused as F
    from raytracer_tpu_torch.renderer import render_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli

    print(card_line(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    out = os.path.join(OUT, "config3_compact.ppm")
    argv = ["render", "--config", "config3", "--compact", str(COMPACT_CAP),
            "--out", out]
    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)  # warm-up
    torch.cuda.synchronize()
    buf = io.StringIO()
    k5_reset()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k5 = k5_searches("cli render --config config3 --compact")
    text = buf.getvalue()
    print(text, end="")
    rays = float(re.search(r"— (\S+) rays", text).group(1))
    print(f"main path: cli render --config config3 --compact {COMPACT_CAP}: "
          f"{wall:.4f} s wall (tracer build and image write included), "
          f"{rays:.6g} rays, {k5} walk launches", flush=True)
    assert k5 > 0, "the compacted config3 frame never launched the walk"
    assert "WARNING" not in text, text

    scene, cam, opts = load_scene_cli("config3")
    tracer = build_tracer(scene, "auto", device)
    oc = dataclasses.replace(opts, compact_cap=COMPACT_CAP)
    img, traced, dropped = render_banded(scene, cam, oc, device=device,
                                         tracer=tracer, count_rays=True)
    full, f_traced = render_banded(scene, cam, opts, device=device,
                                   tracer=tracer, count_rays=True)
    again = render_banded(scene, cam, oc, device=device, tracer=tracer)[0]
    k1 = F.FusedWhitted(scene, cam, opts, device=device).render()
    torch.cuda.synchronize()
    d_full = float((img - full).abs().max())
    diff = (img - k1).abs().amax(dim=-1)
    bad = float((diff > PX_TOL).float().mean())
    cli_img = load_ppm(out)
    msg = (f"config3 {opts.width}x{opts.height} d{opts.max_depth} cap "
           f"{COMPACT_CAP}: dropped {float(dropped):.0f}; vs the uncompacted "
           f"frame max |d| {d_full:.3g} (limit {COMPACT_ATOL}), traced "
           f"{float(traced):.6g} vs {float(f_traced):.6g}; vs K1's image "
           f"{bad:.5%} pixels off >1/255 (limit {PX_BAD:.1%}); two runs "
           f"bit-equal {torch.equal(img, again)}; CLI image = frame "
           f"{bool((abs(cli_img - to_u8(img) / 255.0) < 1e-6).all())}")
    print(msg, flush=True)
    assert float(dropped) == 0.0, msg
    assert d_full <= COMPACT_ATOL, msg
    assert bad <= PX_BAD, msg
    assert torch.equal(img, again), msg
    assert float(traced) == float(f_traced), msg

    one = opts.width * opts.height
    for tile in (REF_TILE, one):
        for cap in (COMPACT_CAP, None):
            o = dataclasses.replace(opts, compact_cap=cap, tile_rays=tile)
            k5_reset()
            med, runs, peak = frame_times(lambda: render_banded(
                scene, cam, o, device=device, tracer=tracer,
                count_rays=True))
            per = k5_searches("config3 compacted frames") // (len(runs) + 1)
            res = render_banded(scene, cam, o, device=device, tracer=tracer,
                                count_rays=True)
            same = torch.equal(res[0], img)
            print(f"config3 {opts.width}x{opts.height} d{opts.max_depth}, "
                  f"tile {tile} "
                  f"({-(-one // tile)} tiles), compact "
                  f"{cap if cap else 'off'}: {med:.4f} s (median of "
                  f"{len(runs)} frames; {', '.join(f'{t:.4f}' for t in runs)}), "
                  f"{float(res[1]):.6g} traced rays, {per} walk launches, "
                  f"peak {peak:.1f} MiB; image = the compacted frame: {same}",
                  flush=True)
            assert same, (tile, cap)
    return k5, img


def glass_step_phase(frame3, device):
    """C2: config3 1024² d4 fwd+bwd through the plan-compacted replay: K1's
    full plan per band (`FusedWhitted.bind` → `render_plan`), autograd over
    the compacted shading replay (`value_and_grad_replay`, GLASS_CAP, bands
    of max(64, H/4) rows) for the sphere centers and material albedos,
    target = the compacted frame × 0.9. Against the uncompacted replay, the
    replay image against K1's, two runs; step time split into plan and
    replay vg. Then the shipping cap 0.5 in 4 bands (drops, reported) and
    in one band. → K1 full-plan launches of one step."""
    import dataclasses

    import torch

    from raytracer_tpu_torch.ops import fused as F
    from raytracer_tpu_torch.ops.replay import (replay_band_vg,
                                                replay_render,
                                                value_and_grad_replay)
    from raytracer_tpu_torch.utils.hostload import load_scene_cli

    print(card_line(), flush=True)
    scene, cam, opts = load_scene_cli("config3")
    oc = dataclasses.replace(opts, compact_cap=GLASS_CAP)
    dscene = scene.to(device)
    fw = F.FusedWhitted(scene, cam, oc, device=device, param_inputs=True)
    p0 = {"center": dscene.spheres.center, "albedo": dscene.materials.albedo}
    target = frame3 * 0.9
    band_rows = max(64, opts.height // 4)

    def builder(p):
        return fw.bind(center=p["center"].detach(),
                       albedo=p["albedo"].detach())

    def step(o, drops=None):
        return value_and_grad_replay(with_params, p0, dscene, cam, o, target,
                                     builder, band_rows=band_rows,
                                     device=device, dropped=drops)

    step(oc)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    drops = []
    F.plan_launches = 0
    t0 = time.perf_counter()
    loss, grads = step(oc, drops)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = F.plan_launches
    peak = torch.cuda.max_memory_allocated() / 2**20
    assert k1 > 0, "the glass step never launched K1's full plan"
    assert len(drops) == -(-opts.height // band_rows), drops
    assert all(float(d) == 0.0 for d in drops), [float(d) for d in drops]

    # the step split by CUDA events: K1's plan, then the replay's vg
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
          for _ in range(GLASS_STEPS * len(drops))]
    k = 0
    for _ in range(GLASS_STEPS):
        for r0 in range(0, opts.height, band_rows):
            rb = min(band_rows, opts.height - r0)
            ev[k][0].record()
            _, wins, occs = builder(p0).render_plan(row0=r0, rows=rb)
            ev[k][1].record()
            replay_band_vg(p0, dscene, cam, target, (wins, occs), r0,
                           apply_params=with_params, opts=oc, rb=rb,
                           device=device)
            ev[k][2].record()
            k += 1
    torch.cuda.synchronize()
    plan_ms = sum(e[0].elapsed_time(e[1]) for e in ev) / GLASS_STEPS
    vg_ms = sum(e[1].elapsed_time(e[2]) for e in ev) / GLASS_STEPS
    print(f"config3 {opts.width}x{opts.height} d{opts.max_depth} glass "
          f"fwd+bwd (plan-compacted replay, cap {GLASS_CAP}, {len(drops)} "
          f"bands of {band_rows} rows): step {plan_ms + vg_ms:.3f} ms = "
          f"K1 plan {plan_ms:.3f} + replay vg {vg_ms:.3f} (CUDA events, mean "
          f"of {GLASS_STEPS} after a warm-up); one step {wall:.4f} s wall; "
          f"{k1} full-plan launches per step; peak {peak:.1f} MiB; dropped "
          f"per band {[float(d) for d in drops]}", flush=True)

    # against the uncompacted replay, the replay image, two runs
    torch.cuda.reset_peak_memory_stats()
    v_ref, g_ref = step(dataclasses.replace(oc, compact_cap=None))
    peak_u = torch.cuda.max_memory_allocated() / 2**20
    d_loss = abs(float(loss) - float(v_ref)) / abs(float(v_ref))
    d_grad = max_rel(grads, g_ref)
    loss2, grads2 = step(oc)
    d_rerun = max_rel(grads2, grads)
    img, wins, occs = builder(p0).render_plan()
    with torch.no_grad():
        rimg, _, rdrop = replay_render(dscene, cam, oc, (wins, occs),
                                       device=device)
    diff = (rimg - img).abs().amax(dim=-1)
    bad = float((diff > PX_TOL).float().mean())
    msg = (f"glass step vs the uncompacted replay (peak {peak_u:.1f} MiB): "
           f"loss {float(loss):.9g} vs {float(v_ref):.9g} (rel {d_loss:.3g}, "
           f"limit {VG_LOSS_RTOL}), gradients within {d_grad:.3g} of each max "
           f"(limit {VG_GRAD_TOL}); two runs: losses {float(loss):.9g} and "
           f"{float(loss2):.9g}, gradients within {d_rerun:.3g}; replay image "
           f"vs K1's: {bad:.5%} pixels off >1/255 (limit {PX_BAD:.1%}), "
           f"dropped {float(rdrop):.0f}")
    print(msg, flush=True)
    assert d_loss <= VG_LOSS_RTOL and d_grad <= VG_GRAD_TOL, msg
    assert float(loss2) == float(loss) and d_rerun <= RERUN_GRAD_TOL, msg
    assert bad <= PX_BAD and float(rdrop) == 0.0, msg
    assert all(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0
               for g in grads.values()), msg

    # the shipping cap 0.5: in the 4 bands (band 3 drops lanes: reported,
    # and the loss it loses), and in one band of the whole frame (exact)
    for rows in (band_rows, opts.height):
        o5 = dataclasses.replace(opts, compact_cap=COMPACT_CAP)
        fw5 = F.FusedWhitted(scene, cam, o5, device=device,
                             param_inputs=True)

        def step5(drops5=None):
            return value_and_grad_replay(
                with_params, p0, dscene, cam, o5, target,
                lambda p: fw5.bind(center=p["center"].detach(),
                                   albedo=p["albedo"].detach()),
                band_rows=rows, device=device, dropped=drops5)

        step5()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        drops5 = []
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        loss5, grads5 = step5(drops5)
        e1.record()
        torch.cuda.synchronize()
        d5 = abs(float(loss5) - float(v_ref)) / abs(float(v_ref))
        g5 = max_rel(grads5, g_ref)
        msg = (f"the glass step at cap {COMPACT_CAP} in bands of {rows} rows: "
               f"{e0.elapsed_time(e1):.3f} ms (CUDA events, one step after a "
               f"warm-up), peak "
               f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
               f"dropped per band {[float(d) for d in drops5]}; vs the "
               f"uncompacted replay: loss rel {d5:.3g}, gradients within "
               f"{g5:.3g} of each max")
        print(msg, flush=True)
        if rows == opts.height:  # one band: exact
            assert float(drops5[0]) == 0.0, msg
            assert d5 <= VG_LOSS_RTOL and g5 <= VG_GRAD_TOL, msg
    return k1


def compare_hits(name, ref, got, max_t=None):
    """Hold one search's result to another's on hits: identical hit/miss
    sets, t at T_RTOL, winner ids of hits on all but ID_MAX_DIFF of them
    (a miss's id is each walk's own). In any-hit mode (`max_t`) only the
    verdicts t < max_t compare: each walk stops at its own first hit."""
    import torch

    (t0, i0), (t1, i1) = ref, got
    if max_t is not None:
        occ = int(((t0 < max_t) != (t1 < max_t)).sum())
        msg = (f"{name}: {t0.shape[0]} rays, {int((t0 < max_t).sum())} "
               f"occluded, occlusion diffs {occ}")
        print(msg, flush=True)
        assert occ == 0, msg
        return
    fin0, fin1 = torch.isfinite(t0), torch.isfinite(t1)
    n_flip = int((fin0 != fin1).sum())
    both = fin0 & fin1
    rel = float(((t1[both] - t0[both]).abs() / t0[both].abs()).max()) \
        if bool(both.any()) else 0.0
    ids = float((i0[both] != i1[both]).float().mean()) if bool(
        both.any()) else 0.0
    msg = (f"{name}: {t0.shape[0]} rays, {int(fin0.sum())} hits, hit/miss "
           f"flips {n_flip}, max rel dt {rel:.3g}, hit id diff {ids:.5f}")
    print(msg, flush=True)
    assert n_flip == 0 and rel <= T_RTOL and ids <= ID_MAX_DIFF, msg


def bvh_phase(scene, cam, opts, grid, grid_img, device):
    """C3: the BVH walk. The kernel vs its plain version on config4's 1080p
    ray sets (bit for bit) and vs the grid walk K5 on them; the main path
    `cli render --config config4 --tracer bvh` at 1920×1080 d4 against the
    grid frame; kernel and plain times over that frame's launches and the
    bound from the work they need. → the JSON entry's numbers."""
    import numpy as np
    import torch

    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.accel.bvh import BVHTracer, bvh_walk
    from raytracer_tpu_torch.io.image import load_ppm, to_u8
    from raytracer_tpu_torch.ops import bvh_walk as BW
    from raytracer_tpu_torch.ops import walk as W

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    tracer = BVHTracer.build(scene, device)
    b, table = tracer._bvh, tracer._table
    print(f"BVH: {b.n_nodes} nodes, leaves of ≤{b.capacity}, {b.n_tris} "
          f"tris, built in {time.perf_counter() - t0:.2f} s", flush=True)
    sets = walk_ray_sets(scene, cam, opts, grid, device)
    sets.append(("primary-occl6", sets[0][1], sets[0][2],
                 torch.full_like(sets[0][1][:, 0], 6.0), None))
    err = 0.0
    for name, o, d, mx, act in sets:
        o, d = o.contiguous(), d.contiguous()
        got = BW.bvh_walk_cuda(b, table, o, d, opts.t_min, mx, act)
        ref = bvh_walk(b, *table.soa, o, d, opts.t_min, mx, act)
        g = W.grid_walk(grid._grid, grid._table, o, d, opts.t_min, mx, act)
        torch.cuda.synchronize()
        same = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        fin = torch.isfinite(ref[0])
        if bool(fin.any()):
            err = max(err, float((got[0][fin] - ref[0][fin]).abs().max()))
        print(f"bvh {name}: kernel bit-equal to the plain walk: {same}",
              flush=True)
        assert same, name
        compare_hits(f"bvh {name} vs the grid walk", g, got, mx)

    os.makedirs(OUT, exist_ok=True)
    out = os.path.join(OUT, "config4_bvh.ppm")
    argv = ["render", "--config", "config4", "--tracer", "bvh", "--out", out]
    with recording(BW, ("bvh_walk_cuda",)) as rec, \
            contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)  # warm-up
    torch.cuda.synchronize()
    calls = rec["bvh_walk_cuda"]
    walls = []
    for _ in range(3):
        buf = io.StringIO()
        BW.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = BW.launches
    print(buf.getvalue(), end="")
    got = load_ppm(out)
    want = to_u8(grid_img) / 255.0
    bad_px = int((np.abs(got - want).max(axis=-1) > IMG_TOL).sum())
    bad = bad_px / (got.shape[0] * got.shape[1])
    msg = (f"main path: cli render config4 1920x1080 d4 --tracer bvh: "
           f"{sorted(walls)[1]:.4f} s wall (median of 3; "
           f"{', '.join(f'{t:.4f}' for t in walls)}; BVH build and image "
           f"write included), {launches} BVH walk launches; vs the grid "
           f"frame {bad_px} pixels ({bad:.4%}) off by > {IMG_TOL}")
    print(msg, flush=True)
    assert launches > 0 and launches == len(calls), (launches, len(calls))
    assert bad <= IMG_BAD, msg

    t = bvh_times(calls)
    plain_ms = cuda_ms(lambda: [bvh_walk(a[0], *a[1].soa, *a[2:])
                                for a in calls], 1, warmup=False)
    work = bvh_work(calls)
    b_ms, b_by = bound_ms(work["ops"], work["bytes"])
    old_ms, old_by = bound_ms(work["ops"], work["old_bytes"])
    ms = t["device_ms"]
    print(f"bvh_walk over the frame's {len(calls)} launches: {fmt_call(t)}; "
          f"plain {plain_ms:.1f} ms; {work['live']:.6g} live of "
          f"{work['lanes']:.6g} lanes, {work['steps']:.6g} node steps (the "
          f"longest walk {work['max_steps']:.0f}), {work['tests']:.6g} "
          f"triangle tests, {work['ops']:.6g} ops, {work['bytes']:.6g} bytes "
          f"→ bound {b_ms:.4f} ms ({b_by}), the call at {b_ms / ms:.1%} of "
          f"bound (the first count, ray bytes on every lane: "
          f"{work['old_bytes']:.6g} bytes, {old_ms:.4f} ms, {old_by}); "
          f"steps / warp_steps: {work['steps'] / work['warp_lanes']:.4f} in "
          f"lane order, {work['steps'] / work['warp_live']:.4f} in live-list "
          f"order ({card_line()})", flush=True)
    print(f"bvh_walk per launch (kernel ms by the {t['source']}, live lanes, "
          "longest walk): " + "; ".join(f"{x:.4f} {n} {m}" for x, n, m in zip(
              t["each_ms"], work["live_each"], work["max_each"])), flush=True)
    return {"launches": launches, "err": err, "ms": ms,
            "events_ms": t["events_ms"], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def bvh_times(calls) -> dict:
    """The BVH walk's recorded calls through its wrapper, timed whole
    (`call_times`)."""
    from raytracer_tpu_torch.ops import bvh_walk as BW

    return call_times([lambda a=a: BW.bvh_walk_cuda(*a) for a in calls],
                      "bvh_walk_kernel")


def live_first(per_lane, act, rows: int = 1):
    """`per_lane`'s entries in `rows` rows, each row's live ones (`act`;
    None: every lane) moved to its front in order and the rest 0: the slots
    in live-list order."""
    import torch

    x = per_lane.reshape(rows, -1)
    if act is None:
        return x
    a = act.reshape(rows, -1)
    order = torch.argsort((~a).to(torch.int32), dim=1, stable=True)
    return (x * a).gather(1, order)


def bvh_work(calls) -> dict:
    """What recorded BVH walk calls need (one pass of the plain walk counts
    the steps and tests): live and all lanes, steps, tests, warp steps in
    lane and in live-list order (`kernels.build.warp_work`), operations,
    bytes, and the first count's bytes."""
    from raytracer_tpu_torch.accel.bvh import bvh_walk
    from raytracer_tpu_torch.kernels.build import warp_work

    w = {k: 0.0 for k in ("live", "lanes", "steps", "tests", "warp_lanes",
                          "warp_live", "bytes", "old_bytes")}
    w["live_each"], w["max_each"] = [], []
    for a in calls:
        b, table, orig, _, _, max_t, act = a
        stats = {}
        bvh_walk(b, *table.soa, *a[2:], stats=stats)
        steps = stats["lane_steps"]
        w["warp_lanes"] += warp_work(steps)
        w["warp_live"] += warp_work(live_first(steps, act))
        w["steps"] += stats.get("steps", 0)  # none when no lane is live
        w["tests"] += stats.get("tests", 0)
        w["max_each"].append(stats.get("max_steps", 0))
        n = orig.shape[0]
        live = n if act is None else int(act.sum())
        mode = "nearest" if max_t is None else "occluded"
        tables = b.n_nodes * BVH_NODE_BYTES + b.n_tris * BVH_TRI_BYTES
        mask = act is not None
        w["live"] += live
        w["live_each"].append(live)
        w["lanes"] += n
        w["bytes"] += (tables + live * BVH_LIVE_BYTES[mode]
                       + n * (BVH_LANE_BYTES + mask))
        w["old_bytes"] += tables + n * (BVH_OLD_RAY_BYTES + mask
                                        + 4 * (max_t is not None))
    w["ops"] = (BVH_OPS["step"] * w["steps"]
                + BVH_OPS["test"] * w["tests"])
    w["max_steps"] = max(w["max_each"])
    return w


def exact_grid_phase(scene, cam, opts, box, box_img, device):
    """C4: the grid built with exact binning (`GridTracer.build(...,
    exact=True)`) on config4: cell occupancy and build time both ways, K5
    vs the plain composition on the exact grid (bit for bit) over config4's
    ray sets and K5's time over the four sets both ways, and the 1080p d4
    frame against the box-binned grid's (the goldens' standard).
    → K5 launches of the exact grid's frame."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.accel.grid import GridTracer
    from raytracer_tpu_torch.renderer import render_banded

    print(card_line(), flush=True)
    built = {}
    for exact in (False, True):
        t0 = time.perf_counter()
        tr = GridTracer.build(scene, device, exact=exact)
        torch.cuda.synchronize()
        built[exact] = (tr, time.perf_counter() - t0)
    exact_tr = built[True][0]
    for exact, (tr, dt) in built.items():
        g = tr._grid
        occ = (g.cell_soa[..., 9] != g.n_tris).sum(dim=1).float()
        print(f"grid {'exact' if exact else 'box'} binning: res {g.res}, "
              f"capacity {g.capacity}, cell occupancy mean "
              f"{float(occ.mean()):.3f} (non-empty cells "
              f"{float(occ[occ > 0].mean()):.3f}), max {int(occ.max())}, "
              f"{g.overflow.shape[0]} overflow, built in {dt:.2f} s",
              flush=True)

    sets = walk_ray_sets(scene, cam, opts, box, device)
    sets.append(("primary-occl6", sets[0][1], sets[0][2],
                 torch.full_like(sets[0][1][:, 0], 6.0), None))
    for name, o, d, mx, act in sets:
        got = grid_search(exact_tr, o, d, opts.t_min, mx, act)
        want = composed_search(exact_tr, o, d, opts.t_min, mx, act)
        torch.cuda.synchronize()
        same = search_equal(got, want)
        print(f"exact grid {name}: K5 bit-equal to the plain composition: "
              f"{same}", flush=True)
        assert same, name
    for exact, (tr, _) in built.items():
        ms = cuda_ms(lambda: [grid_search(tr, o, d, opts.t_min, mx, act)
                              for _, o, d, mx, act in sets[:-1]], 5)
        print(f"K5 over config4's four 1080p walk sets, "
              f"{'exact' if exact else 'box'} grid: {ms:.4f} ms (the "
              f"searches whole: dense tests, walk, merge)", flush=True)

    k5_reset()
    img, _ = render_banded(scene, cam, opts, device=device, tracer=exact_tr)
    torch.cuda.synchronize()
    k5 = k5_searches("config4 1080p d4 frame on the exact grid")
    diff = (img - box_img).abs().amax(dim=-1).cpu().numpy()
    bad = float((diff > IMG_TOL).mean())
    msg = (f"config4 1920x1080 d4 frame on the exact grid: {k5} walk "
           f"launches; vs the box grid's frame {bad:.4%} pixels off by > "
           f"{IMG_TOL} (limit {IMG_BAD:.1%}), max {float(np.max(diff)):.4f}")
    print(msg, flush=True)
    assert k5 > 0 and bad <= IMG_BAD, msg
    return k5


# the culled sweep (accel/cull.py, csrc/cull_sweep.cu): the reference's
# hybrid rung, HybridBand at the config4 preset's 5120-ray 32x160 screen
# blocks (raytracer_tpu/models/presets.py:187), cap 1024
CULL_CAP = 1024
CULL_BLOCK = (32, 160)
CULL_SMALL = (480, 270)       # the per-call form: ~70 ms of dispatch a tile
CULL_DRILL = (192, 108, 128)  # the overflow drill: width, height, cap
CULL_STEPS = 3                # timed hybrid steps (CUDA events) after a warm-up
CULL_IMG_MAX = 2e-7           # culled == grid to 1 ulp (tests/test_cull.py)
CULL_LOSS_RTOL, CULL_GRAD_RTOL, CULL_GRAD_ATOL = 1e-6, 1e-4, 1e-7
CULL_DIVERGE = 1e-3           # an overflowing cap's image moves past this
# per test: Möller–Trumbore (test_row, 46 fp32 operations); bytes per live
# lane: orig + dir in (24), any-hit max_t in (4); per lane: active in (1),
# nearest t + idx out (8) or an any-hit bool out (1); per list its count
# (4) and its ids (4 each, up to cap); each listed row once, 40 bytes
# (v0|e1|e2|id)
CULL_OPS = 46
CULL_LIVE_BYTES = {"nearest": 24, "occluded": 28}
CULL_LANE_BYTES = {"nearest": 9, "occluded": 2}
CULL_ROW_BYTES = 40


def cull_work(calls):
    """Tests, warp tests in lane and in live-list order
    (`kernels.build.warp_work` a row per list), operations and bytes of
    recorded sweep calls (one pass of the plain version counts the tests)
    → dict."""
    import torch

    from raytracer_tpu_torch.kernels.build import warp_work
    from raytracer_tpu_torch.ops import cull_sweep as CS

    w = {k: 0.0 for k in ("tests", "warp_lanes", "warp_live", "bytes")}
    for name, args in calls:
        rays, ids, counts, table, tile, t_min, act, *mx = args
        stats = {}
        CS.cull_sweep_plain(rays, ids, counts, table, tile, t_min, act, *mx,
                            stats=stats)
        per = stats["lane_tests"]
        w["warp_lanes"] += warp_work(per.reshape(-1, tile))
        w["warp_live"] += warp_work(live_first(per, act, ids.shape[0]))
        w["tests"] += stats["tests"]
        lens = torch.clamp(counts, max=ids.shape[1])
        slot = torch.arange(ids.shape[1], device=ids.device)
        listed = ids[slot[None, :] < lens[:, None]]
        live = rays[0].shape[0] if act is None else int(act.sum())
        w["bytes"] += (live * CULL_LIVE_BYTES[name]
                       + rays[0].shape[0] * CULL_LANE_BYTES[name]
                       + 4 * counts.shape[0] + 4 * float(lens.sum())
                       + CULL_ROW_BYTES * torch.unique(listed).numel())
    w["ops"] = CULL_OPS * w["tests"]
    return w


def cull_times(calls) -> dict:
    """The sweep's recorded (mode, args) calls through its wrapper, timed
    whole (`call_times`)."""
    from raytracer_tpu_torch.ops import cull_sweep as CS

    return call_times([lambda a=a: CS.cull_sweep_cuda(*a)
                       for _, a in calls], "cull_sweep_kernel")


def cull_ctas(args) -> tuple:
    """(CTAs the sweep kernel launches, CTAs that stage rows) for one
    recorded call (`cull_sweep.list_live`, `cta_shares`)."""
    import torch

    from raytracer_tpu_torch.ops import cull_sweep as CS

    _, ids, counts, _, tile, _, act, *_ = args
    n_lists = ids.shape[0]
    n_live = (torch.full((n_lists,), tile, dtype=torch.int32,
                         device=ids.device) if act is None
              else CS.list_live(act, n_lists, tile)[1])
    table = CS.cta_shares(n_live, counts, tile, CS.THREADS)
    return table.shape[0] * table.shape[1], int((table[..., 1] > 0).sum())


def ms_in_turns(fns, n=FRAMES, reps=5):
    """CUDA-event ms of each of `fns` (`cuda_ms`, `reps` runs after a
    warm-up), `n` rounds in turns → [(median, all)] per fn."""
    times = [[] for _ in fns]
    for _ in range(n):
        for fn, ts in zip(fns, times):
            ts.append(cuda_ms(fn, reps))
    return [(sorted(ts)[n // 2], ts) for ts in times]


def cull_vs_walk(name, args, grid):
    """One recorded sweep call: the kernel against its plain version (bit
    for bit) and against the grid walk on the same rays and active lanes
    (the hits, or the occlusion bits) → (max |Δt| kernel vs plain, the
    grid tracer's search of the same call: `grid_search`'s args)."""
    import torch

    from raytracer_tpu_torch.ops import cull_sweep as CS
    from raytracer_tpu_torch.ops import walk as W

    rays, ids, counts, table, tile, t_min, act, *mx = args
    got = CS.cull_sweep_cuda(*args)
    want = CS.cull_sweep_plain(*args)
    mx = mx[0] if mx else None
    walk = W.grid_walk(grid._grid, grid._table, *rays, t_min, mx, act)
    torch.cuda.synchronize()
    n_live = int(act.sum())
    if mx is not None:
        same = torch.equal(got, want)
        k5_diff = int((got != (walk[0] < mx)).sum())
        msg = (f"cull {name}: {rays[0].shape[0]} lanes in {ids.shape[0]} "
               f"lists, {n_live} live, {int(got.sum())} occluded; kernel "
               f"bit-equal to plain: {same}; occlusion bits off the walk's: "
               f"{k5_diff}")
        err = 0.0
    else:
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        fin = torch.isfinite(want[0])
        err = float((got[0][fin] - want[0][fin]).abs().max()) if bool(
            fin.any()) else 0.0
        hit = torch.isfinite(walk[0])
        k5_diff = int((~torch.eq(got[0], walk[0])).sum()
                      + (got[1][hit] != walk[1][hit]).sum())
        msg = (f"cull {name}: {rays[0].shape[0]} lanes in {ids.shape[0]} "
               f"lists, {n_live} live, {int(fin.sum())} hits; kernel "
               f"bit-equal to plain: {same}; lanes whose t or hit id is off "
               f"the walk's: {k5_diff}")
    print(msg, flush=True)
    assert same and k5_diff == 0, msg
    return err, (grid, *rays, t_min, mx, act)


def assert_vg_close(tag, v, g, want_v, want_g):
    """The reference's gradient standard (tests/test_cull.py): loss rtol
    1e-6, each gradient rtol 1e-4, atol 1e-7 elementwise."""
    import torch

    d_loss = abs(float(v) - float(want_v)) / abs(float(want_v))
    bad = {k: int((~torch.isclose(g[k], want_g[k], rtol=CULL_GRAD_RTOL,
                                  atol=CULL_GRAD_ATOL)).sum()) for k in want_g}
    msg = (f"{tag}: loss {float(v):.9g} vs {float(want_v):.9g} (rel "
           f"{d_loss:.3g}, limit {CULL_LOSS_RTOL}); gradient entries outside "
           f"rtol {CULL_GRAD_RTOL}, atol {CULL_GRAD_ATOL}: {bad}")
    print(msg, flush=True)
    assert d_loss <= CULL_LOSS_RTOL and not any(bad.values()), msg


def cull_counts(reset: bool = False) -> tuple:
    """(culled sweep, K5) launches since the last reset."""
    from raytracer_tpu_torch.ops import cull_sweep as CS
    from raytracer_tpu_torch.ops import walk as W

    if reset:
        CS.launches = W.launches = 0
    return CS.launches, W.launches


def cull_phase(scene, cam, opts, grid, frame, traced, device):
    """The culled sweep on the main path's scene at config4 1920×1080 d4 in
    32×160 blocks, cap 1024: the audit; the sweep kernel vs its plain
    version and vs the grid walk on the hybrid frame's calls, times and
    bound (beside the grid tracer's searches of the same calls);
    `HybridBand` 5 frames in turns with the grid frame (image, rays, two
    runs); `render_partitioned`; the hybrid fwd+bwd step against the grid
    step; the per-call form at 480×270; the overflow drill at 192×108, cap
    128 → the JSON entry's numbers."""
    import dataclasses

    import torch

    from raytracer_tpu_torch.accel.cull import (CullTracer, HybridBand,
                                                cull_audit, render_partitioned,
                                                thin_tiles)
    from raytracer_tpu_torch.ops import cull_sweep as CS
    from raytracer_tpu_torch.renderer import (render_banded, render_rays,
                                              value_and_grad_bands,
                                              value_and_grad_banded)

    t_start = time.perf_counter()
    card = card_line()
    print(card, flush=True)
    bh, bw = CULL_BLOCK
    block = dataclasses.replace(opts, tile_rays=bh * bw, tile_block=CULL_BLOCK)
    launches = {}

    # 1. the audit
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aud = cull_audit(scene, cam, block, device=device, cap=CULL_CAP,
                     inner=grid)
    audit_ms = (time.perf_counter() - t0) * 1e3
    shadow = aud["shadow"].max(axis=1)
    thin = thin_tiles(aud)
    size = f"{opts.width}x{opts.height} d{opts.max_depth}"
    print(f"cull_audit config4 {size}, {bh}x{bw} blocks, cap "
          f"{aud['cap']}: {aud['n_tiles']} tiles of {aud['tile']} lanes, "
          f"{int(thin.sum())} thin, {int((~thin).sum())} fat (one band); max "
          f"d0 count {int(aud['d0'].max())}, max shadow bound "
          f"{int(shadow.max())}; d0 counts of thin tiles: mean "
          f"{float(aud['d0'][thin].mean()):.1f}, empty "
          f"{int((aud['d0'][thin] == 0).sum())}; audit {audit_ms:.2f} ms "
          f"(host clock, grid build excluded, {card})", flush=True)
    assert int(thin.sum()) > 0, "no thin tile: the sweep would never run"
    assert (aud["d0"][thin] <= CULL_CAP).all() and (
        aud["shadow"][thin] <= CULL_CAP).all()

    # 2. the kernel against its plain version and the grid walk, on the
    # calls of the hybrid frame (the thin tiles' d0 nearest and each
    # light's shadows)
    t0 = time.perf_counter()
    band = HybridBand(scene, cam, block, device=device, inner=grid,
                      cap=CULL_CAP)
    torch.cuda.synchronize()
    band_s = time.perf_counter() - t0
    assert band.n_thin == int(thin.sum()) and band.n_tiles == aud["n_tiles"]
    with recording(CS, ("cull_nearest", "cull_occluded")) as rec:
        cull_counts(reset=True)
        img = band()
        torch.cuda.synchronize()
        frame_launches = cull_counts()
    calls = ([("nearest", a) for a in rec["cull_nearest"]]
             + [("occluded", a) for a in rec["cull_occluded"]])
    assert len(calls) == frame_launches[0] == 1 + scene.lights.count, (
        len(calls), frame_launches)
    err = 0.0
    walks = []
    for name, args in calls:
        e, w_args = cull_vs_walk(name, args, grid)
        err = max(err, e)
        walks.append(w_args)
    t = cull_times(calls)
    ms = t["device_ms"]
    plain_ms = cuda_ms(lambda: [CS.cull_sweep_plain(*a) for _, a in calls], 1,
                       warmup=False)
    k5_ms = cuda_ms(lambda: [grid_search(*a) for a in walks], 5)
    work = cull_work(calls)
    b_ms, b_by = bound_ms(work["ops"], work["bytes"])
    # the hybrid's gate, part 1: the whole search call, culling included,
    # against the grid tracer's, in turns
    rays = calls[0][1][0]
    act = calls[0][1][6]
    fresh = band.cull.fresh
    (call_ms, call_all), (grid_call_ms, grid_call_all) = ms_in_turns([
        lambda: fresh().nearest(*rays, block.t_min, block.tri_chunk, act),
        lambda: grid.nearest(*rays, block.t_min, block.tri_chunk, act)])
    fmt = lambda ts: ", ".join(f"{t:.4f}" for t in ts)
    print(f"cull_sweep over the hybrid frame's {len(calls)} launches (d0 "
          f"nearest + {scene.lights.count} shadow sets of "
          f"{rays[0].shape[0]} lanes): {fmt_call(t)}; plain {plain_ms:.2f} "
          f"ms; {work['tests']:.6g} tests (Σ min(count, cap) × live lanes), "
          f"{work['ops']:.6g} ops, {work['bytes']:.6g} bytes → bound "
          f"{b_ms:.4f} ms ({b_by}), the call at {b_ms / ms:.1%} of bound; "
          f"tests / warp_tests {work['tests'] / work['warp_lanes']:.4f} in "
          f"lane order, {work['tests'] / work['warp_live']:.4f} in live-list "
          f"order; the grid tracer's searches (K5) of the same calls "
          f"{k5_ms:.4f} ms; the d0 nearest call "
          f"whole (segments, lists, kernel, spheres/planes) {call_ms:.4f} ms "
          f"({fmt(call_all)}) in turns with the grid tracer's "
          f"{grid_call_ms:.4f} ms ({fmt(grid_call_all)}) (CUDA events, "
          f"median of {FRAMES} rounds of 5; {card})", flush=True)
    print(f"cull_sweep per launch (kernel ms by the {t['source']}; CTAs "
          "launched, CTAs that stage rows): " + "; ".join(
              f"{name} {x:.4f} ({cull_ctas(a)[0]}, {cull_ctas(a)[1]})"
              for (name, a), x in zip(calls, t["each_ms"])), flush=True)

    # 3. HybridBand: frames in turns with the main-path grid frame
    (grid_s, grid_all), (hyb_s, hyb_all) = in_turns([
        lambda: render_banded(scene, cam, opts, device=device, tracer=grid),
        band], n=FRAMES)
    d_img = float((img - frame).abs().max())
    img2, traced_h = band.image(count_rays=True)
    # padding lanes (the partial block row) trace the dummy direction too
    n_pad = band.n_tiles * band.thin_dirs.shape[1] - band.n_pix
    pad_traced = 0.0
    if n_pad:
        dummy = torch.tensor([[0.0, 0.0, -1.0]], device=device)
        pad_traced = float(render_rays(
            band.scene, band.orig[:1].expand(n_pad, 3), dummy.expand(n_pad, 3),
            opts, count_rays=True, tracer=grid)[1])
    same = torch.equal(img2, img)
    msg = (f"HybridBand config4 {size} ({band.n_thin} thin / "
           f"{band.n_tiles} tiles): {hyb_s:.4f} s median of {FRAMES} "
           f"({', '.join(f'{t:.4f}' for t in hyb_all)}) in turns with the "
           f"grid frame's {grid_s:.4f} s ({', '.join(f'{t:.4f}' for t in grid_all)}); "
           f"build (audit + partition) {band_s:.3f} s; per frame "
           f"{frame_launches[0]} sweep + {frame_launches[1]} K5 launches; vs "
           f"the grid frame max |d| {d_img:.3g} (limit {CULL_IMG_MAX}); rays "
           f"{float(traced_h):.9g} = the frame's {float(traced):.9g} + "
           f"{n_pad} padding lanes' {pad_traced:.9g}; two runs bit-equal: "
           f"{same} ({card})")
    print(msg, flush=True)
    assert d_img <= CULL_IMG_MAX and same, msg
    assert float(traced_h) == float(traced) + pad_traced, msg
    launches[f"HybridBand frame (config4 {size}, {bh}x{bw}, cap "
             f"{CULL_CAP})"] = frame_launches[0]

    # 4. render_partitioned (audits again) == HybridBand's frame
    cull_counts(reset=True)
    img_p, _ = render_partitioned(scene, cam, block, device=device,
                                  inner=grid, cap=CULL_CAP)
    torch.cuda.synchronize()
    n_rp = cull_counts()[0]
    print(f"render_partitioned: bit-equal to HybridBand's frame: "
          f"{bool(torch.equal(img_p, img))}, {n_rp} sweep launches",
          flush=True)
    assert torch.equal(img_p, img) and n_rp > 0
    launches[f"render_partitioned (config4 {size})"] = n_rp
    del img_p, img2

    # 5. the hybrid fwd+bwd step against the grid step
    dscene = band.scene
    target = frame * 0.9
    p0 = {"center": dscene.spheres.center, "albedo": dscene.materials.albedo}
    h = opts.height

    def hybrid_step():
        return value_and_grad_bands(
            lambda leaves, r0, rb: band.image(
                scene=with_params(dscene, leaves))[0],
            p0, block, target, [(0, h)], device=device)

    def grid_step():
        return value_and_grad_banded(with_params, p0, dscene, cam, opts,
                                     target, device=device, tracer=grid)

    hybrid_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cull_counts(reset=True)
    v, g = hybrid_step()
    torch.cuda.synchronize()
    step_launches = cull_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    step_ms = cuda_ms(hybrid_step, CULL_STEPS, warmup=False)
    v_ref, g_ref = grid_step()
    grid_step_ms = cuda_ms(grid_step, CULL_STEPS)
    print(f"hybrid fwd+bwd step (hybrid_image under autograd, centers "
          f"{tuple(p0['center'].shape)} and albedos "
          f"{tuple(p0['albedo'].shape)}, target = grid frame × 0.9): "
          f"{step_ms:.3f} ms (CUDA events, mean of {CULL_STEPS} after a "
          f"warm-up) against the grid step's (value_and_grad_banded) "
          f"{grid_step_ms:.3f} ms; {step_launches[0]} sweep + "
          f"{step_launches[1]} K5 launches per step; peak {peak:.1f} MiB "
          f"({card})", flush=True)
    assert_vg_close("hybrid step vs the grid step", v, g, v_ref, g_ref)
    assert step_launches[0] > 0
    launches[f"hybrid fwd+bwd step (config4 {size})"] = step_launches[0]
    del g, g_ref

    # 6. the per-call form: render(tracer=CullTracer) in 32x160 blocks, at
    # a cap the audit of that size shows no list above
    w, hs = CULL_SMALL
    small = dataclasses.replace(block, width=w, height=hs)
    aud_s = cull_audit(scene, cam, small, device=device, cap=CULL_CAP,
                       inner=grid)
    top = int(max(aud_s["d0"].max(), aud_s["shadow"].max()))
    cap_s = max(CULL_CAP, top)
    want = render_banded(scene, cam, small, device=device, tracer=grid)[0]
    tr = CullTracer(scene, device, inner=grid, cap=cap_s)
    cull_counts(reset=True)
    t0 = time.perf_counter()
    img_s, _ = render_banded(scene, cam, small, device=device, tracer=tr)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_pc = cull_counts()[0]
    d_s = float((img_s - want).abs().max())
    msg = (f"render(tracer=CullTracer) config4 {w}x{hs} d4, {bh}x{bw} blocks "
           f"({aud_s['n_tiles']} tiles; largest count {top}, cap {tr._cd.cap}): "
           f"{secs:.3f} s, {n_pc} sweep launches; vs the grid render max "
           f"|d| {d_s:.3g} (limit {CULL_IMG_MAX}) ({card})")
    print(msg, flush=True)
    assert n_pc > 0 and d_s <= CULL_IMG_MAX, msg
    launches[f"render(tracer=CullTracer) config4 {w}x{hs} d4"] = n_pc

    # 7. the overflow drill
    w, hs, cap = CULL_DRILL
    drill = dataclasses.replace(block, width=w, height=hs)
    aud_d = cull_audit(scene, cam, drill, device=device, cap=cap, inner=grid)
    over = int((aud_d["d0"] > cap).sum() + (aud_d["shadow"] > cap).sum())
    want = render_banded(scene, cam, drill, device=device, tracer=grid)[0]
    cull_counts(reset=True)
    img_d, _ = render_banded(scene, cam, drill, device=device,
                             tracer=CullTracer(scene, device, inner=grid,
                                               cap=cap))
    torch.cuda.synchronize()
    n_dr = cull_counts()[0]
    d_d = float((img_d - want).abs().max())
    msg = (f"overflow drill config4 {w}x{hs} d4, cap {cap}: the audit finds "
           f"{over} counts above cap (max {int(aud_d['d0'].max())} d0, "
           f"{int(aud_d['shadow'].max())} shadow); the image differs from "
           f"the grid's by {d_d:.4f} (must exceed {CULL_DIVERGE}); {n_dr} "
           "sweep launches")
    print(msg, flush=True)
    assert over > 0 and d_d > CULL_DIVERGE and n_dr > 0, msg
    launches[f"overflow drill config4 {w}x{hs} d4 cap {cap}"] = n_dr

    print(f"culled-sweep phase: {time.perf_counter() - t_start:.1f} s; the "
          f"hybrid's gate (the whole d0 call and the frame each below the "
          f"grid's): call {call_ms:.4f} against {grid_call_ms:.4f} ms, frame "
          f"{hyb_s:.4f} against {grid_s:.4f} s: "
          f"{'met' if call_ms < grid_call_ms and hyb_s < grid_s else 'not met'}",
          flush=True)
    return {"launches": launches, "err": err, "ms": ms,
            "events_ms": t["events_ms"],
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by}


MD_FRAMES = 5       # timed frames per side, in turns, after a warm-up
MD_STEPS = 3        # timed training steps (CUDA events) after a warm-up
MD_REDUCES = 20     # timed all_reduces of the fused step's floats
MD_TIMEOUT_S = 600  # the spawned ranks (more than one card)
# the fused step's sharded vs single-device standard
# (tests/test_fused_vjp.py::test_kernel_vg_sharded_matches_single_device)
MD_LOSS_RTOL, MD_TABLE_TOL = 1e-5, 1e-4
# overlap vs the plain backward (tests/test_overlap.py); vs the single-device
# autograd loss
OV_LOSS_RTOL, OV_GRAD_RTOL, OV_GRAD_ATOL, OV_SINGLE_RTOL = 1e-6, 1e-4, 1e-7, \
    1e-5
# kernels of the multi-device path → their launch counters
MD_KERNELS = {"grid_walk": ("raytracer_tpu_torch.ops.walk", "launches"),
              "bvh_walk": ("raytracer_tpu_torch.ops.bvh_walk", "launches"),
              "fused_whitted_live_plan": ("raytracer_tpu_torch.ops.fused",
                                          "live_plan_launches"),
              "fused_train": ("raytracer_tpu_torch.ops.fused",
                              "train_launches")}


def md_counts(reset: bool = False) -> dict:
    """The multi-device path's launch counts (set to 0 first with
    `reset`)."""
    import importlib

    out = {}
    for name, (mod, attr) in MD_KERNELS.items():
        m = importlib.import_module(mod)
        if reset:
            setattr(m, attr, 0)
        out[name] = getattr(m, attr)
    return out


def in_turns(fns, n=MD_FRAMES):
    """Host seconds of `n` runs of each of `fns`, in turns, each run ended by
    a synchronize, after one warm-up each → [(median, all)] per fn."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(n):
        for fn, ts in zip(fns, times):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
    return [(sorted(ts)[n // 2], ts) for ts in times]


def md_launched(say, path: str, kernels, launches: dict) -> dict:
    """The counts since the last reset of `kernels` on this rank; each must
    have launched."""
    counts = md_counts()
    got = {k: counts[k] for k in kernels}
    say(f"{path}: launches on this rank {got}")
    for k, n in got.items():
        assert n > 0, f"{path}: {k} was never launched"
        launches.setdefault(k, {})[path] = n
    return got


def multidevice_rank(device, out_dir=None):
    """One rank of the multi-device phase, on its card `device`, in the NCCL
    group it has joined → its launches per kernel and path, errors and
    times (written as JSON to `out_dir`/multidevice_rank<rank>.json when
    given). Rank 0 prints."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel.mesh import make_rt_mesh
    from raytracer_tpu_torch.parallel.overlap import (float_partition,
                                                      make_loss_and_grad)
    from raytracer_tpu_torch.parallel.shard import (build_sharded_accel,
                                                    render_sharded)
    from raytracer_tpu_torch.renderer import render, value_and_grad_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli

    rank, world = dist.get_rank(), dist.get_world_size()
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    say = (lambda *a: print(*a, flush=True)) if rank == 0 else \
        (lambda *a: None)
    say(f"process group: {dist.get_backend()}, world size "
        f"{dist.get_world_size()}, rank {rank} on {device}")
    assert dist.get_backend() == "nccl", dist.get_backend()
    launches, res = {}, {"rank": rank}
    mesh_t = make_rt_mesh(tiles=world, prims=1)
    mesh_p = make_rt_mesh(tiles=1, prims=world)
    scene, cam, opts = load_scene_cli("config4")
    dscene = scene.to(device)
    tag = (f"config4 {opts.width}x{opts.height} d{opts.max_depth}, "
           f"{scene.meshes.count} triangles")

    # grid: replicated GridTracer, tiles = world size
    grid = build_tracer(scene, "grid", device)
    want, want_n = render(dscene, cam, opts, device=device, tracer=grid,
                          count_rays=True)
    md_counts(reset=True)
    got, got_n = render_sharded(dscene, cam, opts, mesh_t,
                                count_rays=True, tracer=grid,
                                device=device)
    torch.cuda.synchronize()
    path = f"render_sharded {tag}, GridTracer, tiles={world}"
    md_launched(say, path, ("grid_walk",), launches)
    same = torch.equal(got, want) and float(got_n) == float(want_n)
    say(f"{path}: image and traced ({float(got_n):.6g}) equal to the "
        f"single-device render: {same}")
    assert same, path
    (t1, a1), (ts, a_s) = in_turns([
        lambda: render(dscene, cam, opts, device=device, tracer=grid,
                       count_rays=True),
        lambda: render_sharded(dscene, cam, opts, mesh_t, count_rays=True,
                               tracer=grid, device=device)])
    say(f"{path}: {ts:.4f} s (median of {MD_FRAMES}; "
        f"{', '.join(f'{t:.4f}' for t in a_s)}) against the "
        f"single-device frame {t1:.4f} s ("
        f"{', '.join(f'{t:.4f}' for t in a1)}), in turns")
    res["grid_s"], res["grid_single_s"] = ts, t1

    # bvh: one BVH per primitive shard, prims = world size
    bvh = build_tracer(scene, "bvh", device)
    want, want_n = render(dscene, cam, opts, device=device, tracer=bvh,
                          count_rays=True)
    md_counts(reset=True)
    got, got_n = render_sharded(dscene, cam, opts, mesh_p, accel="bvh",
                                count_rays=True, device=device)
    torch.cuda.synchronize()
    path = f"render_sharded {tag}, accel=bvh, prims={world}"
    md_launched(say, path, ("bvh_walk",), launches)
    diff = (got - want).abs().amax(dim=-1)
    n_diff = int((diff > 0).sum())
    bad = float((diff > IMG_TOL).float().mean())
    say(f"{path}: vs the single-device --tracer bvh frame {n_diff} "
        f"pixels differ, {bad:.4%} by > {IMG_TOL}; traced "
        f"{float(got_n):.6g} vs {float(want_n):.6g}")
    assert bad <= IMG_BAD, path
    t0 = time.perf_counter()
    stacked = build_sharded_accel(scene, world)
    build_s = time.perf_counter() - t0
    (t1, a1), (ts, a_s) = in_turns([
        lambda: render(dscene, cam, opts, device=device, tracer=bvh,
                       count_rays=True),
        lambda: render_sharded(dscene, cam, opts, mesh_p, accel=stacked,
                               count_rays=True, device=device)])
    say(f"{path}: {ts:.4f} s (median of {MD_FRAMES}, the per-shard BVH "
        f"stack prebuilt in {build_s:.3f} s; "
        f"{', '.join(f'{t:.4f}' for t in a_s)}) against the "
        f"single-device BVHTracer frame {t1:.4f} s ("
        f"{', '.join(f'{t:.4f}' for t in a1)}), in turns")
    res["bvh_s"], res["bvh_single_s"] = ts, t1
    res["bvh_diff_px"] = n_diff
    del bvh, grid, stacked

    # the sharded fused step: K1's live plan + K2 on a band per rank
    res["fused"] = {}
    for ftag, name, w, h, depth in (
            ("config2 1920x1080 d2", "config2", 1920, 1080, 2),
            ("config3 1024x1024 d4", "config3", 0, 0, None)):
        fw, target = train_case(name, device, w, h, depth)
        l1, g1, _ = fw.plan_value_and_grad(target)
        md_counts(reset=True)
        ls, gs = fw.plan_value_and_grad_sharded(target, mesh_t)
        torch.cuda.synchronize()
        path = f"plan_value_and_grad_sharded {ftag}, tiles={world}"
        md_launched(say, path, ("fused_whitted_live_plan",
                                "fused_train"), launches)
        rel = abs(float(ls) - float(l1)) / abs(float(l1))
        worst = max(float((gs[k] - g1[k]).abs().max())
                    / (float(g1[k].abs().max()) + 1e-9) for k in g1)
        ms = cuda_ms(lambda: fw.plan_value_and_grad_sharded(
            target, mesh_t), MD_STEPS)
        ms1 = cuda_ms(lambda: fw.plan_value_and_grad(target), MD_STEPS)
        # the step's one collective alone, on as many floats
        flat = torch.zeros(1 + sum(g.numel() for g in gs.values()),
                           device=device)
        ar_ms = cuda_ms(lambda: dist.all_reduce(
            flat, group=mesh_t.tiles_group), MD_REDUCES)
        say(f"{path}: loss {float(ls):.8g} vs single-device "
            f"{float(l1):.8g} (rel {rel:.3g}), tables within "
            f"{worst:.3g} of each max; step {ms:.4f} ms against the "
            f"single-device step {ms1:.4f} ms (CUDA events, mean of "
            f"{MD_STEPS}); its all_reduce of {flat.numel()} floats "
            f"alone {ar_ms:.4f} ms (mean of {MD_REDUCES})")
        assert rel <= MD_LOSS_RTOL and worst <= MD_TABLE_TOL, path
        res["fused"][ftag] = {"ms": ms, "single_ms": ms1,
                              "all_reduce_ms": ar_ms}
        del fw, target

    # the bounce-pipelined backward, config2 1080p d2
    scene2, cam2, opts2 = load_scene_cli("config2", width=1920,
                                         height=1080, max_depth=2)
    d2 = scene2.to(device)
    target = render_sharded(d2, cam2, opts2, mesh_t,
                            device=device)[0] * 0.9
    path = f"make_loss_and_grad config2 1920x1080 d2, tiles={world}"
    out, steps = {}, {}
    for ov in (True, False):
        steps[ov] = make_loss_and_grad(scene2, cam2, opts2, mesh_t,
                                       overlap=ov, device=device)
        out[ov] = steps[ov](d2, target)
    lo, lf = float(out[True][0]), float(out[False][0])
    go = float_partition(out[True][1])[0]
    gf = float_partition(out[False][1])[0]
    worst = max(float(((a - b).abs() - OV_GRAD_RTOL * b.abs()).max())
                for a, b in zip(go, gf) if a.numel())
    big = max(float(a.abs().max()) for a in go if a.numel())
    p0 = {"center": d2.spheres.center, "albedo": d2.materials.albedo}
    l1, _ = value_and_grad_banded(with_params, p0, d2, cam2, opts2,
                                  target, device=device)
    ms = {ov: cuda_ms(lambda ov=ov: steps[ov](d2, target), MD_STEPS)
          for ov in (True, False)}
    say(f"{path}: loss {lo:.8g} overlapped vs {lf:.8g} plain (rel "
        f"{abs(lo - lf) / lf:.3g}); gradients past rtol {OV_GRAD_RTOL} "
        f"by at most {worst:.3g} (atol {OV_GRAD_ATOL}; largest "
        f"{big:.4g}); single-device autograd loss {float(l1):.8g} (rel "
        f"{abs(lo - float(l1)) / float(l1):.3g}); step {ms[True]:.3f} ms "
        f"overlapped, {ms[False]:.3f} ms plain (CUDA events, mean of "
        f"{MD_STEPS})")
    assert abs(lo - lf) <= OV_LOSS_RTOL * abs(lf), path
    assert worst <= OV_GRAD_ATOL and big > 1e-6, path
    assert abs(lo - float(l1)) <= OV_SINGLE_RTOL * abs(float(l1)), path
    res["overlap_ms"], res["plain_ms"] = ms[True], ms[False]
    del out, steps, target
    res["launches"] = launches
    if out_dir is not None:
        with open(os.path.join(out_dir, f"multidevice_rank{rank}.json"),
                  "w") as f:
            json.dump(res, f)
    return res


def multidevice_phase() -> dict:
    """The multi-device paths at world size = the card count: in this
    process at one card (a one-rank NCCL group), else one spawned process
    per card. → {kernel: {path: launches summed over the ranks}}."""
    import torch
    import torch.distributed as dist

    from raytracer_tpu_torch.parallel import frames

    world = torch.cuda.device_count()
    print(f"{card_line()} × {world}", flush=True)
    if world == 1:
        device = frames.join(0, 1, frames.free_address(), "cuda")
        try:
            results = [multidevice_rank(device)]
        finally:
            dist.destroy_process_group()
    else:
        os.makedirs(OUT, exist_ok=True)
        # a rank that fails leaves the others waiting in a collective: the
        # launcher stops them all at the first failure, or at the deadline
        with frames.spawn_ranks(world, multidevice_rank, [OUT]) as ranks:
            code = ranks.wait(MD_TIMEOUT_S)
        assert code == 0, f"a rank exited {code}"
        results = []
        for r in range(world):
            with open(os.path.join(OUT, f"multidevice_rank{r}.json")) as f:
                results.append(json.load(f))
    total = {}
    for r in results:
        for k, paths in r["launches"].items():
            for path, n in paths.items():
                key = f"{path} (all {world} ranks)"
                total.setdefault(k, {})[key] = \
                    total.get(k, {}).get(key, 0) + n
    return total


# tooling (`cli render --tile-block|--trace|--resilient`, `cli optimize
# --supervise|--resume`): config4 1080p d4 frames and config5 128² runs
TILE_BLOCK = (270, 480)   # 16 tiles of the 1080p frame
REF_BLOCK = (32, 160)     # the reference preset's block (presets.py:177-187)
REF_BLOCK_MAX_S = 60.0    # predicted past this: the 32x160 frame at 480x270
SMALL_FRAME = (480, 270)
RESUME_RTOL = 1e-6        # exact resume (tests/test_elastic.py:89)
SUP_FAULT_STEPS = 3       # --fault-after-steps of the crashed supervised run
TOOL_TIMEOUT_S = 600      # each child process of the phase
HOOK = os.path.join(OUT, "counthook")
# a python process that starts with HOOK on its PYTHONPATH imports this as
# `sitecustomize` and writes its kernels' launch counts at exit (os._exit
# included): the counts of the CLI's child processes
HOOK_SRC = '''"""Kernel launch counts of this process, written at exit to
counts/<pid>.json beside this file (chip_smoke.py writes this file)."""
import atexit
import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_KERNELS = %r


def _dump():
    out = {}
    for name, (mod, attr) in _KERNELS.items():
        m = sys.modules.get(mod)
        out[name] = getattr(m, attr, 0) if m is not None else 0
    d = os.path.join(_HERE, "counts")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "%%d.json" %% os.getpid()), "w") as f:
        json.dump(out, f)


_os_exit = os._exit


def _exit(code):
    _dump()
    _os_exit(code)


atexit.register(_dump)
os._exit = _exit
# the environment's own sitecustomize, if it had one, still runs
for _p in sys.path:
    _f = os.path.join(os.path.abspath(_p or "."), "sitecustomize.py")
    if os.path.dirname(_f) != _HERE and os.path.isfile(_f):
        with open(_f) as _fh:
            exec(compile(_fh.read(), _f, "exec"), {"__name__": "sitecustomize",
                                                   "__file__": _f})
        break
'''


def hook_env() -> dict:
    """os.environ with the count hook first on PYTHONPATH; counts reset."""
    import shutil

    os.makedirs(HOOK, exist_ok=True)
    with open(os.path.join(HOOK, "sitecustomize.py"), "w") as f:
        f.write(HOOK_SRC % (MD_KERNELS,))
    shutil.rmtree(os.path.join(HOOK, "counts"), ignore_errors=True)
    path = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, PYTHONPATH=HOOK + (os.pathsep + path if path
                                                else ""))


def hook_counts() -> dict:
    """Launches summed over the processes that wrote counts since
    `hook_env()`."""
    d = os.path.join(HOOK, "counts")
    total = {k: 0 for k in MD_KERNELS}
    for name in os.listdir(d) if os.path.isdir(d) else []:
        with open(os.path.join(d, name)) as f:
            for k, n in json.load(f).items():
                total[k] += n
    return total


@contextlib.contextmanager
def hooked_environ():
    """This process's environment as `hook_env()`'s while the block runs
    (for the children that the port's own code starts)."""
    saved = dict(os.environ)
    os.environ.update(hook_env())
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)


@contextlib.contextmanager
def capturing(mod, name):
    """Wrap `mod.name`: record each call's (args, output, wall s ended by a
    synchronize)."""
    import torch

    saved = getattr(mod, name)
    got = []

    def call(*args, **kw):
        t0 = time.perf_counter()
        out = saved(*args, **kw)
        torch.cuda.synchronize()
        got.append((args, out, time.perf_counter() - t0))
        return out

    setattr(mod, name, call)
    try:
        yield got
    finally:
        setattr(mod, name, saved)


def cli_frame(argv):
    """`cli.main(argv)` in-process (a render) → (image, rays, wall s of its
    `render_banded`, stdout, K5 launches)."""
    from raytracer_tpu_torch import cli, renderer

    buf = io.StringIO()
    k5_reset()
    with capturing(renderer, "render_banded") as got, \
            contextlib.redirect_stdout(buf):
        cli.main(argv)
    launches = k5_searches(" ".join(argv))
    assert len(got) == 1, len(got)
    _, (img, rays), secs = got[0]
    return img, rays, secs, buf.getvalue(), launches


def run_child(argv, tag):
    """A python child with the count hook → (stdout, stderr, wall s,
    launches)."""
    env = hook_env()
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                       capture_output=True, text=True,
                       timeout=TOOL_TIMEOUT_S)
    dt = time.perf_counter() - t0
    assert r.returncode == 0, f"{tag}: exit {r.returncode}\n{r.stderr[-4000:]}"
    return r.stdout, r.stderr, dt, hook_counts()


def idle_share(trace_dir, tag):
    """1 − (union of the card's kernel, copy and set intervals) / (the
    traced window: first to last event of any kind), from the trace files
    under `trace_dir` → the share."""
    from raytracer_tpu_torch.utils.profiling import DEVICE_CATS, trace_events

    events = trace_events(trace_dir)
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events
                   if e.get("cat", "").lower() in DEVICE_CATS)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    share = 1.0 - busy / (t1 - t0)
    n_kernels = sum(1 for e in events if e.get("cat", "").lower() == "kernel")
    print(f"{tag}: traced window {(t1 - t0) / 1e3:.3f} ms, {n_kernels} "
          f"kernels, {len(spans)} device events, device busy (their union) "
          f"{busy / 1e3:.3f} ms, device-idle share {share:.4f}", flush=True)
    assert len(spans) > 0, f"{tag}: the trace holds no device event"
    return share


def trace_warm_frame(logdir):
    """config4 1080p d4: one frame, then a second one under `xprof_trace`
    (in a process of its own: one profiler session per process)."""
    import torch

    from raytracer_tpu_torch.renderer import render_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli
    from raytracer_tpu_torch.utils.profiling import xprof_trace

    device = torch.device("cuda", 0)
    scene, cam, opts = load_scene_cli("config4")
    tracer = build_tracer(scene, "auto", device)
    render_banded(scene, cam, opts, device=device, tracer=tracer)
    torch.cuda.synchronize()
    with xprof_trace(logdir, device=device):
        render_banded(scene, cam, opts, device=device, tracer=tracer)
        torch.cuda.synchronize()


def cold_start():
    """The parts of a fresh process's config4 1080p d4 frame, in the order a
    band worker (`utils/elastic.py`) runs them: prints each part's seconds
    (run in a process of its own)."""
    t0 = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    from raytracer_tpu_torch.renderer import render_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli

    t_pkg = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)
    torch.cuda.synchronize()
    t_ctx = time.perf_counter()
    scene, cam, opts = load_scene_cli("config4")
    tracer = build_tracer(scene, "auto", device)
    torch.cuda.synchronize()
    t_tracer = time.perf_counter()
    parts = []
    for _ in range(2):
        t = time.perf_counter()
        render_banded(scene, cam, opts, device=device, tracer=tracer)
        torch.cuda.synchronize()
        parts.append(time.perf_counter() - t)
    print(f"cold start in a fresh process: import torch {t_torch - t0:.3f} "
          f"s, the package {t_pkg - t_torch:.3f} s, CUDA context "
          f"{t_ctx - t_pkg:.3f} s, scene + grid build {t_tracer - t_ctx:.3f} "
          f"s, first frame {parts[0]:.4f} s, second frame {parts[1]:.4f} s",
          flush=True)


def block_tiles(h, w, bh, bw) -> int:
    """Tiles of an h×w frame in bh×bw screen blocks (`renderer.block_perm`
    pads a partial block row or column to whole blocks)."""
    return -(-h // bh) * -(-w // bw)


def tile_block_phase(scene, cam, opts, tracer, frame, rays, device):
    """`cli render --config config4 --tile-block 270x480` (16 tiles) and at
    the reference's 32x160 (408 tiles): image and rays bit-equal to the
    one-tile frame; 5 frames in turns → {path: K5 launches}."""
    import dataclasses

    import torch

    from raytracer_tpu_torch.renderer import render_banded

    launches = {}
    bh, bw = TILE_BLOCK
    img, r, secs, text, n = cli_frame([
        "render", "--config", "config4", "--tile-block", f"{bh}x{bw}",
        "--out", os.path.join(OUT, "config4_block.png")])
    print(text, end="")
    path = f"cli render --config config4 --tile-block {bh}x{bw} (1080p d4)"
    launches[path] = n
    ntiles = block_tiles(opts.height, opts.width, bh, bw)
    print(f"{path}: {ntiles} tiles, render {secs:.4f} s, {n} walk launches; "
          f"image bit-equal to the one-tile frame: "
          f"{bool(torch.equal(img, frame))}, rays {float(r):.9g} against "
          f"{float(rays):.9g}", flush=True)
    assert torch.equal(img, frame), f"{path}: image differs"
    assert float(r) == float(rays), (float(r), float(rays))
    assert n > 0, f"{path}: the walk never launched"
    block = dataclasses.replace(opts, tile_rays=bh * bw, tile_block=(bh, bw))
    (one_s, one_all), (blk_s, blk_all) = in_turns([
        lambda: render_banded(scene, cam, opts, device=device, tracer=tracer),
        lambda: render_banded(scene, cam, block, device=device,
                              tracer=tracer)])
    print(f"config4 1080p d4, 5 frames in turns: one tile {one_s:.4f} s "
          f"median ({', '.join(f'{t:.4f}' for t in one_all)}); {ntiles} "
          f"tiles of {bh}x{bw} {blk_s:.4f} s ("
          f"{', '.join(f'{t:.4f}' for t in blk_all)})", flush=True)

    rbh, rbw = REF_BLOCK
    predicted = blk_s / ntiles * block_tiles(opts.height, opts.width, rbh,
                                             rbw)
    argv = ["render", "--config", "config4", "--tile-block", f"{rbh}x{rbw}",
            "--out", os.path.join(OUT, "config4_refblock.png")]
    want = frame
    size = "1080p"
    if predicted > REF_BLOCK_MAX_S:
        w, h = SMALL_FRAME
        size = f"{w}x{h}"
        small = dataclasses.replace(opts, width=w, height=h)
        argv += ["--width", str(w), "--height", str(h)]
        want = render_banded(scene, cam, small, device=device,
                             tracer=tracer)[0]
        print(f"the {rbh}x{rbw} frame is predicted at {predicted:.1f} s "
              f"(> {REF_BLOCK_MAX_S} s): run at {size} d4 instead",
              flush=True)
    img, r, secs, text, n = cli_frame(argv)
    print(text, end="")
    path = f"cli render --config config4 --tile-block {rbh}x{rbw} ({size} d4)"
    launches[path] = n
    print(f"{path}: {block_tiles(img.shape[0], img.shape[1], rbh, rbw)} "
          "tiles (a partial block row is padded to whole blocks), "
          f"render {secs:.4f} s (predicted {predicted:.1f} s from the "
          f"{ntiles}-tile frame), {n} walk launches; bit-equal to the "
          f"one-tile frame: {bool(torch.equal(img, want))}", flush=True)
    assert torch.equal(img, want), f"{path}: image differs"
    assert n > 0, f"{path}: the walk never launched"
    return launches


def trace_phase():
    """`cli render --config config4 --trace DIR` (1080p d4) in a process of
    its own: top ops and the frame's device-idle share; the same for a warm
    frame (`trace_warm_frame`) → {path: K5 launches}."""
    import shutil

    from raytracer_tpu_torch.utils.profiling import print_top_ops

    d = os.path.join(OUT, "trace_cli")
    shutil.rmtree(d, ignore_errors=True)
    out, _, dt, counts = run_child([
        "-m", "raytracer_tpu_torch.cli", "render", "--config", "config4",
        "--trace", d, "--out", os.path.join(OUT, "config4_trace.png")],
        "cli render --trace")
    print(out, end="")
    path = "cli render --config config4 --trace (1080p d4, own process)"
    print(f"{path}: {dt:.2f} s for the process, {counts['grid_walk']} walk "
          "launches; top device ops:", flush=True)
    assert counts["grid_walk"] > 0, f"{path}: the walk never launched"
    print_top_ops(d, k=12)
    idle_share(d, "cli render --trace (the process's first frame)")
    d2 = os.path.join(OUT, "trace_warm")
    shutil.rmtree(d2, ignore_errors=True)
    run_child(["-c", f"import chip_smoke; chip_smoke.trace_warm_frame({d2!r})"],
              "warm frame trace")
    print("warm frame (the second in its process); top device ops:")
    print_top_ops(d2, k=12)
    idle_share(d2, "warm frame")
    return {path: counts["grid_walk"]}


def resilient_phase(frame, frame_s):
    """The parts of a fresh process's frame (`cold_start`), then `cli render
    --config config4 --resilient` (1080p d4) without a fault and with a
    countdown of 1: each image bit-equal to the main-path frame → {path: K5
    launches}."""
    import numpy as np

    from raytracer_tpu_torch import cli

    want = frame.cpu().numpy()
    out, _, dt, _ = run_child(["-c", "import chip_smoke; "
                               "chip_smoke.cold_start()"], "cold start")
    print(out, end="")
    print(f"(the process: {dt:.2f} s wall, interpreter start included)",
          flush=True)
    cd = os.path.join(OUT, "countdown.txt")
    launches = {}
    for tag, extra in (("", []), (" --fault-countdown (1)",
                                  ["--fault-countdown", cd])):
        with open(cd, "w") as f:
            f.write("1")
        buf = io.StringIO()
        with hooked_environ(), capturing(cli, "_save") as saved, \
                contextlib.redirect_stdout(buf):
            t0 = time.perf_counter()
            cli.main(["render", "--config", "config4", "--resilient",
                      "--out", os.path.join(OUT, "config4_resilient.png"),
                      *extra])
            dt = time.perf_counter() - t0
            counts = hook_counts()
        text = buf.getvalue()
        print(text, end="")
        ok, failed, retries = (int(x) for x in re.search(
            r"(\d+) bands ok, (\d+) failed, (\d+) retries", text).groups())
        img = saved[0][0][1]
        path = f"cli render --config config4 --resilient{tag} (1080p d4)"
        launches[path] = counts["grid_walk"]
        equal = bool(np.array_equal(img, want))
        print(f"{path}: {dt:.2f} s wall against the in-process frame's "
              f"{frame_s:.4f} s; {ok} bands ok, {failed} failed, {retries} "
              f"retries; {counts['grid_walk']} walk launches in the workers; "
              f"bit-equal to the main-path frame: {equal}", flush=True)
        assert failed == 0 and equal, path
        assert counts["grid_walk"] > 0, f"{path}: the walk never launched"
        if extra:
            with open(cd) as f:
                assert f.read().strip() == "0", "the fault was not consumed"
            assert retries >= 1 and ok >= 2, (ok, retries)
    return launches


def supervised_phase():
    """`cli optimize --kernel --supervise` (config5 128², 8 steps) with
    children that crash every 3 steps against an uncrashed supervised run;
    the autograd trainer stopped at 5 steps and resumed to 8 against 8
    straight → {kernel: {path: launches}}."""
    import shutil

    import numpy as np

    launches = {"fused_whitted_live_plan": {}, "fused_train": {}}
    runs = {}
    for tag, extra in (("crashed", ["--fault-after-steps",
                                    str(SUP_FAULT_STEPS)]),
                       ("uncrashed", [])):
        ck = os.path.join(OUT, f"ck_{tag}")
        shutil.rmtree(ck, ignore_errors=True)
        out, err, dt, counts = run_child([
            "-m", "raytracer_tpu_torch.cli", "optimize", "--kernel",
            "--steps", "8", "--ckpt-every", "2", "--log-every", "1",
            "--supervise", "--checkpoint", ck, "--out",
            os.path.join(OUT, f"supervised_{tag}.ppm"), *extra],
            f"supervised {tag}")
        losses = {}
        for line in out.splitlines():  # a re-run step: the later child's
            if line.startswith('{"step"'):
                d = json.loads(line)
                losses[d["step"]] = d["loss"]
        restarts = err.count("restarting with --resume")
        path = " ".join(["cli optimize --kernel --supervise --steps 8",
                         *extra, f"({tag}, children)"])
        k1, k2 = counts["fused_whitted_live_plan"], counts["fused_train"]
        launches["fused_whitted_live_plan"][path] = k1
        launches["fused_train"][path] = k2
        print(f"{path}: {dt:.2f} s wall, {restarts} restarts, {k1} live-plan "
              f"and {k2} train launches in the children", flush=True)
        assert sorted(losses) == list(range(8)), sorted(losses)
        assert k1 > 0 and k2 > 0, f"{path}: K1 or K2 never launched"
        runs[tag] = (losses, restarts)
    (crashed, restarts), (clean, clean_restarts) = runs["crashed"], \
        runs["uncrashed"]
    rel = max(abs(crashed[i] - clean[i]) / abs(clean[i]) for i in range(8))
    print(f"supervised --kernel: {restarts} restarts; losses against the "
          f"uncrashed run's: max rel {rel:.3g} (limit {RESUME_RTOL})",
          flush=True)
    assert restarts >= 2 and clean_restarts == 0, (restarts, clean_restarts)
    for i in range(8):
        np.testing.assert_allclose(crashed[i], clean[i], rtol=RESUME_RTOL)

    base = ["optimize", "--lr", "5e-2", "--log-every", "1", "--ckpt-every",
            "2", "--out", os.path.join(OUT, "resume.ppm")]
    ck, ck2 = os.path.join(OUT, "ck_resume"), os.path.join(OUT, "ck_straight")
    for d in (ck, ck2):
        shutil.rmtree(d, ignore_errors=True)
    first, _, _ = cli_losses(base + ["--steps", "5", "--checkpoint", ck])
    rest, text, _ = cli_losses(base + ["--steps", "8", "--resume",
                                       "--checkpoint", ck])
    straight, _, _ = cli_losses(base + ["--steps", "8", "--checkpoint", ck2])
    assert "resumed from step 4" in text, text[-2000:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(first + rest, straight))
    print(f"cli optimize (autograd) 5 steps, then --resume to 8, against 8 "
          f"straight: max rel {rel:.3g} (limit {RESUME_RTOL})", flush=True)
    assert len(first + rest) == len(straight) == 8
    np.testing.assert_allclose(first + rest, straight, rtol=RESUME_RTOL)
    return launches


def tooling_phase(scene, cam, opts, tracer, frame, rays, frame_s, device):
    """The tooling slice on the card → {kernel: {path: launches}}."""
    os.makedirs(OUT, exist_ok=True)
    t0 = time.perf_counter()
    walk = tile_block_phase(scene, cam, opts, tracer, frame, rays, device)
    walk.update(trace_phase())
    walk.update(resilient_phase(frame, frame_s))
    out = {"grid_walk": walk, **supervised_phase()}
    print(f"tooling phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main_frame(scene, cam, opts, tracer, device):
    """The main path's config4 frame: `render_banded` with the grid walk, a
    warm-up and FRAMES timed frames → (image, traced rays, median s, walk
    launches per frame)."""
    import torch

    from raytracer_tpu_torch.renderer import render_banded

    render_banded(scene, cam, opts, device=device, tracer=tracer,
                  count_rays=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k5_reset()
    frame_s = []
    for _ in range(FRAMES):  # the host's share varies: report the median
        t0 = time.perf_counter()
        img, traced = render_banded(scene, cam, opts, device=device,
                                    tracer=tracer, count_rays=True)
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t0)
    launches = k5_searches("cli render --config config4")
    assert launches % FRAMES == 0, launches
    launches //= FRAMES
    dt = sorted(frame_s)[FRAMES // 2]
    rays = float(traced)
    print(f"config4 {opts.width}x{opts.height} depth {opts.max_depth}: "
          f"{dt:.4f} s (median of {FRAMES} frames; "
          f"{', '.join(f'{t:.4f}' for t in frame_s)}), {rays:.6g} rays, "
          f"{rays / dt:.6g} rays/s, {launches} walk launches per frame, peak "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB", flush=True)
    assert launches > 0, "the main path never launched the walk kernel"
    return img, traced, dt, launches


@contextlib.contextmanager
def torch_shading():
    """Every bounce in the block takes the torch bounce (K6's and K7's
    twin), recorded or not."""
    from raytracer_tpu_torch.ops import bounce_shade as BS

    real = BS.fused_shading, BS.adjoint_shading
    BS.fused_shading = BS.adjoint_shading = lambda *a, **k: False
    try:
        yield
    finally:
        BS.fused_shading, BS.adjoint_shading = real


class AnsweringTracer:
    """A tracer that answers a bounce's searches from recorded results:
    `nearest` the recorded hit, `occluded` each light's bits in light
    order. It stands in for the searches where only the shading is
    timed."""

    def __init__(self, device, hit, shadowed):
        self.device, self._hit, self._shadowed = device, hit, shadowed
        self._light = 0

    def nearest(self, *args, **kw):
        return self._hit

    def occluded(self, *args, **kw):
        self._light += 1
        return self._shadowed[self._light - 1]


def frame_bounces(scene, cam, opts, tracer, device):
    """Each bounce of the main path's frame (`render_banded`) → [(device
    scene, state, n0, is_last, depth, radiance before the bounce, the
    nearest search's hit, each light's shadow bits)]."""
    import torch

    from raytracer_tpu_torch import renderer

    answers, bounces = [], []

    class Recording:
        def __init__(self, inner):
            self.inner, self.device = inner, inner.device

        def nearest(self, *a, **k):
            answers.append(self.inner.nearest(*a, **k))
            return answers[-1]

        def occluded(self, *a, **k):
            answers.append(self.inner.occluded(*a, **k))
            return answers[-1]

    real = renderer.bounce_step

    def recording(dscene, state, opts_, n0, is_last, **kw):
        start, rad = len(answers), kw.get("radiance")
        rad = None if rad is None else rad.clone()
        out = real(dscene, state, opts_, n0, is_last, **kw)
        bounces.append((dscene, state, n0, is_last, kw.get("depth", 0), rad,
                        answers[start], answers[start + 1:]))
        return out

    renderer.bounce_step = recording
    try:
        renderer.render_banded(scene, cam, opts, device=device,
                               tracer=Recording(tracer))
    finally:
        renderer.bounce_step = real
    torch.cuda.synchronize()
    return bounces


def k6_bytes(dscene, n: int, children: int, plan: bool) -> tuple:
    """The bytes K6's two launches need on a bounce of `n` lanes →
    (surface, shade)."""
    from raytracer_tpu_torch.ops import bounce_shade as BS

    tables, counts = BS.scene_tables(dscene, dscene.lights.pos.device)
    once = sum(4 * t.numel() for t in tables if t is not None)
    nl = counts[3]
    return (once + n * (K6_SURFACE_LANE + nl * K6_SURFACE_LIGHT),
            once + n * (K6_SHADE_LANE + nl * K6_SHADE_LIGHT
                        + children * K6_CHILD + plan * K6_PLAN))


def shade_phase(scene, cam, opts, tracer, device) -> dict:
    """K6 (`ops/bounce_shade`, the fused forward shading of a bounce) on
    the main path's config4 frame: each bounce through K6 and through the
    torch bounce from the same state and the same search answers, bit for
    bit (the radiance, the ray count, the children, the plan planes); each
    half's device time over the frame's bounces (the profiler, and CUDA
    events), the torch bounce's, the bound (bytes / 3.35 TB/s); K6's
    launches on the main paths (a render frame, a training step's record)
    and the device operations of a frame → the PERF.md row's numbers."""
    import torch

    from raytracer_tpu_torch import renderer
    from raytracer_tpu_torch.ops import bounce_shade as BS
    from raytracer_tpu_torch.renderer import render_banded

    bounces = frame_bounces(scene, cam, opts, tracer, device)
    calls, plain, nbytes = [], [], 0.0
    for dscene, state, n0, is_last, depth, rad, hit, shadowed in bounces:
        def bounce(fused, state=state, n0=n0, is_last=is_last, depth=depth,
                   rad=rad, hit=hit, shadowed=shadowed, dscene=dscene):
            radiance, plan = rad.clone(), []
            answers = AnsweringTracer(device, hit, shadowed)
            with contextlib.nullcontext() if fused else torch_shading():
                terms, child, inc = renderer.bounce_step(
                    dscene, state, opts, n0, is_last, count_rays=True,
                    tracer=answers, plan_out=plan, depth=depth,
                    radiance=radiance)
            for t in terms:
                radiance = radiance + t
            return [radiance, inc, *plan[0], *(child or ())]

        got, want = bounce(True), bounce(False)
        torch.cuda.synchronize()
        same = len(got) == len(want) and all(
            torch.equal(a.view(torch.int32) if a.dtype == torch.float32
                        else a, b.view(torch.int32)
                        if b.dtype == torch.float32 else b)
            for a, b in zip(got, want))
        n = state[0].shape[0]
        print(f"bounce {depth} ({n} lanes, {int(state[3].sum())} alive, "
              f"last {is_last}): K6 bit-equal to the torch bounce (radiance, "
              f"ray count, plan planes, children): {same}", flush=True)
        assert same, f"bounce {depth}: K6 != the torch bounce"

        tables = BS.scene_tables(dscene, device)
        o = state[0].contiguous()
        stacked = torch.stack(shadowed)
        scratch = rad.clone()
        calls += [
            lambda o=o, s=state, h=hit, t=tables: BS.surface_cuda(
                t, o, s[1], s[3], h, opts),
            lambda o=o, s=state, h=hit, t=tables, b=stacked, last=is_last,
            r=scratch, g=dscene.has_glass: BS.shade_cuda(
                t, o, s[1], s[2], s[3], h, b, opts, is_last=last, glass=g,
                radiance=r)]
        plain.append(lambda f=bounce: f(False))
        surf_b, shade_b = k6_bytes(dscene, n, 0 if is_last else 1, False)
        nbytes += surf_b + shade_b
    whole = call_times(calls, "shade_")
    each = whole["each_ms"]
    plain_ms = cuda_ms(lambda: [f() for f in plain], 3)
    b_ms, b_by = bound_ms(0.0, nbytes)
    print(f"K6 over the frame's {len(bounces)} bounces: {fmt_call(whole)}; "
          f"surface launches {', '.join(f'{x:.4f}' for x in each[0::2])} "
          f"ms, shade launches {', '.join(f'{x:.4f}' for x in each[1::2])} "
          f"ms; the torch bounce (searches answered from the record) "
          f"{plain_ms:.4f} ms by CUDA events; {nbytes:.6g} bytes → bound "
          f"{b_ms:.4f} ms ({b_by}), {b_ms / whole['kernel_ms']:.1%} of it",
          flush=True)

    BS.launches = 0
    render_banded(scene, cam, opts, device=device, tracer=tracer)
    torch.cuda.synchronize()
    frame_launches = BS.launches
    ops = device_intervals(lambda: render_banded(
        scene, cam, opts, device=device, tracer=tracer), "shade_")
    kernels = len(ops)
    dscene, dcam = scene.to(device), cam.to(device)
    target = render_banded(dscene, dcam, opts, device=device,
                           tracer=tracer)[0] * 0.9
    BS.launches = 0
    renderer.value_and_grad_banded(
        with_params, {"center": dscene.spheres.center,
                      "albedo": dscene.materials.albedo}, dscene, dcam, opts,
        target, device=device, tracer=tracer)
    torch.cuda.synchronize()
    step_launches = BS.launches
    print(f"K6 launches: {frame_launches} a config4 render_banded frame, "
          f"{step_launches} a value_and_grad_banded step (the plan's "
          f"record, the replay and its recompute); {kernels} device "
          f"operations a frame (the profiler)",
          flush=True)
    assert frame_launches == 2 * len(bounces), frame_launches
    assert step_launches > 0, "the training step's record skipped K6"
    return {"call_ms": whole["kernel_ms"], "events_ms": whole["events_ms"],
            "each_ms": each, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nbytes,
            "launches_frame": frame_launches,
            "launches_step": step_launches, "device_ops_frame": kernels}


def k7_bytes(call) -> float:
    """The bytes one recorded K7 call (`adjoint_phase`'s) needs."""
    from raytracer_tpu_torch.kernels.build import load_library

    args, kw = call
    tables, o = args[0], args[1]
    n, nl = o.shape[0], tables[1][3]
    vecs = sum(int(g.numel()) // 3 for g in (args[8], *args[9])
               if g is not None) / max(n, 1)
    vecs += sum(bool(w) for w in kw["rays"])
    once = sum(4 * t.numel() for t in tables[0] if t is not None)
    blocks = load_library().rt_bounce_adjoint_blocks(n)
    rows = 4 * tables[1][0] + 9 * tables[1][1] + 6 * nl + 7 * int(
        tables[0][19].shape[0])
    return once + 4 * blocks * (rows + 1) * 2 + n * (
        K7_LANE + nl * K7_LIGHT + K7_VEC * vecs)


def adjoint_phase(scene, cam, opts, tracer, device) -> dict:
    """K7 (`ops/bounce_shade.adjoint_cuda`, the adjoint of a recorded
    bounce) in the config4 1080p d4 training step (`value_and_grad_banded`,
    the plan replay, centers and albedos): its calls as the step made them
    (the replay's two bounces), timed whole (the profiler, and CUDA events)
    beside the bound (bytes / 3.35 TB/s); the plain autograd twin's
    backward (the torch bounce under torch.autograd, from the same inputs
    and cotangents) timed by CUDA events, its gradients held to K7's; K7's
    launches a step; the step through K7 and through the torch bounce, by
    CUDA events → the PERF.md row's numbers."""
    import torch

    from raytracer_tpu_torch import renderer
    from raytracer_tpu_torch.ops import bounce_shade as BS

    dscene, dcam = scene.to(device), cam.to(device)
    target = renderer.render_banded(dscene, dcam, opts, device=device,
                                    tracer=tracer)[0] * 0.9
    p0 = {"center": dscene.spheres.center, "albedo": dscene.materials.albedo}

    def step():
        return renderer.value_and_grad_banded(
            with_params, p0, dscene, dcam, opts, target, device=device,
            tracer=tracer)

    calls, real = [], BS.adjoint_cuda

    def recording(*args, **kw):
        keep = lambda g: None if g is None else g.detach().clone()
        calls.append(((*args[:8], keep(args[8]),
                       tuple(keep(g) for g in args[9])), dict(kw)))
        return real(*args, **kw)

    step()  # warm-up
    torch.cuda.synchronize()
    BS.adjoint_launches = 0
    BS.adjoint_cuda = recording
    try:
        step()
    finally:
        BS.adjoint_cuda = real
    torch.cuda.synchronize()
    launches = BS.adjoint_launches
    assert launches == 2 * len(calls) and calls, (launches, len(calls))

    thunks = [lambda c=c: real(*c[0], **c[1]) for c in calls]
    whole = call_times(thunks, "bounce_adjoint_kernel")
    nbytes = sum(k7_bytes(c) for c in calls)
    b_ms, b_by = bound_ms(0.0, nbytes)

    # the twin: the torch bounce from the same state and search answers,
    # its backward under torch.autograd for the same cotangents
    twins, worst = [], {}
    for (args, kw) in calls:
        tables, o, d, thr, alive, hit, shadowed, _, g_terms, g_child = args
        is_last = kw["is_last"]
        leaves = {"o": o.detach().clone().requires_grad_(),
                  "d": d.detach().clone().requires_grad_(),
                  "thr": thr.detach().clone().requires_grad_(),
                  "center": dscene.spheres.center.clone().requires_grad_(),
                  "albedo": dscene.materials.albedo.clone().requires_grad_()}
        with torch_shading():
            terms, child, _ = renderer.bounce_step(
                with_params(dscene, leaves),
                (leaves["o"], leaves["d"], leaves["thr"], alive), opts,
                o.shape[0], is_last,
                tracer=AnsweringTracer(device, hit, list(shadowed)))
        outs = [torch.stack(terms)] + ([] if is_last else list(child[:3]))
        pairs = [(x, g) for x, g in zip(outs, (g_terms, *g_child))
                 if g is not None]
        wrt = list(leaves.values())

        def twin(pairs=pairs, wrt=wrt):
            return torch.autograd.grad([x for x, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       retain_graph=True, allow_unused=True)

        want = twin()
        got_o, got_d, got_thr, vec = real(*args, **kw)
        ns, nm = dscene.spheres.count, dscene.materials.mtype.shape[0]
        np_ = dscene.planes.count
        got = {"o": got_o, "d": got_d, "thr": got_thr,
               "center": vec[:4 * ns].view(ns, 4)[:, :3],
               "albedo": vec[4 * ns + 9 * np_:4 * ns + 9 * np_ + 7 * nm]
               .view(nm, 7)[:, :3]}
        for k, w in zip(leaves, want):
            if w is None or got[k] is None:
                continue
            err = float((got[k] - w).abs().max()) / max(
                float(w.abs().max()), 1e-30)
            worst[k] = max(worst.get(k, 0.0), err)
        twins.append(twin)
    twin_ms = cuda_ms(lambda: [t() for t in twins], 3)
    print(f"K7 against the twin's gradients over the step's {len(calls)} "
          f"bounces: max |Δ| / max |twin| {worst}", flush=True)
    assert all(v <= 1e-3 for v in worst.values()), worst

    ms_k7 = cuda_ms(step, 3)
    with torch_shading():
        ms_torch = cuda_ms(step, 3)
    each = whole["each_ms"]
    print(f"K7 over a config4 1080p d4 step's {len(calls)} replayed "
          f"bounces: {fmt_call(whole)}; adjoint launches "
          f"{', '.join(f'{x:.4f}' for x in each)} ms; the plain autograd "
          f"twin's backward (the torch bounce, retained graph) "
          f"{twin_ms:.4f} ms by CUDA events; {nbytes:.6g} bytes → bound "
          f"{b_ms:.4f} ms ({b_by}), {b_ms / whole['kernel_ms']:.1%} of it; "
          f"{launches} K7 launches a step; the step {ms_k7:.3f} ms through "
          f"K7, {ms_torch:.3f} ms through the torch bounce (CUDA events, "
          f"mean of 3 after a warm-up)", flush=True)
    return {"call_ms": whole["kernel_ms"], "device_ms": whole["device_ms"],
            "events_ms": whole["events_ms"], "each_ms": each,
            "plain_ms": twin_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "launches_step": launches,
            "step_ms": ms_k7, "step_torch_ms": ms_torch, "max_rel": worst}


def adjoint_alone():
    """K7's phase on its own (`alone_setup` first)."""
    scene, cam, opts, tracer, _, _, _, device = alone_setup()
    print_ptxas(("bounce_adjoint_kernel",))
    print(json.dumps({"k7": adjoint_phase(scene, cam, opts, tracer,
                                          device)}))
    print(card_line(), flush=True)


def shade_alone():
    """K6's phase on its own (`alone_setup` first)."""
    scene, cam, opts, tracer, _, _, _, device = alone_setup()
    print_ptxas(("shade_surface_kernel", "shade_finish_kernel"))
    print(json.dumps({"k6": shade_phase(scene, cam, opts, tracer, device)}))
    print(card_line(), flush=True)


def alone_setup():
    """What a phase run on its own starts from: the kernel build and the
    main path's config4 frame → (scene, cam, opts, grid tracer, image,
    traced rays, frame s, device)."""
    import torch

    from raytracer_tpu_torch.kernels import build
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    device = torch.device("cuda", 0)
    print(card_line(), flush=True)
    path, build_s = build.build_library()
    build.load_library()
    print(f"built {os.path.relpath(path)} in {build_s:.2f} s", flush=True)
    print_ptxas(("bvh_live_list_kernel", "bvh_walk_kernel",
                 "cull_live_list_kernel", "cull_sweep_kernel"))
    scene, cam, opts = load_scene_cli("config4")
    tracer = build_tracer(scene, "auto", device)
    img, traced, dt, _ = main_frame(scene, cam, opts, tracer, device)
    return scene, cam, opts, tracer, img, traced, dt, device


def kernel_alone():
    """K5's fused search phase on its own (`alone_setup` first)."""
    scene, cam, opts, tracer, _, _, _, device = alone_setup()
    print(json.dumps(kernel_phase(scene, cam, opts, tracer, device)))
    print(card_line(), flush=True)


def tooling_alone():
    """The tooling phase on its own (`alone_setup` first)."""
    scene, cam, opts, tracer, img, traced, dt, device = alone_setup()
    tooling_phase(scene, cam, opts, tracer, img, traced, dt, device)
    print(card_line(), flush=True)


def cull_alone():
    """The culled-sweep phase on its own (`alone_setup` first)."""
    scene, cam, opts, tracer, img, traced, _, device = alone_setup()
    print(json.dumps(cull_phase(scene, cam, opts, tracer, img, traced,
                                device)))
    print(card_line(), flush=True)


def bvh_alone():
    """The BVH walk phase on its own (`alone_setup` first)."""
    scene, cam, opts, tracer, img, _, _, device = alone_setup()
    print(json.dumps(bvh_phase(scene, cam, opts, tracer, img, device)))
    print(card_line(), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from raytracer_tpu_torch.kernels import build
    from raytracer_tpu_torch.models import presets
    from raytracer_tpu_torch.ops import fused as F
    from raytracer_tpu_torch.renderer import render_banded
    from raytracer_tpu_torch.utils.hostload import build_tracer, load_scene_cli

    t_start = time.perf_counter()
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
    for key, name in (("tri_trace_kernel", "K3"), ("mat_trace_kernel", "K4")):
        rows = ptxas_report(build.build_log, key)
        for entry, regs, st, ld in rows:
            mode = "b any-hit" if "ILb1E" in entry else "a nearest"
            print(f"{name}{mode} ({entry}): {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B", flush=True)
        assert len(rows) == 2 and not any(st or ld for _, _, st, ld in rows), \
            rows
    print_ptxas(("bvh_live_list_kernel", "bvh_walk_kernel",
                 "cull_live_list_kernel", "cull_sweep_kernel"))

    _phase("raygen on the card")
    raygen_check(device)

    _phase("K5's fused search vs the plain composition it replaces, the "
           "searches of the config4 1920x1080 d4 frame")
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
    img, traced, dt, launches = main_frame(scene, cam, opts, tracer, device)
    walk_frame = profile_ms(lambda: render_banded(
        scene, cam, opts, device=device, tracer=tracer), "grid_walk_kernel")
    print(f"walk kernel over one frame's {launches} launches (profiler): "
          f"{walk_frame:.4f} ms", flush=True)
    assert tuple(img.shape) == (opts.height, opts.width, 3), img.shape
    assert bool(torch.isfinite(img).all()), "non-finite pixels"
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0

    _phase("K6, the fused shading of a bounce, vs the torch bounce on the "
           "config4 1920x1080 d4 frame")
    k6 = shade_phase(scene, cam, opts, tracer, device)

    _phase("K7, the adjoint of a recorded bounce, in the config4 1920x1080 "
           "d4 training step")
    k7 = adjoint_phase(scene, cam, opts, tracer, device)

    _phase("tooling: cli render --tile-block, --trace, --resilient (config4 "
           "1920x1080 d4); cli optimize --kernel --supervise, --resume "
           "(config5 128x128)")
    tool = tooling_phase(scene, cam, opts, tracer, img, traced, dt, device)

    _phase("main path: config4 1920x1080 d4 fwd+bwd (wavefront-planner "
           "replay)")
    k5_step = waveplan_phase(scene, cam, opts, tracer, img, device)

    _phase("one training step under torch.profiler (own process)")
    profile_phase()

    _phase("replay autograd against central differences, config4 256x144 d4")
    waveplan_fd(device)

    _phase("brute-force kernels (K3, K4) vs plain versions, config4 rays at "
           "1920x1080")
    brute_err = brute_phase(scene, cam, opts, tracer, device)

    _phase("goldens on the card through --tracer pallas and --tracer mat")
    golden_phase("config4", 192, 108, device, "pallas")
    golden_phase("config4", 192, 108, device, "mat")

    _phase("main path: cli render --config config4 --tracer pallas|mat")
    brute_launches, brute_calls = brute_main_path(img)

    _phase("brute-force kernel times")
    brute_t = {kind: brute_times(kind, brute_calls[kind]) for kind in BRUTE}
    del brute_calls

    _phase("BVH walk kernel vs plain version and vs K5, config4 rays at "
           "1920x1080; main path: cli render --config config4 --tracer bvh")
    bvh = bvh_phase(scene, cam, opts, tracer, img, device)

    _phase("golden on the card through --tracer bvh")
    golden_phase("config4", 192, 108, device, "bvh")

    _phase("exact binning: config4's grid built with the separating-axis "
           "test")
    k5_exact = exact_grid_phase(scene, cam, opts, tracer, img, device)

    _phase("culled sweep: config4 1920x1080 d4, 32x160 blocks, cap 1024")
    cull = cull_phase(scene, cam, opts, tracer, img, traced, device)

    _phase("main path: cli render --config config3 --compact 0.5 (1024x1024 "
           "d4)")
    k5_c3, frame3 = compact_phase(device)

    _phase("main path: config3 1024x1024 d4 glass fwd+bwd (plan-compacted "
           "replay of K1's full plan)")
    k1_glass = glass_step_phase(frame3, device)
    del frame3

    _phase("fused kernel vs plain version on the card")
    fused_err = {m: 0.0 for m in K1_MODES}

    def worst(errs):
        for m, e in errs.items():
            fused_err[m] = max(fused_err[m], e)

    frames = {}
    for tag, name, w, h, depth in (
            ("config1 256x256 d0", "config1", 256, 256, None),
            ("config2 1920x1080 d2", "config2", 1920, 1080, 2),
            ("config3 1024x1024 d4", "config3", 0, 0, None)):
        fw, case = fused_case(name, device, w, h, depth)
        worst(fused_compare(name, fw))
        if name != "config1":
            frames[tag] = (fw, case)
    init, target, cam5, opts5 = presets.config5_inverse()
    fw5 = F.FusedWhitted(init, cam5, opts5, device=device, param_inputs=True)
    first = fw5.render()
    fw5.bind(center=target.spheres.center, albedo=target.materials.albedo)
    assert float((fw5.render() - first).abs().max()) > 0.1, "bind moved nothing"
    worst(fused_compare("config5 (bound)", fw5))

    _phase("goldens on the card through the fused path")
    fused_golden("config1", 256, 256, device, IMG_TOL, IMG_BAD)
    fused_golden("config2", 256, 256, device, IMG_TOL, IMG_BAD)
    fused_golden("config3", 96, 96, device, GLASS_TOL, GLASS_BAD, GLASS_MEAN)

    _phase("main path: cli render --tracer fused (image mode)")
    k1_launches = {"image": sum(fused_main_path(device).values())}

    _phase("main path: FusedWhitted.render_plan (full plan)")
    k1_plan_paths = {"FusedWhitted.render_plan": plan_main_path(frames)}

    _phase("K1's full plan replays to K1's image")
    fused_replay_phase(frames["config2 1920x1080 d2"], device)

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

    _phase("repairs: 345 table floats; glass-free max_depth 40")
    deep_err, err_k = repairs_phase(device)
    worst(deep_err)
    train_err = max(train_err, err_k)

    _phase("fused train kernel against central differences")
    for tag, name, w, h, depth, probes in (
            ("config2 256x256 d2", "config2", 256, 256, 2,
             [("albedo", (0, 0)), ("center", (0, 1))]),
            ("config3 96x96 d4", "config3", 96, 96, 4,
             [("albedo", (1, 1)), ("center", (1, 0))])):
        fw, target = train_case(name, device, w, h, depth)
        train_fd(tag, fw, target, probes)

    _phase("main path: cli optimize --kernel")
    k1_launches["live_plan"], train_launches = optimize_main_path()

    _phase("main path: cli optimize (autograd), --plan, --preset mesh")
    k1_plan_paths["cli optimize --plan --steps 30"] = trainers_main_path()
    k1_plan_paths["config3 1024x1024 d4 glass fwd+bwd step "
                  "(value_and_grad_replay, cap 1)"] = k1_glass

    _phase("multi-device: render_sharded (config4 1080p d4: grid, bvh), "
           "plan_value_and_grad_sharded, make_loss_and_grad over NCCL")
    md = multidevice_phase()
    k1_launches["plan"] = sum(k1_plan_paths.values())
    k1_live_paths = {"cli optimize --kernel --steps 30":
                     k1_launches["live_plan"],
                     **md["fused_whitted_live_plan"],
                     **tool["fused_whitted_live_plan"]}
    k1_launches["live_plan"] = sum(k1_live_paths.values())
    k1_paths = {"image": {"cli render --tracer fused": k1_launches["image"]},
                "live_plan": k1_live_paths, "plan": k1_plan_paths}

    _phase("fused kernel times")
    k1 = {m: {"ms": 0.0, "plain_ms": 0.0, "ops": 0.0, "bytes": 0.0}
          for m in K1_MODES}
    for tag, (fw, case) in frames.items():
        res, plain = fused_times(tag, fw, case, device)
        for m in K1_MODES:
            for key, v in zip(("ms", "ops", "bytes"), res[m]):
                k1[m][key] += v
            k1[m]["plain_ms"] += plain[m]
    for m in K1_MODES:
        k1[m]["bound_ms"], k1[m]["bound_by"] = bound_ms(k1[m]["ops"],
                                                        k1[m]["bytes"])
        print(f"fused kernel, {m}, over both main-path frames: "
              f"{k1[m]['ms']:.4f} ms, plain {k1[m]['plain_ms']:.3f} ms, "
              f"bound {k1[m]['bound_ms']:.4f} ms ({k1[m]['bound_by']}), "
              f"{k1[m]['bound_ms'] / k1[m]['ms']:.1%} of bound", flush=True)

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
    print(f"train kernel over both bench frames: {train_ms:.4f} ms, training "
          f"step {train_step_ms:.4f} ms, plain {train_plain_ms:.3f} ms, bound "
          f"{train_bound:.4f} ms ({train_by})", flush=True)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all",
          flush=True)
    print(json.dumps({"kernels": [{
        "name": "grid_walk", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/grid_walk.cu",
        "replaces": "raytracer_tpu/ops/pallas_walk.py:111",
        "launches": launches + k5_step + k5_c3 + k5_exact
        + sum(md["grid_walk"].values()) + sum(tool["grid_walk"].values()),
        "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": walk_bound, "bound_by": walk_by,
        "library_ms": None, "main_paths": {
            "cli render --config config4 (1080p d4 frame)": launches,
            "config4 1080p d4 fwd+bwd step (record_plan)": k5_step,
            "cli render --config config3 --compact 0.5 (1024² d4 frame)":
                k5_c3,
            "config4 1080p d4 frame on the exact grid": k5_exact,
            **md["grid_walk"], **tool["grid_walk"]}}] + [{
        "name": "fused_whitted" + ("" if m == "image" else "_" + m),
        "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/fused_whitted.cu",
        "replaces": "raytracer_tpu/ops/fused.py:326",
        "launches": k1_launches[m], "max_abs_err": fused_err[m],
        "ms": k1[m]["ms"], "plain_ms": k1[m]["plain_ms"],
        "bound_ms": k1[m]["bound_ms"], "bound_by": k1[m]["bound_by"],
        "library_ms": None, "main_paths": k1_paths[m]}
        for m in K1_MODES] + [{
        "name": "fused_train", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/fused_train.cu",
        "replaces": "raytracer_tpu/ops/fused.py:326 (train)",
        "launches": train_launches + sum(md["fused_train"].values())
        + sum(tool["fused_train"].values()),
        "max_abs_err": train_err,
        "ms": train_ms, "plain_ms": train_plain_ms, "bound_ms": train_bound,
        "bound_by": train_by, "library_ms": None, "main_paths": {
            "cli optimize --kernel --steps 30": train_launches,
            **md["fused_train"], **tool["fused_train"]}}] + [{
        "name": BRUTE[kind][1 + m], "route": "cuda", "source": BRUTE[kind][3],
        "replaces": f"{BRUTE[kind][4]}:{BRUTE[kind][5][m]}",
        "launches": brute_launches[kind][m],
        "max_abs_err": brute_err[kind][mode], "ms": brute_t[kind][mode][0],
        "plain_ms": brute_t[kind][mode][1],
        "bound_ms": brute_t[kind][mode][2],
        "bound_by": brute_t[kind][mode][3], "library_ms": None}
        for kind in BRUTE for m, mode in enumerate(("nearest", "occluded"))]
        + [{
        "name": "bvh_walk", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/bvh_walk.cu",
        "replaces": "raytracer_tpu/accel/bvh.py:348 (XLA while_loop; no "
                    "pallas_call)",
        "launches": bvh["launches"] + sum(md["bvh_walk"].values()),
        "max_abs_err": bvh["err"],
        "ms": bvh["ms"], "plain_ms": bvh["plain_ms"],
        "bound_ms": bvh["bound_ms"], "bound_by": bvh["bound_by"],
        "library_ms": None, "main_paths": {
            "cli render --config config4 --tracer bvh (1080p d4 frame)":
                bvh["launches"], **md["bvh_walk"]}}, {
        "name": "cull_sweep", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/cull_sweep.cu",
        "replaces": "raytracer_tpu/accel/cull.py:141 and :162 "
                    "(_dense_nearest, _dense_occluded: XLA; no pallas_call)",
        "launches": sum(cull["launches"].values()),
        "max_abs_err": cull["err"], "ms": cull["ms"],
        "plain_ms": cull["plain_ms"], "bound_ms": cull["bound_ms"],
        "bound_by": cull["bound_by"], "library_ms": None,
        "main_paths": cull["launches"]}, {
        "name": "bounce_shade", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/bounce_shade.cu",
        "replaces": "none (plain torch shading of renderer.bounce_step)",
        "launches": k6["launches_frame"] + k6["launches_step"],
        "max_abs_err": 0.0, "ms": k6["call_ms"], "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
        "library_ms": None, "main_paths": {
            "cli render --config config4 (1080p d4 frame)":
                k6["launches_frame"],
            "config4 1080p d4 fwd+bwd step (the plan's record, the "
            "replay, its recompute)": k6["launches_step"]}}, {
        "name": "bounce_adjoint", "route": "cuda",
        "source": "raytracer_tpu_torch/csrc/bounce_adjoint.cu",
        "replaces": "none (torch.autograd of the plain torch shading of "
                    "renderer.bounce_step)",
        "launches": k7["launches_step"], "max_abs_err": max(
            k7["max_rel"].values()),
        "ms": k7["call_ms"], "plain_ms": k7["plain_ms"],
        "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
        "library_ms": None, "main_paths": {
            "config4 1080p d4 fwd+bwd step (the replay's backward)":
                k7["launches_step"]}}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
