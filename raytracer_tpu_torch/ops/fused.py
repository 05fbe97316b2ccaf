"""Fused Whitted forward and train step: the whole render of a mesh-free
scene in one kernel launch per band, and the loss and gradients of a
training step in one more (counterpart of `raytracer_tpu/ops/fused.py`).

Per pixel of a `(row0, rows)` band: raygen, the winner search over the
scene's spheres, planes and up to `MAX_FUSED_TRIS` flat triangles, Phong
with one shadow any-hit per light, fresnel, and the depth-first mirror/glass
recursion to `max_depth` (one child per node without glass, a binary tree of
2^(D+1)−1 nodes with glass). `render_plan` also returns the replay plan: per
recursion node, the winner-id plane ([rows, W] i32, −1 = miss) and the
per-light shadow bitmask plane (bit l = light l occluded).

Two versions of the same function, behind `FusedWhitted`:
- `fused_whitted_cuda` launches `csrc/fused_whitted.cu` (one thread per
  pixel, the scene in shared memory, an explicit per-thread stack) in one
  of three modes: the image alone (`render`: only the live nodes, those
  whose radiance reaches the pixel, are traced), the live plan (inside
  `plan_value_and_grad`: of the live nodes, the plan entries that the train
  kernel reads; the others left unwritten or 0) or the full plan
  (`render_plan`: every node's entries, the reference's contract);
- `fused_whitted_plain` is the plain torch version, vectorised over the
  band's pixels and recursing in Python in the same depth-first order. It
  writes every node's entries, so it is the plain version of all three
  modes: what the kernel skips changes no pixel and no entry that the train
  kernel reads.
Both transcribe the reference kernel's own expressions (not the wavefront
renderer's), op for op. A `FusedWhitted` on a CPU device renders with the
plain version; on a CUDA device with the kernel, or it raises.

`plan_value_and_grad` is one training step on a band: the forward records
the plan, and the train step replays it (each node's winner from the plan,
only its t recomputed, shadow bits from the plan) to form
Σ (clip(rad, 0, 1) − target)² and its gradient with respect to every table.
Again two versions: `fused_train_cuda` launches `csrc/fused_train.cu` (a
hand-written adjoint of the tree), `fused_train_plain` runs torch autograd
over the forward's own node body in replay mode. Both give the reference's
gradients at ties (see `ops/safemath.py`).

The scene lives in four tables on the object's device, packed exactly as the
reference packs its param-mode inputs (sph [S,4] center|radius, pln [P,9]
point|normal|albedo2, mat [M,7] albedo|kd|ks|spec_n|ior, lgt [L,6]
pos|intensity; an absent primitive kind keeps one zero row), plus static
data that `bind` never moves (plane tangent frames and checker flags,
triangle v0/e1/e2/normal, material ids and types, the camera). Baked and
param mode run the same code on the same tables: `param_inputs=True` only
allows `bind` to write new values into them, with no rebuild. Primitive
counts come from the scene, never from table heights.
"""

import math

import numpy as np
import torch

from raytracer_tpu_torch.core.types import (REFLECTION,
                                            REFLECTION_AND_REFRACTION, Camera,
                                            RenderOptions, Scene)
from raytracer_tpu_torch.ops.safemath import abs1 as _abs
from raytracer_tpu_torch.ops.safemath import clip as _clip
from raytracer_tpu_torch.ops.safemath import const as _const
from raytracer_tpu_torch.ops.safemath import maximum as _max

# Baked triangles are swept per ray like spheres and planes: fine for scene
# geometry (Cornell walls), ruinous for real meshes (those take the grid).
MAX_FUSED_TRIS = 64
# Glass doubles the recursion per bounce: 2^(D+1)−1 nodes per pixel.
MAX_GLASS_DEPTH = 5
# The occlusion plane packs one bit per light into an int32.
MAX_PLAN_LIGHTS = 32
# The kernel stages the packed scene in shared memory (static 48 KB window).
KERNEL_SMEM_BYTES = 48 * 1024
# The train kernel keeps a column of accumulators per thread in shared
# memory: the loss, a window of table floats (whole table rows, of G = 4·S +
# 9·P + 7·M + 6·L, padded heights) and a sink of the widest row.
# TRAIN_THREADS columns beside the scene must fit TRAIN_SMEM_BYTES
# (csrc/fused_train.cu: kTrainThreads, kTrainSmemBytes, kMaxRow): one launch
# per window, one window whenever the table fits.
TRAIN_THREADS = 128
TRAIN_SMEM_BYTES = 232448
_MAX_ROW = 9
_MODES = {"image": 0, "live_plan": 1, "plan": 2}

_DET_EPS = 1e-8
_INF = math.inf

# Kernel launches since the last reset: the forward kernel by mode
# (`launches`: image, `live_plan_launches`, `plan_launches`: full plan) and
# the train kernel (`train_launches`, one per gradient window). Incremented
# only where a kernel is launched; callers that must show a kernel ran set
# them to 0 and read them.
launches = 0
live_plan_launches = 0
plan_launches = 0
train_launches = 0


def supported(scene: Scene) -> bool:
    """Fused path: all materials; meshes only if tiny, flat-shaded and
    without UVs (the baked triangles have no st-checker stage)."""
    mesh_ok = scene.meshes.count == 0 or (
        scene.meshes.count <= MAX_FUSED_TRIS and not scene.meshes.smooth
        and not scene.meshes.has_uv)
    return bool(mesh_ok)


def _pad1(a):
    """Tables keep ≥1 row even for an absent primitive kind (a zero row)."""
    return a if a.shape[0] else np.zeros((1,) + a.shape[1:], np.float32)


def _pack_tables(scene: Scene):
    """The four live tables (numpy f32), exactly as the reference packs them."""
    s = scene
    sph = _pad1(np.concatenate(
        [np.asarray(s.spheres.center, np.float32).reshape(-1, 3),
         np.asarray(s.spheres.radius, np.float32).reshape(-1, 1)], axis=1))
    pln = _pad1(np.concatenate(
        [np.asarray(s.planes.point, np.float32).reshape(-1, 3),
         np.asarray(s.planes.normal, np.float32).reshape(-1, 3),
         np.asarray(s.planes.albedo2, np.float32).reshape(-1, 3)], axis=1))
    mat = _pad1(np.concatenate(
        [np.asarray(s.materials.albedo, np.float32).reshape(-1, 3),
         np.asarray(s.materials.kd, np.float32).reshape(-1, 1),
         np.asarray(s.materials.ks, np.float32).reshape(-1, 1),
         np.asarray(s.materials.spec_n, np.float32).reshape(-1, 1),
         np.asarray(s.materials.ior, np.float32).reshape(-1, 1)], axis=1))
    lgt = _pad1(np.concatenate(
        [np.asarray(s.lights.pos, np.float32).reshape(-1, 3),
         np.asarray(s.lights.intensity, np.float32).reshape(-1, 3)], axis=1))
    return sph, pln, mat, lgt


def _tri_data(scene: Scene) -> np.ndarray:
    """[T, 12] f32: v0 | e1 | e2 | flat normal, the normal computed exactly
    as the reference bakes it (normalize(cross(e1, e2)) in f32)."""
    rows = []
    if scene.meshes.count:
        verts = np.asarray(scene.meshes.verts, np.float32)
        tris = np.asarray(scene.meshes.tris)
        for i in range(scene.meshes.count):
            v0, v1, v2 = (verts[tris[i, k]] for k in range(3))
            e1, e2 = v1 - v0, v2 - v0
            cr = np.cross(e1, e2).astype(np.float32)
            n2 = np.float32(np.dot(cr, cr))
            inv = (np.float32(1.0) / np.sqrt(n2) if n2 > 1e-12
                   else np.float32(1.0))
            nrm = (cr * inv).astype(np.float32)
            rows.append(np.concatenate([v0, e1, e2, nrm]))
    return np.asarray(rows, np.float32).reshape(-1, 12)


def _nodes(has_glass: bool, max_depth: int) -> int:
    return (1 << (max_depth + 1)) - 1 if has_glass else max_depth + 1


def _node_off(has_glass: bool, depth: int) -> int:
    return (1 << depth) - 1 if has_glass else depth


class FusedWhitted:
    """Build once per (scene, camera, opts) on a device; call `.render`.

    `render(row0, rows, eps)` → image [rows, W, 3] f32 in [0, 1];
    `render_plan(...)` → (image, win_planes, occ_planes), n_nodes planes of
    [rows, W] i32 each; `bind(...)` (param mode) moves the live parameters.
    `eps` (keep 0) is added to the camera's x: the data-dependency hook for
    chained timing.
    """

    def __init__(self, scene: Scene, camera: Camera, opts: RenderOptions, *,
                 device, param_inputs: bool = False):
        if not supported(scene):
            raise ValueError("fused path: meshes must be tiny "
                             f"(≤{MAX_FUSED_TRIS} triangles), flat-shaded "
                             "and without UVs")
        self.has_glass = bool(scene.has_glass)
        if self.has_glass and opts.max_depth > MAX_GLASS_DEPTH:
            raise ValueError("fused glass recursion capped at depth "
                             f"{MAX_GLASS_DEPTH}")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"FusedWhitted on {device}: no CUDA device is "
                               "available")
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"FusedWhitted runs on cpu or cuda, not {device}")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.opts = opts
        self._param = bool(param_inputs)
        self.n_nodes = _nodes(self.has_glass, opts.max_depth)
        self.counts = (scene.spheres.count, scene.planes.count,
                       scene.meshes.count,
                       np.asarray(scene.materials.mtype).shape[0],
                       scene.lights.count)

        f32 = lambda a: torch.from_numpy(np.ascontiguousarray(
            a, np.float32)).to(device)
        self.sph, self.pln, self.mat, self.lgt = (
            f32(t) for t in _pack_tables(scene))

        # static data: plane tangent frame + checker, triangle geometry,
        # material ids per primitive and type per material, the camera
        pl = scene.planes
        pstat = np.concatenate(
            [np.asarray(pl.tangent, np.float32).reshape(-1, 3),
             np.asarray(pl.bitangent, np.float32).reshape(-1, 3),
             np.asarray(pl.checker_scale, np.float32).reshape(-1, 1),
             (np.asarray(pl.checker).reshape(-1, 1) != 0).astype(np.float32)],
            axis=1)
        self._pstat_np = pstat
        self._tri_np = _tri_data(scene)
        stat = np.concatenate([pstat.reshape(-1), self._tri_np.reshape(-1)])
        self.stat = f32(stat if stat.size else np.zeros((1,), np.float32))
        mids = np.concatenate([np.asarray(scene.spheres.mat_id),
                               np.asarray(scene.planes.mat_id),
                               np.asarray(scene.meshes.mat_id)]).astype(np.int32)
        self._mids_np = mids
        self._mtype_np = np.asarray(scene.materials.mtype, np.int32)
        self.ids = torch.from_numpy(np.concatenate(
            [mids, self._mtype_np]).astype(np.int32)).to(device)

        pos = np.asarray(camera.pos, np.float32).reshape(3)
        c2w = np.asarray(camera.c2w, np.float32).reshape(9)
        scale = np.float32(np.tan(np.deg2rad(
            float(np.asarray(camera.fov_deg))) / 2.0))
        aspect = np.float32(float(opts.width) / float(opts.height))
        self.cam = f32(np.concatenate([pos, c2w, [scale, aspect]]))

    # -- param mode ---------------------------------------------------------
    def bind(self, center=None, albedo=None, radius=None, kd=None, ks=None,
             spec_n=None, ior=None, plane_point=None, plane_normal=None,
             plane_albedo2=None, light_pos=None, light_intensity=None):
        """Param mode: write live parameter values into the four tables in
        place (no rebuild): sphere center/radius, material
        albedo/kd/ks/spec_n/ior, plane point/normal/albedo2, light
        pos/intensity. Values are array-likes or tensors (on any device).
        Returns self."""
        if not self._param:
            raise ValueError("build with param_inputs=True to bind params")
        for tab, col, width, val in (
                (self.sph, 0, 3, center), (self.sph, 3, 1, radius),
                (self.pln, 0, 3, plane_point), (self.pln, 3, 3, plane_normal),
                (self.pln, 6, 3, plane_albedo2), (self.mat, 0, 3, albedo),
                (self.mat, 3, 1, kd), (self.mat, 4, 1, ks),
                (self.mat, 5, 1, spec_n), (self.mat, 6, 1, ior),
                (self.lgt, 0, 3, light_pos), (self.lgt, 3, 3, light_intensity)):
            if val is not None:
                v = (val.detach() if isinstance(val, torch.Tensor)
                     else torch.from_numpy(np.asarray(val, np.float32)))
                v = v.to(tab.device, torch.float32).reshape(-1, width)
                tab[:v.shape[0], col:col + width] = v
        return self

    # -- rendering ----------------------------------------------------------
    def _band(self, row0, rows):
        rows = self.opts.height - row0 if rows is None else rows
        if row0 < 0 or rows < 1 or row0 + rows > self.opts.height:
            raise ValueError(f"band rows [{row0}, {row0 + rows}) outside the "
                             f"{self.opts.height}-row frame")
        return rows

    def _run(self, row0, rows, eps, mode):
        rows = self._band(row0, rows)
        if mode != "image" and self.counts[4] > MAX_PLAN_LIGHTS:
            raise ValueError("plan emission packs per-light occlusion into "
                             f"int32 bits (≤{MAX_PLAN_LIGHTS} lights)")
        if self.device.type == "cpu":
            return fused_whitted_plain(self, row0, rows, eps,
                                       mode != "image")
        return fused_whitted_cuda(self, row0, rows, eps, mode)

    def render(self, row0: int = 0, rows: int | None = None, eps=0.0):
        """→ image [rows, W, 3] in [0, 1] (a band of the full projection).
        On the card only the nodes whose radiance reaches a pixel are
        traced."""
        return self._run(row0, rows, eps, "image")[0]

    def render_plan(self, row0: int = 0, rows: int | None = None, eps=0.0):
        """→ (image, win_planes, occ_planes): the forward render plus, per
        recursion node in (depth, path-prefix) order, the winner-id plane
        and the per-light occlusion bitmask plane, for every node of every
        pixel's tree (the reference's contract)."""
        img, plan = self._run(row0, rows, eps, "plan")
        n = self.n_nodes
        return img, tuple(plan[:n].unbind(0)), tuple(plan[n:].unbind(0))

    # -- training -----------------------------------------------------------
    def plan_value_and_grad(self, target, row0: int = 0,
                            rows: int | None = None, eps=0.0):
        """One training step's loss and gradients for a band →
        (loss_sum, grads, img).

        The forward renders the band and records its plan (on the card the
        live plan: only the entries that the train kernel reads); the train
        kernel (`fused_train_cuda`; `fused_train_plain` on a CPU object)
        replays the plan against the live tables and returns Σ over the
        band of (clip(rad, 0, 1) − target)² and its gradient with respect
        to each table (sph [S,4] center|radius, pln [P,9]
        point|normal|albedo2, mat [M,7] albedo|kd|ks|spec_n|ior, lgt [L,6]
        pos|intensity). `target` is the band's own [rows, W, 3] image.
        Normalise outside (÷ rows·W·3 for a mean). Param mode only."""
        if not self._param:
            raise ValueError("build with param_inputs=True to train")
        rows = self._band(row0, rows)
        target = _check_target(self, rows, target)
        img, plan = self._run(row0, rows, eps, "live_plan")
        if self.device.type == "cpu":
            n = self.n_nodes
            loss, grads = fused_train_plain(self, row0, rows, plan[:n],
                                            plan[n:], target, eps)
        else:
            loss, grads = fused_train_cuda(self, row0, rows, plan, target,
                                           eps)
        return loss, grads, img

    def plan_value_and_grad_sharded(self, target, mesh, eps=0.0):
        """The data-parallel training step on the ranks of `mesh`
        (`parallel.mesh.RtMesh`) → (loss_sum, grads), the same on every
        rank: `plan_value_and_grad` of the whole frame, summed over bands.

        Each rank runs `plan_value_and_grad` on its band of H / T rows
        (tile t: rows [t·H/T, (t+1)·H/T)) against that band of `target`
        (the frame's [H, W, 3] image): it renders and records the plan of
        its own band only. The loss and the four gradient tables are then
        all-reduced over 'tiles' (one flat sum). Param mode only; H must
        split evenly over the tiles."""
        import torch.distributed as dist

        h = self.opts.height
        n_tiles = mesh.shape["tiles"]
        if h % n_tiles:
            raise ValueError(f"height {h} does not split over {n_tiles} "
                             "tiles")
        rows = h // n_tiles
        r0 = mesh.tile * rows
        target = _check_target(self, h, target)[r0:r0 + rows]
        loss, grads, _ = self.plan_value_and_grad(target, r0, rows, eps)
        names = ("sph", "pln", "mat", "lgt")
        flat = torch.cat([loss.reshape(1)]
                         + [grads[k].reshape(-1) for k in names])
        dist.all_reduce(flat, group=mesh.tiles_group)
        out, k = {}, 1
        for name in names:
            g = grads[name]
            out[name] = flat[k:k + g.numel()].view(g.shape)
            k += g.numel()
        return flat[0], out


def _check_target(fw: FusedWhitted, rows: int, target) -> torch.Tensor:
    """The band's target as a [rows, W, 3] f32 tensor on the object's
    device; any other shape raises."""
    t = (target if isinstance(target, torch.Tensor)
         else torch.from_numpy(np.array(target, np.float32)))
    want = (rows, fw.opts.width, 3)
    if tuple(t.shape) != want:
        raise ValueError(f"target must be the band's [rows, W, 3] = "
                         f"{list(want)} image, got {list(t.shape)}")
    return t.to(device=fw.device, dtype=torch.float32).contiguous()


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

def grad_windows(tables, window: int):
    """The train kernel's launches: windows (g0, gn) of whole table rows,
    ≤`window` floats each, covering the tables' floats in order."""
    windows, g0, gn = [], 0, 0
    for t in tables:
        width = t.shape[1]
        for _ in range(t.shape[0]):
            if gn + width > window:
                windows.append((g0, gn))
                g0, gn = g0 + gn, 0
            gn += width
    return windows + [(g0, gn)]


def train_window(fw: "FusedWhitted") -> int:
    """Table floats one train launch accumulates for this object's scene:
    the widest window whose per-thread columns fit the block's shared memory
    beside the staged scene."""
    scene = -(-_smem_bytes(fw) // 16) * 16
    return (TRAIN_SMEM_BYTES - scene) // (4 * TRAIN_THREADS) - 1 - _MAX_ROW


def _smem_bytes(fw: FusedWhitted) -> int:
    """Shared memory the kernel stages the scene in, for this object."""
    ns, np_, nt, nm, nl = fw.counts
    floats = 4 * ns + 17 * np_ + 12 * nt + 7 * nm + 6 * nl + 14
    return 4 * (floats + ns + np_ + nt + nm)


def fused_whitted_cuda(fw: FusedWhitted, row0: int, rows: int, eps=0.0,
                       mode: str = "image"):
    """Launch the CUDA kernel on the current stream → (image [rows, W, 3]
    f32, plan [2·n_nodes, rows, W] i32 or None). `mode`: "image" (no plan),
    "plan" (every entry: `render_plan`'s contract) or "live_plan", whose
    plan is not `render_plan`'s: it holds the winners of the live nodes and
    only the occlusion bits the train kernel reads (diffuse hits, lights
    with ldn ≥ 0; the other bits 0), and the dead nodes' entries are
    undefined (torch.empty's). Pass a live plan to `fused_train_cuda` and
    nowhere else. Raises on any input the kernel does not take and on a
    refused launch."""
    global launches, live_plan_launches, plan_launches
    from raytracer_tpu_torch.kernels.build import load_library

    dev = fw.device
    if dev.type != "cuda":
        raise ValueError(f"fused_whitted_cuda needs a CUDA object, got {dev}")
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r}: expected one of {list(_MODES)}")
    opts = fw.opts
    ns, np_, nt, nm, nl = fw.counts
    smem = _smem_bytes(fw)
    if smem > KERNEL_SMEM_BYTES:
        raise ValueError(f"scene needs {smem} bytes of shared memory, the "
                         f"kernel has {KERNEL_SMEM_BYTES}")
    for name, x, dt, min_rows, width in (
            ("sph", fw.sph, torch.float32, max(ns, 1), 4),
            ("pln", fw.pln, torch.float32, max(np_, 1), 9),
            ("mat", fw.mat, torch.float32, max(nm, 1), 7),
            ("lgt", fw.lgt, torch.float32, max(nl, 1), 6)):
        if (x.device != dev or x.dtype != dt or x.dim() != 2
                or x.shape[0] < min_rows or x.shape[1] != width
                or not x.is_contiguous()):
            raise ValueError(f"table {name}: expected contiguous {dt} "
                             f"[≥{min_rows}, {width}] on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    w = opts.width
    lib = load_library()
    img = torch.empty((rows, w, 3), dtype=torch.float32, device=dev)
    plan = (None if mode == "image" else torch.empty(
        (2 * fw.n_nodes, rows, w), dtype=torch.int32, device=dev))
    deep = lib.rt_fused_whitted_deep_levels(opts.max_depth, int(fw.has_glass))
    scratch = (torch.empty((deep, 4, rows, w), dtype=torch.float32,
                           device=dev) if deep else None)
    bg = [float(c) for c in opts.background]
    rc = lib.rt_fused_whitted(
        fw.sph.data_ptr(), fw.pln.data_ptr(), fw.mat.data_ptr(),
        fw.lgt.data_ptr(), fw.stat.data_ptr(), fw.ids.data_ptr(),
        fw.cam.data_ptr(), ns, np_, nt, nm, nl, opts.max_depth,
        int(fw.has_glass), float(opts.t_min), float(opts.bias), *bg,
        w, opts.height, row0, rows, float(eps), _MODES[mode],
        img.data_ptr(), None if plan is None else plan.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused Whitted kernel launch failed: CUDA error "
                           f"{rc}")
    if mode == "image":
        launches += 1
    elif mode == "live_plan":
        live_plan_launches += 1
    else:
        plan_launches += 1
    return img, plan


def fused_train_cuda(fw: FusedWhitted, row0: int, rows: int, plan, target,
                     eps=0.0):
    """Launch the train kernel (csrc/fused_train.cu) on the current stream,
    once per window of table rows (`grad_windows` of `train_window`: one
    launch whenever the table fits) → (loss_sum [] f32,
    {"sph", "pln", "mat", "lgt"} gradients shaped like the tables).
    `plan`: the band's [2·n_nodes, rows, W] i32 plan as `fused_whitted_cuda`
    returns it in either plan mode (the win planes, then the occ planes; only
    the live nodes' entries are read); `target` [rows, W, 3] f32. Raises on
    any input the kernel does not take and on a refused launch."""
    global train_launches
    from raytracer_tpu_torch.kernels.build import load_library

    dev = fw.device
    if dev.type != "cuda":
        raise ValueError(f"fused_train_cuda needs a CUDA object, got {dev}")
    opts = fw.opts
    ns, np_, nt, nm, nl = fw.counts
    w = opts.width
    rows = fw._band(row0, rows)
    if nl > MAX_PLAN_LIGHTS:
        raise ValueError(f"the plan packs ≤{MAX_PLAN_LIGHTS} lights' shadow "
                         "bits")
    smem = _smem_bytes(fw)
    if smem > KERNEL_SMEM_BYTES:
        raise ValueError(f"scene needs {smem} bytes of shared memory, the "
                         f"kernel has {KERNEL_SMEM_BYTES}")
    tabs = (fw.sph, fw.pln, fw.mat, fw.lgt)
    for name, x, min_rows, width in (("sph", fw.sph, max(ns, 1), 4),
                                     ("pln", fw.pln, max(np_, 1), 9),
                                     ("mat", fw.mat, max(nm, 1), 7),
                                     ("lgt", fw.lgt, max(nl, 1), 6)):
        if (x.device != dev or x.dtype != torch.float32 or x.dim() != 2
                or x.shape[0] < min_rows or x.shape[1] != width
                or not x.is_contiguous()):
            raise ValueError(f"table {name}: expected contiguous float32 "
                             f"[≥{min_rows}, {width}] on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    n_grads = sum(t.numel() for t in tabs)
    want = (2 * fw.n_nodes, rows, w)
    if (not isinstance(plan, torch.Tensor) or plan.device != dev
            or plan.dtype != torch.int32 or tuple(plan.shape) != want
            or not plan.is_contiguous()):
        raise ValueError(f"plan: expected contiguous int32 {list(want)} on "
                         f"{dev}")
    if (not isinstance(target, torch.Tensor) or target.device != dev
            or target.dtype != torch.float32
            or tuple(target.shape) != (rows, w, 3)
            or not target.is_contiguous()):
        raise ValueError(f"target: expected contiguous float32 [{rows}, {w}, "
                         f"3] on {dev}")
    lib = load_library()
    n_blocks = lib.rt_fused_train_blocks(w, rows)
    windows = grad_windows(tabs, train_window(fw))
    partial = torch.empty((n_blocks, 1 + max(gn for _, gn in windows)),
                          dtype=torch.float32, device=dev)
    out = torch.empty((n_grads + 1,), dtype=torch.float32, device=dev)
    deep = lib.rt_fused_train_deep_nodes(opts.max_depth, int(fw.has_glass))
    scratch = (torch.empty((deep, 12, rows, w), dtype=torch.float32,
                           device=dev) if deep else None)
    bg = [float(c) for c in opts.background]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for g0, gn in windows:  # the loss with the first window
        rc = lib.rt_fused_train(
            *(t.data_ptr() for t in tabs), fw.stat.data_ptr(),
            fw.ids.data_ptr(), fw.cam.data_ptr(),
            *(t.shape[0] for t in tabs), ns, np_, nt, nm, nl,
            opts.max_depth, int(fw.has_glass), float(opts.t_min),
            float(opts.bias), *bg, w, opts.height, row0, rows, float(eps),
            plan.data_ptr(), target.data_ptr(), g0, gn, partial.data_ptr(),
            None if scratch is None else scratch.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"fused train kernel launch failed: CUDA "
                               f"error {rc}")
        train_launches += 1
        rc = lib.rt_fused_train_reduce(
            partial.data_ptr(), n_blocks, gn + 1,
            out.data_ptr() if g0 == 0 else None, out[1 + g0:].data_ptr(),
            stream)
        if rc != 0:
            raise RuntimeError(f"fused train reduction launch failed: CUDA "
                               f"error {rc}")
    grads, k = {}, 1
    for name, t in zip(("sph", "pln", "mat", "lgt"), tabs):
        grads[name] = out[k:k + t.numel()].view(t.shape)
        k += t.numel()
    return out[0], grads


# ---------------------------------------------------------------------------
# The plain torch version (the kernel's expressions, vectorised over pixels)
# ---------------------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sphere_t(o, d, c, r, t_min):
    L = (o[0] - c[0], o[1] - c[1], o[2] - c[2])
    a = _dot(d, d)
    b = 2.0 * _dot(d, L)
    c0 = _dot(L, L) - r * r
    disc = b * b - 4.0 * a * c0
    has = disc >= 0
    sq = torch.sqrt(_max(torch.where(has, disc, 1.0), 1e-12))
    sq = torch.where(has, sq, 0.0)
    q = -0.5 * (b + torch.where(b >= 0, sq, -sq))
    t0 = q / a
    okq = torch.abs(q) > 1e-12
    t1 = torch.where(okq, c0 / torch.where(okq, q, 1.0), -_INF)
    tlo = torch.minimum(t0, t1)
    thi = torch.maximum(t0, t1)
    t = torch.where(tlo > t_min, tlo,
                    torch.where(thi > t_min, thi, _INF))
    return torch.where(has, t, _INF)


def _plane_t(o, d, p, n, t_min):
    denom = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
    valid = torch.abs(denom) > _DET_EPS
    num = ((p[0] - o[0]) * n[0] + (p[1] - o[1]) * n[1]
           + (p[2] - o[2]) * n[2])
    t = torch.where(valid, num / torch.where(valid, denom, 1.0), -_INF)
    return torch.where(valid & (t > t_min), t, _INF)


def _tri_t(o, d, v0, e1, e2, t_min):
    pv = (d[1] * e2[2] - d[2] * e2[1],
          d[2] * e2[0] - d[0] * e2[2],
          d[0] * e2[1] - d[1] * e2[0])
    det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
    ok = torch.abs(det) > _DET_EPS
    inv = torch.where(ok, 1.0, 0.0) / torch.where(ok, det, 1.0)
    tv = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
    u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv
    qv = (tv[1] * e1[2] - tv[2] * e1[1],
          tv[2] * e1[0] - tv[0] * e1[2],
          tv[0] * e1[1] - tv[1] * e1[0])
    v = _dot(d, qv) * inv
    t = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > t_min)
    return torch.where(ok, t, _INF)


class _Prims:
    """Per-primitive accessors over the object's tensors, in the search's
    tie order (spheres, planes, triangles; lower index first). `tables`
    (sph, pln, mat, lgt) replaces the object's live tables: the train
    version reads leaf copies that autograd differentiates."""

    def __init__(self, fw: FusedWhitted, tables=None):
        ns, np_, nt, _, nl = fw.counts
        sph, pln, mat, lgt = tables or (fw.sph, fw.pln, fw.mat, fw.lgt)
        tri = torch.from_numpy(fw._tri_np).to(fw.device)
        pst = torch.from_numpy(fw._pstat_np).to(fw.device)
        mtype = fw._mtype_np
        self.prims = []
        for i, mid in enumerate(fw._mids_np.tolist()):
            m = mat[mid]
            p = dict(alb=(m[0], m[1], m[2]), kd=m[3], ks=m[4], spec_n=m[5],
                     ior=m[6], mirror=int(mtype[mid]) == REFLECTION,
                     glass=int(mtype[mid]) == REFLECTION_AND_REFRACTION)
            if i < ns:
                p.update(kind="s", c=(sph[i, 0], sph[i, 1], sph[i, 2]),
                         r=sph[i, 3])
            elif i < ns + np_:
                j = i - ns
                p.update(kind="p", p=(pln[j, 0], pln[j, 1], pln[j, 2]),
                         n=(pln[j, 3], pln[j, 4], pln[j, 5]),
                         a2=(pln[j, 6], pln[j, 7], pln[j, 8]),
                         tan=(pst[j, 0], pst[j, 1], pst[j, 2]),
                         bit=(pst[j, 3], pst[j, 4], pst[j, 5]),
                         cscale=pst[j, 6],
                         checker=bool(fw._pstat_np[j, 7]))
            else:
                j = i - ns - np_
                p.update(kind="t", v0=(tri[j, 0], tri[j, 1], tri[j, 2]),
                         e1=(tri[j, 3], tri[j, 4], tri[j, 5]),
                         e2=(tri[j, 6], tri[j, 7], tri[j, 8]),
                         n=(tri[j, 9], tri[j, 10], tri[j, 11]))
            self.prims.append(p)
        self.lights = [((lgt[li, 0], lgt[li, 1], lgt[li, 2]),
                        (lgt[li, 3], lgt[li, 4], lgt[li, 5]))
                       for li in range(nl)]

    def t(self, o, d, p, t_min):
        if p["kind"] == "s":
            return _sphere_t(o, d, p["c"], p["r"], t_min)
        if p["kind"] == "p":
            return _plane_t(o, d, p["p"], p["n"], t_min)
        return _tri_t(o, d, p["v0"], p["e1"], p["e2"], t_min)


def _eye_rays(fw: FusedWhitted, row0: int, rows: int, eps):
    """The band's primary rays (full-image projection) → (o, d), each a
    3-tuple of [rows·W] tensors."""
    opts, dev, cam = fw.opts, fw.device, fw.cam
    f32 = torch.float32
    w, h = opts.width, opts.height
    row = (torch.arange(rows, dtype=torch.int32, device=dev) + row0).to(f32)
    col = torch.arange(w, dtype=torch.int32, device=dev).to(f32)
    row = row[:, None].expand(rows, w).reshape(-1)
    col = col[None, :].expand(rows, w).reshape(-1)
    scale, aspect = cam[12], cam[13]
    # divide by device tensors: torch on CUDA divides by a Python number as
    # a product with its rounded reciprocal, an ulp off the kernel's quotient
    x = (2.0 * (col + 0.5) / _const(w, col) - 1.0) * aspect * scale
    y = (1.0 - 2.0 * (row + 0.5) / _const(h, row)) * scale
    dw = tuple(x * cam[3 + 3 * k] + y * cam[4 + 3 * k] - cam[5 + 3 * k]
               for k in range(3))
    inv = torch.rsqrt(_dot(dw, dw))
    d = (dw[0] * inv, dw[1] * inv, dw[2] * inv)
    eps = torch.as_tensor(eps, dtype=f32, device=dev)
    o = (torch.zeros_like(x) + cam[0] + eps, torch.zeros_like(x) + cam[1],
         torch.zeros_like(x) + cam[2])
    return o, d


def _tree(fw: FusedWhitted, sc: _Prims, o, d, plan_in=None, plan_out=None,
          stats=None):
    """Every pixel's Whitted tree, depth first → radiance (3 tensors).

    Search (`plan_in` None): the winner search and the shadow sweeps; with
    `plan_out` ([2·n_nodes, N] i32) the plan is written per node.
    Replay (`plan_in` = (win planes, occ planes), each [N]): the winner
    comes from the plan and only its t is recomputed (a recompute that
    misses demotes the node to a miss); the shadow bits come from the plan.

    `stats` (a dict) adds counts of work. In both modes, the live nodes:
    those reached through mirror/glass reflections and existing glass
    refractions of valid hits ("live"; what the train kernel and the
    forward's image and live-plan modes evaluate), those that are valid
    hits by winner kind ("live_s", "live_p", "live_t"), the diffuse ones
    ("live_diffuse") and the leaves ("live_leaf") among them, and their
    child rays ("reflect", "refract"). In search mode also the shadow-sweep
    intersection tests by primitive kind k, each sweep stopped at its first
    occluder as the kernel stops it: on every node ("shadow_k": the full
    plan's), on the live diffuse hits toward the lights with ldn ≥ 0
    ("live_shadow_k": the live plan's), and toward those with ldn > 0
    ("lit_shadow_k": the image's).
    """
    opts = fw.opts
    bg = tuple(float(c) for c in opts.background)
    t_min, bias = opts.t_min, opts.bias
    has_glass = fw.has_glass
    prims, lights = sc.prims, sc.lights
    n_nodes = fw.n_nodes
    zeros = torch.zeros_like(o[0])
    dev = zeros.device
    count = stats is not None

    def add(key, mask):
        stats[key] = stats.get(key, 0) + mask.sum()

    def occluded(o, d, max_t, swept, lit):
        occ = torch.zeros_like(max_t, dtype=torch.bool)
        for p in prims:
            if count:
                free = ~occ
                add("shadow_" + p["kind"], free)
                add("live_shadow_" + p["kind"], free & swept)
                add("lit_shadow_" + p["kind"], free & lit)
            occ = occ | (sc.t(o, d, p, t_min) < max_t)
        return occ

    def radiance(o, d, depth, path, live):
        node = _node_off(has_glass, depth) + path
        if plan_in is None:
            # winner search (strict < keeps sphere < plane < triangle order)
            best_t = torch.full_like(zeros, _INF)
            win = torch.full(zeros.shape, -1, dtype=torch.int32, device=dev)
            for i, p in enumerate(prims):
                ti = sc.t(o, d, p, t_min)
                better = ti < best_t
                best_t = torch.where(better, ti, best_t)
                win = torch.where(better, i, win)
            valid = win >= 0
            if plan_out is not None:
                plan_out[node] = win
        else:
            # replay: the plan's winner, its t recomputed (a primitive no
            # pixel of the band chose is skipped: its `where` selects nothing)
            win = plan_in[0][node]
            best_t = torch.full_like(zeros, _INF)
            for i, p in enumerate(prims):
                if bool((win == i).any()):
                    best_t = torch.where(win == i, sc.t(o, d, p, t_min),
                                         best_t)
            valid = (win >= 0) & (best_t < _INF)
        tt = torch.where(valid, best_t, 0.0)
        p_ = tuple(o[k] + tt * d[k] for k in range(3))

        # winner attributes (blends over the tiny scene)
        nrm = [zeros] * 3
        alb = [zeros] * 3
        kd, ks = zeros, zeros
        spec_n = torch.ones_like(zeros)
        ior = torch.ones_like(zeros)
        is_mir = torch.zeros_like(valid)
        is_gls = torch.zeros_like(valid)
        for i, p in enumerate(prims):
            msk = win == i
            if p["kind"] == "s":
                inv_r = 1.0 / p["r"]
                ni = tuple((p_[k] - p["c"][k]) * inv_r for k in range(3))
                ai = tuple(p["alb"][k].expand_as(zeros) for k in range(3))
            elif p["kind"] == "p":
                ni = tuple(p["n"][k].expand_as(zeros) for k in range(3))
                if p["checker"]:
                    rel = tuple(p_[k] - p["p"][k] for k in range(3))
                    u = _dot(rel, p["tan"]) * p["cscale"]
                    v = _dot(rel, p["bit"]) * p["cscale"]
                    pat = (u - torch.floor(u) > 0.5) ^ (v - torch.floor(v) > 0.5)
                    ai = tuple(torch.where(pat, p["a2"][k], p["alb"][k])
                               for k in range(3))
                else:
                    ai = tuple(p["alb"][k].expand_as(zeros) for k in range(3))
            else:
                ni = tuple(p["n"][k].expand_as(zeros) for k in range(3))
                ai = tuple(p["alb"][k].expand_as(zeros) for k in range(3))
            for k in range(3):
                nrm[k] = torch.where(msk, ni[k], nrm[k])
                alb[k] = torch.where(msk, ai[k], alb[k])
            kd = torch.where(msk, p["kd"], kd)
            ks = torch.where(msk, p["ks"], ks)
            spec_n = torch.where(msk, p["spec_n"], spec_n)
            ior = torch.where(msk, p["ior"], ior)
            if p["mirror"]:
                is_mir = is_mir | msk
            if p["glass"]:
                is_gls = is_gls | msk

        rad = [torch.where(valid, 0.0, bg[k]) for k in range(3)]
        is_diff = valid & ~is_mir & ~is_gls

        # Phong + one shadow any-hit per light, for every lane
        din = _dot(d, nrm)
        if plan_in is None:
            side = torch.where(din < 0, 1.0, -1.0)
            so = tuple(p_[k] + side * bias * nrm[k] for k in range(3))
        lamt = [zeros] * 3
        spec = [zeros] * 3
        occ_acc = torch.zeros_like(win)
        for li, (lpos, lint) in enumerate(lights):
            lvec = tuple(lpos[k] - p_[k] for k in range(3))
            d2 = _dot(lvec, lvec)
            dist = torch.sqrt(_max(d2, 1e-12))
            dist = torch.where(d2 > 0, dist, 0.0)
            il = 1.0 / _max(dist, 1e-12)
            ldir = tuple(lvec[k] * il for k in range(3))
            ldn = _max(_dot(ldir, nrm), 0.0)
            if plan_in is None:
                mld = _dot(ldir, nrm)
                swept = live & is_diff & ~(mld < 0)
                shadowed = occluded(so, ldir, dist, swept, swept & (mld > 0))
                occ_acc = occ_acc | (shadowed.to(torch.int32) << li)
            else:  # the recorded shadow bit
                shadowed = ((plan_in[1][node] >> li) & 1) != 0
            vis = torch.where(shadowed, 0.0, 1.0)
            mld = _dot(ldir, nrm)
            rl = tuple(-ldir[k] + 2.0 * mld * nrm[k] for k in range(3))
            base = -_dot(rl, d)
            pw = torch.where(base > 0,
                             torch.pow(_max(base, 1e-7), spec_n), 0.0)
            for k in range(3):
                lamt[k] = lamt[k] + vis * ldn * lint[k]
                spec[k] = spec[k] + pw * lint[k]
        if plan_out is not None:
            plan_out[n_nodes + node] = occ_acc
        for k in range(3):
            local = lamt[k] * alb[k] * kd + spec[k] * ks
            rad[k] = rad[k] + torch.where(is_diff, local, 0.0)

        # fresnel kr (kr = 1 on total internal reflection)
        cosi = _clip(din, -1.0, 1.0)
        entering = cosi <= 0
        etai = torch.where(entering, 1.0, ior)
        etat = torch.where(entering, ior, 1.0)
        s2 = _max(1.0 - cosi * cosi, 0.0)
        sq2 = torch.where(s2 > 0, torch.sqrt(_max(s2, 1e-12)), 0.0)
        sint = etai / etat * sq2
        no_tir = sint < 1.0
        c2 = _max(1.0 - sint * sint, 0.0)
        cost = torch.where(no_tir, torch.sqrt(_max(c2, 1e-12)), 0.0)
        cosa = _abs(cosi)
        den1 = etat * cosa + etai * cost
        den2 = etai * cosa + etat * cost
        rs = torch.where(no_tir, (etat * cosa - etai * cost)
                         / torch.where(no_tir, den1, 1.0), 0.0)
        rp = torch.where(no_tir, (etai * cosa - etat * cost)
                         / torch.where(no_tir, den2, 1.0), 0.0)
        kr = torch.where(no_tir, 0.5 * (rs * rs + rp * rp), 1.0)

        leaf = depth == opts.max_depth
        if count:
            add("live", live)
            hit = live & valid
            add("live_diffuse", hit & is_diff)
            for kind in "spt":
                add("live_" + kind, hit & torch.as_tensor(
                    [p["kind"] == kind for p in prims] + [False],
                    device=dev)[win.long()])
            if leaf:
                add("live_leaf", hit)
        if leaf:
            # children would exceed max_depth → each returns bg
            wl = torch.where(valid & is_mir, kr,
                             torch.where(valid & is_gls, 1.0, 0.0))
            for k in range(3):
                rad[k] = rad[k] + wl * bg[k]
            return rad

        # reflect child (weight kr on mirror and glass lanes)
        rdw = tuple(d[k] - 2.0 * din * nrm[k] for k in range(3))
        rinv = torch.rsqrt(_max(_dot(rdw, rdw), 1e-12))
        rd = tuple(rdw[k] * rinv for k in range(3))
        rside = torch.where(_dot(rd, nrm) < 0, -1.0, 1.0)
        ro = tuple(p_[k] + rside * bias * nrm[k] for k in range(3))
        if has_glass:  # the refract ray, before the reflect subtree
            ent_t = din < 0
            cosa_t = _abs(_clip(din, -1.0, 1.0))
            etai_t = torch.where(ent_t, 1.0, ior)
            etat_t = torch.where(ent_t, ior, 1.0)
            n_o = tuple(torch.where(ent_t, nrm[k], -nrm[k]) for k in range(3))
            eta = etai_t / etat_t
            kk = 1.0 - eta * eta * (1.0 - cosa_t * cosa_t)
            t_ok = kk >= 0
            sqk = torch.where(t_ok, torch.sqrt(_max(
                torch.where(t_ok, kk, 1.0), 1e-12)), 0.0)
            td = tuple(torch.where(t_ok, eta * d[k]
                                   + (eta * cosa_t - sqk) * n_o[k], 0.0)
                       for k in range(3))
            tn2 = _dot(td, td)
            tinv = torch.where(t_ok, 1.0 / torch.sqrt(_max(
                torch.where(t_ok, tn2, 1.0), 1e-12)), 1.0)
            td = tuple(td[k] * tinv for k in range(3))
            tside = torch.where(_dot(td, nrm) < 0, -1.0, 1.0)
            to = tuple(p_[k] + tside * bias * nrm[k] for k in range(3))
            on_t = valid & is_gls & t_ok
            w_t = torch.where(on_t, 1.0 - kr, 0.0)
        on_r = valid & (is_mir | is_gls)
        w_r = torch.where(on_r, kr, 0.0)
        if count:
            add("reflect", live & on_r)
        cr = radiance(ro, rd, depth + 1, path, live & on_r)
        for k in range(3):
            rad[k] = rad[k] + w_r * cr[k]
        if has_glass:
            # refract child: the path prefix gains the 2^depth bit
            if count:
                add("refract", live & on_t)
            ct = radiance(to, td, depth + 1, path + (1 << depth),
                          live & on_t)
            for k in range(3):
                rad[k] = rad[k] + w_t * ct[k]
        return rad

    return radiance(o, d, 0, 0, torch.ones_like(zeros, dtype=torch.bool))


@torch.no_grad()
def fused_whitted_plain(fw: FusedWhitted, row0: int, rows: int, eps=0.0,
                        emit_plan: bool = False, stats=None):
    """The plain torch version of the kernel, on the object's device →
    (image [rows, W, 3] f32, plan [2·n_nodes, rows, W] i32 or None). With
    `emit_plan` every node's entries are written: the plain version of both
    plan modes.

    With a `stats` dict, adds the work counts of this band (see `_tree`).
    """
    w = fw.opts.width
    plan = (torch.empty((2 * fw.n_nodes, rows * w), dtype=torch.int32,
                        device=fw.device) if emit_plan else None)
    o, d = _eye_rays(fw, row0, rows, eps)
    rad = _tree(fw, _Prims(fw), o, d, plan_out=plan, stats=stats)
    img = torch.stack([_clip(c, 0.0, 1.0) for c in rad],
                      dim=-1).reshape(rows, w, 3)
    if emit_plan:
        plan = plan.reshape(2 * fw.n_nodes, rows, w)
    return img, plan


def fused_train_plain(fw: FusedWhitted, row0: int, rows: int, wins, occs,
                      target, eps=0.0, *, band_rows: int | None = None,
                      stats=None):
    """The plain torch version of the train kernel → (loss_sum [] f32,
    {"sph", "pln", "mat", "lgt"}: d loss_sum / d table, shaped like the
    tables).

    Replays the plan (`wins`, `occs`: n_nodes planes [rows, W] i32 each)
    through the Whitted tree on fresh leaf copies of the four tables (`bind`
    writes the live ones in place), forms Σ (clip(rad, 0, 1) − target)² over
    the band's pixels (`target` [rows, W, 3] f32) and differentiates it with
    torch.autograd. `band_rows` splits the band into sub-bands whose losses
    and gradients add up (autograd over a whole 1080p tree holds every
    intermediate); `stats` counts the nodes the train kernel evaluates (see
    `_tree`).
    """
    rows = fw._band(row0, rows)
    tgt = _check_target(fw, rows, target)
    step = rows if band_rows is None else max(1, int(band_rows))
    leaves = tuple(t.detach().clone().requires_grad_(True)
                   for t in (fw.sph, fw.pln, fw.mat, fw.lgt))
    loss = torch.zeros((), dtype=torch.float32, device=fw.device)
    grads = [torch.zeros_like(t) for t in leaves]
    for r in range(0, rows, step):
        n = min(step, rows - r)
        with torch.enable_grad():
            o, d = _eye_rays(fw, row0 + r, n, eps)
            plan_in = ([x[r:r + n].reshape(-1) for x in wins],
                       [x[r:r + n].reshape(-1) for x in occs])
            rad = _tree(fw, _Prims(fw, leaves), o, d, plan_in=plan_in,
                        stats=stats)
            t = tgt[r:r + n].reshape(-1, 3)
            s = torch.zeros((), dtype=torch.float32, device=fw.device)
            for k in range(3):
                dk = _clip(rad[k], 0.0, 1.0) - t[:, k]
                s = s + (dk * dk).sum()
            g = torch.autograd.grad(s, leaves, allow_unused=True)
        loss = loss + s.detach()
        for acc, gi in zip(grads, g):
            if gi is not None:
                acc += gi
    return loss, dict(zip(("sph", "pln", "mat", "lgt"), grads))
