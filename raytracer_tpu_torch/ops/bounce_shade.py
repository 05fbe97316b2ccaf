"""The fused forward shading of a bounce: K6 (`csrc/bounce_shade.cu`).

On a CUDA device, a bounce that autograd does not record
(`fused_shading`) shades through two launches of K6 around its shadow
searches, where the torch bounce of `renderer.bounce_step` launches ~500
plain torch ops:
- `surface_cuda` (under `rt.surface`): `trace.surface_at`, then
  `shade.shade_diffuse`'s shadow set-up: the shadow origin, each light's
  direction, distance and search mask, and the diffuse mask;
- the shadow searches, unchanged tracer calls (`shade.shadow_search`);
- `shade_cuda` (under `rt.shade`): the Phong sums under the shadow bits,
  the leaf terms, `geometry.fresnel`, the children of `renderer._spawn`
  and the plan planes.

A bounce that autograd records on a glass-free scene (`adjoint_shading`)
takes the same two launches, its shade launch as the forward of an
autograd Function (`shade_recorded`) whose backward is K7
(`csrc/bounce_adjoint.cu`, `adjoint_cuda`): the hand-written adjoint of
the torch bounce's shading, one lane a thread, then the partial rows'
sum. That is the plan replay, its recompute, the `full` remat policy.

The torch bounce is the twin the kernels are held to (K6 bit for bit on
the card, K7 against torch.autograd of it; tests/test_torch_bounce_shade.py,
tests/test_torch_bounce_adjoint.py): it is what every CPU bounce runs,
and every recorded bounce K7 does not cover (glass, a scene tensor that
requires grad outside ADJOINT_TABLES). The scene's tables are read at each
call, whatever the tracer was built with.
"""

import collections
import ctypes
import dataclasses

import torch

from raytracer_tpu_torch.kernels.build import check_arg
from raytracer_tpu_torch.ops.trace import Hit
from raytracer_tpu_torch.utils.profiling import span

# Kernel launches since the last reset (two a fused bounce). Incremented
# only where the kernel is launched; callers that must show the kernel ran
# set it to 0 and read it.
launches = 0
# K7's launches since the last reset (two a window: the adjoint and the
# partial rows' sum), as `launches`.
adjoint_launches = 0

_N_PTRS = 47
_N_ADJ_PTRS = 42

# The scene tensors K7 differentiates (K2's set), by group: a recorded
# bounce whose scene has another tensor that requires grad keeps the
# torch bounce.
ADJOINT_TABLES = {"spheres": ("center", "radius"),
                  "planes": ("point", "normal", "albedo2"),
                  "materials": ("albedo", "kd", "ks", "spec_n", "ior"),
                  "lights": ("pos", "intensity")}
# Table floats of one K7 launch (whole rows): a thread's sums, a column of
# 1 + window + 9 floats, fit a block's 227 KB of shared memory.
ADJ_WINDOW = 440


def fused_shading(scene, state, radiance=None) -> bool:
    """Does this bounce shade through K6? When its rays are on a CUDA
    device and autograd records nothing for it (`autograd_records`)."""
    return (state[0].device.type == "cuda"
            and not autograd_records(scene, state, radiance))


def adjoint_shading(scene, state, radiance=None) -> bool:
    """Does this bounce shade through K6's shade launch under K7's
    adjoint (`shade_recorded`)? When its rays are on a CUDA device and K7
    covers what autograd records of it (`adjoint_covers`)."""
    return (state[0].device.type == "cuda"
            and adjoint_covers(scene, state, radiance))


def adjoint_covers(scene, state, radiance=None) -> bool:
    """K7's rule on any device: autograd records the bounce
    (`autograd_records`), the scene has no glass, and every scene tensor
    that requires grad is one K7 differentiates (ADJOINT_TABLES)."""
    if scene.has_glass or not autograd_records(scene, state, radiance):
        return False
    for group in ("spheres", "planes", "meshes", "materials", "lights"):
        table = getattr(scene, group)
        keep = ADJOINT_TABLES.get(group, ())
        for f in dataclasses.fields(table):
            x = getattr(table, f.name)
            if (f.name not in keep and isinstance(x, torch.Tensor)
                    and x.requires_grad):
                return False
    return True


def autograd_records(scene, state, radiance=None) -> bool:
    """Would autograd record this bounce: is grad mode on, and does a
    float tensor it reads (the scene's, the wavefront's o, d, thr, the
    radiance it adds into) require grad?"""
    from raytracer_tpu_torch.renderer import needs_grad

    return needs_grad(scene) or (torch.is_grad_enabled() and any(
        x is not None and x.requires_grad for x in (*state[:3], radiance)))


def scene_tables(scene, device):
    """The scene's tables as K6 reads them, checked (on `device`, dtype,
    shape) and made contiguous → (the tables in the C entry's order, the
    counts [ns, np, nt, nl]). An empty table (an empty group's, a flat
    mesh's normals, a uv-less mesh's uvs) is None: a null pointer. The
    caller holds the tables until both launches are enqueued: a copy that
    `contiguous` made would otherwise return to the allocator first."""
    f32, i32 = torch.float32, torch.int32
    sp, pl, me = scene.spheres, scene.planes, scene.meshes
    mats, lights = scene.materials, scene.lights
    ns, np_, nt, nl = sp.count, pl.count, me.count, lights.count
    nv, nm = me.verts.shape[0], mats.mtype.shape[0]
    rows = [("spheres.center", sp.center, f32, (ns, 3)),
            ("spheres.radius", sp.radius, f32, (ns,)),
            ("spheres.mat_id", sp.mat_id, i32, (ns,)),
            ("planes.point", pl.point, f32, (np_, 3)),
            ("planes.normal", pl.normal, f32, (np_, 3)),
            ("planes.tangent", pl.tangent, f32, (np_, 3)),
            ("planes.bitangent", pl.bitangent, f32, (np_, 3)),
            ("planes.mat_id", pl.mat_id, i32, (np_,)),
            ("planes.checker", pl.checker, i32, (np_,)),
            ("planes.checker_scale", pl.checker_scale, f32, (np_,)),
            ("planes.albedo2", pl.albedo2, f32, (np_, 3)),
            ("meshes.verts", me.verts, f32, (nv, 3)),
            ("meshes.tris", me.tris, i32, (nt, 3)),
            ("meshes.normals", me.normals, f32,
             (nv if me.smooth else 0, 3)),
            ("meshes.mat_id", me.mat_id, i32, (nt,)),
            ("meshes.uvs", me.uvs, f32, (nv if me.has_uv else 0, 2)),
            ("meshes.checker", me.checker, i32, (nt,)),
            ("meshes.checker_scale", me.checker_scale, f32, (nt,)),
            ("meshes.albedo2", me.albedo2, f32, (nt, 3)),
            ("materials.mtype", mats.mtype, i32, (nm,)),
            ("materials.albedo", mats.albedo, f32, (nm, 3)),
            ("materials.kd", mats.kd, f32, (nm,)),
            ("materials.ks", mats.ks, f32, (nm,)),
            ("materials.spec_n", mats.spec_n, f32, (nm,)),
            ("materials.ior", mats.ior, f32, (nm,)),
            ("lights.pos", lights.pos, f32, (nl, 3)),
            ("lights.intensity", lights.intensity, f32, (nl, 3))]
    tables = []
    for name, x, dtype, shape in rows:
        x = x.contiguous()
        check_arg(name, x, dtype, shape, device)
        tables.append(x if x.numel() else None)
    return tables, [ns, np_, nt, nl]


def _check_wavefront(o, d, alive, hit, thr=None):
    n, dev = o.shape[0], o.device
    if dev.type != "cuda":
        raise ValueError(f"K6 needs CUDA rays, got {dev}")
    if n >= 1 << 31:
        raise ValueError(f"too many lanes for one launch: {n}")
    f32, i32 = torch.float32, torch.int32
    args = [("o", o, f32, (n, 3)), ("d", d, f32, (n, 3)),
            ("alive", alive, torch.bool, (n,)),
            ("hit.kind", hit.kind, i32, (n,)),
            ("hit.idx", hit.idx, i32, (n,))]
    if thr is not None:
        args.append(("thr", thr, f32, (n, 3)))
    for name, x, dtype, shape in args:
        check_arg(name, x, dtype, shape, dev)


def _launch(half, wave, tables, outs, ints, opts):
    global launches
    from raytracer_tpu_torch.kernels.build import load_library

    ptr = lambda x: None if x is None else x.data_ptr()
    ptrs = [ptr(x) for x in (*wave, *tables, *outs)]
    assert len(ptrs) == _N_PTRS
    floats = (opts.t_min, opts.bias, *opts.background)
    dev = wave[0].device
    rc = load_library().rt_bounce_shade(
        half, (ctypes.c_void_p * _N_PTRS)(*ptrs), (ctypes.c_int * 7)(*ints),
        (ctypes.c_float * 5)(*floats),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bounce shading kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1


def surface_cuda(tables, o, d, alive, hit, opts):
    """K6's first launch on the current stream → (sorig [N,3], ldir
    [L,N,3], dist [L,N], oactive [L,N] bool, is_diff [N] bool): the
    shadow searches' rays and masks, and the diffuse mask, as
    `shade_diffuse` computes them after `surface_at`. `tables` =
    `scene_tables(scene, o.device)`."""
    _check_wavefront(o, d, alive, hit)
    tabs, (ns, np_, nt, nl) = tables
    n, dev = o.shape[0], o.device
    f32 = torch.float32
    sorig = torch.empty((n, 3), dtype=f32, device=dev)
    ldir = torch.empty((nl, n, 3), dtype=f32, device=dev)
    dist = torch.empty((nl, n), dtype=f32, device=dev)
    oactive = torch.empty((nl, n), dtype=torch.bool, device=dev)
    is_diff = torch.empty((n,), dtype=torch.bool, device=dev)
    outs = (sorig, ldir, dist, oactive, is_diff) + (None,) * 9
    _launch(0, (o, d, None, alive, hit.kind, hit.idx), tabs, outs,
            (n, ns, np_, nt, nl, 0, 0), opts)
    return sorig, ldir, dist, oactive, is_diff


def shade_cuda(tables, o, d, thr, alive, hit, shadowed, opts, *,
               is_last: bool, glass: bool, radiance=None, plan=False):
    """K6's second launch on the current stream, once `shadowed` [L,N]
    bool holds each light's shadow bits → (terms, children, plan planes):
    - with `radiance` [N,3] (a wavefront whose lanes are its pixels) the
      bounce's terms are added into it in place and `terms` is None;
      otherwise `terms` [2 or 3, N, 3] holds the miss, diffuse and (on the
      last bounce) leaf terms per lane, for the renderer's fold;
    - `children` (o, d, thr [k·N,3], alive [k·N]), k = 2 on a `glass`
      scene (reflections, then refractions), None when `is_last`;
    - with `plan`, (winner [N] i32, occlusion bitmask [N] i32), else
      None."""
    _check_wavefront(o, d, alive, hit, thr)
    tabs, (ns, np_, nt, nl) = tables
    n, dev = o.shape[0], o.device
    f32 = torch.float32
    check_arg("shadowed", shadowed, torch.bool, (nl, n), dev)
    if radiance is not None:
        check_arg("radiance", radiance, f32, (n, 3), dev)
        terms = None
    else:
        terms = torch.empty((3 if is_last else 2, n, 3), dtype=f32,
                            device=dev)
    children = None
    if not is_last:
        k = 2 if glass else 1
        children = (torch.empty((k * n, 3), dtype=f32, device=dev),
                    torch.empty((k * n, 3), dtype=f32, device=dev),
                    torch.empty((k * n, 3), dtype=f32, device=dev),
                    torch.empty((k * n,), dtype=torch.bool, device=dev))
    planes = None
    if plan:
        planes = (torch.empty((n,), dtype=torch.int32, device=dev),
                  torch.empty((n,), dtype=torch.int32, device=dev))
    outs = ((None,) * 5 + (shadowed, radiance, terms)
            + (children or (None,) * 4) + (planes or (None, None)))
    _launch(1, (o, d, thr, alive, hit.kind, hit.idx), tabs, outs,
            (n, ns, np_, nt, nl, int(is_last), int(glass)), opts)
    return terms, children, planes


# What K7's backward needs besides the saved tensors.
_ShadeInfo = collections.namedtuple("_ShadeInfo",
                                    "counts opts is_last plan")


class _RecordedShade(torch.autograd.Function):
    """K6's shade launch, with K7 as its backward."""

    @staticmethod
    def forward(ctx, info, o, d, thr, alive, kind, idx, shadowed, *tabs):
        terms, children, planes = shade_cuda(
            (tabs, info.counts), o, d, thr, alive, Hit(kind, idx, None),
            shadowed, info.opts, is_last=info.is_last, glass=False,
            plan=info.plan)
        ctx.info = info
        ctx.save_for_backward(o, d, thr, alive, kind, idx, shadowed, *tabs)
        ctx.set_materialize_grads(False)
        outs = (terms, *(children or ()), *(planes or ()))
        ctx.mark_non_differentiable(
            *(x for x in outs if not x.is_floating_point()))
        return outs

    @staticmethod
    def backward(ctx, g_terms, *g_rest):
        info = ctx.info
        o, d, thr, alive, kind, idx, shadowed, *tabs = ctx.saved_tensors
        need = ctx.needs_input_grad
        with span("rt.shade.adjoint"):
            go, gd, gthr, grads = adjoint_cuda(
                (tabs, info.counts), o, d, thr, alive, Hit(kind, idx, None),
                shadowed, info.opts, g_terms,
                (None,) * 3 if info.is_last else g_rest[:3],
                is_last=info.is_last, rays=need[1:4])
        return (None, go, gd, gthr, None, None, None, None,
                *_table_grads(grads, tabs, info.counts, need[8:]))


def shade_recorded(tables, o, d, thr, alive, hit, shadowed, opts, *,
                   is_last: bool, plan=False):
    """`shade_cuda` on a glass-free bounce that autograd records: K6's
    shade launch as the forward of an autograd Function whose backward is
    K7 (`adjoint_cuda`) → (terms [2 or 3, N, 3], children or None, plan
    planes or None), as `shade_cuda` returns them without a radiance.
    Gradients reach o, d, thr and the tables of ADJOINT_TABLES. The
    Function saves its inputs, so a checkpoint's recompute reruns the
    launch."""
    tabs, counts = tables
    outs = _RecordedShade.apply(_ShadeInfo(counts, opts, is_last, plan), o,
                                d, thr, alive, hit.kind, hit.idx, shadowed,
                                *tabs)
    children = None if is_last else tuple(outs[1:5])
    return outs[0], children, (tuple(outs[-2:]) if plan else None)


def _windows(rows, cap: int):
    """Table rows (their float counts, in order) packed whole into windows
    of at most `cap` floats → [(first float, floats)]."""
    out, g0, gn = [], 0, 0
    for w in rows:
        if gn and gn + w > cap:
            out.append((g0, gn))
            g0, gn = g0 + gn, 0
        gn += w
    return out + [(g0, gn)]


def adjoint_cuda(tables, o, d, thr, alive, hit, shadowed, opts, g_terms,
                 g_children, *, is_last: bool, rays=(True, True, True)):
    """K7 on the current stream: the backward of `shade_cuda`'s shade
    launch (glass-free, no radiance) for the cotangents `g_terms` [2 or 3,
    N, 3] of its terms and `g_children` (o, d, thr [N, 3]) of its
    children, None being zero → (dL/do, dL/dd, dL/dthr [N, 3], each None
    where `rays` does not want it; the table gradients [4·ns + 9·np + 7·nm
    + 6·nl] f32: each sphere's center | radius, plane's point | normal |
    albedo2, material's albedo | kd | ks | spec_n | ior, light's pos |
    intensity). One adjoint launch a window of ADJ_WINDOW floats, each
    followed by the sum of its blocks' partial rows in a fixed order (K2's
    `rt_fused_train_reduce`)."""
    global adjoint_launches
    from raytracer_tpu_torch.kernels.build import load_library

    _check_wavefront(o, d, alive, hit, thr)
    tabs, (ns, np_, nt, nl) = tables
    nm = tabs[19].shape[0]
    n, dev = o.shape[0], o.device
    f32 = torch.float32
    check_arg("shadowed", shadowed, torch.bool, (nl, n), dev)
    cots = [None if g is None else g.contiguous()
            for g in (g_terms, *g_children)]
    for name, g, shape in zip(("terms", "child o", "child d", "child thr"),
                              cots, [(3 if is_last else 2, n, 3)]
                              + [(n, 3)] * 3):
        if g is not None:
            check_arg(f"the {name} cotangent", g, f32, shape, dev)
    rows = [4] * ns + [9] * np_ + [7] * nm + [6] * nl
    if n == 0:
        return (*(torch.zeros((0, 3), dtype=f32, device=dev) if want
                  else None for want in rays),
                torch.zeros((sum(rows),), dtype=f32, device=dev))
    # the launches write every lane and every float
    outs = [torch.empty((n, 3), dtype=f32, device=dev) if want else None
            for want in rays]
    grads = torch.empty((sum(rows),), dtype=f32, device=dev)
    lib = load_library()
    blocks = lib.rt_bounce_adjoint_blocks(n)
    stream = torch.cuda.current_stream(dev).cuda_stream
    floats = (ctypes.c_float * 5)(opts.t_min, opts.bias, *opts.background)
    ptr = lambda x: None if x is None else x.data_ptr()
    for g0, gn in _windows(rows, ADJ_WINDOW):
        partial = torch.empty((blocks, gn + 1), dtype=f32, device=dev)
        ptrs = [ptr(x) for x in (o, d, thr, alive, hit.kind, hit.idx, *tabs,
                                 shadowed, *cots,
                                 *(outs if g0 == 0 else (None,) * 3),
                                 partial)]
        assert len(ptrs) == _N_ADJ_PTRS
        ints = (n, ns, np_, nt, nl, int(is_last), nm, g0, gn)
        rc = lib.rt_bounce_adjoint((ctypes.c_void_p * _N_ADJ_PTRS)(*ptrs),
                                   (ctypes.c_int * 9)(*ints), floats, stream)
        if rc == 0:
            rc = lib.rt_fused_train_reduce(partial.data_ptr(), blocks,
                                           gn + 1, None,
                                           grads[g0:].data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"bounce adjoint kernel launch failed: CUDA "
                               f"error {rc}")
        adjoint_launches += 2
    return (*outs, grads)


# K7's gradient vector, group by group (spheres, planes, materials,
# lights): each group's row width, and for each `scene_tables` entry it
# holds, (its group, its first column, its columns; 0: one column, a
# vector)
_ROW_WIDTHS = (4, 9, 7, 6)
_GRAD_COLS = {0: (0, 0, 3), 1: (0, 3, 0), 3: (1, 0, 3), 4: (1, 3, 3),
              10: (1, 6, 3), 20: (2, 0, 3), 21: (2, 3, 0), 22: (2, 4, 0),
              23: (2, 5, 0), 24: (2, 6, 0), 25: (3, 0, 3), 26: (3, 3, 3)}


def _table_grads(grads, tabs, counts, need):
    """K7's gradient vector → a gradient (or None) for each of
    `scene_tables`' entries: those of ADJOINT_TABLES that `need` marks."""
    ns, np_, _, nl = counts
    heights = (ns, np_, tabs[19].shape[0], nl)
    starts = [0]
    for w, h in zip(_ROW_WIDTHS, heights):
        starts.append(starts[-1] + w * h)
    out = []
    for j, want in enumerate(need):
        if not (want and j in _GRAD_COLS):
            out.append(None)
            continue
        g, c, k = _GRAD_COLS[j]
        table = grads[starts[g]:starts[g + 1]].view(heights[g],
                                                    _ROW_WIDTHS[g])
        out.append(table[:, c:c + k] if k else table[:, c])
    return out
