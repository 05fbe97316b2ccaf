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

The torch bounce is the twin the kernel is held to, bit for bit on the
card (tests/test_torch_bounce_shade.py): it is what every CPU bounce and
every bounce autograd records (the replay, its recompute, the `full`
remat policy) runs. The scene's tables are read at each call, whatever
the tracer was built with.
"""

import ctypes

import torch

from raytracer_tpu_torch.kernels.build import check_arg

# Kernel launches since the last reset (two a fused bounce). Incremented
# only where the kernel is launched; callers that must show the kernel ran
# set it to 0 and read it.
launches = 0

_N_PTRS = 47


def fused_shading(scene, state, radiance=None) -> bool:
    """Does this bounce shade through K6? When its rays are on a CUDA
    device and autograd records nothing for it (`autograd_records`)."""
    return (state[0].device.type == "cuda"
            and not autograd_records(scene, state, radiance))


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
