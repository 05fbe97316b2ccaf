"""Culled-list triangle sweep: the CUDA kernel (`csrc/cull_sweep.cu`) and
its plain torch version, behind one dispatcher.

The reference keeps this sweep in XLA (`raytracer_tpu/accel/cull.py:
_dense_nearest` and `_dense_occluded`, no Pallas kernel). The rays come in
lists of `tile` lanes, list by list; list j's candidates are the first
min(counts[j], cap) entries of `ids[j]` (ascending triangle ids, built by
`accel.cull.tile_ids`). Nearest: the nearest hit with t > t_min, ties to
the lowest id; any-hit: a hit with t < max_t. A lane whose `active` is
False misses with (inf, n_tris); a live lane that hits nothing keeps the
lowest id it tested (the lexicographic fold of `csrc/tri_row.cuh`, as the
grid walk's misses do), so only hits' ids mean anything.

`cull_nearest` / `cull_occluded` dispatch on the rays' device: a CUDA
tensor launches the kernel (or raises — there is no fallback), a CPU
tensor runs the plain version. The two are equal bit for bit. The kernel
takes the live lanes only, list by list (a first kernel lists them on the
device; `list_live` and `cta_shares` mirror its list and CTA table), and
no torch op runs on the device per launch.
"""

import torch

from raytracer_tpu_torch.kernels.build import check_arg
from raytracer_tpu_torch.ops import geometry as geom

# Kernel launches since the last reset. Incremented only where the kernel
# is launched; callers that must show the kernel ran set it to 0 and read it.
launches = 0
THREADS = 128  # live lanes a CTA takes (csrc/cull_sweep.cu kThreads)

# The plain version tests `_CHUNK` ids of a slice of lists at a time, with
# about `_ELEMS` ray–triangle pairs per slice: its temporaries (~25 of that
# size, f32) stay near 1 GiB.
_CHUNK = 128
_ELEMS = 1 << 23


def cull_nearest(rays, ids, counts, table, tile: int, t_min, active=None):
    """Nearest hit over each ray's list → (t [N] f32, idx [N] i32).

    `rays` = (orig, direc) [N, 3] f32 with N = n_lists · `tile`; `ids`
    [n_lists, cap] i32; `counts` [n_lists] i32 (true counts, may exceed
    cap); `table` [n_tris + 1, 12] f32, the packed rows of
    `accel.cull.build_cull` (sentinel row at n_tris); `active` [N] bool or
    None (every lane)."""
    return _dispatch(rays, ids, counts, table, tile, t_min, active, None)


def cull_occluded(rays, ids, counts, table, tile: int, t_min, active,
                  max_t):
    """Any hit with t in (t_min, max_t) over each ray's list → bool [N];
    the arguments of `cull_nearest`, and `max_t` [N] f32."""
    return _dispatch(rays, ids, counts, table, tile, t_min, active, max_t)


@torch.no_grad()
def _dispatch(rays, ids, counts, table, tile, t_min, active, max_t):
    dev = rays[0].device
    if dev.type == "cpu":
        return cull_sweep_plain(rays, ids, counts, table, tile, t_min, active,
                                max_t)
    if dev.type != "cuda":
        raise ValueError(f"the culled sweep runs on cpu or cuda, not {dev}")
    return cull_sweep_cuda(rays, ids, counts, table, tile, t_min, active,
                           max_t)


def _shapes(rays, ids, tile):
    n = rays[0].shape[0]
    n_lists = ids.shape[0]
    if tile <= 0 or n != n_lists * tile:
        raise ValueError(f"{n} rays are not {n_lists} lists of {tile} lanes")
    return n, n_lists, ids.shape[1]


def list_live(active, n_lists: int, tile: int):
    """Each list's live lanes as the kernel lists them: ascending, at the
    front of the list's own segment of `tile` entries, and their count →
    (live [N] i32, each segment's entries past its count N; n_live
    [n_lists] i32)."""
    act = active.reshape(n_lists, tile)
    n_live = act.sum(dim=1).to(torch.int32)
    lane = torch.arange(n_lists * tile, dtype=torch.int32,
                        device=active.device).reshape(n_lists, tile)
    order = torch.argsort((~act).to(torch.int32), dim=1, stable=True)
    live = torch.where(act, lane, n_lists * tile).gather(1, order)
    return live.reshape(-1), n_live


def cta_shares(n_live, counts, tile: int, per_cta: int):
    """The kernel's CTA table: the launch is n_lists × ceil(tile / per_cta)
    CTAs, and CTA b of list j takes list j's live lanes [b·per_cta,
    (b+1)·per_cta), none when the list is empty (counts[j] = 0: its CTAs
    write every lane's miss) → [n_lists, ceil(tile / per_cta), 2] i32
    (first entry in `list_live`'s list, j·tile + b·per_cta; count; a CTA of
    count 0 stages nothing)."""
    lo = torch.arange(0, tile, per_cta, dtype=torch.int32,
                      device=n_live.device)
    n = torch.clamp(n_live[:, None] - lo[None, :], 0, per_cta)
    n = torch.where(counts[:, None] > 0, n, 0)
    first = (torch.arange(n_live.shape[0], dtype=torch.int32,
                          device=n_live.device)[:, None] * tile + lo[None, :])
    return torch.stack([first, n], dim=2).to(torch.int32)


def cull_sweep_cuda(rays, ids, counts, table, tile, t_min, active=None,
                    max_t=None):
    """Launch the CUDA kernel on the current stream: nearest when `max_t` is
    None, else any-hit; over the live lanes of `active`. Raises on any input
    the kernel does not take and on a refused launch."""
    global launches
    from raytracer_tpu_torch.kernels.build import load_library

    orig, direc = rays
    dev = orig.device
    if dev.type != "cuda":
        raise ValueError(f"cull_sweep_cuda needs CUDA tensors, got {dev}")
    n, n_lists, cap = _shapes(rays, ids, tile)
    if n_lists >= 1 << 16:
        raise ValueError(f"too many lists for one launch: {n_lists}")
    f32, i32 = torch.float32, torch.int32
    for name, x, dt, shape in (
            ("orig", orig, f32, (n, 3)), ("direc", direc, f32, (n, 3)),
            ("ids", ids, i32, (n_lists, cap)),
            ("counts", counts, i32, (n_lists,)),
            ("table", table, f32, (table.shape[0], 12))):
        check_arg(name, x, dt, shape, dev)
    if active is not None:
        check_arg("active", active, torch.bool, (n,), dev)
    occl = max_t is not None
    if occl:
        check_arg("max_t", max_t, f32, (n,), dev)
        outs = (None, None, torch.empty((n,), dtype=torch.bool, device=dev))
    else:
        outs = (torch.empty((n,), dtype=f32, device=dev),
                torch.empty((n,), dtype=i32, device=dev), None)
    result = outs[2] if occl else outs[:2]
    if n == 0:
        return result
    if table.data_ptr() % 16:
        raise ValueError("the packed table must be 16-byte aligned")
    # the kernel's list of each list's live lanes (scratch; no device op)
    live = n_live = None
    if active is not None:
        live = torch.empty((n,), dtype=i32, device=dev)
        n_live = torch.empty((n_lists,), dtype=i32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = load_library().rt_cull_sweep(
        orig.data_ptr(), direc.data_ptr(),
        *(ptr(x) for x in (active, live, n_live, max_t)),
        ids.data_ptr(), counts.data_ptr(), table.data_ptr(), n_lists, tile,
        cap, table.shape[0] - 1, float(t_min), int(occl),
        *(ptr(x) for x in outs),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"culled sweep kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return result


@torch.no_grad()
def cull_sweep_plain(rays, ids, counts, table, tile, t_min, active=None,
                     max_t=None, stats=None):
    """The plain version of the kernel, on any device: `_dense_nearest` /
    `_dense_occluded`'s chunked broadcast Möller–Trumbore
    (`geometry.triangle_tuv`), list by list in slices, each list's ids past
    its count read as the sentinel row. With a `stats` dict, adds "tests":
    Σ over lists of min(count, cap) × its live lanes (what the kernel
    tests), and sets "lane_tests", this call's tests of each lane ([N] i64,
    list-major: its list's min(count, cap) where live, else 0)."""
    orig, direc = rays
    n, n_lists, cap = _shapes(rays, ids, tile)
    n_tris = table.shape[0] - 1
    dev = orig.device
    o = orig.reshape(n_lists, tile, 1, 3)
    d = direc.reshape(n_lists, tile, 1, 3)
    act = (torch.ones((n_lists, tile), dtype=torch.bool, device=dev)
           if active is None else active.reshape(n_lists, tile))
    lens = torch.clamp(counts, max=cap)
    if stats is not None:
        per_list = lens.to(torch.int64)
        live = act.sum(dim=1)
        stats["tests"] = stats.get("tests", 0) + int((per_list * live).sum())
        stats["lane_tests"] = (per_list[:, None] * act).reshape(n)
    bt = torch.full((n_lists, tile), geom.INF, dtype=torch.float32,
                    device=dev)
    bi = torch.full((n_lists, tile), n_tris, dtype=torch.int32, device=dev)
    mt = None if max_t is None else max_t.reshape(n_lists, tile, 1)
    occ = torch.zeros((n_lists, tile), dtype=torch.bool, device=dev)
    step = max(1, _ELEMS // (tile * _CHUNK))
    for s in range(0, n_lists, step):
        sl = slice(s, s + step)
        top = int(lens[sl].max()) if lens[sl].numel() else 0
        for k in range(0, top, _CHUNK):
            slot = torch.arange(k, min(k + _CHUNK, cap), device=dev)
            idc = torch.where(slot[None, :] < lens[sl, None],
                              ids[sl, k:k + _CHUNK], n_tris)  # [g, c]
            rows = table[idc.long()][:, None]                 # [g, 1, c, 12]
            ts, _, _ = geom.triangle_tuv(o[sl], d[sl], rows[..., 0:3],
                                         rows[..., 3:6], rows[..., 6:9],
                                         t_min)               # [g, tile, c]
            ts = torch.where(act[sl, :, None], ts, geom.INF)
            if mt is not None:
                occ[sl] |= (ts < mt[sl]).any(dim=2)
                continue
            tc = ts.amin(dim=2)
            # lowest id among the t-minima, then the lexicographic fold
            ic = torch.where(ts <= tc[..., None], idc[:, None, :],
                             n_tris).amin(dim=2)
            better = (tc < bt[sl]) | ((tc == bt[sl]) & (ic < bi[sl]))
            bt[sl] = torch.where(better, tc, bt[sl])
            bi[sl] = torch.where(better, ic, bi[sl])
    if mt is not None:
        return occ.reshape(n)
    bi = torch.where(act, bi, n_tris)
    return bt.reshape(n), bi.reshape(n)
