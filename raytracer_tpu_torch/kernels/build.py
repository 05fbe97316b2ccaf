"""nvcc build and ctypes binding of the CUDA kernels in `csrc/`.

Every `*.cu` in `raytracer_tpu_torch/csrc/` compiles into one shared library
with a plain C interface, at first use, into `raytracer_tpu_torch/_build/`
(listed in .gitignore): one nvcc per source, all started together, then one
link. The file name carries a hash of the sources and the flags, so an
edited kernel rebuilds and a cached library is never stale. Each compile
runs with `-Xptxas -v`; `build_log` keeps the report (registers, spills)
of the last build. Nothing here runs at import: importing this module needs
neither nvcc nor CUDA.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# --fmad=false: no multiply-add contraction, so each product and sum rounds
# as the plain torch version's separate ops do. With contraction the walk's
# hit distances drifted up to 6.66e-6 relative from the plain version on
# config4's 1080p primaries (H100 80GB HBM3, 700 W) — outside the 2e-6
# cross-backend standard.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_lib = None  # the loaded library, once built
build_log = ""  # ptxas report of the last build_library()


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"librt_kernels_{h.hexdigest()[:16]}.so")


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def build_library() -> tuple[str, float]:
    """Compile csrc/*.cu with nvcc, one process per source, and link them →
    (library path, build seconds)."""
    global build_log
    out = library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    srcs = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in srcs]
    t0 = time.perf_counter()
    cmds = [[nvcc, *compile_flags, "-Xptxas", "-v", "-c", src, "-o", obj]
            for src, obj in zip(srcs, objs)]
    jobs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
            for cmd in cmds]
    logs = []
    try:
        for cmd, proc in jobs:
            log, _ = proc.communicate()
            logs.append(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{log}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    finally:
        for _, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)  # atomic: a concurrent builder never sees half a file
    build_log = "".join(logs)
    return out, time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if no library of these sources exists."""
    global _lib
    if _lib is None:
        path = library_path()
        if not os.path.exists(path):
            path, _ = build_library()
        lib = ctypes.CDLL(path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rt_grid_walk.restype = i
        lib.rt_grid_walk.argtypes = (
            [p] * 12                      # orig … cells, slots
            + [i] * 4                     # n, nx, ny, nz
            + [ctypes.c_float, i, i]      # t_min, max_iters, occlusion
            + [p, p, p])                  # t_out, i_out, stream
        f = ctypes.c_float
        lib.rt_fused_whitted.restype = i
        lib.rt_fused_whitted.argtypes = (
            [p] * 7                       # sph, pln, mat, lgt, stat, ids, cam
            + [i] * 7                     # ns, np, nt, nm, nl, max_depth, glass
            + [f] * 5                     # t_min, bias, bg rgb
            + [i] * 4                     # width, height, row0, rows
            + [f, i, p, p, p, p])         # eps, mode, img, plan, scratch,
                                          # stream
        lib.rt_fused_train_blocks.restype = i
        lib.rt_fused_train_blocks.argtypes = [i, i]  # width, rows
        for entry in ("rt_fused_whitted_deep_levels",
                      "rt_fused_train_deep_nodes"):
            getattr(lib, entry).restype = i
            getattr(lib, entry).argtypes = [i, i]  # max_depth, glass
        lib.rt_fused_train.restype = i
        lib.rt_fused_train.argtypes = (
            [p] * 7                       # sph, pln, mat, lgt, stat, ids, cam
            + [i] * 4                     # table heights
            + [i] * 7                     # ns, np, nt, nm, nl, max_depth, glass
            + [f] * 5                     # t_min, bias, bg rgb
            + [i] * 4                     # width, height, row0, rows
            + [f, p, p, i, i]             # eps, plan, target, g0, gn
            + [p] * 3)                    # partial, scratch, stream
        lib.rt_fused_train_reduce.restype = i
        lib.rt_fused_train_reduce.argtypes = (
            [p, i, i] + [p] * 3)          # partial, n_blocks, n_out,
                                          # loss_out, grad_out, stream
        lib.rt_tri_trace.restype = i
        lib.rt_tri_trace.argtypes = (
            [p] * 7                       # orig, dir, live, n_live, max_t,
                                          # active, rows
            + [i, i, i, f, i]             # n, tp, spread, t_min, occlusion
            + [p] * 4)                    # t_out, i_out, occ_out, stream
        lib.rt_bvh_walk.restype = i
        lib.rt_bvh_walk.argtypes = (
            [p] * 8                       # orig, dir, active, max_t, nodes,
                                          # minid, links, slots
            + [i, i, i, f, i]             # n, n_nodes, n_tris, t_min,
                                          # occlusion
            + [p, p, p])                  # t_out, i_out, stream
        lib.rt_mat_trace.restype = i
        lib.rt_mat_trace.argtypes = (
            [p] * 6                       # feats, live, n_live, max_t,
                                          # active, rows
            + [i, i, i, f, i]             # n, tp, spread, t_min, occlusion
            + [p] * 4)                    # t_out, i_out, occ_out, stream
        _lib = lib
    return _lib


def check_arg(name, x, dtype, shape, device):
    """Raise ValueError unless `x` is a contiguous `dtype` tensor of `shape`
    on `device`: what a kernel's C entry takes."""
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def live_rays(active):
    """The ids of the `active` rays in ascending order and their count, on
    the device and without a host sync → (live [N+1] i32, n_live [1] i32);
    (None, None) when `active` is None (every ray live). Entry N of `live`
    takes the masked rays' scatter and is never read."""
    import torch

    if active is None:
        return None, None
    n, dev = active.shape[0], active.device
    pos = torch.cumsum(active, 0, dtype=torch.int32)
    slot = torch.where(active, pos - 1, n).long()
    live = torch.empty((n + 1,), dtype=torch.int32, device=dev)
    live.scatter_(0, slot, torch.arange(n, dtype=torch.int32, device=dev))
    return live, pos[-1:]


def launch_search(entry, rays, max_t, active, table, tp, t_min):
    """Launch the brute-force search kernel of C entry `entry` (rt_tri_trace
    or rt_mat_trace) on the current stream over the live rays of `active`
    (`live_rays`), split over at least 4 blocks per SM: nearest when `max_t`
    is None, else any-hit below `max_t`. `rays` (the entry's tensors per
    ray, before the live list) and the packed `table` of `tp` triangles are
    checked by the caller. Checks `max_t` and `active`, allocates the
    outputs and raises on a refused launch → (occluded bool [N] or (t [N]
    f32, idx [N] i32), whether a kernel was launched)."""
    import torch

    n, dev = rays[0].shape[0], rays[0].device
    if active is not None:
        check_arg("active", active, torch.bool, (n,), dev)
    occl = max_t is not None
    if occl:
        check_arg("max_t", max_t, torch.float32, (n,), dev)
        outs = (None, None, torch.empty((n,), dtype=torch.bool, device=dev))
    else:
        outs = (torch.empty((n,), dtype=torch.float32, device=dev),
                torch.empty((n,), dtype=torch.int32, device=dev), None)
    result = outs[2] if occl else outs[:2]
    if n == 0:
        return result, False
    if table.data_ptr() % 16:
        raise ValueError("the packed table must be 16-byte aligned")
    spread = 4 * torch.cuda.get_device_properties(dev).multi_processor_count
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = getattr(load_library(), entry)(
        *(ptr(x) for x in (*rays, *live_rays(active), max_t, active, table)),
        n, tp, spread, float(t_min), int(occl), *(ptr(x) for x in outs),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    return result, True
