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
            [p] * 11                      # orig … soa
            + [i] * 6                     # n, nx, ny, nz, cap, n_tris
            + [ctypes.c_float, i, i]      # t_min, max_iters, occlusion
            + [p, p, p])                  # t_out, i_out, stream
        f = ctypes.c_float
        lib.rt_fused_whitted.restype = i
        lib.rt_fused_whitted.argtypes = (
            [p] * 7                       # sph, pln, mat, lgt, stat, ids, cam
            + [i] * 7                     # ns, np, nt, nm, nl, max_depth, glass
            + [f] * 5                     # t_min, bias, bg rgb
            + [i] * 4                     # width, height, row0, rows
            + [f, p, p, p])               # eps, img, plan, stream
        lib.rt_fused_train_blocks.restype = i
        lib.rt_fused_train_blocks.argtypes = [i, i]  # width, rows
        lib.rt_fused_train.restype = i
        lib.rt_fused_train.argtypes = (
            [p] * 7                       # sph, pln, mat, lgt, stat, ids, cam
            + [i] * 4                     # table heights
            + [i] * 7                     # ns, np, nt, nm, nl, max_depth, glass
            + [f] * 5                     # t_min, bias, bg rgb
            + [i] * 4                     # width, height, row0, rows
            + [f, p, p, p, p, p])         # eps, plan, target, partial, out,
        _lib = lib                        # stream
    return _lib
