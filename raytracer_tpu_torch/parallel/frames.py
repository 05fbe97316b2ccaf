"""A steady multi-card frame service: one process a card of this host, each
keeping the scene and its tracer on its card across frames.

`spawn_ranks(n, target, args)` starts rank processes through
multiprocessing's spawn, rank r on `cuda:r` (or on the CPU, over gloo);
each joins the group over a TCP store on a free localhost port (`join`,
through `mesh.init_distributed`) and calls `target(device, *args)`. A rank
that exits with an error stops the others: `Ranks.wait` kills them and
returns its exit code, and `Ranks.watch` does the same for a caller that
is itself rank 0 and may be blocked in a collective.

`ShardedFrames` is one rank's part of the service, on a (tiles n × prims
1) layout: the frame's pixels split in contiguous blocks of
`shard.rank_lanes` lanes, one a rank, and the mesh searched by a grid
(`accel.grid.GridTracer`) replicated on every card. For each frame rank 0
broadcasts the view (the camera and a go flag: the one per-frame control
collective), every rank renders its block through `render_sharded`, and
the blocks are all-gathered: the image is bit-equal to one card's
`render_banded` of the same view. Rank 0 calls `frame(camera)` for each
frame and `stop()` at the end; every other rank runs `serve()`, which
returns at the stop. Both then hand rank 0 every rank's span aggregate,
lane counters and peak memory (`report`).

    # on every rank r of n (rank 0 may be the process that spawned 1 … n−1)
    device = join(r, n, address, "cuda")
    frames = ShardedFrames(scene, opts, device=device)
    if r == 0:
        img = frames.frame(camera)       # as many frames as wanted
        per_rank = frames.stop()
    else:
        frames.serve()

Spans (`utils/profiling.span`): `rt.view` here; `rt.band`, `rt.gather` and
`rt.reduce` in `shard.render_sharded`.
"""

import multiprocessing as mp
import os
import socket
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from raytracer_tpu_torch.core.types import Camera
from raytracer_tpu_torch.parallel.mesh import init_distributed, make_rt_mesh
from raytracer_tpu_torch.parallel.shard import render_sharded
from raytracer_tpu_torch.utils import profiling
from raytracer_tpu_torch.utils.hostload import build_tracer

# the view a frame broadcasts: go flag, camera position [3], c2w [3, 3], fov
CONTROL = 14
POLL_S = 0.05
TIMEOUT_EXIT = 124      # Ranks.wait's code when its deadline passed
PARENT_GONE_EXIT = 75   # a rank whose launcher died ends itself


def free_address() -> str:
    """"localhost:<port>" of a port free now, for the group's TCP store."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return f"localhost:{s.getsockname()[1]}"


def join(rank: int, world: int, address: str, device_type: str):
    """Join the group of `world` ranks at `address` as `rank`, on this
    host's card `rank` (NCCL) or on the CPU (gloo) → the rank's device."""
    # NCCL's shared-memory transport maps segments under /dev/shm; the
    # ranks of one host talk over peer access (NVLink) or sockets instead
    os.environ.setdefault("NCCL_SHM_DISABLE", "1")
    if device_type == "cuda":
        if torch.cuda.device_count() <= rank:
            raise RuntimeError(f"rank {rank} of {world} needs cuda:{rank}; "
                               f"{torch.cuda.device_count()} card(s) here")
        device = torch.device("cuda", rank)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"ranks run on cuda or cpu, not {device_type!r}")
    init_distributed(address, world, rank, device=device)
    return device


class Ranks:
    """The rank processes that `spawn_ranks` started ({rank: Process}). A rank
    that exits with an error fails the group; as a context manager, every
    rank still running at the exit is killed."""

    def __init__(self, procs: dict, address: str):
        self.procs, self.address = procs, address
        self._done = threading.Event()

    def failed(self):
        """(rank, exit code) of a rank that exited with an error, or None
        (a signal's death reads as 128 + the signal)."""
        for rank, p in self.procs.items():
            code = p.exitcode
            if code:
                return rank, code if code > 0 else 128 - code
        return None

    def kill(self) -> None:
        for p in self.procs.values():
            if p.exitcode is None:
                p.kill()
        for p in self.procs.values():
            p.join()

    def wait(self, timeout_s: float) -> int:
        """Wait until every rank has exited → 0; at the first rank that
        fails, or at the deadline, kill the others → its exit code, or
        TIMEOUT_EXIT. Ends the watch: from here the caller sees failures."""
        self._done.set()
        deadline = time.monotonic() + timeout_s
        while True:
            bad = self.failed()
            if bad:
                self.kill()
                return bad[1]
            if all(p.exitcode is not None for p in self.procs.values()):
                return 0
            if time.monotonic() > deadline:
                self.kill()
                return TIMEOUT_EXIT
            time.sleep(POLL_S)

    def watch(self, on_fail) -> None:
        """From a thread, until `wait` or the exit: at the first rank that
        fails, kill the others and call `on_fail(rank, code)` (for a caller
        that is a rank itself, whose own thread may be blocked in a
        collective with the dead rank)."""
        def run():
            while not self._done.is_set():
                bad = self.failed()
                if bad:
                    self.kill()
                    on_fail(*bad)
                    return
                self._done.wait(POLL_S)

        threading.Thread(target=run, name="ranks-watch", daemon=True).start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._done.set()
        self.kill()
        return False


def spawn_ranks(n: int, target, args=(), *, device_type: str = "cuda",
                ranks=None) -> Ranks:
    """Start ranks `ranks` (default 0 … n−1) of a group of `n`, one process
    each (multiprocessing's spawn), rank r on `cuda:r` or on the CPU →
    Ranks. Each process joins the group at `Ranks.address` (a free localhost
    port) and calls `target(device, *args)`: `target` a module-level
    function, `args` picklable. The processes start in this process's
    working directory, with its `sys.path`, environment, standard output
    and error; each imports the caller's main module again, so a script
    that calls this keeps its work under `if __name__ == "__main__":`. A
    caller that is one of the ranks joins with `join` itself."""
    if n < 1:
        raise ValueError(f"a group of {n} ranks")
    address = free_address()
    ctx = mp.get_context("spawn")
    procs = {}
    try:
        for r in (range(n) if ranks is None else ranks):
            procs[r] = ctx.Process(
                target=_rank_main, name=f"rank{r}", daemon=True,
                args=(r, n, address, device_type, target, tuple(args)))
            procs[r].start()
    except BaseException:
        Ranks({r: p for r, p in procs.items() if p.pid is not None},
              address).kill()
        raise
    return Ranks(procs, address)


def _exit_with_parent() -> None:
    """End this process when the one that started it is gone (a rank left
    alone waits in a collective for ever)."""
    parent = os.getppid()

    def run():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(PARENT_GONE_EXIT)

    threading.Thread(target=run, name="parent-watch", daemon=True).start()


def _rank_main(rank, world, address, device_type, target, args) -> None:
    _exit_with_parent()
    device = join(rank, world, address, device_type)
    try:
        target(device, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class ShardedFrames:
    """One rank's part of the frame service (module docstring): the scene,
    the options and a grid tracer on `device`, built once; the layout
    (tiles = the group's size, prims 1) over the initialized group."""

    def __init__(self, scene, opts, *, device):
        if not scene.meshes.count:
            raise ValueError("ShardedFrames searches a mesh with the "
                             "replicated grid; the scene has no mesh")
        self.device = torch.device(device)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        self.mesh = make_rt_mesh(tiles=self.world, prims=1)
        self.opts = opts
        self.scene = scene.to(self.device)
        self.tracer = build_tracer(scene, "grid", self.device)
        self.frames = 0
        self._view = torch.zeros(CONTROL, dtype=torch.float32,
                                 device=self.device)

    def _agree(self, control=None):
        """The frame's view from rank 0 (`control` there) → its Camera on
        this device, or None at the stop."""
        with profiling.span("rt.view"):
            if control is not None:
                self._view.copy_(torch.from_numpy(control))
            dist.broadcast(self._view, src=0)
            go = control[0] if control is not None else self._view[0].item()
        if not go:
            return None
        v = self._view
        return Camera(pos=v[1:4], c2w=v[4:13].view(3, 3), fov_deg=v[13])

    def _render(self, camera):
        img, _ = render_sharded(self.scene, camera, self.opts, self.mesh,
                                tracer=self.tracer, device=self.device)
        self.frames += 1
        return img

    def frame(self, camera: Camera):
        """Rank 0: render the frame of `camera` on every rank → the gathered
        image [H, W, 3] on this device."""
        control = np.concatenate([
            [1.0], *(np.asarray(x, np.float32).reshape(-1) for x in (
                camera.pos, camera.c2w, camera.fov_deg))]).astype(np.float32)
        return self._render(self._agree(control))

    def stop(self) -> list:
        """Rank 0: end every other rank's `serve()` → `report()`."""
        self._agree(np.zeros(CONTROL, np.float32))
        return self.report()

    def serve(self):
        """Every rank but 0: render each frame rank 0 asks for, until it
        stops → `report()` (None here)."""
        while (camera := self._agree()) is not None:
            self._render(camera)
        return self.report()

    def report(self):
        """Every rank: hand rank 0 {"rank", "frames", "spans"
        (`profiling.spans()`), "counters" (`profiling.counters()`),
        "peak_bytes" (the card's allocated peak; 0 on the CPU)} → the list
        by rank on rank 0, None elsewhere."""
        mine = {"rank": self.rank, "frames": self.frames,
                "spans": profiling.spans(), "counters": profiling.counters(),
                "peak_bytes": int(torch.cuda.max_memory_allocated(self.device))
                if self.device.type == "cuda" else 0}
        out = [None] * self.world
        dist.all_gather_object(out, mine)
        return out if self.rank == 0 else None

