"""Process group and rank layout (counterpart of
`raytracer_tpu/parallel/mesh.py`).

The layout has two axes, as the reference's device mesh:
  'tiles' — pixel-tile data parallelism: no communication in the forward
            but the final gather of the image shards;
  'prims' — primitive sharding: each rank searches its primitive shard for
            all of its rays, and partial hits min-combine over the axis.

On torch every rank is a process of its own. `init_distributed` creates the
process group (NCCL for a CUDA device, gloo for the CPU); `make_rt_mesh`
lays the ranks out row-major over (tiles, prims), as `jax.make_mesh` does,
and creates a subgroup per row and per column.
"""

import dataclasses

import torch
import torch.distributed as dist


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     *, device) -> None:
    """Join (or create) the process group of `num_processes` ranks as rank
    `process_id`.

    `coordinator` is "host:port" (→ tcp://host:port) or a full "tcp://…" or
    "file://…" init method. A CUDA `device` takes NCCL, bound to that device
    and connected here (a group that fails to form fails now); the CPU takes
    gloo. Any `num_processes` ≥ 1 forms a real group."""
    device = torch.device(device)
    if num_processes < 1 or not 0 <= process_id < num_processes:
        raise ValueError(f"rank {process_id} of {num_processes} processes")
    init = (coordinator if coordinator.startswith(("tcp://", "file://"))
            else f"tcp://{coordinator}")
    if device.type == "cuda":
        if device.index is None:
            raise ValueError("init_distributed needs an indexed CUDA device "
                             "(cuda:<rank's card>)")
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method=init,
                                world_size=num_processes, rank=process_id,
                                device_id=device)
    elif device.type == "cpu":
        dist.init_process_group("gloo", init_method=init,
                                world_size=num_processes, rank=process_id)
    else:
        raise ValueError(f"init_distributed runs on cpu or cuda, not {device}")


@dataclasses.dataclass(frozen=True)
class RtMesh:
    """This rank's place in the (tiles, prims) layout: `shape` {"tiles": T,
    "prims": P}, its `tile` and `prim` (rank = tile·P + prim), and the
    process groups of its tiles axis (the T ranks of its prim) and of its
    prims axis (the P ranks of its tile). A group's rank i is tile i,
    resp. prim i."""

    shape: dict
    tile: int
    prim: int
    tiles_group: object
    prims_group: object


def make_rt_mesh(tiles: int | None = None, prims: int = 1) -> RtMesh:
    """The (tiles, prims) layout over the initialized process group (tiles
    defaults to world size / prims). Every rank creates every subgroup, in
    the same order, as `dist.new_group` requires."""
    if not dist.is_initialized():
        raise RuntimeError("make_rt_mesh: no process group; call "
                           "init_distributed first")
    n = dist.get_world_size()
    if tiles is None:
        if n % prims:
            raise ValueError(f"{n} ranks do not split into prims={prims}")
        tiles = n // prims
    if tiles * prims != n:
        raise ValueError(f"tiles={tiles} × prims={prims} != {n} ranks")
    tile, prim = divmod(dist.get_rank(), prims)
    tiles_groups = [dist.new_group([t * prims + p for t in range(tiles)])
                    for p in range(prims)]
    prims_groups = [dist.new_group([t * prims + p for p in range(prims)])
                    for t in range(tiles)]
    return RtMesh(shape={"tiles": tiles, "prims": prims}, tile=tile,
                  prim=prim, tiles_group=tiles_groups[prim],
                  prims_group=prims_groups[tile])

