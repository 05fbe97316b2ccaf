"""Threaded BVH walk: the CUDA kernel (`csrc/bvh_walk.cu`) and the dispatch
to it or to the plain torch version (`accel.bvh.bvh_walk`).

The reference keeps this walk in XLA (`raytracer_tpu/accel/bvh.py:
bvh_walk`, a `while_loop`, no Pallas kernel). Its plain torch version on the
card is a host-driven loop: ~30 torch ops over the walking lanes per step,
with a read-back of their count, for up to n_nodes + 1 steps, 15 walks per
config4 frame. The kernel walks the live rays only (a first kernel lists
them on the device), one a thread, in persistent warps that take their
rays from a counter, the whole walk inside the kernel, and equals the plain
version bit for bit; no torch op runs on the device per launch.

`bvh_trace` dispatches on the rays' device: a CUDA tensor launches the
kernel (or raises — there is no fallback), a CPU tensor runs the plain
version.
"""

import dataclasses

import torch

from raytracer_tpu_torch.accel import bvh as bvh_mod
from raytracer_tpu_torch.kernels.build import check_arg
from raytracer_tpu_torch.ops.walk import pack_rows

# Kernel launches since the last reset. Incremented only where the kernel
# is launched; callers that must show the kernel ran set it to 0 and read it.
launches = 0
# the kernel's int32 work counter runs past N by 32 lanes a warp
_MAX_RAYS = 1 << 30


@dataclasses.dataclass(frozen=True)
class BVHTable:
    """The walk's tables, built once per tree (`pack_bvh_table`), on the
    tree's device:
    - `soa`: (v0, e1, e2) [T, 3] f32, the plain walk's triangle layout;
    - `nodes`: [n_nodes, 8] f32, per node two 16-byte rows: box min xyz and
      the node's first slot, box max xyz and its count of listed triangles
      (the two ints stored as their bits);
    - `minid`: [n_nodes] i32, the lowest listed id of each node (n_tris for
      inner nodes): what a missed leaf folds in, as the plain walk's
      sentinel-padded row does;
    - `slots`: [T, 12] f32, every leaf's listed triangles packed once in
      node order and in `leaf_tris`' slot order, v0|e1|e2|id|0|0;
    - `counter`: [3] i32, the kernel's counters (the walk's next ray, its
      warps out, the live list's length), 0 between launches (each launch
      sets them back), so one launch at a time uses a table."""

    soa: tuple
    nodes: torch.Tensor
    minid: torch.Tensor
    slots: torch.Tensor
    counter: torch.Tensor


def pack_bvh_table(bvh: bvh_mod.BVHData, v0, e1, e2) -> BVHTable:
    """The walk's tables from `bvh.leaf_tris`, whose rows fill front to back
    (listed triangles, then sentinel slots), and the mesh's (v0, e1, e2)."""
    leaf = bvh.leaf_tris
    listed = leaf != bvh.n_tris
    counts = listed.sum(dim=1)
    slot = torch.arange(bvh.capacity, device=leaf.device)
    if not torch.equal(listed, slot[None, :] < counts[:, None]):
        raise ValueError("leaf_tris: a sentinel slot precedes a listed one")
    ids = leaf[listed].long()  # row-major: node by node, slots in order
    slots = pack_rows(torch.cat([v0[ids], e1[ids], e2[ids],
                                 ids.to(torch.float32)[:, None]], dim=1))
    bits = torch.stack([torch.cumsum(counts, 0) - counts, counts],
                       dim=1).to(torch.int32).view(torch.float32)
    box = bvh.aabb6
    nodes = torch.cat([box[:, :3], bits[:, :1], box[:, 3:], bits[:, 1:]],
                      dim=1)
    minid = torch.where(listed, leaf, bvh.n_tris).amin(dim=1)
    return BVHTable(soa=(v0, e1, e2), nodes=nodes.contiguous(),
                    minid=minid.to(torch.int32).contiguous(),
                    slots=slots,
                    counter=torch.zeros((3,), dtype=torch.int32,
                                        device=leaf.device))


@torch.no_grad()
def bvh_trace(bvh: bvh_mod.BVHData, table: BVHTable, orig, direc, t_min,
              occlusion_max_t=None, active=None):
    """The BVH walk on the rays' device → (best_t [N] f32, best_idx [N]
    i32), with `accel.bvh.bvh_walk`'s contract: the kernel on CUDA, the
    plain version on the CPU."""
    if orig.device.type == "cpu":
        return bvh_mod.bvh_walk(bvh, *table.soa, orig, direc, t_min,
                                occlusion_max_t, active)
    if orig.device.type != "cuda":
        raise ValueError(f"bvh_trace runs on cpu or cuda, not {orig.device}")
    return bvh_walk_cuda(bvh, table, orig.contiguous(), direc.contiguous(),
                         t_min, occlusion_max_t, active)


def bvh_walk_cuda(bvh: bvh_mod.BVHData, table: BVHTable, orig, direc, t_min,
                  occlusion_max_t=None, active=None):
    """Launch the CUDA kernel on the current stream; it walks the live rays
    of `active` and writes the masked ones' misses. Raises on any input the
    kernel does not take and on a refused launch."""
    global launches
    from raytracer_tpu_torch.kernels.build import load_library

    n = orig.shape[0]
    dev = orig.device
    if dev.type != "cuda":
        raise ValueError(f"bvh_walk_cuda needs CUDA tensors, got {dev}")
    f32, i32 = torch.float32, torch.int32
    nn = bvh.n_nodes
    for name, x, dt, shape in (
            ("orig", orig, f32, (n, 3)), ("direc", direc, f32, (n, 3)),
            ("table.nodes", table.nodes, f32, (nn, 8)),
            ("table.minid", table.minid, i32, (nn,)),
            ("bvh.links2", bvh.links2, i32, (8 * nn, 2)),
            ("table.slots", table.slots, f32, (table.slots.shape[0], 12)),
            ("table.counter", table.counter, i32, (3,))):
        check_arg(name, x, dt, shape, dev)
    if active is not None:
        check_arg("active", active, torch.bool, (n,), dev)
    occl = occlusion_max_t is not None
    if occl:
        check_arg("occlusion_max_t", occlusion_max_t, f32, (n,), dev)
    t_out = torch.empty((n,), dtype=f32, device=dev)
    i_out = torch.empty((n,), dtype=i32, device=dev)
    if n == 0:
        return t_out, i_out
    if n > _MAX_RAYS:
        raise ValueError(f"too many rays for one launch: {n}")
    # the kernel's list of live rays (scratch; no device op)
    live = None if active is None else torch.empty((n,), dtype=i32,
                                                   device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = load_library().rt_bvh_walk(
        orig.data_ptr(), direc.data_ptr(), ptr(active), ptr(occlusion_max_t),
        table.nodes.data_ptr(), table.minid.data_ptr(),
        bvh.links2.data_ptr(), table.slots.data_ptr(),
        table.counter.data_ptr(), ptr(live), n, nn, bvh.n_tris, float(t_min),
        int(occl), t_out.data_ptr(), i_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"BVH walk kernel launch failed: CUDA error {rc}")
    launches += 1
    return t_out, i_out
