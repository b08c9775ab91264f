"""Device mesh and batch sharding over torch.distributed, one process per GPU.

Port of moca_tpu/parallel/mesh.py. The JAX package runs one process over a
(dp, fifo) mesh of devices and lets XLA split the window batch; here
`torchrun` (or the caller) starts one process a GPU, every rank runs the
whole pipeline with the same seed (the same noise, queue and MoCA step), and
only the row-parallel calls are split: each rank computes its contiguous
block of rows and an `all_gather_into_tensor` hands every rank the whole
batch. Parameters are replicated, as in the JAX package; no DTensor, whose
dispatch the hand-written attention kernels do not take.

Rank order: a rank's block is its position in the flattened mesh, the
global rank, which is ("dp", "fifo") row-major as `init_device_mesh` lays
the ranks out (the JAX decode's order; its FIFO batch flattens ("fifo",
"dp")). Every rank holds the same inputs and receives every block, so the
order moves no result. As in the JAX package, both axes flatten into one:
the shards and gathers run over the world group, so a (2, 1) and a (1, 2)
mesh split the same rows, and the mesh serves for its size.

Launch: `torchrun --nproc_per_node N -m moca_tpu_torch.cli.main --mesh 1,N ...`.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist


AXES = ("dp", "fifo")


def make_mesh(shape: Optional[Tuple[int, int]] = None):
    """A ("dp", "fifo") DeviceMesh over the process group's ranks, on the
    GPU where there is one; the default puts every rank on "fifo". The group
    must exist (`initialize_distributed`)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if shape is None:
        shape = (1, n)
    assert shape[0] * shape[1] == n, f"mesh {tuple(shape)} != {n} devices"
    return init_device_mesh("cuda" if torch.cuda.is_available() else "cpu", tuple(shape),
                            mesh_dim_names=AXES)


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, backend: Optional[str] = None):
    """Start the process group at the coordinator's URL (`tcp://host:port`,
    `file:///path`), else from torchrun's environment (`env://`); a single
    process with no coordinator gets an in-process store. The backend is
    NCCL on a GPU and gloo on the CPU unless named. Under NCCL each rank
    takes the card LOCAL_RANK names, so `cuda` resolves to its own card."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(kw["device_id"])
    if coordinator is None and num_processes == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kw)
        return
    dist.init_process_group(backend, init_method=coordinator or "env://",
                            world_size=num_processes or -1,
                            rank=-1 if process_id is None else process_id, **kw)


@contextlib.contextmanager
def own_group():
    """Ends, on leaving, a process group started inside the block (the CLIs'
    one-rank group), and leaves one that existed before alone."""
    owned = not dist.is_initialized()
    try:
        yield
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def is_lead(mesh) -> bool:
    """True where the caller writes files and runs host-side providers: rank 0,
    or the only process when there is no mesh."""
    return mesh is None or dist.get_rank() == 0


def barrier(mesh):
    """Wait for every rank of the mesh (nothing without one)."""
    if mesh is not None:
        dist.barrier()


def broadcast_from_lead(mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Rank 0's `tensor` on every rank (in place; the tensor without a mesh)."""
    if mesh is not None:
        dist.broadcast(tensor, src=0)
    return tensor


def shard_rows(mesh, n: int) -> Tuple[int, int]:
    """This rank's [start, stop) of an n-row batch padded to the next multiple
    of the mesh size: contiguous blocks of ceil(n / size) rows over the
    flattened mesh, so `stop` may pass n on the last ranks."""
    per = -(-n // mesh.size())
    start = dist.get_rank() * per
    return start, start + per


def _rows(x: torch.Tensor, start: int, stop: int) -> torch.Tensor:
    """x[start:stop], rows past the end repeating the last row."""
    n = x.shape[0]
    block = x[start:min(stop, n)]
    if stop > n:
        pad = x[-1:].expand((stop - max(start, n),) + tuple(x.shape[1:]))
        block = torch.cat([block, pad])
    return block


def gather_rows(mesh, block: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's equal block, gathered in rank order, cut to n rows. The
    bytes are gathered, so any dtype goes through gloo and NCCL alike."""
    block = block.contiguous()
    out = torch.empty((mesh.size() * block.shape[0],) + tuple(block.shape[1:]),
                      dtype=block.dtype, device=block.device)
    dist.all_gather_into_tensor(out.view(-1).view(torch.uint8), block.view(-1).view(torch.uint8))
    return out[:n]


def map_rows(fn: Callable, mesh, *arrays: torch.Tensor) -> torch.Tensor:
    """fn(*arrays) over the leading axis, split over the mesh: this rank
    computes its block (`shard_rows`, the pad repeating the last row) and
    every rank returns the whole [n, ...] result."""
    n = arrays[0].shape[0]
    start, stop = shard_rows(mesh, n)
    return gather_rows(mesh, fn(*(_rows(a, start, stop) for a in arrays)), n)


def make_sharded_unet_apply(unet_apply: Callable, mesh, skip_indivisible: bool = False):
    """unet_apply with its rows of x, t_frames and context split over the
    mesh and the output gathered. skip_indivisible: a batch that does not
    tile the mesh runs whole on every rank (the T2V path's 2·B rows, which
    the user's --bs sets; the FIFO batch is padded instead)."""

    def apply(x, t_frames, context, fps=16, **kw):
        if skip_indivisible and x.shape[0] % mesh.size():
            return unet_apply(x, t_frames, context, fps, **kw)
        return map_rows(lambda a, b, c: unet_apply(a, b, c, fps, **kw), mesh, x, t_frames,
                        context)

    return apply


def map_tiled_rows(fn: Callable, mesh, x: torch.Tensor) -> torch.Tensor:
    """fn(x) split over the mesh where x's rows tile it; otherwise every rank
    computes all rows (the head and clip decodes)."""
    if mesh is None or x.shape[0] % mesh.size():
        return fn(x)
    return map_rows(fn, mesh, x)
