"""A mesh of devices for the chains: a ``torch.distributed`` process group
(the port's counterpart of the JAX package's 1-D ``chain_mesh``,
``parallel/chains.py``).

PyTorch runs one process per device, so where the JAX package shards the
chain axis of one program over a ``jax.sharding.Mesh``, the port runs one
rank per device: each rank holds ``n_chains / size`` chains on its own
device and runs the single-device code, and each pooling point makes one
collective call over the group.

The collectives use only ``all_reduce`` and ``broadcast``, the two that
gloo also runs on CUDA tensors, so one code path serves NCCL, gloo on the
card and gloo on the CPU. A gather is a zero-filled buffer that each rank
fills at its own offset, summed over the group. On a mesh of one rank
every helper returns its input: a size-1 mesh is the identity, bit for
bit.
"""

from __future__ import annotations

import dataclasses
import os

import torch


@dataclasses.dataclass(frozen=True)
class ChainMesh:
    """The chains' process group: ``group`` (None: the default group),
    this process's ``rank`` in it, its ``size``, and the ``device`` that
    holds this rank's chains."""

    group: object
    rank: int
    size: int
    device: torch.device


def chain_mesh(group=None, device=None) -> ChainMesh:
    """The mesh of an initialized process group (None: the default one).
    ``device``: where this rank's chains live; by default
    ``cuda:{LOCAL_RANK}`` when torchrun set ``LOCAL_RANK``, else the
    current CUDA device. The CPU only when asked (``device="cpu"``)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "chain_mesh needs an initialized process group "
            "(parallel.multihost.initialize or "
            "torch.distributed.init_process_group)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "chains on the CPU")
        local = os.environ.get("LOCAL_RANK")
        device = torch.device(
            "cuda", int(local) if local is not None
            else torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return ChainMesh(group=group, rank=dist.get_rank(group),
                     size=dist.get_world_size(group), device=device)


def _global_rank(mesh: ChainMesh, rank: int) -> int:
    import torch.distributed as dist

    return rank if mesh.group is None else dist.get_global_rank(mesh.group,
                                                                rank)


def all_sum(x: torch.Tensor, mesh: ChainMesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor; ``x`` on one rank)."""
    if mesh.size == 1:
        return x
    import torch.distributed as dist

    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_mean(x: torch.Tensor, mesh: ChainMesh) -> torch.Tensor:
    """The mean of ``x`` over the ranks."""
    if mesh.size == 1:
        return x
    return all_sum(x, mesh) / mesh.size


def broadcast_from(x: torch.Tensor, mesh: ChainMesh,
                   rank: int = 0) -> torch.Tensor:
    """Rank ``rank``'s ``x`` on every rank (a new tensor; ``x`` on one)."""
    if mesh.size == 1:
        return x
    import torch.distributed as dist

    out = x.clone().contiguous()
    dist.broadcast(out, src=_global_rank(mesh, rank), group=mesh.group)
    return out


def all_gather_chains(x: torch.Tensor, mesh: ChainMesh) -> torch.Tensor:
    """Every rank's (C_local, ...) ``x`` -> the (C, ...) global tensor, the
    ranks' rows in rank order, on every rank. Booleans travel as uint8."""
    if mesh.size == 1:
        return x
    import torch.distributed as dist

    flag = x.dtype == torch.bool
    rows = x.shape[0]
    buf = torch.zeros((mesh.size * rows,) + tuple(x.shape[1:]),
                      dtype=torch.uint8 if flag else x.dtype, device=x.device)
    buf[mesh.rank * rows:(mesh.rank + 1) * rows] = x
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    return buf.bool() if flag else buf
