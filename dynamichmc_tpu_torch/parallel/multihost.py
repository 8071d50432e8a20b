"""Multi-process chain fan-out on ``torch.distributed`` (port of
``dynamichmc_tpu.parallel.multihost``).

One process per device, as torchrun starts them: ``initialize`` joins the
process group, ``global_chain_mesh`` spans it, and ``run_chains_multihost``
runs ``n_chains_per_device`` chains on every rank. Sampling needs no
communication; the collectives are the pooled adaptation's (one Welford
pool per pooled metric estimate, one mean per pooled stepsize update) and
the checks that read every chain (parallel/chains.py).

    torchrun --nproc-per-node=N script.py   # script: initialize(), then
                                            # run_chains_multihost(...)
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from .chains import run_chains
from .mesh import ChainMesh, chain_mesh

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> None:
    """Join the default process group (``torch.distributed``).

    A no-op when the group is already initialized, or when single-process
    with nothing given: no argument and no torchrun variable. It
    initializes the group when the arguments say so (``init_method``, e.g.
    ``"tcp://host:port"`` or ``"file:///shared/path"``, with
    ``world_size`` and ``rank``) or torchrun's ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR`` do. Anything else raises, as does a failed rendezvous:
    a misconfigured multi-process run never degrades to a single-process
    one. ``backend``: ``nccl`` where CUDA is available, else ``gloo``;
    under nccl with torchrun's ``LOCAL_RANK``, that CUDA device becomes the
    current one. ``timeout``: of every collective (torch's default if
    None)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    given = [name for name, value in (("init_method", init_method),
                                      ("world_size", world_size),
                                      ("rank", rank)) if value is not None]
    env = [name for name in _TORCHRUN_ENV if name in os.environ]
    if not given and not env:
        return  # one process, nothing configured
    if given and len(given) < 3 and init_method is not None:
        raise ValueError(f"initialize: {', '.join(given)} given; an "
                         "init_method needs world_size and rank too")
    if not given and len(env) < len(_TORCHRUN_ENV):
        raise ValueError(
            f"initialize: only {', '.join(env)} of torchrun's "
            f"{', '.join(_TORCHRUN_ENV)} are set")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    kwargs = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank, **kwargs)


def global_chain_mesh(device=None) -> ChainMesh:
    """The mesh of every rank of the default process group, this rank's
    chains on ``device`` (as ``mesh.chain_mesh``)."""
    return chain_mesh(None, device)


def run_chains_multihost(generator: torch.Generator, ld,
                         n_chains_per_device: int, n_samples: int,
                         device=None, **kwargs):
    """``run_chains`` over the global mesh with ``n_chains_per_device``
    chains on every rank; returns this rank's result (the rank's chains,
    the pooled metric and eps on every rank alike).

    ``generator``: seeded alike on every rank, as the JAX package's one
    key. One 63-bit seed is drawn from it, and rank r's chains run on a
    new generator on ``device`` seeded with seed + r, so that no two
    ranks run the same stream. ``device``: as ``global_chain_mesh``'s."""
    mesh = global_chain_mesh(device)
    seed = int(torch.randint(0, 2 ** 63 - 1, (1,), generator=generator,
                             device=generator.device))
    stream = torch.Generator(device=mesh.device).manual_seed(seed + mesh.rank)
    return run_chains(stream, ld, n_chains_per_device * mesh.size, n_samples,
                      mesh=mesh, **kwargs)
