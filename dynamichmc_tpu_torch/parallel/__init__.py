"""Batched chains on one device or over a mesh of devices."""

from .chains import init_chain_states, run_chains
from .mesh import ChainMesh, chain_mesh
from .multihost import global_chain_mesh, initialize, run_chains_multihost

__all__ = ["ChainMesh", "chain_mesh", "global_chain_mesh", "init_chain_states",
           "initialize", "run_chains", "run_chains_multihost"]
