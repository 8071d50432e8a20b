"""Batched chains on one device."""

from .chains import init_chain_states, run_chains

__all__ = ["init_chain_states", "run_chains"]
