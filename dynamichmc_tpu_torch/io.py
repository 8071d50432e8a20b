"""Draw streaming: sink sampling chunks to host storage (port of
``dynamichmc_tpu.io``).

A long run wants more draws than device memory holds (4096 chains x 100
coordinates in float32 is 1.6 MB a draw; a million draws is 1.6 TB).
``run_chains(..., draw_sink=store.sink, sample_chunk=n)`` hands each chunk
of ``n`` draws to a sink as it completes, so the device holds O(chunk)
positions, and the draws land in a memory-mapped store that is a numpy
array afterwards.

The on-disk layout is the JAX package's: ``positions.npy`` (C, N, K),
``logdensities.npy`` (C, N) and ``meta.json`` with ``n_chains``,
``n_samples``, ``dim`` and ``dtype``; a store written by either package
opens in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor's values on the host (one copy), or ``np.asarray``."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class MemmapDrawStore:
    """A (n_chains, n_samples, dim) memory-mapped draw store plus the
    draws' log densities, written chunk by chunk by the sampling loop.

    Usage:
        store = MemmapDrawStore(path, n_chains, n_samples, dim)
        run_chains(..., draw_sink=store.sink)
        store.positions[...]   # memmap, (C, N, K)
    """

    def __init__(self, path: str, n_chains: int, n_samples: int, dim: int,
                 dtype=np.float32):
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.n_chains = n_chains
        self.n_samples = n_samples
        self.dim = dim
        self.dtype = np.dtype(dtype)
        self.positions = np.lib.format.open_memmap(
            os.path.join(path, "positions.npy"), mode="w+", dtype=self.dtype,
            shape=(n_chains, n_samples, dim))
        self.logdensities = np.lib.format.open_memmap(
            os.path.join(path, "logdensities.npy"), mode="w+",
            dtype=self.dtype, shape=(n_chains, n_samples))
        self.written = 0
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump({"n_chains": n_chains, "n_samples": n_samples,
                       "dim": dim, "dtype": self.dtype.name}, fh)

    def sink(self, start: int, positions, logdensities,
             tree_statistics) -> None:
        """Write one sampling chunk, copied to the host once; ``start`` is
        the absolute draw offset. Draws past ``n_samples`` are trimmed; a
        2-d chunk is one chain's."""
        qs, lds = _host(positions), _host(logdensities)
        if qs.ndim == 2:  # one chain
            qs, lds = qs[None], lds[None]
        n = min(qs.shape[1], self.n_samples - start)
        if n <= 0:
            return
        # assignment casts to the store's dtype
        self.positions[:, start:start + n] = qs[:, :n]
        self.logdensities[:, start:start + n] = lds[:, :n]
        self.written = max(self.written, start + n)

    def flush(self) -> None:
        self.positions.flush()
        self.logdensities.flush()

    @staticmethod
    def open(path: str) -> "MemmapDrawStore":
        """Re-open an existing store read-only."""
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        store = object.__new__(MemmapDrawStore)
        store.path = path
        store.n_chains = meta["n_chains"]
        store.n_samples = meta["n_samples"]
        store.dim = meta["dim"]
        store.dtype = np.dtype(meta["dtype"])
        store.positions = np.load(os.path.join(path, "positions.npy"),
                                  mmap_mode="r")
        store.logdensities = np.load(os.path.join(path, "logdensities.npy"),
                                     mmap_mode="r")
        store.written = meta["n_samples"]
        return store
