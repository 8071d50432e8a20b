"""Streamed draws: the port's ``io.MemmapDrawStore`` and ``run_chains``'
``draw_sink`` / ``sample_chunk``, against the JAX package.

- Port of JAX tests/test_parallel.py::test_draw_sink_streams_to_memmap.
- A store written by either package opens in the other, with equal arrays.
- A run with a sink fills its store with the draws and log densities of a
  run that keeps them, bit for bit, for every chunk size; the sink sees
  the chunks at their offsets.
- The default chunk is the JAX package's rule.
"""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamichmc_tpu.parallel.chains as jchains
from dynamichmc_tpu.io import MemmapDrawStore as JStore
from dynamichmc_tpu.models import std_normal as j_std_normal
from dynamichmc_tpu_torch import run_chains
from dynamichmc_tpu_torch.io import MemmapDrawStore
from dynamichmc_tpu_torch.models import std_normal
from dynamichmc_tpu_torch.parallel.chains import default_sample_chunk
from dynamichmc_tpu_torch.warmup import default_warmup_stages

F64 = torch.float64
C, N, K = 4, 60, 3


def _stages():
    return default_warmup_stages(init_steps=20, middle_steps=20,
                                 doubling_stages=1, terminating_steps=20)


def _run(**kw):
    return run_chains(torch.Generator().manual_seed(11),
                      std_normal(K, dtype=F64, device="cpu"), C, N,
                      warmup_stages=_stages(), dtype=F64, **kw)


_KEPT = {}


def _kept():
    if "res" not in _KEPT:
        _KEPT["res"] = _run()
    return _KEPT["res"]


def test_draw_sink_streams_to_memmap(tmp_path):
    store = MemmapDrawStore(str(tmp_path / "draws"), n_chains=C,
                            n_samples=N, dim=K, dtype=np.float64)
    res = _run(draw_sink=store.sink)
    store.flush()
    assert res.positions is None and res.logdensities is None
    assert store.written == N
    qs = np.asarray(store.positions)
    assert qs.shape == (C, N, K)
    assert np.isfinite(qs).all()
    # tree statistics still returned, on the device
    assert tuple(res.tree_statistics.depth.shape) == (C, N)
    again = MemmapDrawStore.open(str(tmp_path / "draws"))
    np.testing.assert_array_equal(np.asarray(again.positions), qs)


@pytest.mark.parametrize("chunk", [1, 7, N, 1000, None])
def test_sink_store_equals_the_kept_draws_bitwise(chunk, tmp_path):
    store = MemmapDrawStore(str(tmp_path / "d"), C, N, K, dtype=np.float64)
    seen = []

    def sink(start, positions, logdensities, tree_statistics):
        seen.append((start, tuple(positions.shape),
                     tuple(tree_statistics.depth.shape)))
        store.sink(start, positions, logdensities, tree_statistics)

    res = _run(draw_sink=sink, sample_chunk=chunk)
    ref = _kept()
    np.testing.assert_array_equal(np.asarray(store.positions),
                                  ref.positions.numpy())
    np.testing.assert_array_equal(np.asarray(store.logdensities),
                                  ref.logdensities.numpy())
    for name in ("depth", "steps", "acceptance_rate", "directions"):
        assert torch.equal(getattr(res.tree_statistics, name),
                           getattr(ref.tree_statistics, name)), name
    assert torch.equal(res.eps, ref.eps)
    # an explicit chunk is capped at n_samples, the default is not
    size = default_sample_chunk(C, K) if chunk is None else min(chunk, N)
    starts = list(range(0, N, size))
    assert seen == [(s, (C, min(size, N - s), K), (C, min(size, N - s)))
                    for s in starts]


def test_stores_open_across_packages(tmp_path):
    # the port's store, written by a run, opened by the JAX package
    port = MemmapDrawStore(str(tmp_path / "port"), C, N, K, dtype=np.float64)
    _run(draw_sink=port.sink, sample_chunk=16)
    port.flush()
    j_open = JStore.open(str(tmp_path / "port"))
    assert (j_open.n_chains, j_open.n_samples, j_open.dim) == (C, N, K)
    assert j_open.dtype == np.float64
    np.testing.assert_array_equal(np.asarray(j_open.positions),
                                  _kept().positions.numpy())
    np.testing.assert_array_equal(np.asarray(j_open.logdensities),
                                  _kept().logdensities.numpy())
    # the JAX package's store, fed float32 chunks, opened by the port
    rng = np.random.default_rng(3)
    qs = rng.normal(size=(2, 10, 5)).astype(np.float32)
    lds = rng.normal(size=(2, 10)).astype(np.float32)
    jax_store = JStore(str(tmp_path / "jax"), 2, 10, 5)
    jax_store.sink(0, jnp.asarray(qs[:, :6]), jnp.asarray(lds[:, :6]), None)
    jax_store.sink(6, jnp.asarray(qs[:, 6:]), jnp.asarray(lds[:, 6:]), None)
    jax_store.flush()
    opened = MemmapDrawStore.open(str(tmp_path / "jax"))
    assert (opened.n_chains, opened.n_samples, opened.dim) == (2, 10, 5)
    assert opened.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(opened.positions), qs)
    np.testing.assert_array_equal(np.asarray(opened.logdensities), lds)


def test_sink_trims_and_takes_one_chain(tmp_path):
    """Draws past n_samples are dropped; a 2-d chunk is one chain's."""
    store = MemmapDrawStore(str(tmp_path / "s"), 1, 5, 2, dtype=np.float64)
    qs = torch.arange(16, dtype=F64).reshape(8, 2)
    store.sink(0, qs[:3], qs[:3, 0], None)
    store.sink(3, qs[3:], qs[3:, 0], None)  # 5 draws, 2 fit
    assert store.written == 5
    np.testing.assert_array_equal(np.asarray(store.positions)[0],
                                  qs[:5].numpy())
    store.sink(5, qs, qs[:, 0], None)  # past the end: nothing
    assert store.written == 5


def _jax_default_chunk():
    """The JAX package's default-chunk expression, read from its source."""
    src = inspect.getsource(jchains)
    expr = re.search(r"sample_chunk = (int\(max\(8, min\(512, .*\)\)\)\))",
                     src).group(1)
    return lambda c, k: eval(expr, {"c": c, "k": k})


@pytest.mark.parametrize("c,k", [(1, 1), (4, 3), (4096, 100), (4096, 129),
                                 (8192, 100), (65536, 1000), (2048, 128)])
def test_default_chunk_is_the_jax_rule(c, k):
    assert default_sample_chunk(c, k) == _jax_default_chunk()(c, k)


def test_jax_run_sinks_its_default_chunk():
    """The JAX package's run hands its sink chunks of the default size
    (padded past n_samples); the port's rule gives the same size."""
    sizes = []
    jchains.run_chains(
        jax.random.PRNGKey(0), j_std_normal(K), C, 20, tune="reference",
        warmup_stages=(None,) + tuple(_jax_stages()[1:]),
        initialization={"eps": 0.5},
        draw_sink=lambda start, qs, lds, st: sizes.append(qs.shape[1]))
    assert sizes == [default_sample_chunk(C, K)]


def _jax_stages():
    from dynamichmc_tpu.warmup import default_warmup_stages as j_stages

    return j_stages(init_steps=20, middle_steps=20, doubling_stages=1,
                    terminating_steps=20)


def test_sample_chunk_validation():
    with pytest.raises(ValueError, match="sample_chunk must be >= 1"):
        _run(sample_chunk=0)
