"""Multi-process fan-out on the port (``parallel/multihost.py``): the JAX
package's tests/test_multihost.py on torch.distributed.

``initialize()`` is a no-op in one process with nothing configured and
refuses a partial configuration; over a 2-rank gloo group on the CPU
(tests/torch_mesh_worker.py) ``global_chain_mesh`` spans the world and
``run_chains_multihost``, from one generator seeded alike on both ranks,
gives each rank (n_chains_per_device, N, K) finite draws of its own
chains with a pooled metric replicated bit for bit, and the moments of
JAX's single-process test at its tolerances.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from dynamichmc_tpu_torch.parallel import initialize
from torch_mesh_worker import spawn

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn("multihost", 2, tmp_path_factory.mktemp("multihost"))


@pytest.fixture
def clean_env(monkeypatch):
    for name in TORCHRUN_ENV:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_initialize_single_process_is_noop(clean_env):
    initialize()
    assert not dist.is_initialized()


@pytest.mark.parametrize("env,kw", [
    ({"RANK": "0"}, {}),
    ({"RANK": "0", "WORLD_SIZE": "2"}, {}),
    ({}, {"init_method": "file:///nonexistent/store"}),
    ({}, {"init_method": "file:///nonexistent/store", "world_size": 2}),
])
def test_initialize_refuses_a_partial_configuration(clean_env, env, kw):
    for name, value in env.items():
        clean_env.setenv(name, value)
    with pytest.raises(ValueError, match="initialize"):
        initialize(**kw)
    assert not dist.is_initialized()


def test_global_chain_mesh_spans_the_world(ranks):
    for r, out in enumerate(ranks):
        assert (out["size"], out["rank"], out["world_size"]) == (2, r, 2)


def test_run_chains_multihost_two_processes(ranks):
    for out in ranks:
        res = out["two_process"]
        assert res["positions"].shape == (2, 50, 2)  # this rank's chains
        assert torch.isfinite(res["positions"]).all()
        assert res["m_inv"].shape == (2,)  # pooled: replicated
        assert torch.isfinite(res["m_inv"]).all()
        assert res["eps"].shape == (2,)
    assert torch.equal(ranks[0]["two_process"]["m_inv"],
                       ranks[1]["two_process"]["m_inv"])
    # one seed on both ranks, one stream per rank: other chains
    assert not torch.equal(ranks[0]["two_process"]["positions"],
                           ranks[1]["two_process"]["positions"])


def test_run_chains_multihost_pooled_moments(ranks):
    """JAX's single-process case at its sizes: 16 chains in all, a pooled
    metric near the unit variances, the moments of N(0, I)."""
    assert torch.equal(ranks[0]["pooled"]["m_inv"],
                       ranks[1]["pooled"]["m_inv"])
    m_inv = ranks[0]["pooled"]["m_inv"].numpy()
    assert m_inv.shape == (3,)
    np.testing.assert_allclose(m_inv, 1.0, rtol=0.5)
    qs = torch.cat([out["pooled"]["positions"] for out in ranks]).numpy()
    assert qs.shape == (16, 200, 3)
    qs = qs.reshape(-1, 3)
    assert np.abs(qs.mean(0)).max() < 0.15
    assert np.abs(qs.std(0) - 1).max() < 0.15
