"""Package rules and host-side pieces of dynamichmc_tpu_torch.

- Importing the port brings in neither JAX nor the JAX package (the GPU
  machine has no JAX), checked in a fresh interpreter.
- stats.py gives the JAX package's numbers (numpy paths, rtol 1e-12).
- convert.py carries JAX objects across without importing JAX.
- The host-side checks raise DynamicHMCError as the reference does.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamichmc_tpu import stats as jstats
from dynamichmc_tpu.metric import dense_metric as j_dense
from dynamichmc_tpu.metric import diagonal_metric as j_diag
from dynamichmc_tpu.warmup import WarmupState as JWarmupState
from dynamichmc_tpu_torch import DynamicHMCError, NUTS, convert, stats
from dynamichmc_tpu_torch.mcmc import _check_stepsize_search
from dynamichmc_tpu_torch.models import correlated_gaussian
from dynamichmc_tpu_torch.ops import (
    cuda_build,
    gaussian_leaf,
    logreg_leaf,
    tree_kernel,
)
from dynamichmc_tpu_torch.parallel import init_chain_states

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dynamichmc_tpu_torch")


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import dynamichmc_tpu_torch, dynamichmc_tpu_torch.convert\n"
        "import dynamichmc_tpu_torch.ops.tree_kernel, dynamichmc_tpu_torch.stats\n"
        "import dynamichmc_tpu_torch.ops.logreg_leaf, dynamichmc_tpu_torch.stats_device\n"
        "import dynamichmc_tpu_torch.engine, dynamichmc_tpu_torch.parallel\n"
        "import dynamichmc_tpu_torch.ops.gaussian_leaf\n"
        "import dynamichmc_tpu_torch.ops.gaussian_leapfrog, chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'dynamichmc_tpu' or m.startswith('dynamichmc_tpu.')]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_module_of_the_port_imports_jax():
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|dynamichmc_tpu)\b", re.M)
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(PKG):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path


@pytest.mark.parametrize("module", [tree_kernel, logreg_leaf, gaussian_leaf])
def test_kernel_build_is_lazy_and_content_hashed(module, tmp_path):
    """Every CUDA source goes through the one build helper: nothing is built
    or loaded at import, and each library's name hashes its own source and
    the flags."""
    lib = module.library
    assert not lib.loaded  # nothing built or loaded at import
    path = lib.library_path()
    assert os.path.dirname(path) == cuda_build.BUILD_DIR
    assert os.path.basename(path).startswith(f"{lib.name}-")
    assert os.path.exists(lib.source)
    assert lib.source.endswith(f"csrc/{lib.name}.cu")
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
    # an edited source gets another library name
    copy = cuda_build.CudaLibrary(lib.name, lib.signatures)
    copy.source = str(tmp_path / f"{lib.name}.cu")
    with open(lib.source) as f, open(copy.source, "w") as g:
        g.write(f.read() + "\n// edited\n")
    assert copy.library_path() != path
    paths = {m.library.library_path()
             for m in (tree_kernel, logreg_leaf, gaussian_leaf)}
    assert len(paths) == 3


@pytest.mark.parametrize("fn", ["ess_bulk", "ess_tail", "rhat"])
def test_stats_match_jax(fn):
    rng = np.random.default_rng(0)
    x = np.cumsum(rng.normal(size=(4, 300)), axis=1) * 0.1 + rng.normal(
        size=(4, 300))
    assert getattr(stats, fn)(x) == pytest.approx(getattr(jstats, fn)(x),
                                                  rel=1e-12)


def test_ess_rhat_matches_jax():
    x = np.random.default_rng(1).normal(size=(3, 200, 4))
    a = stats.ess_rhat(x)
    b = jstats.ess_rhat(x, use_native=False)
    for key in ("ess_bulk", "ess_tail", "rhat"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-12)


def _stats_workloads():
    """i.i.d., strong positive autocorrelation, antithetic chains, ties and
    a constant series: every branch of the Geyer sequences and the rank
    averaging (tests/test_stats_device.py's workloads)."""
    rng = np.random.RandomState(0)
    iid = rng.randn(4, 200, 2)
    ar = np.zeros((3, 300, 2))
    e = rng.randn(3, 300, 2)
    for t in range(1, 300):
        ar[:, t] = 0.95 * ar[:, t - 1] + np.sqrt(1 - 0.95**2) * e[:, t]
    anti = np.cumprod(np.full((2, 100, 1), -1.0), axis=1) * (
        1 + 0.1 * rng.randn(2, 100, 1))
    ties = np.round(rng.randn(4, 100, 2), 1)
    const = np.concatenate([rng.randn(3, 60, 1), np.ones((3, 60, 1))], 2)
    return {"iid": iid, "ar": ar, "anti": anti, "ties": ties, "const": const}


@pytest.mark.parametrize("name", ["iid", "ar", "anti", "ties", "const"])
def test_stats_device_matches_jax_stats(name):
    """stats_device (torch, float64) against dynamichmc_tpu.stats (numpy)
    to 1e-6 relative, the JAX stats_device's own parity."""
    from dynamichmc_tpu_torch import stats_device

    x = _stats_workloads()[name]
    host = jstats.ess_rhat(x, use_native=False)
    dev = stats_device.ess_rhat_device(torch.as_tensor(x), param_chunk=1)
    for key in ("ess_bulk", "ess_tail", "rhat"):
        np.testing.assert_allclose(dev[key].numpy(), host[key], rtol=1e-6,
                                   err_msg=key)
    bulk = stats_device.ess_bulk_device(torch.as_tensor(x))
    np.testing.assert_allclose(bulk.numpy(), host["ess_bulk"], rtol=1e-6)
    one = stats_device.ess_bulk_device(torch.as_tensor(x[:, :, 0]))
    assert float(one) == pytest.approx(jstats.ess_bulk(x[:, :, 0]), rel=1e-6)


def test_stats_device_rank_normalize_matches_jax():
    from dynamichmc_tpu.stats_device import _rank_normalize as j_rank
    from dynamichmc_tpu_torch.stats_device import _rank_normalize

    x = np.random.RandomState(3).randn(6, 50)
    x[0, :10] = 1.25  # a tie run
    np.testing.assert_allclose(
        _rank_normalize(torch.as_tensor(x)[None])[0].numpy(),
        np.asarray(j_rank(jnp.asarray(x))), rtol=1e-12)


def test_convert_carries_state_across():
    cov = np.array([[2.0, 0.3], [0.3, 0.5]])
    dm = convert.metric(j_dense(jnp.asarray(cov)))
    np.testing.assert_allclose((dm.w @ dm.w.mT).numpy(), np.linalg.inv(cov),
                               rtol=1e-12)
    gm = convert.metric(j_diag(jnp.asarray([1.0, 4.0])))
    np.testing.assert_allclose(gm.w_diag.numpy(), [1.0, 0.5])
    from dynamichmc_tpu.hamiltonian import EvaluatedPoint as JEP

    st = convert.warmup_state(JWarmupState(
        Q=JEP(q=jnp.ones((3, 2)), logdensity=jnp.zeros(3),
              grad=jnp.zeros((3, 2))),
        metric=j_diag(jnp.ones(2)), eps=None), dtype=torch.float32)
    assert st.eps is None and st.Q.q.dtype == torch.float32
    bits = convert.tensor(np.array([0, 1, 2**31, 2**32 - 1], np.uint32))
    assert bits.dtype == torch.int32
    assert [int(b) for b in (bits >> 31) & 1] == [0, 0, 1, 1]
    assert convert.tensor(np.float64(3.0)).shape == ()


def test_init_chain_states_strict_check():
    model = correlated_gaussian(3, dtype=torch.float64, device="cpu")
    q = torch.zeros((4, 3), dtype=torch.float64)
    q[2, 0] = float("nan")
    with pytest.raises(DynamicHMCError, match="initial positions") as err:
        init_chain_states(torch.Generator().manual_seed(0), model, 4, q=q,
                          dtype=torch.float64)
    assert err.value.payload["chains"] == [2]
    st = init_chain_states(torch.Generator().manual_seed(0), model, 4,
                           dtype=torch.float64)
    assert st.metric.m_inv.shape == (4, 3)  # broadcast per chain
    assert float(st.Q.q.abs().max()) <= 2.0


def test_stepsize_search_check_raises():
    ok = torch.tensor([True, True])
    _check_stepsize_search({"eps": torch.ones(2), "success": ok,
                            "l0": torch.zeros(2)})
    with pytest.raises(DynamicHMCError, match="non-finite density"):
        _check_stepsize_search({"eps": torch.ones(2), "success": ok,
                                "l0": torch.tensor([0.0, -float("inf")])})
    with pytest.raises(DynamicHMCError, match="without crossing"):
        _check_stepsize_search({"eps": torch.ones(2),
                                "success": torch.tensor([True, False]),
                                "l0": torch.zeros(2)})


def test_nuts_validation():
    with pytest.raises(ValueError):
        NUTS(max_depth=0)
    with pytest.raises(ValueError):
        NUTS(max_depth=31)
    with pytest.raises(ValueError):
        NUTS(min_delta=1.0)
