"""Package rules and host-side pieces of dynamichmc_tpu_torch.

- Importing the port brings in neither JAX nor the JAX package (the GPU
  machine has no JAX), checked in a fresh interpreter.
- Every public top-level name of every JAX module has a counterpart in
  the port, or a stated reason why it was not ported.
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
        "import dynamichmc_tpu_torch.diagnostics, dynamichmc_tpu_torch.models\n"
        "import dynamichmc_tpu_torch.models.hierarchical\n"
        "import dynamichmc_tpu_torch.models.mixture\n"
        "import dynamichmc_tpu_torch.models.transforms\n"
        "import dynamichmc_tpu_torch.io, dynamichmc_tpu_torch.checkpoint\n"
        "import dynamichmc_tpu_torch.constraints, dynamichmc_tpu_torch.autotune\n"
        "import dynamichmc_tpu_torch.profiling, dynamichmc_tpu_torch.native\n"
        "sys.path.insert(0, 'tests')\n"
        "import torch_correctness_utils, torch_dummy_batched, torch_turn_statistics\n"
        "import test_torch_db_batched, test_torch_gpu_correctness\n"
        "import test_torch_sample_correctness\n"
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
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(REPO, "tests", n)
        for n in ("torch_correctness_utils.py", "torch_dummy_batched.py",
                  "torch_turn_statistics.py", "test_torch_db_batched.py",
                  "test_torch_gpu_correctness.py",
                  "test_torch_sample_correctness.py")]
    for root, _dirs, files in os.walk(PKG):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    for path in paths:
        with open(path) as f:
            assert not pattern.search(f.read()), path


# names of the JAX package's __all__ the port does not export, with the
# reason; none at present
JAX_NAMES_NOT_EXPORTED = {}


def test_the_port_exports_the_jax_packages_names():
    import dynamichmc_tpu
    import dynamichmc_tpu_torch

    missing = set(dynamichmc_tpu.__all__) - set(dynamichmc_tpu_torch.__all__)
    assert missing == set(JAX_NAMES_NOT_EXPORTED)
    for name in dynamichmc_tpu_torch.__all__:
        assert hasattr(dynamichmc_tpu_torch, name), name
    assert dynamichmc_tpu_torch.__version__ == dynamichmc_tpu.__version__


# The JAX modules whose counterpart in the port has another name.
JAX_MODULE_COUNTERPARTS = {
    "ops/pallas_tree.py": "ops/tree_kernel.py",
    "ops/pallas_logreg.py": "ops/logreg_leaf.py",
    "ops/pallas_leaf.py": "ops/gaussian_leaf.py",
    "ops/pallas_leapfrog.py": "ops/gaussian_leapfrog.py",
}

_ENGINE_PROGRAMS = ("a builder of the JAX engine's jitted programs: the port "
                    "runs the stage fold (warmup.run_warmup, engine.run_block,"
                    " engine.run_sampling) eagerly")
_REF_STACK = ("the merge stack as jax.Ref buffers or a threaded scratch carry:"
              " the port's driver allocates its stack per transition")
_PYTREE = ("utils/pytree.py registers frozen dataclasses as JAX pytrees and "
           "maps over them: the port's state classes are plain dataclasses")
# Public names of the JAX package decided not to port (ROADMAP.md,
# "Decided not to port"), each with its reason; nothing else belongs here.
JAX_NAMES_NOT_PORTED = {
    "checkpoint.py:save_state_orbax": "orbax is a JAX library",
    "checkpoint.py:load_state_orbax": "orbax is a JAX library",
    "engine.py:StageSummary": _ENGINE_PROGRAMS,
    "engine.py:make_stage_driver": _ENGINE_PROGRAMS,
    "engine.py:make_collecting_stage_driver": _ENGINE_PROGRAMS,
    "engine.py:make_metric_update": _ENGINE_PROGRAMS,
    "engine.py:combine_welford_batch": _ENGINE_PROGRAMS,
    "engine.py:make_shared_metric_update": _ENGINE_PROGRAMS,
    "engine.py:make_sampling_driver": _ENGINE_PROGRAMS,
    "engine.py:FastPrograms": _ENGINE_PROGRAMS,
    "engine.py:build_programs": _ENGINE_PROGRAMS,
    "engine.py:execute": _ENGINE_PROGRAMS,
    "engine.py:make_stage_driver_batched": _ENGINE_PROGRAMS,
    "engine.py:make_monolithic_warmup_driver": _ENGINE_PROGRAMS,
    "engine.py:make_sampling_driver_batched": _ENGINE_PROGRAMS,
    "engine.py:build_programs_batched": _ENGINE_PROGRAMS,
    "metric.py:metric_dim": "no work of its own: m_inv.shape[0]",
    "metric.py:sqrt_diag_m_inv": "no work of its own: sqrt of M^-1's diagonal",
    "tree.py:make_tree_noise": ("a numpy helper of the JAX equivalence tests; "
                                "the port's tests draw their noise themselves"),
    "tree_batched.py:use_ref_stack": _REF_STACK,
    "tree_batched.py:make_tree_stack_refs": _REF_STACK,
    "tree_batched.py:make_tree_scratch": _REF_STACK,
    "tree_wavefront.py:wavefront_carry_specs": (
        "shard_map partition specs: each rank holds its own lanes' carry"),
    "tree_wavefront_epoch.py:epoch_carry_specs": (
        "shard_map partition specs: each rank holds its own lanes' carry"),
    "utils/cache.py:host_fingerprint": (
        "utils/cache.py keys the XLA compile cache, which the port has not; "
        "native.host_fingerprint keys its host library"),
    "utils/cache.py:host_keyed_cache_dir": (
        "utils/cache.py keys the XLA compile cache, which the port has not"),
    "utils/pytree.py:pytree_dataclass": _PYTREE,
    "utils/pytree.py:tree_where": _PYTREE,
    "utils/pytree.py:tree_index": _PYTREE,
    "utils/pytree.py:tree_update_index": _PYTREE,
    "utils/pytree.py:tree_select_level": _PYTREE,
    "utils/pytree.py:tree_update_level": _PYTREE,
    "utils/welford.py:welford_init": (
        "no work of its own: zero count, mean and m2"),
    "utils/welford.py:pool_welford_over_axis": (
        "pools over a named vmap or mesh axis; the port pools over a "
        "torch.distributed group (pool_welford_over_group)"),
}


def _jax_public_names():
    """(module path, name) of every public top-level def and class of the
    JAX package, read from its sources as text."""
    import ast

    root = os.path.join(REPO, "dynamichmc_tpu")
    for dirpath, _dirs, files in os.walk(root):
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                tree = ast.parse(f.read())
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)) and not node.name.startswith("_"):
                    yield rel, node.name


def _port_has(rel, name):
    """Whether the port's counterpart of JAX module ``rel`` (or the
    package that holds it, which may re-export the name from a sibling)
    defines ``name``."""
    import importlib

    rel = JAX_MODULE_COUNTERPARTS.get(rel, rel)
    if not os.path.exists(os.path.join(PKG, rel)):
        return False
    dotted = rel[:-3].replace("/", ".")
    dotted = dotted[:-len(".__init__")] if dotted.endswith(".__init__") else dotted
    module = importlib.import_module(f"dynamichmc_tpu_torch.{dotted}")
    package = importlib.import_module(
        f"dynamichmc_tpu_torch.{dotted.rpartition('.')[0]}".rstrip("."))
    return hasattr(module, name) or hasattr(package, name)


def test_every_public_jax_name_is_ported_or_decided_against():
    """The port is whole: each public top-level def or class of each JAX
    module exists in its counterpart module of the port, or is in
    JAX_NAMES_NOT_PORTED with its reason; and that dict names only JAX
    names the port lacks."""
    missing, names = [], set()
    for rel, name in _jax_public_names():
        key = f"{rel}:{name}"
        names.add(key)
        if _port_has(rel, name):
            assert key not in JAX_NAMES_NOT_PORTED, f"{key} is ported"
        elif key not in JAX_NAMES_NOT_PORTED:
            missing.append(key)
    assert not missing, f"JAX names with no counterpart in the port: {missing}"
    assert set(JAX_NAMES_NOT_PORTED) <= names
    assert all(r and "\n" not in r for r in JAX_NAMES_NOT_PORTED.values())


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
    a = stats.ess_rhat(x, use_native=False)
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
    """The check reads a warmup history, as JAX ``_check_stepsize_search``
    does: only the search's results (the entries with l0) are checked."""
    ok = torch.tensor([True, True])

    def history(results):
        return [(None, None, None), (None, results, None),
                (None, {"epss": torch.ones(3)}, None)]

    _check_stepsize_search(history({"eps": torch.ones(2), "success": ok,
                                    "l0": torch.zeros(2)}))
    with pytest.raises(DynamicHMCError, match="non-finite density"):
        _check_stepsize_search(history({
            "eps": torch.ones(2), "success": ok,
            "l0": torch.tensor([0.0, -float("inf")])}))
    with pytest.raises(DynamicHMCError, match="without crossing"):
        _check_stepsize_search(history({
            "eps": torch.ones(2), "success": torch.tensor([True, False]),
            "l0": torch.zeros(2)}))


def test_nuts_validation():
    with pytest.raises(ValueError):
        NUTS(max_depth=0)
    with pytest.raises(ValueError):
        NUTS(max_depth=31)
    with pytest.raises(ValueError):
        NUTS(min_delta=1.0)
