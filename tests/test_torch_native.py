"""The port's native ESS engine (dynamichmc_tpu_torch/native/): its C++
batch ESS / R-hat against the port's numpy path (rtol 1e-7, the JAX
package's tests/test_native.py cases) and against the JAX package's own
engine (rtol 1e-12, where that loads), the dispatch of
``stats.ess_rhat(use_native=...)``, and the build: a hashed name under
``_build/``, one build when processes race, None without a compiler."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dynamichmc_tpu import stats as jstats
from dynamichmc_tpu_torch import native, stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("ess_bulk", "ess_tail", "rhat")


@pytest.fixture(scope="module")
def lib_available():
    if native.load() is None:
        pytest.skip("fastdiag unavailable (no C++ toolchain)")


def make_chains(seed, c=6, n=400, k=4, rho=0.6, shift_chain=None):
    """tests/test_native.py's AR(1) chains."""
    rng = np.random.RandomState(seed)
    eps = rng.randn(c, n, k)
    x = np.zeros_like(eps)
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + eps[:, t]
    if shift_chain is not None:
        x[shift_chain] += 3.0
    return x


def _cases():
    nan = make_chains(3)
    nan[0, 5, 0] = np.nan
    return {"rho0": make_chains(0, rho=0.0), "rho0.6": make_chains(0, rho=0.6),
            "rho0.95": make_chains(0, rho=0.95),
            "shifted": make_chains(1, shift_chain=0), "nan": nan}


@pytest.mark.parametrize("rho", [0.0, 0.6, 0.95])
def test_parity_autocorrelated(lib_available, rho):
    x = make_chains(0, rho=rho)
    got = native.ess_rhat_batch(x)
    want = stats.ess_rhat(x, use_native=False)
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-7, err_msg=key)


def test_parity_nonconverged(lib_available):
    x = make_chains(1, shift_chain=0)
    got = native.ess_rhat_batch(x)
    want = stats.ess_rhat(x, use_native=False)
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-7, err_msg=key)
    assert got["rhat"].max() > 1.2


def test_nan_input_is_defined(lib_available):
    """A NaN draw gives the same outputs twice, and the other parameters
    keep their parity with the numpy path."""
    x = _cases()["nan"]
    got1 = native.ess_rhat_batch(x)
    got2 = native.ess_rhat_batch(x)
    for key in KEYS:
        np.testing.assert_array_equal(got1[key], got2[key])
    want = stats.ess_rhat(x[:, :, 1:], use_native=False)
    for key in KEYS:
        np.testing.assert_allclose(got1[key][1:], want[key], rtol=1e-7)


def test_degenerate_draw_counts(lib_available):
    """Fewer than 4 draws: NaN, never an out-of-bounds read."""
    for n in (1, 2, 3):
        x = np.random.default_rng(n).normal(size=(4, n, 2))
        got = native.ess_rhat_batch(x)
        assert np.isnan(got["ess_bulk"]).all()


@pytest.mark.parametrize("case", sorted(_cases()))
def test_matches_the_jax_packages_engine(lib_available, case):
    """The same C++ source built twice: the port's engine gives the JAX
    package's engine's numbers (NaN where it gives NaN)."""
    from dynamichmc_tpu import native as jnative

    if jnative.load() is None:
        pytest.skip("the JAX package's fastdiag is unavailable")
    x = _cases()[case]
    got, want = native.ess_rhat_batch(x), jnative.ess_rhat_batch(x)
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12,
                                   err_msg=key)


def test_stats_dispatches_to_native(lib_available):
    x = make_chains(2)
    direct = native.ess_rhat_batch(x)
    via = stats.ess_rhat(x, use_native=True)
    plain = stats.ess_rhat(x, use_native=False)
    jplain = jstats.ess_rhat(x, use_native=False)
    for key in KEYS:
        np.testing.assert_array_equal(via[key], direct[key])
        np.testing.assert_array_equal(stats.ess_rhat(x)[key], direct[key])
        np.testing.assert_allclose(plain[key], jplain[key], rtol=1e-12)
        np.testing.assert_allclose(via[key], plain[key], rtol=1e-7)
    stacked = np.swapaxes(x, 0, 1)  # (draws, chains, params)
    for key, value in stats.ess_rhat_from_stacked(stacked).items():
        np.testing.assert_array_equal(value, direct[key])
        np.testing.assert_allclose(
            value, jstats.ess_rhat_from_stacked(stacked)[key], rtol=1e-7)


def test_library_is_host_keyed_and_content_hashed():
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "dynamichmc_tpu_torch",
                                                 "_build")
    name = os.path.basename(path)
    assert name.startswith("fastdiag-") and name.endswith(".so")
    assert name[:-3].rsplit("-", 1)[1] == native.host_fingerprint()
    assert os.path.exists(native.SOURCE)


def _fresh(monkeypatch, tmp_path, compilers):
    """An empty build directory, nothing loaded, these compilers."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_compilers", lambda: compilers)


def test_without_a_compiler_the_numpy_path_runs(monkeypatch, tmp_path):
    """No compiler and no library built: load() gives None, says why, and
    stats.ess_rhat takes the numpy path."""
    _fresh(monkeypatch, tmp_path, [str(tmp_path / "no-such-compiler")])
    assert native.load() is None
    assert "no-such-compiler" in native.build_log
    assert native.ess_rhat_batch(make_chains(0)) is None
    x = make_chains(4)
    got, want = stats.ess_rhat(x), stats.ess_rhat(x, use_native=False)
    for key in KEYS:
        np.testing.assert_array_equal(got[key], want[key])
    assert all(f.endswith(".so.lock") for f in os.listdir(tmp_path))


def test_a_compiler_without_openmp_falls_back_to_numpy(monkeypatch, tmp_path):
    """A compiler that refuses -fopenmp (no libgomp) builds nothing: load()
    gives None, says why, and stats.ess_rhat takes the numpy path."""
    cxx = tmp_path / "cxx-without-openmp"
    cxx.write_text('#!/bin/sh\ncase "$*" in *-fopenmp*) '
                   'echo "cannot read spec file libgomp.spec" >&2; exit 1;; '
                   'esac\nexec g++ "$@"\n')
    cxx.chmod(0o755)
    _fresh(monkeypatch, tmp_path, [str(cxx)])
    assert native.load() is None
    assert "libgomp.spec" in native.build_log
    assert not os.path.exists(native.library_path())
    x = make_chains(5)
    got, want = stats.ess_rhat(x), stats.ess_rhat(x, use_native=False)
    for key in KEYS:
        np.testing.assert_array_equal(got[key], want[key])


def test_processes_racing_to_build_build_once(tmp_path):
    """Three interpreters load at once into an empty build directory: each
    gets the library, built once under the lock and renamed into place."""
    code = ("import sys\n"
            "from dynamichmc_tpu_torch import native\n"
            "native.BUILD_DIR = sys.argv[1]\n"
            "print(native.load() is not None)\n")
    env = {k: v for k, v in os.environ.items() if k != "DYNHMC_NO_NATIVE"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=240)[0].strip() for p in procs]
    if native.load() is None:
        assert outs == ["False"] * 3
        return
    assert outs == ["True"] * 3
    files = sorted(os.listdir(tmp_path))
    so = os.path.basename(native.library_path())
    assert files == [so, f"{so}.lock"]
