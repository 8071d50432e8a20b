"""The benchmark's harness on the CPU: its files found by name, the
window's arithmetic, the frozen ESS against numpy, the imports, and the
check: sound runs pass, the control and planted faults fail. The port's
kernels run their plain versions here (CPU tensors); the card's tests are
marked ``gpu``."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from scipy.special import ndtri

from conftest import CELLS, ROOT, _dump, _load

from hmcbench import checks, faults, harness, registry
from hmcbench.reference import ess, peaks, precision
from hmcbench.trace import TraceRecord
from hmcbench.window import CallRecord, RunRecord, call_seed, run_window

NAME = registry.NAME
UNIT_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                 "0123456789_/%.-")


def run_tiny(root, cell, seed=7, seconds=0.5, traced=False):
    return harness.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                            time.perf_counter(), root)


# --- files found by name ------------------------------------------------


def test_every_cell_configuration_and_metric_loads_by_name():
    reg = registry.Registry(ROOT)
    bench = reg.benchmark
    assert bench["paths"] == ["hmcbench"]
    assert bench["command"] == ["python3", "hmcbench/run.py"]
    names = [c["name"] for c in bench["configs"]]
    for config in bench["configs"]:
        data = reg.config(config["name"])
        assert data["name"] == config["name"]
        assert os.path.join(ROOT, config["file"]) == os.path.join(
            reg.dir, "configs", config["name"] + ".json")
        assert data["reduced"] == config["reduced"] == []
        assert data["dtype"] == "float32"
        registry.reference(data["model"])
        registry.target(data["model"])
    for cell in bench["workloads"]:
        work = reg.workload(cell["name"])
        assert work["config"] == cell["config"] in names
        assert work["name"] == cell["name"]
        assert cell["chips"] == 1
        assert 1 <= len(cell["why"]) <= 200
        assert set(work["limits"]) == set(checks.NAMES)
        untraced = {m["name"] for m in reg.metrics(cell["name"], False)}
        traced = reg.metrics(cell["name"], True)
        assert {"setup_s", "ess_per_s", "run_s"} <= untraced
        assert traced and all(m["moves"] in untraced for m in traced)
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(metric["name"])
        assert set(metric["unit"]) <= UNIT_CHARS
        assert metric["better"] in ("lower", "higher")
        assert callable(reg.reader(metric["name"]))
    for metric in bench["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_a_cell_and_a_metric_added_from_files_alone_are_found(tmp_path):
    root = os.path.join(str(tmp_path), "checkout")
    from conftest import make_tiny_root

    make_tiny_root(root)
    with open(os.path.join(root, "hmcbench", "metrics",
                           "calls_in_window.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.calls))\n")
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    work = _load(os.path.join(root, "hmcbench", "workloads",
                              "gauss100_dense.tiny.json"))
    work.update(name="gauss100_dense.thrown", chains=8)
    _dump(work, os.path.join(root, "hmcbench", "workloads",
                             "gauss100_dense.thrown.json"))
    bench["workloads"].append({"name": "gauss100_dense.thrown",
                               "config": work["config"], "traffic": "thrown",
                               "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({
        "name": "calls_in_window", "unit": "calls", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["gauss100_dense.thrown"]})
    for metric in bench["end_to_end"]:
        if "workloads" not in metric or metric["name"] == "calls_in_window":
            continue
        metric["workloads"].append("gauss100_dense.thrown")
    _dump(bench, os.path.join(root, "BENCHMARK.json"))
    result = run_tiny(root, "gauss100_dense.thrown", seconds=0.2)
    assert result["metrics"]["calls_in_window"]["value"] == result["attempted"]
    assert {"ess_per_s", "run_s", "setup_s"} <= set(result["metrics"])


def test_names_outside_the_rule_are_refused():
    reg = registry.Registry(ROOT)
    for bad in ("../BENCHMARK", "a b", "", "x/y", "-lead"):
        with pytest.raises(ValueError):
            reg.workload(bad)


# --- the window ---------------------------------------------------------


def test_the_call_in_flight_at_the_deadline_counts_whole():
    walls = iter([0.4, 0.4, 0.4, 0.4])
    calls = run_window(lambda i: CallRecord(wall_s=next(walls),
                                            min_ess=100.0 * (i + 1)), 1.0)
    assert len(calls) == 3  # 0.8 s < 1.0 s when the third started
    run = RunRecord(cell={}, config={}, reference=None, setup_s=5.0,
                    calls=calls)
    reg = registry.Registry(ROOT)
    assert run.window_s == pytest.approx(1.2)
    assert reg.reader("ess_per_s")(run) == pytest.approx(600.0 / 1.2)
    assert reg.reader("run_s")(run) == pytest.approx(0.4)
    assert reg.reader("setup_s")(run) == 5.0


def test_a_failed_call_adds_its_time_and_no_ess():
    calls = [CallRecord(wall_s=1.0, min_ess=50.0),
             CallRecord(wall_s=3.0, failure="non-finite draws")]
    run = RunRecord(cell={}, config={}, reference=None, setup_s=1.0,
                    calls=calls)
    assert registry.Registry(ROOT).reader("ess_per_s")(run) == 50.0 / 4.0


def test_call_seeds_take_any_large_seed_and_repeat():
    seeds = [0, 1, 2**31 + 5, 2**32 + 5, 2**40 + 3]
    got = {call_seed(s, i) for s in seeds for i in (-1, 0, 1)}
    assert len(got) == 15 and all(0 <= x < 2**63 for x in got)
    assert call_seed(2**33, 4) == call_seed(2**33, 4)
    assert call_seed(9, 0, 0) != call_seed(9, 0, 1)


# --- the yardstick ------------------------------------------------------


def _numpy_bulk_ess(x):
    """Bulk ESS of one parameter's (chains, draws), written plainly
    (Vehtari et al. 2021): split chains, average-tied ranks, Blom offsets,
    then Geyer's initial positive and monotone sequences as loops."""
    c, n = x.shape
    half = n // 2
    x = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    c, n = x.shape
    flat = x.ravel()
    order = np.argsort(flat, kind="mergesort")
    ranks = np.empty(flat.size)
    sorted_vals = flat[order]
    i = 0
    while i < flat.size:
        j = i
        while j + 1 < flat.size and sorted_vals[j + 1] == sorted_vals[i]:
            j += 1
        ranks[order[i:j + 1]] = (i + j) / 2 + 1
        i = j + 1
    z = ndtri((ranks - 0.375) / (flat.size + 0.25)).reshape(c, n)
    zc = z - z.mean(axis=1, keepdims=True)
    acov = np.array([[np.dot(zc[k, :n - t], zc[k, t:]) / n for t in range(n)]
                     for k in range(c)])
    mean_var = (acov[:, 0] * n / (n - 1)).mean()
    var_plus = mean_var * (n - 1) / n + z.mean(axis=1).var(ddof=1)
    rho = np.zeros(n)
    rho[0] = 1.0
    even, odd = 1.0, 1 - (mean_var - acov[:, 1].mean()) / var_plus
    rho[1] = odd
    t = 1
    while t < n - 3 and even + odd > 0:
        even = 1 - (mean_var - acov[:, t + 1].mean()) / var_plus
        odd = 1 - (mean_var - acov[:, t + 2].mean()) / var_plus
        if even + odd >= 0:
            rho[t + 1], rho[t + 2] = even, odd
        t += 2
    max_t = t - 2
    if even > 0:
        rho[max_t + 1] = even
    t = 1
    while t <= max_t - 2:
        if rho[t + 1] + rho[t + 2] > rho[t - 1] + rho[t]:
            rho[t + 1] = rho[t + 2] = (rho[t - 1] + rho[t]) / 2
        t += 2
    tau = -1 + 2 * rho[:max_t + 1].sum() + rho[max_t + 1]
    tau = max(tau, 1 / np.log10(c * n))
    return c * n / tau


@pytest.mark.parametrize("phi", [0.0, 0.6, 0.95])
def test_the_frozen_ess_matches_numpy(phi):
    rng = np.random.default_rng(3)
    C, N, K = 6, 200, 3
    x = np.zeros((C, N, K))
    noise = rng.standard_normal((C, N, K))
    for t in range(1, N):
        x[:, t] = phi * x[:, t - 1] + noise[:, t]
    x[:, :, 2] = np.round(x[:, :, 2])  # ties
    got = ess.ess_bulk(torch.as_tensor(x, dtype=torch.float32)).numpy()
    want = [_numpy_bulk_ess(x.astype(np.float32).astype(np.float64)[:, :, k])
            for k in range(K)]
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_the_ess_blocks_give_the_unblocked_numbers(monkeypatch):
    x = torch.randn(4, 64, 7, generator=torch.Generator().manual_seed(1))
    whole = ess.ess_bulk(x)
    monkeypatch.setattr(ess, "CHUNK_ELEMENTS", 4 * 64 * 2)
    torch.testing.assert_close(ess.ess_bulk(x), whole, rtol=0, atol=0)


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-11 + 2**-13, 1 + 2**-12,
                      -3.0 * (1 + 2**-12), 6.5e-3])
    got = precision.tf32(x)
    want = torch.tensor([1.0, 1 + 2**-10, 1 + 2**-10, 1.0, -3.0, 6.5e-3])
    assert torch.allclose(got, want, rtol=2**-11, atol=0)
    assert got[:5].tolist() == want[:5].tolist()
    mantissa = got.view(torch.int32) & 0x1FFF
    assert bool((mantissa == 0).all())


@pytest.mark.parametrize("config", ["gauss100_dense", "logreg_1000x25"])
def test_the_reference_gradient_is_its_value_s_derivative(config):
    reg = registry.Registry(ROOT)
    cfg = reg.config(config)
    ref = registry.reference(cfg["model"])
    target = ref.make_target(ref.make_data(cfg), "cpu", cfg)
    q = torch.randn(3, cfg["dim"], dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2)) * 0.1
    q.requires_grad_(True)
    ld, grad = target.ld_grad(q.detach())
    auto = torch.func.grad(lambda v: _value(target, cfg, v).sum())(q)
    torch.testing.assert_close(grad, auto, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(ld, _value(target, cfg, q.detach()))


def _value(target, cfg, q):
    if cfg["model"] == "gaussian":
        d = q - target.mean
        return -0.5 * (d * (d @ target.prec.mT)).sum(-1)
    logits = q @ target.x.mT
    return ((target.y * logits).sum(-1)
            - torch.nn.functional.softplus(logits).sum(-1)
            - 0.5 * ((q / target.prior_scale) ** 2).sum(-1))


def test_the_bounds_follow_the_frozen_arithmetic():
    reg = registry.Registry(ROOT)
    gauss = reg.config("gauss100_dense")
    logreg = reg.config("logreg_1000x25")
    g, lr = registry.reference("gaussian"), registry.reference(
        "logistic_regression")
    assert g.leaf_flops(gauss) == 8 * 100**2 + 30 * 100
    assert lr.leaf_flops(logreg) == 4 * 1000 * 25 + 10 * 1000 + 30 * 25
    # every input and output of a launch once; at chip_smoke's
    # logreg_tree shape the bound of 2048 chains x 15 leaves is the
    # operations' (0.94 ms, as its phase 5 gives it)
    tree = dict(logreg, n_obs=4000, dim=128)
    n_bytes = lr.launch_bytes(tree, 2048)
    C, K = 2048, 128
    assert n_bytes == 4 * (3 * C * K + 3 * C + 15 * C + 4 * C + K
                           + 4000 * K + 4000 + 2 * C * K + 9 * C)
    seconds, by = peaks.bound_seconds(2048 * 15 * lr.leaf_flops(tree),
                                      n_bytes)
    assert by == "operations" and seconds == pytest.approx(9.57e-4, rel=0.01)
    # X's rows padded to 4 floats: 25 -> 28
    assert lr.launch_bytes(logreg, 1) - lr.launch_bytes(
        dict(logreg, n_obs=0), 1) == 4 * 1000 * (28 + 1)


def test_the_gaussian_is_neal_s_and_the_logreg_data_have_an_intercept():
    reg = registry.Registry(ROOT)
    cfg = reg.config("gauss100_dense")
    sd = np.sqrt(np.diag(registry.reference("gaussian").make_data(cfg)["cov"]))
    np.testing.assert_allclose(sd, np.arange(1, 101) / 100, rtol=1e-12)
    cfg = reg.config("logreg_1000x25")
    data = registry.reference("logistic_regression").make_data(cfg)
    x, y = data["x"], data["y"]
    assert x.shape == (1000, 25) and y.shape == (1000,)
    assert (x[:, 0] == 1).all()
    np.testing.assert_allclose(x[:, 1:].mean(0), 0, atol=1e-12)
    np.testing.assert_allclose(x[:, 1:].std(0), 1, rtol=1e-12)
    assert 0.2 < y.mean() < 0.4 and set(np.unique(y)) == {0.0, 1.0}


def test_importance_sampling_recovers_a_known_posterior():
    from hmcbench.reference import importance

    K = 4
    a = torch.randn(K, K, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(4))
    cov = a @ a.mT / K + 0.1 * torch.eye(K, dtype=torch.float64)
    mu = torch.arange(K, dtype=torch.float64)
    prec = torch.linalg.inv(cov)

    def log_density(x):
        d = x - mu
        return -0.5 * (d * (d @ prec)).sum(-1)

    mean, got, n = importance.moments(
        log_density, mu + 0.05, cov * 1.2, 1 << 17,
        torch.Generator().manual_seed(5))
    assert 1 << 14 < n < 1 << 17
    sd = torch.sqrt(torch.diagonal(cov))
    assert float(((mean - mu).abs() / (sd / n**0.5)).max()) < 5
    assert float(((got - cov).abs() / torch.outer(sd, sd)).max()) < 0.03


def test_the_logreg_reference_finds_the_mode_and_its_moments():
    # the posterior of 1000 rows is near its Laplace approximation (the
    # intercept's mean lies a third of a standard deviation past the
    # mode), and another proposal gives the same moments
    from hmcbench.reference import importance

    reg = registry.Registry(ROOT)
    cfg = dict(reg.config("logreg_1000x25"), reference_draws=1 << 16)
    ref = registry.reference("logistic_regression")
    target = ref.make_target(ref.make_data(cfg), "cpu", cfg)
    mode, laplace = target.mode()
    _, grad = target.ld_grad(mode[None])
    assert float(grad.abs().max()) < 1e-8
    mean, cov, n = ref.posterior_moments(target, cfg)
    assert n > 0.4 * cfg["reference_draws"]
    sd = torch.sqrt(torch.diagonal(laplace))
    assert float(((mean - mode).abs() / sd).max()) < 0.5
    torch.testing.assert_close(torch.sqrt(torch.diagonal(cov)), sd,
                               rtol=0.05, atol=0)
    mean3, cov3, n3 = importance.moments(
        lambda b: target.ld_grad(b, grad=False)[0], mode, laplace * 1.5,
        1 << 16, torch.Generator().manual_seed(9), df=3)
    se = torch.sqrt(torch.diagonal(cov) * (1 / n + 1 / n3))
    assert float(((mean3 - mean).abs() / se).max()) < 5


# --- the imports --------------------------------------------------------


def _python(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    code = f"""
import time, torch, sys
import hmcbench.run
from hmcbench import harness
harness.run_cell("gauss100_dense.tiny", 5, 0.2, False, torch.device("cpu"),
                 time.perf_counter(), {tiny_root!r})
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(harness.stray_modules())
"""
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded, stray = out.stdout.strip().splitlines()[-2:]
    assert "'dynamichmc_tpu_torch'" in loaded
    for name in ("'jax'", "'jaxlib'", "'flax'", "'dynamichmc_tpu'"):
        assert name not in loaded
    assert stray == "[]"


def test_stray_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dynamichmc_tpu_torch_x", sys)
    assert "dynamichmc_tpu" not in harness.stray_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert harness.stray_modules() == ["jaxlib"]


def test_the_reference_imports_nothing_of_the_port():
    names = sorted(f[:-3] for f in os.listdir(os.path.join(
        ROOT, "hmcbench", "reference")) if f.endswith(".py"))
    code = ("import sys\n" + "".join(
        f"import hmcbench.reference.{n}\n" for n in names if n != "__init__")
        + "print(sorted(m for m in sys.modules "
          "if m.split('.')[0].startswith('dynamichmc')))")
    out = _python(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    for name in names:
        with open(os.path.join(ROOT, "hmcbench", "reference",
                               name + ".py")) as f:
            assert "dynamichmc" not in f.read().replace(
                "DynamicHMC", "")


def test_run_exits_without_a_card_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "hmcbench/run.py", "--workload",
         "gauss100_dense.fleet16k", "--seed", str(2**31 + 9), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2
    assert out.stdout == ""


def test_run_fails_in_a_checkout_without_the_port(tmp_path):
    import shutil

    shutil.copytree(os.path.join(ROOT, "hmcbench"),
                    os.path.join(tmp_path, "hmcbench"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "hmcbench/run.py", "--workload",
         "logreg_1000x25.fleet16k", "--seed", "3", "--seconds", "1",
         "--trace", "0"], cwd=str(tmp_path), capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


# --- the check ----------------------------------------------------------


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_a_sound_run_is_correct_and_the_control_is_not(tiny_root, cell):
    c = harness.Cell(cell, "cpu", tiny_root)
    record, samples, _ = c.call(11, 0)
    assert not record.failed, record.failure
    correct, lines = c.check([samples], [record])
    assert correct, lines
    correct, lines = c.check([samples], [record], "control")
    assert not correct, lines
    result = run_tiny(tiny_root, cell, seed=2**31 + 77, seconds=0.3)
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "answer_altered", "metric_unchanged"])
@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    build = harness.Cell.__init__

    def init(self, *args, **kwargs):
        build(self, *args, **kwargs)
        faults.plant(self, fault, monkeypatch.setattr)

    monkeypatch.setattr(harness.Cell, "__init__", init)
    result = run_tiny(tiny_root, cell, seed=5, seconds=0.3)
    assert result["correct"] is False


def _iid_samples(mu, sigma, n, scale=1.0, m_inv=None, seed=0):
    """Samples of n independent draws from N(mu, scale^2 Sigma)."""
    g = torch.Generator().manual_seed(seed)
    chol = torch.linalg.cholesky(sigma)
    x = mu + scale * torch.randn(n, mu.shape[0], dtype=torch.float64,
                                 generator=g) @ chol.mT
    mean, cov = checks.draw_moments(x[None])
    m_inv = sigma if m_inv is None else m_inv
    return checks.Samples(draw_q=x[:4], draw_ld=None, state_q=None,
                          state_ld=None, state_grad=None, dense=True,
                          m_inv=m_inv, factor=None, draw_mean=mean,
                          draw_cov=cov, n_eff=float(n))


def test_the_moments_numbers_read_the_law_and_the_fold():
    K, n = 6, 200_000
    a = torch.randn(K, K, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    sigma = a @ a.mT / K + 0.2 * torch.eye(K, dtype=torch.float64)
    mu = torch.linspace(-1, 1, K, dtype=torch.float64)
    sound = checks.moment_numbers(_iid_samples(mu, sigma, n),
                                  (mu, sigma, float("inf")))
    assert sound["mean_z"] < 4.5 and sound["cov_z"] < 5
    assert sound["metric_fold"] == 0
    wide = checks.moment_numbers(_iid_samples(mu, sigma, n, scale=1.05),
                                 (mu, sigma, float("inf")))
    assert wide["cov_z"] > 20
    eye = torch.eye(K, dtype=torch.float64)
    unfolded = checks.moment_numbers(_iid_samples(mu, sigma, n, m_inv=eye),
                                     (mu, sigma, float("inf")))
    assert unfolded["metric_fold"] > 0.5
    diagonal = dataclasses.replace(_iid_samples(mu, sigma, n), dense=False,
                                   m_inv=torch.diagonal(sigma) * 1.1)
    assert checks.moment_numbers(diagonal, (mu, sigma, float("inf")))[
        "metric_fold"] == pytest.approx(0.1)


@pytest.mark.parametrize("cell", sorted(CELLS.values()))
def test_the_traced_run_fails_where_the_trace_holds_no_kernel(tiny_root,
                                                              cell):
    with pytest.raises(harness.TraceError):
        run_tiny(tiny_root, cell, traced=True)


# --- the traced call's readers -----------------------------------------


def _traced_run(root=ROOT):
    reg = registry.Registry(root)
    cfg = reg.config("gauss100_dense")
    work = reg.workload("gauss100_dense.fleet16k")
    k1 = ("void (anonymous namespace)::tree_transition_warp_kernel<false, 0,"
          " 4>(float const*)")
    device = [("elementwise(x)", 0.0, 0.1), (k1, 0.2, 0.5), (k1, 0.6, 0.9),
              ("Memcpy DtoH (Device -> Pageable)", 0.95, 1.0)]
    host = [("aten::item", 0.1, 0.2), ("cudaLaunchKernel", 0.15, 0.16),
            ("aten::mm", 0.5, 0.6)]
    trace = TraceRecord(device=device, host=host, window_s=1.0,
                        draws_start_s=0.45)
    call = CallRecord(wall_s=1.0, n_draws=1000, min_ess=1500.0,
                      draw_steps=15_000, launches={"tree_transition": 2},
                      warmup_s=0.6)
    return reg, RunRecord(cell=work, config=cfg,
                          reference=registry.reference(cfg["model"]),
                          setup_s=3.0, calls=[call], trace=trace)


def test_the_trace_arithmetic():
    _, run = _traced_run()
    trace = run.trace
    assert trace.busy_s == pytest.approx(0.75)
    assert len(trace.kernels("tree_transition_warp_kernel")) == 2
    assert len(trace.kernels("tree_transition_warp_kernel", after=0.45)) == 1
    parts = trace.breakdown()
    assert parts["device_ops"][0] == [
        "tree_transition_warp_kernel<false, 0, 4>", pytest.approx(0.6)]
    assert parts["idle_gaps"][0] == ["warmup: aten::item",
                                     pytest.approx(0.1)]
    labels = [g[0] for g in parts["idle_gaps"]]
    assert "draws: aten::mm" in labels


def test_the_per_layer_readers_on_a_traced_record():
    reg, run = _traced_run()
    read = {m["name"]: reg.reader(m["name"])(run)
            for m in reg.metrics("gauss100_dense.fleet16k", True)}
    leaf = 8 * 100**2 + 30 * 100
    bound_s = 15_000 * leaf / peaks.FP32_FLOP_PER_S
    assert read["k1_gauss_warp_roofline"] == pytest.approx(
        100 * bound_s / 0.3)
    assert read["draws_mfu"] == pytest.approx(
        100 * 15_000 * leaf / 0.4 / peaks.FP32_FLOP_PER_S)
    assert read["device_idle_share"] == pytest.approx(25.0)
    assert read["launches_per_transition"] == pytest.approx(1.5)
    assert read["warmup_share"] == pytest.approx(60.0)
    assert read["min_ess_per_draw"] == pytest.approx(1.5)
    assert read["grad_evals_per_draw"] == pytest.approx(15.0)
    assert reg.reader("k1_logreg_roofline")(run) is None


# --- on the card --------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_is_correct_on_the_card(cuda, cell):
    out = subprocess.run(
        [sys.executable, "hmcbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 101), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
