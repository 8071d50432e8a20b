"""The hierarchical logistic regression's cell (Hoffman and Gelman's HLR,
``logreg_hier_1000x302.fused16k``) on the CPU: its CPU twin, built as
``conftest.make_tiny_root`` builds the others', is correct and the
control is not, each planted fault makes it incorrect, its three readers
work on synthetic and traced records, and its reference holds to its own
arithmetic. The fused leaf's plain version stands in for the kernel here;
the card's test is marked ``gpu``."""

import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import (ROOT, SHORT_WARMUP, _dump, _load, bench_entry,
                      make_tiny_root)

from hmcbench import driver_faults, harness, registry
from hmcbench.reference import hierarchical_logistic_regression as hlr
from hmcbench.reference import peaks
from hmcbench.trace import TraceRecord
from hmcbench.window import CallRecord, RunRecord

CELL = "logreg_hier_1000x302.fused16k"
TWIN = "logreg_hier_1000x302.tiny"
METRICS = ("k3_logreg_roofline", "driver_leaf_host_us", "lockstep_leaf_share")
# The twin's reference: 2048 annealed proposals (its moments' own error is
# then that of the Kish draws behind them, which the check takes in), and
# its limits on the moments: 16 chains x 16 draws after a 60-transition
# warmup are unconverged, so sound twins read mean_z 10.5-15.6 and
# metric_fold 19-48 (three seeds); the identity metric reads metric_fold
# about 250 (b's variance ~0.004). The cell's own limits are set on the
# card at its own size.
TWIN_REFERENCE_DRAWS = 2048
TWIN_LIMITS = {"mean_z": 50, "metric_fold": 80}


def make_hier_root(dest: str) -> str:
    """``make_tiny_root``'s checkout, with the HLR cell's twin beside it."""
    make_tiny_root(dest)
    bench_dir = os.path.join(dest, "hmcbench")
    bench = _load(os.path.join(dest, "BENCHMARK.json"))
    work = _load(os.path.join(bench_dir, "workloads", CELL + ".json"))
    config = _load(os.path.join(bench_dir, "configs",
                                work["config"] + ".json"))
    config.update(name=config["name"] + ".tiny", warmup=SHORT_WARMUP,
                  reference_draws=TWIN_REFERENCE_DRAWS)
    _dump(config, os.path.join(bench_dir, "configs",
                               config["name"] + ".json"))
    work.update(name=TWIN, config=config["name"], chains=16, draws=16,
                check_draws=64, limits=dict(work["limits"], **TWIN_LIMITS))
    _dump(work, os.path.join(bench_dir, "workloads", TWIN + ".json"))
    bench["workloads"].append(dict(bench_entry(bench, CELL), name=TWIN,
                                   config=config["name"]))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if CELL in metric.get("workloads", []):
            metric["workloads"].append(TWIN)
    _dump(bench, os.path.join(dest, "BENCHMARK.json"))
    return dest


@pytest.fixture(scope="module")
def hier_root(tmp_path_factory):
    return make_hier_root(str(tmp_path_factory.mktemp("hier_root")))


@pytest.fixture(autouse=True)
def one_reference(monkeypatch):
    """The reference's moments once per configuration in this process (the
    annealed importance sampler takes about a minute at K = 302 here)."""
    monkeypatch.setattr(hlr, "posterior_moments", _cached_moments)


_ORIGINAL = hlr.posterior_moments


@functools.lru_cache(maxsize=None)
def _moments(config_json: str, device: str):
    cfg = json.loads(config_json)
    target = hlr.make_target(hlr.make_data(cfg), device, cfg)
    return _ORIGINAL(target, cfg)


def _cached_moments(target, config):
    return _moments(json.dumps(config, sort_keys=True), str(target.x.device))


def run_tiny(root, cell, seed=7, seconds=0.3, traced=False):
    return harness.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                            time.perf_counter(), root)


# --- the twin's check ---------------------------------------------------


def test_a_sound_twin_is_correct_and_the_control_is_not(hier_root):
    c = harness.Cell(TWIN, "cpu", hier_root)
    record, samples, _ = c.call(11, 0)
    assert not record.failed, record.failure
    correct, lines = c.check([samples], [record])
    assert correct, lines
    correct, lines = c.check([samples], [record], "control")
    assert not correct, lines
    result = run_tiny(hier_root, TWIN, seed=2**31 + 77)
    assert result["correct"] and result["failed"] == 0, result["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "answer_altered", "metric_unchanged"])
def test_a_broken_timed_path_is_not_correct(hier_root, monkeypatch, fault):
    """faults.py's faults, those it plants in the tree kernel's hook
    planted in the plain driver's transition (driver_faults.py)."""
    build = harness.Cell.__init__

    def init(self, *args, **kwargs):
        build(self, *args, **kwargs)
        driver_faults.plant(self, fault, monkeypatch.setattr)

    monkeypatch.setattr(harness.Cell, "__init__", init)
    result = run_tiny(hier_root, TWIN, seed=5)
    assert result["correct"] is False


# --- the readers --------------------------------------------------------

SLICE = ("void (anonymous namespace)::logreg_leaf_slice_kernel<0, 2, 64>"
         "(float const*)")
FINISH = ("void (anonymous namespace)::logreg_leaf_finish_kernel<0, true>"
          "(float const*)")
COUNTERS = {"fused_leaf_rows": {"warmup": 16384 * 5000,
                                "draws": 16384 * 4000},
            "spans": {"dhmc.leaf": {
                "warmup": {"count": 5000, "ns": 5000 * 2_500_000},
                "draws": {"count": 4000, "ns": 4000 * 2_000_000}}}}


def _run(launches):
    reg = registry.Registry(ROOT)
    work = reg.workload(CELL)
    cfg = reg.config(work["config"])
    device = [(SLICE, 0.10, 0.11), (FINISH, 0.11, 0.112),  # warmup
              (SLICE, 1.30, 1.301), (FINISH, 1.301, 1.302),
              (SLICE, 1.40, 1.403), (FINISH, 1.403, 1.404)]
    trace = TraceRecord(device=device, host=[], window_s=2.0,
                        draws_start_s=1.2)
    call = CallRecord(wall_s=2.0, n_draws=16384 * 512,
                      min_ess=1e6, draw_steps=16384 * 3000,
                      launches=launches, warmup_s=1.2)
    return reg, RunRecord(cell=work, config=cfg,
                          reference=registry.reference(cfg["model"]),
                          setup_s=3.0, calls=[call], trace=trace)


def test_the_readers_arithmetic():
    reg, run = _run(dict(COUNTERS))
    read = {m: reg.reader(m)(run) for m in METRICS}
    leaf = 4 * 1000 * 301 + 10 * 1000 + 30 * 302 + 4 * 301 + 20
    flops = 16384 * 4000 * leaf
    n_bytes = 2 * 4 * (6 * 16384 * 302 + 3 * 16384 + 302 + 1000 * 304 + 1000)
    bound = max(flops / peaks.FP32_FLOP_PER_S, n_bytes / peaks.HBM_BYTES_PER_S)
    assert read["k3_logreg_roofline"] == pytest.approx(100 * bound / 0.006)
    assert read["driver_leaf_host_us"] == pytest.approx(2000.0)
    assert read["lockstep_leaf_share"] == pytest.approx(75.0)
    assert {m["name"] for m in reg.metrics(CELL, True)} == set(METRICS)
    for other in ("gauss100_dense.fleet16k", "logreg_1000x25.fleet16k"):
        assert not set(METRICS) & {m["name"] for m in
                                   reg.metrics(other, True)}


@pytest.mark.parametrize("absent", ["all", "untraced", "no_draws"])
@pytest.mark.parametrize("metric", METRICS)
def test_a_reader_returns_none_without_its_counters(metric, absent):
    """``all``: a port without the counters (the launch counts only);
    ``untraced``: no span aggregate and no rows, kept only under a
    profiler; ``no_draws``: counters of the warmup alone."""
    launches = {"logreg_fused_leaf": 9000}
    if absent == "no_draws":
        launches = {"fused_leaf_rows": {"warmup": 5},
                    "spans": {"dhmc.leaf": {"warmup": {"count": 1,
                                                       "ns": 10}}}}
    elif absent == "all":
        launches = {"tree_transition": 1412, "tree_transition_warp": 1412}
    reg, run = _run(launches)
    assert reg.reader(metric)(run) is None


def test_a_traced_cpu_call_reads_the_program_counters(hier_root):
    """One traced call of the twin: the plain version stands in for the
    kernel (no K3 launch, so no roofline); the span and rows are read."""
    c = harness.Cell(TWIN, "cpu", hier_root)
    record, _samples, trace = c.call(3, 0, traced=True)
    assert not record.failed, record.failure
    run = RunRecord(cell=c.workload, config=c.config, reference=c.reference,
                    setup_s=1.0, calls=[record], trace=trace)
    read = {m: c.reg.reader(m)(run) for m in METRICS}
    assert read["k3_logreg_roofline"] is None
    assert read["driver_leaf_host_us"] > 0
    assert 0 < read["lockstep_leaf_share"] <= 100
    counts = record.launches
    assert counts["logreg_fused_leaf_hier"] == 0
    assert counts["fused_leaf_rows"]["draws"] == 16 * counts["spans"][
        "dhmc.leaf"]["draws"]["count"]


# --- the reference ------------------------------------------------------

SMALL = {"n_obs": 200, "covariates": 3, "interactions": 3, "rate": 0.01,
         "data_seed": 0, "intercept": -0.8473, "coef_scale": 0.2,
         "interaction_scale": 0.05}


def test_the_data_follow_the_configuration():
    cfg = registry.Registry(ROOT).config("logreg_hier_1000x302")
    data = hlr.make_data(cfg)
    x, y = data["x"], data["y"]
    assert x.shape == (1000, 301) and y.shape == (1000,)
    assert (x[:, 0] == 1).all()
    np.testing.assert_allclose(x[:, 1:].mean(0), 0, atol=1e-12)
    np.testing.assert_allclose(x[:, 1:].std(0), 1, rtol=1e-12)
    # the covariates are logreg_1000x25's draw; the products follow them
    lr = registry.reference("logistic_regression").make_data(
        registry.Registry(ROOT).config("logreg_1000x25"))
    np.testing.assert_allclose(x[:, 1:25], lr["x"][:, 1:], rtol=1e-12)
    w = x[:, 1] * x[:, 2]
    np.testing.assert_allclose(x[:, 25], (w - w.mean()) / w.std(),
                               rtol=1e-10, atol=1e-12)
    w = x[:, 23] * x[:, 24]
    np.testing.assert_allclose(x[:, 300], (w - w.mean()) / w.std(),
                               rtol=1e-10, atol=1e-12)
    assert 0.2 < y.mean() < 0.5
    assert hlr.leaf_flops(cfg) == 4 * 1000 * 301 + 10 * 1000 + 30 * 302 + (
        4 * 301 + 20)
    assert hlr.launch_bytes(cfg, 1) - hlr.launch_bytes(
        dict(cfg, n_obs=0), 1) == 4 * 1000 * (304 + 1)


def test_the_reference_gradient_is_its_value_s_derivative():
    data = hlr.make_data(SMALL)
    target = hlr.make_target(data, "cpu", SMALL)
    q = 0.3 * torch.randn(4, 8, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(2))
    q[:, -1] = torch.tensor([-4.0, -1.0, 0.5, 2.0], dtype=torch.float64)
    ld, grad = target.ld_grad(q)
    auto = torch.func.grad(lambda v: target.ld_grad(v, grad=False)[0].sum())(q)
    torch.testing.assert_close(grad, auto, rtol=1e-10, atol=1e-10)
    # the non-centered density is the centered one with its Jacobian, and
    # its gradient in z the autograd one
    z, t = q[:, :7] * torch.exp(-0.5 * q[:, 7:]), q[:, 7]
    log_p, g_z = target.noncentered(z, t, grad=True)
    torch.testing.assert_close(log_p - log_p[0], (ld + 3.5 * t)
                               - (ld[0] + 3.5 * t[0]))
    auto = torch.func.grad(lambda v: target.noncentered(v, t)[0].sum())(z)
    torch.testing.assert_close(g_z, auto, rtol=1e-10, atol=1e-10)


def test_annealing_agrees_with_plain_importance_sampling():
    """At K = 8, plain importance sampling from the same proposal (one
    level, no annealing) has Kish draws to spare: the annealed moments
    agree with it within their joint standard errors, and annealing raises
    the Kish share."""
    target = hlr.make_target(hlr.make_data(SMALL), "cpu", SMALL)
    plain = hlr.importance_moments(target, 1 << 15,
                                   torch.Generator().manual_seed(1), temps=1)
    annealed = hlr.importance_moments(target, 1 << 12,
                                      torch.Generator().manual_seed(2),
                                      temps=16)
    (m1, c1, n1), (m2, c2, n2) = plain, annealed
    assert n1 > 0.2 * (1 << 15) and n2 > 0.5 * (1 << 12)
    se = torch.sqrt(torch.diagonal(c1) * (1 / n1 + 1 / n2))
    assert float(((m1 - m2).abs() / se).max()) < 5
    sd = torch.sqrt(torch.diagonal(c1))
    assert float(((c1 - c2).abs() / torch.outer(sd, sd)).max()) < 0.15


def test_kept_moments_read_back_and_answer_only_their_configuration(
        tmp_path):
    path = str(tmp_path / "moments.json")
    cfg = dict(SMALL, reference_draws=256)
    hlr.write_moments(cfg, "cpu", path)
    mean, cov, kish = hlr.frozen_moments(cfg, "cpu", path)
    target = hlr.make_target(hlr.make_data(cfg), "cpu", cfg)
    m, c, n = hlr.compute_moments(target, cfg)
    torch.testing.assert_close(mean, m, rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(cov, c, rtol=1e-9, atol=1e-12)
    assert kish == n
    for key, value in (("reference_draws", 512), ("data_seed", 1),
                       ("rate", 0.02)):
        assert hlr.frozen_moments(dict(cfg, **{key: value}), "cpu",
                                  path) is None
    assert hlr.frozen_moments(cfg, "cpu", str(tmp_path / "none.json")) is None


def test_the_cell_s_kept_moments_agree_with_a_fresh_reference():
    """The file the cell reads holds its configuration's moments: a fresh
    run of the same sampler at 2048 proposals (another sample of the
    same proposals' law) agrees with it, each mean within 6 joint
    standard errors (from both Kish counts) and each standard deviation
    within a factor 1.3."""
    cfg = registry.Registry(ROOT).config("logreg_hier_1000x302")
    kept = hlr.frozen_moments(cfg, "cpu")
    assert kept is not None, "the kept moments are not the cell's"
    mean, cov, kish = kept
    assert mean.shape == (302,) and cov.shape == (302, 302)
    assert kish > 0.1 * cfg["reference_draws"]
    assert bool((torch.linalg.eigvalsh(cov) > 0).all())
    fresh = dict(cfg, reference_draws=TWIN_REFERENCE_DRAWS)
    m, c, n = _moments(json.dumps(fresh, sort_keys=True), "cpu")
    sd = torch.sqrt(torch.diagonal(cov))
    z = (m - mean).abs() / (sd * math.sqrt(1 / n + 1 / kish))
    assert float(z.max()) < 6
    ratio = torch.sqrt(torch.diagonal(c)) / sd
    assert 1 / 1.3 < float(ratio.min()) and float(ratio.max()) < 1.3


# --- on the card --------------------------------------------------------


@pytest.mark.gpu
def test_the_cell_is_correct_on_the_card(cuda):
    out = subprocess.run(
        [sys.executable, "hmcbench/run.py", "--workload", CELL, "--seed",
         str(2**31 + 103), "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
