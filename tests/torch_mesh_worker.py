"""Ranks of a gloo process group on the CPU for the port's mesh tests.

    python tests/torch_mesh_worker.py CASE RANK WORLD INIT_METHOD OUTDIR

runs one rank of ``CASE`` (a function below) on a ``torch.distributed``
gloo group joined through ``INIT_METHOD`` (a ``file://`` store, so that
concurrent test processes share no TCP port), and saves what it returns to
``OUTDIR/CASE_rank{RANK}.pt``. It imports torch and dynamichmc_tpu_torch
only: never JAX, and never tests/conftest.py. :func:`spawn` starts the
ranks from a test and kills them all when its timeout passes, so that a
rank left waiting in a collective cannot hang the suite; every collective
has its own timeout too (``COLLECTIVE_SECONDS``).
"""

import datetime
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_SECONDS = 150  # the whole of one spawn, every rank
COLLECTIVE_SECONDS = 90  # one collective


def spawn(case, world, outdir, timeout=SPAWN_SECONDS):
    """Run ``case`` on ``world`` ranks; returns each rank's saved result.
    Fails with every rank's log tail if a rank exits non-zero or the
    timeout passes (the ranks are killed)."""
    import pytest
    import torch

    outdir = str(outdir)
    store = os.path.join(outdir, f"{case}_store")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        env.pop(name, None)
    logs = [os.path.join(outdir, f"{case}_rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r in range(world):
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), case, str(r),
                     str(world), f"file://{store}", outdir],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        hung = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()

    def tails():
        out = []
        for r, path in enumerate(logs):
            with open(path) as f:
                out.append(f"--- rank {r}:\n{f.read()[-3000:]}")
        return "\n".join(out)

    if hung:
        pytest.fail(f"{case}: ranks {hung} still running after {timeout} s "
                    f"(killed)\n{tails()}")
    codes = [p.returncode for p in procs]
    if any(codes):
        pytest.fail(f"{case}: exit codes {codes}\n{tails()}")
    return [torch.load(os.path.join(outdir, f"{case}_rank{r}.pt"))
            for r in range(world)]


# --- inputs shared with the tests ------------------------------------------

COLLECTIVE_SEED = 20261017
K_POOL, C_POOL, N_POOL, T_EPS = 5, 3, 7, 9


def collective_inputs(world):
    """Every rank's draws (world, N, C, K), with offsets and correlation
    so that no moment sits near 0, and its search eps (world, C) and
    acceptance signals (world, T, C), from one numpy seed."""
    import numpy as np

    rng = np.random.default_rng(COLLECTIVE_SEED + world)
    L = np.tril(rng.normal(size=(K_POOL, K_POOL))) + 2 * np.eye(K_POOL)
    offsets = np.array([1.0, -2.0, 3.0, 0.5, 5.0])
    x = offsets + rng.normal(size=(world, N_POOL, C_POOL, K_POOL)) @ L.T
    eps = np.exp(rng.normal(size=(world, C_POOL)))
    acc = rng.uniform(size=(world, T_EPS, C_POOL))
    return x, eps, acc


def short_stages(metric_kind="diagonal", pooled=False, pooled_stepsize=False):
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    return default_warmup_stages(
        metric_kind=metric_kind, init_steps=20, middle_steps=20,
        doubling_stages=2, terminating_steps=20, pooled=pooled,
        pooled_stepsize=pooled_stepsize)


def _result(res):
    """An MCMCResult as plain tensors."""
    stats = res.tree_statistics
    return {"positions": res.positions, "logdensities": res.logdensities,
            "eps": res.eps, "m_inv": res.metric.m_inv,
            "depth": stats.depth, "steps": stats.steps,
            "acceptance_rate": stats.acceptance_rate}


def _error(fn):
    """Run ``fn``; its DynamicHMCError or ValueError as plain values (None
    if it raised none)."""
    from dynamichmc_tpu_torch import DynamicHMCError

    try:
        fn()
    except DynamicHMCError as err:
        return {"type": "DynamicHMCError", "message": err.message,
                "payload": {k: (v.tolist() if hasattr(v, "tolist") else v)
                            for k, v in err.payload.items()}}
    except ValueError as err:
        return {"type": "ValueError", "message": str(err)}
    return None


# --- cases: each runs on every rank and returns what the test reads --------


def case_collectives(mesh):
    """The helpers, the pooled Welford state (diagonal and dense) and the
    pooled stepsize on this rank's share of collective_inputs."""
    import torch

    from dynamichmc_tpu_torch.metric import diagonal_metric
    from dynamichmc_tpu_torch.parallel.chains import _shared
    from dynamichmc_tpu_torch.parallel.mesh import (
        all_gather_chains, all_mean, all_sum, broadcast_from)
    from dynamichmc_tpu_torch.stepsize import PooledStepsize
    from dynamichmc_tpu_torch.utils.welford import (
        pool_welford_over_group, welford_update_pooled_b, welford_zero_shared)

    x, eps, acc = collective_inputs(mesh.size)
    out = {}
    for kind in ("diagonal", "dense"):
        w = welford_zero_shared(K_POOL, kind == "dense", torch.float64)
        for t in range(N_POOL):
            w = welford_update_pooled_b(w, torch.from_numpy(x[mesh.rank, t]))
        pooled = pool_welford_over_group(w, mesh)
        out[kind] = {"local": (w.count, w.mean, w.m2),
                     "pooled": (pooled.count, pooled.mean, pooled.m2)}
    adaptation = PooledStepsize(mesh=mesh)
    state = adaptation.init(torch.from_numpy(eps[mesh.rank]))
    states = [vars(state)]
    for t in range(T_EPS):
        state = adaptation.update(state, torch.from_numpy(acc[mesh.rank, t]))
        states.append(vars(state))
    out["eps_states"] = states
    out["eps_final"] = adaptation.final(state)
    rows = torch.arange(6, dtype=torch.float64).reshape(3, 2) + 10 * mesh.rank
    out["gathered"] = all_gather_chains(rows, mesh)
    out["gathered_bool"] = all_gather_chains(
        torch.tensor([mesh.rank % 2 == 0, True]), mesh)
    out["broadcast"] = broadcast_from(
        torch.tensor([mesh.rank + 1.0]), mesh, rank=mesh.size - 1)
    # a per-chain initial metric under pooling: global chain 0's
    per_chain = diagonal_metric(torch.arange(6, dtype=torch.float64)
                                .reshape(3, 2) + 1 + 10 * mesh.rank)
    out["shared_metric"] = _shared(per_chain, mesh).m_inv
    out["sum"] = all_sum(torch.tensor(mesh.rank + 1.0), mesh)
    out["mean"] = all_mean(torch.tensor(mesh.rank + 1.0), mesh)
    return out


SIZE1_CONFIGS = {  # name -> short_stages' arguments
    "pooled_dense": ("dense", True, True),
    "per_chain_diagonal": ("diagonal", False, False),
}


def case_size1(mesh):
    """run_chains over a mesh of one rank and without one, same seed."""
    import torch

    from dynamichmc_tpu_torch import run_chains
    from dynamichmc_tpu_torch.models import std_normal

    ld = std_normal(3, dtype=torch.float64, device="cpu")
    out = {}
    for name, args in SIZE1_CONFIGS.items():
        runs = {}
        for label, m in (("mesh", mesh), ("plain", None)):
            runs[label] = _result(run_chains(
                torch.Generator().manual_seed(5), ld, 8, 50, mesh=m,
                warmup_stages=short_stages(*args), tune="reference",
                dtype=torch.float64))
        out[name] = runs
    return out


def case_parallel(mesh):
    """The mesh cases of the JAX package's tests/test_parallel.py, each
    rank on its own seed."""
    import numpy as np
    import torch

    from dynamichmc_tpu_torch import default_warmup_stages, run_chains
    from dynamichmc_tpu_torch.models import mvnormal, std_normal

    def gen(seed):
        return torch.Generator().manual_seed(100 * seed + mesh.rank)

    target = mvnormal(np.zeros(3), np.diag([0.5, 1.0, 2.0]),
                      dtype=torch.float64, device="cpu")
    out = {}
    out["sharded"] = _result(run_chains(
        gen(1), std_normal(3, dtype=torch.float64, device="cpu"), 8, 400,
        dtype=torch.float64, mesh=mesh))
    out["pooled_metric"] = _result(run_chains(
        gen(2), target, 8, 100, dtype=torch.float64, mesh=mesh,
        warmup_stages=default_warmup_stages(pooled=True)))
    out["pooled_stepsize"] = _result(run_chains(
        gen(7), target, 16, 100, dtype=torch.float64, mesh=mesh,
        warmup_stages=default_warmup_stages(pooled=True,
                                            pooled_stepsize=True)))
    out["divisibility"] = _error(lambda: run_chains(
        gen(0), std_normal(2, dtype=torch.float64, device="cpu"), 9, 30,
        mesh=mesh))
    return out


def case_errors(mesh):
    """Checks that fail on one rank only, each raising on every rank."""
    import torch

    from dynamichmc_tpu_torch import (
        NUTS, InitialStepsizeSearch, TuningNUTS, from_logdensity_fn,
        run_chains)
    from dynamichmc_tpu_torch.models import std_normal

    ld = std_normal(2, dtype=torch.float64, device="cpu")
    kw = dict(dtype=torch.float64, mesh=mesh, tune="reference")
    out = {}
    # generators seeded alike on every rank
    out["seeded_alike"] = _error(lambda: run_chains(
        torch.Generator().manual_seed(3), ld, 8, 10, **kw))
    # a non-finite initial point on rank 1 only (its chain 2)
    q = torch.zeros((4, 2), dtype=torch.float64)
    if mesh.rank == 1:
        q[2, 0] = float("nan")
    out["initial_point"] = _error(lambda: run_chains(
        torch.Generator().manual_seed(mesh.rank), ld, 8, 10,
        initialization={"q": q}, **kw))
    # a failed stepsize search on rank 1 only: its chain 1 starts on the
    # flat shelf of a clamped normal, where the one-step acceptance ratio
    # is 1 at every stepsize and no crossing comes within 50 doublings
    shelf = from_logdensity_fn(
        2, lambda q: -0.5 * (q.clamp(-10.0, 10.0) ** 2).sum(-1))
    q = 0.5 * torch.ones((4, 2), dtype=torch.float64)
    if mesh.rank == 1:
        q[1] = 20.0
    stages = (InitialStepsizeSearch(maxiter_crossing=50), TuningNUTS(20))
    out["stepsize_search"] = _error(lambda: run_chains(
        torch.Generator().manual_seed(mesh.rank), shelf, 8, 10,
        initialization={"q": q}, warmup_stages=stages,
        algorithm=NUTS(max_depth=2), **kw))
    return out


def case_dryrun(mesh):
    """Passes 1-8 of the JAX package's dryrun_multichip (its mesh path),
    float32, 4 chains a rank: 4-6 are the schedulers (stratification with
    a warmup clamp, the wavefront with a pooled stepsize, epoch
    sampling)."""
    import torch

    from dynamichmc_tpu_torch import (
        DualAveraging, InitialStepsizeSearch, TuningNUTS,
        default_warmup_stages, run_chains)
    from dynamichmc_tpu_torch.models import std_normal

    ld = std_normal(4, dtype=torch.float32, device="cpu")
    n = 4 * mesh.size

    def run(seed, stages, n_samples=8, **kw):
        return run_chains(torch.Generator().manual_seed(10 * seed + mesh.rank),
                          ld, n, n_samples, warmup_stages=stages,
                          dtype=torch.float32, mesh=mesh, **kw)

    def stages(pooled_stepsize=False):
        return default_warmup_stages(
            metric_kind="dense", init_steps=20, middle_steps=20,
            doubling_stages=1, terminating_steps=20, pooled=True,
            pooled_stepsize=pooled_stepsize)

    out = {}
    out["pass1"] = _result(run(0, (
        InitialStepsizeSearch(),
        TuningNUTS(N=20, metric_kind="diagonal", pooled=True),
        TuningNUTS(N=20, metric_kind="dense", pooled=True),
        TuningNUTS(N=20, stepsize_adaptation=DualAveraging()))))
    out["pass2"] = _result(run(1, stages()))
    out["pass3"] = _result(run(2, stages(pooled_stepsize=True)))
    out["pass4"] = _result(run(3, stages(), stratify_sampling=mesh.size,
                               warmup_depth_clamp=3))
    out["pass5"] = _result(run(4, stages(pooled_stepsize=True),
                               warmup_driver="wavefront"))
    out["pass6"] = _result(run(5, stages(), sampling_driver="epoch"))
    checkpoints = []
    out["pass7_ref"] = _result(run(6, stages(),
                                   warmup_checkpoint_sink=checkpoints.append))
    out["pass7_steps"] = [c.step for c in checkpoints]
    mid = next(c for c in checkpoints if 0 < c.step < 60)
    out["pass7_resumed"] = _result(run(6, stages(), warmup_resume=mid))
    out["pass8"] = _result(run(7, stages(), n_samples=64, sample_chunk=16,
                               ess_target=10.0, ess_check_start=16,
                               ess_check_factor=1.0))
    # ranks resuming from different stages raise on every rank
    out["resume_mismatch"] = _error(lambda: run(
        6, stages(), warmup_resume=checkpoints[1 + mesh.rank]))
    return out


def stratified_target(dim=5, seed=0):
    """JAX tests/test_stratified.py's target covariance."""
    import numpy as np

    a = np.random.default_rng(seed).normal(size=(dim, dim))
    return a @ a.T + 0.5 * np.eye(dim)


def case_stratified(mesh):
    """JAX tests/test_stratified.py's mesh case (32 chains over the ranks,
    200 draws, stratify_sampling=8, the half schedule) beside the same run
    unstratified; then chains a unit apart at a tiny per-chain eps, falling
    over the global chains, so that the sort sends every rank's chains to
    the other rank's band: how far each chain's last draw lies from its
    start."""
    import numpy as np
    import torch

    from dynamichmc_tpu_torch import NUTS, FixedStepsize, TuningNUTS, run_chains
    from dynamichmc_tpu_torch.models import mvnormal
    from dynamichmc_tpu_torch.parallel.mesh import all_gather_chains
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    ld = mvnormal(np.zeros(5), stratified_target(), dtype=torch.float64,
                  device="cpu")
    kw = dict(dtype=torch.float64, mesh=mesh, tune="reference",
              warmup_stages=default_warmup_stages(
                  metric_kind="dense", init_steps=40, middle_steps=20,
                  doubling_stages=3, terminating_steps=25))

    def gen(seed):
        return torch.Generator().manual_seed(100 * seed + mesh.rank)

    out = {"stratified": _result(run_chains(gen(3), ld, 32, 200,
                                            stratify_sampling=8, **kw)),
           "plain": _result(run_chains(gen(3), ld, 32, 8, **kw))}
    n = 8
    first = mesh.rank * n
    q0 = (torch.arange(first, first + n, dtype=torch.float64)[:, None]
          * torch.ones(5, dtype=torch.float64))
    eps = torch.linspace(2e-3, 1e-3, n * mesh.size,
                         dtype=torch.float64)[first:first + n]
    kw.update(warmup_stages=(TuningNUTS(
        N=20, stepsize_adaptation=FixedStepsize()),),
        algorithm=NUTS(max_depth=2))
    res = run_chains(gen(4), ld, n * mesh.size, 4, stratify_sampling=2,
                     initialization={"q": q0, "eps": eps}, **kw)
    band = torch.argsort(all_gather_chains(eps, mesh))[first:first + n]
    out["still"] = {
        "max_move": float((res.positions[:, -1] - q0).abs().max()),
        "band_moved": bool((band // n != mesh.rank).all())}
    return out


def case_multihost(mesh):
    """The JAX package's tests/test_multihost.py on this group: the mesh
    spans the world, initialize() is a no-op once initialized, and
    run_chains_multihost from one seed on every rank."""
    import torch
    import torch.distributed as dist

    from dynamichmc_tpu_torch import InitialStepsizeSearch, TuningNUTS
    from dynamichmc_tpu_torch.models import std_normal
    from dynamichmc_tpu_torch.parallel import (
        global_chain_mesh, initialize, run_chains_multihost)
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    initialize()  # already initialized: a no-op
    world = global_chain_mesh("cpu")
    out = {"size": world.size, "rank": world.rank,
           "world_size": dist.get_world_size()}
    out["two_process"] = _result(run_chains_multihost(
        torch.Generator().manual_seed(0), std_normal(2, dtype=torch.float64,
                                                     device="cpu"),
        n_chains_per_device=2, n_samples=50, device="cpu",
        warmup_stages=(InitialStepsizeSearch(),
                       TuningNUTS(N=40, metric_kind="diagonal", pooled=True)),
        dtype=torch.float64))
    out["pooled"] = _result(run_chains_multihost(
        torch.Generator().manual_seed(0), std_normal(3, dtype=torch.float64,
                                                     device="cpu"),
        n_chains_per_device=8, n_samples=200, device="cpu",
        dtype=torch.float64, warmup_stages=default_warmup_stages(pooled=True)))
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main(argv):
    case, rank, world, init_method, outdir = (
        argv[1], int(argv[2]), int(argv[3]), argv[4], argv[5])
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import dynamichmc_tpu_torch  # noqa: F401  (the port's settings first)
    from dynamichmc_tpu_torch.parallel import chain_mesh, initialize

    initialize(init_method, world, rank, backend="gloo",
               timeout=datetime.timedelta(seconds=COLLECTIVE_SECONDS))
    try:
        out = CASES[case](chain_mesh(device="cpu"))
        torch.save(out, os.path.join(outdir, f"{case}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
