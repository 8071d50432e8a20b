"""The statistical protocol on the card, at float32, with the kernels on.

One test for each gate of tests/test_sample_correctness.py where a kernel
of the port takes the chains, at that gate's workload, thresholds, chain
and draw counts and warmup stages (tests/torch_correctness_utils.py):

- the bench configuration at bench dimension through K1, the tree kernel
  with the Gaussian leaf: its warp variant must take every transition;
- the specific normals and the extreme variances through K2, the fused
  Gaussian leaf, with the per-chain diagonal metric of the default warmup:
  it must take every leaf the plain driver executes.

They import torch and the port only:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu_correctness.py``.
Without a CUDA device they skip.
"""

import pytest
import torch

from torch_correctness_utils import (
    SPECIFIC_NORMALS,
    bench_dim_k1_gate,
    k1_warp_on_every_transition,
    k2_on_every_leaf,
    run_and_check,
    specific_normal_gate,
    transitions,
)
from dynamichmc_tpu_torch import default_warmup_stages
from dynamichmc_tpu_torch.models import extreme_variance_gaussian

F32 = torch.float32


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_bench_kernel_semantics_bench_dim():
    bench_dim_k1_gate(_device())


@pytest.mark.gpu
@pytest.mark.parametrize("workload", SPECIFIC_NORMALS, ids=lambda w: w[0])
def test_specific_normals(workload):
    label, mean, cov, seed = workload
    specific_normal_gate(label, mean, cov, seed, dtype=F32, device=_device(),
                         fused=True, launch_check=k2_on_every_leaf)


@pytest.mark.gpu
def test_extreme_variances():
    run_and_check(
        extreme_variance_gaussian(2, log10_range=8.0, device=_device(),
                                  fused=True),
        300,
        "extreme variances",
        warmup_stages=default_warmup_stages(metric_kind="diagonal"),
        dtype=F32,
        launch_check=k2_on_every_leaf,
    )


def test_launch_checks_refuse_a_missing_kernel():
    """The checks fail a run in which the kernel did not take the chains
    (runs on the CPU: no launch is counted there)."""
    zeros = {"tree_transition": 0, "tree_transition_warp": 0,
             "gaussian_fused_leaf": 0, "logreg_fused_leaf": 0,
             "gaussian_leapfrog": 0, "driver_fused_leaves": 12,
             "leapfrog_calls": 0}
    with pytest.raises(AssertionError):
        k2_on_every_leaf(zeros)
    with pytest.raises(AssertionError):
        k1_warp_on_every_transition(1156)(zeros)
    k2_on_every_leaf({**zeros, "gaussian_fused_leaf": 12})
    k1_warp_on_every_transition(1156)(
        {**zeros, "driver_fused_leaves": 0, "tree_transition": 1156,
         "tree_transition_warp": 1156})
    assert transitions(default_warmup_stages(metric_kind="dense", pooled=True),
                       256) == 1156


def test_protocol_passes_the_target_and_refuses_a_biased_one():
    """run_and_check on the CPU at a small size: a 2-d normal passes; the
    same run against an exact sampler shifted by half a standard deviation
    fails on Anderson-Darling; the launch check sees the run's counts."""
    import dataclasses

    import numpy as np

    from dynamichmc_tpu_torch.models import mvnormal

    model = mvnormal(np.zeros(2), np.diag([1.0, 4.0]), device="cpu")
    short = default_warmup_stages(init_steps=20, middle_steps=20,
                                  doubling_stages=2, terminating_steps=20)
    seen = []
    gate = run_and_check(model, 7, "2-d normal", n_samples=400,
                         warmup_stages=short, launch_check=seen.append)
    assert seen == [gate.launches] and gate.launches["tree_transition"] == 0
    assert gate.rhat_max < 1.02 and gate.ad_p_min is not None

    def shifted(generator, n):
        return model.sample(generator, n) + torch.tensor([0.5, 1.0],
                                                         dtype=torch.float64)

    biased = dataclasses.replace(model, sample_fn=shifted)
    with pytest.raises(AssertionError, match="AD p="):
        run_and_check(biased, 7, "2-d normal, shifted exact draws",
                      n_samples=400, warmup_stages=short)
