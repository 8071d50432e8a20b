"""GPU-only checks of the port's hand-written kernels.

They import torch and the port only, so they also run where JAX is absent:
``python -m pytest --noconftest -m gpu tests/test_torch_gpu.py``. Without a
CUDA device they skip (the kernels have no CPU mode; on the CPU the wrappers
take their plain versions, which the other test_torch_* files check against
the JAX package).
"""

import pytest
import torch

from dynamichmc_tpu_torch.metric import dense_metric, diagonal_metric
from dynamichmc_tpu_torch.models import correlated_gaussian
from dynamichmc_tpu_torch.ops import tree_kernel
from dynamichmc_tpu_torch.tree_batched import (
    exponential_like,
    gumbel_like,
    rand_p_b,
    random_directions,
)

F32 = torch.float32


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_args(dev, K, C, md, kind, dcap, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = correlated_gaussian(K, dtype=F32, device=dev, tree_kernel=True)
    prec_t, lchol, mu = model.tree_transition_fn.operands
    q = model.sample(gen, C)
    v, g = model.logdensity_and_gradient(q)
    minv = model.cov_fn().to(F32)
    if kind == "diag":
        minv = torch.diagonal(minv).contiguous()
    metric = diagonal_metric(minv) if kind == "diag" else dense_metric(minv)
    eps = torch.empty(C, device=dev).uniform_(0.2, 0.6, generator=gen)
    return (
        q, rand_p_b(gen, metric, (C, K), F32).contiguous(), g, v, eps,
        random_directions(gen, C, dev),
        gumbel_like(gen, ((1 << md) - 1, C), F32, dev),
        exponential_like(gen, (md, C), F32, dev), minv.contiguous(),
        prec_t, lchol, mu, dcap, -1000.0, md,
    )


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dcap,K", [
    ("dense", 4, 5), ("diag", 4, 5), ("dense", 2, 5), ("dense", 4, 100),
    ("dense", 6, 33),
])
def test_cuda_kernel_matches_plain(kind, dcap, K):
    """The CUDA kernel against its plain version on the same injected noise.

    Discrete statistics must agree on >= 99% of chains (a dot product that
    sits at 0 can flip a U-turn or Gumbel decision under another summation
    order). On those chains ld' agrees to 1e-4 (1 + |x|). q', grad' and
    log_sum carry the target's float32 conditioning (the plain float32
    transition itself lies up to ~3e-4 (1 + |q|) from the float64 one at
    K = 100, and log_sum inherits the absolute rounding of pi ~ 1e2), so
    they must be as close to the float64 plain transition as the float32
    plain version is: within twice its error, plus 1e-5 (float32 rounding
    of values ~10 over a 15-step trajectory)."""
    dev = _device()
    C, md = 256, max(dcap, 4)
    args = _kernel_args(dev, K, C, md, kind, dcap)
    tree_kernel.reset_launches()
    out = tree_kernel.tree_transition(*args)
    torch.cuda.synchronize()
    assert tree_kernel.launches == 1
    ref = tree_kernel.tree_transition_plain(*args)
    ref64 = tree_kernel.tree_transition_plain(*(
        a.double() if torch.is_tensor(a) and a.is_floating_point() else a
        for a in args
    ))
    same = torch.ones(C, dtype=torch.bool, device=dev)
    for name in ("depth", "steps", "term_left", "term_right"):
        same &= (out[name] == ref[name]) & (ref64[name] == ref[name])
    assert same.float().mean() >= 0.99

    def rel(x, y):
        x, y = x[same].double(), y[same].double()
        return torch.where(x == y, 0.0, (x - y).abs() / (1 + y.abs()))

    assert float(rel(out["prop_ld"], ref["prop_ld"]).max()) <= 1e-4
    for name in ("prop_q", "prop_grad", "log_sum"):
        err_kernel = float(rel(out[name], ref64[name]).max())
        err_plain = float(rel(ref[name], ref64[name]).max())
        assert err_kernel <= 2 * err_plain + 1e-5, (name, err_kernel, err_plain)
    assert int(out["depth"].max()) <= dcap
    assert torch.equal(out["work"], out["steps"])  # the chain's own leaves
