"""PyTorch + CUDA port of the batched NUTS sampler ``dynamichmc_tpu``.

Imports torch, numpy and scipy only; never JAX or the JAX package. The hot
loops run in hand-written CUDA kernels (csrc/): one whole NUTS transition
per chain (tree_kernel.cu), the fused logreg leaf (logreg_leaf.cu) and the
fused Gaussian leaf and leapfrog (gaussian_leaf.cu). ``run_chains`` runs a
batch of chains; ``mcmc_with_warmup`` runs one.

float32 matrix products run in full fp32: TF32 is switched off here for
every matmul and convolution the port issues.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .errors import DynamicHMCError  # noqa: E402
from .hamiltonian import (  # noqa: E402
    EvaluatedPoint,
    PhasePoint,
    evaluate,
    evaluate_strict,
    leapfrog,
)
from .logdensity import LogDensity, from_logdensity_fn  # noqa: E402
from .mcmc import MCMCResult, mcmc_with_warmup  # noqa: E402
from .metric import (  # noqa: E402
    DenseMetric,
    DiagonalMetric,
    dense_metric,
    diagonal_metric,
    identity_metric,
)
from .nuts import NUTS, TreeStatistics  # noqa: E402
from .parallel import run_chains  # noqa: E402
from .warmup import TuningNUTS, default_warmup_stages  # noqa: E402

__all__ = [
    "DenseMetric", "DiagonalMetric", "DynamicHMCError", "EvaluatedPoint",
    "LogDensity", "MCMCResult", "NUTS", "PhasePoint", "TreeStatistics",
    "TuningNUTS", "default_warmup_stages", "dense_metric", "diagonal_metric",
    "evaluate", "evaluate_strict", "from_logdensity_fn", "identity_metric",
    "leapfrog", "mcmc_with_warmup", "run_chains",
]
