"""PyTorch + CUDA port of the batched NUTS sampler ``dynamichmc_tpu``.

Imports torch, numpy and scipy only; never JAX or the JAX package. The hot
loop of the main path, one whole NUTS transition per chain, is the
hand-written CUDA kernel in csrc/tree_kernel.cu (ops/tree_kernel.py).

float32 matrix products run in full fp32: TF32 is switched off here for
every matmul and convolution the port issues.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .errors import DynamicHMCError  # noqa: E402
from .hamiltonian import EvaluatedPoint, evaluate  # noqa: E402
from .logdensity import LogDensity, from_logdensity_fn  # noqa: E402
from .mcmc import MCMCResult  # noqa: E402
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
    "LogDensity", "MCMCResult", "NUTS", "TreeStatistics", "TuningNUTS",
    "default_warmup_stages", "dense_metric", "diagonal_metric", "evaluate",
    "from_logdensity_fn", "identity_metric", "run_chains",
]
