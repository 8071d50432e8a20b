"""PyTorch + CUDA port of the batched NUTS sampler ``dynamichmc_tpu``.

Imports torch, numpy and scipy only; never JAX or the JAX package. The hot
loops run in hand-written CUDA kernels (csrc/): one whole NUTS transition
per chain (tree_kernel.cu), the fused logreg leaf (logreg_leaf.cu) and the
fused Gaussian leaf and leapfrog (gaussian_leaf.cu). ``run_chains`` runs a
batch of chains (by default with the knobs left out chosen by
``autotune``, as in the JAX package), streaming its draws to ``io.MemmapDrawStore``, sampling
until an ESS target or resuming a checkpointed warmup (``checkpoint``) as
asked; ``mcmc_with_warmup`` and ``mcmc_keep_warmup`` run one chain, and
``mcmc_steps`` steps a chain or a batch one transition at a time.
``run_chains(..., mesh=chain_mesh())`` and ``run_chains_multihost`` run
the chains over a ``torch.distributed`` process group, one rank per
device.
``constraints`` maps constrained parameters to R^n.

float32 matrix products run in full fp32: TF32 is switched off here for
every matmul and convolution the port issues.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .diagnostics import (  # noqa: E402
    EBFMI,
    straggler_waste,
    summarize_tree_statistics,
)
from .engine import WarmupCheckpoint  # noqa: E402
from .errors import DynamicHMCError  # noqa: E402
from .hamiltonian import (  # noqa: E402
    EvaluatedPoint,
    PhasePoint,
    evaluate,
    evaluate_strict,
    leapfrog,
)
from .logdensity import LogDensity, from_logdensity_fn  # noqa: E402
from .mcmc import (  # noqa: E402
    InferenceResult,
    MCMCResult,
    StepwiseChunk,
    mcmc,
    mcmc_keep_warmup,
    mcmc_steps,
    mcmc_steps_from_state,
    mcmc_with_warmup,
    pool_posterior_matrices,
    stack_posterior_matrices,
)
from .metric import (  # noqa: E402
    DenseMetric,
    DiagonalMetric,
    dense_metric,
    diagonal_metric,
    identity_metric,
)
from .nuts import NUTS, TreeStatistics, sample_tree  # noqa: E402
from .parallel import (  # noqa: E402
    ChainMesh,
    chain_mesh,
    global_chain_mesh,
    run_chains,
    run_chains_multihost,
)
from .reporting import (  # noqa: E402
    LogProgressReport,
    NoProgressReport,
    TqdmProgressReport,
    default_reporter,
)
from .stats import ess_rhat  # noqa: E402
from .stepsize import (  # noqa: E402
    DualAveraging,
    FixedStepsize,
    InitialStepsizeSearch,
    PooledStepsize,
)
from .warmup import (  # noqa: E402
    TuningNUTS,
    WarmupState,
    default_warmup_stages,
    fixed_stepsize_warmup_stages,
    initialize_warmup_state,
)

__version__ = "0.1.0"

__all__ = [
    "ChainMesh", "DenseMetric", "DiagonalMetric", "DualAveraging",
    "DynamicHMCError", "EBFMI", "EvaluatedPoint", "FixedStepsize",
    "InferenceResult", "InitialStepsizeSearch", "LogDensity",
    "LogProgressReport", "MCMCResult", "NUTS", "NoProgressReport",
    "PhasePoint", "PooledStepsize", "StepwiseChunk", "TqdmProgressReport",
    "TreeStatistics", "TuningNUTS", "WarmupCheckpoint", "WarmupState",
    "__version__", "chain_mesh", "default_reporter", "default_warmup_stages",
    "dense_metric", "diagonal_metric", "ess_rhat", "evaluate",
    "evaluate_strict", "fixed_stepsize_warmup_stages", "from_logdensity_fn",
    "global_chain_mesh", "identity_metric", "initialize_warmup_state",
    "leapfrog", "mcmc", "mcmc_keep_warmup", "mcmc_steps",
    "mcmc_steps_from_state", "mcmc_with_warmup", "pool_posterior_matrices",
    "run_chains", "run_chains_multihost", "sample_tree",
    "stack_posterior_matrices", "straggler_waste",
    "summarize_tree_statistics",
]
