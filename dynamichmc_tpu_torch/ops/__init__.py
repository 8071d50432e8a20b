"""Hand-written GPU kernels of the port (built at first use, never at
import), and the counts that show which of them a run went through."""


def reset_launch_counts() -> None:
    """Set every kernel's launch count, the tree kernel's declines, the
    drivers' counts of fused leaves and leapfrog calls, and the program's
    counters and span aggregates (profiling.py) to 0."""
    from .. import hamiltonian, profiling, tree_batched
    from . import gaussian_leaf, gaussian_leapfrog, logreg_leaf, tree_kernel

    profiling.reset_counts()
    tree_kernel.reset_launches()
    logreg_leaf.reset_launches()
    gaussian_leaf.reset_launches()
    gaussian_leapfrog.reset_launches()
    tree_batched.reset_fused_leaf_calls()
    hamiltonian.reset_leapfrog_calls()


def launch_counts() -> dict:
    """The counts since :func:`reset_launch_counts`: each kernel's
    launches (the tree kernel's warp variant apart), the tree kernel's
    hook's declines by reason (``tree_transition_declined``: ``dtype``,
    ``statistic``, ``per_chain_metric``, ``shape``; the plain driver ran
    those transitions), the leaves the plain driver handed to a fused
    leaf, the ``hamiltonian.leapfrog`` calls, and ``profiling.counts()``:
    the step loops' batch transitions (``transitions_warmup``,
    ``transitions_draws``), the host reads by site (``host_reads``) and,
    where a torch.profiler session was active, the span aggregates
    (``spans``) and the phases' leapfrog steps (``warmup_steps``,
    ``draw_steps``)."""
    from .. import hamiltonian, profiling, tree_batched
    from . import gaussian_leaf, gaussian_leapfrog, logreg_leaf, tree_kernel

    return {"tree_transition": tree_kernel.launches,
            "tree_transition_warp": tree_kernel.warp_launches,
            "logreg_fused_leaf": logreg_leaf.launches,
            "gaussian_fused_leaf": gaussian_leaf.launches,
            "gaussian_leapfrog": gaussian_leapfrog.launches,
            "driver_fused_leaves": tree_batched.fused_leaf_calls,
            "leapfrog_calls": hamiltonian.leapfrog_calls,
            "tree_transition_declined": dict(tree_kernel.declined),
            **profiling.counts()}
