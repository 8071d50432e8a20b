"""Hand-written GPU kernels of the port (built at first use, never at
import), and the counts that show which of them a run went through."""


def reset_launch_counts() -> None:
    """Set every kernel's launch count, and the drivers' counts of fused
    leaves and leapfrog calls, to 0."""
    from .. import hamiltonian, tree_batched
    from . import gaussian_leaf, gaussian_leapfrog, logreg_leaf, tree_kernel

    tree_kernel.reset_launches()
    logreg_leaf.reset_launches()
    gaussian_leaf.reset_launches()
    gaussian_leapfrog.reset_launches()
    tree_batched.reset_fused_leaf_calls()
    hamiltonian.reset_leapfrog_calls()


def launch_counts() -> dict:
    """The counts since :func:`reset_launch_counts`: each kernel's
    launches (the tree kernel's warp variant apart), the leaves the plain
    driver handed to a fused leaf, and the ``hamiltonian.leapfrog`` calls."""
    from .. import hamiltonian, tree_batched
    from . import gaussian_leaf, gaussian_leapfrog, logreg_leaf, tree_kernel

    return {"tree_transition": tree_kernel.launches,
            "tree_transition_warp": tree_kernel.warp_launches,
            "logreg_fused_leaf": logreg_leaf.launches,
            "gaussian_fused_leaf": gaussian_leaf.launches,
            "gaussian_leapfrog": gaussian_leapfrog.launches,
            "driver_fused_leaves": tree_batched.fused_leaf_calls,
            "leapfrog_calls": hamiltonian.leapfrog_calls}
