"""The tree kernel's warp variant (Gaussian leaf) over the draws: percent
of its roofline (hmcbench/rooflines.py)."""

from hmcbench.rooflines import kernel_roofline


def read(run):
    return kernel_roofline(run, "tree_transition_warp_kernel")
