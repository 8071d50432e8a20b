"""The tree kernel's CTA variant (logistic-regression leaf) over the
draws: percent of its roofline (hmcbench/rooflines.py)."""

from hmcbench.rooflines import kernel_roofline


def read(run):
    return kernel_roofline(run, "tree_transition_kernel")
