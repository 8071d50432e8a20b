"""Bytes of one launch of the port's whole-transition NUTS kernel, from the
shapes alone: every input and every output once (the frozen arithmetic of
the port's ``chip_smoke.tree_kernel_bound``).

Inputs: q, p, gradient (C x K each); log density and eps (C each); the
direction words (C); the Gumbel rows (2^max_depth - 1 per chain) and the
Exponential rows (max_depth per chain); M^-1; the leaf's own operands.
Outputs: the proposal's q and gradient (C x K each) and nine per-chain
scalars (log density, energy, depth, two termination ends, log-sum,
steps, directions, work). All four bytes wide.
"""


def launch_bytes(chains: int, dim: int, max_depth: int, metric_elements: int,
                 operand_elements: int) -> int:
    inputs = (3 * chains * dim + 3 * chains + ((1 << max_depth) - 1) * chains
              + max_depth * chains + metric_elements + operand_elements)
    outputs = 2 * chains * dim + 9 * chains
    return 4 * (inputs + outputs)
