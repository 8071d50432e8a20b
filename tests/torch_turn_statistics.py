"""The generalized U-turn statistic reimplemented as a custom turn
statistic configuration (NUTS.jl:107-139), for the port's tests and
chip_smoke.py: a custom statistic sends every transition of the per-chain
API through the generic driver, and this one must reproduce the default
generic driver's transitions exactly."""

from dynamichmc_tpu_torch.hamiltonian import calculate_psharp
from dynamichmc_tpu_torch.nuts import (
    GeneralizedTurnStatistic,
    _combine_turn_statistics,
)


class GeneralizedReimpl:
    def leaf(self, metric, z):
        psharp = calculate_psharp(metric, z)
        return GeneralizedTurnStatistic(
            p_minus=z.p, psharp_minus=psharp, p_plus=z.p,
            psharp_plus=psharp, rho=z.p)

    def combine(self, metric, x, y):
        return _combine_turn_statistics(x, y)
