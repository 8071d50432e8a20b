"""The port's hierarchical logistic-regression posterior (Hoffman and
Gelman's HLR) on the benchmark's data."""

import torch


def build(config: dict, data: dict, options: dict, device):
    from dynamichmc_tpu_torch.models import (
        hierarchical_logistic_regression_from_data)

    return hierarchical_logistic_regression_from_data(
        data["x"], data["y"], rate=float(config["rate"]),
        dtype=getattr(torch, config["dtype"]), device=device, **options)
