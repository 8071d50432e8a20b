"""The port's logistic-regression posterior on the benchmark's data."""

import torch


def build(config: dict, data: dict, options: dict, device):
    from dynamichmc_tpu_torch.models import logistic_regression_from_data

    return logistic_regression_from_data(
        data["x"], data["y"], prior_scale=float(config["prior_scale"]),
        dtype=getattr(torch, config["dtype"]), device=device, **options)
