"""The port's dense Gaussian model on the benchmark's covariance."""

import torch


def build(config: dict, data: dict, options: dict, device):
    from dynamichmc_tpu_torch.models import mvnormal

    return mvnormal(data["mean"], data["cov"], dtype=getattr(torch, config["dtype"]),
                    device=device, **options)
