"""The port's entry point as the benchmark drives it: run_chains with the
configuration's sampler settings and the cell's chains, draws and route."""

from __future__ import annotations

import torch


def stages(config: dict, warmup: dict):
    from dynamichmc_tpu_torch.warmup import default_warmup_stages

    return default_warmup_stages(
        metric_kind=config["metric"], pooled=config["pooled_metric"],
        pooled_stepsize=config["pooled_stepsize"], **warmup)


def run_options(config: dict, cell: dict, warmup: dict) -> dict:
    """run_chains' keywords: the configuration's warmup (``warmup``: the
    stage lengths), max_depth, depth clamp and dtype, then the cell's own
    ``run_options`` over them."""
    from dynamichmc_tpu_torch.nuts import NUTS

    options = dict(
        tune="reference", warmup_stages=stages(config, warmup),
        algorithm=NUTS(max_depth=int(config["max_depth"])),
        dtype=getattr(torch, config["dtype"]),
        warmup_depth_clamp=config["warmup_depth_clamp"],
        warmup_depth_clamp_tail=config["warmup_depth_clamp_tail"])
    options.update(cell.get("run_options", {}))
    return options


def run_chains(generator, model, chains: int, draws: int, options: dict,
               checkpoint_sink):
    from dynamichmc_tpu_torch import run_chains as entry

    return entry(generator, model, chains, draws,
                 warmup_checkpoint_sink=checkpoint_sink, **options)


def reset_launch_counts() -> None:
    from dynamichmc_tpu_torch.ops import reset_launch_counts as reset

    reset()


def launch_counts() -> dict:
    from dynamichmc_tpu_torch.ops import launch_counts as counts

    return counts()
