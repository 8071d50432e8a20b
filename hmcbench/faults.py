"""Faults planted under the timed path, in this process only, to show that
the check catches them (the tests on the CPU, ``calibrate.py --fault`` on
the card at a cell's own size). A benchmark run plants none.

- ``state_unchanged``: each transition returns its state unchanged;
- ``half_the_batch``: half of the chains keep their state;
- ``answer_altered``: each state's first coordinate moved by 0.01 where
  the tree kernel produces it, its log density and gradient left as they
  were; the next transition starts from the state as it was, so the
  chains run on and their draws are off by 0.01;
- ``metric_unchanged``: the stage fold leaves the metric as it starts,
  the identity, instead of the Welford estimate;
- ``momentum_scaled``: the momenta are drawn 1.5 times too wide while the
  kinetic energy keeps M^-1: draws of a consistent (q, log density,
  gradient) from the wrong law.
"""

from __future__ import annotations

import dataclasses

import torch

FAULTS = ("state_unchanged", "half_the_batch", "answer_altered",
          "metric_unchanged", "momentum_scaled")


def _broken_transition(hook, fault: str):
    def shifted(Q, sign):
        shift = torch.zeros_like(Q.q[0])
        shift[0] = 0.01
        return dataclasses.replace(Q, q=Q.q + sign * shift)

    def transition(generator, algorithm, metric, Q, eps, depth_limit=None):
        if fault == "answer_altered" and getattr(Q, "_altered", False):
            Q = shifted(Q, -1)
        if fault == "momentum_scaled":
            field = "w" if hasattr(metric, "w") else "w_diag"
            metric = dataclasses.replace(
                metric, **{field: getattr(metric, field) * 1.5})
        out = hook(generator, algorithm, metric, Q, eps, depth_limit)
        if out is None or fault == "momentum_scaled":
            return out
        Q2, stats = out
        if fault == "state_unchanged":
            return Q, stats
        if fault == "half_the_batch":
            half = Q.q.shape[0] // 2
            Q2.q[half:] = Q.q[half:]
            Q2.logdensity[half:] = Q.logdensity[half:]
            Q2.grad[half:] = Q.grad[half:]
            return Q2, stats
        Q2 = shifted(Q2, 1)
        Q2._altered = True
        return Q2, stats
    return transition


def _identity_metric(welford, kind: str, shrinkage: float):
    from dynamichmc_tpu_torch.metric import dense_metric, diagonal_metric

    if kind == "diagonal":
        return diagonal_metric(torch.ones_like(welford.mean))
    eye = torch.eye(welford.mean.shape[-1], dtype=welford.mean.dtype,
                    device=welford.mean.device)
    return dense_metric(eye.expand_as(welford.m2).clone())


def plant(cell, fault: str, setattr=setattr) -> None:
    """Plant ``fault`` in ``cell`` (a ``harness.Cell``) and the port's
    modules; ``setattr``: pytest's ``monkeypatch.setattr`` to undo it."""
    if fault == "metric_unchanged":
        from dynamichmc_tpu_torch import engine

        setattr(engine, "estimate_metric", _identity_metric)
    elif fault in FAULTS:
        setattr(cell, "model", dataclasses.replace(
            cell.model, tree_transition_fn=_broken_transition(
                cell.model.tree_transition_fn, fault)))
    else:
        raise ValueError(f"unknown fault {fault!r}")
