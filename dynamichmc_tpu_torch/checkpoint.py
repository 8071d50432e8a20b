"""Checkpoint and resume of sampler state (port of
``dynamichmc_tpu.checkpoint``).

All sampler state is the (Q, metric, eps) triple plus the random stream
(SURVEY.md section 5); here the stream is a ``torch.Generator``'s state.
Any of the port's state objects (``WarmupState``, ``engine.WarmupCheckpoint``,
``EvaluatedPoint``, ``PhasePoint``, both metrics, ``TreeStatistics``,
``WelfordState``), and dicts, tuples or lists of them, round-trip through
one file that ``torch.load(..., weights_only=True)`` reads: each object is
saved as a plain dict of its fields under its class name, so loading runs
no pickled code. Every tensor keeps its dtype: a float64 checkpoint loads
as float64.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional, Tuple

import torch

from .engine import WarmupCheckpoint
from .hamiltonian import EvaluatedPoint, PhasePoint
from .metric import DenseMetric, DiagonalMetric
from .nuts import TreeStatistics
from .utils.welford import WelfordState
from .warmup import WarmupState

_FILE = "state.pt"
_TYPE = "__dynamichmc_tpu_torch_type__"
_CLASSES = {cls.__name__: cls for cls in (
    WarmupState, WarmupCheckpoint, EvaluatedPoint, PhasePoint, DiagonalMetric,
    DenseMetric, TreeStatistics, WelfordState)}


def _encode(x):
    if type(x) in _CLASSES.values():
        return {_TYPE: type(x).__name__,
                "fields": {f.name: _encode(getattr(x, f.name))
                           for f in dataclasses.fields(x)}}
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, dict):
        if _TYPE in x:
            raise ValueError(
                f"save_state: a dict may not hold the key {_TYPE!r}")
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_encode(v) for v in x)
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"save_state: cannot save a {type(x).__name__}")


def _decode(x):
    if isinstance(x, dict) and _TYPE in x:
        cls = _CLASSES[x[_TYPE]]
        fields = {k: _decode(v) for k, v in x["fields"].items()}
        if fields.get("generator_state") is not None:
            # Generator.set_state takes a CPU byte tensor
            fields["generator_state"] = fields["generator_state"].cpu()
        return cls(**fields)
    if isinstance(x, dict):
        return {k: _decode(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_decode(v) for v in x)
    return x


def save_state(path: str, state: Any,
               generator: Optional[torch.Generator] = None) -> None:
    """Persist ``state`` and, when given, ``generator.get_state()`` into
    the directory ``path``."""
    os.makedirs(path, exist_ok=True)
    torch.save({"state": _encode(state),
                "generator_state": (None if generator is None
                                    else generator.get_state())},
               os.path.join(path, _FILE))


def load_state(path: str, device=None) -> Tuple[Any, Optional[torch.Tensor]]:
    """Restore ``(state, generator_state)`` saved by :func:`save_state`,
    its tensors on ``device`` (default: where they were saved) with their
    dtypes; ``generator_state`` (None if none was saved) is the CPU byte
    tensor ``torch.Generator.set_state`` takes."""
    payload = torch.load(os.path.join(path, _FILE), map_location=device,
                         weights_only=True)
    generator_state = payload["generator_state"]
    if generator_state is not None:
        generator_state = generator_state.cpu()
    return _decode(payload["state"]), generator_state
