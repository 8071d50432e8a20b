#!/usr/bin/env python3
"""The faults of ``faults.py`` for cells whose model has no
``tree_transition_fn`` (the fused leaf's cells, where the plain driver
runs every transition): those that ``faults.py`` plants in the tree
kernel's hook are planted here in the plain driver's transition, as the
engine calls it (``engine.sample_tree_batched``), with the same effect:

- ``state_unchanged``, ``half_the_batch``: all, or half, of the chains
  keep their state;
- ``answer_altered``: each transition's state moved by 0.01 in its first
  coordinate, its log density and gradient left as they were; the next
  transition starts from the state as it was;
- ``momentum_scaled``: the momenta drawn 1.5 times too wide while the
  kinetic energy keeps M^-1.

``metric_unchanged`` lies outside any transition and is planted by
``faults.plant`` as it stands. A benchmark run plants none. On the card::

    python3 hmcbench/driver_faults.py --workload <cell> --seeds 1,2
        --fault <name> [--control 0]

runs ``calibrate.py``'s readings with the fault planted: one JSON line a
seed with its verdict, then the summary.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from hmcbench import faults  # noqa: E402


def _broken(original, fault: str):
    """``original`` (the plain driver's batch transition) with ``fault``:
    faults.py's broken tree-kernel hook around it."""

    def transition(generator, algorithm, ld, metric, Q, eps,
                   depth_limit=None):
        def hook(gen, alg, met, state, step, limit):
            return original(gen, alg, ld, met, state, step,
                            depth_limit=limit)

        return faults._broken_transition(hook, fault)(
            generator, algorithm, metric, Q, eps, depth_limit)

    return transition


def plant(cell, fault: str, setattr=setattr) -> None:
    """Plant ``fault`` in ``cell`` (a ``harness.Cell``) and the port's
    modules; ``setattr``: pytest's ``monkeypatch.setattr`` to undo it."""
    if fault == "metric_unchanged":
        faults.plant(cell, fault, setattr)
    elif fault in faults.FAULTS:
        from dynamichmc_tpu_torch import engine

        setattr(engine, "sample_tree_batched",
                _broken(engine.sample_tree_batched, fault))
    else:
        raise ValueError(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated whole numbers")
    parser.add_argument("--fault", required=True,
                        help="a fault of faults.py to plant")
    parser.add_argument("--control", type=int, default=0,
                        help="seeds (the first ones) read with the control")
    args = parser.parse_args(argv)
    import torch

    from hmcbench import calibrate, harness

    if not torch.cuda.is_available():
        print("driver_faults needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = harness.Cell(args.workload, torch.device("cuda", 0), ROOT)
    plant(cell, args.fault)
    cell.call(seeds[0], -1, warm=True)
    print(json.dumps({"setup_s": time.perf_counter() - T_START,
                      "device": torch.cuda.get_device_name(0),
                      "fault": args.fault}), flush=True)
    print(json.dumps(calibrate.calibrate(cell, seeds, args.control)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
