#!/usr/bin/env python3
"""Readings behind a cell's limits: the port's compared numbers and the
control's, seed by seed, in one process.

    python3 hmcbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control 3]
        [--fault <name>]

For each seed, one call exactly as a run's first timed call (set-up once,
before the first seed), then the numbers of ``checks.py`` for the port's
outputs and, for the first ``--control`` seeds, for the control (the
reference at TF32 precision in the port's place). With ``--fault``, the
fault of ``faults.py`` is planted first and each seed's line gives the
verdict (``correct``) that ``checks.verdict`` returns for its numbers.
One JSON line a seed, then one with the largest port reading and the
smallest control reading of each number. Needs a CUDA device, as a run
does; benchmark runs never run the control or plant a fault.
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


def calibrate(cell, seeds, n_control: int) -> dict:
    """Readings of ``cell`` (a ``harness.Cell`` set up and warmed up) over
    ``seeds``; returns the summary line's object."""
    program, control = {}, {}
    for i, seed in enumerate(seeds):
        record, samples, _ = cell.call(seed, 0)
        correct, lines = cell.check([samples], [record])
        line = {"seed": seed, "wall_s": record.wall_s,
                "min_ess": record.min_ess, "failure": record.failure,
                "peak_bytes": record.peak_bytes, "correct": correct,
                "program": lines}
        if i < n_control:
            line["control"] = cell.check([samples], [record], "control")[1]
        print(json.dumps(line), flush=True)
        for source, worst, pick in (("program", program, max),
                                    ("control", control, min)):
            for name, reading in line.get(source, {}).items():
                if reading["value"] is not None:
                    worst[name] = pick(worst.get(name, reading["value"]),
                                       reading["value"])
    return {"lower": program, "upper": control, "seeds": len(seeds)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True,
                        help="comma-separated whole numbers")
    parser.add_argument("--control", type=int, default=3,
                        help="seeds (the first ones) read with the control")
    parser.add_argument("--fault", help="a fault of faults.py to plant")
    args = parser.parse_args(argv)
    import torch

    from hmcbench import faults, harness

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = harness.Cell(args.workload, torch.device("cuda", 0), ROOT)
    if args.fault:
        faults.plant(cell, args.fault)
    cell.call(seeds[0], -1, warm=True)
    print(json.dumps({"setup_s": time.perf_counter() - T_START,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    summary = calibrate(cell, seeds, args.control)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
