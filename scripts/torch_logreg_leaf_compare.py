#!/usr/bin/env python3
"""Time and sweep the fused logreg leaf's slice kernels (K3) on the card:
the tiled one against the chunked one at the same shapes, for the package
of any checkout.

    python3 scripts/torch_logreg_leaf_compare.py [--root DIR] [--parts time,sweep]
        [--shapes hier,2048x128x4000] [--kinds shared_diag] [--reps N]
        [--sweep CBxTN,...]

``--root`` names the checkout whose ``dynamichmc_tpu_torch`` is imported
(default: this one), so that one call can hold this tree's kernels beside
another commit's unpacked with ``git archive``. The inputs, timing and
bound come from this checkout's ``chip_smoke.py`` (phase 3's inputs,
phase 5's ``time_call`` and bound). Needs CUDA. Prints one JSON line per
measurement, each with the nvidia-smi name and power limit.

1. ``time``: ms per wrapper call (CUDA events over ``--reps`` calls after
   one warm-up) at each shape of ``--shapes`` and metric form of
   ``--kinds`` (shared_diag, chain_diag, shared_dense): ``hier`` is the
   hierarchical cell's 16,384 x 302 x 1000, ``CxKxN`` the flat model's
   chains, coordinates and observations. Where the imported package has
   the tiled variant and K takes it, both variants in the order chunked,
   tiled, tiled, chunked; otherwise the slice kernel the package takes,
   twice. Beside them the plain float32 leaf, the launch plan, registers
   and CTAs per SM.
2. ``sweep``: this checkout's tiled kernel rebuilt with other chains per
   CTA (CB) and rows per tile (TN) (a copy of the source under
   ``_build/``), each timed at the ``--shapes`` where its CTA fits, with
   its registers and ptxas's spill line.
"""

import argparse
import concurrent.futures
import importlib.util
import json
import os
import re
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
cuda_build = logreg_leaf = None  # the --root checkout's, set by main


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


chip = load("chip_smoke", os.path.join(HERE, "chip_smoke.py"))


def has_tiled(K):
    """Whether the imported package has the tiled variant and K takes it."""
    return hasattr(logreg_leaf, "tiled") and logreg_leaf.tiled(K)


class Variant:
    """The plan's choice of slice kernel forced to ``tiled`` (True, False)
    for the duration of a ``with`` block; the kernel infos are queried
    anew on both sides. A package without the tiled variant is left as it
    is."""

    def __init__(self, tiled):
        self.tiled = tiled

    def __enter__(self):
        self.rule = getattr(logreg_leaf, "tiled", None)
        if self.rule is not None:
            fits = self.rule
            logreg_leaf.tiled = lambda K: self.tiled and fits(K)
            logreg_leaf._infos.clear()

    def __exit__(self, *exc):
        if self.rule is not None:
            logreg_leaf.tiled = self.rule
            logreg_leaf._infos.clear()


def shapes(dev, names, kinds):
    """(label, leaf, plain, args) of each shape of ``names`` in each metric
    form of ``kinds``."""
    from dynamichmc_tpu_torch.models import (
        hierarchical_logistic_regression_from_data, logistic_regression)

    gen = torch.Generator(device=dev).manual_seed(24)
    out = []
    for name in names:
        if name == "hier":
            model = hierarchical_logistic_regression_from_data(
                *chip.hier_data(), rate=0.01, dtype=torch.float32, device=dev,
                fused=True)
            C, n = chip.C_HIER, chip.N_HIER
            leaf, plain, inputs = (logreg_leaf.logreg_leaf_hier,
                                   logreg_leaf.logreg_leaf_hier_plain,
                                   chip.hier_leaf_inputs)
        else:
            C, K, n = (int(v) for v in name.split("x"))
            model = logistic_regression(n, K, dtype=torch.float32, device=dev,
                                        fused=True)
            leaf, plain, inputs = (logreg_leaf.logreg_leaf,
                                   logreg_leaf.logreg_leaf_plain,
                                   chip.fused_leaf_inputs)
        for kind in kinds:
            out.append((f"{C}x{model.dim}x{n} {kind}", leaf, plain,
                        inputs(model, C, kind, gen)))
    return out


def plan_of(dev, args):
    metric, q = args[0], args[1]
    C, K = q.shape
    info = logreg_leaf.kernel_info(dev, logreg_leaf._metric_mode(metric, C, K), K)
    plan = logreg_leaf.launch_plan(C, K, args[5].shape[0], info.sm_count,
                                   info.blocks_per_sm)
    return {"tiled": getattr(plan, "tiled", False), "tile_rows": plan.tile,
            "slices": plan.slices, "chunks": plan.chunks,
            "registers": info.registers, "smem_bytes": info.smem,
            "ctas_per_sm": info.blocks_per_sm}


def part_time(dev, tag, reps, names, kinds):
    for label, leaf, plain, args in shapes(dev, names, kinds):
        row = {"part": "time", "shape": label, **tag,
               "bound_ms": chip.logreg_leaf_bound(args)}
        order = ((False, True, True, False) if has_tiled(args[1].shape[1])
                 else (False, False))
        for tiled in order:
            with Variant(tiled):
                key = "tiled" if tiled else "chunked"
                row.setdefault(key + "_ms", []).append(
                    chip.time_call(leaf, args, reps))
                row[key + "_plan"] = plan_of(dev, args)
        row["plain_ms"] = chip.time_call(plain, args, max(1, reps // 2))
        print(json.dumps(row), flush=True)


def part_sweep(dev, tag, reps, configs, names, kinds):
    source = logreg_leaf.library.source
    with open(source) as f:
        text = f.read()
    original = (logreg_leaf.library, logreg_leaf.TILED_CHAINS,
                logreg_leaf.TILED_ROWS)
    libs = []
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    for cb, tn in configs:
        copy = re.sub(r"(constexpr int kTiledChains = )\d+", rf"\g<1>{cb}", text)
        copy = re.sub(r"(constexpr int kTiledRows = )\d+", rf"\g<1>{tn}", copy)
        path = os.path.join(cuda_build.BUILD_DIR, f"logreg_leaf_cb{cb}_tn{tn}.cu")
        with open(path, "w") as f:
            f.write(copy)
        lib = cuda_build.CudaLibrary("logreg_leaf", logreg_leaf.library.signatures)
        lib.source = path
        libs.append(lib)

    def build(lib):
        try:
            lib.load()
            return None
        except RuntimeError as e:
            return str(e)[-2000:]

    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        errors = list(pool.map(build, libs))
    for (cb, tn), lib, error in zip(configs, libs, errors):
        row = {"part": "sweep", "chains_per_cta": cb, "rows_per_tile": tn,
               **tag}
        if error:
            row["build_error"] = error
            print(json.dumps(row), flush=True)
            continue
        row["ptxas"] = sorted({line.strip() for line in lib.build_log.splitlines()
                               if "spill" in line or "Used" in line})[:40]
        logreg_leaf.library = lib
        logreg_leaf.TILED_CHAINS, logreg_leaf.TILED_ROWS = cb, tn
        try:
            for label, leaf, _plain, args in shapes(dev, names, kinds):
                K = args[1].shape[1]
                if logreg_leaf.tiled_smem_bytes(K) > logreg_leaf.MAX_SMEM_BYTES:
                    row[label] = "does not fit"
                    continue
                with Variant(True):
                    row[label] = {"ms": chip.time_call(leaf, args, reps),
                                  "plan": plan_of(dev, args)}
        finally:
            (logreg_leaf.library, logreg_leaf.TILED_CHAINS,
             logreg_leaf.TILED_ROWS) = original
            logreg_leaf._infos.clear()
        print(json.dumps(row), flush=True)


def main():
    global cuda_build, logreg_leaf
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--parts", default="time")
    ap.add_argument("--shapes", default="hier,2048x128x4000")
    ap.add_argument("--kinds", default="shared_diag")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--sweep", default="64x32,32x32,32x64,64x64")
    a = ap.parse_args()
    root = os.path.abspath(a.root)
    sys.path.insert(0, root)
    from dynamichmc_tpu_torch.ops import cuda_build, logreg_leaf

    dev = torch.device("cuda", 0)
    tag = {"root": os.path.relpath(root, HERE), "gpu": chip.nvidia_smi_line()}
    names, kinds = a.shapes.split(","), a.kinds.split(",")
    parts = a.parts.split(",")
    lib = logreg_leaf.library
    lib.load()
    print(json.dumps({"part": "build", **tag, "torch": torch.__version__,
                      "ptxas": [line.strip() for line in lib.build_log.splitlines()
                                if "spill" in line or "Used" in line
                                or "Function properties" in line]}), flush=True)
    if "time" in parts:
        part_time(dev, tag, a.reps, names, kinds)
    if "sweep" in parts:
        configs = [tuple(int(v) for v in c.split("x")) for c in a.sweep.split(",")]
        part_sweep(dev, tag, a.reps, configs, names, kinds)


if __name__ == "__main__":
    main()
