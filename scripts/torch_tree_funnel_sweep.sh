#!/bin/bash
# Sweep the funnel warp variant's launch bounds at R = 1 on one GPU.
#
#     bash scripts/torch_tree_funnel_sweep.sh [W:M ...]
#
# For each W:M (warps per CTA, CTAs per SM asked of ptxas; default: the
# list below), copies dynamichmc_tpu_torch into _work/funnel_sweep/W_M with
# kFunnelWarps = W and kFunnelCtas = M in csrc/tree_kernel.cu, builds all
# copies in parallel, prints ptxas's registers and spills of the funnel's
# two R = 1 instantiations, then times each copy twice in turns with
# scripts/torch_tree_funnel_compare.py --seeds 0 --K 25 (4096 chains, md 7,
# diagonal and dense; each line carries the copy's launch plan: registers,
# CTAs per SM, resident warps per SM). Run from the root of a checkout;
# _work/ is gitignored. Needs CUDA and nvcc.
set -e
cd "$(dirname "$0")/.."
SWEEP=${*:-"16:2 16:1 4:5 10:2 12:2 8:3 4:6 4:7"}
SRC=dynamichmc_tpu_torch/csrc/tree_kernel.cu
BOUNDS="constexpr int kFunnelWarps = [0-9]*, kFunnelCtas = [0-9]*;"
grep -q "$BOUNDS" $SRC
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for wm in $SWEEP; do
  d=_work/funnel_sweep/${wm%:*}_${wm#*:}
  rm -rf "$d" && mkdir -p "$d" && cp -r dynamichmc_tpu_torch "$d/"
  rm -rf "$d/dynamichmc_tpu_torch/_build"
  sed -i "s/$BOUNDS/constexpr int kFunnelWarps = ${wm%:*}, kFunnelCtas = ${wm#*:};/" "$d/$SRC"
  (cd "$d" && python3 -c "from dynamichmc_tpu_torch.ops import tree_kernel; tree_kernel.library.build()") &
done
wait
for wm in $SWEEP; do
  d=_work/funnel_sweep/${wm%:*}_${wm#*:}
  python3 - "$wm" "$d"/dynamichmc_tpu_torch/_build/tree_kernel-*.log <<'PY'
import json, sys
sys.path.insert(0, ".")
import chip_smoke

usage = chip_smoke.tree_kernel_usage(open(sys.argv[2]).read())
for key, u in sorted(usage.items(), key=str):
    if key[0] == "warp" and key[2] == 1 and key[3] == 1:
        print(json.dumps({"bounds": sys.argv[1], "diag": key[1],
                          "registers": u["registers"], "ptxas": u["spill"]}))
PY
done
for rep in 1 2; do
  for wm in $SWEEP; do
    d=_work/funnel_sweep/${wm%:*}_${wm#*:}
    python3 scripts/torch_tree_funnel_compare.py --root "$d" --seeds 0 --K 25
  done
done
