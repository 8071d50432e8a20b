#!/usr/bin/env python3
"""Where a launch of the fused Gaussian kernel (K2 / K4) spends its clocks.

    python3 scripts/torch_gaussian_leaf_phases.py

Builds a copy of ``dynamichmc_tpu_torch/csrc/gaussian_leaf.cu`` into the
package's gitignored ``_build/`` with ``clock64()`` stamps added at the
phase boundaries of each CTA (the copy's kernel is otherwise the source's),
launches it with the package's launch plan at the phase-5 shapes, and
prints, per shape, the median and largest clocks from the CTA's start to:
the end of the kick and drift (``kick``), the barrier after the staging
(``barrier``), the end of the products and epilogue (``columns``) and the
end of the butterflies and stores (``end``), read by warp 0 of each of the
first 1024 CTAs; beside them the kernel's device time (torch.profiler) and
the nvidia-smi name and power limit. The stamps are ordinary instructions,
so a phase's edge moves by what the compiler schedules across it. Needs
CUDA and nvcc.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as chip  # noqa: E402
from dynamichmc_tpu_torch.ops import cuda_build, gaussian_leaf  # noqa: E402

SHAPES = [  # (K2?, C, K, metric form)
    (True, 4096, 25, "chain_diag"), (False, 4096, 25, "chain_diag"),
    (False, 1, 25, "shared_diag"), (True, 1, 1, "shared_diag"),
    (True, 4096, 100, "chain_diag"),
]
STAMPS = [  # (marker in the source, code put before it)
    ("  const int threads = blockDim.x;\n",
     "  const long long t_start = clock64();\n"),
    ("  if (staged) cp_async_wait_all();\n",
     "  const long long t_kick = clock64();\n"),
    ("  if (cw >= nc) return;  // whole warps only: no barrier follows\n",
     "  const long long t_bar = clock64();\n"),
    ("  // The chains' sums: lane 4 r (R = 8) or lane 0 (R = 1) writes chain r.\n",
     "  const long long t_cols = clock64();\n"),
]
END = """  const long long t_end = clock64();
  if (lane == 0 && warp == 0 && blockIdx.x < 1024) {
    long long* o = g_phase_clocks + 4 * blockIdx.x;
    o[0] = t_kick - t_start;
    o[1] = t_bar - t_start;
    o[2] = t_cols - t_start;
    o[3] = t_end - t_start;
  }
}
"""


def instrumented_source():
    """The source with the stamps, a device array for them and a reader."""
    with open(os.path.join(cuda_build.CSRC, "gaussian_leaf.cu")) as f:
        src = f.read()
    src = src.replace("namespace {\n",
                      "__device__ long long g_phase_clocks[4 * 1024];\n"
                      "namespace {\n", 1)
    for marker, stamp in STAMPS:
        if src.count(marker) != 1:
            raise SystemExit(f"marker not found once in the source: {marker!r}")
        src = src.replace(marker, stamp + marker)
    # the kernel's closing brace follows the last store of pi'
    tail = "      pin[c] = pi;\n    }\n  }\n}\n"
    if src.count(tail) != 1:
        raise SystemExit("the kernel's end was not found once in the source")
    src = src.replace(tail, "      pin[c] = pi;\n    }\n  }\n" + END)
    return src + """
extern "C" int read_phase_clocks(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(long long) * 4 * 1024);
}
"""


def build():
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(cuda_build.BUILD_DIR, "gaussian_leaf_phases.cu")
    so = os.path.join(cuda_build.BUILD_DIR, "gaussian_leaf_phases.so")
    with open(cu, "w") as f:
        f.write(instrumented_source())
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, cu],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    for name, sig in gaussian_leaf.library.signatures.items():
        getattr(lib, name).argtypes, getattr(lib, name).restype = sig
    lib.read_phase_clocks.argtypes = [ctypes.c_void_p]
    lib.read_phase_clocks.restype = ctypes.c_int
    return lib


def main():
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = chip.nvidia_smi_line()
    lib = build()
    gen = torch.Generator(device=dev).manual_seed(7)
    from dynamichmc_tpu_torch.models import correlated_gaussian, mvnormal

    for write_pi, C, K, kind in SHAPES:
        model = (mvnormal(np.zeros(K), np.eye(K), dtype=torch.float32,
                          device=dev, fused=True) if K in (1, 25) else
                 correlated_gaussian(K, dtype=torch.float32, device=dev,
                                     fused=True))
        metric, q, p, g, eps, prec, lchol, mu = chip.gaussian_leaf_inputs(
            model, C, kind, gen)
        plan = gaussian_leaf.launch_plan(C, K, gaussian_leaf.sm_count(dev.index))
        outs = [torch.empty_like(q) for _ in range(3)] + [
            torch.empty_like(eps) for _ in range(2 if write_pi else 1)]
        fn = lib.gaussian_leaf_f32 if write_pi else lib.gaussian_leapfrog_f32
        call = [t.data_ptr() for t in (q, p, g, metric.m_inv, eps, prec, lchol,
                                       mu, *outs)]
        call += [C, K, int(metric.m_inv.ndim == 2), plan.R, plan.warps,
                 int(plan.staged), torch.cuda.current_stream(dev).cuda_stream]
        for _ in range(10):
            assert fn(*call) == 0
        torch.cuda.synchronize()
        clocks = np.zeros(4 * 1024, dtype=np.int64)
        assert lib.read_phase_clocks(clocks.ctypes.data) == 0
        t = clocks.reshape(1024, 4)[:min(plan.ctas, 1024)]
        names = ("kick", "barrier", "columns", "end")
        print(json.dumps({
            "phases": "K2" if write_pi else "K4", "shape": [C, K, kind],
            "plan": {"R": plan.R, "warps": plan.warps, "ctas": plan.ctas,
                     "staged": plan.staged},
            "clocks_median": {n: float(np.median(t[:, i]))
                              for i, n in enumerate(names)},
            "clocks_max": {n: int(t[:, i].max()) for i, n in enumerate(names)},
            "device_ms": chip.device_ms(lambda: fn(*call), (), 50,
                                        "gaussian_leaf_kernel"),
            "gpu": smi}), flush=True)


if __name__ == "__main__":
    main()
