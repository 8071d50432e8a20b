"""Native (C++) host runtime components, loaded via ctypes (port of
``dynamichmc_tpu.native``).

``fastdiag`` (native/fastdiag.cpp) computes split rank-normalized R-hat
and bulk/tail ESS for a whole (chains, draws, params) batch, OpenMP-parallel
over the parameters: the post-processing hot path of 4096-chain fleets.
It is built with the host's C++ compiler (``$CXX``, else ``g++``, else
``c++``: the first that builds it with OpenMP) at first use into
``dynamichmc_tpu_torch/_build/`` (gitignored), under a name that hashes
the source, the flags and the host's CPU (the library is compiled with
``-march=native``, so one host's build must never load on another). Every
caller falls back to the numpy implementation in ``stats`` when the
compiler or the library is unavailable, or when ``DYNHMC_NO_NATIVE`` is
set.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "fastdiag.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-fPIC", "-shared",
             "-std=c++17")


def host_fingerprint() -> str:
    """12 hex digits of the host CPU's identity: the machine, and the
    first processor's model name and feature flags (two hosts whose
    hypervisors mask different flags get different names)."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # end of the first processor block
                if line.startswith(("flags", "model name", "Features")):
                    parts.append(line.strip())
    except OSError:
        parts.append(platform.processor() or "")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:12]


def library_path() -> str:
    """``_build/fastdiag-<source and flags hash>-<host>.so``: an edited
    source, other flags or another host never load a stale library."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(
        BUILD_DIR, f"fastdiag-{h.hexdigest()[:12]}-{host_fingerprint()}.so")


def _compilers() -> list:
    """``$CXX``, then ``g++``, then ``c++``: the first that builds wins."""
    names = []
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and name not in names:
            names.append(name)
    return names


build_log = ""  # the compilers' commands and output of the last build


def _build(so: str) -> bool:
    """Compile the source into ``so`` unless it exists, with the first
    compiler of :func:`_compilers` that succeeds: under an exclusive lock
    on ``so``.lock (processes building at once build it once) into a
    temporary name renamed into place. False when every compiler fails
    (``build_log`` says why)."""
    global build_log
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(f"{so}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return True
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        for cxx in _compilers():
            cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=120)
            except (OSError, subprocess.SubprocessError) as err:
                build_log += f"{' '.join(cmd)}: {err}\n"
                continue
            build_log += " ".join(cmd) + "\n" + proc.stdout + proc.stderr
            if proc.returncode == 0:
                os.replace(tmp, so)
                return True
            if os.path.exists(tmp):
                os.remove(tmp)
    return False


_lock = threading.Lock()
_lib = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    """The fastdiag library, built if needed; None where no compiler
    builds it or it does not load (the numpy path runs then). Tried once
    a process."""
    global _lib, _tried, build_log
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("DYNHMC_NO_NATIVE"):
            return None  # kill-switch: force the numpy fallback
        build_log = ""
        so = library_path()
        if not _build(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as err:
            build_log += f"loading {so}: {err}\n"
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        lib.ess_rhat_batch.argtypes = [dp, ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64, dp, dp, dp]
        lib.ess_rhat_batch.restype = None
        _lib = lib
        return _lib


def ess_rhat_batch(positions: np.ndarray) -> Optional[dict]:
    """(chains, draws, params) -> dict of per-parameter ``ess_bulk``,
    ``ess_tail`` and ``rhat``, or None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    x = np.ascontiguousarray(positions, np.float64)
    c, n, k = x.shape
    out = {key: np.empty(k) for key in ("ess_bulk", "ess_tail", "rhat")}
    dp = ctypes.POINTER(ctypes.c_double)
    lib.ess_rhat_batch(x.ctypes.data_as(dp), c, n, k,
                       out["ess_bulk"].ctypes.data_as(dp),
                       out["ess_tail"].ctypes.data_as(dp),
                       out["rhat"].ctypes.data_as(dp))
    return out
