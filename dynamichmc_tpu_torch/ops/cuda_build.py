"""Build and load the port's CUDA sources: one nvcc call per source into a
content-hashed shared library with a plain C interface, loaded with ctypes.

Nothing is compiled or loaded at import. :meth:`CudaLibrary.build` runs
``nvcc`` the first time a library is needed (or when chip_smoke.py builds
every kernel up front); the library lands in ``dynamichmc_tpu_torch/_build/``
(gitignored) under a name that hashes the source and the flags, so an
edited source never loads a stale binary.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or (
        "/usr/local/cuda"
    )
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's kernels are built "
            "from source at first use"
        )
    return found


class CudaLibrary:
    """One ``csrc/<name>.cu`` source and its ctypes library.

    ``signatures`` maps each exported C function to ``(argtypes, restype)``.
    """

    def __init__(self, name: str, signatures: dict):
        self.name = name
        self.source = os.path.join(CSRC, f"{name}.cu")
        self.signatures = signatures
        self.build_log = ""  # compiler output of the last build (ptxas usage)
        self._lib = None
        self._lock = threading.Lock()

    def library_path(self) -> str:
        h = hashlib.sha256()
        with open(self.source, "rb") as f:
            h.update(f.read())
        h.update(" ".join(NVCC_FLAGS).encode())
        return os.path.join(BUILD_DIR, f"{self.name}-{h.hexdigest()[:12]}.so")

    def build(self) -> str:
        """Compile the source for sm_90a if its library is missing; returns
        the library path. Raises with the compiler's output on failure. The
        compiler's output is kept beside the library (``.log``), so that
        ``build_log`` holds it for a library built earlier too."""
        so = self.library_path()
        if os.path.exists(so):
            if os.path.exists(f"{so}.log"):
                with open(f"{so}.log") as f:
                    self.build_log = f.read()
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
            capture_output=True, text=True,
        )
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {self.source} ({proc.returncode}):\n"
                f"{self.build_log}"
            )
        with open(f"{tmp}.log", "w") as f:
            f.write(self.build_log)
        os.replace(f"{tmp}.log", f"{so}.log")
        os.replace(tmp, so)
        return so

    def load(self) -> ctypes.CDLL:
        lib = self._lib  # once loaded, no lock: launches call this every time
        if lib is not None:
            return lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                for fn, (argtypes, restype) in self.signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = restype
                self._lib = lib
            return self._lib

    @property
    def loaded(self) -> bool:
        return self._lib is not None
