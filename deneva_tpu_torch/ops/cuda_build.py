"""Build a CUDA source of ``deneva_tpu_torch/csrc`` into a shared library
with a plain C interface and load it through ctypes.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``deneva_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the source and the flags, so an edited source is always
rebuilt.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: name -> (ctypes.CDLL, build record) for every library this process loaded
_LOADED: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of deneva_tpu_torch "
                       "are built with nvcc at first use")


def load_library(name: str) -> tuple[ctypes.CDLL, dict]:
    """Build (if needed) and load ``csrc/<name>.cu``.  Returns the library
    and a record ``{"path", "built", "seconds", "ptxas"}``: ``built`` says
    whether this call compiled it, ``ptxas`` is the compiler's register and
    shared-memory report."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD / f"lib{name}-{digest}.so"
    rec = {"path": str(out), "built": False, "seconds": 0.0, "ptxas": ""}
    if not out.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(src)], capture_output=True, text=True)
        rec["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
        rec["built"] = True
        rec["ptxas"] = proc.stderr
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = (lib, rec)
    return lib, rec
