"""Build a CUDA source of ``deneva_tpu_torch/csrc`` into a shared library
with a plain C interface and load it through ctypes.

The library is compiled with ``nvcc`` for ``sm_90a`` at first use, into
``deneva_tpu_torch/_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the source and the flags, so an edited source is always
rebuilt.  ``build_all`` starts one ``nvcc`` per source at once.  A missing
``nvcc`` or a failed build raises.
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


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start ``nvcc`` on ``csrc/<name>.cu`` unless its library is built;
    returns the running job or None."""
    src, out = _target(name)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                            text=True)
    return proc, tmp, time.perf_counter()


def _finish(name: str, job) -> tuple[ctypes.CDLL, dict]:
    """Wait for `job` (``_start``), then load the library."""
    src, out = _target(name)
    rec = {"path": str(out), "built": False, "seconds": 0.0, "ptxas": ""}
    if job is not None:
        proc, tmp, t0 = job
        _, err = proc.communicate()
        rec["seconds"] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{err}")
        os.replace(tmp, out)
        rec["built"] = True
        rec["ptxas"] = err
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = (lib, rec)
    return lib, rec


def load_library(name: str) -> tuple[ctypes.CDLL, dict]:
    """Build (if needed) and load ``csrc/<name>.cu``.  Returns the library
    and a record ``{"path", "built", "seconds", "ptxas"}``: ``built`` says
    whether it was compiled in this process, ``ptxas`` is the compiler's
    register and shared-memory report."""
    if name in _LOADED:
        return _LOADED[name]
    return _finish(name, _start(name))


def build_all(names) -> dict:
    """Build every ``csrc/<name>.cu`` of `names` that is not built yet, one
    ``nvcc`` each, all started together, and load them.  Returns each
    one's build record (``load_library``).  If one fails, the others are
    stopped and it raises."""
    jobs = {}
    try:
        for name in names:
            if name not in _LOADED:
                jobs[name] = _start(name)
        for name in list(jobs):
            _finish(name, jobs.pop(name))
    finally:
        for job in jobs.values():
            if job is not None:
                job[0].kill()
                job[0].wait()
    return {name: _LOADED[name][1] for name in names}
