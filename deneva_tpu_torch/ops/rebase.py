"""In-place timestamp rebase of two int32 arrays by a device scalar
shift: the wrapper of the Hopper kernel ``csrc/ts_rebase.cu``, its plain
PyTorch version and its launch counter.  Two rules:

- plain, ``x = max(x - shift, 0)``: TIMESTAMP's ``wts`` and ``rts``
  (``cc/timestamp.py``), MVCC's ``rts0`` and ``w_floor``;
- ring, ``x = x > 0 ? max(x - shift, 1) : 0``: MVCC's version rings
  ``w_ring`` and ``r_ring`` (``cc/mvcc.py``), whose empty slots stay 0
  and whose versions stay above 0.

The plugins run it on every tick.  The JAX engine rebases under a
``lax.cond`` only on a tick whose counter passed its threshold; the port's
tick reads nothing on the host, so its shift is 0 on every other tick, and
the kernel returns at once on a shift of 0 (the cond on the device).  The
plain version, a few in-place ops per array, reads and writes both arrays
on every tick.

Dispatch is by device, as in ``ops/fused.py``: CPU tensors take the plain
version, CUDA tensors the kernel (which raises if it cannot build or
launch).  ``LAUNCHES`` counts kernel launches; a launch captured into a
CUDA graph counts once, at the capture.
"""

from __future__ import annotations

import ctypes

import torch

I32 = torch.int32
I64 = torch.int64
THREADS = 256
#: blocks per SM of a grid-stride launch
BLOCKS_PER_SM = 8

#: kernel launches since the last reset (one per wrapper call on CUDA),
#: by rule ("plain", "ring")
LAUNCHES: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def rebase_plain(a: torch.Tensor, b: torch.Tensor, shift,
                 ring: bool = False) -> None:
    """``max(x - shift, 0)`` on ``a`` and ``b``, in place; with ``ring``,
    ``x > 0 ? max(x - shift, 1) : 0`` (the JAX plugins' own expressions,
    ``deneva_tpu/cc/timestamp.py:119``, ``deneva_tpu/cc/mvcc.py:97``)."""
    for x in (a, b):
        if ring:
            x.copy_(torch.where(x > 0, torch.clamp(x - shift, min=1), 0))
        else:
            x.sub_(shift).clamp_(min=0)


def _lib():
    from deneva_tpu_torch.ops.cuda_build import load_library
    lib, _ = load_library("ts_rebase")
    if not getattr(lib, "_dn_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dn_ts_rebase.argtypes = [vp, vp, ctypes.c_longlong, vp, ci, ci,
                                     ci, vp]
        lib.dn_ts_rebase.restype = ci
        lib.dn_ts_rebase_error_string.argtypes = [ci]
        lib.dn_ts_rebase_error_string.restype = ctypes.c_char_p
        lib._dn_bound = True
    return lib


def build() -> dict:
    """Build and load the kernel now; returns the build record
    (ops/cuda_build.py load_library)."""
    from deneva_tpu_torch.ops.cuda_build import load_library
    _lib()
    return load_library("ts_rebase")[1]


def _rebase_cuda(a, b, shift, ring: bool) -> None:
    dev = a.device
    for x in (a, b):
        if x.device != dev or x.dtype != I32 or x.dim() != 1 \
                or x.shape != a.shape or not x.is_contiguous() \
                or x.data_ptr() % 16:
            raise ValueError(
                "ts_rebase kernel takes two contiguous, 16-byte aligned 1-D "
                f"int32 arrays of one length on one CUDA device; got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if shift.device != dev or shift.dtype != I64 or shift.numel() != 1:
        raise ValueError("ts_rebase kernel takes an int64 scalar shift on "
                         f"the arrays' device; got {shift.dtype} "
                         f"{tuple(shift.shape)} on {shift.device}")
    lib = _lib()
    n = a.shape[0]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-max(n // 4, 1) // THREADS), sms * BLOCKS_PER_SM))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dn_ts_rebase(a.data_ptr(), b.data_ptr(), n,
                              shift.data_ptr(), int(ring), grid, THREADS,
                              stream)
    if rc != 0:
        raise RuntimeError("ts_rebase kernel launch failed: "
                           + lib.dn_ts_rebase_error_string(rc).decode())
    rule = "ring" if ring else "plain"
    LAUNCHES[rule] = LAUNCHES.get(rule, 0) + 1


def rebase_(a: torch.Tensor, b: torch.Tensor, shift: torch.Tensor,
            ring: bool = False) -> None:
    """``max(x - shift, 0)`` on ``a`` and ``b`` in place, or with ``ring``
    the ring rule (``rebase_plain``); ``shift`` is an int64 scalar tensor,
    >= 0 and below 2^31.  CPU tensors take the plain version; CUDA tensors
    the kernel."""
    devices = {a.device.type, b.device.type, shift.device.type}
    if devices == {"cpu"}:
        rebase_plain(a, b, shift, ring)
    elif devices == {"cuda"}:
        _rebase_cuda(a, b, shift, ring)
    else:
        raise ValueError(f"ts_rebase: tensors on {sorted(devices)}")
