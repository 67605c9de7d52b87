"""Fused sort + segment-scan: the wrapper of the Hopper kernel
``csrc/fused_sort_scan.cu``, its plain PyTorch version, the eligibility
gate and the launch counter.

The kernel replaces the JAX package's Pallas kernel
(``deneva_tpu/ops/fused.py:_pallas_sort_scan``).  Both sort 1-D int32
columns lexicographically by the first ``num_keys`` of them with the lane
index as the final key -- exactly the stable order, which is a valid
result for the stable and the unstable call sites alike -- and both return
the segment-start mask and start index of the sorted primary key.  The port
adds a ``shift``: the scan outputs are then those of the sorted primary key
shifted right by ``shift``, so that a caller whose segments are a prefix of
the key's bits (twopl.arbitrate's rows, ``keykind >> 1``) takes them from
the kernel.

Dispatch is by device, never by failure: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel (which raises if it cannot build or
launch).  ``LAUNCHES`` counts kernel launches, so a run can show that its
main path went through the kernel.  The count moves where the wrapper
runs: a launch captured into a CUDA graph counts once, at the capture,
and not at each replay (``engine/graph.py`` keeps the launches of each
captured graph).  The launch, ``cudaLaunchCooperativeKernel`` on the
current stream, is captured as a cooperative kernel node.
"""

from __future__ import annotations

import ctypes
import warnings

import torch

I32 = torch.int32

#: operand-count ceiling, as in the JAX package (MAAT's widest chain sort
#: packs 10 operands); the kernel carries up to this many columns
MAX_OPERANDS = 24
#: key-count ceiling of the kernel's record (keys + lane index held as one
#: record of at most 4 words): the most any call site in the repo sorts by
MAX_KEYS = 3
#: the kernel's width limit: up to 2^23 lanes, the entry-index limit of
#: the packed lock sort (cc/twopl.py _IDX_BITS).  Unlike the TPU kernel it
#: has no fast-memory budget: past one block's 1024-lane tile it merges
#: through device memory, so any width up to this limit is eligible.
MAX_LANES = 1 << 23

#: kernel launches since the last reset (one per wrapper call on CUDA),
#: in all and by pack shape (columns, keys, lanes, shift)
LAUNCHES = 0
LAUNCHES_BY_PACK: dict = {}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    LAUNCHES_BY_PACK.clear()


# ---------------------------------------------------------------------------
# fallback registry: an ineligible CPU pack is counted and warned about,
# never silently sorted elsewhere (on the card it raises instead)
# ---------------------------------------------------------------------------

_FALLBACKS: dict = {}


def record_fallback(width: int, n_operands: int, reason: str) -> None:
    key = (width, n_operands, reason)
    if key not in _FALLBACKS:
        _FALLBACKS[key] = 0
        warnings.warn(
            f"fused_sort_scan fallback to the plain sort: width={width} "
            f"operands={n_operands} reason={reason} (counted in "
            "fallback_snapshot)", stacklevel=3)
    _FALLBACKS[key] += 1


def fallback_snapshot() -> dict:
    """Aggregated registry: one event per (width, operands, reason) with
    the number of dispatches that fell back."""
    events = [{"width": w, "operands": n, "reason": r, "traces": c}
              for (w, n, r), c in sorted(_FALLBACKS.items())]
    return {"count": int(sum(e["traces"] for e in events)),
            "events": events}


def reset_fallbacks() -> None:
    _FALLBACKS.clear()


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _stable_order(keys) -> torch.Tensor:
    """Permutation that sorts lexicographically by `keys`, ties broken by
    lane index: stable sorts from the least significant key up."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def lex_sort(operands, num_keys: int) -> tuple:
    """Stable lexicographic sort of 1-D tensors by the first ``num_keys``
    (the counterpart of ``lax.sort``, any dtype)."""
    ops = tuple(operands)
    perm = _stable_order(ops[:num_keys])
    return tuple(o[perm] for o in ops)


def fused_sort_scan_plain(operands, num_keys: int, shift: int = 0):
    """The kernel's function in plain PyTorch, on integer columns:
    ``(sorted_columns, starts, start_index)``, where starts (bool) and the
    start index are those of ``sorted_columns[0] >> shift``."""
    from deneva_tpu_torch.ops import segment as seg
    srt = lex_sort(operands, num_keys)
    starts = seg.segment_starts(srt[0] >> shift if shift else srt[0])
    return srt, starts, seg.start_index(starts)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _lib():
    from deneva_tpu_torch.ops.cuda_build import load_library
    lib, _ = load_library("fused_sort_scan")
    if not getattr(lib, "_dn_bound", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dn_fused_sort_scan.argtypes = [
            ctypes.POINTER(vp), ci, ci, ci, ci, ctypes.POINTER(vp), vp, vp,
            vp, vp]
        lib.dn_fused_sort_scan.restype = ci
        lib.dn_scratch_words.argtypes = [ci, ci]
        lib.dn_scratch_words.restype = ctypes.c_longlong
        lib.dn_launch_plan.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.dn_launch_plan.restype = ci
        lib.dn_error_string.argtypes = [ci]
        lib.dn_error_string.restype = ctypes.c_char_p
        lib._dn_bound = True
    return lib


def build() -> dict:
    """Build and load the kernel now; returns the build record
    (ops/cuda_build.py load_library)."""
    from deneva_tpu_torch.ops.cuda_build import load_library
    _lib()
    return load_library("fused_sort_scan")[1]


def warm() -> None:
    """Build and load the kernel and make its occupancy query for every key
    count on the current device: the start-up a CUDA-graph capture must
    find done (the query is cached per device, csrc/fused_sort_scan.cu
    ``grid_size``)."""
    for num_keys in range(1, MAX_KEYS + 1):
        launch_plan(num_keys, 1)


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"fused_sort_scan {what} failed: "
                           + lib.dn_error_string(rc).decode())


def launch_plan(num_keys: int, n: int) -> dict:
    """The one cooperative launch a call of this shape makes on the current
    CUDA device: blocks and threads per block, records per tile, merge
    levels, outputs per merge chunk and the tiles each block sorts at
    most."""
    lib = _lib()
    plan = (ctypes.c_int * 5)()
    _raise_on(lib, lib.dn_launch_plan(num_keys, n, plan), "launch plan")
    grid, threads, tile, levels, chunk = plan
    tiles = -(-n // tile)
    return {"grid": grid, "threads": threads, "tile": tile,
            "levels": levels, "chunk": chunk, "tiles": tiles,
            "tiles_per_block": -(-tiles // grid)}


def _check_cuda_pack(cols, num_keys: int, shift: int) -> None:
    dev = cols[0].device
    n = cols[0].shape[0]
    if not 1 <= num_keys <= min(MAX_KEYS, len(cols)):
        raise ValueError(f"num_keys={num_keys} outside 1..{MAX_KEYS}")
    if len(cols) > MAX_OPERANDS:
        raise ValueError(f"{len(cols)} columns > MAX_OPERANDS")
    if not 1 <= n <= MAX_LANES:
        raise ValueError(f"width {n} outside 1..{MAX_LANES}")
    if not 0 <= shift <= 31:
        raise ValueError(f"shift={shift} outside 0..31")
    for c in cols:
        if c.device != dev or c.dtype != I32 or c.dim() != 1 \
                or c.shape[0] != n or not c.is_contiguous():
            raise ValueError(
                "fused_sort_scan kernel takes contiguous 1-D int32 columns "
                f"of one length on one CUDA device; got {c.dtype} "
                f"{tuple(c.shape)} on {c.device}")


def _fused_sort_scan_cuda(cols, num_keys: int, shift: int):
    global LAUNCHES
    _check_cuda_pack(cols, num_keys, shift)
    lib = _lib()
    dev = cols[0].device
    n = cols[0].shape[0]
    outs = [torch.empty(n, dtype=I32, device=dev) for _ in cols]
    starts = torch.empty(n, dtype=torch.bool, device=dev)
    sidx = torch.empty(n, dtype=I32, device=dev)
    scratch = torch.empty(lib.dn_scratch_words(num_keys, n), dtype=I32,
                          device=dev)
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])
    # the launch is asynchronous on the current stream; the caching
    # allocator reuses the scratch and the inputs only for work queued on
    # that stream after it, so they need no reference past this call
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dn_fused_sort_scan(
            ptrs(cols), len(cols), num_keys, n, shift, ptrs(outs),
            starts.data_ptr(), sidx.data_ptr(), scratch.data_ptr(), stream)
    _raise_on(lib, rc, "kernel launch")
    LAUNCHES += 1
    pack = (len(cols), num_keys, n, shift)
    LAUNCHES_BY_PACK[pack] = LAUNCHES_BY_PACK.get(pack, 0) + 1
    return tuple(outs), starts, sidx


def fused_sort_scan(operands, num_keys: int, shift: int = 0):
    """Sort 1-D ``operands`` lexicographically by the first ``num_keys``
    (stable: the lane index is the implicit final key) and return
    ``(sorted_operands, segment_starts, start_index)`` of the sorted
    primary key shifted right by ``shift`` (arithmetic; 0 is the key
    itself).  Booleans ride as int32 and convert back.  CPU tensors take
    the plain version; CUDA tensors the kernel."""
    ops = tuple(operands)
    cols = [o.to(I32) if o.dtype == torch.bool else o for o in ops]
    devices = {o.device.type for o in ops}
    if devices == {"cpu"}:
        srt, starts, sidx = fused_sort_scan_plain(cols, num_keys, shift)
    elif devices == {"cuda"}:
        srt, starts, sidx = _fused_sort_scan_cuda(
            [c.contiguous() for c in cols], num_keys, shift)
    else:
        raise ValueError(f"fused_sort_scan: operands on {sorted(devices)}")
    sorted_ops = tuple(o == 1 if orig.dtype == torch.bool else o
                       for o, orig in zip(srt, ops))
    return sorted_ops, starts, sidx


def _ineligible(ops, num_keys: int):
    """Why the kernel does not take this pack, or None if it does."""
    if any(o.dim() != 1 for o in ops):
        return "rank"
    if any(o.dtype not in (I32, torch.bool) for o in ops):
        return "dtype"
    if len(ops) > MAX_OPERANDS:
        return "operands"
    if num_keys > MAX_KEYS:
        return "keys"
    if ops[0].shape[0] > MAX_LANES:
        return "width"
    return None


def maybe_fused_sort(cfg, operands, num_keys: int, shift: int = 0):
    """Eligibility gate for one dispatch (ops/segment.py sort_pack and
    sort_pack_scan): ``(sorted_operands, starts, start_idx)`` when the pack
    fits the kernel.  An ineligible pack raises on the card; on the CPU,
    where the plain version runs either way, it returns None after
    recording the loud fallback, as the JAX package's gate does.  The JAX
    package's ``fused_max_lanes`` and VMEM budget are TPU limits and are
    not read: the kernel takes any width up to ``MAX_LANES``."""
    ops = tuple(operands)
    reason = _ineligible(ops, num_keys)
    if reason is None:
        return fused_sort_scan(ops, num_keys, shift)
    if any(o.device.type != "cpu" for o in ops):
        raise ValueError(f"fused_sort_scan kernel does not take this pack "
                         f"({reason}): {len(ops)} operands, {num_keys} keys, "
                         f"shapes {[tuple(o.shape) for o in ops]}, dtypes "
                         f"{sorted({str(o.dtype) for o in ops})}")
    if reason != "rank":             # not an entry-lane sort; stay quiet
        record_fallback(ops[0].shape[0], len(ops), reason)
    return None
