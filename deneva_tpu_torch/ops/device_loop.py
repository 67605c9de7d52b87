"""A loop whose trip count the device decides: the port's ``lax.while_loop``
(the OCC active-writer fixed point, ``deneva_tpu/cc/occ.py:291-292``).

``run_while(step, site, device)`` runs ``step()`` until the () device
flag it returns is false, and at least once, as the reference's loop
starts with "changed".  ``step`` advances its carry in place (buffers made
before the loop, at fixed addresses) and returns "another pass".  Where
it runs:

- inside a CUDA graph capture (``torch.cuda.is_current_stream_capturing``
  on a CUDA device), the loop becomes a conditional WHILE node of the
  graph (``csrc/graph_while.cu``): ``step`` is captured once into the
  node's body, on a side stream, followed by a one-thread kernel that
  sets the condition from the flag.  A replay runs the body until the
  flag is false: exact, with no bound and no host read;
- elsewhere (eager on CUDA, the CPU, a graph's warm-up tick), it loops on
  the host and reads the flag once per pass.

The bodies' allocations go to one private memory pool per device, held
for the life of the process: a captured body runs on a stream that
captures into the node's body graph, whose allocations the capture's own
pool does not serve.  A body's intermediates die inside its pass, and
replays run one at a time on one stream, so every body may share that
pool (as ``engine/graph.py``'s phase graphs share theirs).

The first call outside a capture on a CUDA device does the start-up a
capture needs: it builds and loads the library and makes the device's
body stream and pool.  Each site keeps a device pass counter
(``passes``), made at the site's first call outside a capture and
bumped once per pass, eager and replayed alike.
``LAUNCHES`` counts the set-condition kernel's launches: one per captured
body, at the capture (a replay runs it once per pass, which the pass
counter counts).  A node that fails to bind raises at capture; nothing
falls back to the host loop inside a capture.
"""

from __future__ import annotations

import ctypes

import torch

#: set-condition kernel launches since the last reset (one per captured
#: body, at the capture)
LAUNCHES = 0
#: (site, device) -> () int64 device tensor: passes run at that site
PASSES: dict = {}
#: device index -> (the side stream that captures WHILE bodies, their
#: memory pool)
_BODIES: dict = {}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def reset_passes() -> None:
    """Zero every pass counter in place (captured graphs keep bumping the
    same tensors)."""
    for c in PASSES.values():
        c.zero_()


def _dev(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def passes(site: str, device) -> torch.Tensor:
    """The pass counter of `site` on `device` (a () int64 tensor)."""
    return PASSES[(site, str(_dev(device)))]


def _lib():
    from deneva_tpu_torch.ops.cuda_build import load_library
    lib, _ = load_library("graph_while")
    if not getattr(lib, "_dn_bound", False):
        vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
        lib.dn_while_begin.argtypes = [vp, vp, ctypes.POINTER(cu)]
        lib.dn_while_begin.restype = ci
        lib.dn_while_set.argtypes = [vp, cu, vp]
        lib.dn_while_set.restype = ci
        lib.dn_while_end.argtypes = [vp]
        lib.dn_while_end.restype = ci
        lib.dn_while_error_string.argtypes = [ci]
        lib.dn_while_error_string.restype = ctypes.c_char_p
        lib._dn_bound = True
    return lib


def build() -> dict:
    """Build and load the library now; returns the build record
    (ops/cuda_build.py load_library)."""
    from deneva_tpu_torch.ops.cuda_build import load_library
    _lib()
    return load_library("graph_while")[1]


def _counter(site: str, device: torch.device) -> torch.Tensor:
    """The site's pass counter; made, with the device's start-up, at the
    site's first call, which must come before any capture."""
    key = (site, str(device))
    if key not in PASSES:
        if device.type == "cuda":
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"device_loop site {site!r}: its pass counter must be "
                    "made before the capture (run the loop once outside it)")
            _lib()
            if device.index not in _BODIES:
                _BODIES[device.index] = (torch.cuda.Stream(device),
                                         torch.cuda.graph_pool_handle())
        PASSES[key] = torch.zeros((), dtype=torch.int64, device=device)
    return PASSES[key]


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"graph WHILE node {what} failed: "
                           + lib.dn_while_error_string(rc).decode())


def _capture_while(step, counter: torch.Tensor, device: torch.device):
    global LAUNCHES
    lib = _lib()
    cap = torch.cuda.current_stream(device)
    body, pool = _BODIES[device.index]
    handle = ctypes.c_ulonglong()
    _raise_on(lib, lib.dn_while_begin(cap.cuda_stream, body.cuda_stream,
                                      ctypes.byref(handle)), "bind")
    ended = False
    try:
        with torch.cuda.stream(body):
            torch._C._cuda_beginAllocateCurrentStreamToPool(device.index,
                                                            pool)
            try:
                flag = step()
                counter.add_(1)
                if flag.device != device or flag.dtype != torch.bool \
                        or flag.numel() != 1:
                    raise ValueError("run_while: step must return a () "
                                     f"bool on {device}, got {flag.dtype} "
                                     f"{tuple(flag.shape)} on {flag.device}")
                _raise_on(lib, lib.dn_while_set(body.cuda_stream,
                                                handle.value,
                                                flag.data_ptr()),
                          "set-condition launch")
                LAUNCHES += 1
            finally:
                torch._C._cuda_endAllocateToPool(device.index, pool)
        ended = True
        _raise_on(lib, lib.dn_while_end(body.cuda_stream), "body capture")
    finally:
        if not ended:
            lib.dn_while_end(body.cuda_stream)


def run_while(step, site: str, device) -> None:
    """Run ``step()`` until the () bool device flag it returns is false,
    at least once (see the module docstring)."""
    device = _dev(device)
    counter = _counter(site, device)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        _capture_while(step, counter, device)
        return
    while True:
        flag = step()
        counter.add_(1)
        if not bool(flag):      # the one host read of a pass
            break
