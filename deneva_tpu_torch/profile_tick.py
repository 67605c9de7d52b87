"""Where the time of one tick goes on a CUDA device.

    python -m deneva_tpu_torch.profile_tick --cell headline --ticks 50
    python -m deneva_tpu_torch.profile_tick --cell tpcc --ticks 50
    python -m deneva_tpu_torch.profile_tick --cell pps --ticks 50
    python -m deneva_tpu_torch.profile_tick --cell pps_wait_die --ticks 50
    python -m deneva_tpu_torch.profile_tick --cell pps --compiled
    python -m deneva_tpu_torch.profile_tick --cell tpcc_timestamp --compiled
    python -m deneva_tpu_torch.profile_tick --cell tpcc_mvcc --compiled
    python -m deneva_tpu_torch.profile_tick --cell tpcc_occ --compiled
    python -m deneva_tpu_torch.profile_tick --cell headline_sharded4 --compiled

Runs the cell's warm-up, then times ``--ticks`` ticks with CUDA events
(no profiler attached), counting the fused kernel's launches by pack,
then counts the host syncs of the same number of ticks (torch's CUDA sync
debug mode), then traces them with ``torch.profiler`` and reports, per
tick: device time by kernel, the share and launches of the fused sort +
scan kernel, the launches of ``torch.cummax``, kernel launches, host
syncs, and the device's idle share (1 - device busy time / tick time).
``--compiled`` does the same for the ticks of ``Engine.run_compiled``,
replays of the captured phase graphs: their launches by pack are those
captured in the graphs, and the sync debug mode is "error", so a replayed
tick that synced would raise.  ``--table PATH`` writes every device
kernel of the trace.  Needs a CUDA device.

``trace_kernels`` and ``breakdown`` are also what ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` count device kernels with; ``graph_nodes``
counts the device work of one call exactly, from a CUDA graph capture.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings

import torch

from deneva_tpu_torch import cells
from deneva_tpu_torch.engine.scheduler import timed_run
from deneva_tpu_torch.ops import fused

#: kernel name of csrc/fused_sort_scan.cu
SORT_KERNELS = ("fused_sort_scan_kernel",)
#: device kernels of torch.cummax
CUMMAX_KERNELS = ("cummax", "scan_innermost_dim_with_indices",
                  "scan_outer_dim_with_indices")
#: kernel name of csrc/graph_while.cu (a WHILE body's last kernel)
WHILE_KERNELS = ("set_condition_kernel",)


def device_us(evt) -> float:
    """Self device time of one ``key_averages()`` row, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_kernels(prof) -> list:
    """The ``key_averages()`` rows of a trace that ran on the card, less
    the span the profiler's schedule puts around each recorded step."""
    return [e for e in prof.key_averages()
            if device_us(e) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]


def launches_of(kernels, names) -> int:
    """Launches of the device kernels whose name holds one of `names`."""
    return sum(e.count for e in kernels if any(k in e.key for k in names))


def trace_kernels(fn, reps: int, expect_sort=None,
                  host_calls: dict | None = None) -> list:
    """The device kernels of `reps` calls of `fn` in one torch.profiler
    trace.  On an H100 host the profiler misses the first kernel launched
    in most traces, however long after the trace's start, so the trace
    has a warm-up step: `reps` calls of `fn` with the device tracing on
    and their events thrown away, then the `reps` calls that are
    recorded.  A few traces still lose or gain kernels (a whole step's,
    or one of the warm-up's).  When `expect_sort` is given (the fused
    kernel's launches the recorded calls make, or a function that returns
    them after the calls), a trace that holds another count of the
    kernel's launches is taken again, up to ten times in all; the last
    trace is returned, and the caller checks its counts.  A `host_calls`
    dict is filled with the calls of each host op in that trace's
    recorded step (``aten::_cummax_helper``: one per torch.cummax); the
    profiler records host ops only in the step that calls them, so these
    counts are exact."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    for _ in range(10):
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _step in ("warm-up", "recorded"):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = device_kernels(prof)
        want = expect_sort() if callable(expect_sort) else expect_sort
        if want is None or launches_of(kernels, SORT_KERNELS) == want:
            break
    if host_calls is not None:
        host_calls.clear()
        host_calls.update(
            (e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU)
    return kernels


#: CUgraphNodeType values (cuda.h) of the nodes a capture of stream work
#: makes
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
               4: "graph", 5: "empty", 6: "wait_event", 7: "event_record"}


def graph_nodes(fn) -> dict:
    """The device work of one call of `fn`, counted exactly: the nodes, by
    type, of a CUDA graph captured from the call (every launch the call
    makes on the stream becomes one node; a profiler trace can lose or
    gain kernels).  `fn` must have run once outside a capture."""
    import ctypes
    from deneva_tpu_torch.engine.graph import no_collection_in_capture
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with no_collection_in_capture(), torch.cuda.graph(graph):
        fn()
    lib = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUresult {rc}")

    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(lib.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    check(lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    counts: dict = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(lib.cuGraphNodeGetType(ctypes.c_void_p(node),
                                     ctypes.byref(kind)), "cuGraphNodeGetType")
        name = _NODE_TYPES.get(kind.value, f"type {kind.value}")
        counts[name] = counts.get(name, 0) + 1
    graph.reset()
    return counts


def breakdown(kernels, reps: int) -> dict:
    """Per traced call: device busy µs, kernel launches, and the fused
    kernel's µs and launches, and the launches of torch.cummax and of the
    WHILE node's set-condition kernel."""
    sort_us = sum(device_us(e) for e in kernels
                  if any(k in e.key for k in SORT_KERNELS))
    return {
        "device_busy_us": sum(device_us(e) for e in kernels) / reps,
        "kernel_launches": sum(e.count for e in kernels) / reps,
        "fused_sort_scan_us": sort_us / reps,
        "fused_sort_scan_launches": launches_of(kernels, SORT_KERNELS) / reps,
        "cummax_launches": launches_of(kernels, CUMMAX_KERNELS) / reps,
        "while_set_launches": launches_of(kernels, WHILE_KERNELS) / reps,
    }


def host_syncs(fn, reps: int, mode: str = "warn") -> tuple[float, dict]:
    """Calls that synchronise the host with the card per call of `fn`, as
    torch's CUDA sync debug mode reports them (one warning each), in all
    and by the source line that made them.  In ``mode="error"`` a sync
    raises instead."""
    torch.cuda.set_sync_debug_mode(mode)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(reps):
                fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1 / reps
    return sum(sites.values()), sites


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deneva_tpu_torch.profile_tick")
    ap.add_argument("--cell", choices=sorted(cells.CELLS), default="headline")
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--table", default=None)
    ap.add_argument("--compiled", action="store_true",
                    help="profile the replayed ticks of run_compiled")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_tick needs a CUDA device", file=sys.stderr)
        return 2

    eng = cells.engine(cells.config(args.cell), device="cuda")
    state = eng.run(args.warmup)
    fused.reset_launches()
    state, per_tick = timed_run(eng, args.ticks, state,
                                compiled=args.compiled)
    if args.compiled:
        counted = eng.graphs.launches_of(state.host_tick - args.ticks,
                                         args.ticks)
    else:
        counted = fused.LAUNCHES_BY_PACK
    by_pack = {"x".join(map(str, k)): v / args.ticks
               for k, v in sorted(counted.items())}

    box, per_call = [state], []

    def tick():
        # a replay's launches are those its graph captured
        t, n0 = box[0].host_tick, fused.LAUNCHES
        box[0] = eng.advance(1, box[0], args.compiled)
        per_call.append(sum(eng.graphs.launches_of(t, 1).values())
                        if args.compiled else fused.LAUNCHES - n0)

    # host time to enqueue one tick (no synchronisation inside the loop)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(args.ticks):
        tick()
    host_per_tick = (time.perf_counter() - h0) / args.ticks
    torch.cuda.synchronize()

    syncs, sync_sites = host_syncs(tick, args.ticks,
                                   "error" if args.compiled else "warn")
    kernels = trace_kernels(tick, args.ticks,
                            lambda: sum(per_call[-args.ticks:]))
    eng._flush_body(box[0])

    per = breakdown(kernels, args.ticks)
    busy_us = per["device_busy_us"]
    tick_us = per_tick * 1e6
    rows = [f"  {device_us(e) / args.ticks:9.2f} us/tick  "
            f"{e.count / args.ticks:6.1f} launches/tick  {e.key}"
            for e in sorted(kernels, key=device_us, reverse=True)]
    for row in rows[:12]:
        print(row[:120])
    out = {
        "cell": args.cell, "ticks": args.ticks, "compiled": args.compiled,
        "device": torch.cuda.get_device_name(0),
        "tick_us_cuda_events": tick_us,
        "host_enqueue_us_per_tick": host_per_tick * 1e6,
        "device_idle_share": (1.0 - busy_us / tick_us) if busy_us else None,
        "fused_sort_scan_share_of_busy":
            per["fused_sort_scan_us"] / busy_us if busy_us else None,
        "host_syncs_per_tick": syncs,
        "host_sync_sites_per_tick": sync_sites,
        # columns x keys x lanes x shift -> kernel launches per timed tick
        "fused_sort_scan_launches_by_pack_per_tick": by_pack,
    }
    out.update({f"{k}_per_tick": v for k, v in per.items()})
    print(json.dumps(out))
    if args.table:
        with open(args.table, "w") as f:
            f.write("\n".join(rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
