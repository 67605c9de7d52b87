"""Where the time of one tick goes on a CUDA device.

    python -m deneva_tpu_torch.profile_tick --cell headline --ticks 50

Runs the cell's warm-up, then times ``--ticks`` ticks with CUDA events
(no profiler attached), then traces the same number of ticks with
``torch.profiler`` and reports, per tick: device time by kernel, the
share of the fused sort + scan kernel, kernel launches, and the device's
idle share (1 - device busy time / tick time).  ``--table PATH`` writes the
profiler's full table.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from deneva_tpu_torch import cells
from deneva_tpu_torch.engine.scheduler import Engine, timed_run

#: kernel names of csrc/fused_sort_scan.cu
SORT_KERNELS = ("block_sort", "global_step", "block_merge", "gather",
                "starts_scan", "carry_scan", "carry_apply")


def device_us(evt) -> float:
    """Self device time of one ``key_averages()`` row, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_kernels(prof) -> list:
    """The ``key_averages()`` rows of a trace that ran on the card."""
    return [e for e in prof.key_averages()
            if device_us(e) > 0
            and e.device_type == torch.autograd.DeviceType.CUDA]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deneva_tpu_torch.profile_tick")
    ap.add_argument("--cell", choices=sorted(cells.CELLS), default="headline")
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--table", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_tick needs a CUDA device", file=sys.stderr)
        return 2

    eng = Engine(cells.config(args.cell), device="cuda")
    state = eng.run(args.warmup)
    state, per_tick = timed_run(eng, args.ticks, state)

    # host time to enqueue one tick (no synchronisation inside the loop)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(args.ticks):
        state = eng.tick(state)
    host_per_tick = (time.perf_counter() - h0) / args.ticks
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.ticks):
            state = eng.tick(state)
        torch.cuda.synchronize()
    eng._flush_body(state)

    kernels = device_kernels(prof)
    busy_us = sum(device_us(e) for e in kernels) / args.ticks
    launches = sum(e.count for e in kernels) / args.ticks
    sort_us = sum(device_us(e) for e in kernels
                  if any(k in e.key for k in SORT_KERNELS)) / args.ticks
    tick_us = per_tick * 1e6
    top = sorted(kernels, key=device_us, reverse=True)[:12]
    for e in top:
        print(f"  {device_us(e) / args.ticks:9.2f} us/tick  "
              f"{e.count / args.ticks:6.1f} launches/tick  {e.key[:90]}")
    out = {
        "cell": args.cell, "ticks": args.ticks,
        "device": torch.cuda.get_device_name(0),
        "tick_us_cuda_events": tick_us,
        "host_enqueue_us_per_tick": host_per_tick * 1e6,
        "device_busy_us_per_tick": busy_us,
        "device_idle_share": (1.0 - busy_us / tick_us) if busy_us else None,
        "kernel_launches_per_tick": launches,
        "fused_sort_scan_us_per_tick": sort_us,
        "fused_sort_scan_share_of_busy": sort_us / busy_us if busy_us
        else None,
    }
    print(json.dumps(out))
    if args.table:
        key = ("self_device_time_total"
               if hasattr(kernels[0], "self_device_time_total")
               else "self_cuda_time_total") if kernels else None
        with open(args.table, "w") as f:
            f.write(prof.key_averages().table(sort_by=key, row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
