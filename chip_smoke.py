"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Phases, each printing one line:
  1. the card's name and power limit (nvidia-smi);
  2. the build of the fused sort + scan kernel (csrc/fused_sort_scan.cu);
  3. the kernel against its plain PyTorch version on the card, bit-equal,
     on the unit shape set and on both main-path packs, with the key shift
     of 0 and of 1, with times, its launch plan (blocks, tile, merge
     levels) and exactly 1 device kernel per call (torch.profiler);
  4. the headline cell (16M rows, B=8192, R=10, zipf 0.6, NO_WAIT,
     fused_arbitrate) on CUDA: the [summary] line, commits per tick, tick
     time from CUDA events, peak memory, and 2 kernel launches per tick
     with no fallback; then a short torch.profiler trace of the same
     ticks: 2 device launches of the kernel per tick and no cummax;
  5. the same cell on the port's CPU path: summary and data equal to a
     CUDA run of the same length, and the write-count oracle.
Then one JSON line of per-kernel numbers and the final
``{"ok": true, "device": {...}}`` line.  Any failure raises and exits
nonzero; without a CUDA device it exits nonzero before printing a result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the non-tensor-core
#: scalar rate used for the sort's integer compare operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12

HEADLINE_TICKS = 300
WINDOW_TICKS = 50
WARMUP_TICKS = 20
CPU_TICKS = 60
MAIN_N = 8192 * 10           # B * R lanes of the headline cell
#: widths 1..130 as in tests/test_fused.py, and one that is not a power of
#: two between 2 and 8 tiles of 1024 records (6 tiles: 3 merge levels)
UNIT_WIDTHS = (1, 2, 7, 64, 96, 128, 130, 6007)
TRACE_TICKS = 10


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rand_pack(n, num_keys, n_pay, seed, dev, hi=6):
    """Tie-heavy int32 keys and int32 payloads, the last payload a bool."""
    rng = np.random.default_rng(seed)
    cols = [torch.from_numpy(rng.integers(0, hi, n).astype(np.int32))
            for _ in range(num_keys)]
    cols += [torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32))
             for _ in range(max(n_pay - 1, 0))]
    if n_pay:
        cols.append(torch.from_numpy(rng.random(n) < 0.5))
    return [c.to(dev) for c in cols]


def main_path_packs(dev, seed=7):
    """The two packs one headline tick sorts, built from a seed: the lock
    sort (keykind, ts, payload) by 2 keys, with about half the lanes dead
    (their key is the dead-row sentinel, equal to INT32_MAX), and the
    unpermute (entry index, packed decision) by 1 key."""
    from deneva_tpu_torch.cc import twopl
    rng = np.random.default_rng(seed)
    B, R = 8192, 10
    live = rng.random(MAIN_N) < 0.5
    held = live & (rng.random(MAIN_N) < 0.8)
    row = np.where(live, rng.integers(0, 1 << 24, MAIN_N), twopl._DEAD_ROW)
    keykind = (row * 2 + np.where(held, 0, 1)).astype(np.int32)
    ts = np.repeat(rng.permutation(1 << 20)[:B], R).astype(np.int32)
    payload = (np.arange(MAIN_N) | (rng.integers(0, 8, MAIN_N) << 23))
    lock = [torch.from_numpy(a.astype(np.int32)).to(dev)
            for a in (keykind, ts, payload)]
    unperm = [torch.from_numpy(rng.permutation(MAIN_N).astype(np.int32))
              .to(dev),
              torch.from_numpy(rng.integers(0, 8, MAIN_N).astype(np.int32))
              .to(dev)]
    return lock, unperm


def cuda_ms(fn, reps=50, warm=5):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps=20, expect_sort=None):
    """Device time of one call of `fn` and the device kernels it runs: the
    sums over its kernels in a torch.profiler trace of `reps` calls.
    Unlike `cuda_ms`, the time leaves out the host's gaps between
    launches."""
    from deneva_tpu_torch.profile_tick import breakdown, trace_kernels
    per = breakdown(trace_kernels(fn, reps, expect_sort), reps)
    return per["device_busy_us"] / 1e3, per["kernel_launches"]


def compare(fused, cols, num_keys, shift=0):
    """Kernel against plain on the same CUDA tensors; returns the largest
    absolute difference over every output (they are integers: 0 means
    bit-equal).  Restores the launch counters it moves."""
    before = (fused.LAUNCHES, dict(fused.LAUNCHES_BY_PACK))
    got_cols, got_st, got_si = fused.fused_sort_scan(cols, num_keys, shift)
    conv = [c.to(torch.int32) for c in cols]
    want_cols, want_st, want_si = fused.fused_sort_scan_plain(
        conv, num_keys, shift)
    want_cols = [w == 1 if c.dtype == torch.bool else w
                 for w, c in zip(want_cols, cols)]
    torch.cuda.synchronize()
    fused.LAUNCHES, fused.LAUNCHES_BY_PACK = before[0], before[1]
    err = 0
    for g, w in zip(list(got_cols) + [got_st, got_si],
                    list(want_cols) + [want_st, want_si]):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"kernel output {g.dtype}{tuple(g.shape)} "
                                 f"!= plain {w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max().item()))
    return err


def bound_ms(n, n_in, num_keys):
    """Least time for the function on this card: inputs read once and
    outputs (sorted int32 columns, bool starts, int32 start index) written
    once, against n*log2(n) comparisons of num_keys+1 words."""
    bytes_ = 4 * n * (n_in + n_in + 1) + n
    ops = n * max(1.0, math.log2(n)) * (num_keys + 1)
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_gpu():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(out, flush=True)     # as nvidia-smi gives it: name, power limit
    return out


def phase_build(fused):
    t0 = time.perf_counter()
    rec = fused.build()
    say("build", f"fused_sort_scan built={rec['built']} nvcc_s="
        f"{rec['seconds']:.2f} load_s={time.perf_counter() - t0:.2f} "
        f"lib={rec['path']}")
    for line in rec["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas: " + line.strip())


def phase_kernel(fused, dev):
    # unit shape set: widths 1..6007, all-tie stability, sentinel keys,
    # bool payloads, scan outputs of the key and of the key >> 1
    errs = []
    for n in UNIT_WIDTHS:
        pack2 = rand_pack(n, 2, 3, n, dev)
        errs.append(compare(fused, pack2, 2))
        errs.append(compare(fused, pack2, 2, shift=1))
        errs.append(compare(fused, rand_pack(n, 1, 1, 100 + n, dev), 1))
    tie = [torch.zeros(37, dtype=torch.int32, device=dev),
           torch.arange(37, dtype=torch.int32, device=dev) * 3]
    errs.append(compare(fused, tie, 1))
    sent = [torch.tensor([2**31 - 1, 3, 2**31 - 1, 1, 2], dtype=torch.int32,
                         device=dev),
            torch.arange(5, dtype=torch.int32, device=dev)]
    errs.append(compare(fused, sent, 1))
    errs.append(compare(fused, sent, 1, shift=1))
    if max(errs) != 0:
        raise AssertionError(f"kernel != plain on the unit shape set: {errs}")
    say("kernel", f"unit shape set: {len(errs)} packs bit-equal, shift 0 "
        "and 1 (tolerance: exact, integer outputs)")

    lock, unperm = main_path_packs(dev)
    rows = {}
    for name, cols, nk, shift, lib_fn in (
            ("lock sort (3 columns, 2 keys)", lock, 2, 1,
             lambda: torch.sort((lock[0].to(torch.int64) << 32)
                                | lock[1].to(torch.int64), stable=True)),
            ("unpermute (2 columns, 1 key)", unperm, 1, 0,
             lambda: torch.sort(unperm[0], stable=True))):
        for sh in sorted({0, shift}):
            err = compare(fused, cols, nk, sh)
            if err != 0:
                raise AssertionError(
                    f"kernel != plain on the {name}, shift {sh}: {err}")
        plan = fused.launch_plan(nk, MAIN_N)
        before = (fused.LAUNCHES, dict(fused.LAUNCHES_BY_PACK))
        call = lambda: fused.fused_sort_scan(cols, nk, shift)
        ms = cuda_ms(call)
        dev_ms, dev_launches = device_ms(call, expect_sort=20)
        fused.LAUNCHES, fused.LAUNCHES_BY_PACK = before[0], before[1]
        if dev_launches != 1:
            raise AssertionError(f"{name}: {dev_launches} device kernels "
                                 "per call, expected 1")
        plain_ms = cuda_ms(lambda: fused.fused_sort_scan_plain(cols, nk,
                                                               shift))
        library_ms = cuda_ms(lib_fn)
        library_dev_ms, _ = device_ms(lib_fn)
        bms, by = bound_ms(MAIN_N, len(cols), nk)
        rows[(len(cols), nk)] = dict(
            err=err, ms=ms, device_ms=dev_ms, device_launches=dev_launches,
            plain_ms=plain_ms, library_ms=library_ms,
            library_device_ms=library_dev_ms, bound_ms=bms, bound_by=by)
        say("kernel", f"{name} n={MAIN_N} shift={shift}: launch plan "
            f"grid={plan['grid']} blocks x {plan['threads']} threads, tile="
            f"{plan['tile']} records ({plan['tiles']} tiles), merge "
            f"levels={plan['levels']}, chunk={plan['chunk']}")
        say("kernel", f"{name}: bit-equal, kernel {ms:.4f} ms per call "
            f"({dev_ms:.4f} ms of it on the device in {dev_launches:g} "
            f"device kernel per call, torch.profiler), plain "
            f"{plain_ms:.4f} ms, torch.sort {library_ms:.4f} ms "
            f"({library_dev_ms:.4f} ms on the device), bound {bms:.5f} ms "
            f"({by})")
    return rows


def phase_trace(eng, state):
    """A torch.profiler trace of TRACE_TICKS headline ticks: the kernel's
    device launches per tick and the cummax kernels left in the tick."""
    from deneva_tpu_torch.profile_tick import breakdown, trace_kernels
    box = [state]

    def tick():
        box[0] = eng.tick(box[0])

    per = breakdown(trace_kernels(tick, TRACE_TICKS, 2 * TRACE_TICKS),
                    TRACE_TICKS)
    say("trace", f"{TRACE_TICKS} headline ticks (torch.profiler): "
        f"{per['kernel_launches']:.1f} device launches per tick, device "
        f"busy {per['device_busy_us']:.1f} us per tick, fused kernel "
        f"{per['fused_sort_scan_launches']:g} launches per tick, cummax "
        f"kernels {per['cummax_launches']:g} per tick")
    if per["fused_sort_scan_launches"] != 2:
        raise AssertionError(f"{per['fused_sort_scan_launches']} fused "
                             "kernel launches per traced tick, expected 2")
    if per["cummax_launches"]:
        raise AssertionError("the headline tick still runs torch.cummax")


def phase_headline(cells, Engine, timed_run, fused, dev):
    cfg = cells.config("headline")
    t0 = time.perf_counter()
    eng = Engine(cfg, device=dev)
    say("headline", f"engine built in {time.perf_counter() - t0:.1f} s "
        "(query pool generated on the host)")
    state = eng.run(WARMUP_TICKS)
    before = eng.summary(state)["txn_cnt"]
    torch.cuda.reset_peak_memory_stats(dev)
    fused.reset_fallbacks()
    fused.reset_launches()
    # the timed ticks in windows, each timed with CUDA events
    window_ms = []
    for _ in range(HEADLINE_TICKS // WINDOW_TICKS):
        state, per_tick = timed_run(eng, WINDOW_TICKS, state)
        window_ms.append(per_tick * 1e3)
    launches = fused.LAUNCHES
    by_pack = dict(fused.LAUNCHES_BY_PACK)
    snap = fused.fallback_snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    s = eng.summary(state)
    commits = s["txn_cnt"] - before
    tick_ms = float(np.median(window_ms))
    print(eng.summary_line(state))
    say("headline", f"ticks={HEADLINE_TICKS} commits_per_tick="
        f"{commits / HEADLINE_TICKS} tick_ms median={tick_ms:.4f} "
        f"min={min(window_ms):.4f} max={max(window_ms):.4f} over "
        f"{len(window_ms)} windows of {WINDOW_TICKS} ticks (cuda events) "
        f"committed_txn_per_s={commits / HEADLINE_TICKS / tick_ms * 1e3:.1f}"
        f" abort_rate={s['abort_rate']:.6f} peak_mem_mb={peak / 2**20:.1f}")
    say("headline", f"kernel launches={launches} by pack={by_pack} "
        f"fallbacks={snap['count']}")
    if launches != 2 * HEADLINE_TICKS:
        raise AssertionError(f"expected {2 * HEADLINE_TICKS} kernel "
                             f"launches, counted {launches}")
    if snap["count"] != 0:
        raise AssertionError(f"fused sort fell back: {snap}")
    if int(state.data.sum().item()) != s["write_cnt"]:
        raise AssertionError("data.sum() != write_cnt on the CUDA run")
    if not s["txn_cnt"] > 0 or not math.isfinite(tick_ms):
        raise AssertionError("the headline run committed nothing")
    phase_trace(eng, state)
    return by_pack


def phase_cpu_match(cells, Engine, dev):
    cfg = cells.config("headline")
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    sg = gpu.run(CPU_TICKS)
    t0 = time.perf_counter()
    sc = cpu.run(CPU_TICKS)
    cpu_s = time.perf_counter() - t0
    a, b = gpu.summary(sg), cpu.summary(sc)
    diff = {k: (a[k], b.get(k)) for k in a
            if k != "ccl_samples" and a[k] != b.get(k)}
    if diff or a != b:
        raise AssertionError(f"CUDA and CPU summaries differ: {diff}")
    if not torch.equal(sg.data.cpu(), sc.data):
        raise AssertionError("CUDA and CPU data tables differ")
    if int(sc.data.sum().item()) != b["write_cnt"]:
        raise AssertionError("data.sum() != write_cnt on the CPU run")
    say("cpu", f"{CPU_TICKS} ticks: CUDA and CPU summary dicts and data "
        f"equal (txn_cnt={b['txn_cnt']}, write_cnt={b['write_cnt']}); "
        f"CPU run {cpu_s:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2

    from deneva_tpu_torch import cells
    from deneva_tpu_torch.engine.scheduler import Engine, timed_run
    from deneva_tpu_torch.ops import fused

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    phase_gpu()
    phase_build(fused)
    rows = phase_kernel(fused, dev)
    by_pack = phase_headline(cells, Engine, timed_run, fused, dev)
    phase_cpu_match(cells, Engine, dev)

    kernels = []
    for (n_in, nk), name in (((3, 2), "fused_sort_scan[lock sort 3x2]"),
                             ((2, 1), "fused_sort_scan[unpermute 2x1]")):
        r = rows[(n_in, nk)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deneva_tpu_torch/csrc/fused_sort_scan.cu",
            "replaces": "deneva_tpu/ops/fused.py:122",
            "launches": by_pack.get((n_in, nk), 0),
            "device_launches_per_call": r["device_launches"],
            "device_ms": r["device_ms"],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    say("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
