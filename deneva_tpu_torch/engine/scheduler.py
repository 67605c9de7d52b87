"""The batched scheduler tick, in PyTorch: the rebuild of the reference's
worker loop (system/worker_thread.cpp:183-275) for every in-flight txn at
once.  One tick:

  1. wakes aborted txns whose backoff expired (abort_queue.cpp:26-82);
  2. admits new txns into free slots from the query pool and draws their
     timestamps (worker_thread.cpp:460-517); under CALVIN at most
     ``epoch_size`` per tick, PPS's recon types deferred one epoch;
  3. commits txns that finished their access program, appending their
     writes to a deferred write ring (txn.cpp:487-554);
  4. runs the CC access kernel for every txn's current access;
  5. sends aborted txns to exponential backoff (worker_thread.cpp:160-171).

With ``commit_after_access`` the commit block (3) runs after the access
block (4), on the freshly advanced cursors, so a txn commits in the tick
its last access grants, and its validation aborts go to backoff after
both blocks.

This is the port of ``deneva_tpu/engine/scheduler.py`` for one slice:
YCSB, TPC-C or PPS under NO_WAIT, WAIT_DIE, TIMESTAMP, MVCC, CALVIN, OCC
or MAAT, single shard, NORMAL mode, commit before or after access, at any
isolation level (NO_WAIT and WAIT_DIE read it), with ``sub_ticks``
(NO_WAIT, WAIT_DIE, TIMESTAMP), ``dense_lock_state`` (NO_WAIT, WAIT_DIE),
live-entry compaction (``compact_auto``, ``compact_lanes``),
``fused_arbitrate`` and ``pipeline_exchange`` on or off and every other
opt-in flag off.  ``check_slice`` refuses
anything else; its single-shard rule also covers the JAX engine's ``part_cnt == 1``
assertion for a workload with commit effects.  Every observatory hook of
the reference tick is a no-op at those flags and is left out.

PyTorch runs eagerly, so the tick is a plain function that updates the
state's counters, rings and workload tables in place (each in-place site
says so).  The tick count and the warm-up gate live on the device, as in
the reference; the engine never reads a device value on the host.
``Engine.run`` launches every op of every tick from Python.  There, a
YCSB tick syncs the device nowhere, TPC-C's and PPS's commit effects
read one scalar per tick on the host (their compact/full choice), and
OCC's validation fixed point and MAAT's commit chain read their flag
once per pass (``ops/device_loop.py``).  ``Engine.run_compiled`` runs the
tick made with ``on_device``, which reads nothing on the host (the
full-width effect body on every tick): on CUDA as a CUDA graph per flush
phase, replayed with no host read, each loop a WHILE node of the graph
(``engine/graph.py``); on the CPU in a host loop, where the loops still
read their flag.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from deneva_tpu_torch import cc as cc_registry
from deneva_tpu_torch import workloads as wl_registry
from deneva_tpu_torch.config import (
    CALVIN, MAAT, MODE_NORMAL, MVCC, NO_WAIT, OCC, PPS, SERIALIZABLE,
    TIMESTAMP, TPCC, WAIT_DIE, YCSB, Config, optin_flags,
)
from deneva_tpu_torch.device import resolve_device
from deneva_tpu_torch.engine.state import (
    NULL_KEY, STATUS_BACKOFF, STATUS_FREE, STATUS_RUNNING, STATUS_WAITING,
    TxnState,
)
from deneva_tpu_torch.ops import segment as seg
from deneva_tpu_torch.workloads.base import QueryPool

I32 = torch.int32
F32 = torch.float32
I64 = torch.int64

#: empty write-ring cell (the reference's out-of-bounds scatter sentinel)
NULL_ROW = NULL_KEY

#: the write ring is flushed into the data table every this many ticks.
#: The reference flushes by a data-dependent ``lax.cond`` at 3/4
#: occupancy; reading that condition here would sync the device every
#: tick.  The flush is invisible to the result (the increments are blind
#: and ``data`` is read only after ``_flush_body``).  A slot commits at most
#: once a tick, whether the commit block runs before or after the access
#: block (``commit_after_access``), so a tick appends at most B of the
#: ring's 4B rows and a fixed flush every 3 ticks (3B rows) never
#: overflows it.
FLUSH_EVERY = 3


class EngineState(NamedTuple):
    txn: TxnState
    db: dict                   # CC-plugin tensors (per-row and per-slot)
    data: torch.Tensor         # (n_rows,) int32 row payload (increment oracle)
    tables: dict               # workload tables ({} for YCSB)
    stats: dict                # counters and rings
    tick: torch.Tensor         # () int32
    pool_cursor: torch.Tensor  # () int32
    ts_counter: torch.Tensor   # () int32
    #: the host's copy of ``tick``, which picks the flush phase (the tick
    #: count does not depend on the data)
    host_tick: int = 0


STAT_KEYS_I32 = (
    "txn_cnt", "total_txn_abort_cnt", "unique_txn_abort_cnt",
    "local_txn_start_cnt", "twopl_wait_cnt", "write_cnt", "user_abort_cnt",
    "vabort_cnt", "recon_cnt", "parts_touched", "multi_part_txn_cnt",
    "measured_ticks", "invariant_violation_cnt",
)
STAT_KEYS_F32 = (
    "txn_run_time_ticks", "txn_total_time_ticks", "lat_process_time",
    "lat_cc_block_time", "lat_abort_time", "lat_network_time",
)

#: commit-latency sampling ring depth (StatsArr, stats_array.cpp)
LAT_SAMPLES = 1 << 14


#: opt-in flags the slice admits: the fused kernel, the single-shard leg
#: of ``pipeline_exchange`` (whose values equal the in-order sub-rounds'),
#: and live-entry compaction (``compact_auto``, ``compact_lanes``)
ADMITTED_OPTINS = ("fused_arbitrate", "pipeline_exchange", "compact_auto",
                   "compact_lanes")


def refuse_outside(cfg: Config, slice_: str, algs, workloads, optins,
                   node_rule: str | None, levels=None, at=()) -> None:
    """Raise NotImplementedError naming every setting of `cfg` outside a
    ported slice (described by `slice_` in the message): a plugin not in
    `algs`, a workload not in `workloads`, an isolation level not in
    `levels` (None admits any), a mode other than NORMAL, the node rule's
    complaint `node_rule` (None when the layout is admitted), a field of
    the ``(name, value)`` pairs `at` at another value, and an opt-in flag
    not in `optins` off its default."""
    bad = []
    if cfg.cc_alg not in algs:
        bad.append(f"cc_alg={cfg.cc_alg}")
    if cfg.workload not in workloads:
        bad.append(f"workload={cfg.workload}")
    if levels is not None and cfg.isolation_level not in levels:
        bad.append(f"isolation_level={cfg.isolation_level}")
    if cfg.mode != MODE_NORMAL:
        bad.append(f"mode={cfg.mode}")
    if node_rule:
        bad.append(node_rule)
    bad += [f"{name}={getattr(cfg, name)}" for name, value in at
            if getattr(cfg, name) != value]
    bad += [name for name, flag in optin_flags().items()
            if name not in optins and getattr(cfg, name) != flag.default]
    if bad:
        raise NotImplementedError(f"outside the ported slice{slice_}: "
                                  + ", ".join(bad))


def check_slice(cfg: Config) -> None:
    """Raise NotImplementedError for a config outside the ported slice."""
    single = cfg.node_cnt == 1 and cfg.part_cnt == 1
    refuse_outside(
        cfg, " (YCSB, TPC-C or PPS under NO_WAIT, WAIT_DIE, TIMESTAMP, "
        "MVCC, CALVIN, OCC or MAAT, single shard, NORMAL mode; "
        "commit_after_access, any isolation_level, sub_ticks, "
        "dense_lock_state, compact_auto, compact_lanes, fused_arbitrate "
        "and pipeline_exchange, every other flag at its default)",
        (NO_WAIT, WAIT_DIE, TIMESTAMP, MVCC, CALVIN, OCC, MAAT),
        (YCSB, TPCC, PPS), ADMITTED_OPTINS,
        None if single else
        f"node_cnt={cfg.node_cnt}, part_cnt={cfg.part_cnt} (more than one "
        "node runs on deneva_tpu_torch.parallel.sharded.ShardedEngine)")


#: opt-in flags the sharded slice admits (``check_sharded_slice``)
SHARDED_ADMITTED_OPTINS = ("fused_arbitrate",)


def check_sharded_slice(cfg: Config) -> None:
    """Raise NotImplementedError for a config outside the ported slice of
    the sharded engine: NO_WAIT, WAIT_DIE, TIMESTAMP or MVCC (the plugins
    with no sharded hook, which run unchanged on the owner's virtual
    txns) on YCSB at SERIALIZABLE in NORMAL mode,
    ``node_cnt == part_cnt`` in 1..8, ``fused_arbitrate`` on or off, and
    the plain knobs (``acquire_window``, ``route_capacity_factor``,
    ``part_per_txn``, ``mpr``, ``strict_ppt``, ``first_part_local``,
    ``backoff``, ``admit_cap``, sizes and penalties); every other flag at
    its default."""
    layout = cfg.node_cnt == cfg.part_cnt and 1 <= cfg.node_cnt <= 8
    refuse_outside(
        cfg, " of the sharded engine (NO_WAIT, WAIT_DIE, TIMESTAMP or MVCC "
        "on YCSB, SERIALIZABLE, NORMAL mode, node_cnt == part_cnt in 1..8, "
        "fused_arbitrate, every other flag at its default)",
        (NO_WAIT, WAIT_DIE, TIMESTAMP, MVCC), (YCSB,),
        SHARDED_ADMITTED_OPTINS,
        None if layout else
        f"node_cnt={cfg.node_cnt}, part_cnt={cfg.part_cnt}",
        levels=(SERIALIZABLE,),
        at=(("repl_mode", "aa"), ("commit_after_access", False),
            ("sub_ticks", 1), ("dense_lock_state", False),
            ("restart_new_ts", False)))


def penalty_ticks(cfg: Config, restarts: torch.Tensor) -> torch.Tensor:
    """Abort penalty of a txn with `restarts` restarts: exponential
    backoff capped at ``abort_penalty_max_ticks``, or the flat penalty
    (abort_queue.cpp:26-82)."""
    if not cfg.backoff:
        return torch.full_like(restarts, cfg.abort_penalty_ticks)
    shift = torch.clamp(restarts, max=16)
    return torch.clamp(
        cfg.abort_penalty_ticks * (torch.ones_like(shift) << shift),
        max=cfg.abort_penalty_max_ticks)


def _zeros_stats(B: int, R: int, device, write_ring: bool = True) -> dict:
    """Counters and rings at default flags.  Rings that take dropped lanes
    carry B scratch cells past their end (see the scatter sites).  The
    sharded engine applies its writes at the owners and keeps no write
    ring (``write_ring=False``)."""
    z = lambda dt: torch.zeros((), dtype=dt, device=device)
    s = {k: z(I32) for k in STAT_KEYS_I32}
    s.update({k: z(F32) for k in STAT_KEYS_F32})
    s["arr_lat_short"] = torch.zeros(LAT_SAMPLES + B, dtype=I32,
                                     device=device)
    s["lat_ring_cursor"] = z(I32)
    if not write_ring:
        return s
    # committed-write ring: one (R,) row per committing txn, 4B rows plus
    # B scratch rows for non-writing lanes
    s["arr_wr_ring"] = torch.full((5 * B, R), NULL_ROW, dtype=I32,
                                  device=device)
    s["wr_ring_cursor"] = z(I32)
    return s


def _pool_to_device(pool: QueryPool, device) -> dict:
    """Pack the host pool for the admission fetch: per-access fields into
    one (Q, R) int32 (key*2+iw, -1 for padding), per-txn scalars into one
    (Q,) int32; args/aux only when the workload uses them."""
    assert pool.max_req < 256 and int(pool.txn_type.max()) < 256
    kw = np.where(pool.keys == np.int32(2**31 - 1), np.int64(-1),
                  pool.keys.astype(np.int64) * 2 + pool.is_write)
    meta = (pool.n_req.astype(np.int64)
            | (pool.txn_type.astype(np.int64) << 8)).astype(np.int32)
    out = {"kw": torch.from_numpy(kw.astype(np.int32)).to(device),
           "meta": torch.from_numpy(meta).to(device)}
    if pool.args.any():
        out["args"] = torch.from_numpy(pool.args).to(device)
    if pool.aux.any():
        out["aux"] = torch.from_numpy(pool.aux).to(device)
    return out


def pool_admit(pool_dev: dict, txn: TxnState, admit, frank, pool_cursor,
               cap: int, Q: int):
    """Fetch pool rows [cursor, cursor+cap) and place them in the admitted
    slots: rank k goes to the k-th free slot.  The reference scatters the
    block into the slots; here each admitted slot gathers its block row
    (admitted ranks are distinct and below cap), which writes the same
    values with no duplicate-index hazard."""
    dev = txn.keys.device
    bidx = (pool_cursor + torch.arange(cap, dtype=I32, device=dev)) % Q
    blk_kw = pool_dev["kw"][bidx.to(I64)]              # (cap, R)
    blk_meta = pool_dev["meta"][bidx.to(I64)]          # (cap,)
    blk_keys = torch.where(blk_kw < 0, NULL_KEY, blk_kw >> 1)
    blk_iw = (blk_kw >= 0) & ((blk_kw & 1) == 1)

    r = torch.where(admit, frank, 0).to(I64)
    a2 = admit[:, None]
    keys = torch.where(a2, blk_keys[r], txn.keys)
    is_write = torch.where(a2, blk_iw[r], txn.is_write)
    n_req = torch.where(admit, blk_meta[r] & 0xFF, txn.n_req)
    txn_type = torch.where(admit, (blk_meta[r] >> 8) & 0xFF, txn.txn_type)
    pool_idx = torch.where(admit, bidx[r], txn.pool_idx)
    targs = txn.targs
    if "args" in pool_dev:
        targs = torch.where(a2, pool_dev["args"][bidx.to(I64)][r], targs)
    aux = txn.aux
    if "aux" in pool_dev:
        aux = torch.where(a2, pool_dev["aux"][bidx.to(I64)][r], aux)
    return keys, is_write, n_req, txn_type, targs, aux, pool_idx


def recon_defer(stats: dict, workload, txn_type, free, status,
                backoff_until, t, measuring):
    """Calvin's reconnaissance deferral (sequencer.cpp:88-114): fresh
    admissions of a recon type sleep one epoch, during which their shadow
    read requests reach the rows.  Returns (status, backoff_until,
    stats)."""
    is_recon = torch.zeros_like(free)
    for tt in workload.recon_types:
        is_recon = is_recon | (txn_type == tt)
    is_recon = free & is_recon
    status = torch.where(is_recon, STATUS_BACKOFF, status)
    backoff_until = torch.where(is_recon, t + 1, backoff_until)
    stats = bump(stats, "recon_cnt", is_recon.sum(dtype=I32), measuring)
    return status, backoff_until, stats


def bump(stats: dict, key: str, amount, measuring) -> dict:
    """Warmup-gated counter increment (INC_STATS + is_warmup_done,
    system/helper.h:136-150), in place: ``where(measuring, amount, 0)``
    cast to the counter's dtype, as the reference adds it (a float32
    counter adds the int32 amount converted to float32)."""
    stats[key].add_(torch.where(measuring, amount, 0).to(stats[key].dtype))
    return stats


def record_commit_latency(stats: dict, commit, t, start_tick,
                          measuring) -> dict:
    """Append committing txns' short latencies to the sampling ring,
    keeping the last LAT_SAMPLES commits under wrap; nothing is recorded
    while not ``measuring`` (the lanes and the cursor add are masked).
    Recorded lanes land on distinct ring cells and the rest on distinct
    scratch cells past LAT_SAMPLES, so the in-place ``index_copy_`` never
    sees a duplicate index."""
    c = commit.to(I32)
    crank = torch.cumsum(c, 0, dtype=I32) - c
    n_commit = c.sum(dtype=I32)
    rec = commit & measuring & (crank >= n_commit - LAT_SAMPLES)
    lanes = torch.arange(commit.shape[0], dtype=I32, device=commit.device)
    pos = torch.where(rec, (stats["lat_ring_cursor"] + crank) % LAT_SAMPLES,
                      LAT_SAMPLES + lanes)
    stats["arr_lat_short"].index_copy_(0, pos.to(I64), t - start_tick)
    stats["lat_ring_cursor"].add_(torch.where(measuring, n_commit, 0))
    return stats


def track_parts_touched(stats: dict, commit, measuring, txn=None,
                        n_parts: int = 1) -> dict:
    """Distinct-partition counters per commit (partitions_touched,
    system/query.h): one partition each on one partition; with
    ``n_parts`` > 1 (the sharded engine, up to 31 partitions) the
    distinct partitions of each committing txn's accesses, and the
    commits that touch more than one.  The partitions of a txn are
    counted by an order-free scatter-max of its access mask into
    ``(B, n_parts)`` cells."""
    if n_parts <= 1 or n_parts > 31:
        return bump(stats, "parts_touched", commit.sum(dtype=I32), measuring)
    B, R = txn.keys.shape
    ridx = torch.arange(R, dtype=I32, device=commit.device)[None, :]
    amask = (ridx < txn.n_req[:, None]).to(I32)
    touched = torch.zeros((B, n_parts), dtype=I32, device=commit.device) \
        .scatter_reduce_(1, (txn.keys % n_parts).to(I64), amask, "amax")
    npart = touched.sum(dim=1, dtype=I32)
    stats = bump(stats, "parts_touched",
                 torch.where(commit, npart, 0).sum(dtype=I32), measuring)
    return bump(stats, "multi_part_txn_cnt",
                (commit & (npart > 1)).sum(dtype=I32), measuring)


def track_state_latencies(stats: dict, txn: TxnState, measuring) -> dict:
    """End-of-tick latency decomposition integrals (stats.cpp:992-999)."""
    for key, st_v in (("lat_process_time", STATUS_RUNNING),
                      ("lat_cc_block_time", STATUS_WAITING),
                      ("lat_abort_time", STATUS_BACKOFF)):
        stats = bump(stats, key, (txn.status == st_v).sum(dtype=I32),
                     measuring)
    return stats


def flush_write_ring(data: torch.Tensor, stats: dict) -> None:
    """Apply the write ring to the data table and empty it, in place.
    Increments are int32 ``index_add_`` (exact in any order); empty cells
    add 0 at a row spread by lane, so they never pile onto one row."""
    n_rows = data.shape[0]
    B = stats["arr_wr_ring"].shape[0] // 5
    cells = stats["arr_wr_ring"][:4 * B].reshape(-1)
    valid = cells != NULL_ROW
    spread = torch.arange(cells.shape[0], dtype=I32,
                          device=cells.device) % n_rows
    data.index_add_(0, torch.where(valid, cells, spread).to(I64),
                    valid.to(I32))
    stats["arr_wr_ring"].fill_(NULL_ROW)
    stats["wr_ring_cursor"].zero_()


def make_tick(cfg: Config, plugin, pool_dev: dict, workload,
              on_device: bool = False):
    """The tick function of the slice; ``on_device`` makes the workload's
    effect branch on the device, so the tick reads nothing on the host."""
    check_slice(cfg)
    Q = pool_dev["kw"].shape[0]
    redraw = plugin.new_ts_on_restart or cfg.restart_new_ts
    recon = plugin.epoch_admission and bool(workload.recon_types)
    REBASE_AT, REBASE_BY = 3 << 29, 1 << 30

    def tick_fn(state: EngineState) -> EngineState:
        txn, db, data, stats = state.txn, state.db, state.data, state.stats
        t = state.tick
        measuring = t >= cfg.warmup_ticks      # () bool on the device
        B, R = txn.keys.shape
        dev = data.device
        ridx = torch.arange(R, dtype=I32, device=dev)[None, :]

        # ---- 1. backoff expiry: restart aborted txns ----
        expire = (txn.status == STATUS_BACKOFF) & (txn.backoff_until <= t)
        status = torch.where(expire, STATUS_RUNNING, txn.status)
        start_tick = torch.where(expire, t, txn.start_tick)

        # ---- 2. admission from the query pool ----
        free = status == STATUS_FREE
        cap = cfg.admit_cap if cfg.admit_cap is not None else cfg.batch_size
        frank = torch.cumsum(free, 0, dtype=I32) - free.to(I32)
        gate = frank
        if plugin.epoch_admission:
            # the sequencer's batch release: at most epoch_size txns per
            # epoch, of which resumed (recon) txns take their share.  Only
            # the cap comparison is offset: frank stays the admitted rank
            # that pool_admit maps onto pool rows
            cap = min(cap, cfg.epoch_size)
            gate = frank + expire.sum(dtype=I32)
        cap = min(cap, cfg.batch_size, Q)
        free = free & (gate < cap)
        n_free = free.sum(dtype=I32)

        keys, is_write, n_req, txn_type, targs, aux, pool_idx = pool_admit(
            pool_dev, txn, free, frank, state.pool_cursor, cap, Q)

        # timestamps: fresh txns always; restarted txns iff the algorithm
        # re-draws per attempt (worker_thread.cpp:492-495)
        need_ts = free | expire if redraw else free
        trank = torch.cumsum(need_ts, 0, dtype=I32) - need_ts.to(I32)
        ts = torch.where(need_ts, state.ts_counter + trank, txn.ts)
        ts_counter = state.ts_counter + need_ts.sum(dtype=I32)

        status = torch.where(free, STATUS_RUNNING, status)
        cursor = torch.where(free, 0, txn.cursor)
        restarts = torch.where(free, 0, txn.restarts)
        start_tick = torch.where(free, t, start_tick)
        first_start_tick = torch.where(free, t, txn.first_start_tick)
        stats = bump(stats, "local_txn_start_cnt", n_free, measuring)

        backoff_until = txn.backoff_until
        if recon:
            status, backoff_until, stats = recon_defer(
                stats, workload, txn_type, free, status, backoff_until, t,
                measuring)

        txn = TxnState(status=status, cursor=cursor, ts=ts,
                       pool_idx=pool_idx, restarts=restarts,
                       backoff_until=backoff_until,
                       start_tick=start_tick,
                       first_start_tick=first_start_tick, keys=keys,
                       is_write=is_write, n_req=n_req, txn_type=txn_type,
                       targs=targs, aux=aux)
        db = plugin.on_start(cfg, db, txn, free | expire)

        # ---- 3/4. the commit and access phases, in the order of
        # cfg.commit_after_access ----

        def commit_block(txn, db, data, tables, stats):
            """Commit the txns that finished their access program: validate,
            append their writes to the ring, apply their effects.  Returns
            the txn slots (committed and user-aborted ones freed) and the
            commit, validation-abort and user-abort masks."""
            finishing = (txn.status == STATUS_RUNNING) \
                & (txn.cursor >= txn.n_req)
            ua = workload.user_abort(cfg, txn, finishing)
            finishing = finishing & ~ua
            ok, db = plugin.validate(cfg, db, txn, finishing, t)
            commit = finishing & ok
            vabort = finishing & ~ok
            db = plugin.on_commit(cfg, db, txn, commit, commit_ts=txn.ts,
                                  tick=t)

            wmask = commit[:, None] & txn.is_write \
                & (ridx < txn.n_req[:, None])
            # append committed write keys to the ring, one row per writing
            # txn at its commit rank; other lanes go to distinct scratch
            # rows past 4B, so the in-place index_copy_ sees no duplicate
            # index
            ring = stats["arr_wr_ring"]
            writing = commit & wmask.any(dim=1)
            wrank = torch.cumsum(writing, 0, dtype=I32) - writing.to(I32)
            lanes = torch.arange(B, dtype=I32, device=dev)
            rowpos = torch.where(writing, stats["wr_ring_cursor"] + wrank,
                                 4 * B + lanes)
            ring.index_copy_(0, rowpos.to(I64),
                             torch.where(wmask, txn.keys, NULL_ROW))
            stats["wr_ring_cursor"].add_(writing.sum(dtype=I32))

            if workload.has_effects:
                # commit effects on the flattened (B*R,) entries, ordered
                # within the tick by the commit timestamp: the plugin's
                # commit_ts_field (MaaT's find_bound lower, which ties
                # across txns: the effect sorts are stable, so ties go by
                # lane), else txn.ts; keys are shard-local on the single
                # shard.  The tables are updated in place.
                cts = db[plugin.commit_ts_field] if plugin.commit_ts_field \
                    else txn.ts
                flds = workload.commit_fields(cfg, tables, txn, commit)
                nmask = commit[:, None] & (ridx < txn.n_req[:, None])
                tables = workload.apply_commit_entries(
                    cfg, tables, txn.keys.reshape(-1), 0,
                    {k: v.reshape(-1) for k, v in flds.items()},
                    cts[:, None].expand(B, R).reshape(-1),
                    nmask.reshape(-1), on_device=on_device)

            stats = bump(stats, "txn_cnt", commit.sum(dtype=I32), measuring)
            stats = bump(stats, "write_cnt", wmask.sum(dtype=I32), measuring)
            stats = bump(stats, "vabort_cnt", vabort.sum(dtype=I32),
                         measuring)
            stats = track_parts_touched(stats, commit, measuring)
            stats = record_commit_latency(stats, commit, t, txn.start_tick,
                                          measuring)
            stats = bump(stats, "unique_txn_abort_cnt",
                         (commit & (txn.restarts > 0)).sum(dtype=I32),
                         measuring)
            stats = bump(stats, "txn_run_time_ticks",
                         torch.where(commit, t - txn.start_tick, 0)
                         .sum(dtype=I32), measuring)
            stats = bump(stats, "txn_total_time_ticks",
                         torch.where(commit, t - txn.first_start_tick, 0)
                         .sum(dtype=I32), measuring)
            stats = bump(stats, "user_abort_cnt", ua.sum(dtype=I32),
                         measuring)
            txn = txn._replace(status=torch.where(commit | ua, STATUS_FREE,
                                                  txn.status))
            return txn, db, data, tables, stats, commit, vabort, ua

        def backoff(txn, stats, abort):
            """Send the `abort` txns to exponential backoff
            (abort_queue.cpp:26-82), counting them."""
            stats = bump(stats, "total_txn_abort_cnt", abort.sum(dtype=I32),
                         measuring)
            return txn._replace(
                status=torch.where(abort, STATUS_BACKOFF, txn.status),
                cursor=torch.where(abort, 0, txn.cursor),
                backoff_until=torch.where(
                    abort, t + penalty_ticks(cfg, txn.restarts),
                    txn.backoff_until),
                restarts=torch.where(abort, txn.restarts + 1,
                                     txn.restarts)), stats

        def access_block(txn, db, stats, vabort):
            """The CC access kernel for every txn's current access, then
            backoff for its aborts and for `vabort`, the validation aborts
            of a commit block that ran before it (all false when the
            commit block runs after it)."""
            active = ((txn.status == STATUS_RUNNING)
                      | (txn.status == STATUS_WAITING)) & ~vabort
            has_req = active & (txn.cursor < txn.n_req)
            acc_active, acc_txn = active, txn
            if recon:
                # Calvin's recon lock traffic (sequencer.cpp:88-114):
                # deferred recon txns request their footprint read-only
                # this epoch.  Their decisions are dropped (has_req and the
                # cursor advance below use the real txn), while their
                # entries block others
                shadow = (txn.status == STATUS_BACKOFF) \
                    & (txn.backoff_until > t)
                acc_active = active | shadow
                acc_txn = txn._replace(
                    is_write=txn.is_write & ~shadow[:, None])
            dec, db = plugin.access(cfg, db, acc_txn, acc_active)

            # advance over the granted prefix; the outcome is the decision
            # at the first non-granted requested access
            okm = dec.grant | (ridx < txn.cursor[:, None]) \
                | (ridx >= txn.n_req[:, None])
            prefix = torch.cumprod(okm.to(I32), dim=1, dtype=I32)
            new_cursor = torch.minimum(prefix.sum(dim=1, dtype=I32),
                                       txn.n_req)
            fail_pos = torch.clamp(new_cursor, max=R - 1)[:, None]
            at_fail = lambda m: (m & (ridx == fail_pos)).any(dim=1)
            blocked = has_req & (new_cursor < txn.n_req)
            wait = blocked & at_fail(dec.wait)
            abort_now = (blocked & at_fail(dec.abort)) | vabort

            cursor = torch.where(has_req & ~abort_now, new_cursor,
                                 txn.cursor)
            status = torch.where(has_req & (new_cursor > txn.cursor),
                                 STATUS_RUNNING, txn.status)
            status = torch.where(wait, STATUS_WAITING, status)
            stats = bump(stats, "twopl_wait_cnt", wait.sum(dtype=I32),
                         measuring)
            txn, stats = backoff(txn._replace(status=status, cursor=cursor),
                                 stats, abort_now)
            return txn, db, stats, abort_now

        tables = state.tables
        if not cfg.commit_after_access:
            # commit first: a txn commits the tick after its last access
            # grants; its validation aborts go to backoff with the access
            # phase's aborts (abort_now includes vabort)
            txn, db, data, tables, stats, commit, vabort, ua = commit_block(
                txn, db, data, tables, stats)
            txn, db, stats, abort_now = access_block(txn, db, stats, vabort)
        else:
            # commit after access (reference scheduler.py:984-1002): the
            # commit block runs on the freshly advanced cursors, so a txn
            # commits in the tick its last access grants; its validation
            # aborts go to backoff after both blocks, counted once
            txn, db, stats, abort_now = access_block(
                txn, db, stats, torch.zeros_like(free))
            txn, db, data, tables, stats, commit, vabort, ua = commit_block(
                txn, db, data, tables, stats)
            txn, stats = backoff(txn, stats, vabort)
        db = plugin.on_abort(cfg, db, txn, abort_now | vabort | ua)

        stats = track_state_latencies(stats, txn, measuring)

        # ts wraparound guard: rebase every timestamp once the counter
        # passes 3 * 2^29.  The reference guards it with a data-dependent
        # lax.cond; here it is an unconditional select (plugins get a zero
        # shift on ticks that do not rebase), so no tick syncs the device
        rebase = ts_counter > REBASE_AT
        txn = txn._replace(ts=torch.where(
            rebase, torch.clamp(txn.ts - REBASE_BY, min=1), txn.ts))
        db = plugin.on_ts_rebase(cfg, db, torch.where(rebase, REBASE_BY, 0))
        ts_counter = torch.where(rebase, ts_counter - REBASE_BY, ts_counter)

        # static flush schedule of the write ring (see FLUSH_EVERY), by
        # the host's copy of the tick count
        if (state.host_tick + 1) % FLUSH_EVERY == 0:
            flush_write_ring(data, stats)

        stats = bump(stats, "measured_ticks", 1, measuring)
        return EngineState(txn=txn, db=db, data=data, tables=tables,
                           stats=stats, tick=t + 1,
                           pool_cursor=(state.pool_cursor + n_free) % Q,
                           ts_counter=ts_counter,
                           host_tick=state.host_tick + 1)

    if not cfg.fused_arbitrate:
        return tick_fn

    # fused-arbitration dispatch: every eligible sort of the tick goes
    # through the fused kernel (ops/fused.py, ops/segment.py sort_pack)
    def tick_fused(state: EngineState) -> EngineState:
        with seg.fused_scope(cfg):
            return tick_fn(state)

    return tick_fused


class Engine:
    """Single-shard scheduler on one device.  ``device`` defaults to CUDA;
    pass ``device="cpu"`` to run on the host."""

    #: the tick's CUDA graphs, one per flush phase of the write ring
    graph_phases = FLUSH_EVERY

    #: the check that refuses a config outside the engine's slice
    check = staticmethod(check_slice)

    def __init__(self, cfg: Config, pool: QueryPool | None = None,
                 device="cuda"):
        self.check(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plugin = cc_registry.get(cfg.cc_alg)
        self.workload = wl_registry.get(cfg)
        if pool is None:
            pool = self.workload.gen_pool(cfg)
        self.pool = pool
        self.n_rows = self.workload.cc_rows(cfg)
        self.workload.init_counters(self.device)
        #: the eager tick, and the host-read-free tick of run_compiled
        self._tick_fns = self._make_ticks()
        #: the captured phase graphs of ``run_compiled`` on CUDA
        self.graphs = None

    def _make_ticks(self) -> dict:
        """Put the query pool on the device (``pool_dev``) and return the
        tick by ``compiled``."""
        self.pool_dev = _pool_to_device(self.pool, self.device)
        return {c: make_tick(self.cfg, self.plugin, self.pool_dev,
                             self.workload, on_device=c)
                for c in (False, True)}

    def init_state(self) -> EngineState:
        cfg, dev = self.cfg, self.device
        B, R = cfg.batch_size, self.pool.max_req
        return EngineState(
            txn=TxnState.empty(B, R, A=self.pool.args.shape[1], device=dev),
            db=self.plugin.init_db(cfg, self.n_rows, B, R, device=dev),
            data=torch.zeros(self.n_rows, dtype=I32, device=dev),
            tables=self.workload.init_tables(cfg, 0, device=dev),
            stats=_zeros_stats(B, R, dev),
            tick=torch.zeros((), dtype=I32, device=dev),
            pool_cursor=torch.zeros((), dtype=I32, device=dev),
            ts_counter=torch.ones((), dtype=I32, device=dev),
        )

    def tick(self, state: EngineState, compiled: bool = False
             ) -> EngineState:
        """One tick, without the end-of-run flush: eager, or the tick that
        ``run_compiled`` runs, with no host read (``compiled``)."""
        return self._tick_fns[compiled](state)

    def run(self, n_ticks: int, state: EngineState | None = None
            ) -> EngineState:
        """Run n_ticks ticks, then flush the write ring.  The state's
        tensors are updated in place where the tick says so."""
        if state is None:
            state = self.init_state()
        return self._flush_body(self.advance(n_ticks, state))

    def run_compiled(self, n_ticks: int, state: EngineState | None = None
                     ) -> EngineState:
        """Run n_ticks ticks with no host read, then flush the write ring:
        the twin of the reference's ``run_compiled`` (one ``fori_loop``).
        On CUDA each tick is a replay of a CUDA graph of the tick, one per
        flush phase, captured at the first call and reused by every later
        one (``engine/graph.py``); the state is copied into the graphs'
        buffers unless it is the state a replay returned.  The state
        returned on CUDA is those buffers: it is valid until the next
        compiled call of this engine, which overwrites it in place
        (``clone`` what must outlive that).  A capture that fails raises.
        On the CPU the same tick runs in a host loop."""
        if state is None:
            state = self.init_state()
        return self._flush_body(self.advance(n_ticks, state, compiled=True))

    def advance(self, n_ticks: int, state: EngineState,
                compiled: bool = False) -> EngineState:
        """n_ticks ticks without the final flush: eager, or as
        ``run_compiled`` runs them (``compiled``)."""
        if compiled and self.device.type == "cuda":
            if self.graphs is None:
                from deneva_tpu_torch.engine.graph import TickGraphs
                self.graphs = TickGraphs(self)
            return self.graphs.replay(n_ticks, state)
        for _ in range(n_ticks):
            state = self.tick(state, compiled)
        return state

    def _flush_body(self, state: EngineState) -> EngineState:
        """Apply the deferred write ring to the data table so host readers
        see it up to date."""
        flush_write_ring(state.data, state.stats)
        return state

    def summary(self, state: EngineState,
                wall_seconds: float | None = None) -> dict:
        """Host-side stats in the reference's [summary] vocabulary
        (statistics/stats.cpp:1541-1575)."""
        s = {k: v.item() for k, v in state.stats.items()
             if not k.startswith("arr_") and k != "wr_ring_cursor"}
        s.update({k: int(v.item()) for k, v in state.db.items()
                  if k.endswith("_cnt") and v.dim() == 0})
        commits = max(s["txn_cnt"], 1)
        out = dict(s)
        out["tput_per_tick"] = s["txn_cnt"] / max(s["measured_ticks"], 1)
        out["abort_rate"] = s["total_txn_abort_cnt"] / (
            s["total_txn_abort_cnt"] + commits)
        out["avg_latency_ticks_short"] = s["txn_run_time_ticks"] / commits
        out["avg_latency_ticks_long"] = s["txn_total_time_ticks"] / commits
        ring = state.stats["arr_lat_short"][:LAT_SAMPLES].cpu().numpy()
        n_valid = min(s["lat_ring_cursor"], LAT_SAMPLES)
        out["ccl_samples"] = tuple(ring[:n_valid].tolist())
        out["ccl_valid"] = n_valid
        if wall_seconds is not None:
            out["tput"] = s["txn_cnt"] / wall_seconds
        return out

    def summary_line(self, state: EngineState,
                     wall_seconds: float | None = None,
                     prog: bool = False) -> str:
        """The reference's ``[summary]`` key=value line."""
        from deneva_tpu_torch import stats as stats_mod
        d = stats_mod.reference_summary(self.summary(state, wall_seconds),
                                        wall_seconds)
        return stats_mod.format_summary(d, prog=prog)


def timed_run(engine: Engine, n_ticks: int, state: EngineState,
              compiled: bool = False):
    """Run n_ticks ticks and flush; returns (state, seconds per tick).  On
    CUDA the time comes from CUDA events around the ticks; on the CPU from
    the host clock.  ``compiled`` runs them as ``run_compiled`` does (on
    CUDA, graph replays; the graphs are captured, and the state copied in,
    before the clock starts)."""
    if compiled:
        state = engine.advance(0, state, compiled=True)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state = engine.advance(n_ticks, state, compiled)
        t1.record()
        torch.cuda.synchronize(engine.device)
        per_tick = t0.elapsed_time(t1) / 1e3 / max(n_ticks, 1)
    else:
        h0 = time.perf_counter()
        state = engine.advance(n_ticks, state, compiled)
        per_tick = (time.perf_counter() - h0) / max(n_ticks, 1)
    return engine._flush_body(state), per_tick
