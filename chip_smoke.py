"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA device

Phases, each printing one line:
  1. the card's name and power limit (nvidia-smi);
  2. the build of the kernels (csrc/fused_sort_scan.cu, csrc/ts_rebase.cu
     and csrc/graph_while.cu), one nvcc each, started together;
  3. the kernel against its plain PyTorch version on the card, bit-equal,
     on the unit shape set and on both main-path packs, with the key shift
     of 0 and of 1, with times, its launch plan (blocks, tile, merge
     levels) and exactly 1 device kernel per call (the nodes of a CUDA
     graph captured from one call), its device time per launch traced by
     torch.profiler;
  4. the headline cell (16M rows, B=8192, R=10, zipf 0.6, NO_WAIT,
     fused_arbitrate) on CUDA: the [summary] line, commits per tick, tick
     time from CUDA events, peak memory, and 2 kernel launches per tick
     with no fallback; then a short torch.profiler trace of the same
     ticks, for times: 2 sort wrapper launches per traced tick, no
     cummax, one tick captured into a CUDA graph (not replayed) whose
     wrapper launches are the 2 and whose nodes count the tick's device
     work exactly, and no host sync (CUDA sync debug mode);
  5. the same cell on the port's CPU path: summary and data equal to a
     CUDA run of the same length, and the write-count oracle;
  6. the tpcc cell (TPC-C at 128 warehouses, 16.74M rows, B=8192, NO_WAIT,
     fused_arbitrate) on CUDA: pool and table build times, the [summary]
     line, commits per tick, abort rate, tick time, the kernel's launches
     per tick by pack against the ticks that took the compacted or the
     full-width effect body, 0 fallbacks, TPC-C's conservation laws, a
     traced window (for times) whose sort wrapper launches match the
     plan for the effect bodies taken, a captured tick's launches and
     graph nodes, and 1 host sync per tick (the effect step's
     compact/full choice);
  7. every pack one tpcc tick sorts, captured from the tick, held
     bit-equal to the plain version and timed as in phase 3;
  8. the tpcc cell on the port's CPU path: summary, data and every table
     equal to a CUDA run of the same length;
  9. the pps cell (PPS at the Config defaults, 23,575 catalog rows,
     B=8192, R=21, NO_WAIT, fused_arbitrate) on CUDA, as phase 6: build
     times, the [summary] line, commits per tick, abort rate, tick time,
     launches per tick by pack against the effect bodies, 0 fallbacks,
     PART_AMOUNT conservation (every committed ORDERPRODUCT part write
     lowers the sum by 1, every UPDATEPART raises it by 100), a traced
     window, and 1 host sync per tick (the effect count);
 10. every pack one pps tick sorts, captured from the tick, held bit-equal
     to the plain version and timed as in phase 3;
 11. the pps cell on the port's CPU path: summary, data and both tables
     equal to a CUDA run of the same length;
 12. WAIT_DIE: the pps_wait_die cell on CUDA (waits happen, launches by
     pack, tick time, no torch.cummax left in the tick, 1 host sync per
     tick), then CPU == CUDA on pps_wait_die and on the headline and tpcc
     cells under WAIT_DIE (fewer ticks, see WD_CPU_TICKS);
 13. TIMESTAMP (basic T/O): the headline_timestamp cell as phase 4 (the
     [summary] line, commits per tick, abort rate, 2 launches per tick by
     pack, no fallback, a traced window with 0 host syncs), the rebase
     kernel (csrc/ts_rebase.cu) launched on every tick of that run and held
     bit-equal to its plain version on the cell's 16M-row wts/rts at the
     shift of a tick that does not rebase (0) and of one that does (2^30),
     with both times and the plain version's device time, and the
     tpcc_timestamp cell as phase 6 (1 host sync per tick, the effect
     branch: the restock chain is in closed form), then the histogram of
     its deepest restock chain per tick over 150 more ticks (read on the
     host by this script, outside the timed windows); every T/O pack
     captured from a tick, held bit-equal to the plain version and timed,
     its bound counting each column at its own width; then CPU == CUDA
     under TIMESTAMP on the three workloads and on the headline with
     ts_twr (fewer ticks, see TO_CPU_TICKS), wts and rts included;
 14. MVCC: the headline_mvcc cell as phase 4 (3 launches per tick: the
     decision sort, the unpermute and the version insert; 2 rebase kernel
     launches per tick, the rings in ring mode and rts0/w_floor in plain
     mode; 0 host syncs and 0 cummax in a traced window; the tail-fold
     counter), the rebase kernel in ring mode held bit-equal to its plain
     version on the cell's own 1.07 GB of rings at shift 0 and 2^30 and
     timed, the tpcc_mvcc cell as phase 6 (TPC-C conservation, the deepest
     restock chain per tick, 1 host sync per eager tick, 0 cummax), every
     new pack (the version insert, 4 columns by 2 keys at B*R lanes)
     captured from a tick, held bit-equal and timed; then CPU == CUDA
     under MVCC on the three workloads (see MV_CPU_TICKS), rings, rts0
     and w_floor included;
 15. CALVIN: the headline_calvin cell as phase 4 (2 launches per tick, 0
     host syncs and 0 cummax in a traced window, no abort), the
     tpcc_calvin cell as phase 6 (TPC-C conservation, 1 host sync per
     eager tick, 0 cummax, no abort; its FIFO lock sort captured from a
     tick, held bit-equal to the plain version and timed as a row of its
     own), the pps_calvin cell as phase 9 (PART_AMOUNT conservation, recon
     deferrals counted, no abort), then CPU == CUDA under CALVIN on the
     three cells (see CA_CPU_TICKS), txn slots included;
 16. OCC: the headline_occ cell as phase 4 (1 launch per tick, the
     validation sort; 0 cummax; one host sync per pass of the fixed point
     and none else; vabort_cnt = occ_hist_abort_cnt + occ_active_abort_cnt;
     the passes per tick), the tpcc_occ cell as phase 6 (TPC-C
     conservation, passes + 1 host syncs per eager tick) and the pps_occ
     cell as phase 9 (PART_AMOUNT conservation); each cell's validation
     sort captured from a tick, held bit-equal to the plain version and
     timed as a row of its own; one pass of the fixed point's body timed
     (CUDA events, in a plain graph and eager); CPU == CUDA under OCC on
     the three cells (see OC_CPU_TICKS), txn slots and passes included;
     the forced chain (``cc/occ.py`` ``chain_pool``: OC_CHAIN txns
     finishing in one tick) on the CPU, eager on CUDA and replayed: OC_CHAIN passes, OC_CHAIN / 2
     commits, no host sync in the replay; the WHILE node on a bare loop:
     exact pass counts up to 1,000 from one graph, its time per pass
     against the same kernels in a plain graph and against the host loop;
 17. MAAT: the headline_maat cell as phase 4 (2 launches per tick, its
     chain sort and squeeze sort, 3 keys each; one host sync per pass of
     its commit chain and none else; torch.cummax 7 times per tick plus
     once per chain pass and nowhere else; 1 rebase launch per tick in
     ring mode; vabort_cnt = maat_range_abort_cnt; the passes per tick),
     the tpcc_maat cell as phase 6 (TPC-C conservation, passes + 1 host
     syncs per eager tick) and the pps_maat cell as phase 9 (PART_AMOUNT
     conservation); each cell's two packs captured from a tick, held
     bit-equal to the plain version and timed as rows of their own; one
     pass of the chain's body timed (CUDA events, in a plain graph and
     eager) on headline_maat and tpcc_maat; MAAT's rebase on the six
     arrays a no-op at shift 0 (uppers of 0 included) and equal to the
     plain version at 2^30, the ring rule on maat_lr+maat_lw timed; CPU ==
     CUDA under MAAT on the three cells (see MA_CPU_TICKS), txn slots,
     MAAT arrays and passes included; the forced chains (MA_CHAINS: 40
     passes and 20 commits, and at 80 txns the bound, 66 passes) on the
     CPU, eager on CUDA and replayed; a step whose flag never clears
     stopped at exactly 66 passes by the host loop and the WHILE node;
 18. the lock family's arbitration opt-ins: on each of headline_subticks
     (sub_ticks=8), headline_timestamp_subticks (TIMESTAMP, sub_ticks=8),
     pps_wait_die_dense (the dense-row window) and headline_read_committed,
     50 eager ticks timed after the warm-up with the sort kernel's
     launches by pack (2K + 1 = 17 per tick on the sub-tick cells: K lock
     or decision sorts, K unpermutes and the ts_groups rank), 0
     fallbacks and the increment oracle; one torch.profiler trace, taken
     once, whose host records show exactly the tick's sort calls and 0
     torch.cummax calls (and 0 cummax device kernels), with the eager idle
     share; the host syncs of a tick (0 on YCSB, the effect choice on
     pps); each pack the access phase sorts, taken from a live tick, held
     bit-equal to the plain version and timed as a row of its own (1
     device kernel per call); 12 ticks eager == replayed tick by tick
     (every tensor of the state); CPU == CUDA after 20 ticks (summary,
     [summary] line, data, tables, CC arrays and txn slots); then
     dense_lock_state == the sorted join on one pool for 20 + 150 ticks on
     the headline and on pps_wait_die; pipeline_exchange == the in-order
     rounds on headline_subticks over 50 ticks; the headline at
     READ_UNCOMMITTED and at NOLOCK over 50 ticks, CPU == CUDA and eager
     == replayed;
 19. commit after access (``commit_after_access``): on each of
     headline_caa, headline_occ_caa, headline_maat_caa and tpcc_calvin_caa
     and its flagless cell, from one pool, CAA_TICKS eager ticks timed
     after the warm-up, the [summary] line, commits per tick, abort rate
     and short latency side by side; the sort kernel's launches per tick
     by pack (and the rebase kernel's) equal to the flagless cell's, 0
     fallbacks; the increment oracle, and TPC-C's conservation laws on
     tpcc_calvin_caa; on the flag's engine one trace (torch.cummax: 7 + 1
     per chain pass on headline_maat_caa, 0 on the others), the sort
     wrapper's launches per traced tick and a captured tick's, the host
     syncs of an eager tick (0 on YCSB but the loop's flag reads, 1 on
     tpcc), 12 ticks eager == replayed tick by tick, CPU == CUDA after 20
     ticks (txn slots included); then CPU == CUDA with the flag on the
     headline under WAIT_DIE, TIMESTAMP and MVCC and on pps under NO_WAIT
     and MAAT (CAA_CPU_OTHERS);
 21. live-entry compaction (``compact_auto``), run after phase 19 and
     before phase 20: on each of headline_compact, tpcc_compact,
     headline_mvcc_compact and headline_maat_compact and its flagless cell,
     from one pool, CAA_TICKS eager ticks timed after the warm-up, the
     [summary] line, commits per tick, abort rate, compact_overflow_cnt and
     live_entry_cnt per tick side by side; the sort kernel's launches per
     tick by pack: the flagless cell's sorts at the live width K plus the
     compaction pack (and the expansion pack on the access path), 0
     fallbacks, the same rebase launches; the increment oracle, and
     TPC-C's conservation laws on tpcc_compact; on the flag's engine one
     trace (torch.cummax: 7 + 1 per chain pass on headline_maat_compact, 0
     on the others), the sort wrapper's launches per traced tick and a
     captured tick's, the host syncs of an eager tick (the flagless
     cell's), every pack the flagless cell does not sort, taken from a
     live tick, held bit-equal to the plain version and timed as a row of
     its own, 12 ticks eager == replayed tick by tick, CPU == CUDA after 20
     ticks (txn slots included); then CPU == CUDA on the headline under
     WAIT_DIE and TIMESTAMP and on headline_occ and pps with
     ``compact_auto``, on tpcc_calvin with ``compact_lanes`` = 135,168 (half
     its B*R: CALVIN's auto bucket is the identity), and on the headline
     with ``compact_lanes`` = 8,192, which must spill (CP_CPU_OTHERS);
 22. the sharded engine (``parallel/sharded.py``), run after phase 21 and
     before phase 20: on headline_sharded4 (four nodes of the headline's
     size on the card, NO_WAIT, fused_arbitrate), SH_TICKS eager ticks
     and SH_TICKS graph replays from one initial state equal (summary,
     [summary] line, every node's data and counters, txn slots) with the
     write-count oracle; then 3 windows of SH_WINDOW eager ticks, with the
     sort kernel's launches by pack (per node and tick: routing A and B,
     3 columns by 2 keys at B*R lanes, the lock sort and the unpermute at
     the owner's N*C + B*R lanes: 16 a tick), and 3 windows of replays,
     each cell's tick ms the median of its windows; commits per tick,
     abort rate, remote entries and route-overflow aborts per tick, peak
     memory; one trace of eager ticks and one of replays (times, idle
     share, 0 torch.cummax), the host syncs of an eager tick (0), a
     captured tick's sort launches and graph nodes; each of the four
     packs, taken from a live tick, held bit-equal to the plain version
     and timed as a row of its own; then CPU == CUDA on sharded2_small,
     sharded8_small and sharded2_small with a starved exchange
     (SH_CPU_CELLS), every node's counters and txn slots included;
 20. Engine.run_compiled, the tick as CUDA graphs, on the headline, tpcc,
     pps, pps_wait_die, headline_timestamp, tpcc_timestamp, headline_mvcc,
     tpcc_mvcc, headline_calvin, tpcc_calvin, pps_calvin, headline_occ,
     tpcc_occ, pps_occ, headline_maat, tpcc_maat, pps_maat,
     headline_subticks, headline_timestamp_subticks, pps_wait_die_dense,
     headline_read_committed, headline_caa, headline_occ_caa,
     headline_maat_caa, tpcc_calvin_caa, headline_compact, tpcc_compact,
     headline_mvcc_compact and headline_maat_compact cells: GRAPH_TICKS
     ticks eager and GRAPH_TICKS replayed from the same initial state give equal
     summaries, data, tables, CC state (wts, rts) and effect bodies; a
     replayed tick makes 0 host syncs (sync debug mode "error");
     the launches by pack captured per tick are those of a tick that takes
     the full-width effect body (a captured tick runs it whatever the
     reference's choice, see workloads/base.py), one more tick captured
     (not replayed) holds them and counts its graph nodes, and a traced
     window of replays gives the device times; the eager and the graph tick ms (3 windows of 50 ticks, CUDA events) beside the
     card's name and power limit, every window, the replay windows once
     more after the trace, the SM clock nvidia-smi samples while the
     replays run, and the peak memory of both; the packs only a captured tick sorts (the full-width
     effect body) held bit-equal to the plain version and timed; on the
     OCC and MAAT cells, the loop's passes of the replayed ticks
     equal the eager ticks', and OC_PASS_TICKS ticks eager and replayed
     from the start run equal passes tick by tick (their histogram
     printed).
Then one JSON line of per-kernel numbers (one entry per pack of the sort
kernel, MAAT's six among them, one for CALVIN's lock sort on tpcc_calvin,
one for each OCC cell's validation sort, one for each pack of the lock
opt-in cells' access phase and for each pack a compaction cell sorts
that its flagless cell does not, one per use of the rebase kernel
(T/O's plain rule, MVCC's and MAAT's ring rule) at the main path's shift
of 0, with its numbers at 2^30 under ``rebase_tick``, and one for the
WHILE node, whose launches are the captures of its set-condition kernel
on the OCC and MAAT cells' graph path and whose replayed launches are the
passes those replays ran; ``launches``
counts the wrapper's launches on the eager paths, and for a pack only the
graph path sorts, its warm-up and capture; ``replayed_launches`` those the
graph replays ran) and the final
``{"ok": true, "device": {...}}`` line.  Any failure raises and exits
nonzero; without a CUDA device it exits nonzero before printing a result.
"""

from __future__ import annotations

import contextlib
import gc
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

#: timed eager ticks of the phases before the graph phase (3 windows)
HEADLINE_TICKS = 150
WINDOW_TICKS = 50
WARMUP_TICKS = 20
CPU_TICKS = 60
MAIN_N = 8192 * 10           # B * R lanes of the headline cell
#: widths 1..130 as in tests/test_fused.py, and one that is not a power of
#: two between 2 and 8 tiles of 1024 records (6 tiles: 3 merge levels)
UNIT_WIDTHS = (1, 2, 7, 64, 96, 128, 130, 6007)
TRACE_TICKS = 10
TPCC_TICKS = 150
TPCC_CPU_TICKS = 40
PPS_TICKS = 150
PPS_CPU_TICKS = 40
#: ticks of the CPU == CUDA checks under WAIT_DIE, by cell
WD_CPU_TICKS = {"pps_wait_die": 40, "headline": 20, "tpcc": 20}
#: ticks of the CPU == CUDA checks under TIMESTAMP, by cell and overrides
TO_CPU_TICKS = (("headline_timestamp", {}, 20), ("tpcc_timestamp", {}, 20),
                ("pps", {"cc_alg": "TIMESTAMP"}, 20),
                ("headline_timestamp", {"ts_twr": True}, 20))
#: ticks of the CPU == CUDA checks under MVCC, by cell and overrides
MV_CPU_TICKS = (("headline_mvcc", {}, 20), ("tpcc_mvcc", {}, 20),
                ("pps", {"cc_alg": "MVCC"}, 20))
#: ticks of the CPU == CUDA checks under CALVIN, by cell
CA_CPU_TICKS = (("headline_calvin", 20), ("tpcc_calvin", 20),
                ("pps_calvin", 20))
#: ticks of the CPU == CUDA checks under OCC, by cell
OC_CPU_TICKS = (("headline_occ", 20), ("tpcc_occ", 20), ("pps_occ", 20))
#: ticks of the CPU == CUDA checks under MAAT, by cell
MA_CPU_TICKS = (("headline_maat", 20), ("tpcc_maat", 20), ("pps_maat", 20))
#: MAAT's forced chains (``cc/maat.py`` ``chain_pool``): txns, the chain's
#: passes in their tick (the bound of 66 past 66 txns) and the commits
MA_CHAINS = ((40, 40, 20), (80, 66, 47))
#: the six MAAT arrays
MAAT_ARRAYS = ("maat_lr", "maat_lw", "maat_lower", "maat_upper", "maat_gw",
               "maat_gr")
#: the forced chain of OCC txns finishing in one tick (``chain_pool``)
OC_CHAIN = 40
#: OCC and MAAT cells: ticks whose loop passes are held equal one by one,
#: eager against replayed
OC_PASS_TICKS = 50
#: cells of the graph phase, and its ticks on each path
GRAPH_CELLS = ("headline", "tpcc", "pps", "pps_wait_die",
               "headline_timestamp", "tpcc_timestamp", "headline_mvcc",
               "tpcc_mvcc", "headline_calvin", "tpcc_calvin", "pps_calvin",
               "headline_occ", "tpcc_occ", "pps_occ", "headline_maat",
               "tpcc_maat", "pps_maat", "headline_subticks",
               "headline_timestamp_subticks", "pps_wait_die_dense",
               "headline_read_committed", "headline_caa", "headline_occ_caa",
               "headline_maat_caa", "tpcc_calvin_caa", "headline_compact",
               "tpcc_compact", "headline_mvcc_compact",
               "headline_maat_compact")
GRAPH_TICKS = 150
#: the packs a headline tick sorts, as (columns, keys, lanes, shift)
PACK_NAMES = {
    (3, 2, MAIN_N, 1): "headline lock sort",
    (2, 1, MAIN_N, 0): "headline unpermute",
}


def access_packs(eng, prefix):
    """The CC plugin's own sorts in a tick of `eng`, by (columns, keys,
    lanes, shift), with their names, and the launches of each per tick:
    2PL's lock sort (keykind, ts, payload) by 2 keys with the row shift,
    or the T/O and MVCC decision sort (key, ts, is_write, held, req,
    w_abort, lane) by 2 keys; both are followed by the unpermute, 2
    columns by 1 key at the same width.  CALVIN's FIFO lock sort is 2PL's
    pack.  MVCC's commit adds its version insert (key, BIG_TS - ts, ts,
    committed write) by 2 keys at B*R lanes.  OCC sorts once, to
    validate: (key, ts, is_write, txn) by 2 keys, with no unpermute (its
    access grants every request and sorts nothing).  MAAT sorts twice, to
    validate: its chain sort (key, finishing first, ts, is_write, access
    tick, txn) and its squeeze sort (key, access tick, ts, lane), both by
    3 keys.  These sorts run at the live width K of
    ``Config.compact_width`` (B*R unless ``compact_auto`` or
    ``compact_lanes`` makes it smaller); at K < B*R one full-width sort by
    1 key builds the compacted view first (the access path's class rank
    with the entry view and the plugin's per-lane inputs: 8 columns, 10
    under TIMESTAMP, 11 under MVCC; OCC's 5, MAAT's 7), and on the access
    path one more, 4 columns by 1 key, expands the decisions.  The lock
    family's opt-ins bypass compaction: with ``sub_ticks`` K, K sub-rounds
    of the lock sort (T/O: the decision sort) and its unpermute at B*R,
    and the (ts, lane) rank of ``ts_groups`` at B lanes; with
    ``dense_lock_state``, the window's (row, ts, payload) request sort by
    2 keys and its unpermute at B*W lanes; under NOLOCK no sort at
    all."""
    cfg = eng.cfg
    B = cfg.batch_size
    N = B * eng.pool.max_req
    plugin = eng.plugin.name
    if plugin in ("OCC", "MAAT"):
        K = cfg.compact_width(N, B)
        if plugin == "OCC":
            names = {(4, 2, K, 0): f"{prefix} OCC validation sort"}
        else:
            names = {(6, 3, K, 0): f"{prefix} MAAT chain sort",
                     (4, 3, K, 0): f"{prefix} MAAT squeeze sort"}
        if K < N:
            names[(5 if plugin == "OCC" else 7, 1, N, 0)] = \
                f"{prefix} {plugin} validation compaction"
        return names, {p: 1 for p in names}
    lock_family = plugin in ("NO_WAIT", "WAIT_DIE")
    locking = cfg.isolation_level in ("SERIALIZABLE", "READ_COMMITTED")
    if lock_family and cfg.isolation_level == "NOLOCK":
        return {}, {}
    if lock_family and locking and cfg.sub_ticks == 1 \
            and eng.plugin._window_path(cfg):
        # the dense-row window: the B*W request lanes sorted alone
        n = B * min(cfg.acquire_window, eng.pool.max_req)
        sort, unperm = (3, 2, n, 0), (2, 1, n, 0)
        return ({sort: f"{prefix} dense window request sort",
                 unperm: f"{prefix} dense window unpermute"},
                {sort: 1, unperm: 1})
    sub = cfg.sub_ticks if (plugin == "TIMESTAMP"
                            or (lock_family and locking)) else 1
    if sub > 1:
        # sub sub-rounds of one sort and one unpermute, and the ts_groups
        # rank of the B slots
        pack = (7, 2, N, 0) if plugin == "TIMESTAMP" else (3, 2, N, 1)
        name = "T/O decision sort" if plugin == "TIMESTAMP" else "lock sort"
        groups = (2, 1, B, 0)
        return ({pack: f"{prefix} sub-round {name}",
                 (2, 1, N, 0): f"{prefix} sub-round unpermute",
                 groups: f"{prefix} ts_groups rank"},
                {pack: sub, (2, 1, N, 0): sub, groups: 1})
    K = cfg.compact_width(N, B, request_all=eng.plugin.request_all)
    if plugin in ("TIMESTAMP", "MVCC"):
        pack, name = (7, 2, K, 0), "T/O and MVCC decision sort"
    else:
        pack, name = (3, 2, K, 1), "lock sort"
    names = {pack: f"{prefix} {name}", (2, 1, K, 0): f"{prefix} unpermute"}
    if K < N:
        extras = {"TIMESTAMP": 2, "MVCC": 3}.get(plugin, 0)
        names[(8 + extras, 1, N, 0)] = f"{prefix} access compaction"
        names[(4, 1, N, 0)] = f"{prefix} access expansion"
    if plugin == "MVCC":
        names[(4, 2, N, 0)] = f"{prefix} MVCC version insert"
    return names, {p: 1 for p in names}


def tpcc_packs(eng):
    """The packs a tick of the TPC-C engine `eng` sorts, by (columns,
    keys, lanes, shift), and the kernel launches a tick makes of each
    when it takes the compacted (K-lane) or the full-width effect body.
    B*R lanes are those of the engine's pool; K is the workload's."""
    from deneva_tpu_torch.workloads import tpcc
    B = eng.cfg.batch_size
    N = B * eng.pool.max_req
    K = tpcc.effect_lanes(eng.cfg, N)
    acc_names, every = access_packs(eng, "tpcc")
    wide = "tpcc unpermute (+ 3 full-width ring appends)" \
        if (2, 1, N, 0) in acc_names else "tpcc full-width ring appends"
    names = {
        **acc_names,
        (2, 1, N, 0): wide,
        (8, 2, N, 0): "tpcc effect compaction",
        (2, 1, B, 0): "tpcc o_id rank",
        (3, 2, K, 0): "tpcc restock chain",
        (2, 1, K, 0): "tpcc ring appends",
        (3, 2, N, 0): "tpcc restock chain, full width",
    }
    every[(2, 1, B, 0)] = 1
    compact = dict(every)
    compact.update({(8, 2, N, 0): 1, (3, 2, K, 0): 1, (2, 1, K, 0): 3})
    full = dict(every)
    full.update({(3, 2, N, 0): 1, (2, 1, N, 0): every.get((2, 1, N, 0), 0)
                 + 3})
    return names, compact, full


def pps_packs(eng):
    """The packs a tick of the PPS engine `eng` sorts, by (columns, keys,
    lanes, shift), and the kernel launches a tick makes of each when it
    takes the compacted (K-lane) or the full-width effect body."""
    from deneva_tpu_torch.workloads import pps
    N = eng.cfg.batch_size * eng.pool.max_req
    K = pps.effect_lanes(eng.cfg, N)
    acc_names, every = access_packs(eng, "pps")
    names = {
        **acc_names,
        (2, 1, N, 0): "pps unpermute",
        (6, 1, N, 0): "pps effect compaction",
        (3, 2, K, 0): "pps USES last-writer-wins",
        (3, 2, N, 0): "pps USES last-writer-wins, full width",
    }
    compact = dict(every)
    compact.update({(6, 1, N, 0): 1, (3, 2, K, 0): 1})
    full = dict(every)
    full.update({(3, 2, N, 0): 1})
    return names, compact, full


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
    """Device time of one call of `fn`, the device kernels it runs and the
    launches of the fused kernel among them: the sums over its kernels in
    a torch.profiler trace of `reps` calls, divided by `reps`.  Unlike
    `cuda_ms`, the time leaves out the host's gaps between launches.
    `expect_sort` goes to `trace_kernels`."""
    from deneva_tpu_torch.profile_tick import breakdown, trace_kernels
    per = breakdown(trace_kernels(fn, reps, expect_sort), reps)
    return (per["device_busy_us"] / 1e3, per["kernel_launches"],
            per["fused_sort_scan_launches"])


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


def bound_ms(cols, num_keys):
    """Least time for the function on this card: the input columns read
    once and the outputs (the sorted columns, bool starts, int32 start
    index) written once, each column at its own width (bool 1 byte, int32
    4), against n*log2(n) comparisons of num_keys+1 words."""
    n = cols[0].shape[0]
    bytes_ = n * (2 * sum(c.element_size() for c in cols) + 1 + 4)
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


def phase_build(fused, rebase):
    from deneva_tpu_torch.ops import cuda_build, device_loop
    t0 = time.perf_counter()
    recs = cuda_build.build_all(("fused_sort_scan", "ts_rebase",
                                 "graph_while"))
    fused.build()
    rebase.build()
    device_loop.build()
    wall = time.perf_counter() - t0
    for name, rec in recs.items():
        say("build", f"{name} built={rec['built']} nvcc_s="
            f"{rec['seconds']:.2f} lib={rec['path']}")
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "Compiling entry" in line:
                print("  ptxas: " + line.strip())
    say("build", f"the three sources built and loaded in {wall:.2f} s (one "
        "nvcc each, started together)")


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
    return {pack: measure_pack(fused, PACK_NAMES[pack], cols, pack[1],
                               pack[3])
            for pack, cols in (((3, 2, MAIN_N, 1), lock),
                               ((2, 1, MAIN_N, 0), unperm))}


def library_call(cols, nk):
    """One torch.sort that orders the pack as the kernel does: by the key
    itself, or by two int32 keys packed into one int64, or by three keys
    packed into one int64 with each key less its minimum in as many bits
    as its range takes (all stable; MAAT's packs take at most 63)."""
    if nk == 1:
        return lambda: torch.sort(cols[0], stable=True)
    if nk == 2:
        return lambda: torch.sort((cols[0].to(torch.int64) << 32)
                                  | (cols[1].to(torch.int64) & 0xFFFFFFFF),
                                  stable=True)
    assert nk == 3
    lows = [int(c.min().item()) for c in cols[:3]]
    bits = [max(1, (int(c.max().item()) - lo).bit_length())
            for c, lo in zip(cols[:3], lows)]
    assert sum(bits) <= 63, bits
    return lambda: torch.sort(
        ((cols[0].to(torch.int64) - lows[0]) << (bits[1] + bits[2]))
        | ((cols[1].to(torch.int64) - lows[1]) << bits[2])
        | (cols[2].to(torch.int64) - lows[2]), stable=True)


def measure_pack(fused, name, cols, nk, shift):
    """The kernel on one pack of the main path: bit-equal to its plain
    version (with the path's shift and with 0), its launch plan, its time
    per call (CUDA events), its device work per call (a CUDA graph
    captured from one call must hold exactly 1 node, a kernel, while the
    wrapper counts 1 launch: ``profile_tick.graph_nodes``) and its device
    time per launch (the mean over the fused kernel's launches in a
    torch.profiler trace of 20 calls, which can lose a launch), the plain
    version's and one torch.sort's time, and the bound.  The bound counts
    each column at its own width; the times are those of the kernel's
    own int32 input (the wrapper widens bools).  Restores the launch
    counters."""
    from deneva_tpu_torch.profile_tick import breakdown, graph_nodes, \
        trace_kernels
    n = cols[0].shape[0]
    for sh in sorted({0, shift}):
        err = compare(fused, cols, nk, sh)
        if err != 0:
            raise AssertionError(
                f"kernel != plain on the {name}, shift {sh}: {err}")
    bms, by = bound_ms(cols, nk)
    cols = [c.to(torch.int32) if c.dtype == torch.bool else c for c in cols]
    plan = fused.launch_plan(nk, n)
    before = (fused.LAUNCHES, dict(fused.LAUNCHES_BY_PACK))
    call = lambda: fused.fused_sort_scan(cols, nk, shift)
    ms = cuda_ms(call)
    n0 = fused.LAUNCHES
    nodes = graph_nodes(call)
    wrapped = fused.LAUNCHES - n0
    per = breakdown(trace_kernels(call, 20, expect_sort=20), 20)
    fused.LAUNCHES, fused.LAUNCHES_BY_PACK = before[0], before[1]
    if nodes != {"kernel": 1} or wrapped != 1:
        raise AssertionError(f"{name}: one call captured {nodes} while the "
                             f"wrapper counted {wrapped} launches; expected "
                             "1 kernel node and 1 launch")
    traced = per["fused_sort_scan_launches"]
    if not traced:
        raise AssertionError(f"{name}: the profiler traced no launch of "
                             "the fused kernel in 20 calls")
    dev_launches = nodes["kernel"]
    dev_ms = per["fused_sort_scan_us"] / traced / 1e3
    plain_ms = cuda_ms(lambda: fused.fused_sort_scan_plain(cols, nk, shift))
    library = library_call(cols, nk)
    library_ms = cuda_ms(library)
    library_dev_ms = device_ms(library)[0]
    say("kernel", f"{name} n={n} shift={shift}: launch plan "
        f"grid={plan['grid']} blocks x {plan['threads']} threads, tile="
        f"{plan['tile']} records ({plan['tiles']} tiles), merge "
        f"levels={plan['levels']}, chunk={plan['chunk']}")
    say("kernel", f"{name}: bit-equal, kernel {ms:.4f} ms per call "
        f"({dev_ms:.4f} ms of it on the device, the mean of the "
        f"{traced * 20:g} launches torch.profiler traced in 20 calls; "
        f"{dev_launches:g} device kernel per call, a captured graph's "
        f"nodes), plain "
        f"{plain_ms:.4f} ms, torch.sort {library_ms:.4f} ms "
        f"({library_dev_ms:.4f} ms on the device), bound {bms:.5f} ms "
        f"({by})")
    return dict(err=err, ms=ms, device_ms=dev_ms,
                device_launches=dev_launches, plain_ms=plain_ms,
                library_ms=library_ms, library_device_ms=library_dev_ms,
                bound_ms=bms, bound_by=by)


#: the device_loop site of each plugin whose tick runs a device loop:
#: OCC's fixed point and MAAT's commit chain (``cc/occ.py``,
#: ``cc/maat.py`` LOOP_SITE)
LOOP_SITES = {"OCC": "occ", "MAAT": "maat"}
#: MAAT's segmented min/max scans that run torch.cummax: 7 per tick (the
#: squeeze's) and 1 per pass of its chain (the reader cap's prefix min)
MAAT_CUMMAX = (7, 1)


def runs_loop(eng) -> bool:
    """Whether a tick of `eng` runs a device loop
    (``device_loop.run_while``): OCC's fixed point, MAAT's chain."""
    return eng.plugin.name in LOOP_SITES


def loop_passes(eng) -> int:
    """The passes the tick's device loop has run on the engine's device
    since the counters were last reset (0 for a plugin with no loop)."""
    from deneva_tpu_torch.ops import device_loop
    if not runs_loop(eng):
        return 0
    return int(device_loop.passes(LOOP_SITES[eng.plugin.name],
                                  eng.device).item())


def trace_ticks(name, eng, tick):
    """A torch.profiler trace of TRACE_TICKS calls of `tick`
    (``profile_tick.trace_kernels``), for times only: no launch count is
    held by it, since a trace can lose or gain device kernels.  The device
    loop's passes of each traced tick are read after it.  The tick's
    torch.cummax calls (the trace's host ``aten::_cummax_helper`` ops of
    the recorded step, one per call and per device launch) must be MAAT's counted scan
    sites (MAAT_CUMMAX, with the traced passes) on a MAAT cell and 0 on
    every other, in this one trace.  On a cell with none, the trace's
    cummax device kernels must be 0 too; on a MAAT cell their count is
    reported beside the host calls (a trace can gain or lose device
    kernels at its step's edge, as ``trace_kernels`` says).  Returns the
    per-tick breakdown, with the host calls as ``cummax_calls``, and the
    passes per tick."""
    from deneva_tpu_torch.profile_tick import breakdown, trace_kernels
    per_pass, host = [], {}

    def traced():
        p0 = loop_passes(eng)
        tick()
        per_pass.append(loop_passes(eng) - p0)

    per = breakdown(trace_kernels(traced, TRACE_TICKS, None, host),
                    TRACE_TICKS)
    per["cummax_calls"] = host.get("aten::_cummax_helper", 0) / TRACE_TICKS
    passes = sum(per_pass[-TRACE_TICKS:]) / TRACE_TICKS
    want = 0
    if eng.plugin.name == "MAAT":
        want = MAAT_CUMMAX[0] + MAAT_CUMMAX[1] * passes
    if round(per["cummax_calls"], 6) != round(want, 6) or (
            want == 0 and per["cummax_launches"] != 0):
        raise AssertionError(
            f"the {name} tick calls torch.cummax {per['cummax_calls']} "
            f"times per tick ({per['cummax_launches']} device kernels), "
            f"expected {want}")
    return per, passes


def loop_syncs(eng, tick, n_ticks, want_other, other_files):
    """Host syncs of `n_ticks` calls of `tick` (CUDA sync debug mode): the
    flag reads of the device loop's host loop (one per pass, at
    ``device_loop.py``) plus `want_other` per tick at lines of
    `other_files`; raises on any other count or site.  Returns the syncs
    and passes per tick and the sites."""
    from deneva_tpu_torch.profile_tick import host_syncs
    p0 = loop_passes(eng)
    syncs, sites = host_syncs(tick, n_ticks)
    passes = (loop_passes(eng) - p0) / n_ticks
    files = tuple(other_files) + (("device_loop.py",) if passes else ())
    if round(syncs, 6) != round(passes + want_other, 6) or not all(
            k.split(":")[0] in files for k in sites):
        raise AssertionError(f"expected {want_other} host reads per tick "
                             f"and {passes} loop flag reads, saw "
                             f"{syncs} at {sites}")
    return syncs, passes, sites


def captured_tick(name, eng, state):
    """One tick as ``run_compiled`` runs it, captured into a CUDA graph that
    is not replayed, so `state` does not move: the sort wrapper's launches
    by pack inside the capture, each one kernel node of the graph (as
    ``measure_pack`` holds for every pack), must be those ``graph_packs``
    plans for a replayed tick.  Returns the graph's nodes by type
    (``profile_tick.graph_nodes``), a tick's device work counted exactly,
    where a torch.profiler trace can lose or gain launches.  Restores the
    launch counters the capture moves."""
    from deneva_tpu_torch.ops import device_loop, fused, rebase
    from deneva_tpu_torch.profile_tick import graph_nodes
    saved = (fused.LAUNCHES, dict(fused.LAUNCHES_BY_PACK),
             device_loop.LAUNCHES, dict(rebase.LAUNCHES))
    try:
        nodes = graph_nodes(lambda: eng.tick(state, compiled=True))
        by_pack = {k: v - saved[1].get(k, 0)
                   for k, v in fused.LAUNCHES_BY_PACK.items()
                   if v != saved[1].get(k, 0)}
    finally:
        fused.LAUNCHES, fused.LAUNCHES_BY_PACK = saved[0], saved[1]
        device_loop.LAUNCHES = saved[2]
        rebase.LAUNCHES.clear()
        rebase.LAUNCHES.update(saved[3])
    want = graph_packs(eng)[2]
    if by_pack != want:
        raise AssertionError(f"{name}: a captured tick launches the sort "
                             f"kernel {by_pack} by pack, want {want}")
    say("trace", f"{name}: one captured tick: {sum(by_pack.values())} sort "
        f"launches (wrapper count, one kernel node each), graph nodes "
        f"{nodes}")
    return nodes


def phase_trace(eng, state, name="headline", per_tick=2):
    """A torch.profiler trace of TRACE_TICKS ticks of a YCSB cell, for
    times, and the torch.cummax calls (``trace_ticks``); the sort
    wrapper's launches in each traced tick must be `per_tick`, and so
    must those of one captured tick (``captured_tick``); then the same
    ticks under the CUDA sync debug mode: no host sync, but for one flag
    read per pass of the device loop.  Returns the state after them."""
    from deneva_tpu_torch.ops import fused
    box, per_call = [state], []

    def tick():
        n0 = fused.LAUNCHES
        box[0] = eng.tick(box[0])
        per_call.append(fused.LAUNCHES - n0)

    per, passes = trace_ticks(name, eng, tick)
    say("trace", f"{TRACE_TICKS} {name} ticks (torch.profiler): "
        f"{per['kernel_launches']:.1f} device launches per tick, device "
        f"busy {per['device_busy_us']:.1f} us per tick, fused kernel "
        f"{per['fused_sort_scan_launches']:g} launches per tick (wrapper "
        f"count {per_call[-1]}), torch.cummax {per['cummax_calls']:g} "
        f"calls and {per['cummax_launches']:g} device kernels per tick "
        f"({passes:g} loop passes per tick)")
    if set(per_call) != {per_tick}:
        raise AssertionError(f"sort wrapper launches per traced tick "
                             f"{sorted(set(per_call))}, expected {per_tick}")
    captured_tick(name, eng, box[0])
    syncs, passes, sites = loop_syncs(eng, tick, TRACE_TICKS, 0, ())
    say("trace", f"{TRACE_TICKS} {name} ticks (CUDA sync debug mode): "
        f"{syncs:g} host syncs per tick at {sites or 'no line'} "
        f"({passes:g} loop passes per tick)")
    return box[0]


def phase_headline(cells, Engine, timed_run, fused, dev, name="headline"):
    """The YCSB cell `name` on the card: HEADLINE_TICKS ticks in timed
    windows, the sort kernel's launches per tick (2, 3 under MVCC, 1
    under OCC), the device loop's passes (OCC, MAAT), no fallback, the
    increment
    oracle and a traced window.  Returns the
    engine, the state after the traced ticks, the sort kernel's launches
    by pack and the rebase kernel's launches by rule over the timed
    ticks."""
    from deneva_tpu_torch.ops import rebase
    cfg = cells.config(name)
    t0 = time.perf_counter()
    eng = Engine(cfg, device=dev)
    say(name, f"engine built in {time.perf_counter() - t0:.1f} s "
        "(query pool generated on the host)")
    state = eng.run(WARMUP_TICKS)
    before = eng.summary(state)["txn_cnt"]
    torch.cuda.reset_peak_memory_stats(dev)
    fused.reset_fallbacks()
    fused.reset_launches()
    rebase.reset_launches()
    p0 = loop_passes(eng)
    # the timed ticks in windows, each timed with CUDA events
    window_ms = []
    for _ in range(HEADLINE_TICKS // WINDOW_TICKS):
        state, per_tick = timed_run(eng, WINDOW_TICKS, state)
        window_ms.append(per_tick * 1e3)
    passes = loop_passes(eng) - p0
    launches = fused.LAUNCHES
    by_pack = dict(fused.LAUNCHES_BY_PACK)
    rebase_launches = dict(rebase.LAUNCHES)
    snap = fused.fallback_snapshot()
    peak = torch.cuda.max_memory_allocated(dev)
    s = eng.summary(state)
    commits = s["txn_cnt"] - before
    tick_ms = float(np.median(window_ms))
    print(eng.summary_line(state))
    say(name, f"ticks={HEADLINE_TICKS} commits_per_tick="
        f"{commits / HEADLINE_TICKS} tick_ms median={tick_ms:.4f} "
        f"min={min(window_ms):.4f} max={max(window_ms):.4f} over "
        f"{len(window_ms)} windows of {WINDOW_TICKS} ticks (cuda events) "
        f"committed_txn_per_s={commits / HEADLINE_TICKS / tick_ms * 1e3:.1f}"
        f" abort_rate={s['abort_rate']:.6f} peak_mem_mb={peak / 2**20:.1f}")
    say(name, f"kernel launches={launches} by pack={by_pack} "
        f"fallbacks={snap['count']}; rebase kernel launches="
        f"{rebase_launches}; loop passes={passes} "
        f"({passes / HEADLINE_TICKS:g} per tick)")
    _, every = access_packs(eng, name)
    per_tick = sum(every.values())
    if launches != per_tick * HEADLINE_TICKS:
        raise AssertionError(f"expected {per_tick * HEADLINE_TICKS} kernel "
                             f"launches, counted {launches}")
    if snap["count"] != 0:
        raise AssertionError(f"fused sort fell back: {snap}")
    if int(state.data.sum().item()) != s["write_cnt"]:
        raise AssertionError("data.sum() != write_cnt on the CUDA run")
    if not s["txn_cnt"] > 0 or not math.isfinite(tick_ms):
        raise AssertionError(f"the {name} run committed nothing")
    return (eng, phase_trace(eng, state, name, per_tick), by_pack,
            rebase_launches)


def capture_packs(fused, fn):
    """The operands of the first ``fused_sort_scan`` call of each pack
    shape that `fn` makes, cloned at their own dtypes (the wrapper widens
    bools to int32 for the kernel), by (columns, keys, lanes, shift)."""
    got = {}
    orig = fused.fused_sort_scan

    def record(operands, num_keys, shift=0):
        ops = tuple(operands)
        key = (len(ops), num_keys, ops[0].shape[0], shift)
        got.setdefault(key, [c.clone() for c in ops])
        return orig(ops, num_keys, shift)

    fused.fused_sort_scan = record
    try:
        fn()
    finally:
        fused.fused_sort_scan = orig
    return got


def restock_depths(tpcc, eng, state, ticks):
    """`ticks` more eager ticks of the TPC-C engine `eng`, recording each
    tick's deepest restock chain: the most committing NewOrder entries on
    one STOCK row (a host read per tick, made here and not by the engine).
    Returns the state and the ticks by depth."""
    wl = eng.workload
    body = wl._apply_entries_body
    depths = {}

    def recording(cfg, t, key_local, part, role_f, earg, earg2, cts, eff):
        rows = key_local[eff & ((role_f & 7) == tpcc.ROLE_S_NO)]
        d = int(torch.unique(rows, return_counts=True)[1].max()) \
            if rows.numel() else 0
        depths[d] = depths.get(d, 0) + 1
        return body(cfg, t, key_local, part, role_f, earg, earg2, cts, eff)

    wl._apply_entries_body = recording
    try:
        state = eng.run(ticks, state)
    finally:
        del wl._apply_entries_body
    return state, dict(sorted(depths.items()))


def check_tpcc_conservation(tpcc, cfg, init, tables, s):
    """TPC-C's conservation laws (``tpcc.conservation``) from the
    checksums `init` to those of `tables`; raises if one is broken.
    Returns the Payments, the NewOrders and the names of the laws
    checked (those of a wrapped ring are left out)."""
    fin = tpcc.checksums(tables)
    laws = tpcc.conservation(cfg, init, fin, s)
    broken = [k for k, ok in laws.items() if not ok]
    if broken:
        raise AssertionError(f"TPC-C conservation broken: {broken}")
    return (fin["c_payment_cnt"] - init["c_payment_cnt"],
            fin["d_next_o_id"] - init["d_next_o_id"], sorted(laws))


def run_effect_cell(cells, name, Engine, timed_run, fused, dev, packs_fn,
                    ticks, snapshot):
    """Build the cell `name` on the card (pool and tables timed), take
    ``snapshot`` of its initial tables, warm it up, and run `ticks` ticks
    in windows timed with CUDA events.  Checks the kernel's launches by
    pack against the effect bodies the ticks took (``packs_fn``), and 0
    fallbacks.  Returns the engine, the state, the snapshot and a record
    of the run."""
    cfg = cells.config(name)
    t0 = time.perf_counter()
    eng = Engine(cfg, device=dev)
    torch.cuda.synchronize(dev)
    pool_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = eng.init_state()
    torch.cuda.synchronize(dev)
    tables_s = time.perf_counter() - t0
    mb = sum(v.numel() * v.element_size()
             for v in state.tables.values()) / 2**20
    say(name, f"query pool ({eng.pool.size} txns, {eng.n_rows} catalog "
        f"rows) generated and uploaded in {pool_s:.2f} s; tables "
        f"({mb:.1f} MB on the card) built in {tables_s:.2f} s")
    init = snapshot(state.tables)
    names = packs_fn(eng)[0]
    wl = eng.workload
    state = eng.run(WARMUP_TICKS, state)
    before = eng.summary(state)["txn_cnt"]
    torch.cuda.reset_peak_memory_stats(dev)
    fused.reset_fallbacks()
    fused.reset_launches()
    branch0 = dict(wl.branch_ticks)
    p0 = loop_passes(eng)
    window_ms = []
    for _ in range(ticks // WINDOW_TICKS):
        state, per_tick = timed_run(eng, WINDOW_TICKS, state)
        window_ms.append(per_tick * 1e3)
    passes = loop_passes(eng) - p0
    by_pack = dict(fused.LAUNCHES_BY_PACK)
    launches = fused.LAUNCHES
    snap = fused.fallback_snapshot()
    branch = {k: v - branch0[k] for k, v in wl.branch_ticks.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    s = eng.summary(state)
    commits = s["txn_cnt"] - before
    tick_ms = float(np.median(window_ms))
    print(eng.summary_line(state))
    say(name, f"ticks={ticks} commits_per_tick={commits / ticks} "
        f"abort_rate={s['abort_rate']:.6f} user_abort_cnt="
        f"{s['user_abort_cnt']} twopl_wait_cnt={s['twopl_wait_cnt']} "
        f"tick_ms median={tick_ms:.4f} min={min(window_ms):.4f} "
        f"max={max(window_ms):.4f} over {len(window_ms)} windows of "
        f"{WINDOW_TICKS} ticks (cuda events) committed_txn_per_s="
        f"{commits / ticks / tick_ms * 1e3:.1f} peak_mem_mb="
        f"{peak / 2**20:.1f}")
    c, f = branch["compact"], branch["full"]
    say(name, f"effect bodies: compact={c} full={f} ticks; kernel launches="
        f"{launches} ({launches / ticks:g} per tick), fallbacks="
        f"{snap['count']}; loop passes={passes} "
        f"({passes / ticks:g} per tick)")
    for pack, cnt in sorted(by_pack.items()):
        say(name, f"  {names.get(pack, pack)} {pack}: {cnt} "
            f"launches, {cnt / ticks:g} per tick")
    want = planned_launches(eng, c, f)
    if c + f != ticks or by_pack != want:
        raise AssertionError(f"{name} launches by pack {by_pack} != {want} "
                             f"for {c} compact and {f} full ticks")
    if snap["count"] != 0:
        raise AssertionError(f"fused sort fell back: {snap}")
    if int(state.data.sum().item()) != s["write_cnt"]:
        raise AssertionError(f"data.sum() != write_cnt on the {name} run")
    if not (commits > 0 and math.isfinite(tick_ms)):
        raise AssertionError(f"the {name} run committed nothing")
    return eng, state, init, dict(s=s, by_pack=by_pack, names=names,
                                  tick_ms=tick_ms, passes=passes)


def trace_cell(name, eng, state, fused, want_syncs, sync_files):
    """A traced window of the cell's ticks, for times, and its torch.cummax
    calls (``trace_ticks``); the sort wrapper's launches of the traced
    ticks must be those ``graph_packs`` plans for the effect bodies they
    took, and one captured tick's those of a replay (``captured_tick``);
    then the host syncs of a tick (CUDA sync debug mode) must be
    `want_syncs`, all at lines of the files `sync_files`, plus one flag
    read per pass of the device loop (OCC, MAAT).  Returns the packs of
    one more tick, captured, and the trace's per-tick numbers; flushes the
    state."""
    box, per_call = [state], []
    wl = eng.workload

    def tick():
        n0 = fused.LAUNCHES
        box[0] = eng.tick(box[0])
        per_call.append(fused.LAUNCHES - n0)

    b0 = wl.branch_ticks
    per, passes = trace_ticks(name, eng, tick)
    b1 = wl.branch_ticks
    # the wrapper's launches of every traced call (warm-up and recorded
    # steps) against the plan for the effect bodies they took
    c, f = (b1[k] - b0[k] for k in ("compact", "full"))
    want = sum(planned_launches(eng, c, f).values())
    counted = sum(per_call[-TRACE_TICKS:]) / TRACE_TICKS
    say("trace", f"{TRACE_TICKS} {name} ticks (torch.profiler): "
        f"{per['kernel_launches']:.1f} device launches per tick, device "
        f"busy {per['device_busy_us']:.1f} us per tick, fused kernel "
        f"{per['fused_sort_scan_launches']:g} launches and "
        f"{per['fused_sort_scan_us']:.1f} us per tick (wrapper count "
        f"{counted:g}), torch.cummax {per['cummax_calls']:g} calls and "
        f"{per['cummax_launches']:g} device kernels per tick ({passes:g} "
        "loop passes per tick)")
    if c + f != len(per_call) or sum(per_call) != want:
        raise AssertionError(f"{name}: {sum(per_call)} sort wrapper launches "
                             f"in {len(per_call)} traced ticks ({c} compact "
                             f"and {f} full effect bodies), want {want}")
    captured_tick(name, eng, box[0])
    syncs, passes, sites = loop_syncs(eng, tick, TRACE_TICKS, want_syncs,
                                      sync_files)
    say("trace", f"{TRACE_TICKS} {name} ticks (CUDA sync debug mode): "
        f"{syncs:g} host syncs per tick at {sites} ({passes:g} loop passes "
        "per tick)")
    per["passes"] = passes
    packs = capture_packs(fused, tick)
    eng._flush_body(box[0])
    return packs, per


def phase_tpcc(cells, Engine, timed_run, fused, dev):
    """The tpcc cell at full scale on the card: build times, TPCC_TICKS
    ticks in windows, launches per tick by pack against the branch
    counts, the conservation laws, a traced window, and the captured
    packs."""
    from deneva_tpu_torch.workloads import tpcc
    eng, state, init, rec = run_effect_cell(
        cells, "tpcc", Engine, timed_run, fused, dev, tpcc_packs,
        TPCC_TICKS, tpcc.checksums)
    payments, neworders, laws = check_tpcc_conservation(
        tpcc, eng.cfg, init, state.tables, rec["s"])
    if not (payments > 0 and neworders > 0):
        raise AssertionError("the tpcc run committed no Payment or NewOrder")
    say("tpcc", f"conservation holds ({', '.join(laws)}): {payments} "
        f"Payments, {neworders} NewOrders; data.sum() == write_cnt")
    # the one host read of the effect step (its compact/full choice)
    packs, _ = trace_cell("tpcc", eng, state, fused, 1, ("base.py",))
    return eng.pool, rec["by_pack"], packs, rec["names"]


def part_amount_sum(tables) -> int:
    return int(tables["part_amount"].to(torch.int64).sum().item())


def check_pps_conservation(pps, cfg, pool, amount0, state):
    """PART_AMOUNT conservation (tests/test_pps.py): every committed
    ORDERPRODUCT part write lowers sum(part_amount) by 1 and every
    committed UPDATEPART raises it by 100.  Both write PARTS rows, whose
    committed writes the increment oracle `data` counts, so the change of
    the sum fixes both counts; a pool without UPDATEPART must show none.
    Returns the ORDERPRODUCT part writes and the UPDATEPART commits."""
    t = pps.catalog(cfg).tables["PARTS"]
    parts_writes = int(state.data[t.base:t.base + t.n_local].sum().item())
    delta = part_amount_sum(state.tables) - amount0
    n_upd, rem = divmod(delta + parts_writes, 101)
    has_upd = bool((pool.txn_type == pps.PPS_UPDATEPART).any())
    if rem or not 0 <= n_upd <= parts_writes or (n_upd and not has_upd):
        raise AssertionError(
            f"PART_AMOUNT conservation broken: sum changed by {delta} over "
            f"{parts_writes} committed PARTS writes")
    return parts_writes - n_upd, n_upd


def phase_pps(cells, Engine, timed_run, fused, dev):
    """The pps cell on the card: build times, PPS_TICKS ticks in windows,
    launches per tick by pack against the branch counts, PART_AMOUNT
    conservation, a traced window, and the captured packs."""
    from deneva_tpu_torch.workloads import pps
    eng, state, amount0, rec = run_effect_cell(
        cells, "pps", Engine, timed_run, fused, dev, pps_packs, PPS_TICKS,
        part_amount_sum)
    orders, upd = check_pps_conservation(pps, eng.cfg, eng.pool, amount0,
                                         state)
    if not orders > 0:
        raise AssertionError("the pps run committed no ORDERPRODUCT")
    say("pps", f"PART_AMOUNT conserved: {orders} ORDERPRODUCT part writes "
        f"(-1 each), {upd} UPDATEPART commits (+100 each); "
        "data.sum() == write_cnt")
    # the one host read of the effect step (its compact/full choice)
    packs, _ = trace_cell("pps", eng, state, fused, 1, ("base.py",))
    return eng.pool, rec["by_pack"], packs, rec["names"]


def phase_wait_die(cells, Engine, timed_run, fused, dev):
    """The pps_wait_die cell on the card: waits happen, launches by pack
    match the effect bodies, the tick time, no torch.cummax in a traced
    window (the minimum held ts is a gather), and 1 host sync per tick."""
    eng, state, _, rec = run_effect_cell(
        cells, "pps_wait_die", Engine, timed_run, fused, dev, pps_packs,
        PPS_TICKS, part_amount_sum)
    if not rec["s"]["twopl_wait_cnt"] > 0:
        raise AssertionError("no WAIT decision in the pps_wait_die run")
    # trace_cell holds the tick to 0 torch.cummax (WAIT_DIE's minimum held
    # ts is a gather)
    trace_cell("pps_wait_die", eng, state, fused, 1, ("base.py",))
    return eng.pool


def phase_cpu_equal(cells, name, Engine, dev, ticks, pool=None, **over):
    """The cell `name` (with `over`) on the port's CPU path and on CUDA for
    `ticks` ticks on one pool: summary dicts, data, every table and the
    effect bodies taken (``branch_ticks``, where the workload has them)
    equal, and so are the CC plugin's arrays (TIMESTAMP's wts and rts).
    Returns the CPU run's summary, engine and state, and the CUDA run's
    engine and state."""
    cfg = cells.config(name, **over)
    gpu = Engine(cfg, pool=pool, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    sg = gpu.run(ticks)
    t0 = time.perf_counter()
    sc = cpu.run(ticks)
    cpu_s = time.perf_counter() - t0
    label = " ".join([name] + [f"{k}={v}" for k, v in over.items()])
    a, b = gpu.summary(sg), cpu.summary(sc)
    diff = {k: (a[k], b.get(k)) for k in a
            if k != "ccl_samples" and a[k] != b.get(k)}
    if diff or a != b:
        raise AssertionError(f"{label}: CUDA and CPU summaries differ: "
                             f"{diff}")
    if not torch.equal(sg.data.cpu(), sc.data):
        raise AssertionError(f"{label}: CUDA and CPU data tables differ")
    bad = [k for k in sc.tables
           if not torch.equal(sg.tables[k].cpu(), sc.tables[k])]
    if bad or sorted(sg.tables) != sorted(sc.tables):
        raise AssertionError(f"{label}: CUDA and CPU tables differ: {bad}")
    bad = [k for k in sc.db if not torch.equal(sg.db[k].cpu(), sc.db[k])]
    if bad or sorted(sg.db) != sorted(sc.db):
        raise AssertionError(f"{label}: CUDA and CPU CC state differs: {bad}")
    if getattr(gpu.workload, "branch_ticks", None) \
            != getattr(cpu.workload, "branch_ticks", None):
        raise AssertionError(f"{label}: CUDA and CPU effect bodies differ")
    if int(sc.data.sum().item()) != b["write_cnt"]:
        raise AssertionError(f"{label}: data.sum() != write_cnt on the CPU")
    say("cpu", f"{label} {ticks} ticks: CUDA and CPU summary dicts, data, "
        f"all {len(sc.tables)} tables and {sorted(sc.db) or 'no'} CC arrays "
        f"equal (txn_cnt={b['txn_cnt']}, total_txn_abort_cnt="
        f"{b['total_txn_abort_cnt']}, twopl_wait_cnt={b['twopl_wait_cnt']})"
        f"; CPU run {cpu_s:.1f} s")
    return b, cpu, sc, gpu, sg


def phase_tpcc_cpu_equal(cells, Engine, dev, pool):
    """``phase_cpu_equal`` on the tpcc cell, then TPC-C's conservation laws
    on the CPU run's tables."""
    from deneva_tpu_torch.workloads import tpcc
    s, cpu, sc, _, _ = phase_cpu_equal(cells, "tpcc", Engine, dev,
                                       TPCC_CPU_TICKS, pool=pool)
    init = tpcc.checksums(cpu.init_state().tables)
    _, _, laws = check_tpcc_conservation(tpcc, cpu.cfg, init, sc.tables, s)
    say("cpu", f"tpcc: user_abort_cnt={s['user_abort_cnt']}, order_cursor="
        f"{int(tpcc.ring_view(sc.tables, 'order_cursor'))}; conservation "
        f"holds ({', '.join(laws)})")


def measure_rebase(rebase, a, b, dev, label, ring=False):
    """The rebase kernel (``ring``: in ring mode) on clones of a cell's
    arrays `a` and `b` (and on random and edge values of the same width):
    bit-equal to its plain version at the shift of a tick that does not
    rebase (0) and of one that does (2^30); per shift, its time per call
    (CUDA events) and on the device (torch.profiler), the plain
    version's, and the bound: the shift read once, and at 2^30 both
    arrays read and written once.  Restores the launch counter."""
    a, b = a.clone(), b.clone()
    n = a.shape[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    rand = torch.randint(0, 2**31 - 1, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    edge = torch.tensor([0, 1, 2, 2**30 - 1, 2**30, 2**30 + 1, 2**30 + 2,
                         2**31 - 1], dtype=torch.int32, device=dev)
    before = dict(rebase.LAUNCHES)
    err = 0
    for shift in (0, 2**30):
        s = torch.tensor(shift, dtype=torch.int64, device=dev)
        for x, y in ((a, b), (rand, rand.flip(0)), (edge, edge.flip(0))):
            got, want = [x.clone(), y.clone()], [x.clone(), y.clone()]
            rebase.rebase_(*got, s, ring=ring)
            rebase.rebase_plain(*want, s, ring=ring)
            err = max(err, *(int((g.to(torch.int64) - w.to(torch.int64))
                                 .abs().max().item())
                             for g, w in zip(got, want)))
    if err:
        raise AssertionError(f"rebase kernel != plain on {label}: {err}")
    out = {}
    for shift in (0, 2**30):
        s = torch.tensor(shift, dtype=torch.int64, device=dev)
        x, y = a.clone(), b.clone()
        call = lambda: rebase.rebase_(x, y, s, ring=ring)
        plain = lambda: rebase.rebase_plain(x, y, s, ring=ring)
        ms = cuda_ms(call)
        dev_ms, dev_launches, _ = device_ms(call)
        plain_ms = cuda_ms(plain)
        plain_dev_ms, plain_launches, _ = device_ms(plain)
        bytes_ = 8 + (16 * n if shift else 0)
        t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
        t_ops = (2 * n if shift else 0) / PEAK_SCALAR_OPS_PER_S * 1e3
        out[shift] = dict(
            ms=ms, device_ms=dev_ms, device_launches=dev_launches,
            plain_ms=plain_ms, plain_device_ms=plain_dev_ms,
            plain_launches=plain_launches, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        say("rebase", f"{label}, {n} cells each, shift {shift}: bit-equal; "
            f"kernel {ms:.4f} ms per call ({dev_ms * 1e3:.1f} us on the "
            f"device in {dev_launches:g} kernel), plain {plain_ms:.4f} ms "
            f"({plain_dev_ms * 1e3:.1f} us on the device in "
            f"{plain_launches:g} kernels, torch.profiler), bound "
            f"{out[shift]['bound_ms']:.6f} ms ({out[shift]['bound_by']})")
    rebase.LAUNCHES.clear()
    rebase.LAUNCHES.update(before)
    del a, b, x, y, rand
    return dict(err=err, n=n, by_shift=out)


def phase_timestamp(cells, Engine, timed_run, fused, rebase, dev, rows,
                    names, by_pack, pps_pool):
    """TIMESTAMP on the card (phase 13 of the module docstring).  The
    packs a T/O tick sorts that earlier phases did not are held to the
    plain version and timed into `rows`, named in `names`, and their
    launches on these paths go into `by_pack`.  Returns the rebase
    kernel's record (``measure_rebase``) with its launches on the
    headline_timestamp run."""
    from deneva_tpu_torch.workloads import tpcc

    def measure_new(packs, cell_names, cell, counted):
        new = {p: c for p, c in packs.items() if p not in rows}
        names.update(cell_names)
        measure_captured(fused, rows, new, cell_names, names, cell)
        by_pack.update({p: counted.get(p, 0) for p in new})

    # the rebase kernel runs once on every tick (shift 0 unless the
    # counter passed its threshold): its launches on the timed ticks
    eng, state, hb, rebase_launches = phase_headline(
        cells, Engine, timed_run, fused, dev, "headline_timestamp")
    if rebase_launches != {"plain": HEADLINE_TICKS}:
        raise AssertionError(f"{rebase_launches} rebase kernel launches on "
                             f"{HEADLINE_TICKS} headline_timestamp ticks")
    acc_names, _ = access_packs(eng, "headline")
    measure_new(capture_packs(fused, lambda: eng.tick(state)),
                {**PACK_NAMES, **acc_names}, "headline_timestamp", hb)
    reb = measure_rebase(rebase, state.db["wts"], state.db["rts"], dev,
                         "wts+rts")
    reb["launches"] = rebase_launches["plain"]
    del eng, state

    eng, state, init, rec = run_effect_cell(
        cells, "tpcc_timestamp", Engine, timed_run, fused, dev, tpcc_packs,
        TPCC_TICKS, tpcc.checksums)
    payments, neworders, laws = check_tpcc_conservation(
        tpcc, eng.cfg, init, state.tables, rec["s"])
    say("tpcc_timestamp", f"conservation holds ({', '.join(laws)}): "
        f"{payments} Payments, {neworders} NewOrders")
    state, depths = restock_depths(tpcc, eng, state, TPCC_TICKS)
    say("tpcc_timestamp", f"deepest restock chain per tick (committing "
        f"NewOrder entries on one STOCK row) over {TPCC_TICKS} more ticks: "
        f"{depths} ticks by depth; deepest {max(depths)} (closed form, no "
        "bound)")
    if sum(depths.values()) != TPCC_TICKS:
        raise AssertionError("not every tpcc_timestamp tick ran its effect "
                             "body once")
    # the one host read of an eager tick (its compact/full choice)
    packs, _ = trace_cell("tpcc_timestamp", eng, state, fused, 1,
                          ("base.py",))
    measure_new(packs, rec["names"], "tpcc_timestamp", rec["by_pack"])
    del eng, state

    for name, over, ticks in TO_CPU_TICKS:
        pool = pps_pool if name == "pps" else None
        fused.reset_launches()
        s, _, _, gpu, sg = phase_cpu_equal(cells, name, Engine, dev, ticks,
                                           pool=pool, **over)
        counted = dict(fused.LAUNCHES_BY_PACK)
        if not (s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0):
            raise AssertionError(f"{name} {over}: no commit or no abort")
        if name == "pps":
            # the pps T/O pack, from one tick of the CUDA run; its
            # launches are those of that run
            pnames, _, _ = pps_packs(gpu)
            packs = capture_packs(fused, lambda: gpu.tick(sg))
            measure_new(packs, pnames, "pps under TIMESTAMP", counted)
    return reb


def phase_mvcc(cells, Engine, timed_run, fused, rebase, dev, rows, names,
               by_pack, pps_pool):
    """MVCC on the card (phase 14 of the module docstring).  The packs an
    MVCC tick sorts that earlier phases did not are held to the plain
    version and timed into `rows`, named in `names`, and their launches on
    these paths go into `by_pack`.  Returns the ring-mode rebase record
    (``measure_rebase``) with its launches on the headline_mvcc run."""
    from deneva_tpu_torch.cc.mvcc import Mvcc
    from deneva_tpu_torch.workloads import tpcc

    def measure_new(packs, cell_names, cell, counted):
        new = {p: c for p, c in packs.items() if p not in rows}
        names.update(cell_names)
        measure_captured(fused, rows, new, cell_names, names, cell)
        by_pack.update({p: counted.get(p, 0) for p in new})

    # the rebase kernel runs twice on every tick: the rings in ring mode,
    # rts0 and w_floor in plain mode
    eng, state, hb, rebase_launches = phase_headline(
        cells, Engine, timed_run, fused, dev, "headline_mvcc")
    s = eng.summary(state)
    mb = sum(v.numel() * v.element_size() for v in state.db.values()) / 2**20
    say("headline_mvcc", f"rebase kernel launches={rebase_launches} over "
        f"{HEADLINE_TICKS} ticks; mvcc_tail_fold_cnt="
        f"{s['mvcc_tail_fold_cnt']}; version state on the card {mb:.1f} MB")
    if rebase_launches != {"plain": HEADLINE_TICKS, "ring": HEADLINE_TICKS}:
        raise AssertionError(f"{rebase_launches} rebase kernel launches on "
                             f"{HEADLINE_TICKS} headline_mvcc ticks, "
                             "expected 1 per tick of each rule")
    acc_names, _ = access_packs(eng, "headline")
    measure_new(capture_packs(fused, lambda: eng.tick(state)),
                {**PACK_NAMES, **acc_names}, "headline_mvcc", hb)
    reb = measure_rebase(rebase, state.db["w_ring"], state.db["r_ring"], dev,
                         "w_ring+r_ring", ring=True)
    reb["launches"] = rebase_launches["ring"]
    del eng, state

    eng, state, init, rec = run_effect_cell(
        cells, "tpcc_mvcc", Engine, timed_run, fused, dev, tpcc_packs,
        TPCC_TICKS, tpcc.checksums)
    payments, neworders, laws = check_tpcc_conservation(
        tpcc, eng.cfg, init, state.tables, rec["s"])
    say("tpcc_mvcc", f"conservation holds ({', '.join(laws)}): {payments} "
        f"Payments, {neworders} NewOrders; mvcc_tail_fold_cnt="
        f"{rec['s']['mvcc_tail_fold_cnt']}")
    state, depths = restock_depths(tpcc, eng, state, TPCC_TICKS)
    say("tpcc_mvcc", f"deepest restock chain per tick (committing NewOrder "
        f"entries on one STOCK row) over {TPCC_TICKS} more ticks: {depths} "
        "ticks by depth")
    if sum(depths.values()) != TPCC_TICKS:
        raise AssertionError("not every tpcc_mvcc tick ran its effect body "
                             "once")
    # the one host read of an eager tick (its compact/full choice)
    packs, _ = trace_cell("tpcc_mvcc", eng, state, fused, 1, ("base.py",))
    measure_new(packs, rec["names"], "tpcc_mvcc", rec["by_pack"])
    del eng, state

    for name, over, ticks in MV_CPU_TICKS:
        pool = pps_pool if name == "pps" else None
        fused.reset_launches()
        s, cpu, sc, gpu, sg = phase_cpu_equal(cells, name, Engine, dev, ticks,
                                              pool=pool, **over)
        counted = dict(fused.LAUNCHES_BY_PACK)
        if not s["txn_cnt"] > 0:
            raise AssertionError(f"{name} {over}: no commit")
        vis = Mvcc.visible(cpu.cfg, sc.db)
        say("cpu", f"{name} {over}: MVCC state equal, {vis['w_ring'].numel()}"
            f" ring cells, {int((vis['w_ring'] > 0).sum())} versions, "
            f"max w_floor {int(vis['w_floor'].max())}, mvcc_tail_fold_cnt="
            f"{s['mvcc_tail_fold_cnt']}")
        if name == "pps":
            # the pps MVCC pack, from one tick of the CUDA run; its
            # launches are those of that run
            pnames, _, _ = pps_packs(gpu)
            packs = capture_packs(fused, lambda: gpu.tick(sg))
            measure_new(packs, pnames, "pps under MVCC", counted)
        del cpu, sc, gpu, sg
    return reb


def phase_calvin(cells, Engine, timed_run, fused, dev, pps_pool):
    """CALVIN on the card (phase 15 of the module docstring).  Returns the
    record of its lock sort on tpcc_calvin (``measure_pack``) with its
    launches on that cell's timed ticks."""
    from deneva_tpu_torch.workloads import pps, tpcc

    def no_abort(name, s):
        if s["total_txn_abort_cnt"] or s["unique_txn_abort_cnt"]:
            raise AssertionError(f"the {name} run aborted: CALVIN never "
                                 "aborts")

    eng, state, _, rebase_launches = phase_headline(
        cells, Engine, timed_run, fused, dev, "headline_calvin")
    if rebase_launches:
        raise AssertionError(f"CALVIN launched the rebase kernel: "
                             f"{rebase_launches}")
    s = eng.summary(state)
    # phase_trace checked 2 launches, no host sync and no cummax per tick
    no_abort("headline_calvin", s)
    say("headline_calvin", f"total_txn_abort_cnt=0 twopl_wait_cnt="
        f"{s['twopl_wait_cnt']}")
    del eng, state

    eng, state, init, rec = run_effect_cell(
        cells, "tpcc_calvin", Engine, timed_run, fused, dev, tpcc_packs,
        TPCC_TICKS, tpcc.checksums)
    payments, neworders, laws = check_tpcc_conservation(
        tpcc, eng.cfg, init, state.tables, rec["s"])
    say("tpcc_calvin", f"conservation holds ({', '.join(laws)}): "
        f"{payments} Payments, {neworders} NewOrders")
    # the one host read of an eager tick (its compact/full choice)
    packs, _ = trace_cell("tpcc_calvin", eng, state, fused, 1,
                            ("base.py",))
    no_abort("tpcc_calvin", rec["s"])
    lock = (3, 2, eng.cfg.batch_size * eng.pool.max_req, 1)
    row = measure_pack(fused, "tpcc_calvin lock sort", packs[lock], 2, 1)
    row.update(pack=lock, launches=rec["by_pack"][lock])
    del eng, state

    eng, state, amount0, rec = run_effect_cell(
        cells, "pps_calvin", Engine, timed_run, fused, dev, pps_packs,
        PPS_TICKS, part_amount_sum)
    orders, upd = check_pps_conservation(pps, eng.cfg, eng.pool, amount0,
                                         state)
    s = rec["s"]
    say("pps_calvin", f"PART_AMOUNT conserved: {orders} ORDERPRODUCT part "
        f"writes, {upd} UPDATEPART commits; recon_cnt={s['recon_cnt']}")
    if not (orders > 0 and s["recon_cnt"] > 0):
        raise AssertionError("the pps_calvin run deferred no recon txn or "
                             "committed no ORDERPRODUCT")
    trace_cell("pps_calvin", eng, state, fused, 1, ("base.py",))
    no_abort("pps_calvin", s)
    del eng, state

    for name, ticks in CA_CPU_TICKS:
        _, _, sc, gpu, sg = phase_cpu_equal(
            cells, name, Engine, dev, ticks,
            pool=pps_pool if name == "pps_calvin" else None)
        bad = [f for f in sc.txn._fields
               if not torch.equal(getattr(sg.txn, f).cpu(),
                                  getattr(sc.txn, f))]
        if bad:
            raise AssertionError(f"{name}: CUDA and CPU txn slots differ: "
                                 f"{bad}")
        del sc, gpu, sg
    return row


def check_occ_counts(name, s):
    """Every OCC abort is a failed validation, of the history or of the
    active set."""
    hist, act = s["occ_hist_abort_cnt"], s["occ_active_abort_cnt"]
    say(name, f"vabort_cnt={s['vabort_cnt']} = occ_hist_abort_cnt={hist} + "
        f"occ_active_abort_cnt={act}; total_txn_abort_cnt="
        f"{s['total_txn_abort_cnt']} abort_rate={s['abort_rate']:.6f}")
    if hist + act != s["vabort_cnt"] or s["vabort_cnt"] \
            != s["total_txn_abort_cnt"] or not s["vabort_cnt"] > 0:
        raise AssertionError(f"{name}: OCC's abort counters do not add up")


def loop_step(eng, state):
    """One pass of OCC's fixed point (``cc/occ.py`` ``make_step``) on the
    entries of the txns of `state` that finish in its next tick (user
    aborts aside), after their history check; run to convergence first,
    so a pass changes nothing."""
    from deneva_tpu_torch.cc import occ
    from deneva_tpu_torch.engine.state import STATUS_RUNNING
    txn = state.txn
    finishing = (txn.status == STATUS_RUNNING) & (txn.cursor >= txn.n_req)
    valid_acc, pass1 = occ.history_check(state.db, txn, finishing)
    _, pass1, cols = occ.compact_live(eng.cfg, state.db, txn, valid_acc,
                                      pass1)
    step, _ = occ.make_step(txn.keys.shape[0], cols, pass1)
    while bool(step()):
        pass
    return step


def pass_bound(step, carry):
    """The least time of one pass of a loop body on this card, by bytes:
    every tensor its closure holds read once (the columns the pass reads)
    and the carry it updates in place, the tensors named in `carry`,
    written once, at PEAK_BYTES_PER_S.  Returns the bound in ms and the
    bytes."""
    held = {n: c.cell_contents for n, c in zip(step.__code__.co_freevars,
                                               step.__closure__)}
    tensors = {n: t for n, t in held.items() if isinstance(t, torch.Tensor)}
    bytes_ = sum(t.nbytes for t in tensors.values()) \
        + sum(tensors[n].nbytes for n in carry)
    return bytes_ / PEAK_BYTES_PER_S * 1e3, bytes_


def measure_body_pass(name, step, label="occ", carry=("valid", "conflict")):
    """One pass of a device loop's body on a live tick's entries (it has
    converged, so a pass changes nothing): CUDA events over 50 eager
    passes, and over a plain graph of 20 passes, with the graph's device
    time and kernels per pass (torch.profiler), and its byte bound
    (``pass_bound``; `carry` names the tensors it writes: OCC's verdicts
    and conflict flags, or MAAT's verdicts, bounds and pass count)."""
    from deneva_tpu_torch.engine.graph import no_collection_in_capture
    bound, bytes_ = pass_bound(step, carry)
    eager_ms = cuda_ms(step)
    graph = torch.cuda.CUDAGraph()
    with no_collection_in_capture(), torch.cuda.graph(graph):
        for _ in range(20):
            step()
    graph_ms = cuda_ms(graph.replay, reps=20) / 20
    busy_ms, kernels, _ = device_ms(graph.replay, reps=5)
    say(label, f"{name}: one pass of the loop's body {graph_ms:.4f} "
        f"ms in a graph ({busy_ms / 20 * 1e3:.1f} us on the device in "
        f"{kernels / 20:g} kernels, torch.profiler), {eager_ms:.4f} ms eager "
        f"(cuda events); bound {bound:.6f} ms ({bytes_} bytes)")
    del graph
    return dict(graph_ms=graph_ms, device_ms=busy_ms / 20,
                kernels=kernels / 20, eager_ms=eager_ms, bound_ms=bound,
                bound_bytes=bytes_)


#: the carry of MAAT's chain pass (``cc/maat.py`` ``make_chain``)
MAAT_CARRY = ("ok", "lo", "up", "passes")


def measure_while(dev):
    """The WHILE node on a bare loop, ``c += 1`` while ``c < n``: one
    captured graph runs n passes for n = 1, 5, 40 and 1,000 (and 1 for
    n = 0); per pass (CUDA events), the node's loop (replays at 1,001
    passes less 1), the body's other kernels (the step's two and the pass
    counter's bump) 1,000 times in a plain graph (the difference is the
    set-condition kernel and the node's next iteration), and the host loop that reads the flag once per pass (the
    plain version); the kernels a traced replay shows.  Returns the
    record; restores the launch counter."""
    from deneva_tpu_torch.engine.graph import no_collection_in_capture
    from deneva_tpu_torch.ops import device_loop
    c = torch.zeros((), dtype=torch.int32, device=dev)
    n = torch.tensor(1000, dtype=torch.int32, device=dev)

    def step():
        c.add_(1)
        return c < n

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    device_loop.run_while(step, "smoke", dev)
    b.record()
    torch.cuda.synchronize()
    host_pass_ms = a.elapsed_time(b) / 1000
    launches = device_loop.LAUNCHES
    graph = torch.cuda.CUDAGraph()
    with no_collection_in_capture(), torch.cuda.graph(graph):
        device_loop.run_while(step, "smoke", dev)
    device_loop.LAUNCHES = launches

    def replay(limit):
        n.fill_(limit)
        c.zero_()
        graph.replay()

    err = 0
    for limit in (1, 5, 40, 1000, 0):
        replay(limit)
        torch.cuda.synchronize()
        err = max(err, abs(int(c.item()) - max(limit, 1)))
    if err:
        raise AssertionError(f"WHILE node: pass counts off by {err}")
    t1 = cuda_ms(lambda: replay(1), reps=50)
    t1001 = cuda_ms(lambda: replay(1001), reps=20)
    while_pass_ms = (t1001 - t1) / 1000
    _, traced, _ = device_ms(lambda: replay(5), reps=5)
    # the body's kernels but the last: the step's two and the pass
    # counter's bump
    counter = device_loop.passes("smoke", dev)
    plain = torch.cuda.CUDAGraph()
    with no_collection_in_capture(), torch.cuda.graph(plain):
        for _ in range(1000):
            step()
            counter.add_(1)
    plain_graph_pass_ms = cuda_ms(plain.replay, reps=20) / 1000
    # per pass: c read and written (4 B each), c and n read and the flag
    # written by the compare (9 B), the pass counter read and written
    # (8 B each), the flag read by the set kernel (1 B)
    bytes_ = 34
    rec = dict(err=err, ms=while_pass_ms, plain_ms=host_pass_ms,
               plain_graph_pass_ms=plain_graph_pass_ms,
               set_condition_ms=while_pass_ms - plain_graph_pass_ms,
               bound_ms=bytes_ / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
               traced_kernels_per_replay=traced)
    say("while", f"bare loop: one captured graph ran 1, 5, 40, 1000 and 1 "
        f"(n = 0) passes, exact; per pass {while_pass_ms * 1e3:.3f} us in "
        f"the WHILE node (replays of 1,001 passes less 1, cuda events), "
        f"{plain_graph_pass_ms * 1e3:.3f} us for the body's other three "
        f"kernels in a plain graph, so the set-condition kernel and the "
        f"node's next iteration take {rec['set_condition_ms'] * 1e3:.3f} "
        f"us; the host loop {host_pass_ms * 1e3:.3f} us per pass (one flag "
        f"read each); a traced replay of 5 passes shows {traced:g} device "
        f"kernels (22 if the profiler sees the body's 4 per pass, 2 if "
        f"not); bound {rec['bound_ms']:.2e} ms ({bytes_} B)")
    del graph, plain
    return rec


def phase_occ(cells, Engine, timed_run, fused, dev, pps_pool):
    """OCC on the card (phase 16 of the module docstring).  Returns the
    record of each cell's validation sort (``measure_pack``, with its
    launches on the cell's timed ticks), by cell, and of the WHILE node
    (``measure_while``)."""
    from deneva_tpu_torch.ops import device_loop
    from deneva_tpu_torch.workloads import pps, tpcc

    def validation_row(name, eng, packs, counted):
        pack = (4, 2, eng.cfg.batch_size * eng.pool.max_req, 0)
        row = measure_pack(fused, f"{name} validation sort", packs[pack], 2,
                           0)
        row.update(pack=pack, launches=counted[pack])
        return row

    rows = {}
    # phase_trace checks 1 launch and 0 cummax per tick, and one host sync
    # per fixed-point pass
    eng, state, hb, rebase_launches = phase_headline(
        cells, Engine, timed_run, fused, dev, "headline_occ")
    if rebase_launches:
        raise AssertionError(f"OCC launched the rebase kernel: "
                             f"{rebase_launches}")
    check_occ_counts("headline_occ", eng.summary(state))
    measure_body_pass("headline_occ", loop_step(eng, state))
    rows["headline_occ"] = validation_row(
        "headline_occ", eng, capture_packs(fused, lambda: eng.tick(state)),
        hb)
    del eng, state

    eng, state, init, rec = run_effect_cell(
        cells, "tpcc_occ", Engine, timed_run, fused, dev, tpcc_packs,
        TPCC_TICKS, tpcc.checksums)
    payments, neworders, laws = check_tpcc_conservation(
        tpcc, eng.cfg, init, state.tables, rec["s"])
    say("tpcc_occ", f"conservation holds ({', '.join(laws)}): {payments} "
        f"Payments, {neworders} NewOrders")
    check_occ_counts("tpcc_occ", rec["s"])
    # the effect step's host read and one flag read per pass
    packs, _ = trace_cell("tpcc_occ", eng, state, fused, 1, ("base.py",))
    rows["tpcc_occ"] = validation_row("tpcc_occ", eng, packs, rec["by_pack"])
    body = measure_body_pass("tpcc_occ", loop_step(eng, state))
    del eng, state

    eng, state, amount0, rec = run_effect_cell(
        cells, "pps_occ", Engine, timed_run, fused, dev, pps_packs,
        PPS_TICKS, part_amount_sum)
    orders, upd = check_pps_conservation(pps, eng.cfg, eng.pool, amount0,
                                         state)
    say("pps_occ", f"PART_AMOUNT conserved: {orders} ORDERPRODUCT part "
        f"writes, {upd} UPDATEPART commits")
    check_occ_counts("pps_occ", rec["s"])
    packs, _ = trace_cell("pps_occ", eng, state, fused, 1, ("base.py",))
    rows["pps_occ"] = validation_row("pps_occ", eng, packs, rec["by_pack"])
    del eng, state

    for name, ticks in OC_CPU_TICKS:
        device_loop.reset_passes()
        _, cpu, sc, gpu, sg = phase_cpu_equal(
            cells, name, Engine, dev, ticks,
            pool=pps_pool if name == "pps_occ" else None)
        bad = [f for f in sc.txn._fields
               if not torch.equal(getattr(sg.txn, f).cpu(),
                                  getattr(sc.txn, f))]
        pg, pc = loop_passes(gpu), loop_passes(cpu)
        say("cpu", f"{name}: CUDA and CPU txn slots equal; fixed-point "
            f"passes {pg} on CUDA, {pc} on the CPU")
        if bad or pg != pc:
            raise AssertionError(f"{name}: CUDA and CPU differ: txn slots "
                                 f"{bad}, passes {pg} != {pc}")
        del cpu, sc, gpu, sg

    from deneva_tpu_torch.cc.occ import chain_pool
    phase_forced_chain(Engine, dev, chain_pool, OC_CHAIN, OC_CHAIN,
                       OC_CHAIN // 2, "occ")
    rec = measure_while(dev)
    rec["body"] = body
    return rows, rec


def phase_forced_chain(Engine, dev, chain_pool, n, want_passes,
                       want_commits, label):
    """A forced chain (``chain_pool(n)``: n txns finishing in tick 2, each
    reading the row the one before writes), run on the CPU, eagerly on
    CUDA and as graph replays: `want_passes` passes of the device loop in
    tick 2 (1 in each earlier tick), `want_commits` commits, and equal
    summaries and data; the replayed tick reads nothing on the host."""
    from deneva_tpu_torch.config import Config
    from deneva_tpu_torch.ops import device_loop
    from deneva_tpu_torch.profile_tick import host_syncs
    kw, pool = chain_pool(n)
    cfg = Config(fused_arbitrate=True, **kw)
    runs = {}
    for name, device, compiled in (("cpu", "cpu", False),
                                   ("cuda eager", dev, False),
                                   ("cuda graph", dev, True)):
        eng = Engine(cfg, pool=pool, device=device)
        box = [eng.advance(0, eng.init_state(), compiled=compiled)]
        per_tick = []

        def tick():
            box[0] = eng.advance(1, box[0], compiled=compiled)

        for t in range(3):
            device_loop.reset_passes()
            if compiled and t == 2:
                syncs, sites = host_syncs(tick, 1, "error")
            else:
                tick()
            per_tick.append(loop_passes(eng))
        state = eng._flush_body(box[0])
        runs[name] = (per_tick, eng.summary(state), state.data.cpu())
        del eng, state, box
    want = [1, 1, want_passes]
    for name, (per_tick, s, data) in runs.items():
        if per_tick != want or s["txn_cnt"] != want_commits \
                or s != runs["cpu"][1] or not torch.equal(data,
                                                          runs["cpu"][2]):
            raise AssertionError(f"forced chain, {name}: passes per tick "
                                 f"{per_tick} (want {want}), txn_cnt "
                                 f"{s['txn_cnt']}, or not equal to the CPU")
    say(label, f"forced chain of {n} txns finishing in one tick: passes per "
        f"tick {want} and {want_commits} commits on the CPU, eagerly on "
        "CUDA and in CUDA-graph replays (the WHILE node, 0 host syncs in "
        f"the chain's replayed tick: {syncs:g}); summaries and data equal")


def check_maat_counts(name, s):
    """Every MAAT abort is a validation whose range emptied; prints the six
    counters."""
    say(name, f"vabort_cnt={s['vabort_cnt']} = maat_range_abort_cnt="
        f"{s['maat_range_abort_cnt']} = total_txn_abort_cnt="
        f"{s['total_txn_abort_cnt']}; abort_rate={s['abort_rate']:.6f}; "
        f"maat_case1_cnt={s['maat_case1_cnt']} maat_case3_cnt="
        f"{s['maat_case3_cnt']} maat_chain_cap_cnt="
        f"{s['maat_chain_cap_cnt']} maat_chain_push_cnt="
        f"{s['maat_chain_push_cnt']} maat_chain_overflow_cnt="
        f"{s['maat_chain_overflow_cnt']}")
    if not (s["vabort_cnt"] == s["maat_range_abort_cnt"]
            == s["total_txn_abort_cnt"] > 0):
        raise AssertionError(f"{name}: MAAT's abort counters do not add up")


def maat_chain_step(eng, state):
    """One pass of MAAT's commit chain (``cc/maat.py`` ``make_chain``) on
    the entries of the txns of `state` that finish in its next tick (user
    aborts aside); run to its end first, so a pass changes nothing."""
    from deneva_tpu_torch.cc import maat
    from deneva_tpu_torch.engine.state import STATUS_RUNNING
    txn = state.txn
    finishing = (txn.status == STATUS_RUNNING) & (txn.cursor >= txn.n_req)
    step = maat.make_chain(eng.cfg, state.db, txn, finishing).step
    while bool(step()):
        pass
    return step


def check_maat_rebase(eng, state, rebase, dev):
    """MAAT's rebase (``Maat.on_ts_rebase``) on a copy of the cell's six
    arrays, with uppers of 0 among them (those the run left, and the first
    eight slots set to 0): at the shift of a tick that does not rebase (0)
    every array stays as it was; at 2^30 the CUDA path (the rebase
    kernel's ring rule on the rows) equals the CPU path (the plain
    version) on a host copy.  Restores the rebase kernel's launch
    counter."""
    before = dict(rebase.LAUNCHES)
    db = {k: state.db[k].clone() for k in MAAT_ARRAYS}
    natural = int((db["maat_upper"] == 0).sum().item())
    db["maat_upper"][:8] = 0
    for shift in (0, 2**30):
        got = {k: v.clone() for k, v in db.items()}
        want = {k: v.cpu() for k, v in db.items()}
        eng.plugin.on_ts_rebase(eng.cfg, got, torch.tensor(
            shift, dtype=torch.int64, device=dev))
        eng.plugin.on_ts_rebase(eng.cfg, want, torch.tensor(
            shift, dtype=torch.int64))
        ref = db if shift == 0 else want
        bad = [k for k in MAAT_ARRAYS
               if not torch.equal(got[k].cpu(), ref[k].cpu())]
        if bad:
            raise AssertionError(f"MAAT rebase at shift {shift}: {bad} "
                                 + ("changed" if shift == 0 else
                                    "differ from the plain version"))
        del got, want
    rebase.LAUNCHES.clear()
    rebase.LAUNCHES.update(before)
    say("rebase", f"MAAT's six arrays: shift 0 leaves every one as it was "
        f"({natural} uppers of 0 from the run and 8 more set to 0 stay 0); "
        "shift 2^30 on CUDA equals the plain version on the CPU")


def check_maat_bound(dev):
    """MAAT's chain flag on a step that always changes something: the host
    loop and one captured WHILE node stop it after exactly 66 passes, and
    after 1 with no row of two validators.  Restores the set-condition
    kernel's launch counter."""
    from deneva_tpu_torch.engine.graph import no_collection_in_capture
    from deneva_tpu_torch.cc import maat
    from deneva_tpu_torch.ops import device_loop
    passes = torch.zeros((), dtype=torch.int32, device=dev)
    needed = torch.ones((), dtype=torch.bool, device=dev)
    changed = torch.ones((), dtype=torch.bool, device=dev)

    def step():
        passes.add_(1)
        return maat.flag(needed, passes, changed)

    device_loop.run_while(step, "smoke_maat", dev)
    got = [int(passes.item())]
    launches = device_loop.LAUNCHES
    graph = torch.cuda.CUDAGraph()
    with no_collection_in_capture(), torch.cuda.graph(graph):
        device_loop.run_while(step, "smoke_maat", dev)
    device_loop.LAUNCHES = launches
    for need in (True, False):
        needed.fill_(need)
        passes.zero_()
        graph.replay()
        torch.cuda.synchronize()
        got.append(int(passes.item()))
    del graph
    want = [maat.MAX_PASSES, maat.MAX_PASSES, 1]
    if got != want:
        raise AssertionError(f"MAAT's chain bound: passes {got}, want {want} "
                             "(host loop, WHILE node, no chain)")
    say("maat", f"a step whose flag never clears: {got[0]} passes in the "
        f"host loop, {got[1]} in the WHILE node; {got[2]} when no row has "
        "two validators")


def phase_maat(cells, Engine, timed_run, fused, rebase, dev, rows, names,
               by_pack, pps_pool):
    """MAAT on the card (phase 17 of the module docstring).  Its two packs
    on each cell, captured from a live tick, are held to the plain version
    and timed into `rows`, named in `names`, with their launches on the
    cell's timed ticks in `by_pack`.  Returns the ring-mode rebase record
    on maat_lr+maat_lw (``measure_rebase``) with its launches on the
    headline_maat run, and one chain pass's time on headline_maat and
    tpcc_maat (``measure_body_pass``)."""
    from deneva_tpu_torch.cc.maat import chain_pool
    from deneva_tpu_torch.ops import device_loop
    from deneva_tpu_torch.workloads import pps, tpcc

    def measure_new(packs, cell_names, cell, counted):
        new = {p: c for p, c in packs.items() if p not in rows}
        names.update(cell_names)
        measure_captured(fused, rows, new, cell_names, names, cell)
        by_pack.update({p: counted.get(p, 0) for p in new})

    body = {}
    # phase_trace checks 2 launches per tick, the cummax calls and one
    # host sync per pass of the chain
    eng, state, hb, rebase_launches = phase_headline(
        cells, Engine, timed_run, fused, dev, "headline_maat")
    if rebase_launches != {"ring": HEADLINE_TICKS}:
        raise AssertionError(f"{rebase_launches} rebase kernel launches on "
                             f"{HEADLINE_TICKS} headline_maat ticks, "
                             "expected 1 per tick in ring mode")
    check_maat_counts("headline_maat", eng.summary(state))
    body["headline_maat"] = measure_body_pass(
        "headline_maat", maat_chain_step(eng, state), "maat", MAAT_CARRY)
    acc_names, _ = access_packs(eng, "headline")
    measure_new(capture_packs(fused, lambda: eng.tick(state)),
                {**PACK_NAMES, **acc_names}, "headline_maat", hb)
    check_maat_rebase(eng, state, rebase, dev)
    reb = measure_rebase(rebase, state.db["maat_lr"], state.db["maat_lw"],
                         dev, "maat_lr+maat_lw", ring=True)
    reb["launches"] = rebase_launches["ring"]
    del eng, state

    eng, state, init, rec = run_effect_cell(
        cells, "tpcc_maat", Engine, timed_run, fused, dev, tpcc_packs,
        TPCC_TICKS, tpcc.checksums)
    payments, neworders, laws = check_tpcc_conservation(
        tpcc, eng.cfg, init, state.tables, rec["s"])
    say("tpcc_maat", f"conservation holds ({', '.join(laws)}): {payments} "
        f"Payments, {neworders} NewOrders")
    check_maat_counts("tpcc_maat", rec["s"])
    # the effect step's host read and one flag read per pass
    packs, _ = trace_cell("tpcc_maat", eng, state, fused, 1, ("base.py",))
    measure_new(packs, rec["names"], "tpcc_maat", rec["by_pack"])
    body["tpcc_maat"] = measure_body_pass(
        "tpcc_maat", maat_chain_step(eng, state), "maat", MAAT_CARRY)
    del eng, state

    eng, state, amount0, rec = run_effect_cell(
        cells, "pps_maat", Engine, timed_run, fused, dev, pps_packs,
        PPS_TICKS, part_amount_sum)
    orders, upd = check_pps_conservation(pps, eng.cfg, eng.pool, amount0,
                                         state)
    say("pps_maat", f"PART_AMOUNT conserved: {orders} ORDERPRODUCT part "
        f"writes, {upd} UPDATEPART commits")
    check_maat_counts("pps_maat", rec["s"])
    packs, _ = trace_cell("pps_maat", eng, state, fused, 1, ("base.py",))
    measure_new(packs, rec["names"], "pps_maat", rec["by_pack"])
    del eng, state

    for name, ticks in MA_CPU_TICKS:
        device_loop.reset_passes()
        _, cpu, sc, gpu, sg = phase_cpu_equal(
            cells, name, Engine, dev, ticks,
            pool=pps_pool if name == "pps_maat" else None)
        bad = [f for f in sc.txn._fields
               if not torch.equal(getattr(sg.txn, f).cpu(),
                                  getattr(sc.txn, f))]
        pg, pc = loop_passes(gpu), loop_passes(cpu)
        say("cpu", f"{name}: CUDA and CPU txn slots and the six MAAT arrays "
            f"equal; chain passes {pg} on CUDA, {pc} on the CPU")
        if bad or pg != pc:
            raise AssertionError(f"{name}: CUDA and CPU differ: txn slots "
                                 f"{bad}, passes {pg} != {pc}")
        del cpu, sc, gpu, sg

    for n, passes, commits in MA_CHAINS:
        phase_forced_chain(Engine, dev, chain_pool, n, passes, commits,
                           "maat")
    check_maat_bound(dev)
    return reb, body


#: the lock family's opt-in cells (``cells.py``): phase 18 and the graph
#: phase
LO_CELLS = ("headline_subticks", "headline_timestamp_subticks",
            "pps_wait_die_dense", "headline_read_committed")
#: lock opt-ins: timed eager ticks, ticks held CPU == CUDA, ticks held
#: eager == replayed one by one, and ticks of the two-engine checks
LO_TICKS = 50
LO_CPU_TICKS = 20
LO_STEP_TICKS = 12
LO_PAIR_TICKS = 50
#: the sub-rounds of the sub-tick cells
LO_K = 8


def line_without_host_keys(eng, state):
    """The ``[summary]`` line less the host-process keys (read from /proc
    by the process that prints it)."""
    return [kv for kv in eng.summary_line(state).split(",")
            if not kv.startswith(("mem_util=", "cpu_util="))]


def same_state(label, a_eng, a, b_eng, b, skip_db=()):
    """Summary, ``[summary]`` line, data, tables, CC arrays (less those
    named in `skip_db`) and txn slots of two flushed runs equal; raises
    naming what differs."""
    sa, sb = a_eng.summary(a), b_eng.summary(b)
    diff = {k: (sa[k], sb.get(k)) for k in sa
            if k != "ccl_samples" and sa[k] != sb.get(k)}
    if diff or sa != sb:
        raise AssertionError(f"{label}: summaries differ: {diff}")
    if line_without_host_keys(a_eng, a) != line_without_host_keys(b_eng, b):
        raise AssertionError(f"{label}: [summary] lines differ")
    bad = [] if torch.equal(a.data.cpu(), b.data.cpu()) else ["data"]
    for part in ("tables", "db"):
        x, y = getattr(a, part), getattr(b, part)
        if part == "db":
            x = {k: v for k, v in x.items() if k not in skip_db}
            y = {k: v for k, v in y.items() if k not in skip_db}
        if sorted(x) != sorted(y):
            bad.append(part)
            continue
        bad += [f"{part}.{k}" for k in x
                if not torch.equal(x[k].cpu(), y[k].cpu())]
    bad += [f"txn.{f}" for f in a.txn._fields
            if not torch.equal(getattr(a.txn, f).cpu(),
                               getattr(b.txn, f).cpu())]
    if bad:
        raise AssertionError(f"{label}: {bad} differ")
    return sb


def trace_once(name, eng, state, fused, per_tick):
    """One torch.profiler trace of TRACE_TICKS eager ticks, taken once (no
    retry): the host records of the sort wrapper and of torch.cummax in
    its recorded step are exact, so the tick must show `per_tick` sort
    calls and 0 torch.cummax calls and 0 cummax device kernels in this
    one trace.  Returns the per-tick numbers and the state."""
    from deneva_tpu_torch.profile_tick import breakdown, trace_kernels
    box, host = [state], {}
    orig = fused._fused_sort_scan_cuda

    def recorded(*a, **k):
        with torch.profiler.record_function("fused_sort_scan_wrapper"):
            return orig(*a, **k)

    def tick():
        box[0] = eng.tick(box[0])

    fused._fused_sort_scan_cuda = recorded
    try:
        kernels = trace_kernels(tick, TRACE_TICKS, None, host)
    finally:
        fused._fused_sort_scan_cuda = orig
    # the annotation's own span on the device timeline is no kernel
    per = breakdown([e for e in kernels
                     if e.key != "fused_sort_scan_wrapper"], TRACE_TICKS)
    calls = host.get("fused_sort_scan_wrapper", 0) / TRACE_TICKS
    cummax = host.get("aten::_cummax_helper", 0) / TRACE_TICKS
    if calls != per_tick or cummax != 0 or per["cummax_launches"] != 0:
        raise AssertionError(
            f"{name}: one trace of {TRACE_TICKS} ticks: {calls} sort calls "
            f"per tick (want {per_tick}), {cummax} torch.cummax calls and "
            f"{per['cummax_launches']} cummax device kernels (want 0)")
    per["sort_calls"] = calls
    return per, box[0]


def step_equal(name, eng, ticks):
    """`ticks` ticks from the cell's initial state, eager and replayed one
    at a time, every tensor of the two states equal after each tick."""
    from deneva_tpu_torch.engine.graph import state_items
    se = eng.init_state()
    sg = eng.advance(0, eng.init_state(), compiled=True)
    for t in range(ticks):
        se = eng.advance(1, se)
        sg = eng.advance(1, sg, compiled=True)
        bad = [k for (k, x), (_, y) in zip(state_items(se), state_items(sg))
               if not torch.equal(x, y)]
        if bad or se.host_tick != sg.host_tick:
            raise AssertionError(f"{name}: tick {t}: eager and replayed "
                                 f"states differ: {bad}")
    eng._flush_body(se)
    eng._flush_body(sg)
    same_state(f"{name} eager == replayed", eng, se, eng, sg)


def lock_cell(cells, name, Engine, timed_run, fused, dev, rows):
    """One opt-in cell on the card: LO_TICKS eager ticks timed after the
    warm-up, with the sort kernel's launches by pack (``graph_packs``; the
    access phase's 2K + 1 a tick on the sub-tick cells), 0 fallbacks and the increment
    oracle; one trace (``trace_once``) and the eager idle share; the host
    syncs of a tick (0 on YCSB, the effect choice on pps); every pack the
    access phase sorts, taken from a live tick, held bit-equal to the plain
    version and timed as a row of its own (into `rows`, by cell and pack);
    then eager == replayed tick by tick.  Returns the engine's pool."""
    eng = Engine(cells.config(name), device=dev)
    acc_names, every = access_packs(eng, name)
    if name in ("headline_subticks", "headline_timestamp_subticks") \
            and sum(every.values()) != 2 * LO_K + 1:
        raise AssertionError(f"{name}: {every} sorts a tick planned")
    # the access phase's sorts, and on pps the compacted effect body's
    every = graph_packs(eng)[1]
    per_tick = sum(every.values())
    state = eng.run(WARMUP_TICKS)
    before = eng.summary(state)["txn_cnt"]
    fused.reset_fallbacks()
    fused.reset_launches()
    state, sec = timed_run(eng, LO_TICKS, state)
    by_pack = dict(fused.LAUNCHES_BY_PACK)
    s = eng.summary(state)
    want = {p: n * LO_TICKS for p, n in every.items()}
    if by_pack != want or fused.fallback_snapshot()["count"]:
        raise AssertionError(f"{name}: launches by pack {by_pack}, want "
                             f"{want}; fallbacks "
                             f"{fused.fallback_snapshot()}")
    if int(state.data.sum().item()) != s["write_cnt"] \
            or not s["txn_cnt"] > 0:
        raise AssertionError(f"{name}: data.sum() != write_cnt or no commit")
    print(eng.summary_line(state))
    per, state = trace_once(name, eng, state, fused, per_tick)
    eager_ms = sec * 1e3
    want_syncs = 1 if eng.cfg.workload != "YCSB" else 0
    files = ("base.py",) if want_syncs else ()
    box = [state]

    def tick():
        box[0] = eng.tick(box[0])

    syncs, _, sites = loop_syncs(eng, tick, TRACE_TICKS, want_syncs, files)
    say("lock", f"{name}: {LO_TICKS} eager ticks {eager_ms:.4f} ms per tick "
        f"(cuda events), commits_per_tick="
        f"{(s['txn_cnt'] - before) / LO_TICKS} abort_rate="
        f"{s['abort_rate']:.6f} twopl_wait_cnt={s['twopl_wait_cnt']}; sort "
        f"launches by pack {by_pack} ({per_tick} per tick), 0 fallbacks")
    say("lock", f"{name}: one trace, no retry: {per['sort_calls']:g} sort "
        f"calls per tick (host records of the wrapper), "
        f"{per['fused_sort_scan_launches']:g} fused device kernels, "
        f"torch.cummax 0 calls and {per['cummax_launches']:g} device "
        f"kernels; device busy {per['device_busy_us']:.1f} us, "
        f"{per['kernel_launches']:.1f} device launches per tick; eager idle "
        f"{1 - per['device_busy_us'] / 1e3 / eager_ms:.3f}; host syncs "
        f"{syncs:g} per tick at {sites or 'no line'}")
    packs = capture_packs(fused, tick)
    eng._flush_body(box[0])
    for pack, cols in sorted(packs.items()):
        if pack not in acc_names:
            continue
        r = measure_pack(fused, acc_names[pack], cols, pack[1], pack[3])
        r.update(pack=pack, launches=by_pack[pack], replayed=0)
        rows[(name, pack)] = dict(r, label=acc_names[pack])
    step_equal(name, eng, LO_STEP_TICKS)
    say("lock", f"{name}: {LO_STEP_TICKS} ticks from the start, eager == "
        "replayed tick by tick (every tensor of the state)")
    pool = eng.pool
    del eng, state, box
    gc.collect()
    torch.cuda.empty_cache()
    return pool


def phase_lock_optins(cells, Engine, timed_run, fused, dev):
    """The lock family's arbitration opt-ins on the card (phase 18 of the
    module docstring).  Returns the rows of their packs, by (cell,
    pack)."""
    rows = {}
    pools = {}
    for name in LO_CELLS:
        pools[name] = lock_cell(cells, name, Engine, timed_run, fused, dev,
                                rows)
        s, cpu, sc, gpu, sg = phase_cpu_equal(
            cells, name, Engine, dev, LO_CPU_TICKS, pool=pools[name])
        same_state(f"{name} CUDA == CPU", gpu, sg, cpu, sc)
        del cpu, sc, gpu, sg

    # dense == the sorted join, one pool each, WARMUP_TICKS +
    # HEADLINE_TICKS eager ticks
    for dense, plain, pool in (
            ("headline", "headline", None),
            ("pps_wait_die_dense", "pps_wait_die", pools["pps_wait_die_dense"])):
        over = {"dense_lock_state": True} if dense == "headline" else {}
        a = Engine(cells.config(dense, **over), pool=pool, device=dev)
        b = Engine(cells.config(plain), pool=a.pool, device=dev)
        sa, sb = a.run(WARMUP_TICKS), b.run(WARMUP_TICKS)
        c0 = a.summary(sa)["txn_cnt"]
        sa, sb = a.run(HEADLINE_TICKS, sa), b.run(HEADLINE_TICKS, sb)
        s = same_state(f"{dense} dense == {plain} sorted join", a, sa, b, sb,
                       skip_db=("lk_held",))
        if "lk_held" in sb.db or not bool((sa.db["lk_held"] == 2**31 - 1)
                                          .all()):
            raise AssertionError(f"{dense}: lk_held not at its identity")
        say("lock", f"dense_lock_state == the sorted join on one {plain} "
            f"pool, {WARMUP_TICKS} + {HEADLINE_TICKS} ticks: summary, "
            f"[summary], data, {len(sa.tables)} tables and txn slots equal; "
            f"commits_per_tick={(s['txn_cnt'] - c0) / HEADLINE_TICKS} "
            f"abort_rate={s['abort_rate']:.6f}; lk_held at its identity")
        del a, b, sa, sb

    # pipeline_exchange == the in-order rounds
    a = Engine(cells.config("headline_subticks"), device=dev)
    b = Engine(cells.config("headline_subticks", pipeline_exchange=True),
               pool=a.pool, device=dev)
    s = same_state("headline_subticks pipelined == in order", a,
                   a.run(LO_PAIR_TICKS), b, b.run(LO_PAIR_TICKS))
    say("lock", f"headline_subticks: pipeline_exchange == the in-order "
        f"rounds over {LO_PAIR_TICKS} ticks (txn_cnt={s['txn_cnt']}, "
        f"abort_rate={s['abort_rate']:.6f})")
    del a, b

    # READ_UNCOMMITTED and NOLOCK on the headline: CPU == CUDA, eager ==
    # replayed
    for level in ("READ_UNCOMMITTED", "NOLOCK"):
        s, cpu, sc, gpu, sg = phase_cpu_equal(
            cells, "headline", Engine, dev, LO_PAIR_TICKS,
            isolation_level=level)
        same_state(f"headline {level} CUDA == CPU", gpu, sg, cpu, sc)
        rep = gpu.run_compiled(LO_PAIR_TICKS)
        s = same_state(f"headline {level} eager == replayed", gpu, sg, gpu,
                       rep)
        if level == "NOLOCK" and s["total_txn_abort_cnt"] != 0:
            raise AssertionError("an abort under NOLOCK")
        say("lock", f"headline {level}: {LO_PAIR_TICKS} ticks CUDA == CPU "
            f"and eager == replayed (txn_cnt={s['txn_cnt']}, abort_rate="
            f"{s['abort_rate']:.6f})")
        del cpu, sc, gpu, sg, rep
        gc.collect()
        torch.cuda.empty_cache()
    return rows


#: commit after access: the four cells, each beside its flagless cell
CAA_CELLS = ("headline_caa", "headline_occ_caa", "headline_maat_caa",
             "tpcc_calvin_caa")
#: commit after access: timed eager ticks, and the CPU == CUDA checks with
#: the flag on other plugins (cell, overrides, ticks: the *_CPU_TICKS
#: lengths of their phases)
CAA_TICKS = 50
CAA_CPU_TICKS = 20
CAA_CPU_OTHERS = (("headline", {"cc_alg": "WAIT_DIE"}, 20),
                  ("headline", {"cc_alg": "TIMESTAMP"}, 20),
                  ("headline", {"cc_alg": "MVCC"}, 20),
                  ("pps", {}, PPS_CPU_TICKS),
                  ("pps", {"cc_alg": "MAAT"}, 20))


def caa_window(eng, state, timed_run, fused, rebase):
    """WARMUP_TICKS eager ticks from `state`, then CAA_TICKS timed (CUDA
    events): the sort kernel's launches by pack against ``graph_packs``'s
    plan for the effect bodies taken, 0 fallbacks, the rebase kernel's
    launches, the loop's passes, commits per tick, abort rate and the
    short latency.  Returns the state and a record of the window."""
    wl = eng.workload
    state = eng.run(WARMUP_TICKS, state)
    s0 = eng.summary(state)
    fused.reset_fallbacks()
    fused.reset_launches()
    rebase.reset_launches()
    b0, p0 = wl.branch_ticks, loop_passes(eng)
    state, sec = timed_run(eng, CAA_TICKS, state)
    b1, passes = wl.branch_ticks, loop_passes(eng) - p0
    by_pack = dict(fused.LAUNCHES_BY_PACK)
    c, f = (b1[k] - b0[k] for k in ("compact", "full"))
    if eng.cfg.workload == "YCSB":
        c = CAA_TICKS
    want = planned_launches(eng, c, f)
    if by_pack != want or fused.fallback_snapshot()["count"]:
        raise AssertionError(f"{eng.cfg}: launches by pack {by_pack}, want "
                             f"{want}; fallbacks {fused.fallback_snapshot()}")
    s = eng.summary(state)
    commits = s["txn_cnt"] - s0["txn_cnt"]
    aborts = s["total_txn_abort_cnt"] - s0["total_txn_abort_cnt"]
    if int(state.data.sum().item()) != s["write_cnt"] or not commits > 0:
        raise AssertionError(f"{eng.cfg.cc_alg}: data.sum() != write_cnt or "
                             "no commit")
    lat = np.asarray(s["ccl_samples"])
    return state, dict(s=s, s0=s0, by_pack=by_pack,
                       rebase=dict(rebase.LAUNCHES),
                       ms=sec * 1e3, passes=passes / CAA_TICKS,
                       commits=commits / CAA_TICKS,
                       abort_rate=aborts / max(aborts + commits, 1),
                       lat=s["avg_latency_ticks_short"],
                       lat_p50=float(np.percentile(lat, 50)),
                       lat_p99=float(np.percentile(lat, 99)))


def trace_flag_cell(label, name, eng, state, fused, eager_ms):
    """On an opt-in cell's engine `eng`, from `state`: one trace
    (``trace_ticks``: its torch.cummax calls), the sort wrapper's launches
    per traced tick and a captured tick's, each as ``graph_packs`` plans,
    and the host syncs of an eager tick (the effect choice on TPC-C and
    PPS, the loop's flag reads).  Returns a box holding the state after
    those ticks, and the tick that advances it."""
    box, per_call = [state], []

    def tick():
        n0 = fused.LAUNCHES
        box[0] = eng.tick(box[0])
        per_call.append(fused.LAUNCHES - n0)

    want_tick = sum(graph_packs(eng)[1].values())
    per, passes = trace_ticks(name, eng, tick)
    if set(per_call) != {want_tick}:
        raise AssertionError(f"{name}: sort wrapper launches per traced tick "
                             f"{sorted(set(per_call))}, want {want_tick}")
    nodes = captured_tick(name, eng, box[0])
    want_syncs = 1 if eng.cfg.workload != "YCSB" else 0
    syncs, passes_s, sites = loop_syncs(
        eng, tick, TRACE_TICKS, want_syncs,
        ("base.py",) if want_syncs else ())
    say(label, f"{name}: one trace of {TRACE_TICKS} ticks: device busy "
        f"{per['device_busy_us']:.1f} us per tick, "
        f"{per['kernel_launches']:.1f} device launches, fused kernel "
        f"{per['fused_sort_scan_launches']:g} traced (wrapper count "
        f"{want_tick}), torch.cummax {per['cummax_calls']:g} calls "
        f"({passes:g} loop passes per tick), eager idle "
        f"{1 - per['device_busy_us'] / 1e3 / eager_ms:.3f}; "
        f"{nodes.get('kernel', 0)} kernel nodes in a captured tick; host "
        f"syncs {syncs:g} per eager tick at {sites or 'no line'} "
        f"({passes_s:g} loop passes per tick)")
    return box, tick


def caa_cell(cells, name, Engine, timed_run, fused, rebase, dev):
    """One commit-after-access cell and its flagless cell on one pool (see
    ``caa_window``): the same sort launches by pack and rebase launches per
    tick; the increment oracle, and TPC-C's conservation laws on
    tpcc_calvin_caa; then, on the flag's engine, a trace (its torch.cummax
    calls: 7 + 1 per chain pass on headline_maat_caa, 0 elsewhere), the
    sort wrapper's launches per tick and a captured tick's, the host syncs
    of an eager tick (the effect choice on tpcc, the loop's flag reads),
    ``LO_STEP_TICKS`` ticks eager == replayed tick by tick, and CPU == CUDA
    after CAA_CPU_TICKS ticks."""
    from deneva_tpu_torch.workloads import tpcc
    base = name.removesuffix("_caa")
    a = Engine(cells.config(name), device=dev)
    b = Engine(cells.config(base), pool=a.pool, device=dev)
    recs = []
    for eng in (b, a):
        state = eng.init_state()
        init = tpcc.checksums(state.tables) \
            if eng.cfg.workload == "TPCC" else None
        state, r = caa_window(eng, state, timed_run, fused, rebase)
        if init is not None:
            check_tpcc_conservation(tpcc, eng.cfg, init, state.tables,
                                    r["s"])
        print(eng.summary_line(state))
        recs.append(r)
    rb, ra = recs
    if ra["by_pack"] != rb["by_pack"] or ra["rebase"] != rb["rebase"]:
        raise AssertionError(f"{name}: sort launches {ra['by_pack']} and "
                             f"rebase launches {ra['rebase']}, the flagless "
                             f"cell's {rb['by_pack']} and {rb['rebase']}")
    for r, label in ((rb, base), (ra, name)):
        say("caa", f"{label}: {CAA_TICKS} eager ticks after {WARMUP_TICKS} "
            f"{r['ms']:.4f} ms per tick (cuda events), commits_per_tick="
            f"{r['commits']} abort_rate={r['abort_rate']:.6f} "
            f"avg_latency_ticks_short={r['lat']:.6f} (ring p50 "
            f"{r['lat_p50']:g}, p99 {r['lat_p99']:g}) loop passes per tick "
            f"{r['passes']:g}; sort launches by pack {r['by_pack']}, 0 "
            f"fallbacks; rebase launches {r['rebase']}")
    say("caa", f"{name} against {base}: commits per tick x"
        f"{ra['commits'] / rb['commits']:.4f}, abort rate "
        f"{ra['abort_rate']:.6f} against {rb['abort_rate']:.6f}, short "
        f"latency x{ra['lat'] / rb['lat']:.4f}")
    del b
    gc.collect()

    box, _ = trace_flag_cell("caa", name, a, state, fused, ra["ms"])
    a._flush_body(box[0])
    del state, box
    step_equal(name, a, LO_STEP_TICKS)
    say("caa", f"{name}: {LO_STEP_TICKS} ticks from the start, eager == "
        "replayed tick by tick (every tensor of the state)")
    pool = a.pool
    del a
    gc.collect()
    torch.cuda.empty_cache()
    s, cpu, sc, gpu, sg = phase_cpu_equal(cells, name, Engine, dev,
                                          CAA_CPU_TICKS, pool=pool)
    same_state(f"{name} CUDA == CPU", gpu, sg, cpu, sc)
    del cpu, sc, gpu, sg
    gc.collect()
    torch.cuda.empty_cache()


def phase_commit_after(cells, Engine, timed_run, fused, rebase, dev,
                       pps_pool):
    """Commit after access on the card (phase 19 of the module docstring):
    ``caa_cell`` on each of CAA_CELLS, then CPU == CUDA with the flag on
    under the other plugins (CAA_CPU_OTHERS), txn slots included."""
    for name in CAA_CELLS:
        caa_cell(cells, name, Engine, timed_run, fused, rebase, dev)
    for cell, over, ticks in CAA_CPU_OTHERS:
        s, cpu, sc, gpu, sg = phase_cpu_equal(
            cells, cell, Engine, dev, ticks,
            pool=pps_pool if cell == "pps" else None,
            commit_after_access=True, **over)
        same_state(f"{cell} {over} commit_after_access CUDA == CPU", gpu,
                   sg, cpu, sc)
        del cpu, sc, gpu, sg
        gc.collect()
        torch.cuda.empty_cache()


#: live-entry compaction (phase 21): the four cells, each beside its
#: flagless cell
CP_CELLS = ("headline_compact", "tpcc_compact", "headline_mvcc_compact",
            "headline_maat_compact")
CP_CPU_TICKS = 20
#: CPU == CUDA on cells the four do not cover (cell, overrides, ticks):
#: CALVIN's auto bucket is the identity (it requests every access), so it
#: takes half its B*R; 8,192 lanes (one per txn slot) spill
CP_CPU_OTHERS = (("headline", {"cc_alg": "WAIT_DIE", "compact_auto": True},
                  20),
                 ("headline", {"cc_alg": "TIMESTAMP", "compact_auto": True},
                  20),
                 ("headline_occ", {"compact_auto": True}, 20),
                 ("pps", {"compact_auto": True}, PPS_CPU_TICKS),
                 ("tpcc_calvin", {"compact_lanes": 135168}, 20),
                 ("headline", {"compact_lanes": 8192}, 20))


def compact_cell(cells, name, Engine, timed_run, fused, rebase, dev, rows):
    """One compaction cell and its flagless cell on one pool
    (``caa_window``: launches by pack as planned, 0 fallbacks, the
    increment oracle, and TPC-C's conservation laws on tpcc_compact): the
    flagless cell's sorts a tick at K lanes plus the compaction pack (and
    on the access path the expansion pack), the same rebase launches;
    commits per tick, abort rate, ``compact_overflow_cnt`` and
    ``live_entry_cnt`` per tick side by side; then, on the flag's engine,
    a trace (torch.cummax: 7 + 1 per chain pass on headline_maat_compact,
    0 elsewhere), the sort wrapper's launches per tick and a captured
    tick's, the host syncs of an eager tick (as the flagless cell's: the
    effect choice on tpcc, the loop's flag reads), every pack the flagless
    cell does not sort, taken from a live tick, held bit-equal to the
    plain version and timed as a row of its own (into `rows`, by cell and
    pack), ``LO_STEP_TICKS`` ticks eager == replayed tick by tick, and
    CPU == CUDA after CP_CPU_TICKS ticks."""
    from deneva_tpu_torch.workloads import tpcc
    base = name.removesuffix("_compact")
    a = Engine(cells.config(name), device=dev)
    b = Engine(cells.config(base), pool=a.pool, device=dev)
    recs = []
    for eng in (b, a):
        state = eng.init_state()
        init = tpcc.checksums(state.tables) \
            if eng.cfg.workload == "TPCC" else None
        state, r = caa_window(eng, state, timed_run, fused, rebase)
        if init is not None:
            check_tpcc_conservation(tpcc, eng.cfg, init, state.tables,
                                    r["s"])
        print(eng.summary_line(state))
        recs.append(r)
    rb, ra = recs
    extra = 1 if a.plugin.name in LOOP_SITES else 2
    per_a = sum(ra["by_pack"].values()) / CAA_TICKS
    per_b = sum(rb["by_pack"].values()) / CAA_TICKS
    if per_a != per_b + extra or ra["rebase"] != rb["rebase"]:
        raise AssertionError(f"{name}: sort launches {ra['by_pack']} and "
                             f"rebase launches {ra['rebase']}, the flagless "
                             f"cell's {rb['by_pack']} and {rb['rebase']} "
                             f"plus {extra} a tick")
    N = a.cfg.batch_size * a.pool.max_req
    K = a.cfg.compact_width(N, a.cfg.batch_size)
    delta = lambda r, k: (r["s"].get(k, 0) - r["s0"].get(k, 0)) / CAA_TICKS
    for r, label in ((rb, base), (ra, name)):
        say("compact", f"{label}: {CAA_TICKS} eager ticks after "
            f"{WARMUP_TICKS} {r['ms']:.4f} ms per tick (cuda events), "
            f"commits_per_tick={r['commits']} abort_rate="
            f"{r['abort_rate']:.6f} compact_overflow_cnt per tick "
            f"{delta(r, 'compact_overflow_cnt'):g} live_entry_cnt per tick "
            f"{delta(r, 'live_entry_cnt'):g} loop passes per tick "
            f"{r['passes']:g}; sort launches by pack {r['by_pack']}, 0 "
            f"fallbacks; rebase launches {r['rebase']}")
    say("compact", f"{name} (K = {K} of {N} lanes) against {base}: eager "
        f"tick x{ra['ms'] / rb['ms']:.4f}, commits per tick x"
        f"{ra['commits'] / rb['commits']:.4f}, abort rate "
        f"{ra['abort_rate']:.6f} against {rb['abort_rate']:.6f}; "
        f"{per_a:g} sorts a tick against {per_b:g}")
    flagless = set(graph_packs(b)[1])
    del b
    gc.collect()

    box, tick = trace_flag_cell("compact", name, a, state, fused, ra["ms"])
    names = graph_packs(a)[0]
    body = None
    if a.plugin.name == "MAAT":
        # one chain pass at K lanes, as phase 17 times it at B*R
        body = measure_body_pass(name, maat_chain_step(a, box[0]),
                                 "compact", MAAT_CARRY)
    packs = capture_packs(fused, tick)
    a._flush_body(box[0])
    for pack, cols in sorted(packs.items()):
        if pack in flagless:
            continue
        # the pack's name less the workload's prefix, after the cell's
        label = f"{name} {names[pack].split(' ', 1)[1]} (K = {K})"
        r = measure_pack(fused, label, cols, pack[1], pack[3])
        r.update(pack=pack, launches=ra["by_pack"][pack], replayed=0)
        rows[(name, pack)] = dict(r, label=label)
    del state, box
    step_equal(name, a, LO_STEP_TICKS)
    say("compact", f"{name}: {LO_STEP_TICKS} ticks from the start, eager == "
        "replayed tick by tick (every tensor of the state)")
    pool = a.pool
    del a
    gc.collect()
    torch.cuda.empty_cache()
    s, cpu, sc, gpu, sg = phase_cpu_equal(cells, name, Engine, dev,
                                          CP_CPU_TICKS, pool=pool)
    same_state(f"{name} CUDA == CPU", gpu, sg, cpu, sc)
    del cpu, sc, gpu, sg
    gc.collect()
    torch.cuda.empty_cache()
    return body


def phase_compaction(cells, Engine, timed_run, fused, rebase, dev, pps_pool,
                     rows):
    """Live-entry compaction on the card (phase 21 of the module
    docstring): ``compact_cell`` on each of CP_CELLS, then CPU == CUDA on
    CP_CPU_OTHERS, txn slots included; the spilling case must spill.
    Returns MAAT's chain pass at K, by cell."""
    bodies = {}
    for name in CP_CELLS:
        body = compact_cell(cells, name, Engine, timed_run, fused, rebase,
                            dev, rows)
        if body is not None:
            bodies[name] = body
    for cell, over, ticks in CP_CPU_OTHERS:
        s, cpu, sc, gpu, sg = phase_cpu_equal(
            cells, cell, Engine, dev, ticks,
            pool=pps_pool if cell == "pps" else None, **over)
        same_state(f"{cell} {over} CUDA == CPU", gpu, sg, cpu, sc)
        say("compact", f"{cell} {over}: compact_overflow_cnt="
            f"{s['compact_overflow_cnt']} live_entry_cnt="
            f"{s['live_entry_cnt']} after {ticks} ticks, CUDA == CPU")
        if over.get("compact_lanes") == 8192 \
                and not s["compact_overflow_cnt"] > 0:
            raise AssertionError(f"{cell} {over}: no spill")
        del cpu, sc, gpu, sg
        gc.collect()
        torch.cuda.empty_cache()
    return bodies


#: the sharded engine (phase 22): its cell, the ticks held eager ==
#: replayed, the timed windows, and the CPU == CUDA cells with overrides
SH_CELL = "headline_sharded4"
SH_TICKS = 20
SH_WINDOW = 50
SH_CPU_CELLS = (("sharded2_small", {}), ("sharded8_small", {}),
                ("sharded2_small", {"route_capacity_factor": 0.1}))


def sharded_packs(eng):
    """The sorts of a sharded tick, by (columns, keys, lanes, shift), with
    their names, and their launches per tick: on each of the N nodes the
    routing packs of exchange A (dest, held-first, lane) and exchange B
    (dest, ts, lane), one pack shape of 3 columns by 2 keys at B*R lanes,
    and the owner's NO_WAIT lock sort (3 by 2, row shift 1) and unpermute
    (2 by 1) at its N*C + B*R lanes (NO_WAIT's validation sorts
    nothing)."""
    N = eng.cfg.node_cnt
    nE = eng.cfg.batch_size * eng.pool.max_req
    nV = N * eng.cap + nE
    names = {(3, 2, nE, 0): "sharded routing A / B",
             (3, 2, nV, 1): "sharded owner lock sort",
             (2, 1, nV, 0): "sharded owner unpermute"}
    return names, {(3, 2, nE, 0): 2 * N, (3, 2, nV, 1): N, (2, 1, nV, 0): N}


def sharded_calls(fused, eng, state):
    """The operands of every ``fused_sort_scan`` call of one tick from
    `state`, in call order (the state moves one tick)."""
    calls = []
    orig = fused.fused_sort_scan

    def record(operands, num_keys, shift=0):
        ops = tuple(operands)
        calls.append(([c.clone() for c in ops], num_keys, shift))
        return orig(ops, num_keys, shift)

    fused.fused_sort_scan = record
    try:
        state = eng.tick(state)
    finally:
        fused.fused_sort_scan = orig
    return calls, state


@contextlib.contextmanager
def routing_legs(fused):
    """The sort wrapper's launches inside ``routing.pack_by_dest``, by
    leg (exchange A's packs; exchange B's, whose fields carry "cts"):
    those made while a stream captures (a CUDA graph's plan) under
    "captured", the others under "eager"."""
    from deneva_tpu_torch.parallel import routing
    legs = {"eager": {"A": 0, "B": 0}, "captured": {"A": 0, "B": 0}}
    pack = routing.pack_by_dest

    def counted(dest, prio, live, n_nodes, cap, fields):
        n0 = fused.LAUNCHES
        out = pack(dest, prio, live, n_nodes, cap, fields)
        run = "captured" if torch.cuda.is_current_stream_capturing() \
            else "eager"
        legs[run]["B" if "cts" in fields else "A"] += fused.LAUNCHES - n0
        return out

    routing.pack_by_dest = counted
    try:
        yield legs
    finally:
        routing.pack_by_dest = pack


def sharded_equal(label, a_eng, a, b_eng, b):
    """``same_state`` plus every node's counters and rings."""
    s = same_state(label, a_eng, a, b_eng, b)
    bad = [k for k in a.stats
           if not torch.equal(a.stats[k].cpu(), b.stats[k].cpu())]
    if bad or sorted(a.stats) != sorted(b.stats):
        raise AssertionError(f"{label}: per-node counters differ: {bad}")
    return s


def phase_sharded(cells, timed_run, fused, dev, gpu_line):
    """The sharded engine on the card (phase 22 of the module docstring).
    Returns the four packs' kernels-line rows."""
    from deneva_tpu_torch.profile_tick import breakdown, host_syncs, \
        trace_kernels
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = cells.engine(cells.config(SH_CELL), device=dev)
    N, B, R = eng.cfg.node_cnt, eng.cfg.batch_size, eng.pool.max_req
    names, per_tick = sharded_packs(eng)
    nE = B * R
    nV = N * eng.cap + nE
    say("sharded", f"{SH_CELL}: {N} nodes x {eng.n_rows // N} rows, B={B}, "
        f"R={R}, exchange capacity {eng.cap} lanes per node pair, owner "
        f"width {nV}; pool and engine built in "
        f"{time.perf_counter() - t0:.1f} s")

    # eager == replayed over SH_TICKS ticks from the initial state
    base_mb = torch.cuda.memory_allocated(dev) / 2**20
    torch.cuda.reset_peak_memory_stats(dev)
    se = eng.run(SH_TICKS)
    eager_peak = torch.cuda.max_memory_allocated(dev) / 2**20 - base_mb
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with routing_legs(fused) as cap_legs:
        sg = eng.run_compiled(0)
    torch.cuda.synchronize(dev)
    capture_s = time.perf_counter() - t0
    # the routing launches of the one captured cluster-tick graph, by leg
    captured = cap_legs["captured"]
    sg = eng.run_compiled(SH_TICKS, sg)
    graph_peak = torch.cuda.max_memory_allocated(dev) / 2**20 - base_mb
    s = sharded_equal(f"{SH_CELL} eager == replayed", eng, se, eng, sg)
    if eng.global_data_sum(sg) != s["write_cnt"] or not s["txn_cnt"] > 0:
        raise AssertionError(f"{SH_CELL}: the oracle broke or nothing "
                             "committed")
    say("sharded", f"{SH_CELL}: {SH_TICKS} ticks eager == {SH_TICKS} "
        f"replayed (summary, [summary] line, every node's data and "
        f"counters, txn slots); global data sum == write_cnt="
        f"{s['write_cnt']}; txn_cnt={s['txn_cnt']}; capture {capture_s:.2f}"
        f" s (warm-up and {len(eng.graphs.graphs)} graph)")

    # eager windows: the sort wrapper's launches by pack, and those of the
    # routing packs by leg
    c0 = eng.summary(se)
    fused.reset_launches()
    with routing_legs(fused) as win_legs:
        eager_ms = []
        for _ in range(3):
            se, per = timed_run(eng, SH_WINDOW, se)
            eager_ms.append(per * 1e3)
    legs = win_legs["eager"]
    eager_by_pack = dict(fused.LAUNCHES_BY_PACK)
    ticks = 3 * SH_WINDOW
    want = {p: n * ticks for p, n in per_tick.items()}
    if eager_by_pack != want or legs != {"A": N * ticks, "B": N * ticks} \
            or captured != {"A": N, "B": N}:
        raise AssertionError(f"{SH_CELL}: launches by pack {eager_by_pack}"
                             f" and routing launches {legs} eager, "
                             f"{captured} in the captured tick, want {want}"
                             f", {N * ticks} and {N} of each leg")
    c1 = eng.summary(se)
    d = {k: c1[k] - c0[k] for k in ("txn_cnt", "total_txn_abort_cnt",
                                    "remote_entry_cnt",
                                    "route_overflow_abort_cnt",
                                    "commit_defer_cnt")}
    fused.reset_launches()
    graph_ms = []
    for _ in range(3):
        sg, per = timed_run(eng, SH_WINDOW, sg, compiled=True)
        graph_ms.append(per * 1e3)
    replayed = eng.graphs.launches_of(0, ticks)
    # the routing launches of as many replays of the one graph, by leg
    replayed_legs = {k: n * ticks for k, n in captured.items()}
    if replayed != want:
        raise AssertionError(f"{SH_CELL}: a replay's captured launches "
                             f"{replayed}, want {want}")

    # one trace of eager ticks (0 cummax) and one of replays, for times;
    # host syncs of an eager tick; one captured tick's launches and nodes
    box = [se]

    def tick():
        box[0] = eng.tick(box[0])

    per_e, _ = trace_ticks(SH_CELL, eng, tick)
    syncs, sites = host_syncs(tick, TRACE_TICKS)
    if syncs:
        raise AssertionError(f"{SH_CELL}: an eager tick syncs {syncs} times "
                             f"at {sites}")
    gbox = [sg]

    def replay():
        gbox[0] = eng.advance(1, gbox[0], compiled=True)

    gsyncs, gsites = host_syncs(replay, TRACE_TICKS, "error")
    per_g = breakdown(trace_kernels(replay, TRACE_TICKS), TRACE_TICKS)
    nodes = captured_tick(SH_CELL, eng, box[0])

    e_med, g_med = float(np.median(eager_ms)), float(np.median(graph_ms))
    fmt = lambda xs: "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"
    say("sharded", f"{SH_CELL}: tick_ms eager median={e_med:.4f} "
        f"{fmt(eager_ms)}, graph median={g_med:.4f} {fmt(graph_ms)} (3 "
        f"windows of {SH_WINDOW} ticks each, cuda events; eager/graph "
        f"{e_med / g_med:.2f}x) on {gpu_line}")
    say("sharded", f"{SH_CELL}: per tick over the {ticks} eager ticks: "
        f"commits {d['txn_cnt'] / ticks:.2f}, aborts "
        f"{d['total_txn_abort_cnt'] / ticks:.2f} (abort rate "
        f"{d['total_txn_abort_cnt'] / max(d['total_txn_abort_cnt'] + d['txn_cnt'], 1):.6f}"
        f"), remote entries {d['remote_entry_cnt'] / ticks:.1f}, "
        f"route-overflow aborts {d['route_overflow_abort_cnt'] / ticks:.3f}"
        f", commit deferrals {d['commit_defer_cnt'] / ticks:.3f}")
    say("sharded", f"{SH_CELL}: sort launches per tick {sum(per_tick.values())}"
        f" by pack {{{', '.join(f'{names[p]}: {n}' for p, n in per_tick.items())}}}"
        f" (wrapper count, eager and replayed; routing launches A={legs['A']} "
        f"B={legs['B']} over {ticks} eager ticks, A={captured['A']} "
        f"B={captured['B']} in the captured tick), 0 fallbacks")
    say("sharded", f"{SH_CELL}: eager tick (torch.profiler, {TRACE_TICKS} "
        f"ticks): {per_e['kernel_launches']:.1f} device launches, busy "
        f"{per_e['device_busy_us']:.1f} us, fused kernel "
        f"{per_e['fused_sort_scan_us']:.1f} us, idle "
        f"{1 - per_e['device_busy_us'] / 1e3 / e_med:.3f}, torch.cummax "
        f"{per_e['cummax_calls']:g} calls; replayed tick: "
        f"{per_g['kernel_launches']:.1f} launches, busy "
        f"{per_g['device_busy_us']:.1f} us, fused kernel "
        f"{per_g['fused_sort_scan_us']:.1f} us, idle "
        f"{1 - per_g['device_busy_us'] / 1e3 / g_med:.3f}; host syncs: "
        f"{syncs:g} per eager tick, {gsyncs:g} per replay; a captured tick "
        f"holds {nodes.get('kernel', 0)} kernel nodes")
    say("sharded", f"{SH_CELL}: peak device memory above the engine's own "
        f"{eager_peak:.1f} MB eager, {graph_peak:.1f} MB with the graph "
        "(its static state and pool)")

    # the four packs of a live tick, in call order: N routing A packs, the
    # N owners' lock sort and unpermute, N routing B packs
    calls, _ = sharded_calls(fused, eng, box[0])
    picks = (("routing A (dest, held-first, lane)", 0, "A"),
             ("owner lock sort (keykind, ts, payload)", N, None),
             ("owner unpermute (entry index, decision)", N + 1, None),
             ("routing B (dest, ts, lane)", 3 * N, "B"))
    rows = []
    for label, i, leg in picks:
        cols, nk, shift = calls[i]
        key = (len(cols), nk, cols[0].shape[0], shift)
        if key not in per_tick:
            raise AssertionError(f"{SH_CELL}: call {i} is {key}, not a "
                                 f"pack of the plan {sorted(per_tick)}")
        r = measure_pack(fused, f"{SH_CELL} {label}", cols, nk, shift)
        r.update(label=f"{SH_CELL} {label}", pack=key,
                 launches=legs[leg] if leg else eager_by_pack[key],
                 replayed=replayed_legs[leg] if leg else replayed[key])
        rows.append(r)

    # CPU == CUDA on the small cells
    for name, over in SH_CPU_CELLS:
        cfg = cells.config(name, **over)
        gpu = cells.engine(cfg, device=dev)
        cpu = cells.engine(cfg, pool=gpu.pool, device="cpu")
        sg_, sc_ = gpu.run(SH_TICKS), cpu.run(SH_TICKS)
        label = " ".join([name] + [f"{k}={v}" for k, v in over.items()])
        sm = sharded_equal(f"{label} CUDA == CPU", gpu, sg_, cpu, sc_)
        if over and not sm["route_overflow_abort_cnt"] > 0:
            raise AssertionError(f"{label}: no route overflow")
        say("sharded", f"{label} {SH_TICKS} ticks: CUDA == CPU (summary, "
            f"[summary] line, every node's data and counters, txn slots); "
            f"txn_cnt={sm['txn_cnt']} total_txn_abort_cnt="
            f"{sm['total_txn_abort_cnt']} route_overflow_abort_cnt="
            f"{sm['route_overflow_abort_cnt']} remote_entry_cnt="
            f"{sm['remote_entry_cnt']}")
        del gpu, cpu, sg_, sc_
    del eng, se, sg, box, gbox
    gc.collect()
    torch.cuda.empty_cache()
    say("sharded", f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return rows


def graph_packs(eng):
    """The names of the packs the cell's tick sorts, by (columns, keys,
    lanes, shift), and the launches of each per tick on the eager path
    (the compacted effect body: no full-scale tick has taken the other)
    and per replay of a captured graph (the full-width effect body, which
    a captured tick runs whatever the reference's choice)."""
    if eng.cfg.node_cnt > 1:
        names, every = sharded_packs(eng)
        return names, every, every
    if eng.cfg.workload == "YCSB":
        acc_names, every = access_packs(eng, "headline")
        return {**PACK_NAMES, **acc_names}, every, every
    packs_fn = tpcc_packs if eng.cfg.workload == "TPCC" else pps_packs
    names, compact, full = packs_fn(eng)
    return names, compact, full


def planned_launches(eng, compact, full):
    """The sort kernel's launches by pack that `compact` ticks taking the
    compacted effect body and `full` ticks taking the full-width one make
    (``graph_packs``); a YCSB tick has no effect body and counts as
    compact."""
    _, per_compact, per_full = graph_packs(eng)
    want = {}
    for n, per in ((compact, per_compact), (full, per_full)):
        for pack, k in per.items() if n else ():
            want[pack] = want.get(pack, 0) + k * n
    return want


def host_copy(eng, state):
    """Summary, data, tables and CC arrays of a flushed state, on the
    host."""
    return (eng.summary(state), state.data.cpu(),
            {k: v.cpu() for k, v in state.tables.items()},
            {k: v.cpu() for k, v in state.db.items()})


def windows(timed_run, eng, state, compiled):
    """GRAPH_TICKS ticks in windows of WINDOW_TICKS, each timed with CUDA
    events; returns the state and the ms per tick of each window."""
    ms = []
    for _ in range(GRAPH_TICKS // WINDOW_TICKS):
        state, per_tick = timed_run(eng, WINDOW_TICKS, state,
                                    compiled=compiled)
        ms.append(per_tick * 1e3)
    return state, ms


def sm_clocks(fn):
    """``fn()`` while nvidia-smi samples the SM clock every 20 ms (started
    half a second before, stopped after): fn's result and the samples in
    MHz."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "20"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.5)
        out = fn()
    finally:
        proc.terminate()
        text = proc.communicate(timeout=30)[0]
    return out, [int(x) for x in text.split() if x.isdigit()]


def phase_graph(cells, name, Engine, timed_run, fused, dev, gpu_line):
    """``Engine.run_compiled`` on the cell `name`: GRAPH_TICKS ticks eager
    and GRAPH_TICKS replayed, each from the cell's initial state and in
    timed windows; equal results, 0 host syncs per replayed tick, the
    captured launches by pack, a traced window of replays, tick times and
    peak memory.  The kernel's launch counts are
    set to 0 just before the graph path (warm-up, capture and replays)
    and read just after.  Returns the inputs of every pack a captured tick
    sorts (``packs``), their ``names``, the graph path's wrapper counts
    (``counted``) and the launches of its replays (``replayed``)."""
    from deneva_tpu_torch.profile_tick import (breakdown, host_syncs,
                                               trace_kernels)
    eng = Engine(cells.config(name), device=dev)
    wl = eng.workload
    names, per_eager, per_graph = graph_packs(eng)

    c0 = wl.counts()
    fused.reset_launches()
    # an earlier cell's engine and its graphs form a reference cycle:
    # collect it, so that it is not freed inside this cell's measurement
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mb = torch.cuda.memory_allocated(dev) / 2**20
    p0 = loop_passes(eng)
    state, eager_ms = windows(timed_run, eng, eng.init_state(), False)
    eager_passes = loop_passes(eng) - p0
    eager_peak = torch.cuda.max_memory_allocated(dev) / 2**20 - base_mb
    eager_by_pack = dict(fused.LAUNCHES_BY_PACK)
    c1 = wl.counts()
    eager = host_copy(eng, state)
    del state
    torch.cuda.empty_cache()

    fused.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # warm-up and capture
    state = eng.advance(0, eng.init_state(), compiled=True)
    torch.cuda.synchronize(dev)
    capture_s = time.perf_counter() - t0
    p0 = loop_passes(eng)
    (state, graph_ms), clocks = sm_clocks(
        lambda: windows(timed_run, eng, state, True))
    graph_passes = loop_passes(eng) - p0
    graph_peak = torch.cuda.max_memory_allocated(dev) / 2**20 - base_mb
    counted = dict(fused.LAUNCHES_BY_PACK)
    c2 = wl.counts()
    graph = host_copy(eng, state)

    # the same results
    diff = {k: (eager[0][k], graph[0].get(k)) for k in eager[0]
            if k != "ccl_samples" and eager[0][k] != graph[0].get(k)}
    if diff or eager[0] != graph[0]:
        raise AssertionError(f"{name}: eager and graph summaries differ: "
                             f"{diff}")
    if not torch.equal(eager[1], graph[1]):
        raise AssertionError(f"{name}: eager and graph data differ")
    bad = [k for part in (2, 3) for k in eager[part]
           if not torch.equal(eager[part][k], graph[part][k])]
    if bad:
        raise AssertionError(f"{name}: eager and graph tables or CC arrays "
                             f"differ: {bad}")
    bodies_e = {k: c1[k] - c0[k] for k in c0}
    bodies_g = {k: c2[k] - c1[k] for k in c0}
    if bodies_e != bodies_g:
        raise AssertionError(f"{name}: effect bodies differ: eager "
                             f"{bodies_e}, graph {bodies_g}")
    if int(graph[1].sum()) != graph[0]["write_cnt"] \
            or not graph[0]["txn_cnt"] > 0:
        raise AssertionError(f"{name}: the graph run broke the oracle or "
                             "committed nothing")
    if eager_passes != graph_passes:
        raise AssertionError(f"{name}: {eager_passes} loop passes "
                             f"eager, {graph_passes} replayed")

    # launches: eager by the bodies taken; a replay by its graph's capture
    if bodies_e.get("full", 0) and eng.cfg.workload != "YCSB":
        raise AssertionError(f"{name}: a full-width eager tick at full "
                             "scale; the launch tables assume none")
    want_eager = {p: n * GRAPH_TICKS for p, n in per_eager.items()}
    replayed = eng.graphs.launches_of(0, GRAPH_TICKS)
    want_graph = {p: n * GRAPH_TICKS for p, n in per_graph.items()}
    if eager_by_pack != want_eager or replayed != want_graph:
        raise AssertionError(f"{name}: launches by pack: eager "
                             f"{eager_by_pack} (want {want_eager}), "
                             f"replayed {replayed} (want {want_graph})")
    missing = [p for p in per_graph if not counted.get(p)]
    if missing:
        raise AssertionError(f"{name}: the graph path launched no "
                             f"{missing}")
    extra = {names.get(p, p): per_graph.get(p, 0) - per_eager.get(p, 0)
             for p in sorted(set(per_graph) | set(per_eager))
             if per_graph.get(p, 0) != per_eager.get(p, 0)}

    # 0 host syncs per replayed tick; a traced window of replays
    box = [state]

    def replay():
        box[0] = eng.advance(1, box[0], compiled=True)

    syncs, sites = host_syncs(replay, TRACE_TICKS, "error")
    if syncs:
        raise AssertionError(f"{name}: replayed tick: {syncs} host syncs at "
                             f"{sites}")
    # the trace for times; the launches of a replay are those its graph
    # captured (held above), and one more captured tick's graph nodes
    per = breakdown(trace_kernels(replay, TRACE_TICKS), TRACE_TICKS)
    nodes = captured_tick(name, eng, box[0])
    # the inputs of every pack a captured tick sorts (the full-width body)
    packs = capture_packs(fused, lambda: eng.tick(box[0], compiled=True))
    eng._flush_body(box[0])
    # the replay windows once more, after the trace, on the run's state
    (_, again_ms), again_clocks = sm_clocks(
        lambda: windows(timed_run, eng, box[0], True))

    e_med, g_med = float(np.median(eager_ms)), float(np.median(graph_ms))
    say("graph", f"{name}: {GRAPH_TICKS} ticks eager == {GRAPH_TICKS} "
        f"replayed (summary, data, {len(eager[2])} tables, CC arrays "
        f"{sorted(eager[3]) or 'none'}, effect bodies {bodies_g}); txn_cnt="
        f"{graph[0]['txn_cnt']} abort_rate={graph[0]['abort_rate']:.6f}; "
        "capture "
        f"{capture_s:.2f} s (warm-up and {len(eng.graphs.graphs)} phase "
        "graphs)")
    say("graph", f"{name}: tick_ms eager median={e_med:.4f} "
        f"min={min(eager_ms):.4f} max={max(eager_ms):.4f}, graph median="
        f"{g_med:.4f} min={min(graph_ms):.4f} max={max(graph_ms):.4f} "
        f"({len(graph_ms)} windows of {WINDOW_TICKS} ticks, cuda events; "
        f"eager/graph {e_med / g_med:.2f}x) on {gpu_line}")
    fmt = lambda xs: "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"
    span = lambda xs: f"{min(xs)}-{max(xs)}" if xs else "no sample"
    say("graph", f"{name}: graph windows {fmt(graph_ms)} ms (SM clock "
        f"{span(clocks)} MHz); after the trace {fmt(again_ms)} ms (SM clock "
        f"{span(again_clocks)} MHz, nvidia-smi every 20 ms); eager windows "
        f"{fmt(eager_ms)} ms")
    say("graph", f"{name}: replayed tick: 0 host syncs (sync debug mode "
        f"error), {nodes.get('kernel', 0)} kernel nodes in a captured tick, "
        f"{per['kernel_launches']:.1f} device launches, device busy "
        f"{per['device_busy_us']:.1f} us, fused kernel "
        f"{per['fused_sort_scan_launches']:g} launches and "
        f"{per['fused_sort_scan_us']:.1f} us (torch.profiler, "
        f"{TRACE_TICKS} replays); idle {1 - per['device_busy_us'] / 1e3 / g_med:.3f}"
        f"; launches per tick, replayed less eager: {extra or 'none'}")
    say("graph", f"{name}: peak device memory above the engine's own "
        f"{eager_peak:.1f} MB eager, {graph_peak:.1f} MB graph (static "
        "buffers and the phase graphs' pool)")
    if runs_loop(eng):
        loop_passes_per_tick(name, eng, per, graph_passes)
    return dict(packs=packs, names=names, counted=counted,
                replayed=replayed, passes=graph_passes)


def loop_passes_per_tick(name, eng, per, graph_passes):
    """The device loop of an OCC or MAAT cell in the graph phase: the
    passes of the timed windows, the set-condition kernels the replay
    trace shows, and OC_PASS_TICKS ticks from the initial state, eager
    and replayed, whose passes are read after each tick and must be equal
    one by one; prints their histogram."""
    runs = {}
    for compiled in (False, True):
        state = eng.advance(0, eng.init_state(), compiled=compiled)
        per_tick = []
        for _ in range(OC_PASS_TICKS):
            p0 = loop_passes(eng)
            state = eng.advance(1, state, compiled=compiled)
            per_tick.append(loop_passes(eng) - p0)
        eng._flush_body(state)
        runs[compiled] = per_tick
        del state
    if runs[False] != runs[True]:
        raise AssertionError(f"{name}: loop passes per tick differ: "
                             f"eager {runs[False]}, replayed {runs[True]}")
    hist = {d: runs[True].count(d) for d in sorted(set(runs[True]))}
    say("graph", f"{name}: loop passes {graph_passes} over the "
        f"{GRAPH_TICKS} replayed ticks ({graph_passes / GRAPH_TICKS:g} per "
        f"tick), as many as eager; the replay trace shows "
        f"{per['while_set_launches']:g} set-condition kernels per tick; "
        f"{OC_PASS_TICKS} ticks from the start, eager == replayed tick by "
        f"tick, ticks by passes {hist}")


def measure_captured(fused, rows, packs, cell_names, names, cell):
    """Hold every pack captured from a tick of `cell` against the plain
    version and time it (``measure_pack``), into `rows`."""
    for pack, cols in sorted(packs.items()):
        if pack not in cell_names:
            raise AssertionError(f"the {cell} tick sorted an unnamed pack "
                                 f"{pack}")
        rows[pack] = measure_pack(fused, names[pack], cols, pack[1],
                                  pack[3])


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2

    from deneva_tpu_torch import cells
    from deneva_tpu_torch.engine.scheduler import Engine, timed_run
    from deneva_tpu_torch.ops import fused, rebase

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # CUDA-graph conditional nodes: torch's own (IF bodies would let a
    # captured tick run the compacted effect body), and the WHILE node the
    # port binds itself
    cond = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} graph_conditional_nodes=bound by "
          f"hand (csrc/graph_while.cu); torch's own: {cond}")
    phase_gpu()
    phase_build(fused, rebase)
    rows = phase_kernel(fused, dev)
    _, _, by_pack, _ = phase_headline(cells, Engine, timed_run, fused, dev)
    phase_cpu_equal(cells, "headline", Engine, dev, CPU_TICKS)
    pool, tpcc_by_pack, packs, tpcc_names = phase_tpcc(
        cells, Engine, timed_run, fused, dev)
    names = {**PACK_NAMES, **tpcc_names}
    measure_captured(fused, rows, packs, tpcc_names, names, "tpcc")
    phase_tpcc_cpu_equal(cells, Engine, dev, pool)
    by_pack.update(tpcc_by_pack)

    pps_pool, pps_by_pack, packs, pps_names = phase_pps(
        cells, Engine, timed_run, fused, dev)
    names.update(pps_names)
    measure_captured(fused, rows, packs, pps_names, names, "pps")
    phase_cpu_equal(cells, "pps", Engine, dev, PPS_CPU_TICKS, pool=pps_pool)
    by_pack.update(pps_by_pack)

    wd_pool = phase_wait_die(cells, Engine, timed_run, fused, dev)
    for name, ticks in WD_CPU_TICKS.items():
        if name == "pps_wait_die":
            s = phase_cpu_equal(cells, name, Engine, dev, ticks,
                                pool=wd_pool)[0]
        else:
            s = phase_cpu_equal(cells, name, Engine, dev, ticks,
                                pool=pool if name == "tpcc" else None,
                                cc_alg="WAIT_DIE")[0]
        if not s["twopl_wait_cnt"] > 0:
            raise AssertionError(f"no WAIT decision in the {name} WAIT_DIE "
                                 "run")

    reb = phase_timestamp(cells, Engine, timed_run, fused, rebase, dev,
                          rows, names, by_pack, pps_pool)
    reb_ring = phase_mvcc(cells, Engine, timed_run, fused, rebase, dev,
                          rows, names, by_pack, pps_pool)
    calvin = phase_calvin(cells, Engine, timed_run, fused, dev, pps_pool)
    occ, loop = phase_occ(cells, Engine, timed_run, fused, dev, pps_pool)
    reb_maat, maat_body = phase_maat(cells, Engine, timed_run, fused, rebase,
                                     dev, rows, names, by_pack, pps_pool)
    lock_rows = phase_lock_optins(cells, Engine, timed_run, fused, dev)
    phase_commit_after(cells, Engine, timed_run, fused, rebase, dev,
                       pps_pool)
    # compaction's own packs are rows by cell, like the lock opt-ins'
    maat_body.update(phase_compaction(cells, Engine, timed_run, fused,
                                      rebase, dev, pps_pool, lock_rows))
    sharded_rows = phase_sharded(cells, timed_run, fused, dev, phase_gpu())

    from deneva_tpu_torch.ops import device_loop
    gpu_line = phase_gpu()
    replayed = {}
    device_loop.reset_launches()
    loop["replayed"] = 0
    for name in GRAPH_CELLS:
        rec = phase_graph(cells, name, Engine, timed_run, fused, dev,
                          gpu_line)
        # the set-condition kernel ran once per replayed pass (OCC, MAAT)
        loop["replayed"] += rec["passes"]
        if name in CAA_CELLS:
            # the flagless cell's packs (phase 19 holds the counts equal):
            # no row of their own
            known = set(rows) | {r["pack"] for r in occ.values()}
            if set(rec["packs"]) - known:
                raise AssertionError(f"{name}: a pack no other cell sorts: "
                                     f"{set(rec['packs']) - known}")
            continue
        if name in occ:
            # the validation sort is a row of its own, like CALVIN's lock
            # sort
            occ[name]["replayed"] = rec["replayed"].pop(occ[name]["pack"],
                                                        0)
        # so are the packs of the lock opt-in cells that phase 18 measured,
        # and the compaction cells' own packs (phase 21)
        own = {p for (cell, p) in lock_rows if cell == name}
        for p in own:
            lock_rows[(name, p)]["replayed"] = rec["replayed"].pop(p, 0)
            rec["packs"].pop(p, None)
        # the packs only the graph path sorts (the full-width effect body):
        # held to the plain version and timed; their launches are the graph
        # path's wrapper count (warm-up and capture)
        new = {p: c for p, c in rec["packs"].items() if p not in rows}
        # a pack that cells sort for different uses is named by each (OCC's
        # validation sort aside: it is a row of its own)
        for p in rec["packs"]:
            n = rec["names"][p]
            if p not in names:
                names[p] = n
            elif n not in names[p].split(" / ") and not (
                    name in occ and p == occ[name]["pack"]):
                names[p] += f" / {n}"
        measure_captured(fused, rows, new, rec["names"], names, name)
        by_pack.update({p: rec["counted"][p] for p in new})
        for p, n in rec["replayed"].items():
            replayed[p] = replayed.get(p, 0) + n
        if name == "tpcc_calvin":
            calvin["replayed"] = rec["replayed"].get(calvin["pack"], 0)
    loop["launches"] = device_loop.LAUNCHES

    def sort_row(label, pack, r, launches, replayed_launches):
        n_in, nk, n, shift = pack
        return {
            "name": f"fused_sort_scan[{label} {n_in}x{nk} n={n}"
                    f" shift={shift}]",
            "route": "cuda",
            "source": "deneva_tpu_torch/csrc/fused_sort_scan.cu",
            "replaces": "deneva_tpu/ops/fused.py:122",
            "launches": launches,
            "replayed_launches": replayed_launches,
            "device_launches_per_call": r["device_launches"],
            "device_ms": r["device_ms"],
            "max_abs_err": r["err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }

    kernels = [sort_row(names[pack], pack, r, by_pack.get(pack, 0),
                        replayed.get(pack, 0))
               for pack, r in sorted(rows.items(),
                                     key=lambda kv: names[kv[0]])]
    kernels.append(sort_row("tpcc_calvin lock sort", calvin["pack"], calvin,
                            calvin["launches"], calvin["replayed"]))
    for name, r in occ.items():
        kernels.append(sort_row(f"{name} OCC validation sort", r["pack"], r,
                                r["launches"], r["replayed"]))
    for (name, pack), r in sorted(lock_rows.items()):
        kernels.append(sort_row(r["label"], pack, r, r["launches"],
                                r["replayed"]))
    for r in sharded_rows:
        kernels.append(sort_row(r["label"], r["pack"], r, r["launches"],
                                r["replayed"]))
    kernels.append({
        "name": "graph_while[WHILE node: one pass of a bare loop, add + "
                "compare + set-condition; plain = the host loop]",
        "route": "cuda",
        "source": "deneva_tpu_torch/csrc/graph_while.cu",
        "replaces": "deneva_tpu/cc/occ.py:291",
        "also_replaces": "deneva_tpu/cc/maat.py:546",
        "launches": loop["launches"],
        "replayed_launches": loop["replayed"],
        "max_abs_err": loop["err"], "ms": loop["ms"],
        "plain_ms": loop["plain_ms"], "bound_ms": loop["bound_ms"],
        "bound_by": loop["bound_by"], "library_ms": None,
        "set_condition_ms": loop["set_condition_ms"],
        "occ_body_pass_ms": loop["body"]["graph_ms"],
        "occ_body_pass_device_ms": loop["body"]["device_ms"],
        "occ_body_pass_bound_ms": loop["body"]["bound_ms"],
        "maat_body_pass_ms": {k: v["graph_ms"]
                              for k, v in maat_body.items()},
        "maat_body_pass_device_ms": {k: v["device_ms"]
                                     for k, v in maat_body.items()},
        "maat_body_pass_bound_ms": {k: v["bound_ms"]
                                    for k, v in maat_body.items()},
    })
    for rec, what, replaces in (
            (reb, "wts+rts", "deneva_tpu/cc/timestamp.py:119"),
            (reb_ring, "w_ring+r_ring, ring mode",
             "deneva_tpu/cc/mvcc.py:96"),
            (reb_maat, "maat_lr+maat_lw, ring mode",
             "deneva_tpu/cc/maat.py:168")):
        r0, r1 = rec["by_shift"][0], rec["by_shift"][2**30]
        kernels.append({
            "name": f"ts_rebase[{what} {rec['n']} cells, shift 0: a tick "
                    "that does not rebase]",
            "route": "cuda",
            "source": "deneva_tpu_torch/csrc/ts_rebase.cu",
            "replaces": replaces,
            "launches": rec["launches"],
            "device_launches_per_call": r0["device_launches"],
            "device_ms": r0["device_ms"],
            "max_abs_err": rec["err"], "ms": r0["ms"],
            "plain_ms": r0["plain_ms"], "bound_ms": r0["bound_ms"],
            "bound_by": r0["bound_by"], "library_ms": None,
            "rebase_tick": {k: r1[k] for k in ("ms", "device_ms",
                                               "plain_ms", "bound_ms",
                                               "bound_by")},
        })
    say("done", f"every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
