"""Named engine configurations of the port.

- ``entry``: the JAX package's flagship single-chip tick
  (``__graft_entry__.py:entry``): YCSB + NO_WAIT, B=1024, 65,536 rows.
- ``headline``: the benchmark's YCSB cell (``bench.py`` ``YCSB_KW``) with
  NO_WAIT and the fused sort + scan kernel: 16M rows, B=8192, 10 requests
  per txn, zipf 0.6, 50/50 read/write, admission capped at 1024 per tick.
  This is Deneva's per-node YCSB grid of the VLDB'17 evaluation.
- ``tpcc``: the benchmark's TPC-C cell (``bench.py`` ``TPCC_KW``: B=8192,
  pool 65,536, admission capped at 1024 per tick) under NO_WAIT with the
  fused kernel, at Deneva's full TPC-C scale: 128 warehouses per node
  (the ``tpcc_scaling2`` grid, ``BASELINE.md``), 10 districts each, 3,000
  customers per district, 100,000 items, up to 15 order lines, half
  Payment and half NewOrder, Payments writing their warehouse row.  That
  is 16.74M catalog rows (CUSTOMER 3.84M, STOCK 12.8M) and B*R = 270,336
  lock entries per tick.  Nothing is cut; the insert rings keep the JAX
  package's default capacities.
- ``pps``: PPS under NO_WAIT with the fused kernel, at ``bench.py``'s B=8192,
  pool 65,536 and admission cap of 1024, and the ``Config`` PPS defaults
  (the JAX package's copy of the reference's PPS block, config.h:235-242):
  1,024 parts, products and suppliers, up to 10 parts per product or
  supplier, and the mix 0.2 GETPARTBYPRODUCT, 0.6 ORDERPRODUCT, 0.2
  UPDATEPRODUCTPART.  Its source is Deneva's ``pps_scaling`` grid
  (``BASELINE.md``) at one node, whose in-flight load (MAX_TXN_IN_FLIGHT
  10,000 per node) B=8192 stands for.  PPS tables are small by nature
  (23,575 catalog rows); R = 21, so a tick arbitrates 172,032 lock lanes.
  Nothing is cut.
- ``pps_wait_die``: the ``pps`` cell under WAIT_DIE.
- ``headline_timestamp``: the ``headline`` cell under TIMESTAMP (basic
  T/O); its per-row ``wts`` and ``rts`` add 134 MB on the card.
- ``tpcc_timestamp``: the ``tpcc`` cell under TIMESTAMP, nothing cut.
- ``headline_mvcc``: the ``headline`` cell under MVCC, with the JAX
  package's version ring of ``his_recycle_len`` = 8 slots per row: the
  rings ``w_ring`` and ``r_ring`` (16.7M rows x 8 slots, int32) and
  ``rts0`` and ``w_floor`` add 1.21 GB on the card.
- ``tpcc_mvcc``: the ``tpcc`` cell under MVCC, nothing cut (1.21 GB of
  version state over its 16.74M catalog rows).
- ``headline_calvin``: the ``headline`` cell under CALVIN.  It keeps no
  per-row CC state, so it takes the headline's memory; ``seq_batch_size``
  stays None (the epoch is B = 8192 txns), so the admission cap of 1024
  is the binding cap per tick.
- ``tpcc_calvin``: the ``tpcc`` cell under CALVIN, nothing cut: its 128
  warehouse rows are FIFO queues under Payment's ``wh_update``.
- ``pps_calvin``: the ``pps`` cell under CALVIN, the cell that runs PPS's
  reconnaissance deferral and its read-only shadow requests.
- ``headline_occ``: the ``headline`` cell under OCC; its ``occ_wcommit``
  (16,777,216 int32, 64 MB) sits beside the 64 MB ``data``.
- ``tpcc_occ``: the ``tpcc`` cell under OCC, nothing cut: 241.8 MB of
  tables and a 67 MB ``occ_wcommit`` over the 16.74M catalog rows.
- ``pps_occ``: the ``pps`` cell under OCC.  These three are Deneva's OCC
  column of the VLDB'17 grid at one node.
- ``headline_maat``: the ``headline`` cell under MAAT; ``maat_lr`` and
  ``maat_lw`` (16,777,216 int32 each, 128 MB) sit beside the 64 MB
  ``data``.  ``maat_chain_window`` keeps the ``Config`` default of 8.
- ``tpcc_maat``: the ``tpcc`` cell under MAAT, nothing cut: 134 MB of
  ``maat_lr``/``maat_lw`` beside 241.8 MB of tables.
- ``pps_maat``: the ``pps`` cell under MAAT.  These three are Deneva's
  MAAT column of the VLDB'17 grid at one node.
- ``headline_subticks``: the ``headline`` cell with ``sub_ticks=8``, the K
  at which the JAX package's 2PL abort rate meets the sequential
  oracle's (``PARITY.md``): 8 lock sorts and 8 unpermutes of 81,920
  lanes and one 8,192-lane ``ts_groups`` sort per tick.
- ``headline_timestamp_subticks``: ``headline_timestamp`` with
  ``sub_ticks=8``: 8 T/O decision sorts and 8 unpermutes per tick, and
  the ``ts_groups`` sort.
- ``pps_wait_die_dense``: ``pps_wait_die`` with ``dense_lock_state``: the
  dense-row window arbitration (a per-row held-lock scratch of 23,575
  int32) sorts the 8,192 request lanes in place of the 172,032 entry
  lanes; its results equal ``pps_wait_die``'s.
- ``headline_read_committed``: ``headline`` at READ_COMMITTED, the second
  rung of Deneva's isolation-level experiment (read locks released after
  the read).
Nothing of these four is cut.

Commit after access (``commit_after_access``, "caa"): the commit block runs
after the access block, so a txn commits in the tick its last access
grants.  Each of these four is its cell as it stands with the flag on,
nothing cut:

- ``headline_caa``: ``headline`` (NO_WAIT): locks released in the tick of
  the last grant, and the JAX package's claim of about +10% throughput
  (``deneva_tpu/config.py``, ``commit_after_access``).
- ``headline_occ_caa``: ``headline_occ``: validation and the fixed point
  run after the same tick's access phase, and the validation aborts follow
  the access block.
- ``headline_maat_caa``: ``headline_maat``: the commit chain runs on
  finishers whose last access was granted this tick.
- ``tpcc_calvin_caa``: ``tpcc_calvin``: CALVIN's FIFO chains on the 128
  warehouse rows, and the JAX package's claim that the hot-chain latency
  halves.

Live-entry compaction (``compact_auto``): the CC sorts run at a static
live width K = B * (ceil(R/2) + acquire_window), rounded up to a multiple
of 256, in place of the padded B*R, behind one full-width sort that builds
the compacted view (and, on the access path, one that expands the
decisions).  Each of these four is its cell as it stands with the flag on,
nothing cut:

- ``headline_compact``: ``headline`` (NO_WAIT), K = 8,192 x (5 + 1) =
  49,152 of 81,920 lanes: the JAX package's claim of about 2x on the
  sort-bound ticks (``deneva_tpu/ops/segment.py``), on the lock sort.
- ``tpcc_compact``: ``tpcc`` (NO_WAIT), R = 33: K = 8,192 x 18 = 147,456
  of 270,336 lanes, the widest sort of the repo.
- ``headline_mvcc_compact``: ``headline_mvcc``, K = 49,152: the widest
  compaction pack (11 columns: the entry view and MVCC's 3 per-lane
  inputs).
- ``headline_maat_compact``: ``headline_maat``, K = 49,152: validation
  compaction, the chain, its passes and the squeeze's scans at K, and the
  tick-wide stall of a spilled runner.

The sharded engine (``parallel/sharded.py``), N nodes on one card:

- ``headline_sharded4``: the reference's ``ycsb_scaling`` grid at four
  nodes (``BASELINE.md``; ``part_per_txn = min(2, n)`` as in ``bench.py``'s
  grid), each node at the ``headline`` cell's size (``bench.py``
  ``YCSB_KW``): 16,777,216 rows a node (``synth_table_size`` 2^26), 65,536
  queries a node (``query_pool_size`` 2^18), B=8192, R=10, zipf 0.6,
  50/50 reads, admission capped at 1024, backoff, NO_WAIT with the fused
  kernel, every txn multi-partition (``mpr`` 1.0) over 2 partitions, and
  an exchange capacity of 2x the expected remote share (40,960 lanes per
  node pair).  A node's tick arbitrates 81,920 home lanes and 245,760
  owner lanes; the four ``data`` tables take 268 MB.  Nothing is cut.
- ``headline_sharded4_wait_die``, ``headline_sharded4_timestamp`` and
  ``headline_sharded4_mvcc``: ``headline_sharded4`` under WAIT_DIE,
  TIMESTAMP and MVCC, the rest of Deneva's protocol-by-node grid (VLDB'17)
  at four nodes.  T/O's ``wts``/``rts`` take 134 MB a node; MVCC's two
  8-slot rings, ``rts0`` and ``w_floor`` about 1.2 GB a node.  Nothing is
  cut.
- ``sharded2_small`` and ``sharded8_small``: the same per-node shape at
  B=256 and 16,384 rows a node, on 2 and 8 nodes, for the CPU == CUDA
  checks (with ``cc_alg`` overridden for the other plugins).
"""

from __future__ import annotations

from deneva_tpu_torch.config import Config

CELLS = {
    "entry": dict(cc_alg="NO_WAIT", batch_size=1024,
                  synth_table_size=1 << 16, req_per_query=10,
                  zipf_theta=0.6, query_pool_size=1 << 12),
    "headline": dict(cc_alg="NO_WAIT", fused_arbitrate=True,
                     batch_size=8192, synth_table_size=1 << 24,
                     req_per_query=10, zipf_theta=0.6, tup_read_perc=0.5,
                     query_pool_size=1 << 16, warmup_ticks=0, backoff=True,
                     admit_cap=1024),
    "tpcc": dict(workload="TPCC", cc_alg="NO_WAIT", fused_arbitrate=True,
                 batch_size=8192, num_wh=128, dist_per_wh=10,
                 cust_per_dist=3000, max_items=100000, max_items_per_txn=15,
                 perc_payment=0.5, wh_update=True, query_pool_size=1 << 16,
                 warmup_ticks=0, admit_cap=1024),
    "pps": dict(workload="PPS", cc_alg="NO_WAIT", fused_arbitrate=True,
                batch_size=8192, query_pool_size=1 << 16, warmup_ticks=0,
                admit_cap=1024),
}
CELLS["pps_wait_die"] = dict(CELLS["pps"], cc_alg="WAIT_DIE")
CELLS["headline_timestamp"] = dict(CELLS["headline"], cc_alg="TIMESTAMP")
CELLS["tpcc_timestamp"] = dict(CELLS["tpcc"], cc_alg="TIMESTAMP")
CELLS["headline_mvcc"] = dict(CELLS["headline"], cc_alg="MVCC")
CELLS["tpcc_mvcc"] = dict(CELLS["tpcc"], cc_alg="MVCC")
CELLS["headline_calvin"] = dict(CELLS["headline"], cc_alg="CALVIN")
CELLS["tpcc_calvin"] = dict(CELLS["tpcc"], cc_alg="CALVIN")
CELLS["pps_calvin"] = dict(CELLS["pps"], cc_alg="CALVIN")
CELLS["headline_occ"] = dict(CELLS["headline"], cc_alg="OCC")
CELLS["tpcc_occ"] = dict(CELLS["tpcc"], cc_alg="OCC")
CELLS["pps_occ"] = dict(CELLS["pps"], cc_alg="OCC")
CELLS["headline_maat"] = dict(CELLS["headline"], cc_alg="MAAT")
CELLS["tpcc_maat"] = dict(CELLS["tpcc"], cc_alg="MAAT")
CELLS["pps_maat"] = dict(CELLS["pps"], cc_alg="MAAT")
CELLS["headline_subticks"] = dict(CELLS["headline"], sub_ticks=8)
CELLS["headline_timestamp_subticks"] = dict(CELLS["headline_timestamp"],
                                            sub_ticks=8)
CELLS["pps_wait_die_dense"] = dict(CELLS["pps_wait_die"],
                                   dense_lock_state=True)
CELLS["headline_read_committed"] = dict(CELLS["headline"],
                                        isolation_level="READ_COMMITTED")
for _name in ("headline", "headline_occ", "headline_maat", "tpcc_calvin"):
    CELLS[f"{_name}_caa"] = dict(CELLS[_name], commit_after_access=True)
for _name in ("headline", "tpcc", "headline_mvcc", "headline_maat"):
    CELLS[f"{_name}_compact"] = dict(CELLS[_name], compact_auto=True)

CELLS["headline_sharded4"] = dict(
    CELLS["headline"], node_cnt=4, part_cnt=4, synth_table_size=1 << 26,
    query_pool_size=1 << 18, part_per_txn=2, mpr=1.0,
    route_capacity_factor=2.0)
for _alg in ("WAIT_DIE", "TIMESTAMP", "MVCC"):
    CELLS[f"headline_sharded4_{_alg.lower()}"] = dict(
        CELLS["headline_sharded4"], cc_alg=_alg)
for _n in (2, 8):
    CELLS[f"sharded{_n}_small"] = dict(
        CELLS["headline_sharded4"], node_cnt=_n, part_cnt=_n,
        batch_size=256, synth_table_size=_n << 14,
        query_pool_size=_n << 12)


def config(name: str, **overrides) -> Config:
    return Config(**{**CELLS[name], **overrides})


def engine(cfg: Config, pool=None, device="cuda"):
    """The engine of a config: the sharded engine for more than one node,
    else the single-shard engine."""
    if cfg.node_cnt > 1:
        from deneva_tpu_torch.parallel.sharded import ShardedEngine
        return ShardedEngine(cfg, pool=pool, device=device)
    from deneva_tpu_torch.engine.scheduler import Engine
    return Engine(cfg, pool=pool, device=device)
