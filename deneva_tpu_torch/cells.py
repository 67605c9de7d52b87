"""Named engine configurations of the port.

- ``entry``: the JAX package's flagship single-chip tick
  (``__graft_entry__.py:entry``): YCSB + NO_WAIT, B=1024, 65,536 rows.
- ``headline``: the benchmark's YCSB cell (``bench.py`` ``YCSB_KW``) with
  NO_WAIT and the fused sort + scan kernel: 16M rows, B=8192, 10 requests
  per txn, zipf 0.6, 50/50 read/write, admission capped at 1024 per tick.
  This is Deneva's per-node YCSB grid of the VLDB'17 evaluation.
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
}


def config(name: str, **overrides) -> Config:
    return Config(**{**CELLS[name], **overrides})
