"""Workload-independent query-pool container and workload boundary.

As in the reference (client/client_query.cpp:30-121), every client query
is generated on the host before the run; the engine consumes the pool by
cursor and wraps around when it is exhausted.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class QueryPool:
    """A pool of Q pre-generated transactions, each with up to R accesses.

    keys      (Q, R) int32  global primary keys
    is_write  (Q, R) bool
    n_req     (Q,)   int32  number of valid accesses
    home_part (Q,)   int32  partition of the client / home node
    txn_type  (Q,)   int32  workload program id (0 for YCSB)
    args      (Q, A) int32  workload scalar args
    aux       (Q, R) int32  per-access payload, 0-filled
    """

    keys: np.ndarray
    is_write: np.ndarray
    n_req: np.ndarray
    home_part: np.ndarray
    txn_type: np.ndarray
    args: np.ndarray
    aux: np.ndarray = None

    def __post_init__(self):
        if self.aux is None:
            self.aux = np.zeros_like(self.keys)

    @property
    def size(self) -> int:
        return self.keys.shape[0]

    @property
    def max_req(self) -> int:
        return self.keys.shape[1]


class WorkloadPlugin:
    """Workload boundary: query generation plus commit-time table effects.
    The hooks below are YCSB's: no table effects and no user aborts.

    Effects are applied per access entry: ``commit_fields`` computes each
    committing entry's effect arguments, and ``apply_commit_entries``
    applies them to the tables (both halves run in the same tick on the
    single shard)."""

    name = "?"
    #: True if commits change workload tables beyond the engine's per-row
    #: write-count oracle (TPC-C yes, YCSB no)
    has_effects = False
    #: names of the per-entry int32 fields ``commit_fields`` returns
    effect_fields: tuple = ()

    def gen_pool(self, cfg) -> QueryPool:
        raise NotImplementedError

    def cc_rows(self, cfg) -> int:
        """Global CC-addressable row-space size (the engine's data table)."""
        raise NotImplementedError

    def init_tables(self, cfg, part: int, device="cpu") -> dict:
        """Shard ``part``'s tables and insert rings on ``device``."""
        return {}

    def commit_fields(self, cfg, tables: dict, txn, commit) -> dict:
        """Per-access effect arguments of committing txns: name -> (B, R)
        int32."""
        return {}

    def apply_commit_entries(self, cfg, tables: dict, key_local, part,
                             fields: dict, cts, live) -> dict:
        """Apply the effects of the (n,) entries where ``live``, ordered
        within the tick by commit timestamp ``cts``; ``key_local`` are
        shard-local catalog rows of shard ``part``."""
        return tables

    def user_abort(self, cfg, txn, finishing: torch.Tensor) -> torch.Tensor:
        """Finishing txns that roll back by workload logic: none."""
        return torch.zeros_like(finishing)

    def pool_user_abort(self, cfg, pool: QueryPool) -> np.ndarray:
        """(Q,) bool: ``user_abort``'s decision per pool row (it depends on
        the pool only)."""
        return np.zeros(pool.size, bool)
