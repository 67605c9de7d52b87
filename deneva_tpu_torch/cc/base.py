"""CC-algorithm plugin boundary.

The reference selects its algorithm at compile time (``#define CC_ALG``,
config.h:101); here each algorithm is a plugin of batch functions on
tensors, registered in ``deneva_tpu_torch.cc.REGISTRY``.  A plugin sees the
whole tick at once:

- ``access``   grant/wait/abort for every active txn's current access
  (row_t::get_row, storage/row.cpp:197-310);
- ``validate`` commit-time validation of finishing txns;
- ``on_commit`` / ``on_abort`` / ``on_start`` CC metadata updates.

``db`` is a flat dict of tensors holding per-row and per-slot CC state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.state import TxnState

#: the abort-reason registry; codes are index+1 (0 = no reason recorded)
ABORT_REASONS = (
    "nowait_conflict",      # NO_WAIT: requested row held incompatibly
    "waitdie_wound",        # WAIT_DIE: younger requester dies
    "ts_too_old_read",      # TIMESTAMP: read under a newer committed write
    "ts_too_old_write",     # TIMESTAMP: write under a newer read/write ts
    "mvcc_version_miss",    # MVCC: version evicted / pending prewrite lost
    "occ_validation",       # OCC: read set intersects a committed write set
    "maat_range_collapse",  # MAAT: [lower, upper) squeezed empty
    "user_abort",           # workload logic rollback (TPC-C rbk)
    "compact_spill",        # live-entry compaction bucket overflow retry
    "backoff_reabort",      # re-abort on the first tick back from backoff
    "route_overflow",       # sharded: per-(src,dst) route capacity abort
    "other",                # unattributed
)
REASON = {name: i + 1 for i, name in enumerate(ABORT_REASONS)}
REASON_NONE = 0
assert len(ABORT_REASONS) < 16, "reason codes must fit 4 decision bits"


def static_reason(cfg, name: str, shape, device="cpu"):
    """Constant reason-lane tensor for plugins whose access aborts all
    carry one code (None when the observatory is off)."""
    if not cfg.abort_attribution:
        return None
    return torch.full(shape, REASON[name], dtype=torch.int32, device=device)


def compaction_counters(cfg, device="cpu") -> dict:
    """The two db scalars a plugin carries when the config opts into a
    compaction bucket; absent otherwise, so default summaries match."""
    if (not cfg.entry_compaction
            or (cfg.compact_lanes is None and not cfg.compact_auto)):
        return {}
    return {"live_entry_cnt": torch.zeros((), dtype=torch.float32,
                                          device=device),
            "compact_overflow_cnt": torch.zeros((), dtype=torch.int32,
                                                device=device)}


def note_compaction(db: dict, view) -> dict:
    """Fold one compact_entries view into the occupancy counters (no-op
    when the config never opted into a bucket)."""
    if "live_entry_cnt" not in db:
        return db
    return {**db,
            "live_entry_cnt": db["live_entry_cnt"]
            + view.n_live.to(torch.float32),
            "compact_overflow_cnt": db["compact_overflow_cnt"]
            + view.overflow}


class AccessDecision(NamedTuple):
    """Per-access outcome for this tick's requests: (B, R) masks, mutually
    exclusive, true only at requested positions.  ``reason`` (abort
    codes) and ``blocker`` (blocker slot + 1) are None unless their
    observatories are on."""

    grant: torch.Tensor
    wait: torch.Tensor
    abort: torch.Tensor
    reason: torch.Tensor | None = None
    blocker: torch.Tensor | None = None


class CCPlugin:
    name: str = "?"
    #: re-draw a timestamp on every restart (worker_thread.cpp:492-495)
    new_ts_on_restart: bool = False
    #: admit at most ``cfg.epoch_size`` fresh txns per tick, the
    #: sequencer's batch release (sequencer.cpp:283-326)
    epoch_admission: bool = False
    #: request the whole access set every tick (TxnManager::acquire_locks,
    #: ycsb_txn.cpp:49-88) instead of the cursor window
    request_all: bool = False
    #: no abort path exists (row_lock.cpp:78-81)
    never_aborts: bool = False
    #: registered reasons this plugin's access decisions can carry
    access_abort_reasons: tuple[str, ...] = ()
    #: the db field holding each slot's commit timestamp, which orders the
    #: tick's commit effects (MaaT's find_bound lower); None: ``txn.ts``
    commit_ts_field: str | None = None

    def init_db(self, cfg: Config, n_rows: int, B: int, R: int,
                device="cpu") -> dict:
        return compaction_counters(cfg, device)

    def on_start(self, cfg: Config, db: dict, txn: TxnState,
                 started: torch.Tensor) -> dict:
        return db

    def access(self, cfg: Config, db: dict, txn: TxnState,
               active: torch.Tensor) -> tuple[AccessDecision, dict]:
        raise NotImplementedError

    def validate(self, cfg: Config, db: dict, txn: TxnState,
                 finishing: torch.Tensor, tick) -> tuple[torch.Tensor, dict]:
        return finishing, db

    def on_commit(self, cfg: Config, db: dict, txn: TxnState,
                  committed: torch.Tensor, commit_ts: torch.Tensor,
                  tick) -> dict:
        return db

    def on_abort(self, cfg: Config, db: dict, txn: TxnState,
                 aborted: torch.Tensor) -> dict:
        return db

    def on_ts_rebase(self, cfg: Config, db: dict, shift) -> dict:
        """Shift timestamp-valued db arrays down by `shift`."""
        return db
