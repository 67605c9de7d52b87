"""Workload-independent query-pool container and workload boundary.

As in the reference (client/client_query.cpp:30-121), every client query
is generated on the host before the run; the engine consumes the pool by
cursor and wraps around when it is exhausted.

The commit effects of TPC-C and PPS choose between a compacted and a
full-width body on a device value, the reference's ``lax.cond``; both
bodies give identical tables.  ``WorkloadPlugin.effect_branch`` makes that
choice on the host in the eager tick (one read).  With ``on_device`` (the
tick of ``Engine.run_compiled`` on either device, and so every captured
CUDA graph) it reads nothing: the full-width body runs, which is exact
on every tick, and the counters record the reference's choice.
CUDA-graph conditional nodes would let the graph run the cheaper
compacted body, but the PyTorch of the H100 host (2.11) does not expose
them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

I32 = torch.int32
I64 = torch.int64


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


def iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def effect_lanes(cfg, n: int, per_txn: int, floor: int) -> int:
    """K, the lanes of a compacted commit-effect body for n entries: a
    committing txn carries at most ``per_txn`` effect entries, commits per
    tick do not exceed admissions in steady state, and K is at least
    ``floor`` (the reference's per-workload minimum), at most n."""
    acap = cfg.admit_cap if cfg.admit_cap is not None else cfg.batch_size
    return min(n, max(floor, acap * per_txn))


def add_rows(dst: torch.Tensor, row, mask, vals) -> None:
    """``dst[row] += vals`` where ``mask``, in place: int32 ``index_add_``,
    exact in any order.  Lanes outside the mask add 0 at a row spread by
    lane, in bounds and off any single hot row."""
    lanes = iota(row.shape[0], row.device)
    idx = torch.where(mask, row, lanes % dst.shape[0])
    m = mask if vals.dim() == 1 else mask[:, None]
    dst.index_add_(0, idx.to(I64), torch.where(m, vals, 0))


def store_rows(dst: torch.Tensor, row, mask, vals) -> None:
    """``dst[row] = vals`` where ``mask``, in place, for rows that are
    distinct across the masked lanes: the exact int32 add of
    ``vals - dst[row]``, so no lane needs a scratch row."""
    m = mask if vals.dim() == 1 else mask[:, None]
    old = dst[torch.where(mask, row, 0).to(I64)]
    add_rows(dst, row, mask, torch.where(m, vals - old, 0))


def unpermute_rows(order: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``out[order[i]] = vals[i]`` for a sort permutation ``order``: sorted
    values back to lane order (``index_copy_`` onto distinct indices)."""
    return torch.empty_like(vals).index_copy_(0, order.to(I64), vals)


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
    #: txn types that Calvin's sequencer sends through reconnaissance
    #: first (sequencer.cpp:88-114): admitted one epoch late
    recon_types: tuple = ()
    #: the port's own device counters (outside the engine's stats and
    #: tables, which are held equal to the reference's): the effect bodies
    #: taken, "compact" and "full", and workload-specific ones
    counter_names: tuple = ()

    def __init__(self):
        #: name -> () int32 counter on the engine's device
        self.counters: dict = {}

    def init_counters(self, device) -> None:
        """Zero every counter on ``device`` (the engine does this before
        any tick, so no counter is first made inside a captured graph)."""
        self.counters = {k: torch.zeros((), dtype=I32, device=device)
                         for k in self.counter_names}

    def count(self, name: str, amount) -> None:
        """Add ``amount`` (an int or a device scalar) to a counter, in
        place; a standalone call on a workload without ``init_counters``
        makes the counter on first use."""
        if name not in self.counters:
            dev = amount.device if torch.is_tensor(amount) else "cpu"
            self.counters[name] = torch.zeros((), dtype=I32, device=dev)
        c = self.counters[name]
        c.add_(amount.to(I32) if torch.is_tensor(amount) else amount)

    def counts(self) -> dict:
        """Every counter as a host int (a read of the device)."""
        return {k: int(self.counters[k]) if k in self.counters else 0
                for k in self.counter_names}

    @property
    def branch_ticks(self) -> dict:
        """``apply_commit_entries`` calls by the effect body taken, K-lane
        "compact" or "full", read from the device counters."""
        c = self.counts()
        return {"compact": c.get("compact", 0), "full": c.get("full", 0)}

    def effect_branch(self, fits, eff, compact_fn, full_fn,
                      on_device: bool = False) -> None:
        """The reference's ``lax.cond``: ``compact_fn(eff)`` if the () bool
        ``fits`` holds, else ``full_fn(eff)``, where both bodies give
        identical tables; the body chosen adds 1 to its counter.  Eager,
        the choice is one host read of ``fits``.  ``on_device`` reads
        nothing: ``full_fn(eff)`` runs, and each counter adds its
        predicate.  The bodies update tables in place and return nothing."""
        if not on_device:
            name, fn = ("compact", compact_fn) if bool(fits) \
                else ("full", full_fn)
            self.count(name, 1)
            fn(eff)
            return
        self.count("compact", fits)
        self.count("full", ~fits)
        full_fn(eff)

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
                             fields: dict, cts, live,
                             on_device: bool = False) -> dict:
        """Apply the effects of the (n,) entries where ``live``, ordered
        within the tick by commit timestamp ``cts``; ``key_local`` are
        shard-local catalog rows of shard ``part``.  ``on_device`` makes
        the effect branch on the device (``effect_branch``)."""
        return tables

    def user_abort(self, cfg, txn, finishing: torch.Tensor) -> torch.Tensor:
        """Finishing txns that roll back by workload logic: none."""
        return torch.zeros_like(finishing)

    def pool_user_abort(self, cfg, pool: QueryPool) -> np.ndarray:
        """(Q,) bool: ``user_abort``'s decision per pool row (it depends on
        the pool only)."""
        return np.zeros(pool.size, bool)
