"""Optimistic concurrency control (CC_ALG=OCC): a port of
``deneva_tpu/cc/occ.py``, the rebuild of OptCC (Kung-Robinson backward
validation, concurrency_control/occ.cpp:116-294).

- ``access`` grants every requested access: the work phase is optimistic,
  nothing waits and nothing aborts there.
- ``validate`` runs at commit.  The history check: a finishing txn fails
  if a committed write landed on its read set after its (re)start,
  ``occ_wcommit[k] > start_tick`` with ``occ_wcommit`` the tick of each
  row's last committed write.  The same-tick active-writer check: this
  tick's finishers are serialized by ts, and a txn fails if an earlier
  finisher that itself validates writes a key of its read or write set.
  That is a fixed point, iterated to convergence as the reference's
  ``while_loop`` does (``device_loop.run_while``: on the host eagerly, a
  WHILE node of the graph in a captured tick).
- ``on_commit`` stamps the tick into ``occ_wcommit`` at committed writes.

With ``commit_after_access`` the engine validates after the tick's access
phase.  A writer can then commit (``occ_wcommit[k] = t``) in the tick a
txn admitted at ``t`` reads ``k``; the history check's strict ``>`` does
not abort that reader (``wcommit == start_tick``), in the reference as
here (tests/test_torch_commit_after.py holds it with a hand-made pool).
The fixed point runs after the access phase, in the eager host loop and
in the captured graph's WHILE node alike.

With ``compact_lanes`` or ``compact_auto`` the active-writer check runs
at the compacted live width K (``compact_live``): the validation sort
and every pass of the fixed point see K lanes, and a txn with a spilled
lane votes no.  The reference picks its history-check gather by
``lax.cond`` (the compacted K-row or the full (B, R) gather); both give
the same verdicts and no counter records the choice, so the port runs
the full gather on every tick.  Its depgraph victim plane, the
``net_delay_ticks`` prepare marks and the sharded ``group_and`` branch
are outside the slice (``check_slice`` refuses their configs).
"""

from __future__ import annotations

import numpy as np
import torch

from deneva_tpu_torch.cc import base as cc_base
from deneva_tpu_torch.cc.base import AccessDecision, CCPlugin
from deneva_tpu_torch.cc.timestamp import raise_max
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.state import NULL_KEY, TxnState, make_entries
from deneva_tpu_torch.ops import device_loop
from deneva_tpu_torch.ops import segment as seg
from deneva_tpu_torch.workloads.base import QueryPool

I32 = torch.int32
I64 = torch.int64

#: the device_loop site of the active-writer fixed point
LOOP_SITE = "occ"


class Occ(CCPlugin):
    name = "OCC"
    new_ts_on_restart = True     # start_ts re-drawn per attempt

    def init_db(self, cfg: Config, n_rows: int, B: int, R: int,
                device="cpu") -> dict:
        z = lambda: torch.zeros((), dtype=I32, device=device)
        return {**super().init_db(cfg, n_rows, B, R, device),
                "occ_wcommit": torch.full((n_rows,), -1, dtype=I32,
                                          device=device),
                # validation outcome counters: history-check failures and
                # active-set conflicts, warm-up gated
                "occ_hist_abort_cnt": z(),
                "occ_active_abort_cnt": z()}

    def access(self, cfg: Config, db: dict, txn: TxnState, active):
        B, R = txn.keys.shape
        req = make_entries(txn, active,
                           window=cfg.acquire_window).req.reshape(B, R)
        z = torch.zeros_like(req)
        return AccessDecision(grant=req, wait=z, abort=z), db

    def validate(self, cfg: Config, db: dict, txn: TxnState, finishing,
                 tick):
        valid_acc, pass1 = history_check(db, txn, finishing)
        db, pass1, cols = compact_live(cfg, db, txn, valid_acc, pass1)
        step, valid = make_step(txn.keys.shape[0], cols, pass1)
        device_loop.run_while(step, LOOP_SITE, pass1.device)
        measuring = tick >= cfg.warmup_ticks
        for key, failed in (("occ_hist_abort_cnt", finishing & ~pass1),
                            ("occ_active_abort_cnt", pass1 & ~valid)):
            db[key].add_(torch.where(measuring, failed.sum(dtype=I32), 0))
        return valid, db

    def on_commit(self, cfg: Config, db: dict, txn: TxnState, committed,
                  commit_ts, tick) -> dict:
        # append my write set to the history: each written row's last
        # committed-write tick (occ.cpp:277-286); every cell is >= -1, so
        # the other lanes put -1 (raise_max spreads them over the rows)
        R = txn.keys.shape[1]
        ridx = torch.arange(R, dtype=I32, device=committed.device)[None, :]
        wmask = committed[:, None] & txn.is_write \
            & (ridx < txn.n_req[:, None])
        raise_max(db["occ_wcommit"], txn.keys.reshape(-1),
                  wmask.reshape(-1), tick.expand(wmask.numel()), fill=-1)
        return db


def history_check(db: dict, txn: TxnState, finishing):
    """The history check (occ.cpp:167-180), the full (B, R) gather: a
    finishing txn fails if a committed write landed on its read set after
    its (re)start.  Returns the finishers' accesses (B, R) and the txns
    that pass (B,)."""
    R = txn.keys.shape[1]
    wcommit = db["occ_wcommit"]
    ridx = torch.arange(R, dtype=I32, device=finishing.device)[None, :]
    valid_acc = finishing[:, None] & (ridx < txn.n_req[:, None])
    rmask = valid_acc & ~txn.is_write
    k = torch.clamp(txn.keys, 0, wcommit.shape[0] - 1).to(I64)
    conf = rmask & (wcommit[k] > txn.start_tick[:, None])
    return valid_acc, finishing & ~conf.any(dim=1)


def compact_live(cfg: Config, db: dict, txn: TxnState, valid_acc, pass1):
    """The live lanes of the active-writer check (the accesses of the
    finishers that passed the history check) as columns ``(key, ts, iw,
    tx)``, compacted to ``Config.compact_width`` lanes (maat.py's and the
    reference's ``compact_entries``; the identity view at default flags).
    Every lane here is retryable, so there is no class ranking: a txn with
    a spilled lane votes no, like a failed validator leaving the active
    set.  Returns ``(db, pass1, cols)``, db with the occupancy counters
    and pass1 less the spilled txns."""
    B, R = txn.keys.shape
    ent_live = (valid_acc & pass1[:, None]).reshape(-1)
    key = torch.where(ent_live, txn.keys.reshape(-1), NULL_KEY)
    ts = txn.ts.repeat_interleave(R)
    tx = torch.arange(B, dtype=I32, device=pass1.device).repeat_interleave(R)
    K = cfg.compact_width(B * R, B)
    view, cols = seg.compact_entries(ent_live, K, key, ts,
                                     txn.is_write.reshape(-1), tx)
    db = cc_base.note_compaction(db, view)
    if not view.identity:
        spilled = seg.overflow_mask(ent_live, K).reshape(B, R).any(dim=1)
        pass1 = pass1 & ~spilled
    return db, pass1, cols


def make_step(B: int, cols, pass1):
    """The same-tick active-writer check (occ.cpp:185-233): txns that
    passed the history check, serialized by ts; a failed validator leaves
    the active set, so only finishers that validate block later ones.
    The unique fixed point of "valid = pass1 & no earlier valid writer
    conflicts" is iterated to convergence (pass n settles every conflict
    chain of depth <= n).  One sort of the live columns ``cols``
    (``compact_live``'s, at its width) by (key, ts) gives the row
    segments; each pass moves ``valid`` into sorted order by a gather
    through the sort's ``tx`` column (the reference re-sorts on the same
    keys), so no pass sorts.  Returns ``(step, valid)``: one pass, for
    ``device_loop.run_while``, and the carry it updates in place, which
    holds the verdicts once the loop ends."""
    dev = pass1.device
    (skey, _, s_iw, s_tx), starts, sidx = seg.sort_pack_scan(cols,
                                                             num_keys=2)
    n = skey.shape[0]
    live = skey != NULL_KEY
    live_w = live & s_iw
    # a txn never conflicts with itself: read the blocking count at the
    # start of my (key, txn) run
    run_start = starts | seg.segment_starts(s_tx)
    rs_idx = seg.run_start_index(run_start, sidx)
    s_tx = s_tx.to(I64)
    # the carry: valid and the per-txn conflict flags, at fixed addresses.
    # A lane that finds no conflict scatters to one of B scratch cells
    # past the txns', spread by lane (the reference drops it at cell B; on
    # the card n atomics on one cell would serialize)
    valid = pass1.clone()
    conflict = torch.zeros(2 * B, dtype=I32, device=dev)
    miss = B + torch.arange(n, dtype=I64, device=dev) % B
    hit = torch.where(live, s_tx, miss)
    ones = torch.ones_like(skey)

    def step():
        blocking = live_w & valid.index_select(0, s_tx)
        cnt_before = seg.seg_cumsum_exclusive(blocking.to(I32), starts, sidx)
        at_start = seg.at_run_start(cnt_before, run_start, sidx, -1,
                                    rs_idx=rs_idx)
        conflict.scatter_reduce_(0, torch.where(at_start > 0, hit, miss),
                                 ones, "amax")
        new_valid = pass1 & (conflict[:B] == 0)
        changed = (new_valid != valid).any()
        valid.copy_(new_valid)
        conflict.zero_()
        return changed

    return step, valid


def chain_pool(n: int):
    """A config and a hand-made pool of `n` txns that all finish in tick 2,
    in ts order, txn i reading the row txn i-1 writes (txn 0 reads a row
    nobody writes).  The active-writer fixed point alternates down the
    chain: it takes n passes, and the even txns commit (n/2 for even n)."""
    keys = np.stack([np.r_[n + 10, np.arange(n - 1)], np.arange(n)],
                    1).astype(np.int32)
    iw = np.zeros_like(keys, bool)
    iw[:, 1] = True
    pool = QueryPool(keys=keys, is_write=iw, n_req=np.full(n, 2, np.int32),
                     home_part=np.zeros(n, np.int32),
                     txn_type=np.zeros(n, np.int32),
                     args=np.zeros((n, 1), np.int32))
    kw = dict(cc_alg="OCC", batch_size=n, synth_table_size=2 * n + 16,
              req_per_query=2, query_pool_size=n, warmup_ticks=0,
              backoff=False)
    return kw, pool
