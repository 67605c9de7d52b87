"""2PL lock-family plugins: NO_WAIT and WAIT_DIE.

NO_WAIT: lock conflict => immediate abort (row_lock.cpp:86-90).
WAIT_DIE: older txns wait, younger die (row_lock.cpp:91-151); timestamps
assigned once at first start (worker_thread.cpp:478-480).

Isolation levels (reference config.h:336-340; release-early hooks
ycsb_txn.cpp:233-251):
- SERIALIZABLE: strict 2PL, all locks to commit.
- READ_COMMITTED: S locks released right after the read, so completed
  reads are not held entries.
- READ_UNCOMMITTED: reads take no lock at all: read requests bypass
  arbitration and always grant.
- NOLOCK: CC disabled (storage/row.cpp:199-206): every request grants.

The arbitration runs one of three ways, in the reference's order:
``sub_ticks > 1`` under SERIALIZABLE or READ_COMMITTED takes K sub-rounds
(``twopl.arbitrate_subticked``); ``dense_lock_state`` under those two
levels with an ``acquire_window`` of at most 8 takes the dense-row window
(``twopl.arbitrate_window``, its per-row scratch ``lk_held`` in the db);
everything else takes the sorted-segment join, where NOLOCK and
READ_UNCOMMITTED take their one-round bypass whatever ``sub_ticks`` is.
The depgraph blocker plane and abort attribution are refused by the
engine (``check_slice``).
"""

from __future__ import annotations

import torch

from deneva_tpu_torch.cc import compact as ccompact
from deneva_tpu_torch.cc import twopl
from deneva_tpu_torch.cc.base import AccessDecision, CCPlugin, static_reason
from deneva_tpu_torch.config import (
    NOLOCK, READ_COMMITTED, READ_UNCOMMITTED, SERIALIZABLE, Config,
)
from deneva_tpu_torch.engine.state import NULL_KEY, TxnState, make_entries


class TwoPLPlugin(CCPlugin):
    policy = "NO_WAIT"
    access_abort_reasons = ("nowait_conflict",)

    def _window_path(self, cfg: Config) -> bool:
        """The dense-row window covers SERIALIZABLE and READ_COMMITTED
        with windows of at most 8; READ_UNCOMMITTED's read bypass, NOLOCK
        and wider windows stay on the sorted-segment join."""
        return (cfg.dense_lock_state
                and cfg.isolation_level in (SERIALIZABLE, READ_COMMITTED)
                and cfg.acquire_window <= 8)

    def init_db(self, cfg: Config, n_rows: int, B: int, R: int,
                device="cpu") -> dict:
        db = super().init_db(cfg, n_rows, B, R, device)
        if self._window_path(cfg):
            db.update(twopl.init_lock_tmp(n_rows, device))
        return db

    def _decision(self, cfg, g, w, a):
        B, R = g.shape
        return AccessDecision(
            grant=g, wait=w, abort=a,
            reason=static_reason(cfg, self.access_abort_reasons[0], (B, R),
                                 g.device))

    def access(self, cfg: Config, db: dict, txn: TxnState, active):
        B, R = txn.keys.shape
        level = cfg.isolation_level
        if cfg.sub_ticks > 1 and level in (SERIALIZABLE, READ_COMMITTED):
            # finer time quantization (Config.sub_ticks); NOLOCK and
            # READ_UNCOMMITTED take their bypass paths below.
            # pipeline_exchange is not read: the reference only hoists the
            # request planes for XLA to schedule, and on one stream its
            # values equal these in-order rounds'
            assert cfg.acquire_window == 1, "sub_ticks needs window=1"
            g, w, a = twopl.arbitrate_subticked(
                txn, active, self.policy, cfg.sub_ticks,
                read_locks_held=(level == SERIALIZABLE))
            return self._decision(cfg, g, w, a), db
        if self._window_path(cfg):
            # lk_held is updated and restored in place
            g, w, a = twopl.arbitrate_window(
                txn, active, self.policy, db, cfg.acquire_window,
                read_locks_held=(level != READ_COMMITTED))
            return self._decision(cfg, g, w, a), db

        ent = make_entries(
            txn, active,
            read_locks_held=level not in (READ_COMMITTED, READ_UNCOMMITTED),
            window=cfg.acquire_window)
        if level == NOLOCK:
            z = torch.zeros((B, R), dtype=torch.bool, device=txn.keys.device)
            return AccessDecision(grant=ent.req.reshape(B, R), wait=z,
                                  abort=z), db
        bypass = None
        if level == READ_UNCOMMITTED:
            # reads lock nothing: drop read requests from arbitration
            drop = ent.req & ~ent.is_write
            bypass = drop.reshape(B, R)
            ent = ent._replace(key=torch.where(drop, NULL_KEY, ent.key),
                               req=ent.req & ~drop)

        # sorted-segment join over the (identity) compacted view
        db, ac = ccompact.compact_access(cfg, db, ent, B, R)
        g, w, a = twopl.arbitrate(ac.ent, self.policy)
        reason = static_reason(cfg, self.access_abort_reasons[0], a.shape,
                               a.device)
        g, w, a = ccompact.finish_access(ac, ent.req, g, w, a)
        reason = ccompact.finish_reason(ac, ent.req, reason)
        if reason is not None:
            reason = reason.reshape(B, R)
        g = g.reshape(B, R)
        if bypass is not None:
            g = g | bypass
        return AccessDecision(grant=g, wait=w.reshape(B, R),
                              abort=a.reshape(B, R), reason=reason), db


class NoWait(TwoPLPlugin):
    name = "NO_WAIT"
    policy = "NO_WAIT"
    access_abort_reasons = ("nowait_conflict",)


class WaitDie(TwoPLPlugin):
    name = "WAIT_DIE"
    policy = "WAIT_DIE"
    new_ts_on_restart = False
    access_abort_reasons = ("waitdie_wound",)
