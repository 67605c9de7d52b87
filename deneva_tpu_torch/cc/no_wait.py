"""2PL lock-family plugins: NO_WAIT and WAIT_DIE.

NO_WAIT: lock conflict => immediate abort (row_lock.cpp:86-90).
WAIT_DIE: older txns wait, younger die (row_lock.cpp:91-151); timestamps
assigned once at first start (worker_thread.cpp:478-480).  Both are strict
2PL under SERIALIZABLE: all locks held to commit.  The port carries the
sorted-segment join; the dense-row window kernel, sub-tick rounds and the
other isolation levels come with later slices and are refused by the
engine until then.
"""

from __future__ import annotations

from deneva_tpu_torch.cc import compact as ccompact
from deneva_tpu_torch.cc import twopl
from deneva_tpu_torch.cc.base import AccessDecision, CCPlugin, static_reason
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.state import TxnState, make_entries


class TwoPLPlugin(CCPlugin):
    policy = "NO_WAIT"
    access_abort_reasons = ("nowait_conflict",)

    def access(self, cfg: Config, db: dict, txn: TxnState, active):
        B, R = txn.keys.shape
        ent = make_entries(txn, active, read_locks_held=True,
                           window=cfg.acquire_window)
        # sorted-segment join over the (identity) compacted view
        db, ac = ccompact.compact_access(cfg, db, ent, B, R)
        g, w, a = twopl.arbitrate(ac.ent, self.policy)
        reason = static_reason(cfg, self.access_abort_reasons[0], a.shape,
                               a.device)
        g, w, a = ccompact.finish_access(ac, ent.req, g, w, a)
        reason = ccompact.finish_reason(ac, ent.req, reason)
        if reason is not None:
            reason = reason.reshape(B, R)
        return AccessDecision(grant=g.reshape(B, R), wait=w.reshape(B, R),
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
