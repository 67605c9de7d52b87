"""CALVIN: deterministic, lock-based, abort-free execution.

A port of ``deneva_tpu/cc/calvin.py``.  The reference's Calvin path is a
sequencer that batches client txns into epochs and numbers them
(system/sequencer.cpp:207), a lock thread that acquires all of a txn's
locks up front in that order through the FIFO, never-aborting Row_lock
CALVIN mode (system/calvin_thread.cpp:40-100, row_lock.cpp:78-81,152-170),
and workers that run a txn once all its locks are granted.  Batched:

- the epoch is one tick: the engine admits at most ``cfg.epoch_size``
  fresh txns per tick (``epoch_admission``), and the admission timestamp
  is the sequence number;
- every tick a txn requests its whole access set (``request_all``), held
  to the FIFO grant of ``twopl.arbitrate(..., "CALVIN")``: a write grants
  only at the head of its row's live entries, a read only if no write
  precedes it, and nothing aborts (``never_aborts``);
- a txn commits the tick after its last lock grants: the commit block
  runs before that tick's access phase and frees its locks for it.  With
  ``commit_after_access`` the commit block runs after the access block, so
  a txn commits in the tick its last lock grants: it holds all its entries
  through that tick's access phase and frees them at that tick's commit,
  one tick sooner.  Either way the commit order walks the batch's
  conflict graph frontier by frontier.

PPS's reconnaissance deferral lives in the engine (``recon_defer`` in
``engine/scheduler.py``).  ``check_slice`` refuses the depgraph blocker
plane.
"""

from __future__ import annotations

from deneva_tpu_torch.cc import compact as ccompact
from deneva_tpu_torch.cc import twopl
from deneva_tpu_torch.cc.base import AccessDecision, CCPlugin
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.state import TxnState, make_entries


class Calvin(CCPlugin):
    name = "CALVIN"
    epoch_admission = True   # sequencer batch release per tick
    request_all = True       # acquire_locks() requests every access
    never_aborts = True      # row_lock.cpp:78-81

    def access(self, cfg: Config, db: dict, txn: TxnState, active):
        B, R = txn.keys.shape
        # locks are held from grant to commit whatever the isolation level
        # (system/txn.cpp:778-788); every access is requested every tick
        ent = make_entries(txn, active, read_locks_held=True, window=R)
        db, ac = ccompact.compact_access(cfg, db, ent, B, R,
                                         request_all=self.request_all)
        g, w, a = twopl.arbitrate(ac.ent, "CALVIN")
        g, w, a = ccompact.finish_access(ac, ent.req, g, w, a,
                                         never_aborts=self.never_aborts)
        return AccessDecision(grant=g.reshape(B, R), wait=w.reshape(B, R),
                              abort=a.reshape(B, R)), db
