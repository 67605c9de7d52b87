"""Access-path live-prefix compaction glue shared by the CC plugins
(``Config.compact_lanes`` / ``compact_auto``; the port of
``deneva_tpu/cc/compact.py``).

``ops/segment.py`` gives the width mechanics (``compact_entries`` /
``expand_entries``); this module adds the access path's safety
discipline, where the entry view mixes lanes with different failure
semantics:

- a REQUEST lane's txn can always be told to retry (abort, or wait for
  a never-aborting plugin), so request lanes may spill past the bucket;
- a HELD lane of a txn that also requests this tick may spill too:
  forcing that txn to retry releases its locks;
- a HELD lane of a txn with NO request this tick (a finishing txn
  holding its locks to commit) must never be invisible: nothing can
  force it to retry, and a grant against its unseen lock would break
  mutual exclusion.

``compact_access`` therefore ranks lanes in three classes (non-retryable
held, retryable held, requests), each in its original relative order.
If the first class alone does not fit (``unsafe``, a device bool), the
tick's arbitration degrades to all-WAIT: a one-tick stall, counted in
``compact_overflow_cnt``.

Cross-class ties: the class reordering cannot change a decision against
the padded run.  Every downstream sort keys on (row, ts) at least, and a
live txn's ts is unique, so two lanes tie only inside one txn.  A txn's
lanes are all in the first class or all in the other two, where its held
lanes (before its cursor) precede its request lanes as they did, so the
kernel's lane tie-break only compares lanes whose order compaction kept.
That holds when a txn touches one row twice too
(tests/test_torch_compaction.py, the repeated-key pool).

With neither flag set, ``Config.compact_width`` is B*R and every helper
here is the identity.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deneva_tpu_torch.cc import base as cc_base
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.state import Entries
from deneva_tpu_torch.ops import segment as seg

I32 = torch.int32


class AccessCompaction(NamedTuple):
    """One access-path compaction: the geometry, the entries the kernel
    arbitrates, and the spill bookkeeping ``finish_access`` folds in."""

    view: seg.CompactView
    ent: Entries
    unsafe: torch.Tensor    # () bool: non-retryable lanes spilled -> stall
    ovf_b: torch.Tensor     # (B,) txns with retryable spilled lanes
    extras: tuple = ()


def compact_access(cfg: Config, db: dict, ent: Entries, B: int, R: int,
                   request_all: bool = False, extras: tuple = ()):
    """Compact an access-phase entry view to K lanes (see the module
    doc): ``(db, AccessCompaction)``, db carrying the occupancy counters.
    ``extras`` are more (n,) per-lane arrays the caller needs at width K;
    they ride the same sort.  K >= n is the identity view."""
    n = ent.key.shape[0]
    K = cfg.compact_width(n, B, request_all=request_all)
    live = ent.held | ent.req
    dev = ent.key.device
    if K >= n:
        view, _ = seg.compact_entries(live, n)
        db = cc_base.note_compaction(db, view)
        return db, AccessCompaction(
            view=view, ent=ent,
            unsafe=torch.zeros((), dtype=torch.bool, device=dev),
            ovf_b=torch.zeros(B, dtype=torch.bool, device=dev),
            extras=tuple(extras))

    # lane classes: held lanes of txns with no request this tick cannot be
    # forced to retry and rank first
    has_req_e = ent.req.reshape(B, R).any(dim=1).repeat_interleave(R)
    c1 = ent.held & ~has_req_e
    c2 = ent.held & has_req_e
    idx = torch.arange(n, dtype=I32, device=dev)
    keyrank = torch.where(c1, idx, torch.where(
        c2, n + idx, torch.where(ent.req, 2 * n + idx, 3 * n + idx)))
    i32 = seg.as_i32
    srt = seg.sort_pack(
        (keyrank, ent.key, ent.txn, ent.ridx, ent.ts, i32(ent.is_write),
         i32(ent.held), i32(ent.req)) + tuple(i32(x) for x in extras),
        num_keys=1, is_stable=False)
    cent = Entries(
        key=srt[1][:K], txn=srt[2][:K], ridx=srt[3][:K], ts=srt[4][:K],
        is_write=srt[5][:K] == 1, held=srt[6][:K] == 1, req=srt[7][:K] == 1)
    cex = tuple(s[:K] == 1 if x.dtype == torch.bool else s[:K]
                for x, s in zip(extras, srt[8:]))

    n_live = live.sum(dtype=I32)
    n_c1 = c1.sum(dtype=I32)
    view = seg.CompactView(
        width=K, n=n, orig_sorted=srt[0] % n, live=srt[0][:K] < 3 * n,
        n_live=n_live, overflow=torch.clamp(n_live - K, min=0))
    db = cc_base.note_compaction(db, view)

    # spilled lanes: live entries whose class-ordered rank is >= K
    excl = lambda m: torch.cumsum(m, 0, dtype=I32) - m.to(I32)
    rank = torch.where(c1, excl(c1), torch.where(
        c2, n_c1 + excl(c2), n_c1 + c2.sum(dtype=I32) + excl(ent.req)))
    ovf_e = live & (rank >= K)
    return db, AccessCompaction(
        view=view, ent=cent, unsafe=n_c1 > K,
        ovf_b=(ovf_e & (c2 | ent.req)).reshape(B, R).any(dim=1),
        extras=cex)


def finish_access(ac: AccessCompaction, req_e: torch.Tensor,
                  grant: torch.Tensor, wait: torch.Tensor,
                  abort: torch.Tensor, never_aborts: bool = False):
    """Expand width-K decision masks to full width and fold in the spill
    semantics: txns with spilled lanes retry, an ``unsafe`` tick stalls."""
    n = req_e.shape[0]
    B = ac.ovf_b.shape[0]
    grant, wait, abort = seg.expand_entries(ac.view, grant, wait, abort)
    ovf_e = ac.ovf_b.repeat_interleave(n // B)
    retry = req_e & ovf_e
    grant = grant & ~ovf_e
    if never_aborts:
        wait = (wait & ~ovf_e) | retry
        abort = abort & ~ovf_e
    else:
        wait = wait & ~ovf_e
        abort = (abort & ~ovf_e) | retry
    grant = grant & ~ac.unsafe
    wait = torch.where(ac.unsafe, req_e, wait)
    abort = abort & ~ac.unsafe
    return grant, wait, abort


def finish_reason(ac: AccessCompaction, req_e: torch.Tensor, reason,
                  never_aborts: bool = False):
    """Expand a width-K reason plane like ``finish_access``; spill-forced
    retries carry ``compact_spill``.  None passes through."""
    if reason is None:
        return None
    n = req_e.shape[0]
    B = ac.ovf_b.shape[0]
    (reason,) = seg.expand_entries(ac.view, reason)
    if not never_aborts:
        ovf_e = ac.ovf_b.repeat_interleave(n // B)
        reason = torch.where(req_e & ovf_e, cc_base.REASON["compact_spill"],
                             reason)
    return reason
