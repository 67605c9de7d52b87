"""Access-path live-prefix compaction glue shared by the CC plugins.

This slice runs the identity view: with neither ``compact_lanes`` nor
``compact_auto`` set, ``Config.compact_width`` is B*R, the kernels see
every entry lane, and the finish helpers only expand identity views.  The
compacted branch (K < B*R, spill ranking and forced retries) comes with
the compaction slice and raises until then.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from deneva_tpu_torch.cc import base as cc_base
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.state import Entries
from deneva_tpu_torch.ops import segment as seg


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
    """Returns ``(db, AccessCompaction)``; the identity view when K >= n."""
    n = ent.key.shape[0]
    K = cfg.compact_width(n, B, request_all=request_all)
    if K < n:
        raise NotImplementedError(
            "live-entry compaction (compact_lanes / compact_auto) is not "
            "ported yet")
    live = ent.held | ent.req
    view, _ = seg.compact_entries(live, n)
    db = cc_base.note_compaction(db, view)
    dev = ent.key.device
    return db, AccessCompaction(
        view=view, ent=ent,
        unsafe=torch.zeros((), dtype=torch.bool, device=dev),
        ovf_b=torch.zeros(B, dtype=torch.bool, device=dev),
        extras=tuple(extras))


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
