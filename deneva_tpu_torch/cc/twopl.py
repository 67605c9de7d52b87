"""Batched two-phase-locking arbitration (NO_WAIT / WAIT_DIE / CALVIN).

Replaces the reference's per-row mutex and owner/waiter lists
(concurrency_control/row_lock.cpp:52-217) with one sorted join per tick:
sort all live lock entries by (row_key, held-before-request, priority)
and resolve grants with prefix reductions inside each row segment.
Requests on a row are processed as if they arrived in timestamp order,
after all held locks:

  grant(read)  = no write lock held or granted earlier in my row segment
  grant(write) = I am the very first entry in my row segment

- NO_WAIT  aborts a failed request (row_lock.cpp:86-90);
- WAIT_DIE waits iff no granted request precedes it and it is older than
  every holder (row_lock.cpp:91-151), else aborts;
- CALVIN   is FIFO and never aborts: the priority is the sequence number
  and a failed entry blocks everything behind it (row_lock.cpp:78-81,
  152-170), so a read grants only if no write entry at all, held or
  requested, granted or not, precedes it; a failed request waits.

The sort is packed to three int32 operands: key and kind share one word
(row ids fit 30 bits) and flags and entry index share another (the entry
index fits 23 bits).
"""

from __future__ import annotations

import torch

from deneva_tpu_torch.engine.state import BIG_TS, Entries
from deneva_tpu_torch.ops import segment as seg

I32 = torch.int32

_IDX_BITS = 23
_IDX_MASK = (1 << _IDX_BITS) - 1
_DEAD_ROW = (1 << 30) - 1


def arbitrate(ent: Entries, policy: str):
    """Resolve this tick's lock requests.  Returns (grant, wait, abort):
    (B*R,) masks in original entry order, true only at request lanes."""
    n = ent.key.shape[0]
    assert n <= 1 << _IDX_BITS, n
    live = ent.held | ent.req
    row = torch.where(live, ent.key, _DEAD_ROW)
    kind = (~ent.held).to(I32)           # held 0, request 1
    keykind = row * 2 + kind
    payload = (torch.arange(n, dtype=I32, device=ent.key.device)
               | (ent.is_write.to(I32) << _IDX_BITS)
               | (ent.held.to(I32) << (_IDX_BITS + 1))
               | (ent.req.to(I32) << (_IDX_BITS + 2)))

    # segments are rows (held and requested lanes together): the starts and
    # start index of the sorted row, keykind >> 1, come with the sort
    (skk, sts, spay), starts, sidx = seg.sort_pack_scan(
        (keykind, ent.ts, payload), num_keys=2, shift=1)
    s_iw = (spay >> _IDX_BITS) & 1 == 1
    s_held = (spay >> (_IDX_BITS + 1)) & 1 == 1
    s_req = (spay >> (_IDX_BITS + 2)) & 1 == 1
    s_idx = spay & _IDX_MASK
    s_live = skk < 2 * _DEAD_ROW          # (skk >> 1) != _DEAD_ROW
    pos = torch.arange(n, dtype=I32, device=skk.device) - sidx

    if policy == "CALVIN":
        # FIFO: any write earlier in the segment (granted or not) blocks
        w_blocks = s_iw & s_live
    else:
        # a write only takes effect at segment position 0, and a held X
        # lock is necessarily there too: "conflicting lock earlier in
        # order" == "a write at pos 0 or a held write before me"
        w_blocks = s_iw & s_live & (s_held | (pos == 0))
    w_before = seg.seg_any_before(w_blocks, starts, sidx)
    s_grant = s_req & torch.where(s_iw, pos == 0, ~w_before)
    s_fail = s_req & ~s_grant
    if policy == "CALVIN":
        s_wait = s_fail
        s_abort = torch.zeros_like(s_fail)
    elif policy == "NO_WAIT":
        s_wait = torch.zeros_like(s_fail)
        s_abort = s_fail
    elif policy == "WAIT_DIE":
        granted_before = seg.seg_any_before(s_grant, starts, sidx)
        # a row's held entries sort first (kind 0), by ts: the minimum held
        # ts is the segment start's ts if that entry is held
        min_held_ts = torch.where(s_held.index_select(0, sidx),
                                  sts.index_select(0, sidx), BIG_TS)
        canwait = ~granted_before & (sts < min_held_ts)
        s_wait = s_fail & canwait
        s_abort = s_fail & ~canwait
    else:
        raise ValueError(policy)

    packed = (s_grant.to(I32) | (s_wait.to(I32) << 1)
              | (s_abort.to(I32) << 2))
    out = seg.unpermute(s_idx, packed)
    return out & 1 == 1, (out >> 1) & 1 == 1, (out >> 2) & 1 == 1
