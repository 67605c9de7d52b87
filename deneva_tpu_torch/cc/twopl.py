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

from deneva_tpu_torch.engine.state import (
    BIG_TS, NULL_KEY, Entries, expand_window, request_window,
)
from deneva_tpu_torch.ops import segment as seg

I32 = torch.int32
I64 = torch.int64

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


# ---------------------------------------------------------------------------
# Dense per-row arbitration (Config.dense_lock_state): the held locks
# aggregated by scatter into a per-row scratch, and only the requests sorted
# ---------------------------------------------------------------------------
#
# The same decisions as ``arbitrate``, from one packed per-row aggregate of
# the held entries (a scatter-min into a row-indexed scratch) and a sort of
# the B*W request lanes alone:
#   write grants  <=>  nothing held on the row and it heads the row's
#                      requests;
#   read grants (NO_WAIT/WAIT_DIE)  <=>  no held write, and the row's head
#     request is not an older write on a free row;
#   read grants (CALVIN FIFO)  <=>  no held write and no write request
#     before it on the row;
#   WAIT_DIE canwait = no granted request older than me and ts < min held
#     ts, the granted set read off the row's head and its minimum read.
#
# The scratch lives in the plugin's db and is at its identity (BIG_TS on
# every row) between ticks: the tick lowers the held rows and puts the
# identity back on them before it returns, so no tick clears it and the
# timestamp rebase never sees it.

_SIGN = -(2**31)        # ts - 2^31 marks a WRITE in the packed min


def init_lock_tmp(n_rows: int, device="cpu") -> dict:
    """The identity-valued per-row held-lock scratch of
    ``arbitrate_window``: one packed int32 per row, the min over held
    entries of {is_write ? ts - 2^31 : ts}.  It reads BIG_TS where nothing
    is held, below 0 where a write is held (exclusive, so the only
    holder), and its minimum holder ts otherwise."""
    return {"lk_held": torch.full((n_rows,), BIG_TS, dtype=I32,
                                  device=device)}


def arbitrate_window(txn, active, policy: str, tmp: dict, window: int,
                     read_locks_held: bool = True):
    """Dense-row arbitration of the cursor-window requests: the held
    entries scatter-min their packed priority into ``tmp["lk_held"]`` in
    place, the requests [cursor, cursor + W) are extracted by masked
    reductions, and only the B*W request lanes are sorted, by (row, ts), on
    the sort + scan kernel; the one dynamic lookup is the scratch gather at
    the sorted request rows.  Returns the (B, R) grant, wait and abort
    masks; the scratch is back at its identity."""
    B, R = txn.keys.shape
    W = min(window, R)
    dev = txn.keys.device
    ridx = torch.arange(R, dtype=I32, device=dev)[None, :]
    lk_held = tmp["lk_held"]
    n_rows = lk_held.shape[0]
    ts = txn.ts
    held = active[:, None] & (ridx < txn.cursor[:, None])
    if not read_locks_held:
        held = held & txn.is_write

    # -- held aggregate: one in-place scatter-min of the packed priority;
    # the other lanes put the identity at rows spread by lane --
    hidx = seg.spread_index(held.reshape(-1), txn.keys.reshape(-1), n_rows)
    p_held = torch.where(txn.is_write, ts[:, None] + _SIGN, ts[:, None])
    lk_held.scatter_reduce_(0, hidx,
                            torch.where(held, p_held, BIG_TS).reshape(-1),
                            "amin")

    # -- request extraction: masked reductions (int32 sums), no gathers --
    rkey, riw, _ = request_window(txn, active, W)

    # -- sort only the requests by (row, ts): B*W lanes, not B*R --
    n = B * W
    assert n <= 1 << _IDX_BITS, n
    lane = torch.arange(n, dtype=I32, device=dev)
    payload = lane | (riw.reshape(-1).to(I32) << _IDX_BITS)
    (srow, sts, spay), starts, sidx = seg.sort_pack_scan(
        (rkey.reshape(-1), ts[:, None].expand(B, W).reshape(-1), payload),
        num_keys=2)
    s_iw = (spay >> _IDX_BITS) & 1 == 1
    s_idx = spay & _IDX_MASK
    s_live = srow != NULL_KEY
    pos = lane - sidx
    head_iw = s_iw.index_select(0, sidx)
    head_ts = sts.index_select(0, sidx)

    # held lookup at the sorted request rows
    h = lk_held.index_select(0, torch.where(s_live, srow, 0).to(I64))
    no_held = h == BIG_TS
    hw = h < 0
    mh = torch.where(hw, h - _SIGN, h)    # min held ts (a write is alone)

    grant_w = no_held & (pos == 0)
    if policy == "CALVIN":
        # FIFO: any older write request (granted or not) blocks a read
        any_w_before = seg.seg_any_before(s_iw & s_live, starts, sidx)
        grant_r = ~hw & ~any_w_before
    else:
        head_is_older_write = no_held & head_iw & (pos > 0)
        grant_r = ~hw & ~head_is_older_write
    s_grant = s_live & torch.where(s_iw, grant_w, grant_r)
    s_fail = s_live & ~s_grant
    if policy == "CALVIN":
        s_wait = s_fail
        s_abort = torch.zeros_like(s_fail)
    elif policy == "NO_WAIT":
        s_wait = torch.zeros_like(s_fail)
        s_abort = s_fail
    elif policy == "WAIT_DIE":
        # the granted set on my row: nothing under a held write; every
        # older read request unless the row is free with a write at its
        # head; exactly that head write otherwise (row_lock.cpp:91-151)
        mrr = seg.seg_min_where(sts, ~s_iw & s_live, starts, BIG_TS, sidx)
        head_write = no_held & head_iw
        granted_before = ~hw & torch.where(head_write, head_ts < sts,
                                           mrr < sts)
        canwait = ~granted_before & (sts < mh)
        s_wait = s_fail & canwait
        s_abort = s_fail & ~canwait
    else:
        raise ValueError(policy)

    packed = (s_grant.to(I32) | (s_wait.to(I32) << 1)
              | (s_abort.to(I32) << 2))
    out = seg.unpermute(s_idx, packed).reshape(B, W)

    # -- the identity back on every held row: an in-place scatter-max of
    # BIG_TS.  The other lanes put BIG_TS too, at rows spread by lane: that
    # is exact only because every row the scatter-min above did not lower
    # is still at BIG_TS, and only after the lookup --
    lk_held.scatter_reduce_(0, hidx, torch.full_like(hidx, BIG_TS, dtype=I32),
                            "amax")
    return tuple(expand_window(txn, (out >> b) & 1 == 1, False)
                 for b in range(3))


# ---------------------------------------------------------------------------
# Sub-ticked arbitration (Config.sub_ticks): K timestamp-ordered rounds
# ---------------------------------------------------------------------------


def ts_groups(ts, active, K: int):
    """Contiguous timestamp groups of the sub-rounds: the live txns ranked
    by ts and split into K quantile groups (the 2PL and TIMESTAMP sub-tick
    paths share it).  The rank is the slot order of one stable (ts, lane)
    pack on the sort kernel, inverted by an ``index_copy_`` at the
    permutation's distinct indices; the live count stays on the device."""
    B = ts.shape[0]
    lane = torch.arange(B, dtype=I32, device=ts.device)
    _, (order,) = seg.sort_by((torch.where(active, ts, BIG_TS),), (lane,))
    rank = torch.empty_like(lane).index_copy_(0, order.to(I64), lane)
    n_act = torch.clamp(active.sum(dtype=I32), min=1)
    return torch.clamp(rank * K // n_act, max=K - 1)


def arbitrate_subticked(txn, active, policy: str, K: int,
                        read_locks_held: bool = True):
    """Arbitrate one tick's requests in K timestamp-ordered sub-rounds.

    The one-round tick decides every request against the tick-start lock
    state.  Here the batch is split into K contiguous ts groups, and group
    k arbitrates against the state groups < k left (their grants added,
    their aborted txns' locks removed): each round is one ``arbitrate``
    (a lock sort and an unpermute on the kernel), its grant, wait, abort
    and dead masks carried on the device.

    Needs acquire_window == 1.  Returns the (B, R) grant, wait and abort
    masks."""
    B, R = txn.keys.shape
    dev = txn.keys.device
    ridx = torch.arange(R, dtype=I32, device=dev)[None, :]
    cur = txn.cursor[:, None]
    held_base = active[:, None] & (ridx < cur)
    if not read_locks_held:
        held_base = held_base & txn.is_write
    req_base = active[:, None] & (ridx == cur) & (cur < txn.n_req[:, None])
    group = ts_groups(txn.ts, active, K)

    G = torch.zeros((B, R), dtype=torch.bool, device=dev)
    Wt = torch.zeros_like(G)
    A = torch.zeros_like(G)
    dead = torch.zeros(B, dtype=torch.bool, device=dev)
    flat = lambda x: x.reshape(-1)
    tse = flat(txn.ts[:, None].expand(B, R))
    txe = torch.arange(B, dtype=I32, device=dev).repeat_interleave(R)
    ridx_e = flat(ridx.expand(B, R))
    iw = flat(txn.is_write)

    for k in range(K):
        held_m = (held_base | G) & ~dead[:, None]
        req_m = req_base & (active & (group == k) & ~dead)[:, None]
        live = held_m | req_m
        ent = Entries(key=flat(torch.where(live, txn.keys, NULL_KEY)),
                      txn=txe, ridx=ridx_e, ts=tse, is_write=iw,
                      held=flat(held_m), req=flat(req_m))
        g, w, a = (x.reshape(B, R) for x in arbitrate(ent, policy))
        G, Wt, A = G | g, Wt | w, A | a
        dead = dead | a.any(dim=1)
    return G, Wt, A
