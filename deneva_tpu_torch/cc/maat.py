"""MaaT dynamic timestamp-range validation (CC_ALG=MAAT): a port of
``deneva_tpu/cc/maat.py``, the rebuild of Maat + TimeTable + Row_maat
(concurrency_control/maat.cpp:29-190, row_maat.cpp:99-314), single shard.

State (``init_db``):

  maat_lr, maat_lw        (n_rows,) last committed read / write ts per row
  maat_lower, maat_upper  (B,) each slot's [lower, upper) range
  maat_gw, maat_gr        (B,) greatest lw / lr a slot saw at its accesses

and six counters, warm-up gated: ``maat_case1_cnt`` and
``maat_case3_cnt`` (the reference's families), ``maat_chain_cap_cnt``,
``maat_chain_push_cnt``, ``maat_range_abort_cnt`` and
``maat_chain_overflow_cnt`` (the JAX package's, ``init_db`` there).

- ``access`` grants every requested access and raises ``maat_gw`` /
  ``maat_gr`` from the rows at the request window.
- ``validate`` runs at commit: cases 1 and 3 (the lower above the
  snapshots), then the same-tick commit chain, then the directional
  squeeze of the runners' ranges.  The chain is a fixed point over the
  finishers' bounds in access order, with the reference's own stopping
  point: it runs only when some row has two finishing validators, then
  two passes, then up to 64 more while a pass changed something (66 in
  all).  Here it is ``device_loop.run_while`` (a host loop eagerly, a
  WHILE node in a captured tick) with that rule in its flag (``flag``).
  When no row has two validators the one pass that ``run_while`` always
  runs reproduces its inputs (the reader cap excludes the validator's own
  run and no writer pair exists), which is the reference's skip branch.
- ``on_commit`` raises ``maat_lw`` / ``maat_lr`` to the commit ts, the
  final lower (find_bound), in place.

With ``commit_after_access`` ``validate`` runs after the tick's access
phase: the chain sort (key, finishing first, ts) sees finishers whose last
access was granted in this tick (access tick ``t``), so the passes a tick
runs change; the 66-pass bound stays the reference's.
- ``on_ts_rebase`` shifts the six arrays: the rows by the rebase kernel's
  ring rule in place, the slots by plain ops.  The upper's rule is not the
  identity at a shift of 0 (an upper of 0 would become 1), so it applies
  only on a tick that rebases.

Two sorts per tick, both 3-key packs on the sort + scan kernel: the chain
sort by (key, finishing first, ts), carrying is_write, the access tick and
the txn, and the squeeze sort by (key, access tick, ts), carrying the
lane.  The reference re-sorts on the same keys to ship per-txn values
into either order (``to_chain`` on every pass, the ducked bounds once, and
the squeeze pack's per-txn payloads); here each is a gather through the
sorted txn column.  That is exact: those re-sorts tie only inside one
txn's run (the reference's own precondition: ts is unique per live txn),
and per-txn values are constant there.

With ``compact_lanes`` or ``compact_auto`` the entry view is compacted
to K lanes first (``entries``): cases 1/3 are unchanged, and the chain
sort, ``pair_window``, every pass and the squeeze's sort and scans run
at K, with the reference's spill rules (a finisher with a spilled lane
votes no, a spilled runner's lane stalls every vote of the tick).

Out of the slice (``check_slice`` refuses their configs): the 2PC
prepare window, the sharded group combine and the
sharded hooks (``remote_cache_probe``, ``commit_forward_entries``,
``home_commit_check``), the depgraph plane and abort attribution.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from deneva_tpu_torch.cc import base as cc_base
from deneva_tpu_torch.cc import occ
from deneva_tpu_torch.cc.base import AccessDecision, CCPlugin
from deneva_tpu_torch.cc.timestamp import raise_max
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.state import (
    BIG_TS, NULL_KEY, STATUS_RUNNING, STATUS_WAITING, TxnState, make_entries,
    request_window,
)
from deneva_tpu_torch.ops import device_loop, rebase
from deneva_tpu_torch.ops import segment as seg

I32 = torch.int32
I64 = torch.int64

#: the device_loop site of the commit chain
LOOP_SITE = "maat"
#: the chain's passes at most: two unrolled, then the reference's
#: while_loop of at most 64 (deneva_tpu/cc/maat.py:533-551)
MAX_PASSES = 66

COUNTERS = ("maat_case1_cnt", "maat_case3_cnt", "maat_chain_cap_cnt",
            "maat_chain_push_cnt", "maat_range_abort_cnt",
            "maat_chain_overflow_cnt")


def up1(v):
    """Saturating +1 (the reference pins at UINT64_MAX, maat.cpp:81-86)."""
    return torch.clamp(v, max=BIG_TS - 1) + 1


def dn1(v):
    """Saturating -1 (pins at 0, maat.cpp:57-62)."""
    return torch.clamp(v, min=1) - 1


def txn_min(tx, vals, base):
    """``min(base, min of vals over the lanes of each txn)``: a scatter-min
    into a fresh (B,) array, order-free (``tx`` int64 txn per lane)."""
    acc = torch.full_like(base, BIG_TS).scatter_reduce_(0, tx, vals, "amin")
    return torch.minimum(base, acc)


def txn_max(tx, vals, base):
    """``max(base, max of vals over the lanes of each txn)``."""
    acc = torch.zeros_like(base).scatter_reduce_(0, tx, vals, "amax")
    return torch.maximum(base, acc)


def flag(chain_needed, passes, changed):
    """Another pass of the chain: after the first when some row has two
    validators, then while the last pass changed something and fewer
    than MAX_PASSES have run (``passes`` counts them, this one included)."""
    return chain_needed & ((passes == 1)
                           | (changed & (passes < MAX_PASSES)))


class Entries(NamedTuple):
    """The granted accesses of live txns (the soft-lock sets): (B*R,), or
    (K,) compacted."""

    key: torch.Tensor     # NULL_KEY where not a granted access of a live txn
    ts: torch.Tensor
    iw: torch.Tensor
    atick: torch.Tensor   # start_tick + r // acquire_window
    tx: torch.Tensor      # int32 txn slot
    fin: torch.Tensor     # a granted access of a finishing txn


class Chain(NamedTuple):
    """The validation before the squeeze: the chain's ``step`` and carry
    (``ok``, ``lower``, ``upper``, which hold the verdicts and bounds once
    ``run_while`` ends), the bounds after cases 1 and 3, their counters'
    masks, what the counters read of the chain sort, and the db."""

    step: Callable
    ok: torch.Tensor
    lower: torch.Tensor
    upper: torch.Tensor
    static_lower: torch.Tensor
    case1: torch.Tensor
    case3: torch.Tensor
    starts: torch.Tensor
    nfin_seg: torch.Tensor
    ent: Entries
    db: dict              # with the compaction's occupancy counters


def entries(cfg: Config, db: dict, txn: TxnState, finishing) -> tuple:
    """The entry view (``Entries``) at ``Config.compact_width`` lanes (the
    identity view at default flags), with the occupancy counters folded
    into db, each txn's has-a-granted-write, and the txns that may vote
    yes: ``(db, ent, has_write, ok_allowed)``.

    Compaction is one class in the original order (maat.py:245-270): a
    finishing txn with a spilled lane votes no, and a spilled lane of a
    running txn stalls every vote of the tick (a committer might owe that
    unseen runner a squeeze push).  ``stall`` is a device bool.  The
    2PC-prepared flag the reference compacts too is all false on one
    shard (its ``prepared`` is None), so it is left out of the pack."""
    B, R = txn.keys.shape
    dev = finishing.device
    ridx = torch.arange(R, dtype=I32, device=dev)[None, :]
    live_txn = (txn.status == STATUS_RUNNING) | (txn.status == STATUS_WAITING)
    granted = (ridx < txn.cursor[:, None]) & (ridx < txn.n_req[:, None])
    ent_live = (live_txn[:, None] & granted).reshape(-1)
    # MaaT accesses never block: access r was granted at start_tick +
    # r // window; in-tick ties go by ts (maat.py:231-235)
    atick = txn.start_tick[:, None] + ridx // max(cfg.acquire_window, 1)
    full = Entries(
        key=torch.where(ent_live, txn.keys.reshape(-1), NULL_KEY),
        ts=txn.ts.repeat_interleave(R),
        iw=txn.is_write.reshape(-1),
        atick=atick.reshape(-1),
        tx=torch.arange(B, dtype=I32, device=dev).repeat_interleave(R),
        fin=(finishing[:, None] & granted).reshape(-1))
    has_write = (txn.is_write & granted).any(dim=1)
    K = cfg.compact_width(B * R, B)
    view, cols = seg.compact_entries(ent_live, K, *full)
    db = cc_base.note_compaction(db, view)
    if view.identity:
        return db, full, has_write, finishing
    ovf_e = seg.overflow_mask(ent_live, K)
    ovf_fin = (ovf_e & full.fin).reshape(B, R).any(dim=1)
    stall = (ovf_e & ~full.fin).any()
    # the dead tail of the K lanes carries dead entries' txns; the gathers
    # through ``tx`` are clamped as the reference's ``txc`` (maat.py:270)
    ent = Entries(*cols)._replace(tx=torch.clamp(cols[4], 0, B - 1))
    return db, ent, has_write, finishing & ~ovf_fin & ~stall


def pair_window(M: int, fin3, iw3, k3, t3, at3):
    """The pusher lane of each (distance d, target lane) pair, d = 1..M-1,
    as a (M-1, n) gather index (clamped at 0: those lanes are no pair),
    and each pair's static class (maat.py:414-447): 0 no pair, 1
    concordant pusher that wrote, 2 concordant pusher that read, 3
    discordant.  The reference packs the classes 2 bits a distance into
    one word and loops over d; here every distance is one row of one
    (M-1, n) array, made once per tick, and a pass reduces over its rows
    (min and max: exact in any order)."""
    n = k3.shape[0]
    lane = torch.arange(n, dtype=I64, device=k3.device)
    dist = torch.arange(1, M, dtype=I64, device=k3.device)[:, None]
    src = torch.clamp(lane - dist, min=0)
    pair = (fin3 & iw3 & fin3[src] & (lane >= dist) & (k3[src] == k3)
            & (t3[src] != t3))
    cls = torch.where(at3[src] <= at3, 2 - iw3[src].to(I32), 3)
    return src, torch.where(pair, cls, 0)


def make_chain(cfg: Config, db: dict, txn: TxnState, finishing) -> Chain:
    """Cases 1 and 3, the chain sort and the chain's pass
    (maat.py:292-552), for ``device_loop.run_while``.  A pass ships the
    per-txn carry into chain order by a gather through the sort's txn
    column, caps reader targets by the ok earlier writers of the row (a
    prefix min read at the validator's own run start), and pushes or caps
    writer targets pairwise over the nearest M-1 earlier validators; the
    carry moves to the new verdicts and bounds in place, and the pass
    returns ``flag``."""
    dev = finishing.device
    M = max(int(cfg.maat_chain_window), 1)
    db, ent, has_write, ok_allowed = entries(cfg, db, txn, finishing)

    # cases 1/3: the lower above the greatest committed write / read ts
    # seen at access time (maat.cpp:46-48,68-70)
    lower = torch.maximum(db["maat_lower"], db["maat_gw"] + 1)
    case1 = finishing & (db["maat_lower"] <= db["maat_gw"])
    case3 = finishing & has_write & (lower <= db["maat_gr"])
    static_lower = torch.where(finishing & has_write,
                               torch.maximum(lower, db["maat_gr"] + 1), lower)
    upper0 = db["maat_upper"]

    # finishing entries first on each row, in validation (ts) order
    nf = (~ent.fin).to(I32)
    (k3, nf3, t3, iw3, at3, tx3), st3, sidx3 = seg.sort_pack_scan(
        (ent.key, nf, ent.ts, ent.iw, ent.atick, ent.tx), num_keys=3)
    fin3 = (nf3 == 0) & (k3 != NULL_KEY)
    # a (key, txn) run: one txn's entries on one row share its ts
    run_start3 = st3 | (t3 != torch.roll(t3, 1))
    rs_idx = seg.run_start_index(run_start3, sidx3)
    # distinct finishing validators per row: the overflow counter and the
    # gate (a pusher/target pair needs two of them on one row)
    nfin_seg = seg.seg_reduce((run_start3 & fin3).to(I32), st3, "sum",
                              sidx3)
    chain_needed = (st3 & (nfin_seg > 1)).any()
    src, cls = pair_window(M, fin3, iw3, k3, t3, at3)
    tx3 = tx3.to(I64)
    rd3 = fin3 & ~iw3

    # the carry, at fixed addresses; `passes` counts this tick's passes
    ok = ok_allowed.clone()
    lo = static_lower.clone()
    up = upper0.clone()
    passes = torch.zeros((), dtype=I32, device=dev)

    def step():
        s_ok = ok.index_select(0, tx3)
        s_lo = lo.index_select(0, tx3)
        s_up = up.index_select(0, tx3)
        okf = s_ok & fin3
        # READER targets: capped below every ok earlier writer of the row
        # in both access orders, less the validator's own entries
        pmw_full = seg.seg_prefix_min(
            torch.where(okf & iw3, dn1(s_lo), BIG_TS), st3, BIG_TS)
        pmw = seg.at_run_start(pmw_full, None, None, BIG_TS, "min",
                               rs_idx=rs_idx)
        cap_e = torch.where(rd3, pmw, BIG_TS)
        push_e = torch.zeros_like(cap_e)
        if M > 1:
            # WRITER targets, by the pair's access order (maat.py:463-509),
            # every distance at once: row d-1 pairs a lane with the
            # validator d lanes before it
            p_cls = torch.where(okf[src], cls, 0)
            p_lo = s_lo[src]
            p_up = s_up[src]
            # the pusher's upper ducks under my range first
            # (maat.cpp:145-152)
            c1 = torch.where((s_up < BIG_TS) & (s_up > p_lo + 2)
                             & (s_up < p_up), s_up - 2, BIG_TS)
            c2 = torch.where((s_lo > p_lo + 1) & (s_lo < p_up), s_lo - 1,
                             BIG_TS)
            p_up_eff = torch.minimum(p_up, torch.minimum(c1, c2))
            cap_e = torch.minimum(cap_e, torch.where(
                p_cls == 1, dn1(p_lo), BIG_TS).amin(dim=0))
            push_d = torch.where(p_cls == 2, up1(p_lo),
                                 torch.where(p_cls == 3, up1(p_up_eff), 0))
            push_e = torch.maximum(push_e, push_d.amax(dim=0))
        upper_new = txn_min(tx3, cap_e, upper0)
        lower_new = txn_max(tx3, push_e, static_lower)
        new_ok = ok_allowed & (lower_new < upper_new)
        changed = ((new_ok != ok).any() | (lower_new != lo).any()
                   | (upper_new != up).any())
        ok.copy_(new_ok)
        lo.copy_(lower_new)
        up.copy_(upper_new)
        passes.add_(1)
        return flag(chain_needed, passes, changed)

    return Chain(step=step, ok=ok, lower=lo, upper=up,
                 static_lower=static_lower, case1=case1, case3=case3,
                 starts=st3, nfin_seg=nfin_seg, ent=ent, db=db)


class Maat(CCPlugin):
    name = "MAAT"
    new_ts_on_restart = True
    commit_ts_field = "maat_lower"

    def init_db(self, cfg: Config, n_rows: int, B: int, R: int,
                device="cpu") -> dict:
        zeros = lambda n: torch.zeros(n, dtype=I32, device=device)
        db = {**super().init_db(cfg, n_rows, B, R, device),
              "maat_lr": zeros(n_rows), "maat_lw": zeros(n_rows),
              "maat_lower": zeros(B),
              "maat_upper": torch.full((B,), BIG_TS, dtype=I32,
                                       device=device),
              "maat_gw": zeros(B), "maat_gr": zeros(B)}
        db.update({k: zeros(()) for k in COUNTERS})
        return db

    def on_start(self, cfg: Config, db: dict, txn: TxnState, started):
        # time_table.init (worker_thread.cpp:504-508): [0, MAX), fresh snaps
        return {**db,
                "maat_lower": torch.where(started, 0, db["maat_lower"]),
                "maat_upper": torch.where(started, BIG_TS, db["maat_upper"]),
                "maat_gw": torch.where(started, 0, db["maat_gw"]),
                "maat_gr": torch.where(started, 0, db["maat_gr"])}

    def on_ts_rebase(self, cfg: Config, db: dict, shift) -> dict:
        """Shift the six arrays in place by ``shift`` (an int64 scalar
        tensor, 0 on a tick that does not rebase): the rows and the
        snapshots by the ring rule (0 stays "never"), the lower by the
        plain rule, the upper by ``max(u - shift, 1)`` below BIG_TS, on a
        tick that rebases only."""
        rebase.rebase_(db["maat_lr"], db["maat_lw"], shift, ring=True)
        rebase.rebase_plain(db["maat_gw"], db["maat_gr"], shift, ring=True)
        db["maat_lower"].sub_(shift).clamp_(min=0)
        up = db["maat_upper"]
        up.copy_(torch.where((shift > 0) & (up < BIG_TS),
                             torch.clamp(up - shift, min=1), up))
        return db

    def access(self, cfg: Config, db: dict, txn: TxnState, active):
        # everything is granted; snapshot the greatest last write / read
        # ts of the rows at the request window (row_maat.cpp:131-136,
        # 183-189), the read one for writes only
        B, R = txn.keys.shape
        req = make_entries(txn, active,
                           window=cfg.acquire_window).req.reshape(B, R)
        n_rows = db["maat_lr"].shape[0]
        rkey, riw, valid = request_window(txn, active, cfg.acquire_window)
        kw = torch.clamp(rkey, 0, n_rows - 1).reshape(-1).to(I64)
        lw_k = torch.where(valid, db["maat_lw"][kw].reshape(rkey.shape), 0)
        lr_k = torch.where(valid & riw, db["maat_lr"][kw].reshape(rkey.shape),
                           0)
        z = torch.zeros_like(req)
        return (AccessDecision(grant=req, wait=z, abort=z),
                {**db,
                 "maat_gw": torch.maximum(db["maat_gw"], lw_k.amax(dim=1)),
                 "maat_gr": torch.maximum(db["maat_gr"], lr_k.amax(dim=1))})

    def validate(self, cfg: Config, db: dict, txn: TxnState, finishing,
                 tick):
        B, R = txn.keys.shape
        M = max(int(cfg.maat_chain_window), 1)
        ch = make_chain(cfg, db, txn, finishing)
        device_loop.run_while(ch.step, LOOP_SITE, finishing.device)
        ok, lower, upper, db = ch.ok, ch.lower, ch.upper, ch.db

        measuring = tick >= cfg.warmup_ticks
        cnt = lambda m: torch.where(measuring,
                                    (m & finishing).sum(dtype=I32), 0)
        db["maat_case1_cnt"].add_(cnt(ch.case1))
        db["maat_case3_cnt"].add_(cnt(ch.case3))
        db["maat_chain_cap_cnt"].add_(cnt(upper < db["maat_upper"]))
        db["maat_chain_push_cnt"].add_(cnt(lower > ch.static_lower))
        db["maat_range_abort_cnt"].add_(cnt(~ok))
        if M < B:
            # row-ticks with more validators than the pair window
            db["maat_chain_overflow_cnt"].add_(torch.where(
                measuring, (ch.starts & (ch.nfin_seg > M)).sum(dtype=I32),
                0))
        lower_arr, upper_arr = squeeze(db, ch.ent, finishing, ok, lower,
                                       upper)
        return ok, {**db, "maat_lower": lower_arr, "maat_upper": upper_arr}

    def on_commit(self, cfg: Config, db: dict, txn: TxnState, committed,
                  commit_ts, tick) -> dict:
        # commit_timestamp = lower (find_bound, maat.cpp:176-190); raise
        # the rows' lw / lr in place (every cell is >= 0)
        B, R = txn.keys.shape
        ridx = torch.arange(R, dtype=I32, device=committed.device)[None, :]
        acc = committed[:, None] & (ridx < txn.n_req[:, None])
        keys = txn.keys.reshape(-1)
        cts = db["maat_lower"][:, None].expand(B, R).reshape(-1)
        raise_max(db["maat_lw"], keys, (acc & txn.is_write).reshape(-1), cts)
        raise_max(db["maat_lr"], keys, (acc & ~txn.is_write).reshape(-1),
                  cts)
        return db


def squeeze(db: dict, ent: Entries, finishing, ok, lower, upper):
    """The directional neighbour squeeze (maat.py:598-706): the
    validators' self-adjustments (the upper ducks under running writers
    they saw, the lower jumps above running readers), then the pushes
    each committer gives the runners of its rows by access order.
    Returns the new (B,) lower and upper."""
    lo_cur = torch.where(finishing, lower, db["maat_lower"])
    up_cur = torch.where(finishing, upper, db["maat_upper"])
    n = ent.key.shape[0]
    lanes = torch.arange(n, dtype=I32, device=ent.key.device)
    (k2, _, _, l2), st2, _ = seg.sort_pack_scan(
        (ent.key, ent.atick, ent.ts, lanes), num_keys=3)
    l2 = l2.to(I64)
    w2 = ent.iw.index_select(0, l2)
    f2 = ent.fin.index_select(0, l2)
    tx2 = ent.tx.index_select(0, l2).to(I64)
    ok2 = ok.index_select(0, tx2)
    lo2 = lo_cur.index_select(0, tx2)
    up2 = up_cur.index_select(0, tx2)
    live2 = k2 != NULL_KEY
    cw = live2 & f2 & w2 & ok2          # committing writers
    cr = live2 & f2 & ~w2 & ok2         # committing readers
    run2 = live2 & ~f2                  # runners

    # a committer's upper ducks under the range of a running writer it
    # saw (maat.cpp:145-152); its lower jumps above the upper of a running
    # reader it saw, on the rows it wrote (maat.cpp:121-127)
    cand = torch.where(run2 & w2, torch.minimum(
        torch.where(up2 < BIG_TS, up2 - 2, BIG_TS),
        torch.where(lo2 > 1, lo2 - 1, BIG_TS)), BIG_TS)
    pre_cand = seg.seg_prefix_min(cand, st2, BIG_TS)
    adj = txn_min(tx2, torch.where(live2 & f2, pre_cand, BIG_TS),
                  torch.full_like(upper, BIG_TS))
    pre_cand_r = seg.seg_prefix_max(torch.where(run2 & ~w2, up1(up2), 0),
                                    st2, 0)
    adj_lo = txn_max(tx2, torch.where(live2 & f2 & w2, pre_cand_r, 0),
                     torch.zeros_like(lower))
    lower_v = torch.where(ok & (adj_lo > lower) & (adj_lo < upper), adj_lo,
                          lower)
    upper_v = torch.where(ok, torch.maximum(torch.minimum(upper, adj),
                                            lower_v + 1), upper)
    up2c = upper_v.index_select(0, tx2)
    lo2c = lower_v.index_select(0, tx2)

    # committers after me in access order saw me (their validation
    # squeeze orders me after them); committers before me did not (their
    # commit-time forward validation, row_maat.cpp:208-307)
    suf_up_cw = seg.seg_suffix_max(torch.where(cw, up1(up2c), 0), st2, 0)
    suf_up_cr = seg.seg_suffix_max(torch.where(cr, up1(up2c), 0), st2, 0)
    suf_lo_cw = seg.seg_suffix_min(torch.where(cw, dn1(lo2c), BIG_TS), st2,
                                   BIG_TS)
    pre_lo_cr = seg.seg_prefix_max(torch.where(cr, up1(lo2c), 0), st2, 0)
    pre_lo_cw = seg.seg_prefix_min(torch.where(cw, dn1(lo2c), BIG_TS), st2,
                                   BIG_TS)
    # running writers after the committers that saw them, before the
    # committing writers that did not; running readers before every
    # committing writer of the row
    w_lo = torch.maximum(torch.maximum(suf_up_cw, suf_up_cr), pre_lo_cr)
    r_up = torch.minimum(suf_lo_cw, pre_lo_cw)
    new_lo2 = torch.where(run2 & w2, w_lo, 0)
    new_up2 = torch.where(run2, torch.where(w2, pre_lo_cw, r_up), BIG_TS)
    upper_arr = txn_min(tx2, new_up2, db["maat_upper"])
    lower_arr = txn_max(tx2, new_lo2, db["maat_lower"])
    # the validators keep their own bounds (lower_v is the commit ts)
    return (torch.where(finishing, lower_v, lower_arr),
            torch.where(finishing, upper_v, upper_arr))


def chain_pool(n: int):
    """OCC's hand-made chain (``cc/occ.py`` ``chain_pool``) under MAAT: `n`
    txns finishing in tick 2 in ts order, txn i reading the row txn i-1
    writes.  A validator's upper is capped under the lower of an ok writer
    before it, which empties its range, so the verdicts alternate down the
    chain: min(n, MAX_PASSES) passes, the even txns commit for n up to
    MAX_PASSES."""
    kw, pool = occ.chain_pool(n)
    return dict(kw, cc_alg="MAAT"), pool
