"""Basic timestamp ordering (CC_ALG=TIMESTAMP), the port of
``deneva_tpu/cc/timestamp.py`` (Row_ts, concurrency_control/row_ts.cpp:
167-323).

Per-row state is two int32 arrays, ``wts`` and ``rts``, only ever raised
by scatter-max: monotone, so no update needs an undo, and max is
order-free, so the scatter is exact in any order.  Both are updated in
place (``scatter_reduce_`` "amax"), and so is the timestamp rebase
(``ops/rebase.py``: on the card a kernel that returns at once on a tick
that does not rebase): a captured tick then returns the arrays themselves
and its graph copies nothing back (``engine/graph.py``).

Decision rules (per request, processed in ts order within the tick):

  READ  at ts: ts < wts[k]                        -> Abort  (row_ts.cpp:176)
               exists pending prewrite pts < ts   -> WAIT   (row_ts.cpp:181)
               else grant, rts[k] = max(rts[k],ts)          (row_ts.cpp:187)
  WRITE at ts: ts < rts[k] or ts < wts[k]         -> Abort  (row_ts.cpp:192-200)
               else grant (prewrite buffered)
  commit:      wts[k] = max(wts[k], ts) for writes
  TS_TWR:      ts < wts[k] does not abort the prewrite (Thomas write rule)

A pending prewrite is a granted write of a live txn, or a write granted
earlier in this tick.  Writers never block one another, so several txns
can commit writes to one row in one tick (TPC-C's restock chain takes any
depth, ``workloads/tpcc.py``).

``sub_ticks > 1`` runs K timestamp-ordered sub-rounds of the same
decision (``_access_subticked``).  The depgraph blocker plane and abort
attribution raise (``check_slice`` refuses them first).
"""

from __future__ import annotations

import torch

from deneva_tpu_torch.cc import compact as ccompact
from deneva_tpu_torch.cc import twopl
from deneva_tpu_torch.cc.base import AccessDecision, CCPlugin
from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.state import (
    NULL_KEY, TxnState, contract_window, expand_window, make_entries,
    request_window,
)
from deneva_tpu_torch.ops import rebase
from deneva_tpu_torch.ops import segment as seg

I32 = torch.int32
I64 = torch.int64


def raise_max(dst: torch.Tensor, row, mask, vals, fill: int = 0) -> None:
    """``dst[row] = max(dst[row], vals)`` where ``mask``, in place.  Lanes
    outside the mask put ``fill`` (``dst`` holds values >= fill) at a row
    spread by lane, in bounds and off any single hot row."""
    dst.scatter_reduce_(0, seg.spread_index(mask, row, dst.shape[0]),
                        torch.where(mask, vals, fill), "amax")


def pending_before(key, ts, is_write, held, req, w_abort, reduce):
    """The sort both timestamp plugins decide by (this one and
    ``cc/mvcc.py``): one sort of the flat entry arrays by (key, ts) whose
    scan gives the row segments, and the pending prewrites among them (a
    write entry that is held, or requested and not aborted).
    ``reduce(sts, pending, starts, sidx)`` turns them into a value per
    sorted lane, returned in entry order."""
    n = key.shape[0]
    orig = torch.arange(n, dtype=I32, device=key.device)
    (skey, sts, s_iw, s_held, s_req, s_wab, s_orig), starts, sidx = \
        seg.sort_pack_scan((key, ts, is_write, held, req, w_abort, orig),
                           num_keys=2)
    pending = (skey != NULL_KEY) & s_iw & (s_held | (s_req & ~s_wab))
    return seg.unpermute(s_orig, reduce(sts, pending, starts, sidx))


def decide_rules(req, is_write, w_abort, r_abort, r_wait):
    """Grant a write unless it aborts; grant a read unless it aborts or
    waits on a pending prewrite.  Returns (grant, wait, abort)."""
    grant = req & torch.where(is_write, ~w_abort, ~r_abort & ~r_wait)
    wait = req & ~is_write & ~r_abort & r_wait
    abort = req & ~grant & ~wait
    return grant, wait, abort


def _decide(key, ts, is_write, held, req, w_abort, r_abort):
    """The per-request T/O decision over flat entry arrays: a read waits
    on a pending prewrite before it on its row ("a write entry with
    smaller ts on my key").  Returns (grant, wait, abort) in entry
    order."""
    pw = pending_before(
        key, ts, is_write, held, req, w_abort,
        lambda sts, pending, starts, sidx:
            seg.seg_any_before(pending, starts, sidx))
    return decide_rules(req, is_write, w_abort, r_abort, pw)


class Timestamp(CCPlugin):
    name = "TIMESTAMP"
    new_ts_on_restart = True  # is_cc_new_timestamp(), worker_thread.cpp:492
    access_abort_reasons = ("ts_too_old_read", "ts_too_old_write")
    # hot-key escalation gate of the adaptive controller: a stalled T/O
    # writer retries with its ts intact
    esc_gate_ok = True

    def init_db(self, cfg: Config, n_rows: int, B: int, R: int,
                device="cpu") -> dict:
        return {**super().init_db(cfg, n_rows, B, R, device),
                "wts": torch.zeros(n_rows, dtype=I32, device=device),
                "rts": torch.zeros(n_rows, dtype=I32, device=device)}

    def on_ts_rebase(self, cfg: Config, db: dict, shift) -> dict:
        """``max(x - shift, 0)`` on both arrays, in place (``shift`` an
        int64 scalar tensor, 0 on a tick that does not rebase)."""
        rebase.rebase_(db["wts"], db["rts"], shift)
        return db

    def access(self, cfg: Config, db: dict, txn: TxnState, active):
        unported = [name for name, on in (
            ("depgraph", cfg.depgraph),
            ("abort_attribution", cfg.abort_attribution)) if on]
        if unported:
            raise NotImplementedError(
                "TIMESTAMP in the port has no blocker or reason plane; not "
                "ported: " + ", ".join(unported))
        if cfg.sub_ticks > 1:
            return self._access_subticked(cfg, db, txn, active)
        ent = make_entries(txn, active, window=cfg.acquire_window)
        B, R = txn.keys.shape
        n_rows = db["wts"].shape[0]

        # row state gathered at the request lanes only (B*W, not B*R)
        rkey, riw, _ = request_window(txn, active, cfg.acquire_window)
        kr = torch.clamp(rkey, 0, n_rows - 1).reshape(-1).to(I64)
        wts_r = db["wts"][kr].reshape(rkey.shape)
        rts_r = db["rts"][kr].reshape(rkey.shape)
        tsw = txn.ts[:, None]
        if cfg.ts_twr:
            w_abort_w = tsw < rts_r
        else:
            w_abort_w = (tsw < rts_r) | (tsw < wts_r)
        r_abort_w = tsw < wts_r
        w_abort = expand_window(txn, w_abort_w).reshape(-1)
        r_abort = expand_window(txn, r_abort_w).reshape(-1)

        db, ac = ccompact.compact_access(cfg, db, ent, B, R,
                                         extras=(w_abort, r_abort))
        grant_e, wait_e, abort_e = _decide(
            ac.ent.key, ac.ent.ts, ac.ent.is_write, ac.ent.held,
            ac.ent.req, *ac.extras)
        grant_e, wait_e, abort_e = ccompact.finish_access(
            ac, ent.req, grant_e, wait_e, abort_e)

        # granted reads advance rts at once (row_ts.cpp:187-189), from the
        # request lanes (grant is only ever set there)
        grant = grant_e.reshape(B, R)
        gr_w = contract_window(txn, grant, rkey.shape[1]) & ~riw
        raise_max(db["rts"], rkey.reshape(-1), gr_w.reshape(-1),
                  tsw.expand(rkey.shape).reshape(-1))
        return AccessDecision(grant=grant, wait=wait_e.reshape(B, R),
                              abort=abort_e.reshape(B, R)), db

    def _access_subticked(self, cfg: Config, db: dict, txn: TxnState,
                          active):
        """K timestamp-ordered sub-rounds (Config.sub_ticks), each one
        ``_decide`` (the (key, ts) decision sort and its unpermute on the
        kernel).  Later groups no longer see the prewrites of txns an
        earlier group's request aborted, and do see the writes it granted.
        ``wts``/``rts`` are gathered once at the (B, R) lanes' clipped
        keys: a granted read's rts raise can only pass the ts of later,
        larger-ts writers, which it never aborts, so the inputs hold for
        every round.  Granted reads raise ``rts`` once, at the end."""
        K = cfg.sub_ticks
        B, R = txn.keys.shape
        dev = txn.keys.device
        ridx = torch.arange(R, dtype=I32, device=dev)[None, :]
        cur = txn.cursor[:, None]
        req_base = active[:, None] & (ridx == cur) \
            & (cur < txn.n_req[:, None])
        held_base = active[:, None] & (ridx < cur)
        ts_e = txn.ts[:, None].expand(B, R)

        n_rows = db["wts"].shape[0]
        kclip = torch.clamp(txn.keys, 0, n_rows - 1).reshape(-1).to(I64)
        wts_k = db["wts"][kclip].reshape(B, R)
        rts_k = db["rts"][kclip].reshape(B, R)
        if cfg.ts_twr:
            w_abort = ts_e < rts_k
        else:
            w_abort = (ts_e < rts_k) | (ts_e < wts_k)
        r_abort = ts_e < wts_k

        group = twopl.ts_groups(txn.ts, active, K)
        G = torch.zeros((B, R), dtype=torch.bool, device=dev)
        Wt = torch.zeros_like(G)
        A = torch.zeros_like(G)
        dead = torch.zeros(B, dtype=torch.bool, device=dev)
        flat = lambda x: x.reshape(-1)
        tsf, iwf = flat(ts_e), flat(txn.is_write)
        wabf, rabf = flat(w_abort), flat(r_abort)
        for k in range(K):
            req_m = req_base & (active & (group == k) & ~dead)[:, None]
            held_m = (held_base | G) & ~dead[:, None]
            key_f = flat(torch.where(held_m | req_m, txn.keys, NULL_KEY))
            g, w, a = (x.reshape(B, R) for x in _decide(
                key_f, tsf, iwf, flat(held_m), flat(req_m), wabf, rabf))
            G, Wt, A = G | g, Wt | w, A | a
            dead = dead | a.any(dim=1)

        raise_max(db["rts"], flat(txn.keys), flat(G & ~txn.is_write), tsf)
        return AccessDecision(grant=G, wait=Wt, abort=A), db

    def on_commit(self, cfg: Config, db: dict, txn: TxnState, committed,
                  commit_ts, tick) -> dict:
        ridx = torch.arange(txn.R, dtype=I32, device=txn.keys.device)[None, :]
        wmask = committed[:, None] & txn.is_write \
            & (ridx < txn.n_req[:, None])
        raise_max(db["wts"], txn.keys.reshape(-1), wmask.reshape(-1),
                  txn.ts[:, None].expand(txn.keys.shape).reshape(-1))
        return db
