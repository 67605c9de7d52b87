"""Multi-version timestamp ordering (CC_ALG=MVCC), the port of
``deneva_tpu/cc/mvcc.py`` (Row_mvcc, concurrency_control/row_mvcc.cpp:
198-364).

Per-row state is a bounded version ring of ``his_recycle_len`` = H slots,
stored flat and addressed as ``key*H + slot``:

  w_ring  (n_rows*H + K,) committed version timestamps (0 = empty slot)
  r_ring  (n_rows*H + K,) max read ts observed per version
  rts0    (n_rows,)       read ts on the initial version (wts = 0)
  w_floor (n_rows,)       max version ts ever evicted from the ring: an
                          access whose target version lies at or below
                          it aborts

The rings carry K = ``merge_lanes`` scratch cells past their ``n_rows*H``
rows: the commit's version insert stores every one of its K lanes with
one ``index_copy_`` at distinct indices, and the lanes that insert
nothing go to those cells.  Only the ``n_rows*H`` prefix is state
(``visible``).  Every array is updated in place (``index_copy_``,
``scatter_reduce_`` "amax", the rebase kernel), so a captured tick
returns the arrays themselves and its graph copies nothing back
(``engine/graph.py``).

Decision rules (requests in ts order within the tick; a pending prewrite
is a granted write of a live txn):

  READ at ts : v = newest committed version with wts <= ts;
               w_floor in (v.wts, ts]          -> Abort (version evicted)
               pts = max pending prewrite ts before me on the row;
               pts > v.wts                     -> WAIT
               else grant; r_ring[v] = max(r_ring[v], ts)
  WRITE at ts: w_floor in (v.wts, ts]          -> Abort
               r_ring[v] > ts                  -> Abort
               else grant (prewrite pending until commit)
  commit     : the merged ring of a row is the top-H of its old ring and
               its new versions; an evicted or folded version raises
               w_floor.

This slice carries the one-round path.  The depgraph blocker plane and
abort attribution raise (``check_slice`` refuses them first).
"""

from __future__ import annotations

import numpy as np
import torch

from deneva_tpu_torch.cc import compact as ccompact
from deneva_tpu_torch.cc.base import AccessDecision, CCPlugin
from deneva_tpu_torch.cc.timestamp import (
    decide_rules, pending_before, raise_max,
)
from deneva_tpu_torch.config import TPCC, Config
from deneva_tpu_torch.engine.state import (
    BIG_TS, NULL_KEY, TxnState, contract_window, expand_window, make_entries,
    request_window,
)
from deneva_tpu_torch.ops import rebase
from deneva_tpu_torch.ops import segment as seg

I32 = torch.int32
I64 = torch.int64

#: the per-row state arrays, rings first
STATE_KEYS = ("w_ring", "r_ring", "rts0", "w_floor")


def merge_lanes(cfg: Config, B: int, R: int) -> int:
    """K, the lanes of a tick's version insert: the steady-state bound of
    committed write lanes per tick (admission cap x written rows per txn;
    TPC-C writes at most district + order + one row per item), at least
    4096, at most B*R.  Committed writes past K fold into ``w_floor``."""
    acap = cfg.admit_cap if cfg.admit_cap is not None else B
    wpt = (cfg.max_items_per_txn + 2) if cfg.workload == TPCC else R
    return min(B * R, max(4096, acap * wpt))


def version_lookup(db: dict, key: torch.Tensor, ts: torch.Tensor, H: int):
    """Newest committed version with wts <= ts for each lane: (v_ts,
    v_slot, evicted).  v_ts == 0 is the initial version; ``evicted`` flags
    lanes whose target version may have left the ring (the floor lies in
    (v_ts, ts]).  ``torch.argmax``, like ``jnp.argmax``, returns the first
    of equal maxima, so tied versions (a rebase clamps old ones to 1) pick
    the lowest slot, as the reference does."""
    n_rows = db["rts0"].shape[0]
    k = torch.clamp(key, 0, n_rows - 1).to(I64)
    slots = torch.arange(H, dtype=I64, device=key.device)
    ring = db["w_ring"][(k * H)[:, None] + slots[None, :]]
    eligible = (ring > 0) & (ring <= ts[:, None])
    v_ts = torch.where(eligible, ring, 0).amax(dim=1)
    v_slot = torch.where(eligible, ring, -1).argmax(dim=1).to(I32)
    floor = db["w_floor"][k]
    evicted = (floor > v_ts) & (floor <= ts)
    return v_ts, v_slot, evicted


def _decide(key, ts, is_write, held, req, w_abort, r_abort, v_ts):
    """The per-request MVCC decision over flat entry arrays: T/O's sort
    (``timestamp.pending_before``), and a read waits when the max
    pending-prewrite ts before it on its row lies above its version.  That
    max is the ts of the last pending lane before it, since ts does not
    decrease inside a row: no cummax.  Returns (grant, wait, abort) in
    entry order."""
    pts = pending_before(
        key, ts, is_write, held, req, w_abort,
        lambda sts, pending, starts, sidx:
            seg.seg_prefix_max_sorted(sts, pending, sidx))
    r_wait = (pts > v_ts) & (pts > 0)
    return decide_rules(req, is_write, w_abort, r_abort, r_wait)


class Mvcc(CCPlugin):
    name = "MVCC"
    new_ts_on_restart = True
    access_abort_reasons = ("mvcc_version_miss",)

    def init_db(self, cfg: Config, n_rows: int, B: int, R: int,
                device="cpu") -> dict:
        cells = n_rows * cfg.his_recycle_len + merge_lanes(cfg, B, R)
        z = lambda n: torch.zeros(n, dtype=I32, device=device)
        return {**super().init_db(cfg, n_rows, B, R, device),
                "w_ring": z(cells), "r_ring": z(cells),
                "rts0": z(n_rows), "w_floor": z(n_rows),
                # committed writes folded into the floor because a commit
                # burst straddled the K-lane merge (a device counter, so
                # it moves on a graph replay)
                "mvcc_tail_fold_cnt": torch.zeros((), dtype=I32,
                                                  device=device)}

    def db_from_numpy(self, cfg: Config, arrays: dict, B: int, R: int,
                      device="cpu") -> dict:
        """A db of this plugin holding `arrays`, the JAX package's MVCC db
        as numpy arrays (rings of ``n_rows*H`` cells): each goes into the
        head of its array; the rings' scratch cells are 0."""
        db = self.init_db(cfg, np.asarray(arrays["rts0"]).shape[0], B, R,
                          device)
        for k, v in arrays.items():
            src = torch.from_numpy(np.array(v)).reshape(-1)
            db[k].view(-1)[:src.numel()].copy_(src)
        return db

    @staticmethod
    def visible(cfg: Config, db: dict) -> dict:
        """The per-row state, ``STATE_KEYS``: the rings without their
        scratch cells."""
        cells = db["rts0"].shape[0] * cfg.his_recycle_len
        return {k: db[k][:cells] if k.endswith("_ring") else db[k]
                for k in STATE_KEYS}

    def on_ts_rebase(self, cfg: Config, db: dict, shift) -> dict:
        """The rings by ``x > 0 ? max(x - shift, 1) : 0``, ``rts0`` and
        ``w_floor`` by ``max(x - shift, 0)``: two launches of the rebase
        kernel, in place (``shift`` an int64 scalar tensor, 0 on a tick
        that does not rebase)."""
        rebase.rebase_(db["w_ring"], db["r_ring"], shift, ring=True)
        rebase.rebase_(db["rts0"], db["w_floor"], shift)
        return db

    def access(self, cfg: Config, db: dict, txn: TxnState, active):
        unported = [name for name, on in (
            ("depgraph", cfg.depgraph),
            ("abort_attribution", cfg.abort_attribution)) if on]
        if unported:
            raise NotImplementedError(
                "MVCC in the port runs the one-round path only; not "
                "ported: " + ", ".join(unported))
        ent = make_entries(txn, active, window=cfg.acquire_window)
        B, R = txn.keys.shape
        n_rows = db["rts0"].shape[0]
        H = cfg.his_recycle_len

        # version lookup at the request lanes only (B*W, not B*R)
        rkey, riw, _ = request_window(txn, active, cfg.acquire_window)
        W = rkey.shape[1]
        kw = rkey.reshape(-1)
        tsw = txn.ts[:, None].expand(B, W).reshape(-1)
        v_ts_w, v_slot_w, evicted_w = version_lookup(db, kw, tsw, H)
        kc = torch.clamp(kw, 0, n_rows - 1)
        vcell = kc * H + v_slot_w
        rts_v_w = torch.where(v_ts_w > 0, db["r_ring"][vcell.to(I64)],
                              db["rts0"][kc.to(I64)])

        # prewrite rule: a later read already observed my target version
        w_abort_w = (rts_v_w > tsw) | evicted_w
        w_abort, evicted, v_ts = (
            expand_window(txn, x.reshape(B, W)).reshape(-1)
            for x in (w_abort_w, evicted_w, v_ts_w))

        db, ac = ccompact.compact_access(cfg, db, ent, B, R,
                                         extras=(w_abort, evicted, v_ts))
        grant_e, wait_e, abort_e = _decide(
            ac.ent.key, ac.ent.ts, ac.ent.is_write, ac.ent.held,
            ac.ent.req, *ac.extras)
        grant_e, wait_e, abort_e = ccompact.finish_access(
            ac, ent.req, grant_e, wait_e, abort_e)

        # granted reads record their ts on the version they read, from the
        # request lanes (grant is only ever set there)
        grant = grant_e.reshape(B, R)
        gr_w = (contract_window(txn, grant, W) & ~riw).reshape(-1)
        raise_max(db["r_ring"], vcell, gr_w & (v_ts_w > 0), tsw)
        raise_max(db["rts0"], kw, gr_w & (v_ts_w == 0), tsw)
        return AccessDecision(grant=grant, wait=wait_e.reshape(B, R),
                              abort=abort_e.reshape(B, R)), db

    def on_commit(self, cfg: Config, db: dict, txn: TxnState, committed,
                  commit_ts, tick) -> dict:
        """Insert every committed write as a version: the merged ring of a
        row is the top-H of its old ring and its new versions (the closed
        form of newest-first min-slot insertion, ``mvcc.py:254-265`` of the
        JAX package).  A new version at rank p among its row's new ones
        survives iff p + |{old > it}| < H, and replaces the p-th smallest
        old slot, whose value goes to the floor; a folded version raises
        the floor itself."""
        B, R = txn.keys.shape
        dev = txn.keys.device
        n_rows = db["rts0"].shape[0]
        H = cfg.his_recycle_len
        ridx = torch.arange(R, dtype=I32, device=dev)[None, :]
        wmask = (committed[:, None] & txn.is_write
                 & (ridx < txn.n_req[:, None])).reshape(-1)
        key = torch.where(wmask, txn.keys.reshape(-1), NULL_KEY)
        ts = txn.ts[:, None].expand(B, R).reshape(-1)

        # newest first within each row; dead lanes sort last, so the live
        # committed writes are a prefix: the merge takes its first K lanes
        (skey, _, sts, slive), starts, sidx = seg.sort_pack_scan(
            (key, BIG_TS - ts, ts, wmask), num_keys=2)
        K = merge_lanes(cfg, B, R)
        stsK, sliveK = sts[:K], slive[:K]
        kk = torch.clamp(skey[:K], 0, n_rows - 1)
        # rank among the row's new versions
        pos = seg.pos_in_segment(starts[:K], sidx[:K])

        slots = torch.arange(H, dtype=I64, device=dev)
        ring = db["w_ring"][(kk.to(I64) * H)[:, None] + slots[None, :]]
        cnt_gt = (ring > stsK[:, None]).sum(dim=1, dtype=I32)
        survive = sliveK & (pos + cnt_gt < H)
        # stable, as jnp.sort/argsort: empty slots (0) tie, and the slot
        # chosen among them must be the reference's
        ring_asc, slot_asc = torch.sort(ring, dim=1, stable=True)
        p = torch.clamp(pos, max=H - 1).to(I64)[:, None]
        slot = slot_asc.gather(1, p)[:, 0].to(I32)
        old_at_p = ring_asc.gather(1, p)[:, 0]

        # survivors land on distinct ring cells (distinct ranks of a row
        # pick distinct old slots); the other lanes on distinct scratch
        # cells past n_rows*H, so index_copy_ sees no duplicate index
        lanes = torch.arange(K, dtype=I32, device=dev)
        iflat = torch.where(survive, kk * H + slot,
                            n_rows * H + lanes).to(I64)
        db["w_ring"].index_copy_(0, iflat, stsK)
        db["r_ring"].index_copy_(0, iflat, torch.zeros_like(stsK))
        raise_max(db["w_floor"], kk, sliveK,
                  torch.where(survive, old_at_p, stsK))

        # committed writes past the K lanes fold into the floor and are
        # counted: the reference's lax.cond, as a body that is exact on
        # every tick (it adds nothing when no tail lane is live)
        if skey.shape[0] > K:
            tail = slive[K:]
            raise_max(db["w_floor"], torch.clamp(skey[K:], 0, n_rows - 1),
                      tail, sts[K:])
            db["mvcc_tail_fold_cnt"].add_(tail.sum(dtype=I32))
        return db
