"""TPC-C (Payment + NewOrder), the reference's second workload, in PyTorch.

A port of ``deneva_tpu/workloads/tpcc.py``.  The host half is a copy: the
catalog, ``RING_COLS``/``ring_view``, ``NURand``, the by-last-name map and
``gen_pool`` give a byte-equal pool for the same ``Config``.  The device
half builds the same packed 2-D tables from the same RNG stream and applies
the same commit effects, bit for bit:

- **access footprint**: Payment touches WAREHOUSE (WR iff ``wh_update``),
  DISTRICT (WR), CUSTOMER (WR); NewOrder reads WAREHOUSE and CUSTOMER,
  writes DISTRICT, then per order line reads ITEM and writes STOCK
  (benchmarks/tpcc_txn.cpp:384-498 state-machine order).
- **commit effects** (the reference's *_1/_3/_5/_9 compute steps and
  ``insert_row``): ``commit_fields`` packs each committing entry's role and
  arguments, ``apply_commit_entries`` applies them to the tables.
- **inserts** (HISTORY / ORDER / NEW-ORDER / ORDER-LINE): preallocated
  rings appended at commit in (commit ts, entry index) order.

Every sort here is a ``segment.sort_pack`` / ``sort_pack_scan``, so inside
the engine's ``fused_scope`` each one runs the fused sort + scan kernel on
the card.  A tick with commit effects makes these calls: the o_id rank
sort (B lanes), the compaction sort (B*R lanes, 8 columns), the s_quantity
chain sort and the three ring-append sorts (K lanes, or B*R on a
full-width tick).

Two parts of the JAX reference depend on device data:

- ``n_eff <= K`` picks the K-lane compacted body or the full-width body
  (the reference's ``lax.cond``).  Both give identical tables.  The eager
  tick reads the count on the host, once per tick, and a full-width tick
  skips the compaction sort, whose result the reference computes and
  does not use; ``Engine.run_compiled`` runs the full-width body on every
  tick and counts the reference's choice on the device
  (``WorkloadPlugin.effect_branch``, ``workloads/base.py``).
- The restock chain (the reference's ``while_loop`` over the committers
  of one STOCK row in cts order) has a closed form here instead of a
  loop.  The rule ``q - k if q - k > 10 else q - k + 91`` equals
  ``11 + (q - 11 - k) mod 91`` for every ``q`` in [10, 101] and ``k`` in
  [1, 16], and maps that range into [11, 101].  ``init_tables`` draws
  ``s_quantity`` from [10, 100], and an entry's quantity
  ``(earg & 15) + 1`` is in [1, 16], so the chain composes to
  ``11 + (q0 - 11 - sum of k) mod 91``: order-free, exact at any depth,
  with no host read and no bound on committing writers per row (under
  T/O several txns can commit to one STOCK row in a tick).

``TPCCWorkload.branch_ticks`` counts the bodies taken, on the device.

Scatters keep the port's discipline (the helpers of ``workloads/base.py``,
shared with PPS).  Additive effects are int32 ``index_add_``, exact in any
order; lanes without an effect add 0 at a row spread by lane (adding at
one shared row would serialize the atomics).  A store (the s_quantity
result, a ring row) is the same ``index_add_`` of ``new - old`` at its
distinct position, so it needs no scratch rows and no duplicate-index
store.  The rank unpermutes are ``index_copy_`` onto a
permutation, whose indices are distinct.  No element of a device tensor
is stored from the host (``x[-1] = True`` syncs the device).

Deliberate divergences of the JAX package from the reference (int32 whole
dollars, rbk without retry, OL_AMOUNT 0, the median-of-chain lastname
lookup, empty rings with D_NEXT_O_ID = 3001) carry over unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from deneva_tpu_torch.config import Config
from deneva_tpu_torch.ops import segment as seg
from deneva_tpu_torch.storage.catalog import Catalog
from deneva_tpu_torch.workloads import base
from deneva_tpu_torch.workloads.base import (
    QueryPool, WorkloadPlugin, add_rows, iota, store_rows, unpermute_rows,
)

I32 = torch.int32
I64 = torch.int64

# txn_type ids (reference TPCCTxnType, config.h:209-214)
TPCC_PAYMENT = 1
TPCC_NEW_ORDER = 2

# targs layout (per-txn scalar args, the TPCCQuery fields message.h ships)
TA_W, TA_D, TA_C, TA_CW, TA_CD, TA_AMT, TA_OLCNT, TA_RBK, TA_ALLLOC = range(9)
N_TARGS = 9

# per-access effect roles (low 3 bits of QueryPool.aux / shipped role field)
ROLE_NONE = 0    # plain read, no commit effect
ROLE_W_PAY = 1   # warehouse W_YTD += h_amount        (run_payment_1)
ROLE_D_PAY = 2   # district D_YTD += h_amount         (run_payment_3)
ROLE_C_PAY = 3   # customer balance/ytd/cnt + HISTORY (run_payment_5)
ROLE_D_NO = 4    # district D_NEXT_O_ID++ + ORDER/NEW-ORDER (new_order_5)
ROLE_S_NO = 5    # stock update + ORDER-LINE           (new_order_9)

#: sort sentinel of lanes without an effect (they sort last)
OOB = 2**31 - 1


def catalog(cfg: Config) -> Catalog:
    """CC-addressable row space, warehouse-striped over part_cnt shards."""
    P = cfg.part_cnt
    assert cfg.num_wh % P == 0, "num_wh must be a multiple of part_cnt"
    # effect-field packing bounds (commit_fields / apply_commit_entries)
    assert cfg.dist_per_wh <= 16 and cfg.cust_per_dist <= 1 << 14
    assert 5 <= cfg.max_items_per_txn <= 15
    wh_local = cfg.num_wh // P
    cat = Catalog(P)
    cat.add("WAREHOUSE", wh_local)
    cat.add("DISTRICT", wh_local * cfg.dist_per_wh)
    cat.add("CUSTOMER", wh_local * cfg.dist_per_wh * cfg.cust_per_dist)
    cat.add("ITEM", cfg.max_items)          # replicated per shard
    cat.add("STOCK", wh_local * cfg.max_items)
    assert cat.rows_global < 1 << 30, "catalog exceeds packed sort-key space"
    return cat


#: legacy column name -> (block key, column index) for the packed 2-D
#: blocks of init_tables
RING_COLS = {
    "c_balance": ("cust_block", 0), "c_ytd_payment": ("cust_block", 1),
    "c_payment_cnt": ("cust_block", 2),
    "s_ytd": ("stock_block", 0), "s_order_cnt": ("stock_block", 1),
    "s_remote_cnt": ("stock_block", 2),
    "h_c_id": ("hist_block", 0), "h_c_d_id": ("hist_block", 1),
    "h_c_w_id": ("hist_block", 2), "h_d_id": ("hist_block", 3),
    "h_w_id": ("hist_block", 4), "h_amount": ("hist_block", 5),
    "o_id": ("ord_block", 0), "o_c_id": ("ord_block", 1),
    "o_d_id": ("ord_block", 2), "o_w_id": ("ord_block", 3),
    "o_ol_cnt": ("ord_block", 4), "o_all_local": ("ord_block", 5),
    "no_o_id": ("ord_block", 6), "no_d_id": ("ord_block", 7),
    "no_w_id": ("ord_block", 8),
    "ol_o_id": ("ol_block", 0), "ol_d_id": ("ol_block", 1),
    "ol_w_id": ("ol_block", 2), "ol_number": ("ol_block", 3),
    "ol_i_id": ("ol_block", 4), "ol_supply_w_id": ("ol_block", 5),
    "ol_quantity": ("ol_block", 6), "ol_amount": ("ol_block", 7),
}


def ring_view(tables: dict, col: str):
    """Resolve a legacy single-column name against the packed block
    layout."""
    if col in RING_COLS:
        blk, j = RING_COLS[col]
        return tables[blk][..., j]
    return tables[col]


def effect_lanes(cfg: Config, n: int) -> int:
    """K, the lanes of the compacted effect body for n = B*R entries: a
    txn has at most max_items_per_txn + 2 effect roles."""
    return base.effect_lanes(cfg, n, cfg.max_items_per_txn + 2, 8192)


def checksums(tables: dict) -> dict:
    """int64 sum of every table and of every column of the packed blocks
    (under its legacy name): what ``conservation`` compares."""
    blocks = {blk for blk, _ in RING_COLS.values()}
    names = [k for k in tables if k not in blocks] + list(RING_COLS)
    return {k: int(ring_view(tables, k).to(I64).sum()) for k in names}


def conservation(cfg: Config, init: dict, fin: dict, summary: dict) -> dict:
    """TPC-C's money and order conservation between two ``checksums`` of
    one run whose insert rings started empty, law -> holds.  Every
    committed Payment moves h_amount through W_YTD, D_YTD, C_BALANCE,
    C_YTD_PAYMENT and HISTORY; every committed NewOrder advances
    D_NEXT_O_ID once and appends one ORDER row and its ORDER-LINE rows.  A
    law that sums a ring's contents is left out once that ring has
    wrapped (its cursor passed its capacity)."""
    d = {k: fin[k] - init[k] for k in init}
    payments, neworders = d["c_payment_cnt"], d["d_next_o_id"]
    laws = {
        "commits": payments + neworders == summary["txn_cnt"],
        "money": d["d_ytd"] == -d["c_balance"] == d["c_ytd_payment"]
        and d["w_ytd"] == (d["d_ytd"] if cfg.wh_update else 0),
        "history": d["hist_cursor"] == payments,
        "orders": d["order_cursor"] == neworders,
        "order lines": d["ol_cursor"] == d["s_order_cnt"],
    }
    if fin["hist_cursor"] <= cfg.tpcc_hist_cap:
        laws["history money"] = d["h_amount"] == d["d_ytd"]
    if fin["order_cursor"] <= cfg.tpcc_max_orders:
        laws["order line counts"] = d["o_ol_cnt"] == d["ol_cursor"]
    if fin["ol_cursor"] <= cfg.tpcc_ol_cap:
        laws["stock ytd"] = d["s_ytd"] == d["ol_quantity"]
    return laws


def _wh_local(w, P):
    """(w-1) // P: local warehouse index on shard wh_to_part(w)=(w-1)%P."""
    return (w - 1) // P


def _urand(rng, lo, hi, size=None):
    return rng.integers(lo, hi + 1, size=size).astype(np.int64)


class NURand:
    """TPC-C non-uniform random (tpcc_helper.cpp:101-134): per-run constant
    C drawn once per A, then ((URand(0,A) | URand(x,y)) + C) % (y-x+1) + x."""

    def __init__(self, rng):
        self.C = {a: int(_urand(rng, 0, a)) for a in (255, 1023, 8191)}

    def __call__(self, rng, A, x, y, size=None):
        u1 = _urand(rng, 0, A, size)
        u2 = _urand(rng, x, y, size)
        return ((u1 | u2) + self.C[A]) % (y - x + 1) + x


def _lastname_median_map(cfg: Config, rng, nurand: NURand) -> np.ndarray:
    """(num_wh, dist_per_wh, 1000) -> c_id resolving a by-last-name lookup.

    Mirrors the loader's lastname assignment (tpcc_wl.cpp:369-374:
    c_id<=1000 gets Lastname(c_id-1), the rest Lastname(NURand(255,0,999)))
    and run_payment_4's median-of-chain walk (tpcc_txn.cpp:617-626).
    """
    W, D, C = cfg.num_wh, cfg.dist_per_wh, cfg.cust_per_dist
    assert C >= 1000, "TPC-C requires cust_per_dist >= 1000 (tpcc_wl.cpp:360)"
    out = np.zeros((W, D, 1000), np.int64)
    for w in range(W):
        for d in range(D):
            nums = np.concatenate([
                np.arange(1000, dtype=np.int64),
                nurand(rng, 255, 0, 999, size=C - 1000),
            ])
            order = np.argsort(nums, kind="stable")  # ascending c_id in ties
            sorted_nums = nums[order]
            starts = np.searchsorted(sorted_nums, np.arange(1000))
            ends = np.searchsorted(sorted_nums, np.arange(1000), side="right")
            mid = starts + (ends - starts) // 2     # the cnt/2 chain walk
            out[w, d] = order[mid] + 1              # back to 1-based c_id
    return out


class TPCCWorkload(WorkloadPlugin):
    name = "TPCC"
    has_effects = True
    effect_fields = ("role", "earg", "earg2")
    #: the effect bodies taken
    counter_names = ("compact", "full")

    # ------------------------------------------------------------------
    # query generation (benchmarks/tpcc_query.cpp:149-263)
    # ------------------------------------------------------------------

    def gen_pool(self, cfg: Config, seed: int | None = None) -> QueryPool:
        rng = np.random.default_rng(cfg.seed if seed is None else seed)
        nurand = NURand(rng)
        lastname_map = _lastname_median_map(cfg, rng, nurand)
        cat = catalog(cfg)
        P = cfg.part_cnt
        Q = cfg.query_pool_size
        Rmax = 3 + 2 * cfg.max_items_per_txn
        wh_local = cfg.num_wh // P

        home_part = np.arange(Q, dtype=np.int64) % P
        is_payment = _urand(rng, 0, 99, Q) < int(cfg.perc_payment * 100)

        # home warehouse: FIRST_PART_LOCAL draws until wh_to_part(w)==home
        # (tpcc_query.cpp:155-159) == uniform over the home part's warehouses
        if cfg.first_part_local:
            w_id = home_part + 1 + P * _urand(rng, 0, wh_local - 1, Q)
        else:
            w_id = _urand(rng, 1, cfg.num_wh, Q)
            home_part = (w_id - 1) % P
        d_id = _urand(rng, 1, cfg.dist_per_wh, Q)
        h_amount = _urand(rng, 1, 5000, Q)

        # --- Payment customer choice (tpcc_query.cpp:168-195) ---
        # remote customer warehouse with fixed prob 0.15 (x > 0.15 -> home;
        # the reference hardcodes 0.15, tpcc_query.cpp:172)
        x = rng.integers(0, 10_000, Q) / 10_000.0
        remote_cust = (x <= 0.15) & (cfg.num_wh > 1)
        c_w_id = np.where(remote_cust, 0, w_id)
        c_d_id = np.where(remote_cust, _urand(rng, 1, cfg.dist_per_wh, Q), d_id)
        need = remote_cust.copy()
        while need.any():  # resample c_w_id != w_id
            draw = _urand(rng, 1, cfg.num_wh, int(need.sum()))
            c_w_id[need] = draw
            need = remote_cust & (c_w_id == w_id)
        y = _urand(rng, 1, 100, Q)
        by_last = y <= int(cfg.tpcc_by_last_name_perc * 100)
        c_id_direct = nurand(rng, 1023, 1, cfg.cust_per_dist, Q)
        ln_num = nurand(rng, 255, 0, 999, Q)
        c_id_ln = lastname_map[np.where(remote_cust, c_w_id, w_id) - 1,
                               c_d_id - 1, ln_num]
        pay_c_id = np.where(by_last, c_id_ln, c_id_direct)
        pay_c_w = np.where(is_payment, c_w_id, w_id)
        pay_c_d = np.where(is_payment, c_d_id, d_id)

        # --- NewOrder lines (tpcc_query.cpp:204-262) ---
        no_c_id = nurand(rng, 1023, 1, cfg.cust_per_dist, Q)
        ol_cnt = _urand(rng, 5, cfg.max_items_per_txn, Q)
        rbk = rng.integers(0, 10_000, Q) / 10_000.0 < cfg.tpcc_rbk_perc
        L = cfg.max_items_per_txn
        # distinct item ids per txn: NURand(8191) resampled on duplicates
        i_ids = nurand(rng, 8191, 1, cfg.max_items, (Q, L))
        for _ in range(1000):
            dup = np.zeros((Q, L), bool)
            for j in range(1, L):
                dup[:, j] = (i_ids[:, j:j + 1] == i_ids[:, :j]).any(axis=1)
            if not dup.any():
                break
            i_ids[dup] = nurand(rng, 8191, 1, cfg.max_items, int(dup.sum()))
        else:  # pragma: no cover
            raise RuntimeError("could not de-duplicate ol_i_ids")
        ol_qty = _urand(rng, 1, 10, (Q, L))
        # remote supply warehouse: 1% per line, gated by MPR part budget
        # (tpcc_query.cpp:226-252); remote lines pick a uniform warehouse,
        # capped at part_per_txn distinct partitions per txn
        r_mpr = rng.integers(0, 10_000, Q) / 10_000.0
        part_limit = np.where(r_mpr < cfg.mpr, cfg.part_per_txn, 1)
        r_rem = rng.integers(0, 100_000, (Q, L)) / 100_000.0
        live_ln = np.arange(L)[None, :] < ol_cnt[:, None]
        want_remote = (r_rem <= 0.01) & (r_mpr < cfg.mpr)[:, None] \
            & (cfg.num_wh > 1) & live_ln
        supply_w = np.broadcast_to(w_id[:, None], (Q, L)).copy()
        # sequential per-line partition budget (set logic, vector over Q)
        used = np.zeros((Q, P), bool)
        used[np.arange(Q), (w_id - 1) % P] = True
        for j in range(L):
            draw = _urand(rng, 1, cfg.num_wh, Q)
            dpart = (draw - 1) % P
            n_used = used.sum(axis=1)
            in_used = used[np.arange(Q), dpart]
            ok = want_remote[:, j] & (in_used | (n_used < part_limit))
            supply_w[:, j] = np.where(ok, draw, supply_w[:, j])
            used[np.arange(Q)[ok], dpart[ok]] = True
        all_local = ((supply_w == w_id[:, None]) | ~live_ln).all(axis=1)

        # --- assemble access lists ---
        keys = np.full((Q, Rmax), np.int32(2**31 - 1), np.int64)
        is_write = np.zeros((Q, Rmax), bool)
        aux = np.zeros((Q, Rmax), np.int64)
        n_req = np.where(is_payment, 3, 3 + 2 * ol_cnt)

        def k_wh(w):
            return cat.key("WAREHOUSE", _wh_local(w, P), (w - 1) % P)

        def k_dist(d, w):
            return cat.key("DISTRICT",
                           _wh_local(w, P) * cfg.dist_per_wh + d - 1,
                           (w - 1) % P)

        def k_cust(c, d, w):
            off = (_wh_local(w, P) * cfg.dist_per_wh + d - 1) \
                * cfg.cust_per_dist + c - 1
            return cat.key("CUSTOMER", off, (w - 1) % P)

        def k_item(i, accessor_w):
            return cat.key("ITEM", i - 1, (accessor_w - 1) % P)

        def k_stock(i, w):
            return cat.key("STOCK", _wh_local(w, P) * cfg.max_items + i - 1,
                           (w - 1) % P)

        # Payment: WH, DIST, CUST  (PAYMENT0/2/4 get_row order);
        # NewOrder also reads WH first (NEWORDER0)
        keys[:, 0] = k_wh(w_id)
        keys[:, 1] = k_dist(d_id, w_id)
        pc = k_cust(pay_c_id, pay_c_d, np.where(is_payment, pay_c_w, w_id))
        nc = k_cust(no_c_id, d_id, w_id)
        keys[:, 2] = np.where(is_payment, pc, nc)
        is_write[:, 0] = np.where(is_payment, cfg.wh_update, False)
        is_write[:, 1] = is_payment          # payment: D WR; neworder below
        is_write[:, 2] = is_payment          # payment: C WR; neworder: C RD
        aux[:, 0] = np.where(is_payment & cfg.wh_update, ROLE_W_PAY, ROLE_NONE)
        aux[:, 1] = np.where(is_payment, ROLE_D_PAY, ROLE_NONE)
        aux[:, 2] = np.where(is_payment, ROLE_C_PAY, ROLE_NONE)

        # NewOrder: WH RD, CUST RD, DIST WR, then (ITEM RD, STOCK WR)*
        # (NEWORDER0/2/4 then 6/8 per line); slot 1<->2 swap vs Payment is
        # the reference's own access order
        no_mask = ~is_payment
        keys[no_mask, 1] = nc[no_mask]
        keys[no_mask, 2] = k_dist(d_id, w_id)[no_mask]
        is_write[no_mask, 2] = True
        aux[no_mask, 1] = ROLE_NONE
        aux[no_mask, 2] = ROLE_D_NO
        line = np.arange(L)[None, :]
        live_line = no_mask[:, None] & (line < ol_cnt[:, None])
        ki = k_item(i_ids, w_id[:, None])
        ks = k_stock(i_ids, supply_w)
        for j in range(L):
            m = live_line[:, j]
            keys[m, 3 + 2 * j] = ki[m, j]
            keys[m, 4 + 2 * j] = ks[m, j]
            is_write[m, 4 + 2 * j] = True
            aux[m, 3 + 2 * j] = ROLE_NONE
            aux[m, 4 + 2 * j] = ROLE_S_NO | (
                (ol_qty[m, j] - 1)
                | ((supply_w[m, j] != w_id[m]).astype(np.int64) << 4)
                | (j << 5)) << 3

        targs = np.zeros((Q, N_TARGS), np.int64)
        targs[:, TA_W] = w_id
        targs[:, TA_D] = d_id
        targs[:, TA_C] = np.where(is_payment, pay_c_id, no_c_id)
        targs[:, TA_CW] = pay_c_w
        targs[:, TA_CD] = pay_c_d
        targs[:, TA_AMT] = h_amount
        targs[:, TA_OLCNT] = np.where(is_payment, 0, ol_cnt)
        targs[:, TA_RBK] = np.where(is_payment, False, rbk)
        targs[:, TA_ALLLOC] = all_local

        return QueryPool(
            keys=keys.astype(np.int32),
            is_write=is_write,
            n_req=n_req.astype(np.int32),
            home_part=home_part.astype(np.int32),
            txn_type=np.where(is_payment, TPCC_PAYMENT,
                              TPCC_NEW_ORDER).astype(np.int32),
            args=targs.astype(np.int32),
            aux=aux.astype(np.int32),
        )

    def cc_rows(self, cfg: Config) -> int:
        return catalog(cfg).rows_global

    # ------------------------------------------------------------------
    # storage (loader values tpcc_wl.cpp:243-430)
    # ------------------------------------------------------------------

    def init_tables(self, cfg: Config, part: int = 0, device="cpu") -> dict:
        """Shard ``part``'s tables on ``device``: row state and insert rings
        packed into 2-D blocks, one row per record, as in the JAX package
        (legacy column names resolve through ``ring_view``)."""
        P = cfg.part_cnt
        wh_local = cfg.num_wh // P
        n_dist = wh_local * cfg.dist_per_wh
        n_cust = n_dist * cfg.cust_per_dist
        n_stock = wh_local * cfg.max_items
        rng = np.random.default_rng([cfg.seed, 0x7C, part])
        full = lambda shape, v: torch.full(shape, v, dtype=I32, device=device)
        oc, olc, hc = cfg.tpcc_max_orders, cfg.tpcc_ol_cap, cfg.tpcc_hist_cap
        return {
            "w_ytd": full((wh_local,), 300000),
            "d_ytd": full((n_dist,), 30000),
            "d_next_o_id": full((n_dist,), 3001),
            # [c_balance, c_ytd_payment, c_payment_cnt]
            "cust_block": torch.tensor([-10, 10, 1], dtype=I32, device=device)
            .repeat(n_cust, 1),
            "s_quantity": torch.from_numpy(
                rng.integers(10, 101, n_stock).astype(np.int32)).to(device),
            # [s_ytd, s_order_cnt, s_remote_cnt]
            "stock_block": full((n_stock, 3), 0),
            # insert rings (preallocated; append at cursor, wrap at cap)
            "hist_cursor": full((), 0),
            # [h_c_id, h_c_d_id, h_c_w_id, h_d_id, h_w_id, h_amount]
            "hist_block": full((hc, 6), 0),
            "order_cursor": full((), 0),
            # [o_id, o_c_id, o_d_id, o_w_id, o_ol_cnt, o_all_local,
            #  no_o_id, no_d_id, no_w_id]
            "ord_block": full((oc, 9), 0),
            "ol_cursor": full((), 0),
            # [ol_o_id, ol_d_id, ol_w_id, ol_number, ol_i_id,
            #  ol_supply_w_id, ol_quantity, ol_amount]
            "ol_block": full((olc, 8), 0),
        }

    # ------------------------------------------------------------------
    # commit effects
    # ------------------------------------------------------------------

    def commit_fields(self, cfg: Config, tables: dict, txn, commit) -> dict:
        """role/earg/earg2 per access entry of committing txns, (B, R).

        o_id assignment (new_order_5, tpcc_txn.cpp:774-812): each committing
        NewOrder takes D_NEXT_O_ID of its district plus its rank among
        same-tick committers on that district (by slot).  The rank is the
        position in the district's segment of the (district, slot) sort,
        ``iota - start_index``, carried back to slot order by the inverse
        permutation.
        """
        cat = catalog(cfg)
        B = txn.keys.shape[0]
        dev = txn.keys.device
        role_low = txn.aux & 7
        dw = (txn.targs[:, TA_D] - 1) | ((txn.targs[:, TA_W] - 1) << 4)
        role = torch.where(commit[:, None], role_low | (dw[:, None] << 3), 0)

        # per-txn o_id for committing NewOrders
        is_no = commit & (txn.txn_type == TPCC_NEW_ORDER)
        dloc = cat.local("DISTRICT", txn.keys[:, 2])  # slot 2 = district
        dkey = torch.where(is_no, dloc, OOB)
        slot = iota(B, dev)
        # the sort is stable: same-district slots keep their order
        (_, sslot), _, sidx = seg.sort_pack_scan((dkey, slot), num_keys=1)
        rank = unpermute_rows(sslot, slot - sidx)
        d_next = tables["d_next_o_id"][torch.where(is_no, dloc, 0).to(I64)]
        o_id = torch.where(is_no, d_next + rank, 0)

        amt = txn.targs[:, TA_AMT]
        pay_roles = (role_low == ROLE_W_PAY) | (role_low == ROLE_D_PAY) \
            | (role_low == ROLE_C_PAY)
        earg = torch.where(pay_roles, amt[:, None], txn.aux >> 3)
        d_no_pack = (txn.targs[:, TA_C] - 1) \
            | (txn.targs[:, TA_OLCNT] << 14) \
            | (txn.targs[:, TA_ALLLOC] << 19)
        earg = torch.where(role_low == ROLE_D_NO, d_no_pack[:, None], earg)
        earg2 = torch.where((role_low == ROLE_D_NO) | (role_low == ROLE_S_NO),
                            o_id[:, None], 0)
        # Payment's HISTORY insert needs the *paying* (w,d): shipped in the
        # role bits
        return {"role": role, "earg": earg, "earg2": earg2}

    def apply_commit_entries(self, cfg: Config, tables: dict, key_local,
                             part, fields: dict, cts, live,
                             on_device: bool = False) -> dict:
        """Apply commit effects (run_*_1/3/5/9 + insert_row analogs) to
        ``tables`` in place and return it.

        When B*R > K, the effect entries are first compacted: one
        (cts, idx) sort puts them in a K-lane prefix, and the body runs on
        it.  A tick with more than K effect entries runs the body at full
        width (``effect_branch`` decides, see the module docstring); both
        bodies rank ring appends by (cts, original idx), so they give
        identical tables.  ``on_device`` runs the full-width body on every
        tick and reads nothing on the host.
        """
        n = key_local.shape[0]
        role_f, earg, earg2 = fields["role"], fields["earg"], fields["earg2"]
        eff = live & ((role_f & 7) != ROLE_NONE)
        K = effect_lanes(cfg, n)

        def full(m):
            self._apply_entries_body(cfg, tables, key_local, part, role_f,
                                     earg, earg2, cts, m)

        def compact(m):
            out = seg.sort_pack(
                (torch.where(m, cts, OOB), iota(n, key_local.device),
                 key_local, role_f, earg, earg2, cts, m.to(I32)),
                num_keys=2)
            c_key, c_rolef, c_earg, c_earg2, c_cts = (a[:K]
                                                      for a in out[2:7])
            self._apply_entries_body(cfg, tables, c_key, part, c_rolef,
                                     c_earg, c_earg2, c_cts,
                                     out[7][:K] == 1)

        if K < n:
            self.effect_branch(eff.sum(dtype=I32) <= K, eff, compact, full,
                               on_device)
        else:
            self.count("full", 1)
            full(eff)
        return tables

    def _apply_entries_body(self, cfg: Config, t: dict, key_local, part,
                            role_f, earg, earg2, cts, eff) -> dict:
        cat = catalog(cfg)
        P = cfg.part_cnt
        n = key_local.shape[0]
        lanes = iota(n, key_local.device)
        role = torch.where(eff, role_f & 7, ROLE_NONE)
        dw = role_f >> 3
        pay_d = (dw & 15) + 1
        pay_w = (dw >> 4) + 1

        def off(table, mask):
            return torch.where(mask, key_local - cat.tables[table].base, OOB)

        # -- Payment: YTD / balance effects (additive, order-free) --
        m = role == ROLE_W_PAY
        add_rows(t["w_ytd"], off("WAREHOUSE", m), m, earg)
        m = role == ROLE_D_PAY
        add_rows(t["d_ytd"], off("DISTRICT", m), m, earg)
        mc = role == ROLE_C_PAY
        co = off("CUSTOMER", mc)
        add_rows(t["cust_block"], co, mc,
                 torch.stack([-earg, earg, torch.ones_like(earg)], dim=1))

        # -- NewOrder: district next_o_id advance (additive) --
        md = role == ROLE_D_NO
        add_rows(t["d_next_o_id"], off("DISTRICT", md), md,
                 torch.ones_like(earg))

        # -- Stock: additive counters + sequential s_quantity rule --
        ms = role == ROLE_S_NO
        so = off("STOCK", ms)
        qty = (earg & 15) + 1
        remote = (earg >> 4) & 1
        add_rows(t["stock_block"], so, ms,
                 torch.stack([qty, torch.ones_like(qty), remote], dim=1))
        # s_quantity (new_order_9, tpcc_txn.cpp:900-906): the restock chain
        # of each row in its closed form (module docstring), on the
        # quantity summed over the row's segment so far.  Sorted by (stock
        # row, cts), as the reference sorts, a row's entries are adjacent.
        skey = torch.where(ms, key_local, OOB)
        (sk, _, sqty), sstarts, ssidx = seg.sort_pack_scan((skey, cts, qty),
                                                           num_keys=2)
        slive = sk != OOB
        csum = torch.cumsum(torch.where(slive, sqty, 0), 0, dtype=I32)
        ssi = ssidx.to(I64)
        ksum = csum - csum[ssi] + sqty[ssi]
        soff = torch.where(slive, sk - cat.tables["STOCK"].base, 0)
        sq0 = t["s_quantity"][soff.to(I64)]
        qa = 11 + torch.remainder(sq0 - 11 - ksum, 91)
        # the last entry of each stock row holds its result (an element
        # store from the host, ends[-1] = True, would sync the device)
        ends = torch.roll(sstarts, -1) | (lanes == n - 1)
        store_rows(t["s_quantity"], soff, slive & ends, qa)

        # -- ring appends, ordered by (cts, entry index); one (n, C) row
        # store per ring block --
        def ring_append(mask, cursor_key, cap, block_key, cols: list):
            cnt = mask.sum(dtype=I32)
            pri = torch.where(mask, cts, OOB)
            _, pidx = seg.sort_pack((pri, lanes), num_keys=1)   # stable
            r = unpermute_rows(pidx, lanes)
            # masked lanes sort first, so their ranks are 0..cnt-1; under
            # wrap the ring keeps the LAST cap records
            keep = mask & (r >= cnt - cap)
            pos = (t[cursor_key] + r) % cap
            payload = torch.stack([torch.where(mask, v, 0) for v in cols],
                                  dim=1)
            store_rows(t[block_key], pos, keep, payload)
            t[cursor_key].add_(cnt)

        # HISTORY at the customer's shard (run_payment_5: insert at
        # wh_to_part(c_w_id), tpcc_txn.cpp:688-700)
        cwl = co // (cfg.dist_per_wh * cfg.cust_per_dist)
        crem = co % (cfg.dist_per_wh * cfg.cust_per_dist)
        ring_append(mc, "hist_cursor", cfg.tpcc_hist_cap, "hist_block", [
            crem % cfg.cust_per_dist + 1,
            crem // cfg.cust_per_dist + 1,
            cwl * P + part + 1,
            pay_d, pay_w, earg,
        ])
        # ORDER + NEW-ORDER at the home warehouse's shard (new_order_5)
        ring_append(md, "order_cursor", cfg.tpcc_max_orders, "ord_block", [
            earg2, (earg & 0x3FFF) + 1, pay_d, pay_w,
            (earg >> 14) & 31, (earg >> 19) & 1,
            earg2, pay_d, pay_w,
        ])
        # ORDER-LINE at the supply warehouse's shard (new_order_9)
        swl = so // cfg.max_items
        ring_append(ms, "ol_cursor", cfg.tpcc_ol_cap, "ol_block", [
            earg2, pay_d, pay_w,
            (earg >> 5) & 15,
            so % cfg.max_items + 1,
            swl * P + part + 1,
            qty, torch.zeros_like(earg),
        ])
        return t

    def user_abort(self, cfg: Config, txn, finishing):
        return finishing & (txn.targs[:, TA_RBK] == 1)

    def pool_user_abort(self, cfg: Config, pool: QueryPool) -> np.ndarray:
        return np.asarray(pool.args[:, TA_RBK] == 1)
