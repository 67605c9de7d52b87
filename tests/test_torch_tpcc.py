"""The port's TPC-C (deneva_tpu_torch.workloads.tpcc, device="cpu")
against the JAX package's: the query pool byte for byte, the initial
tables, commit_fields and apply_commit_entries on random commits (the
K-lane compacted body and the full-width body), and the whole engine
under NO_WAIT on one shared pool.  Then the TPC-C conservation laws of
tests/test_tpcc.py on the port's engine.  Every comparison is exact
(integers)."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine import state as jstate  # noqa: E402
from deneva_tpu.engine.scheduler import Engine as JEngine  # noqa: E402
from deneva_tpu.workloads import tpcc as jtpcc  # noqa: E402
from deneva_tpu.workloads.base import QueryPool as JPool  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine import state as tstate  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.workloads import tpcc  # noqa: E402

POOL_FIELDS = ("keys", "is_write", "n_req", "home_part", "txn_type", "args",
               "aux")
TXN_FIELDS = ("status", "cursor", "ts", "pool_idx", "restarts",
              "backoff_until", "start_tick", "first_start_tick", "keys",
              "is_write", "n_req", "txn_type", "targs", "aux")


def tpcc_kw(**kw):
    """tests/test_tpcc.py:tpcc_cfg as Config kwargs."""
    base = dict(workload="TPCC", cc_alg="NO_WAIT", batch_size=64, num_wh=4,
                part_cnt=1, node_cnt=1, query_pool_size=1024,
                cust_per_dist=1000, max_items=128, perc_payment=0.5)
    base.update(kw)
    return base


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tables_equal(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        w, g = np.asarray(want[k]), _np(got[k])
        assert w.dtype == g.dtype and w.shape == g.shape, k
        np.testing.assert_array_equal(w, g, err_msg=k)


def _clone(tables: dict) -> dict:
    return {k: v.clone() for k, v in tables.items()}


# ---------------------------------------------------------------------------
# host half: the pool and the initial tables
# ---------------------------------------------------------------------------

POOL_CASES = {
    "test_tpcc_cfg": {},
    "num_wh8": dict(num_wh=8),
    "all_neworder": dict(perc_payment=0.0),
    "all_payment": dict(perc_payment=1.0),
    "rbk": dict(tpcc_rbk_perc=1.0),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_is_byte_equal(case):
    kw = tpcc_kw(**POOL_CASES[case])
    want = jtpcc.TPCCWorkload().gen_pool(JConfig(**kw))
    got = tpcc.TPCCWorkload().gen_pool(TConfig(**kw))
    for f in POOL_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype and w.shape == g.shape, f
        assert w.tobytes() == g.tobytes(), f
    np.testing.assert_array_equal(
        jtpcc.TPCCWorkload().pool_user_abort(JConfig(**kw), want),
        tpcc.TPCCWorkload().pool_user_abort(TConfig(**kw), got))


def test_catalog_matches_reference():
    for kw in (tpcc_kw(), tpcc_kw(num_wh=8, part_cnt=2, node_cnt=2)):
        a, b = jtpcc.catalog(JConfig(**kw)), tpcc.catalog(TConfig(**kw))
        assert a.rows_global == b.rows_global
        assert {n: (t.n_local, t.base) for n, t in a.tables.items()} == \
            {n: (t.n_local, t.base) for n, t in b.tables.items()}
    assert tpcc.RING_COLS == jtpcc.RING_COLS


@pytest.mark.parametrize("kw", [tpcc_kw(), tpcc_kw(num_wh=8, seed=5)],
                         ids=["test_tpcc_cfg", "num_wh8_seed5"])
def test_init_tables_match_reference(kw):
    want = jtpcc.TPCCWorkload().init_tables(JConfig(**kw), 0)
    got = tpcc.TPCCWorkload().init_tables(TConfig(**kw), 0)
    _assert_tables_equal(want, got)
    for col in tpcc.RING_COLS:
        np.testing.assert_array_equal(np.asarray(jtpcc.ring_view(want, col)),
                                      tpcc.ring_view(got, col).numpy())


# ---------------------------------------------------------------------------
# device half: commit_fields and apply_commit_entries on random commits
# ---------------------------------------------------------------------------


def _txn_from_pool(mod, arr, pool, rows):
    B = rows.shape[0]
    z = arr(np.zeros(B, np.int32))
    return mod.TxnState(
        status=z, cursor=z, ts=arr(np.arange(B, dtype=np.int32) + 1),
        pool_idx=z, restarts=z, backoff_until=z, start_tick=z,
        first_start_tick=z, keys=arr(pool.keys[rows]),
        is_write=arr(pool.is_write[rows]), n_req=arr(pool.n_req[rows]),
        txn_type=arr(pool.txn_type[rows]), targs=arr(pool.args[rows]),
        aux=arr(pool.aux[rows]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commit_fields_match_reference(seed):
    kw = tpcc_kw(num_wh=2, perc_payment=0.3)
    pool = tpcc.TPCCWorkload().gen_pool(TConfig(**kw))
    rng = np.random.default_rng(seed)
    B = 256
    rows = rng.choice(pool.size, B, replace=False)
    commit = rng.random(B) < 0.6
    tables = tpcc.TPCCWorkload().init_tables(TConfig(**kw), 0)
    tables["d_next_o_id"] += torch.from_numpy(
        rng.integers(0, 50, tables["d_next_o_id"].shape[0]).astype(np.int32))
    jtables = {k: jnp.asarray(v.numpy()) for k, v in tables.items()}
    want = jtpcc.TPCCWorkload().commit_fields(
        JConfig(**kw), jtables,
        _txn_from_pool(jstate, jnp.asarray, pool, rows), jnp.asarray(commit))
    got = tpcc.TPCCWorkload().commit_fields(
        TConfig(**kw), tables,
        _txn_from_pool(tstate, torch.from_numpy, pool, rows),
        torch.from_numpy(commit))
    assert sorted(want) == sorted(got) == sorted(tpcc.TPCCWorkload
                                                 .effect_fields)
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                      err_msg=k)
    # several same-district NewOrders commit together: ranks above 0
    is_no = commit & (pool.txn_type[rows] == tpcc.TPCC_NEW_ORDER)
    assert np.bincount(pool.keys[rows][is_no, 2]).max() > 1


def _random_entries(cfg, n, live_frac, seed):
    """Synthetic effect entries spanning every role, with duplicate stock
    and district rows (tests/test_tpcc.py:287)."""
    rng = np.random.default_rng(seed)
    cat = tpcc.catalog(cfg)
    roles = rng.choice([tpcc.ROLE_NONE, tpcc.ROLE_W_PAY, tpcc.ROLE_D_PAY,
                        tpcc.ROLE_C_PAY, tpcc.ROLE_D_NO, tpcc.ROLE_S_NO],
                       size=n).astype(np.int32)
    key = np.zeros(n, np.int32)
    for role, tab in ((tpcc.ROLE_W_PAY, "WAREHOUSE"),
                      (tpcc.ROLE_D_PAY, "DISTRICT"),
                      (tpcc.ROLE_C_PAY, "CUSTOMER"),
                      (tpcc.ROLE_D_NO, "DISTRICT"),
                      (tpcc.ROLE_S_NO, "STOCK")):
        m = roles == role
        ti = cat.tables[tab]
        key[m] = ti.base + rng.integers(0, ti.n_local, int(m.sum()))
    dw = rng.integers(0, 10, n).astype(np.int32) \
        | (rng.integers(0, 8, n).astype(np.int32) << 4)
    role_f = np.where(roles != tpcc.ROLE_NONE, roles | (dw << 3), 0)
    return dict(
        key=key, role=role_f.astype(np.int32),
        earg=rng.integers(0, 1 << 10, n).astype(np.int32),
        earg2=rng.integers(0, 1 << 10, n).astype(np.int32),
        cts=(rng.permutation(n) + 1).astype(np.int32),
        live=(roles != tpcc.ROLE_NONE) & (rng.random(n) < live_frac))


# K = max(8192, admit_cap * 17) = 8192 lanes of n = 17,000: a live
# fraction of 0.3 fits K (compacted body), 0.9 does not (full body); at
# n = 4000 <= K the body runs directly
APPLY_CASES = {"compact": (17000, 0.3), "full": (17000, 0.9),
               "narrow": (4000, 0.9)}


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_commit_entries_matches_reference(case):
    n, live_frac = APPLY_CASES[case]
    kw = tpcc_kw(batch_size=512, admit_cap=16, num_wh=8)
    cfg = TConfig(**kw)
    e = _random_entries(cfg, n, live_frac, seed=7)
    jwl = jtpcc.TPCCWorkload()
    jtables = jwl.init_tables(JConfig(**kw), 0)
    want = jwl.apply_commit_entries(
        JConfig(**kw), jtables, jnp.asarray(e["key"]), 0,
        {f: jnp.asarray(e[f]) for f in ("role", "earg", "earg2")},
        jnp.asarray(e["cts"]), jnp.asarray(e["live"]))

    wl = tpcc.TPCCWorkload()
    tables = wl.init_tables(cfg, 0)
    fields = {f: torch.from_numpy(e[f]) for f in ("role", "earg", "earg2")}
    args = (torch.from_numpy(e["key"]), 0, fields,
            torch.from_numpy(e["cts"]), torch.from_numpy(e["live"]))
    got = wl.apply_commit_entries(cfg, _clone(tables), *args)
    _assert_tables_equal(want, got)
    branch = "full" if case == "narrow" else case
    assert wl.branch_ticks == {"compact": 0, "full": 0, branch: 1}
    # the restock chain ran past rank 0: live stock rows repeat
    s_no = e["live"] & ((e["role"] & 7) == tpcc.ROLE_S_NO)
    assert np.bincount(e["key"][s_no]).max() > 1

    # the port's full-width body gives the same tables as its dispatch
    live = torch.from_numpy(e["live"])
    eff = live & ((fields["role"] & 7) != tpcc.ROLE_NONE)
    full = wl._apply_entries_body(cfg, _clone(tables), args[0], 0,
                                  fields["role"], fields["earg"],
                                  fields["earg2"], args[3], eff)
    _assert_tables_equal(got, full)


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_commit_entries_on_device_branches(case):
    # as run_compiled applies them: the full-width body on every tick, the
    # reference's choice counted on the device (workloads/base.py
    # effect_branch); the reference's tables
    n, live_frac = APPLY_CASES[case]
    kw = tpcc_kw(batch_size=512, admit_cap=16, num_wh=8)
    cfg = TConfig(**kw)
    e = _random_entries(cfg, n, live_frac, seed=7)
    jwl = jtpcc.TPCCWorkload()
    want = jwl.apply_commit_entries(
        JConfig(**kw), jwl.init_tables(JConfig(**kw), 0),
        jnp.asarray(e["key"]), 0,
        {f: jnp.asarray(e[f]) for f in ("role", "earg", "earg2")},
        jnp.asarray(e["cts"]), jnp.asarray(e["live"]))
    wl = tpcc.TPCCWorkload()
    got = wl.apply_commit_entries(
        cfg, wl.init_tables(cfg, 0), torch.from_numpy(e["key"]), 0,
        {f: torch.from_numpy(e[f]) for f in ("role", "earg", "earg2")},
        torch.from_numpy(e["cts"]), torch.from_numpy(e["live"]),
        on_device=True)
    _assert_tables_equal(want, got)
    branch = "full" if case == "narrow" else case
    assert wl.branch_ticks == {"compact": 0, "full": 0, branch: 1}


def test_restock_chain_with_repeated_rows():
    # one stock row written by several entries in one tick: the
    # conditional restock applies them in cts order (rank 0, 1, 2, ...)
    kw = tpcc_kw()
    cfg = TConfig(**kw)
    cat = tpcc.catalog(cfg)
    base = cat.tables["STOCK"].base
    key = np.array([base + 3] * 5 + [base + 9] * 2, np.int32)
    n = key.shape[0]
    qty = np.array([9, 9, 9, 9, 9, 1, 2], np.int32)
    role = np.full(n, tpcc.ROLE_S_NO, np.int32)
    earg = (qty - 1).astype(np.int32)
    cts = np.array([50, 10, 40, 20, 30, 2, 1], np.int32)
    e = dict(role=role, earg=earg, earg2=np.zeros(n, np.int32))
    jt = jtpcc.TPCCWorkload().init_tables(JConfig(**kw), 0)
    want = jtpcc.TPCCWorkload().apply_commit_entries(
        JConfig(**kw), jt, jnp.asarray(key), 0,
        {k: jnp.asarray(v) for k, v in e.items()}, jnp.asarray(cts),
        jnp.ones(n, bool))
    wl = tpcc.TPCCWorkload()
    got = wl.apply_commit_entries(
        cfg, wl.init_tables(cfg, 0), torch.from_numpy(key), 0,
        {k: torch.from_numpy(v) for k, v in e.items()},
        torch.from_numpy(cts), torch.ones(n, dtype=torch.bool))
    _assert_tables_equal(want, got)
    q0 = int(np.asarray(jt["s_quantity"])[3])
    q = q0
    for _ in range(5):
        q = q - 9 if q > 19 else q - 9 + 91
    assert int(got["s_quantity"][3]) == q


# ---------------------------------------------------------------------------
# the engine against the JAX engine on one shared pool
# ---------------------------------------------------------------------------


def _line_without_host_keys(line):
    return [kv for kv in line.split(",")
            if not kv.startswith(("mem_util=", "cpu_util="))]


def _run_both(kw, n_ticks, chunks=None):
    pool = tpcc.TPCCWorkload().gen_pool(TConfig(**kw))
    jpool = JPool(**{f: getattr(pool, f) for f in POOL_FIELDS})
    je = JEngine(JConfig(**kw), pool=jpool)
    te = TEngine(TConfig(**kw), pool=pool, device="cpu")
    js, ts = None, None
    for n in (chunks or [n_ticks]):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the JAX gate's width fallback
            js = je.run(n, js)
        ts = te.run(n, ts)
    return je, js, te, ts


def _assert_engine_parity(je, js, te, ts):
    a, b = je.summary(js), te.summary(ts)
    assert a == b, {k: (a[k], b.get(k)) for k in a if a[k] != b.get(k)}
    assert _line_without_host_keys(je.summary_line(js)) == \
        _line_without_host_keys(te.summary_line(ts))
    np.testing.assert_array_equal(np.asarray(js.data), ts.data.numpy())
    _assert_tables_equal(js.tables, ts.tables)
    for f in TXN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js.txn, f)),
                                      getattr(ts.txn, f).numpy(), err_msg=f)
    assert int(js.pool_cursor) == int(ts.pool_cursor)
    assert int(js.ts_counter) == int(ts.ts_counter)
    # the increment oracle: every committed write applied exactly once
    assert int(ts.data.sum()) == b["write_cnt"]
    return b


ENGINE_CELLS = {
    # tests/test_tpcc.py:tpcc_cfg, 60 ticks; with fused_arbitrate the JAX
    # side runs its Pallas kernel (interpret mode) on every pack
    "small": (tpcc_kw(), 60),
    # NewOrder rollbacks (user aborts) next to commits
    "rbk": (tpcc_kw(num_wh=16, perc_payment=0.3, tpcc_rbk_perc=0.3), 60),
    # 16 warehouses, no warehouse writes: more commits per tick
    "wide": (tpcc_kw(num_wh=16, wh_update=False), 60),
    # B*R = 16,896 > K = 8192: every tick takes the compacted body
    "compact": (tpcc_kw(batch_size=512, admit_cap=64, num_wh=32,
                        query_pool_size=4096), 40),
}


@pytest.mark.parametrize("cell,fused", [
    ("small", False), ("small", True), ("rbk", False), ("rbk", True),
    ("wide", False), ("compact", False)])
def test_engine_matches_reference(cell, fused):
    kw, n_ticks = ENGINE_CELLS[cell]
    je, js, te, ts = _run_both(dict(kw, fused_arbitrate=fused), n_ticks)
    s = _assert_engine_parity(je, js, te, ts)
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    if cell == "rbk":
        assert s["user_abort_cnt"] > 0
    want_branch = "compact" if cell == "compact" else "full"
    assert te.workload.branch_ticks[want_branch] == n_ticks


def test_engine_matches_reference_across_run_calls():
    # the carried tables and rings across run() boundaries: 7 + 11 + 5
    kw, _ = ENGINE_CELLS["wide"]
    _assert_engine_parity(*_run_both(kw, None, chunks=[7, 11, 5]))


# ---------------------------------------------------------------------------
# TPC-C conservation laws on the port's engine (tests/test_tpcc.py)
# ---------------------------------------------------------------------------


def run_and_check(kw, n_ticks=60):
    eng = TEngine(TConfig(**kw), device="cpu")
    st0 = eng.init_state()
    init = tpcc.checksums(st0.tables)
    st = eng.run(n_ticks, st0)
    s = eng.summary(st)
    fin = tpcc.checksums(st.tables)
    check_conservation(eng.cfg, init, fin, s)
    return eng, st, s, init, fin


#: tests/test_tpcc.py:check_conservation's laws, by tpcc.conservation's names
LAWS = ("commits", "money", "history money", "history", "orders",
        "order line counts", "order lines", "stock ytd")


def check_conservation(cfg, init, fin, s):
    laws = tpcc.conservation(cfg, init, fin, s)
    # these runs are short: no ring wraps, so every law applies
    assert sorted(laws) == sorted(LAWS), laws
    assert all(laws.values()), laws


def test_conservation_leaves_out_wrapped_rings():
    # a ring whose cursor passed its capacity no longer holds every row it
    # took: the laws that sum its contents are left out, the others stay
    cfg = TConfig(**tpcc_kw())
    zero = dict.fromkeys(
        tpcc.checksums(tpcc.TPCCWorkload().init_tables(cfg, 0)), 0)
    fin = dict(zero, order_cursor=cfg.tpcc_max_orders + 1,
               d_next_o_id=cfg.tpcc_max_orders + 1)
    laws = tpcc.conservation(cfg, zero, fin,
                             {"txn_cnt": cfg.tpcc_max_orders + 1})
    assert sorted(laws) == sorted(set(LAWS) - {"order line counts"})
    assert all(laws.values()), laws
    laws = tpcc.conservation(cfg, zero, dict(fin, d_ytd=1),
                             {"txn_cnt": cfg.tpcc_max_orders + 1})
    assert not laws["money"] and not laws["history money"]


@pytest.mark.parametrize("kw", [
    tpcc_kw(), tpcc_kw(num_wh=16), tpcc_kw(num_wh=16, wh_update=False),
    tpcc_kw(batch_size=512, admit_cap=64, num_wh=32, query_pool_size=4096)],
    ids=["small", "wide", "no_wh_update", "compact"])
def test_conservation(kw):
    eng, st, s, init, fin = run_and_check(kw)
    assert s["txn_cnt"] > 0
    assert int(st.data.sum()) == s["write_cnt"]


def test_o_id_unique_and_dense_per_district():
    eng, st, s, init, fin = run_and_check(tpcc_kw(num_wh=16,
                                                  perc_payment=0.0))
    n = int(st.tables["order_cursor"])
    assert n > 0
    o_id = tpcc.ring_view(st.tables, "o_id")[:n].numpy()
    o_d = tpcc.ring_view(st.tables, "o_d_id")[:n].numpy()
    o_w = tpcc.ring_view(st.tables, "o_w_id")[:n].numpy()
    for (w, d) in set(zip(o_w.tolist(), o_d.tolist())):
        ids = np.sort(o_id[(o_w == w) & (o_d == d)])
        assert (np.diff(ids) == 1).all(), "o_ids not dense"
        assert ids[0] == 3001, "o_id must start at D_NEXT_O_ID init"


def test_orderline_matches_orders():
    eng, st, s, init, fin = run_and_check(tpcc_kw(num_wh=16,
                                                  perc_payment=0.0))
    n = int(st.tables["order_cursor"])
    nl = int(st.tables["ol_cursor"])
    view = lambda col, m: tpcc.ring_view(st.tables, col)[:m].tolist()
    o_key = list(zip(view("o_w_id", n), view("o_d_id", n), view("o_id", n)))
    ol_key = zip(view("ol_w_id", nl), view("ol_d_id", nl),
                 view("ol_o_id", nl))
    counts = {}
    for k, num in zip(ol_key, view("ol_number", nl)):
        counts.setdefault(k, set()).add(num)
    assert o_key
    for k, cnt in zip(o_key, view("o_ol_cnt", n)):
        assert len(counts.get(k, set())) == cnt


def test_stock_quantity_rule():
    # new_order_9: q' = q - qty if q > qty + 10 else q - qty + 91, so with
    # qty <= 10 s_quantity never drops below 2
    eng, st, s, init, fin = run_and_check(
        tpcc_kw(num_wh=16, perc_payment=0.0), n_ticks=120)
    assert fin["s_order_cnt"] > init["s_order_cnt"]
    assert int(st.tables["s_quantity"].min()) >= 2


def test_rbk_user_abort():
    kw = tpcc_kw(perc_payment=0.0, tpcc_rbk_perc=1.0)
    eng = TEngine(TConfig(**kw), device="cpu")
    st0 = eng.init_state()
    init = tpcc.checksums(st0.tables)
    st = eng.run(40, st0)
    s = eng.summary(st)
    fin = tpcc.checksums(st.tables)
    assert s["txn_cnt"] == 0
    assert s["user_abort_cnt"] > 0
    assert fin["d_next_o_id"] == init["d_next_o_id"]
    assert fin["order_cursor"] == init["order_cursor"]
    assert int(st.data.sum()) == 0


def test_wh_update_false_reads_warehouse():
    kw = tpcc_kw(perc_payment=1.0, wh_update=False)
    eng, st, s, init, fin = run_and_check(kw)
    assert fin["w_ytd"] == init["w_ytd"]   # warehouse never written
    assert s["txn_cnt"] > 0
    _, _, s2, _, _ = run_and_check(dict(kw, wh_update=True))
    assert s["txn_cnt"] > s2["txn_cnt"]
