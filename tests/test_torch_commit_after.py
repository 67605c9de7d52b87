"""Commit after access (``Config.commit_after_access``) in the port
(deneva_tpu_torch, device="cpu") against the JAX package: the commit block
runs after the access block, so a txn commits in the tick its last access
grants, and the validation aborts go to backoff after both blocks.

Each engine case runs the JAX engine, the port's ``run`` and the port's
``run_compiled`` on one query pool, and holds ``summary()``, the
``[summary]`` line (less ``mem_util``/``cpu_util``), ``data``, the txn
slots, every table and the plugin's arrays (``wts``/``rts``, the MVCC
rings, ``occ_wcommit``, ``maat_*``, ``lk_held``) equal, and the device
loop's passes (OCC, MAAT) equal eager and compiled.  The grid: the seven
plugins on YCSB, TPC-C and PPS, ``fused_arbitrate`` on for NO_WAIT and
MAAT on YCSB, ``sub_ticks``, ``dense_lock_state``, READ_COMMITTED and
TPC-C's rollbacks (user aborts).  A
hand-made OCC pool holds the history check at ``wcommit == start_tick``,
and the commit-first order is held to the reference under each plugin.
Every comparison is exact."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine.scheduler import Engine as JEngine  # noqa: E402
from deneva_tpu.ops import fused as jfused  # noqa: E402
from deneva_tpu.workloads.base import QueryPool as JPool  # noqa: E402
from deneva_tpu_torch import cells  # noqa: E402
from deneva_tpu_torch import workloads as wl_registry  # noqa: E402
from deneva_tpu_torch.cc.mvcc import Mvcc  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.ops import device_loop  # noqa: E402
from tests import test_torch_engine as t_engine  # noqa: E402
from tests import test_torch_occ as t_occ  # noqa: E402
from tests.test_torch_lock_optins import (  # noqa: E402
    POOL_FIELDS, PPS, TICKS, TPCC, TXN_FIELDS, YCSB, _assert_same, _line,
)

PLUGINS = ("NO_WAIT", "WAIT_DIE", "TIMESTAMP", "MVCC", "CALVIN", "OCC",
           "MAAT")
WORKLOADS = {"ycsb": YCSB, "tpcc": TPCC, "pps": PPS}


def _db_view(cfg, db):
    """The plugin arrays compared with the reference: MVCC's rings without
    the port's scratch cells past n_rows*H."""
    if cfg.cc_alg != "MVCC":
        return db
    return {**db, **Mvcc.visible(cfg, db)}


def _passes(cfg):
    site = {"OCC": "occ", "MAAT": "maat"}.get(cfg.cc_alg)
    return int(device_loop.passes(site, "cpu")) if site else 0


def run_both_orders(kw, n_ticks=TICKS, pool=None, min_commits=1):
    """The JAX engine's run, and the port's run and run_compiled, on one
    pool: all three held equal (with the device loop's passes, eager
    against compiled), and at least ``min_commits`` commits.  Returns the
    port's summary, engine and state."""
    cfg = TConfig(**kw)
    if pool is None:
        pool = wl_registry.get(cfg).gen_pool(cfg)
    je = JEngine(JConfig(**kw),
                 pool=JPool(**{f: getattr(pool, f) for f in POOL_FIELDS}))
    te = TEngine(cfg, pool=pool, device="cpu")
    tc = TEngine(cfg, pool=pool, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the JAX gate's width fallback
        js = je.run(n_ticks)
    device_loop.reset_passes()
    ts = te.run(n_ticks)
    eager_passes = _passes(cfg)
    device_loop.reset_passes()
    cs = tc.run_compiled(n_ticks)
    assert _passes(cfg) == eager_passes
    a, b = je.summary(js), te.summary(ts)
    assert a == b, {k: (a[k], b.get(k)) for k in a if a[k] != b.get(k)}
    assert t_engine._line_without_host_keys(je.summary_line(js)) == \
        _line(te, ts)
    np.testing.assert_array_equal(np.asarray(js.data), ts.data.numpy())
    assert int(ts.data.sum()) == b["write_cnt"] or cfg.warmup_ticks
    for f in TXN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js.txn, f)),
                                      getattr(ts.txn, f).numpy(), err_msg=f)
    assert int(js.pool_cursor) == int(ts.pool_cursor)
    assert int(js.ts_counter) == int(ts.ts_counter)
    assert sorted(ts.tables) == sorted(js.tables)
    for k in ts.tables:
        np.testing.assert_array_equal(np.asarray(js.tables[k]),
                                      ts.tables[k].numpy(), err_msg=k)
    assert set(ts.db) <= set(js.db), (sorted(ts.db), sorted(js.db))
    for k, v in _db_view(cfg, ts.db).items():
        np.testing.assert_array_equal(np.asarray(js.db[k]), v.numpy(),
                                      err_msg=k)
    _assert_same(te, ts, tc, cs)
    assert te.workload.counts() == tc.workload.counts()
    assert b["txn_cnt"] >= min_commits
    return b, te, ts


def _check_counts(cc, s):
    # the access aborts and the validation aborts add up to the abort
    # count in either order: the validating plugins abort only there, the
    # others never validate, and CALVIN never aborts
    if cc in ("OCC", "MAAT"):
        assert s["total_txn_abort_cnt"] == s["vabort_cnt"] > 0
    else:
        assert s["vabort_cnt"] == 0
    if cc == "CALVIN":
        assert s["total_txn_abort_cnt"] == 0
    if cc == "MVCC":
        assert "mvcc_tail_fold_cnt" in s


GRID = [(w, cc, {}) for w in WORKLOADS for cc in PLUGINS]
GRID += [("ycsb", "NO_WAIT", dict(fused_arbitrate=True)),
         ("ycsb", "MAAT", dict(fused_arbitrate=True)),
         ("ycsb", "NO_WAIT", dict(sub_ticks=2)),
         ("ycsb", "TIMESTAMP", dict(sub_ticks=2)),
         ("pps", "WAIT_DIE", dict(dense_lock_state=True)),
         ("ycsb", "NO_WAIT", dict(isolation_level="READ_COMMITTED")),
         # TPC-C's rollbacks: user aborts inside the commit block, which
         # now runs after the access block
         ("tpcc", "NO_WAIT", dict(tpcc_rbk_perc=0.3)),
         ("tpcc", "OCC", dict(tpcc_rbk_perc=0.3))]


def _id(case):
    w, cc, over = case
    return "-".join([w, cc] + [f"{k}={v}" for k, v in over.items()])


@pytest.mark.parametrize("case", GRID, ids=[_id(c) for c in GRID])
def test_commit_after_access_matches_reference(case):
    workload, cc, over = case
    jfused.reset_fallbacks()
    s, _, _ = run_both_orders(dict(WORKLOADS[workload], cc_alg=cc,
                                   commit_after_access=True, **over))
    _check_counts(cc, s)
    assert (s["user_abort_cnt"] > 0) == ("tpcc_rbk_perc" in over)
    if over.get("fused_arbitrate"):
        # the reference ran its Pallas kernel (interpret mode), never
        # lax.sort
        assert jfused.fallback_snapshot()["count"] == 0


@pytest.mark.parametrize("cc", PLUGINS)
def test_commit_first_order_does_not_move(cc):
    # the flag off on the same pool: the port still equals the reference's
    # commit-first order, and the two orders give different runs
    kw = dict(YCSB, cc_alg=cc)
    cfg = TConfig(**kw)
    pool = wl_registry.get(cfg).gen_pool(cfg)
    first, _, _ = run_both_orders(dict(kw, commit_after_access=False),
                                  pool=pool)
    _check_counts(cc, first)
    after = TEngine(TConfig(**kw, commit_after_access=True), pool=pool,
                    device="cpu")
    assert after.summary(after.run(TICKS)) != first


def test_caa_cells_are_their_cells_with_the_flag():
    # the four full-size cells are their flagless cells plus the flag, and
    # no other cell carries it
    base = {"headline_caa": "headline", "headline_occ_caa": "headline_occ",
            "headline_maat_caa": "headline_maat",
            "tpcc_calvin_caa": "tpcc_calvin"}
    assert set(base) <= set(cells.CELLS)
    for name, kw in cells.CELLS.items():
        if name in base:
            assert kw == dict(cells.CELLS[base[name]],
                              commit_after_access=True)
        else:
            assert not kw.get("commit_after_access"), name


def test_occ_writer_commits_in_the_readers_first_tick():
    # txn0 writes k5 (one access); txn1 reads k5, then k1.  Commit after
    # access: both are admitted at tick 0, txn0's write grants and commits
    # in that tick (occ_wcommit[5] = 0), after txn1's read of k5; at tick
    # 1 txn1 validates with wcommit == start_tick == 0, which the history
    # check (wcommit > start_tick) does not abort, in both engines.
    # Commit first: txn0 commits at tick 1, after txn1's start, and txn1's
    # validation at tick 2 fails the history check
    keys = np.array([[5, 8], [5, 1], [20, 21], [22, 23]], np.int32)
    iw = np.array([[True, True], [False, False], [True, True],
                   [True, True]])
    pool = t_occ._pool(keys, iw, [1, 2, 2, 2])
    kw = dict(t_occ.SMALL, query_pool_size=4, commit_after_access=True)
    eng, st_ = next(t_occ.steps(kw, pool, [2]))
    s = eng.summary(st_)
    assert s["total_txn_abort_cnt"] == 0 and s["txn_cnt"] == 2
    assert int(st_.db["occ_wcommit"][5]) == 0
    kw = dict(kw, commit_after_access=False)
    eng, st_ = next(t_occ.steps(kw, pool, [3]))
    s = eng.summary(st_)
    assert s["occ_hist_abort_cnt"] == 1 and s["total_txn_abort_cnt"] == 1
    assert int(st_.db["occ_wcommit"][5]) == 1
