"""The lock family's arbitration opt-ins in the port (deneva_tpu_torch,
device="cpu") against the JAX package: sub-tick rounds for NO_WAIT,
WAIT_DIE and TIMESTAMP (``sub_ticks``, with ``pipeline_exchange`` off and
on), the dense-row window
arbitration (``dense_lock_state``) and the four isolation levels.

The arbitration functions (``twopl.ts_groups``, ``arbitrate_subticked``,
``arbitrate_window``) and ``seg_reduce``'s min and max at the kernel's
start index are held to their JAX twins on inputs made from a seed.  Each
engine case runs the JAX engine, the port's ``run`` and the port's
``run_compiled`` on one query pool, and holds ``summary()``, the
``[summary]`` line (less ``mem_util``/``cpu_util``), ``data``, the txn
slots, the tables and the plugin's arrays (``wts``/``rts``, ``lk_held``)
equal.  The micro-schedules of tests/test_isolation.py run on both
engines.  Every comparison is exact."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.cc import twopl as jtwopl  # noqa: E402
from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine.scheduler import Engine as JEngine  # noqa: E402
from deneva_tpu.engine.state import TxnState as JTxn  # noqa: E402
from deneva_tpu.ops import fused as jfused  # noqa: E402
from deneva_tpu.ops import segment as jseg  # noqa: E402
from deneva_tpu.workloads.base import QueryPool as JPool  # noqa: E402
from deneva_tpu_torch import workloads as wl_registry  # noqa: E402
from deneva_tpu_torch.cc import twopl as ttwopl  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.engine.state import (  # noqa: E402
    STATUS_BACKOFF, TxnState as TTxn,
)
from deneva_tpu_torch.ops import segment as tseg  # noqa: E402
from tests import test_torch_engine as t_engine  # noqa: E402

POOL_FIELDS = ("keys", "is_write", "n_req", "home_part", "txn_type", "args",
               "aux")
TXN_FIELDS = ("status", "cursor", "ts", "pool_idx", "restarts",
              "backoff_until", "start_tick", "first_start_tick", "keys",
              "is_write", "n_req", "txn_type")
BIG = 2**31 - 1

#: the contended YCSB cell of tests/test_torch_engine.py (B*R = 256, so
#: with fused_arbitrate the JAX side runs its Pallas kernel), and small
#: TPC-C and PPS configs
YCSB = dict(t_engine.CELLS["contended"][0])
TPCC = dict(workload="TPCC", batch_size=64, num_wh=4, cust_per_dist=1000,
            max_items=64, query_pool_size=512)
PPS = dict(workload="PPS", batch_size=64, max_part_key=128,
           max_product_key=128, max_supplier_key=128, max_parts_per=5,
           query_pool_size=512)
TICKS = 40

T = torch.from_numpy
J = jnp.asarray


# ---- the arbitration functions against the JAX package ----


def _txn_state(seed, B=64, R=4, n_keys=32):
    """A random txn state and active mask, made from a seed: distinct
    timestamps, and distinct keys within a txn (as every pool has: the
    reference does not model a txn touching one row twice)."""
    rng = np.random.default_rng(seed)
    f = dict(status=np.zeros(B, np.int32),
             cursor=rng.integers(0, R + 1, B).astype(np.int32),
             ts=rng.permutation(4 * B)[:B].astype(np.int32) + 1,
             pool_idx=np.zeros(B, np.int32),
             restarts=np.zeros(B, np.int32),
             backoff_until=np.zeros(B, np.int32),
             start_tick=np.zeros(B, np.int32),
             first_start_tick=np.zeros(B, np.int32),
             keys=np.stack([rng.choice(n_keys, R, replace=False)
                            for _ in range(B)]).astype(np.int32),
             is_write=rng.random((B, R)) < 0.5,
             n_req=rng.integers(1, R + 1, B).astype(np.int32),
             txn_type=np.zeros(B, np.int32),
             targs=np.zeros((B, 1), np.int32),
             aux=np.zeros((B, R), np.int32))
    f["cursor"] = np.minimum(f["cursor"], f["n_req"])
    active = rng.random(B) < 0.8
    return (JTxn(**{k: J(v) for k, v in f.items()}), J(active),
            TTxn(**{k: T(v) for k, v in f.items()}), T(active))


def _eq(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_ts_groups_matches_reference(seed, K):
    jt, ja, tt, ta = _txn_state(seed)
    got = ttwopl.ts_groups(tt.ts, ta, K)
    _eq(got, jtwopl.ts_groups(jt.ts, ja, K))
    # no live txn at all: the live count is clamped to 1
    _eq(ttwopl.ts_groups(tt.ts, ta & False, K),
        jtwopl.ts_groups(jt.ts, ja & False, K))


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["in_order", "pipelined"])
@pytest.mark.parametrize("policy", ["NO_WAIT", "WAIT_DIE", "CALVIN"])
def test_arbitrate_subticked_matches_reference(policy, pipelined):
    # the port's in-order rounds against the reference's, and against its
    # hoisted request planes (pipeline_exchange), which the port does not
    # build: on one stream they give the same masks
    for seed, K, rlh in ((10, 2, True), (11, 8, True), (12, 4, False)):
        jt, ja, tt, ta = _txn_state(seed)
        want = jtwopl.arbitrate_subticked(jt, ja, policy, K,
                                          read_locks_held=rlh,
                                          pipelined=pipelined)
        got = ttwopl.arbitrate_subticked(tt, ta, policy, K,
                                         read_locks_held=rlh)
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("read_locks_held", [True, False],
                         ids=["held", "released"])
@pytest.mark.parametrize("W", [1, 3, 8])
@pytest.mark.parametrize("policy", ["NO_WAIT", "WAIT_DIE", "CALVIN"])
def test_arbitrate_window_matches_reference(policy, W, read_locks_held):
    jt, ja, tt, ta = _txn_state(20 + W, R=10, n_keys=24)
    jtmp = jtwopl.init_lock_tmp(24)
    ttmp = ttwopl.init_lock_tmp(24)
    buf = ttmp["lk_held"]
    want = jtwopl.arbitrate_window(jt, ja, policy, jtmp, W,
                                   read_locks_held=read_locks_held)
    got = ttwopl.arbitrate_window(tt, ta, policy, ttmp, W,
                                  read_locks_held=read_locks_held)
    for g, w in zip(got, want[:3]):
        _eq(g, w)
    # the scratch is updated in place and left at its identity
    assert ttmp["lk_held"] is buf
    _eq(buf, want[3]["lk_held"])
    assert bool((buf == BIG).all())


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("n", [1, 7, 130, 1000])
def test_seg_reduce_min_max_at_start_index(op, n):
    # the order-free scatter into the start-index slot against the JAX
    # package's scans, with the kernel's start index and without
    rng = np.random.default_rng(30 + n)
    ids = np.sort(rng.integers(0, max(1, n // 3), n)).astype(np.int32)
    vals = rng.integers(-2**31, BIG, n, endpoint=True).astype(np.int32)
    vals[rng.random(n) < 0.1] = BIG
    vals[rng.random(n) < 0.1] = -2**31
    mask = rng.random(n) < 0.4
    ts, js = tseg.segment_starts(T(ids)), jseg.segment_starts(J(ids))
    sidx = tseg.start_index(ts)
    want = jseg.seg_reduce(J(vals), js, op)
    _eq(tseg.seg_reduce(T(vals), ts, op, sidx), want)
    _eq(tseg.seg_reduce(T(vals), ts, op), want)
    if op == "min":
        _eq(tseg.seg_min_where(T(vals), T(mask), ts, BIG, sidx),
            jseg.seg_min_where(J(vals), J(mask), js, BIG))
    else:
        _eq(tseg.seg_max_where(T(vals), T(mask), ts, -2**31),
            jseg.seg_max_where(J(vals), J(mask), js, -2**31))


# ---- the engine against the JAX engine, eager and compiled ----


def _line(eng, state):
    return [kv for kv in eng.summary_line(state).split(",")
            if not kv.startswith(("mem_util=", "cpu_util="))]


def _assert_same(a_eng, a, b_eng, b):
    """Summary, [summary] line, data, tables and plugin arrays of two
    flushed port runs."""
    sa, sb = a_eng.summary(a), b_eng.summary(b)
    assert sa == sb, {k: (sa[k], sb.get(k)) for k in sa if sa[k] != sb.get(k)}
    assert _line(a_eng, a) == _line(b_eng, b)
    assert torch.equal(a.data, b.data)
    assert sorted(a.tables) == sorted(b.tables)
    for part in ("tables", "db"):
        x, y = getattr(a, part), getattr(b, part)
        assert sorted(x) == sorted(y), part
        for k in x:
            assert torch.equal(x[k], y[k]), (part, k)
    return sb


def run_cell(kw, n_ticks=TICKS, pool=None):
    """The JAX engine's run, and the port's run and run_compiled, on one
    pool: all three held equal.  Returns the port's summary, engine and
    eager state."""
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
    ts = te.run(n_ticks)
    cs = tc.run_compiled(n_ticks)
    a, b = je.summary(js), te.summary(ts)
    assert a == b, {k: (a[k], b.get(k)) for k in a if a[k] != b.get(k)}
    assert t_engine._line_without_host_keys(je.summary_line(js)) == \
        _line(te, ts)
    np.testing.assert_array_equal(np.asarray(js.data), ts.data.numpy())
    for f in TXN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js.txn, f)),
                                      getattr(ts.txn, f).numpy(), err_msg=f)
    assert sorted(ts.tables) == sorted(js.tables)
    for k in ts.tables:
        np.testing.assert_array_equal(np.asarray(js.tables[k]),
                                      ts.tables[k].numpy(), err_msg=k)
    assert set(ts.db) <= set(js.db), (sorted(ts.db), sorted(js.db))
    for k in ts.db:
        np.testing.assert_array_equal(np.asarray(js.db[k]),
                                      ts.db[k].numpy(), err_msg=k)
    _assert_same(te, ts, tc, cs)
    assert te.workload.counts() == tc.workload.counts()
    assert b["txn_cnt"] > 0
    return b, te, ts


def _aborted(s, waits=False):
    assert s["total_txn_abort_cnt"] > 0
    if waits:
        assert s["twopl_wait_cnt"] > 0


SUBTICK_CASES = [(cc, K, p) for cc in ("NO_WAIT", "WAIT_DIE")
                 for K in (2, 4) for p in (False, True)]


@pytest.mark.parametrize("cc,K,pipelined", SUBTICK_CASES,
                         ids=[f"{c}-K{k}-{'pipe' if p else 'inorder'}"
                              for c, k, p in SUBTICK_CASES])
def test_subticks_engine_matches_reference(cc, K, pipelined):
    s, _, _ = run_cell(dict(YCSB, cc_alg=cc, sub_ticks=K,
                            pipeline_exchange=pipelined))
    _aborted(s, waits=cc == "WAIT_DIE")


def test_pipelined_equals_in_order_rounds():
    kw = dict(YCSB, cc_alg="WAIT_DIE", sub_ticks=4)
    cfg = TConfig(**kw)
    pool = wl_registry.get(cfg).gen_pool(cfg)
    a = TEngine(cfg, pool=pool, device="cpu")
    b = TEngine(TConfig(**kw, pipeline_exchange=True), pool=pool,
                device="cpu")
    _assert_same(a, a.run(TICKS), b, b.run(TICKS))


def test_subticks_fused_matches_reference():
    # the sort kernel's path on both sides: the JAX package's Pallas kernel
    # (interpret mode) and the port's plain version on the CPU
    jfused.reset_fallbacks()
    s, _, _ = run_cell(dict(YCSB, cc_alg="NO_WAIT", sub_ticks=2,
                            fused_arbitrate=True), n_ticks=20)
    _aborted(s)
    assert jfused.fallback_snapshot()["count"] == 0


@pytest.mark.parametrize("workload", ["ycsb", "tpcc"])
def test_timestamp_subticks_matches_reference(workload):
    kw = dict(YCSB if workload == "ycsb" else TPCC, cc_alg="TIMESTAMP",
              sub_ticks=4)
    s, _, ts = run_cell(kw, n_ticks=30)
    _aborted(s, waits=workload == "ycsb")
    assert int(ts.db["rts"].max()) > 0


DENSE_CASES = {
    "ycsb-NO_WAIT": (YCSB, "NO_WAIT", {}),
    "ycsb-WAIT_DIE": (YCSB, "WAIT_DIE", {}),
    "ycsb-WAIT_DIE-window6": (YCSB, "WAIT_DIE", {"acquire_window": 6}),
    "ycsb-NO_WAIT-read_heavy": (YCSB, "NO_WAIT", {"tup_read_perc": 0.9}),
    "tpcc-NO_WAIT": (TPCC, "NO_WAIT", {}),
    "tpcc-WAIT_DIE": (TPCC, "WAIT_DIE", {}),
    "pps-NO_WAIT": (PPS, "NO_WAIT", {}),
    "pps-WAIT_DIE": (PPS, "WAIT_DIE", {}),
}


@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_lock_state_matches_reference_and_sorted_join(case):
    base, cc, over = DENSE_CASES[case]
    kw = dict(base, cc_alg=cc, **over)
    s, te, ts = run_cell(dict(kw, dense_lock_state=True), n_ticks=30)
    assert "lk_held" in ts.db and bool((ts.db["lk_held"] == BIG).all())
    # the sorted-segment join on the same pool: the same schedule
    sj = TEngine(TConfig(**kw), pool=te.pool, device="cpu")
    js = sj.run(30)
    assert sj.summary(js) == s
    assert torch.equal(js.data, ts.data)
    for k in js.tables:
        assert torch.equal(js.tables[k], ts.tables[k]), k


def test_dense_lock_state_fused_matches_reference():
    jfused.reset_fallbacks()
    s, _, _ = run_cell(dict(YCSB, cc_alg="WAIT_DIE", dense_lock_state=True,
                            fused_arbitrate=True), n_ticks=20)
    _aborted(s)
    assert jfused.fallback_snapshot()["count"] == 0


def test_dense_lock_state_is_inert_under_calvin():
    kw = dict(YCSB, cc_alg="CALVIN")
    s, te, ts = run_cell(dict(kw, dense_lock_state=True), n_ticks=30)
    assert "lk_held" not in ts.db
    plain = TEngine(TConfig(**kw), pool=te.pool, device="cpu")
    ps = plain.run(30)
    assert plain.summary(ps) == s and torch.equal(ps.data, ts.data)


LEVELS = ("SERIALIZABLE", "READ_COMMITTED", "READ_UNCOMMITTED", "NOLOCK")


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("cc", ["NO_WAIT", "WAIT_DIE"])
def test_isolation_level_matches_reference(cc, level):
    s, _, _ = run_cell(dict(YCSB, cc_alg=cc, isolation_level=level))
    if level == "NOLOCK":
        assert s["total_txn_abort_cnt"] == 0 and s["twopl_wait_cnt"] == 0
    else:
        _aborted(s)


@pytest.mark.parametrize("level", ["READ_UNCOMMITTED", "NOLOCK"])
def test_bypass_levels_ignore_sub_ticks(level):
    # NOLOCK and READ_UNCOMMITTED take their one-round bypass even with
    # sub_ticks > 1, as in the reference
    kw = dict(YCSB, cc_alg="WAIT_DIE", isolation_level=level)
    s, te, ts = run_cell(dict(kw, sub_ticks=4), n_ticks=30)
    one = TEngine(TConfig(**kw), pool=te.pool, device="cpu")
    os_ = one.run(30)
    assert one.summary(os_) == s and torch.equal(os_.data, ts.data)


@pytest.mark.parametrize("path", ["sub_ticks", "window"])
@pytest.mark.parametrize("cc", ["NO_WAIT", "WAIT_DIE"])
def test_read_committed_paths_match_reference(cc, path):
    over = {"sub_ticks": 2} if path == "sub_ticks" \
        else {"dense_lock_state": True}
    s, _, _ = run_cell(dict(YCSB, cc_alg=cc, isolation_level="READ_COMMITTED",
                            **over), n_ticks=30)
    _aborted(s)


@pytest.mark.parametrize("cc", ["TIMESTAMP", "OCC"])
def test_other_plugins_ignore_the_isolation_level(cc):
    kw = dict(YCSB, cc_alg=cc)
    s, te, ts = run_cell(dict(kw, isolation_level="NOLOCK"), n_ticks=30)
    ser = TEngine(TConfig(**kw), pool=te.pool, device="cpu")
    ss = ser.run(30)
    assert ser.summary(ss) == s and torch.equal(ss.data, ts.data)
    for k in ss.db:
        assert torch.equal(ss.db[k], ts.db[k]), k
    _aborted(s)


# ---- the micro-schedules of tests/test_isolation.py, on both engines ----


def _steps(kw, keys, is_write, n_ticks):
    pool = t_engine._pool(keys, is_write)
    je, js, te, ts = t_engine._run_both(kw, n_ticks, pool=pool)
    t_engine._assert_parity(je, js, te, ts)
    return te, ts


def _iso(level, **kw):
    return dict(t_engine.SMALL, batch_size=2, query_pool_size=2,
                isolation_level=level, **kw)


def test_read_committed_releases_read_locks():
    # txn0 reads k5 then k1; txn1 writes k5 then k2.  Under SERIALIZABLE
    # txn1 dies at tick 0 on txn0's S lock; under READ_COMMITTED txn0's
    # completed read of k5 is not held, so txn1's retry takes k5
    keys, iw = [[5, 1], [5, 2]], [[False, False], [True, True]]
    _, st = _steps(_iso("SERIALIZABLE"), keys, iw, 1)
    assert int(st.txn.status[1]) == STATUS_BACKOFF
    _, st = _steps(_iso("READ_COMMITTED"), keys, iw, 2)
    assert int(st.txn.cursor[1]) == 1
    # the same on the sub-tick rounds and on the dense window
    for over in ({"sub_ticks": 2}, {"dense_lock_state": True}):
        _, st = _steps(_iso("READ_COMMITTED", **over), keys, iw, 2)
        assert int(st.txn.cursor[1]) == 1


def test_read_uncommitted_reads_bypass_x_locks():
    # txn0 writes k5 (X lock); txn1 reads k5: it dies under SERIALIZABLE
    # (NO_WAIT) and is granted under READ_UNCOMMITTED
    keys, iw = [[5, 1], [5, 2]], [[True, True], [False, False]]
    _, st = _steps(_iso("SERIALIZABLE"), keys, iw, 1)
    assert int(st.txn.status[1]) == STATUS_BACKOFF
    _, st = _steps(_iso("READ_UNCOMMITTED"), keys, iw, 1)
    assert int(st.txn.cursor[1]) == 1


def test_nolock_never_conflicts():
    keys = [[5, 1], [5, 2], [5, 3], [5, 4]]
    eng, st = _steps(dict(t_engine.SMALL, isolation_level="NOLOCK"), keys,
                     np.ones((4, 2), bool), 3)
    s = eng.summary(st)
    assert s["total_txn_abort_cnt"] == 0
    assert s["txn_cnt"] == 4
