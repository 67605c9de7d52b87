"""The port's engine (deneva_tpu_torch, device="cpu") against the JAX
package's Engine: the same Config kwargs and the same QueryPool go to
both, and the summary() dict, the [summary] line (less the host-process
keys mem_util and cpu_util, read from /proc), the data table and the txn
slots must be equal.  Also the golden micro-schedules of
tests/test_engine_nowait.py and the arbitration kernel on random entries.
All comparisons are exact."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.cc import twopl as jtwopl  # noqa: E402
from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine import state as jstate  # noqa: E402
from deneva_tpu.engine.scheduler import Engine as JEngine  # noqa: E402
from deneva_tpu.ops import fused as jfused  # noqa: E402
from deneva_tpu.workloads.base import QueryPool as JPool  # noqa: E402
from deneva_tpu_torch.cc import twopl as ttwopl  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine import state as tstate  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.workloads import ycsb as tycsb  # noqa: E402
from deneva_tpu_torch.workloads.base import QueryPool as TPool  # noqa: E402

CELLS = {
    # __graft_entry__.py:entry(): B*R = 10,240 lanes, P = 16,384 (past the
    # TPU kernel's 8192-lane cap, so the JAX side sorts with lax.sort)
    "entry": (dict(cc_alg="NO_WAIT", batch_size=1024,
                   synth_table_size=1 << 16, req_per_query=10,
                   zipf_theta=0.6, query_pool_size=1 << 12), 50),
    # contended: B*R = 256 lanes, so with fused_arbitrate the JAX side
    # runs its Pallas kernel (interpret mode)
    "contended": (dict(cc_alg="NO_WAIT", batch_size=64,
                       synth_table_size=256, req_per_query=4,
                       zipf_theta=0.9, query_pool_size=512), 100),
}

TXN_FIELDS = ("status", "cursor", "ts", "pool_idx", "restarts",
              "backoff_until", "start_tick", "first_start_tick", "keys",
              "is_write", "n_req", "txn_type")


def _line_without_host_keys(line):
    return [kv for kv in line.split(",")
            if not kv.startswith(("mem_util=", "cpu_util="))]


def _run_both(kw, n_ticks, pool=None, chunks=None):
    """Run both engines on one pool; `chunks` splits the run into several
    run() calls on the carried state."""
    if pool is None:
        pool = tycsb.gen_query_pool(TConfig(**kw))
    jpool = JPool(**{f: getattr(pool, f) for f in (
        "keys", "is_write", "n_req", "home_part", "txn_type", "args",
        "aux")})
    je = JEngine(JConfig(**kw), pool=jpool)
    te = TEngine(TConfig(**kw), pool=pool, device="cpu")
    js, ts = None, None
    for n in (chunks or [n_ticks]):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the JAX gate's width fallback
            js = je.run(n, js)
        ts = te.run(n, ts)
    return je, js, te, ts


def _assert_parity(je, js, te, ts):
    a, b = je.summary(js), te.summary(ts)
    assert a == b, {k: (a[k], b.get(k)) for k in a if a[k] != b.get(k)}
    assert _line_without_host_keys(je.summary_line(js)) == \
        _line_without_host_keys(te.summary_line(ts))
    np.testing.assert_array_equal(np.asarray(js.data), ts.data.numpy())
    if te.cfg.warmup_ticks == 0:
        # increment oracle: every committed write applied exactly once
        # (warmup commits write data but are not counted)
        assert int(ts.data.sum()) == b["write_cnt"]
    for f in TXN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js.txn, f)),
                                      getattr(ts.txn, f).numpy(), err_msg=f)
    assert int(js.pool_cursor) == int(ts.pool_cursor)
    assert int(js.ts_counter) == int(ts.ts_counter)
    return b


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_engine_matches_reference(cell, fused):
    kw, n_ticks = CELLS[cell]
    jfused.reset_fallbacks()
    je, js, te, ts = _run_both(dict(kw, fused_arbitrate=fused), n_ticks)
    s = _assert_parity(je, js, te, ts)
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    if fused and cell == "contended":
        # the reference really ran its Pallas kernel, never lax.sort
        assert jfused.fallback_snapshot()["count"] == 0


def test_engine_matches_reference_across_run_calls():
    # the write ring's flush schedule and the carried state across run()
    # boundaries: 7 + 11 + 5 ticks
    kw, _ = CELLS["contended"]
    _assert_parity(*_run_both(kw, None, chunks=[7, 11, 5]))


@pytest.mark.parametrize("kw", [
    dict(abort_penalty_ticks=3, abort_penalty_max_ticks=20),
    dict(backoff=False),
    dict(restart_new_ts=True),
    dict(acquire_window=2),
    dict(admit_cap=16, warmup_ticks=5),
], ids=["penalty", "no_backoff", "restart_new_ts", "window2", "cap_warmup"])
def test_engine_knobs_match_reference(kw):
    base, _ = CELLS["contended"]
    _assert_parity(*_run_both(dict(base, **kw), 60))


# ---- golden micro-schedules of tests/test_engine_nowait.py ----


def _pool(keys, is_write):
    keys = np.asarray(keys, np.int32)
    Q, R = keys.shape
    return TPool(keys=keys, is_write=np.asarray(is_write, bool),
                 n_req=np.full(Q, R, np.int32),
                 home_part=np.zeros(Q, np.int32),
                 txn_type=np.zeros(Q, np.int32),
                 args=np.zeros((Q, 1), np.int32))


SMALL = dict(batch_size=4, synth_table_size=64, req_per_query=2,
             query_pool_size=4, abort_penalty_ticks=1, backoff=False,
             warmup_ticks=0, cc_alg="NO_WAIT")
PAIR_KEYS = [[5, 1], [5, 2], [10, 11], [12, 13]]


def test_conflict_free_txns_all_commit():
    pool = _pool(np.arange(8).reshape(4, 2), np.ones((4, 2), bool))
    s = _assert_parity(*_run_both(SMALL, 4, pool=pool))
    assert s["txn_cnt"] == 4 and s["total_txn_abort_cnt"] == 0
    assert s["write_cnt"] == 8


def test_ww_conflict_younger_aborts():
    pool = _pool(PAIR_KEYS, np.ones((4, 2), bool))
    je, js, te, ts = _run_both(SMALL, 1, pool=pool)
    _assert_parity(je, js, te, ts)
    assert int(ts.txn.cursor[0]) == 1
    assert int(ts.txn.status[1]) == tstate.STATUS_BACKOFF
    assert int(ts.txn.restarts[1]) == 1


def test_rr_share_no_conflict():
    pool = _pool(PAIR_KEYS, np.zeros((4, 2), bool))
    je, js, te, ts = _run_both(SMALL, 1, pool=pool)
    _assert_parity(je, js, te, ts)
    assert ts.txn.cursor[:2].tolist() == [1, 1]


def test_rw_conflict_aborts_writer():
    iw = [[False, False], [True, True], [False, False], [False, False]]
    je, js, te, ts = _run_both(SMALL, 1, pool=_pool(PAIR_KEYS, iw))
    _assert_parity(je, js, te, ts)
    assert int(ts.txn.cursor[0]) == 1
    assert int(ts.txn.status[1]) == tstate.STATUS_BACKOFF


def test_aborted_txn_retries_and_commits():
    pool = _pool([[5, 1], [5, 2]], np.ones((2, 2), bool))
    kw = dict(SMALL, batch_size=2, query_pool_size=2)
    s = _assert_parity(*_run_both(kw, 12, pool=pool))
    assert s["txn_cnt"] >= 4 and s["total_txn_abort_cnt"] >= 1


def test_warmup_gates_stats():
    kw = dict(batch_size=16, synth_table_size=256, req_per_query=2,
              query_pool_size=64, cc_alg="NO_WAIT", warmup_ticks=10)
    je, js, te, ts = _run_both(kw, 10)
    assert _assert_parity(je, js, te, ts)["txn_cnt"] == 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = je.run(20, js)
    ts = te.run(20, ts)
    assert _assert_parity(je, js, te, ts)["txn_cnt"] > 0


@pytest.mark.parametrize("theta", [0.0, 0.9])
def test_increment_oracle_under_contention(theta):
    kw = dict(batch_size=64, synth_table_size=256, req_per_query=4,
              query_pool_size=512, zipf_theta=theta, tup_read_perc=0.5,
              cc_alg="NO_WAIT", warmup_ticks=0)
    s = _assert_parity(*_run_both(kw, 40))
    assert s["txn_cnt"] > 0
    if theta == 0.9:
        assert s["total_txn_abort_cnt"] > 0


def test_read_only_never_aborts():
    kw = dict(batch_size=32, synth_table_size=256, req_per_query=4,
              query_pool_size=256, zipf_theta=0.9, txn_read_perc=1.0,
              cc_alg="NO_WAIT", warmup_ticks=0)
    je, js, te, ts = _run_both(kw, 30)
    s = _assert_parity(je, js, te, ts)
    assert s["total_txn_abort_cnt"] == 0 and s["txn_cnt"] > 0
    assert int(ts.data.sum()) == 0


# ---- the arbitration kernel on random entry views ----


def _random_txns(seed, B=48, R=5, n_rows=40):
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.choice(n_rows, R, replace=False)
                     for _ in range(B)]).astype(np.int32)
    return dict(
        keys=keys, is_write=rng.random((B, R)) < 0.5,
        cursor=rng.integers(0, R + 1, B).astype(np.int32),
        ts=rng.permutation(10 * B)[:B].astype(np.int32) + 1,
        active=rng.random(B) < 0.8,
        n_req=np.full(B, R, np.int32))


def _txn(mod, arr, d):
    B, R = d["keys"].shape
    z = lambda: arr(np.zeros(B, np.int32))
    return mod.TxnState(
        status=z(), cursor=arr(d["cursor"]), ts=arr(d["ts"]),
        pool_idx=z(), restarts=z(), backoff_until=z(), start_tick=z(),
        first_start_tick=z(), keys=arr(d["keys"]),
        is_write=arr(d["is_write"]), n_req=arr(d["n_req"]),
        txn_type=z(), targs=arr(np.zeros((B, 1), np.int32)),
        aux=arr(np.zeros((B, R), np.int32)))


@pytest.mark.parametrize("window", [1, 3, 9])
def test_request_window_matches_reference(window):
    d = _random_txns(7)
    want = jstate.request_window(_txn(jstate, jnp.asarray, d),
                                 jnp.asarray(d["active"]), window)
    got = tstate.request_window(_txn(tstate, torch.from_numpy, d),
                                torch.from_numpy(d["active"]), window)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("window", [1, 3])
@pytest.mark.parametrize("policy", ["NO_WAIT", "WAIT_DIE"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arbitrate_matches_reference(seed, policy, window):
    d = _random_txns(seed)
    jent = jstate.make_entries(_txn(jstate, jnp.asarray, d),
                               jnp.asarray(d["active"]), window=window)
    tent = tstate.make_entries(_txn(tstate, torch.from_numpy, d),
                               torch.from_numpy(d["active"]), window=window)
    for f in jent._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jent, f)),
                                      getattr(tent, f).numpy(), err_msg=f)
    want = jtwopl.arbitrate(jent, policy)
    got = ttwopl.arbitrate(tent, policy)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(want[0].any())


def test_abort_rate_parity_with_sequential_oracle():
    # the NO_WAIT cell of tests/test_parity.py, the port against the numpy
    # sequential oracle (deneva_tpu/oracle/sequential.py) on one pool,
    # held to the same bound: abort-rate divergence <= 0.02
    from deneva_tpu.oracle.parity import _pair_dict
    from deneva_tpu.oracle.sequential import SequentialEngine
    kw = dict(cc_alg="NO_WAIT", batch_size=256, synth_table_size=1 << 16,
              req_per_query=10, query_pool_size=1 << 12, zipf_theta=0.6,
              tup_read_perc=0.5, warmup_ticks=0)
    pool = tycsb.gen_query_pool(TConfig(**kw))
    te = TEngine(TConfig(**kw), pool=pool, device="cpu")
    ts = te.run(50)
    seq = SequentialEngine(JConfig(**kw), pool=pool).run(50)
    r = _pair_dict(JConfig(**kw), te.summary(ts), int(ts.data.sum()), seq)
    assert r["batched_conserved"] and r["sequential_conserved"], r
    assert r["abort_rate_divergence"] <= 0.02, r
    assert 0.8 <= r["tput_ratio"] <= 1.25, r
