"""OCC in the port (deneva_tpu_torch, device="cpu") against the JAX
package's OCC plugin and engine, on the same inputs made with numpy from a
seed: ``Occ.validate`` on random finishing sets and on conflict chains
deeper than 8 (the active-writer fixed point run to convergence, its
passes counted on the device), the golden micro-schedules of
tests/test_occ.py, a pool whose txns touch one row twice (a txn never
conflicts with itself), the engine on YCSB, TPC-C and PPS with
``fused_arbitrate`` off and on, eager and ``run_compiled``, and the
sequential oracle at OCC's threshold of 0.005 (tests/test_parity.py).
Every comparison is exact (all int32 and bool): summary (with
``occ_hist_abort_cnt`` and ``occ_active_abort_cnt``), ``[summary]`` less
its host keys, ``data``, ``occ_wcommit``, every table and the txn
slots."""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from deneva_tpu.cc import occ as jocc  # noqa: E402
from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine import state as jstate  # noqa: E402
from deneva_tpu.engine.scheduler import Engine as JEngine  # noqa: E402
from deneva_tpu.workloads.base import QueryPool as JPool  # noqa: E402
from deneva_tpu_torch import workloads as wl_registry  # noqa: E402
from deneva_tpu_torch.cc import occ as tocc  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine import state as tstate  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.engine.state import STATUS_BACKOFF  # noqa: E402
from deneva_tpu_torch.ops import device_loop  # noqa: E402
from deneva_tpu_torch.workloads import ycsb  # noqa: E402
from tests import test_torch_engine as t_engine  # noqa: E402
from tests import test_torch_pps as t_pps  # noqa: E402
from tests import test_torch_tpcc as t_tpcc  # noqa: E402
from tests.test_torch_wait_die import _oracle_divergence  # noqa: E402

J, T = jnp.asarray, torch.from_numpy
#: tests/test_engine_nowait.py:small_cfg under OCC
SMALL = dict(batch_size=2, synth_table_size=64, req_per_query=2,
             query_pool_size=2, backoff=False, warmup_ticks=0,
             abort_penalty_ticks=1, cc_alg="OCC")


def passes_of(fn):
    """fn()'s result and the passes of OCC's fixed point it ran (read from
    the CPU pass counter)."""
    device_loop.reset_passes()
    out = fn()
    return out, int(device_loop.passes(tocc.LOOP_SITE, "cpu"))


def steps(kw, pool, chunks):
    """Both engines on one pool, run for each chunk of ticks in turn;
    yields the port's engine and state after each chunk, once the two are
    checked equal (summary, [summary], data, tables, txn slots and
    ``occ_wcommit``)."""
    jpool = JPool(**{f: getattr(pool, f) for f in t_pps.POOL_FIELDS})
    je = JEngine(JConfig(**kw), pool=jpool)
    te = TEngine(TConfig(**kw), pool=pool, device="cpu")
    js, ts = None, None
    for n in chunks:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the JAX gate's width fallback
            js = je.run(n, js)
        ts = te.run(n, ts)
        t_pps.assert_engine_parity(je, js, te, ts)
        np.testing.assert_array_equal(np.asarray(js.db["occ_wcommit"]),
                                      ts.db["occ_wcommit"].numpy())
        yield te, ts


def _pool(keys, iw, n_req=None):
    pool = t_engine._pool(keys, iw)
    if n_req is not None:
        pool.n_req = np.asarray(n_req, np.int32)
    return pool


# ---- (a) Occ.validate on random finishing sets and deep chains ----


def _validate_case(seed, n_rows, p_write, p_finish, depth, B=48, R=4):
    """Txn fields, a finishing mask, a wcommit table and a tick: random
    txns (distinct keys within a txn, distinct ts) over `n_rows` rows, of
    which the first `depth` form a chain on rows of their own (txn i reads
    the row txn i-1 writes, in ts order, all finishing)."""
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.choice(n_rows, R, replace=False)
                     for _ in range(B)]).astype(np.int32)
    iw = rng.random((B, R)) < p_write
    n_req = rng.integers(1, R + 1, B).astype(np.int32)
    ts = rng.permutation(10 * B)[:B].astype(np.int32) + 1
    finishing = rng.random(B) < p_finish
    tick = 50
    start = rng.integers(tick - 10, tick + 1, B).astype(np.int32)
    if depth:
        base = n_rows + 10
        keys[:depth, 0] = np.r_[base + depth, base + np.arange(depth - 1)]
        keys[:depth, 1] = base + np.arange(depth)
        iw[:depth] = [False, True] + [False] * (R - 2)
        n_req[:depth] = 2
        ts[:depth] = np.arange(depth) + 1
        ts[depth:] += depth
        finishing[:depth] = True
    wcommit = rng.integers(-1, tick, base + depth + 1 if depth else n_rows)
    wcommit[rng.random(wcommit.shape[0]) < 0.5] = -1
    wcommit[n_rows:] = -1          # no committed write on the chain's rows
    fields = dict(status=np.ones(B, np.int32), cursor=n_req.copy(), ts=ts,
                  pool_idx=np.zeros(B, np.int32),
                  restarts=np.zeros(B, np.int32),
                  backoff_until=np.zeros(B, np.int32), start_tick=start,
                  first_start_tick=start, keys=keys, is_write=iw,
                  n_req=n_req, txn_type=np.zeros(B, np.int32),
                  targs=np.zeros((B, 1), np.int32),
                  aux=np.zeros((B, R), np.int32))
    return fields, finishing, wcommit.astype(np.int32), tick


def _validate_both(fields, finishing, wcommit, tick, warmup=0):
    """Both plugins' validate on one input; the port's passes."""
    B, R = fields["keys"].shape
    n_rows = wcommit.shape[0]
    kw = dict(cc_alg="OCC", batch_size=B, req_per_query=R,
              synth_table_size=n_rows, warmup_ticks=warmup)
    jdb = {**jocc.Occ().init_db(JConfig(**kw), n_rows, B, R),
           "occ_wcommit": J(wcommit)}
    want, jdb = jocc.Occ().validate(
        JConfig(**kw), jdb, jstate.TxnState(**{k: J(v)
                                              for k, v in fields.items()}),
        J(finishing), jnp.int32(tick))
    tdb = {**tocc.Occ().init_db(TConfig(**kw), n_rows, B, R),
           "occ_wcommit": T(wcommit.copy())}
    (got, tdb), passes = passes_of(lambda: tocc.Occ().validate(
        TConfig(**kw), tdb, tstate.TxnState(**{k: T(np.array(v))
                                               for k, v in fields.items()}),
        T(finishing), torch.tensor(tick, dtype=torch.int32)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert sorted(jdb) == sorted(tdb)
    for k in jdb:
        np.testing.assert_array_equal(np.asarray(jdb[k]), tdb[k].numpy(),
                                      err_msg=k)
    return got.numpy(), passes


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       n_rows=st.sampled_from([6, 20, 200]),
       p_write=st.sampled_from([0.2, 0.5, 0.9]),
       p_finish=st.sampled_from([0.3, 0.8, 1.0]),
       depth=st.sampled_from([0, 0, 3, 9, 17, 30]))
def test_validate_matches_reference(seed, n_rows, p_write, p_finish, depth):
    fields, finishing, wcommit, tick = _validate_case(
        seed, n_rows, p_write, p_finish, depth)
    valid, passes = _validate_both(fields, finishing, wcommit, tick)
    assert not (valid & ~finishing).any()
    if depth:
        # the chain's own rows: it settles one txn per pass, and its txn
        # i validates iff i is even (txn 0 reads a row nobody wrote)
        assert passes >= depth
        np.testing.assert_array_equal(valid[:depth],
                                      np.arange(depth) % 2 == 0)


@pytest.mark.parametrize("n", [1, 5, 9, 40])
def test_chain_takes_one_pass_per_txn(n):
    # chain_pool's pool as one finishing set: n passes (the last confirms
    # the fixed point), the even txns valid; the warm-up gate holds the
    # counters at 0 before it ends
    kw, pool = tocc.chain_pool(n)
    fields = dict(status=np.ones(n, np.int32), cursor=pool.n_req.copy(),
                  ts=np.arange(n, dtype=np.int32) + 1,
                  pool_idx=np.zeros(n, np.int32),
                  restarts=np.zeros(n, np.int32),
                  backoff_until=np.zeros(n, np.int32),
                  start_tick=np.zeros(n, np.int32),
                  first_start_tick=np.zeros(n, np.int32), keys=pool.keys,
                  is_write=pool.is_write, n_req=pool.n_req,
                  txn_type=np.zeros(n, np.int32),
                  targs=np.zeros((n, 1), np.int32),
                  aux=np.zeros((n, 2), np.int32))
    wcommit = np.full(kw["synth_table_size"], -1, np.int32)
    valid, passes = _validate_both(fields, np.ones(n, bool), wcommit, 5,
                                   warmup=6)
    assert passes == n
    np.testing.assert_array_equal(valid, np.arange(n) % 2 == 0)


# ---- (b) the golden micro-schedules of tests/test_occ.py ----


def test_committed_write_in_window_aborts_reader():
    # tests/test_occ.py:12: txn1 commits its write of k5 at tick 2, after
    # txn0's start: txn0's validation at tick 3 fails the history check
    keys = np.array([[5, 1, 2], [5, 8, 8]], np.int32)
    iw = np.array([[False, False, False], [True, True, True]])
    kw = dict(SMALL, req_per_query=3)
    eng, st_ = next(steps(kw, _pool(keys, iw, [3, 2]), [4]))
    s = eng.summary(st_)
    assert s["txn_cnt"] == 1 and s["total_txn_abort_cnt"] == 1
    assert int(st_.txn.status[0]) == STATUS_BACKOFF
    assert s["occ_hist_abort_cnt"] == 1 and s["occ_active_abort_cnt"] == 0
    assert int(st_.db["occ_wcommit"][5]) == 2


def test_same_tick_writer_kills_later_reader():
    # tests/test_occ.py:28: both finish in one tick; the older writer
    # validates, the younger reader of its key does not
    keys = np.array([[5, 1], [5, 2]], np.int32)
    iw = np.array([[True, True], [False, False]])
    eng, st_ = next(steps(SMALL, _pool(keys, iw), [3]))
    s = eng.summary(st_)
    assert s["txn_cnt"] == 1 and int(st_.txn.status[1]) == STATUS_BACKOFF
    assert s["occ_active_abort_cnt"] == 1 and s["occ_hist_abort_cnt"] == 0


def test_same_tick_disjoint_writers_both_commit():
    # tests/test_occ.py:43: the younger writer of k5 follows only the
    # older txn's read of it
    keys = np.array([[5, 1], [5, 2]], np.int32)
    iw = np.array([[False, True], [True, True]])
    eng, st_ = next(steps(SMALL, _pool(keys, iw), [3]))
    assert eng.summary(st_)["txn_cnt"] == 2


def test_read_only_never_aborts():
    # tests/test_occ.py:57
    kw = dict(batch_size=32, synth_table_size=256, req_per_query=4,
              query_pool_size=256, zipf_theta=0.9, txn_read_perc=1.0,
              cc_alg="OCC", warmup_ticks=0)
    eng, st_ = next(steps(kw, ycsb.gen_query_pool(TConfig(**kw)), [30]))
    s = eng.summary(st_)
    assert s["total_txn_abort_cnt"] == 0 and s["txn_cnt"] > 0


@pytest.mark.parametrize("window", [1, 4])
def test_oracle_under_contention(window):
    # tests/test_occ.py:68: hot keys conflict, the increment oracle holds
    kw = dict(batch_size=64, synth_table_size=256, req_per_query=4,
              query_pool_size=512, zipf_theta=0.9, tup_read_perc=0.5,
              cc_alg="OCC", warmup_ticks=0, acquire_window=window)
    eng, st_ = next(steps(kw, ycsb.gen_query_pool(TConfig(**kw)), [60]))
    s = eng.summary(st_)
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    assert s["occ_hist_abort_cnt"] + s["occ_active_abort_cnt"] \
        == s["vabort_cnt"] == s["total_txn_abort_cnt"]


def test_duplicate_key_txns_terminate_and_commit():
    # tests/test_parity.py:270 under OCC: a txn touching one row twice
    # never conflicts with itself, and the fixed point terminates
    keys = np.array([[5, 5], [9, 9], [5, 9], [7, 8]], np.int32)
    kw = dict(cc_alg="OCC", batch_size=4, synth_table_size=64,
              req_per_query=2, query_pool_size=4, warmup_ticks=0)
    eng, st_ = next(steps(kw, _pool(keys, np.ones_like(keys, bool)), [10]))
    s = eng.summary(st_)
    assert s["txn_cnt"] > 0
    assert int(st_.data.sum()) == s["write_cnt"]


def test_forced_chain_in_the_engine():
    # chain_pool(40): every txn finishes in tick 2, the fixed point runs 40
    # passes there and 1 in each earlier tick, and 20 txns commit
    kw, pool = tocc.chain_pool(40)
    run = steps(kw, pool, [2, 1])
    _, passes = passes_of(lambda: next(run))
    assert passes == 2
    (eng, st_), passes = passes_of(lambda: next(run))
    s = eng.summary(st_)
    assert passes == 40
    assert s["txn_cnt"] == 20 and s["occ_active_abort_cnt"] == 20


# ---- (c) the engine on the three workloads, eager and run_compiled ----


def _kw(workload, fused):
    if workload == "ycsb":
        return dict(t_engine.CELLS["contended"][0], cc_alg="OCC",
                    fused_arbitrate=fused)
    if workload == "tpcc":
        # the fused case at B = 16 (its JAX side compiles the tick with
        # the Pallas kernel in interpret mode)
        return t_tpcc.tpcc_kw(cc_alg="OCC", fused_arbitrate=fused,
                              wh_update=True,
                              batch_size=16 if fused else 64)
    return t_pps.pps_kw(cc_alg="OCC", fused_arbitrate=fused,
                        batch_size=32 if fused else 64)


@functools.lru_cache(maxsize=None)
def _reference_run(workload, fused, n_ticks=40):
    """The JAX engine's run of 40 ticks on the workload's pool: the
    reference for the port's eager and compiled runs."""
    kw = _kw(workload, fused)
    cfg = TConfig(**kw)
    pool = wl_registry.get(cfg).gen_pool(cfg)
    je = JEngine(JConfig(**kw),
                 pool=JPool(**{f: getattr(pool, f)
                               for f in t_pps.POOL_FIELDS}))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pool, je, je.run(n_ticks)


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["eager", "compiled"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("workload", ["ycsb", "tpcc", "pps"])
def test_engine_matches_reference(workload, fused, compiled):
    pool, je, js = _reference_run(workload, fused)
    te = TEngine(TConfig(**_kw(workload, fused)), pool=pool, device="cpu")
    ts, passes = passes_of(
        lambda: (te.run_compiled if compiled else te.run)(40))
    s = t_pps.assert_engine_parity(je, js, te, ts)
    np.testing.assert_array_equal(np.asarray(js.db["occ_wcommit"]),
                                  ts.db["occ_wcommit"].numpy())
    assert s["txn_cnt"] > 0 and s["vabort_cnt"] > 0
    assert s["occ_hist_abort_cnt"] + s["occ_active_abort_cnt"] \
        == s["vabort_cnt"]
    assert passes > 40          # some tick settled a chain


# ---- (d) the sequential oracle ----


def test_abort_rate_parity_with_sequential_oracle():
    # tests/test_parity.py:test_abort_rate_parity's OCC cell
    from tests.test_parity import CFG, THRESH
    kw = dict(CFG, cc_alg="OCC")
    r = _oracle_divergence(kw, ycsb.gen_query_pool(TConfig(**kw)))
    assert r["abort_rate_divergence"] <= THRESH["OCC"], r
    assert 0.8 <= r["tput_ratio"] <= 1.25, r


def test_high_contention_parity_with_sequential_oracle():
    # tests/test_parity.py:test_occ_high_contention_exact (zipf 0.9)
    from tests.test_parity import CFG
    kw = dict(CFG, cc_alg="OCC", zipf_theta=0.9)
    r = _oracle_divergence(kw, ycsb.gen_query_pool(TConfig(**kw)))
    assert r["abort_rate_divergence"] <= 0.005, r
