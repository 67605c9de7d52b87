"""MAAT in the port (deneva_tpu_torch, device="cpu") against the JAX
package's MAAT plugin and engine, on the same inputs made with numpy from a
seed: ``Maat.validate`` on random finishing sets at chain windows 8 and 64
(past 16 validators a row reaches the pair masks that do not pack), on
hand-made chains of 4 to 80 txns (the commit chain run to its fixed point,
or stopped at 66 passes where the reference stops), the rebase rules, the
golden micro-schedules of tests/test_maat.py, the engine on YCSB, TPC-C
and PPS with ``fused_arbitrate`` off and on, eager and ``run_compiled``,
a run across a timestamp rebase, and the sequential oracle at
``PARITY_EXTRA``'s window of 64 (tests/test_parity.py).  Every comparison
is exact (all int32 and bool): summary (with the six ``maat_*``
counters), ``[summary]`` less its host keys, ``data``, every table, the
txn slots and ``maat_lr``, ``maat_lw``, ``maat_lower``, ``maat_upper``,
``maat_gw`` and ``maat_gr``."""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from deneva_tpu.cc import maat as jmaat  # noqa: E402
from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine import state as jstate  # noqa: E402
from deneva_tpu.engine.scheduler import Engine as JEngine  # noqa: E402
from deneva_tpu.workloads.base import QueryPool as JPool  # noqa: E402
from deneva_tpu_torch import workloads as wl_registry  # noqa: E402
from deneva_tpu_torch.cc import maat as tmaat  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine import state as tstate  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.ops import device_loop  # noqa: E402
from deneva_tpu_torch.workloads import ycsb  # noqa: E402
from tests import test_torch_engine as t_engine  # noqa: E402
from tests import test_torch_pps as t_pps  # noqa: E402
from tests import test_torch_tpcc as t_tpcc  # noqa: E402
from tests.test_torch_wait_die import _oracle_divergence  # noqa: E402

J, T = jnp.asarray, torch.from_numpy
BIG = 2**31 - 1
#: tests/test_engine_nowait.py:small_cfg under MAAT
SMALL = dict(batch_size=4, synth_table_size=64, req_per_query=2,
             query_pool_size=4, abort_penalty_ticks=1, backoff=False,
             warmup_ticks=0, cc_alg="MAAT")
MAAT_ARRAYS = ("maat_lr", "maat_lw", "maat_lower", "maat_upper", "maat_gw",
               "maat_gr")


def passes_of(fn):
    """fn()'s result and the passes of the commit chain it ran (read from
    the CPU pass counter)."""
    device_loop.reset_passes()
    out = fn()
    return out, int(device_loop.passes(tmaat.LOOP_SITE, "cpu"))


def assert_db_equal(jdb, tdb):
    assert sorted(jdb) == sorted(tdb)
    for k in jdb:
        np.testing.assert_array_equal(np.asarray(jdb[k]), tdb[k].numpy(),
                                      err_msg=k)


def steps(kw, pool, chunks, start=None):
    """Both engines on one pool (the timestamp counter at ``start``, if
    given), run for each chunk of ticks in turn; yields the port's engine
    and state after each chunk, once the two are checked equal (summary,
    [summary], data, tables, txn slots and every MAAT array)."""
    jpool = JPool(**{f: getattr(pool, f) for f in t_pps.POOL_FIELDS})
    je = JEngine(JConfig(**kw), pool=jpool)
    te = TEngine(TConfig(**kw), pool=pool, device="cpu")
    js, ts = je.init_state(), te.init_state()
    if start is not None:
        js = js._replace(ts_counter=jnp.int32(start))
        ts = ts._replace(ts_counter=torch.tensor(start, dtype=torch.int32))
    for n in chunks:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the JAX gate's width fallback
            js = je.run(n, js)
        ts = te.run(n, ts)
        t_pps.assert_engine_parity(je, js, te, ts)
        assert_db_equal(js.db, ts.db)
        yield te, ts


def _pool(keys, iw, n_req=None):
    pool = t_engine._pool(keys, iw)
    if n_req is not None:
        pool.n_req = np.asarray(n_req, np.int32)
    return pool


# ---- (a) Maat.validate on random finishing sets and chains ----


#: the row count of the random validation cases
TABLE = 256


def _validate_case(seed, n_rows, p_write, p_finish, B=48, R=4):
    """Txn fields, a finishing mask and a MAAT db: random txns (distinct
    keys within a txn, distinct ts, statuses of every kind, cursors inside
    the program) over `n_rows` of the TABLE rows, and random ranges and
    snapshots, some of them empty, 0 or open."""
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.choice(n_rows, R, replace=False)
                     for _ in range(B)]).astype(np.int32)
    iw = rng.random((B, R)) < p_write
    n_req = rng.integers(1, R + 1, B).astype(np.int32)
    status = rng.choice([0, 1, 1, 1, 2, 3], B).astype(np.int32)
    cursor = np.minimum(rng.integers(0, R + 2, B), n_req).astype(np.int32)
    finishing = (status == 1) & (cursor >= n_req) & (rng.random(B) < p_finish)
    ts = rng.permutation(10 * B)[:B].astype(np.int32) + 1
    start = rng.integers(0, 6, B).astype(np.int32)
    lower = rng.integers(0, 40, B).astype(np.int32)
    upper = np.where(rng.random(B) < 0.5, BIG,
                     lower + rng.integers(-3, 40, B)).astype(np.int32)
    upper[rng.random(B) < 0.1] = 0
    # one table size for every example, so the jitted reference compiles
    # once per window
    db = {"maat_lr": rng.integers(0, 30, TABLE).astype(np.int32),
          "maat_lw": rng.integers(0, 30, TABLE).astype(np.int32),
          "maat_lower": lower, "maat_upper": upper,
          "maat_gw": rng.integers(0, 30, B).astype(np.int32),
          "maat_gr": rng.integers(0, 30, B).astype(np.int32)}
    fields = dict(status=status, cursor=cursor, ts=ts,
                  pool_idx=np.zeros(B, np.int32),
                  restarts=np.zeros(B, np.int32),
                  backoff_until=np.zeros(B, np.int32), start_tick=start,
                  first_start_tick=start, keys=keys, is_write=iw,
                  n_req=n_req, txn_type=np.zeros(B, np.int32),
                  targs=np.zeros((B, 1), np.int32),
                  aux=np.zeros((B, R), np.int32))
    return fields, finishing, db


@functools.lru_cache(maxsize=None)
def _jax_validate(kw):
    """The JAX plugin's validate under `kw`, jitted once per config and
    shape (eagerly, its cond and while_loop compile on every call)."""
    import jax
    cfg = JConfig(**dict(kw))
    return jax.jit(lambda db, txn, fin, tick:
                   jmaat.Maat().validate(cfg, db, txn, fin, tick))


def _validate_both(fields, finishing, db, window=8, tick=50, warmup=0):
    """Both plugins' validate on one input: the port's verdicts and its
    chain's passes, once verdicts, every db array and counter are equal."""
    B, R = fields["keys"].shape
    n_rows = db["maat_lr"].shape[0]
    kw = dict(cc_alg="MAAT", batch_size=B, req_per_query=R,
              synth_table_size=n_rows, warmup_ticks=warmup,
              maat_chain_window=window)
    jdb = {**jmaat.Maat().init_db(JConfig(**kw), n_rows, B, R),
           **{k: J(v) for k, v in db.items()}}
    want, jdb = _jax_validate(tuple(sorted(kw.items())))(
        jdb, jstate.TxnState(**{k: J(v) for k, v in fields.items()}),
        J(finishing), jnp.int32(tick))
    tdb = {**tmaat.Maat().init_db(TConfig(**kw), n_rows, B, R),
           **{k: T(v.copy()) for k, v in db.items()}}
    (got, tdb), passes = passes_of(lambda: tmaat.Maat().validate(
        TConfig(**kw), tdb, tstate.TxnState(**{k: T(np.array(v))
                                               for k, v in fields.items()}),
        T(finishing), torch.tensor(tick, dtype=torch.int32)))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert_db_equal(jdb, tdb)
    return got.numpy(), passes


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       n_rows=st.sampled_from([4, 6, 20, 200]),
       p_write=st.sampled_from([0.2, 0.5, 0.9]),
       p_finish=st.sampled_from([0.3, 0.8, 1.0]))
@pytest.mark.parametrize("window", [8, 64])
def test_validate_matches_reference(window, seed, n_rows, p_write,
                                    p_finish):
    # on 4 or 6 rows, up to 48 validators share a row: at window 8 the
    # pair window overflows, at 64 distances past 15 use the far masks
    fields, finishing, db = _validate_case(seed, n_rows, p_write, p_finish)
    ok, passes = _validate_both(fields, finishing, db, window)
    assert not (ok & ~finishing).any()
    assert 1 <= passes <= tmaat.MAX_PASSES


def _chain_fields(n):
    """``chain_pool(n)``'s txns as one finishing set at tick 5, every
    access granted."""
    kw, pool = tmaat.chain_pool(n)
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
    rows = kw["synth_table_size"]
    db = {"maat_lr": np.zeros(rows, np.int32),
          "maat_lw": np.zeros(rows, np.int32),
          "maat_lower": np.zeros(n, np.int32),
          "maat_upper": np.full(n, BIG, np.int32),
          "maat_gw": np.zeros(n, np.int32), "maat_gr": np.zeros(n, np.int32)}
    return fields, db


@pytest.mark.parametrize("n", [4, 40, 80])
def test_chain_takes_one_pass_per_txn_up_to_the_bound(n):
    # each txn reads the row the one before writes: a validator's upper is
    # capped under its ok predecessor's lower, which empties its range, so
    # the verdicts alternate down the chain, one txn settled per pass.
    # Past 66 txns the chain stops at 66 passes, where the reference stops
    # (its verdicts then are those of pass 66)
    fields, db = _chain_fields(n)
    ok, passes = _validate_both(fields, np.ones(n, bool), db, tick=5,
                                warmup=6)
    assert passes == min(n, tmaat.MAX_PASSES)
    if n <= tmaat.MAX_PASSES:
        np.testing.assert_array_equal(ok, np.arange(n) % 2 == 0)


def test_never_settling_step_stops_at_the_bound():
    # the chain's flag on a step that always changes something: the host
    # loop ends after exactly MAX_PASSES passes; with no row of two
    # validators, after one
    for needed, want in ((True, tmaat.MAX_PASSES), (False, 1)):
        passes = torch.zeros((), dtype=torch.int32)

        def step():
            passes.add_(1)
            return tmaat.flag(torch.tensor(needed), passes,
                              torch.tensor(True))

        _, counted = passes_of(
            lambda: device_loop.run_while(step, tmaat.LOOP_SITE, "cpu"))
        assert int(passes) == counted == want


EDGE = [0, 1, 2, 2**30 - 1, 2**30, 2**30 + 1, 2**30 + 2, BIG]


@pytest.mark.parametrize("shift", [0, 1, 2**30])
def test_rebase_matches_reference(shift):
    # the six arrays with edge values, uppers of 0 among them: at a shift
    # above 0 as the reference shifts them; at 0 (a tick that does not
    # rebase) unchanged, where the reference's upper rule would turn 0
    # into 1 (the reference never calls it with 0)
    rng = np.random.default_rng(shift % 97)
    vals = np.array(EDGE + list(rng.integers(0, 2**31, 56)), np.int32)
    db = {k: np.roll(vals, 7 * i) for i, k in enumerate(MAAT_ARRAYS)}
    tdb = {k: T(v.copy()) for k, v in db.items()}
    ptrs = {k: v.data_ptr() for k, v in tdb.items()}
    out = tmaat.Maat().on_ts_rebase(None, tdb, torch.tensor(shift))
    assert {k: out[k].data_ptr() for k in MAAT_ARRAYS} == ptrs   # in place
    if shift:
        want = jmaat.Maat().on_ts_rebase(None, {k: J(v) for k, v in
                                                db.items()}, shift)
        assert_db_equal(want, out)
    else:
        assert (db["maat_upper"] == 0).any()
        assert_db_equal(db, out)


# ---- (b) the golden micro-schedules of tests/test_maat.py ----


def test_disjoint_txns_commit_with_full_ranges():
    keys = np.arange(8, dtype=np.int32).reshape(4, 2)
    eng, st_ = next(steps(SMALL, _pool(keys, np.ones((4, 2), bool)), [4]))
    s = eng.summary(st_)
    assert s["txn_cnt"] == 4 and s["total_txn_abort_cnt"] == 0


def test_rw_overlap_both_commit_with_adjusted_ranges():
    # the reader and the writer of k5 both commit, ordered by their ranges
    keys = np.array([[5, 1], [5, 2]], np.int32)
    iw = np.array([[False, False], [True, True]])
    kw = dict(SMALL, batch_size=2, query_pool_size=2)
    eng, st_ = next(steps(kw, _pool(keys, iw), [4]))
    s = eng.summary(st_)
    assert s["txn_cnt"] == 2 and s["total_txn_abort_cnt"] == 0


def test_read_after_commit_serializes_after():
    # case 1: a reader that saw the writer's lw gets a lower above it
    keys = np.array([[5, 8], [5, 9]], np.int32)
    iw = np.array([[True, True], [False, False]])
    kw = dict(SMALL, batch_size=2, query_pool_size=2)
    eng, st_ = next(steps(kw, _pool(keys, iw, [2, 2]), [6]))
    assert eng.summary(st_)["txn_cnt"] >= 2
    assert int(st_.db["maat_lw"][5]) >= 1


def test_squeezed_to_empty_range_aborts():
    kw = dict(batch_size=64, synth_table_size=128, req_per_query=4,
              query_pool_size=512, zipf_theta=0.9, tup_read_perc=0.5,
              cc_alg="MAAT", warmup_ticks=0)
    eng, st_ = next(steps(kw, ycsb.gen_query_pool(TConfig(**kw)), [60]))
    s = eng.summary(st_)
    assert s["txn_cnt"] > 0 and s["maat_range_abort_cnt"] > 0
    assert s["vabort_cnt"] == s["maat_range_abort_cnt"] \
        == s["total_txn_abort_cnt"]


def test_single_key_writers_serialize():
    # one segment holds every entry: the pair windows must not wrap
    keys = np.full((4, 1), 5, np.int32)
    kw = dict(SMALL, req_per_query=1, batch_size=4, query_pool_size=4)
    eng, st_ = next(steps(kw, _pool(keys, np.ones((4, 1), bool)), [8]))
    s = eng.summary(st_)
    assert int(st_.data[5]) == s["txn_cnt"]
    assert s["vabort_cnt"] > 0 and s["maat_chain_cap_cnt"] > 0
    assert s["maat_chain_overflow_cnt"] == 0


@pytest.mark.parametrize("caa", [False, True],
                         ids=["commit_first", "commit_after_access"])
def test_duplicate_key_txns_terminate_and_commit(caa):
    # tests/test_parity.py:270 under MAAT: a txn touching one row twice
    # never conflicts with itself, and the commit chain ends; in either
    # order of the tick's commit and access blocks
    keys = np.array([[5, 5], [9, 9], [5, 9], [7, 8]], np.int32)
    kw = dict(cc_alg="MAAT", batch_size=4, synth_table_size=64,
              req_per_query=2, query_pool_size=4, warmup_ticks=0,
              commit_after_access=caa)
    eng, st_ = next(steps(kw, _pool(keys, np.ones_like(keys, bool)), [10]))
    s = eng.summary(st_)
    assert s["txn_cnt"] > 0
    assert int(st_.data.sum()) == s["write_cnt"]


def test_oracle_under_contention():
    # tests/test_maat.py:test_oracle_and_better_than_nowait_commit_rate
    # at window 1: the increment oracle holds
    kw = dict(batch_size=64, synth_table_size=256, req_per_query=4,
              query_pool_size=512, zipf_theta=0.9, tup_read_perc=0.7,
              warmup_ticks=0, acquire_window=1, cc_alg="MAAT")
    eng, st_ = next(steps(kw, ycsb.gen_query_pool(TConfig(**kw)), [50]))
    s = eng.summary(st_)
    assert int(st_.data.sum()) == s["write_cnt"] and s["txn_cnt"] > 0


def test_forced_chain_in_the_engine():
    # chain_pool(80): every txn finishes in tick 2, where the chain stops
    # at the bound of 66 passes (1 in each earlier tick), unsettled: 47
    # commits where the fixed point would have 40
    kw, pool = tmaat.chain_pool(80)
    run = steps(kw, pool, [2, 1])
    _, passes = passes_of(lambda: next(run))
    assert passes == 2
    (eng, st_), passes = passes_of(lambda: next(run))
    assert passes == tmaat.MAX_PASSES
    s = eng.summary(st_)
    assert s["txn_cnt"] == 47 and s["vabort_cnt"] == 33


# ---- (c) the engine on the three workloads, eager and run_compiled ----


def _kw(workload, fused):
    if workload == "ycsb":
        return dict(t_engine.CELLS["contended"][0], cc_alg="MAAT",
                    fused_arbitrate=fused)
    if workload == "tpcc":
        # the fused case at B = 16 (its JAX side compiles the tick with
        # the Pallas kernel in interpret mode)
        return t_tpcc.tpcc_kw(cc_alg="MAAT", fused_arbitrate=fused,
                              wh_update=True,
                              batch_size=16 if fused else 64)
    return t_pps.pps_kw(cc_alg="MAAT", fused_arbitrate=fused,
                        batch_size=32 if fused else 64)


@functools.lru_cache(maxsize=None)
def _reference_run(workload, fused, n_ticks=40):
    """The JAX engine's run of 40 ticks on the workload's pool, one tick
    per call: the reference for the port's eager and compiled runs, and
    the committers per tick whose commit ts (final lower) ties with
    another's, summed over the ticks."""
    from deneva_tpu.workloads.tpcc import TA_RBK
    kw = _kw(workload, fused)
    cfg = TConfig(**kw)
    pool = wl_registry.get(cfg).gen_pool(cfg)
    je = JEngine(JConfig(**kw),
                 pool=JPool(**{f: getattr(pool, f)
                               for f in t_pps.POOL_FIELDS}))
    js, tied = je.init_state(), 0
    for _ in range(n_ticks):
        prev = np.asarray(js.txn.status)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            js = je.run(1, js)
        done = (prev == 1) & (np.asarray(js.txn.status) == 0)
        if workload == "tpcc":               # less its rollbacks
            done &= np.asarray(js.txn.targs)[:, TA_RBK] != 1
        lo = np.asarray(js.db["maat_lower"])[done]
        tied += lo.size - np.unique(lo).size
    return pool, je, js, tied


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["eager", "compiled"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("workload", ["ycsb", "tpcc", "pps"])
def test_engine_matches_reference(workload, fused, compiled):
    pool, je, js, _ = _reference_run(workload, fused)
    te = TEngine(TConfig(**_kw(workload, fused)), pool=pool, device="cpu")
    ts, passes = passes_of(
        lambda: (te.run_compiled if compiled else te.run)(40))
    s = t_pps.assert_engine_parity(je, js, te, ts)
    assert_db_equal(js.db, ts.db)
    assert s["txn_cnt"] > 0 and s["vabort_cnt"] > 0
    assert s["vabort_cnt"] == s["maat_range_abort_cnt"]
    assert passes > 40          # some tick ran the chain


@pytest.mark.parametrize("workload", ["tpcc", "pps"])
def test_effect_order_by_tied_commit_ts(workload):
    # MAAT's commit ts (the final lower) ties across txns of one tick; the
    # effects' sorts are stable in both engines, so tied committers apply
    # in lane order: TPC-C's ring appends and PPS's USES last-writer-wins
    pool, je, js, tied = _reference_run(workload, False)
    assert tied > 0
    te = TEngine(TConfig(**_kw(workload, False)), pool=pool, device="cpu")
    ts = te.run(40)
    t_pps.assert_engine_parity(je, js, te, ts)
    assert_db_equal(js.db, ts.db)


def test_engine_matches_reference_across_ts_rebase():
    # the timestamp counter starts just below the rebase threshold
    # (3 * 2^29) and crosses it mid-run: txn timestamps, the rows' lr/lw
    # and the slots' snapshots and ranges shift down by 2^30 on that tick
    # only; uppers of 0 are in the state on the ticks before it
    kw = dict(t_engine.CELLS["contended"][0], cc_alg="MAAT")
    pool = ycsb.gen_query_pool(TConfig(**kw))
    zeros = 0
    for _, ts in steps(kw, pool, [5] * 8, start=(3 << 29) - 200):
        if int(ts.ts_counter) > 1 << 30:
            zeros += int((ts.db["maat_upper"] == 0).sum())
    assert zeros > 0
    assert int(ts.ts_counter) < 1 << 30          # it rebased
    assert (ts.db["maat_lw"] > 0).any()


# ---- (d) the sequential oracle ----


def test_abort_rate_parity_with_sequential_oracle():
    # tests/test_parity.py:test_abort_rate_parity's MAAT cell, at
    # PARITY_EXTRA's chain window of 64
    from deneva_tpu.oracle.parity import PARITY_EXTRA
    from tests.test_parity import CFG, THRESH
    kw = dict(CFG, cc_alg="MAAT", **PARITY_EXTRA["MAAT"])
    r = _oracle_divergence(kw, ycsb.gen_query_pool(TConfig(**kw)))
    assert r["abort_rate_divergence"] <= THRESH["MAAT"], r
    assert 0.8 <= r["tput_ratio"] <= 1.25, r
