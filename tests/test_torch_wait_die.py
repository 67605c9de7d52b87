"""WAIT_DIE in the port (deneva_tpu_torch, device="cpu"): the golden
micro-schedules of tests/test_wait_die.py (row_lock.cpp:91-151: older txns
wait for younger holders, younger txns die), each also held to the JAX
engine; the whole engine against the JAX engine on small YCSB, TPC-C and
PPS configs, and across a timestamp rebase; and the abort rate against
the numpy sequential oracle within tests/test_parity.py's WAIT_DIE
thresholds.  Every engine comparison is exact."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine.scheduler import Engine as JEngine  # noqa: E402
from deneva_tpu.workloads.base import QueryPool as JPool  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.engine.state import (  # noqa: E402
    STATUS_BACKOFF, STATUS_WAITING,
)
from deneva_tpu_torch.workloads import ycsb  # noqa: E402
from tests import test_torch_engine as t_engine  # noqa: E402
from tests import test_torch_pps as t_pps  # noqa: E402
from tests import test_torch_tpcc as t_tpcc  # noqa: E402

WD_SMALL = dict(t_engine.SMALL, batch_size=2, query_pool_size=2,
                cc_alg="WAIT_DIE")


def steps(kw, pool, chunks):
    """Both engines on one pool, run for each chunk of ticks in turn; yields
    the port's engine and state after each chunk, once the two engines'
    states are checked equal."""
    jpool = JPool(**{f: getattr(pool, f) for f in t_pps.POOL_FIELDS})
    je = JEngine(JConfig(**kw), pool=jpool)
    te = TEngine(TConfig(**kw), pool=pool, device="cpu")
    js, ts = None, None
    for n in chunks:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            js = je.run(n, js)
        ts = te.run(n, ts)
        t_engine._assert_parity(je, js, te, ts)
        yield te, ts


# ---- twins of tests/test_wait_die.py ----


def test_older_waits_for_younger_holder():
    # txn0 (older): [k1, k5]; txn1 (younger): [k5, k2], all writes.
    # tick0: txn0 takes k1, txn1 takes k5.  tick1: txn0 wants k5 (held by
    # the younger txn1) -> WAIT; txn1 takes k2.  tick2: txn1 commits,
    # releasing k5, and txn0 takes it in the same tick.
    pool = t_engine._pool([[1, 5], [5, 2]], np.ones((2, 2), bool))
    run = steps(WD_SMALL, pool, [2, 1, 1])
    eng, st = next(run)
    assert int(st.txn.status[0]) == STATUS_WAITING
    assert st.txn.cursor.tolist() == [1, 2]
    eng, st = next(run)
    s = eng.summary(st)
    assert s["txn_cnt"] == 1
    assert int(st.txn.cursor[0]) == 2
    assert s["total_txn_abort_cnt"] == 0
    assert s["twopl_wait_cnt"] == 1 and s["lat_cc_block_time"] == 1
    eng, st = next(run)
    assert eng.summary(st)["txn_cnt"] == 2


def test_younger_dies_on_older_holder():
    # txn0 (older): [k5, k1]; txn1 (younger): [k2, k5].  tick1: txn1 wants
    # k5, held by the OLDER txn0 -> die
    pool = t_engine._pool([[5, 1], [2, 5]], np.ones((2, 2), bool))
    eng, st = next(steps(WD_SMALL, pool, [2]))
    assert int(st.txn.status[1]) == STATUS_BACKOFF
    assert int(st.txn.restarts[1]) == 1
    assert eng.summary(st)["total_txn_abort_cnt"] == 1


def test_same_tick_ww_younger_dies():
    # both request k5 first in the same tick: the older (slot 0) wins, the
    # younger conflicts with an older granted owner -> die
    pool = t_engine._pool([[5, 1], [5, 2]], np.ones((2, 2), bool))
    eng, st = next(steps(WD_SMALL, pool, [1]))
    assert int(st.txn.cursor[0]) == 1
    assert int(st.txn.status[1]) == STATUS_BACKOFF


def test_ts_kept_across_restart():
    # WAIT_DIE assigns its timestamp once, at first start
    # (worker_thread.cpp:478-480): a restart keeps it
    pool = t_engine._pool([[5, 1], [5, 2]], np.ones((2, 2), bool))
    run = steps(dict(WD_SMALL, abort_penalty_ticks=1), pool, [1, 3])
    _, st = next(run)
    ts_before = int(st.txn.ts[1])
    _, st = next(run)
    assert int(st.txn.restarts[1]) >= 1
    assert int(st.txn.ts[1]) == ts_before


def test_no_deadlock_and_oracle_under_contention():
    kw = dict(batch_size=64, synth_table_size=256, req_per_query=4,
              query_pool_size=512, zipf_theta=0.9, tup_read_perc=0.5,
              cc_alg="WAIT_DIE", warmup_ticks=0)
    pool = ycsb.gen_query_pool(TConfig(**kw))
    eng, st = next(steps(kw, pool, [60]))
    s = eng.summary(st)
    assert s["txn_cnt"] > 0
    assert s["twopl_wait_cnt"] > 0      # waits must actually happen
    assert int(st.data.sum()) == s["write_cnt"]


# ---- the engine against the JAX engine on the three workloads ----


def _assert_waited(s):
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    assert s["twopl_wait_cnt"] > 0 and s["lat_cc_block_time"] > 0


@pytest.mark.parametrize("fused", [False, True])
def test_ycsb_engine_matches_reference(fused):
    kw, n_ticks = t_engine.CELLS["contended"]
    kw = dict(kw, cc_alg="WAIT_DIE", fused_arbitrate=fused)
    _assert_waited(t_engine._assert_parity(*t_engine._run_both(kw, n_ticks)))


def test_tpcc_engine_matches_reference():
    kw = t_tpcc.tpcc_kw(cc_alg="WAIT_DIE", num_wh=16)
    _assert_waited(t_tpcc._assert_engine_parity(*t_tpcc._run_both(kw, 60)))


@pytest.mark.parametrize("fused", [False, True])
def test_pps_engine_matches_reference(fused):
    kw = t_pps.pps_kw(cc_alg="WAIT_DIE", fused_arbitrate=fused)
    _assert_waited(t_pps.assert_engine_parity(*t_pps.run_both(kw, 60)))


def test_engine_matches_reference_across_ts_rebase():
    # the timestamp counter starts just below the rebase threshold
    # (3 * 2^29): timestamps kept across restarts are shifted down by 2^30
    # with the reference's clamp at 1, mid-run
    kw, _ = t_engine.CELLS["contended"]
    kw = dict(kw, cc_alg="WAIT_DIE")
    pool = ycsb.gen_query_pool(TConfig(**kw))
    jpool = JPool(**{f: getattr(pool, f) for f in t_pps.POOL_FIELDS})
    je = JEngine(JConfig(**kw), pool=jpool)
    te = TEngine(TConfig(**kw), pool=pool, device="cpu")
    start = (3 << 29) - 60
    js = je.init_state()._replace(ts_counter=jnp.int32(start))
    ts = te.init_state()._replace(
        ts_counter=torch.tensor(start, dtype=torch.int32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = je.run(40, js)
    ts = te.run(40, ts)
    _assert_waited(t_engine._assert_parity(je, js, te, ts))
    assert int(ts.ts_counter) < 1 << 30          # it rebased


# ---- abort rate against the sequential oracle ----


def _oracle_divergence(kw, pool, n_ticks=50):
    from deneva_tpu.oracle.parity import _pair_dict
    from deneva_tpu.oracle.sequential import SequentialEngine
    te = TEngine(TConfig(**kw), pool=pool, device="cpu")
    ts = te.run(n_ticks)
    jpool = JPool(**{f: getattr(pool, f) for f in t_pps.POOL_FIELDS})
    seq = SequentialEngine(JConfig(**kw), pool=jpool).run(n_ticks)
    r = _pair_dict(JConfig(**kw), te.summary(ts), int(ts.data.sum()), seq)
    assert r["batched_conserved"] and r["sequential_conserved"], r
    return r


def test_abort_rate_parity_with_sequential_oracle():
    # tests/test_parity.py:test_abort_rate_parity's WAIT_DIE cell
    from tests.test_parity import CFG, THRESH
    kw = dict(CFG, cc_alg="WAIT_DIE")
    r = _oracle_divergence(kw, ycsb.gen_query_pool(TConfig(**kw)))
    assert r["abort_rate_divergence"] <= THRESH["WAIT_DIE"], r
    assert 0.8 <= r["tput_ratio"] <= 1.25, r


def test_pps_abort_rate_parity_with_sequential_oracle():
    # tests/test_parity.py:test_pps_parity's WAIT_DIE cell
    from deneva_tpu_torch.workloads import pps
    from tests.test_parity import PPS_THRESH
    kw = dict(workload="PPS", cc_alg="WAIT_DIE", batch_size=64,
              query_pool_size=1 << 10, warmup_ticks=0, synth_table_size=8,
              max_part_key=256, max_product_key=256, max_supplier_key=256)
    r = _oracle_divergence(kw, pps.PPSWorkload().gen_pool(TConfig(**kw)))
    assert r["abort_rate_divergence"] <= PPS_THRESH["WAIT_DIE"], r
