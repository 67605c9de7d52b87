"""CALVIN in the port (deneva_tpu_torch, device="cpu") against the JAX
package's CALVIN plugin and engine, on the same inputs made with numpy
from a seed: the FIFO arbitration on random entry packs, the golden
schedules of tests/test_calvin.py (the conflict chain, write-write FIFO
order, shared reads behind a blocking write, zero aborts under extreme
contention, the deterministic schedule, the epoch gate, the sequential
outcome), the engine on YCSB, TPC-C and PPS with ``fused_arbitrate`` off
and on (PPS with its reconnaissance deferral, and with an epoch gate that
binds while recon txns resume), and the sequential oracle at CALVIN's
threshold of 0.0, with ``tput_ratio == 1.0`` on PPS.  Every comparison is
exact (all int32 and bool): summary, ``[summary]`` less its host keys,
``data``, every table and the txn slots.  ``run_compiled`` under CALVIN
is held to the reference in tests/test_torch_compiled.py."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

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
from deneva_tpu_torch.engine.state import (  # noqa: E402
    STATUS_BACKOFF, STATUS_WAITING,
)
from deneva_tpu_torch.workloads import pps, ycsb  # noqa: E402
from tests import test_torch_engine as t_engine  # noqa: E402
from tests import test_torch_pps as t_pps  # noqa: E402
from tests import test_torch_tpcc as t_tpcc  # noqa: E402
from tests.test_torch_wait_die import _oracle_divergence  # noqa: E402

#: tests/test_calvin.py:calvin_cfg
SMALL = dict(batch_size=4, synth_table_size=64, req_per_query=2,
             query_pool_size=4, backoff=False, warmup_ticks=0,
             cc_alg="CALVIN")
#: a contended YCSB config (B*R = 256 lanes: with fused_arbitrate the JAX
#: side runs its Pallas kernel in interpret mode)
CONTENDED = dict(t_engine.CELLS["contended"][0], cc_alg="CALVIN")


def steps(kw, pool, chunks):
    """Both engines on one pool, run for each chunk of ticks in turn;
    yields the port's engine and state after each chunk, once the two
    are checked equal (summary, [summary], data, tables, txn slots)."""
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
        yield te, ts


def _assert_no_abort(s):
    assert s["txn_cnt"] > 0
    assert s["total_txn_abort_cnt"] == 0 and s["unique_txn_abort_cnt"] == 0


# ---- (a) the FIFO arbitration on random entry packs ----


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1),
       n_rows=st.sampled_from([6, 12, 40]),
       p_write=st.sampled_from([0.1, 0.5, 0.9]))
def test_arbitrate_matches_reference(seed, n_rows, p_write):
    # every access of an active txn is held (before its cursor) or
    # requested (request_all: the window is R); one entry shape, so the
    # JAX side compiles once
    d = t_engine._random_txns(seed, B=48, R=5, n_rows=n_rows)
    rng = np.random.default_rng(seed)
    d["is_write"] = rng.random(d["keys"].shape) < p_write
    jent = jstate.make_entries(t_engine._txn(jstate, jnp.asarray, d),
                               jnp.asarray(d["active"]), window=5)
    tent = tstate.make_entries(t_engine._txn(tstate, torch.from_numpy, d),
                               torch.from_numpy(d["active"]), window=5)
    want = jtwopl.arbitrate(jent, "CALVIN")
    got = ttwopl.arbitrate(tent, "CALVIN")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    grant, wait, abort = got
    assert not abort.any()
    assert torch.equal(grant | wait, tent.req)


def test_arbitrate_fifo_rules():
    # one row, entries in ts order: a held read, a requested read, a
    # requested write, a requested read.  FIFO: the second read shares,
    # the write waits (not at the head), and the read behind the waiting
    # write waits too (under NO_WAIT the write aborts and the read grants)
    ent = tstate.Entries(
        key=torch.tensor([3, 3, 3, 3], dtype=torch.int32),
        txn=torch.arange(4, dtype=torch.int32),
        ridx=torch.zeros(4, dtype=torch.int32),
        ts=torch.tensor([1, 2, 3, 4], dtype=torch.int32),
        is_write=torch.tensor([False, False, True, False]),
        held=torch.tensor([True, False, False, False]),
        req=torch.tensor([False, True, True, True]))
    grant, wait, abort = ttwopl.arbitrate(ent, "CALVIN")
    assert grant.tolist() == [False, True, False, False]
    assert wait.tolist() == [False, False, True, True]
    assert not abort.any()
    grant, _, abort = ttwopl.arbitrate(ent, "NO_WAIT")
    assert grant.tolist() == [False, True, False, True]
    assert abort.tolist() == [False, False, True, False]


# ---- (b) the golden schedules of tests/test_calvin.py ----


def test_golden_conflict_chain_schedule():
    # tests/test_calvin.py:37: chain T0 -w1- T1 -w2- T2, T3 independent
    keys = np.array([[0, 1], [1, 2], [2, 3], [4, 5]], np.int32)
    keys = np.vstack([keys, np.arange(10, 26, dtype=np.int32).reshape(8, 2)])
    pool = t_engine._pool(keys, np.ones_like(keys, bool))
    run = steps(dict(SMALL, query_pool_size=12), pool, [1, 1, 1, 1])
    eng, s_ = next(run)
    assert s_.txn.cursor.tolist() == [2, 0, 0, 2]
    assert s_.txn.status[1:3].tolist() == [STATUS_WAITING] * 2
    eng, s_ = next(run)
    assert eng.summary(s_)["txn_cnt"] == 2
    assert int(s_.txn.cursor[1]) == 2
    assert int(s_.txn.status[2]) == STATUS_WAITING
    eng, s_ = next(run)
    assert eng.summary(s_)["txn_cnt"] == 3
    assert int(s_.txn.cursor[2]) == 2
    eng, s_ = next(run)
    s = eng.summary(s_)
    assert s["txn_cnt"] == 6 and s["total_txn_abort_cnt"] == 0
    assert s_.data[:6].tolist() == [1, 2, 2, 1, 1, 1]


def test_write_write_fifo_order():
    # tests/test_calvin.py:81: the smaller sequence number grants first;
    # the other waits, never aborts, and commits right after
    keys = np.array([[7, 1], [7, 2], [20, 21], [22, 23]], np.int32)
    pool = t_engine._pool(keys, np.ones_like(keys, bool))
    run = steps(SMALL, pool, [1, 5])
    _, s_ = next(run)
    assert int(s_.txn.cursor[0]) == 2
    assert int(s_.txn.status[1]) == STATUS_WAITING
    assert int(s_.txn.restarts[1]) == 0
    eng, s_ = next(run)
    assert eng.summary(s_)["total_txn_abort_cnt"] == 0


def test_read_shares_write_blocks():
    # tests/test_calvin.py:98: two reads of row 5 grant, the write behind
    # them waits
    keys = np.array([[5, 1], [5, 2], [5, 3], [8, 9]], np.int32)
    iw = np.array([[False, False], [False, False], [True, True],
                   [False, False]])
    _, s_ = next(steps(SMALL, t_engine._pool(keys, iw), [1]))
    assert s_.txn.cursor[:2].tolist() == [2, 2]
    assert int(s_.txn.status[2]) == STATUS_WAITING


def test_zero_abort_under_extreme_contention():
    # tests/test_calvin.py:112: zipf 0.99 on 256 rows
    kw = dict(cc_alg="CALVIN", batch_size=64, synth_table_size=256,
              req_per_query=4, query_pool_size=512, zipf_theta=0.99,
              tup_read_perc=0.5, warmup_ticks=0)
    eng, s_ = next(steps(kw, ycsb.gen_query_pool(TConfig(**kw)), [40]))
    s = eng.summary(s_)
    _assert_no_abort(s)
    assert s["twopl_wait_cnt"] > 0


def test_deterministic_schedule():
    # tests/test_calvin.py:127: two runs of one pool are bit-identical
    kw = dict(cc_alg="CALVIN", batch_size=32, synth_table_size=128,
              req_per_query=3, query_pool_size=128, zipf_theta=0.9,
              warmup_ticks=0)
    pool = ycsb.gen_query_pool(TConfig(**kw))
    runs = [next(steps(kw, pool, [25])) for _ in range(2)]
    (e0, s0), (e1, s1) = runs
    assert e0.summary(s0) == e1.summary(s1)
    assert torch.equal(s0.data, s1.data)


def test_epoch_size_gates_admission():
    # tests/test_calvin.py:141: epoch_size 2 admits 2 txns per tick
    keys = np.arange(16, dtype=np.int32).reshape(8, 2)
    pool = t_engine._pool(keys, np.ones_like(keys, bool))
    run = steps(dict(SMALL, query_pool_size=8, seq_batch_size=2), pool,
                [1, 1])
    eng, s_ = next(run)
    assert eng.summary(s_)["local_txn_start_cnt"] == 2
    eng, s_ = next(run)
    assert eng.summary(s_)["local_txn_start_cnt"] == 4


def test_matches_sequential_outcome():
    # tests/test_calvin.py:153
    kw = dict(cc_alg="CALVIN", batch_size=16, synth_table_size=64,
              req_per_query=2, query_pool_size=64, zipf_theta=0.8,
              warmup_ticks=0)
    eng, s_ = next(steps(kw, ycsb.gen_query_pool(TConfig(**kw)), [60]))
    _assert_no_abort(eng.summary(s_))


# ---- (c) the engine on the three workloads ----


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_ycsb_engine_matches_reference(fused):
    jfused.reset_fallbacks()
    kw = dict(CONTENDED, fused_arbitrate=fused)
    eng, s_ = next(steps(kw, ycsb.gen_query_pool(TConfig(**kw)),
                         [t_engine.CELLS["contended"][1]]))
    s = eng.summary(s_)
    _assert_no_abort(s)
    assert s["twopl_wait_cnt"] > 0
    if fused:
        # the reference really ran its Pallas kernel, never lax.sort
        assert jfused.fallback_snapshot()["count"] == 0


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_tpcc_engine_matches_reference(fused):
    # Payments queue FIFO on the warehouse rows; the fused case at B = 16
    # (its JAX side compiles the tick with the Pallas kernel in interpret
    # mode)
    kw = t_tpcc.tpcc_kw(cc_alg="CALVIN", fused_arbitrate=fused, wh_update=True,
                        batch_size=16 if fused else 64)
    je, js, te, ts = t_tpcc._run_both(kw, 40 if fused else 60)
    s = t_tpcc._assert_engine_parity(je, js, te, ts)
    _assert_no_abort(s)
    assert s["twopl_wait_cnt"] > 0


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_pps_engine_matches_reference(fused):
    # the recon types sleep one epoch after admission while their shadow
    # read requests take part in the arbitration; the fused case at B = 32
    kw = t_pps.pps_kw(cc_alg="CALVIN", fused_arbitrate=fused,
                      batch_size=32 if fused else 64)
    pool = pps.PPSWorkload().gen_pool(TConfig(**kw))
    run = steps(kw, pool, [1, 59])
    eng, s_ = next(run)
    recon = np.isin(s_.txn.txn_type.numpy(), pps.PPSWorkload.recon_types)
    # after the first tick: every recon admission sleeps, at cursor 0,
    # until tick 1, and counts once
    assert recon.any() and eng.summary(s_)["recon_cnt"] == recon.sum()
    assert (s_.txn.status.numpy()[recon] == STATUS_BACKOFF).all()
    assert (s_.txn.cursor.numpy()[recon] == 0).all()
    assert (s_.txn.backoff_until.numpy()[recon] == 1).all()
    eng, s_ = next(run)
    s = eng.summary(s_)
    _assert_no_abort(s)
    assert s["recon_cnt"] > recon.sum() and s["twopl_wait_cnt"] > 0


def test_pps_epoch_gate_counts_resumed_recon_txns():
    # an epoch of 12 txns: recon txns resuming from their deferral take
    # their share of it, so fewer fresh txns are admitted in those ticks,
    # while the admitted ranks still map onto consecutive pool rows
    kw = t_pps.pps_kw(cc_alg="CALVIN", seq_batch_size=12)
    pool = pps.PPSWorkload().gen_pool(TConfig(**kw))
    starts = []
    for eng, s_ in steps(kw, pool, [1] * 12):
        starts.append(eng.summary(s_)["local_txn_start_cnt"])
    per_tick = np.diff([0] + starts)
    assert per_tick.max() == 12 and per_tick.min() < 12, per_tick
    s = eng.summary(s_)
    assert s["recon_cnt"] > 0 and s["txn_cnt"] > 0


# ---- (d) parity with the sequential oracle ----


def test_abort_rate_parity_with_sequential_oracle():
    # tests/test_parity.py:test_abort_rate_parity's CALVIN cell
    from tests.test_parity import CFG, THRESH
    kw = dict(CFG, cc_alg="CALVIN")
    r = _oracle_divergence(kw, ycsb.gen_query_pool(TConfig(**kw)))
    assert r["abort_rate_divergence"] <= THRESH["CALVIN"], r
    assert 0.8 <= r["tput_ratio"] <= 1.25, r


def test_calvin_pps_recon_parity():
    # tests/test_parity.py:test_calvin_pps_recon_parity: the oracle replays
    # the recon deferral, so parity is exact
    kw = dict(workload="PPS", cc_alg="CALVIN", batch_size=64,
              query_pool_size=1 << 10, warmup_ticks=0, synth_table_size=8,
              max_part_key=256, max_product_key=256, max_supplier_key=256)
    r = _oracle_divergence(kw, pps.PPSWorkload().gen_pool(TConfig(**kw)))
    assert r["abort_rate_divergence"] == 0.0, r
    assert r["tput_ratio"] == 1.0, r
