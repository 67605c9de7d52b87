"""TIMESTAMP (basic T/O) in the port (deneva_tpu_torch, device="cpu"): the
golden micro-schedules of tests/test_timestamp_mvcc.py (row_ts.cpp:
167-323), each also held to the JAX engine; the whole engine against the
JAX engine on small YCSB (acquire window 1 and 4, ``ts_twr`` off and on),
TPC-C (with restock chains deeper than one committer per STOCK row) and
PPS (with two committers of one USES row in one tick) configs, and
across a timestamp rebase; and the abort rate against the numpy
sequential oracle within tests/test_parity.py's TIMESTAMP thresholds.
Every engine comparison is exact, the per-row ``wts``/``rts`` arrays
included."""

import contextlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.cc import timestamp as jts  # noqa: E402
from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine import state as jstate  # noqa: E402
from deneva_tpu.engine.scheduler import Engine as JEngine  # noqa: E402
from deneva_tpu.workloads.base import QueryPool as JPool  # noqa: E402
from deneva_tpu_torch.cc import timestamp as tts  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine import state as tstate  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.engine.state import (  # noqa: E402
    STATUS_BACKOFF, STATUS_WAITING,
)
from deneva_tpu_torch.workloads import pps, tpcc, ycsb  # noqa: E402
from deneva_tpu_torch.workloads.base import QueryPool as TPool  # noqa: E402
from tests import test_torch_engine as t_engine  # noqa: E402
from tests import test_torch_pps as t_pps  # noqa: E402
from tests import test_torch_tpcc as t_tpcc  # noqa: E402
from tests.test_torch_wait_die import _oracle_divergence  # noqa: E402

TO_SMALL = dict(t_engine.SMALL, batch_size=2, query_pool_size=2,
                cc_alg="TIMESTAMP")


def assert_db_equal(js, ts):
    """The per-row T/O state of both engines, bit for bit."""
    assert sorted(js.db) == sorted(ts.db)
    for k in ("wts", "rts"):
        np.testing.assert_array_equal(np.asarray(js.db[k]), ts.db[k].numpy(),
                                      err_msg=k)


def db_steps(kw, pool, chunks):
    """Both engines on one pool, run for each chunk of ticks in turn (the
    ``steps`` of tests/test_torch_wait_die.py); yields the port's engine
    and state after each chunk, once the two engines' states, wts and rts
    included, are checked equal."""
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
        assert_db_equal(js, ts)
        yield te, ts


# ---- the window helpers and the decision kernel against the reference ----


@pytest.mark.parametrize("W", [1, 3])
def test_expand_and_contract_window_match_reference(W):
    rng = np.random.default_rng(W)
    B, R = 32, 6
    cursor = rng.integers(0, R, B).astype(np.int32)
    vals = rng.integers(-50, 50, (B, W)).astype(np.int32)
    mask = rng.random((B, R)) < 0.5

    def txn(mod, arr):
        z = arr(np.zeros(B, np.int32))
        return mod.TxnState(
            status=z, cursor=arr(cursor), ts=z, pool_idx=z, restarts=z,
            backoff_until=z, start_tick=z, first_start_tick=z,
            keys=arr(np.zeros((B, R), np.int32)),
            is_write=arr(np.zeros((B, R), bool)), n_req=z, txn_type=z,
            targs=arr(np.zeros((B, 1), np.int32)),
            aux=arr(np.zeros((B, R), np.int32)))

    jt, tt = txn(jstate, jnp.asarray), txn(tstate, torch.from_numpy)
    np.testing.assert_array_equal(
        np.asarray(jstate.expand_window(jt, jnp.asarray(vals), fill=7)),
        tstate.expand_window(tt, torch.from_numpy(vals), fill=7).numpy())
    np.testing.assert_array_equal(
        np.asarray(jstate.contract_window(jt, jnp.asarray(mask), W)),
        tstate.contract_window(tt, torch.from_numpy(mask), W).numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decide_matches_reference(seed):
    # random entries on few rows with tied timestamps: held and requested
    # lanes, writes, reads and too-old flags, dead lanes keyed NULL_KEY
    rng = np.random.default_rng(seed)
    n = 3000
    live = rng.random(n) < 0.7
    key = np.where(live, rng.integers(0, 40, n), tstate.NULL_KEY)
    ts = rng.integers(1, 200, n)
    held = live & (rng.random(n) < 0.5)
    req = live & ~held
    cols = [key.astype(np.int32), ts.astype(np.int32), rng.random(n) < 0.5,
            held, req, rng.random(n) < 0.2, rng.random(n) < 0.2]
    want = jts._decide(*[jnp.asarray(c) for c in cols])
    got = tts._decide(*[torch.from_numpy(c) for c in cols])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    assert got[1].any() and got[2].any()      # waits and aborts happen


def test_raise_max_spreads_dead_lanes_and_is_exact():
    dst = torch.tensor([5, 0, 9, 3], dtype=torch.int32)
    row = torch.tensor([2, 2, 0, 2**31 - 1, 1], dtype=torch.int32)
    mask = torch.tensor([True, True, True, False, False])
    tts.raise_max(dst, row, mask, torch.tensor([4, 12, 7, 99, 99],
                                               dtype=torch.int32))
    assert dst.tolist() == [7, 0, 12, 3]


def test_rebase_plain_is_the_reference_rule():
    # the plain version (the CPU path and the kernel's reference) against
    # the JAX plugin's max(x - shift, 0), at the values around the shift
    edge = [0, 1, 2**30 - 1, 2**30, 2**30 + 1, 2**31 - 1]
    vals = np.array(edge + list(np.random.default_rng(0).integers(
        0, 2**31, 200)), np.int32)
    for shift in (0, 1, 2**30):
        a, b = torch.from_numpy(vals.copy()), torch.from_numpy(vals[::-1]
                                                               .copy())
        tts.rebase.rebase_plain(a, b, torch.tensor(shift))
        want = jts.Timestamp().on_ts_rebase(
            None, {"wts": jnp.asarray(vals), "rts": jnp.asarray(vals[::-1])},
            shift)
        np.testing.assert_array_equal(a.numpy(), np.asarray(want["wts"]))
        np.testing.assert_array_equal(b.numpy(), np.asarray(want["rts"]))


def test_rebase_in_place():
    db = {"wts": torch.tensor([0, 5, 2**30, 2**30 + 7], dtype=torch.int32),
          "rts": torch.tensor([2**30 + 1, 3, 0, 9], dtype=torch.int32)}
    wts, rts = db["wts"], db["rts"]
    tts.Timestamp().on_ts_rebase(None, db, torch.tensor(0))
    assert wts.tolist() == [0, 5, 2**30, 2**30 + 7]
    out = tts.Timestamp().on_ts_rebase(None, db, torch.tensor(2**30))
    assert out["wts"] is wts and out["rts"] is rts      # in place
    assert wts.tolist() == [0, 0, 0, 7] and rts.tolist() == [1, 0, 0, 0]


# ---- twins of tests/test_timestamp_mvcc.py ----


def test_write_too_late_aborts():
    # txn0 (ts=1): [k1 W, k5 W]; txn1 (ts=2): [k5 R, k2 R].  tick0: txn1
    # reads k5 -> rts[k5]=2.  tick1: txn0 prewrites k5 at ts=1 < rts=2 ->
    # Abort (row_ts.cpp:192-194)
    pool = t_engine._pool([[1, 5], [5, 2]], [[True, True], [False, False]])
    eng, st = next(db_steps(TO_SMALL, pool, [2]))
    assert int(st.txn.status[0]) == STATUS_BACKOFF
    assert eng.summary(st)["total_txn_abort_cnt"] == 1
    assert int(st.db["rts"][5]) == 2


def test_read_waits_on_older_prewrite_then_proceeds():
    # txn0 (ts=1): [k5 W, k1 W]; txn1 (ts=2): [k2 R, k5 R].  tick1: txn1's
    # read of k5 sees the pending prewrite (pts=1 < 2) -> WAIT
    # (row_ts.cpp:181-186).  tick2: txn0 commits (wts[k5]=1) and the read
    # is granted
    pool = t_engine._pool([[5, 1], [2, 5]], [[True, True], [False, False]])
    run = db_steps(TO_SMALL, pool, [2, 1])
    _, st = next(run)
    assert int(st.txn.status[1]) == STATUS_WAITING
    eng, st = next(run)
    assert int(st.txn.cursor[1]) == 2
    s = eng.summary(st)
    assert s["txn_cnt"] == 1 and s["total_txn_abort_cnt"] == 0
    assert int(st.db["wts"][5]) == 1 and int(st.db["rts"][5]) == 2


def test_to_aborts_on_a_newer_committed_write():
    # T/O half of test_to_aborts_but_mvcc_reads_old_version: txn1 (ts=2)
    # commits its k5 write (wts=2) before txn0 (ts=1) reads k5 -> Abort
    # (row_ts.cpp:176)
    keys = np.array([[7, 6, 5], [5, 8, 8]], np.int32)
    iw = np.array([[False, False, False], [True, True, True]])
    pool = TPool(keys=keys, is_write=iw, n_req=np.array([3, 2], np.int32),
                 home_part=np.zeros(2, np.int32),
                 txn_type=np.zeros(2, np.int32),
                 args=np.zeros((2, 1), np.int32))
    kw = dict(TO_SMALL, req_per_query=3)
    eng, st = next(db_steps(kw, pool, [4]))
    assert eng.summary(st)["total_txn_abort_cnt"] >= 1


@pytest.mark.parametrize("window", [1, 4])
def test_oracle_under_contention(window):
    kw = dict(batch_size=64, synth_table_size=256, req_per_query=4,
              query_pool_size=512, zipf_theta=0.9, tup_read_perc=0.5,
              cc_alg="TIMESTAMP", warmup_ticks=0, acquire_window=window)
    pool = ycsb.gen_query_pool(TConfig(**kw))
    eng, st = next(db_steps(kw, pool, [60]))
    s = eng.summary(st)
    assert s["txn_cnt"] > 0 and s["twopl_wait_cnt"] > 0
    assert int(st.data.sum()) == s["write_cnt"]


# ---- the engine against the JAX engine on the three workloads ----


def _assert_aborted(s):
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0


@pytest.mark.parametrize("twr", [False, True], ids=["basic", "ts_twr"])
@pytest.mark.parametrize("fused", [False, True])
def test_ycsb_engine_matches_reference(fused, twr):
    kw, n_ticks = t_engine.CELLS["contended"]
    kw = dict(kw, cc_alg="TIMESTAMP", fused_arbitrate=fused, ts_twr=twr)
    pool = ycsb.gen_query_pool(TConfig(**kw))
    eng, st = next(db_steps(kw, pool, [n_ticks]))
    _assert_aborted(eng.summary(st))
    assert eng.summary(st)["twopl_wait_cnt"] > 0


@contextlib.contextmanager
def restock_depths(monkeypatch):
    """Record, for each call of the port's TPC-C effect body, the depth of
    its deepest restock chain: the most committing NewOrder entries on one
    STOCK row (a host read, so for eager ticks only)."""
    depths = []
    body = tpcc.TPCCWorkload._apply_entries_body

    def recording(self, cfg, t, key_local, part, role_f, earg, earg2, cts,
                  eff):
        rows = key_local[eff & ((role_f & 7) == tpcc.ROLE_S_NO)]
        depths.append(int(torch.unique(rows, return_counts=True)[1].max())
                      if rows.numel() else 0)
        return body(self, cfg, t, key_local, part, role_f, earg, earg2, cts,
                    eff)

    with monkeypatch.context() as m:
        m.setattr(tpcc.TPCCWorkload, "_apply_entries_body", recording)
        yield depths


#: the TPC-C cell of tests/test_parity.py under TIMESTAMP (4 warehouses,
#: 128 items, B=64): several txns commit to one STOCK row in a tick
DEEP_TPCC = dict(workload="TPCC", cc_alg="TIMESTAMP", batch_size=64,
                 num_wh=4, cust_per_dist=1000, max_items=128,
                 query_pool_size=1 << 10, warmup_ticks=0, synth_table_size=8)


def _deep_chains(kw, n_ticks, monkeypatch, chunks=None):
    with restock_depths(monkeypatch) as depths:
        je, js, te, ts = t_tpcc._run_both(kw, n_ticks, chunks)
    s = t_tpcc._assert_engine_parity(je, js, te, ts)
    assert_db_equal(js, ts)
    _assert_aborted(s)
    return depths


@pytest.mark.parametrize("fused", [False, True])
def test_tpcc_engine_matches_reference(fused, monkeypatch):
    _deep_chains(t_tpcc.tpcc_kw(cc_alg="TIMESTAMP", fused_arbitrate=fused),
                 60, monkeypatch)


def test_tpcc_parity_cell_with_deep_restock_chains(monkeypatch):
    # eager: several txns commit to one STOCK row in one tick, and the
    # restock chain's closed form gives the reference's while_loop result
    depths = _deep_chains(DEEP_TPCC, 50, monkeypatch, chunks=[20, 30])
    assert len(depths) == 50
    assert max(depths) > 1, depths


def _restock_step(q, k):
    """new_order_9's rule (tpcc_txn.cpp:900-906), as the reference's
    while_loop applies it."""
    return np.where(q > k + 10, q - k, q - k + 91)


def test_restock_closed_form_holds_on_its_range():
    # every s_quantity the tables can hold (init [10, 100], the rule's
    # image [11, 101]) and every entry quantity (1..16): the step equals
    # 11 + (q - 11 - k) mod 91 and stays in [10, 101]
    q, k = np.meshgrid(np.arange(10, 102), np.arange(1, 17))
    step = _restock_step(q, k)
    np.testing.assert_array_equal(step, 11 + np.mod(q - 11 - k, 91))
    assert step.min() >= 11 and step.max() <= 101


@pytest.mark.parametrize("depth", [1, 2, 7, 64])
def test_restock_chain_of_any_depth_matches_the_sequential_rule(depth):
    # `depth` committing entries on one STOCK row (and one on another) in
    # one tick, in shuffled cts order: the body's closed form gives the
    # rule applied one entry at a time in cts order
    rng = np.random.default_rng(depth)
    cfg = TConfig(**t_tpcc.tpcc_kw(cc_alg="TIMESTAMP"))
    base_row = tpcc.catalog(cfg).tables["STOCK"].base
    key = np.array([base_row + 3] * depth + [base_row + 5])
    cts = rng.permutation(depth + 1) + 1
    earg = rng.integers(0, 1 << 5, depth + 1)     # quantity (earg & 15) + 1
    wl = tpcc.TPCCWorkload()
    tables = wl.init_tables(cfg, 0)
    q0 = tables["s_quantity"].numpy().copy()
    as_t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))
    wl._apply_entries_body(
        cfg, tables, as_t(key), 0,
        torch.full((depth + 1,), tpcc.ROLE_S_NO, dtype=torch.int32),
        as_t(earg), torch.zeros(depth + 1, dtype=torch.int32), as_t(cts),
        torch.ones(depth + 1, dtype=torch.bool))
    want = q0.copy()
    for i in np.argsort(cts):
        r = key[i] - base_row
        want[r] = _restock_step(want[r], (earg[i] & 15) + 1)
    np.testing.assert_array_equal(tables["s_quantity"].numpy(), want)


@pytest.mark.parametrize("fused", [False, True])
def test_pps_engine_matches_reference(fused):
    kw = t_pps.pps_kw(cc_alg="TIMESTAMP", fused_arbitrate=fused)
    je, js, te, ts = t_pps.run_both(kw, 60)
    _assert_aborted(t_pps.assert_engine_parity(je, js, te, ts))
    assert_db_equal(js, ts)


def test_pps_two_committers_of_one_uses_row_in_a_tick(monkeypatch):
    # UPDATEPRODUCTPART on 8 products: under T/O two committing txns write
    # one USES row in one tick; the one with the larger commit ts wins
    # (the last-writer-wins pack sorts by (row, cts)).  Both engines are
    # held equal after every tick up to and past the first such tick.
    kw = t_pps.pps_kw(cc_alg="TIMESTAMP", max_product_key=8,
                      perc_pps_getpartbyproduct=0.2,
                      perc_pps_orderproduct=0.2,
                      perc_pps_updateproductpart=0.6)
    cfg = TConfig(**kw)
    pool = pps.PPSWorkload().gen_pool(cfg)
    shared = []
    body = pps.PPSWorkload._apply_entries_body

    def spy(self, cfg_, t, key_local, role_f, earg, cts, eff):
        rows = key_local[eff & ((role_f & 7) == pps.ROLE_SETUSES)]
        shared.append(rows.numel() > torch.unique(rows).numel())
        return body(self, cfg_, t, key_local, role_f, earg, cts, eff)

    monkeypatch.setattr(pps.PPSWorkload, "_apply_entries_body", spy)
    seen = None
    for i, (eng, st) in enumerate(db_steps(kw, pool, [1] * 40)):
        if seen is None and any(shared):
            seen = i
        if seen is not None and i >= seen + 2:
            break
    assert seen is not None, "no tick with two committers of one USES row"
    assert eng.summary(st)["txn_cnt"] > 0


def test_engine_matches_reference_across_ts_rebase():
    # the timestamp counter starts just below the rebase threshold
    # (3 * 2^29): T/O redraws a ts on every restart, so it crosses it
    # within a few ticks; txn timestamps shift down by 2^30 with the clamp
    # at 1, and wts/rts by 2^30 with the clamp at 0, mid-run
    kw, _ = t_engine.CELLS["contended"]
    kw = dict(kw, cc_alg="TIMESTAMP")
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
    _assert_aborted(t_engine._assert_parity(je, js, te, ts))
    assert_db_equal(js, ts)
    assert int(ts.ts_counter) < 1 << 30          # it rebased
    assert 0 < int(ts.db["wts"].max()) < 1 << 30


# ---- abort rate against the sequential oracle ----


def test_abort_rate_parity_with_sequential_oracle():
    # tests/test_parity.py:test_abort_rate_parity's TIMESTAMP cell
    from tests.test_parity import CFG, THRESH
    kw = dict(CFG, cc_alg="TIMESTAMP")
    r = _oracle_divergence(kw, ycsb.gen_query_pool(TConfig(**kw)))
    assert r["abort_rate_divergence"] <= THRESH["TIMESTAMP"], r
    assert 0.8 <= r["tput_ratio"] <= 1.25, r


def test_tpcc_abort_rate_parity_with_sequential_oracle():
    # tests/test_parity.py:test_tpcc_timestamp_mixed_cell_bounded
    kw = dict(workload="TPCC", cc_alg="TIMESTAMP", batch_size=64, num_wh=4,
              cust_per_dist=1000, max_items=128, query_pool_size=1 << 10,
              warmup_ticks=0, synth_table_size=8)
    r = _oracle_divergence(kw, tpcc.TPCCWorkload().gen_pool(TConfig(**kw)))
    assert r["abort_rate_divergence"] <= 0.12, r


def test_pps_abort_rate_parity_with_sequential_oracle():
    # tests/test_parity.py:test_pps_parity's TIMESTAMP cell
    from tests.test_parity import PPS_THRESH
    kw = dict(workload="PPS", cc_alg="TIMESTAMP", batch_size=64,
              query_pool_size=1 << 10, warmup_ticks=0, synth_table_size=8,
              max_part_key=256, max_product_key=256, max_supplier_key=256)
    r = _oracle_divergence(kw, pps.PPSWorkload().gen_pool(TConfig(**kw)))
    assert r["abort_rate_divergence"] <= PPS_THRESH["TIMESTAMP"], r
