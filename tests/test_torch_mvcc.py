"""MVCC in the port (deneva_tpu_torch, device="cpu") against the JAX
package's MVCC plugin and engine, on the same inputs made with numpy from
a seed: the version lookup on random rings (empty slots, ties, floors;
H = 1, 2, 8), the access decision and the read-ts raise from a mid-run
db, the commit's version insert (several committers of one row, full
rings, H = 1, and a forced tail that the K-lane merge folds into the
floor), both rebase rules, the cummax-free prefix max, the golden
micro-schedules of tests/test_timestamp_mvcc.py, the engine on YCSB,
TPC-C and PPS with ``fused_arbitrate`` off and on and across a timestamp
rebase, and the abort rate against the numpy sequential oracle within
tests/test_parity.py's MVCC threshold.  Every comparison is exact (all
int32 and bool): summary, ``[summary]``, ``data``, tables, the rings'
``n_rows*H`` cells, ``rts0``, ``w_floor`` and ``mvcc_tail_fold_cnt``."""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

from deneva_tpu.cc import mvcc as jmv  # noqa: E402
from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine import state as jstate  # noqa: E402
from deneva_tpu.engine.scheduler import Engine as JEngine  # noqa: E402
from deneva_tpu.ops import segment as jseg  # noqa: E402
from deneva_tpu.workloads.base import QueryPool as JPool  # noqa: E402
from deneva_tpu_torch.cc import mvcc as tmv  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine import state as tstate  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.engine.state import STATUS_BACKOFF  # noqa: E402
from deneva_tpu_torch.ops import rebase  # noqa: E402
from deneva_tpu_torch.ops import segment as tseg  # noqa: E402
from deneva_tpu_torch.workloads import ycsb  # noqa: E402
from deneva_tpu_torch.workloads.base import QueryPool as TPool  # noqa: E402
from tests import test_torch_engine as t_engine  # noqa: E402
from tests import test_torch_pps as t_pps  # noqa: E402
from tests import test_torch_tpcc as t_tpcc  # noqa: E402
from tests.test_torch_wait_die import _oracle_divergence  # noqa: E402

MV_SMALL = dict(t_engine.SMALL, cc_alg="MVCC")
#: a contended YCSB config (B*R = 256 lanes: with fused_arbitrate the JAX
#: side runs its Pallas kernel in interpret mode)
CONTENDED = dict(t_engine.CELLS["contended"][0], cc_alg="MVCC")
J, T = jnp.asarray, torch.from_numpy


def assert_mvcc_equal(cfg, jdb, tdb):
    """The per-row MVCC state of both, bit for bit: the rings' n_rows*H
    cells, rts0, w_floor, and the tail-fold counter."""
    assert sorted(jdb) == sorted(tdb)
    got = tmv.Mvcc.visible(cfg, tdb)
    for k in tmv.STATE_KEYS:
        np.testing.assert_array_equal(np.asarray(jdb[k]), got[k].numpy(),
                                      err_msg=k)
    assert int(jdb["mvcc_tail_fold_cnt"]) == int(tdb["mvcc_tail_fold_cnt"])


def mv_steps(kw, pool, chunks):
    """Both engines on one pool, run for each chunk of ticks in turn;
    yields the port's engine and state after each chunk, once the two
    engines' states, the MVCC arrays included, are checked equal."""
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
        assert_mvcc_equal(te.cfg, js.db, ts.db)
        yield te, ts


def rand_db(n_rows, H, seed, hi=400):
    """MVCC row state as numpy arrays: rings with empty slots, versions
    clamped to 1 by a rebase (ties), read ts at or above their versions,
    and floors."""
    rng = np.random.default_rng(seed)
    ring = rng.integers(1, hi, (n_rows, H))
    ring[rng.random((n_rows, H)) < 0.3] = 0
    ring[rng.random((n_rows, H)) < 0.1] = 1
    if H > 1:
        # repeated versions: ties for the lookup's argmax
        ring[:, -1] = np.where(rng.random(n_rows) < 0.3, ring[:, 0],
                               ring[:, -1])
    r_ring = np.where(ring > 0, ring + rng.integers(0, 60, ring.shape), 0)
    floor = np.where(rng.random(n_rows) < 0.5,
                     rng.integers(0, hi, n_rows), 0)
    return {"w_ring": ring.reshape(-1).astype(np.int32),
            "r_ring": r_ring.reshape(-1).astype(np.int32),
            "rts0": rng.integers(0, hi, n_rows).astype(np.int32),
            "w_floor": floor.astype(np.int32),
            "mvcc_tail_fold_cnt": np.zeros((), np.int32)}


def both_txns(fields):
    """One TxnState of each package from numpy fields."""
    return (jstate.TxnState(**{f: J(v) for f, v in fields.items()}),
            tstate.TxnState(**{f: T(np.array(v)) for f, v in fields.items()}))


def txn_fields(state):
    return {f: np.asarray(getattr(state.txn, f))
            for f in jstate.TxnState._fields}


# ---- (a) the version lookup ----


@pytest.mark.parametrize("H", [1, 2, 8])
def test_version_lookup_matches_reference(H):
    n_rows, n = 64, 3000
    arrays = rand_db(n_rows, H, H)
    rng = np.random.default_rng(100 + H)
    key = rng.integers(0, n_rows, n).astype(np.int32)
    key[rng.random(n) < 0.05] = tstate.NULL_KEY      # clipped, as there
    ts = rng.integers(0, 420, n).astype(np.int32)
    cfg = TConfig(his_recycle_len=H, synth_table_size=n_rows, batch_size=8,
                  req_per_query=2, query_pool_size=16, cc_alg="MVCC")
    tdb = tmv.Mvcc().db_from_numpy(cfg, arrays, 8, 2)
    want = jmv.Mvcc()._version_lookup({k: J(v) for k, v in arrays.items()},
                                      J(key), J(ts))
    got = tmv.version_lookup(tdb, T(key), T(ts), H)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    v_ts, v_slot, evicted = got
    assert evicted.any() and (v_ts == 0).any() and (v_ts > 0).any()
    if H > 1:
        # tied versions: the first slot of the maximum, as jnp.argmax
        ring = T(arrays["w_ring"]).reshape(n_rows, H)
        tied = (ring[T(key).clamp(0, n_rows - 1).long()]
                == v_ts[:, None]).sum(1) > 1
        assert (tied & (v_ts > 0)).any()


def test_argmax_returns_the_first_maximum():
    x = np.array([[3, 7, 7, 1], [-1, -1, -1, -1], [5, 5, 9, 9]], np.int32)
    np.testing.assert_array_equal(np.asarray(jnp.argmax(J(x), axis=1)),
                                  T(x).argmax(dim=1).numpy())
    assert T(x).argmax(dim=1).tolist() == [1, 0, 2]


# ---- (b) the access decision and the read-ts raise ----


def _mid_run(kw, ticks):
    """The JAX engine's state after `ticks` ticks of `kw`."""
    kw = dict(kw)
    pool = ycsb.gen_query_pool(TConfig(**kw))
    jpool = JPool(**{f: getattr(pool, f) for f in t_pps.POOL_FIELDS})
    je = JEngine(JConfig(**kw), pool=jpool)
    return je.run(ticks)


@functools.lru_cache(maxsize=None)
def _mid_run_at(window):
    """The JAX engine's state after 30 ticks of CONTENDED at H = 2."""
    return _mid_run(dict(CONTENDED, acquire_window=window,
                         his_recycle_len=2), 30)


@pytest.mark.parametrize("window,H,db_kind", [
    (1, 2, "mid_run"), (2, 2, "mid_run"), (1, 8, "random")])
def test_access_matches_reference(window, H, db_kind):
    # the txns of a mid-run state at H = 2, and its db or a random one
    kw = dict(CONTENDED, acquire_window=window, his_recycle_len=H)
    js = _mid_run_at(window)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    n_rows = tcfg.synth_table_size
    arrays = ({k: np.asarray(v) for k, v in js.db.items()}
              if db_kind == "mid_run" else rand_db(n_rows, H, window))
    assert (arrays["w_ring"].reshape(n_rows, H) > 0).all(1).any()  # full
    jtxn, ttxn = both_txns(txn_fields(js))
    B, R = ttxn.keys.shape
    active = lambda s: (s == 1) | (s == 2)
    jdec, jdb = jmv.Mvcc().access(
        jcfg, {k: J(v) for k, v in arrays.items()}, jtxn, active(jtxn.status))
    tdb = tmv.Mvcc().db_from_numpy(tcfg, arrays, B, R)
    tdec, tdb = tmv.Mvcc().access(tcfg, tdb, ttxn, active(ttxn.status))
    for f in ("grant", "wait", "abort"):
        np.testing.assert_array_equal(np.asarray(getattr(jdec, f)),
                                      getattr(tdec, f).numpy(), err_msg=f)
    assert tdec.grant.any() and tdec.abort.any() and tdec.wait.any()
    assert_mvcc_equal(tcfg, jdb, tdb)
    assert not np.array_equal(np.asarray(jdb["r_ring"]), arrays["r_ring"])


def test_access_raises_outside_the_slice():
    cfg = TConfig(**dict(MV_SMALL, depgraph=True, abort_attribution=True))
    txn = tstate.TxnState.empty(4, 2)
    db = tmv.Mvcc().init_db(cfg, 64, 4, 2)
    with pytest.raises(NotImplementedError, match="depgraph"):
        tmv.Mvcc().access(cfg, db, txn, torch.zeros(4, dtype=torch.bool))


# ---- (c) the commit's version insert ----


def _commit_case(B, R, n_rows, H, seed, admit_cap=None, all_write=False,
                 db=None):
    """Random committers on few rows (distinct keys within a txn, distinct
    ts), and the row state `db` (random rings when None), through both
    plugins' on_commit."""
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.permutation(n_rows)[:R] for _ in range(B)])
    fields = {f: np.zeros(B, np.int32) for f in jstate.TxnState._fields}
    fields.update(
        keys=keys.astype(np.int32),
        is_write=np.ones((B, R), bool) if all_write
        else rng.random((B, R)) < 0.6,
        n_req=np.full(B, R, np.int32) if all_write
        else rng.integers(1, R + 1, B).astype(np.int32),
        ts=(rng.permutation(B) + 300).astype(np.int32),
        targs=np.zeros((B, 1), np.int32), aux=np.zeros((B, R), np.int32))
    committed = np.ones(B, bool) if all_write else rng.random(B) < 0.7
    kw = dict(cc_alg="MVCC", batch_size=B, req_per_query=R,
              synth_table_size=n_rows, query_pool_size=B, admit_cap=admit_cap,
              his_recycle_len=H)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    arrays = rand_db(n_rows, H, seed) if db is None else db
    jtxn, ttxn = both_txns(fields)
    jdb = jmv.Mvcc().on_commit(jcfg, {k: J(v) for k, v in arrays.items()},
                               jtxn, J(committed), jtxn.ts, 0)
    tdb = tmv.Mvcc().db_from_numpy(tcfg, arrays, B, R)
    tdb = tmv.Mvcc().on_commit(tcfg, tdb, ttxn, T(committed), ttxn.ts, 0)
    assert_mvcc_equal(tcfg, jdb, tdb)
    return tcfg, arrays, tdb


@pytest.mark.parametrize("H", [1, 2, 8])
def test_commit_with_several_committers_per_row(H):
    # 64 txns of 4 writes on 16 rows: up to ~16 new versions per row
    _, arrays, tdb = _commit_case(64, 4, 16, H, H)
    assert (tdb["w_floor"] > T(arrays["w_floor"])).any()


def test_commit_into_full_rings():
    # every slot of every ring holds a version: each survivor evicts
    H, n_rows = 4, 32
    db = rand_db(n_rows, H, 7)
    db["w_ring"] = np.random.default_rng(7).integers(
        1, 400, n_rows * H).astype(np.int32)
    _commit_case(32, 4, n_rows, H, 8, db=db)


def test_commit_into_a_mid_run_db():
    kw = dict(CONTENDED, his_recycle_len=2)
    js = _mid_run(kw, 30)
    db = {k: np.asarray(v) for k, v in js.db.items()}
    _commit_case(64, 4, 256, 2, 9, db=db)


def test_commit_tail_folds_into_the_floor():
    # B*R = 10,240 committed write lanes against K = max(4096, 1 * 10):
    # the JAX package's lax.cond fires and counts the 6,144 tail lanes
    B, R = 1024, 10
    tcfg, _, tdb = _commit_case(B, R, 2048, 8, 11, admit_cap=1,
                                all_write=True)
    assert tmv.merge_lanes(tcfg, B, R) == 4096
    assert int(tdb["mvcc_tail_fold_cnt"]) == B * R - 4096


# ---- (d) the rebase rules ----


EDGE = [0, 1, 2, 2**30 - 1, 2**30, 2**30 + 1, 2**30 + 2, 2**31 - 1]


@pytest.mark.parametrize("shift", [0, 1, 2**30])
def test_rebase_rules_match_reference(shift):
    rng = np.random.default_rng(shift % 97)
    vals = np.array(EDGE + [shift, shift + 1] + list(rng.integers(
        0, 2**31, 300)), np.int32)
    arrays = {"w_ring": vals, "r_ring": vals[::-1].copy(),
              "rts0": np.roll(vals, 3), "w_floor": np.roll(vals, 7)}
    want = jmv.Mvcc().on_ts_rebase(None, {k: J(v) for k, v in
                                          arrays.items()}, shift)
    s = torch.tensor(shift)
    for ring, (a, b) in ((True, ("w_ring", "r_ring")),
                         (False, ("rts0", "w_floor"))):
        x, y = T(arrays[a].copy()), T(arrays[b].copy())
        rebase.rebase_plain(x, y, s, ring=ring)
        np.testing.assert_array_equal(x.numpy(), np.asarray(want[a]))
        np.testing.assert_array_equal(y.numpy(), np.asarray(want[b]))


def test_on_ts_rebase_in_place():
    cfg = TConfig(**dict(MV_SMALL, his_recycle_len=2))
    arrays = {"w_ring": np.array([0, 1, 5, 2**30, 2**30 + 7, 0, 3, 9] * 8,
                                 np.int32)[:128],
              "r_ring": np.array([0, 2**30 + 1] * 64, np.int32),
              "rts0": np.array([2**30 + 1, 3] * 32, np.int32),
              "w_floor": np.array([0, 2**30 + 5] * 32, np.int32)}
    db = tmv.Mvcc().db_from_numpy(cfg, arrays, 4, 2)
    before = {k: v.clone() for k, v in db.items()}
    held = {k: db[k] for k in tmv.STATE_KEYS}
    tmv.Mvcc().on_ts_rebase(cfg, db, torch.tensor(0))
    assert all(torch.equal(db[k], before[k]) for k in db)
    out = tmv.Mvcc().on_ts_rebase(cfg, db, torch.tensor(2**30))
    assert all(out[k] is held[k] for k in held)          # in place
    assert out["w_ring"][:8].tolist() == [0, 1, 1, 1, 7, 0, 1, 1]
    assert out["r_ring"][:2].tolist() == [0, 1]
    assert out["rts0"][:2].tolist() == [1, 0]
    assert out["w_floor"][:2].tolist() == [0, 5]


# ---- (e) the prefix max with no cummax ----


PACK_LANES = 360


def _sorted_pack(cuts, ts_vals, mask_bits):
    """PACK_LANES lanes sorted by (row, ts): a row starts at lane 0 and
    wherever `cuts` is 0 (one width, so the JAX side compiles once)."""
    new_row = np.asarray(cuts) == 0
    new_row[0] = True
    ids = (np.cumsum(new_row) - 1).astype(np.int32)
    ts = np.asarray(ts_vals, np.int32)
    order = np.lexsort((ts, ids))
    return ids[order], ts[order], np.asarray(mask_bits, bool)


@settings(max_examples=12, deadline=None)
@given(cuts=st.lists(st.integers(0, 4), min_size=PACK_LANES,
                     max_size=PACK_LANES),
       ts_vals=st.lists(st.integers(0, 30), min_size=PACK_LANES,
                        max_size=PACK_LANES),
       mask_bits=st.lists(st.booleans(), min_size=PACK_LANES,
                          max_size=PACK_LANES))
def test_prefix_max_without_cummax(cuts, ts_vals, mask_bits):
    # rows sorted by (row, ts) with ties, as the decision pack: the max
    # masked ts before each lane in its row is the reference's
    # seg_prefix_max, and the last masked lane its blocker lane
    ids, ts, mask = _sorted_pack(cuts, ts_vals, mask_bits)
    starts = tseg.segment_starts(T(ids))
    sidx = tseg.start_index(starts)
    jst = jseg.segment_starts(J(ids))
    want = jseg.seg_prefix_max(jnp.where(J(mask), J(ts), 0), jst)
    got = tseg.seg_prefix_max_sorted(T(ts), T(mask), sidx)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    lane = np.arange(ids.shape[0], dtype=np.int32)
    want_lane = jseg.seg_prefix_max(jnp.where(J(mask), J(lane), -1), jst,
                                    identity=-1)
    np.testing.assert_array_equal(np.asarray(want_lane),
                                  tseg.last_before(T(mask), sidx).numpy())
    np.testing.assert_array_equal(np.asarray(jseg.pos_in_segment(jst)),
                                  tseg.pos_in_segment(starts, sidx).numpy())


# ---- (f) twins of tests/test_timestamp_mvcc.py's MVCC cases ----


def test_mvcc_reads_old_version():
    # tests/test_timestamp_mvcc.py:53: txn1 (ts=2) commits version 2 of k5
    # before txn0 (ts=1) reads k5; MVCC serves the initial version
    keys = np.array([[7, 6, 5], [5, 8, 8]], np.int32)
    iw = np.array([[False, False, False], [True, True, True]])
    pool = TPool(keys=keys, is_write=iw, n_req=np.array([3, 2], np.int32),
                 home_part=np.zeros(2, np.int32),
                 txn_type=np.zeros(2, np.int32),
                 args=np.zeros((2, 1), np.int32))
    kw = dict(MV_SMALL, batch_size=2, query_pool_size=2, req_per_query=3)
    eng, st_ = next(mv_steps(kw, pool, [5]))
    s = eng.summary(st_)
    assert s["total_txn_abort_cnt"] == 0 and s["txn_cnt"] >= 2


def test_mvcc_write_too_late_aborts():
    # tests/test_timestamp_mvcc.py:72: txn2 (ts=3) reads k5 -> rts0=3;
    # txn0 (ts=1) prewrites k5 -> Abort (row_mvcc.cpp:217-239)
    pool = t_engine._pool([[1, 5, 9], [11, 12, 13], [5, 8, 7]],
                          [[True] * 3, [False] * 3, [False] * 3])
    kw = dict(MV_SMALL, batch_size=3, query_pool_size=3, req_per_query=3)
    _, st_ = next(mv_steps(kw, pool, [2]))
    assert int(st_.txn.status[0]) == STATUS_BACKOFF
    assert int(st_.db["rts0"][5]) == 3


def test_mvcc_out_of_order_commit_does_not_serve_stale_version():
    # tests/test_timestamp_mvcc.py:114: H=1; the late commit of the old
    # version folds into the floor, version 2 stays; then two same-tick
    # committers of k5 (ts 4 and 5): the newer is the version
    pool = TPool(keys=np.array([[5, 1, 2, 3], [5, 8, 8, 8], [7, 9, 10, 5]],
                               np.int32),
                 is_write=np.array([[True] * 4, [True] * 4, [False] * 4]),
                 n_req=np.array([4, 2, 4], np.int32),
                 home_part=np.zeros(3, np.int32),
                 txn_type=np.zeros(3, np.int32),
                 args=np.zeros((3, 1), np.int32))
    kw = dict(MV_SMALL, batch_size=3, query_pool_size=3, req_per_query=4,
              his_recycle_len=1)
    run = mv_steps(kw, pool, [6, 2])
    eng, st_ = next(run)
    assert int(st_.db["w_ring"][5]) == 2 and int(st_.db["w_floor"][5]) >= 1
    eng, st_ = next(run)
    assert int(st_.db["w_ring"][5]) == 5 and int(st_.db["w_floor"][5]) >= 4


def test_mvcc_ring_eviction_is_safe():
    # tests/test_timestamp_mvcc.py:145: a ring of 2 on hot keys
    kw = dict(batch_size=32, synth_table_size=64, req_per_query=2,
              query_pool_size=256, zipf_theta=0.9, tup_read_perc=0.3,
              cc_alg="MVCC", warmup_ticks=0, his_recycle_len=2)
    eng, st_ = next(mv_steps(kw, ycsb.gen_query_pool(TConfig(**kw)), [80]))
    s = eng.summary(st_)
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    assert int(st_.data.sum()) == s["write_cnt"]
    assert int(st_.db["w_floor"].max()) > 0


# ---- (g) the engine on the three workloads ----


def _assert_aborted(s):
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0


@pytest.mark.parametrize("fused,over", [
    (False, {}), (True, {}), (False, dict(his_recycle_len=2)),
    (False, dict(acquire_window=4, his_recycle_len=4))],
    ids=["plain", "fused", "ring2", "window4"])
def test_ycsb_engine_matches_reference(fused, over):
    kw = dict(CONTENDED, fused_arbitrate=fused, **over)
    pool = ycsb.gen_query_pool(TConfig(**kw))
    eng, st_ = next(mv_steps(kw, pool, [t_engine.CELLS["contended"][1]]))
    _assert_aborted(eng.summary(st_))
    assert eng.summary(st_)["twopl_wait_cnt"] > 0


@pytest.mark.parametrize("fused", [False, True])
def test_tpcc_engine_matches_reference(fused):
    kw = t_tpcc.tpcc_kw(cc_alg="MVCC", fused_arbitrate=fused)
    je, js, te, ts = t_tpcc._run_both(kw, 60)
    _assert_aborted(t_tpcc._assert_engine_parity(je, js, te, ts))
    assert_mvcc_equal(te.cfg, js.db, ts.db)


@pytest.mark.parametrize("fused", [False, True])
def test_pps_engine_matches_reference(fused):
    # the fused case at B = 32: its JAX side compiles the tick with the
    # Pallas kernel in interpret mode
    kw = t_pps.pps_kw(cc_alg="MVCC", fused_arbitrate=fused,
                      batch_size=32 if fused else 64)
    je, js, te, ts = t_pps.run_both(kw, 60)
    _assert_aborted(t_pps.assert_engine_parity(je, js, te, ts))
    assert_mvcc_equal(te.cfg, js.db, ts.db)


# ---- (h) across a timestamp rebase ----


def test_engine_matches_reference_across_ts_rebase():
    # the counter starts just below the rebase threshold (3 * 2^29); MVCC
    # redraws a ts on every restart, so it crosses it within a few ticks:
    # rings shift by 2^30 with the clamp at 1, floors at 0
    kw = dict(CONTENDED, his_recycle_len=4)
    pool = ycsb.gen_query_pool(TConfig(**kw))
    jpool = JPool(**{f: getattr(pool, f) for f in t_pps.POOL_FIELDS})
    je = JEngine(JConfig(**kw), pool=jpool)
    te = TEngine(TConfig(**kw), pool=pool, device="cpu")
    start = (3 << 29) - 60
    js = je.init_state()._replace(ts_counter=jnp.int32(start))
    ts = te.init_state()._replace(
        ts_counter=torch.tensor(start, dtype=torch.int32))
    for n in (25, 25):
        js = je.run(n, js)
        ts = te.run(n, ts)
        _assert_aborted(t_engine._assert_parity(je, js, te, ts))
        assert_mvcc_equal(te.cfg, js.db, ts.db)
    assert int(ts.ts_counter) < 1 << 30          # it rebased
    ring = tmv.Mvcc.visible(te.cfg, ts.db)["w_ring"]
    assert 0 < int(ring.max()) < 1 << 30


# ---- (i) abort rate against the sequential oracle ----


def test_abort_rate_parity_with_sequential_oracle():
    # tests/test_parity.py:test_abort_rate_parity's MVCC cell
    from tests.test_parity import CFG, THRESH
    kw = dict(CFG, cc_alg="MVCC")
    r = _oracle_divergence(kw, ycsb.gen_query_pool(TConfig(**kw)))
    assert r["abort_rate_divergence"] <= THRESH["MVCC"], r
    assert 0.8 <= r["tput_ratio"] <= 1.25, r
