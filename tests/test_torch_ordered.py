"""The port's ordered index (deneva_tpu_torch.storage.ordered, asked for
the CPU): twins of the three tests of tests/test_ordered_index.py, each also
held to the JAX package's OrderedIndex on the same keys and queries.
Comparisons are exact (integer positions)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.storage.ordered import OrderedIndex as JIndex  # noqa: E402
from deneva_tpu_torch.config import Config  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine  # noqa: E402
from deneva_tpu_torch.storage.ordered import (  # noqa: E402
    NULL_ROW, OrderedIndex,
)
from deneva_tpu_torch.workloads.base import QueryPool  # noqa: E402


def sparse_keys(n=500, seed=3):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(0, 10_000, n))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lookup_and_range_match_numpy():
    keys = sparse_keys()
    idx, jidx = OrderedIndex(keys, device="cpu"), JIndex(keys)
    rng = np.random.default_rng(5)
    q = rng.integers(0, 10_000, 256).astype(np.int32)

    got = idx.lookup(q)
    _eq(got, jidx.lookup(q))
    for qi, gi in zip(q.tolist(), got.tolist()):
        where = np.searchsorted(keys, qi)
        if where < len(keys) and keys[where] == qi:
            assert gi == where
        else:
            assert gi == -1

    lo, hi = 2000, 4000
    assert int(idx.range_count(lo, hi)) == int(
        ((keys >= lo) & (keys < hi)).sum())
    _eq(idx.range_start(lo), jidx.range_start(lo))
    win = idx.range_window(lo, 32, hi=hi)
    _eq(win, jidx.range_window(lo, 32, hi=hi))
    expect = np.nonzero((keys >= lo) & (keys < hi))[0][:32]
    live = win[win != NULL_ROW].numpy()
    assert (live == expect).all()


def test_batched_range_windows():
    keys = sparse_keys()
    idx = OrderedIndex(keys, device="cpu")
    los = np.array([0, 5000, 9999, 12000], np.int32)
    win = idx.range_window(los, 8)
    assert tuple(win.shape) == (4, 8)
    _eq(win, JIndex(keys).range_window(los, 8))
    his = np.array([100, 6000, 10_000, 13_000], np.int32)
    _eq(idx.range_window(los, 8, hi=his),
        JIndex(keys).range_window(los, 8, hi=his))
    for i, lo in enumerate(los.tolist()):
        expect = np.nonzero(keys >= lo)[0][:8]
        live = win[i][win[i] != NULL_ROW].numpy()
        assert (live == expect).all()


def test_range_scan_workload_runs_through_engine():
    """A range-scan workload through the port's engine: each txn's access
    program is the index's range window over the sorted, sparse key
    population, as a btree-backed scan would drive row accesses."""
    table = 1 << 12
    pop = np.unique(np.random.default_rng(9).integers(0, table, 600))
    idx = OrderedIndex(pop, device="cpu")
    Q, W = 256, 6
    rng = np.random.default_rng(11)
    los = rng.integers(0, table, Q).astype(np.int32)
    rows = idx.range_window(los, W).numpy()              # (Q, W) positions
    keys = np.where(rows != NULL_ROW, pop[np.clip(rows, 0, len(pop) - 1)],
                    np.int32(2**31 - 1)).astype(np.int32)
    n_req = (rows != NULL_ROW).sum(axis=1).astype(np.int32)
    # last access of each scan is an update (scan-and-touch)
    iw = np.zeros_like(keys, dtype=bool)
    iw[np.arange(Q), np.maximum(n_req - 1, 0)] = n_req > 0
    pool = QueryPool(keys=keys, is_write=iw, n_req=np.maximum(n_req, 1),
                     home_part=np.zeros(Q, np.int32),
                     txn_type=np.zeros(Q, np.int32),
                     args=np.zeros((Q, 1), np.int32),
                     aux=np.zeros((Q, W), np.int32))
    cfg = Config(cc_alg="NO_WAIT", batch_size=64, synth_table_size=table,
                 req_per_query=W, query_pool_size=Q, warmup_ticks=0)
    eng = Engine(cfg, pool=pool, device="cpu")
    st = eng.run(40)
    s = eng.summary(st)
    assert s["txn_cnt"] > 0
    assert int(st.data.sum()) == s["write_cnt"]
