"""The port's sorted-segment primitives (deneva_tpu_torch/ops/segment.py)
against their jnp counterparts in deneva_tpu/ops/segment.py, on random
sorted segments made with numpy from a seed, plus the hand cases of
tests/test_segment_ops.py, and the host loop of
deneva_tpu_torch/ops/device_loop.py.  All comparisons are exact (integer
and boolean outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.ops import segment as jseg  # noqa: E402
from deneva_tpu_torch.ops import device_loop  # noqa: E402
from deneva_tpu_torch.ops import segment as tseg  # noqa: E402

SIZES = (1, 7, 130, 1000)
BIG, SMALL = 2**31 - 1, -2**31


def _segments(n, seed, n_ids=None):
    """Sorted segment ids, int32 values over the whole int32 range (some at
    its ends), non-negative counts and a mask."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, n_ids or max(1, n // 3), n)).astype(np.int32)
    vals = rng.integers(SMALL, BIG, n, endpoint=True).astype(np.int32)
    vals[rng.random(n) < 0.1] = BIG
    vals[rng.random(n) < 0.1] = SMALL
    cnt = rng.integers(0, 5, n).astype(np.int32)
    mask = rng.random(n) < 0.4
    return ids, vals, cnt, mask


def _eq(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


T = torch.from_numpy
J = jnp.asarray


@pytest.mark.parametrize("n", SIZES)
def test_starts_index_ids_pos(n):
    ids, *_ = _segments(n, n)
    ts, js = tseg.segment_starts(T(ids)), jseg.segment_starts(J(ids))
    _eq(ts, js)
    _eq(tseg.start_index(ts), jseg.start_index(js))
    _eq(tseg.seg_ids(ts), jseg.seg_ids(js))
    _eq(tseg.pos_in_segment(ts), jseg.pos_in_segment(js))


@pytest.mark.parametrize("n", SIZES)
def test_cumsum_exclusive_and_any_before(n):
    ids, _, cnt, mask = _segments(n, 10 + n)
    ts, js = tseg.segment_starts(T(ids)), jseg.segment_starts(J(ids))
    _eq(tseg.seg_cumsum_exclusive(T(cnt), ts),
        jseg.seg_cumsum_exclusive(J(cnt), js))
    _eq(tseg.seg_any_before(T(mask), ts), jseg.seg_any_before(J(mask), js))


@pytest.mark.parametrize("n", SIZES)
def test_cumsum_exclusive_and_any_before_at_start_index(n):
    # given the start index, the segment-start value is a gather, not a
    # cummax: the same answer as the JAX functions
    ids, _, cnt, mask = _segments(n, 60 + n)
    ts, js = tseg.segment_starts(T(ids)), jseg.segment_starts(J(ids))
    sidx = tseg.start_index(ts)
    _eq(tseg.seg_cumsum_exclusive(T(cnt), ts, sidx),
        jseg.seg_cumsum_exclusive(J(cnt), js))
    _eq(tseg.seg_any_before(T(mask), ts, sidx),
        jseg.seg_any_before(J(mask), js))


@pytest.mark.parametrize("all_starts", [True, False],
                         ids=["occ_runs", "any_runs"])
@pytest.mark.parametrize("n", SIZES)
def test_at_run_start_matches_reference(n, all_starts):
    # a non-decreasing exclusive count per segment, read at the last run
    # start at or before each lane: OCC's runs (every segment start is a
    # run start), or any runs (lanes before a segment's first run start
    # read the identity)
    ids, _, cnt, mask = _segments(n, 70 + n)
    ts, js = tseg.segment_starts(T(ids)), jseg.segment_starts(J(ids))
    prefix = jseg.seg_cumsum_exclusive(J(cnt), js)
    runs = np.random.default_rng(n).random(n) < 0.3
    run_start = runs | np.asarray(js) if all_starts else runs
    sidx = tseg.start_index(ts)
    want = jseg.at_run_start(prefix, J(run_start), js, -1, "max")
    got = tseg.at_run_start(T(np.asarray(prefix)), T(run_start), sidx, -1)
    _eq(got, want)
    rs_idx = tseg.run_start_index(T(run_start), sidx)
    _eq(tseg.at_run_start(T(np.asarray(prefix)), None, None, -1,
                          rs_idx=rs_idx), want)
    if all_starts:
        assert (rs_idx >= 0).all()
    with pytest.raises(ValueError, match="sum"):
        tseg.at_run_start(T(np.asarray(prefix)), T(run_start), sidx, -1,
                          "sum")


@pytest.mark.parametrize("all_starts", [True, False],
                         ids=["maat_runs", "any_runs"])
@pytest.mark.parametrize("n", SIZES)
def test_at_run_start_min_matches_reference(n, all_starts):
    # MAAT's reader cap: a non-increasing exclusive prefix min of masked
    # values over the whole int32 range, read at the last run start at or
    # before each lane (identity BIG before a segment's first run start)
    ids, vals, _, mask = _segments(n, 80 + n)
    ts, js = tseg.segment_starts(T(ids)), jseg.segment_starts(J(ids))
    prefix = jseg.seg_prefix_min(jnp.where(J(mask), J(vals), BIG), js, BIG)
    runs = np.random.default_rng(n + 1).random(n) < 0.3
    run_start = runs | np.asarray(js) if all_starts else runs
    sidx = tseg.start_index(ts)
    want = jseg.at_run_start(prefix, J(run_start), js, BIG, "min")
    got = tseg.at_run_start(T(np.asarray(prefix)), T(run_start), sidx, BIG,
                            "min")
    _eq(got, want)
    rs_idx = tseg.run_start_index(T(run_start), sidx)
    _eq(tseg.at_run_start(T(np.asarray(prefix)), None, None, BIG, "min",
                          rs_idx=rs_idx), want)


@pytest.mark.parametrize("depth", [1, 2, 9, 40])
def test_run_while_on_the_cpu(depth):
    # the host loop: the carry advances in place until the flag is false,
    # one pass per step, at least one; the site's counter counts them
    carry = torch.zeros(3, dtype=torch.int32)
    ptr = carry.data_ptr()

    def step():
        carry.add_(torch.tensor([1, 2, 0], dtype=torch.int32))
        return carry[0] < depth

    device_loop.reset_passes()
    device_loop.run_while(step, "segment_test", "cpu")
    assert carry.tolist() == [depth, 2 * depth, 0]
    assert carry.data_ptr() == ptr
    assert int(device_loop.passes("segment_test", "cpu")) == depth


@pytest.mark.parametrize("op", ["min", "max", "sum"])
@pytest.mark.parametrize("n", SIZES)
def test_seg_reduce(op, n):
    ids, vals, *_ = _segments(n, 20 + n)
    ts, js = tseg.segment_starts(T(ids)), jseg.segment_starts(J(ids))
    _eq(tseg.seg_reduce(T(vals), ts, op), jseg.seg_reduce(J(vals), js, op))


@pytest.mark.parametrize("n", SIZES + (4096,))
def test_seg_reduce_sum_at_start_index(n):
    # given the kernel's start index, the segment sum is added into each
    # segment's start slot (no cummax), int32 wrap-around included: MAAT's
    # count of distinct validators per row (nfin_seg)
    for seed, n_ids in ((40 + n, None), (50 + n, 1), (60 + n, n)):
        ids, vals, cnt, _ = _segments(n, seed, n_ids)
        ts, js = tseg.segment_starts(T(ids)), jseg.segment_starts(J(ids))
        sidx = tseg.start_index(ts)
        for v in (vals, cnt):
            _eq(tseg.seg_reduce(T(v), ts, "sum", sidx),
                jseg.seg_reduce(J(v), js, "sum"))


@pytest.mark.parametrize("n", SIZES)
def test_min_max_where(n):
    ids, vals, _, mask = _segments(n, 30 + n)
    ts, js = tseg.segment_starts(T(ids)), jseg.segment_starts(J(ids))
    _eq(tseg.seg_min_where(T(vals), T(mask), ts, BIG),
        jseg.seg_min_where(J(vals), J(mask), js, BIG))
    _eq(tseg.seg_max_where(T(vals), T(mask), ts, SMALL),
        jseg.seg_max_where(J(vals), J(mask), js, SMALL))


@pytest.mark.parametrize("n", SIZES)
def test_prefix_and_suffix_scans(n):
    ids, vals, *_ = _segments(n, 40 + n)
    ts, js = tseg.segment_starts(T(ids)), jseg.segment_starts(J(ids))
    tv, jv = T(vals), J(vals)
    _eq(tseg.seg_prefix_max(tv, ts, SMALL), jseg.seg_prefix_max(jv, js, SMALL))
    _eq(tseg.seg_prefix_min(tv, ts, BIG), jseg.seg_prefix_min(jv, js, BIG))
    _eq(tseg.seg_suffix_max(tv, ts, SMALL), jseg.seg_suffix_max(jv, js, SMALL))
    _eq(tseg.seg_suffix_min(tv, ts, BIG), jseg.seg_suffix_min(jv, js, BIG))
    _eq(tseg._seg_scan(tv, ts, "add", 0),
        jseg._seg_scan(jv, js, jnp.add, jnp.int32(0)))


@pytest.mark.parametrize("n", SIZES)
def test_sort_by_and_unpermute(n):
    rng = np.random.default_rng(50 + n)
    k1 = rng.integers(0, 4, n).astype(np.int32)
    k2 = rng.integers(0, 4, n).astype(np.int32)
    pay = rng.integers(0, 1 << 20, n).astype(np.int32)
    flag = rng.random(n) < 0.5
    (a1, a2), (ap, af) = tseg.sort_by((T(k1), T(k2)), (T(pay), T(flag)))
    (b1, b2), (bp, bf) = jseg.sort_by((J(k1), J(k2)), (J(pay), J(flag)))
    for g, w in ((a1, b1), (a2, b2), (ap, bp), (af, bf)):
        _eq(g, w)
    perm = rng.permutation(n).astype(np.int32)
    _eq(tseg.unpermute(T(perm), T(pay)), jseg.unpermute(J(perm), J(pay)))
    _eq(tseg.unpermute(T(perm), T(flag)), jseg.unpermute(J(perm), J(flag)))
    for g, w in zip(tseg.unpermute_many(T(perm), T(pay), T(flag)),
                    jseg.unpermute_many(J(perm), J(pay), J(flag))):
        _eq(g, w)


def test_identity_compaction_view():
    live = np.array([True, False, True, True, False])
    vals = np.arange(5, dtype=np.int32)
    tv, (tp,) = tseg.compact_entries(T(live), 5, T(vals))
    jv, (jp,) = jseg.compact_entries(J(live), 5, J(vals))
    assert tv.identity and jv.identity
    assert (tv.width, tv.n) == (jv.width, jv.n)
    _eq(tv.n_live, jv.n_live)
    _eq(tv.overflow, jv.overflow)
    _eq(tp, jp)
    (te,) = tseg.expand_entries(tv, tp)
    _eq(te, jp)
    # K < n compacts (tests/test_torch_compaction.py holds it in full)
    tv, (tp,) = tseg.compact_entries(T(live), 2, T(vals))
    jv, (jp,) = jseg.compact_entries(J(live), 2, J(vals))
    assert not tv.identity and tv.width == 2
    _eq(tv.orig_sorted, jv.orig_sorted)
    _eq(tv.overflow, jv.overflow)
    _eq(tp, jp)


# the hand cases of tests/test_segment_ops.py


def test_hand_starts_and_pos():
    starts = tseg.segment_starts(torch.tensor([3, 3, 5, 5, 5, 9, 11, 11]))
    assert starts.tolist() == [1, 0, 1, 0, 0, 1, 1, 0]
    assert tseg.pos_in_segment(starts).tolist() == [0, 1, 0, 1, 2, 0, 0, 1]


def test_hand_reduce_and_suffix():
    ids = torch.tensor([0, 0, 2, 2, 2, 6], dtype=torch.int32)
    vals = torch.tensor([5, 3, 9, 1, 7, 4], dtype=torch.int32)
    starts = tseg.segment_starts(ids)
    assert tseg.seg_reduce(vals, starts, "min").tolist() == [3, 3, 1, 1, 1, 4]
    assert tseg.seg_reduce(vals, starts, "sum").tolist() == [8, 8, 17, 17, 17, 4]
    where = torch.tensor([True, False, False, True, True, False])
    assert tseg.seg_min_where(vals, where, starts, 99).tolist() == \
        [5, 5, 1, 1, 1, 99]
    ids = torch.tensor([0, 0, 0, 1, 1, 2], dtype=torch.int32)
    vals = torch.tensor([5, 2, 9, 7, 1, 4], dtype=torch.int32)
    starts = tseg.segment_starts(ids)
    assert tseg.seg_suffix_min(vals, starts, 99).tolist() == \
        [2, 9, 99, 1, 99, 99]
    assert tseg.seg_suffix_max(vals, starts, 0).tolist() == [9, 9, 0, 1, 0, 0]
