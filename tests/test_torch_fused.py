"""The port's fused sort + segment-scan (deneva_tpu_torch/ops/fused.py)
against the JAX package's Pallas kernel and ``lax.sort``.

On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernel in interpret mode (as tests/test_fused.py does) or
``lax.sort(is_stable=True)``.  Every input is made with numpy from a seed.
All comparisons are exact: every output is an integer or a boolean.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.ops import fused as jfused  # noqa: E402
from deneva_tpu.ops import segment as jseg  # noqa: E402
from deneva_tpu_torch.config import Config  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine  # noqa: E402
from deneva_tpu_torch.ops import fused as tfused  # noqa: E402
from deneva_tpu_torch.ops import segment as tseg  # noqa: E402

INT32_MAX = 2**31 - 1
DEAD_ROW = (1 << 30) - 1
MAIN_N = 8192 * 10   # B * R lanes of the headline cell


def _rand_pack(n, num_keys, n_pay, seed, hi=6):
    """Tie-heavy int32 keys + int32 payloads, the last payload a bool
    (the pack of tests/test_fused.py)."""
    rng = np.random.default_rng(seed)
    cols = [rng.integers(0, hi, n).astype(np.int32) for _ in range(num_keys)]
    cols += [rng.integers(0, 1 << 20, n).astype(np.int32)
             for _ in range(max(n_pay - 1, 0))]
    if n_pay:
        cols.append(rng.random(n) < 0.5)
    return cols


def _port(cols, num_keys, shift=0):
    out, starts, sidx = tfused.fused_sort_scan(
        [torch.from_numpy(c) for c in cols], num_keys, shift)
    return [o.numpy() for o in out], starts.numpy(), sidx.numpy()


def _pallas(cols, num_keys):
    out, starts, sidx = jfused.fused_sort_scan(
        [jnp.asarray(c) for c in cols], num_keys, interpret=True)
    return [np.asarray(o) for o in out], np.asarray(starts), np.asarray(sidx)


def _assert_same(got, want):
    g_cols, g_st, g_si = got
    w_cols, w_st, w_si = want
    assert len(g_cols) == len(w_cols)
    for g, w in zip(g_cols, w_cols):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert g_st.dtype == w_st.dtype == np.bool_
    np.testing.assert_array_equal(g_st, w_st)
    np.testing.assert_array_equal(g_si, w_si)


@pytest.mark.parametrize("n", [1, 2, 7, 64, 96, 128, 130])
def test_plain_matches_pallas_kernel(n):
    cols = _rand_pack(n, num_keys=2, n_pay=3, seed=n)
    _assert_same(_port(cols, 2), _pallas(cols, 2))


@pytest.mark.parametrize("n", [5, 64, 130])
def test_scan_outputs_match_pallas_kernel(n):
    cols = _rand_pack(n, num_keys=1, n_pay=1, seed=100 + n)
    _assert_same(_port(cols, 1), _pallas(cols, 1))


def test_all_tie_order_is_stable():
    n = 37
    cols = [np.zeros(n, np.int32), np.arange(n, dtype=np.int32) * 3]
    got = _port(cols, 1)
    np.testing.assert_array_equal(got[0][1], cols[1])
    _assert_same(got, _pallas(cols, 1))


def test_sentinel_valued_real_keys():
    # real lanes whose key equals the INT32_MAX pad sentinel still sort
    # into the real prefix, in lane order
    cols = [np.array([INT32_MAX, 3, INT32_MAX, 1, 2], np.int32),
            np.arange(5, dtype=np.int32)]
    got = _port(cols, 1)
    np.testing.assert_array_equal(got[0][1], [3, 4, 1, 0, 2])
    _assert_same(got, _pallas(cols, 1))


def _lock_pack(seed):
    """The arbitration sort's pack at the headline width: keykind with
    dead-row sentinel keys (DEAD_ROW*2+1 == INT32_MAX), ts shared by a
    txn's lanes, and the packed index/flag payload."""
    rng = np.random.default_rng(seed)
    B, R = 8192, 10
    live = rng.random(MAIN_N) < 0.5
    held = live & (rng.random(MAIN_N) < 0.8)
    row = np.where(live, rng.integers(0, 1 << 24, MAIN_N), DEAD_ROW)
    keykind = (row * 2 + np.where(held, 0, 1)).astype(np.int32)
    assert (keykind == INT32_MAX).sum() == (~live).sum()
    ts = np.repeat(rng.permutation(1 << 20)[:B], R).astype(np.int32)
    payload = (np.arange(MAIN_N) | (rng.integers(0, 8, MAIN_N) << 23))
    return [keykind, ts, payload.astype(np.int32)]


def _unpermute_pack(seed):
    rng = np.random.default_rng(seed)
    return [rng.permutation(MAIN_N).astype(np.int32),
            rng.integers(0, 8, MAIN_N).astype(np.int32)]


@pytest.mark.parametrize("pack,num_keys", [(_lock_pack, 2),
                                           (_unpermute_pack, 1)])
def test_main_path_packs_match_lax_sort(pack, num_keys):
    cols = pack(11)
    got_cols, got_st, got_si = _port(cols, num_keys)
    want = jax.lax.sort(tuple(jnp.asarray(c) for c in cols),
                        num_keys=num_keys, is_stable=True)
    for g, w in zip(got_cols, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    ref_starts = jseg.segment_starts(want[0])
    np.testing.assert_array_equal(got_st, np.asarray(ref_starts))
    np.testing.assert_array_equal(
        got_si, np.asarray(jseg.start_index(ref_starts)))


def _lax_sort_scan(cols, num_keys, shift):
    """The reference for a shifted scan: lax.sort(is_stable=True), then the
    JAX package's segment_starts and start_index of sorted[0] >> shift."""
    want = jax.lax.sort(tuple(jnp.asarray(c) for c in cols),
                        num_keys=num_keys, is_stable=True)
    starts = jseg.segment_starts(want[0] >> shift)
    return ([np.asarray(w) for w in want], np.asarray(starts),
            np.asarray(jseg.start_index(starts)))


@pytest.mark.parametrize("pack,num_keys", [(_lock_pack, 2),
                                           (_unpermute_pack, 1)])
def test_shifted_scan_matches_reference(pack, num_keys):
    # shift 1 on the lock pack gives arbitrate's row segments (keykind >> 1)
    cols = pack(13)
    _assert_same(_port(cols, num_keys, shift=1),
                 _lax_sort_scan(cols, num_keys, 1))


@pytest.mark.parametrize("shift", [1, 2, 31])
@pytest.mark.parametrize("n", [1, 2, 7, 64, 130])
def test_shifted_scan_small_packs(n, shift):
    # keys in [-9, 9): negative keys shift arithmetically
    rng = np.random.default_rng(300 + n)
    cols = [rng.integers(-9, 9, n).astype(np.int32),
            rng.integers(0, 4, n).astype(np.int32),
            rng.integers(0, 1 << 20, n).astype(np.int32)]
    _assert_same(_port(cols, 2, shift), _lax_sort_scan(cols, 2, shift))


@pytest.mark.parametrize("fused", [False, True])
def test_sort_pack_scan_in_and_out_of_scope(fused):
    # the kernel's scan outputs inside an active scope, the plain sort and
    # scans outside it: the same answer either way
    cols = _lock_pack(17)
    with tseg.fused_scope(Config(fused_arbitrate=fused)):
        srt, starts, sidx = tseg.sort_pack_scan(
            [torch.from_numpy(c) for c in cols], num_keys=2, shift=1)
    _assert_same(([o.numpy() for o in srt], starts.numpy(), sidx.numpy()),
                 _lax_sort_scan(cols, 2, 1))


def test_gate_takes_widths_past_the_tpu_cap():
    # P = 16384 > fused_max_lanes (8192): the TPU gate falls back, the
    # Hopper gate does not
    tfused.reset_fallbacks()
    cols = [torch.from_numpy(c) for c in _rand_pack(10240, 1, 1, 3)]
    hit = tfused.maybe_fused_sort(Config(fused_arbitrate=True), cols, 1)
    assert hit is not None
    assert tfused.fallback_snapshot()["count"] == 0


@pytest.mark.parametrize("case", ["dtype", "operands", "keys"])
def test_gate_fallback_is_loud_and_counted(case):
    tfused.reset_fallbacks()
    cfg = Config(fused_arbitrate=True)
    rng = np.random.default_rng(5)
    col = torch.from_numpy(rng.integers(0, 9, 16).astype(np.int32))
    ops, nk = {
        "dtype": ((col.to(torch.float32), col), 1),
        "operands": ((col,) * (tfused.MAX_OPERANDS + 1), 1),
        "keys": ((col,) * (tfused.MAX_KEYS + 1), tfused.MAX_KEYS + 1),
    }[case]
    with pytest.warns(UserWarning, match="fallback to the plain sort"):
        assert tfused.maybe_fused_sort(cfg, ops, nk) is None
    snap = tfused.fallback_snapshot()
    assert snap["count"] == 1
    assert snap["events"][0]["reason"] == case
    # sort_pack then sorts with the plain path: still the right answer
    with tseg.fused_scope(cfg), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = tseg.sort_pack(ops, num_keys=nk)
    want = jax.lax.sort(tuple(jnp.asarray(o.numpy()) for o in ops),
                        num_keys=nk, is_stable=True)
    for g, w in zip(out, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fused_scope_sorts_and_restores():
    k = torch.tensor([5, 1, 5, 2, 1, 1, 5, 9], dtype=torch.int32)
    v = torch.arange(8, dtype=torch.int32)
    cfg = Config(fused_arbitrate=True)
    with tseg.fused_scope(cfg):
        assert tseg._FUSED_CFG is cfg
        with tseg.fused_scope(Config(fused_arbitrate=False)):
            assert tseg._FUSED_CFG is None
        assert tseg._FUSED_CFG is cfg
        (sk,), (sv,) = tseg.sort_by((k,), (v,))
        st = tseg.segment_starts(sk)
        si = tseg.start_index(st)
    assert tseg._FUSED_CFG is None
    np.testing.assert_array_equal(sk.numpy(), [1, 1, 1, 2, 5, 5, 5, 9])
    np.testing.assert_array_equal(sv.numpy(), [1, 4, 5, 3, 0, 2, 6, 7])
    np.testing.assert_array_equal(st.numpy(), [1, 0, 0, 1, 1, 0, 0, 1])
    np.testing.assert_array_equal(si.numpy(), [0, 0, 0, 3, 4, 4, 4, 7])


def test_launch_counter_stays_zero_on_cpu():
    tfused.reset_launches()
    tfused.reset_fallbacks()
    cfg = Config(batch_size=32, synth_table_size=256, req_per_query=4,
                 query_pool_size=128, zipf_theta=0.9, fused_arbitrate=True)
    eng = Engine(cfg, device="cpu")
    s = eng.summary(eng.run(20))
    assert s["txn_cnt"] > 0
    assert tfused.LAUNCHES == 0 and tfused.LAUNCHES_BY_PACK == {}
    assert tfused.fallback_snapshot()["count"] == 0
