"""Live-entry compaction (``Config.compact_auto`` / ``compact_lanes``) in the
port (deneva_tpu_torch, device="cpu") against the JAX package.

1. The primitives (``ops/segment.py``): ``compact_entries``,
   ``expand_entries`` and ``overflow_mask`` held to the JAX package's on
   order, round trip, the identity short-circuit and overflow; and the
   access path's class discipline (``cc/compact.py`` ``compact_access``
   and ``finish_access``) held to the reference's on random entry views,
   with ``unsafe`` ticks (more non-retryable held lanes than K) among them.
2. The engine: the JAX engine, the port's ``run`` and its
   ``run_compiled`` on one pool, holding ``summary()`` (with
   ``compact_overflow_cnt`` and ``live_entry_cnt``), the ``[summary]`` line
   less ``mem_util``/``cpu_util``, ``data``, the txn slots, every table and
   the plugin's arrays equal (``test_torch_commit_after.run_both_orders``).
   The grid: the seven plugins on YCSB at a bucket that never spills and
   at one that does (a spill changes the schedule, so each spilling run is
   held to the JAX engine at the same K, never to the padded run), and
   ``compact_auto`` on TPC-C and PPS; ``commit_after_access``,
   ``sub_ticks``, ``dense_lock_state``, READ_UNCOMMITTED and
   ``fused_arbitrate`` (NO_WAIT) with ``compact_auto``; and the
   repeated-key pool, where one txn touches a row twice, under every
   plugin (cross-class ties, ``cc/compact.py``).
3. In the port alone: a bucket that never spills gives the padded run's
   counts.

``compact_auto`` rounds K up to a multiple of 256, so it is the identity
at B*R <= 256: the YCSB spilling geometry here is B=64, R=10 (K = 512 <
640).  Every comparison is exact.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.cc import base as jcc_base  # noqa: E402
from deneva_tpu.cc import compact as jcompact  # noqa: E402
from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine import state as jstate  # noqa: E402
from deneva_tpu.ops import fused as jfused  # noqa: E402
from deneva_tpu.ops import segment as jseg  # noqa: E402
from deneva_tpu_torch.cc import base as tcc_base  # noqa: E402
from deneva_tpu_torch.cc import compact as tcompact  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine import state as tstate  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.ops import segment as tseg  # noqa: E402
from tests import test_torch_engine as t_engine  # noqa: E402
from tests.test_torch_commit_after import run_both_orders  # noqa: E402
from tests.test_torch_lock_optins import (  # noqa: E402
    PPS, TPCC, _eq, _txn_state,
)

T = torch.from_numpy
J = jnp.asarray

PLUGINS = ("NO_WAIT", "WAIT_DIE", "TIMESTAMP", "MVCC", "CALVIN", "OCC",
           "MAAT")

# ---------------------------------------------------------------------------
# 1. the primitives


def _live(n, p, seed):
    return np.random.default_rng(seed).random(n) < p


def _views_equal(tv, jv):
    assert tv.width == jv.width and tv.n == jv.n
    assert tv.identity == jv.identity
    if not tv.identity:
        _eq(tv.orig_sorted, jv.orig_sorted)
    _eq(tv.live, jv.live)
    _eq(tv.n_live, jv.n_live)
    _eq(tv.overflow, jv.overflow)


@pytest.mark.parametrize("n,K,p,seed", [
    (64, 24, 0.3, 1),      # spills: more live entries than K
    (48, 32, 0.4, 2),      # fits
    (64, 64, 0.5, 3),      # K == n: the identity view
    (64, 80, 0.5, 4),      # K > n: the identity view
    (640, 512, 0.9, 5),    # the engine's compact_auto geometry, spilling
    (50, 1, 0.0, 6),       # nothing live
])
def test_compact_expand_overflow_match_reference(n, K, p, seed):
    live = _live(n, p, seed)
    rng = np.random.default_rng(seed + 100)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    flags = rng.random(n) < 0.5
    tv, (tvals, tflags) = tseg.compact_entries(T(live), K, T(vals),
                                               T(flags))
    jv, (jvals, jflags) = jseg.compact_entries(J(live), K, J(vals),
                                               J(flags))
    _views_equal(tv, jv)
    _eq(tvals, jvals)
    _eq(tflags, jflags)                  # booleans convert back
    assert tflags.dtype == torch.bool
    # live entries keep their original relative order in the prefix
    want = vals[live][:K]
    assert list(tvals[tv.live].numpy()) == list(want)
    assert int(tv.n_live) == live.sum()
    assert int(tv.overflow) == max(int(live.sum()) - K, 0)
    # the round trip: live lanes that rode the K lanes come back in place,
    # the others get the fill
    for fill in (0, 7):
        te = tseg.expand_entries(tv, tvals, tflags, fill=fill)
        je = jseg.expand_entries(jv, jvals, jflags, fill=fill)
        for a, b in zip(te, je):
            _eq(a, b)
    _eq(tseg.overflow_mask(T(live), K), jseg.overflow_mask(J(live), K))
    ovf = tseg.overflow_mask(T(live), K).numpy()
    rank = np.cumsum(live) - live
    np.testing.assert_array_equal(ovf, live & (rank >= K))
    if K >= n:
        # the identity view: payloads returned untouched, no sort
        payload = T(vals)
        view, (out,) = tseg.compact_entries(T(live), K, payload)
        assert view.identity and out is payload
        assert tseg.expand_entries(view, out)[0] is out


def _entry_views(seed, B, R):
    jt, ja, tt, ta = _txn_state(seed, B=B, R=R, n_keys=4 * R)
    return (jstate.make_entries(jt, ja, window=1),
            tstate.make_entries(tt, ta, window=1))


@pytest.mark.parametrize("never_aborts", [False, True])
@pytest.mark.parametrize("K,seed", [(8, 20), (40, 21), (96, 22), (200, 23),
                                    (256, 24)])
def test_compact_access_matches_reference(K, seed, never_aborts):
    # B=32, R=8: random cursors leave some active txns with held lanes and
    # no request (the non-retryable class), so the small buckets take the
    # unsafe all-WAIT stall
    B, R = 32, 8
    je, te = _entry_views(seed, B, R)
    rng = np.random.default_rng(seed)
    extras = (rng.random(B * R) < 0.3,
              rng.integers(0, 99, B * R).astype(np.int32))
    kw = dict(cc_alg="CALVIN" if never_aborts else "NO_WAIT",
              compact_lanes=K)
    jdb = jcc_base.compaction_counters(JConfig(**kw))
    tdb = tcc_base.compaction_counters(TConfig(**kw))
    jdb, jac = jcompact.compact_access(JConfig(**kw), jdb, je, B, R,
                                       extras=tuple(J(x) for x in extras))
    tdb, tac = tcompact.compact_access(TConfig(**kw), tdb, te, B, R,
                                       extras=tuple(T(x) for x in extras))
    _views_equal(tac.view, jac.view)
    for f in te._fields:
        _eq(getattr(tac.ent, f), getattr(jac.ent, f))
    for a, b in zip(tac.extras, jac.extras):
        _eq(a, b)
    _eq(tac.unsafe, jac.unsafe)
    _eq(tac.ovf_b, jac.ovf_b)
    for k in tdb:
        _eq(tdb[k], jdb[k])
    # decisions at width K (any masks will do), expanded and folded
    w = tac.ent.key.shape[0]
    dec = [rng.random(w) < 0.4 for _ in range(3)]
    dec = [d & tac.ent.req.numpy() for d in dec]
    got = tcompact.finish_access(tac, te.req, *(T(d) for d in dec),
                                 never_aborts=never_aborts)
    want = jcompact.finish_access(jac, je.req, *(J(d) for d in dec),
                                  never_aborts=never_aborts)
    for a, b in zip(got, want):
        _eq(a, b)
    if K == 8:
        assert bool(tac.unsafe)              # the stall is exercised
    if K >= B * R:
        assert tac.view.identity and not bool(tac.ovf_b.any())


# ---------------------------------------------------------------------------
# 2. the engine against the JAX package

#: the JAX package's parity geometry (tests/test_compaction.py): high
#: contention keeps cursors low and admit_cap=4 staggers admission, so
#: these buckets never spill (MAAT validates over every granted lane of a
#: live txn, and CALVIN requests every access: both need wider ones)
NOSPILL = dict(batch_size=16, req_per_query=8, synth_table_size=128,
               zipf_theta=0.8, query_pool_size=256, admit_cap=4,
               warmup_ticks=0)
NOSPILL_K = {"MAAT": 112, "CALVIN": 120}
#: B*R = 640 > 256, so compact_auto engages (K = 512) and spills under
#: several plugins; compact_lanes=200 spills under all seven
SPILL = dict(batch_size=64, req_per_query=10, synth_table_size=4096,
             zipf_theta=0.6, query_pool_size=1024, warmup_ticks=0)
TICKS = 20

GRID = [("nospill", cc, dict(compact_lanes=NOSPILL_K.get(cc, 96)))
        for cc in PLUGINS]
GRID += [("spill", cc, dict(compact_lanes=200)) for cc in PLUGINS]
GRID += [("spill", cc, dict(compact_auto=True))
         for cc in ("NO_WAIT", "TIMESTAMP", "MVCC", "OCC", "MAAT")]
GRID += [(w, cc, dict(compact_auto=True)) for w in ("tpcc", "pps")
         for cc in ("NO_WAIT", "OCC", "MAAT")]
GRID += [
    ("spill", "NO_WAIT", dict(compact_auto=True, commit_after_access=True)),
    ("spill", "MAAT", dict(compact_auto=True, commit_after_access=True)),
    # the sub-tick and window paths bypass compaction: counters stay 0
    ("spill", "NO_WAIT", dict(compact_auto=True, sub_ticks=2)),
    ("pps", "WAIT_DIE", dict(compact_auto=True, dense_lock_state=True)),
    ("spill", "NO_WAIT", dict(compact_auto=True,
                              isolation_level="READ_UNCOMMITTED")),
    ("spill", "NO_WAIT", dict(compact_auto=True, fused_arbitrate=True)),
]
GEOMETRY = {"nospill": NOSPILL, "spill": SPILL, "tpcc": TPCC, "pps": PPS}


def _id(case):
    g, cc, over = case
    return "-".join([g, cc] + [f"{k}={v}" for k, v in over.items()])


@pytest.mark.parametrize("case", GRID, ids=[_id(c) for c in GRID])
def test_compaction_matches_reference(case):
    geometry, cc, over = case
    jfused.reset_fallbacks()
    kw = dict(GEOMETRY[geometry], cc_alg=cc, **over)
    s, eng, st = run_both_orders(kw, n_ticks=TICKS)
    assert "live_entry_cnt" in s and "compact_overflow_cnt" in s
    n = st.txn.keys.numel()
    bypass = "sub_ticks" in over or "dense_lock_state" in over
    if bypass:
        assert s["live_entry_cnt"] == s["compact_overflow_cnt"] == 0
    else:
        assert s["live_entry_cnt"] > 0
    if geometry == "nospill":
        assert s["compact_overflow_cnt"] == 0
    if over.get("compact_lanes") == 200:
        assert s["compact_overflow_cnt"] > 0
    if over.get("compact_auto") and geometry != "nospill" and not bypass:
        assert eng.cfg.compact_width(n, eng.cfg.batch_size) < n
    if over.get("fused_arbitrate"):
        # the reference ran its Pallas kernel (interpret mode)
        assert jfused.fallback_snapshot()["count"] == 0


#: one txn touches a row twice (tests/test_parity.py
#: test_duplicate_key_txns_terminate_and_commit): a txn's held and
#: request lanes on one row tie on (row, ts), and compaction's classes
#: must keep their order
REPEATED_KEYS = [[5, 5], [9, 9], [5, 9], [7, 8]]


@pytest.mark.parametrize("cc", PLUGINS)
def test_repeated_key_pool_under_compaction(cc):
    keys = np.asarray(REPEATED_KEYS, np.int32)
    pool = t_engine._pool(keys, np.ones_like(keys, bool))
    kw = dict(cc_alg=cc, batch_size=4, synth_table_size=64,
              req_per_query=2, query_pool_size=4, warmup_ticks=0,
              compact_lanes=6)
    # CALVIN's FIFO queue on a row one txn requests twice stalls it here,
    # padded or compacted; the runs are still held equal
    s, _, _ = run_both_orders(kw, n_ticks=12, pool=pool,
                              min_commits=int(cc != "CALVIN"))
    assert s["live_entry_cnt"] > 0 and s["compact_overflow_cnt"] > 0


# ---------------------------------------------------------------------------
# 3. in the port alone


def _counts(s):
    return {k: v for k, v in s.items()
            if k not in ("live_entry_cnt", "compact_overflow_cnt")}


@pytest.mark.parametrize("cc", PLUGINS)
def test_bucket_that_never_spills_gives_the_padded_counts(cc):
    padded = TEngine(TConfig(**NOSPILL, cc_alg=cc), device="cpu")
    comp = TEngine(TConfig(**NOSPILL, cc_alg=cc,
                           compact_lanes=NOSPILL_K.get(cc, 96)),
                   pool=padded.pool, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sp = padded.summary(padded.run(TICKS))
        sc = comp.summary(comp.run(TICKS))
    assert sc["compact_overflow_cnt"] == 0 and sc["live_entry_cnt"] > 0
    assert "live_entry_cnt" not in sp
    assert _counts(sc) == sp


def test_compact_cells_are_their_cells_with_the_flag():
    # the four full-size cells are their flagless cells plus compact_auto,
    # at the K their docstring gives (B*R from the pool's width R)
    from deneva_tpu_torch import cells
    want = {"headline_compact": ("headline", 10, 49_152),
            "tpcc_compact": ("tpcc", 33, 147_456),
            "headline_mvcc_compact": ("headline_mvcc", 10, 49_152),
            "headline_maat_compact": ("headline_maat", 10, 49_152)}
    for name, kw in cells.CELLS.items():
        if name in want:
            base, R, K = want[name]
            assert kw == dict(cells.CELLS[base], compact_auto=True)
            cfg = cells.config(name)
            B = cfg.batch_size
            assert cfg.compact_width(B * R, B) == K < B * R
        else:
            assert not kw.get("compact_auto") and \
                kw.get("compact_lanes") is None, name
