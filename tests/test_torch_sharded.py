"""The port's sharded engine (deneva_tpu_torch.parallel, device="cpu")
against the JAX package's ShardedEngine on the 8 virtual CPU devices of
tests/conftest.py: one numpy-seeded QueryPool goes to both engines, and
the summary() dict, the [summary] line (less the host-process keys
mem_util and cpu_util), every node's data and CC row state (MVCC's rings
less their scratch cells), the txn slots, the per-node shard counters and
the write-count oracle must be equal, under NO_WAIT, WAIT_DIE, TIMESTAMP
and MVCC.  Also the routing pieces (pack_by_dest, unpack, the exchange)
on random inputs, exchange_capacity over a grid, and the rebase's shift
and the owners' ring scratch.  All comparisons are exact.

The reference is imported inside the helpers, so the card-only cases at
the end (marked ``cuda``) also run on a host without JAX:

    python -m pytest -q -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_sharded.py
"""

import functools
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu_torch import cc as tcc  # noqa: E402
from deneva_tpu_torch.cc import mvcc as tmvcc  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.ops import segment as tseg  # noqa: E402
from deneva_tpu_torch.parallel import routing as trouting  # noqa: E402
from deneva_tpu_torch.parallel.sharded import (  # noqa: E402
    SHARD_STAT_KEYS, ShardedEngine as TEngine, exchange_capacity,
)
from deneva_tpu_torch.workloads import ycsb as tycsb  # noqa: E402

TXN_FIELDS = ("status", "cursor", "ts", "pool_idx", "restarts",
              "backoff_until", "start_tick", "first_start_tick", "keys",
              "is_write", "n_req", "txn_type")


def shard_kw(n, **kw):
    """tests/test_sharded.py's shard_cfg: B=32, 4096 rows, R=4."""
    base = dict(node_cnt=n, part_cnt=n, batch_size=32,
                synth_table_size=1 << 12, req_per_query=4,
                query_pool_size=1 << 10, zipf_theta=0.6, tup_read_perc=0.5,
                warmup_ticks=0, mpr=1.0, part_per_txn=n)
    base.update(kw)
    return base


def _jpool(pool):
    from deneva_tpu.workloads.base import QueryPool as JPool
    return JPool(**{f: getattr(pool, f) for f in (
        "keys", "is_write", "n_req", "home_part", "txn_type", "args",
        "aux")})


def _line(line):
    return [kv for kv in line.split(",")
            if not kv.startswith(("mem_util=", "cpu_util="))]


@functools.lru_cache(maxsize=None)
def _shared_ref(items):
    """The reference engine of a config, kept for the module: a second
    test of the config reuses its compiled tick.  Only for tests that
    patch nothing of the reference."""
    from deneva_tpu.config import Config as JConfig
    from deneva_tpu.parallel.sharded import ShardedEngine as JEngine
    kw = dict(items)
    return JEngine(JConfig(**kw),
                   pool=_jpool(tycsb.gen_query_pool(TConfig(**kw))))


def _engines(kw, shared=False, ref_kw=None):
    """The reference's and the port's engines on one pool; the reference
    runs `ref_kw` where given (the port's config less a flag that does not
    change its values)."""
    from deneva_tpu.config import Config as JConfig
    from deneva_tpu.parallel.sharded import ShardedEngine as JEngine
    pool = tycsb.gen_query_pool(TConfig(**kw))
    ref_kw = kw if ref_kw is None else ref_kw
    je = (_shared_ref(tuple(sorted(ref_kw.items()))) if shared
          else JEngine(JConfig(**ref_kw), pool=_jpool(pool)))
    return je, TEngine(TConfig(**kw), pool=pool, device="cpu")


def _assert_parity(je, js, te, ts):
    a, b = je.summary(js), te.summary(ts)
    assert a == b, {k: (a[k], b.get(k)) for k in a if a[k] != b.get(k)}
    assert _line(je.summary_line(js)) == _line(te.summary_line(ts))
    np.testing.assert_array_equal(np.asarray(js.data), ts.data.numpy())
    for f in TXN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js.txn, f)),
                                      getattr(ts.txn, f).numpy(), err_msg=f)
    for k in SHARD_STAT_KEYS:
        np.testing.assert_array_equal(np.asarray(js.stats[k]),
                                      ts.stats[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(np.asarray(js.pool_cursor),
                                  ts.pool_cursor.numpy())
    np.testing.assert_array_equal(np.asarray(js.ts_counter),
                                  ts.ts_counter.numpy())
    # every node's CC row state; MVCC's rings less the scratch cells the
    # port's carry past n_rows*H
    assert sorted(js.db) == sorted(ts.db)
    for k, v in js.db.items():
        want = np.asarray(v)
        got = ts.db[k].numpy()
        if k.endswith("_ring"):
            got = got[:, :want.shape[1]]
        np.testing.assert_array_equal(want, got, err_msg=k)
    # increment oracle: every committed write applied exactly once
    assert je.global_data_sum(js) == te.global_data_sum(ts) \
        == b["write_cnt"]
    return b


def _run_both(kw, chunks, compiled=False, shared=False, ref_kw=None):
    je, te = _engines(kw, shared, ref_kw)
    js = ts = None
    for n in chunks:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            js = (je.run_compiled if compiled else je.run)(n, js)
        ts = (te.run_compiled if compiled else te.run)(n, ts)
    return je, js, te, ts


@pytest.fixture
def ref_fused(monkeypatch):
    """The reference's fused sharded tick on this JAX release: its
    shard_map checks that every output names how it varies over the mesh,
    which the reference's pallas_call does not declare, so its trace
    raises.  Turning the check off changes no value; the JAX package is
    not edited."""
    from deneva_tpu.ops import fused as jfused
    from deneva_tpu.parallel import sharded as jsharded
    monkeypatch.setattr(jsharded, "shard_map",
                        functools.partial(jsharded.shard_map,
                                          check_vma=False))
    jfused.reset_fallbacks()
    return jfused


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

ROUTE_CASES = [
    # (entries, nodes, capacity, seed): spare room, overflow, one node
    (64, 4, 16, 1), (200, 4, 20, 2), (96, 2, 8, 3), (50, 1, 50, 4),
    (40, 4, 10, 6),
    (333, 8, 11, 5),
]


def _route_inputs(n, n_nodes, seed):
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, n_nodes, n).astype(np.int32)
    prio = rng.integers(0, 3, n).astype(np.int32)
    live = rng.random(n) < 0.7
    key = np.where(live, rng.integers(0, 1 << 20, n), 2**31 - 1)
    fields = {"key": key.astype(np.int32),
              "ts": rng.integers(1, 1 << 30, n).astype(np.int32),
              "flags": rng.integers(0, 16, n).astype(np.int32)}
    return dest, prio, live, fields


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n,n_nodes,cap,seed", ROUTE_CASES)
def test_pack_and_unpack_match_reference(n, n_nodes, cap, seed, fused):
    import jax.numpy as jnp
    from deneva_tpu.parallel import routing as jrouting
    dest, prio, live, fields = _route_inputs(n, n_nodes, seed)
    js, jo, jov = jrouting.pack_by_dest(
        jnp.asarray(dest), jnp.asarray(prio), jnp.asarray(live), n_nodes,
        cap, {k: jnp.asarray(v) for k, v in fields.items()})
    with tseg.fused_scope(TConfig(fused_arbitrate=fused)):
        ts, to, tov = trouting.pack_by_dest(
            torch.from_numpy(dest), torch.from_numpy(prio),
            torch.from_numpy(live), n_nodes, cap,
            {k: torch.from_numpy(v) for k, v in fields.items()})
    for k in fields:
        np.testing.assert_array_equal(np.asarray(js[k]), ts[k].numpy(), k)
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(np.asarray(jov), tov.numpy())
    # the live entries past each destination's capacity overflow
    per = np.bincount(dest[live], minlength=n_nodes)
    assert int(tov.sum()) == int(np.maximum(per - cap, 0).sum())

    # results come back through the permutation; unshipped entries keep
    # their defaults
    rng = np.random.default_rng(seed + 100)
    res = rng.integers(0, 1 << 10, (n_nodes, cap)).astype(np.int32)
    dflt = np.full(n + 1, 1 << 3, np.int32)
    jg = jrouting.unpack({"d": jnp.asarray(res)}, jo, n,
                         {"d": jnp.asarray(dflt)})
    tg = trouting.unpack({"d": torch.from_numpy(res)}, to, n,
                         {"d": torch.from_numpy(dflt)})
    np.testing.assert_array_equal(np.asarray(jg["d"]), tg["d"].numpy())


@pytest.mark.parametrize("n_nodes", [2, 4, 8])
def test_exchange_matches_reference_all_to_all(n_nodes):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from deneva_tpu.compat import shard_map
    from deneva_tpu.parallel import routing as jrouting
    cap = 5
    rng = np.random.default_rng(n_nodes)
    sends = rng.integers(0, 1 << 20, (n_nodes, n_nodes, cap)).astype(
        np.int32)
    mesh = Mesh(np.array(jax.devices()[:n_nodes]), ("node",))
    f = shard_map(
        lambda x: jrouting.exchange({"k": x[0]}, "node")["k"][None],
        mesh=mesh, in_specs=(P("node"),), out_specs=P("node"))
    want = np.asarray(jax.jit(f)(jnp.asarray(sends)))
    got = trouting.exchange([{"k": torch.from_numpy(s)} for s in sends])
    for d in range(n_nodes):
        np.testing.assert_array_equal(want[d], got[d]["k"].numpy())


@pytest.mark.parametrize("alg", ["NO_WAIT", "CALVIN"])
def test_exchange_capacity_matches_reference(alg):
    from deneva_tpu import cc as jcc
    from deneva_tpu.config import Config as JConfig
    from deneva_tpu.parallel.sharded import exchange_capacity as jcap
    for n in (1, 2, 4, 8, 16, 64):
        for B in (16, 256, 8192):
            for R in (4, 10, 33):
                for f in (0.05, 0.5, 2.0, 4.0):
                    for split in (False, True) if n > 1 else (False,):
                        kw = dict(node_cnt=n, part_cnt=n, cc_alg=alg,
                                  route_capacity_factor=f,
                                  synth_table_size=1 << 12,
                                  exchange_split=split)
                        try:
                            want = jcap(JConfig(**kw), jcc.get(alg), B, R)
                        except ValueError:
                            with pytest.raises(ValueError, match="2\\^23"):
                                exchange_capacity(TConfig(**kw),
                                                  tcc.get(alg), B, R)
                            continue
                        assert exchange_capacity(TConfig(**kw), tcc.get(alg),
                                                 B, R) == want, kw
    # the full-size cell: 40,960 lanes per (src, dst), 245,760 at an owner
    cfg = TConfig(node_cnt=4, part_cnt=4, synth_table_size=1 << 26)
    assert exchange_capacity(cfg, tcc.get("NO_WAIT"), 8192, 10) == 40960


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ENGINE_CASES = {
    # part_per_txn = n, as tests/test_sharded.py; B=16 at 8 nodes
    "n1": (shard_kw(1, part_per_txn=1), [12]),
    "n2": (shard_kw(2), [5, 9]),
    "n4": (shard_kw(4), [14]),
    "n8": (shard_kw(8, batch_size=16), [13]),
    # the greedy window: 4 accesses requested per tick
    "n2_window4": (shard_kw(2, acquire_window=4), [15]),
    # the bench grid's part_per_txn = min(2, n), strict, with a cap
    "n4_ppt2_strict": (shard_kw(4, part_per_txn=2, strict_ppt=True,
                                admit_cap=8, warmup_ticks=3), [15]),
    # no backoff, a first partition not forced local, half multi-part
    "n4_flat_penalty": (shard_kw(4, backoff=False, first_part_local=False,
                                 mpr=0.5, abort_penalty_ticks=2), [15]),
}


#: the plugins admitted beside NO_WAIT: none has a sharded hook, so each
#: runs unchanged on the owner's virtual txns
PLUGINS = ("WAIT_DIE", "TIMESTAMP", "MVCC")
#: fused_arbitrate under MVCC, whose owners sort the most packs, held to
#: the reference's tick without it (its Pallas kernel in interpret mode
#: costs ~45 s here, most of it compiling; the NO_WAIT case below runs
#: it).  The two agree when no sort of the reference's tick can order a
#: tie otherwise than the kernel's stable order: the case asserts that
#: premise (`_ref_sorts`, `_distinct_one_key_sorts`)
FUSED_CASES = {"n2_fused": (shard_kw(2, fused_arbitrate=True), [8])}
ENGINE_PARAMS = (
    [pytest.param(c, "NO_WAIT", id=c) for c in sorted(ENGINE_CASES)]
    + [pytest.param(c, a, id=f"{c}-{a}") for a in PLUGINS
       for c in ("n2", "n4")]
    + [pytest.param("n2_fused", "MVCC", id="n2_fused-MVCC")])


def _ref_sorts(je, js):
    """``(num_keys, is_stable)`` of every sort in the reference's traced
    cluster tick (``make_jaxpr``, no compile)."""
    import jax
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "sort":
                out.append((eqn.params["num_keys"], eqn.params["is_stable"]))
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else (v,):
                    sub = getattr(sub, "jaxpr", sub)
                    if hasattr(sub, "eqns"):
                        walk(sub)

    walk(jax.make_jaxpr(je._tick_raw)(js).jaxpr)
    return out


def _distinct_one_key_sorts(monkeypatch):
    """Asserts that every one-key sort of the port's fused tick (on the
    CPU, the kernel's plain version) sorts distinct keys, and counts the
    sorts."""
    from deneva_tpu_torch.ops import fused as tfused
    plain, sorts = tfused.fused_sort_scan_plain, [0]

    def distinct(operands, num_keys, shift=0):
        if num_keys == 1:
            assert len(torch.unique(operands[0])) == len(operands[0])
        sorts[0] += 1
        return plain(operands, num_keys, shift)

    monkeypatch.setattr(tfused, "fused_sort_scan_plain", distinct)
    return sorts


@pytest.mark.parametrize("case,alg", ENGINE_PARAMS)
def test_engine_matches_reference(case, alg, monkeypatch):
    from deneva_tpu_torch.ops import fused as tfused
    kw, chunks = {**ENGINE_CASES, **FUSED_CASES}[case]
    kw = dict(kw, cc_alg=alg)
    tfused.reset_fallbacks()
    sorts = (_distinct_one_key_sorts(monkeypatch) if case in FUSED_CASES
             else None)
    ref_kw = {k: v for k, v in kw.items() if k != "fused_arbitrate"}
    je, js, te, ts = _run_both(kw, chunks, shared=True, ref_kw=ref_kw)
    s = _assert_parity(je, js, te, ts)
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    assert (s["remote_entry_cnt"] > 0) == (kw["node_cnt"] > 1)
    assert s["commit_defer_cnt"] == 0      # see the deferral test below
    if kw["node_cnt"] > 1 and kw["part_per_txn"] > 1:
        assert s["multi_part_txn_cnt"] > 0
    # with fused_arbitrate every sort of the port's tick took the kernel's
    # path (its plain version on the CPU); with it, every sort of the
    # reference's tick is stable or sorts one key, and the port's one-key
    # sorts (the unpermutes) sort distinct keys: no tie is ordered
    # otherwise
    assert tfused.fallback_snapshot()["count"] == 0
    if sorts is not None:
        ref = _ref_sorts(je, js)
        assert sorts[0] > 0 and ref, ref
        assert all(stable or nk == 1 for nk, stable in ref), ref


def test_fused_engine_matches_reference(ref_fused):
    # the reference runs its Pallas kernel in interpret mode (slow): N=2
    kw = shard_kw(2, fused_arbitrate=True)
    s = _assert_parity(*_run_both(kw, [12]))
    assert s["txn_cnt"] > 0 and s["remote_entry_cnt"] > 0
    # every sort of the reference's tick took its kernel, none fell back
    assert ref_fused.fallback_snapshot()["count"] == 0


@pytest.mark.parametrize("n,alg", [
    pytest.param(2, "NO_WAIT", id="2"), pytest.param(4, "NO_WAIT", id="4"),
    pytest.param(4, "MVCC", id="4-MVCC")])
def test_run_compiled_matches_reference(n, alg):
    _assert_parity(*_run_both(shard_kw(n, cc_alg=alg), [6, 7],
                              compiled=True))


def test_route_overflow_aborts_match_reference():
    # a starved exchange (capacity R): overflowing txns abort, exactly once
    s = _assert_parity(*_run_both(
        shard_kw(2, route_capacity_factor=0.05, zipf_theta=0.0), [20]))
    assert s["route_overflow_abort_cnt"] > 0
    # a committing txn's commit entries are the held entries it shipped on
    # exchange A this tick, which fit the same capacity: exchange B cannot
    # overflow with no network delay
    assert s["commit_defer_cnt"] == 0


def _narrow(pack, cat, full, keep):
    """``pack_by_dest`` whose exchange-B calls (their fields carry "cts")
    keep only the first `keep` lanes of each destination, the send shape
    staying (N, C): commit entries then overflow where exchange A's fit."""
    def wrapped(dest, prio, live, n_nodes, cap, fields):
        if "cts" not in fields:
            return pack(dest, prio, live, n_nodes, cap, fields)
        send, orig, ovf = pack(dest, prio, live, n_nodes, keep, fields)
        pad = lambda v, fill: cat([v, full((n_nodes, cap - keep), fill,
                                           v.dtype)])
        return ({k: pad(v, trouting.FILL.get(k, 0)) for k, v in send.items()},
                pad(orig, -1), ovf)
    return wrapped


def test_commit_deferral_matches_reference(monkeypatch):
    import jax.numpy as jnp
    from deneva_tpu.parallel import routing as jrouting
    monkeypatch.setattr(jrouting, "pack_by_dest", _narrow(
        jrouting.pack_by_dest, lambda xs: jnp.concatenate(xs, axis=1),
        lambda s, v, dt: jnp.full(s, v, dt), keep=2))
    monkeypatch.setattr(trouting, "pack_by_dest", _narrow(
        trouting.pack_by_dest, lambda xs: torch.cat(xs, dim=1),
        lambda s, v, dt: torch.full(s, v, dtype=dt), keep=2))
    s = _assert_parity(*_run_both(shard_kw(2, zipf_theta=0.0), [20]))
    # deferred txns retried and committed later; their shipped entries
    # were masked at the owners (the oracle above holds)
    assert s["commit_defer_cnt"] > 0 and s["txn_cnt"] > 0


def test_read_only_multipartition_never_aborts():
    s = _assert_parity(*_run_both(
        shard_kw(4, txn_read_perc=1.0, zipf_theta=0.9), [15]))
    assert s["total_txn_abort_cnt"] == 0 and s["txn_cnt"] > 0
    assert s["write_cnt"] == 0 and s["remote_entry_cnt"] > 0


#: the CC arrays that hold timestamps (0: never written, stays 0)
TS_ARRAYS = ("wts", "rts", "w_ring", "r_ring", "rts0", "w_floor")


@pytest.mark.parametrize("n,alg", [
    pytest.param(2, "NO_WAIT", id="2"), pytest.param(4, "NO_WAIT", id="4"),
    pytest.param(4, "TIMESTAMP", id="4-TIMESTAMP"),
    pytest.param(4, "MVCC", id="4-MVCC")])
def test_global_rebase_matches_reference(n, alg):
    # every timestamp and counter moved up by one amount, so that the
    # cluster's largest counter sits just under the limit: one admission
    # wave crosses it and every node shifts by (1 << 30) // n * n
    # together, the plugins' arrays too.  The move keeps every order and
    # leaves every in-flight timestamp above the shift, so none clamps to
    # 1 and no two txns tie (the clamped case is the next test)
    import jax.numpy as jnp
    je, js, te, ts = _run_both(shard_kw(n, cc_alg=alg), [4], shared=True)
    limit = (3 << 29) // n
    off = limit - 3 - int(ts.ts_counter.max())
    up = lambda a: (torch if isinstance(a, torch.Tensor) else jnp).where(
        a > 0, a + off * n, 0)
    js = js._replace(ts_counter=js.ts_counter + off,
                     txn=js.txn._replace(ts=js.txn.ts + off * n),
                     db={k: up(v) if k in TS_ARRAYS else v
                         for k, v in js.db.items()})
    ts = ts._replace(ts_counter=ts.ts_counter + off,
                     txn=ts.txn._replace(ts=ts.txn.ts + off * n),
                     db={k: up(v) if k in TS_ARRAYS else v
                         for k, v in ts.db.items()})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = je.run(8, js)
    ts = te.run(8, ts)
    s = _assert_parity(je, js, te, ts)
    assert int(ts.ts_counter.max()) < limit - (1 << 30) // n // 2
    assert s["txn_cnt"] > 0 and int(jnp.min(js.txn.ts)) >= 1


@pytest.fixture
def stable_ref_sort(monkeypatch):
    """The reference's sorts made stable.  Its lock sort is unstable
    (``deneva_tpu/cc/twopl.py``), and XLA's CPU sort orders tied keys its
    own way; the port's sort is stable, ties by lane, as the kernel is.
    The orders differ only where two entries of one row tie on their
    timestamp; the JAX package is not edited."""
    from deneva_tpu.ops import segment as jseg
    sort_pack = jseg.sort_pack
    monkeypatch.setattr(
        jseg, "sort_pack",
        lambda ops, num_keys, is_stable=False: sort_pack(ops, num_keys,
                                                         True))


def _clamp_run(je, js, te, ts, ticks):
    """Both engines `ticks` on, the port tick by tick; returns the states
    and the most in-flight txns the port held at a timestamp of 1."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = je.run(ticks, js)
    clamped = 0
    for _ in range(ticks):
        ts = te.run(1, ts)
        clamped = max(clamped, int(((ts.txn.ts == 1)
                                    & (ts.txn.status != 0)).sum()))
    return js, ts, clamped


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("alg", ["NO_WAIT", "WAIT_DIE"])
def test_clamped_rebase_matches_the_stable_reference(n, alg,
                                                     stable_ref_sort):
    # only the counters set just under the limit: the rebase clamps every
    # in-flight timestamp below the shift to 1, and NO_WAIT and WAIT_DIE
    # keep theirs across restarts, so tied timestamps meet the owners'
    # lock sort (against the unstable reference the port differs here)
    je, js, te, ts = _run_both(shard_kw(n, cc_alg=alg), [4])
    limit = (3 << 29) // n
    off = limit - 1 - int(ts.ts_counter.max())
    js, ts, clamped = _clamp_run(
        je, js._replace(ts_counter=js.ts_counter + off),
        te, ts._replace(ts_counter=ts.ts_counter + off), 10)
    s = _assert_parity(je, js, te, ts)
    assert clamped >= 2
    assert int(ts.ts_counter.max()) < limit - (1 << 30) // n // 2
    assert s["txn_cnt"] > 0


def test_single_shard_clamped_rebase_matches_the_stable_reference(
        stable_ref_sort):
    # the single-shard tick meets the same ties: at 1,024 lanes (B=256,
    # R=4) it too differs from the unstable reference across a clamp
    from deneva_tpu.config import Config as JConfig
    from deneva_tpu.engine.scheduler import Engine as JEngine
    from deneva_tpu_torch.engine.scheduler import Engine
    from tests import test_torch_engine as t_engine
    kw = dict(shard_kw(1, part_per_txn=1), batch_size=256,
              query_pool_size=1 << 11)
    pool = tycsb.gen_query_pool(TConfig(**kw))
    je = JEngine(JConfig(**kw), pool=_jpool(pool))
    te = Engine(TConfig(**kw), pool=pool, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = je.run(4)
    ts = te.run(4)
    off = (3 << 29) - 1 - int(ts.ts_counter)
    js, ts, clamped = _clamp_run(
        je, js._replace(ts_counter=js.ts_counter + off),
        te, ts._replace(ts_counter=ts.ts_counter + off), 6)
    t_engine._assert_parity(je, js, te, ts)
    assert clamped >= 2 and int(ts.ts_counter) < 1 << 30


@pytest.mark.parametrize("alg", ["TIMESTAMP", "MVCC"])
def test_rebase_shift_is_an_int64_scalar_and_state_stays_in_place(
        alg, monkeypatch):
    # on_ts_rebase hands its shift to the rebase kernel, which takes an
    # int64 scalar on the arrays' device (ops/rebase.py), as the
    # single-shard tick passes it; the CPU's plain version takes any
    # integer, so a spy checks it.  Every plugin array stays the stacked
    # tensor, updated in place through the node views (no copy a tick)
    kw = shard_kw(2, cc_alg=alg)
    te = TEngine(TConfig(**kw), pool=tycsb.gen_query_pool(TConfig(**kw)),
                 device="cpu")
    cls = type(te.plugin)
    hook = cls.on_ts_rebase
    shifts = []

    def spy(self, cfg, db, shift):
        shifts.append(shift)
        return hook(self, cfg, db, shift)

    monkeypatch.setattr(cls, "on_ts_rebase", spy)
    st = te.init_state()
    ptrs = {k: v.data_ptr() for k, v in st.db.items()}
    st = te.run(3, st)
    st = te.run(3, st._replace(
        ts_counter=st.ts_counter + (3 << 29) // 2 - 1
        - int(st.ts_counter.max())))
    assert len(shifts) == 6 * 2                  # a node a tick
    assert all(x.dtype == torch.int64 and x.dim() == 0
               and x.device == st.ts_counter.device for x in shifts)
    by = [int(x) for x in shifts]
    assert sorted(set(by)) == [0, (1 << 30) // 2 * 2] and by.count(0) == 10
    assert {k: v.data_ptr() for k, v in st.db.items()} == ptrs


def test_mvcc_rings_carry_the_owners_scratch():
    # an owner's on_commit sees N*C + B*R single-access txns, so its
    # version insert stores K = merge_lanes(cfg, N*C + B*R, 1) lanes, more
    # than the scratch of rings sized for a home node's B x R txns
    kw = shard_kw(2, cc_alg="MVCC")
    cfg = TConfig(**kw)
    te = TEngine(cfg, pool=tycsb.gen_query_pool(cfg), device="cpu")
    st = te.run(6)
    H = cfg.his_recycle_len
    K = tmvcc.merge_lanes(cfg, 2 * te.cap + 32 * 4, 1)
    assert K > tmvcc.merge_lanes(cfg, 32, 4)
    rows = te.n_rows // 2
    assert st.db["w_ring"].shape == st.db["r_ring"].shape == (2, rows * H
                                                               + K)
    # the plugin's view of a node's rows is the n_rows*H prefix
    vis = te.plugin.visible(cfg, {k: v[0] for k, v in st.db.items()})
    assert vis["w_ring"].shape == (rows * H,) and bool(
        (vis["w_ring"] > 0).any())
    assert te.summary(st)["txn_cnt"] > 0


def test_sharded_cells_are_the_headline_grid():
    # the full-size cells: headline_sharded4 under each admitted plugin
    from deneva_tpu_torch import cells
    from deneva_tpu_torch.engine.scheduler import check_sharded_slice
    for alg in ("NO_WAIT",) + PLUGINS:
        name = "headline_sharded4" + (
            "" if alg == "NO_WAIT" else "_" + alg.lower())
        assert cells.CELLS[name] == dict(cells.CELLS["headline_sharded4"],
                                         cc_alg=alg)
        check_sharded_slice(cells.config(name))


def test_summary_sums_nodes_in_node_order():
    kw = shard_kw(4)
    te = TEngine(TConfig(**kw), pool=tycsb.gen_query_pool(TConfig(**kw)),
                 device="cpu")
    ts = te.run(10)
    s = te.summary(ts)
    per = ts.stats["txn_cnt"].numpy()
    assert s["txn_cnt"] == int(per.sum()) and len(per) == 4
    assert s["measured_ticks"] == 10
    assert s["ccl_valid"] == int(ts.stats["lat_ring_cursor"].sum())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

SMALL = dict(cc_alg="NO_WAIT", batch_size=256, synth_table_size=2 << 14,
             req_per_query=10, zipf_theta=0.6, tup_read_perc=0.5,
             query_pool_size=1 << 13, warmup_ticks=0, backoff=True,
             admit_cap=1024, node_cnt=2, part_cnt=2, part_per_txn=2)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _same(a, b):
    for f in TXN_FIELDS:
        assert torch.equal(getattr(a.txn, f).cpu(), getattr(b.txn, f).cpu()), f
    assert torch.equal(a.data.cpu(), b.data.cpu())
    for k in a.stats:
        assert torch.equal(a.stats[k].cpu(), b.stats[k].cpu()), k
    assert sorted(a.db) == sorted(b.db)
    for k in a.db:
        assert torch.equal(a.db[k].cpu(), b.db[k].cpu()), k


#: a node's sort launches a tick by plugin (routing A and B, the owner's
#: lock or decision sort and unpermute, MVCC's version insert) and its
#: rebase launches by rule
CUDA_SORTS = {"NO_WAIT": 4, "WAIT_DIE": 4, "TIMESTAMP": 4, "MVCC": 5}
CUDA_REBASES = {"NO_WAIT": {}, "WAIT_DIE": {}, "TIMESTAMP": {"plain": 1},
                "MVCC": {"ring": 1, "plain": 1}}


def _rebase_launches(before):
    from deneva_tpu_torch.ops import rebase
    return {k: v - before.get(k, 0) for k, v in rebase.LAUNCHES.items()
            if v != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["NO_WAIT", "WAIT_DIE", "TIMESTAMP",
                                 "MVCC"])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("over", [{}, {"route_capacity_factor": 0.1}],
                         ids=["plain", "overflow"])
def test_sharded_cuda_matches_cpu_and_replay(dev, fused, over, alg):
    from deneva_tpu_torch.ops import fused as tfused
    from deneva_tpu_torch.ops import rebase
    kw = dict(SMALL, fused_arbitrate=fused, cc_alg=alg, **over)
    pool = tycsb.gen_query_pool(TConfig(**kw))
    cpu = TEngine(TConfig(**kw), pool=pool, device="cpu")
    gpu = TEngine(TConfig(**kw), pool=pool, device=dev)
    sc = cpu.run(20)
    n0, r0 = tfused.LAUNCHES, dict(rebase.LAUNCHES)
    sg = gpu.run(20)
    assert tfused.LAUNCHES - n0 == (CUDA_SORTS[alg] * 2 * 20 if fused
                                    else 0)
    assert _rebase_launches(r0) == {k: v * 2 * 20
                                    for k, v in CUDA_REBASES[alg].items()}
    assert cpu.summary(sc) == gpu.summary(sg)
    _same(sc, sg)
    sr = TEngine(TConfig(**kw), pool=pool, device=dev).run_compiled(20)
    _same(sc, sr)


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["TIMESTAMP", "MVCC"])
def test_sharded_cuda_rebase_matches_cpu(dev, alg):
    # the counters set just under the limit: the rebase kernel shifts the
    # plugin's arrays on every node by the engine's int64 shift, and
    # in-flight timestamps clamp to 1
    kw = dict(SMALL, fused_arbitrate=True, cc_alg=alg)
    pool = tycsb.gen_query_pool(TConfig(**kw))
    cpu = TEngine(TConfig(**kw), pool=pool, device="cpu")
    gpu = TEngine(TConfig(**kw), pool=pool, device=dev)
    sc, sg = cpu.run(4), gpu.run(4)
    off = (3 << 29) // 2 - 1 - int(sc.ts_counter.max())
    sc = cpu.run(10, sc._replace(ts_counter=sc.ts_counter + off))
    sg = gpu.run(10, sg._replace(ts_counter=sg.ts_counter + off))
    assert int(sc.ts_counter.max()) < 1 << 29
    assert cpu.summary(sc) == gpu.summary(sg)
    _same(sc, sg)
