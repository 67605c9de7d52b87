"""The port's sharded engine (deneva_tpu_torch.parallel, device="cpu")
against the JAX package's ShardedEngine on the 8 virtual CPU devices of
tests/conftest.py: one numpy-seeded QueryPool goes to both engines, and
the summary() dict, the [summary] line (less the host-process keys
mem_util and cpu_util), every node's data, the txn slots, the per-node
shard counters and the write-count oracle must be equal.  Also the
routing pieces (pack_by_dest, unpack, the exchange) on random inputs and
exchange_capacity over a grid.  All comparisons are exact.

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


def _engines(kw):
    from deneva_tpu.config import Config as JConfig
    from deneva_tpu.parallel.sharded import ShardedEngine as JEngine
    pool = tycsb.gen_query_pool(TConfig(**kw))
    return (JEngine(JConfig(**kw), pool=_jpool(pool)),
            TEngine(TConfig(**kw), pool=pool, device="cpu"))


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
    # increment oracle: every committed write applied exactly once
    assert je.global_data_sum(js) == te.global_data_sum(ts) \
        == b["write_cnt"]
    return b


def _run_both(kw, chunks, compiled=False):
    je, te = _engines(kw)
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


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_reference(case):
    kw, chunks = ENGINE_CASES[case]
    s = _assert_parity(*_run_both(kw, chunks))
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    assert (s["remote_entry_cnt"] > 0) == (kw["node_cnt"] > 1)
    assert s["commit_defer_cnt"] == 0      # see the deferral test below
    if kw["node_cnt"] > 1 and kw["part_per_txn"] > 1:
        assert s["multi_part_txn_cnt"] > 0


def test_fused_engine_matches_reference(ref_fused):
    # the reference runs its Pallas kernel in interpret mode (slow): N=2
    kw = shard_kw(2, fused_arbitrate=True)
    s = _assert_parity(*_run_both(kw, [12]))
    assert s["txn_cnt"] > 0 and s["remote_entry_cnt"] > 0
    # every sort of the reference's tick took its kernel, none fell back
    assert ref_fused.fallback_snapshot()["count"] == 0


@pytest.mark.parametrize("n", [2, 4])
def test_run_compiled_matches_reference(n):
    _assert_parity(*_run_both(shard_kw(n), [6, 7], compiled=True))


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


@pytest.mark.parametrize("n", [2, 4])
def test_global_rebase_matches_reference(n):
    # every timestamp and counter moved up by one amount, so that the
    # cluster's largest counter sits just under the limit: one admission
    # wave crosses it and every node shifts by (1 << 30) // n * n
    # together.  The move keeps every order and leaves every in-flight
    # timestamp above the shift, so none clamps to 1 and no two txns tie
    # (the reference's lock sort is unstable: a tie's order is XLA's)
    import jax.numpy as jnp
    je, js, te, ts = _run_both(shard_kw(n), [4])
    limit = (3 << 29) // n
    off = limit - 3 - int(ts.ts_counter.max())
    js = js._replace(ts_counter=js.ts_counter + off,
                     txn=js.txn._replace(ts=js.txn.ts + off * n))
    ts = ts._replace(ts_counter=ts.ts_counter + off,
                     txn=ts.txn._replace(ts=ts.txn.ts + off * n))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = je.run(8, js)
    ts = te.run(8, ts)
    s = _assert_parity(je, js, te, ts)
    assert int(ts.ts_counter.max()) < limit - (1 << 30) // n // 2
    assert s["txn_cnt"] > 0 and int(jnp.min(js.txn.ts)) >= 1


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


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("over", [{}, {"route_capacity_factor": 0.1}],
                         ids=["plain", "overflow"])
def test_sharded_cuda_matches_cpu_and_replay(dev, fused, over):
    from deneva_tpu_torch.ops import fused as tfused
    kw = dict(SMALL, fused_arbitrate=fused, **over)
    pool = tycsb.gen_query_pool(TConfig(**kw))
    cpu = TEngine(TConfig(**kw), pool=pool, device="cpu")
    gpu = TEngine(TConfig(**kw), pool=pool, device=dev)
    sc = cpu.run(20)
    n0 = tfused.LAUNCHES
    sg = gpu.run(20)
    assert tfused.LAUNCHES - n0 == (4 * 2 * 20 if fused else 0)
    assert cpu.summary(sc) == gpu.summary(sg)
    _same(sc, sg)
    sr = TEngine(TConfig(**kw), pool=pool, device=dev).run_compiled(20)
    _same(sc, sr)
