"""``Engine.run_compiled`` of the port on the CPU: the tick with its count,
its warm-up gate and its effect branches on the device, run in a host
loop.  It is held bit-equal to the JAX package's ``run_compiled`` (one
``fori_loop``) and to the port's eager ``run`` on one shared pool:
``summary()``, the ``[summary]`` line (less ``mem_util``/``cpu_util``),
``data``, every table and the effect bodies taken.  A guard makes every
host read of a tensor raise while ``run_compiled`` ticks, so a host read
brought back into the tick fails here, without a card; under TIMESTAMP
that holds for TPC-C restock chains of any depth.  OCC's fixed point is
the one exception on the CPU: ``ops/device_loop.py``'s host loop stands in
for the graph's WHILE node and reads its flag once per pass, so the guard
lets reads from that file through and counts them (the card's replayed
tick makes none, ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
Every comparison is exact (integers).  The CUDA-graph twin of these
checks is in ``tests/test_torch_cuda.py``."""

import contextlib
import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine.scheduler import Engine as JEngine  # noqa: E402
from deneva_tpu.workloads.base import QueryPool as JPool  # noqa: E402
from deneva_tpu_torch import workloads as wl_registry  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.ops import device_loop  # noqa: E402
from deneva_tpu_torch.workloads import base, pps, tpcc  # noqa: E402
from tests import test_torch_mvcc as t_mv  # noqa: E402
from tests import test_torch_timestamp as t_to  # noqa: E402

POOL_FIELDS = ("keys", "is_write", "n_req", "home_part", "txn_type", "args",
               "aux")

#: small configs of the three workloads; the warm-up ends inside the first
#: of two calls of 7 ticks (neither a multiple of the 3 flush phases)
WORKLOADS = {
    "ycsb": dict(batch_size=64, synth_table_size=256, req_per_query=4,
                 query_pool_size=512, zipf_theta=0.9),
    "tpcc": dict(workload="TPCC", batch_size=64, num_wh=4,
                 cust_per_dist=1000, max_items=128, query_pool_size=1024),
    "pps": dict(workload="PPS", batch_size=64, max_part_key=128,
                max_product_key=128, max_supplier_key=128, max_parts_per=5,
                query_pool_size=512),
}
CHUNKS = (7, 7)
WARMUP = 4


def _kw(workload, cc, fused, **over):
    kw = dict(WORKLOADS[workload], cc_alg=cc, fused_arbitrate=fused,
              warmup_ticks=WARMUP)
    kw.update(over)
    return kw


def _line(eng, state):
    return [kv for kv in eng.summary_line(state).split(",")
            if not kv.startswith(("mem_util=", "cpu_util="))]


def _tables(state):
    return {k: np.asarray(v) for k, v in state.tables.items()}


def _assert_same(a_eng, a, b_eng, b):
    """Summary, [summary] line, data and tables of two flushed runs."""
    sa, sb = a_eng.summary(a), b_eng.summary(b)
    assert sa == sb, {k: (sa[k], sb.get(k)) for k in sa if sa[k] != sb.get(k)}
    assert _line(a_eng, a) == _line(b_eng, b)
    np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
    ta, tb = _tables(a), _tables(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    return sb


def _engines(kw):
    """The JAX engine and two port engines (compiled, eager) on one pool."""
    cfg = TConfig(**kw)
    pool = wl_registry.get(cfg).gen_pool(cfg)
    je = JEngine(JConfig(**kw),
                 pool=JPool(**{f: getattr(pool, f) for f in POOL_FIELDS}))
    return (je, TEngine(cfg, pool=pool, device="cpu"),
            TEngine(cfg, pool=pool, device="cpu"))


def _run(run, chunks):
    state = None
    for n in chunks:
        state = run(n, state)
    return state


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("cc", ["NO_WAIT", "WAIT_DIE", "TIMESTAMP"])
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_run_compiled_matches_reference_and_run(workload, cc, fused):
    # the reference in one call (one compile of its fori_loop), the port's
    # run_compiled and run split across calls
    je, tc, te = _engines(_kw(workload, cc, fused))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the JAX gate's width fallback
        js = je.run_compiled(sum(CHUNKS))
    ts = _run(tc.run_compiled, CHUNKS)
    es = _run(te.run, CHUNKS)
    s = _assert_same(je, js, tc, ts)
    _assert_same(te, es, tc, ts)
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    assert int(ts.tick) == ts.host_tick == sum(CHUNKS)
    assert tc.workload.counts() == te.workload.counts()
    if cc != "NO_WAIT" and workload != "tpcc":
        assert s["twopl_wait_cnt"] > 0
    if cc == "TIMESTAMP":
        for k in ("wts", "rts"):
            np.testing.assert_array_equal(np.asarray(js.db[k]),
                                          ts.db[k].numpy(), err_msg=k)
            assert torch.equal(es.db[k], ts.db[k]), k


def test_warmup_boundary_inside_a_call():
    # warm-up of 5 ticks inside a call of 9: the counters move only from
    # tick 5 on, as in the reference
    kw = _kw("ycsb", "NO_WAIT", False, warmup_ticks=5)
    je, tc, te = _engines(kw)
    _assert_same(je, je.run_compiled(9), tc, tc.run_compiled(9))
    cold = _engines(dict(kw, warmup_ticks=9))[1]
    assert cold.summary(cold.run_compiled(9))["txn_cnt"] == 0
    assert tc.summary(tc.run_compiled(0))["txn_cnt"] == 0


@pytest.mark.parametrize("workload,over", [
    ("tpcc", dict(num_wh=16, wh_update=False)), ("pps", {})],
    ids=["tpcc", "pps"])
def test_full_width_effect_ticks(workload, over, monkeypatch):
    # K = 4 effect lanes (patched into the port only) sends the ticks with
    # more than 4 effect entries to the full-width body and the rest to the
    # compacted one; both give the reference's tables, eager and compiled
    mod = {"tpcc": tpcc, "pps": pps}[workload]
    monkeypatch.setattr(mod, "effect_lanes", lambda cfg, n: 4)
    je, tc, te = _engines(_kw(workload, "NO_WAIT", False, **over))
    js = je.run_compiled(14)
    _assert_same(je, js, tc, tc.run_compiled(14))
    _assert_same(je, js, te, te.run(14))
    bodies = tc.workload.branch_ticks
    assert bodies == te.workload.branch_ticks
    assert bodies["compact"] > 0 and bodies["full"] > 0, bodies


# ---------------------------------------------------------------------------
# no host read while run_compiled ticks
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _no_host_reads(monkeypatch, allow=()):
    """Every host read of a tensor raises, but for those made from a file
    named in `allow`, which go through and are counted by file in the
    dict this yields."""
    seen = {}

    def refuse(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *a, **k):
            caller = os.path.basename(sys._getframe(1).f_code.co_filename)
            if caller in allow:
                seen[caller] = seen.get(caller, 0) + 1
                return orig(self, *a, **k)
            raise AssertionError(f"host read of a tensor: Tensor.{name}")
        return read

    with monkeypatch.context() as m:
        for name in ("item", "__bool__", "__int__", "tolist"):
            m.setattr(torch.Tensor, name, refuse(name))
        yield seen


#: configs whose effect step takes the device branch (B*R > K)
GUARD_CFGS = {
    "ycsb": _kw("ycsb", "WAIT_DIE", True),
    "tpcc": dict(_kw("tpcc", "NO_WAIT", True), batch_size=512, admit_cap=64,
                 num_wh=32, query_pool_size=2048),
    "pps": dict(_kw("pps", "WAIT_DIE", True), batch_size=512, admit_cap=64,
                query_pool_size=1024),
}


@pytest.mark.parametrize("workload", sorted(GUARD_CFGS))
def test_run_compiled_makes_no_host_read(workload, monkeypatch):
    cfg = TConfig(**GUARD_CFGS[workload])
    eng = TEngine(cfg, device="cpu")
    state = eng.init_state()
    with _no_host_reads(monkeypatch):
        state = eng.run_compiled(8, state)
    assert eng.summary(state)["txn_cnt"] > 0
    if workload != "ycsb":
        # the guard bites: the eager tick reads its branch on the host
        assert eng.workload.branch_ticks["compact"] == 8
        with _no_host_reads(monkeypatch), \
                pytest.raises(AssertionError, match="host read"):
            eng.run(1)


@pytest.mark.parametrize("workload", sorted(GUARD_CFGS))
def test_timestamp_run_compiled_makes_no_host_read(workload, monkeypatch):
    # TIMESTAMP's compiled tick: in-place wts/rts, the restock chain in
    # closed form; the eager TPC-C tick reads its effect branch only
    cfg = TConfig(**dict(GUARD_CFGS[workload], cc_alg="TIMESTAMP"))
    eng = TEngine(cfg, device="cpu")
    state = eng.init_state()
    with _no_host_reads(monkeypatch):
        state = eng.run_compiled(8, state)
    s = eng.summary(state)
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    if workload == "tpcc":
        with _no_host_reads(monkeypatch), \
                pytest.raises(AssertionError, match="host read"):
            eng.run(1)


#: MVCC configs of the compiled tick: YCSB on rings of 2 (evictions), and
#: TPC-C at B*R = 16,896 > K = 4096, so the version insert's tail fold is
#: a body that runs on every tick
MVCC_CFGS = {
    "ycsb": _kw("ycsb", "MVCC", False, his_recycle_len=2),
    "tpcc": dict(GUARD_CFGS["tpcc"], cc_alg="MVCC", fused_arbitrate=False),
}


@pytest.mark.parametrize("workload", sorted(MVCC_CFGS))
def test_mvcc_run_compiled_matches_reference(workload, monkeypatch):
    # MVCC's compiled tick under the guard (every host read raises): the
    # rings updated in place, equal to the reference's run_compiled and to
    # the port's eager run, the rings, rts0, w_floor and the tail-fold
    # counter included
    je, tc, te = _engines(MVCC_CFGS[workload])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = je.run_compiled(sum(CHUNKS))
    ts = None
    with _no_host_reads(monkeypatch):
        for n in CHUNKS:
            ts = tc.run_compiled(n, ts)
    es = _run(te.run, CHUNKS)
    s = _assert_same(je, js, tc, ts)
    _assert_same(te, es, tc, ts)
    assert s["txn_cnt"] > 0
    t_mv.assert_mvcc_equal(tc.cfg, js.db, ts.db)
    for k in ts.db:
        assert torch.equal(es.db[k], ts.db[k]), k


#: CALVIN configs of the compiled tick: contended YCSB, TPC-C and PPS at
#: B*R > K; PPS's recon txns sleep one epoch while their read-only shadow
#: requests take part in the arbitration
CALVIN_CFGS = {
    "ycsb": _kw("ycsb", "CALVIN", False),
    "tpcc": dict(GUARD_CFGS["tpcc"], cc_alg="CALVIN", fused_arbitrate=False),
    "pps": dict(GUARD_CFGS["pps"], cc_alg="CALVIN", fused_arbitrate=False),
}


@pytest.mark.parametrize("workload", sorted(CALVIN_CFGS))
def test_calvin_run_compiled_matches_reference(workload, monkeypatch):
    # CALVIN's compiled tick under the guard (every host read raises): the
    # epoch gate and the recon deferral on the device, equal to the
    # reference's run_compiled and to the port's eager run
    je, tc, te = _engines(CALVIN_CFGS[workload])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = je.run_compiled(sum(CHUNKS))
    ts = None
    with _no_host_reads(monkeypatch):
        for n in CHUNKS:
            ts = tc.run_compiled(n, ts)
    es = _run(te.run, CHUNKS)
    s = _assert_same(je, js, tc, ts)
    _assert_same(te, es, tc, ts)
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] == 0
    assert s["twopl_wait_cnt"] > 0
    assert (s["recon_cnt"] > 0) == (workload == "pps")


#: OCC configs of the compiled tick: contended YCSB, TPC-C and PPS at
#: B*R > K
OCC_CFGS = {
    "ycsb": _kw("ycsb", "OCC", False),
    "tpcc": dict(GUARD_CFGS["tpcc"], cc_alg="OCC", fused_arbitrate=False),
    "pps": dict(GUARD_CFGS["pps"], cc_alg="OCC", fused_arbitrate=False),
}


@pytest.mark.parametrize("workload", sorted(OCC_CFGS))
def test_occ_run_compiled_matches_reference(workload, monkeypatch):
    # OCC's compiled tick under the guard: the only host reads are the
    # fixed point's flag, one per pass, all from ops/device_loop.py (on the
    # card a WHILE node of the graph); equal to the reference's
    # run_compiled and to the port's eager run, occ_wcommit included
    je, tc, te = _engines(OCC_CFGS[workload])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = je.run_compiled(sum(CHUNKS))
    ts = None
    device_loop.reset_passes()
    with _no_host_reads(monkeypatch, allow=("device_loop.py",)) as seen:
        for n in CHUNKS:
            ts = tc.run_compiled(n, ts)
    passes = int(device_loop.passes("occ", "cpu"))
    es = _run(te.run, CHUNKS)
    s = _assert_same(je, js, tc, ts)
    _assert_same(te, es, tc, ts)
    assert s["txn_cnt"] > 0 and s["vabort_cnt"] > 0
    for k in ts.db:
        np.testing.assert_array_equal(np.asarray(js.db[k]), ts.db[k].numpy(),
                                      err_msg=k)
        assert torch.equal(es.db[k], ts.db[k]), k
    assert seen == {"device_loop.py": passes}, seen
    assert passes > sum(CHUNKS)


def test_unbounded_effect_chain_reads_the_host(monkeypatch):
    # TIMESTAMP bounds no committers of one STOCK row per tick, and on this
    # config the restock chain runs deeper than 1.  Only the eager tick
    # reads the host, for its effect branch; the chain's closed form reads
    # nothing, so run_compiled ticks under the guard and equals the eager
    # run
    cfg = TConfig(**t_to.DEEP_TPCC)
    pool = wl_registry.get(cfg).gen_pool(cfg)
    te = TEngine(cfg, pool=pool, device="cpu")
    with t_to.restock_depths(monkeypatch) as depths:
        es = te.run(30)
    assert max(depths) > 1, depths
    tc = TEngine(cfg, pool=pool, device="cpu")
    state = tc.init_state()
    with _no_host_reads(monkeypatch):
        state = tc.run_compiled(30, state)
    _assert_same(te, es, tc, state)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_deep_restock_chains_run_compiled_matches_reference(fused):
    # restock chains deeper than one committer per STOCK row (the TPC-C
    # cell of tests/test_parity.py under TIMESTAMP): run_compiled gives the
    # reference's tables, as the eager tick does
    je, tc, _ = _engines(dict(t_to.DEEP_TPCC, fused_arbitrate=fused))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # the JAX gate's width fallback
        js = je.run_compiled(40)
    ts = _run(tc.run_compiled, (15, 25))
    _assert_same(je, js, tc, ts)
    for k in ("wts", "rts"):
        np.testing.assert_array_equal(np.asarray(js.db[k]),
                                      ts.db[k].numpy(), err_msg=k)


# ---------------------------------------------------------------------------
# a body on an empty mask changes nothing (a tick with no commit effect)
# ---------------------------------------------------------------------------


def test_scatter_helpers_on_an_empty_mask():
    rng = np.random.default_rng(0)
    dst = torch.from_numpy(rng.integers(-9, 9, (50, 3)).astype(np.int32))
    want = dst.clone()
    row = torch.from_numpy(rng.integers(0, 50, 70).astype(np.int32))
    vals = torch.from_numpy(rng.integers(-9, 9, (70, 3)).astype(np.int32))
    none = torch.zeros(70, dtype=torch.bool)
    base.add_rows(dst, row, none, vals)
    base.store_rows(dst, row, none, vals)
    assert torch.equal(dst, want)


def _entries(cat, roles_tables, n, seed):
    rng = np.random.default_rng(seed)
    roles = rng.integers(1, len(roles_tables) + 1, n)
    key = np.zeros(n, np.int64)
    for role, tab in roles_tables.items():
        m = roles == role
        t = cat.tables[tab]
        key[m] = t.base + rng.integers(0, t.n_local, int(m.sum()))
    dw = rng.integers(0, 10, n) | (rng.integers(0, 4, n) << 4)
    as_t = lambda a: torch.from_numpy(np.asarray(a).astype(np.int32))
    return (as_t(key), as_t(roles | (dw << 3)),
            as_t(rng.integers(0, 1 << 10, n)),
            as_t(rng.integers(0, 1 << 10, n)),
            as_t(rng.permutation(n) + 1))


@pytest.mark.parametrize("n", [1, 3000])
def test_tpcc_body_on_an_empty_mask(n):
    cfg = TConfig(**_kw("tpcc", "NO_WAIT", False))
    wl = tpcc.TPCCWorkload()
    tables = wl.init_tables(cfg, 0)
    want = {k: v.clone() for k, v in tables.items()}
    key, role, earg, earg2, cts = _entries(
        tpcc.catalog(cfg), {1: "WAREHOUSE", 2: "DISTRICT", 3: "CUSTOMER",
                            4: "DISTRICT", 5: "STOCK"}, n, 1)
    none = torch.zeros(n, dtype=torch.bool)
    wl._apply_entries_body(cfg, tables, key, 0, role, earg, earg2, cts,
                           none)
    for k in want:
        assert torch.equal(tables[k], want[k]), k   # cursors included


def test_pps_body_on_an_empty_mask():
    cfg = TConfig(**_kw("pps", "NO_WAIT", False))
    wl = pps.PPSWorkload()
    tables = wl.init_tables(cfg, 0)
    want = {k: v.clone() for k, v in tables.items()}
    key, role, earg, _, cts = _entries(
        pps.catalog(cfg), {1: "PARTS", 2: "PARTS", 3: "USES"}, 2000, 2)
    wl._apply_entries_body(cfg, tables, key, role, earg, cts,
                           torch.zeros(2000, dtype=torch.bool))
    for k in want:
        assert torch.equal(tables[k], want[k]), k


def test_effect_branch_on_device_masks():
    # on the device the full-width body runs on the whole mask whatever the
    # predicate, the compacted one never, and each counter adds its
    # predicate (the reference's choice)
    wl = tpcc.TPCCWorkload()
    eff = torch.tensor([True, False, True])
    for fits in (True, False):
        seen = {}
        wl.effect_branch(torch.tensor(fits), eff,
                         lambda m: seen.__setitem__("compact", m),
                         lambda m: seen.__setitem__("full", m),
                         on_device=True)
        assert list(seen) == ["full"]
        assert torch.equal(seen["full"], eff)
    assert wl.branch_ticks == {"compact": 1, "full": 1}
