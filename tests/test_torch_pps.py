"""The port's PPS (deneva_tpu_torch.workloads.pps, device="cpu") against
the JAX package's: the query pool byte for byte, the initial tables,
commit_fields and apply_commit_entries on random commits (the K-lane
compacted body and the full-width body), and the whole engine under
NO_WAIT on one shared pool, with fused_arbitrate off and on.  Then the
PART_AMOUNT conservation of tests/test_pps.py and the abort rate against
the numpy sequential oracle.  Every comparison is exact (integers), but
the oracle's, which is held to tests/test_parity.py:PPS_THRESH."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu.config import Config as JConfig  # noqa: E402
from deneva_tpu.engine import state as jstate  # noqa: E402
from deneva_tpu.engine.scheduler import Engine as JEngine  # noqa: E402
from deneva_tpu.workloads import pps as jpps  # noqa: E402
from deneva_tpu.workloads.base import QueryPool as JPool  # noqa: E402
from deneva_tpu_torch.config import Config as TConfig  # noqa: E402
from deneva_tpu_torch.engine import state as tstate  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine as TEngine  # noqa: E402
from deneva_tpu_torch.workloads import pps  # noqa: E402

POOL_FIELDS = ("keys", "is_write", "n_req", "home_part", "txn_type", "args",
               "aux")
TXN_FIELDS = ("status", "cursor", "ts", "pool_idx", "restarts",
              "backoff_until", "start_tick", "first_start_tick", "keys",
              "is_write", "n_req", "txn_type", "targs", "aux")


def pps_kw(**kw):
    """tests/test_pps.py:pps_cfg as Config kwargs."""
    base = dict(workload="PPS", cc_alg="NO_WAIT", batch_size=64,
                part_cnt=1, node_cnt=1, max_part_key=128,
                max_product_key=128, max_supplier_key=128, max_parts_per=5,
                query_pool_size=512, synth_table_size=8)
    base.update(kw)
    return base


#: every one of the 8 txn types
ALL_TYPES = dict(perc_pps_getpart=0.1, perc_pps_getproduct=0.1,
                 perc_pps_getsupplier=0.1, perc_pps_getpartbysupplier=0.1,
                 perc_pps_getpartbyproduct=0.1, perc_pps_orderproduct=0.2,
                 perc_pps_updateproductpart=0.2, perc_pps_updatepart=0.1)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tables_equal(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        w, g = np.asarray(want[k]), _np(got[k])
        assert w.dtype == g.dtype and w.shape == g.shape, k
        np.testing.assert_array_equal(w, g, err_msg=k)


def _clone(tables: dict) -> dict:
    return {k: v.clone() for k, v in tables.items()}


# ---------------------------------------------------------------------------
# host half: the pool and the initial tables
# ---------------------------------------------------------------------------

POOL_CASES = {
    "test_pps_cfg": {},
    "defaults": dict(max_part_key=1024, max_product_key=1024,
                     max_supplier_key=1024, max_parts_per=10,
                     query_pool_size=2048),
    "all_types": ALL_TYPES,
    "seed5": dict(seed=5),
    "no_first_part_local": dict(first_part_local=False),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_is_byte_equal(case):
    kw = pps_kw(**POOL_CASES[case])
    want = jpps.PPSWorkload().gen_pool(JConfig(**kw))
    got = pps.PPSWorkload().gen_pool(TConfig(**kw))
    for f in POOL_FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        assert w.dtype == g.dtype and w.shape == g.shape, f
        assert w.tobytes() == g.tobytes(), f
    # the pool draws vary with the seed argument, the loader's chains not
    a = jpps.PPSWorkload().gen_pool(JConfig(**kw), seed=11)
    b = pps.PPSWorkload().gen_pool(TConfig(**kw), seed=11)
    assert a.keys.tobytes() == b.keys.tobytes()
    assert not pps.PPSWorkload().pool_user_abort(TConfig(**kw), got).any()


def test_catalog_matches_reference():
    for kw in (pps_kw(), pps_kw(part_cnt=2, node_cnt=2)):
        a, b = jpps.catalog(JConfig(**kw)), pps.catalog(TConfig(**kw))
        assert a.rows_global == b.rows_global
        assert {n: (t.n_local, t.base) for n, t in a.tables.items()} == \
            {n: (t.n_local, t.base) for n, t in b.tables.items()}
        assert pps.PPSWorkload().cc_rows(TConfig(**kw)) == \
            jpps.PPSWorkload().cc_rows(JConfig(**kw))


@pytest.mark.parametrize("kw", [pps_kw(), pps_kw(seed=5, max_parts_per=10)],
                         ids=["test_pps_cfg", "seed5_L10"])
def test_init_tables_match_reference(kw):
    want = jpps.PPSWorkload().init_tables(JConfig(**kw), 0)
    got = pps.PPSWorkload().init_tables(TConfig(**kw), 0)
    _assert_tables_equal(want, got)


# ---------------------------------------------------------------------------
# device half: commit_fields and apply_commit_entries on random commits
# ---------------------------------------------------------------------------


def _txn_from_pool(mod, arr, pool, rows):
    B = rows.shape[0]
    z = arr(np.zeros(B, np.int32))
    return mod.TxnState(
        status=z, cursor=z, ts=arr(np.arange(B, dtype=np.int32) + 1),
        pool_idx=z, restarts=z, backoff_until=z, start_tick=z,
        first_start_tick=z, keys=arr(pool.keys[rows]),
        is_write=arr(pool.is_write[rows]), n_req=arr(pool.n_req[rows]),
        txn_type=arr(pool.txn_type[rows]), targs=arr(pool.args[rows]),
        aux=arr(pool.aux[rows]))


@pytest.mark.parametrize("seed", [0, 1])
def test_commit_fields_match_reference(seed):
    kw = pps_kw(**ALL_TYPES)
    pool = pps.PPSWorkload().gen_pool(TConfig(**kw))
    rng = np.random.default_rng(seed)
    B = 256
    rows = rng.choice(pool.size, B, replace=False)
    commit = rng.random(B) < 0.6
    jtables = jpps.PPSWorkload().init_tables(JConfig(**kw), 0)
    want = jpps.PPSWorkload().commit_fields(
        JConfig(**kw), jtables,
        _txn_from_pool(jstate, jnp.asarray, pool, rows), jnp.asarray(commit))
    got = pps.PPSWorkload().commit_fields(
        TConfig(**kw), pps.PPSWorkload().init_tables(TConfig(**kw), 0),
        _txn_from_pool(tstate, torch.from_numpy, pool, rows),
        torch.from_numpy(commit))
    assert sorted(want) == sorted(got) == sorted(pps.PPSWorkload
                                                 .effect_fields)
    for k in want:
        assert got[k].dtype == torch.int32, k
        np.testing.assert_array_equal(np.asarray(want[k]), got[k].numpy(),
                                      err_msg=k)
    # every effect role is among the committing entries
    roles = got["role"].numpy() & 7
    assert {pps.ROLE_ORDER, pps.ROLE_UPDPART, pps.ROLE_SETUSES} <= \
        set(np.unique(roles).tolist())


def _random_entries(cfg, n, live_frac, seed):
    """Synthetic effect entries of every role, with repeated PARTS and USES
    rows (several committers of one USES row in one tick) and distinct
    commit timestamps."""
    rng = np.random.default_rng(seed)
    cat = pps.catalog(cfg)
    roles = rng.choice([pps.ROLE_NONE, pps.ROLE_ORDER, pps.ROLE_UPDPART,
                        pps.ROLE_SETUSES], size=n).astype(np.int32)
    key = np.zeros(n, np.int32)
    for role, tab in ((pps.ROLE_NONE, "PRODUCTS"), (pps.ROLE_ORDER, "PARTS"),
                      (pps.ROLE_UPDPART, "PARTS"),
                      (pps.ROLE_SETUSES, "USES")):
        m = roles == role
        ti = cat.tables[tab]
        key[m] = ti.base + rng.integers(0, ti.n_local, int(m.sum()))
    earg = np.where(roles == pps.ROLE_SETUSES,
                    rng.integers(1, cfg.max_part_key + 1, n), 0)
    return dict(
        key=key, role=(roles | (earg << 3)).astype(np.int32),
        earg=earg.astype(np.int32),
        cts=(rng.permutation(n) + 1).astype(np.int32),
        live=(roles != pps.ROLE_NONE) & (rng.random(n) < live_frac))


# K = max(4096, admit_cap * (n // B)) = 4096 lanes of n = 9,000 (B = 512,
# admit cap 16): a live fraction of 0.3 fits K (compacted body), 0.9 does
# not (full body); at n = 3000 <= K the body runs directly
APPLY_CASES = {"compact": (9000, 0.3), "full": (9000, 0.9),
               "narrow": (3000, 0.9)}


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_commit_entries_matches_reference(case):
    n, live_frac = APPLY_CASES[case]
    kw = pps_kw(batch_size=512, admit_cap=16)
    cfg = TConfig(**kw)
    assert pps.effect_lanes(cfg, n) == min(n, 4096)
    e = _random_entries(cfg, n, live_frac, seed=7)
    jwl = jpps.PPSWorkload()
    want = jwl.apply_commit_entries(
        JConfig(**kw), jwl.init_tables(JConfig(**kw), 0),
        jnp.asarray(e["key"]), 0,
        {f: jnp.asarray(e[f]) for f in ("role", "earg")},
        jnp.asarray(e["cts"]), jnp.asarray(e["live"]))

    wl = pps.PPSWorkload()
    tables = wl.init_tables(cfg, 0)
    fields = {f: torch.from_numpy(e[f]) for f in ("role", "earg")}
    args = (torch.from_numpy(e["key"]), 0, fields,
            torch.from_numpy(e["cts"]), torch.from_numpy(e["live"]))
    got = wl.apply_commit_entries(cfg, _clone(tables), *args)
    _assert_tables_equal(want, got)
    branch = "full" if case == "narrow" else case
    assert wl.branch_ticks == {"compact": 0, "full": 0, branch: 1}
    # several live committers share a USES row: the last one (max cts) won
    s_set = e["live"] & ((e["role"] & 7) == pps.ROLE_SETUSES)
    assert np.bincount(e["key"][s_set]).max() > 1
    assert not np.array_equal(np.asarray(want["uses_part"]),
                              tables["uses_part"].numpy())

    # the port's full-width body gives the same tables as its dispatch
    live = torch.from_numpy(e["live"])
    eff = live & ((fields["role"] & 7) != pps.ROLE_NONE)
    full = wl._apply_entries_body(cfg, _clone(tables), args[0],
                                  fields["role"], fields["earg"], args[3],
                                  eff)
    _assert_tables_equal(got, full)


@pytest.mark.parametrize("case", sorted(APPLY_CASES))
def test_apply_commit_entries_on_device_branches(case):
    # as run_compiled applies them: the full-width body on every tick, the
    # reference's choice counted on the device (workloads/base.py
    # effect_branch); the reference's tables
    n, live_frac = APPLY_CASES[case]
    kw = pps_kw(batch_size=512, admit_cap=16)
    cfg = TConfig(**kw)
    e = _random_entries(cfg, n, live_frac, seed=7)
    jwl = jpps.PPSWorkload()
    want = jwl.apply_commit_entries(
        JConfig(**kw), jwl.init_tables(JConfig(**kw), 0),
        jnp.asarray(e["key"]), 0,
        {f: jnp.asarray(e[f]) for f in ("role", "earg")},
        jnp.asarray(e["cts"]), jnp.asarray(e["live"]))
    wl = pps.PPSWorkload()
    got = wl.apply_commit_entries(
        cfg, wl.init_tables(cfg, 0), torch.from_numpy(e["key"]), 0,
        {f: torch.from_numpy(e[f]) for f in ("role", "earg")},
        torch.from_numpy(e["cts"]), torch.from_numpy(e["live"]),
        on_device=True)
    _assert_tables_equal(want, got)
    branch = "full" if case == "narrow" else case
    assert wl.branch_ticks == {"compact": 0, "full": 0, branch: 1}


def test_uses_last_writer_wins():
    # one USES row set by three committers in one tick: the one with the
    # largest commit ts wins, whatever the lane order
    kw = pps_kw()
    cfg = TConfig(**kw)
    row = pps.catalog(cfg).tables["USES"].base + 7
    key = np.array([row, row, row, row + 1], np.int32)
    earg = np.array([11, 22, 33, 44], np.int32)
    cts = np.array([30, 50, 10, 5], np.int32)
    role = (pps.ROLE_SETUSES | (earg << 3)).astype(np.int32)
    wl = pps.PPSWorkload()
    got = wl.apply_commit_entries(
        cfg, wl.init_tables(cfg, 0), torch.from_numpy(key), 0,
        {"role": torch.from_numpy(role), "earg": torch.from_numpy(earg)},
        torch.from_numpy(cts), torch.ones(4, dtype=torch.bool))
    jwl = jpps.PPSWorkload()
    want = jwl.apply_commit_entries(
        JConfig(**kw), jwl.init_tables(JConfig(**kw), 0), jnp.asarray(key),
        0, {"role": jnp.asarray(role), "earg": jnp.asarray(earg)},
        jnp.asarray(cts), jnp.ones(4, bool))
    _assert_tables_equal(want, got)
    assert got["uses_part"][7].item() == 22
    assert got["uses_part"][8].item() == 44


# ---------------------------------------------------------------------------
# the engine against the JAX engine on one shared pool
# ---------------------------------------------------------------------------


def _line_without_host_keys(line):
    return [kv for kv in line.split(",")
            if not kv.startswith(("mem_util=", "cpu_util="))]


def run_both(kw, n_ticks, chunks=None):
    """Both engines on one shared pool, `chunks` splitting the run into
    several run() calls on the carried state."""
    pool = pps.PPSWorkload().gen_pool(TConfig(**kw))
    jpool = JPool(**{f: getattr(pool, f) for f in POOL_FIELDS})
    je = JEngine(JConfig(**kw), pool=jpool)
    te = TEngine(TConfig(**kw), pool=pool, device="cpu")
    js, ts = None, None
    for n in (chunks or [n_ticks]):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # the JAX gate's width fallback
            js = je.run(n, js)
        ts = te.run(n, ts)
    return je, js, te, ts


def assert_engine_parity(je, js, te, ts):
    """summary(), the [summary] line less its host keys, data, every table,
    the txn slots and the cursors: all equal."""
    a, b = je.summary(js), te.summary(ts)
    assert a == b, {k: (a[k], b.get(k)) for k in a if a[k] != b.get(k)}
    assert _line_without_host_keys(je.summary_line(js)) == \
        _line_without_host_keys(te.summary_line(ts))
    np.testing.assert_array_equal(np.asarray(js.data), ts.data.numpy())
    _assert_tables_equal(js.tables, ts.tables)
    for f in TXN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(js.txn, f)),
                                      getattr(ts.txn, f).numpy(), err_msg=f)
    assert int(js.pool_cursor) == int(ts.pool_cursor)
    assert int(js.ts_counter) == int(ts.ts_counter)
    # the increment oracle: every committed write applied exactly once
    assert int(ts.data.sum()) == b["write_cnt"]
    return b


ENGINE_CELLS = {
    # tests/test_pps.py:pps_cfg with the default mix, 60 ticks; with
    # fused_arbitrate the JAX side runs its Pallas kernel (interpret mode)
    # on every pack
    "small": (pps_kw(), 60),
    # every txn type, UPDATEPART's +100 included
    "all_types": (pps_kw(**ALL_TYPES), 60),
    # B*R = 5,632 > K = 4096 (admission cap 64): every tick takes the
    # compacted body
    "compact": (pps_kw(batch_size=512, admit_cap=64, query_pool_size=2048),
                60),
}


@pytest.mark.parametrize("cell,fused", [
    ("small", False), ("small", True), ("all_types", False),
    ("compact", False), ("compact", True)])
def test_engine_matches_reference(cell, fused):
    kw, n_ticks = ENGINE_CELLS[cell]
    je, js, te, ts = run_both(dict(kw, fused_arbitrate=fused), n_ticks)
    s = assert_engine_parity(je, js, te, ts)
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    want_branch = "compact" if cell == "compact" else "full"
    assert te.workload.branch_ticks[want_branch] == n_ticks
    # the commits changed both tables
    init = te.workload.init_tables(te.cfg, 0)
    for k in ("part_amount", "uses_part"):
        assert not torch.equal(ts.tables[k], init[k]), k


def test_engine_matches_reference_across_run_calls():
    kw, _ = ENGINE_CELLS["all_types"]
    assert_engine_parity(*run_both(kw, None, chunks=[7, 11, 5]))


# ---------------------------------------------------------------------------
# PART_AMOUNT conservation (tests/test_pps.py) and oracle parity
# ---------------------------------------------------------------------------


def amount_delta(eng, n_ticks):
    """The run's summary and its change of sum(part_amount)."""
    st0 = eng.init_state()
    a0 = int(st0.tables["part_amount"].to(torch.int64).sum())
    st = eng.run(n_ticks, st0)
    return eng.summary(st), \
        int(st.tables["part_amount"].to(torch.int64).sum()) - a0


@pytest.mark.parametrize("mix,sign", [
    (dict(perc_pps_getpartbyproduct=0.0, perc_pps_orderproduct=1.0,
          perc_pps_updateproductpart=0.0), -1),
    (dict(perc_pps_getpartbyproduct=0.0, perc_pps_orderproduct=0.0,
          perc_pps_updateproductpart=0.0, perc_pps_updatepart=1.0), 100)],
    ids=["orderproduct", "updatepart"])
def test_amount_conservation_exact(mix, sign):
    # every committed ORDERPRODUCT write lowers PART_AMOUNT by 1, every
    # committed UPDATEPART raises it by 100
    eng = TEngine(TConfig(**pps_kw(**mix)), device="cpu")
    s, delta = amount_delta(eng, 40)
    assert s["txn_cnt"] > 0
    assert delta == sign * (s["write_cnt"] if sign == -1 else s["txn_cnt"])


def test_abort_rate_parity_with_sequential_oracle():
    # the NO_WAIT cell of tests/test_parity.py:test_pps_parity, the port
    # against the numpy sequential oracle on one pool, held to
    # PPS_THRESH["NO_WAIT"]
    from deneva_tpu.oracle.parity import _pair_dict
    from deneva_tpu.oracle.sequential import SequentialEngine
    from tests.test_parity import PPS_THRESH
    kw = dict(workload="PPS", cc_alg="NO_WAIT", batch_size=64,
              query_pool_size=1 << 10, warmup_ticks=0, synth_table_size=8,
              max_part_key=256, max_product_key=256, max_supplier_key=256)
    pool = pps.PPSWorkload().gen_pool(TConfig(**kw))
    te = TEngine(TConfig(**kw), pool=pool, device="cpu")
    ts = te.run(50)
    jpool = JPool(**{f: getattr(pool, f) for f in POOL_FIELDS})
    seq = SequentialEngine(JConfig(**kw), pool=jpool).run(50)
    r = _pair_dict(JConfig(**kw), te.summary(ts), int(ts.data.sum()), seq)
    assert r["batched_conserved"] and r["sequential_conserved"], r
    assert r["abort_rate_divergence"] <= PPS_THRESH["NO_WAIT"], r
