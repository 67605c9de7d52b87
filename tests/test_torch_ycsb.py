"""The port's host layer against the JAX package's: the Config copy, the
YCSB query pool (byte-equal), and the [summary] line helpers."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from deneva_tpu import config as jconfig  # noqa: E402
from deneva_tpu import stats as jstats  # noqa: E402
from deneva_tpu.workloads import ycsb as jycsb  # noqa: E402
from deneva_tpu_torch import config as tconfig  # noqa: E402
from deneva_tpu_torch import stats as tstats  # noqa: E402
from deneva_tpu_torch.workloads import ycsb as tycsb  # noqa: E402

ENTRY_KW = dict(cc_alg="NO_WAIT", batch_size=1024, synth_table_size=1 << 16,
                req_per_query=10, zipf_theta=0.6, query_pool_size=1 << 12)

POOL_CELLS = {
    "entry": ENTRY_KW,
    "hot_skew": dict(ENTRY_KW, skew_method="hot", access_perc=0.9,
                     data_perc=0.01),
    "contended": dict(batch_size=64, synth_table_size=256, req_per_query=4,
                      zipf_theta=0.9, query_pool_size=512),
    "read_only_key_order": dict(ENTRY_KW, txn_read_perc=1.0,
                                key_order=True, seed=3),
    "partitioned_strict": dict(ENTRY_KW, part_cnt=4, node_cnt=4,
                               strict_ppt=True, part_per_txn=2, mpr=0.5),
}


def test_config_fields_and_defaults_match():
    jf = {f.name: f for f in dataclasses.fields(jconfig.Config)}
    tf = {f.name: f for f in dataclasses.fields(tconfig.Config)}
    assert list(jf) == list(tf)
    for name, f in jf.items():
        assert f.default == tf[name].default, name
    assert set(jconfig.optin_flags()) == set(tconfig.optin_flags())
    for name, flag in jconfig.optin_flags().items():
        tflag = tconfig.optin_flags()[name]
        assert (flag.default, flag.on, flag.engines) == \
            (tflag.default, tflag.on, tflag.engines), name
    for const in ("CC_ALGS", "WORKLOADS", "ISOLATION_LEVELS", "MODES",
                  "ARRIVAL_MODELS"):
        assert getattr(jconfig, const) == getattr(tconfig, const)


@pytest.mark.parametrize("n,batch,kw", [
    (10240, 1024, {}), (10240, 1024, {"compact_auto": True}),
    (256, 64, {"compact_lanes": 100}), (80, 8, {"compact_lanes": 10**6}),
    (80, 8, {"compact_auto": True, "acquire_window": 3})])
def test_compact_width_matches(n, batch, kw):
    assert tconfig.Config(**kw).compact_width(n, batch) == \
        jconfig.Config(**kw).compact_width(n, batch)


@pytest.mark.parametrize("cell", sorted(POOL_CELLS))
def test_query_pool_is_byte_equal(cell):
    kw = POOL_CELLS[cell]
    jp = jycsb.gen_query_pool(jconfig.Config(**kw))
    tp = tycsb.gen_query_pool(tconfig.Config(**kw))
    for field in ("keys", "is_write", "n_req", "home_part", "txn_type",
                  "args", "aux"):
        a, b = getattr(jp, field), getattr(tp, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


def test_samplers_match():
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    za, zb = jycsb.ZipfSampler(4095, 0.9), tycsb.ZipfSampler(4095, 0.9)
    assert (za.zetan, za.eta) == (zb.zetan, zb.eta)
    np.testing.assert_array_equal(za.sample(rng_a, 1000),
                                  zb.sample(rng_b, 1000))
    ha, hb = jycsb.HotSampler(4095, 0.8, 0.05), tycsb.HotSampler(4095, 0.8,
                                                                 0.05)
    np.testing.assert_array_equal(ha.sample(rng_a, 1000),
                                  hb.sample(rng_b, 1000))


@pytest.fixture(scope="module")
def recorded():
    """An Engine.summary() dict of the port, from 100 ticks of the
    contended cell on the CPU."""
    from deneva_tpu_torch.engine.scheduler import Engine
    eng = Engine(tconfig.Config(**POOL_CELLS["contended"]), device="cpu")
    s = eng.summary(eng.run(100))
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    return s


@pytest.mark.parametrize("wall", [None, 2.5])
def test_summary_line_matches(recorded, wall):
    ja = jstats.reference_summary(recorded, wall)
    ta = tstats.reference_summary(recorded, wall)
    for d in (ja, ta):
        d.pop("mem_util")
        d.pop("cpu_util")
    assert ja == ta and list(ja) == list(ta)
    line = tstats.format_summary(ta)
    assert line == jstats.format_summary(ja)
    assert tstats.parse_summary(line) == jstats.parse_summary(line)
    prog = tstats.format_summary(ta, prog=True)
    assert prog.startswith("[prog] ")
    assert tstats.parse_summary(prog) == jstats.parse_summary(line)


def test_latency_percentiles_match():
    samples = np.random.default_rng(4).integers(0, 90, 500)
    for n_valid in (0, 1, 17, 500, 900):
        assert tstats.latency_percentiles(samples, n_valid) == \
            jstats.latency_percentiles(samples, n_valid)
