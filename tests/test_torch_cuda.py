"""Tests of the port that need a CUDA device: the Hopper kernel against
its plain version, the graph WHILE node against the host loop, and the
engine's CUDA path against its CPU path.  They
skip on a host without a card.  This file imports no JAX, so it also runs
on the GPU host, which has none:

    python -m pytest -m cuda tests/test_torch_cuda.py

Comparisons are exact (integer outputs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deneva_tpu_torch.config import Config  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine  # noqa: E402
from deneva_tpu_torch.ops import device_loop, fused, rebase  # noqa: E402
from deneva_tpu_torch.profile_tick import (  # noqa: E402
    breakdown, graph_nodes, trace_kernels,
)
from deneva_tpu_torch.storage.ordered import OrderedIndex  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _cols(dev, n, num_keys, n_cols, hi=3):
    rng = np.random.default_rng(n + num_keys)
    cols = [torch.from_numpy(rng.integers(-hi, hi, n).astype(np.int32))
            .to(dev) for _ in range(num_keys)]
    cols += [torch.from_numpy(rng.integers(0, 1 << 30, n).astype(np.int32))
             .to(dev) for _ in range(n_cols - num_keys)]
    return cols


def _check(cols, num_keys, shift=0):
    before = fused.LAUNCHES
    got = fused.fused_sort_scan(cols, num_keys, shift)
    assert fused.LAUNCHES == before + 1
    want = fused.fused_sort_scan_plain(cols, num_keys, shift)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])


def _assert_one_device_launch(fn):
    """One call of `fn` runs one device kernel, the fused kernel: a CUDA
    graph captured from the call holds exactly one node, a kernel, while
    the wrapper counts one launch (``profile_tick.graph_nodes``; a
    torch.profiler trace can lose a launch)."""
    fn()
    before = fused.LAUNCHES
    nodes = graph_nodes(fn)
    assert nodes == {"kernel": 1}, nodes
    assert fused.LAUNCHES == before + 1


@pytest.mark.parametrize("n,num_keys,n_cols", [
    (1, 1, 2), (7, 2, 4), (130, 2, 5), (2047, 2, 3), (2048, 1, 2),
    (2049, 3, 4), (81920, 2, 3), (81920, 1, 2),
    # more tiles than resident blocks: blocks sort several tiles
    (2_100_000, 1, 2)])
def test_kernel_matches_plain(dev, n, num_keys, n_cols):
    _check(_cols(dev, n, num_keys, n_cols), num_keys)


@pytest.mark.parametrize("n,num_keys,n_cols", [
    (1, 1, 2), (130, 2, 3), (2049, 2, 3), (6007, 3, 4), (81920, 2, 3),
    (2_100_000, 2, 3)])
def test_kernel_shift_matches_plain(dev, n, num_keys, n_cols):
    # odd and even keys share a segment of key >> 1
    _check(_cols(dev, n, num_keys, n_cols, hi=9), num_keys, shift=1)


@pytest.mark.parametrize("n", [1, 2047, 2049, 81920, 2_100_000])
def test_one_device_launch_per_call(dev, n):
    cols = _cols(dev, n, 2, 3)
    _assert_one_device_launch(lambda: fused.fused_sort_scan(cols, 2, 1))


#: the packs a tpcc-cell tick adds (workloads/tpcc.py): the effect
#: compaction at B*R = 270,336 lanes (8 columns, 2 keys), the o_id rank at
#: B = 8192 and the ring appends at K = 17,408 (2 columns, 1 key), the
#: restock chain at K (3 columns, 2 keys); and 3 columns by 2 keys at
#: 8192, the reference's form of the o_id rank
TPCC_PACKS = [(270_336, 2, 8), (8192, 1, 2), (17_408, 1, 2), (17_408, 2, 3),
              (8192, 2, 3)]


@pytest.mark.parametrize("n,num_keys,n_cols", TPCC_PACKS)
def test_tpcc_pack_matches_plain_in_one_launch(dev, n, num_keys, n_cols):
    cols = _cols(dev, n, num_keys, n_cols, hi=1 << 20)
    _check(cols, num_keys)
    _assert_one_device_launch(lambda: fused.fused_sort_scan(cols, num_keys))


def test_grid_with_several_tiles_per_block(dev):
    n = 2_100_000
    plan = fused.launch_plan(2, n)
    assert plan["tiles_per_block"] > 1, plan
    assert plan["levels"] == (plan["tiles"] - 1).bit_length()
    _check(_cols(dev, n, 2, 3), 2)


@pytest.mark.parametrize("case", ["dtype", "operands", "keys", "rank"])
def test_gate_raises_on_ineligible_cuda_pack(dev, case):
    # on the card an ineligible pack never falls back to the plain sort
    col = torch.arange(16, dtype=torch.int32, device=dev)
    ops, nk = {
        "dtype": ((col.to(torch.float32), col), 1),
        "operands": ((col,) * (fused.MAX_OPERANDS + 1), 1),
        "keys": ((col,) * (fused.MAX_KEYS + 1), fused.MAX_KEYS + 1),
        "rank": ((col.reshape(4, 4),), 1),
    }[case]
    fused.reset_fallbacks()
    before = fused.LAUNCHES
    with pytest.raises(ValueError, match=case):
        fused.maybe_fused_sort(Config(fused_arbitrate=True), ops, nk)
    assert fused.LAUNCHES == before
    assert fused.fallback_snapshot()["count"] == 0


@pytest.mark.parametrize("live_frac,branch,launches",
                         [(0.3, "compact", 5), (0.9, "full", 4)])
def test_tpcc_effects_cuda_match_cpu(dev, live_frac, branch, launches):
    # random effect entries of every role, with repeated stock rows, at
    # n = 17,000 > K = 8192 lanes: few enough live entries take the
    # compacted body (compaction, restock chain and 3 ring appends), more
    # the full-width body (no compaction sort)
    from deneva_tpu_torch.ops import segment as seg
    from deneva_tpu_torch.workloads import tpcc
    cfg = Config(workload="TPCC", batch_size=512, admit_cap=16, num_wh=8,
                 cust_per_dist=1000, max_items=128, fused_arbitrate=True)
    cat = tpcc.catalog(cfg)
    rng = np.random.default_rng(7)
    n = 17000
    roles = rng.integers(0, 6, n)        # ROLE_NONE .. ROLE_S_NO
    key = np.zeros(n, np.int64)
    for role, tab in ((1, "WAREHOUSE"), (2, "DISTRICT"), (3, "CUSTOMER"),
                      (4, "DISTRICT"), (5, "STOCK")):
        m = roles == role
        t = cat.tables[tab]
        key[m] = t.base + rng.integers(0, t.n_local, int(m.sum()))
    dw = rng.integers(0, 10, n) | (rng.integers(0, 8, n) << 4)
    cols = dict(role=np.where(roles > 0, roles | (dw << 3), 0),
                earg=rng.integers(0, 1 << 10, n),
                earg2=rng.integers(0, 1 << 10, n), key=key,
                cts=rng.permutation(n) + 1)
    live = (roles > 0) & (rng.random(n) < live_frac)
    out = {}
    for d in ("cpu", dev):
        t = {k: torch.from_numpy(v.astype(np.int32)).to(d)
             for k, v in cols.items()}
        wl = tpcc.TPCCWorkload()
        fused.reset_launches()
        with seg.fused_scope(cfg):
            out[str(d)] = wl.apply_commit_entries(
                cfg, wl.init_tables(cfg, 0, device=d), t["key"], 0,
                {f: t[f] for f in wl.effect_fields}, t["cts"],
                torch.from_numpy(live).to(d))
        assert wl.branch_ticks[branch] == 1
    assert fused.LAUNCHES == launches
    gpu, cpu = out[str(dev)], out["cpu"]
    for k in cpu:
        assert torch.equal(gpu[k].cpu(), cpu[k]), k


def test_tpcc_engine_cuda_matches_cpu(dev):
    # B*R = 16,896 > K = 8192: every tick compacts its effects, so a tick
    # makes 8 kernel launches
    cfg = Config(workload="TPCC", batch_size=512, admit_cap=64, num_wh=32,
                 cust_per_dist=1000, max_items=128, query_pool_size=4096,
                 fused_arbitrate=True)
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    fused.reset_launches()
    sg = gpu.run(40)
    assert fused.LAUNCHES == 8 * 40
    sc = cpu.run(40)
    assert gpu.summary(sg) == cpu.summary(sc)
    assert gpu.summary(sg)["txn_cnt"] > 0
    assert torch.equal(sg.data.cpu(), sc.data)
    for k in sc.tables:
        assert torch.equal(sg.tables[k].cpu(), sc.tables[k]), k
    assert gpu.workload.branch_ticks == cpu.workload.branch_ticks \
        == {"compact": 40, "full": 0}


def test_engine_cuda_matches_cpu(dev):
    cfg = Config(batch_size=64, synth_table_size=256, req_per_query=4,
                 query_pool_size=512, zipf_theta=0.9, fused_arbitrate=True)
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    fused.reset_launches()
    sg = gpu.run(100)
    assert fused.LAUNCHES == 200
    sc = cpu.run(100)
    assert gpu.summary(sg) == cpu.summary(sc)
    assert torch.equal(sg.data.cpu(), sc.data)


#: the packs a pps-cell tick adds (workloads/pps.py): the effect
#: compaction at B*R = 172,032 lanes (6 columns, 1 key) and the USES
#: last-writer-wins sort at K = 21,504 (3 columns, 2 keys)
PPS_PACKS = [(172_032, 1, 6), (21_504, 2, 3)]


@pytest.mark.parametrize("n,num_keys,n_cols", PPS_PACKS)
def test_pps_pack_matches_plain_in_one_launch(dev, n, num_keys, n_cols):
    cols = _cols(dev, n, num_keys, n_cols, hi=1 << 20)
    _check(cols, num_keys)
    _assert_one_device_launch(lambda: fused.fused_sort_scan(cols, num_keys))


@pytest.mark.parametrize("live_frac,branch,launches",
                         [(0.3, "compact", 2), (0.9, "full", 1)])
def test_pps_effects_cuda_match_cpu(dev, live_frac, branch, launches):
    # random effect entries of every role, with repeated PARTS and USES
    # rows, at n = 9,000 > K = 4096 lanes: few enough live entries take
    # the compacted body (compaction and the USES sort at K), more the
    # full-width body (the USES sort at n, no compaction)
    from deneva_tpu_torch.ops import segment as seg
    from deneva_tpu_torch.workloads import pps
    cfg = Config(workload="PPS", batch_size=512, admit_cap=16,
                 max_part_key=128, max_product_key=128,
                 max_supplier_key=128, max_parts_per=5,
                 fused_arbitrate=True)
    cat = pps.catalog(cfg)
    rng = np.random.default_rng(7)
    n = 9000
    roles = rng.integers(0, 4, n)        # ROLE_NONE .. ROLE_SETUSES
    key = np.zeros(n, np.int64)
    for role, tab in ((0, "PRODUCTS"), (1, "PARTS"), (2, "PARTS"),
                      (3, "USES")):
        m = roles == role
        t = cat.tables[tab]
        key[m] = t.base + rng.integers(0, t.n_local, int(m.sum()))
    earg = np.where(roles == 3, rng.integers(1, 129, n), 0)
    cols = dict(role=roles | (earg << 3), earg=earg, key=key,
                cts=rng.permutation(n) + 1)
    live = (roles > 0) & (rng.random(n) < live_frac)
    out = {}
    for d in ("cpu", dev):
        t = {k: torch.from_numpy(v.astype(np.int32)).to(d)
             for k, v in cols.items()}
        wl = pps.PPSWorkload()
        fused.reset_launches()
        with seg.fused_scope(cfg):
            out[str(d)] = wl.apply_commit_entries(
                cfg, wl.init_tables(cfg, 0, device=d), t["key"], 0,
                {f: t[f] for f in wl.effect_fields}, t["cts"],
                torch.from_numpy(live).to(d))
        assert wl.branch_ticks[branch] == 1
    assert fused.LAUNCHES == launches
    gpu, cpu = out[str(dev)], out["cpu"]
    for k in cpu:
        assert torch.equal(gpu[k].cpu(), cpu[k]), k


def test_pps_engine_cuda_matches_cpu(dev):
    # B*R = 5,632 > K = 4096: every tick compacts its effects, so a tick
    # makes 4 kernel launches
    cfg = Config(workload="PPS", batch_size=512, admit_cap=64,
                 max_part_key=128, max_product_key=128,
                 max_supplier_key=128, max_parts_per=5,
                 query_pool_size=2048, fused_arbitrate=True)
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    fused.reset_launches()
    sg = gpu.run(40)
    assert fused.LAUNCHES == 4 * 40
    sc = cpu.run(40)
    assert gpu.summary(sg) == cpu.summary(sc)
    assert gpu.summary(sg)["txn_cnt"] > 0
    assert torch.equal(sg.data.cpu(), sc.data)
    for k in sc.tables:
        assert torch.equal(sg.tables[k].cpu(), sc.tables[k]), k
    assert gpu.workload.branch_ticks == cpu.workload.branch_ticks \
        == {"compact": 40, "full": 0}


#: small WAIT_DIE configs of the three workloads, each with waits
WAIT_DIE_CFGS = {
    "ycsb": dict(batch_size=64, synth_table_size=256, req_per_query=4,
                 query_pool_size=512, zipf_theta=0.9),
    "tpcc": dict(workload="TPCC", batch_size=64, num_wh=16,
                 cust_per_dist=1000, max_items=128, query_pool_size=1024),
    "pps": dict(workload="PPS", batch_size=64, max_part_key=128,
                max_product_key=128, max_supplier_key=128, max_parts_per=5,
                query_pool_size=512),
}


@pytest.mark.parametrize("workload", sorted(WAIT_DIE_CFGS))
def test_wait_die_engine_cuda_matches_cpu(dev, workload):
    cfg = Config(cc_alg="WAIT_DIE", fused_arbitrate=True,
                 **WAIT_DIE_CFGS[workload])
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    sg, sc = gpu.run(60), cpu.run(60)
    s = gpu.summary(sg)
    assert s == cpu.summary(sc)
    assert s["txn_cnt"] > 0 and s["twopl_wait_cnt"] > 0
    assert torch.equal(sg.data.cpu(), sc.data)
    for k in sc.tables:
        assert torch.equal(sg.tables[k].cpu(), sc.tables[k]), k


@pytest.mark.parametrize("workload,twr", [
    ("ycsb", False), ("ycsb", True), ("tpcc", False), ("pps", False)])
def test_timestamp_engine_cuda_matches_cpu(dev, workload, twr):
    # TIMESTAMP: the (key, ts) pack on the kernel, wts/rts raised by
    # in-place scatter-max (order-free, so the atomics give the CPU's
    # arrays), the TPC-C restock chain in closed form
    cfg = Config(cc_alg="TIMESTAMP", fused_arbitrate=True, ts_twr=twr,
                 **WAIT_DIE_CFGS[workload])
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    sg, sc = gpu.run(60), cpu.run(60)
    s = gpu.summary(sg)
    assert s == cpu.summary(sc)
    assert s["txn_cnt"] > 0 and s["total_txn_abort_cnt"] > 0
    assert torch.equal(sg.data.cpu(), sc.data)
    for k in sc.tables:
        assert torch.equal(sg.tables[k].cpu(), sc.tables[k]), k
    for k in ("wts", "rts"):
        assert torch.equal(sg.db[k].cpu(), sc.db[k]), k


def test_timestamp_pack_matches_plain_in_one_launch(dev):
    # the T/O decision pack at the tpcc cell's width: (key, ts, is_write,
    # held, req, w_abort, lane) by 2 keys, dead lanes keyed INT32_MAX
    rng = np.random.default_rng(11)
    n = 270_336
    live = rng.random(n) < 0.3
    cols = [np.where(live, rng.integers(0, 1 << 24, n), 2**31 - 1),
            np.repeat(rng.integers(1, 1 << 20, n // 33), 33)]
    cols += [rng.random(n) < 0.5 for _ in range(4)] + [np.arange(n)]
    cols = [torch.from_numpy(c.astype(np.int32)).to(dev) for c in cols]
    _check(cols, 2)
    _assert_one_device_launch(lambda: fused.fused_sort_scan(cols, 2))


@pytest.mark.parametrize("workload", sorted(WAIT_DIE_CFGS))
def test_mvcc_engine_cuda_matches_cpu(dev, workload):
    # MVCC: the decision and version-insert packs on the kernel, the rings
    # set by index_copy_ at distinct cells and the read ts raised by
    # scatter-max (order-free), the rebase in two launches
    cfg = Config(cc_alg="MVCC", fused_arbitrate=True, his_recycle_len=2,
                 **WAIT_DIE_CFGS[workload])
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    sg, sc = gpu.run(60), cpu.run(60)
    s = gpu.summary(sg)
    assert s == cpu.summary(sc)
    assert s["txn_cnt"] > 0
    assert torch.equal(sg.data.cpu(), sc.data)
    for k in sc.tables:
        assert torch.equal(sg.tables[k].cpu(), sc.tables[k]), k
    assert sorted(sg.db) == sorted(sc.db)
    for k in sc.db:
        assert torch.equal(sg.db[k].cpu(), sc.db[k]), k


@pytest.mark.parametrize("workload", sorted(WAIT_DIE_CFGS))
def test_calvin_engine_cuda_matches_cpu(dev, workload):
    # CALVIN: the FIFO lock sort and the unpermute on the kernel, the epoch
    # gate and, on PPS, the recon deferral with its shadow requests
    cfg = Config(cc_alg="CALVIN", fused_arbitrate=True,
                 **WAIT_DIE_CFGS[workload])
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    fused.reset_launches()
    sg, sc = gpu.run(60), cpu.run(60)
    s = gpu.summary(sg)
    assert s == cpu.summary(sc)
    assert s["txn_cnt"] > 0 and s["twopl_wait_cnt"] > 0
    assert s["total_txn_abort_cnt"] == 0
    assert (s["recon_cnt"] > 0) == (workload == "pps")
    assert fused.LAUNCHES_BY_PACK[(3, 2, cfg.batch_size * gpu.pool.max_req,
                                   1)] == 60
    assert torch.equal(sg.data.cpu(), sc.data)
    for k in sc.tables:
        assert torch.equal(sg.tables[k].cpu(), sc.tables[k]), k
    for f in sc.txn._fields:
        assert torch.equal(getattr(sg.txn, f).cpu(), getattr(sc.txn, f)), f


@pytest.mark.parametrize("workload", sorted(WAIT_DIE_CFGS))
def test_occ_engine_cuda_matches_cpu(dev, workload):
    # OCC: the validation sort on the kernel (its only sort: access grants
    # everything), the fixed point on the host, one flag read per pass;
    # the pass counts agree
    cfg = Config(cc_alg="OCC", fused_arbitrate=True,
                 **WAIT_DIE_CFGS[workload])
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    fused.reset_launches()
    device_loop.reset_passes()
    sg = gpu.run(60)
    sc = cpu.run(60)
    s = gpu.summary(sg)
    assert s == cpu.summary(sc)
    assert s["txn_cnt"] > 0 and s["vabort_cnt"] > 0
    assert s["occ_hist_abort_cnt"] + s["occ_active_abort_cnt"] \
        == s["vabort_cnt"]
    n = cfg.batch_size * gpu.pool.max_req
    assert fused.LAUNCHES_BY_PACK[(4, 2, n, 0)] == 60
    assert int(device_loop.passes("occ", dev)) \
        == int(device_loop.passes("occ", "cpu")) > 60
    assert torch.equal(sg.data.cpu(), sc.data)
    for k in sc.tables:
        assert torch.equal(sg.tables[k].cpu(), sc.tables[k]), k
    for k in sc.db:
        assert torch.equal(sg.db[k].cpu(), sc.db[k]), k
    for f in sc.txn._fields:
        assert torch.equal(getattr(sg.txn, f).cpu(), getattr(sc.txn, f)), f


@pytest.mark.parametrize("workload", sorted(WAIT_DIE_CFGS))
def test_maat_engine_cuda_matches_cpu(dev, workload):
    # MAAT: its chain sort (6 columns by 3 keys) and squeeze sort (4 by 3)
    # on the kernel, once each per tick; the commit chain on the host, one
    # flag read per pass; the pass counts and every MAAT array agree
    from deneva_tpu_torch.cc import maat
    cfg = Config(cc_alg="MAAT", fused_arbitrate=True,
                 **WAIT_DIE_CFGS[workload])
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    fused.reset_launches()
    device_loop.reset_passes()
    sg = gpu.run(60)
    sc = cpu.run(60)
    s = gpu.summary(sg)
    assert s == cpu.summary(sc)
    assert s["txn_cnt"] > 0 and s["vabort_cnt"] == s["maat_range_abort_cnt"]
    n = cfg.batch_size * gpu.pool.max_req
    assert fused.LAUNCHES_BY_PACK[(6, 3, n, 0)] == 60
    assert fused.LAUNCHES_BY_PACK[(4, 3, n, 0)] == 60
    assert int(device_loop.passes(maat.LOOP_SITE, dev)) \
        == int(device_loop.passes(maat.LOOP_SITE, "cpu")) > 60
    assert torch.equal(sg.data.cpu(), sc.data)
    for k in sc.tables:
        assert torch.equal(sg.tables[k].cpu(), sc.tables[k]), k
    for k in sc.db:
        assert torch.equal(sg.db[k].cpu(), sc.db[k]), k
    for f in sc.txn._fields:
        assert torch.equal(getattr(sg.txn, f).cpu(), getattr(sc.txn, f)), f


@pytest.mark.parametrize("n", [81_920, 172_032, 270_336])
def test_maat_packs_match_plain_in_one_launch(dev, n):
    # the chain sort (key, finishing first, ts, is_write, access tick,
    # txn) and the squeeze sort (key, access tick, ts, lane), 3 keys each,
    # at each cell's B*R: half the lanes dead (INT32_MAX), ts per txn of
    # 10 lanes, hot rows
    rng = np.random.default_rng(n)
    live = rng.random(n) < 0.5
    key = np.where(live, rng.integers(0, 4096, n), 2**31 - 1)
    tx = np.arange(n) // 10
    ts = rng.permutation(n // 10 + 1)[tx] + 1
    atick = rng.integers(0, 40, n // 10 + 1)[tx] + np.arange(n) % 10
    nf = np.where(live, (rng.random(n // 10 + 1) < 0.7)[tx], 1)
    iw = rng.random(n) < 0.5
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    chain = [as_t(key), as_t(nf), as_t(ts), torch.from_numpy(iw).to(dev),
             as_t(atick), as_t(tx)]
    squeeze = [as_t(key), as_t(atick), as_t(ts), as_t(np.arange(n))]
    _check(chain, 3)
    _check(squeeze, 3)
    _assert_one_device_launch(lambda: fused.fused_sort_scan(squeeze, 3))


@pytest.mark.parametrize("n", [81_920, 172_032, 270_336])
def test_mvcc_version_insert_pack_matches_plain_in_one_launch(dev, n):
    # (key, BIG_TS - ts, ts, committed write) by 2 keys at each cell's
    # B*R: a quarter of the lanes committed writes on hot rows, the rest
    # keyed INT32_MAX
    rng = np.random.default_rng(n)
    live = rng.random(n) < 0.25
    ts = np.repeat(rng.integers(1, 1 << 20, n // 10 + 1), 10)[:n]
    cols = [np.where(live, rng.integers(0, 4096, n), 2**31 - 1),
            2**31 - 1 - ts, ts]
    cols = [torch.from_numpy(c.astype(np.int32)).to(dev) for c in cols]
    _check(cols + [torch.from_numpy(live).to(dev)], 2)
    # the kernel alone: the wrapper widens a bool column to int32 and
    # narrows it back, two elementwise launches of its own
    cols.append(torch.from_numpy(live.astype(np.int32)).to(dev))
    _assert_one_device_launch(lambda: fused.fused_sort_scan(cols, 2))


def test_ordered_index_cuda_matches_cpu(dev):
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(0, 10_000, 500))
    q = rng.integers(0, 10_000, 256).astype(np.int32)
    los = np.array([0, 5000, 9999, 12000], np.int32)
    his = np.array([100, 6000, 10_000, 13_000], np.int32)
    gpu, cpu = OrderedIndex(keys), OrderedIndex(keys, device="cpu")
    assert gpu.keys.device.type == "cuda"
    for fn in (lambda i: i.lookup(q), lambda i: i.range_start(los),
               lambda i: i.range_window(los, 8, hi=his),
               lambda i: i.range_count(los, his)):
        assert torch.equal(fn(gpu).cpu(), fn(cpu))


#: small engines whose graph replay is held to the eager tick: TPC-C and
#: PPS at B*R > K, so both effect bodies are captured (on masks)
GRAPH_CFGS = {
    "ycsb": dict(batch_size=64, synth_table_size=256, req_per_query=4,
                 query_pool_size=512, zipf_theta=0.9, warmup_ticks=7),
    "tpcc": dict(workload="TPCC", batch_size=512, admit_cap=64, num_wh=32,
                 cust_per_dist=1000, max_items=128, query_pool_size=4096,
                 warmup_ticks=7),
    "pps": dict(workload="PPS", batch_size=512, admit_cap=64,
                max_part_key=128, max_product_key=128, max_supplier_key=128,
                max_parts_per=5, query_pool_size=2048, warmup_ticks=7),
}


def _assert_same_run(eng, a, b):
    assert eng.summary(a) == eng.summary(b)
    assert torch.equal(a.data, b.data)
    for k in a.tables:
        assert torch.equal(a.tables[k], b.tables[k]), k
    for k in a.db:
        assert torch.equal(a.db[k], b.db[k]), k
    for f in a.txn._fields:
        assert torch.equal(getattr(a.txn, f), getattr(b.txn, f)), f
    assert int(a.tick) == int(b.tick) == a.host_tick == b.host_tick


@pytest.mark.parametrize("cc", ["NO_WAIT", "WAIT_DIE", "TIMESTAMP", "MVCC",
                                "CALVIN", "OCC", "MAAT"])
@pytest.mark.parametrize("workload", sorted(GRAPH_CFGS))
def test_graph_replay_matches_eager(dev, workload, cc):
    # 40 ticks: eager, then replayed from the initial state in two calls
    # (17 + 23: neither a multiple of the 3 flush phases); the warm-up
    # ends inside the first call
    cfg = Config(cc_alg=cc, fused_arbitrate=True, **GRAPH_CFGS[workload])
    eng = Engine(cfg, device=dev)
    c0 = eng.workload.counts()
    se = eng.run(40)
    c1 = eng.workload.counts()
    fused.reset_launches()
    sg = eng.run_compiled(23, eng.run_compiled(17))
    c2 = eng.workload.counts()
    _assert_same_run(eng, se, sg)
    assert eng.summary(sg)["txn_cnt"] > 0
    assert {k: c1[k] - c0[k] for k in c0} == {k: c2[k] - c1[k] for k in c0}
    # launches counted at capture only: the warm-up's 3 ticks and the 3
    # phase graphs, not the 40 replays; MVCC adds its version insert, OCC
    # sorts once to validate in place of the lock sort and unpermute, and
    # MAAT twice (its chain and squeeze sorts)
    per_tick = sum(eng.graphs.launches[0].values())
    assert per_tick == {"ycsb": 2, "tpcc": 7, "pps": 3}[workload] \
        + (cc == "MVCC") - (cc == "OCC")
    assert fused.LAUNCHES == 6 * per_tick
    # a replayed tick never syncs the host
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = eng.advance(6, sg, compiled=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.host_tick == 46


@pytest.mark.parametrize("cc", ["NO_WAIT", "WAIT_DIE", "TIMESTAMP", "MVCC",
                                "CALVIN", "OCC", "MAAT"])
@pytest.mark.parametrize("workload", sorted(GRAPH_CFGS))
def test_commit_after_access_cuda_matches_cpu_and_replay(dev, workload, cc):
    # commit after access: CUDA == CPU after 40 eager ticks, 40 replayed
    # ticks == the eager ones (the device loop's passes too), the flagless
    # tick's sorts in a captured tick, and no host read in a replay
    cfg = Config(cc_alg=cc, fused_arbitrate=True, commit_after_access=True,
                 **GRAPH_CFGS[workload])
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    site = {"OCC": "occ", "MAAT": "maat"}.get(cc)
    device_loop.reset_passes()
    sg, sc = gpu.run(40), cpu.run(40)
    assert gpu.summary(sg) == cpu.summary(sc)
    assert gpu.summary(sg)["txn_cnt"] > 0
    assert torch.equal(sg.data.cpu(), sc.data)
    for part in ("tables", "db"):
        for k, v in getattr(sc, part).items():
            assert torch.equal(getattr(sg, part)[k].cpu(), v), k
    for f in sc.txn._fields:
        assert torch.equal(getattr(sg.txn, f).cpu(), getattr(sc.txn, f)), f
    if site:
        eager = int(device_loop.passes(site, dev).item())
        assert eager == int(device_loop.passes(site, "cpu"))
    # the warm-up and capture run the loop too: count from the replays
    st0 = gpu.advance(0, gpu.init_state(), compiled=True)
    device_loop.reset_passes()
    rep = gpu.run_compiled(40, st0)
    _assert_same_run(gpu, sg, rep)
    if site:
        assert int(device_loop.passes(site, dev).item()) == eager
    per_tick = sum(gpu.graphs.launches[0].values())
    assert per_tick == {"ycsb": 2, "tpcc": 7, "pps": 3}[workload] \
        + (cc == "MVCC") - (cc == "OCC")
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu.advance(3, rep, compiled=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("cc", ["NO_WAIT", "WAIT_DIE", "TIMESTAMP", "MVCC",
                                "CALVIN", "OCC", "MAAT"])
@pytest.mark.parametrize("workload", sorted(GRAPH_CFGS))
def test_compaction_cuda_matches_cpu_and_replay(dev, workload, cc):
    # live-entry compaction: CUDA == CPU after 40 eager ticks (the
    # occupancy counters too), 40 replayed ticks == the eager ones, the
    # flagless tick's sorts at K plus the compaction pack (and the
    # expansion pack on the access path) in a captured tick, and no host
    # read in a replay.  YCSB's B*R = 256 takes 160 lanes (compact_auto is
    # the identity at that width), CALVIN's auto bucket is the identity
    # (it requests every access), so it takes 4,096 lanes on TPC-C and PPS
    if workload == "ycsb":
        over = dict(compact_lanes=160)
    elif cc == "CALVIN":
        over = dict(compact_lanes=4096)
    else:
        over = dict(compact_auto=True)
    kw = dict(cc_alg=cc, fused_arbitrate=True, **GRAPH_CFGS[workload])
    gpu = Engine(Config(**kw, **over), device=dev)
    cpu = Engine(Config(**kw, **over), pool=gpu.pool, device="cpu")
    sg, sc = gpu.run(40), cpu.run(40)
    s = gpu.summary(sg)
    assert s == cpu.summary(sc)
    assert s["txn_cnt"] > 0 and s["live_entry_cnt"] > 0
    assert torch.equal(sg.data.cpu(), sc.data)
    for part in ("tables", "db"):
        for k, v in getattr(sc, part).items():
            assert torch.equal(getattr(sg, part)[k].cpu(), v), k
    for f in sc.txn._fields:
        assert torch.equal(getattr(sg.txn, f).cpu(), getattr(sc.txn, f)), f
    st0 = gpu.advance(0, gpu.init_state(), compiled=True)
    rep = gpu.run_compiled(40, st0)
    _assert_same_run(gpu, sg, rep)
    per_tick = sum(gpu.graphs.launches[0].values())
    assert per_tick == {"ycsb": 2, "tpcc": 7, "pps": 3}[workload] \
        + (cc == "MVCC") - (cc == "OCC") + (1 if cc in ("OCC", "MAAT")
                                            else 2)
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu.advance(3, rep, compiled=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _passes_per_tick(eng, state, n_ticks, compiled, site="occ"):
    """Advance n_ticks one at a time; the passes of the device loop at
    `site` (OCC's fixed point, MAAT's chain) in each, read from its
    device counter (a host read between ticks)."""
    out = []
    for _ in range(n_ticks):
        device_loop.reset_passes()
        state = eng.advance(1, state, compiled=compiled)
        out.append(int(device_loop.passes(site, eng.device)))
    return state, out


def _replay_runs_the_eager_passes(dev, workload, cc):
    """The WHILE node runs each replayed tick's loop to its end (OCC's
    fixed point; MAAT's chain, 66 passes at most): as many passes as the
    eager tick's host loop, tick by tick."""
    cfg = Config(cc_alg=cc, fused_arbitrate=True, **GRAPH_CFGS[workload])
    site = cc.lower()
    eng = Engine(cfg, device=dev)
    se, eager = _passes_per_tick(eng, eng.init_state(), 30, False, site)
    eng._flush_body(se)
    state = eng.advance(0, eng.init_state(), compiled=True)
    assert device_loop.LAUNCHES > 0
    sg, graph = _passes_per_tick(eng, state, 30, True, site)
    eng._flush_body(sg)
    _assert_same_run(eng, se, sg)
    assert eager == graph and max(eager) > 1, (eager, graph)


@pytest.mark.parametrize("workload", sorted(GRAPH_CFGS))
def test_occ_graph_replay_runs_the_eager_passes(dev, workload):
    _replay_runs_the_eager_passes(dev, workload, "OCC")


@pytest.mark.parametrize("workload", sorted(GRAPH_CFGS))
def test_maat_graph_replay_runs_the_eager_passes(dev, workload):
    _replay_runs_the_eager_passes(dev, workload, "MAAT")


@pytest.mark.parametrize("n", [40, 80])
def test_maat_deep_chain_replays_every_pass(dev, n):
    # MAAT's forced chain: n txns finishing in one tick, each reading the
    # row the one before writes; 40 passes and 20 commits, or at 80 txns
    # the bound, 66 passes and 47 commits, in a replay as eagerly and on
    # the CPU
    from deneva_tpu_torch.cc.maat import chain_pool
    kw, pool = chain_pool(n)
    cfg = Config(fused_arbitrate=True, **kw)
    runs = {}
    for name, device, compiled in (("cpu", "cpu", False),
                                   ("eager", dev, False),
                                   ("graph", dev, True)):
        eng = Engine(cfg, pool=pool, device=device)
        state = eng.init_state()
        if compiled:
            state = eng.advance(0, state, compiled=True)
        state, per_tick = _passes_per_tick(eng, state, 3, compiled, "maat")
        eng._flush_body(state)
        runs[name] = (per_tick, eng.summary(state))
    for name, (per_tick, s) in runs.items():
        assert per_tick == [1, 1, min(n, 66)], (name, per_tick)
        assert s["txn_cnt"] == {40: 20, 80: 47}[n], name
        assert s == runs["cpu"][1], name


def test_maat_flag_stops_a_never_settling_step_in_the_while_node(dev):
    # a step that always changes something, under MAAT's chain flag: one
    # captured WHILE node stops it after exactly 66 passes, as the host
    # loop does; with no row of two validators, after 1
    from deneva_tpu_torch.cc import maat
    passes = torch.zeros((), dtype=torch.int32, device=dev)
    needed = torch.ones((), dtype=torch.bool, device=dev)
    changed = torch.ones((), dtype=torch.bool, device=dev)

    def step():
        passes.add_(1)
        return maat.flag(needed, passes, changed)

    device_loop.run_while(step, "test_maat", dev)   # the host loop
    assert int(passes) == maat.MAX_PASSES
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        device_loop.run_while(step, "test_maat", dev)
    for need, want in ((True, maat.MAX_PASSES), (False, 1)):
        needed.fill_(need)
        passes.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert int(passes) == want


def test_occ_deep_chain_replays_every_pass(dev):
    # 40 txns finishing in one tick, each reading the row the one before
    # writes: 40 passes, 20 commits, in a replay as eagerly and on the CPU
    from deneva_tpu_torch.cc.occ import chain_pool
    kw, pool = chain_pool(40)
    cfg = Config(fused_arbitrate=True, **kw)
    runs = {}
    for name, device, compiled in (("cpu", "cpu", False),
                                   ("eager", dev, False),
                                   ("graph", dev, True)):
        eng = Engine(cfg, pool=pool, device=device)
        state = eng.init_state()
        if compiled:
            state = eng.advance(0, state, compiled=True)
        state, per_tick = _passes_per_tick(eng, state, 3, compiled)
        eng._flush_body(state)
        runs[name] = (per_tick, eng.summary(state))
    for name, (per_tick, s) in runs.items():
        assert per_tick == [1, 1, 40], (name, per_tick)
        assert s["txn_cnt"] == 20 and s["vabort_cnt"] == 20, name
        assert s == runs["cpu"][1], name


def test_while_node_has_no_bound(dev):
    # a bare WHILE node: the body bumps a counter until it reaches n; one
    # captured graph runs 5, 40 and 1000 passes, and 1 when the flag is
    # false at once (the loop runs at least once)
    c = torch.zeros((), dtype=torch.int32, device=dev)
    n = torch.tensor(5, dtype=torch.int32, device=dev)

    def step():
        c.add_(1)
        return c < n

    device_loop.run_while(step, "test", dev)   # the start-up, the counter
    assert int(c) == 5
    graph = torch.cuda.CUDAGraph()
    before = device_loop.LAUNCHES
    with torch.cuda.graph(graph):
        device_loop.run_while(step, "test", dev)
    assert device_loop.LAUNCHES == before + 1
    for limit, want in ((5, 5), (40, 40), (1000, 1000), (0, 1)):
        n.fill_(limit)
        c.zero_()
        device_loop.reset_passes()
        graph.replay()
        torch.cuda.synchronize()
        assert int(c) == want
        assert int(device_loop.passes("test", dev)) == want


def test_captured_tick_runs_no_collection(dev):
    # a dead engine's graphs that a collection frees inside another
    # engine's capture are destroyed there, which fails the capture: the
    # tick's captures run with automatic collection off (its warm-up not)
    import gc
    eng = Engine(Config(**GRAPH_CFGS["ycsb"]), device=dev)
    tick, seen = eng._tick_fns[True], []

    def spy(state):
        seen.append(gc.isenabled())
        return tick(state)

    eng._tick_fns[True] = spy
    eng.run_compiled(3)
    assert seen == [True] * 3 + [False] * 3 and gc.isenabled()


def test_graph_replay_without_fused_kernel(dev):
    # the plain sorts (torch.sort) are captured as well
    cfg = Config(**GRAPH_CFGS["ycsb"])
    eng = Engine(cfg, device=dev)
    _assert_same_run(eng, eng.run(20), eng.run_compiled(20))


def test_graph_replay_traced_launches(dev):
    # torch.profiler sees the fused kernels of replayed graphs: as many per
    # tick as the phase graphs captured
    eng = Engine(Config(cc_alg="NO_WAIT", fused_arbitrate=True,
                        **GRAPH_CFGS["tpcc"]), device=dev)
    box = [eng.advance(0, eng.init_state(), compiled=True)]

    def replay():
        box[0] = eng.advance(1, box[0], compiled=True)

    per = breakdown(trace_kernels(replay, 6, expect_sort=6 * 7), 6)
    assert per["fused_sort_scan_launches"] == 7, per


#: the lock family's arbitration opt-ins, by name: (plugin, workload,
#: overrides)
LOCK_OPTINS = {
    "nowait_subticks": ("NO_WAIT", "ycsb", dict(sub_ticks=4)),
    "waitdie_subticks_pipelined": ("WAIT_DIE", "ycsb",
                                   dict(sub_ticks=4, pipeline_exchange=True)),
    "timestamp_subticks": ("TIMESTAMP", "ycsb", dict(sub_ticks=4)),
    "timestamp_subticks_tpcc": ("TIMESTAMP", "tpcc", dict(sub_ticks=4)),
    "nowait_dense": ("NO_WAIT", "ycsb", dict(dense_lock_state=True)),
    "waitdie_dense_window6": ("WAIT_DIE", "ycsb",
                              dict(dense_lock_state=True, acquire_window=6)),
    "waitdie_dense_pps": ("WAIT_DIE", "pps", dict(dense_lock_state=True)),
    "nowait_dense_tpcc": ("NO_WAIT", "tpcc", dict(dense_lock_state=True)),
    "waitdie_read_committed": ("WAIT_DIE", "ycsb",
                               dict(isolation_level="READ_COMMITTED")),
    "nowait_read_uncommitted": ("NO_WAIT", "ycsb",
                                dict(isolation_level="READ_UNCOMMITTED")),
    "waitdie_nolock": ("WAIT_DIE", "ycsb", dict(isolation_level="NOLOCK")),
}


@pytest.mark.parametrize("case", sorted(LOCK_OPTINS))
def test_lock_optin_engine_cuda_matches_cpu_and_replay(dev, case):
    # CUDA == CPU after 40 eager ticks, and 40 replayed ticks == the eager
    # ones: the sub-rounds, the dense window (its scratch in place) and
    # the isolation levels on the kernel, with no host read in a replay
    cc, workload, over = LOCK_OPTINS[case]
    cfg = Config(cc_alg=cc, fused_arbitrate=True,
                 **{**GRAPH_CFGS[workload], **over})
    gpu = Engine(cfg, device=dev)
    cpu = Engine(cfg, pool=gpu.pool, device="cpu")
    sg, sc = gpu.run(40), cpu.run(40)
    assert gpu.summary(sg) == cpu.summary(sc)
    assert gpu.summary(sg)["txn_cnt"] > 0
    assert torch.equal(sg.data.cpu(), sc.data)
    for part in ("tables", "db"):
        for k, v in getattr(sc, part).items():
            assert torch.equal(getattr(sg, part)[k].cpu(), v), k
    for f in sc.txn._fields:
        assert torch.equal(getattr(sg.txn, f).cpu(), getattr(sc.txn, f)), f
    rep = gpu.run_compiled(40)
    _assert_same_run(gpu, sg, rep)
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu.advance(3, rep, compiled=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_subtick_rounds_launch_2k_plus_1_sorts(dev):
    # K rounds of a lock sort and an unpermute, and the ts_groups rank:
    # 2K + 1 launches a tick, eager and per replay
    K = 4
    for cc, pack in (("NO_WAIT", (3, 2, 256, 1)),
                     ("TIMESTAMP", (7, 2, 256, 0))):
        eng = Engine(Config(cc_alg=cc, fused_arbitrate=True, sub_ticks=K,
                            **GRAPH_CFGS["ycsb"]), device=dev)
        st = eng.run(5)
        fused.reset_launches()
        eng.run(10, st)
        want = {pack: 10 * K, (2, 1, 256, 0): 10 * K, (2, 1, 64, 0): 10}
        assert fused.LAUNCHES_BY_PACK == want, fused.LAUNCHES_BY_PACK
        eng.run_compiled(1)
        assert eng.graphs.launches_of(0, 1) == {
            p: n // 10 for p, n in want.items()}


@pytest.mark.parametrize("n", [8192, 81_920])
def test_lock_optin_packs_match_plain_in_one_launch(dev, n):
    # the ts_groups rank (ts, lane) by 1 key with dead lanes at BIG_TS, and
    # the dense window's request sort (row, ts, lane | is_write << 23) by
    # 2 keys with dead lanes keyed INT32_MAX
    rng = np.random.default_rng(n)
    live = rng.random(n) < 0.7
    ts = np.where(live, rng.permutation(4 * n)[:n] + 1, 2**31 - 1)
    lane = np.arange(n)
    row = np.where(live, rng.integers(0, 4096, n), 2**31 - 1)
    pay = lane | ((rng.random(n) < 0.5).astype(np.int64) << 23)
    as_t = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    groups = [as_t(ts), as_t(lane)]
    window = [as_t(row), as_t(ts), as_t(pay)]
    _check(groups, 1)
    _check(window, 2)
    _assert_one_device_launch(lambda: fused.fused_sort_scan(groups, 1))
    _assert_one_device_launch(lambda: fused.fused_sort_scan(window, 2))


def _rebase_arrays(dev, n, seed):
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, 2**30 - 1, 2**30, 2**30 + 1, 2**31 - 1])
    vals = np.concatenate([edge, rng.integers(0, 2**31, n)])[:n]
    return [torch.from_numpy(rng.permutation(vals).astype(np.int32)).to(dev)
            for _ in range(2)]


@pytest.mark.parametrize("n", [1, 5, 4096, 1_000_003])
@pytest.mark.parametrize("shift", [0, 1, 2**30])
def test_rebase_kernel_matches_plain(dev, n, shift):
    # one launch rebases both arrays in place; int4 body and scalar tail
    a, b = _rebase_arrays(dev, n, n + shift)
    want = [x.clone() for x in (a, b)]
    s = torch.tensor(shift, dtype=torch.int64, device=dev)
    rebase.rebase_plain(*want, s)
    before = rebase.LAUNCHES.get("plain", 0)
    rebase.rebase_(a, b, s)
    assert rebase.LAUNCHES["plain"] == before + 1
    assert torch.equal(a, want[0]) and torch.equal(b, want[1])


@pytest.mark.parametrize("n", [1, 5, 4096, 1_000_003])
@pytest.mark.parametrize("shift", [0, 1, 2**30])
def test_rebase_kernel_ring_mode_matches_plain(dev, n, shift):
    # MVCC's ring rule: empty slots (0) stay 0, versions stay >= 1
    a, b = _rebase_arrays(dev, n, 7 * n + shift)
    want = [x.clone() for x in (a, b)]
    s = torch.tensor(shift, dtype=torch.int64, device=dev)
    rebase.rebase_plain(*want, s, ring=True)
    before = rebase.LAUNCHES.get("ring", 0)
    rebase.rebase_(a, b, s, ring=True)
    assert rebase.LAUNCHES["ring"] == before + 1
    assert torch.equal(a, want[0]) and torch.equal(b, want[1])


def test_rebase_kernel_in_a_graph_reads_its_shift_at_replay(dev):
    # captured once, the kernel takes the shift the tick computed before it
    # at each replay: 0 leaves the arrays, 2^30 lowers them
    a, b = _rebase_arrays(dev, 4099, 3)
    a0, b0 = a.clone(), b.clone()
    s = torch.zeros((), dtype=torch.int64, device=dev)
    rebase.rebase_(a, b, s)       # build and load before the capture
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        rebase.rebase_(a, b, s)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(a, a0) and torch.equal(b, b0)
    s.fill_(2**30)
    g.replay()
    rebase.rebase_plain(a0, b0, s)
    assert torch.equal(a, a0) and torch.equal(b, b0)


def test_rebase_kernel_refuses_other_arrays(dev):
    a = torch.zeros(8, dtype=torch.int32, device=dev)
    s = torch.zeros((), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="int32"):
        rebase.rebase_(a, a[:4], s)
    with pytest.raises(ValueError, match="int64"):
        rebase.rebase_(a, a.clone(), s.to(torch.int32))


def test_graph_capture_failure_raises(dev):
    # a tick that reads the device on the host cannot be captured: here
    # the eager tick's effect branch, given to run_compiled.  run_compiled
    # raises; it never falls back to the eager tick
    eng = Engine(Config(fused_arbitrate=True, **GRAPH_CFGS["tpcc"]),
                 device=dev)
    eng._tick_fns[True] = eng._tick_fns[False]
    with pytest.raises(RuntimeError, match="capture"):
        eng.run_compiled(3)
