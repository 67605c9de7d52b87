"""The port stands alone: it imports neither jax nor deneva_tpu, asking for
a device it cannot have raises, a config outside the ported slice raises,
and a kernel that cannot be built raises."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from deneva_tpu_torch.config import Config  # noqa: E402
from deneva_tpu_torch.engine.scheduler import Engine  # noqa: E402
from deneva_tpu_torch.ops import cuda_build  # noqa: E402
from deneva_tpu_torch.parallel.sharded import ShardedEngine  # noqa: E402
from deneva_tpu_torch.storage.ordered import OrderedIndex  # noqa: E402

REPO = Path(__file__).resolve().parent.parent

MODULES = (
    "deneva_tpu_torch", "deneva_tpu_torch.config", "deneva_tpu_torch.cells",
    "deneva_tpu_torch.device",
    "deneva_tpu_torch.stats", "deneva_tpu_torch.__main__",
    "deneva_tpu_torch.workloads", "deneva_tpu_torch.workloads.base",
    "deneva_tpu_torch.workloads.ycsb", "deneva_tpu_torch.workloads.tpcc",
    "deneva_tpu_torch.workloads.pps", "deneva_tpu_torch.storage",
    "deneva_tpu_torch.storage.catalog", "deneva_tpu_torch.storage.ordered",
    "deneva_tpu_torch.engine.state",
    "deneva_tpu_torch.engine.scheduler", "deneva_tpu_torch.engine.graph",
    "deneva_tpu_torch.ops.segment",
    "deneva_tpu_torch.ops.fused", "deneva_tpu_torch.ops.cuda_build",
    "deneva_tpu_torch.ops.rebase", "deneva_tpu_torch.ops.device_loop",
    "deneva_tpu_torch.cc", "deneva_tpu_torch.cc.base",
    "deneva_tpu_torch.cc.compact", "deneva_tpu_torch.cc.twopl",
    "deneva_tpu_torch.cc.no_wait", "deneva_tpu_torch.cc.timestamp",
    "deneva_tpu_torch.cc.calvin", "deneva_tpu_torch.cc.occ",
    "deneva_tpu_torch.cc.maat",
    "deneva_tpu_torch.parallel", "deneva_tpu_torch.parallel.routing",
    "deneva_tpu_torch.parallel.sharded",
    "deneva_tpu_torch.profile_tick",
    "chip_smoke",
)


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib'))\n"
        "             or m == 'deneva_tpu' or m.startswith('deneva_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_port_sources_name_no_jax_import():
    for path in (REPO / "deneva_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax",
                                     "import deneva_tpu ",
                                     "from deneva_tpu ",
                                     "from deneva_tpu.")), (path, line)


def test_cuda_engine_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine(Config(batch_size=8, synth_table_size=64, req_per_query=2,
                      query_pool_size=16))


def test_ordered_index_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        OrderedIndex([1, 2, 3])


def test_cpu_engine_runs():
    eng = Engine(Config(batch_size=8, synth_table_size=64, req_per_query=2,
                        query_pool_size=16), device="cpu")
    assert eng.device.type == "cpu"
    assert eng.summary(eng.run(5))["measured_ticks"] == 5


OUTSIDE = {
    # MVCC's depgraph blocker plane is not ported
    "mvcc_depgraph": dict(cc_alg="MVCC", depgraph=True,
                          abort_attribution=True),
    # CALVIN's depgraph blocker plane is not ported
    "calvin_depgraph": dict(cc_alg="CALVIN", depgraph=True,
                            abort_attribution=True),
    # nor is the sharded CALVIN (its epoch log and forwarding exchange)
    "calvin_multi_partition": dict(cc_alg="CALVIN", part_cnt=2),
    # TIMESTAMP's sub-ticked path runs, but not with its blocker plane
    "timestamp_sub_ticks_depgraph": dict(cc_alg="TIMESTAMP", sub_ticks=2,
                                         depgraph=True,
                                         abort_attribution=True),
    # OCC's depgraph victim plane is not ported
    "occ_depgraph": dict(cc_alg="OCC", depgraph=True,
                         abort_attribution=True),
    # nor is the sharded OCC (its per-owner group_and verdicts)
    "occ_multi_partition": dict(cc_alg="OCC", part_cnt=2),
    # MAAT's depgraph plane is not ported
    "maat_depgraph": dict(cc_alg="MAAT", depgraph=True,
                          abort_attribution=True),
    # nor is the sharded MAAT (its per-owner TimeTables and forward pushes)
    "maat_multi_partition": dict(cc_alg="MAAT", part_cnt=2),
    # TPC-C and PPS are ported on one shard only
    "pps": dict(workload="PPS", part_cnt=2),
    "tpcc": dict(workload="TPCC", part_cnt=2),
    # every isolation level runs, but only in NORMAL mode
    "read_committed_nocc": dict(isolation_level="READ_COMMITTED",
                                mode="NOCC"),
    "nocc_mode": dict(mode="NOCC"),
    # the lock family's sub-rounds run, but not with their blocker plane
    "sub_ticks_depgraph": dict(sub_ticks=2, depgraph=True,
                               abort_attribution=True),
    # the dense-row window runs on one shard only
    "dense_lock_state_multi_partition": dict(dense_lock_state=True,
                                             part_cnt=2),
    # pipeline_exchange's single-shard leg runs; the split exchange not
    "exchange_split": dict(exchange_split=True),
    # commit after access runs, but not with an unported flag
    "commit_after_access": dict(commit_after_access=True, logging=True),
    # live-entry compaction runs, but not with an unported flag: the
    # compact_spill reason restamp, and the trace row's compaction deltas
    "compact_auto": dict(compact_auto=True, abort_attribution=True),
    "compact_lanes": dict(compact_lanes=24, trace_ticks=8),
    "abort_attribution": dict(abort_attribution=True),
    "trace_ticks": dict(trace_ticks=8),
    "logging": dict(logging=True),
    "heatmap": dict(heatmap_bins=16),
    "multi_partition": dict(part_cnt=2),
}


@pytest.mark.parametrize("case", sorted(OUTSIDE))
def test_config_outside_the_slice_raises(case):
    cfg = Config(batch_size=8, synth_table_size=64, req_per_query=2,
                 query_pool_size=16, **OUTSIDE[case])
    with pytest.raises(NotImplementedError, match="outside the ported slice"):
        Engine(cfg, device="cpu")


@pytest.mark.parametrize("case", sorted(OUTSIDE))
def test_config_outside_the_slice_raises_with_commit_after_access(case):
    # commit_after_access admits none of the refused configs
    cfg = Config(batch_size=8, synth_table_size=64, req_per_query=2,
                 query_pool_size=16,
                 **{**OUTSIDE[case], "commit_after_access": True})
    with pytest.raises(NotImplementedError, match="outside the ported slice"):
        Engine(cfg, device="cpu")


def test_commit_after_access_alone_is_admitted():
    eng = Engine(Config(batch_size=8, synth_table_size=64, req_per_query=2,
                        query_pool_size=16, commit_after_access=True),
                 device="cpu")
    assert eng.summary(eng.run(5))["measured_ticks"] == 5


#: what the sharded engine refuses: other plugins and workloads, the
#: sharded opt-ins still to port, the mode ladder, compaction, and the
#: isolation levels but SERIALIZABLE
SHARDED_OUTSIDE = {
    "wait_die": dict(cc_alg="WAIT_DIE"),
    "timestamp": dict(cc_alg="TIMESTAMP"),
    "calvin": dict(cc_alg="CALVIN"),
    "tpcc": dict(workload="TPCC"),
    "pps": dict(workload="PPS"),
    "net_delay_ticks": dict(net_delay_ticks=1),
    "exchange_split": dict(exchange_split=True),
    "pipeline_exchange": dict(pipeline_exchange=True, exchange_split=True),
    "remote_cache": dict(remote_cache=True),
    "nocc_mode": dict(mode="NOCC"),
    "compact_auto": dict(compact_auto=True),
    "compact_lanes": dict(compact_lanes=24),
    "read_committed": dict(isolation_level="READ_COMMITTED"),
    "logging": dict(logging=True),
    "mesh": dict(mesh=True),
    "abort_attribution": dict(abort_attribution=True),
    "sub_ticks": dict(sub_ticks=2),
    "dense_lock_state": dict(dense_lock_state=True),
    "nine_nodes": dict(node_cnt=9, part_cnt=9, synth_table_size=72),
    "parts_per_node": dict(node_cnt=2, part_cnt=4),
}


@pytest.mark.parametrize("case", sorted(SHARDED_OUTSIDE))
def test_sharded_config_outside_the_slice_raises(case):
    kw = dict(dict(node_cnt=2, part_cnt=2), **SHARDED_OUTSIDE[case])
    cfg = Config(batch_size=8, synth_table_size=kw.pop("synth_table_size",
                                                       64),
                 req_per_query=2, query_pool_size=16, **kw)
    with pytest.raises(NotImplementedError, match="outside the ported slice"):
        ShardedEngine(cfg, device="cpu")


def test_engine_refuses_nodes_and_names_the_sharded_engine():
    with pytest.raises(NotImplementedError, match="ShardedEngine"):
        Engine(Config(node_cnt=2, part_cnt=2, batch_size=8,
                      synth_table_size=64, req_per_query=2,
                      query_pool_size=16), device="cpu")


def test_sharded_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = Config(node_cnt=2, part_cnt=2, batch_size=8, synth_table_size=64,
                 req_per_query=2, query_pool_size=16)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedEngine(cfg)
    eng = ShardedEngine(cfg, device="cpu")
    assert eng.summary(eng.run(3))["measured_ticks"] == 3


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load_library("fused_sort_scan")


def test_build_all_starts_every_build_and_raises_on_a_failure(
        monkeypatch, tmp_path):
    # one nvcc per source, all started before the first is waited for; a
    # failed one raises, and no library is left behind
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    events = []
    popen = cuda_build.subprocess.Popen

    def spy(*a, **k):
        proc = popen(*a, **k)
        events.append("start")
        wait = proc.communicate
        proc.communicate = lambda: (events.append("wait"), wait())[1]
        return proc

    monkeypatch.setattr(cuda_build.subprocess, "Popen", spy)
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        cuda_build.build_all(("fused_sort_scan", "ts_rebase"))
    assert events[:3] == ["start", "start", "wait"], events
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_build_raises(monkeypatch, tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        cuda_build.load_library("fused_sort_scan")
    assert not list((tmp_path / "build").glob("*.so"))
