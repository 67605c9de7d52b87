"""Tests of the port that need a CUDA device: the Hopper kernel against
its plain version, and the engine's CUDA path against its CPU path.  They
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
from deneva_tpu_torch.ops import fused  # noqa: E402
from deneva_tpu_torch.profile_tick import breakdown, trace_kernels  # noqa: E402

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


def _device_launches(fn) -> int:
    """Kernels the card ran for one call of `fn` (torch.profiler)."""
    return breakdown(trace_kernels(fn, 1, expect_sort=1), 1)[
        "kernel_launches"]


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
    assert _device_launches(lambda: fused.fused_sort_scan(cols, 2, 1)) == 1


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
