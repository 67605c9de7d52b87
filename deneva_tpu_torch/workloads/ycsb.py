"""YCSB query generation.

Replicates the statistics of the reference generator
(benchmarks/ycsb_query.cpp): the "quickly generating billion-record synthetic
databases" zipf sampler with the reference's zeta/eta formulas
(ycsb_query.cpp:181-202), per-request read/write choice
``r_twr < txn_read_perc or r < tup_read_perc`` (ycsb_query.cpp:332-336),
FIRST_PART_LOCAL / strict part-per-txn partition choice (ycsb_query.cpp:303-330),
distinct keys within a txn (resample on duplicate, ycsb_query.cpp:346-353),
and primary_key = row_id * part_cnt + partition_id striping (ycsb_query.cpp:338).

Generation is vectorized numpy on the host, a copy of
``deneva_tpu/workloads/ycsb.py``: the same config and seed give a
byte-equal pool in both packages.
"""

from __future__ import annotations

import numpy as np

from deneva_tpu_torch.config import Config
from deneva_tpu_torch.workloads.base import QueryPool, WorkloadPlugin


class YCSBWorkload(WorkloadPlugin):
    """YCSB has no commit-time data effects beyond the engine's built-in
    per-row write-count oracle (the reference's YCSB_1 compute step just
    reads/overwrites a field, ycsb_txn.cpp:227-246)."""

    name = "YCSB"
    has_effects = False

    def gen_pool(self, cfg: Config) -> QueryPool:
        return gen_query_pool(cfg)

    def cc_rows(self, cfg: Config) -> int:
        return cfg.synth_table_size


def zeta(n: int, theta: float) -> float:
    """sum_{i=1..n} (1/i)^theta  (ycsb_query.cpp:181-186)."""
    i = np.arange(1, n + 1, dtype=np.float64)
    return float(np.sum(np.power(1.0 / i, theta)))


class ZipfSampler:
    """Vectorized port of YCSBQueryGenerator::zipf (ycsb_query.cpp:188-202).

    Returns row ids in [1, n] (row 0 of each partition is never sampled,
    matching the reference).
    """

    def __init__(self, n: int, theta: float):
        self.n = n
        self.theta = theta
        self.zetan = zeta(n, theta)
        self.zeta_2 = zeta(2, theta)
        if theta == 1.0:
            raise ValueError("zipf_theta == 1.0 is singular (alpha = 1/(1-theta))")
        self.alpha = 1.0 / (1.0 - theta)
        self.eta = (1.0 - np.power(2.0 / n, 1.0 - theta)) / (1.0 - self.zeta_2 / self.zetan)

    def sample(self, rng: np.random.Generator, size) -> np.ndarray:
        # reference draws u = (rand % 10M) / 10M
        u = rng.integers(0, 10_000_000, size=size).astype(np.float64) / 10_000_000.0
        uz = u * self.zetan
        out = 1 + (self.n * np.power(self.eta * u - self.eta + 1.0, self.alpha)).astype(np.int64)
        out = np.where(uz < 1.0, 1, np.where(uz < 1.0 + 0.5**self.theta, 2, out))
        return np.minimum(out, self.n).astype(np.int64)


class HotSampler:
    """The reference's second skew generator (SKEW_METHOD == HOT,
    ycsb_query.cpp:205-301): ACCESS_PERC of the traffic goes to the
    DATA_PERC fraction of the table (``gen_requests_hot``'s
    access-to-hot-data coin, with the hot set being the lowest row ids).
    Same interface and [1, n] id range as :class:`ZipfSampler`, so the
    de-duplication resample loop below works unchanged."""

    def __init__(self, n: int, access_perc: float, data_perc: float):
        assert n >= 1
        self.n = n
        self.access_perc = access_perc
        # ceil-free floor with a 1-row minimum; data_perc == 1 degrades
        # to uniform over the whole table (every row "hot")
        self.hot_n = min(n, max(1, int(data_perc * n)))

    def sample(self, rng: np.random.Generator, size) -> np.ndarray:
        # reference draws u = (rand % 10M) / 10M for the access coin
        u = rng.integers(0, 10_000_000, size=size) / 10_000_000.0
        hot = u < self.access_perc
        hot_ids = rng.integers(1, self.hot_n + 1, size=size)
        if self.hot_n >= self.n:
            return hot_ids.astype(np.int64)
        cold_ids = rng.integers(self.hot_n + 1, self.n + 1, size=size)
        return np.where(hot, hot_ids, cold_ids).astype(np.int64)


def make_sampler(cfg: Config, n: int):
    """Per-partition row-id sampler for ``Config.skew_method``."""
    if cfg.skew_method == "hot":
        return HotSampler(n, cfg.access_perc, cfg.data_perc)
    return ZipfSampler(n, cfg.zipf_theta)


def gen_query_pool(cfg: Config, seed: int | None = None) -> QueryPool:
    """Pre-generate cfg.query_pool_size YCSB transactions."""
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    Q, R, P = cfg.query_pool_size, cfg.req_per_query, cfg.part_cnt
    table_size = cfg.synth_table_size // P  # rows per partition
    sampler = make_sampler(cfg, table_size - 1)

    home_part = (np.arange(Q, dtype=np.int64) % P)

    # --- read/write choice (ycsb_query.cpp:315,332-336) ---
    r_twr = rng.integers(0, 10_000, size=(Q, 1)) / 10_000.0      # per-txn
    r_tup = rng.integers(0, 10_000, size=(Q, R)) / 10_000.0      # per-request
    is_read = (r_twr < cfg.txn_read_perc) | (r_tup < cfg.tup_read_perc)
    is_write = ~is_read

    # --- partition choice (ycsb_query.cpp:303-330) with MPR gating
    # (ycsb_query.cpp:213-217): with probability mpr a txn may span
    # multiple partitions; otherwise every request stays in the home
    # partition (part_limit = 1) ---
    part = rng.integers(0, P, size=(Q, R))
    multi = rng.integers(0, 10_000, size=Q) / 10_000.0 < cfg.mpr
    if cfg.first_part_local:
        part[:, 0] = home_part
    if cfg.strict_ppt and cfg.part_per_txn <= P:
        # exactly part_per_txn distinct partitions per txn: choose a
        # per-txn palette and map each request onto it uniformly.
        k = cfg.part_per_txn
        palette = np.argsort(rng.random((Q, P)), axis=1)[:, :k]  # k distinct parts
        if cfg.first_part_local:
            # ensure home partition is in the palette (slot 0)
            has_home = (palette == home_part[:, None]).any(axis=1)
            palette[:, 0] = np.where(has_home, palette[:, 0], home_part)
            # de-dup if home displaced an existing member duplicate is fine:
            # requests index the palette uniformly either way.
        sel = rng.integers(0, k, size=(Q, R))
        part = np.take_along_axis(palette, sel, axis=1)
        if cfg.first_part_local:
            part[:, 0] = home_part
    # MPR gate last so it binds under strict_ppt too: a non-multi txn is
    # single-partition regardless of the palette (part_limit = 1)
    part = np.where(multi[:, None], part, home_part[:, None])

    # --- zipf row ids, resampling duplicates within a txn ---
    row_id = sampler.sample(rng, (Q, R))
    keys = row_id * P + part
    for _ in range(1000):
        srt = np.sort(keys, axis=1)
        dup_exists = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        if not dup_exists.any():
            break
        # positions that duplicate an earlier position in the same txn
        dup_pos = np.zeros_like(keys, dtype=bool)
        for j in range(1, R):
            dup_pos[:, j] = (keys[:, j:j + 1] == keys[:, :j]).any(axis=1)
        n_dup = int(dup_pos.sum())
        new_rows = sampler.sample(rng, n_dup)
        new_parts = part[dup_pos] if not cfg.first_part_local else np.where(
            np.nonzero(dup_pos)[1] == 0, home_part[np.nonzero(dup_pos)[0]], part[dup_pos])
        keys[dup_pos] = new_rows * P + new_parts
    else:  # pragma: no cover
        raise RuntimeError("could not de-duplicate keys within transactions")

    if cfg.key_order:
        order = np.argsort(keys, axis=1, kind="stable")
        keys = np.take_along_axis(keys, order, axis=1)
        is_write = np.take_along_axis(is_write, order, axis=1)

    return QueryPool(
        keys=keys.astype(np.int32),
        is_write=is_write,
        n_req=np.full(Q, R, dtype=np.int32),
        home_part=home_part.astype(np.int32),
        txn_type=np.zeros(Q, dtype=np.int32),
        args=np.zeros((Q, 1), dtype=np.int32),
    )
