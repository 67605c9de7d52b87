"""Runtime configuration, the port's own copy.

Every field and default matches ``deneva_tpu/config.py:Config``, so the
same keyword arguments build the same configuration in both packages and
the two engines can be held against each other.  The port implements one
slice of that space (see ``engine/scheduler.py:check_slice``); every other
value is accepted here and refused by the engine, never run silently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# CC algorithms (reference config.h:94-101)
NO_WAIT = "NO_WAIT"
WAIT_DIE = "WAIT_DIE"
TIMESTAMP = "TIMESTAMP"
MVCC = "MVCC"
OCC = "OCC"
MAAT = "MAAT"
CALVIN = "CALVIN"
CC_ALGS = (NO_WAIT, WAIT_DIE, TIMESTAMP, MVCC, OCC, MAAT, CALVIN)

# Workloads (reference config.h:40)
YCSB = "YCSB"
TPCC = "TPCC"
PPS = "PPS"
WORKLOADS = (YCSB, TPCC, PPS)

# Isolation levels (reference config.h:336-340)
SERIALIZABLE = "SERIALIZABLE"
READ_COMMITTED = "READ_COMMITTED"
READ_UNCOMMITTED = "READ_UNCOMMITTED"
NOLOCK = "NOLOCK"
ISOLATION_LEVELS = (SERIALIZABLE, READ_COMMITTED, READ_UNCOMMITTED, NOLOCK)

# Debug mode ladder (reference config.h:314-319)
MODE_NORMAL = "NORMAL"
MODE_NOCC = "NOCC"
MODE_QRY_ONLY = "QRY_ONLY"
MODE_SIMPLE = "SIMPLE"
MODES = (MODE_NORMAL, MODE_NOCC, MODE_QRY_ONLY, MODE_SIMPLE)

# Open-system arrival models
ARRIVAL_MODELS = ("poisson", "mmpp", "step")


def _optin(default, on: dict, engines=("tick", "sharded_tick")):
    """Declare a Config field an opt-in feature flag: off (its default)
    must leave the tick and the ``[summary]`` line untouched.  ``on`` is
    the kwarg set that turns the feature on; ``engines`` the tick
    builders it applies to.  Read back by ``optin_flags()``."""
    return dataclasses.field(default=default, metadata={
        "certify": {"on": dict(on), "engines": tuple(engines)}})


@dataclasses.dataclass(frozen=True)
class Config:
    """One experiment cell: (CC_ALG x WORKLOAD x knobs)."""

    # --- topology ---
    node_cnt: int = 1
    part_cnt: int = 1

    # --- workload selection ---
    workload: str = YCSB
    cc_alg: str = NO_WAIT
    isolation_level: str = SERIALIZABLE
    mode: str = MODE_NORMAL
    debug_invariants: bool = _optin(False, {"debug_invariants": True})

    # --- scheduler / batch engine ---
    batch_size: int = 4096           # in-flight txns per node (B)
    max_ticks: int = 1_000_000
    warmup_ticks: int = 0
    acquire_window: int = 1          # accesses attempted per tick
    admit_cap: Optional[int] = None  # fresh admissions per tick (None = B)

    # --- open-system arrivals ---
    arrival: Optional[str] = _optin(
        None, {"arrival": "poisson", "arrival_rate": 2.0})
    arrival_rate: float = 0.0
    arrival_burst_rate: float = 0.0
    arrival_p_burst: float = 0.01
    arrival_p_calm: float = 0.10
    arrival_schedule: tuple = ()
    arrival_seed: int = 7
    fam_lat_samples: int = 1 << 12

    commit_after_access: bool = False
    sub_ticks: int = 1
    dense_lock_state: bool = False

    # --- abort/backoff (reference config.h:112-114) ---
    abort_penalty_ticks: int = 1
    abort_penalty_max_ticks: int = 64
    backoff: bool = True
    restart_new_ts: bool = False

    # --- YCSB (reference config.h:216-233) ---
    synth_table_size: int = 1 << 14
    req_per_query: int = 10
    tup_read_perc: float = 0.5
    txn_read_perc: float = 0.0
    zipf_theta: float = 0.6
    skew_method: str = "zipf"
    access_perc: float = 0.75
    data_perc: float = 0.10
    part_per_txn: int = 1
    mpr: float = 1.0
    first_part_local: bool = True
    strict_ppt: bool = False
    key_order: bool = False

    # --- TPC-C (reference config.h:244-260) ---
    num_wh: int = 4
    perc_payment: float = 0.5
    wh_update: bool = True
    dist_per_wh: int = 10
    cust_per_dist: int = 2000
    max_items: int = 1024
    max_items_per_txn: int = 15
    tpcc_by_last_name_perc: float = 0.6
    tpcc_rbk_perc: float = 0.0
    tpcc_max_orders: int = 1 << 12
    tpcc_ol_cap: int = 1 << 16
    tpcc_hist_cap: int = 1 << 14

    # --- PPS (reference config.h:235-242) ---
    max_parts_per: int = 10
    max_part_key: int = 1024
    max_product_key: int = 1024
    max_supplier_key: int = 1024
    perc_pps_getpart: float = 0.0
    perc_pps_getproduct: float = 0.0
    perc_pps_getsupplier: float = 0.0
    perc_pps_getpartbysupplier: float = 0.0
    perc_pps_getpartbyproduct: float = 0.2
    perc_pps_orderproduct: float = 0.6
    perc_pps_updateproductpart: float = 0.2
    perc_pps_updatepart: float = 0.0

    # --- T/O family ---
    ts_twr: bool = False
    his_recycle_len: int = 8

    # --- live-entry compaction ---
    entry_compaction: bool = True
    compact_auto: bool = _optin(False, {"compact_auto": True})
    compact_lanes: Optional[int] = _optin(None, {"compact_lanes": 24})
    maat_chain_window: int = 8

    #: route every eligible sort of the tick through the fused
    #: sort + segment-scan kernel (ops/fused.py); decisions are
    #: bit-identical to the plain sort path
    fused_arbitrate: bool = _optin(False, {"fused_arbitrate": True})
    #: the JAX package's VMEM guard for its TPU kernel; the Hopper kernel
    #: does not read it (ops/fused.py states its own limit)
    fused_max_lanes: int = 8192

    # --- logging / replication ---
    logging: bool = _optin(False, {"logging": True})
    log_flush_ticks: int = 1
    repl_cnt: int = _optin(0, {"logging": True, "repl_cnt": 1},
                           engines=("sharded_tick",))
    repl_mode: str = "aa"
    repl_lag_ticks: int = 1
    log_buf_cap: int = 1 << 16

    # --- Calvin ---
    seq_batch_size: Optional[int] = None

    # --- multi-shard routing ---
    route_capacity_factor: float = 2.0
    net_delay_ticks: int = _optin(0, {"net_delay_ticks": 2},
                                  engines=("sharded_tick",))

    # --- observatories ---
    trace_ticks: int = _optin(0, {"trace_ticks": 8})
    abort_attribution: bool = _optin(False, {"abort_attribution": True})
    flight: bool = _optin(False, {"flight": True, "abort_attribution": True})
    flight_samples: int = 1 << 12
    heatmap_bins: int = _optin(0, {"heatmap_bins": 16})
    heatmap_topk: int = 8

    # --- adaptive contention controller ---
    adaptive: bool = _optin(False, {"adaptive": True,
                                    "abort_attribution": True,
                                    "heatmap_bins": 16})
    ctrl_ewma_shift: int = 3
    ctrl_gain_shift: int = 2
    ctrl_backoff_max: int = 64
    ctrl_esc_keys: int = 8
    ctrl_esc_up: int = 8
    ctrl_esc_down: int = 2
    ctrl_esc_share: int = 8
    ctrl_esc_overload: int = 4
    ctrl_sub_ticks: int = 2

    prog_interval: int = _optin(0, {"prog_interval": 4})
    profile: bool = _optin(False, {"profile": True})
    mesh: bool = _optin(False, {"mesh": True}, engines=("sharded_tick",))

    # --- fault plane ---
    faults: tuple = _optin((), {"faults": (("straggle", 1, 2, 6),)},
                           engines=("sharded_tick",))
    fault_elog_cap: int = 1 << 12

    # --- scale-out exchange ---
    exchange_split: bool = _optin(False, {"exchange_split": True},
                                  engines=("sharded_tick",))
    pipeline_exchange: bool = _optin(
        False, {"pipeline_exchange": True, "exchange_split": True},
        engines=("sharded_tick",))
    remote_cache: bool = _optin(False, {"remote_cache": True},
                                engines=("sharded_tick",))
    remote_cache_buckets: int = 256
    checkpoint_every: int = _optin(0, {"checkpoint_every": 4})
    xmeter: bool = _optin(False, {"xmeter": True})

    # --- SLO plane ---
    slo: bool = _optin(False, {"slo": True})
    slo_hist_bins: int = 96
    slo_p99_ceiling: int = 64
    slo_target: float = 0.99
    slo_burn_fast: int = 5
    slo_burn_slow: int = 50
    slo_burn_threshold: float = 2.0
    slo_served_floor: float = 0.95
    slo_abort_cap: float = 0.5
    slo_export_interval: int = 10

    # --- windowed snapshots and dependency graph ---
    windows: bool = _optin(False, {"windows": True})
    window_ticks: int = 8
    window_slots: int = 64
    depgraph: bool = _optin(False, {"depgraph": True,
                                    "abort_attribution": True})
    dep_samples: int = 1 << 12

    # --- run protocol ---
    seed: int = 12345
    query_pool_size: int = 1 << 16

    def __post_init__(self):
        # the value checks the engine relies on; the JAX package's further
        # checks concern features outside this port's slice, which the
        # engine refuses as a whole
        assert self.cc_alg in CC_ALGS, self.cc_alg
        assert self.workload in WORKLOADS, self.workload
        assert self.isolation_level in ISOLATION_LEVELS
        assert self.mode in MODES, self.mode
        if self.commit_after_access:
            assert self.node_cnt == 1
        if self.sub_ticks > 1:
            assert self.cc_alg in (NO_WAIT, WAIT_DIE, TIMESTAMP)
            assert self.acquire_window == 1, "sub_ticks needs window=1"
        assert self.repl_mode in ("aa", "ap")
        if self.flight or self.depgraph or self.adaptive:
            assert self.abort_attribution
        assert self.heatmap_bins >= 0 and \
            (self.heatmap_bins & (self.heatmap_bins - 1)) == 0, \
            "heatmap_bins must be 0 or a power of two"
        assert self.skew_method in ("zipf", "hot"), self.skew_method
        if self.skew_method == "hot":
            assert 0.0 <= self.access_perc <= 1.0, self.access_perc
            assert 0.0 < self.data_perc <= 1.0, self.data_perc
        assert self.checkpoint_every >= 0
        if self.repl_mode != "ap":
            assert self.part_cnt >= self.node_cnt \
                and self.part_cnt % self.node_cnt == 0
        assert self.synth_table_size % self.part_cnt == 0
        # row ids must fit 30 bits: lock arbitration packs (row_id, kind)
        # into one int32 sort key (cc/twopl.py)
        assert self.synth_table_size < 1 << 30, \
            "table too large for packed sort keys"

    @property
    def rows_per_part(self) -> int:
        return self.synth_table_size // self.part_cnt

    @property
    def epoch_size(self) -> int:
        return (self.seq_batch_size if self.seq_batch_size is not None
                else self.batch_size)

    def compact_width(self, n_entries: int, batch: int,
                      request_all: bool = False) -> int:
        """Static compacted lane count K for an ``n_entries = B * R``
        entry view; ``n_entries`` when compaction is off or not opted in."""
        if not self.entry_compaction or n_entries <= 0 or batch <= 0:
            return n_entries
        if self.compact_lanes is not None:
            return min(max(self.compact_lanes, 1), n_entries)
        if request_all or not self.compact_auto:
            return n_entries
        R = n_entries // batch
        avg_live = -(-R // 2) + min(self.acquire_window, R)
        K = batch * avg_live
        K = -(-K // 256) * 256
        return min(K, n_entries)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class OptinFlag:
    """One opt-in flag: field name, off value, the kwargs that turn it on,
    and the tick builders it applies to."""

    name: str
    default: object
    on: dict
    engines: tuple


def optin_flags() -> dict:
    """Every Config field declared through ``_optin``, keyed by name."""
    out = {}
    for f in dataclasses.fields(Config):
        cert = f.metadata.get("certify")
        if cert is None:
            continue
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
        out[f.name] = OptinFlag(name=f.name, default=default,
                                on=dict(cert["on"]),
                                engines=tuple(cert["engines"]))
    return out
