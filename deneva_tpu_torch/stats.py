"""Stats output contract: the reference's ``[summary]`` key=value line.

A copy of ``deneva_tpu/stats.py`` (the port imports nothing of the JAX
package), so both engines print the same line from the same counters:

- ``reference_summary``  maps the engine's stats dict onto the reference's
  key names (stats.cpp:446-470, :992-999, :392-417);
- ``format_summary``     renders the ``[summary]`` / ``[prog]`` line;
- ``parse_summary``      ports parse_results.py:19-37.

Times are in scheduler ticks unless ``wall_seconds`` converts them.
"""

from __future__ import annotations

import re
import time

import numpy as np

#: percentiles of the commit-latency sampling array, matching the
#: client_client_latency dump (stats.cpp:392-417; StatsArr quantiles,
#: statistics/stats_array.cpp).  ccl0/ccl100 are min/max.
CCL_PERCENTILES = (0, 1, 10, 25, 50, 75, 90, 95, 96, 97, 98, 99, 100)


def latency_percentiles(samples, n_valid: int) -> dict:
    """ccl* keys from the device sampling ring (first n_valid entries are
    meaningful; the ring wraps so they are the most recent commits)."""
    samples = np.asarray(samples)
    n = int(min(n_valid, samples.shape[0]))
    if n == 0:
        return {f"ccl{p}": 0.0 for p in CCL_PERCENTILES}
    s = np.sort(samples[:n].astype(np.float64))
    out = {}
    for p in CCL_PERCENTILES:
        idx = min(n - 1, max(0, int(n * p / 100) - (1 if p == 100 else 0)))
        out[f"ccl{p}"] = float(s[idx])
    out["ccl0"] = float(s[0])
    out["ccl100"] = float(s[-1])
    return out


def reference_summary(s: dict, wall_seconds: float | None = None) -> dict:
    """Engine stats dict -> reference-vocabulary flat dict.

    `s` is Engine/ShardedEngine.summary() output (which itself keeps the
    raw counter names); adds the reference's derived keys.
    """
    ticks = max(s.get("measured_ticks", 0), 1)
    tick_sec = (wall_seconds / ticks) if wall_seconds else 1.0
    commits = max(s["txn_cnt"], 1)

    out = {
        "total_runtime": ticks * tick_sec,
        "tput": s["txn_cnt"] / (ticks * tick_sec),
        "txn_cnt": s["txn_cnt"],
        "local_txn_start_cnt": s["local_txn_start_cnt"],
        "total_txn_commit_cnt": s["txn_cnt"],
        "local_txn_commit_cnt": s["txn_cnt"],
        "total_txn_abort_cnt": s["total_txn_abort_cnt"],
        "unique_txn_abort_cnt": s["unique_txn_abort_cnt"],
        "txn_run_time": s["txn_run_time_ticks"] * tick_sec,
        "txn_run_avg_time": s["txn_run_time_ticks"] * tick_sec / commits,
        "record_write_cnt": s["write_cnt"],
        "parts_touched": s.get("parts_touched", s["txn_cnt"]),
        "avg_parts_touched": s.get("parts_touched", s["txn_cnt"]) / commits,
        "multi_part_txn_cnt": s.get("multi_part_txn_cnt", 0),
        "single_part_txn_cnt": s["txn_cnt"] - s.get("multi_part_txn_cnt", 0),
        # latency decomposition (stats.cpp:992-999): integrals of txn-ticks
        # spent per scheduler state; lat_other_time covers the commit tick
        "lat_cc_block_time": s.get("lat_cc_block_time", 0.0) * tick_sec,
        "lat_abort_time": s.get("lat_abort_time", 0.0) * tick_sec,
        "lat_process_time": s.get("lat_process_time", 0.0) * tick_sec,
        "lat_network_time": s.get("lat_network_time", 0.0) * tick_sec,
        # work-queue wait: the Little's-law backlog integral of the
        # open-system arrival plane (deneva_tpu/traffic/ — txn-ticks
        # queued behind admission).  Closed-loop runs carry no backlog
        # and the key stays exactly 0.0.
        "lat_work_queue_time": s.get("lat_work_queue_time", 0.0) * tick_sec,
        # per-MESSAGE transit integral (message.h:51-57 mq_time): real
        # in the sharded engine's net-delay mode (requests/responses/
        # decision words in flight, parallel/sharded.py); single-shard
        # exchanges happen inside the tick so the key stays exactly 0.0
        "lat_msg_queue_time": s.get("lat_msg_queue_time", 0.0) * tick_sec,
        # CC counters
        "twopl_wait_cnt": s.get("twopl_wait_cnt", 0),
        "cc_vabort_cnt": s.get("vabort_cnt", 0),
        "user_abort_cnt": s.get("user_abort_cnt", 0),
    }
    # per-algorithm case/outcome families — emitted only when the run's
    # CC algorithm produced them, with keys VERBATIM (the reference
    # prints maat_caseN_cnt=%ld, stats.cpp:907).  maat_case1/3 are the
    # reference families (maat.cpp:46-48,68-70); the maat_chain_*/
    # maat_range_abort/occ_*/mvcc_* names are this build's inventions
    # (cc/maat.py init_db documents the mapping).  The fixed tuple pins
    # the legacy key ORDER (the line is a byte-compatibility contract).
    for k in ("maat_case1_cnt", "maat_case3_cnt", "maat_chain_cap_cnt",
              "maat_chain_push_cnt", "maat_range_abort_cnt",
              "maat_chain_overflow_cnt", "occ_hist_abort_cnt",
              "occ_active_abort_cnt", "mvcc_tail_fold_cnt"):
        if k in s:
            out[k] = s[k]
    # ... then any OTHER per-algorithm / observatory counter passes
    # through verbatim (sorted, after the pinned block): the abort_*
    # taxonomy of Config.abort_attribution (cc/base.py ABORT_REASONS)
    # and future plugin-private _cnt scalars.  Passthrough is
    # PREFIX-restricted, not blanket ``_cnt``: engine aggregates like
    # write_cnt/vabort_cnt/recon_cnt already map to reference names
    # above, and a blanket rule would leak them into every default line,
    # breaking byte-compatibility.
    _VERBATIM_PREFIXES = ("abort_", "maat_", "occ_", "mvcc_", "calvin_")
    for k in sorted(s):
        if k.endswith("_cnt") and k.startswith(_VERBATIM_PREFIXES) \
                and k not in out:
            out[k] = s[k]
    # compile & memory observatory keys (Config.xmeter, obs/xmeter.py)
    # pass through verbatim too — present only when the engine summary
    # carries them, so the default line stays byte-identical.  Prefix-
    # restricted like the block above, but without the ``_cnt`` suffix
    # requirement (compile_ms / hbm_bytes are not counters).
    _XMETER_PREFIXES = ("compile_", "hbm_", "xmeter_")
    for k in sorted(s):
        if k.startswith(_XMETER_PREFIXES) and k not in out:
            out[k] = s[k]
    # open-system traffic keys (Config.arrival, deneva_tpu/traffic/):
    # the arrival/queue conservation counters pass through verbatim and
    # the per-family famlat* latency percentiles scale with the
    # timebase (they are tick-valued latencies; the famlat{f}_n sample
    # counts stay integers).  Present only for arrival runs — the
    # closed-loop default line stays byte-identical.
    _TRAFFIC_PREFIXES = ("arrival_", "queue_")
    for k in sorted(s):
        if k.startswith(_TRAFFIC_PREFIXES) and k not in out:
            out[k] = s[k]
    # flight-recorder bookkeeping (Config.flight, obs/flight.py):
    # span/event ring fill counts and the queue-ring validity sentinel
    # pass through verbatim (integers, never time-scaled) — present only
    # when the recorder is on, so the default line stays byte-identical
    for k in sorted(s):
        if k.startswith("flight_") and k not in out:
            out[k] = s[k]
    # mesh observatory keys (Config.mesh, obs/mesh.py): traffic-matrix
    # totals / drops / occupancy planes / straggler counts plus the
    # imb_jain fairness index pass through verbatim (counts and a
    # dimensionless index — never time-scaled).  Present only for
    # sharded mesh runs, so the default line stays byte-identical.
    _MESH_PREFIXES = ("mesh_", "imb_", "straggler_")
    for k in sorted(s):
        if k.startswith(_MESH_PREFIXES) and k not in out:
            out[k] = s[k]
    # fault plane + recovery keys (Config.faults / checkpoint_every,
    # deneva_tpu/faults/, engine/checkpoint.py): in-tick gating counters,
    # host-side kill/replay/checkpoint counters and the replay-parity
    # verdict bits pass through verbatim (counts and 0/1 flags — never
    # time-scaled; the RECOVERY watchdog bit in obs/report.py keys on
    # them).  Present only for fault runs, so the default line stays
    # byte-identical.
    _FAULT_PREFIXES = ("fault_", "ckpt_", "recovery_")
    for k in sorted(s):
        if k.startswith(_FAULT_PREFIXES) and k not in out:
            out[k] = s[k]
    # scale-out keys (Config.exchange_split / Config.remote_cache,
    # parallel/sharded.py): occupied sub-round counts and the remote
    # cache attempt/hit/suppression counters pass through verbatim
    # (integers, never time-scaled).  remote_entry_cnt joins the line
    # ONLY when the cache is on, so the attempts == shipped + suppressed
    # identity (obs/mesh.py reconcile) is checkable from the line alone
    # while the default line stays byte-identical.
    _SCALEOUT_PREFIXES = ("exchange_", "remote_attempt_", "remote_cache_",
                          "reship_")
    for k in sorted(s):
        if k.startswith(_SCALEOUT_PREFIXES) and k.endswith("_cnt") \
                and k not in out:
            out[k] = s[k]
    if "remote_attempt_cnt" in s and "remote_entry_cnt" in s:
        out.setdefault("remote_entry_cnt", s["remote_entry_cnt"])
    # adaptive contention controller keys (Config.adaptive,
    # deneva_tpu/ctrl/): per-reason backoff bases, escalation /
    # de-escalation / width-step / gate-block counters and the
    # occupancy EWMA pass through verbatim (integers and fixed-point
    # gauges in CTRL_SCALE units — never time-scaled; no ``_cnt``
    # requirement because the bases and EWMAs are gauges).  Present
    # only when the controller is on, so the default line stays
    # byte-identical.
    for k in sorted(s):
        if k.startswith("ctrl_") and k not in out:
            out[k] = s[k]
    for k in sorted(s):
        if k.startswith("famlat") and k not in out:
            out[k] = s[k] * tick_sec if isinstance(s[k], float) else s[k]
    # SLO / telemetry plane keys (Config.slo, obs/histo.py + obs/slo.py):
    # hist_* reconciliation totals and burn_* burn-rate gauges pass
    # through verbatim (counts and dimensionless ratios — never
    # time-scaled); slo_* follows the famlat rule — the float quantiles
    # are tick-valued latencies that scale by tick_sec, the int counters
    # (sample counts, alert/breach tallies) pass through verbatim.
    # Present only when the plane is on, so the default line stays
    # byte-identical.
    for k in sorted(s):
        if k.startswith(("hist_", "burn_")) and k not in out:
            out[k] = s[k]
        elif k.startswith("slo_") and k not in out:
            out[k] = s[k] * tick_sec if isinstance(s[k], float) else s[k]
    # conflict dependency observatory keys (Config.depgraph,
    # obs/depgraph.py): wait/abort edge counts, the chain-depth and
    # convoy-width integrals, the cross-node edge count and the sampling
    # ring bookkeeping (kept count, wrap flag, peak gauges) pass through
    # verbatim (integers — never time-scaled; the reconciliation
    # identities dep_wait_edge_cnt == twopl_wait_cnt and
    # dep_abort_edge_cnt == sum(abort_*_cnt) are checkable from the line
    # alone).  Present only when the observatory is on, so the default
    # line stays byte-identical.
    for k in sorted(s):
        if k.startswith("dep_") and k not in out:
            out[k] = s[k]
    # causal-diagnosis observatory keys (Config.windows, obs/windows.py
    # + obs/diff.py): the snapshot-ring bookkeeping (latch count, wrap
    # flag, ring geometry) and any diag_* diagnosis gauges pass through
    # verbatim (integers and dimensionless scores — never time-scaled).
    # Present only when the window plane is on, so the default line
    # stays byte-identical.
    for k in sorted(s):
        if k.startswith(("window_", "diag_")) and k not in out:
            out[k] = s[k]
    # reference-name ALIASES for the invented chain counters, so parsers
    # of reference-format summaries (stats.cpp:907 prints case1..6) keep
    # their maat_caseN_cnt fields.  The reference's case2/4/5 fire against
    # snapshot members still validated at validation time — a state the
    # synchronous tick consolidates (cc/maat.py init_db) — so the closest
    # mechanical equivalents are exported under the reference names:
    #   maat_case2_cnt <- maat_chain_cap_cnt  (upper tightened by a
    #                     concurrent uncommitted validator)
    #   maat_case4_cnt <- maat_chain_push_cnt (lower raised past one)
    #   maat_case6_cnt <- maat_range_abort_cnt (range emptied -> abort)
    # case5 pairs are resolved inside the case1/3 prefix scans and have
    # no separate counter here.
    for alias, src in (("maat_case2_cnt", "maat_chain_cap_cnt"),
                       ("maat_case4_cnt", "maat_chain_push_cnt"),
                       ("maat_case6_cnt", "maat_range_abort_cnt")):
        if src in s:
            out[alias] = s[src]
    if "ccl_samples" in s:
        ccl = latency_percentiles(s["ccl_samples"], s.get("ccl_valid", 0))
        out.update({k: v * tick_sec for k, v in ccl.items()})
    out.update(host_utilization())
    return out


#: matched epoch origins for cpu_util (os.times().elapsed counts from an
#: arbitrary epoch — boot on Linux; process_time counts from process
#: start — both must be measured over the SAME window)
_T0 = time.monotonic()
_P0 = time.process_time()


def host_utilization() -> dict:
    """mem_util / cpu_util of this process, matching the reference's
    /proc-sourced dump keys (stats.cpp:1556-1562: VmRSS in MB and process
    CPU seconds / wall seconds since start)."""
    mem_mb = 0.0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    mem_mb = float(line.split()[1]) / 1024.0
                    break
    except OSError:  # pragma: no cover - non-procfs platform
        pass
    wall = time.monotonic() - _T0
    cpu = (time.process_time() - _P0) / wall if wall > 0 else 0.0
    return {"mem_util": mem_mb, "cpu_util": cpu}


def format_summary(d: dict, prog: bool = False) -> str:
    """Render the reference's output line (stats.cpp:1541-1575)."""
    tag = "[prog]" if prog else "[summary]"
    parts = []
    for k, v in d.items():
        if isinstance(v, float):
            parts.append(f"{k}={v:f}")
        else:
            parts.append(f"{k}={v}")
    return tag + " " + ",".join(parts)


def parse_summary(line: str) -> dict:
    """Port of parse_results.py get_summary/process_results (:19-37).

    Also accepts ``[prog]`` heartbeat lines — they carry the exact same
    key=value payload (obs/prog.py), so progress can be plotted from a
    log with the same parser."""
    line = line.rstrip("\n")
    if line.startswith("[summary] "):
        line = line[10:]
    elif line.startswith("[prog] "):
        line = line[7:]
    else:
        return {}
    out = {}
    for r in re.split(",", line):
        # tolerate unknown FUTURE keys instead of crashing the parser:
        # split once (values may themselves contain '='), keep
        # non-numeric values verbatim, skip malformed records — the
        # line is an append-only contract and old parsers must survive
        # new observatory keys (the same passthrough discipline as the
        # abort_* counters in reference_summary)
        if "=" not in r:
            continue
        name, val = r.split("=", 1)
        try:
            out[name] = float(val)
        except ValueError:
            out[name] = val
    return out
