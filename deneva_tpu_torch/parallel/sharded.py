"""The sharded engine on one device: N nodes, each owning ``rows/N`` rows
(``key % N`` picks the owner, ``key // N`` is the local row), with one
scheduler tick for the whole cluster.

The reference runs NODE_CNT server processes that ship remote accesses to
the row's owner (RQRY), gather 2PC votes (RACK_PREP) and ship the commit
(RFIN).  The JAX package (``deneva_tpu/parallel/sharded.py``) runs them as
one SPMD program over a mesh axis, with three ``all_to_all`` exchanges per
tick.  The port keeps the N nodes on one device: every state tensor
carries a leading node axis, each home and owner stage runs once per node
over the ``x[p]`` views in node order, an exchange is a transpose of the
stacked ``(N_src, N_dst, C)`` send buffers (``routing.exchange``), and the
cluster maximum of the rebase gate is an ``amax`` over the node axis.
One tick:

  1. backoff expiry and admission at each home node, with node-interleaved
     timestamps ``(ts_counter + rank) * N + node``;
  2. exchange A: every live remote entry (held, requested, and those of
     finishing txns, which vote) is packed held-first per owner and
     shipped; local entries never enter the exchange;
  3. each owner runs the UNCHANGED single-shard plugin (``access`` and
     ``validate``) on its received lanes followed by its own local ones,
     as virtual single-access txns, and returns one decision word per
     entry (grant | wait << 1 | abort << 2 | vote << 3);
  4. each home unpacks the words (an unshipped entry votes yes), aborts
     the txns whose entries overflowed, gathers the votes and advances
     its cursors;
  5. exchange B: the committing txns' entries are packed by timestamp and
     shipped to their owners, which run the plugin's ``on_commit`` on
     them (T/O's ``wts``, MVCC's version insert) and apply the writes (an
     int32 ``index_add_`` of 1 per committed write).  A txn whose commit
     entries overflow stays finishing and retries (``commit_defer_cnt``):
     its shipped entries are masked at the owner by the re-gathered
     commit flag, never dropped;
  6. home bookkeeping, and the abort tail into backoff;
  7. the global timestamp rebase, gated on the cluster maximum of the
     counters (``limit = (3 << 29) // N``, a shift of ``(1 << 30) // N *
     N``).  As in the single-shard port it is an unconditional select, so
     no tick reads a device value on the host: every node's
     ``on_ts_rebase`` gets the int64 shift, 0 on a tick that does not
     rebase (the rebase kernel returns at once on 0).

The slice is NO_WAIT, WAIT_DIE, TIMESTAMP and MVCC on YCSB with every
opt-in flag off but ``fused_arbitrate`` (``check_sharded_slice``): the
plugins with no sharded hook, run unchanged on the owner's virtual txns
(TIMESTAMP and MVCC draw a new timestamp on restart).  A node's CC state
is its owner's, sized for ``N*C + B*R`` single-access txns (MVCC's rings
carry the scratch cells of that width's version insert), and every plugin
updates it in place through the node views.  Every observatory hook of
the reference tick is a no-op at those flags and is left out.  Under
``fused_arbitrate`` every sort of the tick runs the fused sort + scan
kernel: per node the routing packs of exchanges A and B (3 columns by 2
keys at B*R lanes) and, at the owner's ``N*C + B*R`` lanes, the lock sort
and unpermute (NO_WAIT, WAIT_DIE), or T/O's decision sort and unpermute
(TIMESTAMP, MVCC) and MVCC's version insert.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from deneva_tpu_torch.config import Config
from deneva_tpu_torch.engine.scheduler import (
    LAT_SAMPLES, Engine, _pool_to_device, _zeros_stats, bump,
    check_sharded_slice, penalty_ticks, pool_admit, record_commit_latency,
    track_parts_touched, track_state_latencies,
)
from deneva_tpu_torch.engine.state import (
    NULL_KEY, STATUS_BACKOFF, STATUS_FREE, STATUS_RUNNING, STATUS_WAITING,
    TxnState, make_entries,
)
from deneva_tpu_torch.ops import segment as seg
from deneva_tpu_torch.parallel import routing

I32 = torch.int32
I64 = torch.int64

#: counters only the sharded engine keeps
SHARD_STAT_KEYS = ("route_overflow_abort_cnt", "commit_defer_cnt",
                   "remote_entry_cnt")


class ShardState(NamedTuple):
    """The cluster's state: each tensor's leading axis is the node."""

    txn: TxnState              # (N, B) / (N, B, R) home transactions
    db: dict                   # CC-plugin tensors, (N, ...) each
    data: torch.Tensor         # (N, rows/N) int32 local rows
    tables: dict               # workload tables ({} for YCSB)
    stats: dict                # (N,) counters and (N, L) rings
    tick: torch.Tensor         # (N,) int32
    pool_cursor: torch.Tensor  # (N,) int32
    ts_counter: torch.Tensor   # (N,) int32
    #: the host's copy of the tick count (the captured graphs' phase)
    host_tick: int = 0


def _flags(iw, held, req, fin):
    """The routed entry's flag word: is_write | held << 1 | req << 2 |
    finishing << 3."""
    return (iw.to(I32) | (held.to(I32) << 1) | (req.to(I32) << 2)
            | (fin.to(I32) << 3))


def exchange_capacity(cfg: Config, plugin, B: int, R: int) -> int:
    """Per-(src, dst) exchange lane capacity: the expected remote share of
    a node's B*R entries with ``route_capacity_factor`` slack, at least R.
    A plugin with no abort path (CALVIN) cannot drop an entry: without the
    split exchange it ships the worst case, B*R, and its owner width
    ``N*B*R`` must fit the lock sort's packed entry index (2^23)."""
    N = cfg.node_cnt
    cap = max(int(B * R / cfg.part_cnt * cfg.route_capacity_factor), R)
    if plugin.never_aborts:
        if cfg.exchange_split:
            return min(cap, B * R)
        if N * B * R > 1 << 23:
            raise ValueError(
                f"CALVIN worst-case exchange overflows the packed "
                f"arbitration index: node_cnt={N} x batch_size={B} x "
                f"max_req={R} = {N * B * R} owner-side entries exceeds the "
                f"2^23 bound (cc/twopl.py packed sort keys)")
        return B * R
    return cap


def _node(state: ShardState, p: int) -> dict:
    """Node p's views of the state (in-place updates reach the state)."""
    return dict(txn=TxnState(*(f[p] for f in state.txn)),
                db={k: v[p] for k, v in state.db.items()},
                data=state.data[p],
                stats={k: v[p] for k, v in state.stats.items()},
                tick=state.tick[p], pool_cursor=state.pool_cursor[p],
                ts_counter=state.ts_counter[p])


def _restack(stacked: dict, per_node: list) -> dict:
    """The stacked dict after per-node updates: a key whose per-node
    tensors are still the views of the stacked tensor keeps it (updated in
    place); any other is stacked anew."""
    out = {}
    for k, v in stacked.items():
        same = all(d[k].data_ptr() == v[p].data_ptr()
                   and d[k].shape == v[p].shape
                   for p, d in enumerate(per_node))
        out[k] = v if same else torch.stack([d[k] for d in per_node])
    return out


def make_sharded_tick(cfg: Config, plugin, pools: list, cap: int, workload):
    """The cluster tick of the slice.  ``pools`` holds each node's query
    stream (``_pool_to_device`` form)."""
    check_sharded_slice(cfg)
    N = cfg.node_cnt
    n_parts = cfg.part_cnt
    Q = pools[0]["kw"].shape[0]
    rows_local = workload.cc_rows(cfg) // n_parts
    redraw = plugin.new_ts_on_restart or cfg.restart_new_ts
    limit = (3 << 29) // N
    by = (1 << 30) // N

    def home_start(nd: dict, p: int) -> dict:
        """Backoff expiry, admission and the entries of node p, and its
        exchange-A send buffers."""
        txn, db, stats = nd["txn"], nd["db"], nd["stats"]
        t = nd["tick"]
        measuring = t >= cfg.warmup_ticks
        B, R = txn.keys.shape
        dev = txn.keys.device

        # ---- 1. backoff expiry and admission (home-local) ----
        expire = (txn.status == STATUS_BACKOFF) & (txn.backoff_until <= t)
        status = torch.where(expire, STATUS_RUNNING, txn.status)
        start_tick = torch.where(expire, t, txn.start_tick)
        free = status == STATUS_FREE
        acap = cfg.admit_cap if cfg.admit_cap is not None else B
        acap = min(acap, B, Q)
        frank = torch.cumsum(free, 0, dtype=I32) - free.to(I32)
        free = free & (frank < acap)
        n_free = free.sum(dtype=I32)
        keys, is_write, n_req, txn_type, targs, aux, pool_idx = pool_admit(
            pools[p], txn, free, frank, nd["pool_cursor"], acap, Q)

        # globally unique, node-interleaved timestamps
        need_ts = free | expire if redraw else free
        trank = torch.cumsum(need_ts, 0, dtype=I32) - need_ts.to(I32)
        ts = torch.where(need_ts, (nd["ts_counter"] + trank) * N + p,
                         txn.ts)
        ts_counter = nd["ts_counter"] + need_ts.sum(dtype=I32)

        status = torch.where(free, STATUS_RUNNING, status)
        txn = TxnState(
            status=status, cursor=torch.where(free, 0, txn.cursor), ts=ts,
            pool_idx=pool_idx, restarts=torch.where(free, 0, txn.restarts),
            backoff_until=txn.backoff_until,
            start_tick=torch.where(free, t, start_tick),
            first_start_tick=torch.where(free, t, txn.first_start_tick),
            keys=keys, is_write=is_write, n_req=n_req, txn_type=txn_type,
            targs=targs, aux=aux)
        stats = bump(stats, "local_txn_start_cnt", n_free, measuring)
        db = plugin.on_start(cfg, db, txn, free | expire)

        # ---- 2. entries and exchange A ----
        active = (txn.status == STATUS_RUNNING) \
            | (txn.status == STATUS_WAITING)
        ridx = torch.arange(R, dtype=I32, device=dev)[None, :]
        in_fp = ridx < txn.n_req[:, None]
        finishing = (txn.status == STATUS_RUNNING) & (txn.cursor >= txn.n_req)
        ua = workload.user_abort(cfg, txn, finishing)
        finishing = finishing & ~ua
        ent = make_entries(txn, active, read_locks_held=True,
                           window=cfg.acquire_window)
        held, req = ent.held, ent.req
        fin2 = finishing[:, None] & in_fp
        live_e = held | req
        key_g = txn.keys.reshape(-1)
        owner = key_g % n_parts
        # local entries never touch the exchange: the owner runs them
        # beside the received ones
        local_e = live_e & (owner == p)
        dest = torch.where(live_e & ~local_e, owner, N)
        key_l = key_g // n_parts
        fields = {
            "key": torch.where(live_e, key_l, NULL_KEY),
            "ts": ent.ts,
            "flags": _flags(ent.is_write, held, req, fin2.reshape(-1)),
            "start_tick": txn.start_tick.repeat_interleave(R),
        }
        ship = live_e & ~local_e
        stats = bump(stats, "remote_entry_cnt", ship.sum(dtype=I32),
                     measuring)
        # held entries pack first: a dropped held lock would hide it from
        # its owner; a dropped entry aborts its txn instead
        send, orig, overflow = routing.pack_by_dest(
            dest, (~held).to(I32), ship, N, cap, fields)
        return dict(
            p=p, nd=nd, txn=txn, db=db, stats=stats, t=t,
            measuring=measuring, n_free=n_free, ts_counter=ts_counter,
            active=active, ridx=ridx, in_fp=in_fp, finishing=finishing,
            ua=ua, fin2=fin2, local_e=local_e, dest=dest, key_l=key_l,
            ts_e=ent.ts, fields=fields, ship=ship, send=send, orig=orig,
            overflow=overflow)

    def owner_cat(c: dict, recv_f, home_f, fill=0):
        """The owner's lanes: the received ones [0, N*C), by source node
        and slot, then its own local entries [N*C, N*C + B*R)."""
        return torch.cat([recv_f.reshape(-1),
                          torch.where(c["local_e"], home_f, fill)])

    def owner_access(c: dict, recv: dict) -> dict:
        """Node p as owner: the plugin's access and validation on virtual
        single-access txns; returns the decision words to send back."""
        fields = c["fields"]
        o_key = owner_cat(c, recv["key"],
                          torch.where(c["local_e"], c["key_l"], NULL_KEY),
                          NULL_KEY)
        o_flags = owner_cat(c, recv["flags"], fields["flags"])
        o_ts = owner_cat(c, recv["ts"], fields["ts"])
        o_stick = owner_cat(c, recv["start_tick"], fields["start_tick"])
        Bv = o_key.shape[0]
        dev = o_key.device
        o_live = o_key != NULL_KEY
        o_iw = (o_flags & 1) == 1
        o_held = ((o_flags >> 1) & 1) == 1
        o_fin = (((o_flags >> 3) & 1) == 1) & o_live
        zeros = lambda *s: torch.zeros(s, dtype=I32, device=dev)
        vtxn = TxnState(
            status=torch.where(o_live, STATUS_RUNNING, STATUS_FREE),
            cursor=o_held.to(I32), ts=o_ts, pool_idx=zeros(Bv),
            restarts=zeros(Bv), backoff_until=zeros(Bv), start_tick=o_stick,
            first_start_tick=o_stick, keys=o_key[:, None],
            is_write=o_iw[:, None], n_req=o_live.to(I32),
            txn_type=zeros(Bv), targs=zeros(Bv, 1), aux=zeros(Bv, 1))
        dec, vdb = plugin.access(cfg, dict(c["db"]), vtxn, o_live)
        votes, vdb = plugin.validate(cfg, vdb, vtxn, o_fin, c["t"])
        decbits = (dec.grant.reshape(-1).to(I32)
                   | (dec.wait.reshape(-1).to(I32) << 1)
                   | (dec.abort.reshape(-1).to(I32) << 2)
                   | (votes.to(I32) << 3))
        nR = N * cap
        c["decb_loc"] = decbits[nR:]
        c["db"] = vdb
        return {"decbits": decbits[:nR].reshape(N, cap)}

    def home_decide(c: dict, ret: dict) -> dict:
        """Node p as home: unpack the decisions, gather the votes, advance
        the cursors, and pack exchange B.  Returns the B send buffers."""
        txn, stats, measuring = c["txn"], c["stats"], c["measuring"]
        B, R = txn.keys.shape
        nE = B * R
        dev = txn.keys.device
        ridx, active, finishing = c["ridx"], c["active"], c["finishing"]
        # an entry that never shipped gets no decision and votes yes
        defaults = {"decbits": torch.full((nE + 1,), 1 << 3, dtype=I32,
                                          device=dev)}
        got = routing.unpack(ret, c["orig"], nE, defaults)
        decb = torch.where(c["local_e"], c["decb_loc"],
                           got["decbits"][:nE]).reshape(B, R)
        grant = (decb & 1) == 1
        wait_e = ((decb >> 1) & 1) == 1
        abort_e = ((decb >> 2) & 1) == 1
        vote_e = ((decb >> 3) & 1) == 1

        ovf_txn = c["overflow"].reshape(B, R).any(dim=1)
        stats = bump(stats, "route_overflow_abort_cnt",
                     (ovf_txn & active).sum(dtype=I32), measuring)
        votes_ok = (vote_e | ~c["fin2"]).all(dim=1)
        # NO_WAIT's coordinator re-validation (home_commit_check) keeps
        # every txn whose votes are all yes
        commit_try = finishing & votes_ok & ~ovf_txn
        vabort = (finishing & ~commit_try & ~ovf_txn) | (ovf_txn & active)

        # cursor advance over the granted prefix
        okm = grant | (ridx < txn.cursor[:, None]) \
            | (ridx >= txn.n_req[:, None])
        prefix = torch.cumprod(okm.to(I32), dim=1, dtype=I32)
        new_cursor = torch.minimum(prefix.sum(dim=1, dtype=I32), txn.n_req)
        fail_pos = torch.clamp(new_cursor, max=R - 1)[:, None]
        at_fail = lambda m: (m & (ridx == fail_pos)).any(dim=1)
        has_req = active & (txn.cursor < txn.n_req) & ~vabort
        blocked = has_req & (new_cursor < txn.n_req)
        wait = blocked & at_fail(wait_e) & ~vabort
        abort_now = (blocked & at_fail(abort_e)) | vabort
        cursor = torch.where(has_req & ~abort_now, new_cursor, txn.cursor)
        status = torch.where(has_req & (new_cursor > txn.cursor),
                             STATUS_RUNNING, txn.status)
        status = torch.where(wait, STATUS_WAITING, status)
        stats = bump(stats, "twopl_wait_cnt", wait.sum(dtype=I32), measuring)

        # ---- 5. exchange B (RFIN), packed by timestamp ----
        commit_e = (commit_try[:, None] & c["in_fp"]).reshape(-1)
        cts_e = txn.ts.repeat_interleave(R)
        iw_e = txn.is_write.reshape(-1).to(I32)
        fieldsB = {"key": torch.where(commit_e, c["key_l"], NULL_KEY),
                   "cts": cts_e, "iw": iw_e}
        sendB, origB, ovfB = routing.pack_by_dest(
            c["dest"], c["ts_e"], commit_e & ~c["local_e"], N, cap, fieldsB)
        ovfB_txn = ovfB.reshape(B, R).any(dim=1)
        commit = commit_try & ~ovfB_txn        # deferred txns retry RFIN
        stats = bump(stats, "commit_defer_cnt",
                     (ovfB_txn & commit_try).sum(dtype=I32), measuring)
        # the final commit flag, re-gathered through the pack permutation:
        # a deferred txn's shipped entries are ignored by their owners
        cflag = (commit[:, None] & c["in_fp"]).reshape(-1)
        cflag_flat = torch.cat([cflag, torch.zeros(1, dtype=torch.bool,
                                                   device=dev)])
        oB = origB.reshape(-1)
        sendB["commit"] = cflag_flat.index_select(
            0, torch.where(oB >= 0, oB, nE).to(I64)).to(I32).reshape(N, cap)
        c.update(stats=stats, commit=commit, vabort=vabort,
                 abort_now=abort_now, wait=wait, commit_e=commit_e,
                 cflag=cflag, cts_e=cts_e, iw_e=iw_e,
                 txn=txn._replace(status=status, cursor=cursor))
        return sendB

    def owner_commit(c: dict, recvB: dict) -> None:
        """Node p as owner: the plugin's commit hook and the write apply
        for the received and its own local commit entries (in place)."""
        local_e = c["local_e"]
        rB_key = owner_cat(c, recvB["key"],
                           torch.where(c["commit_e"] & local_e, c["key_l"],
                                       NULL_KEY), NULL_KEY)
        rB_commit = torch.cat([(recvB["commit"].reshape(-1) == 1)
                               & (recvB["key"].reshape(-1) != NULL_KEY),
                               c["cflag"] & local_e])
        rB_iw = owner_cat(c, recvB["iw"], c["iw_e"]) == 1
        rB_cts = owner_cat(c, recvB["cts"], c["cts_e"])
        Bv = rB_key.shape[0]
        dev = rB_key.device
        zeros = lambda *s: torch.zeros(s, dtype=I32, device=dev)
        vtxnB = TxnState(
            status=torch.where(rB_commit, STATUS_RUNNING, STATUS_FREE),
            cursor=torch.ones(Bv, dtype=I32, device=dev), ts=rB_cts,
            pool_idx=zeros(Bv), restarts=zeros(Bv), backoff_until=zeros(Bv),
            start_tick=zeros(Bv), first_start_tick=zeros(Bv),
            keys=rB_key[:, None], is_write=rB_iw[:, None],
            n_req=rB_commit.to(I32), txn_type=zeros(Bv),
            targs=zeros(Bv, 1), aux=zeros(Bv, 1))
        c["db"] = plugin.on_commit(cfg, dict(c["db"]), vtxnB, rB_commit,
                                   commit_ts=rB_cts, tick=c["t"])
        # one int32 increment per committed write row; other lanes add 0
        # at a row spread by lane
        w = rB_commit & rB_iw
        lane = torch.arange(Bv, dtype=I32, device=dev)
        c["nd"]["data"].index_add_(
            0, torch.where(w, rB_key, lane % rows_local).to(I64), w.to(I32))

    def home_finish(c: dict) -> None:
        """Node p's commit and abort bookkeeping (its counters in place)."""
        txn, stats, t, measuring = c["txn"], c["stats"], c["t"], c["measuring"]
        commit, vabort, abort_now, ua = (c["commit"], c["vabort"],
                                         c["abort_now"], c["ua"])
        stats = bump(stats, "txn_cnt", commit.sum(dtype=I32), measuring)
        stats = bump(stats, "write_cnt",
                     (commit[:, None] & txn.is_write & c["in_fp"])
                     .sum(dtype=I32), measuring)
        stats = bump(stats, "vabort_cnt", vabort.sum(dtype=I32), measuring)
        stats = track_parts_touched(stats, commit, measuring, txn=txn,
                                    n_parts=n_parts)
        stats = record_commit_latency(stats, commit, t, txn.start_tick,
                                      measuring)
        stats = bump(stats, "unique_txn_abort_cnt",
                     (commit & (txn.restarts > 0)).sum(dtype=I32), measuring)
        stats = bump(stats, "txn_run_time_ticks",
                     torch.where(commit, t - txn.start_tick, 0)
                     .sum(dtype=I32), measuring)
        stats = bump(stats, "txn_total_time_ticks",
                     torch.where(commit, t - txn.first_start_tick, 0)
                     .sum(dtype=I32), measuring)
        stats = bump(stats, "user_abort_cnt", ua.sum(dtype=I32), measuring)
        status = torch.where(commit | ua, STATUS_FREE, txn.status)
        stats = bump(stats, "total_txn_abort_cnt", abort_now.sum(dtype=I32),
                     measuring)
        txn = txn._replace(
            status=torch.where(abort_now, STATUS_BACKOFF, status),
            cursor=torch.where(abort_now, 0, txn.cursor),
            backoff_until=torch.where(
                abort_now, t + penalty_ticks(cfg, txn.restarts),
                txn.backoff_until),
            restarts=torch.where(abort_now, txn.restarts + 1, txn.restarts))
        c["db"] = plugin.on_abort(cfg, c["db"], txn, abort_now | ua)
        stats = track_state_latencies(stats, txn, measuring)
        # network time: the remote entries shipped this tick
        stats = bump(stats, "lat_network_time", c["ship"].sum(dtype=I32),
                     measuring)
        bump(stats, "measured_ticks", 1, measuring)
        c["txn"] = txn

    def tick_fn(state: ShardState) -> ShardState:
        nodes = [_node(state, p) for p in range(N)]
        ctx = [home_start(nodes[p], p) for p in range(N)]
        recv = routing.exchange([c["send"] for c in ctx])
        back = [owner_access(c, r) for c, r in zip(ctx, recv)]
        ret = routing.exchange(back)
        sendB = [home_decide(c, r) for c, r in zip(ctx, ret)]
        recvB = routing.exchange(sendB)
        for c, r in zip(ctx, recvB):
            owner_commit(c, r)
            home_finish(c)

        # ---- 7. global ts rebase: every node shifts together once the
        # cluster's largest counter passes the limit ----
        ts_counter = torch.stack([c["ts_counter"] for c in ctx])
        rebase = ts_counter.amax() > limit
        # the rebase kernel's shift: an int64 scalar on the state's device,
        # as the single-shard tick passes it
        shift = torch.where(rebase, by * N, 0)
        txn = TxnState(*(torch.stack(f) for f in
                         zip(*(c["txn"] for c in ctx))))
        txn = txn._replace(ts=torch.where(
            rebase, torch.clamp(txn.ts - by * N, min=1), txn.ts))
        dbs = [plugin.on_ts_rebase(cfg, c["db"], shift) for c in ctx]
        ts_counter = torch.where(rebase, ts_counter - by, ts_counter)
        n_free = torch.stack([c["n_free"] for c in ctx])
        return ShardState(
            txn=txn, db=_restack(state.db, dbs), data=state.data,
            tables=state.tables, stats=state.stats, tick=state.tick + 1,
            pool_cursor=(state.pool_cursor + n_free) % Q,
            ts_counter=ts_counter, host_tick=state.host_tick + 1)

    if not cfg.fused_arbitrate:
        return tick_fn

    # fused-arbitration dispatch: every sort of the cluster tick goes
    # through the fused kernel (ops/segment.py fused_scope)
    def tick_fused(state: ShardState) -> ShardState:
        with seg.fused_scope(cfg):
            return tick_fn(state)

    return tick_fused


class ShardedEngine(Engine):
    """NODE_CNT nodes on one device.  ``device`` defaults to CUDA; pass
    ``device="cpu"`` to run on the host.  The run driver (``run``,
    ``run_compiled``, ``advance``, ``summary_line``) is ``Engine``'s."""

    #: one CUDA graph of the cluster tick (no write ring to flush)
    graph_phases = 1
    check = staticmethod(check_sharded_slice)

    def _make_ticks(self) -> dict:
        """Per-node query streams on the device: node p serves the queries
        whose home partition is p (the pool's rows p, p + N, ...).  The
        cluster tick reads no device value on the host, so the eager tick
        is also the one ``run_compiled`` captures."""
        cfg, pool = self.cfg, self.pool
        N, W = cfg.node_cnt, cfg.part_cnt
        Qn = pool.size // W
        self.pool_dev = [
            _pool_to_device(dataclasses.replace(
                pool, **{f: getattr(pool, f)[p::W][:Qn]
                         for f in ("keys", "is_write", "n_req", "home_part",
                                   "txn_type", "args", "aux")}),
                self.device)
            for p in range(N)]
        B, R = cfg.batch_size, pool.max_req
        self.cap = exchange_capacity(cfg, self.plugin, B, R)
        if N * self.cap + B * R > 1 << 23:
            raise ValueError(f"owner width {N * self.cap + B * R} exceeds "
                             "the lock sort's 2^23 entry index")
        tick = make_sharded_tick(cfg, self.plugin, self.pool_dev, self.cap,
                                 self.workload)
        return {False: tick, True: tick}

    def init_state(self) -> ShardState:
        cfg, dev = self.cfg, self.device
        N = cfg.node_cnt
        B, R = cfg.batch_size, self.pool.max_req
        rows_local = self.n_rows // cfg.part_cnt
        stack = lambda ds: {k: torch.stack([d[k] for d in ds])
                            for k in ds[0]}

        def stats():
            s = _zeros_stats(B, R, dev, write_ring=False)
            s.update({k: torch.zeros((), dtype=I32, device=dev)
                      for k in SHARD_STAT_KEYS})
            return s

        txn = TxnState.empty(B, R, A=self.pool.args.shape[1], device=dev)
        # a node's CC state is its owner's, whose plugin calls see the
        # N*C + B*R lanes as single-access txns: MVCC's rings carry the
        # scratch cells of the owner's version-insert width.  Every node
        # starts from the same arrays: one node's are made and copied N
        # times (MVCC's rings are ~1.2 GB a node at the headline's size)
        db = self.plugin.init_db(cfg, rows_local, N * self.cap + B * R, 1,
                                 device=dev)
        return ShardState(
            txn=TxnState(*(torch.stack([f] * N) for f in txn)),
            db={k: v.expand(N, *v.shape).contiguous()
                for k, v in db.items()},
            data=torch.zeros((N, rows_local), dtype=I32, device=dev),
            tables=stack([self.workload.init_tables(cfg, p, device=dev)
                          for p in range(N)]),
            stats=stack([stats() for _ in range(N)]),
            tick=torch.zeros(N, dtype=I32, device=dev),
            pool_cursor=torch.zeros(N, dtype=I32, device=dev),
            ts_counter=torch.ones(N, dtype=I32, device=dev))

    def _flush_body(self, state: ShardState) -> ShardState:
        """Nothing to flush: the writes apply at exchange B."""
        return state

    def summary(self, state: ShardState,
                wall_seconds: float | None = None) -> dict:
        """Cluster-wide stats in the reference's [summary] vocabulary:
        int32 counters summed over the node axis on the device (int32, as
        the reference's psum), float32 time integrals summed on the host
        with numpy in node order, as the reference does."""
        int_keys = sorted(
            [("db", k) for k, v in state.db.items()
             if k.endswith("_cnt") and v.dim() == 1 and v.dtype == I32]
            + [("stats", k) for k, v in state.stats.items()
               if not k.startswith("arr_") and v.dim() == 1
               and v.dtype == I32])
        s = {k: int(getattr(state, g)[k].sum(dim=0, dtype=I32).item())
             for g, k in int_keys}
        s.update({k: float(v.cpu().numpy().sum())
                  for k, v in state.stats.items()
                  if not k.startswith("arr_") and k not in s})
        s.update({k: int(v.cpu().numpy().sum()) for k, v in state.db.items()
                  if k.endswith("_cnt") and v.dim() <= 1 and k not in s})
        commits = max(s["txn_cnt"], 1)
        out = dict(s)
        out["measured_ticks"] = int(state.stats["measured_ticks"].max())
        out["tput_per_tick"] = s["txn_cnt"] / max(out["measured_ticks"], 1)
        out["abort_rate"] = s["total_txn_abort_cnt"] / (
            s["total_txn_abort_cnt"] + commits)
        out["avg_latency_ticks_short"] = s["txn_run_time_ticks"] / commits
        out["avg_latency_ticks_long"] = s["txn_total_time_ticks"] / commits
        # latency rings: each node's valid prefix, in node order
        rings = state.stats["arr_lat_short"][:, :LAT_SAMPLES].cpu().numpy()
        curs = state.stats["lat_ring_cursor"].cpu().numpy()
        samples = np.concatenate([rings[i][:min(int(curs[i]), LAT_SAMPLES)]
                                  for i in range(rings.shape[0])])
        out["ccl_samples"] = tuple(samples.tolist())
        out["ccl_valid"] = samples.shape[0]
        if wall_seconds is not None:
            out["tput"] = s["txn_cnt"] / wall_seconds
        return out

    def global_data_sum(self, state: ShardState) -> int:
        """Every node's row increments summed: the committed writes."""
        return int(state.data.sum().item())
