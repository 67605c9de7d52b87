"""Device-resident scheduler state (the reference's TxnTable, work queue
and abort queue as fixed-size per-slot tensors; system/txn_table.cpp).

One slot per in-flight transaction (B = MAX_TXN_IN_FLIGHT); every active
txn advances each tick, an aborted txn sleeps out its penalty in
``backoff_until``, and a waiting txn re-arbitrates every tick.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# txn slot status (the tensorized txn state machine)
STATUS_FREE = 0      # slot empty, admissible
STATUS_RUNNING = 1   # executing its access program
STATUS_WAITING = 2   # current access blocked; retries each tick
STATUS_BACKOFF = 3   # aborted, sleeping out its abort penalty

BIG_TS = 2**31 - 1
NULL_KEY = 2**31 - 1  # sort sentinel: dead entries sort last

I32 = torch.int32


class TxnState(NamedTuple):
    """Per-slot transaction state, all shape (B,) or (B, R)."""

    status: torch.Tensor        # (B,) int32
    cursor: torch.Tensor        # (B,) int32: index of current access
    ts: torch.Tensor            # (B,) int32: timestamp / priority
    pool_idx: torch.Tensor      # (B,) int32
    restarts: torch.Tensor      # (B,) int32
    backoff_until: torch.Tensor  # (B,) int32 tick
    start_tick: torch.Tensor    # (B,) int32: latest (re)start
    first_start_tick: torch.Tensor  # (B,) int32: first start
    keys: torch.Tensor          # (B, R) int32
    is_write: torch.Tensor      # (B, R) bool
    n_req: torch.Tensor         # (B,) int32
    txn_type: torch.Tensor      # (B,) int32
    targs: torch.Tensor         # (B, A) int32
    aux: torch.Tensor           # (B, R) int32

    @property
    def B(self) -> int:
        return self.status.shape[0]

    @property
    def R(self) -> int:
        return self.keys.shape[1]

    @staticmethod
    def empty(B: int, R: int, A: int = 1, device="cpu") -> "TxnState":
        zi = lambda: torch.zeros(B, dtype=I32, device=device)
        return TxnState(
            status=zi(), cursor=zi(), ts=zi(), pool_idx=zi(), restarts=zi(),
            backoff_until=zi(), start_tick=zi(), first_start_tick=zi(),
            keys=torch.full((B, R), NULL_KEY, dtype=I32, device=device),
            is_write=torch.zeros((B, R), dtype=torch.bool, device=device),
            n_req=zi(), txn_type=zi(),
            targs=torch.zeros((B, A), dtype=I32, device=device),
            aux=torch.zeros((B, R), dtype=I32, device=device),
        )


class Entries(NamedTuple):
    """Flattened (B*R) view of all access entries + liveness masks.

    ``held`` — lock currently held; ``req`` — the access the txn tries
    this tick.  Entry priority is the owning txn's ts; ``txn`` the slot.
    """

    key: torch.Tensor       # (B*R,) int32, NULL_KEY where dead
    txn: torch.Tensor       # (B*R,) int32
    ridx: torch.Tensor      # (B*R,) int32: access index within txn
    ts: torch.Tensor        # (B*R,) int32
    is_write: torch.Tensor  # (B*R,) bool
    held: torch.Tensor      # (B*R,) bool
    req: torch.Tensor       # (B*R,) bool


def request_window(txn: TxnState, active: torch.Tensor, window: int = 1):
    """The requested accesses [cursor, cursor+window) as dense (B, W)
    arrays: (rkey, riw, valid), NULL_KEY keyed where invalid."""
    B, R = txn.keys.shape
    ridx = torch.arange(R, dtype=I32, device=txn.keys.device)[None, :]
    cur = txn.cursor[:, None]
    rkey, riw, valid = [], [], []
    for j in range(min(window, R)):
        m = ridx == cur + j
        v = active & (txn.cursor + j < txn.n_req)
        rkey.append(torch.where(
            v, torch.where(m, txn.keys, 0).sum(dim=1, dtype=I32), NULL_KEY))
        riw.append((m & txn.is_write).any(dim=1) & v)
        valid.append(v)
    return (torch.stack(rkey, dim=1), torch.stack(riw, dim=1),
            torch.stack(valid, dim=1))


def expand_window(txn: TxnState, vals: torch.Tensor, fill=0) -> torch.Tensor:
    """Inverse of ``request_window``: place (B, W) per-request values into
    (B, R) entry order (the value of request j at lane cursor+j, ``fill``
    elsewhere) with elementwise selects, no scatter."""
    B, R = txn.keys.shape
    ridx = torch.arange(R, dtype=I32, device=txn.keys.device)[None, :]
    cur = txn.cursor[:, None]
    out = torch.full((B, R), fill, dtype=vals.dtype, device=vals.device)
    for j in range(vals.shape[1]):
        out = torch.where(ridx == cur + j, vals[:, j:j + 1], out)
    return out


def contract_window(txn: TxnState, mask: torch.Tensor, W: int) -> torch.Tensor:
    """Inverse of ``expand_window`` for boolean masks: a (B, R) entry-order
    mask to (B, W) request-window order (lane j holds the value at access
    cursor+j)."""
    B, R = txn.keys.shape
    ridx = torch.arange(R, dtype=I32, device=txn.keys.device)[None, :]
    cur = txn.cursor[:, None]
    return torch.stack([(mask & (ridx == cur + j)).any(dim=1)
                        for j in range(W)], dim=1)


def make_entries(txn: TxnState, active: torch.Tensor,
                 read_locks_held: bool = True, window: int = 1) -> Entries:
    """Build the live entry view for lock-style arbitration.

    ``active``: (B,) txns participating (RUNNING | WAITING).
    ``read_locks_held``: False under READ_COMMITTED.
    ``window``: accesses [cursor, cursor+window) are requested this tick.
    """
    B, R = txn.keys.shape
    dev = txn.keys.device
    ridx = torch.arange(R, dtype=I32, device=dev).expand(B, R)
    cur = txn.cursor[:, None]
    act = active[:, None]
    held = act & (ridx < cur)
    if not read_locks_held:
        held = held & txn.is_write
    req = act & (ridx >= cur) & (ridx < cur + window) \
        & (ridx < txn.n_req[:, None])
    live = held | req
    return Entries(
        key=torch.where(live, txn.keys, NULL_KEY).reshape(-1),
        txn=torch.arange(B, dtype=I32, device=dev).repeat_interleave(R),
        ridx=ridx.reshape(-1),
        ts=txn.ts.repeat_interleave(R),
        is_write=txn.is_write.reshape(-1),
        held=held.reshape(-1),
        req=req.reshape(-1),
    )
