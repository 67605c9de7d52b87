"""Fixed-capacity routing of access entries to row-owner nodes.

The reference ships work between nodes in messages batched per
destination (transport/msg_thread.cpp:44-117).  As in the JAX package
(``deneva_tpu/parallel/routing.py``), each node packs its live entries
into per-destination lanes of capacity C, one exchange delivers them to
the owners, and decisions travel back through the inverse exchange.  The
port keeps all N nodes on one device: an exchange is a transpose of the
stacked ``(N_src, N_dst, C)`` send buffers.

Entries pack by (destination, priority, lane): held locks first on the
request leg, timestamps on the commit leg.  A live entry past its
destination's capacity does not ship; the ``overflow`` mask names it, so
its home node can abort or defer its txn.
"""

from __future__ import annotations

import torch

from deneva_tpu_torch.engine.state import NULL_KEY
from deneva_tpu_torch.ops import segment as seg

I32 = torch.int32
I64 = torch.int64

#: fill values per routed field (0 for the others)
FILL = {"key": NULL_KEY}


def pack_by_dest(dest: torch.Tensor, prio: torch.Tensor, live: torch.Tensor,
                 n_nodes: int, cap: int, fields: dict):
    """Pack entries into (N, C) per-destination lanes.

    dest/prio/live: (n,) destination node, packing priority (smaller packs
    first), liveness.  fields: name -> (n,) tensors to route.

    Returns (send: name -> (N, C), orig: (N, C) int32 original entry index
    or -1, overflow: (n,) bool, the live entries that did not fit).

    One sort by (dest, prio) with the lane as payload orders the entries;
    the kernel's start index of the dest segments gives each entry's
    position in its segment, ``lane - start``.  Kept entries go to
    distinct cells ``dest * C + pos``, the others to distinct scratch
    cells past ``N * C``, so every ``index_copy_`` sees distinct indices.
    """
    n = dest.shape[0]
    dev = dest.device
    lane = torch.arange(n, dtype=I32, device=dev)
    d = torch.where(live, dest, n_nodes).to(I32)
    (sd, _, perm), _, start = seg.sort_pack_scan(
        (d, prio.to(I32), lane), num_keys=2)
    pos = lane - start
    routed = sd < n_nodes
    kept = routed & (pos < cap)
    m = n_nodes * cap
    slot = torch.where(kept, sd * cap + pos, m + lane).to(I64)
    perm64 = perm.to(I64)

    send = {}
    for name, vals in fields.items():
        buf = torch.full((m + n,), FILL.get(name, 0), dtype=vals.dtype,
                         device=dev)
        buf.index_copy_(0, slot, vals.index_select(0, perm64))
        send[name] = buf[:m].reshape(n_nodes, cap)
    orig = torch.full((m + n,), -1, dtype=I32, device=dev)
    orig.index_copy_(0, slot, perm)
    # perm is a permutation of the lanes, so this scatter is one-to-one
    overflow = torch.zeros(n, dtype=torch.bool, device=dev)
    overflow.index_copy_(0, perm64, routed & (pos >= cap))
    return send, orig[:m].reshape(n_nodes, cap), overflow


def exchange(sends: list) -> list:
    """Deliver every node's (N, C) send buffers: node d receives, for each
    field, the (N_src, C) rows each source addressed to d (the reference's
    ``all_to_all``, here a transpose of the stacked buffers)."""
    out = [{} for _ in sends]
    for name in sends[0]:
        recv = torch.stack([s[name] for s in sends]).transpose(0, 1) \
            .contiguous()
        for d, got in enumerate(out):
            got[name] = recv[d]
    return out


def unpack(results: dict, orig: torch.Tensor, n: int, defaults: dict):
    """Scatter returned (N, C) per-entry results back to the original (n,)
    entry order through the packing permutation ``orig``.  ``defaults``
    ((n + 1,) each) holds the value of entries that never shipped; empty
    lanes go to distinct scratch cells past them and are dropped."""
    flat = orig.reshape(-1)
    m = flat.shape[0]
    tgt = torch.where(flat >= 0, flat,
                      n + 1 + torch.arange(m, dtype=I32, device=flat.device))
    out = {}
    for name, buf in results.items():
        d = defaults[name]
        full = torch.cat([d, torch.empty(m, dtype=d.dtype, device=d.device)])
        full.index_copy_(0, tgt.to(I64), buf.reshape(-1))
        out[name] = full[:n + 1]
    return out
