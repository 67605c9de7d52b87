"""Ordered index: the reference's B+-tree capability as binary search.

A port of ``deneva_tpu/storage/ordered.py``.  The reference's B+-tree
(index/index_btree.cpp:88-168) serves ordered lookups: find the leaf for a
key, then walk next-pointers for a range.  Its capability here is an
immutable sorted key column per shard, looked up with
``torch.searchsorted``, with range scans as bounded windows over the
sorted order.  Neither engine changes index topology mid-run (inserts go
to append rings, like the reference's index_insert at load time).

API (batched over query lanes):

  idx = OrderedIndex(keys)            # sorted unique int32 keys, 1 shard
  idx.lookup(q)                       # exact-match row ids (-1 miss)
  idx.range_start(lo)                 # first position with key >= lo
  idx.range_window(lo, W)             # row ids of the W smallest keys
                                      #   >= lo (NULL-padded past hi)
  idx.range_count(lo, hi)             # |{k: lo <= k < hi}|

Row ids are the positions the caller's row store used at load time.  The
index lives on ``device`` (the card unless ``device="cpu"`` is asked
for; asking for the card on a host without one raises); queries are moved
there.
"""

from __future__ import annotations

import numpy as np
import torch

from deneva_tpu_torch.device import resolve_device

I32 = torch.int32

NULL_ROW = 2**31 - 1


class OrderedIndex:
    """Immutable sorted-key index over one shard's rows."""

    def __init__(self, keys, device="cuda"):
        k = np.asarray(keys)
        assert k.ndim == 1 and k.size > 0
        assert (np.diff(k) > 0).all(), "keys must be sorted unique"
        self.keys = torch.from_numpy(k.astype(np.int32)).to(
            resolve_device(device))
        self.n = int(k.shape[0])

    def _q(self, q) -> torch.Tensor:
        return torch.as_tensor(q, dtype=I32, device=self.keys.device)

    def _search(self, q) -> torch.Tensor:
        return torch.searchsorted(self.keys, self._q(q), out_int32=True)

    def lookup(self, q):
        """Exact-match positions for query keys q (…,), -1 on a miss
        (index_read, index_btree.cpp:88-117)."""
        q = self._q(q)
        pc = torch.clamp(self._search(q), 0, self.n - 1)
        return torch.where(self.keys[pc.to(torch.int64)] == q, pc, -1)

    def range_start(self, lo):
        """First sorted position with key >= lo (the leaf descent)."""
        return self._search(lo)

    def range_window(self, lo, W: int, hi=None):
        """Positions of the W smallest keys >= lo (the next-pointer walk,
        index_btree.cpp:118-168, as one static-width window); entries past
        hi (exclusive, optional) or past the key column pad to NULL_ROW.

        lo and hi may each be a scalar or a (Q,) batch (broadcast
        together); a batched call gains a leading Q axis."""
        lo = self._q(lo)
        if hi is not None:
            lo, hi = torch.broadcast_tensors(lo, self._q(hi))
        pos = self._search(lo)[..., None] + torch.arange(
            W, dtype=I32, device=self.keys.device)
        valid = pos < self.n
        pc = torch.clamp(pos, 0, self.n - 1).to(torch.int64)
        if hi is not None:
            valid = valid & (self.keys[pc] < hi[..., None])
        return torch.where(valid, pos, NULL_ROW)

    def range_count(self, lo, hi):
        """|{key in [lo, hi)}|: binary-search arithmetic."""
        return self._search(hi) - self._search(lo)
