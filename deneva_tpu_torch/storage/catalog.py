"""Catalog-lite: named tables of int32 columns over a striped key space.

A copy of ``deneva_tpu/storage/catalog.py`` (it imports nothing), so the
port keeps the JAX package's key encoding without importing it.  ``key``
and ``local`` take ints, numpy arrays and torch tensors alike.

The reference parses schema text files into a Catalog of column offsets
(storage/catalog.cpp:30, system/wl.cpp:31-149) and hands out row_t tuples
from per-table factories (storage/table.cpp:43).  Tensorized, a table is a
dict of dense device arrays (one per column) indexed by a LOCAL row id, and
the "index" is an affine key encoding (the rebuild of IndexHash for
primary-key lookups — TPC-C/YCSB keys are dense, so hashing is unnecessary;
see SURVEY.md §7 step 2).

Key encoding.  CC operates on a single global row-id space shared by all
CC-addressable tables.  Striping follows the reference's partition rule
(wh_to_part(w) = w % part_cnt, benchmarks/tpcc_helper.cpp):

    global_key = local_row * P + part
    local_row  = table.base + offset_within_table_shard

so ``key % P`` is the owning shard (what the sharded engine routes by) and
``key // P`` the local row — the same encoding YCSB uses
(primary_key = row_id * part_cnt + partition, ycsb_wl.cpp:70-74).

Replicated tables (TPC-C ITEM) get one copy per shard: accesses encode the
ACCESSOR's home part, so they are always local — the tensor analog of the
reference's per-node replicated item table (tpcc_wl.cpp load_item).

Insert-only tables (ORDER/NEW-ORDER/ORDER-LINE/HISTORY) are not
CC-addressable: the reference's inserts take no locks (insert_row appends,
system/txn.cpp:899-904); here they are preallocated rings written at commit
time.  They live in the workload's table dict but have no catalog rows.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Table:
    name: str
    n_local: int      # rows per shard
    base: int         # local row-id base (filled by Catalog)


class Catalog:
    """CC-addressable row space: ordered tables with per-shard sizes."""

    def __init__(self, part_cnt: int):
        self.P = part_cnt
        self.tables: dict[str, Table] = {}
        self._next = 0

    def add(self, name: str, n_local: int) -> Table:
        t = Table(name=name, n_local=n_local, base=self._next)
        self._next += n_local
        self.tables[name] = t
        return t

    @property
    def rows_local(self) -> int:
        return self._next

    @property
    def rows_global(self) -> int:
        return self._next * self.P

    def key(self, name: str, offset, part):
        """Global CC key for (table, per-shard offset, shard). Vectorized."""
        return (self.tables[name].base + offset) * self.P + part

    def local(self, name: str, key):
        """Per-shard offset within `name` for a global key."""
        return key // self.P - self.tables[name].base
