"""PPS (Product-Parts-Supplier), the reference's third workload, in PyTorch.

A port of ``deneva_tpu/workloads/pps.py``.  The host half is a copy: the
catalog, the loader's association chains (``_chains``, ``_load``) and
``gen_pool`` give a byte-equal pool for the same ``Config`` and seed.  The
device half builds the same tables and applies the same commit effects,
bit for bit.

The reference runs PPS as 8 transaction types over 5 tables
(benchmarks/pps.h:32-71, PPS_schema.txt), with secondary lookups through
the non-unique USES / SUPPLIES indexes, one chain link per state-machine
loop (pps_txn.cpp:485-630):

- **entity tables** PARTS / PRODUCTS / SUPPLIERS: catalog rows striped by
  raw key % part_cnt (pps_helper.cpp:19-29).  The only mutable numeric
  column is PART_AMOUNT (init 1000, pps_wl.cpp:125).
- **association tables** USES / SUPPLIES: one catalog row per chain slot
  (product, i); the chain is the loader's deduped, ascending set of
  max_parts_per draws (std::set iteration, pps_wl.cpp:200-243).
- **access lists**: the chain walk unrolled.  GETPART / GETPRODUCT /
  GETSUPPLIER read one row; GETPARTBYPRODUCT reads PRODUCTS, then per link
  USES + PARTS; GETPARTBYSUPPLIER the same through SUPPLIES;
  ORDERPRODUCT reads PRODUCTS, then per link USES and writes PARTS
  (amount - 1, run_orderproduct_5); UPDATEPRODUCTPART writes USES[product,
  0] := a new part key (pps_txn.cpp:968); UPDATEPART writes PARTS (amount
  + 100, run_updatepart_1).

The JAX package's documented divergences carry over: chain footprints are
resolved against the loader's USES mapping.  Under CALVIN the types that
walk a chain (GETPARTBYSUPPLIER, GETPARTBYPRODUCT, ORDERPRODUCT) take the
reconnaissance pass (``recon_types``): admitted one epoch late, their
footprint shipped read-only in the meantime (``engine/scheduler.py``
``recon_defer``).

Commit effects run as in TPC-C (``workloads/tpcc.py``): when B*R > K, one
sort by ``(cts, lane)`` puts the effect entries in a K-lane prefix and the
body runs on it.  The reference chooses that body by ``lax.cond`` on the
effect count.  The eager tick reads the count on the host, one read per
tick, and a full-width tick skips the compaction sort whose result the
reference computes and does not use; ``Engine.run_compiled`` runs the
full-width body on every tick and counts the reference's choice on the
device (``WorkloadPlugin.effect_branch``).
``PPSWorkload.branch_ticks`` counts the bodies taken, on the device.
The body makes one int32 ``index_add_`` for PART_AMOUNT and one
last-writer-wins sort by ``(USES row, cts)`` for the USES overwrites,
whose winners are stored at distinct rows (``workloads/base.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from deneva_tpu_torch.config import Config
from deneva_tpu_torch.ops import segment as seg
from deneva_tpu_torch.storage.catalog import Catalog
from deneva_tpu_torch.workloads import base
from deneva_tpu_torch.workloads.base import (
    QueryPool, WorkloadPlugin, add_rows, iota, store_rows, unpermute_rows,
)

I32 = torch.int32

# txn types (reference pps.h PPSTxnType order)
PPS_GETPART = 1
PPS_GETPRODUCT = 2
PPS_GETSUPPLIER = 3
PPS_GETPARTBYSUPPLIER = 4
PPS_GETPARTBYPRODUCT = 5
PPS_ORDERPRODUCT = 6
PPS_UPDATEPRODUCTPART = 7
PPS_UPDATEPART = 8

# per-access effect roles (aux low 3 bits; payload above)
ROLE_NONE = 0
ROLE_ORDER = 1       # PARTS: amount -= 1   (run_orderproduct_5)
ROLE_UPDPART = 2     # PARTS: amount += 100 (run_updatepart_1)
ROLE_SETUSES = 3     # USES: part_key := payload (run_updateproductpart_1)

TA_PRODUCT, TA_PART, TA_SUPPLIER = 0, 1, 2
N_TARGS = 3

#: sort sentinel of lanes without an effect (they sort last)
OOB = 2**31 - 1


def catalog(cfg: Config) -> Catalog:
    P = cfg.part_cnt
    loc = lambda k: k // P + 1          # keys are 1-based, striped k % P
    cat = Catalog(P)
    cat.add("PARTS", loc(cfg.max_part_key))
    cat.add("PRODUCTS", loc(cfg.max_product_key))
    cat.add("SUPPLIERS", loc(cfg.max_supplier_key))
    cat.add("USES", loc(cfg.max_product_key) * cfg.max_parts_per)
    cat.add("SUPPLIES", loc(cfg.max_supplier_key) * cfg.max_parts_per)
    assert cat.rows_global < 1 << 30
    return cat


def effect_lanes(cfg: Config, n: int) -> int:
    """K, the lanes of the compacted effect body for n = B*R entries: every
    committed access carries at most one effect role, so a txn has at most
    R = n // B of them."""
    return base.effect_lanes(cfg, n, max(n // max(cfg.batch_size, 1), 1),
                             4096)


def _chains(rng, n_entities: int, cfg: Config) -> list[np.ndarray]:
    """Loader association chains: per entity, the deduped ascending set of
    max_parts_per uniform part draws (pps_wl.cpp:200-243)."""
    out = []
    for _ in range(n_entities):
        draws = rng.integers(1, cfg.max_part_key + 1, cfg.max_parts_per)
        out.append(np.unique(draws))    # dedup + ascending (std::set)
    return out


class PPSWorkload(WorkloadPlugin):
    name = "PPS"
    has_effects = True
    effect_fields = ("role", "earg")
    recon_types = (PPS_GETPARTBYSUPPLIER, PPS_GETPARTBYPRODUCT,
                   PPS_ORDERPRODUCT)
    #: the effect bodies taken
    counter_names = ("compact", "full")

    def _load(self, cfg: Config):
        rng = np.random.default_rng([cfg.seed, 0x995])
        uses = _chains(rng, cfg.max_product_key + 1, cfg)      # 1-based
        supplies = _chains(rng, cfg.max_supplier_key + 1, cfg)
        return rng, uses, supplies

    def gen_pool(self, cfg: Config, seed: int | None = None) -> QueryPool:
        # chains always derive from cfg.seed (they are the LOADER's state
        # and must match init_tables); `seed` varies only the query draws
        _, uses, supplies = self._load(cfg)
        rng = np.random.default_rng(
            [cfg.seed if seed is None else seed, 0x9951])
        cat = catalog(cfg)
        P = cfg.part_cnt
        Q = cfg.query_pool_size
        L = cfg.max_parts_per
        Rmax = 1 + 2 * L

        mix = np.array([cfg.perc_pps_getpart, cfg.perc_pps_getproduct,
                        cfg.perc_pps_getsupplier,
                        cfg.perc_pps_getpartbysupplier,
                        cfg.perc_pps_getpartbyproduct,
                        cfg.perc_pps_orderproduct,
                        cfg.perc_pps_updateproductpart,
                        cfg.perc_pps_updatepart], np.float64)
        assert abs(mix.sum() - 1.0) < 1e-6, "perc_pps_* must sum to 1"
        cum = np.cumsum(mix)
        draw = rng.random(Q)
        ttype = (np.searchsorted(cum, draw, side="right") + 1).clip(1, 8)

        home_part = np.arange(Q, dtype=np.int64) % P

        def pick(maxk):
            # FIRST_PART_LOCAL: uniform over the home part's keys
            # (pps_query.cpp:223-227); keys are 1-based, striped k % P
            assert maxk >= P, "need at least one key per partition"
            if cfg.first_part_local:
                first = np.where(home_part > 0, home_part, P)
                count = (maxk - first) // P + 1
                return first + P * (rng.integers(0, 1 << 30, Q) % count)
            return rng.integers(1, maxk + 1, Q)

        part_k = pick(cfg.max_part_key)
        product_k = pick(cfg.max_product_key)
        supplier_k = pick(cfg.max_supplier_key)

        key = lambda name, off, part: cat.key(name, off, part)
        ent_local = lambda k: k // P
        uses_row = lambda p, i: key("USES",
                                    ent_local(p) * L + i, p % P)
        supp_row = lambda s, i: key("SUPPLIES",
                                    ent_local(s) * L + i, s % P)

        keys = np.full((Q, Rmax), np.int32(2**31 - 1), np.int64)
        is_write = np.zeros((Q, Rmax), bool)
        aux = np.zeros((Q, Rmax), np.int64)
        n_req = np.zeros(Q, np.int64)

        # the chain walks, one pool row at a time (host-side generation)
        for q in range(Q):
            t = ttype[q]
            pk, pr, sk = int(part_k[q]), int(product_k[q]), int(supplier_k[q])
            acc = []
            if t == PPS_GETPART:
                acc = [(key("PARTS", ent_local(pk), pk % P), False, 0)]
            elif t == PPS_GETPRODUCT:
                acc = [(key("PRODUCTS", ent_local(pr), pr % P), False, 0)]
            elif t == PPS_GETSUPPLIER:
                acc = [(key("SUPPLIERS", ent_local(sk), sk % P), False, 0)]
            elif t == PPS_GETPARTBYPRODUCT:
                acc = [(key("PRODUCTS", ent_local(pr), pr % P), False, 0)]
                for i, p in enumerate(uses[pr]):
                    acc.append((uses_row(pr, i), False, 0))
                    acc.append((key("PARTS", ent_local(int(p)), int(p) % P),
                                False, 0))
            elif t == PPS_GETPARTBYSUPPLIER:
                acc = [(key("SUPPLIERS", ent_local(sk), sk % P), False, 0)]
                for i, p in enumerate(supplies[sk]):
                    acc.append((supp_row(sk, i), False, 0))
                    acc.append((key("PARTS", ent_local(int(p)), int(p) % P),
                                False, 0))
            elif t == PPS_ORDERPRODUCT:
                acc = [(key("PRODUCTS", ent_local(pr), pr % P), False, 0)]
                for i, p in enumerate(uses[pr]):
                    acc.append((uses_row(pr, i), False, 0))
                    acc.append((key("PARTS", ent_local(int(p)), int(p) % P),
                                True, ROLE_ORDER))
            elif t == PPS_UPDATEPRODUCTPART:
                # "always the first part for this product" (pps_txn.cpp:968)
                acc = [(uses_row(pr, 0), True, ROLE_SETUSES | (pk << 3))]
            elif t == PPS_UPDATEPART:
                acc = [(key("PARTS", ent_local(pk), pk % P), True,
                        ROLE_UPDPART)]
            n_req[q] = len(acc)
            for r, (k, w, a) in enumerate(acc):
                keys[q, r] = k
                is_write[q, r] = w
                aux[q, r] = a

        targs = np.zeros((Q, N_TARGS), np.int64)
        targs[:, TA_PRODUCT] = product_k
        targs[:, TA_PART] = part_k
        targs[:, TA_SUPPLIER] = supplier_k

        return QueryPool(
            keys=keys.astype(np.int32),
            is_write=is_write,
            n_req=n_req.astype(np.int32),
            home_part=home_part.astype(np.int32),
            txn_type=ttype.astype(np.int32),
            args=targs.astype(np.int32),
            aux=aux.astype(np.int32),
        )

    def cc_rows(self, cfg: Config) -> int:
        return catalog(cfg).rows_global

    def init_tables(self, cfg: Config, part: int = 0, device="cpu") -> dict:
        """Shard ``part``'s PART_AMOUNT column and its USES part-key column
        (the loader's chains of the products it holds), on ``device``."""
        cat = catalog(cfg)
        _, uses, _ = self._load(cfg)
        P = cfg.part_cnt
        L = cfg.max_parts_per
        col = np.zeros(cat.tables["USES"].n_local, np.int32)
        for pr in range(1, cfg.max_product_key + 1):
            if pr % P != part:
                continue
            base_row = (pr // P) * L
            chain = uses[pr]
            col[base_row:base_row + len(chain)] = chain
        return {
            "part_amount": torch.full((cat.tables["PARTS"].n_local,), 1000,
                                      dtype=I32, device=device),
            "uses_part": torch.from_numpy(col).to(device),
        }

    def commit_fields(self, cfg: Config, tables: dict, txn, commit) -> dict:
        """role/earg per access entry of committing txns, (B, R)."""
        c = commit[:, None]
        return {"role": torch.where(c, txn.aux & 7, 0),
                "earg": torch.where(c, txn.aux >> 3, 0)}

    def apply_commit_entries(self, cfg: Config, tables: dict, key_local,
                             part, fields: dict, cts, live,
                             on_device: bool = False) -> dict:
        """Apply commit effects to ``tables`` in place and return it.

        When B*R > K, the effect entries are first compacted: one stable
        sort by cts puts them in a K-lane prefix (the reference sorts by
        ``(cts, lane)``: the same order), and the body runs on it.  A tick
        with more than K effect entries runs the body at full width
        (``effect_branch`` decides, see the module docstring), and every
        tick does with ``on_device``."""
        n = key_local.shape[0]
        role_f, earg = fields["role"], fields["earg"]
        eff = live & ((role_f & 7) != ROLE_NONE)
        K = effect_lanes(cfg, n)

        def full(m):
            self._apply_entries_body(cfg, tables, key_local, role_f, earg,
                                     cts, m)

        def compact(m):
            out = seg.sort_pack((torch.where(m, cts, OOB), key_local, role_f,
                                 earg, cts, m.to(I32)), num_keys=1)
            c_key, c_rolef, c_earg, c_cts = (a[:K] for a in out[1:5])
            self._apply_entries_body(cfg, tables, c_key, c_rolef, c_earg,
                                     c_cts, out[5][:K] == 1)

        if K < n:
            self.effect_branch(eff.sum(dtype=I32) <= K, eff, compact, full,
                               on_device)
        else:
            self.count("full", 1)
            full(eff)
        return tables

    def _apply_entries_body(self, cfg: Config, t: dict, key_local, role_f,
                            earg, cts, eff) -> dict:
        cat = catalog(cfg)
        n = key_local.shape[0]
        lanes = iota(n, key_local.device)
        role = torch.where(eff, role_f & 7, ROLE_NONE)

        # PART_AMOUNT: -1 per committed order line, +100 per updatepart;
        # int32 adds, so the two reference scatters are one index_add_
        m_ord = role == ROLE_ORDER
        m_amt = m_ord | (role == ROLE_UPDPART)
        add_rows(t["part_amount"], key_local - cat.tables["PARTS"].base,
                 m_amt, torch.where(m_ord, -1, 100).to(I32))

        # USES part-key overwrite: the last committer (max cts) of each row
        # wins.  Sorted by (row, cts), it is the last entry of its row's
        # segment (an element store from the host, x[-1] = True, would
        # sync the device, so the end mask is elementwise)
        m_set = role == ROLE_SETUSES
        skey = torch.where(m_set, key_local, OOB)
        (sk, _), (sidx,) = seg.sort_by((skey, cts), (lanes,))
        is_last = (torch.roll(sk, -1) != sk) | (lanes == n - 1)
        winner = m_set & unpermute_rows(sidx, is_last)
        store_rows(t["uses_part"], key_local - cat.tables["USES"].base,
                   winner, earg)
        return t
