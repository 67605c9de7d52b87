"""Sorted-segment primitives: per-row arbitration as sorts and scans.

The reference serializes conflicting accesses with a mutex per row
(concurrency_control/row_lock.cpp:62).  Here, as in the JAX package, all
live (txn, access) entries are sorted by (row_key, priority...), rows
become contiguous segments of the sorted array, and lock compatibility is
a prefix reduction inside each segment.

Torch has no ``lax.associative_scan``.  Every segmented scan below runs on
SORTED segments, so it is a plain ``cummax`` over an int64 packing
``(seg_id << 32) + word``: earlier segments pack smaller, so the running
maximum never crosses a segment start.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

I32 = torch.int32
I64 = torch.int64

# ---------------------------------------------------------------------------
# fused-arbitration dispatch (Config.fused_arbitrate, ops/fused.py)
# ---------------------------------------------------------------------------
#
# The engine runs each tick inside ``fused_scope(cfg)``.  Inside an active
# scope every ``sort_pack`` and ``sort_pack_scan`` goes through the fused
# sort + scan kernel.  ``sort_pack_scan`` also returns the kernel's scan
# outputs: the segment starts and start index of the sorted primary key
# shifted right by ``shift`` (twopl.arbitrate segments on ``keykind >> 1``).

_FUSED_CFG = None


@contextlib.contextmanager
def fused_scope(cfg):
    """Dispatch scope; nested scopes restore the outer config on exit."""
    global _FUSED_CFG
    prev = _FUSED_CFG
    _FUSED_CFG = cfg if getattr(cfg, "fused_arbitrate", False) else None
    try:
        yield
    finally:
        _FUSED_CFG = prev


def sort_pack(operands, num_keys: int, is_stable: bool = False):
    """Counterpart of ``lax.sort(operands, num_keys, is_stable)``: inside an
    active ``fused_scope`` the pack runs the fused kernel (an ineligible
    pack raises on the card, and takes the plain sort on the CPU after a
    counted warning); otherwise the plain stable sort runs.  Both give the
    stable order, which is a valid result for either stability mode."""
    from deneva_tpu_torch.ops import fused
    ops = tuple(operands)
    if _FUSED_CFG is not None:
        hit = fused.maybe_fused_sort(_FUSED_CFG, ops, num_keys)
        if hit is not None:
            return hit[0]
    return fused.lex_sort(ops, num_keys)


def sort_pack_scan(operands, num_keys: int, shift: int = 0):
    """``sort_pack`` plus the scans of its sorted primary key:
    ``(sorted, starts, start_index)``, the last two those of
    ``sorted[0] >> shift``.  Inside an active ``fused_scope`` all three
    come from the fused kernel; otherwise from the plain sort,
    ``segment_starts`` and ``start_index``."""
    from deneva_tpu_torch.ops import fused
    ops = tuple(operands)
    if _FUSED_CFG is not None:
        hit = fused.maybe_fused_sort(_FUSED_CFG, ops, num_keys, shift)
        if hit is not None:
            return hit
    return fused.fused_sort_scan_plain(ops, num_keys, shift)


def sort_by(keys: tuple, payload: tuple):
    """Lexicographically sort 1-D tensors by `keys`, carrying `payload`.
    Returns (sorted_keys, sorted_payload) tuples."""
    nk = len(keys)
    out = sort_pack(tuple(keys) + tuple(payload), num_keys=nk,
                    is_stable=True)
    return out[:nk], out[nk:]


def spread_index(mask: torch.Tensor, row: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """The int64 index of an in-place scatter whose masked lanes go to
    ``row`` and whose other lanes put the reduction's identity at a row
    spread by lane (in bounds, off any single hot row): the port's form of
    a ``mode="drop"`` scatter-max or scatter-min."""
    return torch.where(mask, row, _iota(row) % n_rows).to(I64)


def _iota(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], dtype=I32, device=x.device)


def segment_starts(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Boolean mask marking the first element of each equal-id run.  (The
    first lane is set elementwise: storing one element of a CUDA tensor
    from the host, ``out[0] = True``, syncs the device.)"""
    first = _iota(sorted_ids) == 0
    return (sorted_ids != torch.roll(sorted_ids, 1)) | first


def start_index(starts: torch.Tensor) -> torch.Tensor:
    """For each position, the index where its segment starts (cummax)."""
    return torch.cummax(torch.where(starts, _iota(starts), 0), 0).values


def seg_ids(starts: torch.Tensor) -> torch.Tensor:
    """Dense 0-based segment ids of each equal-id run."""
    return torch.cumsum(starts, 0, dtype=I32) - 1


def pos_in_segment(starts: torch.Tensor,
                   sidx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each lane's position in its segment: its index less its segment's
    start index ``sidx`` (``sort_pack_scan``'s; computed from ``starts``
    by a cummax when not given)."""
    if sidx is None:
        sidx = start_index(starts)
    return _iota(starts) - sidx


def last_before(mask: torch.Tensor, sidx: torch.Tensor) -> torch.Tensor:
    """Index of the last lane strictly before me in my segment that has
    ``mask`` set, -1 if none (``seg_prefix_max(where(mask, lane, -1),
    starts, -1)``), with no cummax.  An exclusive count of the masked
    lanes numbers them; their indices go into a list in that order (an
    ``index_copy_`` at distinct slots, the other lanes to distinct scratch
    slots past it); lane i reads slot count(i) - 1 and keeps it when it
    lies at or after its segment start ``sidx[i]``."""
    n = mask.shape[0]
    lane = _iota(mask)
    m = mask.to(I32)
    before = torch.cumsum(m, 0, dtype=I32) - m
    slots = torch.empty(2 * n, dtype=I32, device=mask.device)
    slots.index_copy_(0, torch.where(mask, before, n + lane).to(I64), lane)
    prev = slots.index_select(0, torch.clamp(before - 1, min=0).to(I64))
    return torch.where((before > 0) & (prev >= sidx), prev, -1)


def seg_prefix_max_sorted(vals: torch.Tensor, mask: torch.Tensor,
                          sidx: torch.Tensor, identity: int = 0):
    """``seg_prefix_max(where(mask, vals, identity), starts, identity)``
    where ``vals`` does not decrease inside a segment and is at least
    ``identity`` on the masked lanes (a pack sorted by (key, ts) and its
    ts): the max over the masked lanes before me is then the value of the
    last of them (``last_before``).  No cummax."""
    last = last_before(mask, sidx)
    return torch.where(last >= 0,
                       vals.index_select(0, torch.clamp(last, min=0)
                                         .to(I64)), identity)


def run_start_index(run_start: torch.Tensor,
                    sidx: torch.Tensor) -> torch.Tensor:
    """Index of the last lane at or before me in my segment that has
    ``run_start`` set, -1 if none: my own index where I am a run start,
    else ``last_before(run_start, sidx)``.  No cummax."""
    return torch.where(run_start, _iota(run_start),
                       last_before(run_start, sidx))


def at_run_start(prefix_val: torch.Tensor, run_start: torch.Tensor,
                 sidx: torch.Tensor, identity, op: str = "max",
                 rs_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Value of an exclusive prefix reduction at my (segment, owner)-run
    start: the reference's ``at_run_start(prefix_val, run_start, starts,
    identity, op)``, the "skip my own entries" exclusion of the OCC and
    MAAT validators.  ``prefix_val`` is monotone inside a segment in the
    direction of ``op`` ("max": non-decreasing and at least ``identity``;
    "min": non-increasing and at most ``identity``), so the running max
    (min) over the run starts at or before me is the value at the last of
    them: one gather at ``run_start_index`` (pass ``rs_idx`` when it is
    fixed across calls)."""
    if op not in ("max", "min"):
        raise ValueError(op)
    if rs_idx is None:
        rs_idx = run_start_index(run_start, sidx)
    got = prefix_val.index_select(0, torch.clamp(rs_idx, min=0).to(I64))
    return torch.where(rs_idx >= 0, got, identity)


def seg_cumsum_exclusive(x: torch.Tensor, starts: torch.Tensor,
                         sidx: Optional[torch.Tensor] = None):
    """Per-segment exclusive prefix sum (count of `x` strictly before me):
    the global exclusive sum less its value at my segment start, gathered
    at the start index ``sidx`` (computed from ``starts`` when not given)."""
    if sidx is None:
        sidx = start_index(starts)
    excl = torch.cumsum(x, 0, dtype=x.dtype) - x
    return excl - excl.index_select(0, sidx)


def seg_any_before(mask: torch.Tensor, starts: torch.Tensor,
                   sidx: Optional[torch.Tensor] = None):
    """True where some earlier element in my segment has `mask` set."""
    return seg_cumsum_exclusive(mask.to(I32), starts, sidx) > 0


def _int_bounds(dtype):
    if dtype != I32:
        raise TypeError(f"segment scans take int32 values, got {dtype}")
    return -2**31, 2**31 - 1


def _seg_incl(vals: torch.Tensor, starts: torch.Tensor, sid: torch.Tensor,
              op: str):
    """Inclusive per-segment scan on sorted segments."""
    if op == "add":
        # int64 sums less the sum before my segment start, wrapped back to
        # int32 like the reference's int32 adds
        cs = torch.cumsum(vals.to(I64), 0)
        first = (cs - vals)[start_index(starts).to(I64)]
        return (cs - first).to(I32)
    word = vals.to(I64) + 2**31                     # order-preserving, >= 0
    if op == "min":
        word = (2**32 - 1) - word
    elif op != "max":
        raise ValueError(op)
    run = torch.cummax((sid.to(I64) << 32) | word, 0).values & (2**32 - 1)
    if op == "min":
        run = (2**32 - 1) - run
    return (run - 2**31).to(I32)


def _seg_scan(vals: torch.Tensor, starts: torch.Tensor, op: str, identity):
    """Exclusive per-segment scan; `op` in {"max", "min", "add"}."""
    _int_bounds(vals.dtype)
    sid = seg_ids(starts)
    incl = _seg_incl(vals, starts, sid, op)
    prev = torch.roll(incl, 1)
    same_seg = (torch.roll(sid, 1) == sid) & (_iota(sid) != 0)
    return torch.where(same_seg, prev, identity)


def seg_reduce(vals: torch.Tensor, starts: torch.Tensor, op: str,
               sidx: Optional[torch.Tensor] = None):
    """Whole-segment reduction broadcast back to every member;
    op in {"min", "max", "sum"}.  Each member goes into the slot at its
    segment's start index ``sidx`` by one order-free reduction (an int32
    ``index_add_`` that wraps like the reference's int32 adds, or a
    ``scatter_reduce_`` "amin"/"amax" onto the op's identity), and every
    member reads that slot back; pass ``sidx`` to run no cummax."""
    lo, hi = _int_bounds(vals.dtype)
    at = (start_index(starts) if sidx is None else sidx).to(I64)
    if op == "sum":
        out = torch.zeros_like(vals).index_add_(0, at, vals)
    elif op in ("min", "max"):
        out = torch.full_like(vals, hi if op == "min" else lo) \
            .scatter_reduce_(0, at, vals, "amin" if op == "min" else "amax")
    else:
        raise ValueError(op)
    return out.index_select(0, at)


def seg_min_where(vals, where, starts, big: int,
                  sidx: Optional[torch.Tensor] = None):
    """Segment-wide min of vals over elements with `where` set; `big` if
    none (``seg_reduce`` "min", at ``sidx`` when given)."""
    return seg_reduce(torch.where(where, vals, big), starts, "min", sidx)


def seg_max_where(vals, where, starts, small: int):
    """Segment-wide max of vals over elements with `where` set; `small` if none."""
    return seg_reduce(torch.where(where, vals, small), starts, "max")


def seg_prefix_max(vals, starts, identity: int = 0):
    """Max over elements strictly before me in my segment (identity if none)."""
    return _seg_scan(vals, starts, "max", identity)


def seg_prefix_min(vals, starts, identity: int):
    """Min over elements strictly before me in my segment (identity if none)."""
    return _seg_scan(vals, starts, "min", identity)


def _seg_ends(starts: torch.Tensor) -> torch.Tensor:
    """Mask marking the last element of each equal-id run."""
    return torch.roll(starts, -1) | (_iota(starts) == starts.shape[0] - 1)


def _seg_suffix_scan(vals, starts, op: str, identity):
    """Exclusive per-segment suffix scan."""
    rev = lambda x: torch.flip(x, (0,))
    return rev(_seg_scan(rev(vals), rev(_seg_ends(starts)), op, identity))


def seg_suffix_min(vals, starts, identity: int):
    """Min over elements strictly after me in my segment (identity if none)."""
    return _seg_suffix_scan(vals, starts, "min", identity)


def seg_suffix_max(vals, starts, identity: int = 0):
    """Max over elements strictly after me in my segment (identity if none)."""
    return _seg_suffix_scan(vals, starts, "max", identity)


def unpermute_many(perm: torch.Tensor, *vals: torch.Tensor):
    """`unpermute` for several payloads with ONE sort."""
    conv = tuple(v.to(I32) if v.dtype == torch.bool else v for v in vals)
    out = sort_pack((perm,) + conv, num_keys=1, is_stable=False)[1:]
    return tuple(o == 1 if v.dtype == torch.bool else o
                 for o, v in zip(out, vals))


def unpermute(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Values in permuted order plus the original indices `perm` they came
    from -> values in original order, as a 2-operand sort by `perm`.
    Booleans ride as int32 and convert back."""
    v = vals.to(I32) if vals.dtype == torch.bool else vals
    _, out = sort_pack((perm, v), num_keys=1, is_stable=False)
    return out == 1 if vals.dtype == torch.bool else out


# ---------------------------------------------------------------------------
# Live-prefix compaction: run a sort chain at a static live width K, not at
# the padded B*R (Config.compact_lanes / compact_auto).
#
#   1. ``compact_entries``: ONE 1-key sort by ``where(live, idx, n + idx)``
#      (all distinct, so the order is fully determined) moves the live
#      entries to a prefix in their original relative order; the payloads
#      ride it and are sliced to K lanes.
#   2. the caller's own sorts run at K lanes.  Compaction keeps the live
#      entries' relative order and every downstream sort breaks ties by
#      lane, so each segment sees the same live entries in the same order
#      as the padded run: decisions are bit-equal whenever nothing spills.
#   3. ``expand_entries``: ONE sort by the permutation puts the K-lane
#      results back at their (n,) positions.
#
# Live entries ranked >= K are never dropped silently: ``overflow_mask``
# marks them at full width, the callers force their txns to retry, and
# the spill is counted in ``compact_overflow_cnt``.  The JAX package
# claims about 2x on its sort-bound ticks; the building and expanding
# sorts are full width, so whether it pays on the card is measured
# (PERF.md), not assumed.
# ---------------------------------------------------------------------------


class CompactView(NamedTuple):
    """Geometry of one ``compact_entries`` call: static lane counts K
    (``width``) and n, the full-width permutation (the original index of
    each liveness-sorted slot; None for the identity view), the live mask
    of the K lanes, and device scalars n_live and overflow."""

    width: int
    n: int
    orig_sorted: Optional[torch.Tensor]
    live: torch.Tensor
    n_live: torch.Tensor
    overflow: torch.Tensor

    @property
    def identity(self) -> bool:
        return self.orig_sorted is None


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """Booleans as int32 sort operands; other tensors as they are."""
    return x.to(I32) if x.dtype == torch.bool else x


def compact_entries(live: torch.Tensor, K: int, *payloads: torch.Tensor):
    """Sort the live entries to a dense prefix and slice to static width K:
    ``(view, compacted_payloads)``.  K >= n is the identity view
    (payloads returned untouched, no sort).  Booleans ride as int32 and
    convert back.  ``n_live`` and ``overflow`` stay on the device."""
    n = live.shape[0]
    n_live = live.sum(dtype=I32)
    if K >= n:
        zero = torch.zeros((), dtype=I32, device=live.device)
        view = CompactView(width=n, n=n, orig_sorted=None, live=live,
                           n_live=n_live, overflow=zero)
        return view, payloads
    idx = _iota(live)
    keyrank = torch.where(live, idx, n + idx)
    srt = sort_pack((keyrank,) + tuple(as_i32(p) for p in payloads),
                    num_keys=1, is_stable=False)
    outs = tuple(o[:K] == 1 if p.dtype == torch.bool else o[:K]
                 for o, p in zip(srt[1:], payloads))
    view = CompactView(
        width=K, n=n,
        orig_sorted=srt[0] % n,      # keyrank mod n: the original index
        live=srt[0][:K] < n,
        n_live=n_live,
        overflow=torch.clamp(n_live - K, min=0))
    return view, outs


def expand_entries(view: CompactView, *vals: torch.Tensor, fill=0):
    """Put K-lane results back at their original (n,) positions with ONE
    sort by the view's permutation (``unpermute_many``); positions that
    did not ride the K lanes get ``fill`` (False for booleans).  Identity
    views pass through untouched."""
    if view.identity:
        return vals
    pad = view.n - view.width
    padded = tuple(torch.cat([v, torch.full((pad,), fill, dtype=v.dtype,
                                            device=v.device)])
                   for v in vals)
    return unpermute_many(view.orig_sorted, *padded)


def overflow_mask(live: torch.Tensor, K: int) -> torch.Tensor:
    """Full-width mask of the live entries ranked beyond K, the ones a
    compacted kernel never saw: compaction keeps the live order, so they
    are the live entries whose exclusive live rank (an int32 cumsum, no
    cummax) is >= K."""
    if K >= live.shape[0]:
        return torch.zeros_like(live)
    m = live.to(I32)
    return live & (torch.cumsum(m, 0, dtype=I32) - m >= K)
