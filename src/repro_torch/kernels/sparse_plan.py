"""Bucketing planner for the fused sparse backward and the dedup forward.

A `SparsePlan` is a CSR layout of one batch's lookup stream, grouped by
unique mega-table row (the reference's `repro.kernels.sparse_plan`):

  unique_rows (U,)    i-th unique row, strictly ascending, -1 past the
                      unique count
  bag_offsets (U+1,)  [bag_offsets[i], bag_offsets[i+1]) slices bag_ids for
                      unique row i (empty for i past the unique count)
  bag_ids     (N,)    for each lookup slot in sorted-row order, the flat
                      (example*F + feature) bag it belongs to; N = B*F*L

Slots of equal row keep their flat-batch order (stable sort), which fixes
the order in which the fused backward adds a row's bag gradients.

Two builders with identical integers (held equal to the reference's in
tests/test_torch_train.py):
  * `build_sparse_plan` — torch ops on the index tensor's device; the
    unique count stays on the device, so planning inside a train step adds
    no host sync;
  * `build_sparse_plan_host` — numpy, for the data pipeline's reader thread
    (`data.pipeline.sparse_plan_hook`), so batch k+1 is planned while batch
    k computes.

The cached tier's host planning reads a hook's plan as numpy
(`host_plan_from_batch`) and groups its sorted miss rows into contiguous
fetch blocks (`coalesce_rows`). The table-wise step cuts a plan into
per-owner segments (`split_plan_by_owner`, over the general
`split_plan_by_ranges`) for the segmented fused backward, and into
per-table segments (`split_plan_by_table`, each table's unique footprint).
The multi-host cached tier splits a plan by host bag range
(`split_plan_by_host`; a hook's per-host sub-plans come back through
`host_plans_from_batch`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# rows are mega-table offsets (< total_rows << 2**31), so int32 max is a safe
# sort-last sentinel for -1 padding slots
SENTINEL = np.iinfo(np.int32).max


class SparsePlan(NamedTuple):
    """CSR layout of a batch's lookups, grouped by unique row (tensors, or
    numpy arrays from the host builder). `unique_rows`/`bag_offsets` may be
    capacity-trimmed to (U,)/(U+1,) with U < N; every consumer sizes
    itself from the arrays."""
    unique_rows: torch.Tensor     # (U,) int32, -1 past the unique count
    bag_offsets: torch.Tensor     # (U+1,) int32, nondecreasing
    bag_ids: torch.Tensor         # (N,) int32 flat (example*F + feature) bags

    def to_batch(self) -> dict:
        """The three arrays under the batch-dict keys the train step reads."""
        return {"plan_rows": self.unique_rows,
                "plan_offsets": self.bag_offsets,
                "plan_bags": self.bag_ids}


def plan_from_batch(batch: dict) -> SparsePlan | None:
    """The plan a `sparse_plan_hook` attached to `batch` (or None), as int32
    tensors on the device the batch's arrays are on."""
    if "plan_rows" not in batch:
        return None
    return SparsePlan(*(torch.as_tensor(batch[k], dtype=torch.int32)
                        for k in ("plan_rows", "plan_offsets", "plan_bags")))


def host_plan_from_batch(batch: dict) -> SparsePlan | None:
    """numpy view of a hook-attached plan (or None), with no device
    transfer: what the cached tier's host-side miss planning consumes."""
    if "plan_rows" not in batch:
        return None
    return SparsePlan(*(np.asarray(batch[k]) for k in
                        ("plan_rows", "plan_offsets", "plan_bags")))


def host_plans_from_batch(batch: dict) -> list[SparsePlan] | None:
    """numpy views of the per-host sub-plans a `sparse_plan_hook` with
    `n_hosts` attached (stacked (H, ...) under the hplan_* keys), or None:
    what the multi-host cached tier's per-host miss planning consumes."""
    if "hplan_rows" not in batch:
        return None
    rows, offs, bags = (np.asarray(batch[k]) for k in
                        ("hplan_rows", "hplan_offsets", "hplan_bags"))
    return [SparsePlan(rows[h], offs[h], bags[h])
            for h in range(rows.shape[0])]


def split_plan_by_host(plan: SparsePlan, n_hosts: int,
                       bags_per_host: int) -> list[SparsePlan]:
    """Split a host-built GLOBAL plan into per-host sub-plans by bag range:
    host h owns the flat bags [h*bags_per_host, (h+1)*bags_per_host), the
    data-parallel batch split. Each sub-plan is in host-local bag space and
    equals `build_sparse_plan_host` on that host's sub-batch (rows,
    offsets, and the live bag prefix). Host numpy.

    No sort: the plan's runs are row-ascending and each run's bags are
    flat-order ascending, so a host's pairs are a mask and a stable
    selection, and its rows the heads of the selected runs."""
    rows = np.asarray(plan.unique_rows)
    offs = np.asarray(plan.bag_offsets).astype(np.int64)
    bags = np.asarray(plan.bag_ids).astype(np.int64)
    nh = bags.shape[0] // n_hosts          # per-host lookup capacity
    n_live = int((rows >= 0).sum())
    n_valid = int(offs[n_live])
    host_of = bags[:n_valid] // bags_per_host
    # run id of each live pair: the live prefix of offsets is sorted
    run_of = np.searchsorted(offs[:n_live + 1], np.arange(n_valid),
                             side="right") - 1
    out = []
    for h in range(n_hosts):
        sel = np.flatnonzero(host_of == h)  # ascending (row, local bag)
        r_sel = run_of[sel]
        sub_rows = np.full((nh,), -1, np.int32)
        sub_offs = np.zeros((nh + 1,), np.int32)
        sub_bags = np.zeros((nh,), np.int32)
        if len(sel):
            change = np.empty(len(sel), bool)
            change[0] = True
            change[1:] = r_sel[1:] != r_sel[:-1]
            head_pos = np.flatnonzero(change)
            k = len(head_pos)
            sub_rows[:k] = rows[r_sel[head_pos]]
            ends = np.append(head_pos[1:], len(sel)).astype(np.int64)
            sub_offs[:k + 1] = np.concatenate([[0], ends])
            sub_offs[k + 1:] = ends[-1]
            sub_bags[:len(sel)] = bags[sel] - h * bags_per_host
        out.append(SparsePlan(sub_rows, sub_offs, sub_bags))
    return out


def coalesce_rows(rows: np.ndarray, chunk: int, total_rows: int,
                  min_fill: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Greedily cover an ASCENDING row list with contiguous `chunk`-row
    blocks, for the chunk-granular fetch (`cache_ops.cache_fetch_chunked`).

    A block opens at min(row, total_rows - chunk) whenever the current one
    cannot hold the next row, so it may cover rows below its first member
    (read, never installed) but never past the table. Blocks holding fewer
    than `min_fill` member rows are dropped and their rows get pos = -1,
    for the caller's per-row fetch. Returns (starts (K,) int32, pos (N,)
    int32): pos[i] = k*chunk + (rows[i] - starts[k]), row i's place in the
    (K*chunk, D) slab, or -1. With chunk <= 1 every row is its own block."""
    rows = np.asarray(rows, np.int64)
    n = rows.shape[0]
    if chunk <= 1 or n == 0:
        return rows.astype(np.int32), np.arange(n, dtype=np.int32)
    chunk = min(chunk, total_rows)
    starts = []
    pos = np.empty((n,), np.int32)
    i = 0
    while i < n:
        start = min(int(rows[i]), total_rows - chunk)
        j = int(np.searchsorted(rows, start + chunk, side="left"))
        if j - i >= min_fill:
            pos[i:j] = len(starts) * chunk + (rows[i:j] - start).astype(
                np.int32)
            starts.append(start)
        else:
            pos[i:j] = -1
        i = j
    return np.asarray(starts, np.int32), pos


def split_plan_by_ranges(plan: SparsePlan, starts, ends,
                         seg_cap: int | None = None
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Slice a plan into segments over DISJOINT ascending row ranges:
    segment s covers global rows [starts[s], ends[s]). Host numpy.

    The plan's live prefix is sorted ascending, so each segment's rows —
    and its (row, bag) pairs in `bag_ids` — form a contiguous slice: two
    searchsorted calls and slicing, no sort. Rows outside every range are
    claimed by no segment.

    Returns (seg_rows (S, cap) int32 SEGMENT-LOCAL rows (global minus
    starts[s]), -1-padded; seg_offsets (S, cap+1) int32 ABSOLUTE positions
    into the shared `bag_ids`, pad entries equal to the segment's bag end;
    seg_base (S,) int32 = starts, the base the segmented fused backward
    adds back). `seg_cap` fixes the per-segment capacity (raises on
    overflow); the default is the tight per-call maximum, which gives the
    same update as any larger cap with a shorter grid."""
    rows = np.asarray(plan.unique_rows)
    offs = np.asarray(plan.bag_offsets).astype(np.int64)
    starts = np.asarray(starts, np.int64)
    ends = np.asarray(ends, np.int64)
    n_seg = len(starts)
    if len(ends) != n_seg:
        raise ValueError(f"{len(ends)} range ends for {n_seg} starts")
    if n_seg and not (np.all(ends >= starts)
                      and np.all(starts[1:] >= ends[:-1])):
        raise AssertionError("ranges must be ascending and disjoint")
    n_live = int((rows >= 0).sum())
    live = rows[:n_live].astype(np.int64)
    lo = np.searchsorted(live, starts)
    hi = np.searchsorted(live, ends)
    widest = int((hi - lo).max()) if n_seg else 0
    cap = widest if seg_cap is None else seg_cap
    if widest > cap:
        raise ValueError(
            f"owner segment overflow: widest owner holds {widest} unique "
            f"rows > seg_cap={cap}")
    seg_rows = np.full((n_seg, cap), -1, np.int32)
    seg_offs = np.zeros((n_seg, cap + 1), np.int32)
    for s in range(n_seg):
        a, b = int(lo[s]), int(hi[s])
        k = b - a
        seg_rows[s, :k] = live[a:b] - starts[s]
        seg_offs[s, :k + 1] = offs[a:b + 1]
        seg_offs[s, k + 1:] = offs[b]
    return seg_rows, seg_offs, starts.astype(np.int32)


def split_plan_by_owner(plan: SparsePlan, shard_rows: int, n_shards: int,
                        seg_cap: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-OWNER segments: owner s of a table_wise placement (or of a
    row-sharded capacity tier) holds rows [s*shard_rows,
    (s+1)*shard_rows). See `split_plan_by_ranges` for the layout."""
    starts = np.arange(n_shards, dtype=np.int64) * shard_rows
    return split_plan_by_ranges(plan, starts, starts + shard_rows,
                                seg_cap=seg_cap)


def split_plan_by_table(plan: SparsePlan, table_offsets, table_rows,
                        seg_cap: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-TABLE segments: table t owns the mega rows [table_offsets[t],
    table_offsets[t] + table_rows[t]) under any layout whose tables do not
    interleave. Segments come in TABLE order (the caller's ids), not row
    order: the split runs over the ranges sorted by start and is unpermuted
    here. The layout of `split_plan_by_ranges`, with seg_base[t] =
    table_offsets[t]."""
    starts = np.asarray(table_offsets, np.int64)
    ends = starts + np.asarray(table_rows, np.int64)
    order = np.argsort(starts, kind="stable")
    seg_rows, seg_offs, seg_base = split_plan_by_ranges(
        plan, starts[order], ends[order], seg_cap=seg_cap)
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    return seg_rows[inv], seg_offs[inv], seg_base[inv]


def _lookups_per_bag(shape, lookups_per_bag: int | None) -> int:
    if len(shape) == 3:
        return shape[2]
    if lookups_per_bag is None:
        raise ValueError("a flat index stream needs lookups_per_bag")
    return lookups_per_bag


def build_sparse_plan(idx: torch.Tensor, lookups_per_bag: int | None = None,
                      capacity: int | None = None) -> SparsePlan:
    """idx: (B, F, L) offset global rows with -1 pads (or a flat (N,)
    stream with `lookups_per_bag=L`), on any device. Integer ops only.

    `capacity` trims unique_rows/bag_offsets to (capacity,)/(capacity+1,).
    As in the reference's on-device builder the trim is a plain slice: the
    caller owns the contract that the batch's unique count fits (checking
    it would need a host sync; the host builder does raise)."""
    lk = _lookups_per_bag(idx.shape, lookups_per_bag)
    flat = idx.reshape(-1).to(torch.int32)
    n, dev = flat.numel(), flat.device
    valid = flat >= 0
    safe = flat.masked_fill(~valid, SENTINEL)            # pads sort last
    # stable: slots of one row stay in flat-batch order (torch's default
    # sort is not stable)
    s, order = torch.sort(safe, stable=True)
    bag_ids = torch.div(order, lk, rounding_mode="floor").to(torch.int32)
    head = torch.ones((n,), dtype=torch.bool, device=dev)
    head[1:] = s[1:] != s[:-1]
    head &= s != SENTINEL
    rank = torch.cumsum(head, 0) - 1                     # unique id at heads
    n_valid = valid.sum(dtype=torch.int32)               # stays on device
    # the reference's mode="drop" scatters: non-heads write one slot past
    # the end, which is sliced off
    unique_rows = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
    unique_rows.scatter_(0, torch.where(head, rank, n), s)
    # run i starts at its head's sorted position; valid slots sort first,
    # so offsets[i+1] doubles as run i's end and the n_valid fill closes
    # the last run and empties the tail
    bag_offsets = n_valid.expand(n + 2).clone()
    bag_offsets.scatter_(0, torch.where(head, rank, n + 1),
                         torch.arange(n, dtype=torch.int32, device=dev))
    unique_rows, bag_offsets = unique_rows[:n], bag_offsets[:n + 1]
    if capacity is not None and capacity < n:
        unique_rows = unique_rows[:capacity]
        bag_offsets = bag_offsets[:capacity + 1]
    return SparsePlan(unique_rows, bag_offsets, bag_ids)


def build_sparse_plan_host(idx: np.ndarray,
                           lookups_per_bag: int | None = None,
                           capacity: int | None = None) -> SparsePlan:
    """numpy twin of `build_sparse_plan` with identical outputs. Unlike the
    device builder, a `capacity` overflow raises here."""
    idx = np.asarray(idx)
    lk = _lookups_per_bag(idx.shape, lookups_per_bag)
    flat = idx.reshape(-1).astype(np.int64)
    n = flat.shape[0]
    valid = flat >= 0
    safe = np.where(valid, flat, SENTINEL)
    order = np.argsort(safe, kind="stable")
    s = safe[order]
    bag_ids = (order // lk).astype(np.int32)
    head = np.concatenate([np.ones((1,), bool), s[1:] != s[:-1]]) \
        & (s != SENTINEL)
    n_valid = int(valid.sum())
    heads = np.flatnonzero(head)
    if capacity is not None and len(heads) > capacity:
        raise ValueError(
            f"plan capacity overflow: batch has {len(heads)} unique rows "
            f"> capacity={capacity}; raise the capacity or shrink the batch")
    u = n if capacity is None else min(capacity, n)
    unique_rows = np.full((u,), -1, np.int32)
    unique_rows[:len(heads)] = s[heads]
    bag_offsets = np.full((u + 1,), n_valid, np.int32)
    bag_offsets[:len(heads)] = heads
    return SparsePlan(unique_rows, bag_offsets, bag_ids)
