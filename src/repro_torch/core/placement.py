"""PlacementPlan: where each embedding table's rows live.

All tables are laid out in one row-concatenated MEGA TABLE (rows, d); the
plan fixes each table's row offset, and the planning of each strategy here
is the reference's (`repro.core.placement`), integers and loads alike:

  replicated   the whole mega table on one device
  table_wise   whole tables bin-packed onto owners (greedy LPT on each
               table's cost, expected lookups unless `table_costs` prices
               them, under a byte limit); owner s holds the contiguous
               rows [s*shard_rows, (s+1)*shard_rows) — the paper's Zion /
               Big Basin placement; `train.steps.build_tablewise_train_step`
               trains it on one device, or over a (data, model) mesh with
               one owner per `model` rank
  row_wise     rows striped over shards regardless of table boundaries
               (what `auto` gives full-width dlrm-m1 at one shard: the
               replicated layout); with `second_axis_size > 1` a table too
               big for one axis of shards spreads over both mesh axes
  column_wise  the embedding dim sliced over all shards (a plan only: the
               steps refuse `column_shards > 1`, as the reference's do)
  cached_host  the mega table in a capacity tier, a `cache_rows`-slot hot
               cache on the device sized from the HBM budget
               (core/cache.py); `capacity_shards > 1` row-shards the
               capacity tier over hosts

`pspec` is the reference's PartitionSpec of the (rows, d) mega table as a
plain tuple of mesh axis names (None: not sharded), e.g. ("model", None)
for row_wise and table_wise: what the sharded executors
(`EmbeddingBagCollection.lookup_pooled_psum`, the mesh steps) check.
`frequency_reorder` renumbers each table's rows by access frequency and
`elastic_table_remap` moves rows between two placements of the same
tables (`train.fault_tolerance.elastic_tablewise_repack`).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import numpy as np

#: device-side bytes per CACHED row beyond the payload: the row-wise
#: AdaGrad accumulator (fp32) + the LFU frequency score (fp32)
CACHED_ROW_META_BYTES = 8


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """The fused mega-table layout, its owners (table_wise) and
    (cached_host) the device-cache size: the reference's fields, with
    `pspec` a tuple (keyword-only, last)."""

    strategy: str   # replicated|table_wise|row_wise|column_wise|cached_host
    table_offsets: tuple[int, ...]   # row offset of each table in the mega table
    total_rows: int                  # padded row count of the mega table
    shard_of_table: tuple[int, ...] | None  # table_wise only
    n_shards: int
    # diagnostics
    bytes_per_shard: tuple[int, ...] = ()
    load_per_shard: tuple[float, ...] = ()
    # cached_host only: device-cache slots backing the capacity tier
    cache_rows: int = 0
    # table_wise: owners (owner s holds rows [s*shard_rows,
    # (s+1)*shard_rows)) and rows per owner; cached_host: the hosts the
    # capacity tier is row-sharded over (1 = unsharded) and rows per host
    capacity_shards: int = 1
    shard_rows: int = 0
    # table_wise only: per table, the count of embedding-dim slices an
    # executor should use — 1 for a table that fits its owner's budget,
    # k > 1 for one whose bytes exceed a shard's; the layout stays
    # full-width
    column_shards: tuple[int, ...] = ()
    # the reference's PartitionSpec of the (rows, d) mega table, as a tuple
    pspec: tuple = (None, None)

    @property
    def load_imbalance(self) -> float:
        """max/mean expected lookup load across shards (1.0 = balanced)."""
        if not self.load_per_shard or max(self.load_per_shard) == 0:
            return 1.0
        mean = float(np.mean(self.load_per_shard))
        return float(max(self.load_per_shard)) / max(mean, 1e-9)


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def _contiguous(hash_sizes, pad_mult: int):
    offsets, off = [], 0
    for h in hash_sizes:
        offsets.append(off)
        off += _round_up(h, pad_mult)
    return tuple(offsets), off


def plan_placement(hash_sizes: Sequence[int],
                   mean_lookups: Sequence[float],
                   embed_dim: int,
                   n_shards: int,
                   hbm_budget_bytes: float,
                   itemsize: int = 4,
                   strategy: str = "auto",
                   model_axis: str = "model",
                   second_axis: str = "data",
                   second_axis_size: int = 1,
                   capacity_shards: int = 1,
                   table_costs: Sequence[float] | None = None
                   ) -> PlacementPlan:
    """Build a placement plan for one EmbeddingBagCollection.

    `hbm_budget_bytes` is the per-shard capacity available for embeddings.
    `auto` resolves as in the reference: replicated if everything fits one
    budget, table_wise if it fits `n_shards` budgets with the largest table
    inside one, else row_wise (so a full-width dlrm-m1 at `n_shards=1`
    plans a one-shard row_wise layout, identical to the replicated one).

    `second_axis_size` (row_wise): when one shard's rows exceed the budget,
    the rows spread over `n_shards * second_axis_size` shards of both mesh
    axes. `capacity_shards` (cached_host): hosts the capacity tier is
    row-sharded over. `table_costs` (table_wise): each table's price for
    the bin-pack, `mean_lookups` by default.
    """
    hash_sizes = [int(h) for h in hash_sizes]
    loads = [float(ld) for ld in mean_lookups]
    total_bytes = sum(h * embed_dim * itemsize for h in hash_sizes)
    if strategy == "host_offload":  # legacy alias for the realized tier
        strategy = "cached_host"
    if strategy == "auto":
        if total_bytes <= hbm_budget_bytes:
            strategy = "replicated"
        elif (total_bytes <= hbm_budget_bytes * n_shards
              and max(hash_sizes) * embed_dim * itemsize
              <= hbm_budget_bytes):
            strategy = "table_wise"
        else:
            strategy = "row_wise"

    if strategy == "replicated":
        offsets, rows = _contiguous(hash_sizes, pad_mult=8)
        return PlacementPlan(strategy, offsets, rows, None, n_shards,
                             bytes_per_shard=(total_bytes,),
                             load_per_shard=(sum(loads),))

    if strategy == "row_wise":
        offsets, rows = _contiguous(hash_sizes, pad_mult=8)
        rows = _round_up(rows, n_shards * 8)
        per = rows // n_shards * embed_dim * itemsize
        pspec = (model_axis, None)
        shards = n_shards
        if per > hbm_budget_bytes and second_axis_size > 1:
            # one axis of shards cannot hold the rows (the paper's M3
            # regime): spread them over both axes of the mesh
            shards = n_shards * second_axis_size
            rows = _round_up(rows, shards * 8)
            per = rows // shards * embed_dim * itemsize
            pspec = ((model_axis, second_axis), None)
        return PlacementPlan(strategy, offsets, rows, None, shards,
                             bytes_per_shard=(per,) * shards,
                             load_per_shard=_rowwise_load(
                                 hash_sizes, loads, offsets, rows, shards),
                             pspec=pspec)

    if strategy == "column_wise":
        # every table's embedding dim sliced over all shards: each holds
        # the whole row space at width d / n_shards
        if embed_dim % n_shards:
            raise ValueError(
                f"column_wise needs embed_dim divisible by n_shards, got "
                f"{embed_dim} % {n_shards}; pad the dim or drop shards")
        offsets, rows = _contiguous(hash_sizes, pad_mult=8)
        per = rows * embed_dim // n_shards * itemsize
        return PlacementPlan(strategy, offsets, rows, None, n_shards,
                             bytes_per_shard=(per,) * n_shards,
                             load_per_shard=(sum(loads) / n_shards,)
                             * n_shards,
                             column_shards=(n_shards,) * len(hash_sizes),
                             pspec=(None, model_axis))

    if strategy == "table_wise":
        return _table_wise(hash_sizes, loads, embed_dim, n_shards,
                           hbm_budget_bytes, itemsize, model_axis,
                           costs=table_costs)

    if strategy == "cached_host":
        # the capacity tier holds the whole mega table (row-sharded over
        # `capacity_shards` hosts); the device tier is a hot-row cache
        # sized so payload + accumulator + LFU score fit the budget
        offsets, rows = _contiguous(hash_sizes, pad_mult=8)
        rows = _round_up(rows, max(8, capacity_shards * 8))
        shard_rows = rows // capacity_shards
        row_bytes = embed_dim * itemsize + CACHED_ROW_META_BYTES
        cache_rows = int(hbm_budget_bytes // row_bytes)
        cache_rows = max(8, min(cache_rows // 8 * 8, rows))
        per_host = cache_rows * row_bytes + (
            0 if capacity_shards == 1
            else shard_rows * embed_dim * itemsize)
        return PlacementPlan("cached_host", offsets, rows, None, n_shards,
                             bytes_per_shard=(per_host,) * n_shards,
                             load_per_shard=(sum(loads),) * n_shards,
                             cache_rows=cache_rows,
                             capacity_shards=capacity_shards,
                             shard_rows=shard_rows,
                             pspec=((None, None) if capacity_shards == 1
                                    else (second_axis, None)))

    raise ValueError(f"unknown placement strategy {strategy!r}")


def frequency_reorder(table_offsets: Sequence[int],
                      hash_sizes: Sequence[int],
                      freq: np.ndarray,
                      total_rows: int) -> tuple[np.ndarray, np.ndarray]:
    """A per-table ids-by-frequency permutation of the mega table's rows:
    each table's rows renumbered so its most-frequent ids come first (a
    stable sort, so equal counts keep their order), which puts the Zipf
    head in a contiguous prefix of every table for chunked transfers.

    freq: (total_rows,) access counts per global row. Returns (remap,
    inverse), int64 (total_rows,): remap[old] = new (apply to incoming
    ids), inverse[new] = old. Padding rows map to themselves; no row
    leaves its table, so the placement is unchanged."""
    freq = np.asarray(freq)
    if freq.shape != (total_rows,):
        raise ValueError(
            f"freq must have shape ({total_rows},), got {freq.shape}")
    remap = np.arange(total_rows, dtype=np.int64)
    for o, h in zip(table_offsets, hash_sizes):
        order = np.argsort(-freq[o:o + h], kind="stable")
        remap[o + order] = o + np.arange(h, dtype=np.int64)
    inverse = np.empty_like(remap)
    inverse[remap] = np.arange(total_rows, dtype=np.int64)
    return remap, inverse


def elastic_table_remap(old_plan: PlacementPlan, new_plan: PlacementPlan,
                        hash_sizes: Sequence[int]
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Row worklist moving a mega table between two placements of the SAME
    tables (only `table_offsets` is read): (src_rows, dst_rows), int64;
    `new[dst_rows] = old[src_rows]` (and the same for the accumulator)
    re-scatters every logical row. Padding rows are never moved."""
    if len(old_plan.table_offsets) != len(hash_sizes) or \
            len(new_plan.table_offsets) != len(hash_sizes):
        raise ValueError(
            "elastic_table_remap needs plans over the same tables: "
            f"{len(old_plan.table_offsets)} vs {len(new_plan.table_offsets)}"
            f" vs {len(hash_sizes)} tables")
    src, dst = [], []
    for t, h in enumerate(hash_sizes):
        rows = np.arange(h, dtype=np.int64)
        src.append(old_plan.table_offsets[t] + rows)
        dst.append(new_plan.table_offsets[t] + rows)
    return np.concatenate(src), np.concatenate(dst)


def _rowwise_load(hash_sizes, loads, offsets, rows, n_shards):
    """Expected lookups hitting each shard under uniform row access."""
    shard_rows = rows // n_shards
    per = np.zeros(n_shards)
    for h, ld, o in zip(hash_sizes, loads, offsets):
        lo, hi = o, o + h
        for s in range(n_shards):
            a, b = s * shard_rows, (s + 1) * shard_rows
            overlap = max(0, min(hi, b) - max(lo, a))
            if h:
                per[s] += ld * overlap / h
    return tuple(float(x) for x in per)


def _table_wise(hash_sizes, loads, embed_dim, n_shards, budget, itemsize,
                model_axis, costs=None):
    """Greedy LPT bin-packing on each table's cost (expected lookups by
    default) under a bytes limit.

    Tables go priciest first to the cheapest owner with room (ties by
    bytes), else to the owner with the fewest bytes; a table whose bytes
    exceed one budget still lands whole (row-contiguous) and is flagged in
    `column_shards` with the slice count that would fit. Every owner's
    block is padded to the largest owner's rows, so owner s holds mega rows
    [s*shard_rows, (s+1)*shard_rows) and `kernels.sparse_plan.
    split_plan_by_owner` cuts a batch plan into per-owner segments with two
    searchsorted calls."""
    n = len(hash_sizes)
    costs = list(loads) if costs is None else [float(c) for c in costs]
    if len(costs) != n:
        raise ValueError(f"{len(costs)} table costs for {n} tables")
    order = np.argsort([-c for c in costs])        # priciest table first
    shard_bytes = np.zeros(n_shards)
    shard_cost = np.zeros(n_shards)
    shard_load = np.zeros(n_shards)
    shard_tables = [[] for _ in range(n_shards)]
    shard_of = np.zeros(n, np.int32)
    col_shards = np.ones(n, np.int64)
    for t in order:
        tb = hash_sizes[t] * embed_dim * itemsize
        if budget > 0 and tb > budget:
            col_shards[t] = min(n_shards, -(-tb // int(budget)))
        cand = sorted(range(n_shards), key=lambda s: (shard_cost[s],
                                                      shard_bytes[s]))
        pick = next((s for s in cand if shard_bytes[s] + tb <= budget),
                    int(np.argmin(shard_bytes)))
        shard_of[t] = pick
        shard_bytes[pick] += tb
        shard_cost[pick] += costs[t]
        shard_load[pick] += loads[t]
        shard_tables[pick].append(t)

    rows_of = [_round_up(h, 8) for h in hash_sizes]
    shard_rows = max(sum(rows_of[t] for t in ts) for ts in shard_tables)
    shard_rows = _round_up(max(shard_rows, 8), 8)
    offsets = [0] * n
    for s, ts in enumerate(shard_tables):
        off = s * shard_rows
        for t in ts:
            offsets[t] = off
            off += rows_of[t]
    return PlacementPlan("table_wise", tuple(offsets),
                         shard_rows * n_shards,
                         tuple(int(x) for x in shard_of), n_shards,
                         bytes_per_shard=tuple(int(x) for x in shard_bytes),
                         load_per_shard=tuple(float(x) for x in shard_load),
                         capacity_shards=n_shards,
                         shard_rows=shard_rows,
                         column_shards=tuple(int(x) for x in col_shards),
                         pspec=(model_axis, None))
