"""PlacementPlan: where each embedding table's rows live.

All tables are laid out in one row-concatenated MEGA TABLE (rows, d); the
plan fixes each table's row offset, and the planning of each strategy here
is the reference's (`repro.core.placement`), integers and loads alike:

  replicated   the whole mega table on one device
  table_wise   whole tables bin-packed onto owners (greedy LPT on expected
               lookups under a byte limit); owner s holds the contiguous
               rows [s*shard_rows, (s+1)*shard_rows) — the paper's Zion /
               Big Basin placement; `train.steps.build_tablewise_train_step`
               trains it on one device with one segmented update
  row_wise     rows striped over shards regardless of table boundaries
               (what `auto` gives full-width dlrm-m1 at one shard: the
               replicated layout)
  cached_host  the mega table in a capacity tier, a `cache_rows`-slot hot
               cache on the device sized from the HBM budget
               (core/cache.py)

The reference's `pspec` field has no counterpart: nothing is sharded on
one device, and the multi-device executors that would read a sharding
come with that slice. So do the reference's options that only those
executors use: `column_wise` (raises here), row_wise's
`second_axis_size`, cached_host's row-sharded capacity tier
(`capacity_shards`) and table_wise's `table_costs` pricing; and
`frequency_reorder` (the hooks' `row_remap`) and `elastic_table_remap`
(fault tolerance's elastic repack) come with the slices that use them.
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
    (cached_host) the device-cache size. The reference's fields, less
    `pspec`."""

    strategy: str   # replicated|table_wise|row_wise|cached_host
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
    # (s+1)*shard_rows)) and rows per owner; cached_host: 1 and total_rows
    capacity_shards: int = 1
    shard_rows: int = 0
    # table_wise only: per table, the count of embedding-dim slices an
    # executor should use — 1 for a table that fits its owner's budget,
    # k > 1 for one whose bytes exceed a shard's; the layout stays
    # full-width
    column_shards: tuple[int, ...] = ()

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
                   strategy: str = "auto") -> PlacementPlan:
    """Build a placement plan for one EmbeddingBagCollection.

    `hbm_budget_bytes` is the per-shard capacity available for embeddings.
    `auto` resolves as in the reference: replicated if everything fits one
    budget, table_wise if it fits `n_shards` budgets with the largest table
    inside one, else row_wise (so a full-width dlrm-m1 at `n_shards=1`
    plans a one-shard row_wise layout, identical to the replicated one).
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
        return PlacementPlan(strategy, offsets, rows, None, n_shards,
                             bytes_per_shard=(per,) * n_shards,
                             load_per_shard=_rowwise_load(
                                 hash_sizes, loads, offsets, rows, n_shards))

    if strategy == "column_wise":
        raise NotImplementedError(
            "column_wise placement (the embedding dim sliced over shards) "
            "comes with the multi-device slice, with the executor that "
            "slices it")

    if strategy == "table_wise":
        return _table_wise(hash_sizes, loads, embed_dim, n_shards,
                           hbm_budget_bytes, itemsize)

    if strategy == "cached_host":
        # the capacity tier holds the whole mega table; the device tier is
        # a hot-row cache sized so payload + accumulator + LFU score fit
        # the budget
        offsets, rows = _contiguous(hash_sizes, pad_mult=8)
        row_bytes = embed_dim * itemsize + CACHED_ROW_META_BYTES
        cache_rows = int(hbm_budget_bytes // row_bytes)
        cache_rows = max(8, min(cache_rows // 8 * 8, rows))
        return PlacementPlan("cached_host", offsets, rows, None, n_shards,
                             bytes_per_shard=(cache_rows * row_bytes,)
                             * n_shards,
                             load_per_shard=(sum(loads),) * n_shards,
                             cache_rows=cache_rows, shard_rows=rows)

    raise ValueError(f"unknown placement strategy {strategy!r}")


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


def _table_wise(hash_sizes, loads, embed_dim, n_shards, budget, itemsize):
    """Greedy LPT bin-packing on expected lookups under a bytes limit.

    Tables go busiest first to the least-loaded owner with room (ties by
    bytes), else to the owner with the fewest bytes; a table whose bytes
    exceed one budget still lands whole (row-contiguous) and is flagged in
    `column_shards` with the slice count that would fit. Every owner's
    block is padded to the largest owner's rows, so owner s holds mega rows
    [s*shard_rows, (s+1)*shard_rows) and `kernels.sparse_plan.
    split_plan_by_owner` cuts a batch plan into per-owner segments with two
    searchsorted calls."""
    n = len(hash_sizes)
    order = np.argsort([-ld for ld in loads])      # busiest table first
    shard_bytes = np.zeros(n_shards)
    shard_load = np.zeros(n_shards)
    shard_tables = [[] for _ in range(n_shards)]
    shard_of = np.zeros(n, np.int32)
    col_shards = np.ones(n, np.int64)
    for t in order:
        tb = hash_sizes[t] * embed_dim * itemsize
        if budget > 0 and tb > budget:
            col_shards[t] = min(n_shards, -(-tb // int(budget)))
        cand = sorted(range(n_shards), key=lambda s: (shard_load[s],
                                                      shard_bytes[s]))
        pick = next((s for s in cand if shard_bytes[s] + tb <= budget),
                    int(np.argmin(shard_bytes)))
        shard_of[t] = pick
        shard_bytes[pick] += tb
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
                         column_shards=tuple(int(x) for x in col_shards))
