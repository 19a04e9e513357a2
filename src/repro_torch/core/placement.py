"""PlacementPlan: where each embedding table's rows live.

All tables are laid out in one row-concatenated MEGA TABLE (rows, d); the
plan fixes each table's row offset and, for `cached_host`, the size of the
device cache in front of the capacity tier. This slice ports the two
single-device strategies the serving path uses:

  replicated   the whole mega table on the device
  cached_host  the mega table in a capacity tier, a `cache_rows`-slot hot
               cache on the device sized from the HBM budget (core/cache.py)

The sharded strategies (table_wise, row_wise, column_wise, and a row-
sharded capacity tier) come with the multi-device slice.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

#: device-side bytes per CACHED row beyond the payload: the row-wise
#: AdaGrad accumulator (fp32) + the LFU frequency score (fp32)
CACHED_ROW_META_BYTES = 8


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """The fused mega-table layout and (cached_host) the device-cache size.

    The reference's `pspec` field has no counterpart: nothing is sharded
    on one device."""

    strategy: str                    # replicated|cached_host
    table_offsets: tuple[int, ...]   # row offset of each table in the mega table
    total_rows: int                  # padded row count of the mega table
    n_shards: int
    bytes_per_shard: tuple[int, ...] = ()
    cache_rows: int = 0              # cached_host only: device-cache slots


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

    `hbm_budget_bytes` is the per-device capacity available for embeddings.
    `mean_lookups` keeps the reference's signature: it prices the sharded
    strategies, which this slice does not plan.
    `auto` resolves as in the reference; a resolution to a sharded strategy
    raises NotImplementedError, as does any sharded strategy by name.
    """
    hash_sizes = [int(h) for h in hash_sizes]
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
        return PlacementPlan(strategy, offsets, rows, n_shards,
                             bytes_per_shard=(total_bytes,))

    if strategy == "cached_host":
        offsets, rows = _contiguous(hash_sizes, pad_mult=8)
        rows = _round_up(rows, 8)
        row_bytes = embed_dim * itemsize + CACHED_ROW_META_BYTES
        cache_rows = int(hbm_budget_bytes // row_bytes)
        cache_rows = max(8, min(cache_rows // 8 * 8, rows))
        return PlacementPlan("cached_host", offsets, rows, n_shards,
                             bytes_per_shard=(cache_rows * row_bytes,)
                             * n_shards,
                             cache_rows=cache_rows)

    if strategy in ("table_wise", "row_wise", "column_wise"):
        raise NotImplementedError(
            f"placement strategy {strategy!r} shards the mega table and "
            "comes with the multi-device slice; this slice ports "
            "'replicated' and 'cached_host'")
    raise ValueError(f"unknown placement strategy {strategy!r}")
