"""Analytic traffic models of the port's placements.

Ported from `repro.launch.analysis`: the table-wise pooled exchange,
which `train.steps.build_tablewise_train_step`'s metrics must equal, and
the cached tiers' transfer models (`cache_admission_traffic`, the
capacity->cache fetch leg; `tier_hierarchy_traffic`, the HBM -> DRAM ->
bulk hierarchy of `core.tiers`; `multihost_exchange_traffic`, the
multi-host tier's three all-to-all legs), which a run's `TierCacheStats`
and `RouteStats` are read beside. The reference's compiled-program analyzers, its other traffic
models and `recommend_placement` come with the port's `launch/` slice.
"""
from __future__ import annotations

import math


def tablewise_exchange_traffic(batch: int, n_features: int, truncation: int,
                               embed_dim: int, n_hosts: int,
                               itemsize: int = 4,
                               features_per_owner=None) -> dict[str, float]:
    """Cross-owner bytes per step of the TABLE-WISE placement: whole tables
    live on owners and only the POOLED (B, F, d) activations cross —
    pooled outputs forward, pooled bag gradients back, each with a remote
    fraction of (H-1)/H. Per-lookup rows never move, so the exchange does
    not depend on the bag length L or the batch's unique rows:

        fwd = bwd = (H-1)/H * B * F * d * itemsize.

    The per-(host, owner) pair leg carries only the owner's own tables for
    the destination's batch slice: ceil(B/H) * max_t F_t * d * itemsize,
    with max_t F_t from `features_per_owner` (a bincount of the plan's
    owners) or the uniform ceil(F/H). `rowshard_bytes` is the row-sharded
    naive gather, which ships the un-pooled (B, F, L, d) rows both ways;
    `pooling_reduction` = rowshard / total."""
    remote = (n_hosts - 1) / max(n_hosts, 1)
    act_bytes = float(embed_dim * itemsize)
    fwd = remote * batch * n_features * act_bytes
    if features_per_owner is not None and len(features_per_owner):
        max_f = max(int(f) for f in features_per_owner)
    else:
        max_f = -(-n_features // max(n_hosts, 1))
    pair_leg = -(-batch // max(n_hosts, 1)) * max_f * act_bytes
    pairs = float(batch * n_features * truncation)
    rowshard = 2.0 * pairs * remote * act_bytes
    total = 2.0 * fwd
    return {"fwd_bytes": fwd,
            "bwd_bytes": fwd,
            "total_bytes": total,
            "pair_leg_bytes": pair_leg,
            "rowshard_bytes": rowshard,
            "pooling_reduction": rowshard / total if total else 1.0}


def multihost_exchange_traffic(batch: int, n_features: int, truncation: int,
                               embed_dim: int, n_hosts: int,
                               unique_per_host: float, unique_global: float,
                               hit_rate: float, itemsize: int = 4,
                               index_itemsize: int = 4) -> dict[str, float]:
    """Cross-host bytes per step of the multi-host cached tier
    (`core.cache.MultiHostCachedEmbeddingBagCollection`) under a uniform
    row -> owner map (a remote fraction of (H-1)/H):

      fetch    each host's misses leave the owning shards:
               H * U_h * (1 - hit_rate) rows (payload + index);
      grads    each (row, bag) pair whose bag gradient must reach a remote
               owner: B*F*L pairs (per-bag routing keeps the owner's
               reduction in flat-batch order, so bit-exact); a per-(host,
               row) partial-sum variant would ship H*U_h rows instead
               (`grad_rowsum_bytes`);
      refresh  every working-set row returns post-update: H * U_h rows.

    The baseline ships per-lookup gradients and rows for the whole batch
    slice, 2 * B*F*L * (H-1)/H * D * itemsize, with no dedup and no cache.
    `dup_rows` = H * U_h - U_g rows are reduced once at the owner. Returns
    each leg's bytes, `total_bytes`, the baseline and `reduction` =
    baseline / total; H = 1 gives zero cross-host bytes (and the baseline
    itself as the reduction)."""
    remote = (n_hosts - 1) / n_hosts
    row_bytes = embed_dim * itemsize
    pairs = float(batch * n_features * truncation)
    fetch_bytes = (n_hosts * unique_per_host * (1.0 - hit_rate)
                   * remote * (row_bytes + index_itemsize))
    grad_bytes = pairs * remote * (row_bytes + index_itemsize)
    grad_rowsum_bytes = (n_hosts * unique_per_host * remote
                         * (row_bytes + index_itemsize))
    refresh_bytes = n_hosts * unique_per_host * remote * row_bytes
    total = fetch_bytes + grad_bytes + refresh_bytes
    rowsum_total = fetch_bytes + grad_rowsum_bytes + refresh_bytes
    baseline = 2.0 * pairs * remote * row_bytes
    return {"fetch_bytes": fetch_bytes,
            "grad_bytes": grad_bytes,
            "grad_rowsum_bytes": grad_rowsum_bytes,
            "refresh_bytes": refresh_bytes,
            "total_bytes": total,
            "rowsum_total_bytes": rowsum_total,
            "baseline_bytes": baseline,
            "dup_rows": n_hosts * unique_per_host - unique_global,
            "reduction": baseline / total if total else baseline,
            "rowsum_reduction": (baseline / rowsum_total if n_hosts > 1
                                 else baseline)}


def cache_admission_traffic(fetched_rows: float, embed_dim: int,
                            fetch_chunks: float = 0.0,
                            overfetch_rows: float = 0.0,
                            itemsize: int = 4,
                            accum_itemsize: int = 4,
                            descriptor_bytes: int = 32) -> dict[str, float]:
    """Capacity->cache transfer bytes of the cached tier's admission path.

    Every admitted row moves `row_bytes` of payload (the fp32 row plus its
    row-wise AdaGrad accumulator) and each transfer descriptor costs
    `descriptor_bytes`. Single-row transfers issue one descriptor a row;
    chunked ones one a block (`fetch_chunks`, the `cache_fetch_chunks`
    stat) but over-fetch `overfetch_rows` of padding. `fetch_chunks=0`
    means the single-row path. Returns both shapes' bytes for the given
    miss stream and `chunked_vs_single`, their ratio (< 1: chunks win)."""
    row_bytes = float(embed_dim * itemsize + accum_itemsize)
    single_bytes = fetched_rows * (row_bytes + descriptor_bytes)
    n_desc = fetch_chunks if fetch_chunks > 0 else fetched_rows
    chunked_bytes = ((fetched_rows + overfetch_rows) * row_bytes
                     + n_desc * descriptor_bytes)
    return {"row_bytes": row_bytes,
            "payload_bytes": fetched_rows * row_bytes,
            "single_row_bytes": single_bytes,
            "chunked_bytes": chunked_bytes,
            "descriptors": n_desc,
            "chunked_vs_single": (chunked_bytes / single_bytes
                                  if single_bytes else 1.0)}


def tier_hierarchy_traffic(fetched_rows: float, embed_dim: int,
                           dram_hit_rate: float,
                           bulk_chunk: int = 32,
                           bulk_latency_us: float = 50.0,
                           chunk_density: float = 1.0,
                           demotion_rows: float | None = None,
                           dram_latency_us: float = 0.5,
                           itemsize: int = 4, accum_itemsize: int = 4,
                           descriptor_bytes: int = 32) -> dict[str, float]:
    """Bytes and latency of the HBM -> DRAM -> bulk hierarchy.

    The `fetched_rows` that reach the capacity level split by
    `dram_hit_rate` (`TierCacheStats.dram_hit_rate`): the DRAM share pays
    one descriptor plus payload at `dram_latency_us` a row; the bulk share
    promotes through `ceil(rows / (bulk_chunk * chunk_density))` blocks,
    each moving a full `bulk_chunk`-row block and costing
    `bulk_latency_us`. In steady state every promotion displaces one DRAM
    row, so demotions write the same block traffic back unless
    `demotion_rows` says otherwise. Returns each leg's bytes and
    microseconds, `total_latency_us` (what a fully synchronous schedule
    would stall) and `bulk_vs_dram`, the hierarchy's latency over an
    all-DRAM capacity tier's."""
    row_bytes = float(embed_dim * itemsize + accum_itemsize)
    dram_rows = fetched_rows * min(max(dram_hit_rate, 0.0), 1.0)
    bulk_rows = max(fetched_rows - dram_rows, 0.0)
    density = min(max(chunk_density, 1e-9), 1.0)
    rows_per_block = max(float(bulk_chunk) * density, 1e-9)
    read_blocks = math.ceil(bulk_rows / rows_per_block) if bulk_rows else 0
    demote = bulk_rows if demotion_rows is None else float(demotion_rows)
    write_blocks = math.ceil(demote / rows_per_block) if demote else 0
    block_bytes = float(bulk_chunk) * row_bytes + descriptor_bytes
    dram_bytes = dram_rows * (row_bytes + descriptor_bytes)
    bulk_read_bytes = read_blocks * block_bytes
    bulk_write_bytes = write_blocks * block_bytes
    dram_us = dram_rows * dram_latency_us
    bulk_us = (read_blocks + write_blocks) * bulk_latency_us
    all_dram_us = fetched_rows * dram_latency_us
    total_us = dram_us + bulk_us
    return {"row_bytes": row_bytes,
            "dram_rows": dram_rows,
            "bulk_rows": bulk_rows,
            "demotion_rows": demote,
            "bulk_read_blocks": float(read_blocks),
            "bulk_write_blocks": float(write_blocks),
            "dram_bytes": dram_bytes,
            "bulk_read_bytes": bulk_read_bytes,
            "bulk_write_bytes": bulk_write_bytes,
            "total_bytes": dram_bytes + bulk_read_bytes + bulk_write_bytes,
            "dram_latency_us": dram_us,
            "bulk_latency_us": bulk_us,
            "total_latency_us": total_us,
            "bulk_vs_dram": (total_us / all_dram_us
                             if all_dram_us > 0 else 1.0)}
