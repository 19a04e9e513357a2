"""Analytic traffic models of the port's placements and paths.

Ported from `repro.launch.analysis`, each keeping the reference's
operands in the reference's order, so that its floats come out equal:

  sparse_backward_traffic     intermediate bytes of the legacy (per-lookup
                              gradients, two-pass update) against the fused
                              sparse backward;
  embedding_forward_traffic   the forward's bytes, per-slot gather against
                              the plan-driven dedup gather, with
                              `zipf_expected_unique` the deterministic
                              unique-row count of a bounded-Zipf stream;
  multihost_exchange_traffic  the multi-host cached tier's three
                              all-to-all legs;
  cache_admission_traffic     the capacity->cache fetch leg;
  tier_hierarchy_traffic      the HBM -> DRAM -> bulk hierarchy of
                              `core.tiers`;
  serve_replay_traffic        the read-only serving path's capacity bytes;
  tablewise_exchange_traffic  the table-wise pooled exchange, which
                              `train.steps.build_tablewise_train_step`'s
                              metrics must equal;
  recommend_placement         the models composed into a per-table
                              placement pick (and, with a DRAM budget, a
                              DRAM/bulk tiering of the capacity level).

A run's `TierCacheStats` and `RouteStats` are read beside them.

The reference's compiled-program analyzers parse XLA's program text; the
port has no such text, so their counterparts count a step while it runs
on the meta device (`launch.dryrun`): `StepAnalysis`, a dispatch mode, for
`StableHloAnalysis` (its `OpCost` fields op by op, the meta kernels'
booked costs, and the peak of live bytes), and `CollectiveAnalysis`, over
a `launch.mesh.DryMesh`'s log of the step, for the reference's analysis
of the partitioned program's collectives.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import meta as kmeta

def sparse_backward_traffic(batch: int, n_features: int, truncation: int,
                            embed_dim: int, itemsize: int = 4,
                            index_itemsize: int = 4) -> dict[str, float]:
    """Bytes of the INTERMEDIATE tensors each sparse-backward path
    materializes between the pooled (B, F, D) gradients and the row-wise
    AdaGrad update, counted once each.

    legacy (per-lookup gradients, dedup, two-pass update): the (B*F*L, D)
      per-lookup broadcast, its sorted copy inside the dedup and the
      deduplicated (B*F*L, D) gsum operand of the two-pass kernel;
    fused (sparse plan + fused_bag_backward_adagrad): the int32 plan only,
      unique_rows (N,), bag_offsets (N+1,) and bag_ids (N,); the kernel
      reads the pooled bag gradients straight from autograd's output.

    Returns legacy_bytes, fused_bytes and their ratio ("reduction") ~= D."""
    n = batch * n_features * truncation
    legacy = 3.0 * n * embed_dim * itemsize
    fused = (2.0 * n + n + 1.0) * index_itemsize
    return {"legacy_bytes": legacy, "fused_bytes": fused,
            "reduction": legacy / fused}


def embedding_forward_traffic(batch: int, n_features: int, truncation: int,
                              embed_dim: int, n_unique: float,
                              itemsize: int = 4, index_itemsize: int = 4,
                              plan_shared: bool = True) -> dict[str, float]:
    """Bytes the legacy vs dedup'd embedding FORWARD moves between the mega
    table and the pooled (B, F, D) bags, counted as
    `sparse_backward_traffic` counts (tensors that cross op/kernel
    boundaries, once each per step).

    legacy (per-slot gather, `lookup` without a plan / embedding_bag):
      one row read per lookup slot, pads included (B*F*L row reads), and
      three full-width (B*F*L, D) per-slot tensors on the plain path: the
      gather result, its masked fp32 copy and the pooling's re-read;
    dedup (plan-driven gather, `lookup(plan=...)` / dedup_embedding_bag):
      each of `n_unique` plan rows read once, plus the int32 CSR plan when
      `plan_shared=False` (shared, the backward's model already charges
      its (3N+1) index bytes).

    `n_unique` is the batch's unique-row count (or its static plan
    capacity): measure it, or take `zipf_expected_unique`. Returns the
    legacy/dedup bytes and row reads with their ratios."""
    n = batch * n_features * truncation
    legacy = 3.0 * n * embed_dim * itemsize
    plan_bytes = 0.0 if plan_shared else (3.0 * n + 1.0) * index_itemsize
    dedup = n_unique * embed_dim * itemsize + plan_bytes
    return {"legacy_bytes": legacy, "dedup_bytes": dedup,
            "reduction": legacy / dedup,
            "legacy_row_reads": float(n),
            "dedup_row_reads": float(n_unique),
            "row_read_reduction": n / n_unique}


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


def zipf_expected_unique(n_draws: float, hash_size: int,
                         alpha: float = 1.05,
                         chunk: int = 1_000_000) -> float:
    """Expected number of DISTINCT rows among `n_draws` i.i.d. draws from
    the bounded Zipf(alpha) over [0, hash_size) (the
    `data.synthetic.bounded_zipf_rows` distribution):

        E[unique] = sum_r 1 - (1 - p_r)^n,   p_r ∝ (r+1)^-alpha.

    Exact chunked float64 sum: deterministic (no sampling), O(hash_size)."""
    import numpy as np  # local: this module otherwise imports stdlib only
    h = int(hash_size)
    norm = 0.0
    for lo in range(1, h + 1, chunk):
        r = np.arange(lo, min(lo + chunk, h + 1), dtype=np.float64)
        norm += float((r ** -alpha).sum())
    total = 0.0
    for lo in range(1, h + 1, chunk):
        r = np.arange(lo, min(lo + chunk, h + 1), dtype=np.float64)
        p = (r ** -alpha) / norm
        # 1-(1-p)^n via expm1/log1p: stable for the tiny tail probabilities
        total += float((-np.expm1(n_draws * np.log1p(-p))).sum())
    return total


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


def serve_replay_traffic(requests: float, examples: int, n_features: int,
                         truncation: int, embed_dim: int, hit_rate: float,
                         shed_rate: float = 0.0,
                         degraded_fraction: float = 0.0,
                         itemsize: int = 4, accum_itemsize: int = 4,
                         descriptor_bytes: int = 32) -> dict[str, float]:
    """Capacity-tier bytes of the SERVING path for a traffic replay
    (`serve.dlrm_engine`), the read-only mirror of
    `cache_admission_traffic`: shed requests (`shed_rate`) never touch the
    capacity tier, degraded batches (`degraded_fraction`) resolve their
    misses from the stale host snapshot, and there is no writeback leg.
    Each surviving unique miss moves the fp32 row, its accumulator and one
    descriptor. `hit_rate` is 1 - unique_misses / accesses
    (`CacheStats.hit_rate`). Returns the cached fetch bytes, the uncached
    bytes (every access pulls a full row) and `uncached_vs_cached`, their
    ratio."""
    served = requests * (1.0 - shed_rate)
    accesses = served * examples * n_features * truncation
    row_bytes = float(embed_dim * itemsize + accum_itemsize)
    fetched = accesses * (1.0 - hit_rate) * (1.0 - degraded_fraction)
    fetch_bytes = fetched * (row_bytes + descriptor_bytes)
    uncached_bytes = accesses * embed_dim * itemsize
    return {"accesses": accesses,
            "fetched_rows": fetched,
            "fetch_bytes": fetch_bytes,
            "writeback_bytes": 0.0,
            "uncached_bytes": uncached_bytes,
            "uncached_vs_cached": (uncached_bytes / fetch_bytes
                                   if fetch_bytes else float("inf"))}


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


def recommend_placement(hash_sizes, mean_lookups, embed_dim: int,
                        batch: int, truncation: int, n_hosts: int,
                        hbm_budget_bytes: float, alpha: float = 1.05,
                        hit_rate: float = 0.0,
                        itemsize: int = 4,
                        dram_budget_bytes: float = 0.0,
                        bulk_chunk: int = 32,
                        bulk_latency_us: float = 50.0) -> dict:
    """Compose the traffic models into a per-table placement pick: place by
    priced bytes, not by hand.

    Prices three strategies for a (batch, truncation) step over Zipf(alpha)
    traffic:
      replicated   every host holds every table, no exchange; only when
                   the whole collection (rows and accumulators) fits one
                   host's budget;
      table_wise   the pooled all-to-all (`tablewise_exchange_traffic`),
                   owners from `core.placement.plan_placement` bin-packing
                   each table's priced cost (its pooled legs plus its
                   expected unique-row update footprint); a table larger
                   than one budget becomes column_wise with
                   ceil(bytes / budget) D-slices;
      cached_host  the row-sharded cached tier
                   (`multihost_exchange_traffic`), unique counts from
                   `zipf_expected_unique`, misses discounted by
                   `hit_rate`.

    A positive `dram_budget_bytes` also tiers the capacity level: tables
    fill host DRAM greedily by heat density (expected unique rows per
    byte) and the overflow goes to the bulk tier; each per-table entry
    then carries `"tier": "dram" | "bulk"` and the result a `"tiering"`
    dict with the split and its `tier_hierarchy_traffic` pricing.

    Returns {"pick", "fits_one_host", "tablewise", "rowshard",
    "per_table": [{"table", "strategy", "owner", "column_shards",
    "bytes", "cost", "tier"}], "plan", "tiering"}; `plan` is the
    PlacementPlan behind the table_wise pricing. Tables of one hash size
    and bag length share their Zipf sums, which are computed once."""
    import numpy as np  # local: this module otherwise imports stdlib only

    from repro_torch.core.placement import plan_placement
    uniques: dict = {}

    def unique(n_draws, h):
        if (n_draws, h) not in uniques:
            uniques[n_draws, h] = zipf_expected_unique(n_draws, h, alpha)
        return uniques[n_draws, h]

    hh = [int(h) for h in hash_sizes]
    n_f = len(hh)
    lk = [min(float(length), float(truncation)) for length in mean_lookups]
    row_bytes = float(embed_dim * itemsize)
    # params + the row-wise AdaGrad accumulator both occupy the owner
    table_bytes = [h * row_bytes + h * 4.0 for h in hh]
    fits = (hbm_budget_bytes <= 0
            or sum(table_bytes) <= float(hbm_budget_bytes))
    uniq_t = [unique(batch * lk[t], hh[t]) for t in range(n_f)]
    # priced cost per table: its share of the pooled legs (uniform: the
    # pooled payload does not depend on the table) + its owner-side update
    # footprint; the bin-pack balances the sum across owners
    remote = (n_hosts - 1) / max(n_hosts, 1)
    pooled_leg = 2.0 * remote * batch * row_bytes
    costs = [pooled_leg + uniq_t[t] * row_bytes for t in range(n_f)]
    plan = plan_placement(hh, mean_lookups, embed_dim, n_hosts,
                          hbm_budget_bytes, strategy="table_wise",
                          itemsize=itemsize, table_costs=costs)
    owners = [int(o // max(plan.shard_rows, 1))
              for o in plan.table_offsets]
    f_per_owner = np.bincount(np.asarray(owners), minlength=n_hosts)
    tw = tablewise_exchange_traffic(batch, n_f, truncation, embed_dim,
                                    n_hosts, itemsize,
                                    features_per_owner=f_per_owner)
    u_g = float(sum(uniq_t))
    u_h = float(sum(unique(batch / max(n_hosts, 1) * lk[t], hh[t])
                    for t in range(n_f)))
    mean_lk = sum(lk) / max(n_f, 1)
    rs = multihost_exchange_traffic(batch, n_f, mean_lk, embed_dim,
                                    n_hosts, u_h, u_g, hit_rate, itemsize)
    if fits:
        pick = "replicated"
    elif tw["total_bytes"] <= rs["total_bytes"]:
        pick = "table_wise"
    else:
        pick = "cached_host"
    per_table = []
    for t in range(n_f):
        cs = int(plan.column_shards[t]) if plan.column_shards else 1
        strategy = ("replicated" if fits
                    else "column_wise" if cs > 1 else "table_wise")
        per_table.append({"table": t, "strategy": strategy,
                          "owner": owners[t], "column_shards": cs,
                          "bytes": table_bytes[t], "cost": costs[t],
                          "tier": "dram"})
    tiering = None
    if dram_budget_bytes > 0:
        # greedy DRAM fill by heat density (expected unique rows touched
        # per byte held): the hottest bytes stay a DRAM hit, the coldest
        # tables page through the bulk tier
        order = sorted(range(n_f),
                       key=lambda t: -(uniq_t[t] / max(table_bytes[t], 1.0)))
        spent, dram_tables, bulk_tables = 0.0, [], []
        for t in order:
            if spent + table_bytes[t] <= float(dram_budget_bytes):
                spent += table_bytes[t]
                dram_tables.append(t)
            else:
                per_table[t]["tier"] = "bulk"
                bulk_tables.append(t)
        fetched = u_g * (1.0 - min(max(hit_rate, 0.0), 1.0))
        uniq_dram = sum(uniq_t[t] for t in dram_tables)
        dram_hit = uniq_dram / u_g if u_g > 0 else 1.0
        tiering = {"dram_tables": sorted(dram_tables),
                   "bulk_tables": sorted(bulk_tables),
                   "dram_bytes": spent,
                   "bulk_bytes": sum(table_bytes[t] for t in bulk_tables),
                   "dram_hit_rate": dram_hit,
                   "traffic": tier_hierarchy_traffic(
                       fetched, embed_dim, dram_hit, bulk_chunk=bulk_chunk,
                       bulk_latency_us=bulk_latency_us, itemsize=itemsize)}
    return {"pick": pick, "fits_one_host": fits, "tablewise": tw,
            "rowshard": rs, "per_table": per_table, "plan": plan,
            "tiering": tiering}

# ---------------------------------------------------------------------------
# a step's cost on the meta device (the counterpart of StableHloAnalysis)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OpCost:
    """The reference's cost fields: product FLOPs (`mxu_flops`, 2·m·n·k),
    elementwise FLOPs (one an output element), the bytes of products,
    gathers, scatters and index ops (`major_bytes`), the products' count,
    and the gathers' and scatters' share of the bytes."""
    mxu_flops: float = 0.0
    vpu_flops: float = 0.0
    major_bytes: float = 0.0
    dot_count: int = 0
    gather_bytes: float = 0.0
    scatter_bytes: float = 0.0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def _tensors(tree) -> list:
    """The tensors of a tree of dicts (their subclasses too: `models.lm.
    Caches`), lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for v in tree for t in _tensors(v)]


_A = torch.ops.aten
#: products whose first operand is an addend (bias), not a factor
_ADD_PRODUCTS = (_A.addmm, _A.baddbmm)
#: reads of rows by index: 2 x the result's bytes (read the slice, write it)
_GATHERS = (_A.index, _A.gather, _A.index_select, _A.embedding, _A.take)
#: writes of rows by index, and the position of their update operand:
#: 3 x the update's bytes (read and write the rows, read the update)
_SCATTERS = {_A.index_put: 2, _A.index_put_: 2, _A._index_put_impl_: 2,
             _A.scatter: 3, _A.scatter_: 3, _A.scatter_add: 3,
             _A.scatter_add_: 3, _A.scatter_reduce: 3, _A.scatter_reduce_: 3,
             _A.index_add: 3, _A.index_add_: 3, _A.index_copy: 3,
             _A.index_copy_: 3}
#: writes of a window: 2 x the update's bytes
_UPDATES = {_A.slice_scatter: 1, _A.select_scatter: 1, _A.copy_: 1}
#: reads of everything, writes of the result: operands' + results' bytes
_SORTS = (_A.sort, _A.cumsum, _A.topk, _A.argsort)
#: the out-of-place scatters PyTorch's backward formulas take under a
#: dispatch mode in place of their in-place variants (gather's,
#: indexing's, index_select's and masked_select's gradients)
_FOLDED = (_A.scatter_add, _A.index_put, _A.index_add, _A.masked_scatter)


class StepAnalysis(TorchDispatchMode):
    """A step's cost and memory, counted op by op while it runs on the
    meta device (the counterpart of the reference's `StableHloAnalysis`
    over a lowered program; use it as a context manager around the step):

      products   FLOPs by `torch.utils.flop_counter`'s formulas (mm,
                 bmm, addmm, ...: 2·m·n·k), the operands' and result's
                 bytes;
      pointwise  one FLOP an output element (`vpu_flops`);
      index ops  bytes as the reference's `_MAJOR_BYTES_OPS` counts them:
                 a gather 2x its result, a scatter 3x its update, a
                 window write 2x its update, arange its result, a sort or
                 reduction its operands and results;
      kernels    each meta kernel call's booked cost (`kernels.meta`):
                 flash attention and dot interaction as products,
                 embedding_bag as pointwise FLOPs and gathered bytes, all
                 in `kernels` by name.

    Everything is scaled by the cut loops' weights (`kernels.meta.
    weighted`). With `memory`, it also tracks the live bytes of every
    storage the step allocates, beside the ones registered with `track`
    (parameters, optimizer state, inputs): `peak_bytes`, and `memory()`
    splits the peak by kind. Under any dispatch mode PyTorch's backward
    formulas take the out-of-place branch meant for tensor subclasses
    (`isTensorSubclassLike`): gather's gradient is zeros.scatter_add(...)
    where a run without the mode scatters into the zeros in place. So a
    backward scatter (`_FOLDED`) whose target the op just before made
    counts as that target, not beside it: at 19a's rank the loss's
    gather gradient would otherwise add a second 1.64 GB buffer."""

    def __init__(self, memory: bool = True):
        super().__init__()
        self.cost = OpCost()
        #: product FLOPs with every cut loop counted once (its trips run)
        self.unscaled_mxu_flops = 0.0
        self.kernels: dict[str, dict[str, float]] = {}
        self.track_memory = memory
        self.peak_bytes = 0
        self._live = 0
        self._event = 0
        self._peak_event = -1
        self._records: list[list] = []
        self._alive: dict[int, list] = {}
        self._task_end: dict[int, int] = {}
        self._task = -1
        self._booking = None

    # -- the context --------------------------------------------------------

    def __enter__(self):
        self._booking = kmeta.booking(self._kernel)
        self._booking.__enter__()
        self._saving = torch.autograd.graph.saved_tensors_hooks(
            self._saved, lambda t: t)
        self._saving.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._saving.__exit__(*exc)
            self._booking.__exit__(*exc)

    def _saved(self, t):
        """A tensor autograd saves for the backward: its storage is an
        activation."""
        rec = self._alive.get(t.untyped_storage()._cdata)
        if rec is not None and rec[1] in ("forward", "other"):
            rec[1] = "saved"
        return t

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fold = self._fold_target(func, args) if self.track_memory else None
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out, kmeta.weight())
        if self.track_memory:
            self._note(out, fold)
        return out

    # -- cost ----------------------------------------------------------------

    def _count(self, func, args, kwargs, out, w: int) -> None:
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            mats = args[1:3] if packet in _ADD_PRODUCTS else args
            self.cost.mxu_flops += flops * w
            self.unscaled_mxu_flops += flops
            self.cost.major_bytes += (sum(map(_nbytes, mats))
                                      + _nbytes(out)) * w
            self.cost.dot_count += w
            return
        if torch.Tag.pointwise in func.tags:
            self.cost.vpu_flops += sum(t.numel() for t in _tensors(out)) * w
            return
        if packet in _GATHERS:
            b = 2.0 * sum(map(_nbytes, _tensors(out)))
            self.cost.gather_bytes += b * w
        elif packet in _SCATTERS:
            i = _SCATTERS[packet]
            upd = args[i] if len(args) > i and isinstance(
                args[i], torch.Tensor) else args[2]
            b = 3.0 * _nbytes(upd)
            self.cost.scatter_bytes += b * w
        elif packet in _UPDATES:
            b = 2.0 * _nbytes(args[_UPDATES[packet]])
        elif packet is _A.arange:
            b = float(sum(map(_nbytes, _tensors(out))))
        elif packet in _SORTS or torch.Tag.reduction in func.tags:
            b = float(sum(map(_nbytes, _tensors((args, kwargs))))
                      + sum(map(_nbytes, _tensors(out))))
        else:
            return
        self.cost.major_bytes += b * w

    def _kernel(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += kmeta.weight()
        k["flops"] += flops
        k["bytes"] += nbytes
        if name == "embedding_bag":
            self.cost.vpu_flops += flops
            self.cost.gather_bytes += nbytes
            self.cost.major_bytes += nbytes
        else:
            self.cost.mxu_flops += flops
            self.unscaled_mxu_flops += flops / kmeta.weight()
            self.cost.major_bytes += nbytes
            self.cost.dot_count += kmeta.weight()

    # -- memory --------------------------------------------------------------

    def track(self, tree, kind: str, nbytes=None) -> None:
        """Register the storages of a tree's tensors, made before the
        step, as live and of `kind` ("parameters", "optimizer_state",
        "inputs"); `nbytes(t)` overrides a storage's bytes (a global
        batch of which the rank holds a block)."""
        for t in _tensors(tree):
            self._register(t.untyped_storage(), kind,
                           None if nbytes is None else nbytes(t))

    def _register(self, st, kind: str, nbytes: int | None = None) -> None:
        key = st._cdata
        if key in self._alive:
            return
        n = st.nbytes() if nbytes is None else int(nbytes)
        rec = [n, kind, self._event, None, self._task]
        self._records.append(rec)
        self._alive[key] = rec
        weakref.finalize(st, self._free, key, rec)
        self._live += n

    def _free(self, key: int, rec: list) -> None:
        if self._alive.get(key) is rec:
            del self._alive[key]
        rec[3] = self._event
        self._live -= rec[0]

    def _fold_target(self, func, args):
        """The record of the zeros an out-of-place backward scatter
        writes from, where a run without a dispatch mode writes into
        them in place (see the class docstring), else None."""
        if func._overloadpacket not in _FOLDED or not args \
                or not isinstance(args[0], torch.Tensor) \
                or torch._C._current_graph_task_id() == -1:
            return None
        rec = self._alive.get(args[0].untyped_storage()._cdata)
        return rec if rec is not None and rec[2] == self._event else None

    def _note(self, out, fold=None) -> None:
        self._event += 1
        task = torch._C._current_graph_task_id()
        if task != self._task:
            if self._task != -1:
                self._task_end[self._task] = self._event
            self._task = task
        kind = ("backward" if task != -1 else
                "forward" if torch.is_grad_enabled() else "other")
        for t in _tensors(out):
            self._register(t.untyped_storage(), kind)
        if fold is not None:
            # the result takes the zeros' place: they count no more
            self._live -= fold[0]
            fold[0] = 0
        if self._live > self.peak_bytes:
            self.peak_bytes, self._peak_event = self._live, self._event

    def memory(self, outputs=None) -> dict:
        """The peak split by kind, and the reference's memory fields.
        At the peak: the registered parameters, optimizer state and
        inputs; "activations", what autograd saved for the backward;
        "gradients", what the backward made and kept past its end;
        "temporaries", the rest (the forward's unsaved results, the
        backward's transients, remat's recompute among them, gradient
        accumulators, and what was made with grad mode off: the loss's
        tail, the update, a serving step).
        `outputs` (the step's result) splits its bytes into new ones and
        ones aliasing the registered inputs."""
        p = self._peak_event
        split = {k: 0 for k in ("parameters", "optimizer_state", "inputs",
                                "activations", "gradients", "temporaries")}
        args = 0
        for n, kind, born, died, task in self._records:
            if kind in ("parameters", "optimizer_state", "inputs"):
                args += n
            if born > p or (died is not None and died < p):
                continue
            if kind == "saved":
                kind = "activations"
            elif kind == "backward":
                end = self._task_end.get(task)
                kind = ("gradients" if end is None or died is None
                        or died > end else "temporaries")
            elif kind in ("forward", "other"):
                kind = "temporaries"
            split[kind] += n
        out_new = alias = 0
        seen = set()
        for t in _tensors(outputs):
            key = t.untyped_storage()._cdata
            if key in seen:
                continue
            seen.add(key)
            rec = self._alive.get(key)
            if rec is not None and rec[1] in ("parameters",
                                              "optimizer_state", "inputs"):
                alias += rec[0]
            else:
                out_new += _nbytes(t)
        peak = self.peak_bytes
        return {"argument_bytes": args, "output_bytes": out_new,
                "temp_bytes": peak - args - out_new + alias,
                "alias_bytes": alias, "peak_per_device": peak,
                "peak_by_kind": split}

# ---------------------------------------------------------------------------
# a rank's collectives (the counterpart of CollectiveAnalysis)
# ---------------------------------------------------------------------------

#: the reference's collective names, by `launch.mesh`'s
_COLLECTIVE_NAMES = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                     "reduce_scatter": "reduce-scatter",
                     "all_to_all": "all-to-all"}


class CollectiveAnalysis:
    """A rank's collective traffic by type, from a `launch.mesh.DryMesh`'s
    log of one step (the counterpart of the reference's analysis of the
    partitioned program): each call's wire bytes under the reference's
    ring model over its axis of g ranks, from the bytes the rank handed
    over (b): all-reduce 2·b·(g-1)/g, all-gather (result b·g) b·(g-1),
    reduce-scatter (result b/g) b·(g-1)/g, all-to-all b·(g-1)/g.
    `op_log` holds (op, bytes a call, calls), `by_type` and `total_bytes`
    the sums; `dot_flops` is the rank's product FLOPs (its
    `StepAnalysis`), replication included. `warnings` stays empty: the
    log names every call, where the reference parses text."""

    def __init__(self, mesh, dot_flops: float = 0.0):
        self.by_type: dict[str, float] = {c: 0.0 for c in (
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute")}
        self.op_log: list[tuple[str, float, int]] = []
        self.warnings: list[str] = []
        self.dot_flops = float(dot_flops)
        for op, axis, nbytes, n in mesh.log:
            g = mesh.shape[axis]
            traffic = {"all_reduce": 2.0 * nbytes * (g - 1) / g,
                       "all_gather": float(nbytes * (g - 1)),
                       "reduce_scatter": nbytes / g * (g - 1),
                       "all_to_all": nbytes * (g - 1) / g}[op]
            name = _COLLECTIVE_NAMES[op]
            self.by_type[name] += traffic * n
            self.op_log.append((name, traffic, n))

    @property
    def total_bytes(self) -> float:
        return sum(self.by_type.values())
