"""The DLRM train steps (the paper's split, Fig. 4): dense parameters with
a dense optimizer, the embedding rows with row-wise AdaGrad.

  build_dlrm_train_step       the whole mega table on the device, with
                              either update of the reference:
                              `sparse_apply="sparse"` (the fused sparse
                              backward on the rows the batch touched, no
                              dense gradient of the table) or `"dense"`
                              (a scatter-add into a (total_rows + 1, d)
                              buffer, then a row pass over the whole
                              table: the reference launcher's default);
  build_cached_train_step     a hot-row cache over the capacity tier
                              (`core.cache`): the sync schedule for a bare
                              `CachedEmbeddingBagCollection`, the
                              overlapped one for `core.tiers.AsyncCachedTier`;
  build_tablewise_train_step  a `table_wise` placement (whole tables on
                              owners, the paper's Zion / Big Basin layout)
                              on one device: the pooled lookup, then one
                              segmented update over every owner's rows.

The multi-host and LM steps, the table-wise step's sharded executor (its
`mesh`) and the dense update's `psum` lookup (`sparse_update_shardmap`)
come with the multi-device and LM-training slices.
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.cache import CachedEmbeddingBagCollection
from repro_torch.core.dlrm import dense_grads, dlrm_grads
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.core.tiers import AsyncCachedTier
from repro_torch.kernels import ops
from repro_torch.kernels.sparse_plan import (build_sparse_plan_host,
                                             host_plan_from_batch,
                                             plan_from_batch,
                                             split_plan_by_owner)
from repro_torch.nn.params import init_params
from repro_torch.optim.optimizers import Optimizer


#: rows per chunk of the dense update's row pass: its temporaries take a
#: few times chunk * d * 4 bytes (256 MiB each at d = 64), not the
#: table's size again and again
DENSE_CHUNK_ROWS = 1 << 20


def dense_gradient_sum(h: int, idx: torch.Tensor,
                       g_pooled: torch.Tensor) -> torch.Tensor:
    """The dense update's scatter: a zeroed (h + 1, d) fp32 buffer into
    which every valid (b, lk) slot of every feature adds its bag's
    gradient at its row, in the reference's scan order (feature by
    feature, then slot order). idx: (B, F, L) rows, -1 pads; g_pooled:
    (B, F, d). The reference sends pads to row h with zero gradients; here
    they are left out (row h stays zero either way), since thousands of
    adds to one row would run one after another.

    CUDA's `index_add_` adds with atomics, so its sum order (and so its
    bits) changes from run to run. `index_put_(accumulate=True)` under
    deterministic algorithms sorts the indices stably and adds each row's
    slots in that order onto the row's value, the order of a sequential
    scatter; the setting is restored afterwards."""
    b, f, lk = idx.shape
    d = g_pooled.shape[-1]
    gsum = torch.zeros((h + 1, d), dtype=torch.float32,
                       device=g_pooled.device)
    idx_f = idx.transpose(0, 1)                     # (F, B, L): scan order
    valid = idx_f >= 0
    rows = idx_f[valid].long()
    vals = g_pooled.float().transpose(0, 1)[:, :, None, :].expand(
        f, b, lk, d)[valid]
    prev = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        gsum.index_put_((rows,), vals, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn_only)
    return gsum


def dense_row_pass(mega: torch.Tensor, accum: torch.Tensor,
                   gsum: torch.Tensor, lr: float, eps: float,
                   chunk_rows: int = DENSE_CHUNK_ROWS) -> None:
    """Row-wise AdaGrad over every row of the table, IN PLACE, in the
    reference's operand order: touched = any(gsum != 0); accum +=
    where(touched, mean(gsum^2), 0); mega -= where(touched, lr * gsum *
    rsqrt(accum + eps), 0). Untouched rows keep their bits. The rows are
    walked in chunks of `chunk_rows`, so the peak stays near the table
    plus `gsum`; a row's result does not depend on the chunking."""
    h = mega.shape[0]
    for lo in range(0, h, chunk_rows):
        hi = min(lo + chunk_rows, h)
        g = gsum[lo:hi]
        touched = torch.any(g != 0.0, dim=-1)
        g2 = torch.mean(torch.square(g), dim=-1)
        new_acc = accum[lo:hi] + torch.where(touched, g2, 0.0)
        upd = lr * g * torch.rsqrt(new_acc[:, None] + eps)
        mega[lo:hi] -= torch.where(touched[:, None], upd, 0.0).to(
            mega.dtype)
        accum[lo:hi] = new_acc


def dense_sparse_update(mega: torch.Tensor, accum: torch.Tensor,
                        idx: torch.Tensor, g_pooled: torch.Tensor,
                        lr: float, eps: float,
                        chunk_rows: int = DENSE_CHUNK_ROWS) -> None:
    """The reference's `sparse_apply="dense"` update (`sparse_update`):
    `dense_gradient_sum`, then `dense_row_pass`, mega and accum in place.
    Its buffer is the size of the table again: (h + 1) * d * 4 bytes."""
    gsum = dense_gradient_sum(mega.shape[0], idx, g_pooled)
    dense_row_pass(mega, accum, gsum, lr, eps, chunk_rows)


def build_dlrm_train_step(cfg: DLRMConfig, ebc: EmbeddingBagCollection,
                          dense_opt: Optimizer, sparse_lr: float = 0.05,
                          sparse_eps: float = 1e-8,
                          sparse_apply: str = "sparse") -> Callable:
    """Returns step(params, state, batch, step_idx) -> (params, state,
    metrics), state = {"dense": dense_opt state, "accum": (rows,) fp32},
    metrics = {"loss", "lookups"} (0-dim tensors on the batch's device).

    batch holds tensors on the parameters' device: "dense", "idx" (offset
    rows, -1 pads), "label", and optionally a `sparse_plan_hook` plan,
    which then drives the deduplicated lookup (and, in "sparse" mode, the
    update); without one the sparse update plans on the device.

    sparse_apply:
      "sparse"  the fused sparse backward: row-wise AdaGrad on the rows
                the batch touched, O(lookups);
      "dense"   the reference's scatter-add over the full row space into a
                (total_rows + 1, d) fp32 buffer, then a row pass over the
                whole table (`dense_sparse_update`), O(table height).
    Both compute the same update up to the order of each row's sum. The
    default stays "sparse", unlike the reference's: the dense buffer is a
    second table, and full-width dlrm-m1 (43.6 GB) does not fit one 80 GB
    card twice; the cached, table-wise and chip-smoke callers rely on the
    default. The launcher defaults to "dense", as the reference's does.
    A `psum` lookup (`cfg.lookup_impl`) needs the multi-device slice.

    The mega table and the accumulator are updated IN PLACE (the returned
    params["emb"]["mega"] and state["accum"] are the tensors passed in);
    the dense parameters and their state are new tensors each step."""
    if sparse_apply not in ("sparse", "dense"):
        raise ValueError(f"sparse_apply={sparse_apply!r}; expected 'sparse' "
                         "or 'dense'")
    if sparse_apply == "dense" and cfg.lookup_impl == "psum":
        raise NotImplementedError(
            "sparse_apply='dense' with lookup_impl='psum' is the reference's "
            "shard_map update (sparse_update_shardmap); it comes with the "
            "multi-device slice of the port")

    def step(params, state, batch, step_idx):
        loss, g_dense, (idx, g_pooled) = dlrm_grads(params, batch, cfg, ebc)
        new_dense, new_dense_state = dense_opt.apply(
            {"bottom": params["bottom"], "top": params["top"]}, g_dense,
            state["dense"], step_idx)
        mega, accum = params["emb"]["mega"], state["accum"]
        with torch.no_grad():
            if sparse_apply == "dense":
                dense_sparse_update(mega, accum, idx, g_pooled, sparse_lr,
                                    sparse_eps)
            else:
                ops.fused_sparse_backward(mega, accum, idx, g_pooled,
                                          sparse_lr, sparse_eps,
                                          plan=plan_from_batch(batch))
        lookups = (batch["idx"] >= 0).sum().to(torch.float32)
        return ({**new_dense, "emb": {"mega": mega}},
                {"dense": new_dense_state, "accum": accum},
                {"loss": loss, "lookups": lookups})

    return step


def dlrm_init_state(ebc: EmbeddingBagCollection, dense_opt: Optimizer,
                    params: dict) -> dict:
    """Optimizer state for the DLRM step: the dense optimizer's, and the
    row-wise accumulator (`ebc.optimizer_specs`) on the table's device."""
    dev = params["emb"]["mega"].device
    return {"dense": dense_opt.init({"bottom": params["bottom"],
                                     "top": params["top"]}),
            "accum": init_params(ebc.optimizer_specs(), 0, dev)["accum"]}

# ---------------------------------------------------------------------------
# DLRM with the cached embedding tier (core/cache.py)
# ---------------------------------------------------------------------------


def _build_cached_inner(cfg: DLRMConfig, cc: CachedEmbeddingBagCollection,
                        dense_opt: Optimizer, sparse_lr: float,
                        sparse_eps: float) -> Callable:
    """Device half shared by the sync and async cached steps: the uncached
    step (`build_dlrm_train_step`) with the cache slab as its table, so the
    fused sparse backward updates the slab and its accumulators IN PLACE. A
    slot-relabelled plan in the batch (`plan_to_slots`) drives both the
    deduplicated slab lookup and the update. Returns inner(dense_params,
    dense_state, cache, cache_accum, batch, step_idx) -> (dense_params,
    dense_state, cache, cache_accum, metrics)."""
    step = build_dlrm_train_step(cfg, cc.ebc, dense_opt, sparse_lr,
                                 sparse_eps)

    def inner(dense_params, dense_state, cache, cache_accum, batch,
              step_idx):
        params, state, metrics = step(
            {**dense_params, "emb": {"mega": cache}},
            {"dense": dense_state, "accum": cache_accum}, batch, step_idx)
        mega = params.pop("emb")["mega"]
        return params, state["dense"], mega, state["accum"], metrics

    return inner


def _device_batch(tier, state, batch: dict, local) -> dict:
    """The batch for the device half: every array on the cache's device,
    idx replaced by the slot-space remap, a hook plan relabelled onto the
    slab, the host-only prefetch set dropped."""
    dev = state.cache.device
    out = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()
           if k not in ("idx", "uniq_rows") and not k.startswith("plan_")}
    out["idx"] = torch.as_tensor(local).to(dev)
    if "plan_rows" in batch:
        # the batch's rows are all resident after take, so a host relabel
        # (row -> slot) carries the reader thread's plan onto the slab
        out.update({k: torch.as_tensor(v).to(dev) for k, v in
                    tier.plan_to_slots(state, batch).items()})
    return out


def _build_sync_cached_step(cfg: DLRMConfig, cc: CachedEmbeddingBagCollection,
                            dense_opt: Optimizer, sparse_lr: float,
                            sparse_eps: float) -> Callable:
    """Sync schedule: `cc.take` makes the batch's rows resident (fetching
    the misses inline) and remaps to slot space; the device half then runs
    against the cache. Updated rows reach the capacity tier on eviction or
    flush. A `next_batch` carrying "uniq_rows" (the hooks attach it) is
    prefetched after the device half is queued.

    Returns step(params, state, cache_state, batch, step_idx,
    next_batch=None) -> (params, state, metrics); params = {"bottom",
    "top"} (the embedding lives in cache_state), state = {"dense": ...},
    batch holds host arrays with OFFSET global rows in "idx"."""
    inner = _build_cached_inner(cfg, cc, dense_opt, sparse_lr, sparse_eps)

    def step(params, state, cache_state, batch, step_idx, next_batch=None):
        local = cc.take(cache_state, batch["idx"], train=True,
                        plan=host_plan_from_batch(batch))
        new_dense, new_dense_state, new_cache, new_accum, metrics = inner(
            params, state["dense"], cache_state.cache,
            cache_state.cache_accum,
            _device_batch(cc, cache_state, batch, local), step_idx)
        cc.mark_updated(cache_state, new_cache, new_accum)
        if next_batch is not None and "uniq_rows" in next_batch:
            cc.prefetch_rows(cache_state, next_batch["uniq_rows"])
        metrics = {**metrics, **cc.stats(cache_state).snapshot()}
        return new_dense, {"dense": new_dense_state}, metrics

    return step


def _build_async_cached_step(cfg: DLRMConfig, tier: AsyncCachedTier,
                             dense_opt: Optimizer, sparse_lr: float,
                             sparse_eps: float, strict_sync: bool
                             ) -> Callable:
    """Overlapped schedule: batch k+1's fetch is queued while batch k's
    step runs. Per call: `tier.take` pops batch k's staged plan and commits
    every pending fetch (after batch k-1's update, so dirty writebacks
    carry post-update rows); the device half runs; `tier.stage(next_batch)`
    plans batch k+1 and queues its shadow fetch; `prefetch_rows` (a k-step
    lookahead, `data.pipeline.lookahead_rows`) is queued best-effort
    behind it. `strict_sync=True` plans and commits each batch inside its
    own step: the same results bit for bit, without the overlap.

    Returns step(params, state, astate, batch, step_idx, next_batch=None,
    prefetch_rows=None) -> (params, state, metrics); astate from
    `tier.init_state`."""
    inner = _build_cached_inner(cfg, tier.cc, dense_opt, sparse_lr,
                                sparse_eps)

    def step(params, state, astate, batch, step_idx, next_batch=None,
             prefetch_rows=None):
        local = tier.take(astate, batch["idx"], train=True,
                          plan=host_plan_from_batch(batch))
        new_dense, new_dense_state, new_cache, new_accum, metrics = inner(
            params, state["dense"], astate.cache, astate.cache_accum,
            _device_batch(tier, astate, batch, local), step_idx)
        tier.mark_updated(astate, new_cache, new_accum)
        # stats before staging batch k+1, so step k's metrics cover only
        # batches that ran, in both schedules
        metrics = {**metrics, **tier.stats(astate).snapshot()}
        if not strict_sync and next_batch is not None:
            tier.stage(astate, next_batch["idx"], train=True,
                       plan=host_plan_from_batch(next_batch))
        if not strict_sync and prefetch_rows is not None:
            tier.prefetch_rows(astate, prefetch_rows)
        return new_dense, {"dense": new_dense_state}, metrics

    return step


def build_cached_train_step(cfg: DLRMConfig, tier, dense_opt: Optimizer,
                            sparse_lr: float = 0.05,
                            sparse_eps: float = 1e-8,
                            strict_sync: bool = False) -> Callable:
    """One train-step factory for the cached tiers, dispatching on the
    tier's type:

      `CachedEmbeddingBagCollection`  sync schedule (take admits the batch
                                      inline; next_batch rows prefetch
                                      behind the step);
      `AsyncCachedTier(cc)`           overlapped schedule (batch k+1
                                      stages while batch k computes;
                                      `strict_sync=True` falls back, bit
                                      for bit).

    The transfer granularity is the collection's own `fetch_chunk`. See
    the two builders for the step signatures. Any other tier raises
    TypeError."""
    if isinstance(tier, AsyncCachedTier):
        return _build_async_cached_step(cfg, tier, dense_opt, sparse_lr,
                                        sparse_eps, strict_sync)
    if isinstance(tier, CachedEmbeddingBagCollection):
        return _build_sync_cached_step(cfg, tier, dense_opt, sparse_lr,
                                       sparse_eps)
    raise TypeError(
        f"build_cached_train_step: unsupported tier {type(tier).__name__}; "
        "expected a CachedEmbeddingBagCollection or an AsyncCachedTier")


def cached_dlrm_init_state(cc, dense_opt: Optimizer, params: dict) -> dict:
    """Dense-only optimizer state; the row-wise accumulator lives in the
    cached tier's state (cap_accum / cache_accum)."""
    return {"dense": dense_opt.init({"bottom": params["bottom"],
                                     "top": params["top"]})}

# ---------------------------------------------------------------------------
# DLRM under a table_wise placement (core/placement.py), on one device
# ---------------------------------------------------------------------------


def build_tablewise_train_step(cfg: DLRMConfig, ebc: EmbeddingBagCollection,
                               dense_opt: Optimizer,
                               sparse_lr: float = 0.05,
                               sparse_eps: float = 1e-8) -> Callable:
    """Train step for a `table_wise` placement: whole tables on H =
    `ebc.plan.capacity_shards` owners, owner s holding the mega rows
    [s*shard_rows, (s+1)*shard_rows) — the paper's Zion / Big Basin
    placement, here with every owner's rows on one device.

    Per step: on the host, the batch's plan (a hook's, else
    `build_sparse_plan_host`) is cut into per-owner segments
    (`split_plan_by_owner`, tight capacity); on the device, the plan-less
    pooled lookup (`ebc.lookup`, the `embedding_bag` kernel), the dense
    tower and BCE differentiated with the pooled activations as a leaf,
    dense `dense_opt`, and ONE segmented fused update over all H owners
    (`ops.fused_sparse_backward_segments`). A row's update does not depend
    on how the plan is segmented, so the step is bit-equal to
    `build_dlrm_train_step` on the same layout.

    Given `next_batch`, the step queues that batch's pooled lookup right
    after its update (so it reads the post-update table); the next call
    consumes it when its step_idx is one more and its batch IS that object,
    and otherwise looks up afresh — the same bits either way. Everything
    runs on the current stream: the staged lookup executes while the host
    plans the next batch. All of a step's uploads are made before its
    device work is queued, since a pageable copy waits for the stream.

    There is no `mesh`: the sharded executor (the pooled psum forward and
    the per-owner update on `torch.distributed`) comes with the
    multi-device slice. Metrics carry the pooled exchange a sharded run
    would make, counted on the host from the batch's shape and the plan's
    owners (`launch.analysis.tablewise_exchange_traffic` is the analytic
    model it must equal).

    Returns step(params, state, batch, step_idx, next_batch=None) ->
    (params, state, metrics); params and state as in
    `build_dlrm_train_step` (mega and accum updated IN PLACE); batch holds
    host arrays, "idx" with OFFSET global rows, optionally a
    `sparse_plan_hook` plan."""
    plan = ebc.plan
    if plan.strategy != "table_wise":
        raise ValueError(
            f"build_tablewise_train_step needs a table_wise placement, "
            f"got {plan.strategy!r}")
    if any(c != 1 for c in plan.column_shards):
        raise NotImplementedError(
            "column-sliced tables (column_shards > 1) need the column_wise "
            "executor; re-plan with a larger per-shard budget or fewer "
            "slices")
    n_owners = plan.capacity_shards
    shard_rows = plan.shard_rows
    d = cfg.embed_dim
    itemsize = 4                       # pooled activations cross in fp32
    owners = np.asarray(plan.table_offsets) // max(shard_rows, 1)
    max_f_owned = int(np.bincount(owners, minlength=n_owners).max())
    staged_cell: list[tuple | None] = [None]

    def step(params, state, batch, step_idx, next_batch=None):
        mega, accum = params["emb"]["mega"], state["accum"]
        dev = mega.device

        def up(x):
            return torch.as_tensor(x).to(dev)

        idx_h = np.asarray(batch["idx"])
        plan_h = host_plan_from_batch(batch)
        if plan_h is None:
            plan_h = build_sparse_plan_host(idx_h)
        seg_rows, seg_offs, seg_base = split_plan_by_owner(
            plan_h, shard_rows, n_owners)
        staged, staged_cell[0] = staged_cell[0], None
        hit = (staged is not None and staged[0] == int(step_idx)
               and staged[1] is batch)
        dense_batch = {"dense": up(batch["dense"]),
                       "label": up(batch["label"])}
        idx = None if hit else up(idx_h)
        seg_rows, seg_offs, bag_ids, seg_base = (
            up(x) for x in (seg_rows, seg_offs, plan_h.bag_ids, seg_base))
        nxt = (None if next_batch is None
               else up(np.asarray(next_batch["idx"])))
        with torch.no_grad():
            pooled = staged[2] if hit else ebc.lookup({"mega": mega}, idx)
        loss, g_dense, g_pooled = dense_grads(params, dense_batch, pooled,
                                              cfg)
        new_dense, new_dense_state = dense_opt.apply(
            {"bottom": params["bottom"], "top": params["top"]}, g_dense,
            state["dense"], step_idx)
        with torch.no_grad():
            ops.fused_sparse_backward_segments(
                mega, accum, seg_rows, seg_offs, bag_ids, g_pooled,
                sparse_lr, seg_base=seg_base, eps=sparse_eps)
            if nxt is not None:
                # queued behind the update: reads the post-update table
                staged_cell[0] = (int(step_idx) + 1, next_batch,
                                  ebc.lookup({"mega": mega}, nxt))
        b, f, _ = idx_h.shape
        wire = (n_owners - 1) / max(n_owners, 1) * b * f * d * itemsize
        metrics = {"loss": loss,
                   "lookups": float(np.count_nonzero(idx_h >= 0)),
                   "exchange_pooled_fwd_bytes": wire,
                   "exchange_pooled_bwd_bytes": wire,
                   "exchange_pair_leg_bytes":
                       -(-b // max(n_owners, 1)) * max_f_owned * d * itemsize}
        return ({**new_dense, "emb": {"mega": mega}},
                {"dense": new_dense_state, "accum": accum}, metrics)

    return step
