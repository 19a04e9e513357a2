"""The train steps: the LM's (`build_lm_train_step`: AdamW on every
parameter, optional gradient accumulation) and the DLRM's (the paper's
split, Fig. 4): dense parameters with a dense optimizer, the embedding
rows with row-wise AdaGrad.

  build_dlrm_train_step       the whole mega table on the device, with
                              either update of the reference:
                              `sparse_apply="sparse"` (the fused sparse
                              backward on the rows the batch touched, no
                              dense gradient of the table) or `"dense"`
                              (a scatter-add into a (total_rows + 1, d)
                              buffer, then a row pass over the whole
                              table: the reference launcher's default);
                              under a (data, model) mesh, `"dense"` with
                              `lookup_impl="psum"`: the reference's
                              shard_map update (`psum_sparse_update`);
  build_cached_train_step     a hot-row cache over the capacity tier
                              (`core.cache`): the sync schedule for a bare
                              `CachedEmbeddingBagCollection` (or the
                              three-tier `core.tiers` subclass), the
                              overlapped one for `core.tiers.AsyncCachedTier`,
                              the routed one for
                              `MultiHostCachedEmbeddingBagCollection` (H
                              hosts' caches over one row-sharded capacity
                              tier);
  build_tablewise_train_step  a `table_wise` placement (whole tables on
                              owners, the paper's Zion / Big Basin layout)
                              on one device (the pooled lookup, then one
                              segmented update over every owner's rows) or
                              over a (data, model) mesh (the pooled psum
                              lookup, a data-parallel dense tower, each
                              owner's segment on its own shard).

Under a mesh (`launch.mesh`, one process per rank) a step takes the
GLOBAL batch on every rank, as the reference's pjit steps take global
arrays: each rank looks up and differentiates its `data` slice, and
params["emb"]["mega"] / state["accum"] are its `model` shard of the rows
(`EmbeddingBagCollection.shard_range`). The multi-host cached step runs
single-controller (one process drives every host's cache) or, with
`mesh=`, one rank a host over a host mesh. The LM step runs on one device,
or with `mesh=` on each rank of a (data, model) mesh under one of
`nn.sharding`'s training tables (`rules`): parameters, AdamW moments and
gradients are this rank's `resolve_sized` blocks.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig, ModelConfig
from repro_torch.core import hostmem
from repro_torch.core.cache import (CachedEmbeddingBagCollection,
                                    MultiHostCachedEmbeddingBagCollection)
from repro_torch.core.dlrm import dense_grads, dlrm_grads
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.core.tiers import AsyncCachedTier, tier_conformance
from repro_torch.kernels import ops
from repro_torch.kernels.sparse_plan import (build_sparse_plan_host,
                                             host_plan_from_batch,
                                             host_plans_from_batch,
                                             plan_from_batch,
                                             split_plan_by_owner,
                                             split_plan_by_ranges)
from repro_torch.models.lm import (lm_loss, lm_param_shardings,
                                   lm_param_specs)
from repro_torch.nn.params import init_params, tree_leaves, tree_map
from repro_torch.nn.sharding import (TRAIN_RULES, LogicalRules, NamedSharding,
                                     batch_axes, resolve_sized, spec_axes)
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


def psum_sparse_update(mega: torch.Tensor, accum: torch.Tensor,
                       idx: torch.Tensor, g_pooled: torch.Tensor,
                       row_lo: int, lr: float, eps: float, mesh,
                       reduce_dtype: str = "float32",
                       chunk_rows: int = DENSE_CHUNK_ROWS) -> None:
    """The reference's `sparse_update_shardmap`, on one rank: mega / accum
    are this rank's shard, global rows [row_lo, row_lo + len(mega)); idx
    (B, F, L) and g_pooled (B, F, d) its slice of the batch.

    The rows outside the shard become pads; each local row's bag gradients
    are summed into a zeroed (rows_local, d) fp32 buffer in slot order
    (`dense_gradient_sum`: the order of the reference's CSR sums over its
    shard-local plan, since a row's slots all belong to one feature); ONE
    all_reduce over `data` merges the slices' partial sums (in bf16
    when `reduce_dtype` is "bfloat16", as the reference's psum); then the
    row pass (`dense_row_pass`, the reference's operand order), IN PLACE.
    The buffer is the shard's size again."""
    h = mega.shape[0]
    loc = torch.where((idx >= row_lo) & (idx < row_lo + h), idx - row_lo,
                      -1)
    gsum = dense_gradient_sum(h, loc, g_pooled)[:h]
    if reduce_dtype == "bfloat16":
        half = gsum.to(torch.bfloat16)
        mesh.all_reduce(half, "data")
        gsum.copy_(half)
        del half
    else:
        mesh.all_reduce(gsum, "data")
    dense_row_pass(mega, accum, gsum, lr, eps, chunk_rows)


def _check_mesh(mesh) -> None:
    if set(mesh.axis_names) != {"data", "model"}:
        raise ValueError(f"the sharded steps run on a (data, model) mesh, "
                         f"got axes {mesh.axis_names}")


def _data_slice(batch: dict, mesh, keys=("dense", "idx", "label")) -> dict:
    """This rank's rows of the global batch's `keys`: the `data`
    coordinate's contiguous block (the reference's P(batch_axes))."""
    n, c = mesh.size("data"), mesh.coords["data"]
    b = batch["idx"].shape[0]
    if b % n:
        raise ValueError(f"a global batch of {b} does not split over "
                         f"{n} data ranks")
    lo, hi = c * (b // n), (c + 1) * (b // n)
    return {k: batch[k][lo:hi] for k in keys}


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
                          sparse_apply: str = "sparse",
                          mesh=None) -> Callable:
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

    `mesh` (a `launch.mesh.Mesh` over ("data", "model"), one process per
    rank) runs the reference's sharded path, `sparse_apply="dense"` with
    `cfg.lookup_impl == "psum"`: batch is the GLOBAL batch on every rank;
    params["emb"]["mega"] and state["accum"] are this rank's `model` shard
    (`ebc.shard_range(mesh)`); each rank pools its `data` slice with
    `lookup_pooled_psum`, runs the data-parallel dense tower
    (`core.dlrm.dense_grads`) and `psum_sparse_update` with
    `cfg.grad_reduce_dtype`. Metrics: the global loss and lookups. The
    reference's pjit `"gather"` path under a mesh is XLA's own
    partitioning and has no counterpart: it raises, as does the fused
    update under a mesh. Without a mesh, the psum update raises too (the
    reference's would fail on its missing mesh); a psum lookup without a
    mesh falls back to the gather lookup, as the reference's does.

    The mega table and the accumulator are updated IN PLACE (the returned
    params["emb"]["mega"] and state["accum"] are the tensors passed in);
    the dense parameters and their state are new tensors each step."""
    if sparse_apply not in ("sparse", "dense"):
        raise ValueError(f"sparse_apply={sparse_apply!r}; expected 'sparse' "
                         "or 'dense'")
    if mesh is not None:
        return _build_psum_dlrm_step(cfg, ebc, dense_opt, sparse_lr,
                                     sparse_eps, sparse_apply, mesh)
    if sparse_apply == "dense" and cfg.lookup_impl == "psum":
        raise ValueError(
            "sparse_apply='dense' with lookup_impl='psum' is the reference's "
            "shard_map update: it needs a (data, model) mesh, "
            "build_dlrm_train_step(..., mesh=launch.mesh.make_test_mesh("
            "...)) on every rank")

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


def _build_psum_dlrm_step(cfg: DLRMConfig, ebc: EmbeddingBagCollection,
                          dense_opt: Optimizer, sparse_lr: float,
                          sparse_eps: float, sparse_apply: str,
                          mesh) -> Callable:
    """`build_dlrm_train_step` under a mesh (see there)."""
    _check_mesh(mesh)
    if cfg.lookup_impl != "psum":
        raise NotImplementedError(
            f"lookup_impl={cfg.lookup_impl!r} under a mesh is the "
            "reference's pjit path, which XLA partitions; the port's "
            "sharded step runs lookup_impl='psum' with sparse_apply='dense'")
    if sparse_apply != "dense":
        raise NotImplementedError(
            "under a mesh the port's sharded step runs sparse_apply='dense' "
            "with lookup_impl='psum' (the reference's shard_map update); "
            "the table-wise step shards the fused update")
    row_lo, _ = ebc.shard_range(mesh)

    def step(params, state, batch, step_idx):
        local = _data_slice(batch, mesh)
        loss, g_dense, (idx, g_pooled) = dlrm_grads(params, local, cfg, ebc,
                                                    mesh)
        new_dense, new_dense_state = dense_opt.apply(
            {"bottom": params["bottom"], "top": params["top"]}, g_dense,
            state["dense"], step_idx)
        mega, accum = params["emb"]["mega"], state["accum"]
        with torch.no_grad():
            psum_sparse_update(mega, accum, idx, g_pooled, row_lo,
                               sparse_lr, sparse_eps, mesh,
                               cfg.grad_reduce_dtype)
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


def _build_multihost_cached_step(cfg: DLRMConfig,
                                 mc: MultiHostCachedEmbeddingBagCollection,
                                 dense_opt: Optimizer, sparse_lr: float,
                                 sparse_eps: float, strict_sync: bool
                                 ) -> Callable:
    """Routed schedule (`MultiHostCachedEmbeddingBagCollection`): H hosts'
    clean caches over one row-sharded capacity tier, single-controller.

    Per step, on the host: `mc.plan_step` (per-host hit/miss split off the
    batch's hook sub-plans or its own, LFU admission, owner grouping,
    stale-copy invalidation), then ONE upload of every array the device
    half reads (`hostmem.upload`: the live miss and working-set entries,
    the remap, the owner segments). On the device, in order on the current
    stream: the miss install from the pre-update capacity (`mc.install`);
    H pooled lookups (`EmbeddingBagCollection.lookup`, the `embedding_bag`
    kernel on each slab), concatenated to the global batch; the dense
    tower and BCE with the pooled embeddings as a leaf; dense AdaGrad; the
    routed update, one segmented fused update over the H owners
    (`ops.fused_sparse_backward_segments`, seg_base = h * shard_rows) IN
    PLACE on the capacity tier; the working-set refresh from the
    post-update capacity. Then, unless `strict_sync`, `mc.prefetch` of
    `next_batch`, queued behind the update. Host h holds examples
    [h*B/H, (h+1)*B/H), so the owners reduce in flat-batch order and the
    step is bit-equal to `build_dlrm_train_step(sparse_apply="sparse")`;
    `strict_sync` gives the same bits.

    Returns step(params, state, mstate, batch, step_idx, next_batch=None)
    -> (params, state, metrics); metrics carry the loss, the lookups and
    the tier's CacheStats and RouteStats snapshots (taken before the
    prefetch); batch holds host arrays, "idx" with OFFSET global rows,
    optionally a `sparse_plan_hook(n_hosts=H)` plan."""
    hn, ebc = mc.n_hosts, mc.ebc

    def step(params, state, mstate, batch, step_idx, next_batch=None):
        splan = mc.plan_step(mstate, batch["idx"],
                             host_plans=host_plans_from_batch(batch),
                             global_plan=host_plan_from_batch(batch),
                             train=True)
        caches, capacity, accum = (mstate.caches, mstate.capacity,
                                   mstate.cap_accum)
        (dense_x, label, local_idx, seg_rows, seg_offs, seg_base, bag_ids,
         *lists) = hostmem.upload(
            [np.asarray(batch["dense"], np.float32),
             np.asarray(batch["label"], np.float32), splan.local_idx,
             splan.seg_rows, splan.seg_offsets, splan.seg_base,
             splan.bag_ids]
            + mc.live_worklist(splan.miss_rows, splan.miss_slots)
            + mc.live_worklist(splan.ws_rows, splan.ws_slots),
            caches.device)
        with torch.no_grad():
            mc.install(caches, capacity, lists[:2 * hn])
            pooled = torch.cat([ebc.lookup({"mega": caches[h]}, local_idx[h])
                                for h in range(hn)])
        loss, g_dense, g_pooled = dense_grads(
            params, {"dense": dense_x, "label": label}, pooled, cfg)
        new_dense, new_dense_state = dense_opt.apply(
            {"bottom": params["bottom"], "top": params["top"]}, g_dense,
            state["dense"], step_idx)
        with torch.no_grad():
            ops.fused_sparse_backward_segments(
                capacity, accum, seg_rows, seg_offs, bag_ids, g_pooled,
                sparse_lr, seg_base=seg_base, eps=sparse_eps)
            mc.install(caches, capacity, lists[2 * hn:])
        mc.mark_updated(mstate, capacity, accum, caches)
        metrics = {"loss": loss,
                   "lookups": float(np.count_nonzero(splan.local_idx >= 0)),
                   **mc.stats(mstate).snapshot(), **mstate.route.snapshot()}
        if not strict_sync and next_batch is not None:
            mc.prefetch(mstate, next_batch["idx"],
                        host_plans=host_plans_from_batch(next_batch),
                        global_plan=host_plan_from_batch(next_batch))
        return new_dense, {"dense": new_dense_state}, metrics

    return step


def _build_multihost_mesh_step(cfg: DLRMConfig,
                               mc: MultiHostCachedEmbeddingBagCollection,
                               dense_opt: Optimizer, sparse_lr: float,
                               sparse_eps: float, strict_sync: bool, mesh,
                               host_axis: str) -> Callable:
    """The routed schedule with one rank a host (`mesh`, a `launch.mesh.
    Mesh` whose `host_axis` has n_hosts ranks; the state from `mc.
    init_state(..., capacity_sharding=NamedSharding(mesh, plan.pspec))`:
    this rank's slab and owned capacity rows). Every rank takes the
    GLOBAL batch. Rank h, per step, in order:
      * `mc.plan_step` on the global batch, as every rank (every host's
        maps, CacheStats and RouteStats, the same integers on all);
      * its misses installed from their owners (`mc.install_worklist`:
        each owner sends the rows it holds, by copy);
      * the pooled lookup of examples [h*B/H, (h+1)*B/H) on its slab (the
        `embedding_bag` kernel), the pools gathered over `host_axis` by
        copy (`Mesh.all_gather_rows`) into the global batch's;
      * the dense tower, BCE and `dense_opt` on the GLOBAL batch (the
        reference's dense half is not sharded; data-parallel sums of the
        dense gradients would change the bits);
      * the owner update of its own segment on its own shard (one
        segmented fused update, S = 1, row base 0), from the replicated
        plan and pooled gradients;
      * its working set refreshed from the owners' post-update rows;
      * unless `strict_sync`, `mc.prefetch` of next_batch (its rows too
        from their owners).
    The losses, dense parameters and every capacity and accumulator shard
    are bit-equal to the single-controller step's. Same signature and
    metrics as `_build_multihost_cached_step`."""
    if mesh.size(host_axis) != mc.n_hosts:
        raise ValueError(f"the host mesh's {host_axis!r} axis has "
                         f"{mesh.size(host_axis)} ranks; the tier "
                         f"{mc.n_hosts} hosts")
    ebc = mc.ebc

    def step(params, state, mstate, batch, step_idx, next_batch=None):
        if mstate.mesh is not mesh or mstate.host_axis != host_axis:
            raise ValueError("the tier state was not made on this step's "
                             "mesh: init_state(capacity_sharding="
                             "NamedSharding(mesh, plan.pspec))")
        splan = mc.plan_step(mstate, batch["idx"],
                             host_plans=host_plans_from_batch(batch),
                             global_plan=host_plan_from_batch(batch),
                             train=True)
        me = mstate.host
        dense_x, label, local_idx, seg_rows, seg_offs, bag_ids = \
            hostmem.upload([np.asarray(batch["dense"], np.float32),
                            np.asarray(batch["label"], np.float32),
                            splan.local_idx[me], splan.seg_rows[me:me + 1],
                            splan.seg_offsets[me:me + 1], splan.bag_ids],
                           mstate.caches.device)
        with torch.no_grad():
            mc.install_worklist(mstate, mc.live_worklist(splan.miss_rows,
                                                         splan.miss_slots))
            pooled = mesh.all_gather_rows(
                ebc.lookup({"mega": mstate.caches[0]}, local_idx), host_axis)
        loss, g_dense, g_pooled = dense_grads(
            params, {"dense": dense_x, "label": label}, pooled, cfg)
        new_dense, new_dense_state = dense_opt.apply(
            {"bottom": params["bottom"], "top": params["top"]}, g_dense,
            state["dense"], step_idx)
        with torch.no_grad():
            ops.fused_sparse_backward_segments(
                mstate.capacity, mstate.cap_accum, seg_rows, seg_offs,
                bag_ids, g_pooled, sparse_lr, eps=sparse_eps)
            mc.install_worklist(mstate, mc.live_worklist(splan.ws_rows,
                                                         splan.ws_slots))
        metrics = {"loss": loss,
                   "lookups": float(np.count_nonzero(splan.local_idx >= 0)),
                   **mc.stats(mstate).snapshot(), **mstate.route.snapshot()}
        if not strict_sync and next_batch is not None:
            mc.prefetch(mstate, next_batch["idx"],
                        host_plans=host_plans_from_batch(next_batch),
                        global_plan=host_plan_from_batch(next_batch))
        return new_dense, {"dense": new_dense_state}, metrics

    return step


def build_cached_train_step(cfg: DLRMConfig, tier, dense_opt: Optimizer,
                            sparse_lr: float = 0.05,
                            sparse_eps: float = 1e-8,
                            strict_sync: bool = False, mesh=None,
                            host_axis: str = "data",
                            fetch_chunk: int | None = None) -> Callable:
    """One train-step factory for every cached tier, dispatching on the
    tier's type (all of them consume the tier through the `EmbeddingTier`
    protocol, `core.tiers`):

      `CachedEmbeddingBagCollection`  sync schedule (take admits the batch
      (the bulk-backed subclass too)  inline; next_batch rows prefetch
                                      behind the step);
      `AsyncCachedTier(cc)`           overlapped schedule (batch k+1
                                      stages while batch k computes;
                                      `strict_sync=True` falls back, bit
                                      for bit);
      `MultiHostCachedEmbeddingBagCollection`
                                      routed schedule (per-host caches
                                      over a row-sharded capacity tier;
                                      `strict_sync=True` drops the
                                      next-batch prefetch, bit for bit).

    `fetch_chunk` (> 1) replaces the tier's transfer granularity; None
    keeps the collection's own. `mesh` runs the multi-host tier one rank a
    host over the mesh's `host_axis` (`_build_multihost_mesh_step`); the
    sync and async tiers ignore it, as the reference's do. See the
    builders for the step signatures. Any other tier raises TypeError."""
    if fetch_chunk is not None and isinstance(tier, AsyncCachedTier):
        tier = AsyncCachedTier(dataclasses.replace(tier.cc,
                                                   fetch_chunk=fetch_chunk))
    elif fetch_chunk is not None and isinstance(
            tier, (CachedEmbeddingBagCollection,
                   MultiHostCachedEmbeddingBagCollection)):
        tier = dataclasses.replace(tier, fetch_chunk=fetch_chunk)
    if isinstance(tier, AsyncCachedTier):
        return _build_async_cached_step(cfg, tier, dense_opt, sparse_lr,
                                        sparse_eps, strict_sync)
    if isinstance(tier, MultiHostCachedEmbeddingBagCollection):
        if mesh is not None:
            return _build_multihost_mesh_step(cfg, tier, dense_opt,
                                              sparse_lr, sparse_eps,
                                              strict_sync, mesh, host_axis)
        return _build_multihost_cached_step(cfg, tier, dense_opt, sparse_lr,
                                            sparse_eps, strict_sync)
    if isinstance(tier, CachedEmbeddingBagCollection):
        return _build_sync_cached_step(cfg, tier, dense_opt, sparse_lr,
                                       sparse_eps)
    raise TypeError(
        f"build_cached_train_step: unsupported tier {type(tier).__name__}; "
        "expected an EmbeddingTier (CachedEmbeddingBagCollection, "
        "AsyncCachedTier, MultiHostCachedEmbeddingBagCollection or the "
        "bulk-backed subclass); protocol conformance "
        f"(core.tiers.tier_conformance): {tier_conformance(tier)}")


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
                               sparse_eps: float = 1e-8,
                               mesh=None) -> Callable:
    """Train step for a `table_wise` placement: whole tables on H =
    `ebc.plan.capacity_shards` owners, owner s holding the mega rows
    [s*shard_rows, (s+1)*shard_rows) — the paper's Zion / Big Basin
    placement.

    Per step: on the host, the batch's plan (a hook's, else
    `build_sparse_plan_host`) is cut into per-owner segments
    (`split_plan_by_owner`, tight capacity); on the device, the plan-less
    pooled lookup (`ebc.lookup`, the `embedding_bag` kernel), the dense
    tower and BCE differentiated with the pooled activations as a leaf,
    dense `dense_opt`, and ONE segmented fused update over all H owners
    (`ops.fused_sparse_backward_segments`). A row's update does not depend
    on how the plan is segmented, so the step is bit-equal to
    `build_dlrm_train_step` on the same layout.

    Under `mesh` (a `launch.mesh.Mesh` over ("data", "model") with
    mesh.size("model") == H, one process per rank) rank (d, m) holds
    owner m's rows (params["emb"]["mega"], state["accum"]: its shard) and
    the batch's `data` slice d: the pooled lookup is
    `ebc.lookup_pooled_psum` (pool, then one all_reduce of the (B/D, F, d)
    pools over `model`); the dense tower is data parallel
    (`core.dlrm.dense_grads`); the slices' pooled gradients are gathered
    over `data` into the whole batch's (an all_reduce of a zero-padded
    buffer), and owner m runs the segmented update on its own shard with
    its own segment of the global plan. Every `data` replica of an owner
    applies the same update to the same rows, so the replicas stay
    bit-equal; on a (1, H) mesh the run is bit-equal to the one-device
    step, since the other owners add exact zeros to each bag.

    Given `next_batch`, the step queues that batch's pooled lookup right
    after its update (so it reads the post-update table); the next call
    consumes it when its step_idx is one more and its batch IS that object,
    and otherwise looks up afresh — the same bits either way. Everything
    runs on the current stream: the staged lookup executes while the host
    plans the next batch. All of a step's uploads are made before its
    device work is queued, since a pageable copy waits for the stream.

    Metrics carry the pooled exchange of a sharded run, counted on the
    host from the batch's shape and the plan's owners
    (`launch.analysis.tablewise_exchange_traffic` is the analytic model it
    must equal).

    Returns step(params, state, batch, step_idx, next_batch=None) ->
    (params, state, metrics); params and state as in
    `build_dlrm_train_step` (mega and accum updated IN PLACE); batch holds
    host arrays (the GLOBAL batch, on every rank of a mesh), "idx" with
    OFFSET global rows, optionally a `sparse_plan_hook` plan."""
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
    if mesh is not None:
        _check_mesh(mesh)
        if mesh["model"].size() != n_owners:
            raise AssertionError(f"mesh model axis of "
                                 f"{mesh['model'].size()} ranks for "
                                 f"{n_owners} owners")
        owner = mesh.coords["model"]
    d = cfg.embed_dim
    itemsize = 4                       # pooled activations cross in fp32
    owners = np.asarray(plan.table_offsets) // max(shard_rows, 1)
    max_f_owned = int(np.bincount(owners, minlength=n_owners).max())
    staged_cell: list[tuple | None] = [None]

    def lookup(mega, idx):
        if mesh is None:
            return ebc.lookup({"mega": mega}, idx)
        return ebc.lookup_pooled_psum({"mega": mega}, idx, mesh)

    def step(params, state, batch, step_idx, next_batch=None):
        mega, accum = params["emb"]["mega"], state["accum"]
        dev = mega.device

        def up(x):
            return torch.as_tensor(x).to(dev)

        idx_h = np.asarray(batch["idx"])
        plan_h = host_plan_from_batch(batch)
        if plan_h is None:
            plan_h = build_sparse_plan_host(idx_h)
        if mesh is None:
            seg_rows, seg_offs, seg_base = split_plan_by_owner(
                plan_h, shard_rows, n_owners)
            local = batch
        else:
            # this owner's segment, its rows local to its shard
            lo = owner * shard_rows
            seg_rows, seg_offs, _ = split_plan_by_ranges(
                plan_h, [lo], [lo + shard_rows])
            seg_base = np.zeros((1,), np.int32)
            local = _data_slice(batch, mesh)
        staged, staged_cell[0] = staged_cell[0], None
        hit = (staged is not None and staged[0] == int(step_idx)
               and staged[1] is batch)
        dense_batch = {"dense": up(local["dense"]),
                       "label": up(local["label"])}
        idx = None if hit else up(np.asarray(local["idx"]))
        seg_rows, seg_offs, bag_ids, seg_base = (
            up(x) for x in (seg_rows, seg_offs, plan_h.bag_ids, seg_base))
        nxt = None
        if next_batch is not None:
            nxt = up(np.asarray(next_batch["idx"] if mesh is None else
                                _data_slice(next_batch, mesh,
                                            ("idx",))["idx"]))
        with torch.no_grad():
            pooled = staged[2] if hit else lookup(mega, idx)
        loss, g_dense, g_pooled = dense_grads(params, dense_batch, pooled,
                                              cfg, mesh)
        new_dense, new_dense_state = dense_opt.apply(
            {"bottom": params["bottom"], "top": params["top"]}, g_dense,
            state["dense"], step_idx)
        with torch.no_grad():
            if mesh is not None:
                g_pooled = mesh.gather_rows(g_pooled, "data")
            ops.fused_sparse_backward_segments(
                mega, accum, seg_rows, seg_offs, bag_ids, g_pooled,
                sparse_lr, seg_base=seg_base, eps=sparse_eps)
            if nxt is not None:
                # queued behind the update: reads the post-update table
                staged_cell[0] = (int(step_idx) + 1, next_batch,
                                  lookup(mega, nxt))
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

# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------


def _chunk(x, i: int, n: int):
    """Chunk i of n equal chunks of x along its first axis."""
    size = x.shape[0] // n
    return x[i * size:(i + 1) * size]


def lm_batch_block(batch: dict, rules: LogicalRules, mesh) -> dict:
    """This rank's block of each batch leaf: the rows of ("batch", None,
    ...) under `rules`, as the reference's dry-run shards a batch. Refuses
    a batch the batch's mesh axes do not divide (a replicated batch would
    count its rows more than once)."""
    ba = batch_axes(rules, mesh)
    out = {}
    for k, v in batch.items():
        spec = resolve_sized(("batch",) + (None,) * (v.dim() - 1), rules,
                             mesh, tuple(v.shape))
        if set(spec_axes(spec)) != set(ba):
            raise ValueError(f"batch leaf {k!r} of {tuple(v.shape)} does "
                             f"not split over the batch's axes {ba}")
        out[k] = NamedSharding(mesh, spec).shard(v)
    return out


def lm_grad_sq_sum(grads, shardings, mesh) -> torch.Tensor:
    """The fp32 sum of squares of every rank's gradient blocks, each
    distinct block once: the leaves' local sums grouped by the mesh axes
    they shard on, each group all-reduced over those axes only (replicas
    count once), the groups added in first-seen leaf order."""
    groups: dict[tuple, torch.Tensor] = {}
    for g, sh in zip(tree_leaves(grads), tree_leaves(shardings)):
        key = tuple(a for a in mesh.axis_names if a in spec_axes(sh.spec))
        sq = torch.sum(torch.square(g.float()))
        groups[key] = groups[key] + sq if key in groups else sq
    total = None
    for key, sq in groups.items():
        sq = sq.clone()
        for a in key:
            mesh.all_reduce(sq, a)
        total = sq if total is None else total + sq
    return total


def build_lm_train_step(cfg: ModelConfig, opt: Optimizer,
                        rules: LogicalRules = TRAIN_RULES,
                        accum_steps: int = 1,
                        grad_dtype: str = "float32",
                        mesh=None) -> Callable:
    """Returns step(params, opt_state, batch, step_idx) -> (params,
    opt_state, metrics), the reference's LM step: `lm_loss` and its
    gradient with respect to every parameter (autograd through the
    train-mode forward, the flash-attention kernels on the card), then
    `opt.apply`. metrics: "loss", "ce" and "aux" (0-dim tensors on the
    parameters' device).

    accum_steps > 1 splits the batch into that many equal chunks along
    its first axis and sums the chunks' fp32 gradients and losses in
    chunk order, then scales both sums by 1 / accum_steps (ce and aux
    likewise); only one chunk's activations live at a time.
    grad_dtype="bfloat16" casts the gradients before the optimizer, as the
    reference does before its cross-shard reduction. The parameters are
    not marked as requiring gradients: the step differentiates detached
    views of them, and an in-place optimizer (`adamw`) updates the
    tensors it was given. Every LM family trains: the MoE layers' aux
    loss enters the loss as `lm_loss` adds it, and the audio arch's
    targets are (B, S, K).

    With `mesh` (a `launch.mesh.Mesh`), every rank calls the step with
    the GLOBAL batch and its own blocks of the parameters and moments
    (`models.lm.shard_lm_params`; refused otherwise). The step takes its
    rows (`lm_batch_block`; with accum_steps > 1, of each chunk of the
    global batch), runs the sharded model (`models.lm`), whose loss is the
    global masked mean and whose weight gathers reduce-scatter their
    gradients over the batch's axes; then a leaf replicated on an axis
    the batch splits over has its gradient all-reduced there (after the
    bfloat16 cast, when grad_dtype asks for it), and the optimizer clips
    by the norm of every distinct block (`lm_grad_sq_sum`). Without a
    mesh, `rules` changes nothing: the one-device step, bit for bit."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if grad_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"grad_dtype must be float32 or bfloat16, got "
                         f"{grad_dtype!r}")

    shardings = blocks = None
    if mesh is not None:
        shardings = lm_param_shardings(cfg, rules, mesh)
        blocks = [sh.local_shape(s.shape) for sh, s in zip(
            tree_leaves(shardings), tree_leaves(lm_param_specs(cfg)))]

    def check_blocks(params):
        got = [tuple(t.shape) for t in tree_leaves(params)]
        if got != blocks:
            raise ValueError(f"the parameters are not this rank's blocks "
                             f"under the rules: {got} vs {blocks}")

    def block(batch):
        return batch if mesh is None else lm_batch_block(batch, rules, mesh)

    def grads_of(params, batch):
        """(loss, parts, grads) of one batch, all detached."""
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        flat = tree_leaves(leaves)
        with torch.enable_grad():
            if mesh is None:
                loss, parts = lm_loss(leaves, batch, cfg)
            else:
                loss, parts = lm_loss(leaves, block(batch), cfg, rules,
                                      mesh)
            grads = iter(torch.autograd.grad(loss, flat,
                                               materialize_grads=True))
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                tree_map(lambda _: next(grads), leaves))

    def accumulated(params, batch):
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"a batch of {n} does not split into "
                             f"{accum_steps} equal chunks")
        dev = tree_leaves(params)[0].device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        parts_sum = {"ce": loss_sum.clone(), "aux": loss_sum.clone()}
        grads_sum = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
        for i in range(accum_steps):
            mb = {k: _chunk(v, i, accum_steps) for k, v in batch.items()}
            loss, parts, grads = grads_of(params, mb)
            tree_map(lambda a, g: a.add_(g.float()), grads_sum, grads)
            del grads
            loss_sum = loss_sum + loss
            parts_sum = {k: parts_sum[k] + parts[k] for k in parts_sum}
        inv = 1.0 / accum_steps
        tree_map(lambda g: g.mul_(inv), grads_sum)
        return (loss_sum * inv, {k: v * inv for k, v in parts_sum.items()},
                grads_sum)

    def sync(grads):
        """All-reduce each gradient over the batch's axes its leaf does
        not shard on, in place, leaf by leaf in tree order."""
        ba = batch_axes(rules, mesh)
        for g, sh in zip(tree_leaves(grads), tree_leaves(shardings)):
            for a in ba:
                if a not in spec_axes(sh.spec):
                    mesh.all_reduce(g, a, staged=True)
        return grads

    def value_and_grads(params, batch):
        """(loss, parts, grads) as the optimizer receives them: cast to
        grad_dtype and, under a mesh, synced."""
        if mesh is not None:
            check_blocks(params)
        if accum_steps > 1:
            loss, parts, grads = accumulated(params, batch)
        else:
            loss, parts, grads = grads_of(params, batch)
        if grad_dtype == "bfloat16":
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        if mesh is not None:
            grads = sync(grads)
        return loss, parts, grads

    def step(params, opt_state, batch, step_idx):
        loss, parts, grads = value_and_grads(params, batch)
        if mesh is None:
            params, opt_state = opt.apply(params, grads, opt_state, step_idx)
        else:
            params, opt_state = opt.apply(
                params, grads, opt_state, step_idx,
                sq_sum=lambda gs: lm_grad_sq_sum(gs, shardings, mesh))
        return params, opt_state, {"loss": loss, **parts}

    step.value_and_grads = value_and_grads
    return step


def lm_step_collectives(cfg: ModelConfig, rules: LogicalRules, mesh,
                        accum_steps: int = 1, clip: bool = True
                        ) -> dict[str, int]:
    """The collectives one `build_lm_train_step(mesh=)` step issues on a
    rank, by f"{op}@{axis}" (`Mesh.stats`' keys, "_calls" left off),
    worked out from the specs, the rules and the remat mode; a one-rank
    axis issues none. Per microbatch:
      * each weight use (`gather_weight`, `replicate_weight`): an
        all_gather per mesh axis it drops, forward; backward a
        reduce_scatter per such axis the batch splits over;
      * attention over split heads: an all_reduce (wo's partial sums)
        forward, one backward (the input's cotangent; three where the kv
        heads are whole: q's, k's and v's); the MLP over split ff: one and
        one; a MoE layer: two forward over the batch's axes (the aux
        loss's sums), and over split experts one forward (the combine)
        and two backward (the dispatch's input and the gates);
      * the vocabulary split: the embedding's all_reduce, the logits'
        input cotangent, the loss's max and sums; the loss's nll sum and
        mask count over the batch's axes;
      * remat "full": each unit's forward again in the backward, but for
        its trailing partial-sum all_reduce (the recompute stops at the
        last tensor the backward saved).
    Per step: each leaf's gradient all_reduce over the batch's axes it
    does not shard on, and (with clipping) one all_reduce per axis of
    each distinct set of axes the leaves shard on."""
    from repro_torch.models.lm import _pattern_moe_flags, _vocab_axes
    from repro_torch.nn import mamba2 as M
    from repro_torch.nn.sharding import GATHERED_AXES, tp_axes
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"counted for remat none and full, not "
                         f"{cfg.remat!r}")
    live = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
    ba = tuple(a for a in batch_axes(rules, mesh) if a in live)
    out: dict[str, int] = {}

    def add(op, axes, n=1, into=None):
        into = out if into is None else into
        for a in axes:
            if a in live:
                into[f"{op}@{a}"] = into.get(f"{op}@{a}", 0) + n

    def dropped(axes, shape, keep):
        src = spec_axes(resolve_sized(axes, rules, mesh, shape))
        dst = spec_axes(() if keep is None else
                        resolve_sized(keep, rules, mesh, shape))
        return tuple(a for a, i in src.items() if dst.get(a) != i)

    def use(fwd, bwd, axes, shape, gather=True):
        """A weight use: gather_weight's (or replicate_weight's)."""
        if gather:
            if not rules.get("_gather_weights"):
                return
            g = rules.get("_gather_axes", GATHERED_AXES)
            keep = tuple(None if a in g else a for a in axes)
        else:
            keep = None
        for a in dropped(axes, shape, keep):
            add("all_gather", (a,), into=fwd)
            if a in ba:
                add("reduce_scatter", (a,), into=bwd)

    d = cfg.d_model

    def block(kind, is_moe, fwd, bwd) -> dict:
        """Adds one layer's events; returns its trailing forward ones."""
        norm = ["scale"] + (["bias"] if cfg.norm_type == "layernorm" else [])
        trail: dict[str, int] = {}
        for _ in norm:
            use(fwd, bwd, ("embed",), (d,))
        if kind == "a":
            h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
            for axes, shape in ((("embed", "heads", "head_dim"), (d, h, dh)),
                                (("embed", "kv_heads", "head_dim"),
                                 (d, kv, dh)),
                                (("embed", "kv_heads", "head_dim"),
                                 (d, kv, dh)),
                                (("heads", "head_dim", "embed"), (h, dh, d))):
                use(fwd, bwd, axes, shape)
            tq = tp_axes("heads", h, rules, mesh)
            tkv = tp_axes("kv_heads", kv, rules, mesh)
            add("all_reduce", tq, into=fwd)
            add("all_reduce", tq, 1 if tkv else 3, into=bwd)
            trail = {}
            add("all_reduce", tq, into=trail)
        else:
            m = M.mamba_dims(cfg)
            for axes, shape in (
                    (("embed", "ssm_inner"), (d, m["d_in_proj"])),
                    ((None, "conv_dim"), (m["d_conv"], m["conv_dim"])),
                    (("conv_dim",), (m["conv_dim"],)),
                    (("ssm_heads",), (m["n_heads"],)),
                    (("ssm_heads",), (m["n_heads"],)),
                    (("ssm_heads",), (m["n_heads"],)),
                    (("ssm_inner",), (m["d_inner"],)),
                    (("ssm_inner", "embed"), (m["d_inner"], d))):
                use(fwd, bwd, axes, shape, gather=False)
            trail = {}
        if cfg.d_ff <= 0:
            return trail
        for _ in norm:
            use(fwd, bwd, ("embed",), (d,))
        f = cfg.d_ff
        trail = {}
        if is_moe:
            e_pad = cfg.n_experts + cfg.expert_pad
            use(fwd, bwd, ("embed", None), (d, cfg.n_experts))
            for axes, shape in ((("expert", "embed", "ff"), (e_pad, d, f)),
                                (("expert", "embed", "ff"), (e_pad, d, f)),
                                (("expert", "ff", "embed"), (e_pad, f, d))):
                use(fwd, bwd, axes, shape)
            add("all_reduce", ba, 2, into=fwd)
            g = rules.get("_gather_axes", GATHERED_AXES) \
                if rules.get("_gather_weights") else ()
            te = () if "expert" in g else tp_axes("expert", e_pad, rules,
                                                  mesh)
            add("all_reduce", te, into=fwd)
            add("all_reduce", te, 2, into=bwd)
            add("all_reduce", te, into=trail)
        else:
            names = (("wi", "wg", "wo") if cfg.mlp_type == "swiglu"
                     else ("wi", "bi", "wo", "bo"))
            layout = {"wi": (("embed", "ff"), (d, f)),
                      "wg": (("embed", "ff"), (d, f)),
                      "wo": (("ff", "embed"), (f, d)),
                      "bi": (("ff",), (f,)), "bo": (("embed",), (d,))}
            for n in names:
                use(fwd, bwd, *layout[n])
            tf = tp_axes("ff", f, rules, mesh)
            add("all_reduce", tf, into=fwd)
            add("all_reduce", tf, into=bwd)
            add("all_reduce", tf, into=trail)
        return trail

    micro: dict[str, int] = {}
    flags = _pattern_moe_flags(cfg)
    for _ in range(cfg.n_units):
        fwd: dict[str, int] = {}
        bwd: dict[str, int] = {}
        trail: dict[str, int] = {}
        for i, kind in enumerate(cfg.pattern):
            trail = block(kind, flags[i], fwd, bwd)
        for src in (fwd, bwd):
            for k, n in src.items():
                micro[k] = micro.get(k, 0) + n
        if cfg.remat == "full":
            for k, n in fwd.items():
                micro[k] = micro.get(k, 0) + n - trail.get(k, 0)
    v = cfg.vocab_size
    tv = _vocab_axes(cfg, rules, mesh)
    end_f: dict[str, int] = {}
    end_b: dict[str, int] = {}
    if cfg.frontend != "audio":
        use(end_f, end_b, ("vocab", "embed"), (v, d))
        add("all_reduce", tv, into=end_f)
    for _ in ["scale"] + (["bias"] if cfg.norm_type == "layernorm" else []):
        use(end_f, end_b, ("embed",), (d,))
    if cfg.tie_embeddings:
        use(end_f, end_b, ("vocab", "embed"), (v, d))
    elif cfg.frontend == "audio":
        use(end_f, end_b, ("embed", "vocab"), (d, v * cfg.n_codebooks),
            gather=False)
    else:
        use(end_f, end_b, ("embed", "vocab"), (d, v))
    add("all_reduce", tv, into=end_b)
    add("all_reduce", tv, 2, into=end_f)
    add("all_reduce", ba, into=end_f)
    for src in (end_f, end_b):
        for k, n in src.items():
            micro[k] = micro.get(k, 0) + n
    for k, n in micro.items():
        out[k] = n * accum_steps
    from repro_torch.models.lm import lm_param_specs
    groups = []
    for s in tree_leaves(lm_param_specs(cfg)):
        spec = spec_axes(resolve_sized(s.logical_axes, rules, mesh,
                                       s.shape))
        add("all_reduce", tuple(a for a in ba if a not in spec))
        key = tuple(a for a in mesh.axis_names if a in spec)
        if key not in groups:
            groups.append(key)
    if clip:
        for key in groups:
            add("all_reduce", key)
    return out
