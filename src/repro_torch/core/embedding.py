"""EmbeddingBagCollection: every sparse-feature table of one model as a
single row-concatenated mega table + a PlacementPlan.

Lookup semantics (paper section III-A.2): each sparse feature is a multi-hot
index list of up to `truncation` entries; each entry fetches one d-vector;
vectors are sum-pooled per (example, feature). The collection consumes
offset global indices with -1 padding and pools every (example, feature)
bag through a hand-written kernel — `ops.embedding_bag`, or, when the batch
carries a `SparsePlan`, `ops.dedup_embedding_bag` — where the reference's
main path used a jnp gather.

Under a (data, model) mesh (`launch.mesh`) each rank holds one `model`
shard of the rows: `lookup_local` pools the bags over the shard's own rows
only, and `lookup_pooled_psum` sums those partial pools over the `model`
axis — the paper's parameter server pooling before the exchange, so the
(B, F, d) pooled tensor crosses ranks, never the (B, F, L, d) rows.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.placement import PlacementPlan, plan_placement
from repro_torch.kernels import ops
from repro_torch.kernels.sparse_plan import SparsePlan
from repro_torch.nn.params import ParamSpec


@dataclasses.dataclass(frozen=True)
class EmbeddingBagCollection:
    """All embedding tables fused into one (total_rows, d) mega table,
    looked up bag-pooled per feature under a placement plan."""

    cfg: DLRMConfig
    plan: PlacementPlan

    @classmethod
    def build(cls, cfg: DLRMConfig, n_shards: int = 1,
              strategy: str | None = None,
              second_axis_size: int = 1,
              capacity_shards: int = 1) -> EmbeddingBagCollection:
        """Plan placement for cfg's tables and wrap it."""
        plan = plan_placement(
            cfg.hash_sizes, cfg.mean_lookups, cfg.embed_dim, n_shards,
            hbm_budget_bytes=cfg.hbm_budget_gb * 1e9,
            itemsize=4 if cfg.param_dtype == "float32" else 2,
            strategy=strategy or cfg.placement,
            second_axis_size=second_axis_size,
            capacity_shards=capacity_shards)
        return cls(cfg, plan)

    def param_specs(self) -> dict:
        """The fused mega-table ParamSpec."""
        dt = torch.float32 if self.cfg.param_dtype == "float32" \
            else torch.bfloat16
        return {"mega": ParamSpec((self.plan.total_rows, self.cfg.embed_dim),
                                  ("hash", "table_dim"), dtype=dt,
                                  init="normal",
                                  scale=1.0 / np.sqrt(self.cfg.embed_dim))}

    def offset_indices(self, raw):
        """raw: (B, F, L) per-table indices in [0, hash_size_f) or -1 pad
        (numpy array or tensor). Returns global mega-table rows of the same
        kind, still -1 padded."""
        if isinstance(raw, torch.Tensor):
            off = torch.as_tensor(self.plan.table_offsets, dtype=raw.dtype,
                                  device=raw.device)
            return torch.where(raw >= 0, raw + off[None, :, None], -1)
        raw = np.asarray(raw)
        off = np.asarray(self.plan.table_offsets, raw.dtype)
        return np.where(raw >= 0, raw + off[None, :, None], -1).astype(
            raw.dtype)

    def optimizer_specs(self) -> dict:
        """Row-wise AdaGrad second-moment accumulator, one fp32 per row."""
        return {"accum": ParamSpec((self.plan.total_rows,), ("hash",),
                                   dtype=torch.float32, init="zeros")}

    def pspecs(self) -> dict:
        """Partition specs of the params, from the plan (`nn.sharding`'s
        form: a tuple of None or mesh axis names a dimension)."""
        return {"mega": self.plan.pspec}

    def optimizer_pspecs(self) -> dict:
        """Partition specs of the optimizer state: the table's row
        dimension only."""
        return {"accum": tuple(self.plan.pspec[:1])}

    def lookup(self, params: dict, idx: torch.Tensor,
               plan: SparsePlan | None = None) -> torch.Tensor:
        """idx: (B, F, L) int32 rows of params["mega"], -1 pads. Returns
        (B, F, d) sum-pooled embeddings: one kernel launch over the
        (B*F, L) view of the batch.

        With `plan` (a SparsePlan over idx's flat stream, e.g. the one
        `data.pipeline.sparse_plan_hook` attaches) the lookup reads each
        unique row once (`ops.dedup_embedding_bag`); the result is bit-equal
        to the plan-less `ops.embedding_bag`."""
        mega = params["mega"]
        b, f, lk = idx.shape
        flat = idx.reshape(b * f, lk)
        if plan is None:
            pooled = ops.embedding_bag(mega, flat, "sum")
        else:
            pooled = ops.dedup_embedding_bag(mega, flat, plan, "sum")
        return pooled.reshape(b, f, -1).to(mega.dtype)

    def lookup_local(self, mega_shard: torch.Tensor, idx: torch.Tensor,
                     row_lo: int, row_hi: int,
                     dedup: bool = False) -> torch.Tensor:
        """The partial pool of one shard: `mega_shard` holds the global
        rows [row_lo, row_hi); every other row of idx (B, F, L) counts as
        a pad. Returns (B, F, d) fp32 sums over the shard's rows, through
        `ops.embedding_bag` or, with `dedup`, `ops.dedup_embedding_bag`
        (planned on the device over the shard-local stream). A bag with no
        row here sums to +0.0, so summing the partials of all shards adds
        exact zeros to each bag's owner's sum."""
        b, f, lk = idx.shape
        local = torch.where((idx >= row_lo) & (idx < row_hi),
                            idx - row_lo, -1).to(torch.int32).reshape(
                                b * f, lk)
        if dedup:
            out = ops.dedup_embedding_bag(mega_shard, local, None, "sum")
        else:
            out = ops.embedding_bag(mega_shard, local, "sum")
        return out.reshape(b, f, -1)

    def shard_range(self, mesh, model_axis: str = "model") -> tuple[int, int]:
        """Global rows [lo, hi) of this rank's shard: the table split into
        mesh.size(model_axis) equal row blocks (the reference's P(model,
        None)), block m on the ranks at `model` coordinate m."""
        if self.plan.pspec != (model_axis, None):
            raise ValueError(
                f"a {self.plan.strategy} placement shards the table as "
                f"{self.plan.pspec}; the psum executors need rows split over "
                f"{model_axis!r} alone: ({model_axis!r}, None)")
        m = mesh.size(model_axis)
        if self.plan.total_rows % m:
            raise ValueError(f"{self.plan.total_rows} rows do not split "
                             f"into {m} {model_axis} shards")
        rows = self.plan.total_rows // m
        lo = mesh.coords[model_axis] * rows
        return lo, lo + rows

    def lookup_pooled_psum(self, params: dict, idx: torch.Tensor, mesh,
                           model_axis: str = "model") -> torch.Tensor:
        """The sharded lookup with pooling before the exchange: this
        rank's partial pools (`lookup_local` on params["mega"], its
        `shard_range` rows) summed over the `model` axis, one all_reduce
        of a (B, F, d) fp32 tensor. idx: (B, F, L) global rows of this
        rank's slice of the batch over the other axes. Returns (B, F, d)
        in the table's dtype.

        The reference pools with a jnp gather and a sum; here the kernel
        pools. Under table_wise every bag lives on one owner and the
        others add exact zeros, so the result is bit-equal to `lookup`;
        under row_wise a bag split between shards sums its two partials
        in another order (within 1e-5 of `lookup`)."""
        lo, hi = self.shard_range(mesh, model_axis)
        mega = params["mega"]
        if mega.shape[0] != hi - lo:
            raise ValueError(f"params['mega'] holds {mega.shape[0]} rows; "
                             f"this rank's shard is [{lo}, {hi})")
        pooled = self.lookup_local(mega, idx, lo, hi).float()
        return mesh.all_reduce(pooled, model_axis).to(mega.dtype)

    def per_lookup_grads(self, idx: torch.Tensor, pooled_grad: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
        """LEGACY layout: under sum pooling every lookup slot inherits its
        bag's gradient, so this materializes the (B*F*L, d) broadcast the
        fused sparse backward exists to avoid. It is the input of
        `ops.rowwise_adagrad_update`, the two-pass oracle of the fused
        update.

        idx: (B, F, L); pooled_grad: (B, F, d). Returns (flat_idx
        (B*F*L,), flat_grads (B*F*L, d))."""
        b, f, lk = idx.shape
        g = pooled_grad[:, :, None, :].expand(b, f, lk, pooled_grad.shape[-1])
        return idx.reshape(-1), g.reshape(b * f * lk, -1)

    def lookups_per_example(self) -> float:
        """Mean pooled lookups per example across features."""
        return float(sum(self.cfg.mean_lookups))

    def table_bytes(self) -> int:
        """Total mega-table bytes at the param dtype."""
        item = 4 if self.cfg.param_dtype == "float32" else 2
        return self.plan.total_rows * self.cfg.embed_dim * item
