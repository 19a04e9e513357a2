"""EmbeddingBagCollection: every sparse-feature table of one model as a
single row-concatenated mega table + a PlacementPlan.

Lookup semantics (paper section III-A.2): each sparse feature is a multi-hot
index list of up to `truncation` entries; each entry fetches one d-vector;
vectors are sum-pooled per (example, feature). The collection consumes
offset global indices with -1 padding and pools every (example, feature)
bag through the hand-written embedding-bag kernel (`ops.embedding_bag`) —
where the reference's main path used a jnp gather, the port's uses the
kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.placement import PlacementPlan, plan_placement
from repro_torch.kernels import ops
from repro_torch.nn.params import ParamSpec


@dataclasses.dataclass(frozen=True)
class EmbeddingBagCollection:
    """All embedding tables fused into one (total_rows, d) mega table,
    looked up bag-pooled per feature under a placement plan."""

    cfg: DLRMConfig
    plan: PlacementPlan

    @classmethod
    def build(cls, cfg: DLRMConfig, n_shards: int = 1,
              strategy: str | None = None) -> EmbeddingBagCollection:
        """Plan placement for cfg's tables and wrap it."""
        plan = plan_placement(
            cfg.hash_sizes, cfg.mean_lookups, cfg.embed_dim, n_shards,
            hbm_budget_bytes=cfg.hbm_budget_gb * 1e9,
            itemsize=4 if cfg.param_dtype == "float32" else 2,
            strategy=strategy or cfg.placement)
        return cls(cfg, plan)

    def param_specs(self) -> dict:
        """The fused mega-table ParamSpec."""
        dt = torch.float32 if self.cfg.param_dtype == "float32" \
            else torch.bfloat16
        return {"mega": ParamSpec((self.plan.total_rows, self.cfg.embed_dim),
                                  dtype=dt, init="normal",
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

    def lookup(self, params: dict, idx: torch.Tensor) -> torch.Tensor:
        """idx: (B, F, L) int32 rows of params["mega"], -1 pads. Returns
        (B, F, d) sum-pooled embeddings: one embedding-bag launch over the
        (B*F, L) view of the batch."""
        mega = params["mega"]
        b, f, lk = idx.shape
        pooled = ops.embedding_bag(mega, idx.reshape(b * f, lk), "sum")
        return pooled.reshape(b, f, -1).to(mega.dtype)

    def table_bytes(self) -> int:
        """Total mega-table bytes at the param dtype."""
        item = 4 if self.cfg.param_dtype == "float32" else 2
        return self.plan.total_rows * self.cfg.embed_dim * item
