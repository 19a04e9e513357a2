"""The DLRM model (paper Fig. 3): bottom MLP over dense features ->
EmbeddingBagCollection over sparse features -> feature interaction -> top
MLP -> logit. This slice ports the forward (serving); the split dense /
sparse training step comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.core.interaction import interact, interaction_dim
from repro_torch.nn.layers import linear, linear_specs
from repro_torch.nn.params import init_params


def _mlp_specs(dims, in_dim: int):
    specs, d = [], in_dim
    for width in dims:
        specs.append(linear_specs(d, width, bias=True))
        d = width
    return specs, d


def dlrm_param_specs(cfg: DLRMConfig, ebc: EmbeddingBagCollection) -> dict:
    """ParamSpec tree for the full DLRM — the reference's layout: bottom /
    top MLP layer lists of {w (in, out), b} + the collection's mega table."""
    bottom, bot_out = _mlp_specs(cfg.bottom_mlp, cfg.n_dense_features)
    if bot_out != cfg.embed_dim:
        raise ValueError(f"bottom MLP must end at embed_dim: {bot_out} != "
                         f"{cfg.embed_dim}")
    top_in = interaction_dim(cfg.n_sparse_features, cfg.embed_dim,
                             cfg.interaction)
    top, top_out = _mlp_specs(cfg.top_mlp, top_in)
    if top_out != 1:
        raise ValueError(f"top MLP must end at 1, got {top_out}")
    return {"bottom": bottom, "top": top, "emb": ebc.param_specs()}


def init_dlrm_params(cfg: DLRMConfig, ebc: EmbeddingBagCollection,
                     seed: int, device: torch.device) -> dict:
    """Random DLRM parameters on `device` from a generator seeded `seed`."""
    return init_params(dlrm_param_specs(cfg, ebc), seed, device)


def _compute_dtype(cfg: DLRMConfig) -> torch.dtype:
    return torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16


def _mlp_apply(layers, x, dtype):
    for i, p in enumerate(layers):
        x = linear(p, x, dtype)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def dlrm_forward_dense(params: dict, dense_x: torch.Tensor,
                       pooled: torch.Tensor, cfg: DLRMConfig) -> torch.Tensor:
    """Everything downstream of the embedding lookup.

    dense_x: (B, n_dense); pooled: (B, F, d). Returns (B,) fp32 logits."""
    dtype = _compute_dtype(cfg)
    bot = _mlp_apply(params["bottom"], dense_x.to(dtype), dtype)
    top_in = interact(bot, pooled.to(dtype), cfg.interaction)
    logit = _mlp_apply(params["top"], top_in, dtype)
    return logit[..., 0].float()


def dlrm_forward(params: dict, batch: dict, cfg: DLRMConfig,
                 ebc: EmbeddingBagCollection) -> torch.Tensor:
    """Full forward: embedding lookup + dense tower -> (B,) logits.
    batch: {"dense" (B, n_dense), "idx" (B, F, L) int32 offset rows}."""
    pooled = ebc.lookup(params["emb"], batch["idx"])
    return dlrm_forward_dense(params, batch["dense"], pooled, cfg)


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits))))


def normalized_entropy(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """The paper's model-quality metric (section VI-C): BCE normalized by
    the entropy of the base CTR."""
    bce = _bce(logits, labels)
    p = torch.clamp(torch.mean(labels), 1e-6, 1 - 1e-6)
    base = -(p * torch.log(p) + (1 - p) * torch.log(1 - p))
    return bce / base
