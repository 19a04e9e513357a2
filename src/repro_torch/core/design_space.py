"""The paper's section-V design-space test suite, as code.

"To explore the design space of training model configurations, we created a
model containing basic components of recommendation models" — this module
builds that parameterized model: dense features 64..4096, sparse features
4..128, FIXED hash size for all tables (default 100000, as in Figs. 10-13),
lookups truncated to 32, MLP dims width^layers.

Each sweep_* function returns the configs (or batches) of one paper
figure, in the reference package's names and order; `chip_smoke.py`'s
phases 15a-15d train every point on the card.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import DLRMConfig


def test_suite_config(n_dense: int = 512, n_sparse: int = 32,
                      hash_size: int = 100_000, mlp_width: int = 512,
                      mlp_layers: int = 3, lookups: int = 32,
                      embed_dim: int = 64,
                      interaction: str = "dot") -> DLRMConfig:
    """One point of the section-V suite: constant hash size (removes indexing
    noise), truncation 32, MLP dims width^layers."""
    return DLRMConfig(
        name=f"suite-d{n_dense}-s{n_sparse}-h{hash_size}"
             f"-m{mlp_width}x{mlp_layers}",
        n_dense_features=n_dense,
        n_sparse_features=n_sparse,
        embed_dim=embed_dim,
        hash_sizes=(hash_size,) * n_sparse,
        mean_lookups=(lookups,) * n_sparse,
        truncation=32,
        bottom_mlp=(mlp_width,) * mlp_layers + (embed_dim,),
        top_mlp=(mlp_width,) * mlp_layers + (1,),
        interaction=interaction,
        notes="section V test suite")


def sweep_fig10() -> list[tuple[str, DLRMConfig]]:
    """Fig. 10: dense x sparse feature grid (MLP 512^3, hash 100k)."""
    out = []
    for n_dense in (64, 256, 1024, 4096):
        for n_sparse in (4, 16, 64, 128):
            cfg = test_suite_config(n_dense=n_dense, n_sparse=n_sparse)
            out.append((f"dense{n_dense}_sparse{n_sparse}", cfg))
    return out


def sweep_fig11_batch() -> list[int]:
    """Fig. 11: batch-size scaling (model fixed; batch is the x-axis)."""
    return [128, 256, 512, 1024, 2048, 4096, 8192]


def sweep_fig12_hash() -> list[tuple[str, DLRMConfig]]:
    """Fig. 12: hash-size scaling (table capacity grows, lookups constant)."""
    out = []
    for h in (10_000, 100_000, 1_000_000, 5_000_000, 10_000_000):
        out.append((f"hash{h}", test_suite_config(hash_size=h)))
    return out


def sweep_fig13_mlp() -> list[tuple[str, DLRMConfig]]:
    """Fig. 13: MLP dimension sweep width^layers."""
    out = []
    for width, layers in ((64, 2), (128, 2), (256, 3), (512, 3),
                          (1024, 3), (2048, 4)):
        out.append((f"mlp{width}x{layers}",
                    test_suite_config(mlp_width=width, mlp_layers=layers)))
    return out


def reduced(cfg: DLRMConfig, factor: int = 16) -> DLRMConfig:
    """Shrink a suite config for CPU runs while keeping ratios."""
    return dataclasses.replace(
        cfg,
        n_dense_features=max(8, cfg.n_dense_features // factor),
        n_sparse_features=max(2, cfg.n_sparse_features // factor),
        hash_sizes=tuple(max(64, h // factor)
                         for h in cfg.hash_sizes)[
                             :max(2, cfg.n_sparse_features // factor)],
        mean_lookups=cfg.mean_lookups[:max(2, cfg.n_sparse_features
                                           // factor)],
        bottom_mlp=tuple(max(8, w // factor) for w in cfg.bottom_mlp[:-1])
        + (cfg.embed_dim // 4,),
        top_mlp=tuple(max(8, w // factor) for w in cfg.top_mlp[:-1]) + (1,),
        embed_dim=cfg.embed_dim // 4,
    )
