"""Config registry for the port: the paper's production DLRMs and their
reduced smoke configs. The LM architectures join with the LM slice."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import DLRMConfig
from repro_torch.configs.dlrm_prod import DLRMS

ARCH_NAMES: list[str] = list(DLRMS)


def _smoke_dlrm(cfg: DLRMConfig) -> DLRMConfig:
    n = min(cfg.n_sparse_features, 6)
    return dataclasses.replace(
        cfg,
        n_dense_features=32, n_sparse_features=n,
        embed_dim=16,
        hash_sizes=tuple([101, 211, 331, 97, 53, 1009][:n]),
        mean_lookups=tuple([3, 5, 2, 8, 1, 4][:n]),
        truncation=8,
        bottom_mlp=(32, 16), top_mlp=(32, 16, 1),
        hbm_budget_gb=0.001,
    )


def get_config(name: str) -> DLRMConfig:
    """Full-size config by name (DLRM names only in this slice)."""
    if name in DLRMS:
        return DLRMS[name]
    raise KeyError(f"unknown arch {name!r}; the port knows {ARCH_NAMES} "
                   "(the LM configs arrive with the LM-zoo slice)")


def get_smoke_config(name: str) -> DLRMConfig:
    """Reduced CPU-test config of the same family."""
    return _smoke_dlrm(get_config(name))
