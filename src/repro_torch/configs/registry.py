"""Config registry of the port: the reference's ten LM architectures
(dense, MoE, SSM, hybrid, and the vision and audio frontends; one module
per arch), the paper's production DLRMs, and their reduced smoke configs
of the same family for CPU tests."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (chatglm3_6b, granite_moe_1b_a400m,
                                 granite_moe_3b_a800m, internvl2_26b,
                                 jamba_v0_1_52b, mamba2_780m, musicgen_large,
                                 qwen1_5_32b, stablelm_1_6b, starcoder2_3b)
from repro_torch.configs.base import (DLRMConfig, ModelConfig, Shape,
                                      shapes_for)
from repro_torch.configs.dlrm_prod import DLRMS

_ARCH_MODULES = (starcoder2_3b, stablelm_1_6b, qwen1_5_32b, chatglm3_6b,
                 mamba2_780m, granite_moe_1b_a400m, granite_moe_3b_a800m,
                 internvl2_26b, musicgen_large, jamba_v0_1_52b)

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                 for m in _ARCH_MODULES}

ARCH_NAMES: list[str] = list(ARCHS) + list(DLRMS)


def _smoke(cfg: ModelConfig) -> ModelConfig:
    period = len(cfg.pattern)
    heads = min(cfg.n_heads, 4) if cfg.n_heads else 0
    kv = min(cfg.n_kv_heads, heads) if cfg.n_kv_heads else 0
    if kv and heads % kv:
        kv = 1
    return dataclasses.replace(
        cfg,
        n_layers=2 * period,
        d_model=64,
        n_heads=heads, n_kv_heads=kv, d_head=16 if heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        attn_block_q=16, attn_block_k=16,
        remat="none", fsdp=False,
    )


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


def get_config(name: str) -> ModelConfig | DLRMConfig:
    """Full-size config by name."""
    if name in ARCHS:
        return ARCHS[name]
    if name in DLRMS:
        return DLRMS[name]
    raise KeyError(f"unknown arch {name!r}; the port knows {ARCH_NAMES}")


def get_smoke_config(name: str) -> ModelConfig | DLRMConfig:
    """Reduced CPU-test config of the same family."""
    cfg = get_config(name)
    return _smoke_dlrm(cfg) if isinstance(cfg, DLRMConfig) else _smoke(cfg)


def list_cells(include_dlrm: bool = True) -> list[tuple[str, Shape]]:
    """Every (arch x shape) cell, in the reference's order: each LM arch
    with its shapes (`shapes_for`), then each DLRM with its."""
    names = list(ARCHS) + (list(DLRMS) if include_dlrm else [])
    return [(name, shape) for name in names
            for shape in shapes_for(name).values()]
