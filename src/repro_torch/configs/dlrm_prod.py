"""The paper's production models M1/M2/M3 (Table II).

Hash sizes / lookup counts follow the paper's Fig. 6/7 power-law shapes:
per-table values drawn deterministically from a Pareto matched to the stated
means (5.7M / 7.3M / 3.7M hash entries; 28 / 17 / 49 mean lookups), clipped
to [30, 20M] as in Fig. 6. Embedding dim d = 64; truncation 32. The numpy
calls are the reference package's, so the tables come out identical.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import DLRMConfig


def _powerlaw(n: int, mean: float, lo: float, hi: float, alpha: float,
              seed: int) -> tuple[int, ...]:
    """Deterministic power-law sample rescaled to the requested mean."""
    rng = np.random.RandomState(seed)
    raw = rng.pareto(alpha, size=n) + 1.0
    raw = np.clip(raw / raw.mean() * mean, lo, hi)
    raw = np.clip(raw * (mean / raw.mean()), lo, hi)
    return tuple(int(round(v)) for v in raw)


def _dlrm(name: str, n_sparse: int, n_dense: int, hash_mean: float,
          lookups_mean: float, bottom: tuple[int, ...],
          top: tuple[int, ...], seed: int, notes: str) -> DLRMConfig:
    return DLRMConfig(
        name=name, n_dense_features=n_dense, n_sparse_features=n_sparse,
        embed_dim=64,
        hash_sizes=_powerlaw(n_sparse, hash_mean, 30, 2e7, 1.2, seed),
        mean_lookups=_powerlaw(n_sparse, lookups_mean, 1, 200, 1.5, seed + 1),
        truncation=32,
        bottom_mlp=bottom + (64,), top_mlp=top + (1,),
        interaction="dot", notes=notes)


DLRMS: dict[str, DLRMConfig] = {
    # Table II: 30 sparse / 800 dense, EMB tens of GB, 28 mean lookups
    "dlrm-m1": _dlrm("dlrm-m1", 30, 800, 5.7e6, 28, (512,),
                     (512, 512, 512), 11, "M1_prod (Table II)"),
    "dlrm-m2": _dlrm("dlrm-m2", 13, 504, 7.3e6, 17, (1024,),
                     (1024, 1024, 512), 22, "M2_prod (Table II)"),
    "dlrm-m3": _dlrm("dlrm-m3", 127, 809, 3.7e6, 49, (512,),
                     (512, 256, 512, 256, 512), 33,
                     "M3_prod (Table II) — embedding-dominant"),
}
