"""Synthetic DLRM click logs and LM token batches (the reference package's
generators, in numpy).

Per-table multi-hot index lists whose LENGTHS follow the paper's power-law
(Fig. 7) and whose INDEX values follow a Zipf over the hash space (Fig. 6);
labels come from a planted logistic model. The numpy calls, their order and
their seeds are the reference's, so a batch is bit-identical to
`repro.data.synthetic.make_dlrm_batch`'s (and `make_lm_batch`'s) for the
same arguments.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig, ModelConfig


def _zipf_indices(rng: np.random.RandomState, hash_size: int, n: int,
                  a: float = 1.3) -> np.ndarray:
    """Zipf-ish draws clipped into [0, hash_size)."""
    raw = rng.zipf(a, size=n) - 1
    return (raw % max(hash_size, 1)).astype(np.int32)


_ZIPF_CDF_CACHE: dict = {}


def _bounded_zipf_cdf(hash_size: int, alpha: float) -> np.ndarray:
    """CDF of the rank-probability Zipf p(r) ∝ (r+1)^-alpha over
    [0, hash_size); cached per (size, alpha)."""
    key = (hash_size, round(alpha, 6))
    cdf = _ZIPF_CDF_CACHE.get(key)
    if cdf is None:
        p = (np.arange(1, hash_size + 1, dtype=np.float64)) ** (-alpha)
        cdf = np.cumsum(p / p.sum())
        _ZIPF_CDF_CACHE[key] = cdf
    return cdf


def bounded_zipf_rows(rng: np.random.RandomState, hash_size: int, n: int,
                      alpha: float) -> np.ndarray:
    """n draws from the bounded Zipf(alpha) over [0, hash_size): row 0 is
    the hottest. Inverse-CDF sampling."""
    cdf = _bounded_zipf_cdf(hash_size, alpha)
    return np.searchsorted(cdf, rng.rand(n)).astype(np.int32)


def make_dlrm_batch(cfg: DLRMConfig, batch: int, step: int = 0,
                    seed: int = 0,
                    zipf_alpha: float | None = None
                    ) -> dict[str, np.ndarray]:
    """Returns {dense (B, n_dense) f32, idx (B, F, L) i32 (-1 pads, in-table
    — NOT offset), label (B,) f32}. `zipf_alpha=None` keeps the per-example
    rng.zipf(1.3) draw; a value switches to the bounded Zipf."""
    rng = np.random.RandomState(seed * 1_000_003 + step)
    f, trunc = cfg.n_sparse_features, cfg.truncation
    dense = rng.randn(batch, cfg.n_dense_features).astype(np.float32)

    idx = np.full((batch, f, trunc), -1, np.int32)
    planted = 0.0
    for t in range(f):
        mean_len = min(cfg.mean_lookups[t], trunc)
        lens = np.clip(rng.poisson(mean_len, size=batch), 1, trunc)
        if zipf_alpha is not None:
            vals = bounded_zipf_rows(rng, cfg.hash_sizes[t], batch * trunc,
                                     zipf_alpha).reshape(batch, trunc)
            mask = np.arange(trunc)[None, :] < lens[:, None]
            idx[:, t, :] = np.where(mask, vals, -1)
        else:
            for b in range(batch):
                vals = _zipf_indices(rng, cfg.hash_sizes[t], lens[b])
                idx[b, t, :lens[b]] = vals
        planted = planted + (idx[:, t, 0] % 7 - 3)

    score = dense[:, :8].mean(axis=1) * 2.0 + planted * 0.3
    prob = 1.0 / (1.0 + np.exp(-score))
    label = (rng.rand(batch) < prob).astype(np.float32)
    return {"dense": dense, "idx": idx, "label": label}


def vlm_prefix(seq_len: int) -> int:
    """The vision arch's patch-prefix length within `seq_len` positions:
    256 patches, bounded for short smoke sequences."""
    return min(256, max(4, seq_len // 8))


def make_lm_batch(cfg: ModelConfig, batch: int, seq_len: int, step: int = 0,
                  seed: int = 0) -> dict[str, np.ndarray]:
    """An LM batch of `seq_len` positions. Token archs: {tokens (B, S) i32,
    targets (B, S) i32 (tokens shifted by one, a fresh draw last),
    loss_mask (B, S) f32 ones}. The vision arch: {embeds (B, P, D) f32,
    the stub frontend's patch embeddings (P = vlm_prefix(S)), tokens (B, S
    - P), targets (B, S), loss_mask zero over the P patches}. The audio
    arch: {embeds (B, S, D) f32 frame embeddings, targets (B, S, K) i32,
    loss_mask ones}."""
    rng = np.random.RandomState(seed * 7_777_777 + step + 1)
    if cfg.frontend == "vision":
        prefix = vlm_prefix(seq_len)
        text = seq_len - prefix
        embeds = rng.randn(batch, prefix,
                           cfg.d_model).astype(np.float32) * 0.02
        tokens = rng.randint(0, cfg.vocab_size,
                             size=(batch, text)).astype(np.int32)
        targets = rng.randint(0, cfg.vocab_size,
                              size=(batch, seq_len)).astype(np.int32)
        mask = np.concatenate([np.zeros((batch, prefix), np.float32),
                               np.ones((batch, text), np.float32)], axis=1)
        return {"embeds": embeds, "tokens": tokens, "targets": targets,
                "loss_mask": mask}
    if cfg.frontend == "audio":
        embeds = rng.randn(batch, seq_len,
                           cfg.d_model).astype(np.float32) * 0.02
        targets = rng.randint(
            0, cfg.vocab_size,
            size=(batch, seq_len, cfg.n_codebooks)).astype(np.int32)
        return {"embeds": embeds, "targets": targets,
                "loss_mask": np.ones((batch, seq_len), np.float32)}
    tokens = rng.randint(0, cfg.vocab_size,
                         size=(batch, seq_len)).astype(np.int32)
    targets = np.concatenate(
        [tokens[:, 1:], rng.randint(0, cfg.vocab_size, size=(batch, 1))],
        axis=1).astype(np.int32)
    return {"tokens": tokens, "targets": targets,
            "loss_mask": np.ones((batch, seq_len), np.float32)}


def lm_batch_specs(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """`make_lm_batch`'s leaves on the meta device (the reference's
    ShapeDtypeStruct stand-ins for the dry run): shapes and dtypes, no
    memory."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    i32, f32 = torch.int32, torch.float32
    if cfg.frontend == "vision":
        prefix = vlm_prefix(seq_len)
        return {"embeds": meta((batch, prefix, cfg.d_model), f32),
                "tokens": meta((batch, seq_len - prefix), i32),
                "targets": meta((batch, seq_len), i32),
                "loss_mask": meta((batch, seq_len), f32)}
    if cfg.frontend == "audio":
        return {"embeds": meta((batch, seq_len, cfg.d_model), f32),
                "targets": meta((batch, seq_len, cfg.n_codebooks), i32),
                "loss_mask": meta((batch, seq_len), f32)}
    return {"tokens": meta((batch, seq_len), i32),
            "targets": meta((batch, seq_len), i32),
            "loss_mask": meta((batch, seq_len), f32)}


def dlrm_batch_specs(cfg: DLRMConfig, batch: int) -> dict:
    """`make_dlrm_batch`'s leaves, indices already offset, on the meta
    device (the dry run's stand-ins)."""
    return {"dense": torch.empty((batch, cfg.n_dense_features),
                                 dtype=torch.float32, device="meta"),
            "idx": torch.empty((batch, cfg.n_sparse_features,
                                cfg.truncation), dtype=torch.int32,
                               device="meta"),
            "label": torch.empty((batch,), dtype=torch.float32,
                                 device="meta")}
