"""Batched CTR inference over the read-only cached embedding tier.

The LM slot engine (`ServeEngine`) comes with the LM-zoo slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dlrm import dlrm_forward_dense


def dlrm_probs(dense_params: dict, cfg, cc, table: torch.Tensor,
               dense_x: np.ndarray, local_idx: np.ndarray) -> np.ndarray:
    """The serving forward: pooled lookup of `local_idx` (slot indices into
    `table`) through the embedding-bag kernel, the dense tower, sigmoid.
    Returns (B,) fp32 click probabilities on the host."""
    dev = table.device
    with torch.inference_mode():
        pooled = cc.lookup_cached(_TableView(table), local_idx)
        dense = torch.from_numpy(np.ascontiguousarray(dense_x,
                                                      np.float32)).to(dev)
        logits = dlrm_forward_dense(dense_params, dense, pooled, cfg)
        return torch.sigmoid(logits).cpu().numpy()


class DLRMEngine:
    """Batched CTR inference with the cached embedding tier in READ-ONLY
    mode: the mega table stays in the capacity tier, hot rows are served
    from the device cache, misses fetch on demand, and eviction never
    writes back (no row is ever dirtied).

    The engine's cache state takes ownership of `params["emb"]["mega"]`
    (see `CachedEmbeddingBagCollection.init_state`); serving never writes
    the capacity tier, so read-only engines may share one mega tensor."""

    def __init__(self, params, cfg, cc):
        self.cfg = cfg
        self.cc = cc
        self.dense = {"bottom": params["bottom"], "top": params["top"]}
        self.state = cc.init_state(params["emb"]["mega"])
        self.requests_served = 0

    def _split_spans(self, idx: np.ndarray) -> list[tuple[int, int]]:
        """Greedy prefix packing: contiguous example spans whose cumulative
        unique-row working set fits the device cache, computed before any
        dispatch. A single example whose own working set exceeds the cache
        raises with the actual sizes."""
        b = idx.shape[0]
        c = self.cc.cache_rows
        mark = np.zeros((self.cc.ebc.plan.total_rows,), bool)
        touched: list[np.ndarray] = []
        spans: list[tuple[int, int]] = []
        start, count, e = 0, 0, 0
        while e < b:
            rows = np.unique(idx[e][idx[e] >= 0])
            new = rows[~mark[rows]]
            if count + len(new) > c:
                if e == start:
                    raise ValueError(
                        f"single example touches {len(rows)} unique rows > "
                        f"cache_rows={c}; it cannot be split further — "
                        "raise the HBM budget or shorten the example's "
                        "multi-hot lists")
                spans.append((start, e))
                for t in touched:
                    mark[t] = False
                touched.clear()
                start, count = e, 0
                continue        # re-evaluate e against the fresh span
            mark[new] = True
            touched.append(new)
            count += len(new)
            e += 1
        if b:
            spans.append((start, b))
        return spans

    def predict(self, batch: dict) -> np.ndarray:
        """batch: {"dense" (B, n_dense), "idx" (B, F, L) OFFSET global
        rows}. Returns (B,) click probabilities. A batch whose working set
        exceeds the cache is split into spans that fit; the tier is
        read-only, so splitting is exact."""
        idx = np.asarray(batch["idx"])
        dense_x = np.asarray(batch["dense"])
        if idx.shape[0] == 0:
            return np.zeros((0,), np.float32)
        outs = []
        for s, e in self._split_spans(idx):
            local = self.cc.take(self.state, idx[s:e], train=False)
            outs.append(dlrm_probs(self.dense, self.cfg, self.cc,
                                   self.state.cache, dense_x[s:e], local))
        self.requests_served += int(idx.shape[0])
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    @property
    def cache_stats(self):
        """Live `CacheStats` of the serving cache state."""
        return self.state.stats


class _TableView:
    """Duck-typed CacheState carrying only what lookup_cached reads."""

    def __init__(self, cache: torch.Tensor):
        self.cache = cache
