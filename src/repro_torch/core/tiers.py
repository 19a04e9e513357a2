"""The async exchange stream as an embedding tier.

`AsyncCachedTier(cc)` maps the tier protocol (`take`, `stage`,
`prefetch_rows`, `commit`, `flush`, `materialize`) onto the wrapped
collection's *_async methods, so the schedule is a tier choice:
`train.steps.build_cached_train_step` runs the overlapped schedule for an
`AsyncCachedTier` and the sync one for the bare collection.

Ported from `repro.core.tiers` without the pieces of later slices: the
`EmbeddingTier` protocol with its conformance check, the bulk store and the
three-tier collection.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.cache import (AsyncCacheState, CacheStats,
                                    CachedEmbeddingBagCollection)
from repro_torch.core.embedding import EmbeddingBagCollection


@dataclasses.dataclass(frozen=True)
class AsyncCachedTier:
    """The wrapped collection's async stream as a tier. State is an
    AsyncCacheState; results are bit-equal to the sync schedule's."""

    cc: CachedEmbeddingBagCollection

    @property
    def ebc(self) -> EmbeddingBagCollection:
        """The wrapped embedding collection."""
        return self.cc.ebc

    @property
    def cache_rows(self) -> int:
        """Device-tier height of the wrapped collection."""
        return self.cc.cache_rows

    def init_state(self, mega: torch.Tensor,
                   accum: torch.Tensor | None = None) -> AsyncCacheState:
        """`init_async_state` (takes ownership of mega and accum)."""
        return self.cc.init_async_state(mega, accum)

    def take(self, state: AsyncCacheState, idx, train: bool = True,
             plan=None) -> np.ndarray:
        """`take_async`: pop the staged plan (or plan now), mark it in
        flight, commit the pending fetches."""
        return self.cc.take_async(state, idx, train=train, plan=plan)

    def stage(self, state: AsyncCacheState, idx, train: bool = True,
              plan=None) -> np.ndarray:
        """`stage_async`: queue the next batch's shadow fetch behind the
        in-flight step."""
        return self.cc.stage_async(state, idx, train=train, plan=plan)

    def prefetch_rows(self, state: AsyncCacheState, rows,
                      gate: bool = False) -> int:
        """`stage_rows` (queued best-effort lookahead)."""
        return self.cc.stage_rows(state, rows, gate=gate)

    def commit(self, state: AsyncCacheState) -> int:
        """`commit_async` (drain the pending queue)."""
        return self.cc.commit_async(state)

    def flush(self, state: AsyncCacheState) -> int:
        """`flush_async`."""
        return self.cc.flush_async(state)

    def materialize(self, state: AsyncCacheState
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """`materialize_async`."""
        return self.cc.materialize_async(state)

    def stats(self, state: AsyncCacheState) -> CacheStats:
        """The tier's CacheStats."""
        return state.stats

    def placement(self) -> dict:
        """The wrapped layout, restamped as the async stream."""
        return {**self.cc.placement(), "stream": "async"}

    def plan_to_slots(self, state: AsyncCacheState, batch: dict) -> dict:
        """Relabel a host plan onto the cache slab (the collection's
        `plan_to_slots`)."""
        return self.cc.plan_to_slots(state, batch)

    def mark_updated(self, state: AsyncCacheState, new_cache: torch.Tensor,
                     new_cache_accum: torch.Tensor) -> None:
        """Install post-update cache tensors (`mark_updated`)."""
        self.cc.mark_updated(state, new_cache, new_cache_accum)

    def lookup(self, state: AsyncCacheState, idx,
               train: bool = False) -> torch.Tensor:
        """Pooled lookup through the async stream (`lookup_async`)."""
        return self.cc.lookup_async(state, idx, train=train)
