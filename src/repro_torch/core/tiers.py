"""N-tier embedding memory behind one `EmbeddingTier` protocol.

Ported from `repro.core.tiers`:

  `EmbeddingTier`   the runtime-checkable protocol every cached collection
                    implements (`take`, `stage`, `prefetch_rows`, `commit`,
                    `flush`, `materialize`, `state_dict`/`load_state_dict`,
                    `stats`, `placement`); `train.steps`,
                    `train.fault_tolerance` and the launchers consume tiers
                    through it, and `tier_conformance` checks it.
  (`core.cache.MultiHostCachedEmbeddingBagCollection`, the multi-host
  tier, implements it in place.)
  `AsyncCachedTier` the async exchange stream as a tier: the protocol
                    mapped onto the wrapped collection's *_async methods, so
                    `build_cached_train_step` runs the overlapped schedule
                    for it and the sync one for a bare collection.
  `BulkCachedEmbeddingBagCollection`
                    device cache -> DRAM capacity -> bulk store. The
                    capacity tensor keeps full height and stays the one
                    authoritative value store, so every oracle stays
                    bit-exact; a `dram_resident` mask splits the rows off
                    the device between DRAM and the `BulkStore` (RAM, or a
                    memory-mapped .npy file, with a deadline model of
                    block latency). Admissions of bulk rows PROMOTE them
                    first (chunked reads, behind the "bulk.fetch" fault
                    site); evictions land in DRAM, and DRAM overflow DEMOTES
                    the coldest rows (EMA score) back to bulk.

Residency is exclusive by construction: device (row_slot >= 0), DRAM
(dram_resident, not on the device) and bulk (neither) partition the rows.

With the capacity tier in page-locked host memory (`core.hostmem`), queued
kernels write it asynchronously: `cache_commit`'s and `cache_exchange`'s
writebacks, and `flush`. The host side keeps this order:
  * a demotion reads capacity rows only after `capacity_fence` (an event
    recorded after the last kernel that writes capacity), and after
    queueing any pending commit whose writeback hits a victim, so it reads
    the written bits;
  * a promotion writes only bulk-resident rows: no queued kernel reads or
    writes them (a row on the device is never a demotion victim, and a
    demoted row's writebacks have landed), and a fetch of a promoted row is
    queued after the host write;
  * `materialize`, `state_dict` and the reseed in `load_state_dict` read
    capacity after the fence.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, ClassVar, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.cache import (AsyncCacheState,
                                    CachedEmbeddingBagCollection,
                                    CacheState, CacheStats, _ema_score,
                                    _fetch_guard, capacity_fence)
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.kernels.sparse_plan import coalesce_rows

#: rows per host copy when the bulk store is seeded from capacity
_SEED_ROWS = 1 << 20


# ---------------------------------------------------------------------------
# Per-tier counters
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TierCacheStats(CacheStats):
    """CacheStats plus the third tier's counters: the miss stream split by
    the level that served it (`dram_hits`, `bulk_hits`), and the
    promotion/demotion pipelines in rows, bytes, blocks and injected
    latency. All integers, so the checkpoint's int64 cast round-trips."""

    dram_hits: int = 0         # admitted rows whose copy was in DRAM
    bulk_hits: int = 0         # admitted rows promoted from the bulk store
    demotions: int = 0         # rows demoted DRAM -> bulk on overflow
    promotion_bytes: int = 0   # bulk -> DRAM payload bytes (row + accum)
    demotion_bytes: int = 0    # DRAM -> bulk payload bytes
    bulk_read_chunks: int = 0  # block descriptors of promotions
    bulk_write_chunks: int = 0  # block descriptors of demotions
    bulk_sched_us: int = 0     # injected bulk latency scheduled
    bulk_wait_us: int = 0      # the part of it paid at a sync point

    @property
    def hit_hbm(self) -> int:
        """Accesses served by the device tier (alias of `hits`)."""
        return self.hits

    @property
    def dram_hit_rate(self) -> float:
        """dram_hits / fetched rows; 0.0 before any fetch."""
        fetched = self.dram_hits + self.bulk_hits
        return self.dram_hits / fetched if fetched else 0.0

    @property
    def hidden_fraction(self) -> float:
        """1 - bulk_wait/bulk_sched: the share of the injected latency the
        async stream hid; 1.0 when nothing was scheduled."""
        if self.bulk_sched_us <= 0:
            return 1.0
        return max(0.0, 1.0 - self.bulk_wait_us / self.bulk_sched_us)

    def snapshot(self) -> dict[str, float]:
        """The two-tier payload plus `tier_*` keys."""
        out = super().snapshot()
        out.update({
            "tier_hit_hbm": float(self.hits),
            "tier_hit_dram": float(self.dram_hits),
            "tier_hit_bulk": float(self.bulk_hits),
            "tier_dram_hit_rate": self.dram_hit_rate,
            "tier_demotions": float(self.demotions),
            "tier_promotion_bytes": float(self.promotion_bytes),
            "tier_demotion_bytes": float(self.demotion_bytes),
            "tier_bulk_read_chunks": float(self.bulk_read_chunks),
            "tier_bulk_write_chunks": float(self.bulk_write_chunks),
            "tier_bulk_sched_us": float(self.bulk_sched_us),
            "tier_bulk_wait_us": float(self.bulk_wait_us)})
        return out


# ---------------------------------------------------------------------------
# The bulk store (SSD/NVM stand-in)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BulkStore:
    """The slowest level: a RAM or memory-mapped row store standing in for
    SSD/NVM below host DRAM.

    Access is block-granular: reads and writes coalesce their sorted rows
    into `chunk`-row blocks (`coalesce_rows`, min_fill=1), and each block
    schedules `latency_us`. The latency is a DEADLINE (`_ready_at`), paid by
    `wait()` at the consumption point (the sync admission, or the async
    commit) only as far as real work has not already hidden it."""

    values: np.ndarray         # (R, d) demoted-row payload (np or memmap)
    accum: np.ndarray          # (R,) fp32 AdaGrad accumulators
    chunk: int                 # block height in rows (>= 1)
    latency_us: float          # injected latency per block access
    path: str | None = None    # backing .npy file when memory-mapped
    _ready_at: float = 0.0     # monotonic deadline of the queued accesses

    @classmethod
    def build(cls, rows: int, dim: int, chunk: int, latency_us: float,
              path: str | None = None, dtype=np.float32) -> BulkStore:
        """An empty (rows, dim) store; `path` memory-maps the payload into
        .npy files (`path` and `path + ".accum.npy"`)."""
        if path and rows:
            values = np.lib.format.open_memmap(
                path, mode="w+", dtype=dtype, shape=(rows, dim))
            accum = np.lib.format.open_memmap(
                str(path) + ".accum.npy", mode="w+", dtype=np.float32,
                shape=(rows,))
        else:
            values = np.zeros((rows, dim), dtype)
            accum = np.zeros((rows,), np.float32)
        return cls(values, accum, max(1, int(chunk)), float(latency_us),
                   path if rows else None)

    @property
    def row_bytes(self) -> int:
        """Payload bytes per row (embedding row + its accumulator)."""
        return int(self.values.shape[1]) * self.values.itemsize \
            + self.accum.itemsize

    def _schedule(self, n_blocks: int, stats: TierCacheStats) -> None:
        """Push the deadline out by `n_blocks` block latencies (accesses
        queue behind each other, like one device channel)."""
        lat_us = n_blocks * self.latency_us
        base = max(self._ready_at, time.monotonic())
        self._ready_at = base + lat_us * 1e-6
        stats.bulk_sched_us += int(round(lat_us))

    def read(self, rows: np.ndarray,
             stats: TierCacheStats) -> tuple[np.ndarray, np.ndarray]:
        """Block-granular read of sorted unique `rows` (a promotion):
        schedules latency, books blocks and bytes, returns copies."""
        starts, _ = coalesce_rows(rows, self.chunk, len(self.values),
                                  min_fill=1)
        stats.bulk_read_chunks += len(starts)
        stats.promotion_bytes += len(rows) * self.row_bytes
        self._schedule(len(starts), stats)
        return np.asarray(self.values[rows]), np.asarray(self.accum[rows])

    def write(self, rows: np.ndarray, values: np.ndarray,
              accum: np.ndarray, stats: TierCacheStats) -> None:
        """Block-granular write of sorted unique `rows` (a demotion):
        schedules latency, books blocks, bytes and demotions."""
        starts, _ = coalesce_rows(rows, self.chunk, len(self.values),
                                  min_fill=1)
        stats.bulk_write_chunks += len(starts)
        stats.demotions += len(rows)
        stats.demotion_bytes += len(rows) * self.row_bytes
        self._schedule(len(starts), stats)
        self.seed(rows, values, accum)

    def seed(self, rows: np.ndarray, values: np.ndarray,
             accum: np.ndarray) -> None:
        """Raw install without latency or counters (the cold seed and a
        restore). A contiguous run of rows is written as one slice."""
        rows = np.asarray(rows)
        if len(rows) and rows[-1] - rows[0] + 1 == len(rows):
            rows = slice(int(rows[0]), int(rows[-1]) + 1)
        self.values[rows] = np.asarray(values, self.values.dtype)
        self.accum[rows] = np.asarray(accum, np.float32)

    def seed_from(self, capacity: torch.Tensor, cap_accum: torch.Tensor,
                  rows: np.ndarray) -> None:
        """`seed` sorted `rows` from the capacity tier (on the card or the
        host), `_SEED_ROWS` rows per copy."""
        for lo in range(0, len(rows), _SEED_ROWS):
            r = rows[lo:lo + _SEED_ROWS]
            if r[-1] - r[0] + 1 == len(r):
                vals = capacity[int(r[0]):int(r[-1]) + 1]
                acc = cap_accum[int(r[0]):int(r[-1]) + 1]
            else:
                idx = torch.from_numpy(r).to(capacity.device)
                vals = capacity.index_select(0, idx)
                acc = cap_accum.index_select(0, idx.to(cap_accum.device))
            self.seed(r, vals.cpu().numpy(), acc.cpu().numpy())

    def wait(self, stats: TierCacheStats) -> float:
        """Sleep until the deadline of the queued accesses; book and
        return the microseconds actually paid."""
        now = time.monotonic()
        paid = 0.0
        if self._ready_at > now:
            paid = self._ready_at - now
            time.sleep(paid)
            stats.bulk_wait_us += int(round(paid * 1e6))
        self._ready_at = 0.0
        return paid * 1e6


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------


@runtime_checkable
class EmbeddingTier(Protocol):
    """The one surface every cached embedding tier implements:
    `CachedEmbeddingBagCollection` (sync two-tier), `AsyncCachedTier` (its
    overlapped stream), `core.cache.MultiHostCachedEmbeddingBagCollection`
    (per-host caches over a row-sharded capacity tier) and
    `BulkCachedEmbeddingBagCollection` (three tiers, sync or wrapped
    async)."""

    def init_state(self, mega: torch.Tensor,
                   accum: torch.Tensor | None = None, device=None):
        """Fresh tier state over the (rows, d) capacity table."""
        ...

    def take(self, state, idx, train: bool = True, plan=None):
        """Make `idx`'s batch current; return its slot-space remap."""
        ...

    def stage(self, state, idx, train: bool = True, plan=None):
        """Overlap the NEXT batch's fetch (None when the tier can't)."""
        ...

    def prefetch_rows(self, state, rows, gate: bool = False) -> int:
        """Best-effort admission of unique rows ahead of use."""
        ...

    def commit(self, state) -> int:
        """Drain pending installs at a step boundary."""
        ...

    def flush(self, state) -> int:
        """Write dirty device rows back to the capacity tier."""
        ...

    def materialize(self, state):
        """The up-to-date (mega, accum) capacity tensors."""
        ...

    def state_dict(self, state) -> dict:
        """Checkpoint-ready tree covering the whole tier."""
        ...

    def load_state_dict(self, d: dict, device=None):
        """Rebuild tier state from a `state_dict` tree."""
        ...

    def stats(self, state) -> CacheStats:
        """The tier's counters."""
        ...

    def placement(self) -> dict:
        """Static memory-level layout, fastest first."""
        ...


def tier_conformance(obj: Any) -> bool:
    """True iff `obj` structurally satisfies `EmbeddingTier`."""
    return isinstance(obj, EmbeddingTier)


# ---------------------------------------------------------------------------
# The async stream as a tier
# ---------------------------------------------------------------------------


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
                   accum: torch.Tensor | None = None,
                   device=None) -> AsyncCacheState:
        """`init_async_state` (takes ownership of mega and accum)."""
        return self.cc.init_async_state(mega, accum, device)

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

    def state_dict(self, state: AsyncCacheState) -> dict:
        """The collection's `state_dict` (drains and unwinds first)."""
        return self.cc.state_dict(state)

    def load_state_dict(self, d: dict, device=None) -> AsyncCacheState:
        """The collection's `load_state_dict` (an async state dict
        restores the async flavour)."""
        return self.cc.load_state_dict(d, device)

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


# ---------------------------------------------------------------------------
# The three-tier collection
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BulkCacheState(CacheState):
    """CacheState plus the bulk store and the DRAM-residency mask (a row is
    in DRAM iff dram_resident and not cached)."""

    bulk: BulkStore | None = None
    dram_resident: np.ndarray | None = None  # (R,) bool

    @property
    def dram_occupancy(self) -> int:
        """Rows whose current home is DRAM: the figure `dram_rows` bounds."""
        return int((self.dram_resident & (self.row_slot < 0)).sum())


@dataclasses.dataclass
class BulkAsyncCacheState(AsyncCacheState):
    """AsyncCacheState plus the third tier (see BulkCacheState)."""

    bulk: BulkStore | None = None
    dram_resident: np.ndarray | None = None  # (R,) bool

    @property
    def dram_occupancy(self) -> int:
        """Rows whose current home is DRAM."""
        return int((self.dram_resident & (self.row_slot < 0)).sum())


@dataclasses.dataclass(frozen=True)
class BulkCachedEmbeddingBagCollection(CachedEmbeddingBagCollection):
    """Three-tier cached collection: device cache -> DRAM capacity -> bulk.

    Promotion copies a row's (identical) bits from the bulk store into
    capacity and demotion copies capacity bits out, so every two-tier
    oracle stays bit-exact, and `dram_rows` <= 0 or >= the table height is
    exactly the two-tier collection with no bulk traffic. Sync admissions
    pay the bulk latency inline; the async stream pays at `commit_async`
    what batch k's compute did not hide."""

    dram_rows: int = 0         # DRAM budget in rows; <= 0 or >= total rows
                               # disables the bulk tier
    bulk_chunk: int = 32       # bulk block height in rows
    bulk_latency_us: float = 50.0  # injected latency per block access
    bulk_path: str | None = None   # memory-map the bulk payload here (.npy)

    _stats_cls: ClassVar[type] = TierCacheStats

    @classmethod
    def build(cls, cfg: DLRMConfig, cache_rows: int | None = None,
              fetch_chunk: int = 1, dram_rows: int = 0, bulk_chunk: int = 32,
              bulk_latency_us: float = 50.0, bulk_path: str | None = None
              ) -> BulkCachedEmbeddingBagCollection:
        """Build over a fresh single-device `cached_host` collection; see
        the class fields for the tier knobs."""
        ebc = EmbeddingBagCollection.build(cfg, n_shards=1,
                                           strategy="cached_host")
        rows = cache_rows if cache_rows is not None else ebc.plan.cache_rows
        return cls(ebc, int(rows), fetch_chunk=int(fetch_chunk),
                   dram_rows=int(dram_rows), bulk_chunk=int(bulk_chunk),
                   bulk_latency_us=float(bulk_latency_us),
                   bulk_path=bulk_path)

    def _dram_cap(self) -> int:
        """Effective DRAM budget in rows (the table height when off)."""
        r = self.ebc.plan.total_rows
        if self.dram_rows <= 0 or self.dram_rows >= r:
            return r
        return int(self.dram_rows)

    # -- state ---------------------------------------------------------------

    def _bulk_wrap(self, base, cls):
        """Extend a fresh two-tier state with the bulk store and the
        residency mask. Cold start: with a real budget every row begins in
        BULK (seeded from capacity) and the working set promotes on first
        touch; with the tier off every row is DRAM-resident and the store
        is empty."""
        r, d = base.capacity.shape
        if self._dram_cap() >= r:
            dram = np.ones((r,), bool)
            bulk = BulkStore.build(0, int(d), self.bulk_chunk,
                                   self.bulk_latency_us)
        else:
            dram = np.zeros((r,), bool)
            bulk = BulkStore.build(r, int(d), self.bulk_chunk,
                                   self.bulk_latency_us, self.bulk_path)
            bulk.seed_from(base.capacity, base.cap_accum,
                           np.arange(r, dtype=np.int64))
        fields = dataclasses.fields(type(base))
        return cls(**{f.name: getattr(base, f.name) for f in fields},
                   bulk=bulk, dram_resident=dram)

    def init_state(self, mega: torch.Tensor,
                   accum: torch.Tensor | None = None,
                   device=None) -> BulkCacheState:
        """Three-tier `init_state` (the parent's ownership and placement
        contract)."""
        return self._bulk_wrap(super().init_state(mega, accum, device),
                               BulkCacheState)

    def init_async_state(self, mega: torch.Tensor,
                         accum: torch.Tensor | None = None,
                         device=None) -> BulkAsyncCacheState:
        """Three-tier `init_async_state`."""
        return self._bulk_wrap(super().init_async_state(mega, accum, device),
                               BulkAsyncCacheState)

    # -- tier hooks ----------------------------------------------------------

    def _stage_capacity(self, state, missing: np.ndarray) -> None:
        """Promote the `missing` rows that live in bulk into capacity
        before the device fetch reads it. The "bulk.fetch" guard fires
        before any mutation (stats included), so a propagated fault leaves
        the admission replayable. The read's latency is paid inline on the
        sync path and at commit on the async one."""
        if len(missing) == 0:
            return
        promote = missing[~state.dram_resident[missing]]
        if len(promote):
            _fetch_guard(self.injector, self.retry, "bulk.fetch")
        s = state.stats
        s.dram_hits += len(missing) - len(promote)
        if not len(promote):
            return
        vals, acc = state.bulk.read(promote, s)
        # bulk-resident rows: no queued kernel reads or writes them
        rows = torch.from_numpy(promote.astype(np.int64))
        state.capacity.index_copy_(
            0, rows.to(state.capacity.device),
            torch.from_numpy(vals).to(state.capacity.device))
        state.cap_accum.index_copy_(
            0, rows.to(state.cap_accum.device),
            torch.from_numpy(acc).to(state.cap_accum.device))
        state.dram_resident[promote] = True
        s.bulk_hits += len(promote)
        if not isinstance(state, AsyncCacheState):
            state.bulk.wait(s)         # the sync path consumes at once

    def _absorb_evictions(self, state, evicted_rows: np.ndarray) -> None:
        """Rows displaced from the device fall back to DRAM; demote the
        coldest DRAM rows when that overflows the budget."""
        ev = np.asarray(evicted_rows, np.int64).ravel()
        ev = ev[ev >= 0]
        if len(ev):
            state.dram_resident[ev] = True
        self._demote_overflow(state, ev)

    def _demote_overflow(self, state, exclude: np.ndarray) -> None:
        """Demote the coldest DRAM rows (lazily decayed EMA score, the
        admission policy run backwards) until occupancy fits `dram_rows`.
        `exclude` (this admission's evictions) never demotes at once: its
        writeback may still be pending. A pending commit whose writeback
        hits a victim is queued first, and the victims are read after
        `capacity_fence`, so a demotion reads the written-back bits."""
        r = len(state.dram_resident)
        cap = self._dram_cap()
        if cap >= r:
            return
        cand_mask = state.dram_resident & (state.row_slot < 0)
        over = int(cand_mask.sum()) - cap
        if over <= 0:
            return
        if len(exclude):
            cand_mask[exclude] = False
        cand = np.flatnonzero(cand_mask)
        over = min(over, len(cand))
        if over <= 0:
            return
        scores = _ema_score(state.ema, state.ema_tick, cand, state.tick,
                            self.decay)
        order = np.argsort(scores, kind="stable")
        victims = np.sort(cand[order[:over]])
        if isinstance(state, AsyncCacheState) and state.pending:
            qwb = np.concatenate([p.evict_rows[p.evict_rows >= 0]
                                  for p in state.pending])
            if len(qwb) and np.intersect1d(victims, qwb).size:
                self.commit_async(state)
        capacity_fence(state)
        idx = torch.from_numpy(victims)
        vals = state.capacity.index_select(
            0, idx.to(state.capacity.device)).cpu().numpy()
        acc = state.cap_accum.index_select(
            0, idx.to(state.cap_accum.device)).cpu().numpy()
        state.bulk.write(victims, vals, acc, state.stats)
        state.dram_resident[victims] = False
        if not isinstance(state, AsyncCacheState):
            state.bulk.wait(state.stats)

    # -- async consumption point ---------------------------------------------

    def commit_async(self, astate) -> int:
        """Commit the pending fetches after paying the part of the
        scheduled bulk latency that batch k's compute did not hide."""
        bulk = getattr(astate, "bulk", None)
        if bulk is not None:
            bulk.wait(astate.stats)
        return super().commit_async(astate)

    # -- introspection -------------------------------------------------------

    def tier_residency(self, state) -> dict[str, np.ndarray]:
        """Exclusive per-row membership masks {hbm, dram, bulk}."""
        hbm = state.row_slot >= 0
        dram = ~hbm & state.dram_resident
        bulk = ~hbm & ~state.dram_resident
        return {"hbm": hbm, "dram": dram, "bulk": bulk}

    def placement(self) -> dict:
        """Static three-level layout, fastest first."""
        r = self.ebc.plan.total_rows
        return {"strategy": "cached_bulk", "stream": "sync",
                "levels": [
                    {"tier": "hbm", "rows": self.cache_rows},
                    {"tier": "dram", "rows": self._dram_cap()},
                    {"tier": "bulk", "rows": r,
                     "chunk": self.bulk_chunk,
                     "latency_us": self.bulk_latency_us,
                     "mmap": bool(self.bulk_path)}]}

    # -- checkpointing -------------------------------------------------------

    def state_dict(self, state) -> dict:
        """The parent's tree (drained, unwound) plus the residency mask.
        The bulk payload is not saved: bulk rows equal their capacity bits
        by construction, so a restore reseeds the store from capacity."""
        d = super().state_dict(state)
        d["dram_resident"] = np.array(state.dram_resident)
        return d

    def load_state_dict(self, d: dict, device=None):
        """Rebuild the three-tier state: the parent restores the two-tier
        half (stats as TierCacheStats), then every row off DRAM is reseeded
        into a fresh bulk store from capacity."""
        dram = np.array(d["dram_resident"], bool)
        base = super().load_state_dict(
            {k: v for k, v in d.items() if k != "dram_resident"}, device)
        cls = BulkAsyncCacheState if isinstance(base, AsyncCacheState) \
            else BulkCacheState
        fields = dataclasses.fields(type(base))
        st = cls(**{f.name: getattr(base, f.name) for f in fields},
                 bulk=None, dram_resident=dram)
        r, dim = st.capacity.shape
        if self._dram_cap() >= r:
            st.bulk = BulkStore.build(0, int(dim), self.bulk_chunk,
                                      self.bulk_latency_us)
            return st
        st.bulk = BulkStore.build(r, int(dim), self.bulk_chunk,
                                  self.bulk_latency_us, self.bulk_path)
        rows = np.flatnonzero(~dram)
        if len(rows):
            st.bulk.seed_from(st.capacity, st.cap_accum, rows)
        return st
