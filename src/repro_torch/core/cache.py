"""Software-managed cached embedding tier, read-only sync subset
(paper section IV-B, Figs. 6-8).

Production embedding tables exceed device memory, and their per-row access
frequency is skewed and uncorrelated with table size — the regime where a
software-managed hot-row cache beats static sharding. The tier is:

  capacity tier  (total_rows, d)  the full mega table + row-wise AdaGrad
                 accumulator;
  device cache   (cache_rows, d)  hot rows + their accumulators + an LFU
                 score per slot, sized by plan_placement("cached_host").

Each batch the host manager extracts the batch's unique global rows, remaps
them to cache slots (fetch-on-miss through the hand-written cache-exchange
kernel, which moves row + accumulator together), and the lookup then runs
against the small cache tensor. Eviction is LFU with decay. The payload
tensors live on the device and are updated IN PLACE (the reference donated
them to XLA); the slot maps and per-row EMA counters are host numpy,
exactly as in the reference, so eviction choices are the reference's.

This slice ports what read-only serving runs: `fetch_chunk=1` transfers,
no prefetch, no flush. The chunked fetch, the async stream, the bulk tier
and the multi-host tier come with later slices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.kernels import cache_ops


@dataclasses.dataclass
class CacheStats:
    """Cache metrics. A miss is a CAPACITY-TIER FETCH: one per unique
    missing row per batch; that row's further accesses in the same batch
    count as hits (hit_rate = 1 - unique_misses / accesses)."""
    hits: int = 0
    misses: int = 0
    fetches: int = 0           # unique rows pulled from the capacity tier
    evictions: int = 0         # slots whose resident row was displaced
    writebacks: int = 0        # dirty evictions written back to capacity
    prefetched: int = 0        # rows admitted ahead of use
    fetch_chunks: int = 0      # transfer descriptors of chunked fetches
    overfetch_rows: int = 0    # padding rows chunked fetches over-read
    steps: int = 0

    @property
    def hit_rate(self) -> float:
        """hits / (hits + misses); 0.0 before any traffic."""
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


@dataclasses.dataclass
class CacheState:
    """Mutable two-tier state: device hot-row cache over the capacity
    tier, plus the host-side slot maps and frequency counters."""

    capacity: torch.Tensor     # (R, d) capacity tier — the full mega table
    cap_accum: torch.Tensor    # (R,) fp32 AdaGrad accumulator
    cache: torch.Tensor        # (C, d) device tier — hot rows
    cache_accum: torch.Tensor  # (C,) fp32 accumulators of cached rows
    freq: torch.Tensor         # (C,) fp32 LFU-with-decay score per slot
    slot_row: np.ndarray       # (C,) int64: global row held by slot, -1 free
    row_slot: np.ndarray       # (R,) int32: slot holding row, -1 uncached
    dirty: np.ndarray          # (C,) bool: slot updated since fetch
    ema: np.ndarray            # (R,) fp32 EMA-decayed per-row access counts
    ema_tick: np.ndarray       # (R,) int64 tick of each row's last EMA touch
    tick: int                  # EMA clock: one tick per planned batch
    stats: CacheStats

    @property
    def cache_rows(self) -> int:
        """Device-tier height C (slots)."""
        return int(self.cache.shape[0])


def _host(x) -> np.ndarray:
    """A numpy view of a host array or a (device) tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pick_slots(slot_row: np.ndarray, freq, n: int,
                protect: np.ndarray, thrash_detail: str
                ) -> tuple[np.ndarray, np.ndarray]:
    """The one slot-selection policy: free slots first, then the coldest
    unprotected residents (stable argsort of the LFU scores), with the
    cache-thrash guard raised when the protected working set leaves too
    few victims. `freq` (host array or tensor) is read only when a victim
    is needed. Returns (slots (n,), victims) — victims occupy the TAIL of
    `slots`, the layout the exchange worklist relies on."""
    free = np.flatnonzero(slot_row < 0)
    need = n - len(free)
    victims = np.empty((0,), np.int64)
    if need > 0:
        evictable = np.flatnonzero((slot_row >= 0) & ~protect)
        if len(evictable) < need:
            raise ValueError(
                f"cache thrash: need {need} evictions but only "
                f"{len(evictable)} unprotected slots — {thrash_detail}")
        order = np.argsort(_host(freq)[evictable], kind="stable")
        victims = evictable[order[:need]]
    return np.concatenate([free[:min(n, len(free))], victims])[:n], victims


def _ema_score(ema: np.ndarray, ema_tick: np.ndarray, rows: np.ndarray,
               now: int, decay: float) -> np.ndarray:
    """Lazily-decayed EMA read: score = ema * decay**age, so the (R,)
    state needs no per-step dense pass."""
    age = (now - ema_tick[rows]).astype(np.float32)
    return ema[rows] * np.power(np.float32(decay), age)


def _ema_touch(ema: np.ndarray, ema_tick: np.ndarray, rows: np.ndarray,
               counts: np.ndarray, now: int, decay: float) -> None:
    """Fold one batch's access counts into the per-row EMA (in place):
    settle each touched row's owed decay, add its counts, stamp the tick."""
    ema[rows] = _ema_score(ema, ema_tick, rows, now, decay) \
        + counts.astype(np.float32)
    ema_tick[rows] = now


def _fetch_guard(injector, retry, site: str) -> int:
    """Fire a fault-injection `site` with bounded retry-with-backoff.

    `injector` is duck-typed (anything with `fire(site)`); a raised
    exception with a truthy `transient` attribute is retried up to
    `retry.max_retries` times with `retry.sleep(attempt)` backoff, anything
    else propagates. The guard runs BEFORE any host-map mutation, so a
    propagated fault leaves the tier consistent. Returns the retries
    burned (0 when no injector is armed)."""
    if injector is None:
        return 0
    attempt = 0
    while True:
        try:
            injector.fire(site)
        except Exception as e:
            if not getattr(e, "transient", False) or retry is None \
                    or attempt >= retry.max_retries:
                raise
            attempt += 1
            retry.sleep(attempt)
            continue
        return attempt


@dataclasses.dataclass
class StaleRowSnapshot:
    """Read-only last-known-good row values for degrade-don't-die serving.

    The serving tier records every row it fetches; when a later fetch
    faults (or the breaker is in stale_only), misses resolve from this
    snapshot — zeros for rows never seen. Host numpy on purpose: the
    degraded path must not depend on the device tier. `empty` allocates
    lazily-zeroed host memory of the full (R, d) size; only recorded rows
    are ever touched."""

    values: np.ndarray         # (R, d) last-known-good rows, host copy
    seen: np.ndarray           # (R,) bool: row has been recorded at least once

    @classmethod
    def empty(cls, total_rows: int, dim: int,
              dtype=np.float32) -> StaleRowSnapshot:
        """Zero-filled snapshot covering `total_rows` rows of width `dim`."""
        return cls(values=np.zeros((total_rows, dim), dtype),
                   seen=np.zeros((total_rows,), bool))

    def record(self, rows: np.ndarray, values) -> None:
        """Remember `values` ((n, d), host array or tensor) for `rows`."""
        rows = np.asarray(rows)
        if len(rows) == 0:
            return
        self.values[rows] = _host(values).astype(self.values.dtype,
                                                  copy=False)
        self.seen[rows] = True

    def gather(self, rows: np.ndarray) -> np.ndarray:
        """(n, d) last-known-good values for `rows`; zeros where unseen."""
        rows = np.asarray(rows)
        out = self.values[rows].copy()
        out[~self.seen[rows]] = 0
        return out


def _device_ints(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)


def _device_floats(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


@dataclasses.dataclass(frozen=True)
class CachedEmbeddingBagCollection:
    """EmbeddingBagCollection whose device working set is a hot-row cache.

    `lookup` results equal the uncached collection's: rows are moved
    bit-exactly and pooled by the same kernel."""
    ebc: EmbeddingBagCollection
    cache_rows: int
    decay: float = 0.98        # LFU decay per step
    fetch_chunk: int = 1       # capacity->cache transfer granularity in rows

    def __post_init__(self):
        if self.fetch_chunk != 1:
            raise NotImplementedError(
                f"fetch_chunk={self.fetch_chunk}: chunk-granular transfers "
                "need the chunked fetch kernels of a later slice; only "
                "fetch_chunk=1 is ported")
        if self.cache_rows <= 0:
            raise ValueError("cached_host plan produced an empty cache")

    @classmethod
    def build(cls, cfg: DLRMConfig, cache_rows: int | None = None,
              fetch_chunk: int = 1) -> CachedEmbeddingBagCollection:
        """Build over a fresh single-device `cached_host` collection;
        `cache_rows` defaults to the plan's."""
        ebc = EmbeddingBagCollection.build(cfg, n_shards=1,
                                           strategy="cached_host")
        rows = cache_rows if cache_rows is not None else ebc.plan.cache_rows
        return cls(ebc, int(rows), fetch_chunk=int(fetch_chunk))

    # -- state ---------------------------------------------------------------

    def init_state(self, mega: torch.Tensor,
                   accum: torch.Tensor | None = None) -> CacheState:
        """mega: (total_rows, d) fp32 capacity-tier table; accum: optional
        (total_rows,) AdaGrad accumulator.

        The state TAKES OWNERSHIP of `mega` (and `accum`) without copying:
        the exchange writes the capacity tier in place, so the caller must
        not use `mega` for anything else afterwards. (The reference copies;
        at full dlrm-m1 width two 43.6 GB copies do not fit in one card.)
        The cache, its accumulators and the LFU scores are allocated on
        mega's device."""
        r, d = mega.shape
        if r != self.ebc.plan.total_rows:
            raise ValueError(f"mega has {r} rows, the plan "
                             f"{self.ebc.plan.total_rows}")
        dev = mega.device
        c = self.cache_rows
        if accum is None:
            accum = torch.zeros((r,), dtype=torch.float32, device=dev)
        return CacheState(
            capacity=mega,
            cap_accum=accum,
            cache=torch.zeros((c, d), dtype=mega.dtype, device=dev),
            cache_accum=torch.zeros((c,), dtype=torch.float32, device=dev),
            freq=torch.zeros((c,), dtype=torch.float32, device=dev),
            slot_row=np.full((c,), -1, np.int64),
            row_slot=np.full((r,), -1, np.int32),
            dirty=np.zeros((c,), bool),
            ema=np.zeros((r,), np.float32),
            ema_tick=np.zeros((r,), np.int64),
            tick=0,
            stats=CacheStats())

    # -- admission -----------------------------------------------------------

    @staticmethod
    def _split_batch(idx, row_slot: np.ndarray, cache_rows: int):
        """Batch parsing: pad mask, unique rows with counts, thrash guard,
        resident/missing split. Returns (idx, valid, rows, counts,
        hit_slots, hit_counts, missing, miss_counts)."""
        idx = np.asarray(idx)
        valid = idx >= 0
        rows, counts = np.unique(idx[valid], return_counts=True)
        if len(rows) > cache_rows:
            raise ValueError(
                f"batch touches {len(rows)} unique rows > cache_rows="
                f"{cache_rows}; raise the HBM budget or shrink the batch")
        resident = row_slot[rows] >= 0
        return (idx, valid, rows, counts, row_slot[rows[resident]],
                counts[resident], rows[~resident], counts[~resident])

    @staticmethod
    def _remap(row_slot: np.ndarray, idx: np.ndarray,
               valid: np.ndarray) -> np.ndarray:
        """Global rows -> cache slots (-1 pads preserved)."""
        local = row_slot[np.where(valid, idx, 0)]
        return np.where(valid, local, -1).astype(np.int32)

    def _admit(self, state: CacheState, missing: np.ndarray,
               seeds: np.ndarray, protect: np.ndarray) -> int:
        """Bring `missing` global rows (SORTED ascending) into cache slots
        through one cache-exchange launch, evicting the coldest unprotected
        slots. `seeds` are the slots' initial LFU scores; `protect` is a
        (C,) bool mask of slots that must survive. Returns rows written
        back."""
        n = len(missing)
        if n == 0:
            return 0
        slots, victims = _pick_slots(
            state.slot_row, state.freq, n, protect,
            f"the batch working set exceeds cache_rows={state.cache_rows};"
            " raise the HBM budget or shrink the batch")
        evicted_rows = state.slot_row[victims]
        wb_mask = state.dirty[victims]
        # worklist: dirty victims write back; every admitted slot fetches
        evict_rows = np.full((n,), -1, np.int64)
        evict_rows[len(slots) - len(victims):] = np.where(
            wb_mask, evicted_rows, -1)
        dev = state.cache.device
        cache_ops.cache_exchange(
            state.capacity, state.cache, state.cap_accum, state.cache_accum,
            state.freq, _device_ints(slots, dev),
            _device_ints(evict_rows, dev), _device_ints(missing, dev),
            _device_floats(seeds, dev))
        # host maps
        state.row_slot[evicted_rows] = -1
        state.slot_row[slots] = missing
        state.row_slot[missing] = slots.astype(np.int32)
        state.dirty[slots] = False
        state.stats.fetches += n
        state.stats.evictions += len(victims)
        state.stats.writebacks += int(wb_mask.sum())
        return int(wb_mask.sum())

    def prepare(self, state: CacheState, idx, train: bool = True
                ) -> np.ndarray:
        """Make every row of `idx` cache-resident and remap to slot space.

        idx: (B, F, L) OFFSET global rows (-1 pads), host array. Returns
        (B, F, L) int32 cache-slot indices (-1 pads preserved). When
        `train`, the working set's slots are marked dirty so eviction
        writes them back; serving passes train=False."""
        (idx, valid, rows, counts, hit_slots, hit_counts, missing,
         _) = self._split_batch(idx, state.row_slot, state.cache_rows)
        dev = state.freq.device
        # LFU accounting: decay everything, bump hit slots; admitted slots
        # are seeded by _admit below
        cache_ops.lfu_touch(state.freq, _device_ints(hit_slots, dev),
                            _device_floats(hit_counts, dev),
                            decay=self.decay)
        state.tick += 1
        _ema_touch(state.ema, state.ema_tick, rows, counts, state.tick,
                   self.decay)
        protect = np.zeros((state.cache_rows,), bool)
        protect[hit_slots] = True
        # EMA admission: a re-admitted row re-enters at its historical
        # frequency (post-touch EMA score), not this batch's count
        self._admit(state, missing, state.ema[missing], protect)
        state.stats.hits += int(counts.sum()) - len(missing)
        state.stats.misses += len(missing)
        state.stats.steps += 1
        if train:
            state.dirty[state.row_slot[rows]] = True
        return self._remap(state.row_slot, idx, valid)

    def take(self, state: CacheState, idx, train: bool = True) -> np.ndarray:
        """Protocol `take`: plan, fetch and install the batch in this one
        call — `prepare` by its protocol name."""
        return self.prepare(state, idx, train=train)

    # -- lookup --------------------------------------------------------------

    def lookup_cached(self, state, local_idx) -> torch.Tensor:
        """Pooled lookup against the device cache. local_idx: (B, F, L)
        slot indices from `prepare` (host array or tensor). `state` needs
        only a `cache` attribute."""
        table = state.cache
        idx = torch.as_tensor(local_idx, dtype=torch.int32,
                              device=table.device)
        return self.ebc.lookup({"mega": table}, idx)

    def lookup(self, state: CacheState, idx,
               train: bool = False) -> torch.Tensor:
        """prepare + lookup_cached: equal to `EmbeddingBagCollection.lookup`
        on the same (global) indices."""
        return self.lookup_cached(state, self.prepare(state, idx, train))

    def stats(self, state: CacheState) -> CacheStats:
        """The tier's CacheStats."""
        return state.stats

    def placement(self) -> dict:
        """Static tier layout, fastest level first."""
        return {"strategy": "cached_host", "stream": "sync",
                "levels": [{"tier": "hbm", "rows": self.cache_rows},
                           {"tier": "dram",
                            "rows": self.ebc.plan.total_rows}]}
