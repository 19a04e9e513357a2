"""Software-managed cached embedding tier (paper section IV-B, Figs. 6-8).

Production embedding tables exceed device memory, and their per-row access
frequency is skewed and uncorrelated with table size — the regime where a
software-managed hot-row cache beats static sharding. The tier is:

  capacity tier  (total_rows, d)  the full mega table + row-wise AdaGrad
                 accumulator;
  device cache   (cache_rows, d)  hot rows + their accumulators + an LFU
                 score per slot, sized by plan_placement("cached_host").

Each batch the host manager extracts the batch's unique global rows, remaps
them to cache slots (fetch-on-miss through the hand-written row movers of
`kernels.cache_ops`, which move a row and its AdaGrad accumulator
together), and the lookup and the sparse update then run against the small
cache tensor. Eviction is LFU with decay; dirty victims are written back.
The payload tensors live on the device and are updated IN PLACE (the
reference donated them to XLA); the slot maps and per-row EMA counters are
host numpy, exactly as in the reference, so eviction choices are the
reference's.

Two schedules, bit-identical in their results:
  sync   `prepare`/`take` fetch and install the batch's misses inline
         (`cache_exchange`, or with `fetch_chunk > 1` the chunked fetch
         into a shadow slab plus `cache_commit`);
  async  (`AsyncCacheState`) batch k+1's misses are fetched into a shadow
         slab (`cache_fetch` / `cache_fetch_chunked`) while batch k
         computes, and installed at the step boundary (`cache_commit`).

All device work runs on PyTorch's current stream, in issue order, as JAX's
does on one device: the overlap comes from the host planning ahead of the
queued device work. Each worklist upload (`_device_ints`) is a pageable
copy, which waits for the work queued before it.

`state_dict`/`load_state_dict` checkpoint the whole tier (device slabs
and host maps, both schedules), and an `injector` fires "cache.fetch"
before each capacity-tier fetch, with `retry` absorbing transient faults.
The bulk tier and the multi-host tier come with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import DLRMConfig
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.kernels import cache_ops
from repro_torch.kernels.sparse_plan import coalesce_rows


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

    def snapshot(self) -> dict[str, float]:
        """Flat metrics dict (the train step's logging payload)."""
        return {"cache_hits": float(self.hits),
                "cache_misses": float(self.misses),
                "cache_hit_rate": self.hit_rate,
                "cache_fetches": float(self.fetches),
                "cache_evictions": float(self.evictions),
                "cache_writebacks": float(self.writebacks),
                "cache_prefetched": float(self.prefetched),
                "cache_fetch_chunks": float(self.fetch_chunks),
                "cache_overfetch_rows": float(self.overfetch_rows)}


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


@dataclasses.dataclass
class PendingCommit:
    """One staged admission waiting for its step-boundary commit: the
    shadow slab its fetch filled (kept here, so it lives until the commit
    has run) and the commit worklist (evict_rows[i] >= 0: slot i's dirty
    victim writes back first)."""
    epoch: int
    slots: np.ndarray          # (n,) cache slots to fill at commit
    evict_rows: np.ndarray     # (n,) capacity row for dirty writeback, -1 none
    rows: np.ndarray           # (n,) global rows being admitted
    victim_slots: np.ndarray   # (v,) slots whose resident was displaced
    ws_mask: np.ndarray        # (C,) bool: staged batch's full working set
    shadow: torch.Tensor | None        # (m, d) fetched rows, m >= n if chunked
    shadow_accum: torch.Tensor | None  # (m,) fetched accumulators
    src_pos: np.ndarray | None = None  # (n,) shadow row per entry (chunked
                                       # fetch); None = one row per entry


@dataclasses.dataclass
class StagedBatch:
    """A batch whose admission was staged ahead of use: its slot-space
    remap and the idx it was planned for (what `take_async` matches).
    hits/misses are its stat contribution, re-booked as a prefetch when
    the plan is discarded."""
    epoch: int
    idx_key: np.ndarray        # (B, F, L) global idx the plan was made for
    local: np.ndarray          # (B, F, L) slot-space remap
    ws_mask: np.ndarray        # (C,) bool working-set slots
    hits: int                  # stat delta booked at plan time
    misses: int


@dataclasses.dataclass
class AsyncCacheState:
    """Double-buffered cache state of the async stream.

    Unlike CacheState, `freq` lives on the HOST (victim selection never
    waits for the device); `slot_epoch` tags each slot with the epoch that
    admitted its row; `pending` is the ordered commit queue. Host maps flip
    at plan time, so later plans see the post-commit view while the device
    catches up. Working-set protection keeps a slot admitted at epoch k+1
    out of the in-flight epoch-k batch, so its gradients land in the slab
    its remap was planned against."""
    capacity: torch.Tensor     # (R, d) capacity tier — the full mega table
    cap_accum: torch.Tensor    # (R,) fp32 AdaGrad accumulator
    cache: torch.Tensor        # (C, d) device tier — hot rows
    cache_accum: torch.Tensor  # (C,) fp32 accumulators of cached rows
    freq: np.ndarray           # (C,) HOST fp32 LFU-with-decay scores
    slot_row: np.ndarray       # (C,) int64: global row held by slot, -1 free
    row_slot: np.ndarray       # (R,) int32: slot holding row, -1 uncached
    dirty: np.ndarray          # (C,) bool: slot updated since fetch
    slot_epoch: np.ndarray     # (C,) int64: admission epoch per slot
    epoch: int                 # last epoch issued
    pending: list[PendingCommit]
    inflight_mask: np.ndarray | None   # (C,) bool: in-flight working set
    staged: StagedBatch | None
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


def _gate_admission(slot_row: np.ndarray, freq, protect: np.ndarray,
                    missing: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """The adaptive admission threshold for best-effort paths (prefetch /
    stage_rows with `gate=True`): rows that fit free slots always admit;
    beyond that, candidates (scores descending) admit only while they
    STRICTLY beat the coldest unprotected residents (freq ascending).
    Returns a (len(missing),) bool keep-mask."""
    n = len(missing)
    free = int((slot_row < 0).sum())
    if n <= free:
        return np.ones((n,), bool)
    evictable = np.flatnonzero((slot_row >= 0) & ~protect)
    vic_scores = np.sort(_host(freq)[evictable])
    order = np.argsort(-scores, kind="stable")
    admit = np.zeros((n,), bool)
    admit[order[:free]] = True
    rest = order[free:]
    k = min(len(rest), len(vic_scores))
    if k:
        beats = scores[rest[:k]] > vic_scores[:k]
        # descending candidates vs ascending victims: the first failure
        # ends the admitted prefix
        n_admit = k if beats.all() else int(np.argmin(beats))
        admit[rest[:n_admit]] = True
    return admit


def _chunk_min_fill(chunk: int) -> int:
    """Fewest member rows for a block to beat per-row fetches (about 3/4
    full); sparser blocks fall back to the row fetch."""
    return max(2, (3 * chunk + 3) // 4)


def _chunked_shadow_fetch(capacity: torch.Tensor, cap_accum: torch.Tensor,
                          missing: np.ndarray, chunk: int, stats: CacheStats
                          ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Chunk-granular shadow fetch of the sorted `missing` rows, shared by
    the sync and async admissions: dense blocks through
    `cache_fetch_chunked`, the isolated rest through `cache_fetch`, one
    slab. Books `fetch_chunks` (transfers) and `overfetch_rows` (block
    padding). Returns (shadow, shadow_accum, src_pos): src_pos[i] is miss
    i's slab row, the commit's install remap."""
    total = int(capacity.shape[0])
    chunk = min(chunk, total)
    starts, pos = coalesce_rows(missing, chunk, total,
                                min_fill=_chunk_min_fill(chunk))
    single = np.flatnonzero(pos < 0)
    src_pos = pos.copy()
    src_pos[single] = len(starts) * chunk + np.arange(len(single),
                                                      dtype=np.int32)
    dev = capacity.device
    parts = []
    if len(starts):
        parts.append(cache_ops.cache_fetch_chunked(
            capacity, cap_accum, _device_ints(starts, dev), chunk))
    if len(single):
        parts.append(cache_ops.cache_fetch(
            capacity, cap_accum, _device_ints(missing[single], dev)))
    if len(parts) == 2:
        shadow = torch.cat([parts[0][0], parts[1][0]])
        shadow_accum = torch.cat([parts[0][1], parts[1][1]])
    else:
        shadow, shadow_accum = parts[0]
    stats.fetch_chunks += len(starts) + len(single)
    stats.overfetch_rows += len(starts) * chunk - (len(missing) - len(single))
    return shadow, shadow_accum, src_pos


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
    bit-exactly and pooled by the same kernel. `fetch_chunk` > 1 moves
    capacity rows to the cache in contiguous blocks of that many rows."""
    ebc: EmbeddingBagCollection
    cache_rows: int
    decay: float = 0.98        # LFU decay per step
    fetch_chunk: int = 1       # capacity->cache transfer granularity in rows
    injector: Any = None       # FaultInjector firing "cache.fetch" ahead of
                               # every capacity-tier fetch
    retry: Any = None          # RetryPolicy bounding transient-fault
                               # retries in `_fetch_guard`; None fails fast

    def __post_init__(self):
        if self.cache_rows <= 0:
            raise ValueError("cached_host plan produced an empty cache")
        if self.fetch_chunk < 1:
            raise ValueError(f"fetch_chunk must be >= 1, got "
                             f"{self.fetch_chunk}")

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

    def _tiers(self, mega: torch.Tensor, accum: torch.Tensor | None):
        r, d = mega.shape
        if r != self.ebc.plan.total_rows:
            raise ValueError(f"mega has {r} rows, the plan "
                             f"{self.ebc.plan.total_rows}")
        dev = mega.device
        c = self.cache_rows
        if accum is None:
            accum = torch.zeros((r,), dtype=torch.float32, device=dev)
        return dict(
            capacity=mega, cap_accum=accum,
            cache=torch.zeros((c, d), dtype=mega.dtype, device=dev),
            cache_accum=torch.zeros((c,), dtype=torch.float32, device=dev),
            slot_row=np.full((c,), -1, np.int64),
            row_slot=np.full((r,), -1, np.int32),
            dirty=np.zeros((c,), bool),
            ema=np.zeros((r,), np.float32),
            ema_tick=np.zeros((r,), np.int64),
            tick=0, stats=CacheStats())

    def init_state(self, mega: torch.Tensor,
                   accum: torch.Tensor | None = None) -> CacheState:
        """mega: (total_rows, d) fp32 capacity-tier table; accum: optional
        (total_rows,) AdaGrad accumulator.

        The state TAKES OWNERSHIP of `mega` (and `accum`) without copying:
        the row movers write the capacity tier in place, so the caller must
        not use `mega` for anything else afterwards. (The reference copies;
        at full dlrm-m1 width two 43.6 GB copies do not fit in one card.)
        The cache, its accumulators and the LFU scores are allocated on
        mega's device."""
        t = self._tiers(mega, accum)
        return CacheState(freq=torch.zeros((self.cache_rows,),
                                           dtype=torch.float32,
                                           device=mega.device), **t)

    # -- admission -----------------------------------------------------------

    @staticmethod
    def _split_batch(idx, row_slot: np.ndarray, cache_rows: int, plan=None):
        """Batch parsing shared by the sync and async planners: pad mask,
        unique rows with counts, thrash guard, resident/missing split.
        `plan` (a host SparsePlan over idx in GLOBAL row space, e.g.
        `host_plan_from_batch`'s) replaces the np.unique sort: its live
        prefix is the sorted unique row set and its offset diffs the
        counts. Returns (idx, valid, rows, counts, hit_slots, hit_counts,
        missing, miss_counts)."""
        idx = _host(idx)
        valid = idx >= 0
        if plan is not None:
            prows = np.asarray(plan.unique_rows)
            n_live = int((prows >= 0).sum())
            rows = prows[:n_live].astype(np.int64)
            counts = np.diff(np.asarray(plan.bag_offsets)[:n_live + 1]
                             .astype(np.int64))
        else:
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
        """Bring `missing` global rows (SORTED ascending) into cache slots,
        evicting the coldest unprotected slots: one `cache_exchange`, or
        with `fetch_chunk > 1` the chunked shadow fetch and one
        `cache_commit` (values are copies either way, so both give the
        same bits). `seeds` are the slots' initial LFU scores; `protect` is
        a (C,) bool mask of slots that must survive. Returns rows written
        back."""
        n = len(missing)
        if n == 0:
            return 0
        # the fault gate comes before any host-map mutation: a propagated
        # transient fault leaves the tier consistent for a replay
        _fetch_guard(self.injector, self.retry, "cache.fetch")
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
        if self.fetch_chunk > 1:
            shadow, shadow_accum, pos = _chunked_shadow_fetch(
                state.capacity, state.cap_accum, missing, self.fetch_chunk,
                state.stats)
            slots_t = _device_ints(slots, dev)
            cache_ops.cache_commit(
                state.capacity, state.cache, state.cap_accum,
                state.cache_accum, shadow, shadow_accum, slots_t,
                _device_ints(evict_rows, dev), _device_ints(missing, dev),
                src_pos=_device_ints(pos, dev))
            state.freq.index_copy_(0, slots_t.long(),
                                   _device_floats(seeds, dev))
        else:
            cache_ops.cache_exchange(
                state.capacity, state.cache, state.cap_accum,
                state.cache_accum, state.freq, _device_ints(slots, dev),
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

    def prepare(self, state: CacheState, idx, train: bool = True,
                plan=None) -> np.ndarray:
        """Make every row of `idx` cache-resident and remap to slot space.

        idx: (B, F, L) OFFSET global rows (-1 pads), host array. Returns
        (B, F, L) int32 cache-slot indices (-1 pads preserved). When
        `train`, the working set's slots are marked dirty so eviction
        writes them back; serving passes train=False. `plan` (host
        SparsePlan in global row space) replaces the miss planner's sort
        (see `_split_batch`)."""
        (idx, valid, rows, counts, hit_slots, hit_counts, missing,
         _) = self._split_batch(idx, state.row_slot, state.cache_rows, plan)
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

    def prefetch(self, state: CacheState, rows, gate: bool = False) -> int:
        """Best-effort admission of unique global `rows` (e.g. the next
        batch's) so their fetch is queued behind the current step's device
        work. No hit/miss accounting; rows already resident are protected;
        overflow beyond free + evictable slots is dropped. `gate=True` adds
        the EMA admission threshold (`_gate_admission`). Returns the number
        of rows admitted."""
        rows = np.unique(np.asarray(rows))
        rows = rows[rows >= 0]
        missing = rows[state.row_slot[rows] < 0]
        protect = np.zeros((state.cache_rows,), bool)
        protect[state.row_slot[rows[state.row_slot[rows] >= 0]]] = True
        # seed = EMA score + 1: this request counts as one access
        seeds = _ema_score(state.ema, state.ema_tick, missing, state.tick,
                           self.decay) + np.float32(1.0)
        if gate and len(missing):
            keep = _gate_admission(state.slot_row, state.freq, protect,
                                   missing, seeds)
            missing, seeds = missing[keep], seeds[keep]
        evictable = int(((state.slot_row >= 0) & ~protect).sum())
        free = int((state.slot_row < 0).sum())
        missing, seeds = missing[:free + evictable], seeds[:free + evictable]
        self._admit(state, missing, seeds, protect)
        state.stats.prefetched += len(missing)
        return len(missing)

    # -- the tier protocol (the sync schedule) -------------------------------

    def take(self, state: CacheState, idx, train: bool = True,
             plan=None) -> np.ndarray:
        """Protocol `take`: plan, fetch and install the batch in this one
        call — `prepare` by its protocol name."""
        return self.prepare(state, idx, train=train, plan=plan)

    def stage(self, state: CacheState, idx, train: bool = True,
              plan=None) -> None:
        """Protocol `stage`: the sync tier fetches inside `take`, so there
        is nothing to stage ahead; returns None."""
        return None

    def prefetch_rows(self, state: CacheState, rows,
                      gate: bool = False) -> int:
        """Protocol alias of `prefetch`."""
        return self.prefetch(state, rows, gate=gate)

    def commit(self, state: CacheState) -> int:
        """Protocol `commit`: the sync tier installs inside `take`, so
        nothing is ever pending; returns 0."""
        return 0

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

    # -- training ------------------------------------------------------------

    def plan_to_slots(self, state, batch: dict) -> dict:
        """Relabel a host-built plan (`sparse_plan_hook`, GLOBAL rows) onto
        the cache slab: unique rows map through row_slot (a bijection over
        the batch's working set, resident after `take`), then the runs are
        re-sorted by slot so the live prefix stays strictly ascending (the
        dedup lookup's binary search needs it). Permuting whole runs leaves
        each row's bag order, so the fused update is unchanged bit for bit.
        Call after `take`; accepts CacheState or AsyncCacheState. Returns
        the three plan keys (numpy)."""
        rows = np.asarray(batch["plan_rows"])
        offs = np.asarray(batch["plan_offsets"]).astype(np.int64)
        bags = np.asarray(batch["plan_bags"], np.int32)
        n_live = int((rows >= 0).sum())        # pads trail (planner sorts)
        slots = state.row_slot[rows[:n_live]].astype(np.int64)
        order = np.argsort(slots, kind="stable")
        lengths = np.diff(offs[:n_live + 1])[order]
        new_rows = np.full(rows.shape, -1, np.int32)
        new_rows[:n_live] = slots[order]
        new_offs = offs.copy()                 # tail already == n_valid
        new_offs[:n_live + 1] = np.concatenate([[0], np.cumsum(lengths)])
        # permute the bag list segment-wise to follow its runs
        n_valid = int(offs[n_live])
        starts = offs[:n_live][order]
        ends = np.cumsum(lengths)
        gather = (np.repeat(starts - np.concatenate([[0], ends[:-1]]),
                            lengths) + np.arange(n_valid)) \
            if n_live else np.empty((0,), np.int64)
        new_bags = bags.copy()
        new_bags[:n_valid] = bags[gather]
        return {"plan_rows": new_rows,
                "plan_offsets": new_offs.astype(np.int32),
                "plan_bags": new_bags}

    def mark_updated(self, state, new_cache: torch.Tensor,
                     new_cache_accum: torch.Tensor) -> None:
        """Install post-update cache tensors (the port's update works in
        place, so these are the state's own; dirty bits were set by the
        take). Accepts CacheState or AsyncCacheState."""
        state.cache = new_cache
        state.cache_accum = new_cache_accum

    # -- writeback -----------------------------------------------------------

    def _write_back(self, state, freq: torch.Tensor) -> int:
        """Write every dirty slot back to the capacity tier through one
        pure-writeback `cache_exchange` (rows stay cached, now clean; fetch
        -1 leaves `freq` untouched). Returns rows written back."""
        slots = np.flatnonzero(state.dirty)
        if len(slots) == 0:
            return 0
        dev = state.cache.device
        cache_ops.cache_exchange(
            state.capacity, state.cache, state.cap_accum, state.cache_accum,
            freq, _device_ints(slots, dev),
            _device_ints(state.slot_row[slots], dev),
            torch.full((len(slots),), -1, dtype=torch.int32, device=dev),
            torch.zeros((len(slots),), dtype=torch.float32, device=dev))
        state.dirty[slots] = False
        state.stats.writebacks += len(slots)
        return len(slots)

    def flush(self, state: CacheState) -> int:
        """Write every dirty slot back to the capacity tier (rows stay
        cached, now clean). Returns rows written back."""
        return self._write_back(state, state.freq)

    def materialize(self, state: CacheState
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Flush and return the up-to-date (mega, accum) capacity tensors —
        what a checkpoint or an uncached evaluator should read."""
        self.flush(state)
        return state.capacity, state.cap_accum

    def stats(self, state) -> CacheStats:
        """The tier's CacheStats."""
        return state.stats

    def placement(self) -> dict:
        """Static tier layout, fastest level first."""
        return {"strategy": "cached_host", "stream": "sync",
                "levels": [{"tier": "hbm", "rows": self.cache_rows},
                           {"tier": "dram",
                            "rows": self.ebc.plan.total_rows}]}

    # -- async exchange stream -----------------------------------------------
    #
    # Per step (k = the in-flight batch):
    #   take_async(k)     pop batch k's staged plan (or plan it now), mark its
    #                     working set in flight, then COMMIT every pending
    #                     fetch — queued after batch k-1's update, so dirty
    #                     writebacks read post-update rows;
    #   <device step k against the committed slab>
    #   stage_async(k+1)  plan batch k+1 on the host, queue its fetch into a
    #                     fresh shadow slab, flip the host maps, queue the
    #                     commit.
    # Victims never come from the in-flight, staged or queued working sets.

    def init_async_state(self, mega: torch.Tensor,
                         accum: torch.Tensor | None = None
                         ) -> AsyncCacheState:
        """Async twin of `init_state`, with the same ownership of `mega`
        and `accum` (no copy), host-resident LFU scores and an empty commit
        queue at epoch 0."""
        t = self._tiers(mega, accum)
        c = self.cache_rows
        return AsyncCacheState(
            freq=np.zeros((c,), np.float32),
            slot_epoch=np.zeros((c,), np.int64), epoch=0, pending=[],
            inflight_mask=None, staged=None, **t)

    def _protected_mask(self, astate: AsyncCacheState) -> np.ndarray:
        """Slots no plan may evict: the in-flight working set, the staged
        batch's (kept apart from the queue: a drain commits and clears its
        pending entry while its remap is still outstanding) and every
        queued plan's."""
        protect = np.zeros((astate.cache_rows,), bool)
        if astate.inflight_mask is not None:
            protect |= astate.inflight_mask
        if astate.staged is not None:
            protect |= astate.staged.ws_mask
        for p in astate.pending:
            protect |= p.ws_mask
        return protect

    def _drain_if_fetching_queued_victims(self, astate: AsyncCacheState,
                                          missing: np.ndarray) -> None:
        """A row being fetched whose DIRTY eviction is still queued would
        read a stale capacity value: commit the queue first. Committing
        early is always safe (the queued writebacks read `astate.cache`,
        which carries every queued update); only the overlap is lost."""
        if not len(missing) or not astate.pending:
            return
        queued_wb = np.concatenate([p.evict_rows[p.evict_rows >= 0]
                                    for p in astate.pending])
        if len(queued_wb) and np.intersect1d(missing, queued_wb).size:
            self.commit_async(astate)

    def _admit_async(self, astate: AsyncCacheState, missing: np.ndarray,
                     extra_protect: np.ndarray, seed: np.ndarray,
                     strict: bool, gate: bool = False) -> PendingCommit:
        """Admission core of `_plan_async` and `stage_rows`: drain if a
        missing row's dirty eviction is queued, pick free slots then the
        coldest unprotected victims, queue the shadow fetch, flip the host
        maps, queue the commit. `strict=True` raises on overflow (a planned
        batch must become resident); `strict=False` truncates (best-effort
        prefetch), after the EMA threshold when `gate`. Returns the
        PendingCommit (its ws_mask covers the admitted slots)."""
        self._drain_if_fetching_queued_victims(astate, missing)
        protect = self._protected_mask(astate) | extra_protect
        if not strict:
            if gate and len(missing):
                keep = _gate_admission(astate.slot_row, astate.freq,
                                       protect, missing, seed)
                missing, seed = missing[keep], seed[keep]
            free = int((astate.slot_row < 0).sum())
            evictable = int(((astate.slot_row >= 0) & ~protect).sum())
            missing = missing[:free + evictable]
            seed = seed[:len(missing)]
        n = len(missing)
        slots, victims = _pick_slots(
            astate.slot_row, astate.freq, n, protect,
            "the staged + in-flight working sets exceed cache_rows="
            f"{astate.cache_rows}; raise the HBM budget, shrink the "
            "batch, or reduce the lookahead depth")
        evicted_rows = astate.slot_row[victims]
        wb_mask = astate.dirty[victims]
        evict_rows = np.full((n,), -1, np.int64)
        evict_rows[len(slots) - len(victims):] = np.where(
            wb_mask, evicted_rows, -1)
        src_pos = None
        shadow = shadow_accum = None
        if n:
            # fault gate first: a plan that dies here leaves the maps
            # unflipped and the queue intact (the batch re-plans at take)
            _fetch_guard(self.injector, self.retry, "cache.fetch")
            # the fetch only reads the tiers: queued behind the in-flight
            # step, it never touches a slot that step uses
            if self.fetch_chunk > 1:
                shadow, shadow_accum, src_pos = _chunked_shadow_fetch(
                    astate.capacity, astate.cap_accum, missing,
                    self.fetch_chunk, astate.stats)
            else:
                shadow, shadow_accum = cache_ops.cache_fetch(
                    astate.capacity, astate.cap_accum,
                    _device_ints(missing, astate.capacity.device))
        epoch = astate.epoch + 1
        astate.epoch = epoch
        # flip the host maps to the post-commit view now: later plans see
        # these admissions as resident
        astate.row_slot[evicted_rows] = -1
        astate.slot_row[slots] = missing
        astate.row_slot[missing] = slots.astype(np.int32)
        astate.dirty[slots] = False
        astate.freq[slots] = seed.astype(np.float32)
        astate.slot_epoch[slots] = epoch
        ws_mask = np.zeros((astate.cache_rows,), bool)
        ws_mask[slots] = True
        astate.stats.fetches += n
        astate.stats.evictions += len(victims)
        astate.stats.writebacks += int(wb_mask.sum())
        pending = PendingCommit(epoch, slots.astype(np.int64), evict_rows,
                                missing, victims, ws_mask, shadow,
                                shadow_accum, src_pos)
        if n:                                  # nothing to commit for all-hit
            astate.pending.append(pending)
        return pending

    def _plan_async(self, astate: AsyncCacheState, idx, train: bool,
                    plan=None) -> StagedBatch:
        """Plan one batch's admission on the host (LFU accounting, victim
        choice), queue its shadow fetch, flip the maps, queue the commit.
        Never waits for device work except through worklist uploads."""
        (idx, valid, rows, counts, hit_slots, hit_counts, missing,
         _) = self._split_batch(idx, astate.row_slot, astate.cache_rows,
                                plan)
        # host LFU, the math of ref.lfu_touch_ref in np.float32
        astate.freq *= np.float32(self.decay)
        astate.freq[hit_slots] += hit_counts.astype(np.float32)
        astate.tick += 1
        _ema_touch(astate.ema, astate.ema_tick, rows, counts, astate.tick,
                   self.decay)
        extra = np.zeros((astate.cache_rows,), bool)
        extra[hit_slots] = True
        n = len(missing)
        pending = self._admit_async(astate, missing, extra,
                                    astate.ema[missing], strict=True)
        ws_slots = astate.row_slot[rows]
        pending.ws_mask[ws_slots] = True       # widen: full batch working set
        if train:
            astate.dirty[ws_slots] = True
        hits = int(counts.sum()) - n
        astate.stats.hits += hits
        astate.stats.misses += n
        astate.stats.steps += 1
        return StagedBatch(pending.epoch, idx.copy(),
                           self._remap(astate.row_slot, idx, valid),
                           pending.ws_mask, hits, n)

    def stage_async(self, astate: AsyncCacheState, idx, train: bool = True,
                    plan=None) -> np.ndarray:
        """Stage the NEXT batch: plan it and queue its shadow fetch while
        the in-flight batch computes. Returns its slot-space remap, which
        `take_async` hands back when the batch becomes current."""
        staged = self._plan_async(astate, idx, train, plan)
        astate.staged = staged
        return staged.local

    def stage_rows(self, astate: AsyncCacheState, rows,
                   gate: bool = False) -> int:
        """Best-effort lookahead admission (the async twin of `prefetch`):
        queue a fetch for `rows` without hit/miss accounting and without
        evicting a protected slot; overflow is dropped. Returns rows
        admitted."""
        rows = np.unique(np.asarray(rows))
        rows = rows[rows >= 0]
        missing = rows[astate.row_slot[rows] < 0]
        if len(missing) == 0:
            return 0
        extra = np.zeros((astate.cache_rows,), bool)
        extra[astate.row_slot[rows[astate.row_slot[rows] >= 0]]] = True
        seeds = _ema_score(astate.ema, astate.ema_tick, missing,
                           astate.tick, self.decay) + np.float32(1.0)
        pending = self._admit_async(astate, missing, extra, seeds,
                                    strict=False, gate=gate)
        n = len(pending.rows)
        astate.stats.prefetched += n
        return n

    def take_async(self, astate: AsyncCacheState, idx, train: bool = True,
                   plan=None) -> np.ndarray:
        """Make `idx`'s batch current: reuse its staged plan when one
        matches, else plan it now (cold start, strict-sync fallback, or a
        staged plan for another batch, which then counts as a prefetch).
        Marks the working set in flight and commits every pending fetch.
        Returns the (B, F, L) slot-space indices."""
        idx = _host(idx)
        st = astate.staged
        astate.staged = None
        if st is None or st.idx_key.shape != idx.shape or \
                not np.array_equal(st.idx_key, idx):
            if st is not None:
                # the discarded plan's rows stay admitted, but its batch
                # never runs: re-book its stats as a prefetch
                astate.stats.hits -= st.hits
                astate.stats.misses -= st.misses
                astate.stats.steps -= 1
                astate.stats.prefetched += st.misses
            st = self._plan_async(astate, idx, train, plan)
        astate.inflight_mask = st.ws_mask
        self.commit_async(astate)
        return st.local

    def commit_async(self, astate: AsyncCacheState) -> int:
        """Drain the pending queue in order: each entry's dirty victims
        write back (post-update values) and its shadow rows install into
        their slots (`cache_commit`). Returns entries committed."""
        dev = astate.cache.device
        done = 0
        for p in astate.pending:
            cache_ops.cache_commit(
                astate.capacity, astate.cache, astate.cap_accum,
                astate.cache_accum, p.shadow, p.shadow_accum,
                _device_ints(p.slots, dev), _device_ints(p.evict_rows, dev),
                _device_ints(p.rows, dev),
                src_pos=None if p.src_pos is None
                else _device_ints(p.src_pos, dev))
            done += 1
        # the slabs are freed here, after their commits are queued on the
        # same stream, so the allocator cannot hand them out too early
        astate.pending.clear()
        return done

    def lookup_async(self, astate: AsyncCacheState, idx,
                     train: bool = False) -> torch.Tensor:
        """take_async + cache lookup: equal to the sync `lookup` and to the
        uncached collection on the same indices."""
        return self.lookup_cached(astate,
                                  self.take_async(astate, idx, train))

    def flush_async(self, astate: AsyncCacheState) -> int:
        """Commit all pending fetches, then write every dirty slot back
        (rows stay cached, now clean). Returns rows written back."""
        self.commit_async(astate)
        # the LFU scores live on the host; the exchange wants a device
        # (C,) tensor, which a pure writeback never writes
        return self._write_back(astate, torch.empty(
            (astate.cache_rows,), dtype=torch.float32,
            device=astate.cache.device))

    def materialize_async(self, astate: AsyncCacheState
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """flush_async and return the up-to-date (mega, accum) capacity
        tensors — bit-equal to the sync `materialize` after the same
        batches."""
        self.flush_async(astate)
        return astate.capacity, astate.cap_accum

    # -- checkpointing -------------------------------------------------------

    def state_dict(self, state: CacheState | AsyncCacheState) -> dict:
        """The whole tier as a checkpointable tree: the device tensors
        (capacity, cap_accum, cache, cache_accum, and the sync schedule's
        freq) are the tier's OWN tensors on its device, not copies (a
        full-width capacity tier does not fit twice), so save or load them
        before the tier steps again; the host maps are owned numpy copies.

        An AsyncCacheState is first drained (`commit_async`) and a staged
        but unconsumed plan is unwound to a prefetch, as `take_async` does
        on a mismatch: its rows stay admitted and the restored run
        re-plans the batch, which leaves the model's math unchanged.
        Mutates `state` (drain + unwind) before taking it."""
        is_async = isinstance(state, AsyncCacheState)
        if is_async:
            self.commit_async(state)
            st = state.staged
            state.staged = None
            if st is not None:
                state.stats.hits -= st.hits
                state.stats.misses -= st.misses
                state.stats.steps -= 1
                state.stats.prefetched += st.misses
            state.inflight_mask = None
        d = {k: getattr(state, k) for k in
             ("capacity", "cap_accum", "cache", "cache_accum")}
        d["freq"] = np.array(state.freq) if is_async else state.freq
        d.update({k: np.array(getattr(state, k)) for k in
                  ("slot_row", "row_slot", "dirty", "ema", "ema_tick")})
        d["tick"] = np.int64(state.tick)
        d["stats"] = {k: np.int64(v)
                      for k, v in dataclasses.asdict(state.stats).items()}
        if is_async:
            d["slot_epoch"] = np.array(state.slot_epoch)
            d["epoch"] = np.int64(state.epoch)
        return d

    def load_state_dict(self, d: dict, device=None
                        ) -> CacheState | AsyncCacheState:
        """Rebuild the tier from a `state_dict` tree (as restored by
        `CheckpointManager.restore`, or numpy leaves). Tensor leaves are
        taken as they are, without a copy; numpy device leaves go to the
        capacity tensor's device, else to `device` (default cuda). The
        host maps become owned copies, since the planner mutates them. The
        async-only `epoch` key selects the state's flavour."""
        cap = d["capacity"]
        dev = (cap.device if isinstance(cap, torch.Tensor)
               else resolve_device(device))

        def on_dev(x, dtype):
            if isinstance(x, torch.Tensor):
                return x
            return torch.from_numpy(np.array(x, dtype)).to(dev)

        stats = CacheStats(**{k: int(v) for k, v in d["stats"].items()})
        tensors = dict(capacity=on_dev(cap, np.float32),
                       cap_accum=on_dev(d["cap_accum"], np.float32),
                       cache=on_dev(d["cache"], np.float32),
                       cache_accum=on_dev(d["cache_accum"], np.float32))
        host = dict(
            slot_row=np.array(d["slot_row"], np.int64),
            row_slot=np.array(d["row_slot"], np.int32),
            dirty=np.array(d["dirty"], bool),
            ema=np.array(d["ema"], np.float32),
            ema_tick=np.array(d["ema_tick"], np.int64))
        if "epoch" in d:
            return AsyncCacheState(
                **tensors, freq=np.array(d["freq"], np.float32), **host,
                slot_epoch=np.array(d["slot_epoch"], np.int64),
                epoch=int(d["epoch"]), pending=[], inflight_mask=None,
                staged=None, tick=int(d["tick"]), stats=stats)
        return CacheState(**tensors, freq=on_dev(d["freq"], np.float32),
                          **host, tick=int(d["tick"]), stats=stats)
