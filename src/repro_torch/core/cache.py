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
The payload tensors are updated IN PLACE (the reference donated them to
XLA); the slot maps and per-row EMA counters are host numpy, exactly as in
the reference, so eviction choices are the reference's.

Placement (`init_state(mega, device=...)`): the device tier goes on
`device` (default: mega's device). The capacity tier stays where `mega`
is: on the card, or, for a CUDA device tier, in page-locked host memory
(`core.hostmem.pinned_zeros`), the paper's system-memory tier, which the
row movers read and write across PCIe. A pageable host `mega` under a CUDA
device tier raises: the kernels cannot reach it. Kernels write a host
capacity tier asynchronously, so every host read of it (`materialize`,
`state_dict`, the bulk tier's demotions and reseed) first waits on an event
recorded after the last kernel that writes it (`capacity_fence`).

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
Two tier hooks, `_stage_capacity` before every capacity-tier read and
`_absorb_evictions` after every eviction, are no-ops here; the bulk tier
(`core.tiers`) overrides them.

`MultiHostCachedEmbeddingBagCollection` is the data-parallel tier: H
hosts' clean hot caches over ONE row-sharded capacity tier. Its host maps
are numpy as in the reference; its slab installs are index ops on the
card (`install`), and its train step (`train.steps`) routes every update
to the owning shard through the segmented fused update.
"""
from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import DLRMConfig
from repro_torch.core import hostmem
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.kernels import cache_ops
from repro_torch.kernels.sparse_plan import (build_sparse_plan_host,
                                             coalesce_rows,
                                             split_plan_by_host,
                                             split_plan_by_owner)


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

    def reset(self) -> None:
        """Zero every counter in place (subclasses' too)."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


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
    capacity_event: Any = None  # CUDA event after the last kernel that
                                # writes a host capacity tier

    @property
    def cache_rows(self) -> int:
        """Device-tier height C (slots)."""
        return int(self.cache.shape[0])

    @property
    def resident(self) -> int:
        """Number of occupied cache slots."""
        return int((self.slot_row >= 0).sum())


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
    capacity_event: Any = None  # see CacheState

    @property
    def cache_rows(self) -> int:
        """Device-tier height C (slots)."""
        return int(self.cache.shape[0])

    @property
    def resident(self) -> int:
        """Number of occupied cache slots."""
        return int((self.slot_row >= 0).sum())


def _host_capacity(state) -> bool:
    """True when the capacity tier is host memory under a CUDA device
    tier (written by queued kernels, read by host code)."""
    return state.capacity.device.type == "cpu" and state.cache.is_cuda


def _capacity_written(state) -> None:
    """Record an event after the kernels queued so far, which may write a
    host capacity tier."""
    if _host_capacity(state):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(state.cache.device))
        state.capacity_event = ev


def capacity_fence(state) -> None:
    """Wait until no queued kernel writes the capacity tier any more.
    Needed before host code reads a host capacity tier; a no-op when the
    tier is on the card (torch orders its reads on the stream) or nothing
    was queued."""
    if state.capacity_event is not None:
        state.capacity_event.synchronize()
        state.capacity_event = None


def _rows_padded(t: torch.Tensor, lo: int, hi: int, dtype,
                 dev: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of `t` as `dtype` on `dev`'s device type: `t` itself
    or a view of it when it holds them all, else a new tensor, zeros past
    t's end."""
    if t.shape[0] >= hi and t.dtype == dtype and t.device.type == dev.type:
        return t if (lo, hi) == (0, t.shape[0]) else t[lo:hi]
    out = torch.zeros((hi - lo,) + tuple(t.shape[1:]), dtype=dtype,
                      device=dev)
    n = max(0, min(hi, t.shape[0]) - lo)
    out[:n] = t[lo:lo + n]
    return out


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
                          missing: np.ndarray, chunk: int, stats: CacheStats,
                          dev: torch.device | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """Chunk-granular shadow fetch of the sorted `missing` rows, shared by
    the sync and async admissions: dense blocks through
    `cache_fetch_chunked`, the isolated rest through `cache_fetch`, one
    slab. Books `fetch_chunks` (transfers) and `overfetch_rows` (block
    padding). The worklists and the slab go on `dev`, the device tier's
    (default capacity's). Returns (shadow, shadow_accum, src_pos): src_pos[i] is miss i's slab
    row, the commit's install remap."""
    total = int(capacity.shape[0])
    chunk = min(chunk, total)
    starts, pos = coalesce_rows(missing, chunk, total,
                                min_fill=_chunk_min_fill(chunk))
    single = np.flatnonzero(pos < 0)
    src_pos = pos.copy()
    src_pos[single] = len(starts) * chunk + np.arange(len(single),
                                                      dtype=np.int32)
    dev = capacity.device if dev is None else dev
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

    @property
    def coverage(self) -> float:
        """Fraction of the row space with a recorded value."""
        return float(self.seen.mean()) if len(self.seen) else 0.0


def _restore_device(cap, cache, device) -> torch.device:
    """The device a `load_state_dict` puts numpy leaves on: `device`, else
    the device tier's (`cache` leaf), else a tensor capacity leaf's unless
    it is page-locked host memory, else cuda."""
    if device is not None:
        return resolve_device(device)
    if isinstance(cache, torch.Tensor):
        return cache.device
    if isinstance(cap, torch.Tensor) and not (
            cap.device.type == "cpu" and hostmem.is_page_locked(cap)):
        return cap.device
    return resolve_device(None)


def _leaf_on(x, dtype, dev: torch.device) -> torch.Tensor:
    """A restored leaf as a tensor: a tensor as it is, numpy onto `dev`."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, dtype)).to(dev)


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

    _stats_cls: ClassVar[type] = CacheStats

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

    def _tiers(self, mega: torch.Tensor, accum: torch.Tensor | None,
               device):
        r, d = mega.shape
        if r != self.ebc.plan.total_rows:
            raise ValueError(f"mega has {r} rows, the plan "
                             f"{self.ebc.plan.total_rows}")
        dev = mega.device if device is None else torch.device(device)
        on_host = mega.device.type == "cpu" and dev.type == "cuda"
        if on_host:
            for name, t in (("mega", mega), ("accum", accum)):
                if t is not None and t.device.type == "cpu" \
                        and not hostmem.is_page_locked(t):
                    raise ValueError(
                        f"{name} is pageable host memory under a CUDA "
                        "device tier: the kernels cannot reach it; make it "
                        "with core.hostmem.pinned_zeros or keep it on the "
                        "card")
        elif mega.device.type != dev.type:
            raise ValueError(f"a capacity tier on {mega.device} under a "
                             f"device tier on {dev}")
        c = self.cache_rows
        if accum is None:
            accum = (hostmem.pinned_zeros((r,)) if on_host else
                     torch.zeros((r,), dtype=torch.float32, device=dev))
        return dict(
            capacity=mega, cap_accum=accum,
            cache=torch.zeros((c, d), dtype=mega.dtype, device=dev),
            cache_accum=torch.zeros((c,), dtype=torch.float32, device=dev),
            slot_row=np.full((c,), -1, np.int64),
            row_slot=np.full((r,), -1, np.int32),
            dirty=np.zeros((c,), bool),
            ema=np.zeros((r,), np.float32),
            ema_tick=np.zeros((r,), np.int64),
            tick=0, stats=self._stats_cls())

    def init_state(self, mega: torch.Tensor,
                   accum: torch.Tensor | None = None,
                   device=None) -> CacheState:
        """mega: (total_rows, d) fp32 capacity-tier table; accum: optional
        (total_rows,) AdaGrad accumulator; device: the device tier's
        device (default mega's).

        The state TAKES OWNERSHIP of `mega` (and `accum`) without copying:
        the row movers write the capacity tier in place, so the caller must
        not use `mega` for anything else afterwards. (The reference copies;
        at full dlrm-m1 width two 43.6 GB copies do not fit in one card.)
        The cache, its accumulators and the LFU scores are allocated on
        `device`. With a CUDA `device`, a host `mega` (and `accum`) must be
        page-locked (`core.hostmem.pinned_zeros`), else ValueError before
        any allocation; a missing `accum` is then allocated page-locked."""
        t = self._tiers(mega, accum, device)
        return CacheState(freq=torch.zeros((self.cache_rows,),
                                           dtype=torch.float32,
                                           device=t["cache"].device), **t)

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

    # -- tier hooks (the bulk tier, core/tiers.py, overrides them) ---------

    def _stage_capacity(self, state, missing: np.ndarray) -> None:
        """Called by every admission with the sorted unique `missing` rows
        right before the capacity tier is read. The two-tier collection
        stages nothing: capacity is its slowest tier."""

    def _absorb_evictions(self, state, evicted_rows: np.ndarray) -> None:
        """Called by every admission after the host maps flip, with the
        rows displaced from the device tier. The two-tier collection needs
        nothing: evicted rows already live in capacity."""

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
        # tier hook: stage the rows into capacity before the fetch reads it
        self._stage_capacity(state, missing)
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
                state.stats, dev)
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
        _capacity_written(state)
        # host maps
        state.row_slot[evicted_rows] = -1
        state.slot_row[slots] = missing
        state.row_slot[missing] = slots.astype(np.int32)
        state.dirty[slots] = False
        # tier hook: evicted rows fall back to the next tier down
        self._absorb_evictions(state, evicted_rows)
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
        _capacity_written(state)
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
        what a checkpoint or an uncached evaluator should read. A host
        capacity tier is returned after its writebacks have landed."""
        self.flush(state)
        capacity_fence(state)
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
                         accum: torch.Tensor | None = None,
                         device=None) -> AsyncCacheState:
        """Async twin of `init_state`, with the same ownership of `mega`
        and `accum` (no copy) and placement (`device`), host-resident LFU
        scores and an empty commit queue at epoch 0."""
        t = self._tiers(mega, accum, device)
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
            # tier hook: stage the rows into capacity before the fetch
            # reads it (its own fault gate also fires before any mutation)
            self._stage_capacity(astate, missing)
            # the fetch only reads the tiers: queued behind the in-flight
            # step, it never touches a slot that step uses
            dev = astate.cache.device
            if self.fetch_chunk > 1:
                shadow, shadow_accum, src_pos = _chunked_shadow_fetch(
                    astate.capacity, astate.cap_accum, missing,
                    self.fetch_chunk, astate.stats, dev)
            else:
                shadow, shadow_accum = cache_ops.cache_fetch(
                    astate.capacity, astate.cap_accum,
                    _device_ints(missing, dev))
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
        # tier hook after the append: a demotion that must drain queued
        # dirty writebacks sees this entry too
        self._absorb_evictions(astate, evicted_rows)
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
        if done:
            _capacity_written(astate)
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
        capacity_fence(astate)
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
        Mutates `state` (drain + unwind) before taking it. A host capacity
        tier is returned after its queued writebacks have landed."""
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
        capacity_fence(state)
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
        taken as they are, without a copy, so a page-locked host capacity
        tier stays there (`CheckpointManager.restore` fills the example
        tree's own tensors in place). Numpy leaves go to the device tier's
        device: `device`, else the `cache` leaf's, else a tensor capacity
        leaf's unless it is page-locked host memory (default cuda). The
        host maps become owned copies, since the planner mutates them. The
        async-only `epoch` key selects the state's flavour."""
        cap, cache = d["capacity"], d["cache"]
        dev = _restore_device(cap, cache, device)

        def on_dev(x, dtype):
            return _leaf_on(x, dtype, dev)

        stats = self._stats_cls(**{k: int(v) for k, v in d["stats"].items()})
        tensors = dict(capacity=on_dev(cap, np.float32),
                       cap_accum=on_dev(d["cap_accum"], np.float32),
                       cache=on_dev(cache, np.float32),
                       cache_accum=on_dev(d["cache_accum"], np.float32))
        if tensors["cache"].is_cuda:
            for name in ("capacity", "cap_accum"):
                t = tensors[name]
                if t.device.type == "cpu" and not hostmem.is_page_locked(t):
                    raise ValueError(
                        f"{name} is pageable host memory under a CUDA "
                        "device tier: the kernels cannot reach it")
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


# ---------------------------------------------------------------------------
# The multi-host tier: per-host caches over one row-sharded capacity tier
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class RouteStats:
    """Per-row traffic counters of the multi-host tier: which shard served
    each capacity-tier touch. `local` means the touching host owns the row
    (owner == host); `remote` rows crossed the host interconnect, the
    all-to-all legs `launch.analysis.multihost_exchange_traffic` prices."""
    fetch_local: int = 0       # miss rows served by the host's own shard
    fetch_remote: int = 0      # miss rows pulled from a remote owner
    refresh_local: int = 0     # post-update working-set rows, own shard
    refresh_remote: int = 0    # ... returned by a remote owner
    grad_pairs_local: int = 0  # (row, bag) grads aggregated at a local owner
    grad_pairs_remote: int = 0  # pairs routed to a remote owner
    dup_rows: int = 0          # rows in >1 host's working set, reduced once
                               # at the owner
    invalidations: int = 0     # cached copies dropped after a remote update
    fetch_chunks: int = 0      # per-(host, owner) transfer descriptors after
                               # run-coalescing the miss messages
    steps: int = 0

    @property
    def remote_fetch_fraction(self) -> float:
        """Fraction of fetched rows served by a remote owner shard."""
        total = self.fetch_local + self.fetch_remote
        return self.fetch_remote / total if total else 0.0

    def snapshot(self) -> dict[str, float]:
        """Flat metrics dict (the train step's logging payload)."""
        return {"route_fetch_local": float(self.fetch_local),
                "route_fetch_remote": float(self.fetch_remote),
                "route_refresh_remote": float(self.refresh_remote),
                "route_grad_pairs_remote": float(self.grad_pairs_remote),
                "route_dup_rows": float(self.dup_rows),
                "route_invalidations": float(self.invalidations),
                "route_fetch_chunks": float(self.fetch_chunks),
                "route_remote_fetch_fraction": self.remote_fetch_fraction}

    def reset(self) -> None:
        """Zero every counter in place."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


@dataclasses.dataclass
class MultiHostCacheState:
    """State of the data-parallel cached tier: ONE row-sharded capacity
    tier (owner h holds rows [h*shard_rows, (h+1)*shard_rows)) under H
    independent per-host hot caches over the whole row space.

    Cached copies are clean by construction: updates are routed to the
    owning shard and applied there once, each host's working set is
    refreshed from the post-update capacity inside the same step, and
    copies a remote update left stale are invalidated before the next
    batch plans. Eviction never writes back, and the AdaGrad accumulator
    never leaves the owner."""
    capacity: torch.Tensor     # (R, d) row-sharded capacity tier
    cap_accum: torch.Tensor    # (R,) fp32 AdaGrad accumulator, owner-only
    caches: torch.Tensor       # (H, C, d) per-host clean hot caches
    freq: np.ndarray           # (H, C) host fp32 LFU-with-decay scores
    slot_row: np.ndarray       # (H, C) int64: row held by slot, -1 free
    row_slot: np.ndarray       # (H, R) int32: slot holding row, -1 uncached
    ema: np.ndarray            # (R,) fp32 EMA-decayed GLOBAL per-row counts
    ema_tick: np.ndarray       # (R,) int64 tick of each row's last EMA touch
    tick: int                  # EMA clock: one tick per planned batch
    stats: CacheStats          # aggregate over hosts
    route: RouteStats
    # under a host mesh (`init_state(capacity_sharding=)`): this rank holds
    # host `mesh.coords[host_axis]`'s slab alone (caches (1, C, d)) and the
    # capacity rows [row_base, row_base + len(capacity)); the host maps
    # stay every host's, planned alike on every rank
    mesh: Any = None
    host_axis: str = "data"
    row_base: int = 0

    @property
    def n_hosts(self) -> int:
        """Host count H (one hot cache each)."""
        return int(self.freq.shape[0])

    @property
    def host(self) -> int | None:
        """This rank's host under a mesh; None on a single controller."""
        return None if self.mesh is None else self.mesh.coords[self.host_axis]

    @property
    def rows(self) -> tuple[int, int]:
        """The global capacity rows this state holds: all of them on a
        single controller, the owner's shard under a mesh."""
        return self.row_base, self.row_base + int(self.capacity.shape[0])

    @property
    def cache_rows(self) -> int:
        """Per-host device-tier height C (slots)."""
        return int(self.caches.shape[1])


@dataclasses.dataclass
class MultiHostStepPlan:
    """One batch's host-planned worklist: every array the multi-host step
    consumes (`train.steps`), host numpy, -1-padded; the miss and
    working-set lists hold each host's live entries first."""
    local_idx: np.ndarray      # (H, B/H, F, L) slot-space remap
    miss_rows: np.ndarray      # (H, M) capacity rows to install pre-forward
    miss_slots: np.ndarray     # (H, M) destination cache slots
    ws_rows: np.ndarray        # (H, M) working-set rows to refresh post-update
    ws_slots: np.ndarray       # (H, M) their cache slots
    seg_rows: np.ndarray       # (H, U) OWNER-LOCAL unique rows per segment
    seg_offsets: np.ndarray    # (H, U+1) absolute positions into bag_ids
    seg_base: np.ndarray       # (H,) owner row bases
    bag_ids: np.ndarray        # (N,) shared flat-bag list of the global plan


@dataclasses.dataclass(frozen=True)
class MultiHostCachedEmbeddingBagCollection:
    """The cached tier under data parallelism: H hosts each run a
    `cache_rows` hot cache over a capacity tier row-sharded across the same
    H hosts. Misses resolve against the owning shard (each host's sorted
    sub-plan grouped by owner), and gradients of rows cached on several
    hosts are routed to the owner and reduced once before the fused
    AdaGrad update (per-owner segments of the global plan).

    With host h holding examples [h*B/H, (h+1)*B/H), the owner's reduction
    runs in flat-batch order, so the tier is bit-equal to the uncached
    step (`build_dlrm_train_step(sparse_apply="sparse")`).

    Single controller: one process drives every host's cache, all on the
    capacity tier's device. Under a host mesh (`init_state(
    capacity_sharding=)`), one rank a host: rank h keeps its slab and the
    capacity rows it owns, plans every batch exactly as the single
    controller does (so every rank holds every host's maps and counters,
    with the same integers), and installs its misses and working set from
    the owners by copy (`install_worklist`, `Mesh.all_to_all_rows`). The
    host maps (`freq`, `slot_row`, `row_slot`, `ema`, `ema_tick`) are host
    numpy with the reference's integers and fp32 arithmetic; slab installs
    are `index_select` / `index_copy_` on the device (`install`)."""
    ebc: EmbeddingBagCollection
    n_hosts: int
    cache_rows: int
    decay: float = 0.98        # LFU and EMA decay per step
    fetch_chunk: int = 1       # miss-message granularity in rows: > 1
                               # coalesces each (host, owner) message's
                               # sorted rows into blocks (booked in
                               # RouteStats.fetch_chunks)
    injector: Any = None       # FaultInjector firing "cache.fetch" once per
                               # planned global batch and per prefetch,
                               # before any host map mutates
    retry: Any = None          # RetryPolicy for transient faults

    def __post_init__(self):
        if self.cache_rows <= 0:
            raise ValueError("cached_host plan produced an empty cache")
        if self.fetch_chunk < 1:
            raise ValueError(f"fetch_chunk must be >= 1, got "
                             f"{self.fetch_chunk}")

    @classmethod
    def build(cls, cfg: DLRMConfig, n_hosts: int,
              cache_rows: int | None = None, decay: float = 0.98,
              fetch_chunk: int = 1, total_rows: int | None = None
              ) -> MultiHostCachedEmbeddingBagCollection:
        """Build over a fresh `cached_host` collection whose capacity tier
        is row-sharded over `n_hosts`; `cache_rows` (per host) defaults to
        the plan's. `total_rows` (at least the plan's, a multiple of
        n_hosts) pads the capacity tier further: a mesh of another size
        saved it that tall (the layout pads to 8 * n_hosts rows), and an
        elastic restore re-shards the saved rows as they are. Pad rows are
        never reached."""
        ebc = EmbeddingBagCollection.build(cfg, n_shards=n_hosts,
                                           strategy="cached_host",
                                           capacity_shards=n_hosts)
        if total_rows is not None:
            if total_rows < ebc.plan.total_rows or total_rows % n_hosts:
                raise ValueError(
                    f"total_rows {total_rows}: want at least the plan's "
                    f"{ebc.plan.total_rows} and a multiple of {n_hosts}")
            ebc = dataclasses.replace(ebc, plan=dataclasses.replace(
                ebc.plan, total_rows=int(total_rows),
                shard_rows=int(total_rows) // n_hosts))
        rows = cache_rows if cache_rows is not None else ebc.plan.cache_rows
        return cls(ebc, int(n_hosts), int(rows), decay, int(fetch_chunk))

    @property
    def shard_rows(self) -> int:
        """Capacity rows owned by each host shard."""
        return self.ebc.plan.shard_rows

    # -- state ---------------------------------------------------------------

    def init_state(self, mega: torch.Tensor | None,
                   accum: torch.Tensor | None = None, device=None,
                   capacity_sharding=None) -> MultiHostCacheState:
        """mega: (rows, d) capacity table, rows <= total_rows; accum:
        optional (rows,) fp32 AdaGrad accumulator; device: the caches'
        device (default mega's), which must be the capacity tier's.

        A `mega` (and `accum`) of height total_rows is TAKEN, not copied:
        the update writes the capacity tier in place, so the caller must
        not use it for anything else afterwards (at full dlrm-m1 width a
        second 43.6 GB capacity does not fit beside the caches). A shorter
        one (a single-host layout, whose tail padding is 8-aligned rather
        than H*8-aligned) is zero-padded into a new tensor, as the
        reference does; pad rows are unreachable.

        `capacity_sharding` (an `nn.sharding.NamedSharding` over a host
        mesh, spec `ebc.plan.pspec`: one axis of n_hosts ranks on the
        rows) makes this the state of one rank: it keeps the rows its
        coordinate owns, [h*shard_rows, (h+1)*shard_rows), of mega and
        accum (a view of a full-height table: a CUDA IPC view of a
        parent's table stays the parent's memory and is updated there),
        its own (1, C, d) slab, and every host's maps. With mega None its
        rows start as zeros on `device`, for `CheckpointManager.restore(
        shardings=)` to fill in place."""
        total = self.ebc.plan.total_rows
        if capacity_sharding is not None:
            return self._init_rank_state(mega, accum, device,
                                         capacity_sharding)
        r, d = mega.shape
        if r > total:
            raise ValueError(f"mega has {r} rows, the plan {total}")
        dev = mega.device if device is None else torch.device(device)
        if mega.device.type != dev.type or (
                accum is not None and accum.device.type != dev.type):
            raise ValueError(
                f"the multi-host tier keeps its capacity tier on the caches' "
                f"device ({dev}); got mega on {mega.device}")
        if accum is None:
            accum = torch.zeros((r,), dtype=torch.float32, device=dev)
        capacity = _rows_padded(mega, 0, total, mega.dtype, dev)
        cap_accum = _rows_padded(accum, 0, total, torch.float32, dev)
        return self._state(capacity, cap_accum, self.n_hosts, dev)

    def _state(self, capacity, cap_accum, slabs: int, dev, **kw
               ) -> MultiHostCacheState:
        h, c, total = self.n_hosts, self.cache_rows, self.ebc.plan.total_rows
        return MultiHostCacheState(
            capacity=capacity, cap_accum=cap_accum,
            caches=torch.zeros((slabs, c, capacity.shape[1]),
                               dtype=capacity.dtype, device=dev),
            freq=np.zeros((h, c), np.float32),
            slot_row=np.full((h, c), -1, np.int64),
            row_slot=np.full((h, total), -1, np.int32),
            ema=np.zeros((total,), np.float32),
            ema_tick=np.zeros((total,), np.int64),
            tick=0, stats=CacheStats(), route=RouteStats(), **kw)

    def _init_rank_state(self, mega, accum, device, sharding
                         ) -> MultiHostCacheState:
        """`init_state` under a host mesh (see there)."""
        axis = sharding.spec[0] if sharding.spec else None
        if not isinstance(axis, str) or \
                sharding.mesh.shape[axis] != self.n_hosts:
            raise ValueError(
                f"capacity_sharding {sharding} does not row-shard over "
                f"{self.n_hosts} hosts: want the spec (host_axis, None) "
                f"on a mesh whose host_axis has {self.n_hosts} ranks")
        total, d = self.ebc.plan.total_rows, self.ebc.cfg.embed_dim
        lo = sharding.mesh.coords[axis] * self.shard_rows
        hi = lo + self.shard_rows
        if mega is None:
            dev = torch.device(device if device is not None else "cuda")
            capacity = torch.zeros((self.shard_rows, d), dtype=torch.float32,
                                   device=dev)
        else:
            if mega.shape[0] > total:
                raise ValueError(f"mega has {mega.shape[0]} rows, the plan "
                                 f"{total}")
            dev = mega.device if device is None else torch.device(device)
            capacity = _rows_padded(mega, lo, hi, mega.dtype, dev)
        cap_accum = (torch.zeros((self.shard_rows,), dtype=torch.float32,
                                 device=dev) if accum is None
                     else _rows_padded(accum, lo, hi, torch.float32, dev))
        return self._state(capacity, cap_accum, 1, dev, mesh=sharding.mesh,
                           host_axis=axis, row_base=lo)

    # -- per-host admission --------------------------------------------------

    def _admit_host(self, state: MultiHostCacheState, h: int,
                    missing: np.ndarray, seeds: np.ndarray,
                    protect: np.ndarray) -> np.ndarray:
        """Assign host h's cache slots to `missing` rows: free slots first,
        then the coldest unprotected residents. `seeds` are the slots'
        initial LFU scores. Caches are clean, so a displaced copy is just
        dropped. Returns the slots."""
        n = len(missing)
        if n == 0:
            return np.empty((0,), np.int64)
        slots, victims = _pick_slots(
            state.slot_row[h], state.freq[h], n, protect,
            f"host {h}'s batch working set exceeds cache_rows="
            f"{state.cache_rows}; raise the HBM budget or shrink the "
            "per-host batch")
        evicted = state.slot_row[h, victims]
        state.row_slot[h, evicted] = -1
        state.slot_row[h, slots] = missing
        state.row_slot[h, missing] = slots.astype(np.int32)
        state.freq[h, slots] = seeds.astype(np.float32)
        state.stats.fetches += n
        state.stats.evictions += len(victims)
        return slots

    def _book_fetch_chunks(self, state: MultiHostCacheState,
                           missing: np.ndarray) -> None:
        """Book the per-(host, owner) miss messages of one host's sorted
        `missing` rows as chunked transfers: each owner's slice coalesces
        on its own (blocks never straddle shard boundaries)."""
        chunk = min(self.fetch_chunk, self.shard_rows)
        cuts = np.searchsorted(
            missing, np.arange(self.n_hosts + 1) * self.shard_rows)
        for s in range(self.n_hosts):
            a, b = int(cuts[s]), int(cuts[s + 1])
            if b > a:
                starts, pos = coalesce_rows(
                    missing[a:b] - s * self.shard_rows, chunk,
                    self.shard_rows, min_fill=_chunk_min_fill(chunk))
                n_single = int((pos < 0).sum())
                descs = len(starts) + n_single
                state.route.fetch_chunks += descs
                state.stats.fetch_chunks += descs
                state.stats.overfetch_rows += \
                    len(starts) * chunk - (b - a - n_single)

    # -- step planning -------------------------------------------------------

    def plan_step(self, state: MultiHostCacheState, idx, host_plans=None,
                  global_plan=None, train: bool = True) -> MultiHostStepPlan:
        """Plan one global batch on the host: per host, split its
        contiguous sub-batch into hits and misses off its sub-plan (the
        live prefix is the host's sorted unique row set), admit the misses
        (LFU eviction, clean drop) and remap to slot space. Cross-host legs
        are booked in RouteStats by owner (row // shard_rows). When
        `train`, also cut the global plan into per-owner update segments
        (`split_plan_by_owner`, seg_cap = the plan's height) and invalidate
        the cached copies this step's remote updates leave stale (working
        set copies are exempt: the step refreshes them).

        idx: (B, F, L) OFFSET global rows, B divisible by n_hosts;
        host_plans / global_plan: a hook's (`host_plans_from_batch` /
        `host_plan_from_batch`), else built here. Mutates the host maps."""
        # the fault gate comes before any mutation (tick, EMA, maps): a
        # propagated transient fault leaves this call cleanly replayable
        _fetch_guard(self.injector, self.retry, "cache.fetch")
        idx = _host(idx)
        b, f, lk = idx.shape
        hn = self.n_hosts
        if b % hn:
            raise ValueError(f"a global batch of {b} does not split over "
                             f"{hn} hosts")
        bh = b // hn
        if global_plan is None:
            global_plan = build_sparse_plan_host(idx)
        if host_plans is None:
            host_plans = split_plan_by_host(global_plan, hn, bh * f)
        m = bh * f * lk                       # per-host worklist capacity
        local_idx = np.empty((hn, bh, f, lk), np.int32)
        miss_rows = np.full((hn, m), -1, np.int32)
        miss_slots = np.full((hn, m), -1, np.int32)
        ws_rows = np.full((hn, m), -1, np.int32)
        ws_slots = np.full((hn, m), -1, np.int32)
        g_rows = np.asarray(global_plan.unique_rows)
        n_live = int((g_rows >= 0).sum())
        dup = -n_live
        state.tick += 1          # one EMA tick per planned global batch
        for h in range(hn):
            (sub, valid, rows, counts, hit_slots, hit_counts, missing,
             _) = CachedEmbeddingBagCollection._split_batch(
                idx[h * bh:(h + 1) * bh], state.row_slot[h],
                self.cache_rows, host_plans[h])
            dup += len(rows)
            # host LFU: decay everything, bump hits; admissions seed below
            state.freq[h] *= np.float32(self.decay)
            state.freq[h, hit_slots] += hit_counts.astype(np.float32)
            # the GLOBAL per-row EMA: hosts touch in turn, so a shared row
            # adds every host's counts at this tick
            _ema_touch(state.ema, state.ema_tick, rows, counts, state.tick,
                       self.decay)
            protect = np.zeros((self.cache_rows,), bool)
            protect[hit_slots] = True
            # EMA admission, as the single-host tier: a re-admitted row
            # re-enters at its GLOBAL post-touch EMA score
            slots = self._admit_host(state, h, missing, state.ema[missing],
                                     protect)
            miss_rows[h, :len(missing)] = missing
            miss_slots[h, :len(missing)] = slots
            ws_rows[h, :len(rows)] = rows
            ws_slots[h, :len(rows)] = state.row_slot[h, rows]
            local_idx[h] = CachedEmbeddingBagCollection._remap(
                state.row_slot[h], sub, valid)
            state.stats.hits += int(counts.sum()) - len(missing)
            state.stats.misses += len(missing)
            owner_m = missing // self.shard_rows
            state.route.fetch_remote += int((owner_m != h).sum())
            state.route.fetch_local += int((owner_m == h).sum())
            if self.fetch_chunk > 1 and len(missing):
                self._book_fetch_chunks(state, missing)
            if train:
                remote = rows // self.shard_rows != h
                state.route.refresh_remote += int(remote.sum())
                state.route.refresh_local += int((~remote).sum())
                state.route.grad_pairs_remote += int(counts[remote].sum())
                state.route.grad_pairs_local += int(counts[~remote].sum())
        state.stats.steps += 1
        state.route.steps += 1
        state.route.dup_rows += max(dup, 0)
        if train:
            touched = g_rows[:n_live].astype(np.int64)
            for h in range(hn):
                slots_t = state.row_slot[h, touched]
                in_ws = np.zeros((self.cache_rows,), bool)
                wss = ws_slots[h]
                in_ws[wss[wss >= 0]] = True
                kill = (slots_t >= 0) & ~in_ws[np.clip(slots_t, 0, None)]
                state.slot_row[h, slots_t[kill]] = -1
                state.row_slot[h, touched[kill]] = -1
                state.freq[h, slots_t[kill]] = 0.0
                state.route.invalidations += int(kill.sum())
            seg_rows, seg_offs, seg_base = split_plan_by_owner(
                global_plan, self.shard_rows, hn, seg_cap=len(g_rows))
        else:
            u = len(g_rows)
            seg_rows = np.full((hn, u), -1, np.int32)
            seg_offs = np.zeros((hn, u + 1), np.int32)
            seg_base = np.zeros((hn,), np.int32)
        return MultiHostStepPlan(
            local_idx, miss_rows, miss_slots, ws_rows, ws_slots,
            seg_rows, seg_offs, seg_base,
            np.asarray(global_plan.bag_ids, np.int32))

    # -- slab installs -------------------------------------------------------

    def live_worklist(self, rows, slots) -> list[np.ndarray]:
        """Each host's live entries of (H, M) -1-padded `rows` / `slots`
        (the ones with a slot), as the flat list [rows_0, slots_0, ...,
        rows_{H-1}, slots_{H-1}] of int32 arrays, for `hostmem.upload`. The
        mask runs on the host: on the device it would sync."""
        rows, slots = _host(rows), _host(slots)
        out = []
        for h in range(self.n_hosts):
            keep = slots[h] >= 0
            out += [rows[h][keep].astype(np.int32),
                    slots[h][keep].astype(np.int32)]
        return out

    def install(self, caches: torch.Tensor, source: torch.Tensor,
                worklist) -> torch.Tensor:
        """Copy each host's rows of `source` (the capacity tier) into its
        slab, IN PLACE: worklist is `live_worklist`'s list as tensors on
        the device. Every install leg (miss install, post-update refresh,
        prefetch) is this one copy. Returns caches."""
        for h in range(self.n_hosts):
            rows, slots = worklist[2 * h], worklist[2 * h + 1]
            if rows.numel():
                caches[h].index_copy_(0, slots.long(),
                                      source.index_select(0, rows))
        return caches

    def install_worklist(self, state: MultiHostCacheState,
                         worklist: list[np.ndarray]) -> None:
        """Install `live_worklist`'s list (each host's rows, ascending, and
        their slots) from the capacity tier. On a single controller every
        host's slab, from the one capacity tensor. Under a host mesh, a
        collective every rank calls with the same list: each owner sends
        every host the rows of its list it owns (`Mesh.all_to_all_rows`,
        copies), and this rank writes what it got into its slab."""
        if state.mesh is None:
            self.install(state.caches, state.capacity,
                         hostmem.upload(worklist, state.caches.device))
            return
        me, sr = state.host, self.shard_rows
        rows = worklist[0::2]
        owners = rows[me] // sr
        if np.any(np.diff(owners) < 0):
            raise ValueError("install_worklist wants each host's rows "
                             "grouped by owner (ascending)")
        asked = [(r[r // sr == me] - me * sr).astype(np.int32) for r in rows]
        *asked, slots = hostmem.upload(asked + [worklist[2 * me + 1]],
                                       state.caches.device)
        got = state.mesh.all_to_all_rows(
            [state.capacity.index_select(0, a) for a in asked],
            np.bincount(owners, minlength=self.n_hosts).tolist(),
            state.host_axis)
        if slots.numel():
            state.caches[0].index_copy_(0, slots.long(), torch.cat(got))

    def fill_slabs(self, caches: torch.Tensor, source: torch.Tensor,
                   rows, slots) -> torch.Tensor:
        """Install `rows` gathered from `source` into each host's slab at
        `slots`, IN PLACE: rows / slots (H, M) host int arrays, entries
        with slot -1 dropped (the reference's mode="drop"). One upload of
        the live entries, then `install`. Returns caches."""
        return self.install(caches, source, hostmem.upload(
            self.live_worklist(rows, slots), caches.device))

    # -- eval / serving ------------------------------------------------------

    def install_misses(self, state: MultiHostCacheState,
                       splan: MultiHostStepPlan) -> None:
        """Resolve the planned misses eagerly: gather each host's missing
        rows from the owning shards into its slab (under a mesh, this
        rank's slab)."""
        self.install_worklist(state, self.live_worklist(splan.miss_rows,
                                                        splan.miss_slots))

    def lookup(self, state: MultiHostCacheState, idx, host_plans=None,
               global_plan=None) -> torch.Tensor:
        """plan + fetch + per-host pooled lookup, concatenated back to the
        global batch: equal to the uncached collection's lookup on the same
        indices. Eval path (no update legs). Under a mesh each rank pools
        its examples and the pools are gathered by copy."""
        splan = self.plan_step(state, idx, host_plans, global_plan,
                               train=False)
        self.install_misses(state, splan)
        local = torch.from_numpy(splan.local_idx).to(state.caches.device)
        if state.mesh is not None:
            return state.mesh.all_gather_rows(
                self.ebc.lookup({"mega": state.caches[0]},
                                local[state.host]), state.host_axis)
        return torch.cat([self.ebc.lookup({"mega": state.caches[h]},
                                          local[h])
                          for h in range(self.n_hosts)])

    # -- prefetch ------------------------------------------------------------

    def prefetch(self, state: MultiHostCacheState, idx, host_plans=None,
                 global_plan=None, gate: bool = False) -> int:
        """Best-effort admission of the NEXT batch's per-host misses, queued
        behind the step on the current stream, so the gathers read the
        post-update capacity. Never evicts a requested resident; overflow
        beyond free + evictable slots is dropped. `gate=True` adds the EMA
        admission threshold per host (`_gate_admission`). Returns rows
        admitted."""
        _fetch_guard(self.injector, self.retry, "cache.fetch")
        idx = _host(idx)
        b, f, _ = idx.shape
        hn, c = self.n_hosts, self.cache_rows
        if global_plan is None:
            global_plan = build_sparse_plan_host(idx)
        if host_plans is None:
            host_plans = split_plan_by_host(global_plan, hn, b // hn * f)
        worklist, total = [], 0
        for h in range(hn):
            prows = np.asarray(host_plans[h].unique_rows)
            rows = prows[:int((prows >= 0).sum())].astype(np.int64)
            resident = state.row_slot[h, rows] >= 0
            missing = rows[~resident]
            protect = np.zeros((c,), bool)
            protect[state.row_slot[h, rows[resident]]] = True
            # seed = EMA score + 1: this request counts as one access
            seeds = _ema_score(state.ema, state.ema_tick, missing,
                               state.tick, self.decay) + np.float32(1.0)
            if gate and len(missing):
                keep = _gate_admission(state.slot_row[h], state.freq[h],
                                       protect, missing, seeds)
                missing, seeds = missing[keep], seeds[keep]
            evictable = int(((state.slot_row[h] >= 0) & ~protect).sum())
            free = int((state.slot_row[h] < 0).sum())
            missing = missing[:free + evictable]
            seeds = seeds[:free + evictable]
            slots = self._admit_host(state, h, missing, seeds, protect)
            worklist += [missing.astype(np.int32), slots.astype(np.int32)]
            owner = missing // self.shard_rows
            state.route.fetch_remote += int((owner != h).sum())
            state.route.fetch_local += int((owner == h).sum())
            total += len(missing)
        if total:
            self.install_worklist(state, worklist)
        state.stats.prefetched += total
        return total

    def mark_updated(self, state: MultiHostCacheState, capacity: torch.Tensor,
                     cap_accum: torch.Tensor, caches: torch.Tensor) -> None:
        """Install the step's outputs (the port updates in place, so these
        are the state's own tensors)."""
        state.capacity = capacity
        state.cap_accum = cap_accum
        state.caches = caches

    def materialize(self, state: MultiHostCacheState
                    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The up-to-date (mega, accum) capacity tensors; under a mesh this
        rank's shard, the global rows `state.rows`. Nothing to flush:
        every update already lives at its owner."""
        return state.capacity, state.cap_accum

    # -- the tier protocol (core.tiers.EmbeddingTier) ------------------------

    def take(self, state: MultiHostCacheState, idx, train: bool = True,
             plan=None) -> np.ndarray:
        """Protocol `take`: plan the batch, install its misses, return the
        (H, B/H, F, L) slot-space remap. The train step uses `plan_step`
        itself (its worklist is richer than a remap). `plan` is the global
        host SparsePlan when the reader built one."""
        splan = self.plan_step(state, idx, global_plan=plan, train=train)
        self.install_misses(state, splan)
        return splan.local_idx

    def stage(self, state: MultiHostCacheState, idx, train: bool = True,
              plan=None) -> None:
        """Protocol `stage`: this tier overlaps through `prefetch` of the
        whole next batch; returns None."""
        return None

    def prefetch_rows(self, state: MultiHostCacheState, rows,
                      gate: bool = False) -> int:
        """Protocol `prefetch_rows`: splitting rows by host needs the
        (B, F, L) batch (`prefetch`), so a bare row list admits nothing;
        returns 0."""
        return 0

    def commit(self, state: MultiHostCacheState) -> int:
        """Protocol `commit`: installs happen in the step; returns 0."""
        return 0

    def flush(self, state: MultiHostCacheState) -> int:
        """Protocol `flush`: caches are clean by construction; returns 0."""
        return 0

    def stats(self, state: MultiHostCacheState) -> CacheStats:
        """The tier's aggregate CacheStats."""
        return state.stats

    def placement(self) -> dict:
        """Static tier layout, fastest level first."""
        return {"strategy": "cached_host", "stream": "multihost",
                "n_hosts": self.n_hosts,
                "levels": [{"tier": "hbm", "rows": self.cache_rows},
                           {"tier": "dram",
                            "rows": self.ebc.plan.total_rows}]}

    # -- checkpointing -------------------------------------------------------

    def state_dict(self, state: MultiHostCacheState) -> dict:
        """The whole tier as a checkpointable tree: the device tensors
        (capacity, cap_accum, caches) are the tier's OWN tensors, not
        copies (save them before the tier steps again); the host maps are
        owned numpy copies. Nothing to drain: caches are clean."""
        d = {k: getattr(state, k) for k in ("capacity", "cap_accum",
                                            "caches")}
        d.update({k: np.array(getattr(state, k)) for k in
                  ("freq", "slot_row", "row_slot", "ema", "ema_tick")})
        d["tick"] = np.int64(state.tick)
        for k in ("stats", "route"):
            d[k] = {f: np.int64(v) for f, v in
                    dataclasses.asdict(getattr(state, k)).items()}
        return d

    def load_state_dict(self, d: dict, device=None) -> MultiHostCacheState:
        """Rebuild the tier from a `state_dict` tree. Tensor leaves are
        taken as they are (`CheckpointManager.restore` fills the example's
        own tensors in place); numpy leaves go to `device`, else the
        `caches` leaf's device, else the capacity leaf's, else cuda. The
        host maps become owned copies."""
        dev = _restore_device(d["capacity"], d["caches"], device)
        return MultiHostCacheState(
            capacity=_leaf_on(d["capacity"], np.float32, dev),
            cap_accum=_leaf_on(d["cap_accum"], np.float32, dev),
            caches=_leaf_on(d["caches"], np.float32, dev),
            freq=np.array(d["freq"], np.float32),
            slot_row=np.array(d["slot_row"], np.int64),
            row_slot=np.array(d["row_slot"], np.int32),
            ema=np.array(d["ema"], np.float32),
            ema_tick=np.array(d["ema_tick"], np.int64),
            tick=int(d["tick"]),
            stats=CacheStats(**{k: int(v) for k, v in d["stats"].items()}),
            route=RouteStats(**{k: int(v) for k, v in d["route"].items()}))
