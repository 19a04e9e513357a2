"""Overload-robust continuous-batching DLRM serving.

The port of `repro.serve.dlrm_engine`: `DLRMServeEngine` wraps the
read-only cached embedding tier in

  * a bounded admission queue with typed `Overloaded` backpressure;
  * per-request deadlines and deadline-aware load shedding on an
    injectable clock;
  * a batch former that pops a FIFO prefix whose running union of unique
    rows fits `cache_rows` (the thrash guard consulted before dispatch),
    padded to fixed (max_batch, ...) slots so that a later CUDA graph can
    capture one forward for every batch;
  * degrade-don't-die: on capacity-fetch faults (or in the breaker's
    stale_only state) misses resolve from a `StaleRowSnapshot` and the
    response is flagged `degraded=True`;
  * a healthy -> shedding -> stale_only -> healthy circuit breaker, driven
    by a duck-typed fault injector on the `serve.fetch` / `serve.admit`
    sites;
  * p50/p99 latency, shed-rate and degraded-fraction counters, plus the
    host seconds spent in each phase of a step (`ServeMetrics.phase_s`).

The serving invariant: every submitted request resolves as exactly one of
{bit-equal to the unloaded engine, flagged degraded, cleanly shed}.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.cache import StaleRowSnapshot, _fetch_guard
from repro_torch.serve.engine import dlrm_probs

#: `Overloaded.reason` values
SHED_REASONS = ("queue_full", "deadline", "admit_fault")
#: phases of `DLRMServeEngine.step` timed on the host clock
PHASES = ("form", "take", "snapshot", "forward")


@dataclasses.dataclass
class ServeRequest:
    """One CTR scoring request: n examples with an optional deadline
    (ABSOLUTE time on the engine's clock; `submitted` is stamped by
    `submit`)."""

    uid: int
    dense: np.ndarray          # (n, n_dense) float32
    idx: np.ndarray            # (n, F, L) OFFSET global rows, -1 pads
    deadline: float | None = None
    submitted: float = 0.0


@dataclasses.dataclass
class ServeResponse:
    """A served request: (n,) click probabilities + the degraded flag."""

    uid: int
    probs: np.ndarray
    degraded: bool
    latency: float


@dataclasses.dataclass
class Overloaded:
    """A cleanly-shed request (typed backpressure, never an exception);
    `reason` is one of `SHED_REASONS`."""

    uid: int
    reason: str
    queue_depth: int
    at: float


@dataclasses.dataclass
class ServeMetrics:
    """Serving counters; `snapshot` adds the derived SLO figures.
    `phase_s` sums the host (wall-clock) seconds of each step phase."""

    submitted: int = 0
    served: int = 0
    degraded: int = 0
    shed_queue_full: int = 0
    shed_deadline: int = 0
    shed_admit_fault: int = 0
    batches: int = 0
    stale_batches: int = 0
    latencies: list = dataclasses.field(default_factory=list)
    phase_s: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(PHASES, 0.0))

    @property
    def shed(self) -> int:
        """Total cleanly-shed requests across all reasons."""
        return (self.shed_queue_full + self.shed_deadline
                + self.shed_admit_fault)

    def snapshot(self) -> dict[str, float]:
        """Flat metrics dict: p50/p99 latency, shed rate, degraded frac."""
        lat = np.asarray(self.latencies, np.float64)
        return {
            "submitted": float(self.submitted),
            "served": float(self.served),
            "shed": float(self.shed),
            "shed_rate": self.shed / self.submitted if self.submitted else 0.0,
            "degraded": float(self.degraded),
            "degraded_fraction": (self.degraded / self.served
                                  if self.served else 0.0),
            "p50_latency": float(np.percentile(lat, 50)) if len(lat) else 0.0,
            "p99_latency": float(np.percentile(lat, 99)) if len(lat) else 0.0,
            "batches": float(self.batches),
            "stale_batches": float(self.stale_batches),
        }


class ServeCircuitBreaker:
    """healthy -> shedding -> stale_only -> healthy state machine.

      * healthy -> shedding when queue pressure (depth / max_queue) crosses
        `shed_enter`; back when it falls below `shed_exit`;
      * any state -> stale_only after `demote_after` CONSECUTIVE
        capacity-fetch failures;
      * stale_only -> healthy after `promote_after` consecutive successful
        probe fetches (one probe every `probe_every` batches).

    Transitions are recorded in `transitions` as (state, event_count)."""

    def __init__(self, shed_enter: float = 0.75, shed_exit: float = 0.25,
                 demote_after: int = 2, promote_after: int = 3,
                 probe_every: int = 4):
        self.shed_enter = shed_enter
        self.shed_exit = shed_exit
        self.demote_after = demote_after
        self.promote_after = promote_after
        self.probe_every = probe_every
        self.state = "healthy"
        self.transitions: list[tuple[str, int]] = []
        self._failures = 0
        self._probe_ok = 0
        self._probe_tick = 0
        self._events = 0

    def _to(self, state: str) -> None:
        self.state = state
        self.transitions.append((state, self._events))

    def record_pressure(self, frac: float) -> None:
        """Queue-depth watermark check (frac = depth / max_queue)."""
        self._events += 1
        if self.state == "healthy" and frac >= self.shed_enter:
            self._to("shedding")
        elif self.state == "shedding" and frac <= self.shed_exit:
            self._to("healthy")

    def record_fetch_failure(self) -> None:
        """One capacity-fetch dispatch that exhausted its retries."""
        self._events += 1
        self._failures += 1
        self._probe_ok = 0
        if self.state != "stale_only" and self._failures >= self.demote_after:
            self._to("stale_only")

    def record_fetch_success(self) -> None:
        """One clean capacity-fetch dispatch (counts as a probe success)."""
        self._events += 1
        self._failures = 0
        if self.state == "stale_only":
            self._probe_ok += 1
            if self._probe_ok >= self.promote_after:
                self._probe_ok = 0
                self._to("healthy")

    def should_probe(self) -> bool:
        """In stale_only: True every `probe_every`-th batch."""
        self._probe_tick += 1
        return self._probe_tick % self.probe_every == 0


class DLRMServeEngine:
    """Continuous-batching CTR server over the read-only cached tier.

    Drive it with `submit` (returns `Overloaded` on backpressure, None on
    admission) + `step` (forms and dispatches one batch), or `run` to
    drain. Resolved requests land in `results` (uid -> ServeResponse |
    Overloaded). The cache state takes ownership of
    `params["emb"]["mega"]` (read-only, never written)."""

    def __init__(self, params, cfg, cc, *, max_queue: int = 64,
                 max_batch: int = 32, shed_slack: float = 0.0,
                 clock: Callable[[], float] = time.monotonic,
                 injector: Any = None, retry: Any = None,
                 breaker: ServeCircuitBreaker | None = None):
        self.cfg = cfg
        self.cc = cc
        self.max_queue = int(max_queue)
        self.max_batch = int(max_batch)
        self.shed_slack = float(shed_slack)
        self.clock = clock
        self.injector = injector
        self.retry = retry
        self.breaker = breaker if breaker is not None else ServeCircuitBreaker()
        self.dense = {"bottom": params["bottom"], "top": params["top"]}
        self.state = cc.init_state(params["emb"]["mega"])
        r, d = params["emb"]["mega"].shape
        self.snapshot = StaleRowSnapshot.empty(r, d)
        self.queue: collections.deque[ServeRequest] = collections.deque()
        self.results: dict[int, ServeResponse | Overloaded] = {}
        self.metrics = ServeMetrics()

    # -- admission -----------------------------------------------------------

    def submit(self, req: ServeRequest) -> Overloaded | None:
        """Admit `req` or shed it with a typed `Overloaded` (also recorded
        in `results`). Raises ValueError for requests that could NEVER be
        served (more examples than `max_batch`, or a working set larger
        than the device cache)."""
        req.dense = np.asarray(req.dense)
        req.idx = np.asarray(req.idx)
        n = int(req.idx.shape[0])
        if n > self.max_batch:
            raise ValueError(
                f"request carries {n} examples > max_batch={self.max_batch};"
                " split it client-side or build the engine with more slots")
        n_rows = len(np.unique(req.idx[req.idx >= 0]))
        if n_rows > self.cc.cache_rows:
            raise ValueError(
                f"request working set of {n_rows} unique rows exceeds "
                f"cache_rows={self.cc.cache_rows}; it can never form a "
                "servable batch — raise the HBM budget or shrink the "
                "request")
        now = self.clock()
        req.submitted = now
        self.metrics.submitted += 1
        try:
            _fetch_guard(self.injector, self.retry, site="serve.admit")
        except Exception as e:
            if not getattr(e, "transient", False):
                raise
            return self._shed(req, "admit_fault", now)
        if len(self.queue) >= self.max_queue:
            return self._shed(req, "queue_full", now)
        self.queue.append(req)
        return None

    def _shed(self, req: ServeRequest, reason: str,
              now: float) -> Overloaded:
        res = Overloaded(req.uid, reason, len(self.queue), now)
        self.results[req.uid] = res
        if reason == "queue_full":
            self.metrics.shed_queue_full += 1
        elif reason == "deadline":
            self.metrics.shed_deadline += 1
        else:
            self.metrics.shed_admit_fault += 1
        return res

    # -- batch forming + dispatch --------------------------------------------

    def _shed_expired(self, now: float) -> None:
        """Drop queued requests that missed (or, in the shedding state,
        would miss within `shed_slack`) their deadline."""
        slack = self.shed_slack if self.breaker.state == "shedding" else 0.0
        keep: collections.deque[ServeRequest] = collections.deque()
        while self.queue:
            r = self.queue.popleft()
            if r.deadline is not None and r.deadline < now + slack:
                self._shed(r, "deadline", now)
            else:
                keep.append(r)
        self.queue = keep

    def _form_batch(self) -> list[ServeRequest]:
        """Pop a FIFO prefix of the queue whose examples fit `max_batch`
        AND whose running union of unique rows fits the device cache; at
        least one request is always taken."""
        mark = np.zeros((self.cc.ebc.plan.total_rows,), bool)
        batch: list[ServeRequest] = []
        total = count = 0
        while self.queue:
            r = self.queue[0]
            n = int(r.idx.shape[0])
            if total + n > self.max_batch:
                break
            rows = np.unique(r.idx[r.idx >= 0])
            new = rows[~mark[rows]]
            if count + len(new) > self.cc.cache_rows:
                break
            mark[new] = True
            count += len(new)
            total += n
            batch.append(self.queue.popleft())
        return batch

    def _pad(self, batch: list[ServeRequest]):
        """Concatenate + zero/-1-pad to the fixed (max_batch, ...) slots."""
        f, el = batch[0].idx.shape[1:]
        nd = batch[0].dense.shape[1]
        dense = np.zeros((self.max_batch, nd), np.float32)
        idx = np.full((self.max_batch, f, el), -1, np.int64)
        off = 0
        for r in batch:
            n = r.idx.shape[0]
            dense[off:off + n] = r.dense
            idx[off:off + n] = r.idx
            off += n
        return dense, idx, off

    def _stale_local(self, idx: np.ndarray):
        """Remap `idx` onto a stale slab: unique rows gather from the
        snapshot into a zero-padded (C, d) table, indices remap by
        searchsorted. Same shapes as the healthy path."""
        valid = idx >= 0
        rows = np.unique(idx[valid])
        slab = np.zeros((self.cc.cache_rows, self.state.cache.shape[1]),
                        np.float32)
        slab[:len(rows)] = self.snapshot.gather(rows)
        local = np.searchsorted(rows, np.where(valid, idx, rows[0] if
                                               len(rows) else 0))
        local = np.where(valid, local, -1).astype(np.int32)
        table = torch.from_numpy(slab).to(self.state.cache.device,
                                          self.state.cache.dtype)
        return table, local

    def step(self) -> list[ServeResponse]:
        """One engine step: shed expired work, form one thrash-safe batch,
        dispatch it (healthy or degraded), resolve its requests."""
        phase = self.metrics.phase_s
        t0 = time.perf_counter()
        now = self.clock()
        self._shed_expired(now)
        self.breaker.record_pressure(
            len(self.queue) / self.max_queue if self.max_queue else 0.0)
        if not self.queue:
            return []
        batch = self._form_batch()
        dense, idx, _ = self._pad(batch)
        t1 = time.perf_counter()
        phase["form"] += t1 - t0
        degraded = False
        table = None
        local = None
        if self.breaker.state == "stale_only" \
                and not self.breaker.should_probe():
            degraded = True
        else:
            try:
                _fetch_guard(self.injector, self.retry, site="serve.fetch")
                local = self.cc.take(self.state, idx, train=False)
            except Exception as e:
                if not getattr(e, "transient", False):
                    raise
                self.breaker.record_fetch_failure()
                degraded = True
            else:
                self.breaker.record_fetch_success()
                table = self.state.cache
                t2 = time.perf_counter()
                phase["take"] += t2 - t1
                t1 = t2
                # remember every first-seen row while the tier is healthy:
                # the tier is read-only, so these can never go stale
                rows = np.unique(idx[idx >= 0])
                fresh = rows[~self.snapshot.seen[rows]]
                if len(fresh):
                    slots = torch.from_numpy(
                        self.state.row_slot[fresh].astype(np.int64)).to(
                            table.device)
                    self.snapshot.record(fresh, table[slots])
                t2 = time.perf_counter()
                phase["snapshot"] += t2 - t1
                t1 = t2
        if degraded:
            table, local = self._stale_local(idx)
        probs = dlrm_probs(self.dense, self.cfg, self.cc, table, dense,
                           local)
        phase["forward"] += time.perf_counter() - t1
        done = self.clock()
        self.metrics.batches += 1
        if degraded:
            self.metrics.stale_batches += 1
        out: list[ServeResponse] = []
        off = 0
        for r in batch:
            n = int(r.idx.shape[0])
            resp = ServeResponse(r.uid, probs[off:off + n], degraded,
                                 done - r.submitted)
            self.results[r.uid] = resp
            self.metrics.served += 1
            self.metrics.degraded += int(degraded)
            self.metrics.latencies.append(resp.latency)
            out.append(resp)
            off += n
        return out

    def run(self, max_steps: int = 10_000):
        """Step until the queue drains (every step resolves >= 1 request,
        so `max_steps` only trips on a logic error). Returns `results`."""
        steps = 0
        while self.queue:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"serve loop did not drain within {max_steps} steps "
                    f"({len(self.queue)} requests still queued)")
        return self.results

    @property
    def cache_stats(self):
        """Live `CacheStats` of the serving cache state."""
        return self.state.stats
