"""Fault injection and crash-consistent recovery for the port's trainer.

  * `FaultInjector`: deterministic, seed-driven fault schedules fired at
    named hook points (`pipeline.batch`, `cache.fetch`, the bulk tier's
    `bulk.fetch`, `checkpoint.write`, `loop.step`, and the serving tier's
    `serve.fetch` and `serve.admit`), threaded through data/pipeline.py,
    core/cache.py, core/tiers.py, train/checkpoint.py and
    serve/dlrm_engine.py. `from_seed` draws the
    reference's schedule for the same seed (the same `RandomState` draws
    in the same order).
  * `RetryPolicy`: bounded retry with backoff for transient fetch faults
    (consumed duck-typed by core/cache.py's `_fetch_guard`, which
    core/tiers.py's bulk promotions call too).
  * `DegradationManager`: the async -> strict_sync state machine.
  * `TrainState` with `save_train_state` / `restore_train_state`: params,
    optimizer state, the cache tier's `state_dict` and the pipeline cursor
    as one atomic checkpoint.
  * `PreemptionHandler`, `StragglerDetector`, `StepTimer`.
  * `run_resilient_loop` and `run_chaos_loop`, the loops; the
    chaos invariant (any fault schedule ends bit-equal to the fault-free
    run) is held by tests/test_torch_chaos.py on the sync, async and
    three-tier bulk collections.
  * `elastic_tablewise_repack`: host-loss recovery of a table_wise
    placement (re-plan for the surviving owners, move every row).

`_recoverable` differs from the reference's on purpose: a kernel that
failed to build or launch (`kernels._build.KernelError`), a device out of
memory and a CUDA fault are RuntimeErrors too, and replaying them from a
checkpoint would only fail again, so the chaos loop raises them at once.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import signal
import threading
import time
from collections.abc import Callable
from typing import Any

import numpy as np
import torch

from repro_torch.kernels._build import KernelError

#: hook points a FaultSpec can target (call sites fire these by name);
#: `bulk.fetch` fires before a bulk tier's promotion (core/tiers.py)
SITES = ("pipeline.batch", "cache.fetch", "bulk.fetch", "checkpoint.write",
         "loop.step", "serve.fetch", "serve.admit")

#: raising kinds ("error"/"kill") throw at the hook point; cooperative kinds
#: ("latency"/"torn"/"preempt"/"host_loss") return the spec for the call
#: site to interpret
KINDS = ("error", "kill", "latency", "torn", "preempt", "host_loss")

#: sites whose "error" is a transient fetch fault (retried by the guard)
_FETCH_SITES = ("cache.fetch", "bulk.fetch", "serve.fetch", "serve.admit")


class InjectedFault(RuntimeError):
    """Base class for faults raised by `FaultInjector.fire`."""

    transient = False


class TransientFetchFault(InjectedFault):
    """Retryable capacity-fetch failure: `transient = True` is what the
    cache's retry guard keys on."""

    transient = True


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: fire `kind` at the `at`-th call (0-based, over
    the injector's lifetime) of `site`. `arg` is kind-specific: latency
    seconds, torn leaf index, lost host."""

    site: str
    at: int
    kind: str = "error"
    arg: float | int | None = None
    fired: bool = False


class FaultInjector:
    """Deterministic fault-schedule registry. `fire(site)` advances the
    site's call counter and, when a scheduled spec matches: raises for the
    raising kinds (`error` -> TransientFetchFault on the fetch and admit
    sites, InjectedFault elsewhere; `kill` -> SystemExit, a reader-thread
    death), sleeps for `latency`, and returns the spec for the cooperative
    kinds. Thread-safe: the reader thread and the loop share one."""

    def __init__(self, schedule: list[FaultSpec] | tuple[FaultSpec, ...] = ()):
        self.schedule = list(schedule)
        for s in self.schedule:
            if s.site not in SITES:
                raise ValueError(f"unknown fault site {s.site!r}")
            if s.kind not in KINDS:
                raise ValueError(f"unknown fault kind {s.kind!r}")
        self.calls: collections.Counter = collections.Counter()
        self.fired: list[tuple[str, int, str]] = []
        self._lock = threading.Lock()

    @classmethod
    def from_seed(cls, seed: int, n_steps: int,
                  sites: tuple[str, ...] = ("pipeline.batch", "cache.fetch",
                                            "loop.step"),
                  n_faults: int = 3) -> FaultInjector:
        """`n_faults` faults over `n_steps` calls, each at a random site
        with a site-appropriate random kind; the same seed gives the same
        schedule, and the reference's for that seed."""
        kinds = {"pipeline.batch": ("kill", "error"),
                 "cache.fetch": ("error", "latency"),
                 "bulk.fetch": ("error", "latency"),
                 "checkpoint.write": ("torn",),
                 "loop.step": ("preempt",),
                 "serve.fetch": ("error", "latency"),
                 "serve.admit": ("error",)}
        rng = np.random.RandomState(seed)
        seen: set[tuple[str, int]] = set()
        sched: list[FaultSpec] = []
        while len(sched) < n_faults:
            site = sites[int(rng.randint(len(sites)))]
            opts = kinds[site]
            kind = opts[int(rng.randint(len(opts)))]
            at = int(rng.randint(1, max(n_steps, 2)))
            if (site, at) in seen:
                continue
            seen.add((site, at))
            arg = 0.002 if kind == "latency" else None
            sched.append(FaultSpec(site, at, kind, arg))
        sched.sort(key=lambda s: (s.site, s.at))
        return cls(sched)

    def fire(self, site: str, **ctx) -> FaultSpec | None:
        """Advance `site`'s call counter; raise or return the matching
        scheduled fault (None when nothing is due). `ctx` is for the
        caller's record (e.g. step=...)."""
        with self._lock:
            at = self.calls[site]
            self.calls[site] += 1
            spec = next((s for s in self.schedule
                         if not s.fired and s.site == site and s.at == at),
                        None)
            if spec is None:
                return None
            spec.fired = True
            self.fired.append((site, at, spec.kind))
        if spec.kind == "latency":
            time.sleep(float(spec.arg or 0.002))
            return spec
        if spec.kind == "error":
            if site in _FETCH_SITES:
                raise TransientFetchFault(
                    f"injected transient fetch fault at {site}[{at}]")
            raise InjectedFault(f"injected fault at {site}[{at}]")
        if spec.kind == "kill":
            raise SystemExit(f"injected kill at {site}[{at}]")
        return spec            # cooperative: torn / preempt / host_loss


# -- retry + degradation ----------------------------------------------------


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff for transient fetch faults
    (`max_retries` and `sleep` are what the cache's guard reads)."""

    max_retries: int = 3
    backoff_s: float = 1e-3
    multiplier: float = 2.0
    max_backoff_s: float = 0.05

    def sleep(self, attempt: int) -> None:
        """Back off before retry number `attempt` (1-based)."""
        time.sleep(min(self.backoff_s * self.multiplier ** (attempt - 1),
                       self.max_backoff_s))


class DegradationManager:
    """The async -> strict_sync degradation state machine: after
    `demote_after` consecutive async-path failures `mode` becomes
    "strict_sync" (the step stops staging next batches), and after
    `promote_after` consecutive clean steps it returns to "async". Both
    schedules give the same bits, so only the overlap changes."""

    def __init__(self, demote_after: int = 2, promote_after: int = 4):
        self.demote_after = demote_after
        self.promote_after = promote_after
        self.mode = "async"
        self.demotions = 0
        self.promotions = 0
        self.transitions: list[tuple[str, int]] = []   # (mode, event count)
        self._failures = 0
        self._clean = 0
        self._events = 0

    @property
    def degraded(self) -> bool:
        """True while the strict_sync fallback schedule is active."""
        return self.mode == "strict_sync"

    def record_failure(self) -> None:
        """One async-path failure (retries exhausted)."""
        self._events += 1
        self._failures += 1
        self._clean = 0
        if self.mode == "async" and self._failures >= self.demote_after:
            self.mode = "strict_sync"
            self.demotions += 1
            self.transitions.append(("strict_sync", self._events))

    def record_success(self) -> None:
        """One clean step in the current mode."""
        self._events += 1
        self._failures = 0
        if self.mode == "strict_sync":
            self._clean += 1
            if self._clean >= self.promote_after:
                self.mode = "async"
                self.promotions += 1
                self._clean = 0
                self.transitions.append(("async", self._events))


# -- atomic TrainState bundle ----------------------------------------------


@dataclasses.dataclass
class TrainState:
    """Everything a resumed run needs, checkpointed as one unit: dense
    params, optimizer state, the cache tier's `state_dict` (accumulators
    live per slot while a row is cached, so params alone cannot resume a
    cached run bit for bit), the pipeline cursor (the next step to run:
    synthetic batches are deterministic per step) and an optional host
    RNG state."""

    params: Any
    opt_state: Any
    cache: Any = None
    step: int = 0
    rng: Any = None

    def tree(self) -> dict:
        """The checkpointable tree (tensor and numpy leaves)."""
        t = {"params": self.params, "opt": self.opt_state,
             "cursor": np.int64(self.step)}
        if self.cache is not None:
            t["cache"] = self.cache
        if self.rng is not None:
            t["rng"] = np.asarray(self.rng)
        return t


def save_train_state(mgr, state: TrainState, async_: bool = False) -> None:
    """Checkpoint the bundle at its cursor step."""
    mgr.save(state.step, state.tree(), async_=async_)


def restore_train_state(mgr, example: TrainState, step: int | None = None
                        ) -> TrainState:
    """Restore the bundle into `example`'s tensors (a fresh job's params,
    optimizer state and cache `state_dict`); with step=None the newest
    intact checkpoint (mgr.last_restored_step says which)."""
    tree = mgr.restore(example.tree(), step=step)
    return TrainState(params=tree["params"], opt_state=tree["opt"],
                      cache=tree.get("cache"), step=int(tree["cursor"]),
                      rng=None if "rng" not in tree
                      else np.asarray(tree["rng"]))


# -- elastic table-wise restore --------------------------------------------

#: rows a chunk of `elastic_tablewise_repack`'s re-scatter moves: its index
#: tensors and gathered rows take chunk * (16 + d * itemsize) bytes
REPACK_CHUNK_ROWS = 1 << 22


def elastic_tablewise_repack(cfg, old_ebc, mega: torch.Tensor,
                             accum: torch.Tensor, n_shards_new: int,
                             chunk_rows: int = REPACK_CHUNK_ROWS):
    """Host-loss recovery for a table_wise placement: re-run the
    `plan_placement` bin-pack for the `n_shards_new` surviving owners and
    re-scatter the restored mega / accum rows under the new placement
    (`core.placement.elastic_table_remap`'s worklist), into new tensors on
    the table's device. The worklist moves through index tensors on that
    device, `chunk_rows` rows at a time, so the only table-sized
    allocation is the new table itself.

    Per-bag pooling and per-row AdaGrad do not depend on where a row
    lives, so a repacked run's losses are bit-equal to the uninterrupted
    one. Returns (new_ebc, new_mega, new_accum); batches must be offset
    with the NEW collection's `offset_indices`."""
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.core.placement import elastic_table_remap

    new_ebc = EmbeddingBagCollection.build(cfg, n_shards=n_shards_new,
                                           strategy="table_wise")
    src, dst = elastic_table_remap(old_ebc.plan, new_ebc.plan,
                                   cfg.hash_sizes)
    dev = mega.device
    new_mega = torch.zeros((new_ebc.plan.total_rows, mega.shape[1]),
                           dtype=mega.dtype, device=dev)
    new_accum = torch.zeros((new_ebc.plan.total_rows,), dtype=accum.dtype,
                            device=dev)
    for lo in range(0, len(src), chunk_rows):
        s = torch.as_tensor(src[lo:lo + chunk_rows]).to(dev)
        d = torch.as_tensor(dst[lo:lo + chunk_rows]).to(dev)
        new_mega.index_copy_(0, d, mega.index_select(0, s))
        new_accum.index_copy_(0, d, accum.index_select(0, s))
    return new_ebc, new_mega, new_accum


# -- preemption / stragglers ------------------------------------------------


class PreemptionHandler:
    """SIGTERM (by default) -> checkpoint-now flag, polled by the loop each
    step. `restore()` puts back the handlers it displaced."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = False
        self._prev = {}
        for s in signals:
            with contextlib.suppress(ValueError):    # non-main thread
                self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        """True once a preemption signal (or `trigger`) has fired."""
        return self._stop

    def trigger(self):
        """Raise the stop flag in-process."""
        self._stop = True

    def clear(self):
        """Re-arm after a handled preemption (simulated restarts)."""
        self._stop = False

    def restore(self):
        """Reinstall the signal handlers this handler displaced."""
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev = {}


class StragglerDetector:
    """Mean + z-score over a window of step wall times: a step more than
    `z_threshold` deviations above the window's mean is flagged."""

    def __init__(self, window: int = 50, z_threshold: float = 3.0,
                 warmup: int = 5):
        self.window = window
        self.z_threshold = z_threshold
        self.warmup = warmup
        self.times: collections.deque[float] = collections.deque(maxlen=window)
        self.flagged_steps: list[int] = []
        self._step = 0

    def record(self, seconds: float) -> bool:
        """Returns True when this step is a straggler."""
        is_straggler = False
        if len(self.times) >= self.warmup:
            mean = float(np.mean(self.times))
            std = float(np.std(self.times)) + 1e-9
            if (seconds - mean) / std > self.z_threshold:
                is_straggler = True
                self.flagged_steps.append(self._step)
        self.times.append(seconds)
        self._step += 1
        return is_straggler


class StepTimer:
    """Monotonic lap timer for per-step wall times."""

    def __init__(self):
        self.t0 = time.monotonic()

    def lap(self) -> float:
        """Seconds since construction or the previous lap."""
        now = time.monotonic()
        dt = now - self.t0
        self.t0 = now
        return dt


# -- the loops ---------------------------------------------------------------


def run_resilient_loop(step_fn: Callable, n_steps: int,
                       checkpoint_cb: Callable[[int], None],
                       checkpoint_every: int,
                       preemption: PreemptionHandler | None = None,
                       straggler: StragglerDetector | None = None,
                       on_straggler: Callable[[int], None] | None = None,
                       start_step: int = 0,
                       injector: FaultInjector | None = None) -> int:
    """Run step_fn(step) from `start_step` to `n_steps`, checkpointing
    every `checkpoint_every` steps; returns the last completed step. A
    preemption saves once (a scheduled save covers it) and stops.
    `injector` fires "loop.step" before each step, and a "preempt" spec
    stops the loop as a SIGTERM would."""
    timer = StepTimer()
    step = start_step
    while step < n_steps:
        if injector is not None and preemption is not None:
            spec = injector.fire("loop.step", step=step)
            if spec is not None and spec.kind == "preempt":
                preemption.trigger()
        step_fn(step)
        dt = timer.lap()
        if straggler is not None and straggler.record(dt) and on_straggler:
            on_straggler(step)
        step += 1
        saved = False
        if step % checkpoint_every == 0:
            checkpoint_cb(step)
            saved = True
        if preemption is not None and preemption.should_stop:
            if not saved:
                checkpoint_cb(step)
            break
    return step


#: failures a replay from a checkpoint cannot cure: a kernel that did not
#: build or launch, a device out of memory, a CUDA fault (all RuntimeErrors)
_UNRECOVERABLE = (KernelError, torch.OutOfMemoryError, torch.AcceleratorError)


def _recoverable(e: BaseException) -> bool:
    """Faults the chaos loop restores from: anything flagged transient,
    injected faults, and runtime failures such as a dead reader, but not
    `_UNRECOVERABLE`. Programming errors (ValueError etc.) propagate."""
    if isinstance(e, _UNRECOVERABLE):
        return False
    return getattr(e, "transient", False) or isinstance(e, RuntimeError)


@dataclasses.dataclass
class ChaosReport:
    """What a `run_chaos_loop` soak did."""

    last_step: int = 0
    restarts: int = 0
    degraded_steps: int = 0
    recovery_s: list = dataclasses.field(default_factory=list)


def run_chaos_loop(step_fn: Callable[[int], None], n_steps: int, *,
                   save_cb: Callable[[int], None],
                   restore_cb: Callable[[], int],
                   checkpoint_every: int = 10,
                   preemption: PreemptionHandler | None = None,
                   injector: FaultInjector | None = None,
                   degradation: DegradationManager | None = None,
                   max_restarts: int = 8) -> ChaosReport:
    """Run to `n_steps` through any recoverable fault.

    `step_fn(step)` runs one step and may raise; `save_cb(step)` saves the
    TrainState bundle after `step` steps; `restore_cb()` rebuilds the
    whole job (params, optimizer, cache tier, pipeline) from the newest
    intact checkpoint and returns the step to resume from (0 when nothing
    is saved). A recoverable failure restores and replays, and the
    replayed steps recompute the same bits. A preemption saves once, then
    restarts in-process: clear the flag, restore, go on. `degradation`
    hears of failures and successes, for step_fn to consult its `.mode`."""
    rep = ChaosReport()
    step = restore_cb()
    while step < n_steps:
        if injector is not None:
            spec = injector.fire("loop.step", step=step)
            if (spec is not None and spec.kind == "preempt"
                    and preemption is not None):
                preemption.trigger()
        try:
            step_fn(step)
        except Exception as e:
            if not _recoverable(e) or rep.restarts >= max_restarts:
                raise
            if degradation is not None and getattr(e, "transient", False):
                degradation.record_failure()
            rep.restarts += 1
            t0 = time.monotonic()
            step = restore_cb()
            rep.recovery_s.append(time.monotonic() - t0)
            continue
        if degradation is not None:
            degradation.record_success()
            if degradation.degraded:
                rep.degraded_steps += 1
        step += 1
        saved = False
        if checkpoint_every and step % checkpoint_every == 0:
            save_cb(step)
            saved = True
        if preemption is not None and preemption.should_stop:
            if not saved:
                save_cb(step)
            preemption.clear()
            rep.restarts += 1
            t0 = time.monotonic()
            step = restore_cb()
            rep.recovery_s.append(time.monotonic() - t0)
    rep.last_step = step
    return rep
