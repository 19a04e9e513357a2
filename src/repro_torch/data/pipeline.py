"""Host-side data pipeline: the paper's reader tier (section IV-B.2).

Readers are decoupled from the trainer so data loading does not stall
training: `DataPipeline` runs the generator (and a transform, such as the
sparse-plan hook) in a background thread feeding a bounded queue, and
`ShardedLoader` slices each global batch into this host's shard with
deterministic per-step seeds. Batches stay numpy arrays; the trainer moves
them to its device.

`DataPipeline.peek` and `lookahead_rows` give the cached tier's async
fetch stream its lookahead: the upcoming batches, seen without being
consumed. A fault injector (`train.fault_tolerance.FaultInjector`) fires
the "pipeline.batch" site once per batch in the reader thread. Ported from
`repro.data.pipeline`: the hooks take the reference's `row_remap` (a
`core.placement.frequency_reorder` permutation) and `sparse_plan_hook` its
`n_hosts` (per-host sub-plans for the multi-host cached tier).
"""
from __future__ import annotations

import collections
import contextlib
import queue
import threading
from collections.abc import Callable, Iterator, Sequence

import numpy as np

from repro_torch.kernels.sparse_plan import (build_sparse_plan_host,
                                             split_plan_by_host)


class _WorkerError:
    """Marker riding the batch queue: the generator or transform raised."""

    def __init__(self, error: BaseException):
        self.error = error


class DataPipeline:
    """Prefetching wrapper: gen(step) -> batch, produced ahead of use;
    iterating yields (step, batch).

    `transform` runs on each batch inside the worker thread, so host-side
    preprocessing overlaps device compute.

    Failure contract: any exception in the reader thread — BaseExceptions
    such as a simulated kill included — surfaces in the consumer as a
    RuntimeError naming the step, within one step; a worker that dies
    without parking an error is caught by a liveness check instead of
    deadlocking the consumer; the failure is sticky until `close()`.

    `peek(i)` returns the i-th upcoming batch without consuming it; peeked
    batches wait in a consumer-side buffer and `__next__` still returns
    them, in order.

    `injector` fires "pipeline.batch" in the reader once per produced
    batch: an "error" or "kill" spec is the reader-thread death, which
    reaches the consumer through the failure contract above.
    """

    _POLL_S = 0.05             # liveness-check poll while waiting on the queue

    def __init__(self, gen: Callable[[int], dict[str, np.ndarray]],
                 prefetch: int = 2, start_step: int = 0,
                 transform: Callable[[dict[str, np.ndarray]],
                                     dict[str, np.ndarray]] | None = None,
                 injector=None):
        self._gen = gen
        self._transform = transform
        self._injector = injector
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._buf: collections.deque = collections.deque()   # peeked
        self._failed: BaseException | None = None   # sticky failure
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _worker(self):
        step = self._step
        try:
            while not self._stop.is_set():
                batch = self._gen(step)
                if self._transform is not None:
                    batch = self._transform(batch)
                if self._injector is not None:
                    self._injector.fire("pipeline.batch", step=step)
                self._put((step, batch))
                step += 1
        except BaseException as e:  # noqa: BLE001 — surface in the consumer
            # a dead reader must fail the trainer loudly, not starve it
            self._put((step, _WorkerError(e)))

    def _pull(self):
        """Blocking get with worker-liveness checks: never deadlocks on a
        dead reader. Returns the (step, batch-or-error) tuple."""
        while True:
            try:
                return self._q.get(timeout=self._POLL_S)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration from None
                if not self._thread.is_alive():
                    # one last look: the worker may have parked its error
                    # between our get() and is_alive()
                    try:
                        return self._q.get_nowait()
                    except queue.Empty:
                        # sticky: a peek that swallows this raise must not
                        # turn the next __next__ into a clean end
                        self._failed = RuntimeError(
                            "data pipeline worker died without reporting an "
                            "error (reader thread no longer alive)")
                        self._stop.set()
                        raise self._failed from None

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._buf:
            # batches peeked before a failure was seen are still delivered,
            # in order, before the failure raises
            step, batch = self._buf.popleft()
        else:
            if self._stop.is_set():
                if self._failed is not None:
                    raise self._failed      # the stream failed, not ended
                raise StopIteration
            step, batch = self._pull()
        if isinstance(batch, _WorkerError):
            self._failed = RuntimeError(
                f"data pipeline worker failed at step {step}")
            self._stop.set()
            raise self._failed from batch.error
        return step, batch

    def peek(self, i: int = 0) -> dict[str, np.ndarray] | None:
        """The i-th upcoming batch (0 = what the next `__next__` returns)
        without consuming it. None once the stream has failed or closed at
        or before that position: the error itself is raised by the next
        `__next__`, so a prefetching trainer runs its last steps without
        lookahead instead of failing early."""
        if self._stop.is_set():
            return None
        while len(self._buf) <= i:
            if self._buf and isinstance(self._buf[-1][1], _WorkerError):
                return None                 # the stream is known to be dead
            try:
                self._buf.append(self._pull())
            except (StopIteration, RuntimeError):
                return None
        batch = self._buf[i][1]
        return None if isinstance(batch, _WorkerError) else batch

    def close(self):
        self._stop.set()
        self._failed = None                 # explicit shutdown is not failure
        self._buf.clear()
        # drain so a worker blocked in put() unblocks promptly
        with contextlib.suppress(queue.Empty):
            while True:
                self._q.get_nowait()
        self._thread.join(timeout=2)


class ShardedLoader:
    """Deterministic per-host slicing of global batches: gen(step, seed)
    makes the global batch, host `host_index` of `num_hosts` keeps its
    contiguous slice."""

    def __init__(self, gen: Callable[[int, int], dict[str, np.ndarray]],
                 global_batch: int, host_index: int = 0, num_hosts: int = 1,
                 seed: int = 0):
        if global_batch % num_hosts:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {num_hosts} hosts")
        self.global_batch = global_batch
        self.host_batch = global_batch // num_hosts
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.seed = seed
        self._gen = gen

    def host_slice(self, step: int) -> dict[str, np.ndarray]:
        """This host's rows of the step's global batch."""
        full = self._gen(step, self.seed)
        lo = self.host_index * self.host_batch
        return {k: v[lo:lo + self.host_batch] for k, v in full.items()}

    def pipeline(self, prefetch: int = 2, start_step: int = 0,
                 transform: Callable | None = None,
                 injector=None) -> DataPipeline:
        return DataPipeline(self.host_slice, prefetch, start_step, transform,
                            injector=injector)


def _offset_rows(idx: np.ndarray, offsets: np.ndarray,
                 remap: np.ndarray | None) -> np.ndarray:
    """(B, F, L) per-table indices -> offset global mega-table rows, int32,
    -1 pads kept; `remap` (total_rows,) permutes the offset rows."""
    valid = idx >= 0
    glob = np.where(valid, idx + offsets[None, :, None], -1)
    if remap is not None:
        glob = np.where(valid, remap[glob], -1)
    return glob.astype(np.int32)


def dedup_indices_hook(table_offsets: Sequence[int],
                       row_remap: np.ndarray | None = None
                       ) -> Callable[[dict[str, np.ndarray]],
                                     dict[str, np.ndarray]]:
    """Reader-thread transform: rewrites batch["idx"] from (B, F, L)
    per-table indices to offset global mega-table rows (int32, -1 pads) and
    attaches the sorted unique row set as batch["uniq_rows"] (int64), the
    cached tier's prefetch set. `row_remap` (total_rows,), e.g.
    `core.placement.frequency_reorder`'s, is applied to the offset rows
    here, so no consumer sees un-remapped ids."""
    offsets = np.asarray(table_offsets, np.int64)
    remap = None if row_remap is None else np.asarray(row_remap, np.int64)

    def hook(batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        glob = _offset_rows(batch["idx"], offsets, remap)
        return {**batch, "idx": glob,
                "uniq_rows": np.unique(glob[glob >= 0]).astype(np.int64)}

    return hook


def sparse_plan_hook(table_offsets: Sequence[int],
                     capacity: int | None = None,
                     n_hosts: int | None = None,
                     row_remap: np.ndarray | None = None
                     ) -> Callable[[dict[str, np.ndarray]],
                                   dict[str, np.ndarray]]:
    """Reader-thread transform: the offset rewrite of `dedup_indices_hook`
    plus the batch's `SparsePlan` (`kernels.sparse_plan.
    build_sparse_plan_host`), attached as
    batch["plan_rows"/"plan_offsets"/"plan_bags"]. The sort runs in the
    reader thread, so batch k's plan is built while batch k-1 computes; the
    train step then uses it for the deduplicated lookup and the fused
    sparse backward, and the cached tier for its miss planning.
    batch["uniq_rows"] (int64), the cached tier's prefetch set, is the
    plan's live prefix: the same sorted unique rows as
    `dedup_indices_hook`'s, without a second sort. `capacity` trims the
    plan's unique arrays; a batch with more unique rows fails in the
    reader thread.

    `n_hosts` > 1 also splits the plan by host bag range
    (`split_plan_by_host`, the multi-host cached tier's data-parallel
    split) and stacks the sub-plans (H, ...) under
    batch["hplan_rows"/"hplan_offsets"/"hplan_bags"]. `row_remap` is
    applied before the plan is built (see `dedup_indices_hook`)."""
    offsets = np.asarray(table_offsets, np.int64)
    remap = None if row_remap is None else np.asarray(row_remap, np.int64)

    def hook(batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        glob = _offset_rows(batch["idx"], offsets, remap)
        plan = build_sparse_plan_host(glob, capacity=capacity)
        rows = plan.unique_rows
        out = {**batch, "idx": glob, **plan.to_batch(),
               "uniq_rows": rows[rows >= 0].astype(np.int64)}
        if n_hosts is not None and n_hosts > 1:
            b, f, _ = glob.shape
            subs = split_plan_by_host(plan, n_hosts, b // n_hosts * f)
            out.update({key: np.stack([np.asarray(p[i]) for p in subs])
                        for i, key in enumerate(("hplan_rows",
                                                 "hplan_offsets",
                                                 "hplan_bags"))})
        return out

    return hook


def lookahead_rows(pipe: DataPipeline, k: int) -> np.ndarray:
    """The union of the next `k` upcoming batches' unique row sets (the
    hooks attach them as batch["uniq_rows"]), peeked without consuming: the
    k-step lookahead that the async cached step's `prefetch_rows` queues
    behind the current batch. Stops early, returning the union so far,
    when the stream ends or fails before position k."""
    rows = []
    for i in range(k):
        batch = pipe.peek(i)
        if batch is None or "uniq_rows" not in batch:
            break
        rows.append(np.asarray(batch["uniq_rows"]).ravel())
    if not rows:
        return np.empty((0,), np.int64)
    cat = np.concatenate(rows)
    return np.unique(cat[cat >= 0]).astype(np.int64)
