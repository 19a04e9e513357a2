"""Row movers of the cached embedding tier (CUDA C++ under `csrc/`) and
its LFU counter update.

  cache_exchange       `csrc/cache_exchange.cu`  fused writeback + fetch,
                       in place (TPU kernel `cache_exchange_kernel`)
  cache_fetch          `csrc/cache_fetch.cu`     capacity rows -> a fresh
                       shadow slab (`cache_fetch_kernel`)
  cache_fetch_chunked  `csrc/cache_fetch.cu`     contiguous row blocks ->
                       a fresh slab (`cache_fetch_chunked_kernel`)
  cache_commit         `csrc/cache_commit.cu`    writeback, then shadow row
                       -> slot, in place (`cache_commit_kernel`)

The TPU kernels live in `repro/kernels/cache_ops.py`. JAX donated the tier
buffers so XLA could alias them; the port mutates the torch tensors in
place. Every kernel runs on PyTorch's current stream. `lfu_touch` is a
plain torch op here as in the reference, which has no kernel for it.

Dispatch goes by the worklist's device: all-CPU calls take the plain
version; a CUDA worklist launches the kernel on its device, with the
cache and the shadow slab there too, and the capacity tier (`capacity`,
`cap_accum`) either there or in page-locked host memory
(`core.hostmem`), which the kernel reads and writes over PCIe through the
same pointers (UVA). Anything else raises: no copy, no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.hostmem import is_page_locked
from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, stream_handle

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
# the exchange and the row fetch take the capacity tier's placement (1:
# page-locked host memory) before the stream: it picks their schedule
KERNEL = Kernel("cache_exchange", "cache_exchange_launch",
                [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _P])
FETCH_KERNEL = Kernel("cache_fetch", "cache_fetch_launch",
                      [_P, _P, _P, _P, _P, _I64, _I64, _I32, _P])
FETCH_CHUNKED_KERNEL = Kernel("cache_fetch_chunked",
                              "cache_fetch_chunked_launch",
                              [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P],
                              source="cache_fetch")
COMMIT_KERNEL = Kernel("cache_commit", "cache_commit_launch",
                       [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                        _P])


def _check_distinct_slots(op: str, slots: torch.Tensor) -> torch.Tensor:
    """Raise if a live (>= 0) slot repeats; returns the live mask."""
    live = slots >= 0
    s = slots[live]
    if torch.unique(s).numel() != s.numel():
        raise ValueError(f"{op} worklist repeats a cache slot")
    return live


def check_worklist(slots: torch.Tensor, evict_rows: torch.Tensor,
                   fetch_rows: torch.Tensor) -> None:
    """Raise unless the worklist meets the exchange's no-race contract:
    live slots distinct, and no row both written back and fetched. Costs a
    host sync; tests and chip_smoke.py call it, the serving path does not."""
    live = _check_distinct_slots("cache_exchange", slots)
    ev = evict_rows[live & (evict_rows >= 0)]
    ft = fetch_rows[live & (fetch_rows >= 0)]
    if torch.isin(ev, ft).any():
        raise ValueError("cache_exchange worklist writes back and fetches "
                         "the same capacity row")


def check_commit_worklist(slots: torch.Tensor, fetch_rows: torch.Tensor,
                          src_pos: torch.Tensor | None,
                          shadow_rows: int) -> None:
    """Raise unless a commit worklist meets the commit's contract: live
    slots distinct, and every installing entry's shadow row (src_pos[i],
    default i) inside the (shadow_rows, D) slab. Costs a host sync; tests
    and chip_smoke.py call it."""
    live = _check_distinct_slots("cache_commit", slots)
    pos = (torch.arange(slots.numel(), device=slots.device)
           if src_pos is None else src_pos.long())
    pos = pos[live & (fetch_rows >= 0)]
    if pos.numel() and not (0 <= int(pos.min())
                            and int(pos.max()) < shadow_rows):
        raise ValueError(f"cache_commit reads shadow rows outside "
                         f"[0, {shadow_rows})")


def check_chunk_starts(chunk_starts: torch.Tensor, chunk: int,
                       total_rows: int) -> None:
    """Raise unless every live block [start, start + chunk) lies inside
    the capacity tier's [0, total_rows). Costs a host sync."""
    live = chunk_starts[chunk_starts >= 0]
    if live.numel() and int(live.max()) + chunk > total_rows:
        raise ValueError(f"cache_fetch_chunked block runs past row "
                         f"{total_rows}")


_HOST_OK = ("capacity", "cap_accum")


def _check_cuda(op: str, shapes: dict) -> torch.device:
    """The wrappers' common guard: every tensor on one CUDA device (the
    capacity tier's two tensors may be page-locked host memory instead),
    of the expected shape and dtype (int32 worklists, fp32 payload),
    contiguous. `shapes` maps name -> (tensor, shape, dtype). Returns the
    device."""
    dev = next(t.device for name, (t, _, _) in shapes.items()
               if name not in _HOST_OK)
    if dev.type != "cuda" or any(
            t.device != dev and not (name in _HOST_OK and is_page_locked(t))
            for name, (t, _, _) in shapes.items()):
        raise ValueError(f"{op} needs every tensor on one CUDA device "
                         "(capacity and cap_accum may be page-locked host "
                         "memory instead)")
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
    return dev


def cache_fetch(capacity: torch.Tensor, cap_accum: torch.Tensor,
                fetch_rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """FETCH half of the split exchange: gather capacity rows `fetch_rows`
    (N,) int32 (-1 = pad) and their accumulators into a fresh shadow slab,
    reading the tiers only. Returns (shadow (N, D), shadow_accum (N,)); a
    pad gives a zero row (`ref.cache_fetch_ref`).

    CPU tensors take the plain version; a CUDA worklist launches the
    kernel (the slab on its device; the capacity tier there or page-locked
    on the host), or raises. The device's part is ~12 µs on an H100 at a
    training batch's misses, so this path keeps its host work to direct
    checks, two allocations and the launch, as `cache_fetch_chunked`
    does."""
    if capacity.is_cpu and cap_accum.is_cpu and fetch_rows.is_cpu:
        return ref.cache_fetch_ref(capacity, cap_accum, fetch_rows)
    r, d = capacity.shape
    n = fetch_rows.shape[0]
    check_fetch(capacity, cap_accum, fetch_rows)
    shadow = fetch_rows.new_empty((n, d), dtype=torch.float32)
    shadow_accum = fetch_rows.new_empty((n,), dtype=torch.float32)
    FETCH_KERNEL.launch(capacity.data_ptr(), cap_accum.data_ptr(),
                        fetch_rows.data_ptr(), shadow.data_ptr(),
                        shadow_accum.data_ptr(), n, d, int(capacity.is_cpu),
                        stream_handle(fetch_rows.get_device()))
    return shadow, shadow_accum


def check_fetch(capacity: torch.Tensor, cap_accum: torch.Tensor,
                fetch_rows: torch.Tensor) -> None:
    """`cache_fetch`'s guard (`_check_gather`)."""
    _check_gather("cache_fetch", capacity, cap_accum, fetch_rows,
                  "fetch_rows")


def cache_fetch_chunked(capacity: torch.Tensor, cap_accum: torch.Tensor,
                        chunk_starts: torch.Tensor, chunk: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-granular fetch: gather K contiguous `chunk`-row capacity
    blocks (+ accumulators) into one fresh (K*chunk, D) slab. chunk_starts:
    (K,) int32 block starts from `kernels.sparse_plan.coalesce_rows`,
    clamped so start + chunk <= R (-1 = pad, a zero block). Returns
    (shadow (K*chunk, D), shadow_accum (K*chunk,)).

    CPU tensors take the plain version; a CUDA worklist launches the
    kernel (as `cache_fetch`), or raises. The device's part is a few
    microseconds, so this path keeps its host work to direct checks, two
    allocations and the launch."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if capacity.is_cpu and cap_accum.is_cpu and chunk_starts.is_cpu:
        return ref.cache_fetch_chunked_ref(capacity, cap_accum, chunk_starts,
                                           chunk)
    r, d = capacity.shape
    k = chunk_starts.shape[0]
    if chunk > r:
        raise ValueError(f"chunk {chunk} is taller than the {r}-row table")
    check_fetch_chunked(capacity, cap_accum, chunk_starts)
    n = k * chunk
    shadow = chunk_starts.new_empty((n, d), dtype=torch.float32)
    shadow_accum = chunk_starts.new_empty((n,), dtype=torch.float32)
    FETCH_CHUNKED_KERNEL.launch(
        capacity.data_ptr(), cap_accum.data_ptr(), chunk_starts.data_ptr(),
        shadow.data_ptr(), shadow_accum.data_ptr(), k, chunk, d,
        stream_handle(chunk_starts.get_device()))
    return shadow, shadow_accum


def check_fetch_chunked(capacity: torch.Tensor, cap_accum: torch.Tensor,
                        chunk_starts: torch.Tensor) -> None:
    """`cache_fetch_chunked`'s guard (`_check_gather`)."""
    _check_gather("cache_fetch_chunked", capacity, cap_accum, chunk_starts,
                  "chunk_starts")


def _check_gather(op: str, capacity: torch.Tensor, cap_accum: torch.Tensor,
                  rows: torch.Tensor, rows_name: str) -> None:
    """The two fetches' guard: `_check_cuda`'s checks written out directly
    (no dict, no loop); on a failure `_check_cuda` raises its own exception
    and message."""
    dev = rows.get_device()
    if not (rows.is_cuda
            and (capacity.get_device() == dev or is_page_locked(capacity))
            and (cap_accum.get_device() == dev or is_page_locked(cap_accum))
            and cap_accum.shape == capacity.shape[:1]
            and rows.dim() == 1
            and capacity.dtype == torch.float32
            and cap_accum.dtype == torch.float32
            and rows.dtype == torch.int32
            and capacity.is_contiguous() and cap_accum.is_contiguous()
            and rows.is_contiguous()):
        r, d = capacity.shape
        _check_cuda(op, {
            "capacity": (capacity, (r, d), torch.float32),
            "cap_accum": (cap_accum, (r,), torch.float32),
            rows_name: (rows, (rows.shape[0],), torch.int32)})
        raise AssertionError(f"{op}'s guard and _check_cuda disagree")


def cache_commit(capacity: torch.Tensor, cache: torch.Tensor,
                 cap_accum: torch.Tensor, cache_accum: torch.Tensor,
                 shadow: torch.Tensor, shadow_accum: torch.Tensor,
                 slots: torch.Tensor, evict_rows: torch.Tensor,
                 fetch_rows: torch.Tensor,
                 src_pos: torch.Tensor | None = None) -> None:
    """COMMIT half of the split exchange, IN PLACE on capacity (R, D),
    cache (C, D), cap_accum (R,) and cache_accum (C,): dirty-victim
    writeback (reading the post-update cache), then shadow row src_pos[i]
    (default i) -> slot slots[i]. shadow: (M, D), shadow_accum (M,) fp32;
    slots, evict_rows, fetch_rows, src_pos: (N,) int32, -1 = skip (fetch
    -1 = pure writeback). See `ref.cache_commit_ref` for the contract
    (distinct slots, src_pos inside the slab: `check_commit_worklist`).

    CPU tensors take the plain version; a CUDA worklist launches the
    kernel (cache and slab on its device; the capacity tier there or
    page-locked on the host), or raises. The device's part is a few tens
    of µs on an H100 at a training batch's misses, so this path keeps its
    host work to direct checks and the launch, as the fetches do."""
    if (capacity.is_cpu and cache.is_cpu and cap_accum.is_cpu
            and cache_accum.is_cpu and shadow.is_cpu and shadow_accum.is_cpu
            and slots.is_cpu and evict_rows.is_cpu and fetch_rows.is_cpu
            and (src_pos is None or src_pos.is_cpu)):
        ref.cache_commit_ref(capacity, cache, cap_accum, cache_accum, shadow,
                             shadow_accum, slots, evict_rows, fetch_rows,
                             src_pos)
        return
    _check_commit(capacity, cache, cap_accum, cache_accum, shadow,
                  shadow_accum, slots, evict_rows, fetch_rows, src_pos)
    COMMIT_KERNEL.launch(
        capacity.data_ptr(), cache.data_ptr(), cap_accum.data_ptr(),
        cache_accum.data_ptr(), shadow.data_ptr(), shadow_accum.data_ptr(),
        slots.data_ptr(), evict_rows.data_ptr(), fetch_rows.data_ptr(),
        None if src_pos is None else src_pos.data_ptr(), slots.shape[0],
        capacity.shape[1], stream_handle(slots.get_device()))


def _check_commit(capacity: torch.Tensor, cache: torch.Tensor,
                  cap_accum: torch.Tensor, cache_accum: torch.Tensor,
                  shadow: torch.Tensor, shadow_accum: torch.Tensor,
                  slots: torch.Tensor, evict_rows: torch.Tensor,
                  fetch_rows: torch.Tensor,
                  src_pos: torch.Tensor | None) -> None:
    """`cache_commit`'s guard: `_check_cuda`'s checks written out directly
    (no dict, no loop); on a failure `_check_cuda` raises its own exception
    and message."""
    r, d = capacity.shape
    dev = slots.get_device()
    n = slots.shape[0]
    if not (slots.is_cuda and cache.get_device() == dev
            and (capacity.get_device() == dev or is_page_locked(capacity))
            and (cap_accum.get_device() == dev or is_page_locked(cap_accum))
            and cache_accum.get_device() == dev
            and shadow.get_device() == dev
            and shadow_accum.get_device() == dev
            and evict_rows.get_device() == dev
            and fetch_rows.get_device() == dev
            and (src_pos is None or src_pos.get_device() == dev)
            and cache.dim() == 2 and shadow.dim() == 2 and cache.shape[1] == d
            and shadow.shape[1] == d
            and cap_accum.shape == capacity.shape[:1]
            and cache_accum.shape == cache.shape[:1]
            and shadow_accum.shape == shadow.shape[:1]
            and evict_rows.shape == slots.shape
            and fetch_rows.shape == slots.shape and slots.dim() == 1
            and (src_pos is None or src_pos.shape == slots.shape)
            and capacity.dtype == torch.float32
            and cache.dtype == torch.float32
            and cap_accum.dtype == torch.float32
            and cache_accum.dtype == torch.float32
            and shadow.dtype == torch.float32
            and shadow_accum.dtype == torch.float32
            and slots.dtype == torch.int32
            and evict_rows.dtype == torch.int32
            and fetch_rows.dtype == torch.int32
            and (src_pos is None or src_pos.dtype == torch.int32)
            and capacity.is_contiguous() and cache.is_contiguous()
            and cap_accum.is_contiguous() and cache_accum.is_contiguous()
            and shadow.is_contiguous() and shadow_accum.is_contiguous()
            and slots.is_contiguous() and evict_rows.is_contiguous()
            and fetch_rows.is_contiguous()
            and (src_pos is None or src_pos.is_contiguous())):
        c, m = cache.shape[0], shadow.shape[0]
        shapes = {"capacity": (capacity, (r, d), torch.float32),
                  "cache": (cache, (c, d), torch.float32),
                  "cap_accum": (cap_accum, (r,), torch.float32),
                  "cache_accum": (cache_accum, (c,), torch.float32),
                  "shadow": (shadow, (m, d), torch.float32),
                  "shadow_accum": (shadow_accum, (m,), torch.float32),
                  "slots": (slots, (n,), torch.int32),
                  "evict_rows": (evict_rows, (n,), torch.int32),
                  "fetch_rows": (fetch_rows, (n,), torch.int32)}
        if src_pos is not None:
            shapes["src_pos"] = (src_pos, (n,), torch.int32)
        _check_cuda("cache_commit", shapes)
        raise AssertionError("cache_commit's guard and _check_cuda disagree")


def cache_exchange(capacity: torch.Tensor, cache: torch.Tensor,
                   cap_accum: torch.Tensor, cache_accum: torch.Tensor,
                   freq: torch.Tensor, slots: torch.Tensor,
                   evict_rows: torch.Tensor, fetch_rows: torch.Tensor,
                   counts: torch.Tensor) -> None:
    """Batched eviction-writeback + fetch-on-miss, IN PLACE on capacity
    (R, D), cache (C, D), cap_accum (R,), cache_accum (C,) and freq (C,),
    all fp32. Worklist: slots, evict_rows, fetch_rows (N,) int32 (-1 =
    skip), counts (N,) fp32 LFU seeds; see `ref.cache_exchange_ref` for the
    per-entry contract (distinct slots, disjoint evict/fetch rows).

    CPU tensors take the plain version; a CUDA worklist launches the
    kernel (the capacity tier on its device or page-locked on the host),
    or raises."""
    tiers = (capacity, cache, cap_accum, cache_accum, freq)
    work = (slots, evict_rows, fetch_rows, counts)
    if all(t.device.type == "cpu" for t in tiers + work):
        ref.cache_exchange_ref(*tiers, *work)
        return
    r, d = capacity.shape
    c, n = cache.shape[0], slots.shape[0]
    dev = _check_cuda("cache_exchange", {
        "capacity": (capacity, (r, d), torch.float32),
        "cache": (cache, (c, d), torch.float32),
        "cap_accum": (cap_accum, (r,), torch.float32),
        "cache_accum": (cache_accum, (c,), torch.float32),
        "freq": (freq, (c,), torch.float32),
        "slots": (slots, (n,), torch.int32),
        "evict_rows": (evict_rows, (n,), torch.int32),
        "fetch_rows": (fetch_rows, (n,), torch.int32),
        "counts": (counts, (n,), torch.float32)})
    KERNEL.launch(*(t.data_ptr() for t in tiers + work), n, d,
                  int(capacity.is_cpu), stream_handle(dev))


def lfu_touch(freq: torch.Tensor, slots: torch.Tensor, counts: torch.Tensor,
              decay: float = 0.8) -> torch.Tensor:
    """LFU-with-decay hit accounting, in place: freq *= decay, then
    freq[slots] += counts (slots < 0 dropped). Returns freq."""
    return ref.lfu_touch_ref(freq, slots, counts, decay)
