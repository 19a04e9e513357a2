"""Capacity <-> cache row exchange (CUDA C++, `csrc/cache_exchange.cu`)
and the LFU counter update of the cached embedding tier.

`cache_exchange` ports the TPU kernel `repro/kernels/cache_ops.py::
cache_exchange_kernel`. JAX donated the five tier buffers so XLA could
alias them; the port simply mutates the torch tensors in place. The
split async fetch/commit kernels and the chunked fetch come with the async
cached-tier slice. `lfu_touch` is a plain torch op here as in the
reference, which has no kernel for it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, stream_handle

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
KERNEL = Kernel("cache_exchange", "cache_exchange_launch",
                [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _P])


def check_worklist(slots: torch.Tensor, evict_rows: torch.Tensor,
                   fetch_rows: torch.Tensor) -> None:
    """Raise unless the worklist meets the exchange's no-race contract:
    live slots distinct, and no row both written back and fetched. Costs a
    host sync; tests and chip_smoke.py call it, the serving path does not."""
    live = slots >= 0
    s = slots[live]
    if torch.unique(s).numel() != s.numel():
        raise ValueError("cache_exchange worklist repeats a cache slot")
    ev = evict_rows[live & (evict_rows >= 0)]
    ft = fetch_rows[live & (fetch_rows >= 0)]
    if torch.isin(ev, ft).any():
        raise ValueError("cache_exchange worklist writes back and fetches "
                         "the same capacity row")


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

    CPU tensors take the plain version; CUDA tensors launch the kernel, or
    raise."""
    tiers = (capacity, cache, cap_accum, cache_accum, freq)
    work = (slots, evict_rows, fetch_rows, counts)
    if all(t.device.type == "cpu" for t in tiers + work):
        ref.cache_exchange_ref(*tiers, *work)
        return
    dev = capacity.device
    if dev.type != "cuda" or any(t.device != dev for t in tiers + work):
        raise ValueError("cache_exchange needs every tensor on one CUDA "
                         "device")
    r, d = capacity.shape
    c = cache.shape[0]
    n = slots.shape[0]
    shapes = {"capacity": (capacity, (r, d)), "cache": (cache, (c, d)),
              "cap_accum": (cap_accum, (r,)),
              "cache_accum": (cache_accum, (c,)), "freq": (freq, (c,)),
              "evict_rows": (evict_rows, (n,)),
              "fetch_rows": (fetch_rows, (n,)), "counts": (counts, (n,)),
              "slots": (slots, (n,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"cache_exchange: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        want = torch.int32 if name in ("slots", "evict_rows",
                                       "fetch_rows") else torch.float32
        if t.dtype != want:
            raise TypeError(f"cache_exchange: {name} must be {want}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cache_exchange: {name} must be contiguous")
    KERNEL.launch(*(t.data_ptr() for t in tiers + work), n, d,
                  stream_handle(dev))


def lfu_touch(freq: torch.Tensor, slots: torch.Tensor, counts: torch.Tensor,
              decay: float = 0.8) -> torch.Tensor:
    """LFU-with-decay hit accounting, in place: freq *= decay, then
    freq[slots] += counts (slots < 0 dropped). Returns freq."""
    return ref.lfu_touch_ref(freq, slots, counts, decay)
