"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in the same
accumulation order where the kernel has one, on any device. The kernel
wrappers (`kernels/ops.py`, `kernels/cache_ops.py`) call these only for
tensors on the CPU; `chip_smoke.py` holds each kernel against its plain
version on the card, and the tests hold the plain versions against the
reference package's `repro.kernels.ref` oracles.
"""
from __future__ import annotations

import numpy as np
import torch


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      mode: str = "sum") -> torch.Tensor:
    """Multi-hot lookup + pooling. table: (H, D); indices: (B, L) int,
    -1 = padding slot. Returns (B, D): the sum (or mean over valid slots,
    divided by max(count, 1)) of the bag's rows.

    The L slots are added one after another in fp32, pads contributing
    nothing — the CUDA kernel's order, so the two agree bit for bit."""
    b, length = indices.shape
    valid = indices >= 0
    safe = indices.clamp(min=0).long()
    out = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for j in range(length):
        rows = table[safe[:, j]].float()
        out = torch.where(valid[:, j, None], out + rows, out)
    if mode == "mean":
        cnt = valid.sum(dim=1, keepdim=True).clamp(min=1).float()
        out = out / cnt
    elif mode != "sum":
        raise ValueError(f"unknown pooling mode {mode!r}")
    return out.to(table.dtype)


def dot_interaction_ref(z: torch.Tensor) -> torch.Tensor:
    """Pairwise dot-product interaction. z: (B, F, D). Returns
    (B, F*(F-1)//2): the strict lower triangle of z @ z^T per example, in
    np.tril_indices(F, -1) order, accumulated in fp32."""
    f = z.shape[1]
    zf = z.float()
    s = torch.einsum("bfd,bgd->bfg", zf, zf)
    rows, cols = np.tril_indices(f, -1)
    return s[:, torch.as_tensor(rows, device=z.device),
             torch.as_tensor(cols, device=z.device)].to(z.dtype)


def cache_exchange_ref(capacity: torch.Tensor, cache: torch.Tensor,
                       cap_accum: torch.Tensor, cache_accum: torch.Tensor,
                       freq: torch.Tensor, slots: torch.Tensor,
                       evict_rows: torch.Tensor, fetch_rows: torch.Tensor,
                       counts: torch.Tensor) -> None:
    """One batched swap between the capacity tier and the device cache,
    IN PLACE on the five tier tensors (the reference returns new arrays).

    capacity: (R, D); cache: (C, D); cap_accum: (R,), cache_accum: (C,),
    freq: (C,) fp32. Entry i with slots[i] >= 0 first writes the slot back
    to capacity row evict_rows[i] if that is >= 0, then fills the slot from
    capacity row fetch_rows[i] if that is >= 0, seeding freq[slot] with
    counts[i]. Entries with slots[i] < 0 are skipped (the TPU kernel's
    rule). Slots must be distinct and the evict/fetch row sets disjoint."""
    live = slots >= 0
    wb = live & (evict_rows >= 0)
    s_wb, r_wb = slots[wb].long(), evict_rows[wb].long()
    capacity[r_wb] = cache[s_wb]
    cap_accum[r_wb] = cache_accum[s_wb]
    ft = live & (fetch_rows >= 0)
    s_ft, r_ft = slots[ft].long(), fetch_rows[ft].long()
    cache[s_ft] = capacity[r_ft]
    cache_accum[s_ft] = cap_accum[r_ft]
    freq[s_ft] = counts[ft].to(freq.dtype)


def lfu_touch_ref(freq: torch.Tensor, slots: torch.Tensor,
                  counts: torch.Tensor, decay: float) -> torch.Tensor:
    """Decay-then-bump LFU update, IN PLACE: freq *= decay, then
    freq[slots[i]] += counts[i] for every valid (>= 0) slot. Returns freq.
    One multiply and, for distinct slots, one add per slot — the
    reference's arithmetic, so the scores (and the eviction order they
    decide) come out bit-equal."""
    keep = slots >= 0
    freq.mul_(decay)
    freq.index_add_(0, slots[keep].long(), counts[keep].to(freq.dtype))
    return freq
