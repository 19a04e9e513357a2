"""Embedding-bag kernel wrappers (CUDA C++, `csrc/embedding_bag.cu` and
`csrc/dedup_embedding_bag.cu`).

Ports of the TPU kernels `repro/kernels/embedding_bag.py::
embedding_bag_kernel` and `dedup_embedding_bag_kernel`: pooled multi-hot
gather of an (H, D) fp32 table by (B, L) int32 indices (-1 pads), sum or
mean, into (B, D) fp32 — the second reading each unique row of a
`SparsePlan` from the table once. The TPU's 128-lane padding of D is gone:
both kernels take any D.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, stream_handle

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
KERNEL = Kernel("embedding_bag", "embedding_bag_launch",
                [_P, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P])
DEDUP_KERNEL = Kernel("dedup_embedding_bag", "dedup_embedding_bag_launch",
                      [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P])
MODES = ("sum", "mean")


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """Pooled lookup. table: (H, D) fp32; indices: (B, L) int32, -1 pads,
    every other entry in [0, H). Returns (B, D) fp32.

    A CPU tensor takes the plain version (`ref.embedding_bag_ref`); a CUDA
    tensor launches the kernel, or raises."""
    if mode not in MODES:
        raise ValueError(f"unknown pooling mode {mode!r}; expected {MODES}")
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"need table (H, D) and indices (B, L), got "
                         f"{tuple(table.shape)} and {tuple(indices.shape)}")
    if table.device.type == "cpu" and indices.device.type == "cpu":
        return ref.embedding_bag_ref(table, indices, mode)
    _check_cuda(table, indices)
    b, length = indices.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=torch.float32, device=table.device)
    KERNEL.launch(table.data_ptr(), indices.data_ptr(), out.data_ptr(),
                  b, length, d, int(mode == "mean"),
                  stream_handle(table.device))
    return out


def dedup_embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                        unique_rows: torch.Tensor,
                        mode: str = "sum") -> torch.Tensor:
    """Pooled lookup that reads each unique row of the table once.
    table: (H, D) fp32; indices: (B, L) int32, -1 pads; unique_rows: (U,)
    int32, a `SparsePlan`'s unique rows over indices' flat stream (live
    prefix ascending, -1 tail), covering every valid index. Returns
    (B, D) fp32, bit-equal to `embedding_bag`.

    A CPU tensor takes the plain version (`ref.dedup_embedding_bag_ref`); a
    CUDA tensor launches the kernel (gather, then pool), or raises. The
    kernel's scratch, the (U, D) slab and an (H,) int32 row-to-slab-position
    map (4 bytes a table row), is one uncleared allocation per call."""
    if mode not in MODES:
        raise ValueError(f"unknown pooling mode {mode!r}; expected {MODES}")
    if table.dim() != 2 or indices.dim() != 2 or unique_rows.dim() != 1:
        raise ValueError(f"need table (H, D), indices (B, L) and unique_rows "
                         f"(U,), got {tuple(table.shape)}, "
                         f"{tuple(indices.shape)} and "
                         f"{tuple(unique_rows.shape)}")
    if table.is_cpu and indices.is_cpu and unique_rows.is_cpu:
        return ref.dedup_embedding_bag_ref(table, indices, unique_rows, mode)
    # the wrapper's host time is most of its cost at the training batch,
    # so the checks are direct; a failure raises what `_check_cuda` raises
    dev = table.get_device()
    if not (table.is_cuda and indices.get_device() == dev
            and unique_rows.get_device() == dev
            and table.dtype == torch.float32 and indices.dtype == torch.int32
            and unique_rows.dtype == torch.int32 and table.is_contiguous()
            and indices.is_contiguous() and unique_rows.is_contiguous()):
        _check_cuda(table, indices)
        raise ValueError("dedup_embedding_bag kernel needs contiguous int32 "
                         "unique_rows on the table's device")
    if unique_rows.numel() == 0:
        raise ValueError("dedup_embedding_bag needs a plan with at least one "
                         "entry")
    b, length = indices.shape
    h, d = table.shape
    u = unique_rows.numel()
    # the slab's fp32 words, then the map's int32 words
    scratch = table.new_empty((u * d + h,))
    out = table.new_empty((b, d))
    compact = scratch.data_ptr()
    DEDUP_KERNEL.launch(table.data_ptr(), unique_rows.data_ptr(),
                        indices.data_ptr(), compact, compact + u * d * 4,
                        out.data_ptr(), u, b, length, d,
                        stream_handle(dev))
    if mode == "mean":
        out = out / (indices >= 0).sum(dim=1, keepdim=True).clamp(
            min=1).float()
    return out


def _check_cuda(table: torch.Tensor, indices: torch.Tensor) -> None:
    if table.device.type != "cuda" or indices.device != table.device:
        raise ValueError(f"embedding_bag needs both tensors on one CUDA "
                         f"device, got {table.device} and {indices.device}")
    if table.dtype != torch.float32 or indices.dtype != torch.int32:
        raise TypeError(f"embedding_bag kernel takes fp32 table and int32 "
                        f"indices, got {table.dtype} and {indices.dtype}")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("embedding_bag kernel needs contiguous tensors")
