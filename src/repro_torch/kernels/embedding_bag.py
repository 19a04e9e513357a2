"""Embedding-bag kernel wrapper (CUDA C++, `csrc/embedding_bag.cu`).

Port of the TPU kernel `repro/kernels/embedding_bag.py::embedding_bag_kernel`:
pooled multi-hot gather of an (H, D) fp32 table by (B, L) int32 indices
(-1 pads), sum or mean, into (B, D) fp32. The TPU's 128-lane padding of D
is gone: the kernel takes any D.
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


def _check_cuda(table: torch.Tensor, indices: torch.Tensor) -> None:
    if table.device.type != "cuda" or indices.device != table.device:
        raise ValueError(f"embedding_bag needs both tensors on one CUDA "
                         f"device, got {table.device} and {indices.device}")
    if table.dtype != torch.float32 or indices.dtype != torch.int32:
        raise TypeError(f"embedding_bag kernel takes fp32 table and int32 "
                        f"indices, got {table.dtype} and {indices.dtype}")
    if not (table.is_contiguous() and indices.is_contiguous()):
        raise ValueError("embedding_bag kernel needs contiguous tensors")
