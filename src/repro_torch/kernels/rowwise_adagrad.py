"""Legacy row-wise AdaGrad kernel wrapper (CUDA C++,
`csrc/rowwise_adagrad.cu`).

Port of the TPU kernel `repro/kernels/rowwise_adagrad.py::
rowwise_adagrad_kernel`, the second pass of the two-pass sparse update:
given per-row gradient sums from the dedup (`ref.dedup_grads_ref`), apply
row-wise AdaGrad to each named row and its accumulator in place. No
training path runs it (the fused sparse backward replaced it); it is the
two-pass oracle the fused update is held to bit for bit, through
`ops.rowwise_adagrad_update`. The TPU's limits do not carry over: no
scalar-prefetch cap on the index array and no D % 128 requirement (the
reference's lane padding and `sqrt(Dp/d)` rescale have no counterpart).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, stream_handle

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
KERNEL = Kernel("rowwise_adagrad", "rowwise_adagrad_launch",
                [_P, _P, _P, _P, _I64, _I64, _F, _F, _P])


def rowwise_adagrad(table: torch.Tensor, accum: torch.Tensor,
                    uniq: torch.Tensor, gsum: torch.Tensor, lr: float,
                    eps: float = 1e-8):
    """Row-wise AdaGrad from deduplicated row gradients, IN PLACE.

    table: (H, D) fp32; accum: (H,) fp32; uniq: (N,) int32 rows, -1 skips,
    live rows distinct; gsum: (N, D) fp32 summed gradients. Neither table
    nor accum may require grad. Returns (table, accum).

    CPU tensors take the plain version (`ref.rowwise_adagrad_ref`); CUDA
    tensors launch the kernel, or raise."""
    if table.dim() != 2 or accum.shape != table.shape[:1]:
        raise ValueError(f"need table (H, D) and accum (H,), got "
                         f"{tuple(table.shape)} and {tuple(accum.shape)}")
    if uniq.dim() != 1 or gsum.shape != (uniq.numel(), table.shape[1]):
        raise ValueError(f"need uniq (N,) and gsum (N, {table.shape[1]}), "
                         f"got {tuple(uniq.shape)} and {tuple(gsum.shape)}")
    if table.requires_grad or accum.requires_grad:
        raise ValueError("the sparse update writes table and accum in "
                         "place; neither may require grad")
    tensors = (table, accum, uniq, gsum)
    if all(t.device.type == "cpu" for t in tensors):
        with torch.no_grad():
            return ref.rowwise_adagrad_ref(table, accum, uniq, gsum, lr, eps)
    dev = table.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("rowwise_adagrad needs every tensor on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if not all(t.dtype == torch.float32 for t in (table, accum, gsum)) \
            or uniq.dtype != torch.int32:
        raise TypeError("rowwise_adagrad kernel takes fp32 table, accum and "
                        "gsum and int32 uniq")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rowwise_adagrad kernel needs contiguous tensors")
    KERNEL.launch(table.data_ptr(), accum.data_ptr(), uniq.data_ptr(),
                  gsum.data_ptr(), uniq.numel(), table.shape[1], float(lr),
                  float(eps), stream_handle(dev))
    return table, accum
