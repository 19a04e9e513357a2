"""Fused sparse backward kernel wrapper (CUDA C++,
`csrc/fused_bag_backward_adagrad.cu`).

Port of the TPU kernel `repro/kernels/sparse_update.py::
fused_bag_backward_adagrad_kernel` (the S=1 case of the segmented kernel):
per unique row of a `SparsePlan`, sum the pooled bag gradients of its CSR
slice, then apply row-wise AdaGrad to the row and its accumulator in place.
The TPU's limits do not carry over: no scalar-prefetch cap on the plan's
size and no D % 128 requirement (the reference's lane padding and its
`sqrt(Dp/d)` learning-rate rescale have no counterpart). The per-owner
segmented form (S > 1) comes with the multi-device slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, stream_handle

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
KERNEL = Kernel("fused_bag_backward_adagrad",
                "fused_bag_backward_adagrad_launch",
                [_P, _P, _P, _P, _P, _P, _I64, _I64, _F, _F, _P])


def fused_bag_backward_adagrad(table: torch.Tensor, accum: torch.Tensor,
                               unique_rows: torch.Tensor,
                               bag_offsets: torch.Tensor,
                               bag_ids: torch.Tensor, pooled: torch.Tensor,
                               lr: float, eps: float = 1e-8):
    """Row-wise AdaGrad from pooled bag gradients, IN PLACE.

    table: (H, D) fp32; accum: (H,) fp32; plan arrays (U,), (U+1,), (N,)
    int32 (`kernels.sparse_plan`); pooled: (B*F, D) fp32. Neither table nor
    accum may require grad: the update is the optimizer, not a graph node.
    Returns (table, accum).

    CPU tensors take the plain version (`ref.fused_bag_backward_adagrad_ref`);
    CUDA tensors launch the kernel, or raise."""
    if table.dim() != 2 or accum.shape != table.shape[:1]:
        raise ValueError(f"need table (H, D) and accum (H,), got "
                         f"{tuple(table.shape)} and {tuple(accum.shape)}")
    if pooled.dim() != 2 or pooled.shape[1] != table.shape[1]:
        raise ValueError(f"need pooled (B*F, {table.shape[1]}), got "
                         f"{tuple(pooled.shape)}")
    if bag_offsets.shape != (unique_rows.numel() + 1,):
        raise ValueError("bag_offsets must hold one more entry than "
                         "unique_rows")
    if table.requires_grad or accum.requires_grad:
        raise ValueError("the sparse update writes table and accum in "
                         "place; neither may require grad")
    tensors = (table, accum, unique_rows, bag_offsets, bag_ids, pooled)
    if all(t.device.type == "cpu" for t in tensors):
        with torch.no_grad():
            return ref.fused_bag_backward_adagrad_ref(
                table, accum, unique_rows, bag_offsets, bag_ids, pooled,
                lr, eps)
    _check_cuda(tensors)
    KERNEL.launch(table.data_ptr(), accum.data_ptr(), unique_rows.data_ptr(),
                  bag_offsets.data_ptr(), bag_ids.data_ptr(),
                  pooled.data_ptr(), unique_rows.numel(), table.shape[1],
                  float(lr), float(eps), stream_handle(table.device))
    return table, accum


def _check_cuda(tensors) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("fused_bag_backward_adagrad needs every tensor on "
                         f"one CUDA device, got {[str(t.device) for t in tensors]}")
    table, accum, rows, offs, bags, pooled = tensors
    if not all(t.dtype == torch.float32 for t in (table, accum, pooled)) \
            or not all(t.dtype == torch.int32 for t in (rows, offs, bags)):
        raise TypeError("fused_bag_backward_adagrad kernel takes fp32 table, "
                        "accum and pooled grads and int32 plan arrays")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_bag_backward_adagrad kernel needs contiguous "
                         "tensors")
