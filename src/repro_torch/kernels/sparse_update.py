"""Fused sparse backward kernel wrappers (CUDA C++,
`csrc/fused_bag_backward_adagrad.cu`, two entry points over one per-row
body).

Ports of the TPU kernel `repro/kernels/sparse_update.py::
fused_bag_backward_adagrad_segments_kernel`: per unique row, sum the pooled
bag gradients of its CSR slice, then apply row-wise AdaGrad to the row and
its accumulator in place.

  fused_bag_backward_adagrad           one plan (the S=1 case,
                                       `fused_bag_backward_adagrad_kernel`);
  fused_bag_backward_adagrad_segments  S per-owner segments of one plan
                                       (S > 1), rows rebased per segment —
                                       the table-wise step's update.

The TPU's limits do not carry over: no scalar-prefetch cap on the plan's
size and no D % 128 requirement (the reference's lane padding and its
`sqrt(Dp/d)` learning-rate rescale have no counterpart).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import meta as kmeta
from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, stream_handle

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
KERNEL = Kernel("fused_bag_backward_adagrad",
                "fused_bag_backward_adagrad_launch",
                [_P, _P, _P, _P, _P, _P, _I64, _I64, _F, _F, _P])
SEGMENTS_KERNEL = Kernel("fused_bag_backward_adagrad_segments",
                         "fused_bag_backward_adagrad_segments_launch",
                         [_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _F,
                          _F, _P],
                         source="fused_bag_backward_adagrad")


def fused_bag_backward_adagrad(table: torch.Tensor, accum: torch.Tensor,
                               unique_rows: torch.Tensor,
                               bag_offsets: torch.Tensor,
                               bag_ids: torch.Tensor, pooled: torch.Tensor,
                               lr: float, eps: float = 1e-8):
    """Row-wise AdaGrad from pooled bag gradients, IN PLACE.

    table: (H, D) fp32; accum: (H,) fp32; plan arrays (U,), (U+1,), (N,)
    int32 (`kernels.sparse_plan`), unique_rows a live prefix as the planner
    makes it (the kernel may skip a live entry that follows a pad);
    pooled: (B*F, D) fp32. Neither table nor accum may require grad: the
    update is the optimizer, not a graph node. Returns (table, accum).

    CPU tensors take the plain version (`ref.fused_bag_backward_adagrad_ref`);
    CUDA tensors launch the kernel, or raise; meta tensors are checked,
    launch nothing and book the kernel's cost with every plan entry taken
    as live (`kernels.meta`)."""
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
    if table.is_cpu and all(t.is_cpu for t in tensors):
        with torch.no_grad():
            return ref.fused_bag_backward_adagrad_ref(
                table, accum, unique_rows, bag_offsets, bag_ids, pooled,
                lr, eps)
    if table.is_meta:
        _check_cuda(tensors, "fused_bag_backward_adagrad", meta=True)
        kmeta.book("fused_bag_backward_adagrad", *kmeta.fused_update_cost(
            unique_rows.numel(), bag_ids.numel(), pooled.shape[0],
            table.shape[1]))
        return table, accum
    _check_direct("fused_bag_backward_adagrad", *tensors)
    KERNEL.launch(table.data_ptr(), accum.data_ptr(), unique_rows.data_ptr(),
                  bag_offsets.data_ptr(), bag_ids.data_ptr(),
                  pooled.data_ptr(), unique_rows.numel(), table.shape[1],
                  float(lr), float(eps), stream_handle(table.get_device()))
    return table, accum


def fused_bag_backward_adagrad_segments(table: torch.Tensor,
                                        accum: torch.Tensor,
                                        seg_rows: torch.Tensor,
                                        seg_offsets: torch.Tensor,
                                        bag_ids: torch.Tensor,
                                        pooled: torch.Tensor,
                                        seg_base: torch.Tensor, lr: float,
                                        eps: float = 1e-8):
    """Row-wise AdaGrad from pooled bag gradients over S per-owner
    segments of one plan, IN PLACE: entry (s, i) updates row seg_base[s] +
    seg_rows[s, i] (skipped when seg_rows[s, i] < 0) from the bag slice
    [seg_offsets[s, i], seg_offsets[s, i+1]) of the shared bag_ids.

    table: (H, D) fp32; accum: (H,) fp32; seg_rows (S, C), seg_offsets
    (S, C+1) absolute into bag_ids (N,), seg_base (S,), all int32
    (`sparse_plan.split_plan_by_owner`); pooled: (B*F, D) fp32. The
    segments must be disjoint row ranges of one plan. Returns
    (table, accum).

    CPU tensors take the plain version
    (`ref.fused_bag_backward_adagrad_segments_ref`); CUDA tensors launch
    the kernel, or raise."""
    if table.dim() != 2 or accum.shape != table.shape[:1]:
        raise ValueError(f"need table (H, D) and accum (H,), got "
                         f"{tuple(table.shape)} and {tuple(accum.shape)}")
    if pooled.dim() != 2 or pooled.shape[1] != table.shape[1]:
        raise ValueError(f"need pooled (B*F, {table.shape[1]}), got "
                         f"{tuple(pooled.shape)}")
    if seg_rows.dim() != 2:
        raise ValueError(f"need seg_rows (S, C), got "
                         f"{tuple(seg_rows.shape)}")
    s, c = seg_rows.shape
    if seg_offsets.shape != (s, c + 1):
        raise ValueError(f"need seg_offsets ({s}, {c + 1}), got "
                         f"{tuple(seg_offsets.shape)}")
    if seg_base.shape != (s,):
        raise ValueError(f"need seg_base ({s},), got "
                         f"{tuple(seg_base.shape)}")
    if table.requires_grad or accum.requires_grad:
        raise ValueError("the sparse update writes table and accum in "
                         "place; neither may require grad")
    tensors = (table, accum, seg_rows, seg_offsets, bag_ids, pooled,
               seg_base)
    if table.is_cpu and all(t.is_cpu for t in tensors):
        with torch.no_grad():
            return ref.fused_bag_backward_adagrad_segments_ref(
                table, accum, seg_rows, seg_offsets, bag_ids, pooled,
                seg_base, lr, eps)
    _check_direct("fused_bag_backward_adagrad_segments", table, accum,
                  seg_rows, seg_offsets, bag_ids, pooled, seg_base)
    SEGMENTS_KERNEL.launch(
        table.data_ptr(), accum.data_ptr(), seg_rows.data_ptr(),
        seg_offsets.data_ptr(), bag_ids.data_ptr(), pooled.data_ptr(),
        seg_base.data_ptr(), s, c, table.shape[1], float(lr), float(eps),
        stream_handle(table.get_device()))
    return table, accum


def _check_direct(name: str, table, accum, rows, offsets, bag_ids, pooled,
                  seg_base=None) -> None:
    """The wrappers' guard: `_check_cuda`'s checks written out directly;
    on a failure `_check_cuda` raises its own exception and message."""
    dev = table.get_device()
    f32, i32 = torch.float32, torch.int32
    if not (table.is_cuda and accum.get_device() == dev
            and rows.get_device() == dev and offsets.get_device() == dev
            and bag_ids.get_device() == dev and pooled.get_device() == dev
            and table.dtype == f32 and accum.dtype == f32
            and pooled.dtype == f32 and rows.dtype == i32
            and offsets.dtype == i32 and bag_ids.dtype == i32
            and table.is_contiguous() and accum.is_contiguous()
            and rows.is_contiguous() and offsets.is_contiguous()
            and bag_ids.is_contiguous() and pooled.is_contiguous()
            and (seg_base is None
                 or (seg_base.get_device() == dev and seg_base.dtype == i32
                     and seg_base.is_contiguous()))):
        tensors = (table, accum, rows, offsets, bag_ids, pooled)
        _check_cuda(tensors + (() if seg_base is None else (seg_base,)),
                    name)
        raise AssertionError(f"{name}'s guard and _check_cuda disagree")


def _check_cuda(tensors, name: str, meta: bool = False) -> None:
    """Every tensor on one CUDA device (or, with `meta`, all on the meta
    device), contiguous; table, accum and pooled (the first two and the
    sixth) fp32, every index array int32."""
    dev = tensors[0].device
    ok = ("cuda", "meta") if meta else ("cuda",)
    if dev.type not in ok or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs every tensor on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    floats = (tensors[0], tensors[1], tensors[5])
    ints = tensors[2:5] + tensors[6:]
    if not all(t.dtype == torch.float32 for t in floats) \
            or not all(t.dtype == torch.int32 for t in ints):
        raise TypeError(f"{name} kernel takes fp32 table, accum and pooled "
                        "grads and int32 plan arrays")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous tensors")
