"""Causal flash-attention kernel wrappers (CUDA C++,
`csrc/flash_attention.cu` and `csrc/flash_attention_bwd.cu`), and the
`torch.autograd.Function` that trains through them.

Forward: port of the TPU kernel `repro/kernels/flash_attention.py::
flash_attention_kernel`: causal softmax attention on (b, h, s, dh) with an
online softmax over key tiles, so the (s, s) scores never reach device
memory. bf16 inputs run a tensor-core kernel (wgmma, TMA, a warp-
specialised K/V ring) that rounds P to bf16 before P.V, as the model's
blockwise attention does; fp32 inputs run an fp32 SIMT kernel. The kernels
take dh 64 and 128 natively; a smaller dh is padded with zeros to 64 (up
to 128 for 65..128), which changes no dot product, and the scale stays
1/sqrt(true dh). Unlike the reference wrapper it needs no sequence
padding: the kernels mask their own ragged edge. Asked for it, the forward
also stores each row's log-sum-exp (log2 units) for the backward.

Backward: no TPU kernel to port (the reference trains through XLA's
autodiff of its blockwise attention). `flash_attention_bwd` is the causal
FlashAttention-2 backward from (q, k, v, o, dO, lse), deterministic (no
atomics), bf16 or fp32 at the forward's head dims: bf16 inputs run two
tensor-core passes (wgmma, TMA) that round P and dS to bf16 before the
products that take them, fp32 inputs fp32 SIMT kernels. `FlashAttention`
runs the forward with the log-sum-exp and the backward kernel; on the CPU
both take their plain versions.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, stream_handle

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
KERNEL = Kernel("flash_attention", "flash_attention_launch",
                [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, ctypes.c_float,
                 _P])
BWD_KERNEL = Kernel("flash_attention_bwd", "flash_attention_bwd_launch",
                    [_P] * 10 + [_I64, _I64, _I64, _I64, ctypes.c_float, _P])
#: head dims the kernel is compiled for; others pad up to the next one
NATIVE_DH = (64, 128)
#: b * h the kernels take (the y dimension of the fp32 kernel's grid)
MAX_BATCH_HEADS = 65535
#: keys per tile of the bf16 kernel, by native dh: its plain version
#: (`ref.flash_attention_tiled_ref`) folds the same tiles in the same order
BLOCK_K = {64: 128, 128: 64}


def _native_dh(dh: int) -> int:
    return next(n for n in NATIVE_DH if dh <= n)


def block_k(dh: int) -> int:
    """Keys per tile of the bf16 kernel for a head dim of `dh`."""
    return BLOCK_K[_native_dh(dh)]


def _check_cuda(name: str, tensors, causal: bool) -> torch.device:
    """The checks both kernels share; raises on what they do not take."""
    q = tensors[0]
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs its tensors on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not causal:
        raise ValueError("the flash-attention kernels are causal only")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name} kernel takes fp32 or bf16 tensors of one "
                        f"dtype, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    b, h, s, dh = q.shape
    if dh > NATIVE_DH[-1]:
        raise ValueError(f"{name} kernel takes dh <= {NATIVE_DH[-1]}, got "
                         f"{dh}")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"b * h = {b * h} exceeds the grid's "
                         f"{MAX_BATCH_HEADS}")
    return dev


def _pad_dh(tensors):
    """Zero-pad the head dim up to the kernels' native one."""
    dh = tensors[0].shape[-1]
    dp = _native_dh(dh)
    if dp == dh:
        return tensors
    return [F.pad(t, (0, dp - dh)) for t in tensors]


def _check_shapes(tensors) -> None:
    q = tensors[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"need tensors of one (b, h, s, dh) shape, got "
                         f"{[tuple(t.shape) for t in tensors]}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, with_lse: bool = False):
    """q, k, v: (b, h, s, dh), one dtype (fp32 or bf16 on the card).
    Returns (b, h, s, dh) in q's dtype; with `with_lse`, (out, lse) where
    lse (b, h, s) is each row's log-sum-exp of the scaled scores in log2
    units (fp32 from the kernel), what `flash_attention_bwd` takes.

    A CPU tensor takes the plain version of the kernel its dtype would run,
    causal or not: bf16 the tiled `ref.flash_attention_tiled_ref` at the
    bf16 kernel's key tile, anything else `ref.flash_attention_ref`. A CUDA
    tensor launches the kernel, which is causal only, or raises."""
    tensors = (q, k, v)
    _check_shapes(tensors)
    if all(t.device.type == "cpu" for t in tensors):
        if q.dtype == torch.bfloat16 and q.shape[-1] <= NATIVE_DH[-1]:
            return ref.flash_attention_tiled_ref(
                q, k, v, block_k(q.shape[-1]), causal, with_lse)
        return ref.flash_attention_ref(q, k, v, causal, with_lse)
    dev = _check_cuda("flash_attention", tensors, causal)
    b, h, s, dh = q.shape
    q, k, v = _pad_dh(tensors)
    dp = q.shape[-1]
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs 16-byte aligned "
                         "q, k, v")
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=dev)
           if with_lse else None)
    if out.numel():
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), 0 if lse is None else lse.data_ptr(),
                      b * h, s, dp, int(q.dtype == torch.bfloat16),
                      1.0 / math.sqrt(dh), stream_handle(dev))
    out = out if dp == dh else out[..., :dh].contiguous()
    return (out, lse) if with_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        causal: bool = True):
    """Gradients (dq, dk, dv) of causal attention, each (b, h, s, dh) in
    q's dtype, from the forward's q, k, v, output o, the output's gradient
    do and the forward's `lse` (log2 units, (b, h, s)).

    A CPU tensor takes the plain version `ref.flash_attention_bwd_ref`
    (causal or not); a CUDA tensor launches the backward kernel (causal
    only) or raises."""
    tensors = (q, k, v, o, do)
    _check_shapes(tensors)
    if lse.shape != q.shape[:3]:
        raise ValueError(f"lse must be {tuple(q.shape[:3])}, got "
                         f"{tuple(lse.shape)}")
    if all(t.device.type == "cpu" for t in tensors + (lse,)):
        return ref.flash_attention_bwd_ref(q, k, v, o, do, lse, causal)
    dev = _check_cuda("flash_attention_bwd", tensors, causal)
    if lse.device != dev or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd needs a contiguous fp32 lse on "
                         "the tensors' device")
    b, h, s, dh = q.shape
    padded = _pad_dh(tensors)
    dp = padded[0].shape[-1]
    if any(t.data_ptr() % 16 for t in padded):
        raise ValueError("flash_attention_bwd kernel needs 16-byte aligned "
                         "tensors")
    grads = [torch.empty_like(padded[0]) for _ in range(3)]
    delta = torch.empty((b, h, s), dtype=torch.float32, device=dev)
    if q.numel():
        BWD_KERNEL.launch(*(t.data_ptr() for t in padded), lse.data_ptr(),
                          *(g.data_ptr() for g in grads), delta.data_ptr(),
                          b * h, s, dp, int(q.dtype == torch.bfloat16),
                          1.0 / math.sqrt(dh), stream_handle(dev))
    if dp != dh:
        grads = [g[..., :dh].contiguous() for g in grads]
    return tuple(grads)


class FlashAttention(torch.autograd.Function):
    """Differentiable causal attention on (b, h, s, dh): the forward
    kernel with the log-sum-exp stored, and `flash_attention_bwd` for the
    gradient of q, k and v (the plain versions of both on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True):
        out, lse = flash_attention(q, k, v, causal, with_lse=True)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, ctx.causal)
        return dq, dk, dv, None
