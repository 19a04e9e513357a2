"""Causal flash-attention kernel wrapper (CUDA C++,
`csrc/flash_attention.cu`).

Port of the TPU kernel `repro/kernels/flash_attention.py::
flash_attention_kernel`: causal softmax attention on (b, h, s, dh) with an
online softmax over key tiles, so the (s, s) scores never reach device
memory. bf16 inputs run a tensor-core kernel (wgmma, TMA, a warp-
specialised K/V ring) that rounds P to bf16 before P.V, as the model's
blockwise attention does; fp32 inputs run an fp32 SIMT kernel. The kernels
take dh 64 and 128 natively; a smaller dh is padded with zeros to 64 (up
to 128 for 65..128), which changes no dot product, and the scale stays
1/sqrt(true dh). Unlike the reference wrapper it needs no sequence
padding: the kernels mask their own ragged edge.
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
                [_P, _P, _P, _P, _I64, _I64, _I64, _I64, ctypes.c_float, _P])
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q, k, v: (b, h, s, dh), one dtype (fp32 or bf16 on the card).
    Returns (b, h, s, dh) in q's dtype.

    A CPU tensor takes the plain version of the kernel its dtype would run,
    causal or not: bf16 the tiled `ref.flash_attention_tiled_ref` at the
    bf16 kernel's key tile, anything else `ref.flash_attention_ref`. A CUDA
    tensor launches the kernel, which is causal only, or raises."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"need q, k, v of one (b, h, s, dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        if q.dtype == torch.bfloat16 and q.shape[-1] <= NATIVE_DH[-1]:
            return ref.flash_attention_tiled_ref(
                q, k, v, block_k(q.shape[-1]), causal)
        return ref.flash_attention_ref(q, k, v, causal)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_attention needs q, k, v on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if not causal:
        raise ValueError("the flash-attention kernel is causal only")
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or any(t.dtype != q.dtype for t in tensors):
        raise TypeError("flash_attention kernel takes fp32 or bf16 q, k, v "
                        f"of one dtype, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    b, h, s, dh = q.shape
    if dh > NATIVE_DH[-1]:
        raise ValueError(f"flash_attention kernel takes dh <= "
                         f"{NATIVE_DH[-1]}, got {dh}")
    if b * h > MAX_BATCH_HEADS:
        raise ValueError(f"b * h = {b * h} exceeds the grid's "
                         f"{MAX_BATCH_HEADS}")
    dp = _native_dh(dh)
    if dp != dh:
        q, k, v = (F.pad(t, (0, dp - dh)) for t in tensors)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs 16-byte aligned "
                         "q, k, v")
    out = torch.empty_like(q)
    if out.numel():
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b * h, s, dp,
                      int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(dh),
                      stream_handle(dev))
    return out if dp == dh else out[..., :dh].contiguous()
