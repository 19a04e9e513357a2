"""Dot-interaction kernel wrapper (CUDA C++, `csrc/dot_interaction.cu`).

Port of the TPU kernel `repro/kernels/dot_interaction.py::
dot_interaction_kernel`: per example, the strictly-lower triangle of
Z Z^T over the stacked (F, D) features, fp32. Unlike the TPU kernel it
packs the triangle itself, in np.tril_indices(F, -1) order, and needs no
sublane/lane padding of F and D.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, stream_handle

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
KERNEL = Kernel("dot_interaction", "dot_interaction_launch",
                [_P, _P, _I64, _I64, _I64, _P])
#: the block stages one example's (F, D+1) floats in shared memory; above
#: the 48 KB a launch gets without an opt-in the kernel would be refused
MAX_SHARED_BYTES = 48 * 1024


def dot_interaction(z: torch.Tensor) -> torch.Tensor:
    """z: (B, F, D) fp32 -> (B, F*(F-1)//2) fp32 pairwise dots, packed.

    A CPU tensor takes the plain version (`ref.dot_interaction_ref`); a
    CUDA tensor launches the kernel, or raises."""
    if z.dim() != 3:
        raise ValueError(f"need z (B, F, D), got {tuple(z.shape)}")
    if z.device.type == "cpu":
        return ref.dot_interaction_ref(z)
    if z.device.type != "cuda":
        raise ValueError(f"dot_interaction: unsupported device {z.device}")
    if z.dtype != torch.float32:
        raise TypeError(f"dot_interaction kernel takes fp32, got {z.dtype}")
    if not z.is_contiguous():
        raise ValueError("dot_interaction kernel needs a contiguous z")
    b, f, d = z.shape
    if f * (d + 1) * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"dot_interaction kernel stages (F, D+1) fp32 in "
                         f"shared memory: F={f}, D={d} exceeds "
                         f"{MAX_SHARED_BYTES} bytes")
    out = torch.empty((b, f * (f - 1) // 2), dtype=torch.float32,
                      device=z.device)
    KERNEL.launch(z.data_ptr(), out.data_ptr(), b, f, d,
                  stream_handle(z.device))
    return out
