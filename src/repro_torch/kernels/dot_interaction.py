"""Dot-interaction kernel wrapper (CUDA C++, `csrc/dot_interaction.cu`).

Port of the TPU kernel `repro/kernels/dot_interaction.py::
dot_interaction_kernel`: per example, the strictly-lower triangle of
Z Z^T over the stacked (F, D) features, fp32. Unlike the TPU kernel it
packs the triangle itself, in np.tril_indices(F, -1) order, and needs no
sublane/lane padding of F and D. On a meta tensor it checks and allocates
as on the card, launches nothing and books its cost (`kernels.meta`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import meta as kmeta
from repro_torch.kernels import ref
from repro_torch.kernels._build import Kernel, stream_handle

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
KERNEL = Kernel("dot_interaction", "dot_interaction_launch",
                [_P, _P, _I64, _I64, _I64, _P])
#: a block stages whole examples' (F, D) slabs in shared memory, F padded
#: up to the tile size and rows to `row_stride(D)` floats; above the 48 KB
#: a launch gets without an opt-in the kernel would be refused
MAX_SHARED_BYTES = 48 * 1024


def row_stride(d: int) -> int:
    """Floats a staged row takes in shared memory (`csrc/dot_interaction.cu`,
    `row_stride`): an odd number of 16-byte chunks when D % 4 == 0, an odd
    number of words otherwise, so consecutive rows start on other banks."""
    return 4 * ((d // 4) | 1) if d % 4 == 0 else d | 1


def example_bytes(f: int, d: int) -> int:
    """Shared memory one example takes at the largest tile size (4)."""
    return -(-f // 4) * 4 * row_stride(d) * 4


def dot_interaction(z: torch.Tensor) -> torch.Tensor:
    """z: (B, F, D) fp32 -> (B, F*(F-1)//2) fp32 pairwise dots, packed.

    A CPU tensor takes the plain version (`ref.dot_interaction_ref`); a
    CUDA tensor launches the kernel, or raises; a meta tensor is checked
    and allocated as a CUDA one and books the kernel's cost. The kernel's
    part is a few
    microseconds, so this path keeps its host work to direct checks, one
    allocation and the launch."""
    if z.dim() != 3:
        raise ValueError(f"need z (B, F, D), got {tuple(z.shape)}")
    if z.is_cpu:
        return ref.dot_interaction_ref(z)
    check_dot(z)
    b, f, d = z.shape
    out = z.new_empty((b, f * (f - 1) // 2))
    if z.is_meta:
        kmeta.book("dot_interaction", *kmeta.dot_interaction_cost(b, f, d))
        return out
    KERNEL.launch(z.data_ptr(), out.data_ptr(), b, f, d,
                  stream_handle(z.get_device()))
    return out


def check_dot(z: torch.Tensor) -> None:
    """`dot_interaction`'s guard: device, dtype, contiguity, and one
    example's staged rows within the shared memory a block gets."""
    _, f, d = z.shape
    if ((z.is_cuda or z.is_meta) and z.dtype == torch.float32
            and z.is_contiguous() and example_bytes(f, d) <= MAX_SHARED_BYTES):
        return
    if not (z.is_cuda or z.is_meta):
        raise ValueError(f"dot_interaction: unsupported device {z.device}")
    if z.dtype != torch.float32:
        raise TypeError(f"dot_interaction kernel takes fp32, got {z.dtype}")
    if not z.is_contiguous():
        raise ValueError("dot_interaction kernel needs a contiguous z")
    raise ValueError(f"dot_interaction kernel stages an example's rows in "
                     f"shared memory: F={f}, D={d} needs "
                     f"{example_bytes(f, d)}, which exceeds "
                     f"{MAX_SHARED_BYTES} bytes")
