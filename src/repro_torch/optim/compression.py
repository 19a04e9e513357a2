"""Gradient compression for the slow (cross-pod) axis, with error feedback:
the reference's `repro.optim.compression` on torch tensors.

Compressing the inter-pod reduction to bf16 (or int8) halves (quarters)
the bytes on the slowest hop. Error feedback (Seide et al.; Karimireddy et
al. 2019) adds each step's quantization residual back before the next
compression, so the noise does not bias convergence.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.nn.params import tree_map


def compress_decompress(g: torch.Tensor,
                        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Straight-through quantize / dequantize of one gradient leaf. int8:
    scale max|g| / 127 + 1e-12 in fp32, round half to even (`torch.round`,
    as `jnp.round`), clip to [-127, 127]; any other dtype: a round trip
    through it (round to nearest even)."""
    if dtype == torch.int8:
        g32 = g.to(torch.float32)
        # a true division, as the reference's: CUDA multiplies by the
        # reciprocal of a Python-number divisor, which moves the scale by
        # an ulp; a tensor divisor keeps the division on every device
        scale = g32.abs().max() / torch.full((), 127.0, device=g.device) \
            + 1e-12
        q = torch.clamp(torch.round(g32 / scale), -127, 127)
        return (q * scale).to(g.dtype)
    return g.to(dtype).to(g.dtype)


def error_feedback_compress(grads: Any, residual: Any,
                            dtype: torch.dtype = torch.bfloat16
                            ) -> tuple[Any, Any]:
    """(compressed grads, new residual): each leaf's g + residual (fp32)
    compressed, and what compression lost of it. `residual` mirrors grads
    in fp32 (`init_residual`)."""
    corrected = tree_map(lambda g, r: g.to(torch.float32) + r, grads,
                         residual)
    cq = tree_map(lambda c: compress_decompress(c, dtype), corrected)
    comp = tree_map(lambda q, g: q.to(g.dtype), cq, grads)
    res = tree_map(lambda c, q: c - q.to(torch.float32), corrected, cq)
    return comp, res


def init_residual(grads: Any) -> Any:
    """fp32 zeros shaped like each leaf of `grads`, on its device."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
