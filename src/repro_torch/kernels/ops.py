"""Public kernel ops of the port, named after `repro.kernels.ops`.

Dispatch is by the tensor's device, not by a flag: a CPU tensor takes the
plain PyTorch version, a CUDA tensor the hand-written kernel (or an error).
The TPU-only layout work of the reference wrappers — padding D to the
128-lane width and F to the 8-row sublane — has no counterpart. Only the
forward is ported: serving needs no gradient, and the backward kernels
(the bag scatter-add and the symmetric `s_bar @ z`) come with training.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dot_interaction as _dot
from repro_torch.kernels import embedding_bag as _bag


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """Pooled multi-hot lookup. table: (H, D); indices: (B, L) int32, -1
    pads. Returns (B, D)."""
    return _bag.embedding_bag(table, indices, mode)


def dot_interaction(z: torch.Tensor) -> torch.Tensor:
    """z: (B, F, D) -> (B, F*(F-1)//2) strict-lower-triangle pairwise dots."""
    return _dot.dot_interaction(z)
