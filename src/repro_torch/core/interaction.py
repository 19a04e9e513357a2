"""Feature interaction (paper section III-A.3): concat or pairwise dot.

`dot`: stack the bottom-MLP output with the pooled sparse embeddings into
Z (B, F+1, d), take all strictly-lower-triangle pairwise dot products
(through the hand-written dot-interaction kernel on the card), and
concatenate them with the bottom output — exactly DLRM's interaction.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def interact(bottom_out: torch.Tensor, pooled: torch.Tensor,
             kind: str) -> torch.Tensor:
    """bottom_out: (B, d); pooled: (B, F, d). Returns the top-MLP input."""
    if kind == "cat":
        b = pooled.shape[0]
        return torch.cat([bottom_out, pooled.reshape(b, -1)], dim=-1)
    if kind == "dot":
        z = torch.cat([bottom_out[:, None, :], pooled], dim=1)
        tri = ops.dot_interaction(z.contiguous())
        return torch.cat([bottom_out, tri.to(bottom_out.dtype)], dim=-1)
    raise ValueError(f"unknown interaction {kind!r}")


def interaction_dim(n_sparse: int, embed_dim: int, kind: str) -> int:
    """Width of the top-MLP input."""
    f = n_sparse + 1
    if kind == "cat":
        return embed_dim + n_sparse * embed_dim
    return embed_dim + f * (f - 1) // 2
