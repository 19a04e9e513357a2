"""Copy the reference package's DLRM parameters into the port.

`jax.random` cannot be replayed by torch, so a test that runs both packages
initialises the reference, converts its parameter tree to numpy, and hands
that tree to `params_from_jax`. Nothing here imports jax: the caller does
the `np.asarray` conversion.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True)).to(device)


def params_from_jax(tree: dict, device: str | torch.device = "cpu") -> dict:
    """Map the reference's `{"bottom": [{w, b}, ...], "top": [...],
    "emb": {"mega": ...}}` tree (numpy leaves, or anything `np.array`
    accepts) to the port's tree of the same layout with fp32 tensors on
    `device`. Weights stay (in, out), as the port's `linear` expects."""
    def mlp(layers):
        return [{k: _tensor(v, device) for k, v in layer.items()}
                for layer in layers]

    out = {"bottom": mlp(tree["bottom"]), "top": mlp(tree["top"])}
    if tree.get("emb") is not None:
        out["emb"] = {"mega": _tensor(tree["emb"]["mega"], device)}
    return out
