"""Copy the reference package's DLRM parameters and optimizer state, and
its LM parameters, into the port.

`jax.random` cannot be replayed by torch, so a test that runs both packages
initialises the reference, converts its trees to numpy, and hands them to
`params_from_jax` / `state_from_jax`. Nothing here imports jax: the caller
does the `np.asarray` conversion. Like every entry point of the port, both
put the tensors on the card unless `device="cpu"` is given.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.nn.params import tree_map


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32, copy=True)).to(device)


def params_from_jax(tree: dict,
                    device: str | torch.device | None = None) -> dict:
    """Map the reference's `{"bottom": [{w, b}, ...], "top": [...],
    "emb": {"mega": ...}}` tree (numpy leaves, or anything `np.array`
    accepts) to the port's tree of the same layout with fp32 tensors on
    `device` (default cuda; raises without it). Weights stay (in, out), as
    the port's `linear` expects."""
    dev = resolve_device(device)
    out = {"bottom": tree_map(lambda x: _tensor(x, dev), tree["bottom"]),
           "top": tree_map(lambda x: _tensor(x, dev), tree["top"])}
    if tree.get("emb") is not None:
        out["emb"] = {"mega": _tensor(tree["emb"]["mega"], dev)}
    return out


def state_from_jax(tree: dict,
                   device: str | torch.device | None = None) -> dict:
    """Map the reference DLRM step's optimizer state `{"dense": <dense
    optimizer state tree>, "accum": (rows,)}` to the port's
    (`train.steps.dlrm_init_state` layout) on `device` (default cuda), so a
    reference run can be continued in the port part-way through."""
    dev = resolve_device(device)
    return {"dense": tree_map(lambda x: _tensor(x, dev), tree["dense"]),
            "accum": _tensor(tree["accum"], dev)}


def lm_params_from_jax(tree: dict,
                       device: str | torch.device | None = None) -> dict:
    """Map the reference's LM parameter tree (`lm_param_specs` layout: the
    blocks stacked along a leading n_units axis; numpy leaves) to the
    port's, the same layout with fp32 tensors on `device` (default cuda;
    raises without it)."""
    dev = resolve_device(device)
    return tree_map(lambda x: _tensor(x, dev), tree)
