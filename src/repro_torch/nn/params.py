"""ParamSpec trees: declare each parameter's shape and init rule once, then
initialise the whole tree on a device from one seeded `torch.Generator`.

The init rules are the reference's (`normal`, `fan_in`, `zeros`); the random
numbers are torch's, not `jax.random`'s, so tests that compare the two
packages copy the reference's parameters across (`repro_torch.convert`).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.float32
    init: str = "fan_in"          # fan_in | normal | zeros
    scale: float = 1.0            # stddev multiplier
    fan_axis: int = -2            # which axis is fan-in for "fan_in" init


def _init_one(spec: ParamSpec, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        std = spec.scale
    elif spec.init == "fan_in":
        fan = spec.shape[spec.fan_axis] if spec.shape else 1
        std = spec.scale / math.sqrt(max(fan, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    # scale in place: a full-width mega table is tens of GB, a second
    # temporary of that size would not fit beside it
    out = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                      device=device).mul_(std)
    return out if spec.dtype == torch.float32 else out.to(spec.dtype)


def init_params(specs, seed: int, device: torch.device):
    """Initialise a tree (dicts / lists) of ParamSpec into tensors on
    `device`, drawing in tree order from one generator seeded `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def walk(node):
        if isinstance(node, ParamSpec):
            return _init_one(node, gen, device)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        raise TypeError(f"not a ParamSpec tree node: {type(node)}")

    return walk(specs)
