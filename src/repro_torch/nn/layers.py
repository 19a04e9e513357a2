"""Dense layers of the DLRM towers. Weights keep the reference's (in, out)
layout, so `y = x @ w + b` matches `repro.nn.layers.linear`."""
from __future__ import annotations

import torch

from repro_torch.nn.params import ParamSpec


def linear_specs(d_in: int, d_out: int, bias: bool = False,
                 scale: float = 1.0) -> dict[str, ParamSpec]:
    """ParamSpecs of one (d_in, d_out) linear layer (+ zero bias)."""
    specs = {"w": ParamSpec((d_in, d_out), init="fan_in", scale=scale,
                            fan_axis=-2)}
    if bias:
        specs["b"] = ParamSpec((d_out,), init="zeros")
    return specs


def linear(p: dict[str, torch.Tensor], x: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x @ w (+ b), computed in `dtype`."""
    y = torch.matmul(x.to(dtype), p["w"].to(dtype))
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y
