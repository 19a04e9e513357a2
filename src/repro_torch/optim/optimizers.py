"""Dense optimizers (the embedding rows use the fused sparse backward).

Functional and optax-shaped, like the reference's:
  opt = adagrad(lr=...); state = opt.init(params)
  new_params, new_state = opt.apply(params, grads, state, step)

The paper's production split (section IV, Fig. 4): MLP ("dense") parameters
with AdaGrad or SGD, embedding rows with row-wise AdaGrad. State mirrors the
parameter tree leaf for leaf. `torch.optim.Adagrad` is not a substitute: it
divides by sqrt(s) + eps, where the reference multiplies by rsqrt(s + eps).
`adamw` is the LM zoo's and comes with it.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import torch

from repro_torch.nn.params import tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    apply: Callable[[Any, Any, Any, int], tuple[Any, Any]]
    name: str = "opt"


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """Plain SGD, or heavy-ball momentum when `momentum` > 0."""
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def apply(params, grads, state, step):
        del step
        if momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g.to(p.dtype),
                            params, grads), state
        new_state = tree_map(lambda m, g: momentum * m + g.to(m.dtype),
                             state, grads)
        return tree_map(lambda p, m: p - lr * m.to(p.dtype), params,
                        new_state), new_state

    return Optimizer(init, apply, "sgd")


def adagrad(lr: float, eps: float = 1e-8) -> Optimizer:
    """Dense AdaGrad, the paper's dense-PS optimizer:
    s += g^2;  p -= lr * g * rsqrt(s + eps)."""
    def init(params):
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)

    @torch.no_grad()
    def apply(params, grads, state, step):
        del step
        new_state = tree_map(lambda s, g: s + torch.square(g.float()),
                             state, grads)
        new = tree_map(
            lambda p, g, s: (p.float() - lr * g.float()
                             * torch.rsqrt(s + eps)).to(p.dtype),
            params, grads, new_state)
        return new, new_state

    return Optimizer(init, apply, "adagrad")
