"""Dense optimizers (the embedding rows use the fused sparse backward).

Functional and optax-shaped, like the reference's:
  opt = adagrad(lr=...); state = opt.init(params)
  new_params, new_state = opt.apply(params, grads, state, step)

The paper's production split (section IV, Fig. 4): MLP ("dense") parameters
with AdaGrad or SGD, embedding rows with row-wise AdaGrad. State mirrors the
parameter tree leaf for leaf. `torch.optim.Adagrad` is not a substitute: it
divides by sqrt(s) + eps, where the reference multiplies by rsqrt(s + eps).
`adamw` is the LM zoo's optimizer; it updates in place (see its docstring).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import torch

from repro_torch.nn.params import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Any], Any]
    apply: Callable[[Any, Any, Any, int], tuple[Any, Any]]
    name: str = "opt"


def clip_by_global_norm(grads, max_norm: float, sq_sum=None):
    """Returns (clipped_grads, pre_clip_norm): every gradient times
    min(1, max_norm / max(norm, 1e-12)), where norm is the fp32 L2 norm over
    all leaves (the leaves' sums of squares added in tree order, as the
    reference's `sum`; or `sq_sum(grads)`, a sharded step's sum over every
    rank's blocks). The product is taken in fp32 and cast back to each
    gradient's dtype, as the reference's promotion does."""
    if sq_sum is not None:
        norm = torch.sqrt(sq_sum(grads))
    else:
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    """Plain SGD, or heavy-ball momentum when `momentum` > 0."""
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def apply(params, grads, state, step, sq_sum=None):
        del step, sq_sum                  # no clipping: nothing to sum
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
    def apply(params, grads, state, step, sq_sum=None):
        del step, sq_sum                  # no clipping: nothing to sum
        new_state = tree_map(lambda s, g: s + torch.square(g.float()),
                             state, grads)
        new = tree_map(
            lambda p, g, s: (p.float() - lr * g.float()
                             * torch.rsqrt(s + eps)).to(p.dtype),
            params, grads, new_state)
        return new, new_state

    return Optimizer(init, apply, "adagrad")


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0,
          clip_norm: float | None = 1.0) -> Optimizer:
    """AdamW with decoupled weight decay and optional global-norm clipping
    (`clip_norm=None` skips it), fp32 moments whatever the parameter's
    dtype; state {"m", "v"}. The reference's operand order: t = step + 1
    in fp32, c1 = 1 - b1**t, c2 = 1 - b2**t (fp32), m' = b1 m + (1 - b1) g,
    v' = b2 v + (1 - b2) g^2, u = (m' / c1) * rsqrt(v' / c2 + eps), plus
    weight_decay * p when it is set, then p - lr * u.

    Not `torch.optim.AdamW`, whose update divides by sqrt(v_hat) + eps and
    decays the parameter before the step. `apply` updates the parameters
    and both moments IN PLACE and returns the same trees (the reference
    returns new ones): at full width a second copy of each would not fit
    the card. Clipped gradients are new tensors; the caller's are left.
    A sharded step passes `sq_sum` (see `clip_by_global_norm`)."""
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}

    def bias_correction(b: float, t: torch.Tensor) -> float:
        # 1 - b**t in fp32, as a Python float that rounds back exactly
        return float(1.0 - torch.pow(torch.tensor(b, dtype=torch.float32), t))

    @torch.no_grad()
    def apply(params, grads, state, step, sq_sum=None):
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm, sq_sum)
        t = torch.tensor(float(step), dtype=torch.float32) + 1.0
        c1, c2 = bias_correction(b1, t), bias_correction(b2, t)

        def upd(p, g, m, v):
            g = g.float()
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            u = (m / c1).mul_(torch.rsqrt((v / c2).add_(eps)))
            if weight_decay:
                u.add_(p.float() * weight_decay)
            if p.dtype == torch.float32:
                p.sub_(u.mul_(lr))
            else:
                p.copy_((p.float() - u.mul_(lr)).to(p.dtype))

        tree_map(upd, params, grads, state["m"], state["v"])
        return params, state

    return Optimizer(init, apply, "adamw")
