"""Elastic-Averaging SGD (Zhang et al. 2015) and local-SGD synchronization,
the paper's gradient-sync methods (section III-A.6), the reference's
`repro.optim.easgd` on torch tensors.

Each pod is one EASGD trainer (replica). The stacked form holds every
replica as a leading `replica` axis (leaves (R, ...)); the elastic pull
runs round-synchronously every tau steps:

    x_i <- x_i - alpha * (x_i - c)
    c   <- c + beta * (mean_i x_i - c)        (the mean in fp32)

and `local_sgd_sync` (the alpha = 1 limit with center == mean) collapses
the replicas to their mean. Cross-pod traffic happens only at a sync.

The pod form runs one replica a rank over a mesh's `pod` axis
(`launch.mesh.Mesh`): a rank's replica leaves are its block of the
stacked ones, (1, ...) (`nn.sharding.NamedSharding(mesh, ("pod",))`), and
the mean is one `Mesh.all_reduce` over the axis of an fp32 copy, divided
by R. At R = 2 a sum of two terms does not depend on its order, so the
pod form equals the stacked one bit for bit.

Trees are dicts and lists of tensors (`nn.params.tree_map`); the
functions return new tensors and leave their inputs alone.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.nn.params import tree_map


class EASGDState(NamedTuple):
    replicas: Any    # tree, each leaf (R, ...), or (1, ...) under a mesh
    center: Any      # tree, each leaf (...): the center variable


def easgd_init(params, n_replicas: int, sharding=None) -> EASGDState:
    """R copies of `params` as the replicas, `params` as the center. With
    `sharding` (a NamedSharding over the pod axis, spec ("pod",)) the
    replicas are this rank's block of the stacked copies."""
    def stack(p):
        out = p.unsqueeze(0).expand((n_replicas,) + tuple(p.shape)).clone()
        return out if sharding is None else sharding.shard(out).clone()
    return EASGDState(tree_map(stack, params), params)


def _mean(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The fp32 mean over replicas: of the stacked leaf's leading axis, or
    over `mesh`'s `axis` of each rank's (1, ...) replica."""
    if mesh is None:
        return torch.mean(x.to(torch.float32), dim=0)
    total = mesh.all_reduce(x[0].to(torch.float32, copy=True), axis)
    return total / mesh.size(axis)


def easgd_sync(state: EASGDState, alpha: float, beta: float, mesh=None,
               axis: str = "pod") -> EASGDState:
    """One elastic-averaging round (every tau local steps); with `mesh`,
    the pod form (see the module docstring)."""
    def pull(x, c):
        return x - alpha * (x - c.unsqueeze(0).to(x.dtype))

    def push(c, x):
        c32 = c.to(torch.float32)
        return (c32 + beta * (_mean(x, mesh, axis) - c32)).to(c.dtype)

    return EASGDState(tree_map(pull, state.replicas, state.center),
                      tree_map(push, state.center, state.replicas))


def local_sgd_sync(state: EASGDState, mesh=None,
                   axis: str = "pod") -> EASGDState:
    """ShadowSync / local-SGD limit: the replicas collapse to their mean;
    with `mesh`, the pod form."""
    def avg(x):
        mean = _mean(x, mesh, axis).to(x.dtype)
        return mean.unsqueeze(0).expand(x.shape).clone()

    replicas = tree_map(avg, state.replicas)
    return EASGDState(replicas, tree_map(lambda x: x[0].clone(), replicas))


def replica_step(state: EASGDState, grads_stacked, lr: float) -> EASGDState:
    """Per-replica SGD step; grads_stacked leaves (R, ...), or this rank's
    (1, ...) under a mesh."""
    return EASGDState(tree_map(lambda x, g: x - lr * g.to(x.dtype),
                               state.replicas, grads_stacked),
                      state.center)
