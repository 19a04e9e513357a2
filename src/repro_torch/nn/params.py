"""ParamSpec trees: declare each parameter's shape, logical axes and init
rule once, then initialise the whole tree on a device from one seeded
`torch.Generator`, place it on a mesh by a rule table
(`specs_to_pspecs`, `specs_to_shardings`), or lay it out on the meta
device without memory (`abstract_params`).

The init rules are the reference's (`normal`, `fan_in`, `zeros`, `ones`,
`constant`); the random numbers are torch's, not `jax.random`'s, so tests
that compare the two packages copy the reference's parameters across
(`repro_torch.convert`).
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor: one logical axis
    name (or None) a dimension, as the reference's."""
    shape: tuple[int, ...]
    logical_axes: tuple[str | None, ...]
    dtype: torch.dtype = torch.float32
    init: str = "fan_in"          # fan_in | normal | zeros | ones | constant
    scale: float = 1.0            # stddev multiplier / constant value
    fan_axis: int = -2            # which axis is fan-in for "fan_in" init

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} vs axes "
                             f"{self.logical_axes}")


def _init_one(spec: ParamSpec, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "constant":
        return torch.full(spec.shape, spec.scale, dtype=spec.dtype,
                          device=device)
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


def tree_map(fn, tree, *rest):
    """Apply `fn` leaf by leaf over trees of one layout (dicts, lists,
    tuples), the counterpart of `jax.tree.map` for parameter trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree, in `tree_map` order."""
    out = []
    tree_map(out.append, tree)
    return out


def init_params(specs, seed: int, device: torch.device):
    """Initialise a tree (dicts / lists) of ParamSpec into tensors on
    `device`, drawing in tree order from one generator seeded `seed`. On
    the meta device there is nothing to draw: the tree's shapes and
    dtypes (`abstract_params`)."""
    if torch.device(device).type == "meta":
        return abstract_params(specs)
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


def abstract_params(specs):
    """The tree's tensors on the meta device: shapes and dtypes, no
    memory (the counterpart of the reference's ShapeDtypeStruct tree)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def specs_to_pspecs(specs, rules, mesh_axis_names=None, mesh=None):
    """Spec tuples for a ParamSpec tree (`nn.sharding`'s form). With
    `mesh` (anything with `axis_names` and a `shape` mapping) the
    resolution is size-aware: mesh axes that do not divide their dimension
    drop out (`resolve_sized`); else `mesh_axis_names` filters the rules."""
    from repro_torch.nn.sharding import _resolve, resolve_sized
    if mesh is not None:
        return tree_map(lambda s: resolve_sized(s.logical_axes, rules, mesh,
                                                s.shape), specs)
    return tree_map(lambda s: _resolve(s.logical_axes, rules,
                                       tuple(mesh_axis_names or ())), specs)


def specs_to_shardings(specs, rules, mesh):
    """A `nn.sharding.NamedSharding` a leaf: where each rank's block of
    each parameter lies on `mesh` (a `launch.mesh.Mesh`)."""
    from repro_torch.nn.sharding import NamedSharding, resolve_sized
    return tree_map(lambda s: NamedSharding(
        mesh, resolve_sized(s.logical_axes, rules, mesh, s.shape)), specs)


def stack_specs(specs, n: int, axis_name: str = "layer"):
    """Prepend a stacked-layer axis of size n, named `axis_name`, to every
    spec (the layers of a model are one tensor per parameter, sliced per
    unit). fan_axis moves as the reference's `stack_specs` moves it: a
    non-negative axis shifts up by one, and a negative one down by one, so
    a default fan_axis of -2 then names the axis before it (the
    reference's init, kept as it is)."""
    return tree_map(
        lambda s: dataclasses.replace(
            s, shape=(n,) + s.shape,
            logical_axes=(axis_name,) + tuple(s.logical_axes),
            fan_axis=s.fan_axis - 1 if s.fan_axis < 0 else s.fan_axis + 1),
        specs)


def cast_specs(specs, dtype: torch.dtype):
    """The tree with every floating-point spec's dtype replaced by
    `dtype` (bf16 serving weights); other specs as they are."""
    return tree_map(lambda s: dataclasses.replace(s, dtype=dtype)
                    if s.dtype.is_floating_point else s, specs)


def param_count(specs) -> int:
    """Number of scalars in a ParamSpec tree."""
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


def param_bytes(specs) -> int:
    """Bytes of a ParamSpec tree's tensors at their dtypes."""
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in tree_leaves(specs))
