"""Logical-axis -> mesh-axis sharding rules, and where a rank's piece of a
global array lies.

Params and activations carry logical axis names ("vocab", "heads", "ff",
"batch", ...). A rules table maps each logical name to a mesh axis, a
tuple of mesh axes, or None (replicated). Within one spec a mesh axis is
used at most once: a later logical axis that would reuse a consumed mesh
axis degrades to replicated. The tables and the resolvers are the
reference's (`repro.nn.sharding`); a spec is a plain tuple, one entry per
dimension (a mesh axis name, a tuple of names, or None), trailing Nones
trimmed, as `core.placement.PlacementPlan.pspec` holds one.

`NamedSharding(mesh, spec)` reads a spec against a `launch.mesh.Mesh`: a
dimension sharded over axes (a0, a1, ...) splits into prod(sizes) equal
blocks, and a rank holds block number ((c0 * s1) + c1) ... of its
coordinates, row-major as the mesh lays its ranks out. `local_shape`,
`local_slice` and `shard` give that block; `gather` puts the whole array
back together on every rank.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch

MeshAxes = None | str | tuple[str, ...]
LogicalRules = dict[str, MeshAxes]

# ---------------------------------------------------------------------------
# The rule tables. "pod" exists only on a multi-pod mesh: rules are filtered
# against the mesh's axis names when they resolve, so one table serves both.
# ---------------------------------------------------------------------------

#: Training rules: data-parallel batch, tensor-parallel heads / ff / vocab /
#: expert; the `data` axis is the paper's trainers, `model` its sparse
#: parameter-server shards.
TRAIN_RULES: LogicalRules = {
    "batch": ("pod", "data"),
    "seq": None,
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "expert": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv_dim": "model",
    "layer": None,
    # DLRM logical axes
    "hash": "model",        # row-wise embedding-table sharding
    "table": None,          # table-wise is the placement planner's
    "feature": None,
    "dense_ff": "model",
    # activations
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_embed": None,
    "act_vocab": "model",
    "act_heads": "model",
    "act_ff": "model",
    # MoE dispatch tiles: (group, expert, capacity)
    "act_tokens": ("pod", "data"),
    "act_expert": "model",
    "moe_groups": ("pod", "data"),
    "moe_cap": None,
}

#: FSDP (ZeRO-3) and sequence parallelism: weights, gradients and
#: optimizer state shard over `data` on the non-TP dim and are gathered
#: at compute.
FSDP_RULES: LogicalRules = dict(
    TRAIN_RULES,
    embed=("data",),
    head_dim=None,
    ssm_state=None,
    _gather_weights=True,
)

#: Pure data parallelism over every mesh axis with ZeRO-3 weight sharding:
#: no tensor parallelism, so no per-layer activation all-reduce; experts
#: sharded at rest and gathered at compute.
ZERO_DP_RULES: LogicalRules = dict(
    TRAIN_RULES,
    batch=("pod", "data", "model"),
    act_batch=("pod", "data", "model"),
    act_tokens=("pod", "data", "model"),
    moe_groups=("pod", "data", "model"),
    heads=None, kv_heads=None, ff=None, vocab=None,
    ssm_inner=None, ssm_heads=None, conv_dim=None,
    act_vocab=None, act_heads=None, act_ff=None, act_expert=None,
    expert=("model",),
    embed=("data", "model"),
    _gather_weights=True,
    _gather_axes=("embed", "expert"),
)

#: Serving rules: tensor parallelism over `model`, batch over `data`; a
#: heads dim that `model` does not divide (qwen's 40) migrates its axis to
#: head_dim (`resolve_sized`'s fallback).
SERVE_RULES: LogicalRules = dict(
    TRAIN_RULES,
    batch=("pod", "data"),
    act_batch=("pod", "data"),
    embed=None,
    cache_seq=None,
    cache_kv="model",
    _fallback={"heads": "head_dim", "kv_heads": "head_dim"},
)

#: Long-context decode (a batch of 1 cannot fill `data`): the cache's
#: sequence dim shards over `model`; batch and token dims replicated.
LONG_SERVE_RULES: LogicalRules = dict(
    SERVE_RULES,
    cache_seq="model",
    cache_kv=None,
    batch=None,
    act_batch=None,
    act_tokens=None,
    moe_groups=None,
)


def _trim(out: list) -> tuple:
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _resolve(axes: Sequence[str | None], rules: LogicalRules,
             mesh_axis_names: Sequence[str]) -> tuple:
    """Map logical axis names to a spec tuple, dropping conflicts."""
    used: set = set()
    out = []
    for name in axes:
        target = None if name is None else rules.get(name, None)
        if target is None:
            out.append(None)
            continue
        if isinstance(target, str):
            target = (target,)
        picked = tuple(t for t in target
                       if t in mesh_axis_names and t not in used)
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(picked)
    return _trim(out)


def logical_to_pspec(axes: Sequence[str | None], rules: LogicalRules,
                     mesh=None) -> tuple:
    """`_resolve` against `mesh`'s axis names; without a mesh nothing is
    sharded (the reference's answer outside a mesh context)."""
    names = tuple(mesh.axis_names) if mesh is not None else ()
    return _resolve(axes, rules, names)


def resolve_sized(axes: Sequence[str | None], rules: LogicalRules, mesh,
                  shape: Sequence[int]) -> tuple:
    """`_resolve`, then drop the mesh axes that do not divide their
    dimension (qwen's 40 kv heads over 16). A dropped axis may migrate to a
    sibling dim through rules["_fallback"] (heads -> head_dim: qwen's wq
    (d, 40, 128) becomes ("data", None, "model")). `mesh` needs
    `axis_names` and a `shape` mapping each axis to its size."""
    base = _resolve(axes, rules, mesh.axis_names)
    out = []
    dropped = []                       # (mesh_axis, source_logical_name)
    for i, dim in enumerate(shape):
        entry = base[i] if i < len(base) else None
        if entry is None:
            out.append(None)
            continue
        cand = entry if isinstance(entry, tuple) else (entry,)
        kept, prod = [], 1
        for a in cand:
            size = mesh.shape[a]
            if dim % (prod * size) == 0:
                kept.append(a)
                prod *= size
            elif i < len(axes):
                dropped.append((a, axes[i]))
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    fallbacks = rules.get("_fallback") or {}
    if dropped and fallbacks:
        used = {a for e in out if e
                for a in (e if isinstance(e, tuple) else (e,))}
        for mesh_ax, src in dropped:
            tgt = fallbacks.get(src)
            if tgt is None or mesh_ax in used:
                continue
            for j, lname in enumerate(axes):
                if (lname == tgt and j < len(shape) and out[j] is None
                        and shape[j] % mesh.shape[mesh_ax] == 0):
                    out[j] = mesh_ax
                    used.add(mesh_ax)
                    break
    return _trim(out)


class NamedSharding:
    """A spec tuple read against a `launch.mesh.Mesh` (`axis_names`,
    `shape` and this rank's `coords`): which block of a global array this
    rank holds. Dimensions past the spec's length are whole."""

    def __init__(self, mesh, spec: Sequence):
        self.mesh = mesh
        self.spec = tuple(spec)
        for entry in self.spec:
            for a in self._axes(entry):
                if a not in mesh.shape:
                    raise ValueError(f"spec {self.spec} names axis {a!r}; "
                                     f"the mesh has {tuple(mesh.axis_names)}")

    @staticmethod
    def _axes(entry) -> tuple:
        if entry is None:
            return ()
        return entry if isinstance(entry, tuple) else (entry,)

    def _blocks(self, shape: Sequence[int]) -> list[tuple[int, int]]:
        """(block count, this rank's block) of each dimension."""
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than the "
                             f"array's {len(shape)} dimensions")
        out = []
        for i, dim in enumerate(shape):
            n, k = 1, 0
            for a in self._axes(self.spec[i] if i < len(self.spec)
                                else None):
                n, k = n * self.mesh.shape[a], k * self.mesh.shape[a] \
                    + self.mesh.coords[a]
            if dim % n:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                                 f"split into {n} blocks (spec {self.spec})")
            out.append((n, k))
        return out

    def local_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of this rank's block of a global `shape`."""
        return tuple(dim // n for dim, (n, _) in zip(shape,
                                                     self._blocks(shape)))

    def local_slice(self, shape: Sequence[int]) -> tuple[slice, ...]:
        """This rank's block of a global `shape`, one slice a dimension."""
        out = []
        for dim, (n, k) in zip(shape, self._blocks(shape)):
            size = dim // n
            out.append(slice(k * size, (k + 1) * size))
        return tuple(out)

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor `t`: a view, no copy."""
        return t[self.local_slice(t.shape)]

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's block (`local`), on every
        rank: one `Mesh.all_gather_rows` a sharded dimension, blocks put
        together by copy in coordinate order."""
        out = local
        for i in reversed(range(len(self.spec))):
            for a in reversed(self._axes(self.spec[i])):
                moved = out.movedim(i, 0).contiguous()
                out = self.mesh.all_gather_rows(moved, a).movedim(0, i)
        return out.contiguous()

    def __repr__(self) -> str:
        return (f"NamedSharding({dict(self.mesh.shape)}, spec={self.spec})")

