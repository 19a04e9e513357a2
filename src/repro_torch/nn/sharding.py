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



# ---------------------------------------------------------------------------
# moving a rank's block between layouts, with gradients (the reference's
# with_sharding_constraint; here every move is an explicit collective of
# `launch.mesh`, booked in `Mesh.stats`)
# ---------------------------------------------------------------------------

#: weight logical axes that FSDP shards at rest and gathers at compute
#: (rules["_gather_axes"] overrides; ZERO_DP adds "expert")
GATHERED_AXES = ("embed",)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Sequence) -> dict[str, int]:
    """Each mesh axis a spec names, with the dimension it shards."""
    return {a: i for i, e in enumerate(spec) for a in _entry_axes(e)}


def batch_axes(rules: LogicalRules, mesh) -> tuple[str, ...]:
    """The mesh axes the batch dimension splits over under `rules`: along
    these each rank differentiates its own rows, so a replicated weight's
    cotangent there is a partial sum."""
    if mesh is None or not rules:
        return ()
    spec = _resolve(("batch",), rules, mesh.axis_names)
    return _entry_axes(spec[0]) if spec else ()


def global_shape(local_shape: Sequence[int], spec: Sequence, mesh
                 ) -> tuple[int, ...]:
    """The global shape whose block under `spec` has `local_shape`."""
    out = list(local_shape)
    for i, e in enumerate(spec):
        for a in _entry_axes(e):
            out[i] *= mesh.shape[a]
    return tuple(out)


def relayout(x: torch.Tensor, mesh, src: Sequence, dst: Sequence,
             partial: Sequence[str] = (),
             partial_grad: Sequence[str] = ()) -> torch.Tensor:
    """Move this rank's block `x` from layout `src` (a spec, plus the mesh
    axes over which x holds partial sums) to the spec `dst`, axis by axis:

      partial -> replicated    all_reduce (backward: identity)
      partial -> sharded       reduce_scatter (backward: all_gather)
      sharded -> replicated    all_gather (backward: reduce_scatter over
                               the axes in `partial_grad`, where the
                               result's cotangent is a partial sum; the
                               rank's slice over the others)
      replicated -> sharded    the rank's block (backward: all_gather)

    An axis that moves from one dimension to another is gathered, then
    taken. Gathers run before reductions, reductions before takes; over
    a dimension's several axes a gather runs minor axis first, a scatter
    or a take major axis first, as blocks are numbered."""
    from repro_torch.launch import mesh as M
    src_ax, dst_ax = spec_axes(src), spec_axes(dst)
    partial = tuple(partial)
    for a in partial:
        if a in src_ax:
            raise ValueError(f"axis {a!r} both shards and sums {src}")
    gathers = []
    for i, e in enumerate(src):
        axs = _entry_axes(e)
        kept = [a for a in axs if dst_ax.get(a) == i]
        if tuple(kept) != axs[:len(kept)]:
            raise ValueError(f"dimension {i}: {src} -> {dst} keeps a minor "
                             "axis and drops a major one")
        gathers += [(a, i) for a in axs[len(kept):]]
    for a, i in reversed(gathers):
        x = M.all_gather(x, mesh, (a,), i, partial_grad=a in partial_grad)
    for a in partial:
        if a not in dst_ax:
            x = M.reduce_from(x, mesh, (a,))
    for i, e in enumerate(dst):
        for a in _entry_axes(e):
            if a in partial:
                x = M.reduce_scatter(x, mesh, (a,), i)
            elif src_ax.get(a) != i:
                x = M.take_block(x, mesh, (a,), i)
    return x


def shard_activation(x: torch.Tensor, axes: Sequence[str | None],
                     rules: LogicalRules, mesh=None, src: Sequence = (),
                     partial: Sequence[str] = ()) -> torch.Tensor:
    """The reference's sharding constraint by logical axis names, as an
    explicit move: this rank's block `x`, laid out as `src` (a spec, plus
    the mesh axes in `partial` over which it holds partial sums), goes to
    the spec `resolve_sized(axes, rules, mesh, global shape)` gives (axes
    that do not divide their dimension drop out) by `relayout`'s
    collectives. Without a mesh, or with an empty table ("unmanaged", not
    "replicate everything"), `x` as it is."""
    if not rules or mesh is None:
        return x
    dst = resolve_sized(axes, rules, mesh, global_shape(x.shape, src, mesh))
    return relayout(x, mesh, src, dst, partial)


def gather_weight(w: torch.Tensor, axes: Sequence[str | None],
                  rules: LogicalRules, mesh=None,
                  shape: Sequence[int] | None = None) -> torch.Tensor:
    """Manual FSDP, the reference's `gather_weight`: a (compute-dtype)
    weight block, stored as `resolve_sized(axes, rules, mesh, shape)` lays
    it out (`shape` the global shape; by default the block's times every
    mesh axis its axes resolve to, which is right whenever they divide),
    goes to the spec with rules.get("_gather_axes", GATHERED_AXES)
    dropped: one all_gather a sharded mesh axis at each use (forward, and
    again in a rematted backward). Its backward reduce-scatters the
    gradient over the axes the batch splits over (`batch_axes`: each
    rank's cotangent is its rows' share) and slices it over any other.
    Enabled by rules["_gather_weights"]; a no-op otherwise, and without a
    mesh."""
    if not rules or not rules.get("_gather_weights") or mesh is None:
        return w
    gathered = rules.get("_gather_axes", GATHERED_AXES)
    g_axes = tuple(None if a in gathered else a for a in axes)
    return replicate_weight(w, axes, rules, mesh, shape, keep=g_axes)


def use_spec(axes: Sequence[str | None], rules: LogicalRules, mesh,
             shape: Sequence[int]) -> tuple:
    """The spec of a weight of global `shape` as `gather_weight` hands it
    out: its storage spec, or under rules["_gather_weights"] the spec
    with the gathered axes dropped (`()` without a mesh)."""
    if mesh is None or not rules:
        return ()
    if rules.get("_gather_weights"):
        gathered = rules.get("_gather_axes", GATHERED_AXES)
        axes = tuple(None if a in gathered else a for a in axes)
    return resolve_sized(axes, rules, mesh, shape)


def dim_axes(spec: Sequence, dim: int) -> tuple[str, ...]:
    """The mesh axes a spec shards dimension `dim` over (none past its
    end)."""
    return _entry_axes(spec[dim]) if dim < len(spec) else ()


def storage_spec(w: torch.Tensor, axes: Sequence[str | None],
                 rules: LogicalRules, mesh,
                 shape: Sequence[int] | None = None
                 ) -> tuple[tuple, tuple[int, ...]]:
    """(spec, global shape) of a stored weight block `w`: `shape` given,
    or the block's shape times every mesh axis its axes resolve to."""
    if shape is None:
        shape = global_shape(w.shape, _resolve(axes, rules,
                                               mesh.axis_names), mesh)
    spec = resolve_sized(axes, rules, mesh, shape)
    want = NamedSharding(mesh, spec).local_shape(shape)
    if tuple(w.shape) != want:
        raise ValueError(f"a block of {tuple(w.shape)} is not the {spec} "
                         f"block {want} of {tuple(shape)}")
    return spec, tuple(shape)


def replicate_weight(w: torch.Tensor, axes: Sequence[str | None],
                     rules: LogicalRules, mesh,
                     shape: Sequence[int] | None = None,
                     keep: Sequence[str | None] | None = None
                     ) -> torch.Tensor:
    """A weight block stored under `resolve_sized(axes)` (see
    `storage_spec`), moved to the spec of the logical axes `keep`
    (default none: the whole weight on every rank). The gradient is
    reduce-scattered over the batch's axes and sliced over the rest, as
    `gather_weight`'s."""
    if mesh is None:
        return w
    src, shape = storage_spec(w, axes, rules, mesh, shape)
    dst = () if keep is None else resolve_sized(keep, rules, mesh, shape)
    return relayout(w, mesh, src, dst, partial_grad=batch_axes(rules, mesh))


def tp_axes(name: str, size: int, rules: LogicalRules, mesh
            ) -> tuple[str, ...]:
    """The mesh axes a dimension of `size` named `name` shards over (none
    without a mesh, or where they do not divide it): a tensor-parallel
    layer splits its work over these. Refuses axes the batch splits over
    too: a rank would then hold neither whole rows nor a whole sum."""
    if mesh is None or not rules:
        return ()
    spec = resolve_sized((name,), rules, mesh, (size,))
    out = _entry_axes(spec[0]) if spec else ()
    clash = set(out) & set(batch_axes(rules, mesh))
    if clash:
        raise ValueError(f"{name!r} and the batch both shard over "
                         f"{sorted(clash)}")
    return out


def block_range(size: int, axes: Sequence[str], mesh) -> tuple[int, int]:
    """[lo, hi) of this rank's block of a dimension of `size` split over
    `axes` (whole without axes)."""
    n, k = 1, 0
    for a in axes:
        n, k = n * mesh.shape[a], k * mesh.shape[a] + mesh.coords[a]
    step = size // n
    return k * step, (k + 1) * step
