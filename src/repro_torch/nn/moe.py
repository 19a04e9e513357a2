"""Token-choice top-k Mixture-of-Experts with grouped dispatch, the port
of the reference's `nn/moe.py` as torch ops (no kernel lies under it in
the reference either).

Tokens split into `moe_groups` groups; capacity, the position of each
(token, slot) within its expert, the gather table and the combine all stay
group-local. Experts are embedding tables in the paper's terms: the router
is a multi-hot lookup, and the per-group capacity is the truncation bound
on lookups. Whatever passes capacity is dropped.

With a mesh (training and serving), the groups split over the batch's
mesh axes (a rank's groups are the global reshape's: with its rows,
group i is tokens [i tg, (i + 1) tg) of the flattened (b, s)), so
moe_groups must split over them; a serving step with fewer groups than
the batch's ranks gathers the batch and routes it whole on every rank,
as GSPMD does with a group dimension it cannot split. Under tables that shard the experts at compute (TRAIN, FSDP:
`expert` on `model`), every rank of a `model` line routes its groups the
same way, dispatches to and runs only its own experts, and one all_reduce
over `model` adds the partial combines; under ZERO_DP the experts are
gathered and the dispatch is the rank's own. The Switch aux loss is taken
from the global means: the sums of the router's probabilities and of the
routed counts are all-reduced over the batch's axes first.

Expert padding: `cfg.expert_pad` dummy experts (granite-moe-3b's 40 pad to
48) have weights and are computed over their all-sentinel rows, but the
router scores only the real experts, so they are never routed. The
reference's sharding constraints become the explicit moves above under
a mesh.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch import mesh as M
from repro_torch.nn.layers import ACT, _silu, act_spec
from repro_torch.nn.params import ParamSpec
from repro_torch.nn.sharding import (batch_axes, block_range, gather_weight,
                                     shard_activation, tp_axes)


def moe_specs(cfg) -> dict[str, ParamSpec]:
    """ParamSpecs of one MoE layer: the router over the real experts and
    the SwiGLU experts' (e + pad, d, f) / (e + pad, f, d) tables."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts + cfg.expert_pad
    out_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "router": ParamSpec((d, cfg.n_experts), ("embed", None),
                            init="fan_in"),
        "wi": ParamSpec((e, d, f), ("expert", "embed", "ff"),
                        init="fan_in", fan_axis=1),
        "wg": ParamSpec((e, d, f), ("expert", "embed", "ff"),
                        init="fan_in", fan_axis=1),
        "wo": ParamSpec((e, f, d), ("expert", "ff", "embed"),
                        init="fan_in", fan_axis=1, scale=out_scale),
    }


def _capacity(tokens_per_group: int, n_experts: int, top_k: int,
              capacity_factor: float) -> int:
    """Slots an expert has in a group: ceil(k * tokens / e * factor),
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(top_k * tokens_per_group / n_experts
                      * capacity_factor))
    return max(8, -(-c // 8) * 8)


def dropless_config(cfg):
    """`cfg`, but for an MoE arch a capacity factor of n_experts / top_k:
    an expert's capacity then holds every (token, slot) pair of its group,
    so none is dropped. A prefill drops pairs past capacity where a decode
    step of the same tokens does not, so only without drops are the two
    the same function at the prompt's last position."""
    if not cfg.n_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts
                               / cfg.top_k)


def route(router: torch.Tensor, xg: torch.Tensor, cfg, cap: int,
          dtype: torch.dtype, mesh=None, axes: tuple = ()
          ) -> dict[str, torch.Tensor]:
    """The router and the dispatch plan of xg (g, tg, d).

    Returns {"gate_vals" (g, tg, k) fp32, renormalised; "gate_idx" (g, tg,
    k); "pos" (g, tg*k), the exclusive count of earlier (token, slot)
    pairs routed to the same expert in the group; "keep" (g, tg*k), pos <
    cap; "gather" (g, e_pad, cap), the token each expert slot reads (tg,
    the sentinel, where none); "pair" (g, e_pad * cap), the (token, slot)
    pair t * k + j each expert slot holds (tg * k where none); "slot" (g,
    tg * k), the flat expert slot e * cap + pos of each pair (e_pad * cap
    where dropped); "aux", the Switch load-balancing loss e * sum(mean
    prob * routed fraction)}.

    top-k is a stable descending sort: on equal probabilities the lower
    expert index comes first, as `jax.lax.top_k` orders ties (torch.topk
    promises no order).

    With a mesh, the aux loss's means are over every rank's groups along
    `axes` (the batch's): the probability sums and routed counts are
    all-reduced there before the product."""
    g, tg, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    e_pad = e + cfg.expert_pad
    dev = xg.device
    logits = (xg @ router.to(dtype)).float()                  # (g, tg, e)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = order.values[..., :k], order.indices[..., :k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    t = g * tg
    # the routed fraction as an integer count (no float atomics on the
    # card); it carries no gradient, as the reference's scatter of a
    # constant
    if gate_idx.is_meta:
        # bincount has no meta kernel; its length is e (every index < e)
        counts = torch.empty((e,), dtype=torch.long, device=dev)
    else:
        counts = torch.bincount(gate_idx.reshape(-1), minlength=e)
    if axes:
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        t = t * n
        me = M.reduce_from(probs.sum(dim=(0, 1)), mesh, axes) / t
        counts = M.reduce_from(counts.float(), mesh, axes)
    else:
        me = probs.mean(dim=(0, 1))                           # (e,)
    ce = counts.float() * (1.0 / (t * k))
    aux = e * (me * ce).sum()

    # the one-hot laid out (g, e, n), so that the count runs along the
    # innermost axis: laid out (g, n, e), its scan over n took 16.4 ms a
    # layer at granite-moe-3b's 8,192-token prefill on an H100
    flat_e = gate_idx.reshape(g, tg * k)                      # (g, n)
    onehot = (flat_e[:, None, :] == torch.arange(e, device=dev)[:, None]
              ).long()                                        # (g, e, n)
    pos = (onehot.cumsum(-1) - onehot).gather(1, flat_e[:, None, :])[:, 0]
    keep = pos < cap

    # each kept pair's flat expert slot, unique within its group; a
    # dropped pair writes the spare slot past the end, which is cut off
    n = tg * k
    slot = torch.where(keep, flat_e * cap + pos, e_pad * cap)
    pair = torch.full((g, e_pad * cap + 1), n, dtype=torch.long, device=dev)
    pair.scatter_(1, slot, torch.arange(n, device=dev).expand(g, -1))
    pair = pair[:, :-1]
    return {"gate_vals": gate_vals, "gate_idx": gate_idx, "pos": pos,
            "keep": keep, "gather": (pair // k).view(g, e_pad, cap),
            "pair": pair, "slot": slot, "aux": aux}


class _GatherRows(torch.autograd.Function):
    """out[g, i] = src[g, idx[g, i]] for src (g, m, d) and idx (g, n) in
    [0, m], m reading a zero row. Its gradient is a gather too: d_src[g,
    r] = sum over j of d_out[g, inv[g, r, j]] for inv (g, m, J) in [0, n],
    n reading a zero row, the J terms added in order. The autograd of an
    indexing gather scatters instead: every row the sentinel or a dropped
    pair reads queues behind one row's serial sum, which took 2,032 of a
    granite-moe-1b-a400m step's 2,678 device ms on an H100 (`PERF.md`)."""

    @staticmethod
    def forward(ctx, src, idx, inv):
        ctx.save_for_backward(inv)
        return _take(src, idx)

    @staticmethod
    def backward(ctx, d_out):
        inv, = ctx.saved_tensors
        g, m, j = inv.shape
        rows = _take(d_out, inv.reshape(g, m * j)).view(g, m, j, -1)
        return rows.sum(2) if j > 1 else rows[:, :, 0], None, None


def _take(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src (g, m, d) rows at idx (g, n), idx == m a zero row."""
    g, m, d = src.shape
    pad = torch.cat([src, src.new_zeros(g, 1, d)], dim=1)
    return pad[torch.arange(g, device=src.device)[:, None], idx]


def moe(p: dict, x: torch.Tensor, cfg, dtype: torch.dtype = torch.bfloat16,
        capacity_factor: float | None = None, rules=None, mesh=None,
        global_aux: bool = True, replicated: bool = False
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y (b, s, d) in dtype, aux_loss fp32 scalar).

    Each group's tokens are gathered into (e_pad, cap, d) expert slots
    (the sentinel reads a zero row), the SwiGLU experts run as batched
    products, and each kept (token, slot) adds its expert's output times
    its gate into an fp32 sum per token. A token's k pairs are consecutive
    rows (pair t * k + j), so the combine is a sum over k in a fixed
    order, where the reference scatter-adds: the same function. The two
    gathers differentiate as gathers (`_GatherRows`), so neither the
    forward nor the backward adds floats in an order that varies: a remat
    recompute repeats the forward's bits and two steps agree bit for bit
    on the card. The gradient reaches the router through the renormalised
    gates and the aux loss's mean probability; the routing integers carry
    none.

    With a mesh, `x` is this rank's rows (see the module docstring). Where
    the experts split over `model`, the gates enter the combine through
    `launch.mesh.copy_to` (each rank's combine covers its experts' pairs
    only, so their cotangents are summed there), as does the dispatch's
    input; the router sees the input as it is. With global_aux=False (the
    serving steps, which read no aux loss) the aux loss is this rank's
    groups' own and no collective runs over the batch's axes. There, with
    fewer groups than the batch's ranks, every rank gathers the batch and
    routes it whole (`replicated`: x is already the whole batch)."""
    b, s, d = x.shape
    k, f = cfg.top_k, cfg.d_ff
    e, e_pad = cfg.n_experts, cfg.n_experts + cfg.expert_pad
    cf = capacity_factor or cfg.capacity_factor
    ba = () if replicated else batch_axes(rules, mesh)
    nb = 1
    for a in ba:
        nb *= mesh.shape[a]
    g = max(1, cfg.moe_groups)
    if g % nb and not global_aux and (b * s * nb) % g == 0:
        # fewer groups than the batch's ranks (a decode step's one group of
        # the global batch): every rank routes them whole, as GSPMD
        # replicates a group dimension that does not split, and keeps its
        # own rows of the result
        xa = M.all_gather(x, mesh, ba, 0, partial_grad=False)
        y, aux = moe(p, xa, cfg, dtype, capacity_factor, rules, mesh,
                     global_aux, replicated=True)
        return M.take_block(y, mesh, ba, 0), aux
    if g % nb or (b * s * nb) % g:
        raise ValueError(f"{g} MoE groups of {b * s * nb} tokens do not "
                         f"split over the batch's {nb} ranks {ba}")
    g_loc = g // nb
    tg = b * s // g_loc
    cap = _capacity(tg, e, k, cf)

    xg = x.reshape(g_loc, tg, d).to(dtype)
    router = gather_weight(p["router"].to(dtype), ("embed", None), rules,
                           mesh, (d, e))
    r = route(router, xg, cfg, cap, dtype, mesh, ba if global_aux else ())
    n = tg * k
    w = {name: gather_weight(p[name].to(dtype), axes, rules, mesh, shape)
         for name, axes, shape in (
             ("wi", ("expert", "embed", "ff"), (e_pad, d, f)),
             ("wg", ("expert", "embed", "ff"), (e_pad, d, f)),
             ("wo", ("expert", "ff", "embed"), (e_pad, f, d)))}
    e_loc = w["wi"].shape[0]
    te = tp_axes("expert", e_pad, rules, mesh) if e_loc < e_pad else ()
    lo, hi = block_range(e_pad * cap, te, mesh)
    mine = (r["slot"] >= lo) & (r["slot"] < hi)
    # this rank's expert slots: the tokens they read, and each pair's slot
    # among them (e_loc * cap, a zero row, where another rank's or none)
    slot = torch.where(mine, r["slot"] - lo, hi - lo)
    pair = r["pair"][:, lo:hi]
    xin = M.copy_to(xg, mesh, te) if te else xg
    xe = _GatherRows.apply(xin, pair // k, slot.view(g_loc, tg, k))
    xe = xe.view(g_loc, e_loc, cap, d)
    h = _silu(xe @ w["wg"]) * (xe @ w["wi"])
    ye = h @ w["wo"]
    contrib = _GatherRows.apply(ye.view(g_loc, e_loc * cap, d), slot,
                                pair[..., None])
    gates = M.copy_to(r["gate_vals"], mesh, te) if te else r["gate_vals"]
    contrib = contrib * (gates.reshape(g_loc, n, 1)
                         * mine[..., None]).to(dtype)
    y = contrib.view(g_loc, tg, k, d).float().sum(2).reshape(b, s, d)
    if te:
        y = shard_activation(y, ACT, rules, mesh, act_spec(rules, mesh),
                             partial=te)
    return y.to(dtype), r["aux"]
