"""Token-choice top-k Mixture-of-Experts with grouped dispatch, the port
of the reference's `nn/moe.py` as torch ops (no kernel lies under it in
the reference either).

Tokens split into `moe_groups` groups; capacity, the position of each
(token, slot) within its expert, the gather table and the combine all stay
group-local. Experts are embedding tables in the paper's terms: the router
is a multi-hot lookup, and the per-group capacity is the truncation bound
on lookups. Whatever passes capacity is dropped.

Expert padding: `cfg.expert_pad` dummy experts (granite-moe-3b's 40 pad to
48) have weights and are computed over their all-sentinel rows, but the
router scores only the real experts, so they are never routed. The
reference's sharding constraints are mesh-only and left out.
"""
from __future__ import annotations

import math

import torch

from repro_torch.nn.layers import _silu
from repro_torch.nn.params import ParamSpec


def moe_specs(cfg) -> dict[str, ParamSpec]:
    """ParamSpecs of one MoE layer: the router over the real experts and
    the SwiGLU experts' (e + pad, d, f) / (e + pad, f, d) tables."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts + cfg.expert_pad
    out_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "router": ParamSpec((d, cfg.n_experts), init="fan_in"),
        "wi": ParamSpec((e, d, f), init="fan_in", fan_axis=1),
        "wg": ParamSpec((e, d, f), init="fan_in", fan_axis=1),
        "wo": ParamSpec((e, f, d), init="fan_in", fan_axis=1,
                        scale=out_scale),
    }


def _capacity(tokens_per_group: int, n_experts: int, top_k: int,
              capacity_factor: float) -> int:
    """Slots an expert has in a group: ceil(k * tokens / e * factor),
    rounded up to a multiple of 8, at least 8."""
    c = int(math.ceil(top_k * tokens_per_group / n_experts
                      * capacity_factor))
    return max(8, -(-c // 8) * 8)


def route(router: torch.Tensor, xg: torch.Tensor, cfg, cap: int,
          dtype: torch.dtype) -> dict[str, torch.Tensor]:
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
    promises no order)."""
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
    me = probs.mean(dim=(0, 1))                               # (e,)
    # the routed fraction as an integer count (no float atomics on the
    # card); it carries no gradient, as the reference's scatter of a
    # constant
    ce = torch.bincount(gate_idx.reshape(-1), minlength=e).float() \
        * (1.0 / (t * k))
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
        capacity_factor: float | None = None
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
    none."""
    b, s, d = x.shape
    k = cfg.top_k
    cf = capacity_factor or cfg.capacity_factor
    t = b * s
    g = max(1, cfg.moe_groups)
    if t % g:
        raise ValueError(f"{t} tokens do not split into {g} MoE groups")
    tg = t // g
    cap = _capacity(tg, cfg.n_experts, k, cf)

    xg = x.reshape(g, tg, d).to(dtype)
    r = route(p["router"], xg, cfg, cap, dtype)
    e_pad, n = cfg.n_experts + cfg.expert_pad, tg * k
    # dispatch: each expert slot reads its token (the sentinel a zero
    # row); a token's gradient gathers its k slots'
    xe = _GatherRows.apply(xg, r["gather"].view(g, -1),
                           r["slot"].view(g, tg, k))
    xe = xe.view(g, e_pad, cap, d)
    wi, wg, wo = (p[name].to(dtype) for name in ("wi", "wg", "wo"))
    h = _silu(xe @ wg) * (xe @ wi)                            # (g,e_pad,cap,f)
    ye = h @ wo                                               # (g,e_pad,cap,d)

    # combine: each pair reads its slot's output (a dropped pair a zero
    # row), an expert slot's gradient gathers its one pair's
    contrib = _GatherRows.apply(ye.view(g, e_pad * cap, d), r["slot"],
                                r["pair"][..., None])         # (g, n, d)
    contrib = contrib * (r["gate_vals"].reshape(g, n, 1)
                         * r["keep"][..., None]).to(dtype)
    y = contrib.view(g, tg, k, d).float().sum(2)
    return y.reshape(b, s, d).to(dtype), r["aux"]
