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
    the sentinel, where none); "aux", the Switch load-balancing loss
    e * sum(mean prob * routed fraction)}.

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
    ce = torch.zeros(e, device=dev).index_add_(
        0, gate_idx.reshape(-1),
        torch.full((t * k,), 1.0 / (t * k), device=dev))
    aux = e * (me * ce).sum()

    # the one-hot laid out (g, e, n), so that the count runs along the
    # innermost axis: laid out (g, n, e), its scan over n took 16.4 ms a
    # layer at granite-moe-3b's 8,192-token prefill on an H100
    flat_e = gate_idx.reshape(g, tg * k)                      # (g, n)
    onehot = (flat_e[:, None, :] == torch.arange(e, device=dev)[:, None]
              ).long()                                        # (g, e, n)
    pos = (onehot.cumsum(-1) - onehot).gather(1, flat_e[:, None, :])[:, 0]
    keep = pos < cap

    token_ids = torch.arange(tg, device=dev).repeat_interleave(k)
    slot_e = torch.where(keep, flat_e, e_pad)   # dropped: the spare row
    slot_p = torch.where(keep, pos, 0)
    table = torch.full((g, e_pad + 1, cap), tg, dtype=torch.long,
                       device=dev)
    grp = torch.arange(g, device=dev)[:, None]
    table[grp, slot_e, slot_p] = token_ids.expand(g, -1)
    return {"gate_vals": gate_vals, "gate_idx": gate_idx, "pos": pos,
            "keep": keep, "gather": table[:, :e_pad], "aux": aux}


def moe(p: dict, x: torch.Tensor, cfg, dtype: torch.dtype = torch.bfloat16,
        capacity_factor: float | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (y (b, s, d) in dtype, aux_loss fp32 scalar).

    Each group's tokens are gathered into (e_pad, cap, d) expert slots
    (the sentinel reads a zero row), the SwiGLU experts run as batched
    products, and each kept (token, slot) adds its expert's output times
    its gate into an fp32 sum per token (`index_add_`, in no fixed order,
    as the reference's scatter-add)."""
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
    grp = torch.arange(g, device=x.device)
    xpad = torch.cat([xg, xg.new_zeros(g, 1, d)], dim=1)
    xe = xpad[grp[:, None, None], r["gather"]]               # (g,e_pad,cap,d)
    wi, wg, wo = (p[n].to(dtype) for n in ("wi", "wg", "wo"))
    h = _silu(xe @ wg) * (xe @ wi)                            # (g,e_pad,cap,f)
    ye = h @ wo                                               # (g,e_pad,cap,d)

    keep, n = r["keep"], tg * k
    slot = torch.where(keep, r["gate_idx"].reshape(g, n) * cap + r["pos"], 0)
    contrib = ye.reshape(g, -1, d)[grp[:, None], slot]        # (g, n, d)
    contrib = contrib * (r["gate_vals"].reshape(g, n, 1)
                         * keep[..., None]).to(dtype)
    token_ids = torch.arange(tg, device=x.device).repeat_interleave(k)
    y = torch.zeros(g, tg, d, device=x.device).index_add_(
        1, token_ids, contrib.float())
    return y.reshape(b, s, d).to(dtype), r["aux"]
