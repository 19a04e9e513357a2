"""LM serving over a mesh: the collectives one serving step issues on a
rank, the dry run's prefill rules, and a rank's memory by the reckoning.

`lm_serve_collectives` is the serving counterpart of
`train.steps.lm_step_collectives`: from the specs, the rules and the
mode it works out every `Mesh.stats` call one `models.lm.prefill_step`
or `decode_step(rules=, mesh=)` makes on a rank, by f"{op}@{axis}".
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig
from repro_torch.nn.sharding import (GATHERED_AXES, LogicalRules, batch_axes,
                                     dim_axes, resolve_sized, spec_axes,
                                     tp_axes, use_spec)


def prefill_rules(rules: LogicalRules) -> LogicalRules:
    """The dry run's prefill override of a serving table: no `_fallback`
    (a head_dim split would all-reduce (b, h, s, s) scores), weights stored
    FSDP-sharded over `data` on `embed` and gathered at each use."""
    out = {k: v for k, v in rules.items() if k != "_fallback"}
    out.update(embed=("data",), _gather_weights=True)
    return out


def lm_serve_collectives(cfg: ModelConfig, rules: LogicalRules, mesh,
                         mode: str, max_len: int | None = None
                         ) -> dict[str, int]:
    """The collectives one `prefill_step` (mode "prefill") or `decode_step`
    ("decode") over `mesh` issues on a rank, by f"{op}@{axis}" (`Mesh.
    stats`' keys, "_calls" left off); a one-rank axis issues none.
    `max_len`, the caches' positions, decides whether `cache_seq` splits
    them (by default it does wherever the rules say). Per step:
      * each weight use under `_gather_weights` (`gather_weight`): an
        all_gather per mesh axis it drops; `replicate_weight` (the audio
        head, Mamba-2's conv weights and bias together, in_proj in
        prefill): one per axis its block splits over;
      * the vocabulary split: the embedding's all_reduce (the audio arch's
        codebook sum in decode over its table's vocabulary axes);
      * attention: the head_dim blocks of q, k and v gathered where
        `_fallback` split them; wo's all_reduce over the axes its rows
        split on; with the cache split by positions, k and v gathered
        over the kv heads' axes, and in decode q over the heads' axes and
        the merge's max and sum all_reduces over the positions' axes;
      * a Mamba-2 mixer with its heads split (`nn.mamba2.serve_heads`):
        in decode in_proj's output gathered over its columns' axes; the
        gated norm's and out_proj's all_reduces; else every leaf whole;
      * the MLP's and a MoE layer's combine all_reduce over ff's / the
        experts' axes (serving takes no aux sums across ranks);
      * the last position's logits gathered over the vocabulary's axes,
        then over the batch's."""
    from repro_torch.models.lm import _pattern_moe_flags, _vocab_axes
    from repro_torch.nn import layers as L
    from repro_torch.nn import mamba2 as M
    if mode not in ("prefill", "decode"):
        raise ValueError(f"serving modes are prefill and decode, not "
                         f"{mode!r}")
    live = tuple(a for a in mesh.axis_names if mesh.shape[a] > 1)
    out: dict[str, int] = {}

    def add(op, axes, n=1):
        for a in axes:
            if a in live:
                out[f"{op}@{a}"] = out.get(f"{op}@{a}", 0) + n

    def use(axes, shape):
        """gather_weight's all_gathers."""
        if not rules.get("_gather_weights"):
            return
        src = spec_axes(resolve_sized(axes, rules, mesh, shape))
        dst = spec_axes(use_spec(axes, rules, mesh, shape))
        add("all_gather", tuple(a for a, i in src.items()
                                if dst.get(a) != i))

    def whole(axes, shape):
        """replicate_weight's all_gathers."""
        add("all_gather", tuple(spec_axes(resolve_sized(axes, rules, mesh,
                                                        shape))))

    d, v = cfg.d_model, cfg.vocab_size
    norm = 2 if cfg.norm_type == "layernorm" else 1

    def attention():
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        wq = (("embed", "heads", "head_dim"), (d, h, dh))
        wk = (("embed", "kv_heads", "head_dim"), (d, kv, dh))
        wo = (("heads", "head_dim", "embed"), (h, dh, d))
        for w in (wq, wk, wk, wo):
            use(*w)
        sq, sk, so = (use_spec(w[0], rules, mesh, w[1]) for w in (wq, wk, wo))
        tq, tk = dim_axes(sq, 1), dim_axes(sk, 1)
        add("all_gather", dim_axes(sq, 2))
        add("all_gather", dim_axes(sk, 2), 2)
        n_b = math.prod(mesh.shape[a] for a in batch_axes(rules, mesh))
        length = max_len if max_len is not None else math.prod(
            mesh.shape.values())
        ts = dim_axes(L.kv_cache_spec(rules, mesh, n_b, length, kv, dh), 1)
        if ts:
            add("all_gather", tk, 2)
            if mode == "decode":
                add("all_gather", tq)
                add("all_reduce", ts, 2)
        add("all_reduce", dim_axes(so, 0) or dim_axes(so, 1))

    def mixer():
        m = M.mamba_dims(cfg)
        in_proj = (("embed", "ssm_inner"), (d, m["d_in_proj"]))
        conv = ((None, "conv_dim"), (m["d_conv"], m["conv_dim"]))
        out_proj = (("ssm_inner", "embed"), (m["d_inner"], d))
        th = M.serve_heads(cfg, rules, mesh)
        if not th:
            heads = (("ssm_heads",), (m["n_heads"],))
            for w in [in_proj, conv, (("conv_dim",), (m["conv_dim"],)),
                      heads, heads, heads,
                      (("ssm_inner",), (m["d_inner"],)), out_proj]:
                whole(*w)
            return
        ti = dim_axes(use_spec(in_proj[0], rules, mesh, in_proj[1]), 1)
        if ti and mode == "decode":
            use(*in_proj)
            add("all_gather", ti)
        elif ti:
            whole(*in_proj)
        else:
            use(*in_proj)
        whole(*conv)                 # conv_w and conv_b in one gather
        use(*out_proj)
        add("all_reduce", th, 2)

    def ffn(is_moe):
        f = cfg.d_ff
        if is_moe:
            e_pad = cfg.n_experts + cfg.expert_pad
            use(("embed", None), (d, cfg.n_experts))
            for axes, shape in ((("expert", "embed", "ff"), (e_pad, d, f)),
                                (("expert", "embed", "ff"), (e_pad, d, f)),
                                (("expert", "ff", "embed"), (e_pad, f, d))):
                use(axes, shape)
            g = rules.get("_gather_axes", GATHERED_AXES) \
                if rules.get("_gather_weights") else ()
            add("all_reduce", () if "expert" in g else
                tp_axes("expert", e_pad, rules, mesh))
            return
        layout = {"wi": (("embed", "ff"), (d, f)),
                  "wg": (("embed", "ff"), (d, f)),
                  "wo": (("ff", "embed"), (f, d)),
                  "bi": (("ff",), (f,)), "bo": (("embed",), (d,))}
        for n in (("wi", "wg", "wo") if cfg.mlp_type == "swiglu"
                  else ("wi", "bi", "wo", "bo")):
            use(*layout[n])
        add("all_reduce", tp_axes("ff", f, rules, mesh))

    tv = _vocab_axes(cfg, rules, mesh)
    if cfg.frontend != "audio":
        use(("vocab", "embed"), (v, d))
        add("all_reduce", tv)
    elif mode == "decode":
        cb = ((None, "vocab", "embed"), (cfg.n_codebooks, v, d))
        use(*cb)
        add("all_reduce", dim_axes(use_spec(cb[0], rules, mesh, cb[1]), 1))
    flags = _pattern_moe_flags(cfg)
    for _ in range(cfg.n_units):
        for i, kind in enumerate(cfg.pattern):
            for _ in range(norm):
                use(("embed",), (d,))
            attention() if kind == "a" else mixer()
            if cfg.d_ff > 0:
                for _ in range(norm):
                    use(("embed",), (d,))
                ffn(flags[i])
    for _ in range(norm):
        use(("embed",), (d,))
    if cfg.tie_embeddings:
        use(("vocab", "embed"), (v, d))
    elif cfg.frontend == "audio":
        whole(("embed", "vocab"), (d, v * cfg.n_codebooks))
    else:
        use(("embed", "vocab"), (d, v))
    add("all_gather", tv)
    add("all_gather", batch_axes(rules, mesh))
    return out
