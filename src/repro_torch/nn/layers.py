"""Layers of the port: the dense layers of the DLRM towers, and the LM
layer zoo's dense family (norms, RoPE, sinusoidal positions, GQA
attention with a bf16 or int8 KV cache, SwiGLU / GELU MLPs). Weights keep
the reference's layouts, so
`y = x @ w + b` matches `repro.nn.layers.linear`, and the attention
weights are (d, h, dh) and (h, dh, d).

With a `mesh` (training), each weight arrives as the block its rules
store (`nn.sharding.resolve_sized`) and the activations as this rank's
rows: `gather_weight` puts FSDP's sharded weights together at each use,
and attention and the MLP run Megatron's tensor parallelism over the
axes their heads and ff dims shard on (wq, wk, wv, wi, wg column-parallel,
wo row-parallel with one all_reduce; `launch.mesh.copy_to` at the
input). In prefill and decode (serving) attention keeps tensor
parallelism over the heads and reads and writes this rank's block of the
KV cache, laid out as `kv_cache_spec` says (`_serve_attention`). Without
a mesh they are the one-device layers, bit for bit."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.launch import mesh as M
from repro_torch.nn.params import ParamSpec
from repro_torch.nn.sharding import (LogicalRules, NamedSharding,
                                     batch_axes, block_range, dim_axes,
                                     gather_weight, resolve_sized,
                                     shard_activation, tp_axes, use_spec)

#: the residual stream's logical axes
ACT = ("act_batch", "act_seq", "act_embed")


def act_spec(rules: LogicalRules, mesh) -> tuple:
    """The spec of an activation of this rank's rows: the batch dim over
    the batch's mesh axes (as the step splits its batch)."""
    axes = batch_axes(rules, mesh)
    if not axes:
        return ()
    return (axes if len(axes) > 1 else axes[0],)


def linear_specs(d_in: int, d_out: int, in_ax: str | None,
                 out_ax: str | None, bias: bool = False,
                 scale: float = 1.0) -> dict[str, ParamSpec]:
    """ParamSpecs of one (d_in, d_out) linear layer (+ zero bias), its
    dimensions named in_ax and out_ax."""
    specs = {"w": ParamSpec((d_in, d_out), (in_ax, out_ax), init="fan_in",
                            scale=scale, fan_axis=-2)}
    if bias:
        specs["b"] = ParamSpec((d_out,), (out_ax,), init="zeros")
    return specs


def linear(p: dict[str, torch.Tensor], x: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x @ w (+ b), computed in `dtype`."""
    y = torch.matmul(x.to(dtype), p["w"].to(dtype))
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y

# ---------------------------------------------------------------------------
# the LM layers (dense family): norms, RoPE, GQA attention with a KV cache,
# MLPs. Layouts are the reference's: activations (b, s, h, dh), weights
# (d, h, dh) and (h, dh, d). Weights are stored in fp32 and cast to the
# compute dtype at each use; norms and RoPE compute in fp32.
# ---------------------------------------------------------------------------


def norm_specs(d: int, kind: str = "rmsnorm") -> dict[str, ParamSpec]:
    """ParamSpecs of an RMSNorm (scale) or LayerNorm (scale, bias)."""
    specs = {"scale": ParamSpec((d,), ("embed",), init="ones")}
    if kind == "layernorm":
        specs["bias"] = ParamSpec((d,), ("embed",), init="zeros")
    return specs


def apply_norm(p: dict[str, torch.Tensor], x: torch.Tensor,
               kind: str = "rmsnorm", eps: float = 1e-5,
               dtype: torch.dtype = torch.bfloat16,
               rules: LogicalRules | None = None, mesh=None
               ) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, in fp32, cast to dtype.
    LayerNorm's variance is the biased one, as `jnp.var`'s. The scale and
    bias go through `gather_weight`."""
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(f"unknown norm {kind!r}")
    d = x.shape[-1]
    y = y * gather_weight(p["scale"].float(), ("embed",), rules, mesh, (d,))
    if "bias" in p:
        y = y + gather_weight(p["bias"].float(), ("embed",), rules, mesh,
                              (d,))
    return y.to(dtype)


def rope_frequencies(head_dim: int, rotary_pct: float, theta: float,
                     style: str, device=None) -> torch.Tensor:
    """Inverse frequencies of the rotated sub-dimension (fp32)."""
    if style == "glm":
        rot = head_dim // 2          # ChatGLM rotates the first half, 2D style
    else:
        rot = int(head_dim * rotary_pct)
    rot -= rot % 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                         device=device) / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, head_dim: int,
               rotary_pct: float = 1.0, theta: float = 10000.0,
               style: str = "neox") -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) int. Rotates
    the first `rot` dims in fp32 (neox split-half or glm interleaved
    pairs) and passes the rest through."""
    if style == "none":
        return x
    inv = rope_frequencies(head_dim, rotary_pct, theta, style, x.device)
    ang = positions[..., :, None].float() * inv           # (..., s, rot/2)
    sin = ang.sin()[..., :, None, :]                      # over heads
    cos = ang.cos()[..., :, None, :]
    rot = inv.shape[0] * 2
    xr, xp = x[..., :rot], x[..., rot:]
    xf = xr.float()
    if style == "glm":
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xf.shape)
    else:
        half = rot // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """MusicGen's absolute position embedding, fp32: for positions (...)
    the (..., d_model) concatenation of sin and cos of position * 10000^(-2i
    / d_model), i < d_model / 2."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, d_model, 2, dtype=torch.float32,
                                          device=positions.device)
                             / d_model))
    ang = positions[..., None].float() * inv
    return torch.cat([ang.sin(), ang.cos()], dim=-1)


def attention_specs(cfg) -> dict[str, ParamSpec]:
    """ParamSpecs of one GQA attention layer (+ QKV biases)."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    specs = {
        "wq": ParamSpec((d, h, dh), ("embed", "heads", "head_dim"),
                        init="fan_in", fan_axis=0),
        "wk": ParamSpec((d, kv, dh), ("embed", "kv_heads", "head_dim"),
                        init="fan_in", fan_axis=0),
        "wv": ParamSpec((d, kv, dh), ("embed", "kv_heads", "head_dim"),
                        init="fan_in", fan_axis=0),
        "wo": ParamSpec((h, dh, d), ("heads", "head_dim", "embed"),
                        init="fan_in", fan_axis=1,
                        scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, dh), ("heads", "head_dim"),
                                init="zeros")
        specs["bk"] = ParamSpec((kv, dh), ("kv_heads", "head_dim"),
                                init="zeros")
        specs["bv"] = ParamSpec((kv, dh), ("kv_heads", "head_dim"),
                                init="zeros")
    return specs


def _project(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one (d, h*dh) matmul."""
    d, h, dh = w.shape
    return (x @ w.to(dtype).reshape(d, h * dh)).unflatten(-1, (h, dh))


def _attn_weights(p, cfg, dtype, rules, mesh, names) -> dict:
    """The weights `names` of wq, wk, wv, wo in the compute dtype, each
    gathered for use."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    axes = {"wq": (("embed", "heads", "head_dim"), (d, h, dh)),
            "wk": (("embed", "kv_heads", "head_dim"), (d, kv, dh)),
            "wv": (("embed", "kv_heads", "head_dim"), (d, kv, dh)),
            "wo": (("heads", "head_dim", "embed"), (h, dh, d))}
    return {k: gather_weight(p[k].to(dtype), axes[k][0], rules, mesh,
                             axes[k][1]) for k in names}


def _qkv(p, x, cfg, positions, dtype, rules=None, mesh=None):
    """q, k, v with RoPE. With a mesh whose `model`-like axes split the
    heads, q (and k, v when the kv heads split too) are this rank's heads
    of the column-parallel projections, k and v (b, s, kv, dh) else; the
    input enters through `launch.mesh.copy_to`."""
    w = _attn_weights(p, cfg, dtype, rules, mesh, ("wq", "wk", "wv"))
    tq = tp_axes("heads", cfg.n_heads, rules, mesh)
    tkv = tp_axes("kv_heads", cfg.n_kv_heads, rules, mesh)
    if tkv and tkv != tq:
        raise ValueError(f"kv heads shard over {tkv}, heads over {tq}")
    xq = M.copy_to(x, mesh, tq) if tq else x
    xk = xq if tkv else x
    q = _project(xq, w["wq"], dtype)
    k = _project(xk, w["wk"], dtype)
    v = _project(xk, w["wv"], dtype)
    if "bq" in p:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    rope = (cfg.d_head, cfg.rotary_pct, cfg.rope_theta, cfg.rope_style)
    return apply_rope(q, positions, *rope), apply_rope(k, positions, *rope), v


def _repeat_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(b, s, kv, dh) -> (b, s, h, dh), each kv group repeated in place
    (`jnp.repeat` order: kv head j serves heads j*n .. j*n+n-1)."""
    kv = k.shape[-2]
    if kv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // kv, dim=-2)


def full_attention(q, k, v, causal: bool = True,
                   kv_valid_len=None) -> torch.Tensor:
    """Materialized-scores attention. q: (b, sq, h, dh); k, v: (b, sk, h,
    dh). Scores in fp32 (scaled by 1/sqrt(dh), -1e30 where masked), softmax
    in fp32, probabilities cast to q's dtype, then times V. kv_valid_len:
    scalar or (b,) per-sequence valid cache length. (The reference's
    `q_offset`, which no caller passes, is not ported.)"""
    dh = q.shape[-1]
    b, sq, sk = q.shape[0], q.shape[1], k.shape[1]
    # the einsum's result is a fresh tensor, so the scaling and the mask
    # go in place: at 8k tokens a (1, 32, s, s) fp32 copy is 8.6 GB
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float().div_(math.sqrt(dh))
    mask = torch.zeros((1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(sk, device=q.device)[None, :]
        mask = mask | (kpos > qpos)[None, None]
    if kv_valid_len is not None:
        valid = torch.as_tensor(kv_valid_len, device=q.device).expand(b)
        mask = mask | (torch.arange(sk, device=q.device)[None, None, None, :]
                       >= valid[:, None, None, None])
    probs = torch.softmax(scores.masked_fill_(mask, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def attention(p, x, cfg, positions, *, mode: str = "train",
              cache: dict[str, torch.Tensor] | None = None,
              cache_index=None,
              dtype: torch.dtype = torch.bfloat16,
              rules: LogicalRules | None = None, mesh=None,
              max_len: int | None = None
              ) -> tuple[torch.Tensor, dict | None]:
    """GQA attention. mode: train | prefill | decode.

    prefill writes the prompt's K/V into `cache` at offset 0 and decode
    writes one token's at `cache_index` (an int shared by the batch, or a
    (b,) tensor of per-slot positions): both write the cache tensors IN
    PLACE (the reference returns an updated copy) and return the same dict.

    In train and prefill mode a sequence longer than `attn_block_q` and a
    multiple of it runs the causal flash-attention kernel
    (`kernels.ops.flash_attention`), where the reference runs its blockwise
    attention; the reference's block condition and its assertion that the
    length is a multiple of `attn_block_k` are kept. Shorter or ragged
    prompts take `full_attention`.

    With a `mesh` in train mode: each rank runs the heads its wq block
    holds (all of them where the heads do not split), on its rows; where
    the kv heads do not split but the heads do, k and v are computed whole
    and this rank's heads taken after the GQA repeat, their cotangent
    summed over the heads' axes (`copy_to`), so wk and wv get whole
    gradients. wo is row-parallel: one all_reduce of the (b, s, d) partial
    sums over the heads' axes (`shard_activation`). Prefill and decode
    run `_serve_attention`, with a mesh or without, where `max_len` is the
    caches' global length (the cache's own without a mesh)."""
    if mode != "train":
        return _serve_attention(p, x, cfg, positions, mode, cache,
                                cache_index, dtype, rules, mesh, max_len)
    q, k, v = _qkv(p, x.to(dtype), cfg, positions, dtype, rules, mesh)
    tq = tp_axes("heads", cfg.n_heads, rules, mesh)
    if tq and k.shape[-2] == cfg.n_kv_heads:
        # the kv heads are whole: this rank's query heads' share of them
        k = M.copy_to(_repeat_kv(k, cfg.n_heads), mesh, tq)
        v = M.copy_to(_repeat_kv(v, cfg.n_heads), mesh, tq)
        lo, hi = block_range(cfg.n_heads, tq, mesh)
        k, v = k[..., lo:hi, :], v[..., lo:hi, :]
    out = _causal_attention(q, _repeat_kv(k, q.shape[-2]),
                            _repeat_kv(v, q.shape[-2]), cfg)
    wo = _attn_weights(p, cfg, dtype, rules, mesh, ("wo",))["wo"]
    h, dh, d = wo.shape
    y = out.reshape(*out.shape[:2], h * dh) @ wo.reshape(h * dh, d)
    if tq:
        y = shard_activation(y, ACT, rules, mesh, act_spec(rules, mesh),
                             partial=tq)
    return y, cache


def _causal_attention(q, k, v, cfg) -> torch.Tensor:
    """Causal attention over a whole sequence (train, prefill): the
    flash-attention kernel where the sequence is longer than
    `attn_block_q` and a multiple of it (the reference's blockwise
    branch, whose assertion that it is a multiple of `attn_block_k` is
    kept), `full_attention` otherwise."""
    s = q.shape[1]
    if s > cfg.attn_block_q and s % cfg.attn_block_q == 0:
        if s % cfg.attn_block_k:
            raise ValueError(
                f"a sequence of {s} takes the blockwise branch (> "
                f"attn_block_q={cfg.attn_block_q} and a multiple of it) but "
                f"is not a multiple of attn_block_k={cfg.attn_block_k}")
        return ops.flash_attention(q, k, v, causal=True)
    return full_attention(q, k, v)


def _serve_attention(p, x, cfg, positions, mode, cache, cache_index, dtype,
                     rules, mesh, max_len):
    """Attention in prefill or decode, on this rank of `mesh` where one is
    given: `x` is its rows, `cache` its block of the layer's KV cache
    (`kv_cache_spec` of the global (batch, max_len)). Without a mesh every
    split below is empty: the whole projections, the whole cache. Each
    projection runs on the block of the weight's columns the rank holds:

      * heads split (SERVE_RULES where `model` divides them): q, and k
        and v where the kv heads split too, are the rank's heads; where
        the kv heads do not split, k and v are whole and the rank's heads
        taken after the GQA repeat;
      * head_dim split (`_fallback`, heads that `model` does not divide):
        each projection's head_dim block is gathered before RoPE, so q, k
        and v are whole and the attention (the flash kernel in prefill)
        runs on every head; the rank then takes its head_dim block of the
        output for wo. (Scores summed over head_dim blocks instead would
        all-reduce a (b, h, s, s) tensor a layer.)

    The cache holds the rank's kv heads (`cache_kv` split), all of them
    (`cache_kv` dropped: chatglm3's 2 kv heads on 4 ranks), or a block of
    positions (`cache_seq` split, LONG_SERVE_RULES): prefill writes the
    prompt's positions in the rank's block, k and v gathered whole over
    the heads first; decode writes a token's K/V only on the rank that
    owns its position and attends flash-decoding style: q gathered whole,
    each rank's fp32 row max, sums of exponentials and weighted values
    over its positions, one max and one sum all_reduce, then the rank's
    heads (or head_dim block) for wo. wo is row-parallel: one all_reduce
    of the partial sums over the axes its rows split on."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    b, s = x.shape[:2]
    if mode not in ("prefill", "decode"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if cache is None:
        raise ValueError(f"{mode} needs a cache")
    if max_len is None:
        if mesh is not None:
            raise ValueError("attention over a mesh in prefill or decode "
                             "needs the caches' global max_len")
        max_len = cache["k"].shape[1]
    w = _attn_weights(p, cfg, dtype, rules, mesh, ("wq", "wk", "wv", "wo"))
    sq = use_spec(("embed", "heads", "head_dim"), rules, mesh, (d, h, dh))
    sk = use_spec(("embed", "kv_heads", "head_dim"), rules, mesh,
                  (d, kv, dh))
    so = use_spec(("heads", "head_dim", "embed"), rules, mesh, (h, dh, d))
    tq, dq = dim_axes(sq, 1), dim_axes(sq, 2)
    tk, dk = dim_axes(sk, 1), dim_axes(sk, 2)
    if tk and tk != tq:
        raise ValueError(f"kv heads shard over {tk}, heads over {tq}")
    xd = x.to(dtype)
    q = _project(xd, w["wq"], dtype)
    k = _project(xd, w["wk"], dtype)
    v = _project(xd, w["wv"], dtype)
    if "bq" in p:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    if dq:
        q = M.all_gather(q, mesh, dq, -1, partial_grad=False)
    if dk:
        k = M.all_gather(k, mesh, dk, -1, partial_grad=False)
        v = M.all_gather(v, mesh, dk, -1, partial_grad=False)
    rope = (dh, cfg.rotary_pct, cfg.rope_theta, cfg.rope_style)
    q, k = apply_rope(q, positions, *rope), apply_rope(k, positions, *rope)
    n_b = 1
    for a in batch_axes(rules, mesh):
        n_b *= mesh.shape[a]
    cs = kv_cache_spec(rules, mesh, b * n_b, max_len, kv, dh)
    ts, tc = dim_axes(cs, 1), dim_axes(cs, 2)
    if ts and tc:
        raise ValueError(f"a KV cache split over positions and kv heads "
                         f"{cs}")
    hq = q.shape[-2]
    lo_h, hi_h = block_range(h, tq, mesh)

    def whole(t):
        """(b, s, kv, dh) from the rank's kv heads."""
        return M.all_gather(t, mesh, tk, -2, partial_grad=False) if tk \
            else t

    def cached(t):
        """`t` in the cache's layout over the kv heads."""
        if tc == tk:
            return t
        if tc and not tk:
            return M.take_block(t, mesh, tc, -2)
        if not tc:
            return whole(t)
        raise ValueError(f"kv heads split over {tk}, the cache over {tc}")

    def rank_heads(t):
        """K or V (b, s, kv heads whole or the rank's, dh) repeated to the
        rank's query heads."""
        if tq and t.shape[-2] == kv:
            return _repeat_kv(t, h)[..., lo_h:hi_h, :]
        return _repeat_kv(t, hq)

    if mode == "prefill":
        if ts:
            lo, hi = block_range(max_len, ts, mesh)
            _write_kv_block(cache, whole(k), whole(v), lo, hi)
        else:
            write_kv_prefix(cache, cached(k), cached(v))
        out = _causal_attention(q, rank_heads(k), rank_heads(v), cfg)
    else:
        if cache_index is None:
            raise ValueError("decode needs a cache_index")
        if ts:
            lo, hi = block_range(max_len, ts, mesh)
            _update_kv_block(cache, whole(k), whole(v), cache_index, lo, hi)
            if tq:
                q = M.all_gather(q, mesh, tq, -2, partial_grad=False)
            out = _merge_decode(q, cache, dtype, h, cache_index + 1, lo,
                                mesh, ts)[..., lo_h:hi_h, :]
        else:
            update_kv_cache(cache, cached(k), cached(v), cache_index)
            kf, vf = read_kv_cache(cache, dtype)
            out = full_attention(q, rank_heads(kf), rank_heads(vf),
                                 causal=False, kv_valid_len=cache_index + 1)
    to, do = dim_axes(so, 0), dim_axes(so, 1)
    if do:
        lo_d, hi_d = block_range(dh, do, mesh)
        out = out[..., lo_d:hi_d]
    wo = w["wo"]
    y = out.reshape(b, s, -1) @ wo.reshape(-1, d)
    red = to or do
    if red:
        y = shard_activation(y, ACT, rules, mesh, act_spec(rules, mesh),
                             partial=red)
    return y, cache


def _merge_decode(q, cache, dtype, n_heads, valid, lo, mesh, axes):
    """Flash-decoding over a cache split by positions: q (b, 1, h, dh)
    whole, `cache` this rank's positions [lo, lo + len). Scores in fp32
    (-1e30 at positions >= valid, a scalar or (b,)), the row max
    all-reduced (max) over `axes`, then this rank's sums of exponentials
    and exp-weighted values (fp32) in one sum all_reduce. Returns (b, 1,
    h, dh) in q's dtype."""
    kf, vf = read_kv_cache(cache, dtype)
    kf, vf = _repeat_kv(kf, n_heads), _repeat_kv(vf, n_heads)
    b, dh = q.shape[0], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf).float().div_(math.sqrt(dh))
    pos = lo + torch.arange(kf.shape[1], device=q.device)
    valid = torch.as_tensor(valid, device=q.device).expand(b)
    scores.masked_fill_(pos[None, None, None, :]
                        >= valid[:, None, None, None], -1e30)
    mx = scores.amax(-1, keepdim=True).contiguous()
    for a in axes:
        mesh.all_reduce(mx, a, op="max", staged=True)
    e = torch.exp(scores - mx)
    acc = torch.einsum("bhqk,bkhd->bqhd", e, vf.float())
    parts = torch.cat([acc, e.sum(-1).transpose(1, 2)[..., None]], dim=-1)
    for a in axes:
        mesh.all_reduce(parts, a, staged=True)
    return (parts[..., :dh] / parts[..., dh:]).to(q.dtype)

# ---------------------------------------------------------------------------
# KV cache (bf16, or int8 with per-token-head fp32 scales)
# ---------------------------------------------------------------------------

#: a layer's KV cache's logical axes (`cache_pspecs` adds "layer" first)
KV_CACHE_AXES = ("act_batch", "cache_seq", "cache_kv", None)


def kv_cache_spec(rules: LogicalRules, mesh, batch: int, max_len: int,
                  n_kv: int, d_head: int) -> tuple:
    """The spec of one layer's K or V cache (batch, max_len, n_kv, d_head)
    on `mesh` under `rules` (the scales' (..., 1) take the same): the
    batch over `act_batch`'s axes, the positions over `cache_seq`'s, the
    kv heads over `cache_kv`'s, each where it divides."""
    if mesh is None:
        return ()
    return resolve_sized(KV_CACHE_AXES, rules, mesh,
                         (batch, max_len, n_kv, d_head))


def kv_cache_abstract(batch: int, max_len: int, n_kv: int, d_head: int,
                      dtype: torch.dtype = torch.bfloat16,
                      quantized: bool = False) -> dict:
    """`init_kv_cache`'s tensors on the meta device: shapes and dtypes."""
    return init_kv_cache(batch, max_len, n_kv, d_head, dtype, quantized,
                         "meta")


def init_kv_cache(batch: int, max_len: int, n_kv: int, d_head: int,
                  dtype: torch.dtype = torch.bfloat16,
                  quantized: bool = False, device=None,
                  rules: LogicalRules | None = None, mesh=None) -> dict:
    """Zeroed K/V cache of one layer: (batch, max_len, n_kv, d_head), or
    with a mesh this rank's block of it (`kv_cache_spec`)."""
    shape = (batch, max_len, n_kv, d_head)
    scale = (batch, max_len, n_kv, 1)
    if mesh is not None:
        sh = NamedSharding(mesh, kv_cache_spec(rules, mesh, *shape))
        shape, scale = sh.local_shape(shape), sh.local_shape(scale)
    if quantized:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale, device=device),
                "v_scale": torch.zeros(scale, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_i8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (token, head): scale = max|x| / 127 (at least
    1e-8 / 127), values rounded half to even and clipped to +-127."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _cache_items(cache: dict, k: torch.Tensor, v: torch.Tensor):
    """(buffer, value) pairs to write: k/v, quantized with their scales
    for an int8 cache."""
    if "k_scale" in cache:
        kq, ks = _quantize_i8(k)
        vq, vs = _quantize_i8(v)
        return [(cache["k"], kq), (cache["v"], vq),
                (cache["k_scale"], ks), (cache["v_scale"], vs)]
    return [(cache["k"], k), (cache["v"], v)]


def update_kv_cache(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                    index) -> dict:
    """Write one token (b, 1, kv, dh) at position `index`, IN PLACE: an int
    shared by the batch, or a (b,) tensor, each sequence at its own depth
    (continuous batching). Returns `cache`."""
    for buf, val in _cache_items(cache, k_new, v_new):
        val = val[:, 0].to(buf.dtype)
        if isinstance(index, int):
            buf[:, index] = val
        else:
            rows = torch.arange(buf.shape[0], device=buf.device)
            buf[rows, index.to(buf.device, torch.long)] = val
    return cache


def write_kv_prefix(cache: dict, k: torch.Tensor, v: torch.Tensor) -> dict:
    """Write a prompt's K/V (b, s, kv, dh) at positions [0, s), IN PLACE.
    Returns `cache`."""
    s = k.shape[1]
    for buf, val in _cache_items(cache, k, v):
        buf[:, :s] = val.to(buf.dtype)
    return cache


def _write_kv_block(cache: dict, k: torch.Tensor, v: torch.Tensor,
                    lo: int, hi: int) -> dict:
    """Write the prompt positions in [lo, hi) of K/V (b, s, kv, dh) into
    a cache block holding positions [lo, hi), IN PLACE."""
    n = max(0, min(hi, k.shape[1]) - lo)
    if n:
        for buf, val in _cache_items(cache, k[:, lo:lo + n],
                                     v[:, lo:lo + n]):
            buf[:, :n] = val.to(buf.dtype)
    return cache


def _update_kv_block(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                     index, lo: int, hi: int) -> dict:
    """`update_kv_cache` on a cache block holding positions [lo, hi): a
    sequence whose position lies outside it writes nothing here."""
    if isinstance(index, int):
        if lo <= index < hi:
            update_kv_cache(cache, k_new, v_new, index - lo)
        return cache
    idx = index.to(k_new.device, torch.long)
    inside = (idx >= lo) & (idx < hi)
    local = (idx - lo).clamp(0, hi - lo - 1)
    for buf, val in _cache_items(cache, k_new, v_new):
        rows = torch.arange(buf.shape[0], device=buf.device)
        val = val[:, 0].to(buf.dtype)
        buf[rows, local] = torch.where(inside[:, None, None], val,
                                       buf[rows, local])
    return cache


def read_kv_cache(cache: dict, dtype: torch.dtype = torch.bfloat16):
    """The whole cache's K and V in `dtype` (dequantized if int8)."""
    if "k_scale" in cache:
        k = cache["k"].float() * cache["k_scale"]
        v = cache["v"].float() * cache["v_scale"]
        return k.to(dtype), v.to(dtype)
    return cache["k"].to(dtype), cache["v"].to(dtype)

# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg) -> dict[str, ParamSpec]:
    """ParamSpecs of a SwiGLU (wi, wg, wo) or GELU (wi, bi, wo, bo) MLP."""
    d, f = cfg.d_model, cfg.d_ff
    out_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    if cfg.mlp_type == "swiglu":
        return {"wi": ParamSpec((d, f), ("embed", "ff"), init="fan_in"),
                "wg": ParamSpec((d, f), ("embed", "ff"), init="fan_in"),
                "wo": ParamSpec((f, d), ("ff", "embed"), init="fan_in",
                                scale=out_scale)}
    return {"wi": ParamSpec((d, f), ("embed", "ff"), init="fan_in"),
            "bi": ParamSpec((f,), ("ff",), init="zeros"),
            "wo": ParamSpec((f, d), ("ff", "embed"), init="fan_in",
                            scale=out_scale),
            "bo": ParamSpec((d,), ("embed",), init="zeros")}


class _Silu(torch.autograd.Function):
    """x * sigmoid(x) with `jax.nn.silu`'s gradient. The forward is
    sigmoid as 1 / (1 + exp(-x)) op by op, each rounded to x's dtype
    (bf16 results equal XLA's bit for bit). The backward is the
    reference's: g * (s + x * s * (1 - s)) from the saved sigmoid s, as
    `lax.logistic` differentiates. Autograd through the ops instead would
    multiply a zero gradient by exp(-x) = inf where x < -88 (bf16 and
    fp32 overflow there) and give NaN, where the reference's gradient is
    0."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * (s + x * (s * (1 - s)))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as `jax.nn.silu` computes it, forward and gradient
    (`_Silu`)."""
    return _Silu.apply(x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU (`jax.nn.gelu`'s default, not
    torch's erf one), op by op in x's dtype with its constants rounded to
    it, as the reference computes it."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    a = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + a * (x * x * x)))))


def mlp(p, x: torch.Tensor, cfg,
        dtype: torch.dtype = torch.bfloat16,
        rules: LogicalRules | None = None, mesh=None) -> torch.Tensor:
    """SwiGLU: silu(x wg) * (x wi) wo; GELU: gelu(x wi + bi) wo + bo, in
    the compute dtype. With a mesh, wi and wg (and bi) are column-parallel
    over the axes ff shards on, wo row-parallel: one all_reduce of the
    partial sums, bo added after it."""
    x = x.to(dtype)
    d, f = cfg.d_model, cfg.d_ff
    axes = {"wi": ("embed", "ff"), "wg": ("embed", "ff"),
            "wo": ("ff", "embed"), "bi": ("ff",), "bo": ("embed",)}
    shapes = {"wi": (d, f), "wg": (d, f), "wo": (f, d), "bi": (f,),
              "bo": (d,)}
    w = {k: gather_weight(t.to(dtype), axes[k], rules, mesh, shapes[k])
         for k, t in p.items()}
    tf = tp_axes("ff", f, rules, mesh)
    xin = M.copy_to(x, mesh, tf) if tf else x
    if cfg.mlp_type == "swiglu":
        y = (_silu(xin @ w["wg"]) * (xin @ w["wi"])) @ w["wo"]
    else:
        y = _gelu_tanh(xin @ w["wi"] + w["bi"]) @ w["wo"]
    if tf:
        y = shard_activation(y, ACT, rules, mesh, act_spec(rules, mesh),
                             partial=tf)
    return y if cfg.mlp_type == "swiglu" else y + w["bo"]
