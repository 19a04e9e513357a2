"""Layers of the port: the dense layers of the DLRM towers, and the LM
layer zoo's dense family (norms, RoPE, sinusoidal positions, GQA
attention with a bf16 or int8 KV cache, SwiGLU / GELU MLPs). Weights keep
the reference's layouts, so
`y = x @ w + b` matches `repro.nn.layers.linear`, and the attention
weights are (d, h, dh) and (h, dh, d)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.nn.params import ParamSpec


def linear_specs(d_in: int, d_out: int, bias: bool = False,
                 scale: float = 1.0) -> dict[str, ParamSpec]:
    """ParamSpecs of one (d_in, d_out) linear layer (+ zero bias)."""
    specs = {"w": ParamSpec((d_in, d_out), init="fan_in", scale=scale,
                            fan_axis=-2)}
    if bias:
        specs["b"] = ParamSpec((d_out,), init="zeros")
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
    specs = {"scale": ParamSpec((d,), init="ones")}
    if kind == "layernorm":
        specs["bias"] = ParamSpec((d,), init="zeros")
    return specs


def apply_norm(p: dict[str, torch.Tensor], x: torch.Tensor,
               kind: str = "rmsnorm", eps: float = 1e-5,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, in fp32, cast to dtype.
    LayerNorm's variance is the biased one, as `jnp.var`'s."""
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
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
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
        "wq": ParamSpec((d, h, dh), init="fan_in", fan_axis=0),
        "wk": ParamSpec((d, kv, dh), init="fan_in", fan_axis=0),
        "wv": ParamSpec((d, kv, dh), init="fan_in", fan_axis=0),
        "wo": ParamSpec((h, dh, d), init="fan_in", fan_axis=1,
                        scale=1.0 / math.sqrt(2 * max(cfg.n_layers, 1))),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((h, dh), init="zeros")
        specs["bk"] = ParamSpec((kv, dh), init="zeros")
        specs["bv"] = ParamSpec((kv, dh), init="zeros")
    return specs


def _project(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one (d, h*dh) matmul."""
    d, h, dh = w.shape
    return (x @ w.to(dtype).reshape(d, h * dh)).unflatten(-1, (h, dh))


def _qkv(p, x, cfg, positions, dtype):
    q = _project(x, p["wq"], dtype)
    k = _project(x, p["wk"], dtype)
    v = _project(x, p["wv"], dtype)
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
              dtype: torch.dtype = torch.bfloat16
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
    prompts take `full_attention`."""
    q, k, v = _qkv(p, x.to(dtype), cfg, positions, dtype)
    if mode == "decode":
        if cache is None or cache_index is None:
            raise ValueError("decode needs a cache and a cache_index")
        update_kv_cache(cache, k, v, cache_index)
        kf, vf = read_kv_cache(cache, dtype)
        kf = _repeat_kv(kf, cfg.n_heads)
        vf = _repeat_kv(vf, cfg.n_heads)
        out = full_attention(q, kf, vf, causal=False,
                             kv_valid_len=cache_index + 1)
    elif mode in ("train", "prefill"):
        if mode == "prefill":
            if cache is None:
                raise ValueError("prefill needs a cache")
            write_kv_prefix(cache, k, v)
        k = _repeat_kv(k, cfg.n_heads)
        v = _repeat_kv(v, cfg.n_heads)
        s = x.shape[1]
        if s > cfg.attn_block_q and s % cfg.attn_block_q == 0:
            if s % cfg.attn_block_k:
                raise ValueError(
                    f"a sequence of {s} takes the blockwise branch "
                    f"(> attn_block_q={cfg.attn_block_q} and a multiple of "
                    f"it) but is not a multiple of attn_block_k="
                    f"{cfg.attn_block_k}")
            out = ops.flash_attention(q, k, v, causal=True)
        else:
            out = full_attention(q, k, v)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    wo = p["wo"].to(dtype)
    h, dh, d = wo.shape
    y = out.reshape(*out.shape[:2], h * dh) @ wo.reshape(h * dh, d)
    return y, cache

# ---------------------------------------------------------------------------
# KV cache (bf16, or int8 with per-token-head fp32 scales)
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, max_len: int, n_kv: int, d_head: int,
                  dtype: torch.dtype = torch.bfloat16,
                  quantized: bool = False, device=None) -> dict:
    """Zeroed K/V cache of one layer: (batch, max_len, n_kv, d_head)."""
    shape = (batch, max_len, n_kv, d_head)
    if quantized:
        scale = (batch, max_len, n_kv, 1)
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
        return {"wi": ParamSpec((d, f), init="fan_in"),
                "wg": ParamSpec((d, f), init="fan_in"),
                "wo": ParamSpec((f, d), init="fan_in", scale=out_scale)}
    return {"wi": ParamSpec((d, f), init="fan_in"),
            "bi": ParamSpec((f,), init="zeros"),
            "wo": ParamSpec((f, d), init="fan_in", scale=out_scale),
            "bo": ParamSpec((d,), init="zeros")}


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
        dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """SwiGLU: silu(x wg) * (x wi) wo; GELU: gelu(x wi + bi) wo + bo, in
    the compute dtype."""
    x = x.to(dtype)
    w = {k: t.to(dtype) for k, t in p.items()}
    if cfg.mlp_type == "swiglu":
        return (_silu(x @ w["wg"]) * (x @ w["wi"])) @ w["wo"]
    return _gelu_tanh(x @ w["wi"] + w["bi"]) @ w["wo"] + w["bo"]
