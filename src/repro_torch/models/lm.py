"""Causal LM of the port: the reference's unified decoder for every LM
family (GQA attention with neox / glm / no RoPE, partial rotary, optional
QKV bias, SwiGLU or GELU MLPs or top-k MoE, Mamba-2 mixers, per-period
layer patterns as Jamba's, RMSNorm or LayerNorm, tied or untied head) and
the reference's two stub frontends: the vision arch takes precomputed
patch embeddings as a prefix before its token embeddings, the audio arch
takes precomputed frame embeddings, adds sinusoidal positions and
predicts K parallel codebooks through a V*K head.

Parameters keep the reference's stacked layout: one block `b{i}` per
position of the layer pattern, each tensor with a leading n_units axis,
so `lm_params_from_jax` copies the reference's tree as it is. The
reference's `scan` over units is a Python loop over that axis. `lm_loss`
is the training objective; in train mode with autograd recording, each
unit runs under the config's `remat` (activation checkpointing).

Caches are written IN PLACE by `prefill_step` and `decode_step` (the
reference returns updated copies); both return the caches they were given.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.nn import layers as L
from repro_torch.nn import mamba2 as M
from repro_torch.nn import moe as MOE
from repro_torch.nn.params import ParamSpec, init_params, stack_specs

MODES = ("train", "prefill", "decode")
REMAT = ("none", "dots", "full")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _block_specs(cfg: ModelConfig, kind: str, is_moe: bool) -> dict:
    specs = {"ln1": L.norm_specs(cfg.d_model, cfg.norm_type)}
    if kind == "a":
        specs["attn"] = L.attention_specs(cfg)
    elif kind == "m":
        specs["mamba"] = M.mamba_specs(cfg)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if cfg.d_ff > 0:
        specs["ln2"] = L.norm_specs(cfg.d_model, cfg.norm_type)
        specs["ffn"] = MOE.moe_specs(cfg) if is_moe else L.mlp_specs(cfg)
    return specs


def _pattern_moe_flags(cfg: ModelConfig) -> tuple[bool, ...]:
    """MoE-ness per pattern position, the same in every unit."""
    period = len(cfg.pattern)
    if cfg.n_experts > 0 and period % cfg.moe_every:
        raise ValueError(f"{cfg.name}: a pattern period of {period} is not "
                         f"a multiple of moe_every={cfg.moe_every}")
    return tuple(cfg.is_moe_layer(i) for i in range(period))


def lm_param_specs(cfg: ModelConfig) -> dict:
    """ParamSpec tree: the token embedding (the audio arch: K codebook
    tables, "codebooks" (K, V, D)), one stacked block per pattern position
    ("b0", "b1", ...), the final norm and, when untied, the head ((D, V*K)
    for the audio arch)."""
    v, d = cfg.vocab_size, cfg.d_model
    flags = _pattern_moe_flags(cfg)
    if cfg.frontend == "audio":
        embed = {"codebooks": ParamSpec((cfg.n_codebooks, v, d),
                                        init="normal", scale=0.02)}
    else:
        embed = {"tok": ParamSpec((v, d), init="normal", scale=0.02)}
    p = {"embed": embed,
         "blocks": {f"b{i}": stack_specs(_block_specs(cfg, kind, flags[i]),
                                         cfg.n_units)
                    for i, kind in enumerate(cfg.pattern)},
         "final_norm": L.norm_specs(d, cfg.norm_type)}
    if not cfg.tie_embeddings:
        out = v * cfg.n_codebooks if cfg.frontend == "audio" else v
        p["head"] = {"w": ParamSpec((d, out), init="fan_in")}
    return p


def init_lm_params(cfg: ModelConfig, seed: int,
                   device: str | torch.device | None = None) -> dict:
    """Parameters from a `torch.Generator` seeded `seed`, fp32, on `device`
    (default cuda; raises without it)."""
    return init_params(lm_param_specs(cfg), seed, resolve_device(device))

# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _device(params: dict) -> torch.device:
    """The device the parameters lie on."""
    return next(iter(params["embed"].values())).device


def embed_input(params: dict, batch: dict, cfg: ModelConfig,
                positions: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The input embeddings (B, S, D) in the compute dtype, and positions
    (B, S): `positions` from the decode path, else arange(S).

    Token archs look up batch["tokens"]; the vision arch puts
    batch["embeds"] (B, P, D), the patch prefix, before its tokens'
    embeddings; the audio arch takes batch["embeds"] (B, S, D) as they
    are. With `sinusoidal_pos`, the fp32 positional embedding of each
    position, cast to the compute dtype, is added."""
    dtype = _dtype(cfg)
    dev = _device(params)
    if cfg.frontend == "audio":
        x = torch.as_tensor(batch["embeds"], device=dev).to(dtype)
    else:
        table = params["embed"]["tok"]
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        x = table[tokens.long()].to(dtype)
        if cfg.frontend == "vision":
            prefix = torch.as_tensor(batch["embeds"], device=dev)
            x = torch.cat([prefix.to(dtype), x], dim=1)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=dev).expand(b, s)
    if cfg.sinusoidal_pos:
        x = x + L.sinusoidal_positions(positions, cfg.d_model).to(dtype)
    return x, positions


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """Final norm, then the tied embedding's transpose or the head; the
    audio arch's (B, S, V*K) reshaped to (B, S, K, V)."""
    dtype = _dtype(cfg)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type, dtype=dtype)
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["tok"].to(dtype).T
    else:
        logits = x @ params["head"]["w"].to(dtype)
    if cfg.frontend == "audio":
        b, s, _ = logits.shape
        logits = logits.reshape(b, s, cfg.n_codebooks, cfg.vocab_size)
    return logits

# ---------------------------------------------------------------------------
# blocks and the forward
# ---------------------------------------------------------------------------


def _apply_block(bp: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 is_moe: bool, positions: torch.Tensor, mode: str,
                 cache: dict | None, cache_index
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer: norm, attention or Mamba-2 mixer, residual; then (if
    d_ff > 0) norm, MLP or MoE, residual. Returns (x, the MoE aux loss, or
    None without a router)."""
    dtype = _dtype(cfg)
    h = L.apply_norm(bp["ln1"], x, cfg.norm_type, dtype=dtype)
    if kind == "a":
        h, _ = L.attention(bp["attn"], h, cfg, positions, mode=mode,
                           cache=cache, cache_index=cache_index, dtype=dtype)
    else:
        h, _ = M.mamba_block(bp["mamba"], h, cfg, mode=mode, cache=cache,
                             dtype=dtype)
    x = x + h
    aux = None
    if cfg.d_ff > 0:
        h = L.apply_norm(bp["ln2"], x, cfg.norm_type, dtype=dtype)
        if is_moe:
            h, aux = MOE.moe(bp["ffn"], h, cfg, dtype=dtype)
        else:
            h = L.mlp(bp["ffn"], h, cfg, dtype=dtype)
        x = x + h
    return x, aux


def _apply_unit(unit: dict, x: torch.Tensor, aux: torch.Tensor,
                cfg: ModelConfig, positions: torch.Tensor, mode: str,
                caches: dict | None, cache_index
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The blocks of one unit in pattern order, the MoE blocks' aux losses
    added to `aux`."""
    flags = _pattern_moe_flags(cfg)
    for i, kind in enumerate(cfg.pattern):
        name = f"b{i}"
        x, a = _apply_block(unit[name], x, cfg, kind, flags[i], positions,
                            mode, None if caches is None else caches[name],
                            cache_index)
        if a is not None:
            aux = aux + a
    return x, aux


def _decode_index(cache_index, b: int, device,
                  max_len: int) -> int | torch.Tensor:
    """A decode position: a Python int shared by the batch, or a (b,) long
    tensor on `device` of per-slot positions (continuous batching).

    Raises ValueError on the host for a position outside [0, max_len),
    before any cache is indexed. The reference clamps such a scalar (its
    dynamic_update_slice writes the last row) and drops such an entry of a
    vector (its scatter skips it); the port refuses both, since either
    would silently serve a token from the wrong cache row, and on the card
    an out-of-range vector entry would trip a device-side assert that ends
    the process's CUDA context. An attention-free model's caches hold no
    positions, and the range is the max_len they were made for."""
    idx = cache_index if isinstance(cache_index, torch.Tensor) \
        else torch.as_tensor(np.asarray(cache_index))
    if idx.dim() != 0 and idx.shape != (b,):
        raise ValueError(f"cache_index must be a scalar or ({b},), got "
                         f"{tuple(idx.shape)}")
    host = idx.cpu()
    if bool(((host < 0) | (host >= max_len)).any()):
        raise ValueError(f"cache_index {host.tolist()} outside the caches' "
                         f"[0, {max_len})")
    if idx.dim() == 0:
        return int(host)
    return idx.to(device=device, dtype=torch.long)


#: the weight products, whose outputs remat="dots" keeps: the counterpart
#: of `dots_with_no_batch_dims_saveable` (the attention products are
#: batched, bmm or the kernel, and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _run_unit(remat: str, fn, *args):
    """fn(*args) under the reference's remat modes: "full" keeps only the
    unit's input and recomputes the rest in the backward, "dots" keeps the
    weight products' outputs as well, "none" keeps everything. The three
    give the same bits, on the card too: a recompute repeats the same
    operations on the same inputs, and no operation adds floats in an
    order that varies from run to run (the MoE counts its routed pairs in
    integers, sums each token's k outputs in order and differentiates its
    gathers as gathers)."""
    if remat == "none":
        return fn(*args)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_dots))
    return checkpoint(fn, *args, use_reentrant=False)


def _unstack(tree: dict, n: int) -> list[dict]:
    """The n units' parameter trees of a stacked tree, by one `unbind` per
    stacked tensor: its gradient is one stack of the units' gradients,
    where indexing unit by unit would scatter each into a zeroed
    full-size tensor."""
    subs = {k: (_unstack(v, n) if isinstance(v, dict) else v.unbind(0))
            for k, v in tree.items()}
    return [{k: sub[u] for k, sub in subs.items()} for u in range(n)]


def _window(caches: dict, cfg: ModelConfig) -> int:
    """The caches' positions: an attention block's KV length, else the
    max_len `init_caches` was given (an attention-free model)."""
    for i, kind in enumerate(cfg.pattern):
        if kind == "a":
            return caches[f"b{i}"]["k"].shape[2]
    max_len = getattr(caches, "max_len", None)
    if max_len is None:
        raise ValueError(f"{cfg.name} has no KV cache to bound a decode "
                         "position: pass the caches of init_caches, which "
                         "carry their max_len")
    return max_len


def lm_forward(params: dict, batch: dict, cfg: ModelConfig,
               mode: str = "train", caches: dict | None = None,
               cache_index=None
               ) -> tuple[torch.Tensor, torch.Tensor, dict | None]:
    """Returns (logits (B, S, V), or (B, S, K, V) for the audio arch,
    aux_loss, caches), as the reference.

    train: with autograd recording, each unit runs under `cfg.remat`
    (`_run_unit`); `lm_loss` differentiates it. prefill: writes the
    prompt's K/V at offset 0 and each mixer's conv tail and final state
    into `caches`, in place. decode: one token per sequence at
    `cache_index` (int or (B,)), written in place. aux_loss: the MoE
    layers' load-balancing losses summed over blocks in order (fp32, 0
    without experts)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if cfg.remat not in REMAT:
        raise ValueError(f"unknown remat {cfg.remat!r}; one of {REMAT}")
    if mode != "train" and caches is None:
        raise ValueError(f"{mode} needs caches (init_caches)")
    dev = _device(params)
    positions, index = None, None
    if mode == "decode":
        if cache_index is None:
            raise ValueError("decode needs a cache_index")
        b = len(next(iter(batch.values())))
        index = _decode_index(cache_index, b, dev, _window(caches, cfg))
        positions = (torch.full((b, 1), index, device=dev)
                     if isinstance(index, int) else index[:, None])
    x, positions = embed_input(params, batch, cfg, positions)
    units = {name: _unstack(tree, cfg.n_units)
             for name, tree in params["blocks"].items()}
    remat = cfg.remat if mode == "train" and torch.is_grad_enabled() \
        else "none"
    aux = torch.zeros((), device=dev)
    for u in range(cfg.n_units):
        unit_caches = None if caches is None else \
            {name: {k: t[u] for k, t in caches[name].items()}
             for name in units}
        x, aux = _run_unit(remat, _apply_unit,
                           {name: sub[u] for name, sub in units.items()},
                           x, aux, cfg, positions, mode, unit_caches, index)
    return lm_logits(params, x, cfg), aux, caches


def lm_loss(params: dict, batch: dict, cfg: ModelConfig
            ) -> tuple[torch.Tensor, dict]:
    """The reference's training objective: the train-mode forward, then
    per position the fp32 logsumexp of the logits minus the target's
    logit (the mean over codebooks for (B, S, K) targets), the mean over
    the loss mask (divided by max(mask.sum(), 1)), and total = ce +
    aux_loss_coef * aux. Returns (total, {"ce", "aux"}).

    The target's logit is `take_along_dim`, where the reference contracts
    the logits with a one-hot of the vocabulary (a gather would all-gather
    its model-sharded vocab axis). For finite logits both give the same
    bits, as every other term of the contraction is +-0, and the one-hot
    would be another (B, S, V) fp32 tensor: 6.6 GB at stablelm-1.6b's
    train_4k cut to batch 4."""
    logits, aux, _ = lm_forward(params, batch, cfg, "train")
    dev = logits.device
    targets = torch.as_tensor(batch["targets"], device=dev).long()
    mask = torch.as_tensor(batch["loss_mask"], device=dev,
                           dtype=torch.float32)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.take_along_dim(lf, targets[..., None], dim=-1)[..., 0]
    nll = lse - tgt                                   # (B,S) or (B,S,K)
    if nll.dim() == 3:                                # audio codebooks
        nll = nll.mean(dim=-1)
    denom = torch.clamp(mask.sum(), min=1.0)
    ce = (nll * mask).sum() / denom
    total = ce + cfg.aux_loss_coef * aux
    return total, {"ce": ce, "aux": aux}

# ---------------------------------------------------------------------------
# caches and the serving steps
# ---------------------------------------------------------------------------


class Caches(dict):
    """The stacked caches of `init_caches`, by block name, and the number
    of positions they hold (`max_len`), which bounds a decode position
    where no block has a KV cache."""

    def __init__(self, blocks: dict, max_len: int):
        super().__init__(blocks)
        self.max_len = max_len


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: str | torch.device | None = None) -> Caches:
    """Zeroed caches, stacked along a leading n_units axis, one per pattern
    position on `device` (default cuda): an attention block's {"k", "v"
    (+ "k_scale", "v_scale" for int8)} of (n_units, batch, max_len, n_kv,
    d_head), bf16 whatever the compute dtype; a mixer's {"conv" (n_units,
    batch, k-1, conv_dim) bf16, "ssm" (n_units, batch, h, p, n) fp32}, as
    the reference's."""
    dev = resolve_device(device)
    out = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "a":
            unit = L.init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.d_head,
                                   torch.bfloat16,
                                   cfg.kv_cache_dtype == "int8", dev)
        else:
            unit = M.init_mamba_cache(batch, cfg, dev)
        out[f"b{i}"] = {k: t.new_zeros((cfg.n_units,) + t.shape)
                        for k, t in unit.items()}
    return Caches(out, max_len)


def decode_step(params: dict, tokens: torch.Tensor, caches: dict,
                cache_index, cfg: ModelConfig
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence: tokens (B, 1), or (B, 1, K) codebook
    tokens for the audio arch, whose input is the sum of their K
    codebook embeddings (fp32, cast to the compute dtype); the vision arch
    decodes text with an empty patch prefix. Returns (logits (B, V), or
    (B, K, V), of the new position, caches), the caches written in
    place."""
    if cfg.frontend == "audio":
        emb = params["embed"]["codebooks"]                     # (K, V, D)
        tokens = torch.as_tensor(tokens, device=emb.device).long()
        x = emb[0][tokens[..., 0]]
        for k in range(1, cfg.n_codebooks):
            x = x + emb[k][tokens[..., k]]
        batch = {"embeds": x.to(_dtype(cfg))}
    elif cfg.frontend == "vision":
        batch = {"tokens": tokens,
                 "embeds": torch.zeros((len(tokens), 0, cfg.d_model),
                                       device=_device(params))}
    else:
        batch = {"tokens": tokens}
    logits, _, caches = lm_forward(params, batch, cfg, "decode", caches,
                                   cache_index)
    return logits[:, -1], caches


def prefill_step(params: dict, batch: dict, caches: dict, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, dict]:
    """Run the whole prompt once, filling the caches in place. Returns
    (last-position logits (B, V), caches)."""
    logits, _, caches = lm_forward(params, batch, cfg, "prefill", caches)
    return logits[:, -1], caches
