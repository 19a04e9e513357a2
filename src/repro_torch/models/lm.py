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

Training over a mesh (`rules`, `mesh`: the step passes them, a
`launch.mesh.Mesh` and one of `nn.sharding`'s tables): each parameter is
this rank's `resolve_sized` block and the batch this rank's rows (the
block of ("batch", None, ...)); the layers run as `nn.layers`, `nn.moe`
and `nn.mamba2` say. The token embedding is vocab-parallel (out-of-block
ids masked, a local take, one all_reduce over the vocab's axes), as are
the logits and the loss: the row max, the sum of exponentials and the
target's logit are all-reduced over the vocab's axes, never the (B, S, V)
logits, and the masked nll sum and mask count over the batch's axes, so
every rank's loss is the global masked mean. Without a mesh, the
one-device model, bit for bit.

Serving over a mesh (`prefill_step` / `decode_step(rules=, mesh=)`,
SERVE_RULES, LONG_SERVE_RULES or the dry run's prefill override of
FSDP-stored weights): the caller passes the whole batch, every rank runs
its rows (those of ("batch", ...)) through its parameter blocks and
its blocks of the caches (`init_caches(rules=, mesh=)`: `cache_pspecs`'
blocks, a Mamba-2 conv tail by `nn.mamba2.conv_channels`), and every
rank gets the last position's logits whole: each rank's vocabulary block
gathered, then its rows.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import mesh as MESH
from repro_torch.nn import layers as L
from repro_torch.nn import mamba2 as M
from repro_torch.nn import moe as MOE
from repro_torch.nn.params import (ParamSpec, init_params, specs_to_shardings,
                                   stack_specs, tree_map)
from repro_torch.nn.sharding import (SERVE_RULES, TRAIN_RULES, LogicalRules,
                                     batch_axes, block_range,
                                     dim_axes, gather_weight,
                                     replicate_weight, resolve_sized,
                                     shard_activation, tp_axes, use_spec)

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
                                        (None, "vocab", "embed"),
                                        init="normal", scale=0.02)}
    else:
        embed = {"tok": ParamSpec((v, d), ("vocab", "embed"), init="normal",
                                  scale=0.02)}
    p = {"embed": embed,
         "blocks": {f"b{i}": stack_specs(_block_specs(cfg, kind, flags[i]),
                                         cfg.n_units)
                    for i, kind in enumerate(cfg.pattern)},
         "final_norm": L.norm_specs(d, cfg.norm_type)}
    if not cfg.tie_embeddings:
        out = v * cfg.n_codebooks if cfg.frontend == "audio" else v
        p["head"] = {"w": ParamSpec((d, out), ("embed", "vocab"),
                                    init="fan_in")}
    return p


def lm_param_shardings(cfg: ModelConfig, rules: LogicalRules, mesh) -> dict:
    """A `nn.sharding.NamedSharding` a parameter: where each rank's
    `resolve_sized` block of it lies on `mesh` under `rules`."""
    return specs_to_shardings(lm_param_specs(cfg), rules, mesh)


def shard_lm_params(params: dict, cfg: ModelConfig, rules: LogicalRules,
                    mesh) -> dict:
    """This rank's blocks of whole parameters (copies, so the whole tree
    can go)."""
    return tree_map(lambda sh, t: sh.shard(t).clone(),
                    lm_param_shardings(cfg, rules, mesh), params)


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


def _vocab_axes(cfg: ModelConfig, rules: LogicalRules, mesh) -> tuple:
    """The mesh axes the vocabulary splits over on the logits (none for
    the audio arch, whose K codebooks' columns an even split would cut
    across: its head is gathered and its logits computed whole)."""
    if cfg.frontend == "audio":
        return ()
    return tp_axes("vocab", cfg.vocab_size, rules, mesh)


def embed_input(params: dict, batch: dict, cfg: ModelConfig,
                positions: torch.Tensor | None = None,
                rules: LogicalRules = TRAIN_RULES, mesh=None
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
        table = gather_weight(params["embed"]["tok"], ("vocab", "embed"),
                              rules, mesh, (cfg.vocab_size, cfg.d_model))
        tokens = torch.as_tensor(batch["tokens"], device=dev).long()
        tv = _vocab_axes(cfg, rules, mesh)
        if tv:
            lo, hi = block_range(cfg.vocab_size, tv, mesh)
            inside = (tokens >= lo) & (tokens < hi)
            x = table[(tokens - lo).clamp(0, hi - lo - 1)]
            x = torch.where(inside[..., None], x, 0.0).to(dtype)
            x = shard_activation(x, L.ACT, rules, mesh,
                                 L.act_spec(rules, mesh), partial=tv)
        else:
            x = table[tokens].to(dtype)
    if cfg.frontend != "audio":
        if cfg.frontend == "vision":
            prefix = torch.as_tensor(batch["embeds"], device=dev)
            x = torch.cat([prefix.to(dtype), x], dim=1)
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=dev).expand(b, s)
    if cfg.sinusoidal_pos:
        x = x + L.sinusoidal_positions(positions, cfg.d_model).to(dtype)
    return x, positions


def lm_logits(params: dict, x: torch.Tensor, cfg: ModelConfig,
              rules: LogicalRules = TRAIN_RULES, mesh=None) -> torch.Tensor:
    """Final norm, then the tied embedding's transpose or the head; the
    audio arch's (B, S, V*K) reshaped to (B, S, K, V). With a mesh, this
    rank's rows and its block of the vocabulary (`_vocab_axes`)."""
    dtype = _dtype(cfg)
    x = L.apply_norm(params["final_norm"], x, cfg.norm_type, dtype=dtype,
                     rules=rules, mesh=mesh)
    v, d = cfg.vocab_size, cfg.d_model
    tv = _vocab_axes(cfg, rules, mesh)
    if tv:
        x = MESH.copy_to(x, mesh, tv)
    if cfg.tie_embeddings:
        logits = x @ gather_weight(params["embed"]["tok"].to(dtype),
                                   ("vocab", "embed"), rules, mesh,
                                   (v, d)).T
    elif cfg.frontend == "audio":
        logits = x @ replicate_weight(params["head"]["w"].to(dtype),
                                      ("embed", "vocab"), rules, mesh,
                                      (d, v * cfg.n_codebooks))
    else:
        logits = x @ gather_weight(params["head"]["w"].to(dtype),
                                   ("embed", "vocab"), rules, mesh, (d, v))
    if cfg.frontend == "audio":
        b, s, _ = logits.shape
        logits = logits.reshape(b, s, cfg.n_codebooks, cfg.vocab_size)
    return logits

# ---------------------------------------------------------------------------
# blocks and the forward
# ---------------------------------------------------------------------------


def _apply_block(bp: dict, x: torch.Tensor, cfg: ModelConfig, kind: str,
                 is_moe: bool, positions: torch.Tensor, mode: str,
                 cache: dict | None, cache_index,
                 rules: LogicalRules = TRAIN_RULES, mesh=None,
                 max_len: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One layer: norm, attention or Mamba-2 mixer, residual; then (if
    d_ff > 0) norm, MLP or MoE, residual. Returns (x, the MoE aux loss, or
    None without a router). `max_len`: the caches' global positions (an
    attention layer serving over a mesh needs them)."""
    dtype = _dtype(cfg)
    sh = {"rules": rules, "mesh": mesh}
    h = L.apply_norm(bp["ln1"], x, cfg.norm_type, dtype=dtype, **sh)
    if kind == "a":
        h, _ = L.attention(bp["attn"], h, cfg, positions, mode=mode,
                           cache=cache, cache_index=cache_index, dtype=dtype,
                           max_len=max_len, **sh)
    else:
        h, _ = M.mamba_block(bp["mamba"], h, cfg, mode=mode, cache=cache,
                             dtype=dtype, **sh)
    x = x + h
    aux = None
    if cfg.d_ff > 0:
        h = L.apply_norm(bp["ln2"], x, cfg.norm_type, dtype=dtype, **sh)
        if is_moe:
            h, aux = MOE.moe(bp["ffn"], h, cfg, dtype=dtype,
                             global_aux=mode == "train", **sh)
        else:
            h = L.mlp(bp["ffn"], h, cfg, dtype=dtype, **sh)
        x = x + h
    return x, aux


def _apply_unit(unit: dict, x: torch.Tensor, aux: torch.Tensor,
                cfg: ModelConfig, positions: torch.Tensor, mode: str,
                caches: dict | None, cache_index,
                rules: LogicalRules = TRAIN_RULES, mesh=None,
                max_len: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The blocks of one unit in pattern order, the MoE blocks' aux losses
    added to `aux`."""
    flags = _pattern_moe_flags(cfg)
    for i, kind in enumerate(cfg.pattern):
        name = f"b{i}"
        x, a = _apply_block(unit[name], x, cfg, kind, flags[i], positions,
                            mode, None if caches is None else caches[name],
                            cache_index, rules, mesh, max_len)
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
    positions, and the range is the max_len they were made for. A meta
    (b,) vector has no values to check (the dry run's): it is checked by
    shape alone; a meta scalar is refused (pass an int)."""
    idx = cache_index if isinstance(cache_index, torch.Tensor) \
        else torch.as_tensor(np.asarray(cache_index))
    if idx.dim() != 0 and idx.shape != (b,):
        raise ValueError(f"cache_index must be a scalar or ({b},), got "
                         f"{tuple(idx.shape)}")
    if idx.is_meta:
        if idx.dim() == 0:
            raise ValueError("a scalar cache_index on the meta device has "
                             "no value: pass an int")
        return idx.to(device=device, dtype=torch.long)
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
    """The caches' global positions: the max_len `init_caches` was given,
    else an attention block's KV length (caches made by hand)."""
    max_len = getattr(caches, "max_len", None)
    if max_len is not None:
        return max_len
    for i, kind in enumerate(cfg.pattern):
        if kind == "a":
            return caches[f"b{i}"]["k"].shape[2]
    if max_len is None:
        raise ValueError(f"{cfg.name} has no KV cache to bound a decode "
                         "position: pass the caches of init_caches, which "
                         "carry their max_len")
    return max_len


def lm_forward(params: dict, batch: dict, cfg: ModelConfig,
               mode: str = "train", caches: dict | None = None,
               cache_index=None, rules: LogicalRules = TRAIN_RULES,
               mesh=None
               ) -> tuple[torch.Tensor, torch.Tensor, dict | None]:
    """Returns (logits (B, S, V), or (B, S, K, V) for the audio arch,
    aux_loss, caches), as the reference.

    train: with autograd recording, each unit runs under `cfg.remat`
    (`_run_unit`); `lm_loss` differentiates it. prefill: writes the
    prompt's K/V at offset 0 and each mixer's conv tail and final state
    into `caches`, in place. decode: one token per sequence at
    `cache_index` (int or (B,)), written in place. aux_loss: the MoE
    layers' load-balancing losses summed over blocks in order (fp32, 0
    without experts; serving over a mesh, the rank's own groups'). With a
    `mesh`, `batch` and a (B,) `cache_index` are this rank's rows and
    `caches` its blocks (the module docstring)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if cfg.remat not in REMAT:
        raise ValueError(f"unknown remat {cfg.remat!r}; one of {REMAT}")
    if mode != "train" and caches is None:
        raise ValueError(f"{mode} needs caches (init_caches)")
    dev = _device(params)
    positions, index = None, None
    window = _window(caches, cfg) if caches is not None and (
        mode == "decode" or mesh is not None) else None
    if mode == "decode":
        if cache_index is None:
            raise ValueError("decode needs a cache_index")
        b = len(next(iter(batch.values())))
        index = _decode_index(cache_index, b, dev, window)
        positions = (torch.full((b, 1), index, device=dev)
                     if isinstance(index, int) else index[:, None])
    x, positions = embed_input(params, batch, cfg, positions, rules, mesh)
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
                           x, aux, cfg, positions, mode, unit_caches, index,
                           rules, mesh, window)
    return lm_logits(params, x, cfg, rules, mesh), aux, caches


def lm_loss(params: dict, batch: dict, cfg: ModelConfig,
            rules: LogicalRules = TRAIN_RULES, mesh=None
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
    train_4k cut to batch 4.

    With a mesh, `batch` is this rank's rows and the loss the global
    masked mean (the module docstring): the same value on every rank."""
    logits, aux, _ = lm_forward(params, batch, cfg, "train", rules=rules,
                                mesh=mesh)
    dev = logits.device
    targets = torch.as_tensor(batch["targets"], device=dev).long()
    mask = torch.as_tensor(batch["loss_mask"], device=dev,
                           dtype=torch.float32)
    lf = logits.float()
    del logits                       # the compute-dtype copy is not needed
    tv = _vocab_axes(cfg, rules, mesh)
    if tv:
        nll = _vocab_parallel_nll(lf, targets, cfg.vocab_size, tv, mesh)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        tgt = torch.take_along_dim(lf, targets[..., None], dim=-1)[..., 0]
        nll = lse - tgt                               # (B,S) or (B,S,K)
    if nll.dim() == 3:                                # audio codebooks
        nll = nll.mean(dim=-1)
    ba = batch_axes(rules, mesh)
    if ba:
        sums = MESH.reduce_from(torch.stack([(nll * mask).sum(),
                                             mask.sum()]), mesh, ba)
        ce = sums[0] / torch.clamp(sums[1], min=1.0)
    else:
        denom = torch.clamp(mask.sum(), min=1.0)
        ce = (nll * mask).sum() / denom
    total = ce + cfg.aux_loss_coef * aux
    return total, {"ce": ce, "aux": aux}


def _vocab_parallel_nll(lf: torch.Tensor, targets: torch.Tensor, v: int,
                        axes: tuple, mesh) -> torch.Tensor:
    """logsumexp minus the target's logit from this rank's vocabulary
    block `lf` (fp32): the row max all-reduced (max) over `axes`, then the
    block's sums of exp(x - max) and its target logit (0 where the target
    lies in another block) in one (..., 2) all_reduce, whose cotangent
    comes back whole (`launch.mesh.reduce_from`)."""
    mx = lf.detach().amax(-1).contiguous()
    for a in axes:
        mesh.all_reduce(mx, a, op="max")
    lo, hi = block_range(v, axes, mesh)
    inside = (targets >= lo) & (targets < hi)
    tgt = torch.take_along_dim(
        lf, (targets - lo).clamp(0, hi - lo - 1)[..., None], dim=-1)[..., 0]
    # exp in place on the difference's fresh tensor: one (..., V) fp32
    # temporary fewer, the same bits and gradient
    parts = torch.stack([(lf - mx[..., None]).exp_().sum(-1),
                         torch.where(inside, tgt, 0.0)], dim=-1)
    se, tgt = MESH.reduce_from(parts, mesh, axes).unbind(-1)
    return se.log() + mx - tgt

# ---------------------------------------------------------------------------
# caches and the serving steps
# ---------------------------------------------------------------------------


class Caches(dict):
    """The stacked caches of `init_caches`, by block name, and the number
    of positions they hold (`max_len`, global where they are a rank's
    blocks), which bounds a decode position."""

    def __init__(self, blocks: dict, max_len: int):
        super().__init__(blocks)
        self.max_len = max_len


def _unit_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                rules=None, mesh=None) -> dict:
    """One unit's caches (no leading n_units axis), this rank's blocks
    with a mesh."""
    out = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "a":
            out[f"b{i}"] = L.init_kv_cache(
                batch, max_len, cfg.n_kv_heads, cfg.d_head, torch.bfloat16,
                cfg.kv_cache_dtype == "int8", device, rules, mesh)
        else:
            out[f"b{i}"] = M.init_mamba_cache(batch, cfg, device, rules,
                                              mesh)
    return out


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device: str | torch.device | None = None,
                rules: LogicalRules | None = None, mesh=None) -> Caches:
    """Zeroed caches, stacked along a leading n_units axis, one per pattern
    position on `device` (default cuda): an attention block's {"k", "v"
    (+ "k_scale", "v_scale" for int8)} of (n_units, batch, max_len, n_kv,
    d_head), bf16 whatever the compute dtype; a mixer's {"conv" (n_units,
    batch, k-1, conv_dim) bf16, "ssm" (n_units, batch, h, p, n) fp32}, as
    the reference's. With `mesh` (and `rules`), this rank's blocks of the
    caches of `batch` sequences: `cache_pspecs`' blocks, but a mixer's
    conv tail, which holds the channels the rank convolves
    (`nn.mamba2.conv_channels`). `device` "meta" gives the shapes and
    dtypes alone."""
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    unit = _unit_cache(cfg, batch, max_len, dev, rules, mesh)
    return Caches({name: {k: t.new_zeros((cfg.n_units,) + t.shape)
                          for k, t in blocks.items()}
                   for name, blocks in unit.items()}, max_len)


def cache_abstract(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """`init_caches`' tensors on the meta device (the reference's
    ShapeDtypeStruct tree): shapes and dtypes, no memory."""
    out = {}
    for i, kind in enumerate(cfg.pattern):
        unit = L.kv_cache_abstract(
            batch, max_len, cfg.n_kv_heads, cfg.d_head, torch.bfloat16,
            cfg.kv_cache_dtype == "int8") if kind == "a" \
            else M.mamba_cache_abstract(batch, cfg)
        out[f"b{i}"] = {k: t.new_empty((cfg.n_units,) + t.shape)
                        for k, t in unit.items()}
    return out


def cache_pspecs(cfg: ModelConfig, rules: LogicalRules, mesh, batch: int,
                 max_len: int) -> dict:
    """The reference's spec tree of the caches (`cache_abstract`'s leaves),
    size-aware (`resolve_sized`: qwen's 40 kv heads do not split 16 ways,
    so the positions or nothing take the axis, as the rules say). `mesh`
    needs `axis_names` and a `shape` mapping."""
    out = {}
    kv_axes = ("layer",) + L.KV_CACHE_AXES
    for name, blocks in cache_abstract(cfg, batch, max_len).items():
        axes = {"conv": ("layer",) + M.MAMBA_CACHE_AXES["conv"],
                "ssm": ("layer",) + M.MAMBA_CACHE_AXES["ssm"]}
        out[name] = {k: resolve_sized(axes.get(k, kv_axes), rules, mesh,
                                      tuple(t.shape))
                     for k, t in blocks.items()}
    return out


def _rows(t, n: int, rules: LogicalRules, mesh):
    """This rank's rows of a whole-batch leaf `t` (n rows): the block of
    ("batch", ...) over the batch's mesh axes."""
    ba = batch_axes(rules, mesh)
    if not ba:
        return t
    lo, hi = block_range(n, ba, mesh)
    if (hi - lo) * math.prod(mesh.shape[a] for a in ba) != n:
        raise ValueError(f"a batch of {n} does not split over the batch's "
                         f"axes {ba}")
    return t[lo:hi]


def _whole_logits(logits: torch.Tensor, cfg: ModelConfig,
                  rules: LogicalRules, mesh) -> torch.Tensor:
    """The last position's logits (rows, V block) of every rank put
    together: each vocabulary block gathered over `_vocab_axes`, then
    every rank's rows over the batch's axes."""
    tv = _vocab_axes(cfg, rules, mesh)
    if tv:
        logits = MESH.all_gather(logits, mesh, tv, -1, partial_grad=False)
    ba = batch_axes(rules, mesh)
    if ba:
        logits = MESH.all_gather(logits, mesh, ba, 0, partial_grad=False)
    return logits


def _codebook_input(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                    rules: LogicalRules, mesh) -> torch.Tensor:
    """The audio arch's decode input: the sum of the K codebook
    embeddings of tokens (B, 1, K), fp32. With a mesh, over the codebook
    table's vocabulary block: ids outside it read 0, the rank's sum is
    all-reduced over the block's axes."""
    k_, v, d = cfg.n_codebooks, cfg.vocab_size, cfg.d_model
    axes = (None, "vocab", "embed")
    emb = gather_weight(params["embed"]["codebooks"], axes, rules, mesh,
                        (k_, v, d))                          # (K, V, D)
    tokens = torch.as_tensor(tokens, device=emb.device).long()
    tv = dim_axes(use_spec(axes, rules, mesh, (k_, v, d)), 1)
    lo, hi = block_range(v, tv, mesh)
    x = None
    for k in range(k_):
        t = tokens[..., k]
        e = emb[k][(t - lo).clamp(0, hi - lo - 1)]
        if tv:
            e = torch.where(((t >= lo) & (t < hi))[..., None], e, 0.0)
        x = e if x is None else x + e
    if tv:
        x = MESH.reduce_from(x, mesh, tv)
    return x


def decode_step(params: dict, tokens: torch.Tensor, caches: dict,
                cache_index, cfg: ModelConfig,
                rules: LogicalRules = SERVE_RULES, mesh=None
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence: tokens (B, 1), or (B, 1, K) codebook
    tokens for the audio arch, whose input is the sum of their K
    codebook embeddings (fp32, cast to the compute dtype); the vision arch
    decodes text with an empty patch prefix. Returns (logits (B, V), or
    (B, K, V), of the new position, caches), the caches written in
    place. With a `mesh`: `tokens` and a (B,) `cache_index` whole, the
    caches this rank's blocks (`init_caches(rules=, mesh=)`), the logits
    whole on every rank."""
    n = len(tokens)
    tokens = _rows(tokens, n, rules, mesh)
    if np.ndim(cache_index):
        cache_index = _rows(cache_index if isinstance(
            cache_index, torch.Tensor) else np.asarray(cache_index), n,
            rules, mesh)
    logits, caches = decode_rows(params, tokens, caches, cache_index, cfg,
                                 rules, mesh)
    return _whole_logits(logits, cfg, rules, mesh), caches


def decode_rows(params: dict, tokens: torch.Tensor, caches: dict,
                cache_index, cfg: ModelConfig,
                rules: LogicalRules = SERVE_RULES, mesh=None
                ) -> tuple[torch.Tensor, dict]:
    """`decode_step` on this rank's rows alone: `tokens` and a (b,)
    `cache_index` its rows, `caches` its blocks; returns its rows' logits
    (its vocabulary block) and the caches. A batch split over `data`
    issues no collective over the batch's axes here, so one `data`
    coordinate's ranks may run it alone (the engine's admission)."""
    if cfg.frontend == "audio":
        batch = {"embeds": _codebook_input(params, tokens, cfg, rules,
                                           mesh).to(_dtype(cfg))}
    elif cfg.frontend == "vision":
        batch = {"tokens": tokens,
                 "embeds": torch.zeros((len(tokens), 0, cfg.d_model),
                                       device=_device(params))}
    else:
        batch = {"tokens": tokens}
    logits, _, caches = lm_forward(params, batch, cfg, "decode", caches,
                                   cache_index, rules, mesh)
    return logits[:, -1], caches


def prefill_step(params: dict, batch: dict, caches: dict, cfg: ModelConfig,
                 rules: LogicalRules = SERVE_RULES, mesh=None
                 ) -> tuple[torch.Tensor, dict]:
    """Run the whole prompt once, filling the caches in place. Returns
    (last-position logits (B, V), caches). With a `mesh`, `batch` whole,
    the caches this rank's blocks, the logits whole on every rank."""
    n = len(next(iter(batch.values())))
    local = {k: _rows(v, n, rules, mesh) for k, v in batch.items()}
    logits, _, caches = lm_forward(params, local, cfg, "prefill", caches,
                                   rules=rules, mesh=mesh)
    return _whole_logits(logits[:, -1], cfg, rules, mesh), caches
