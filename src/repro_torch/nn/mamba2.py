"""Mamba-2 (SSD, state-space duality) mixer, the port of the reference's
`nn/mamba2.py` as torch ops: chunked-parallel for train and prefill, an
O(1)-state recurrence for decode (arXiv:2405.21060's minimal SSD).

Within a chunk the output is a masked (semiseparable) product; across
chunks a loop over the chunks carries the (heads, headdim, state) tensor.
The decay math stays in fp32. The products over the state axis are done
once per B/C group and shared by the group's heads, where the reference
repeats B and C to every head first: the same sums.

Caches are written IN PLACE, as the port's KV caches: {"conv" (b, k-1,
conv_dim), the last k-1 conv inputs, bf16; "ssm" (b, h, p, n) fp32}.
Prefill stores its final scan state into the fp32 "ssm" buffer; the
reference returns the scan's own state, which is bf16 under bf16 compute
and then stays bf16 through its decode steps.

Over a mesh, training gathers the mixer's parameters whole (`_whole`).
Serving splits the SSD heads, which are independent, over the axes
`ssm_heads` shards on (`serve_heads`): a rank projects, convolves and
scans its heads (and the B / C groups they read) and holds their "ssm"
state, `cache_pspecs`' block exactly. Its "conv" tail holds the channels
it convolves: its heads' x channels and its groups' B and C
(`conv_channels`), where `cache_pspecs` cuts conv_dim into even blocks
that do not fall on a head's edge (at mamba2-780m on 4 ranks 1,024 of
3,328 channels a rank against 832: 6,144 bytes a sequence a layer
against 4,992, beside the 393,216 of its state, and no exchange a
step).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.launch import mesh as MESH
from repro_torch.nn.layers import ACT, _silu, act_spec
from repro_torch.nn.params import ParamSpec
from repro_torch.nn.sharding import (NamedSharding, block_range, dim_axes,
                                     gather_weight, replicate_weight,
                                     resolve_sized, shard_activation,
                                     tp_axes, use_spec)


def mamba_dims(cfg) -> dict[str, int]:
    """The mixer's widths: in_proj gives z (d_inner), x (d_inner), B (g*n),
    C (g*n), dt (h); the conv runs over x, B and C (conv_dim)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_headdim
    return {
        "d_inner": d_inner,
        "n_heads": n_heads,
        "headdim": cfg.ssm_headdim,
        "d_state": cfg.ssm_state,
        "n_groups": cfg.ssm_ngroups,
        "d_conv": cfg.ssm_conv,
        "d_in_proj": 2 * d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        + n_heads,
        "conv_dim": d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state,
    }


def mamba_specs(cfg) -> dict[str, ParamSpec]:
    """ParamSpecs of one mixer (dt_bias softplus^-1(1), A_log 0, D 1)."""
    d = cfg.d_model
    m = mamba_dims(cfg)
    out_scale = 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))
    return {
        "in_proj": ParamSpec((d, m["d_in_proj"]), ("embed", "ssm_inner"),
                             init="fan_in"),
        "conv_w": ParamSpec((m["d_conv"], m["conv_dim"]),
                            (None, "conv_dim"), init="fan_in", fan_axis=0),
        "conv_b": ParamSpec((m["conv_dim"],), ("conv_dim",), init="zeros"),
        "dt_bias": ParamSpec((m["n_heads"],), ("ssm_heads",),
                             init="constant", scale=math.log(math.e - 1)),
        "A_log": ParamSpec((m["n_heads"],), ("ssm_heads",),
                           init="constant", scale=0.0),
        "D": ParamSpec((m["n_heads"],), ("ssm_heads",), init="ones"),
        "norm_scale": ParamSpec((m["d_inner"],), ("ssm_inner",),
                                init="ones"),
        "out_proj": ParamSpec((m["d_inner"], d), ("ssm_inner", "embed"),
                              init="fan_in", scale=out_scale),
    }


def _segsum(logdec: torch.Tensor) -> torch.Tensor:
    """logdec (..., l) -> (..., l, l): L[i, j] = sum(logdec[j+1 .. i]) for
    j <= i, -inf above the diagonal (exp gives exactly 0 there)."""
    ln = logdec.shape[-1]
    cs = logdec.cumsum(-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(ln, ln, dtype=torch.bool, device=logdec.device).tril()
    return diff.masked_fill_(~mask, -math.inf)


def _by_group(t: torch.Tensor, g: int) -> torch.Tensor:
    """(..., h, x, y) -> (..., g, rep * x, y) for heads h = g * rep, head
    j*rep + r serving group j (`jnp.repeat` order)."""
    *lead, h, a, c = t.shape
    return t.reshape(*lead, g, h // g * a, c)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD scan. x: (b, s, h, p); dt: (b, s, h) fp32; A: (h,) fp32,
    negative; B, C: (b, s, g, n) with h % g == 0. Returns (y (b, s, h, p)
    in x's dtype, final state (b, h, p, n) in x's dtype).

    s must be a multiple of `chunk` (ValueError otherwise, where the
    reference asserts)."""
    b, s, h, p = x.shape
    g, n = B.shape[-2], B.shape[-1]
    if s % chunk:
        raise ValueError(f"a sequence of {s} does not split into chunks of "
                         f"{chunk}")
    nc, rep, dtype = s // chunk, h // g, x.dtype

    # fold dt into x; the per-step log decay stays fp32
    xdt = x * dt.to(dtype)[..., None]                        # (b, s, h, p)
    logdec = dt * A                                           # (b, s, h)
    xc = xdt.reshape(b, nc, chunk, h, p)
    dc = logdec.reshape(b, nc, chunk, h).transpose(2, 3)      # (b, c, h, l)
    Bg = B.reshape(b, nc, chunk, g, n).transpose(2, 3)        # (b, c, g, l, n)
    Cg = C.reshape(b, nc, chunk, g, n).transpose(2, 3)

    # 1. intra-chunk (diagonal blocks): Y = (C B^T o L) X
    L = torch.exp(_segsum(dc))                                # (b,c,h,l,l)
    scores = Cg @ Bg.transpose(-1, -2)                        # (b,c,g,l,m)
    masked = (scores[:, :, :, None] * L.to(scores.dtype).unflatten(
        2, (g, rep))).flatten(2, 3)                           # (b,c,h,l,m)
    del L
    y_diag = masked @ xc.permute(0, 1, 3, 2, 4)               # (b,c,h,l,p)
    del masked

    # 2. chunk final states: S_c = sum_m decay_to_end[m] B_m x_m^T
    dcum = dc.cumsum(-1)                                      # (b, c, h, l)
    dec_to_end = torch.exp(dcum[..., -1:] - dcum)
    xw = xc.permute(0, 1, 3, 4, 2) * dec_to_end.to(dtype)[:, :, :, None]
    states = (_by_group(xw, g) @ Bg).reshape(b, nc, h, p, n)  # (b,c,h,p,n)

    # 3. inter-chunk recurrence, one chunk at a time
    chunk_decay = torch.exp(dcum[..., -1])                    # (b, c, h)
    st = x.new_zeros(b, h, p, n)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None].to(dtype) + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (b,c,h,p,n)

    # 4. inter-chunk output: Y_off = C_l . (decay_from_start[l] S_{c-1})
    dec_from_start = torch.exp(dcum).to(dtype)                # (b, c, h, l)
    y_off = (Cg @ _by_group(prev_states, g).transpose(-1, -2))  # (b,c,g,l,rp)
    y_off = y_off.unflatten(-1, (rep, p)).permute(0, 1, 3, 2, 4, 5) \
        .reshape(b, nc, chunk, h, p)
    y_off = y_off * dec_from_start.transpose(2, 3)[..., None]
    y = y_diag.transpose(2, 3) + y_off                        # (b,c,l,h,p)
    return y.reshape(b, s, h, p), st


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One recurrent step. state: (b, h, p, n); x_t: (b, h, p); dt_t: (b,
    h) fp32; B_t, C_t: (b, g, n). Returns (y_t (b, h, p), new_state in
    state's dtype)."""
    h, g = x_t.shape[1], B_t.shape[1]
    Bh = B_t.repeat_interleave(h // g, dim=1)                 # (b, h, n)
    Ch = C_t.repeat_interleave(h // g, dim=1)
    dec = torch.exp(dt_t * A)                                 # (b, h)
    upd = (x_t * dt_t[..., None])[..., None] * Bh[:, :, None, :]
    new_state = state * dec[..., None, None].to(state.dtype) + \
        upd.to(state.dtype)
    y = (new_state @ Ch.to(state.dtype)[..., None])[..., 0]
    return y, new_state


def _causal_conv_train(xBC, w, bias):
    """xBC: (b, s, c); w: (k, c) depthwise causal conv, tap by tap."""
    k, s = w.shape[0], xBC.shape[1]
    pad = torch.nn.functional.pad(xBC, (0, 0, k - 1, 0))
    out = torch.zeros_like(xBC)
    for i in range(k):
        out = out + pad[:, i:i + s] * w[i]
    return out + bias


def _split_in_proj(zxbcdt, m):
    """z, xBC, dt of the in_proj output."""
    di, cd = m["d_inner"], m["conv_dim"]
    return zxbcdt[..., :di], zxbcdt[..., di:di + cd], zxbcdt[..., di + cd:]


def _split_conv(xBC_c, m):
    """x as (b, s, h, p), B and C as (b, s, g, n) of the conv output."""
    b, s, _ = xBC_c.shape
    di, gn = m["d_inner"], m["n_groups"] * m["d_state"]
    xs = xBC_c[..., :di].reshape(b, s, m["n_heads"], m["headdim"])
    Bm = xBC_c[..., di:di + gn].reshape(b, s, m["n_groups"], m["d_state"])
    Cm = xBC_c[..., di + gn:].reshape(b, s, m["n_groups"], m["d_state"])
    return xs, Bm, Cm


MODES = ("train", "prefill", "decode")


@functools.lru_cache(maxsize=None)
def _zero(device: torch.device) -> torch.Tensor:
    """A 0-d fp32 zero on `device`, made once: softplus's second operand."""
    return torch.zeros((), device=device)


def _whole(p: dict, cfg, dtype, rules, mesh) -> dict:
    """The mixer's parameters whole on every rank of the mesh (in_proj,
    out_proj and conv_w in the compute dtype): each stored block gathered
    over every axis it shards on (`nn.sharding.replicate_weight`). in_proj
    packs z, x, B, C and dt along its `ssm_inner` dim, and an even split
    of that dim over `model` does not fall on the parts' edges, so the
    block is computed whole on each rank of a `model` line: the gradient
    is reduce-scattered over the batch's axes and sliced over `model`."""
    d, m = cfg.d_model, mamba_dims(cfg)
    layout = {"in_proj": (("embed", "ssm_inner"), (d, m["d_in_proj"])),
              "conv_w": ((None, "conv_dim"), (m["d_conv"], m["conv_dim"])),
              "conv_b": (("conv_dim",), (m["conv_dim"],)),
              "dt_bias": (("ssm_heads",), (m["n_heads"],)),
              "A_log": (("ssm_heads",), (m["n_heads"],)),
              "D": (("ssm_heads",), (m["n_heads"],)),
              "norm_scale": (("ssm_inner",), (m["d_inner"],)),
              "out_proj": (("ssm_inner", "embed"), (m["d_inner"], d))}
    cast = ("in_proj", "out_proj", "conv_w", "conv_b")
    return {k: replicate_weight(t.to(dtype) if k in cast else t,
                                layout[k][0], rules, mesh, layout[k][1])
            for k, t in p.items()}


def serve_heads(cfg, rules, mesh) -> tuple[str, ...]:
    """The mesh axes a serving rank splits the SSD heads over: those of
    `ssm_heads`, where they divide the heads and `ssm_inner` (norm_scale,
    out_proj's rows) splits over the same; none otherwise (the mixer then
    runs whole on every rank, as in training)."""
    if mesh is None or not rules:
        return ()
    m = mamba_dims(cfg)
    th = tp_axes("ssm_heads", m["n_heads"], rules, mesh)
    inner = dim_axes(resolve_sized(("ssm_inner",), rules, mesh,
                                   (m["d_inner"],)), 0)
    return th if th and inner == th else ()


def _rank_dims(cfg, th, mesh) -> tuple[dict, dict]:
    """(this rank's mixer widths, its ranges): heads [h0, h1) of the heads
    split over `th`, and the B / C groups [g0, g1) they read."""
    m = mamba_dims(cfg)
    h, g, p, n = m["n_heads"], m["n_groups"], m["headdim"], m["d_state"]
    h0, h1 = block_range(h, th, mesh)
    rep, hl = h // g, h1 - h0
    if hl % rep == 0:
        g0, g1 = h0 // rep, h1 // rep
    elif rep % hl == 0:
        g0, g1 = h0 // rep, h0 // rep + 1
    else:
        raise ValueError(f"{hl} heads a rank do not fall on the {g} groups "
                         f"of {rep} heads")
    gl = g1 - g0
    loc = dict(m, d_inner=hl * p, n_heads=hl, n_groups=gl,
               d_in_proj=2 * hl * p + 2 * gl * n + hl,
               conv_dim=hl * p + 2 * gl * n)
    return loc, {"h": (h0, h1), "g": (g0, g1)}


def conv_channels(cfg, rules=None, mesh=None) -> list[tuple[int, int]]:
    """The conv_dim channels [lo, hi) whose conv tail a serving rank
    holds, in order: its heads' x channels, its groups' B, its groups' C
    (the whole conv_dim without a split)."""
    m = mamba_dims(cfg)
    th = serve_heads(cfg, rules, mesh)
    if not th:
        return [(0, m["conv_dim"])]
    _, r = _rank_dims(cfg, th, mesh)
    (h0, h1), (g0, g1) = r["h"], r["g"]
    di, p, n = m["d_inner"], m["headdim"], m["d_state"]
    gn = m["n_groups"] * n
    return [(h0 * p, h1 * p), (di + g0 * n, di + g1 * n),
            (di + gn + g0 * n, di + gn + g1 * n)]


def _cols(t: torch.Tensor, ranges) -> torch.Tensor:
    """The last dim's [lo, hi) ranges of `t`, concatenated in order."""
    return torch.cat([t[..., lo:hi] for lo, hi in ranges], dim=-1)


def _rank_mixer(p: dict, x: torch.Tensor, cfg, mode: str, dtype, rules,
                mesh, th) -> tuple[dict, dict, torch.Tensor]:
    """(the rank's parameters, its widths, its in_proj output) for serving
    with the heads split over `th`: in_proj's columns of the rank's z, x,
    B, C and dt, conv_w's and conv_b's of its channels (`conv_channels`,
    both gathered in one call); dt_bias, A_log, D, norm_scale and
    out_proj's rows are its stored blocks. in_proj's stored block is an
    even split of the packed columns: in prefill the weight is gathered
    whole (d x d_in_proj) and the rank's columns multiplied; in decode,
    where one token's output is the smaller, the stored block is
    multiplied and its output gathered."""
    d, m = cfg.d_model, mamba_dims(cfg)
    loc, r = _rank_dims(cfg, th, mesh)
    (h0, h1), di = r["h"], m["d_inner"]
    conv = conv_channels(cfg, rules, mesh)
    dt0 = di + m["conv_dim"]
    # z, then x, B and C (in_proj packs them after z as the conv's
    # channels), then dt
    cols = [(h0 * m["headdim"], h1 * m["headdim"])] + \
        [(di + lo, di + hi) for lo, hi in conv] + [(dt0 + h0, dt0 + h1)]
    axes, shape = ("embed", "ssm_inner"), (d, m["d_in_proj"])
    ti = dim_axes(use_spec(axes, rules, mesh, shape), 1)
    w = p["in_proj"].to(dtype)
    xd = x.to(dtype)
    if ti and mode == "decode":
        y = xd @ gather_weight(w, axes, rules, mesh, shape)
        zxbcdt = _cols(MESH.all_gather(y, mesh, ti, -1, partial_grad=False),
                       cols)
    else:
        w = replicate_weight(w, axes, rules, mesh, shape) if ti else \
            gather_weight(w, axes, rules, mesh, shape)
        zxbcdt = xd @ _cols(w, cols)
    # conv_w and conv_b split alike over conv_dim: one gather for both
    k = m["d_conv"]
    conv = _cols(replicate_weight(
        torch.cat([p["conv_w"], p["conv_b"][None]]).to(dtype),
        (None, "conv_dim"), rules, mesh, (k + 1, m["conv_dim"])), conv)
    q = {"conv_w": conv[:k], "conv_b": conv[k],
         "out_proj": gather_weight(p["out_proj"].to(dtype),
                                   ("ssm_inner", "embed"), rules, mesh,
                                   (di, d))}
    for k in ("dt_bias", "A_log", "D", "norm_scale"):
        q[k] = p[k]
    return q, loc, zxbcdt


def mamba_block(p: dict, x: torch.Tensor, cfg, *, mode: str = "train",
                cache: dict | None = None,
                dtype: torch.dtype = torch.bfloat16,
                rules=None, mesh=None
                ) -> tuple[torch.Tensor, dict | None]:
    """Mamba-2 mixer, x: (b, s, d) -> ((b, s, d) in dtype, cache).

    train: the chunked scan. prefill: the same, then the last k-1 conv
    inputs and the final state written into `cache`. decode (s == 1): the
    conv over the cached inputs and one recurrent step, `cache` updated.
    Both write in place and return the cache they were given.

    With a mesh, `x` is this rank's rows. In train mode the parameters
    come whole (`_whole`); in prefill and decode the rank runs the heads
    `serve_heads` gives it (`_rank_mixer`; the cache is its block, the
    gated norm's sum of squares is all-reduced over those axes and
    out_proj is row-parallel), or the whole mixer where they do not
    split."""
    if mode not in MODES:
        raise ValueError(f"unknown mamba mode {mode!r}; one of {MODES}")
    m = mamba_dims(cfg)
    b, s, _ = x.shape
    th = () if mode == "train" else serve_heads(cfg, rules, mesh)
    if th:
        p, m, zxbcdt = _rank_mixer(p, x, cfg, mode, dtype, rules, mesh, th)
    else:
        if mesh is not None:
            p = _whole(p, cfg, dtype, rules, mesh)
        zxbcdt = x.to(dtype) @ p["in_proj"].to(dtype)
    z, xBC, dt = _split_in_proj(zxbcdt, m)
    A = -torch.exp(p["A_log"].float())                        # (h,)
    dt = torch.logaddexp(dt.float() + p["dt_bias"].float(),
                         _zero(x.device))                     # softplus
    conv_w = p["conv_w"].to(dtype)
    conv_b = p["conv_b"].to(dtype)

    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError("mamba decode takes one token and a cache")
        hist = torch.cat([cache["conv"], xBC.to(cache["conv"].dtype)], 1)
        xBC_c = _silu((hist * conv_w[None]).sum(1, keepdim=True) + conv_b)
        cache["conv"].copy_(hist[:, 1:])
        xs, Bm, Cm = _split_conv(xBC_c, m)
        y_t, new_ssm = ssd_decode_step(cache["ssm"], xs[:, 0], dt[:, 0], A,
                                       Bm[:, 0], Cm[:, 0])
        cache["ssm"].copy_(new_ssm)
        y = y_t[:, None]                                      # (b, 1, h, p)
    else:
        xBC_c = _silu(_causal_conv_train(xBC, conv_w, conv_b))
        xs, Bm, Cm = _split_conv(xBC_c, m)
        y, final_state = ssd_chunked(xs, dt, A, Bm, Cm,
                                     chunk=min(cfg.ssm_chunk, s))
        if mode == "prefill":
            if cache is None:
                raise ValueError("mamba prefill needs a cache")
            k1 = m["d_conv"] - 1
            tail = xBC[:, -k1:]
            cache["conv"].zero_()
            cache["conv"][:, k1 - tail.shape[1]:] = tail
            cache["ssm"].copy_(final_state)

    # skip connection D, gate, norm, out projection
    y = y + xs * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(b, s, m["d_inner"])
    y = y * _silu(z.to(y.dtype))
    yf = y.float()
    if th:
        ss = MESH.reduce_from(yf.square().sum(-1, keepdim=True), mesh, th)
        var = ss / mamba_dims(cfg)["d_inner"]
    else:
        var = yf.square().mean(-1, keepdim=True)
    y = (yf * torch.rsqrt(var + 1e-5) * p["norm_scale"].float()).to(dtype)
    out = y @ p["out_proj"].to(dtype)
    if th:
        out = shard_activation(out, ACT, rules, mesh, act_spec(rules, mesh),
                               partial=th)
    return out, cache


#: a mixer's caches' logical axes (`cache_pspecs` adds "layer" first)
MAMBA_CACHE_AXES = {"conv": ("act_batch", None, "conv_dim"),
                    "ssm": ("act_batch", "ssm_heads", None, None)}


def init_mamba_cache(batch: int, cfg, device=None, rules=None,
                     mesh=None) -> dict:
    """Zeroed cache of one mixer, as the reference's: the conv inputs in
    bf16, the state in fp32. The decode path rounds each conv input to
    the cache's dtype, whatever that is. With a mesh, this rank's block:
    its rows, the "ssm" state of its heads (`cache_pspecs`' block) and
    the "conv" tail of its channels (`conv_channels`)."""
    m = mamba_dims(cfg)
    conv = (batch, m["d_conv"] - 1, m["conv_dim"])
    ssm = (batch, m["n_heads"], m["headdim"], m["d_state"])
    if mesh is not None:
        rows = NamedSharding(mesh, resolve_sized(
            ("act_batch",), rules, mesh, (batch,))).local_shape((batch,))[0]
        th = serve_heads(cfg, rules, mesh)
        heads = _rank_dims(cfg, th, mesh)[0]["n_heads"] if th \
            else m["n_heads"]
        ssm = (rows, heads) + ssm[2:]
        conv = (rows, m["d_conv"] - 1, sum(
            hi - lo for lo, hi in conv_channels(cfg, rules, mesh)))
    return {"conv": torch.zeros(conv, dtype=torch.bfloat16, device=device),
            "ssm": torch.zeros(ssm, device=device)}


def mamba_cache_abstract(batch: int, cfg) -> dict:
    """`init_mamba_cache`'s tensors on the meta device."""
    return init_mamba_cache(batch, cfg, "meta")
