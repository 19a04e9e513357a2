"""Training the port's MoE, SSM and hybrid LM families against the
reference package, at smoke size on the CPU: `lm_loss` and every gradient
against `jax.grad` of the reference's `lm_loss`, the remat modes, and the
MoE and Mamba-2 layers' gradients in their corner cases (a zero router,
capacity drops, decays that underflow), on the same numpy inputs and the
reference's parameters copied across (`lm_params_from_jax`). The train
step and the launcher are in tests/test_torch_lm_zoo_step.py.

Tolerances. fp32 compute: the loss, ce and aux within rtol/atol 1e-5 and
each parameter's gradient within a relative L2 error of 1e-4 (the same
fp32 arithmetic in other orders: the port sums each token's k expert
outputs in order where the reference scatter-adds, and contracts the SSD
products as batched matmuls where the reference runs einsums); the MoE
layer's gradients within rtol/atol 1e-5 of the largest, the Mamba-2
mixer's within a relative L2 error of 1e-4. bf16 compute:
each gradient no farther from the port's fp32 gradient than the
reference's bf16 gradient is from the reference's fp32 one, times 1.5,
plus 0.01 (the dense families' rule, tests/test_torch_lm_train.py), and
the loss, ce and aux by the same rule with 5e-3 added (bf16 routing can
pick other experts at near ties than fp32 routing in either package, so
the aux loss, a count of routed pairs, moves in steps).
Remat modes are held bit-equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.nn import mamba2 as JM
from repro.nn import moe as JMOE
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import flash_attention as kflash
from repro_torch.models import lm
from repro_torch.nn import mamba2 as M
from repro_torch.nn import moe as MOE
from repro_torch.nn.params import tree_leaves, tree_map

ZOO = ["granite-moe-1b-a400m", "granite-moe-3b-a800m", "mamba2-780m",
       "jamba-v0.1-52b"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
GRAD_RTOL = 1e-4
BF16_LOSS_ATOL = {"loss": 5e-3, "ce": 5e-3, "aux": 0.05}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _cfgs(name: str, dtype: str, **over):
    return (dataclasses.replace(get_smoke_config(name), compute_dtype=dtype,
                                **over),
            dataclasses.replace(jget_smoke(name), compute_dtype=dtype,
                                **over))


@functools.lru_cache(maxsize=None)
def _host_params(name: str):
    """The reference's parameters of a smoke arch (seed 1) as numpy."""
    return jax.tree.map(np.asarray, jinit(jlm.lm_param_specs(jget_smoke(
        name)), jax.random.PRNGKey(1)))


def _params(jcfg):
    """(reference tree, port tree), fresh each call."""
    host = _host_params(jcfg.name)
    return (jax.tree.map(jnp.asarray, host),
            lm_params_from_jax(jax.tree.map(np.copy, host), device="cpu"))


def _batch(cfg, b: int, s: int, seed: int = 3):
    """Random tokens, next-token targets, a fifth of the positions
    masked out."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
            "loss_mask": (rng.rand(b, s) > 0.2).astype(np.float32)}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _loss_and_grads(cfg, tp, batch):
    leaves = tree_map(lambda t: t.detach().requires_grad_(), tp)
    loss, parts = lm.lm_loss(leaves, batch, cfg)
    loss.backward()
    return loss, parts, [t.grad for t in tree_leaves(leaves)]


def _ref_loss_and_grads(jcfg, jp, batch):
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, jcfg, rules={}), has_aux=True))(
            jp, _jbatch(batch))
    return loss, parts, jax.tree.leaves(grads)

# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _loss_grads(name: str, dtype: str, s: int):
    """(port, reference) of the smoke arch's lm_loss on `_batch(cfg, 2,
    s)`: each {"loss", "ce", "aux"} as floats and every gradient as
    numpy, computed once per worker (the bf16 case reads the fp32 ones)."""
    cfg, jcfg = _cfgs(name, dtype)
    jp, tp = _params(jcfg)
    batch = _batch(cfg, 2, s)
    out = []
    for loss, parts, grads in (_loss_and_grads(cfg, tp, batch),
                               _ref_loss_and_grads(jcfg, jp, batch)):
        out.append(({"loss": float(_np(loss)),
                     **{k: float(_np(v)) for k, v in parts.items()}},
                    [_np(g) for g in grads]))
    return tuple(out)


@pytest.mark.parametrize("name,dtype,s", [
    (name, dtype, s) for name in ZOO for dtype in ("float32", "bfloat16")
    for s in (16, 32) if name != "jamba-v0.1-52b" or s == 32])
def test_lm_loss_and_grads_match_reference(name, dtype, s):
    """s = 32 > attn_block_q = 16: the attention layers take the flash
    branch (the Function, its plain versions on the CPU); s = 16 full
    attention (jamba, whose 16 smoke layers make each case the file's
    slowest, only at 32). The MoE layers' aux loss enters the total; the
    tied embeddings (granite, mamba2) take their gradient from the lookup
    and the head."""
    (got, grads), (want, jgrads) = _loss_grads(name, dtype, s)
    assert set(got) == {"loss", "ce", "aux"}
    assert (got["aux"] > 0) == (get_smoke_config(name).n_experts > 0)
    assert len(grads) == len(jgrads)
    assert all(np.isfinite(g).all() for g in grads)
    if dtype == "float32":
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        for g, jg in zip(grads, jgrads):
            assert g.shape == jg.shape
            assert _rel_l2(g, jg) < GRAD_RTOL, _rel_l2(g, jg)
        return
    (got32, grads32), (want32, jgrads32) = _loss_grads(name, "float32", s)
    for k in got:
        ours, theirs = abs(got[k] - got32[k]), abs(want[k] - want32[k])
        assert ours <= 1.5 * theirs + BF16_LOSS_ATOL[k], (k, ours, theirs)
    for g, jg, g32, jg32 in zip(grads, jgrads, grads32, jgrads32):
        ours, theirs = _rel_l2(g, g32), _rel_l2(jg, jg32)
        assert ours <= 1.5 * theirs + 0.01, (ours, theirs)


@pytest.mark.parametrize("name", ZOO)
def test_remat_modes_give_the_same_bits(name):
    """none / full / dots, bf16 compute, 32 tokens: the same loss, aux
    and gradients bit for bit; "full" and "dots" recompute every unit
    (the MoE routing and combine, the SSD scan) in the backward."""
    out = {}
    for remat in ("none", "full", "dots"):
        cfg, jcfg = _cfgs(name, "bfloat16", remat=remat)
        _, tp = _params(jcfg)
        calls = []
        real = kflash.flash_attention
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kflash, "flash_attention",
                       lambda *a, **k: calls.append(1) or real(*a, **k))
            loss, parts, grads = _loss_and_grads(cfg, tp, _batch(cfg, 2, 32))
        out[remat] = (loss, parts["aux"], grads, len(calls))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert torch.equal(out[remat][1], out["none"][1])
        for a, b in zip(out[remat][2], out["none"][2]):
            assert torch.equal(a, b)
    n = cfg.pattern.count("a") * cfg.n_units
    assert [out[r][3] for r in ("none", "full", "dots")] == [n, 2 * n, 2 * n]

# ---------------------------------------------------------------------------
# the MoE layer's gradient: ties, drops
# ---------------------------------------------------------------------------


def _moe_pair(zero_router: bool, seed: int = 0, groups: int = 1):
    cfg, jcfg = _cfgs("granite-moe-1b-a400m", "float32", moe_groups=groups)
    jp = jinit(JMOE.moe_specs(jcfg), jax.random.PRNGKey(seed))
    if zero_router:
        jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    return cfg, jcfg, jp, {k: torch.from_numpy(np.array(v))
                           for k, v in jp.items()}


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("cf", [0.5, 1.25])
@pytest.mark.parametrize("zero_router", [False, True])
def test_moe_layer_grads_match_reference(zero_router, cf, groups):
    """jax.grad of sum(y * w) + aux through the reference's layer against
    autograd of the port's, for the input and every parameter, in one and
    two dispatch groups. A zero router makes every probability equal
    (top-k takes the lowest expert indices, as jax.lax.top_k); capacity
    factor 0.5 drops pairs."""
    cfg, jcfg, jp, tp = _moe_pair(zero_router, groups=groups)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 24, cfg.d_model).astype(np.float32)
    w = rng.randn(2, 24, cfg.d_model).astype(np.float32)

    def jloss(p, xx):
        y, aux = JMOE.moe(p, xx, jcfg, dtype=jnp.float32,
                          capacity_factor=cf)
        return jnp.sum(y * w) + aux

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = MOE.moe(leaves, tx, cfg, dtype=torch.float32,
                     capacity_factor=cf)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    scale = max(float(np.abs(np.asarray(jgx)).max()), 1e-30)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgx), rtol=1e-5,
                               atol=1e-5 * scale)
    for k in tp:
        want = np.asarray(jgp[k])
        np.testing.assert_allclose(
            _np(leaves[k].grad), want, rtol=1e-5,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-30), err_msg=k)
    if zero_router:
        # equal probabilities: the router's gradient comes from the aux
        # loss and the kept pairs' gates alone, and is finite
        assert bool(torch.isfinite(leaves["router"].grad).all())


def test_dropped_pairs_pass_no_gradient_to_their_gates(monkeypatch):
    """At capacity factor 0.5 some (token, slot) pairs are dropped; the
    loss's gradient with respect to the renormalised gates is zero at
    every dropped pair and non-zero at kept ones (the reference's keep
    mask)."""
    cfg, _, _, tp = _moe_pair(False)
    seen = {}
    real = MOE.route

    def spy(*a, **k):
        r = real(*a, **k)
        r["gate_vals"].retain_grad()
        seen.update(r)
        return r

    monkeypatch.setattr(MOE, "route", spy)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(2, 24, cfg.d_model).astype(np.float32))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, _ = MOE.moe(leaves, x, cfg, dtype=torch.float32, capacity_factor=0.5)
    (y * torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
     ).sum().backward()
    keep = seen["keep"].reshape(seen["gate_vals"].shape)
    g = seen["gate_vals"].grad
    assert bool((~keep).any()) and bool(keep.any())
    assert bool((g[~keep] == 0).all())
    assert bool((g[keep] != 0).all())


def test_moe_combine_and_count_use_no_float_index_add(monkeypatch):
    """The combine sums each token's k pairs in order and the expert count
    is an integer bincount: no float index_add_ runs in the layer."""
    cfg, _, _, tp = _moe_pair(False)
    calls = []
    real = torch.Tensor.index_add_

    def spy(self, *a, **k):
        calls.append(self.dtype)
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "index_add_", spy)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    y, aux = MOE.moe(tp, x, cfg, dtype=torch.float32)
    assert calls == [] and torch.isfinite(y).all() and float(aux) > 0

# ---------------------------------------------------------------------------
# the Mamba-2 mixer's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt_bias", [None, 60.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block_grads_match_reference(dtype, dt_bias):
    """jax.grad of sum(y * w) through the reference's train-mode mixer
    against autograd of the port's, for the input and every parameter
    (the causal conv, the chunked scan, the gated norm, A = -exp(A_log),
    softplus(dt + dt_bias)). With dt_bias 60 and A_log 2, every step's
    decay exp(dt * A) underflows to 0: the segment sum's -inf entries must
    not reach the backward as inf - inf, so every gradient is finite. fp32
    within a relative L2 error of GRAD_RTOL (at dt 60 the inputs of the
    products grow 60-fold: one conv_w element is 2.5e-4 apart); bf16 no
    farther from the port's fp32 gradient than the reference's bf16 one,
    x1.5 + 0.01."""
    cfg, jcfg = _cfgs("mamba2-780m", dtype)
    jp = jinit(JM.mamba_specs(jcfg), jax.random.PRNGKey(4))
    if dt_bias is not None:
        jp = dict(jp, dt_bias=jnp.full_like(jp["dt_bias"], dt_bias),
                  A_log=jnp.full_like(jp["A_log"], 2.0))
    rng = np.random.RandomState(7)
    x = rng.randn(2, 32, cfg.d_model).astype(np.float32)
    w = rng.randn(2, 32, cfg.d_model).astype(np.float32)

    def jgrads(dt):
        def loss(p, xx):
            y, _ = JM.mamba_block(p, xx, dataclasses.replace(
                jcfg, compute_dtype=dt), mode="train", dtype=JDT[dt])
            return jnp.sum(y.astype(jnp.float32) * w)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
        return {**{k: np.asarray(v, np.float32) for k, v in gp.items()},
                "x": np.asarray(gx, np.float32)}

    def tgrads(dt):
        leaves = {k: torch.from_numpy(np.array(v)).requires_grad_()
                  for k, v in jp.items()}
        tx = torch.from_numpy(x).requires_grad_()
        y, _ = M.mamba_block(leaves, tx, cfg, mode="train", dtype=TDT[dt])
        (y.float() * torch.from_numpy(w)).sum().backward()
        return {**{k: _np(v.grad) for k, v in leaves.items()},
                "x": _np(tx.grad)}

    got = tgrads(dtype)
    assert all(np.isfinite(g).all() for g in got.values()), \
        [k for k, g in got.items() if not np.isfinite(g).all()]
    want = jgrads(dtype)
    if dtype == "float32":
        for k, g in got.items():
            assert _rel_l2(g, want[k]) < GRAD_RTOL, (k, _rel_l2(g, want[k]))
        return
    got32, want32 = tgrads("float32"), jgrads("float32")
    for k, g in got.items():
        assert _rel_l2(g, got32[k]) <= \
            1.5 * _rel_l2(want[k], want32[k]) + 0.01, k


def test_segsum_backward_sees_no_inf_minus_inf():
    """The segment sum's -inf above the diagonal comes from a masked fill,
    so exp gives exact zeros there and their gradient is 0 (no NaN), also
    when the log decays are large."""
    logdec = (torch.randn(2, 3, 8, dtype=torch.float64) * 50 - 100
              ).requires_grad_()
    torch.exp(M._segsum(logdec)).sum().backward()
    assert bool(torch.isfinite(logdec.grad).all())
    ld = logdec.detach().requires_grad_()
    torch.autograd.gradcheck(lambda t: torch.exp(M._segsum(t / 100)),
                             (ld[:1, :1, :5],))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_gradient_is_the_references_where_exp_overflows(dtype):
    """SwiGLU's and the mixers' silu: below x = -88 exp(-x) overflows to
    inf in fp32 and bf16, and autograd through x / (1 + exp(-x)) op by op
    gave NaN there (0 * inf), which reached every gradient through the
    global-norm clip (internvl2-26b at 2 layers: the reference's init puts
    its SwiGLU pre-activations near N(0, 55^2)). The gradient is the
    reference's, jax.grad of jax.nn.silu: 0 there, and equal elsewhere
    within one ulp of the dtype."""
    from repro_torch.nn.layers import _silu
    x = np.array([-1e4, -200, -100, -89, -88, -20, -1, 0, 0.5, 3, 50, 100,
                  1e4], np.float32)
    t = torch.from_numpy(x).to(TDT[dtype]).requires_grad_()
    _silu(t).float().sum().backward()
    want = jax.grad(lambda a: jnp.sum(jax.nn.silu(a).astype(jnp.float32)))(
        jnp.asarray(x, JDT[dtype]))
    got = _np(t.grad)
    assert np.isfinite(got).all()
    eps = 2 ** -7 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(got, _np(want), rtol=eps, atol=1e-30)
