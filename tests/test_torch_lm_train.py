"""LM training in the port against the reference package, at smoke size on
the CPU: the plain flash-attention backward, the `FlashAttention`
Function, `clip_by_global_norm` and `adamw`, `lm_loss` and its gradients,
and `build_lm_train_step`, on the same numpy inputs and the reference's
parameters copied across (`lm_params_from_jax`). On the CPU the Function
runs the kernels' plain versions (`ref.flash_attention_tiled_ref` /
`flash_attention_ref` forward, `ref.flash_attention_bwd_ref` backward).

Tolerances. fp32: the attention gradients within rtol/atol 1e-5 of
`jax.grad` of the reference's `blockwise_attention` and of torch autograd
through `ref.flash_attention_ref` (measured gaps ~2e-6: the same fp32
arithmetic in other summation orders); `lm_loss` within 1e-5 and each
parameter's gradient within a relative L2 error of 1e-5 (measured up to
3.6e-6); an AdamW step within rtol/atol 1e-6 of the reference's (its
rsqrt and pow against XLA's, measured 1.5e-8). bf16: the attention
gradients within a relative L2 error of 1.5e-2 of the reference's and
1e-2 of the fp32 oracle (measured 5.5e-3 and 3.1e-3; 5.3e-3 and 2.3e-3
before the port rounded dS to bf16, as the tensor-core kernel and the
reference's bf16 autodiff do: the reference also rounds dP, dV and the
products' outputs to bf16 where the port keeps fp32; three bf16
roundings of the output are 2^-9 each); `lm_loss` within
5e-3 (measured 2.2e-3) and each gradient within a relative L2 error of
0.1 of the reference's, and no farther from the fp32 gradient than
1.5 times the reference's own bf16 gradient is, plus 0.01 (the
reference's bf16 gradients are 1-8% from its fp32 ones, the port's
1-4.5%; the two round at other places). Train steps in fp32 compute
within rtol/atol 1e-5 of the reference's parameters after the step
(Adam's u = m / sqrt(v) turns gradient differences of 1e-6 into
parameter differences of lr * 1e-3 at the smallest gradients). The three
remat modes, and the resumed and chaos runs, are held bit-equal.
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
from repro.nn import layers as JL
from repro.nn.params import init_params as jinit
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.nn.params import tree_leaves, tree_map
from repro_torch.optim import adamw, clip_by_global_norm, sgd
from repro_torch.train.steps import build_lm_train_step

DENSE = ["stablelm-1.6b", "starcoder2-3b", "chatglm3-6b", "qwen1.5-32b"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    """The reference's parameters of a smoke arch (seed 1) as numpy, drawn
    once: they do not depend on the compute dtype or the remat mode."""
    jcfg = jget_smoke(name)
    return jax.tree.map(np.asarray, jinit(jlm.lm_param_specs(jcfg),
                                          jax.random.PRNGKey(1)))


def _params(jcfg):
    """(reference tree, port tree): fresh arrays and tensors each call, so
    a step that updates in place leaves the cached draw as it was."""
    host = _host_params(jcfg.name)
    return (jax.tree.map(jnp.asarray, host),
            lm_params_from_jax(jax.tree.map(np.copy, host), device="cpu"))


def _batch(cfg, b: int, s: int, seed: int = 3, masked: bool = True):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    mask = ((rng.rand(b, s) > 0.2) if masked else np.ones((b, s))
            ).astype(np.float32)
    return {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
            "loss_mask": mask}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}

# ---------------------------------------------------------------------------
# the attention backward: plain version and Function
# ---------------------------------------------------------------------------


def _attention_grads(q, k, v, g, dtype):
    """(port (dq, dk, dv) from the forward's lse and the plain backward,
    the reference's jax.grad of blockwise_attention, torch autograd of the
    fp32 oracle), all (b, h, s, dh) numpy; inputs (b, s, h, dh) numpy."""
    s = q.shape[1]
    block = 16 if s > 16 else s

    def loss(q_, k_, v_):
        out = JL.blockwise_attention(q_, k_, v_, block, block, True)
        return jnp.sum(out.astype(jnp.float32) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)))
    want = [_np(w).transpose(0, 2, 1, 3) for w in want]
    tq, tk, tv, tg = (torch.from_numpy(x).to(TDT[dtype]).transpose(1, 2)
                      .contiguous() for x in (q, k, v, g))
    out, lse = kflash.flash_attention(tq, tk, tv, True, with_lse=True)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, out, tg, lse)
    leaves = [t.detach().float().requires_grad_() for t in (tq, tk, tv)]
    ref.flash_attention_ref(*leaves).backward(tg.float())
    return ([_np(t) for t in got], want, [_np(t.grad) for t in leaves])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [16, 64])
@pytest.mark.parametrize("s", [16, 64])
def test_flash_attention_bwd_ref_matches_reference_autodiff(s, dh, dtype):
    """s = 16: one block (block_q = block_k = s); s = 64: four blocks."""
    rng = np.random.RandomState(s + dh)
    q, k, v, g = (rng.randn(2, s, 3, dh).astype(np.float32)
                  for _ in range(4))
    got, want, oracle = _attention_grads(q, k, v, g, dtype)
    for name, a, b, c in zip("qkv", got, want, oracle):
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            assert _rel_l2(a, b) < 1.5e-2, name
            assert _rel_l2(a, c) < 1e-2, name


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(1, 2, 10, 4), (2, 1, 7, 8)])
def test_flash_attention_function_passes_gradcheck(shape, causal):
    rng = np.random.RandomState(sum(shape))
    q, k, v = (torch.from_numpy(rng.randn(*shape)).requires_grad_()
               for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: kflash.FlashAttention.apply(a, b, c, causal),
        (q, k, v))


def test_flash_attention_bwd_rounds_p_to_bf16_for_bf16_inputs():
    """The plain backward rounds P to v's dtype before P^T dO, as the
    kernel does: with P = 1/3 everywhere the bf16 dV differs from the fp32
    one by P's rounding, dq and dk do not depend on it."""
    q = torch.zeros(1, 1, 3, 16)
    k = torch.zeros(1, 1, 3, 16)
    v = torch.randn(1, 1, 3, 16, generator=torch.Generator().manual_seed(0))
    do = torch.ones(1, 1, 3, 16)
    out, lse = ref.flash_attention_ref(q, k, v, causal=False, with_lse=True)
    _, _, dv32 = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, False)
    args = [t.bfloat16() for t in (q, k, v, out, do)]
    _, _, dv16 = ref.flash_attention_bwd_ref(*args, lse, False)
    p16 = float(torch.tensor(1 / 3).bfloat16())
    assert torch.allclose(dv32, torch.full_like(dv32, 1.0))
    torch.testing.assert_close(dv16.float(), torch.full_like(dv32, 3 * p16)
                               .bfloat16().float())



def test_flash_attention_bwd_rounds_ds_to_bf16_for_bf16_inputs():
    """The plain backward rounds dS to v's dtype before dS^T Q and dS K, as
    the tensor-core kernel does; fp32 inputs keep dS in fp32. Q and K are
    small integers on disjoint halves of dh, so S = 0 and P = 2^-lse with
    lse = log2(3) (P = 1/3, not exact in bf16); V, O and dO = 1 are small
    integers, so dP and delta are exact and dS = P (dP - delta) is one
    fp32 product. dK = dS^T Q / 4 and dQ = dS K / 4 are worked out here in
    float64 from dS rounded to bf16 or not: bf16 inputs give exactly the
    rounded ones in bf16 (sums of bf16 dS times integers are exact in
    fp32), fp32 inputs the unrounded ones to fp32 rounding, and each is
    2^-9-sized away from the other."""
    rng = np.random.RandomState(3)
    s, dh = 3, 16
    q, k = np.zeros((2, 1, 1, s, dh), np.float32)
    q[..., :8] = rng.choice([-2, -1, 1, 2], size=(1, 1, s, 8))
    k[..., 8:] = rng.choice([-2, -1, 1, 2], size=(1, 1, s, 8))
    v, o = (rng.randint(-2, 3, size=(1, 1, s, dh)).astype(np.float32)
            for _ in range(2))
    q, k, v, o = (torch.from_numpy(x) for x in (q, k, v, o))
    do = torch.ones(1, 1, s, dh)
    lse = torch.full((1, 1, s), float(np.log2(3.0)), dtype=torch.float32)
    p = torch.exp2(-lse)[..., None].expand(1, 1, s, s)
    dp = v.sum(-1)[..., None, :].expand(1, 1, s, s)
    ds = p * (dp - o.sum(-1)[..., None])

    def by_hand(ds_):
        d = ds_.double()
        return ((d @ k.double()) / 4, (d.transpose(-1, -2) @ q.double()) / 4)

    rounded = by_hand(ds.bfloat16().float())
    exact = by_hand(ds)
    args = [t.bfloat16() for t in (q, k, v, o, do)]
    got16 = ref.flash_attention_bwd_ref(*args, lse, False)[:2]
    got32 = ref.flash_attention_bwd_ref(q, k, v, o, do, lse, False)[:2]
    for name, g16, g32, r, x in zip(("dq", "dk"), got16, got32, rounded,
                                    exact):
        assert torch.equal(g16, r.bfloat16()), name
        assert not torch.equal(g16, x.bfloat16()), name
        torch.testing.assert_close(g32.double(), x, rtol=1e-6, atol=0)
        assert float(((g32.double() - r) / x.abs().max()).abs().max()) \
            > 1e-4, name

def test_lse_is_the_log2_logsumexp_of_the_scaled_scores():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, 40, 16).astype(np.float32))
               for _ in range(3))
    want = torch.logsumexp(
        (q @ k.transpose(-1, -2) / 4.0).masked_fill(
            torch.ones(40, 40).triu(1).bool(), -1e30), -1) / np.log(2)
    _, lse = ref.flash_attention_ref(q, k, v, with_lse=True)
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-5)
    bq, bk, bv = (t.bfloat16() for t in (q, k, v))
    _, lse16 = ref.flash_attention_tiled_ref(bq, bk, bv, 16, with_lse=True)
    _, want16 = ref.flash_attention_ref(bq, bk, bv, with_lse=True)
    torch.testing.assert_close(lse16, want16, rtol=1e-6, atol=1e-5)


def test_ops_flash_attention_takes_the_function_only_where_autograd_records(
        monkeypatch):
    """A forward without gradients (the prefill) stores no log-sum-exp; a
    recorded one goes through FlashAttention and asks for it."""
    asked = []
    real = kflash.flash_attention
    monkeypatch.setattr(kflash, "flash_attention",
                        lambda *a, **k: asked.append(k.get("with_lse",
                                                           False))
                        or real(*a, **k))
    q, k, v = (torch.randn(1, 32, 2, 16) for _ in range(3))
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    ops.flash_attention(q, k, v)
    qg = q.clone().requires_grad_()
    out = ops.flash_attention(qg, k, v)
    assert asked == [False, False, True]
    out.sum().backward()
    assert qg.grad is not None and qg.grad.abs().sum() > 0

# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    return {"a": (rng.randn(4, 5) * scale).astype(np.float32),
            "b": {"c": (rng.randn(7) * scale).astype(np.float32),
                  "d": (rng.randn(3, 2) * scale).astype(np.float32)}}


def _torch_tree(t, dtype=torch.float32):
    return tree_map(lambda x: torch.from_numpy(np.array(x)).to(dtype), t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm, dtype):
    g = _tree(np.random.RandomState(2), 3.0)
    jg = jax.tree.map(lambda x: jnp.asarray(x, JDT[dtype]), g)
    want, wnorm = jopt.clip_by_global_norm(jg, max_norm)
    got, norm = clip_by_global_norm(_torch_tree(g, TDT[dtype]), max_norm)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == TDT[dtype]
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("clip_norm", [None, 1.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference_over_three_steps(weight_decay, clip_norm):
    rng = np.random.RandomState(4)
    p0 = _tree(rng)
    jo = jopt.adamw(1e-2, weight_decay=weight_decay, clip_norm=clip_norm)
    to = adamw(1e-2, weight_decay=weight_decay, clip_norm=clip_norm)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jo.init(jp)
    tp = _torch_tree(p0)
    ts = to.init(tp)
    for step in range(3):
        g = _tree(rng, 3.0)
        tg = _torch_tree(g)
        jp, js = jo.apply(jp, jax.tree.map(jnp.asarray, g), js,
                          jnp.asarray(step, jnp.int32))
        new, ts = to.apply(tp, tg, ts, step)
        assert new is tp                              # updated in place
        for a, b in zip(tree_leaves(tg), tree_leaves(g)):
            assert np.array_equal(a.numpy(), b)       # grads left as given
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)
    for key in ("m", "v"):
        for a, b in zip(tree_leaves(ts[key]), jax.tree.leaves(js[key])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


def test_adamw_keeps_fp32_moments_for_bf16_params():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    opt = adamw(0.1, clip_norm=None)
    state = opt.init(p)
    p, state = opt.apply(p, {"w": torch.full((3,), 2.0)}, state, 0)
    assert state["m"]["w"].dtype == torch.float32
    assert p["w"].dtype == torch.bfloat16
    # first step: u = g / |g| = 1, so p = 1 - lr
    torch.testing.assert_close(p["w"].float(), torch.full((3,), 0.9)
                               .bfloat16().float())

# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------


def test_take_along_dim_equals_the_reference_one_hot_contraction():
    rng = np.random.RandomState(5)
    logits = (rng.randn(3, 11, 97) * 8).astype(np.float32)
    logits[0, 0, :] = -logits[0, 0, :]
    targets = rng.randint(0, 97, size=(3, 11))
    lf = torch.from_numpy(logits)
    t = torch.from_numpy(targets)
    got = torch.take_along_dim(lf, t[..., None], dim=-1)[..., 0]
    onehot = (t[..., None] == torch.arange(97)).float()
    assert torch.equal(got, (lf * onehot).sum(-1))
    jl = jnp.asarray(logits)
    jt = jnp.asarray(targets, jnp.int32)
    want = (jl * (jt[..., None] == jnp.arange(97, dtype=jnp.int32))
            .astype(jnp.float32)).sum(-1)
    assert np.array_equal(got.numpy(), np.asarray(want))


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


@pytest.mark.parametrize("s", [8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_lm_loss_and_grads_match_reference(name, dtype, s):
    """s = 32 > attn_block_q = 16: the flash branch (the Function, its
    plain versions on the CPU) against the reference's blockwise attention
    under jax autodiff; s = 8: full attention in both. A fifth of the
    positions are masked out."""
    cfg, jcfg = _cfgs(name, dtype)
    jp, tp = _params(jcfg)
    batch = _batch(cfg, 2, s)
    loss, parts, grads = _loss_and_grads(cfg, tp, batch)
    jloss, jparts, jgrads = _ref_loss_and_grads(jcfg, jp, batch)
    assert set(parts) == {"ce", "aux"} and float(parts["aux"]) == 0.0
    tol = 1e-5 if dtype == "float32" else 5e-3
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(float(parts["ce"].detach()),
                               float(jparts["ce"]), rtol=tol, atol=tol)
    assert len(grads) == len(jgrads)
    if dtype == "float32":
        for g, jg in zip(grads, jgrads):
            assert g.shape == jg.shape and _rel_l2(g, jg) < 1e-5
        return
    cfg32, jcfg32 = _cfgs(name, "float32")
    _, _, grads32 = _loss_and_grads(cfg32, tp, batch)
    for g, jg, g32 in zip(grads, jgrads, grads32):
        assert _rel_l2(g, jg) < 0.1
        assert _rel_l2(g, g32) <= 1.5 * _rel_l2(jg, g32) + 0.01


def test_lm_loss_divides_by_at_least_one_and_adds_the_aux_term():
    cfg, jcfg = _cfgs("stablelm-1.6b", "float32", aux_loss_coef=0.5)
    jp, tp = _params(jcfg)
    batch = _batch(cfg, 2, 8)
    batch["loss_mask"][:] = 0.0
    loss, parts = lm.lm_loss(tp, batch, cfg)
    jloss, jparts = jlm.lm_loss(jp, _jbatch(batch), jcfg, rules={})
    assert float(loss) == float(parts["ce"]) == 0.0 == float(jloss)
    logits = torch.randn(2, 8, cfg.vocab_size)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "lm_forward", lambda *a, **k: (
            logits, torch.tensor(3.0), None))
        batch["loss_mask"][:] = 1.0
        total, parts = lm.lm_loss(tp, batch, cfg)
    assert float(total) == pytest.approx(float(parts["ce"]) + 1.5)


def test_lm_loss_codebook_targets_take_the_mean_over_codebooks():
    """(B, S, K) targets on (B, S, K, V) logits: the reference's audio
    path, reachable once the audio frontend is ported."""
    cfg = get_smoke_config("stablelm-1.6b")
    rng = np.random.RandomState(6)
    logits = torch.from_numpy(rng.randn(2, 5, 3, 11).astype(np.float32))
    targets = rng.randint(0, 11, size=(2, 5, 3))
    batch = {"targets": targets, "loss_mask": np.ones((2, 5), np.float32)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "lm_forward", lambda *a, **k: (
            logits, torch.zeros(()), None))
        total, parts = lm.lm_loss({}, batch, cfg)
    nll = (torch.logsumexp(logits, -1) - torch.take_along_dim(
        logits, torch.from_numpy(targets)[..., None], -1)[..., 0])
    torch.testing.assert_close(parts["ce"], nll.mean(-1).mean())

# ---------------------------------------------------------------------------
# remat and the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [8, 32])
def test_remat_modes_give_the_same_bits(s):
    """none / full / dots: the same loss and gradients bit for bit (bf16
    compute, the flash branch at s = 32); "full" and "dots" recompute the
    units in the backward, and "full" runs the attention forward twice."""
    name = "stablelm-1.6b"
    out = {}
    for remat in ("none", "full", "dots"):
        cfg, jcfg = _cfgs(name, "bfloat16", remat=remat)
        _, tp = _params(jcfg)
        calls = []
        real = kflash.flash_attention
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kflash, "flash_attention",
                       lambda *a, **k: calls.append(1) or real(*a, **k))
            loss, _, grads = _loss_and_grads(cfg, tp, _batch(cfg, 2, s))
        out[remat] = (loss, grads, len(calls))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
    n = cfg.n_layers if s == 32 else 0
    assert [out[r][2] for r in ("none", "full", "dots")] == [n, 2 * n, 2 * n]


def test_unknown_remat_raises():
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                              remat="some")
    tp = lm.init_lm_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        lm.lm_forward(tp, {"tokens": np.zeros((1, 4), np.int32)}, cfg)


def _ref_step(jcfg, jp, batch, accum, grad_dtype, lr=1e-3):
    opt = jopt.adamw(lr)
    step = jax.jit(jsteps.build_lm_train_step(
        jcfg, opt, accum_steps=accum, grad_dtype=grad_dtype))
    return step(jp, opt.init(jp), _jbatch(batch), jnp.asarray(0, jnp.int32))


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("accum", [1, 2, 4])
def test_lm_train_step_matches_reference(accum, grad_dtype):
    """fp32 compute, batch 8 of 32 tokens (the flash branch), adamw(1e-3)
    with its clip: the loss, the parameters and the moments after one
    step."""
    cfg, jcfg = _cfgs("starcoder2-3b", "float32")
    jp, tp = _params(jcfg)
    batch = _batch(cfg, 8, 32)
    opt = adamw(1e-3)
    step = build_lm_train_step(cfg, opt, accum_steps=accum,
                               grad_dtype=grad_dtype)
    params, state, metrics = step(tp, opt.init(tp), batch, 0)
    jparams, jstate, jmetrics = _ref_step(jcfg, jp, batch, accum, grad_dtype)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jmetrics["loss"]), rtol=1e-5, atol=1e-5)
    assert set(metrics) == {"loss", "ce", "aux"}
    for a, b in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)
    # bf16 gradients 1e-6 apart can round to neighbouring bf16 values:
    # m = (1 - b1) g then differs by one bf16 ulp of g (2^-8 relative)
    rtol = 1e-4 if grad_dtype == "float32" else 2 ** -7
    for a, b in zip(tree_leaves(state["m"]), jax.tree.leaves(jstate["m"])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=1e-7)


def test_lm_train_step_remat_modes_are_bit_equal():
    """Two bf16-compute steps with accumulation over 2 chunks: the
    parameters after them are the same bits under every remat mode."""
    out = {}
    for remat in ("none", "full", "dots"):
        cfg, jcfg = _cfgs("stablelm-1.6b", "bfloat16", remat=remat)
        _, tp = _params(jcfg)
        opt = adamw(1e-3)
        step = build_lm_train_step(cfg, opt, accum_steps=2)
        state = opt.init(tp)
        losses = []
        for i in range(2):
            tp, state, m = step(tp, state, _batch(cfg, 4, 32, seed=i), i)
            losses.append(float(m["loss"]))
        out[remat] = (losses, tree_leaves(tp))
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)


def test_lm_train_step_leaves_the_callers_tensors_unmarked():
    cfg = get_smoke_config("stablelm-1.6b")
    tp = lm.init_lm_params(cfg, 0, device="cpu")
    before = tree_map(torch.clone, tp)
    step = build_lm_train_step(cfg, sgd(0.0))
    new, _, m = step(tp, (), _batch(cfg, 2, 8), 0)
    assert all(not t.requires_grad for t in tree_leaves(new))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new),
                                                 tree_leaves(before)))
    assert m["loss"].dim() == 0 and not m["loss"].requires_grad
    with pytest.raises(ValueError, match="equal chunks"):
        build_lm_train_step(cfg, sgd(0.0), accum_steps=3)(
            tp, (), _batch(cfg, 2, 8), 0)

# ---------------------------------------------------------------------------
# counterparts of tests/test_lm_behaviour.py
# ---------------------------------------------------------------------------


def test_lm_loss_decreases_on_constant_data():
    cfg = get_smoke_config("stablelm-1.6b")
    params = lm.init_lm_params(cfg, 0, device="cpu")
    opt = adamw(3e-3, clip_norm=1.0)
    state = opt.init(params)
    step = build_lm_train_step(cfg, opt)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(4, 32)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
             "loss_mask": np.ones((4, 32), np.float32)}
    losses = []
    for i in range(30):
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 1.0, losses[:5]


def test_grad_accumulation_matches_single_step():
    cfg = get_smoke_config("starcoder2-3b")
    params = lm.init_lm_params(cfg, 0, device="cpu")
    opt = adamw(1e-3, clip_norm=None)
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, size=(8, 16)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
             "loss_mask": np.ones((8, 16), np.float32)}
    outs = []
    for accum in (1, 4):
        p = tree_map(torch.clone, params)
        step = build_lm_train_step(cfg, opt, accum_steps=accum)
        outs.append(step(p, opt.init(p), batch, 0))
    (p1, _, m1), (p4, _, m4) = outs
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 2e-2
    for a, b in zip(tree_leaves(p1), tree_leaves(p4)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=3e-2, atol=3e-3)
