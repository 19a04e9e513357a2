"""The port's dense LM against the reference package, at smoke size on the
CPU: each layer function, the flash-attention op, the forward in train
mode, `prefill_step` and `decode_step` for the four dense archs, on the
same numpy inputs and the reference's parameters copied across
(`lm_params_from_jax`).

Tolerances. fp32 compute: single layers within rtol/atol 1e-5 (the same
fp32 arithmetic, other summation orders); the flash-attention op within
the reference's own fp32 kernel tolerance, 2e-4; whole-model logits
within 1e-4 (two layers of fp32 matmuls, softmax and norms) — the KV cache
is bf16 in both packages whatever the compute dtype, so decode logits,
which read it, get 1e-3: a cached value one fp32 rounding apart can round
to bf16 one ulp (2^-8 relative) apart. bf16 compute: the layers within
the reference's own bf16 tolerance, rtol/atol 3e-2. Whole-model bf16
logits get atol 0.125 (8 bf16 ulps at |logit| < 4) and rtol 3e-2: under
the reference's init the residual stream reaches |x| ~ 500 (its stacked
MLP weights draw with fan = n_layers), where one bf16 ulp is 2 to 4, and
one-ulp differences of summation order there reach the logits as up to
~0.1 — the reference's own jitted and op-by-op runs of the same forward
differ by 0.039 (stablelm-1.6b smoke, seed 1). Integer results (int8
quantization) and pure data movement (KV-cache writes of equal values,
repeat_kv) are exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.kernels import ops as jops
from repro.models import lm as jlm
from repro.nn import layers as JL
from repro.nn.params import init_params as jinit
from repro.nn.params import param_count as jparam_count
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.nn import layers as L
from repro_torch.nn.params import param_count, tree_leaves, tree_map

DENSE = ["stablelm-1.6b", "starcoder2-3b", "chatglm3-6b", "qwen1.5-32b"]
DTYPES = ["float32", "bfloat16"]
LAYER_TOL = {"float32": {"rtol": 1e-5, "atol": 1e-5},
             "bfloat16": {"rtol": 3e-2, "atol": 3e-2}}
MODEL_TOL = {"float32": {"rtol": 1e-4, "atol": 1e-4},
             "bfloat16": {"rtol": 3e-2, "atol": 0.125}}
DECODE_TOL = {"float32": {"rtol": 1e-3, "atol": 1e-3},
              "bfloat16": {"rtol": 3e-2, "atol": 0.125}}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of `dtype` (both
    round fp32 to bf16 to nearest even)."""
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _cfgs(name: str, dtype: str):
    return (dataclasses.replace(get_smoke_config(name), compute_dtype=dtype),
            dataclasses.replace(jget_smoke(name), compute_dtype=dtype))


def _params(jcfg, seed: int = 0):
    jp = jinit(jlm.lm_param_specs(jcfg), jax.random.PRNGKey(seed))
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")

# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", DENSE)
def test_param_specs_match_reference(name):
    cfg, jcfg = get_config(name), jget_config(name)
    assert param_count(lm.lm_param_specs(cfg)) == \
        jparam_count(jlm.lm_param_specs(jcfg))
    scfg, sjcfg = get_smoke_config(name), jget_smoke(name)
    assert _flat(lm.lm_param_specs(scfg)) == _flat(jlm.lm_param_specs(sjcfg))


def _flat(tree, path=()):
    """{path: (shape, init, scale, fan_axis)} of a ParamSpec tree."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    return {path: (tuple(tree.shape), tree.init, tree.scale, tree.fan_axis)}


def test_stablelm_has_the_published_parameter_count():
    assert get_config("stablelm-1.6b").param_count_estimate() == 1_644_367_872


def test_init_lm_params_draws_the_spec_scales():
    cfg = get_smoke_config("stablelm-1.6b")
    p = lm.init_lm_params(cfg, 0, device="cpu")
    assert p["embed"]["tok"].device.type == "cpu"
    blk = p["blocks"]["b0"]
    assert blk["attn"]["wq"].shape == (cfg.n_units, 64, 4, 16)
    assert torch.equal(blk["ln1"]["scale"], torch.ones(cfg.n_units, 64))
    # wq's fan is d_model (axis 1 once stacked): std 1/8
    assert abs(float(blk["attn"]["wq"].std()) - 1 / 8) < 0.01
    assert abs(float(p["embed"]["tok"].std()) - 0.02) < 0.002
    again = lm.init_lm_params(cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(p), tree_leaves(again)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm.init_lm_params(cfg, 0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm_params_from_jax({"w": np.zeros(2)})


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm_matches_reference(kind, dtype):
    rng = np.random.RandomState(1)
    jx, tx = _pair(rng.randn(2, 5, 64) * 3 + 1, dtype)
    p = {"scale": rng.randn(64).astype(np.float32),
         "bias": rng.randn(64).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in p.items()}, tx,
                       kind, dtype=TDT[dtype])
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jx,
                         kind, dtype=JDT[dtype])
    assert got.dtype == TDT[dtype]
    _close(got, want, LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("style,pct", [("neox", 1.0), ("neox", 0.25),
                                       ("glm", 1.0), ("none", 1.0)])
def test_apply_rope_matches_reference(style, pct, dtype):
    rng = np.random.RandomState(2)
    jx, tx = _pair(rng.randn(2, 7, 3, 16), dtype)
    pos = rng.randint(0, 5000, size=(2, 7)).astype(np.int32)
    got = L.apply_rope(tx, torch.from_numpy(pos), 16, pct, 1e4, style)
    want = JL.apply_rope(jx, jnp.asarray(pos), 16, pct, 1e4, style)
    _close(got, want, LAYER_TOL[dtype])
    np.testing.assert_allclose(
        L.rope_frequencies(16, pct, 1e4, style).numpy(),
        np.asarray(JL.rope_frequencies(16, pct, 1e4, style)), rtol=1e-6)
    if style == "neox" and pct < 1:               # the rest passes through
        assert torch.equal(got[..., 4:], tx[..., 4:])


def test_repeat_kv_is_jnp_repeat():
    x = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    got = L._repeat_kv(torch.from_numpy(x), 6).numpy()
    np.testing.assert_array_equal(got, np.asarray(JL._repeat_kv(
        jnp.asarray(x), 6)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["causal", "valid_scalar",
                                  "valid_per_row"])
def test_full_attention_matches_reference(case, dtype):
    rng = np.random.RandomState(3)
    b, sq, sk, h, dh = 2, 5, 9, 3, 16
    jq, tq = _pair(rng.randn(b, sq, h, dh), dtype)
    jk, tk = _pair(rng.randn(b, sk, h, dh), dtype)
    jv, tv = _pair(rng.randn(b, sk, h, dh), dtype)
    kw = {"causal": {},
          "valid_scalar": {"causal": False, "kv_valid_len": 6},
          "valid_per_row": {"causal": False,
                            "kv_valid_len": np.asarray([3, 9])}}[case]
    tkw = dict(kw)
    if case == "valid_per_row":
        tkw["kv_valid_len"] = torch.from_numpy(kw["kv_valid_len"])
    got = L.full_attention(tq, tk, tv, **tkw)
    want = JL.full_attention(jq, jk, jv, **kw)
    assert got.dtype == TDT[dtype]
    _close(got, want, LAYER_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu"])
def test_mlp_matches_reference(mlp_type, dtype):
    rng = np.random.RandomState(4)
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                              mlp_type=mlp_type)
    specs = L.mlp_specs(cfg)
    p = {k: (rng.randn(*s.shape) * 0.3).astype(np.float32)
         for k, s in specs.items()}
    jx, tx = _pair(rng.randn(2, 3, 64), dtype)
    got = L.mlp({k: torch.from_numpy(v) for k, v in p.items()}, tx, cfg,
                TDT[dtype])
    want = JL.mlp({k: jnp.asarray(v) for k, v in p.items()}, jx, cfg,
                  JDT[dtype])
    _close(got, want, LAYER_TOL[dtype])


def test_gelu_is_the_tanh_approximation():
    # erf GELU and tanh GELU differ by ~1e-3 near |x| = 2: the MLP test
    # above at fp32 would fail with torch's erf default
    x = torch.linspace(-4, 4, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    cfg = dataclasses.replace(get_smoke_config("starcoder2-3b"), d_ff=101,
                              d_model=101)
    p = {"wi": torch.eye(101), "bi": torch.zeros(101), "wo": torch.eye(101),
         "bo": torch.zeros(101)}
    got = L.mlp(p, x[None], cfg, torch.float32)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _attn_params(rng, cfg):
    return {k: (rng.randn(*s.shape) * 0.2).astype(np.float32)
            for k, s in L.attention_specs(cfg).items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [12, 32])
@pytest.mark.parametrize("name", ["stablelm-1.6b", "starcoder2-3b"])
def test_attention_train_and_prefill_match_reference(name, s, dtype):
    """s = 32 > attn_block_q = 16 and a multiple of it: the port takes the
    flash-attention branch (its plain version on the CPU), the reference
    its blockwise attention; s = 12 is full attention in both."""
    cfg, jcfg = _cfgs(name, dtype)
    rng = np.random.RandomState(5)
    p = _attn_params(rng, cfg)
    jx, tx = _pair(rng.randn(2, s, 64), dtype)
    pos = np.broadcast_to(np.arange(s), (2, s))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got, _ = L.attention(tp, tx, cfg, torch.from_numpy(pos.copy()),
                         mode="train", dtype=TDT[dtype])
    want, _ = JL.attention(jp, jx, jcfg, jnp.asarray(pos), mode="train",
                           dtype=JDT[dtype])
    _close(got, want, LAYER_TOL[dtype] if dtype == "bfloat16"
           else MODEL_TOL[dtype])
    tc = L.init_kv_cache(2, 40, cfg.n_kv_heads, 16, device="cpu")
    jc = JL.init_kv_cache(2, 40, cfg.n_kv_heads, 16)
    got2, tc = L.attention(tp, tx, cfg, torch.from_numpy(pos.copy()),
                           mode="prefill", cache=tc, dtype=TDT[dtype])
    want2, jc = JL.attention(jp, jx, jcfg, jnp.asarray(pos), mode="prefill",
                             cache=jc, dtype=JDT[dtype])
    assert torch.equal(got2, got)
    for key in ("k", "v"):
        _close(tc[key], jc[key], LAYER_TOL["bfloat16"])
        assert not tc[key][:, s:].any()


def test_attention_prefill_takes_the_kernel_branch_at_the_block_condition(
        monkeypatch):
    cfg = get_smoke_config("stablelm-1.6b")           # attn_block_q = 16
    calls = []
    real = kflash.flash_attention
    monkeypatch.setattr(kflash, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or
                        real(*a, **k))
    rng = np.random.RandomState(6)
    tp = {k: torch.from_numpy(v) for k, v in _attn_params(rng, cfg).items()}
    for s, hit in ((16, False), (24, False), (32, True), (48, True)):
        x = torch.randn(1, s, 64)
        pos = torch.arange(s)[None]
        calls.clear()
        L.attention(tp, x, cfg, pos, mode="train")
        assert bool(calls) == hit, s
    assert calls == [(1, 4, 48, 16)]


@pytest.mark.parametrize("s", [48, 1536])
def test_blockwise_length_not_a_multiple_of_block_k_raises_in_both(s):
    """A length that is a multiple of attn_block_q but not of attn_block_k
    takes the blockwise branch and raises, in the reference (assertion in
    blockwise_attention) and in the port; 1,536 tokens at stablelm-1.6b's
    own blocks (512, 1024) are the full-width case."""
    blocks = {48: (16, 32), 1536: (512, 1024)}[s]
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                              attn_block_q=blocks[0], attn_block_k=blocks[1])
    jcfg = dataclasses.replace(jget_smoke("stablelm-1.6b"),
                               attn_block_q=blocks[0], attn_block_k=blocks[1])
    rng = np.random.RandomState(7)
    p = _attn_params(rng, cfg)
    x = rng.randn(1, s, 64).astype(np.float32)
    pos = np.arange(s)[None]
    with pytest.raises(AssertionError):
        JL.attention({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), jcfg, jnp.asarray(pos), mode="train")
    with pytest.raises(ValueError, match="attn_block_k"):
        L.attention({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), cfg, torch.from_numpy(pos),
                    mode="train")


@pytest.mark.parametrize("quantized", [False, True])
def test_kv_cache_writes_and_reads_match_reference(quantized):
    rng = np.random.RandomState(8)
    b, max_len, kv, dh = 3, 10, 2, 16
    tc = L.init_kv_cache(b, max_len, kv, dh, quantized=quantized,
                         device="cpu")
    jc = JL.init_kv_cache(b, max_len, kv, dh, quantized=quantized)
    assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
            for k, t in tc.items()} == \
        {k: (t.shape, str(t.dtype)) for k, t in jc.items()}
    jk, tk = _pair(rng.randn(b, 4, kv, dh), "bfloat16")
    jv, tv = _pair(rng.randn(b, 4, kv, dh), "bfloat16")
    assert L.write_kv_prefix(tc, tk, tv) is tc
    jc = JL.write_kv_prefix(jc, jk, jv)
    for index in (4, np.asarray([5, 7, 9])):
        jk1, tk1 = _pair(rng.randn(b, 1, kv, dh), "bfloat16")
        jv1, tv1 = _pair(rng.randn(b, 1, kv, dh), "bfloat16")
        ti = index if isinstance(index, int) else torch.from_numpy(index)
        assert L.update_kv_cache(tc, tk1, tv1, ti) is tc
        jc = JL.update_kv_cache(jc, jk1, jv1, jnp.asarray(index))
    for key in tc:
        np.testing.assert_array_equal(_np(tc[key]), _np(jc[key]))
    for got, want in zip(L.read_kv_cache(tc, torch.bfloat16),
                         JL.read_kv_cache(jc, jnp.bfloat16)):
        np.testing.assert_array_equal(_np(got), _np(want))

# ---------------------------------------------------------------------------
# the flash-attention op against the reference's Pallas kernel (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,s,h,dh,bq,bk", [
    (2, 64, 3, 16, 16, 16),     # the reference kernel test's shapes
    (1, 128, 2, 128, 32, 64),
    (2, 96, 2, 40, 32, 32),     # dh and a ragged s the reference pads
])
def test_flash_attention_matches_reference_pallas_kernel(b, s, h, dh, bq, bk,
                                                         dtype):
    rng = np.random.RandomState(s + dh)
    jq, tq = _pair(rng.randn(b, s, h, dh) * 0.5, dtype)
    jk, tk = _pair(rng.randn(b, s, h, dh) * 0.5, dtype)
    jv, tv = _pair(rng.randn(b, s, h, dh), dtype)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    want = jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                                causal=True, use_kernel=None, interpret=True)
    assert got.dtype == TDT[dtype] and got.shape == (b, s, h, dh)
    tol = ({"rtol": 2e-4, "atol": 2e-4} if dtype == "float32"
           else LAYER_TOL["bfloat16"])
    _close(got, want, tol)


def test_flash_attention_is_causal():
    rng = np.random.RandomState(9)
    q, k, v = (torch.from_numpy(rng.randn(1, 64, 2, 16).astype(np.float32))
               for _ in range(3))
    base = ops.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:], v2[:, 40:] = 77.0, -5.0
    out = ops.flash_attention(q, k2, v2)
    assert torch.equal(out[:, :40], base[:, :40])
    assert not torch.allclose(out[:, 40:], base[:, 40:])


def test_flash_attention_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.RandomState(10)
    q, k, v = (torch.from_numpy(rng.randn(2, 3, 20, 16).astype(np.float32))
               for _ in range(3))
    from repro_torch.kernels import ref
    before = kflash.KERNEL.launches
    assert torch.equal(kflash.flash_attention(q, k, v),
                       ref.flash_attention_ref(q, k, v))
    assert torch.equal(kflash.flash_attention(q, k, v, causal=False),
                       ref.flash_attention_ref(q, k, v, causal=False))
    assert kflash.KERNEL.launches == before
    with pytest.raises(ValueError):
        kflash.flash_attention(q, k[:, :2], v)

# ---------------------------------------------------------------------------
# the bf16 kernel's plain version, ref.flash_attention_tiled_ref
# ---------------------------------------------------------------------------


def _bhsd(t):
    """(b, s, h, dh) -> (b, h, s, dh) and back (a transpose is its own
    inverse on these two axes)."""
    return t.transpose(1, 2)


@pytest.mark.parametrize("b,s,h,dh,bq,bk", [
    (2, 64, 3, 16, 16, 16),     # the reference kernel test's shapes
    (1, 128, 2, 128, 32, 64),
    (2, 96, 2, 40, 32, 32),
    (1, 203, 2, 64, 64, 64),    # more than one of the kernel's key tiles
])
def test_flash_attention_tiled_ref_matches_reference_pallas_kernel(
        b, s, h, dh, bq, bk):
    """bf16 inputs. The Pallas kernel (interpret mode) runs P.V in fp32; the
    tiled version rounds each P to bf16 (at most 2^-9 relative) and divides
    by the sum of the unrounded P, so O, a convex combination of V's rows,
    moves by at most 2^-9 max|V|; fp32 scores and sums in other orders add
    ~1e-6, and both round their fp32 result to bf16 once, which rtol 2^-7
    (one bf16 ulp) covers."""
    rng = np.random.RandomState(s + dh)
    jq, tq = _pair(rng.randn(b, s, h, dh) * 0.5, "bfloat16")
    jk, tk = _pair(rng.randn(b, s, h, dh) * 0.5, "bfloat16")
    jv, tv = _pair(rng.randn(b, s, h, dh), "bfloat16")
    got = _bhsd(ref.flash_attention_tiled_ref(
        _bhsd(tq), _bhsd(tk), _bhsd(tv), kflash.block_k(dh)))
    want = jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                                causal=True, use_kernel=None, interpret=True)
    assert got.dtype == torch.bfloat16
    atol = 2 ** -9 * float(tv.float().abs().max()) + 1e-5
    _close(got, want, {"rtol": 2 ** -7, "atol": atol})


@pytest.mark.parametrize("b,s,h,dh,bq,bk", [
    (2, 64, 3, 16, 16, 16),     # the smoke configs' attn_block_q/k
    (1, 128, 2, 128, 32, 64),
    (2, 256, 2, 64, 64, 128),
])
def test_flash_attention_tiled_ref_matches_reference_blockwise_attention(
        b, s, h, dh, bq, bk):
    """bf16 inputs against the reference's model path at its block sizes.
    blockwise_attention rounds each score to bf16 twice (the bf16 product,
    then times the bf16 scale): within eps = 2^-7 max|s| of the tiled
    version's fp32 scores. Logits that move by at most eps move each
    softmax weight by a factor within e^(+-2 eps), so O by at most
    expm1(2 eps) max|V|. Both round P to bf16 (2^-9 max|V| each, see the
    test above) and blockwise_attention rounds each block's P.V to bf16
    before adding it (2^-9 max|V| over all blocks): in all (2^-8 + 2^-9 +
    expm1(2 eps)) max|V|, and one bf16 ulp of the output (rtol 2^-7)."""
    rng = np.random.RandomState(s + dh + 1)
    jq, tq = _pair(rng.randn(b, s, h, dh) * 0.5, "bfloat16")
    jk, tk = _pair(rng.randn(b, s, h, dh) * 0.5, "bfloat16")
    jv, tv = _pair(rng.randn(b, s, h, dh), "bfloat16")
    q, k, v = _bhsd(tq), _bhsd(tk), _bhsd(tv)
    got = _bhsd(ref.flash_attention_tiled_ref(q, k, v, kflash.block_k(dh)))
    want = JL.blockwise_attention(jq, jk, jv, bq, bk, causal=True)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / dh ** .5
    eps = 2 ** -7 * float(scores.abs().max())
    atol = (2 ** -8 + 2 ** -9 + np.expm1(2 * eps)) * float(
        tv.float().abs().max()) + 1e-5
    _close(got, want, {"rtol": 2 ** -7, "atol": atol})


@pytest.mark.parametrize("shape,block_k", [((2, 3, 203, 64), 128),
                                           ((1, 2, 130, 128), 64),
                                           ((1, 1, 1, 64), 128),
                                           ((2, 2, 37, 40), 16)])
def test_flash_attention_tiled_ref_fp32_matches_the_oracle(shape, block_k):
    """fp32 inputs keep P in fp32, so the tile loop alone is checked: the
    online softmax in exp2 against one softmax, other fp32 sum orders."""
    rng = np.random.RandomState(sum(shape))
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
               for _ in range(3))
    for causal in (True, False):
        torch.testing.assert_close(
            ref.flash_attention_tiled_ref(q, k, v, block_k, causal),
            ref.flash_attention_ref(q, k, v, causal), rtol=1e-5, atol=1e-5)


def test_flash_attention_wrapper_takes_the_tiled_version_for_bf16_on_the_cpu():
    """bf16 on the CPU runs the bf16 kernel's plain version at its key tile
    (128 keys up to dh 64, 64 above), and launches nothing."""
    rng = np.random.RandomState(13)
    before = kflash.KERNEL.launches
    for dh, bk in ((40, 128), (64, 128), (100, 64), (128, 64)):
        q, k, v = (torch.from_numpy(rng.randn(1, 2, 150, dh).astype(
            np.float32)).bfloat16() for _ in range(3))
        assert kflash.block_k(dh) == bk
        assert torch.equal(kflash.flash_attention(q, k, v),
                           ref.flash_attention_tiled_ref(q, k, v, bk))
    assert kflash.KERNEL.launches == before


def test_bf16_forward_gap_to_the_reference_is_its_score_rounding():
    """How far the port's bf16 train-mode forward (flash branch: the tiled
    plain version on the CPU) is from the reference's, against the
    reference's own jitted and op-by-op runs (stablelm-1.6b smoke, seed 1).
    With the reference's blockwise_attention put in place of the port's
    attention op, the rest of the port is as far from the reference as the
    reference is from itself, give or take one bf16 ulp at |logit| < 4
    (2^-6); with the tiled version the gap grows by what blockwise_attention
    rounds and the kernel does not, the scores to bf16, and stays within
    MODEL_TOL."""
    cfg, jcfg = _cfgs("stablelm-1.6b", "bfloat16")
    jp, tp = _params(jcfg, seed=1)
    tokens = np.random.RandomState(11).randint(0, 256, size=(2, 32))
    want = _np(jlm.lm_forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                              "train", rules={})[0])
    with jax.disable_jit():
        own = _np(jlm.lm_forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                                 "train", rules={})[0])

    def port():
        return _np(lm.lm_forward(tp, {"tokens": torch.from_numpy(tokens)},
                                 cfg, "train")[0])

    def blockwise(q, k, v, causal=True):
        out = JL.blockwise_attention(*(jnp.asarray(_np(t), jnp.bfloat16)
                                       for t in (q, k, v)),
                                     cfg.attn_block_q, cfg.attn_block_k,
                                     causal)
        return torch.tensor(_np(out)).to(q.dtype)

    kernel_path = port()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "flash_attention", blockwise)
        reference_attention = port()
    own_gap = np.abs(own - want).max()
    rest_gap = np.abs(reference_attention - want).max()
    kernel_gap = np.abs(kernel_path - want).max()
    print(f"bf16 logits, max |diff| from the reference's jitted forward: "
          f"its own op-by-op run {own_gap}, the port with the reference's "
          f"attention {rest_gap}, the port {kernel_gap}")
    assert rest_gap <= own_gap + 2 ** -6
    np.testing.assert_allclose(kernel_path, want, **MODEL_TOL["bfloat16"])

# ---------------------------------------------------------------------------
# the model: train-mode forward, prefill_step, decode_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_lm_forward_train_matches_reference(name, dtype):
    cfg, jcfg = _cfgs(name, dtype)
    jp, tp = _params(jcfg, seed=1)
    tokens = np.random.RandomState(11).randint(0, 256, size=(2, 32))
    got, aux, caches = lm.lm_forward(tp, {"tokens": torch.from_numpy(tokens)},
                                     cfg, "train")
    want, _, _ = jlm.lm_forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                                "train", rules={})
    assert got.shape == (2, 32, 256) and got.dtype == TDT[dtype]
    assert caches is None and float(aux) == 0.0
    _close(got, want, MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", DENSE)
def test_prefill_then_decode_match_reference(name, dtype):
    """prefill_step over 32 tokens (the flash branch), then three decode
    steps: two at a shared position, one at per-row positions (row 1 skips
    a position). qwen1.5's smoke config carries the int8 KV cache."""
    cfg, jcfg = _cfgs(name, dtype)
    jp, tp = _params(jcfg, seed=2)
    rng = np.random.RandomState(12)
    b, s, max_len = 2, 32, 40
    tokens = rng.randint(0, 256, size=(b, s))
    tc = lm.init_caches(cfg, b, max_len, device="cpu")
    jc = jlm.init_caches(jcfg, b, max_len)
    got, tc2 = lm.prefill_step(tp, {"tokens": torch.from_numpy(tokens)}, tc,
                               cfg)
    assert tc2 is tc
    want, jc = jlm.prefill_step(jp, {"tokens": jnp.asarray(tokens)}, jc,
                                jcfg, {})
    _close(got, want, MODEL_TOL[dtype])
    for step, index in enumerate((s, s + 1, np.asarray([s + 2, s + 3]))):
        tok = rng.randint(0, 256, size=(b, 1))
        ti = index if isinstance(index, int) else torch.from_numpy(index)
        got, tc = lm.decode_step(tp, torch.from_numpy(tok), tc, ti, cfg)
        want, jc = jlm.decode_step(jp, jnp.asarray(tok), jc,
                                   jnp.asarray(index, jnp.int32), jcfg, {})
        assert got.shape == (b, 256), step
        _close(got, want, DECODE_TOL[dtype])
    assert set(tc["b0"]) == set(jc["b0"])
    assert (cfg.kv_cache_dtype == "int8") == ("k_scale" in tc["b0"])
    assert tc["b0"]["k"].shape == (cfg.n_units, b, max_len, cfg.n_kv_heads,
                                   cfg.d_head)


def test_decode_writes_only_the_named_positions():
    cfg = get_smoke_config("stablelm-1.6b")
    tp = lm.init_lm_params(cfg, 3, device="cpu")
    caches = lm.init_caches(cfg, 2, 8, device="cpu")
    before = tree_map(torch.clone, caches)
    lm.decode_step(tp, torch.tensor([[5], [6]]), caches,
                   torch.tensor([2, 6]), cfg)
    k, k0 = caches["b0"]["k"], before["b0"]["k"]
    touched = torch.zeros_like(k, dtype=torch.bool)
    touched[:, 0, 2] = touched[:, 1, 6] = True
    assert torch.equal(k[~touched], k0[~touched])
    assert k[touched].abs().sum() > 0


def test_decode_index_out_of_range_raises_where_the_reference_clamps():
    """A (2, 4, 1, 2) cache (max_len 4) and a position past its end: the
    reference clamps the scalar 4 (dynamic_update_slice writes row 3) and
    drops the out-of-range entry of [1, 4] (row 1 of sequence 0 is
    written, sequence 1 is not); the port deliberately refuses both with a
    ValueError on the host, before any cache is indexed, through
    `_decode_index` and through `decode_step`."""
    rng = np.random.RandomState(14)
    cache = rng.randn(2, 4, 1, 2).astype(np.float32)
    new = rng.randn(2, 1, 1, 2).astype(np.float32)
    jc = {"k": jnp.asarray(cache), "v": jnp.asarray(cache)}
    clamped = np.asarray(JL.update_kv_cache(jc, jnp.asarray(new),
                                            jnp.asarray(new), 4)["k"])
    want = cache.copy()
    want[:, 3] = new[:, 0]
    np.testing.assert_array_equal(clamped, want)
    dropped = np.asarray(JL.update_kv_cache(
        jc, jnp.asarray(new), jnp.asarray(new),
        jnp.asarray([1, 4]))["k"])
    want = cache.copy()
    want[0, 1] = new[0, 0]
    np.testing.assert_array_equal(dropped, want)
    for index in (4, torch.tensor([1, 4]), -1, torch.tensor([-1, 0])):
        with pytest.raises(ValueError, match="outside"):
            lm._decode_index(index, 2, "cpu", 4)
    cfg = get_smoke_config("stablelm-1.6b")
    tp = lm.init_lm_params(cfg, 3, device="cpu")
    caches = lm.init_caches(cfg, 2, 4, device="cpu")
    before = tree_map(torch.clone, caches)
    for index in (4, torch.tensor([1, 4])):
        with pytest.raises(ValueError, match="outside"):
            lm.decode_step(tp, torch.tensor([[5], [6]]), caches, index, cfg)
    for key in caches["b0"]:
        assert torch.equal(caches["b0"][key], before["b0"][key])


@pytest.mark.parametrize("index", [3, [1, 3], [0, 0]])
def test_decode_index_in_range_writes_what_the_reference_writes(index):
    """In range the check moves nothing: the position `_decode_index`
    returns writes the (2, 4, 1, 2) cache bit for bit as the reference."""
    rng = np.random.RandomState(15)
    k, v = (rng.randn(2, 4, 1, 2).astype(np.float32) for _ in range(2))
    k1, v1 = (rng.randn(2, 1, 1, 2).astype(np.float32) for _ in range(2))
    ti = index if isinstance(index, int) else torch.tensor(index)
    got = L.update_kv_cache(
        {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())},
        torch.from_numpy(k1), torch.from_numpy(v1),
        lm._decode_index(ti, 2, "cpu", 4))
    want = JL.update_kv_cache({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                              jnp.asarray(k1), jnp.asarray(v1),
                              jnp.asarray(index))
    for key in ("k", "v"):
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]))
