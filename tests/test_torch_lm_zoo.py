"""The port's MoE, SSM and hybrid LM families against the reference
package, at smoke size on the CPU: configs and parameter trees, the
forward in train mode, `prefill_step` then `decode_step` (jamba-v0.1-52b
carries the int8 KV cache), `lm_loss` with its aux term, on the same numpy
inputs and the reference's parameters copied across
(`lm_params_from_jax`); the decode window of an attention-free model; and
the training refusals.

Tolerances. fp32 compute: logits within rtol/atol 1e-4 (the same fp32
arithmetic in other orders), decode logits, which read the bf16 caches,
within 1e-3; the aux loss within 1e-5. bf16 compute: the port's logits are
no farther from the reference's fp32 logits than the reference's own bf16
logits are, times 1.5, plus 0.01 (the bound the LM training tests use for
bf16 gradients). A fixed bf16 tolerance does not carry to jamba: its 16
smoke layers let one-ulp differences grow, and the reference's own jitted
and op-by-op bf16 runs differ by 0.156 there (logits up to 4.7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.nn.params import init_params as jinit
from repro.nn.params import param_count as jparam_count
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import lm
from repro_torch.nn.params import param_count, tree_leaves

ZOO = ["granite-moe-1b-a400m", "granite-moe-3b-a800m", "mamba2-780m",
       "jamba-v0.1-52b"]
DTYPES = ["float32", "bfloat16"]
FP32 = {"rtol": 1e-4, "atol": 1e-4}
FP32_DECODE = {"rtol": 1e-3, "atol": 1e-3}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(name: str, dtype: str):
    return (dataclasses.replace(get_smoke_config(name), compute_dtype=dtype),
            dataclasses.replace(jget_smoke(name), compute_dtype=dtype))


def _params(jcfg, seed: int):
    jp = jinit(jlm.lm_param_specs(jcfg), jax.random.PRNGKey(seed))
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _held(got, want_bf16, want_fp32, dtype, what):
    """fp32: `got` within FP32 of the reference. bf16: no farther from the
    reference's fp32 result than the reference's bf16 result, x1.5 + 0.01."""
    got, want_bf16, want_fp32 = _np(got), _np(want_bf16), _np(want_fp32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want_bf16, **what)
        return
    ours = np.abs(got - want_fp32).max()
    theirs = np.abs(want_bf16 - want_fp32).max()
    assert ours <= 1.5 * theirs + 0.01, (ours, theirs)

# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_config_fields_equal(name, smoke):
    port = get_smoke_config(name) if smoke else get_config(name)
    want = jget_smoke(name) if smoke else jget_config(name)
    for f in dataclasses.fields(want):
        assert getattr(port, f.name) == getattr(want, f.name), f.name
    assert (port.pattern, port.n_units) == (want.pattern, want.n_units)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    return {path: (tuple(tree.shape), tree.init, tree.scale, tree.fan_axis)}


@pytest.mark.parametrize("name", ZOO)
def test_zoo_param_specs_match_reference(name):
    cfg, jcfg = get_config(name), jget_config(name)
    assert param_count(lm.lm_param_specs(cfg)) == \
        jparam_count(jlm.lm_param_specs(jcfg)) == cfg.param_count_estimate()
    assert _flat(lm.lm_param_specs(get_smoke_config(name))) == \
        _flat(jlm.lm_param_specs(jget_smoke(name)))


def test_full_width_parameter_counts():
    """granite-moe-3b-a800m 3.90 B (its 8 padded experts included),
    mamba2-780m 0.78 B, and one 8-layer unit of jamba-v0.1-52b 13.27 B."""
    count = {n: get_config(n).param_count_estimate() for n in ZOO}
    assert round(count["granite-moe-3b-a800m"] / 1e9, 2) == 3.90
    assert round(count["mamba2-780m"] / 1e9, 2) == 0.78
    unit = dataclasses.replace(get_config("jamba-v0.1-52b"), n_layers=8)
    assert round(unit.param_count_estimate() / 1e9, 2) == 13.27


def test_hybrid_unit_blocks_and_converted_trees():
    """jamba's unit is m m m a m m m m with MoE on the odd positions; the
    converted tree keeps every stacked shape (experts (n_units, e_pad, d,
    f), A_log, D, conv_w) as the reference's."""
    cfg, jcfg = _cfgs("jamba-v0.1-52b", "float32")
    jp, tp = _params(jcfg, 0)
    blocks = tp["blocks"]
    assert list(blocks) == [f"b{i}" for i in range(8)]
    for i, kind in enumerate(cfg.pattern):
        b = blocks[f"b{i}"]
        assert ("attn" in b) == (kind == "a") and ("mamba" in b) == (kind == "m")
        assert ("router" in b["ffn"]) == (i % 2 == 1)
    assert blocks["b1"]["ffn"]["wi"].shape == (2, 4, 64, 128)
    assert blocks["b0"]["mamba"]["A_log"].shape == (2, 8)
    flat_j = jax.tree.leaves(jp)
    assert [tuple(t.shape) for t in tree_leaves(tp)] == \
        [tuple(a.shape) for a in flat_j]
    for t, a in zip(tree_leaves(tp), flat_j):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))


@pytest.mark.parametrize("name", ZOO)
def test_init_lm_params_draws_the_zoo(name):
    cfg = get_smoke_config(name)
    p = lm.init_lm_params(cfg, 0, device="cpu")
    assert sum(t.numel() for t in tree_leaves(p)) == \
        cfg.param_count_estimate()
    for name_, blk in p["blocks"].items():
        if "mamba" in blk:
            assert torch.equal(blk["mamba"]["A_log"],
                               torch.zeros_like(blk["mamba"]["A_log"]))


@pytest.mark.parametrize("name", ["internvl2-26b", "musicgen-large"])
def test_frontends_still_raise(name):
    with pytest.raises(NotImplementedError, match="later slice"):
        get_config(name)
    with pytest.raises(NotImplementedError, match="frontends"):
        lm.lm_param_specs(jget_smoke(name))

# ---------------------------------------------------------------------------
# the forward, prefill and decode, the loss
# ---------------------------------------------------------------------------


def _reference_logits(jp, jcfg, tokens, dtype):
    out = {}
    for dt in {dtype, "float32"}:
        c = dataclasses.replace(jcfg, compute_dtype=dt)
        out[dt] = jlm.lm_forward(jp, {"tokens": jnp.asarray(tokens)}, c,
                                 "train", rules={})
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ZOO)
def test_lm_forward_train_matches_reference(name, dtype):
    cfg, jcfg = _cfgs(name, dtype)
    jp, tp = _params(jcfg, seed=1)
    tokens = np.random.RandomState(11).randint(0, 256, size=(2, 32))
    got, aux, caches = lm.lm_forward(tp, {"tokens": torch.from_numpy(tokens)},
                                     cfg, "train")
    want = _reference_logits(jp, jcfg, tokens, dtype)
    assert got.shape == (2, 32, 256) and caches is None
    _held(got, want[dtype][0], want["float32"][0], dtype, FP32)
    if dtype == "float32":
        np.testing.assert_allclose(float(aux), float(want[dtype][1]),
                                   rtol=1e-5, atol=1e-5)
    assert (float(aux) > 0) == (cfg.n_experts > 0)


def _prefill_decode(step_fn, params, cfg, caches, tokens, feeds, jax_side):
    """Logits of a prefill over `tokens`, then a decode step per feed."""
    out = []
    if jax_side:
        lg, caches = step_fn[0](params, {"tokens": jnp.asarray(tokens)},
                                caches, cfg, {})
    else:
        lg, caches = step_fn[0](params, {"tokens": torch.from_numpy(tokens)},
                                caches, cfg)
    out.append(lg)
    for tok, index in feeds:
        if jax_side:
            lg, caches = step_fn[1](params, jnp.asarray(tok), caches,
                                    jnp.asarray(index, jnp.int32), cfg, {})
        else:
            ti = index if isinstance(index, int) else torch.from_numpy(index)
            lg, caches = step_fn[1](params, torch.from_numpy(tok), caches,
                                    ti, cfg)
        out.append(lg)
    return out, caches


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ZOO)
def test_prefill_then_decode_match_reference(name, dtype):
    """prefill_step over 32 tokens (the flash branch for the attention
    layers), then three decode steps: two at a shared position, one at
    per-row positions. jamba's smoke config carries the int8 KV cache."""
    cfg, jcfg = _cfgs(name, dtype)
    jp, tp = _params(jcfg, seed=2)
    rng = np.random.RandomState(12)
    b, s, max_len = 2, 32, 40
    tokens = rng.randint(0, 256, size=(b, s))
    feeds = [(rng.randint(0, 256, size=(b, 1)), idx)
             for idx in (s, s + 1, np.asarray([s + 2, s + 3]))]
    tc = lm.init_caches(cfg, b, max_len, device="cpu")
    got, tc2 = _prefill_decode((lm.prefill_step, lm.decode_step), tp, cfg,
                               tc, tokens, feeds, False)
    assert tc2 is tc
    want = {}
    for dt in {dtype, "float32"}:
        c = dataclasses.replace(jcfg, compute_dtype=dt)
        want[dt], jc = _prefill_decode(
            (jlm.prefill_step, jlm.decode_step), jp, c,
            jlm.init_caches(c, b, max_len), tokens, feeds, True)
    for i, g in enumerate(got):
        assert g.shape == (b, 256)
        _held(g, want[dtype][i], want["float32"][i], dtype,
              FP32 if i == 0 else FP32_DECODE)
    assert set(tc) == set(jc)
    for name_ in tc:
        assert set(tc[name_]) == set(jc[name_])
        for key, t in tc[name_].items():
            assert tuple(t.shape) == jc[name_][key].shape, (name_, key)
    assert (cfg.kv_cache_dtype == "int8") == any(
        "k_scale" in unit for unit in tc.values())


@pytest.mark.parametrize("name", ZOO)
def test_lm_loss_with_aux_matches_reference(name):
    cfg, jcfg = _cfgs(name, "float32")
    jp, tp = _params(jcfg, seed=3)
    rng = np.random.RandomState(13)
    toks = rng.randint(0, 256, size=(2, 16)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
             "loss_mask": (rng.rand(2, 16) > 0.2).astype(np.float32)}
    total, parts = lm.lm_loss(tp, {k: torch.from_numpy(v)
                                   for k, v in batch.items()}, cfg)
    jtotal, jparts = jlm.lm_loss(jp, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, jcfg,
                                 rules={})
    for got, want in ((total, jtotal), (parts["ce"], jparts["ce"]),
                      (parts["aux"], jparts["aux"])):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                   atol=1e-5)
    want_total = float(parts["ce"]) + cfg.aux_loss_coef * float(parts["aux"])
    assert float(total) == pytest.approx(want_total, rel=1e-6)
    assert (float(parts["aux"]) > 0) == (cfg.n_experts > 0)

# ---------------------------------------------------------------------------
# the decode window, the refusals
# ---------------------------------------------------------------------------


def test_attention_free_decode_window_is_the_caches_max_len():
    """mamba2 has no KV cache: a decode position is held to the max_len
    `init_caches` was given, and caches that carry none raise."""
    cfg = get_smoke_config("mamba2-780m")
    tp = lm.init_lm_params(cfg, 0, device="cpu")
    caches = lm.init_caches(cfg, 2, 8, device="cpu")
    assert caches.max_len == 8
    lm.decode_step(tp, torch.tensor([[1], [2]]), caches, 7, cfg)
    for index in (8, torch.tensor([0, 8]), -1):
        with pytest.raises(ValueError, match="outside"):
            lm.decode_step(tp, torch.tensor([[1], [2]]), caches, index, cfg)
    plain = {k: v for k, v in caches.items()}
    with pytest.raises(ValueError, match="max_len"):
        lm.decode_step(tp, torch.tensor([[1], [2]]), plain, 0, cfg)


def test_hybrid_decode_window_comes_from_the_attention_block():
    cfg = get_smoke_config("jamba-v0.1-52b")
    caches = lm.init_caches(cfg, 1, 12, device="cpu")
    assert lm._window(caches, cfg) == 12
    assert lm._window({k: v for k, v in caches.items()}, cfg) == 12


@pytest.mark.parametrize("name", ZOO)
def test_training_the_new_families_is_refused(name):
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_lm_train_step
    cfg = get_smoke_config(name)
    with pytest.raises(NotImplementedError, match="training slice"):
        build_lm_train_step(cfg, adamw(1e-3))
    with pytest.raises(NotImplementedError, match="training slice"):
        train_cli.main(["--arch", name, "--smoke", "--steps", "1",
                        "--device", "cpu"])
