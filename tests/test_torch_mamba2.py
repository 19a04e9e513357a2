"""The port's Mamba-2 mixer (`repro_torch.nn.mamba2`) against the
reference's `repro.nn.mamba2`, at smoke size on the CPU, on the same numpy
inputs and parameters: the segment sum, the chunked SSD scan and its
recurrent step, the causal conv, and `mamba_block` in train, prefill and
decode mode with its caches; and the port's chunked scan against its own
recurrence.

Tolerances. fp32 compute: rtol/atol 1e-5 for the scan and the block (the
same fp32 arithmetic in other summation orders); the recurrence against
the chunked scan 1e-5 as well (an exact rewrite of the same sums). bf16
compute: the reference's own bf16 layer tolerance, rtol/atol 3e-2. The
caches' conv inputs are bf16 in both packages and equal to the bit in
fp32 compute.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.nn import mamba2 as JM
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.nn import mamba2 as M
from repro_torch.nn.params import init_params

SSM_ARCHS = ["mamba2-780m", "jamba-v0.1-52b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": {"rtol": 1e-5, "atol": 1e-5},
       "bfloat16": {"rtol": 3e-2, "atol": 3e-2}}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _pair(x, dtype):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(TDT[dtype])


def _flat(specs):
    return {k: (tuple(s.shape), s.init, s.scale, s.fan_axis)
            for k, s in specs.items()}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_mamba_specs_and_dims_match_reference(name, smoke):
    cfg = get_smoke_config(name) if smoke else get_config(name)
    jcfg = jget_smoke(name) if smoke else jget_config(name)
    assert M.mamba_dims(cfg) == JM.mamba_dims(jcfg)
    assert _flat(M.mamba_specs(cfg)) == _flat(JM.mamba_specs(jcfg))


def test_constant_init_gives_the_reference_values():
    """dt_bias = softplus^-1(1) = log(e - 1) and A_log = 0, as the
    reference's "constant" init draws them."""
    cfg = get_smoke_config("mamba2-780m")
    specs = M.mamba_specs(cfg)
    p = init_params(specs, 0, torch.device("cpu"))
    jp = jinit(JM.mamba_specs(jget_smoke("mamba2-780m")),
               jax.random.PRNGKey(0))
    for key in ("dt_bias", "A_log", "D", "norm_scale", "conv_b"):
        np.testing.assert_array_equal(p[key].numpy(), np.asarray(jp[key]))
    assert float(p["dt_bias"][0]) == np.float32(math.log(math.e - 1))
    assert float(torch.nn.functional.softplus(p["dt_bias"])[0]) == \
        pytest.approx(1.0, rel=1e-6)


def _params(cfg_name, seed, scale=None):
    jcfg = jget_smoke(cfg_name)
    jp = jinit(JM.mamba_specs(jcfg), jax.random.PRNGKey(seed))
    if scale is not None:          # spread A_log / dt_bias off their init
        rng = np.random.RandomState(seed)
        jp = dict(jp, A_log=jnp.asarray(rng.randn(*jp["A_log"].shape)
                                        * scale, jnp.float32),
                  dt_bias=jnp.asarray(rng.randn(*jp["dt_bias"].shape)
                                      * scale, jnp.float32))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}

# ---------------------------------------------------------------------------
# the scan
# ---------------------------------------------------------------------------


def test_segsum_matches_reference_and_exp_is_zero_above_the_diagonal():
    rng = np.random.RandomState(1)
    x = -np.abs(rng.randn(2, 3, 8)).astype(np.float32)
    got = M._segsum(torch.from_numpy(x))
    want = np.asarray(JM._segsum(jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    upper = ~torch.ones(8, 8, dtype=torch.bool).tril()
    assert bool((torch.exp(got)[..., upper] == 0).all())
    assert bool(torch.isneginf(got[..., upper]).all())


def _scan_inputs(seed, b, s, h, p, g, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, s, h, p), np.abs(rng.randn(b, s, h)) * 0.3 + 0.01,
            -np.abs(rng.randn(h)) - 0.1, rng.randn(b, s, g, n) * 0.5,
            rng.randn(b, s, g, n) * 0.5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,h,g,chunk", [(32, 4, 1, 8), (24, 4, 2, 8),
                                         (16, 6, 3, 16), (8, 2, 1, 4)])
def test_ssd_chunked_matches_reference(s, h, g, chunk, dtype):
    x, dt, A, B, C = _scan_inputs(s + h + g, 2, s, h, 16, g, 16)
    jx, tx = _pair(x, dtype)
    jB, tB = _pair(B, dtype)
    jC, tC = _pair(C, dtype)
    jdt, tdt = _pair(dt, "float32")
    jA, tA = _pair(A, "float32")
    y, st = M.ssd_chunked(tx, tdt, tA, tB, tC, chunk)
    wy, wst = JM.ssd_chunked(jx, jdt, jA, jB, jC, chunk)
    assert y.dtype == TDT[dtype] and st.dtype == TDT[dtype]
    _close(y, wy, TOL[dtype])
    _close(st, wst, TOL[dtype])


@pytest.mark.parametrize("g", [1, 2])
def test_ssd_chunked_equals_the_recurrence(g):
    """fp32: the chunked scan's outputs and final state equal
    `ssd_decode_step` run token by token from a zero state, and the
    reference's decode step equals the port's at every token."""
    b, s, h, p, n = 2, 32, 4, 16, 16
    x, dt, A, B, C = (torch.from_numpy(np.asarray(a, np.float32))
                      for a in _scan_inputs(7 + g, b, s, h, p, g, n))
    y, final = M.ssd_chunked(x, dt, A, B, C, 8)
    state = torch.zeros(b, h, p, n)
    jstate = jnp.zeros((b, h, p, n), jnp.float32)
    for t in range(s):
        y_t, state = M.ssd_decode_step(state, x[:, t], dt[:, t], A,
                                       B[:, t], C[:, t])
        wy_t, jstate = JM.ssd_decode_step(
            jstate, *(jnp.asarray(a.numpy()) for a in (
                x[:, t], dt[:, t], A, B[:, t], C[:, t])))
        _close(y_t, wy_t, TOL["float32"])
        _close(y_t, y[:, t], TOL["float32"])
    _close(state, final, TOL["float32"])
    _close(state, jstate, TOL["float32"])


def test_ssd_chunked_refuses_a_ragged_length_where_the_reference_asserts():
    x, dt, A, B, C = (np.asarray(a, np.float32)
                      for a in _scan_inputs(3, 1, 12, 2, 16, 1, 16))
    with pytest.raises(AssertionError):
        JM.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, A, B, C)), 8)
    with pytest.raises(ValueError, match="chunks of 8"):
        M.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)), 8)


@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_reference(dtype):
    rng = np.random.RandomState(4)
    jx, tx = _pair(rng.randn(2, 9, 12), dtype)
    jw, tw = _pair(rng.randn(4, 12), dtype)
    jb, tb = _pair(rng.randn(12), dtype)
    _close(M._causal_conv_train(tx, tw, tb),
           JM._causal_conv_train(jx, jw, jb), TOL[dtype])

# ---------------------------------------------------------------------------
# the block, its caches, and its three modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_mamba_block_train_matches_reference(name, dtype):
    cfg = dataclasses.replace(get_smoke_config(name), compute_dtype=dtype)
    jcfg = dataclasses.replace(jget_smoke(name), compute_dtype=dtype)
    jp, tp = _params(name, 2, scale=0.5)
    jx, tx = _pair(np.random.RandomState(5).randn(2, 32, cfg.d_model), dtype)
    got, cache = M.mamba_block(tp, tx, cfg, mode="train", dtype=TDT[dtype])
    want, _ = JM.mamba_block(jp, jx, jcfg, mode="train", dtype=JDT[dtype])
    assert cache is None and got.dtype == TDT[dtype]
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [32, 2])
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_mamba_block_prefill_then_decode_match_reference(name, s, dtype):
    """Prefill s tokens (s = 2 is shorter than the conv's 3-row tail: the
    rest of the tail is zeros), then four decode steps; outputs and
    caches against the reference's. The reference's prefill returns its
    scan state in the compute dtype and decodes on from that; the port
    keeps the state in its fp32 cache, so in bf16 the states differ by a
    bf16 rounding."""
    cfg = dataclasses.replace(get_smoke_config(name), compute_dtype=dtype)
    jcfg = dataclasses.replace(jget_smoke(name), compute_dtype=dtype)
    jp, tp = _params(name, 3, scale=0.5)
    rng = np.random.RandomState(6)
    jx, tx = _pair(rng.randn(2, s, cfg.d_model), dtype)
    tc = M.init_mamba_cache(2, cfg, "cpu")
    jc = JM.init_mamba_cache(2, jcfg)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tc.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in jc.items()}
    got, tc2 = M.mamba_block(tp, tx, cfg, mode="prefill", cache=tc,
                             dtype=TDT[dtype])
    want, jc = JM.mamba_block(jp, jx, jcfg, mode="prefill", cache=jc,
                              dtype=JDT[dtype])
    assert tc2 is tc and tc["ssm"].dtype == torch.float32
    _close(got, want, TOL[dtype])
    _close(tc["ssm"], jc["ssm"], TOL[dtype])
    if dtype == "float32":
        np.testing.assert_array_equal(_np(tc["conv"]), _np(jc["conv"]))
    if s < cfg.ssm_conv - 1:
        assert not tc["conv"][:, :cfg.ssm_conv - 1 - s].any()
    for _ in range(4):
        jx, tx = _pair(rng.randn(2, 1, cfg.d_model), dtype)
        got, _ = M.mamba_block(tp, tx, cfg, mode="decode", cache=tc,
                               dtype=TDT[dtype])
        want, jc = JM.mamba_block(jp, jx, jcfg, mode="decode", cache=jc,
                                  dtype=JDT[dtype])
        _close(got, want, TOL[dtype])
        _close(tc["ssm"], jc["ssm"], TOL[dtype])
        _close(tc["conv"], jc["conv"], TOL[dtype])


@pytest.mark.parametrize("conv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", SSM_ARCHS)
def test_prefill_then_decode_equals_the_one_shot_forward(name, conv_dtype):
    """fp32: prefill 24 tokens, then decode 8 one at a time; each decode
    output equals the train-mode forward of all 32 at that position. With
    an fp32 conv cache (swapped in for the bf16 one) within 1e-5 (the same sums in another order); with
    the reference's bf16 conv cache, which rounds each conv input by up to
    2^-9 relative, within 1e-2 of the largest output (3.3e-3 measured)."""
    cfg = dataclasses.replace(get_smoke_config(name), compute_dtype="float32")
    _, tp = _params(name, 4, scale=0.5)
    x = torch.from_numpy(np.random.RandomState(7).randn(
        1, 32, cfg.d_model).astype(np.float32))
    full, _ = M.mamba_block(tp, x, cfg, mode="train", dtype=torch.float32)
    cache = M.init_mamba_cache(1, cfg, "cpu")
    cache["conv"] = torch.zeros_like(cache["conv"], dtype=conv_dtype)
    head, _ = M.mamba_block(tp, x[:, :24], cfg, mode="prefill", cache=cache,
                            dtype=torch.float32)
    _close(head, full[:, :24], TOL["float32"])
    tol = (TOL["float32"] if conv_dtype == torch.float32 else
           {"rtol": 1e-2, "atol": 1e-2 * float(full.abs().max())})
    for t in range(24, 32):
        y, _ = M.mamba_block(tp, x[:, t:t + 1], cfg, mode="decode",
                             cache=cache, dtype=torch.float32)
        _close(y[:, 0], full[:, t], tol)


def test_mamba_block_refuses_what_the_reference_asserts():
    cfg = get_smoke_config("mamba2-780m")
    _, tp = _params("mamba2-780m", 0)
    x = torch.randn(1, 2, cfg.d_model)
    with pytest.raises(ValueError, match="one token"):
        M.mamba_block(tp, x, cfg, mode="decode",
                      cache=M.init_mamba_cache(1, cfg, "cpu"))
    with pytest.raises(ValueError, match="needs a cache"):
        M.mamba_block(tp, x, cfg, mode="prefill")
    with pytest.raises(ValueError, match="unknown mamba mode"):
        M.mamba_block(tp, x, cfg, mode="scan")
