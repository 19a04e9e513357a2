"""The port's MoE layer (`repro_torch.nn.moe`) against the reference's
`repro.nn.moe`, at smoke size on the CPU, on the same numpy inputs and
parameters.

The reference's routing intermediates (top-k's gates and indices, the
(expert, slot) each (token, slot) lands in, the gather table) are read
from its own run: a stand-in for its `jax` module records what `top_k`
returned and what each `vmap`-ed function was called with and returned.

Tolerances. Integer routing results (gate indices, positions within an
expert, the keep mask, the gather table) are equal. fp32 compute: the
gates, the output and the aux loss within rtol/atol 1e-5 (the same fp32
arithmetic; the reference's combine adds in no fixed order, the port's
in (token, slot) order). bf16
compute: the output within the reference's own bf16 layer tolerance,
rtol/atol 3e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.nn import moe as JMOE
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.nn import moe as MOE
from repro_torch.nn.params import init_params

MOE_ARCHS = ["granite-moe-1b-a400m", "granite-moe-3b-a800m",
             "jamba-v0.1-52b"]
FP32_TOL = {"rtol": 1e-5, "atol": 1e-5}
BF16_TOL = {"rtol": 3e-2, "atol": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _JaxSpy:
    """Stands in for the `jax` module inside `repro.nn.moe`: records
    `lax.top_k`'s outputs and each `vmap`-ed call's arguments and result,
    and passes everything else through."""

    def __init__(self):
        self.top_k = None
        self.vmaps = []
        spy = self

        class _Lax:
            def __getattr__(self, name):
                return getattr(jax.lax, name)

            def top_k(self, x, k):
                spy.top_k = jax.lax.top_k(x, k)
                return spy.top_k

        self.lax = _Lax()

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        mapped = jax.vmap(fn, *a, **kw)

        def call(*args):
            out = mapped(*args)
            self.vmaps.append((args, out))
            return out
        return call


def _cfgs(name, **kw):
    return (dataclasses.replace(get_smoke_config(name), **kw),
            dataclasses.replace(jget_smoke(name), **kw))


def _params(jcfg, seed):
    jp = jinit(JMOE.moe_specs(jcfg), jax.random.PRNGKey(seed))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _reference(jp, x, jcfg, dtype, cf, monkeypatch):
    """The reference's (y, aux) and its routing, read by `_JaxSpy`."""
    spy = _JaxSpy()
    monkeypatch.setattr(JMOE, "jax", spy)
    y, aux = JMOE.moe(jp, jnp.asarray(x, JDT[dtype]), jcfg, dtype=JDT[dtype],
                      capacity_factor=cf)
    monkeypatch.undo()
    (slot_e, slot_p, _), gather = spy.vmaps[0]
    e_pad = jcfg.n_experts + jcfg.expert_pad
    keep = np.asarray(slot_e) != e_pad
    return {"y": np.asarray(y, np.float32), "aux": float(aux),
            "gate_vals": np.asarray(spy.top_k[0]),
            "gate_idx": np.asarray(spy.top_k[1]), "keep": keep,
            "pos": np.where(keep, np.asarray(slot_p), -1),
            "gather": np.asarray(gather)}


def _f32(t):
    return t.detach().float().numpy()

# ---------------------------------------------------------------------------
# specs and capacity
# ---------------------------------------------------------------------------


def _flat(specs):
    return {k: (tuple(s.shape), s.init, s.scale, s.fan_axis)
            for k, s in specs.items()}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_specs_match_reference(name, smoke):
    from repro.configs import get_config as jget_config
    cfg = get_smoke_config(name) if smoke else get_config(name)
    jcfg = jget_smoke(name) if smoke else jget_config(name)
    assert _flat(MOE.moe_specs(cfg)) == _flat(JMOE.moe_specs(jcfg))


def test_granite_3b_pads_40_experts_to_48():
    specs = MOE.moe_specs(get_config("granite-moe-3b-a800m"))
    assert specs["router"].shape == (1536, 40)
    assert specs["wi"].shape == (48, 1536, 512)
    assert specs["wo"].shape == (48, 512, 1536)


@pytest.mark.parametrize("tokens,e,k,cf", [
    (64, 4, 2, 1.25), (64, 4, 2, 1e-9), (8192, 40, 8, 1.25),
    (8192, 16, 2, 1.25), (4, 16, 2, 1.25), (1000, 7, 3, 0.9)])
def test_capacity_matches_reference(tokens, e, k, cf):
    got = MOE._capacity(tokens, e, k, cf)
    assert got == JMOE._capacity(tokens, e, k, cf)
    assert got >= 8 and got % 8 == 0

# ---------------------------------------------------------------------------
# routing and output against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_routing_and_output_match_reference(name, groups, cf,
                                                monkeypatch):
    """fp32: the routing's integers equal, the gates, output and aux loss
    within 1e-5. A capacity factor of 0.5 drops (token, slot) pairs in
    every arch; 8.0 drops none."""
    cfg, jcfg = _cfgs(name, moe_groups=groups)
    jp, tp = _params(jcfg, seed=3)
    x = np.random.RandomState(4).randn(2, 32, cfg.d_model).astype(np.float32)
    want = _reference(jp, x, jcfg, "float32", cf, monkeypatch)
    t = 2 * 32
    cap = MOE._capacity(t // groups, cfg.n_experts, cfg.top_k, cf)
    xg = torch.from_numpy(x).reshape(groups, t // groups, -1)
    r = MOE.route(tp["router"], xg, cfg, cap, torch.float32)
    np.testing.assert_array_equal(r["gate_idx"].numpy(), want["gate_idx"])
    np.testing.assert_array_equal(r["keep"].numpy(), want["keep"])
    np.testing.assert_array_equal(
        torch.where(r["keep"], r["pos"], -1).numpy(), want["pos"])
    np.testing.assert_array_equal(r["gather"].numpy(), want["gather"])
    top = want["gate_vals"]                       # top-k probabilities
    np.testing.assert_allclose(r["gate_vals"].numpy(),
                               top / top.sum(-1, keepdims=True), **FP32_TOL)
    assert (not want["keep"].all()) == (cf == 0.5)
    y, aux = MOE.moe(tp, torch.from_numpy(x), cfg, torch.float32,
                     capacity_factor=cf)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(_f32(y), want["y"], **FP32_TOL)
    np.testing.assert_allclose(float(aux), want["aux"], **FP32_TOL)
    assert float(aux) == float(r["aux"])


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_bf16_matches_reference(name, monkeypatch):
    cfg, jcfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=5)
    x = np.random.RandomState(6).randn(2, 16, cfg.d_model).astype(np.float32)
    want = _reference(jp, x, jcfg, "bfloat16", None, monkeypatch)
    y, aux = MOE.moe(tp, torch.from_numpy(x), cfg)
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(y), want["y"], **BF16_TOL)
    np.testing.assert_allclose(float(aux), want["aux"], **BF16_TOL)


def test_top_k_ties_take_the_lower_expert_first(monkeypatch):
    """A zero router scores every expert alike: `jax.lax.top_k` takes the
    lowest indices in order, and so does the port (a stable sort), where
    torch.topk promises no order."""
    cfg, jcfg = _cfgs("granite-moe-1b-a400m")
    jp, tp = _params(jcfg, seed=7)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.RandomState(8).randn(1, 16, cfg.d_model).astype(np.float32)
    want = _reference(jp, x, jcfg, "float32", 8.0, monkeypatch)
    r = MOE.route(tp["router"], torch.from_numpy(x), cfg, 64, torch.float32)
    np.testing.assert_array_equal(
        want["gate_idx"], np.broadcast_to(np.arange(cfg.top_k), (1, 16, 2)))
    np.testing.assert_array_equal(r["gate_idx"].numpy(), want["gate_idx"])
    y, _ = MOE.moe(tp, torch.from_numpy(x), cfg, torch.float32,
                   capacity_factor=8.0)
    np.testing.assert_allclose(_f32(y), want["y"], **FP32_TOL)


def test_padded_experts_are_never_routed():
    """granite-moe-3b's smoke config: 4 real experts, 8 pads. No gate
    index reaches a pad, and every pad's gather row is the sentinel."""
    cfg = get_smoke_config("granite-moe-3b-a800m")
    assert (cfg.n_experts, cfg.expert_pad) == (4, 8)
    p = init_params(MOE.moe_specs(cfg), 0, torch.device("cpu"))
    x = torch.randn(1, 64, cfg.d_model, generator=torch.Generator()
                    .manual_seed(9))
    r = MOE.route(p["router"], x, cfg, 64, torch.float32)
    assert int(r["gate_idx"].max()) < cfg.n_experts
    assert r["gather"].shape == (1, 12, 64)
    assert bool((r["gather"][:, cfg.n_experts:] == 64).all())

# ---------------------------------------------------------------------------
# the reference's MoE behaviour tests (tests/test_lm_behaviour.py), on the
# port with its own parameters
# ---------------------------------------------------------------------------


def _moe_cfg():
    return get_smoke_config("granite-moe-1b-a400m")


def _bf16_input(seed, *shape):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                            .astype(np.float32)).bfloat16()


def test_moe_output_and_aux():
    cfg = _moe_cfg()
    p = init_params(MOE.moe_specs(cfg), 0, torch.device("cpu"))
    x = _bf16_input(0, 2, 16, cfg.d_model)
    y, aux = MOE.moe(p, x, cfg, capacity_factor=8.0)
    assert y.shape == x.shape
    assert np.isfinite(float(aux))
    # balanced router at init: aux loss should be near 1 (e * 1/e * 1)
    assert 0.5 < float(aux) < 2.0


def test_moe_capacity_drops_tokens():
    """With capacity factor ~0, every expert keeps only the 8-slot floor,
    so the output's norm drops against a generous capacity."""
    cfg = _moe_cfg()
    p = init_params(MOE.moe_specs(cfg), 0, torch.device("cpu"))
    x = _bf16_input(1, 1, 32, cfg.d_model)
    y_tiny, _ = MOE.moe(p, x, cfg, capacity_factor=1e-9)
    y_big, _ = MOE.moe(p, x, cfg, capacity_factor=8.0)
    assert float(y_tiny.float().abs().sum()) < float(y_big.float().abs().sum())


def test_moe_is_permutation_equivariant():
    """Token order must not change each token's output (capacity
    permitting)."""
    cfg = _moe_cfg()
    p = init_params(MOE.moe_specs(cfg), 1, torch.device("cpu"))
    x = _bf16_input(2, 1, 16, cfg.d_model)
    y, _ = MOE.moe(p, x, cfg, capacity_factor=8.0)
    perm = torch.arange(16).flip(0)
    y2, _ = MOE.moe(p, x[:, perm], cfg, capacity_factor=8.0)
    np.testing.assert_allclose(_f32(y[:, perm]), _f32(y2), rtol=5e-2,
                               atol=5e-2)
