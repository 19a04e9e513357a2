"""The share of (token, slot) pairs that capacity drops in the first MoE
layer of full-width granite-moe-1b-a400m, under the reference's
`repro.nn.moe` routing and under the port's, each on its own seeded init
(`repro.nn.params.init_params` with a `jax.random` key; the port's
`init_lm_params` with a `torch.Generator`) and its own `make_lm_batch`
data: 4 x 1,024 = 4,096 tokens in one MoE group (the config's), bf16
compute as the launcher trains. The layer's input is each package's own
embedding, first attention block and second norm.

The port drops 20.5% of the pairs at 4,096 x 4 on the card over all 24
layers (`PERF.md`). If the reference routed the same kind of inputs more
evenly, the port's routing or init would be at fault. The shares are
held to each other within their sampling spread: four times the larger
of the two seeds' gap within each package and the binomial standard
error of a share over the layer's 32,768 pairs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.nn import layers as JL
from repro.nn import moe as JMOE
from repro.nn.params import init_params as jinit
from repro.nn.sharding import TRAIN_RULES as JTRAIN
from repro_torch.configs import get_config
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.models import lm
from repro_torch.nn import layers as L
from repro_torch.nn import moe as MOE

ARCH = "granite-moe-1b-a400m"
BATCH, SEQ = 4, 1024
SEEDS = (0, 1)


def _one_unit(cfg):
    import dataclasses
    return dataclasses.replace(cfg, n_layers=len(cfg.pattern))


class _Routed(Exception):
    """Raised once the routing is known: the experts' products are not
    needed."""


class _TopK:
    """Stands in for `repro.nn.moe`'s `jax`: keeps what its first
    `vmap`-ed call (the gather table's scatter of the (token, slot) pairs,
    whose expert index is e_pad for a dropped pair) was given, then stops
    the layer."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def vmap(self, fn, *a, **kw):
        def call(*args):
            self.calls.append(args)
            raise _Routed
        return call


def _reference_share(seed: int, monkeypatch) -> float:
    cfg = _one_unit(jget_config(ARCH))
    p = jinit(jlm.lm_param_specs(cfg), jax.random.PRNGKey(seed))
    batch = {k: jnp.asarray(v) for k, v in make_lm_batch(
        get_config(ARCH), BATCH, SEQ, 0, seed).items()}
    dt = jnp.bfloat16
    bp = jax.tree.map(lambda t: t[0], p["blocks"]["b0"])

    @jax.jit
    def moe_input(p, bp, batch):
        x, pos = jlm.embed_input(p, batch, cfg, JTRAIN)
        h = JL.apply_norm(bp["ln1"], x, cfg.norm_type, dtype=dt)
        h, _ = JL.attention(bp["attn"], h, cfg, pos, mode="train", dtype=dt)
        return JL.apply_norm(bp["ln2"], x + h, cfg.norm_type, dtype=dt)
    h = moe_input(p, bp, batch)
    spy = _TopK()
    monkeypatch.setattr(JMOE, "jax", spy)
    try:
        JMOE.moe(bp["ffn"], h, cfg, dtype=dt)
    except _Routed:
        pass
    monkeypatch.undo()
    slot_e = np.asarray(spy.calls[0][0])
    return float(np.mean(slot_e == cfg.n_experts + cfg.expert_pad))


def _port_share(seed: int) -> float:
    cfg = _one_unit(get_config(ARCH))
    p = lm.init_lm_params(cfg, seed, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(
        cfg, BATCH, SEQ, 0, seed).items()}
    dt = torch.bfloat16
    bp = {k: (v.unbind(0)[0] if not isinstance(v, dict) else
              {n: t[0] for n, t in v.items()})
          for k, v in p["blocks"]["b0"].items()}
    with torch.no_grad():
        x, pos = lm.embed_input(p, batch, cfg)
        h = L.apply_norm(bp["ln1"], x, cfg.norm_type, dtype=dt)
        h, _ = L.attention(bp["attn"], h, cfg, pos, mode="train", dtype=dt)
        x = x + h
        h = L.apply_norm(bp["ln2"], x, cfg.norm_type, dtype=dt)
        g = max(1, cfg.moe_groups)
        tg = BATCH * SEQ // g
        cap = MOE._capacity(tg, cfg.n_experts, cfg.top_k,
                            cfg.capacity_factor)
        r = MOE.route(bp["ffn"]["router"], h.reshape(g, tg, -1).to(dt), cfg,
                      cap, dt)
    return float(1.0 - r["keep"].float().mean())


def test_dropped_pair_shares_agree_at_full_width(monkeypatch):
    ref = [_reference_share(s, monkeypatch) for s in SEEDS]
    port = [_port_share(s) for s in SEEDS]
    cfg = get_config(ARCH)
    pairs = BATCH * SEQ * cfg.top_k
    p = (np.mean(ref) + np.mean(port)) / 2
    spread = max(abs(ref[0] - ref[1]), abs(port[0] - port[1]),
                 np.sqrt(p * (1 - p) / pairs))
    assert abs(np.mean(ref) - np.mean(port)) <= 4 * spread, (ref, port)
    # both drop pairs at the reference's init: capacity 1.25 x the mean
    # load is not enough when the router's logits are this far apart
    assert min(ref + port) > 0.01
