"""Training the port's MoE, SSM and hybrid LM families, the train step:
`build_lm_train_step` against the reference's jitted step over three
steps, and the launcher at `--smoke --device cpu`, at smoke size on the
CPU with the reference's parameters copied across (`lm_params_from_jax`).
The loss, its gradients and the remat modes are in
tests/test_torch_lm_zoo_train.py.

Tolerances. fp32 compute: the loss within rtol/atol 1e-5 and the
parameters after each of three steps within rtol/atol 1e-5 of the
reference's (Adam's u = m / sqrt(v) turns gradient differences of 1e-6
into parameter differences of lr * 1e-3 at the smallest gradients); bf16
gradients add 3 * lr * 2^-7 to the atol. The launcher is held bit-equal
to the same steps driven by hand.
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
from repro.nn.params import init_params as jinit
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.models import lm
from repro_torch.nn.params import tree_leaves
from repro_torch.optim import adamw
from repro_torch.train.steps import build_lm_train_step

ZOO = ["granite-moe-1b-a400m", "granite-moe-3b-a800m", "mamba2-780m",
       "jamba-v0.1-52b"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


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

def _ref_steps(jcfg, jp, batches, accum, grad_dtype, lr=1e-3):
    opt = jopt.adamw(lr)
    step = jax.jit(jsteps.build_lm_train_step(
        jcfg, opt, accum_steps=accum, grad_dtype=grad_dtype))
    state, out = opt.init(jp), []
    for i, batch in enumerate(batches):
        jp, state, m = step(jp, state, _jbatch(batch),
                            jnp.asarray(i, jnp.int32))
        out.append((float(m["loss"]), jax.tree.leaves(jp)))
    return out


@pytest.mark.parametrize("name,accum,grad_dtype", [
    (name, accum, gd) for name in ZOO for accum in (1, 2)
    for gd in ("float32", "bfloat16")
    if name != "jamba-v0.1-52b" or (accum == 2) == (gd == "bfloat16")])
def test_lm_train_step_matches_reference(name, accum, grad_dtype):
    """fp32 compute, batch 4 of 32 tokens, adamw(1e-3) with its clip,
    three steps on three batches: the loss and every parameter after each
    step (jamba: accum 1 with fp32 gradients and accum 2 with bf16 ones).
    bf16 gradients 1e-6 apart can round to neighbouring bf16 values; the
    Adam update m / sqrt(v) then moves by up to 2^-7 relative (m by one
    bf16 ulp, v by two), a parameter by lr * 2^-7 a step, so bf16
    gradients add 3 * lr * 2^-7 to the parameters' atol."""
    cfg, jcfg = _cfgs(name, "float32")
    jp, tp = _params(jcfg)
    batches = [_batch(cfg, 4, 32, seed=i) for i in range(3)]
    opt = adamw(1e-3)
    step = build_lm_train_step(cfg, opt, accum_steps=accum,
                               grad_dtype=grad_dtype)
    want = _ref_steps(jcfg, jp, batches, accum, grad_dtype)
    atol = 1e-5 + (3 * 1e-3 * 2 ** -7 if grad_dtype == "bfloat16" else 0)
    state = opt.init(tp)
    for i, batch in enumerate(batches):
        tp, state, metrics = step(tp, state, batch, i)
        assert set(metrics) == {"loss", "ce", "aux"}
        np.testing.assert_allclose(float(metrics["loss"]), want[i][0],
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(tree_leaves(tp), want[i][1]):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("name", ZOO)
def test_launcher_trains_the_family_on_the_cpu(name, tmp_path):
    """`launch.train --smoke --device cpu`: finite losses, equal to the
    bits of build_lm_train_step driven by hand from init_lm_params(seed 0)
    on make_lm_batch's batches."""
    from repro_torch.launch import train as train_cli
    steps, b, s = 3, 2, 32
    run = train_cli.main(["--arch", name, "--smoke", "--steps", str(steps),
                          "--batch", str(b), "--seq", str(s), "--device",
                          "cpu", "--ckpt-dir", str(tmp_path),
                          "--log-every", "100"])
    assert len(run.losses) == steps and np.isfinite(run.losses).all()
    cfg = get_smoke_config(name)
    params = lm.init_lm_params(cfg, train_cli.PARAM_SEED, device="cpu")
    opt = adamw(3e-4)
    state = opt.init(params)
    step = build_lm_train_step(cfg, opt)
    losses = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v)
                 for k, v in make_lm_batch(cfg, b, s, i, 0).items()}
        params, state, m = step(params, state, batch, i)
        losses.append(float(m["loss"]))
    assert run.losses == losses
    for a, c in zip(tree_leaves(run.params), tree_leaves(params)):
        assert torch.equal(a, c)
