"""The port's `sparse_apply="dense"` update against the reference's, on the
CPU: the reference's jitted dense step and the port's own "sparse" step as
oracles, its scatter and row pass on their own, and the row pass's
chunking. Sizes: the smoke dlrm-m1 (6 tables, d 16) and the 10-table
variant of tests/test_torch_train.py (the reference's lookup takes its
scan-over-features branch), batch 8, 4 steps.

Tolerances, each with its reason:
  * the scatter (`dense_gradient_sum`): bit-equal to the reference's scan
    of per-feature scatter-adds; both add each row's slots in feature,
    then slot order (measured: bit-equal on this CPU);
  * the row pass against the reference's formula on the same buffer:
    rtol 1e-6 / atol 1e-7 (mean(g^2) is reduced in another order than
    XLA's, and XLA's rsqrt is not torch's); untouched rows bit-unchanged;
  * whole steps against the reference: rtol/atol 1e-5 (fp32 matmuls and
    sums in other orders; measured up to 1.2e-7 on the table and 5e-10 on
    the accumulator after 4 steps);
  * dense against the port's sparse step: rtol/atol 1e-5 (the fused
    update adds each row's bags in the plan's example-major order, the
    dense scatter feature by feature);
  * the chunked row pass against one chunk: bit-equal.
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _batches, _jb, _setup, _t, _tb, _to_np

from repro.optim import adagrad as jadagrad
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.optim import adagrad
from repro_torch.train import steps

STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
PASS_TOL = {"rtol": 1e-6, "atol": 1e-7}
LR, EPS = 0.05, 1e-8


def _compare(params, state, jparams, jstate):
    np.testing.assert_allclose(params["emb"]["mega"].numpy(),
                               np.asarray(jparams["emb"]["mega"]), **STEP_TOL)
    np.testing.assert_allclose(state["accum"].numpy(),
                               np.asarray(jstate["accum"]), **STEP_TOL)
    for part in ("bottom", "top"):
        for a, b in zip(jax.tree.leaves(jparams[part]),
                        jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     params[part]))):
            np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL)


@pytest.mark.parametrize("plan", [False, True], ids=["no_plan", "plan"])
@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "wide"])
def test_dense_steps_match_the_reference_dense_step(wide, plan):
    cfg, jcfg, ebc, jebc, jparams = _setup(wide)
    batches = _batches(cfg, ebc, 4, plan)
    jopt = jadagrad(0.01)
    jstate = jsteps.dlrm_init_state(jebc, jopt, jparams)
    jstep = jax.jit(jsteps.build_dlrm_train_step(jcfg, jebc, jopt,
                                                 sparse_apply="dense"))
    opt = adagrad(0.01)
    params = params_from_jax(_to_np(jparams), device="cpu")
    state = steps.dlrm_init_state(ebc, opt, params)
    step = steps.build_dlrm_train_step(cfg, ebc, opt, sparse_apply="dense")
    mega = params["emb"]["mega"]
    for t, batch in enumerate(batches):
        jparams, jstate, jm = jstep(jparams, jstate, _jb(batch),
                                    jnp.asarray(t, jnp.int32))
        params, state, m = step(params, state, _tb(batch), t)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **STEP_TOL)
        assert float(m["lookups"]) == float(jm["lookups"])
    assert params["emb"]["mega"] is mega            # updated in place
    _compare(params, state, jparams, jstate)


@pytest.mark.parametrize("plan", [False, True], ids=["no_plan", "plan"])
def test_dense_steps_match_the_ports_sparse_steps(plan):
    cfg, _, ebc, _, jparams = _setup(True, seed=5)
    batches = _batches(cfg, ebc, 4, plan)
    runs = []
    for mode in ("dense", "sparse"):
        opt = adagrad(0.01)
        params = params_from_jax(_to_np(jparams), device="cpu")
        state = steps.dlrm_init_state(ebc, opt, params)
        step = steps.build_dlrm_train_step(cfg, ebc, opt, sparse_apply=mode)
        losses = []
        for t, batch in enumerate(batches):
            params, state, m = step(params, state, _tb(batch), t)
            losses.append(float(m["loss"]))
        runs.append((losses, params["emb"]["mega"], state["accum"]))
    (ld, md, ad), (ls, ms, as_) = runs
    np.testing.assert_allclose(ld, ls, **STEP_TOL)
    torch.testing.assert_close(md, ms, **STEP_TOL)
    torch.testing.assert_close(ad, as_, **STEP_TOL)
    assert ad.count_nonzero() == as_.count_nonzero() > 0


def _scatter_inputs(seed, h=200, d=16, b=32, f=5, lk=8):
    rng = np.random.RandomState(seed)
    idx = ((rng.zipf(1.1, size=(b, f, lk)) - 1) % h).astype(np.int32)
    idx[rng.rand(b, f, lk) < 0.3] = -1
    scale = (10.0 ** rng.randint(-3, 3, size=(b, f, 1))).astype(np.float32)
    g = rng.randn(b, f, d).astype(np.float32) * scale
    return h, idx, g


def _reference_scatter(h, idx, g):
    b, _, lk = idx.shape
    d = g.shape[-1]

    def add_feature(gsum, xs):
        idx_f, g_f = xs
        valid = idx_f >= 0
        safe = jnp.where(valid, idx_f, h)
        upd = jnp.broadcast_to(g_f[:, None, :], (b, lk, d))
        upd = jnp.where(valid[..., None], upd, 0.0)
        return gsum.at[safe.reshape(-1)].add(upd.reshape(b * lk, d)), None

    gsum, _ = jax.jit(lambda i, gg: jax.lax.scan(
        add_feature, jnp.zeros((h + 1, d), jnp.float32),
        (jnp.swapaxes(i, 0, 1), jnp.swapaxes(gg, 0, 1))))(idx, g)
    return np.asarray(gsum)


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_scatter_is_bit_equal_to_the_reference_scan(seed):
    h, idx, g = _scatter_inputs(seed)
    got = steps.dense_gradient_sum(h, _t(idx), _t(g))
    np.testing.assert_array_equal(got.numpy(), _reference_scatter(h, idx, g))
    assert not got[h].any()                          # pads add zeros


def test_dense_row_pass_matches_the_reference_formula():
    h, idx, g = _scatter_inputs(2)
    rng = np.random.RandomState(3)
    mega = rng.randn(h, g.shape[-1]).astype(np.float32)
    accum = rng.rand(h).astype(np.float32)
    gsum = _reference_scatter(h, idx, g)
    j = jnp.asarray(gsum[:h])
    touched = jnp.any(j != 0.0, axis=-1)
    new_accum = accum + jnp.where(touched, jnp.mean(jnp.square(j), axis=-1),
                                  0.0)
    upd = LR * j * jax.lax.rsqrt(new_accum[:, None] + EPS)
    new_mega = mega - jnp.where(touched[:, None], upd, 0.0)
    tm, ta = _t(mega), _t(accum)
    steps.dense_row_pass(tm, ta, _t(gsum), LR, EPS)
    np.testing.assert_allclose(tm.numpy(), np.asarray(new_mega), **PASS_TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(new_accum), **PASS_TOL)
    still = ~np.asarray(touched)
    assert still.any() and (~still).any()
    np.testing.assert_array_equal(tm.numpy()[still], mega[still])
    np.testing.assert_array_equal(ta.numpy()[still], accum[still])


@pytest.mark.parametrize("chunk_rows", [7, 16])
def test_chunked_row_pass_is_bit_equal_to_one_chunk(chunk_rows):
    h, idx, g = _scatter_inputs(4)
    gsum = steps.dense_gradient_sum(h, _t(idx), _t(g))
    rng = np.random.RandomState(5)
    mega = _t(rng.randn(h, g.shape[-1]).astype(np.float32))
    accum = _t(rng.rand(h).astype(np.float32))
    one = (mega.clone(), accum.clone())
    steps.dense_row_pass(*one, gsum, LR, EPS, chunk_rows=h)
    steps.dense_row_pass(mega, accum, gsum, LR, EPS, chunk_rows=chunk_rows)
    assert h % chunk_rows                            # a ragged last chunk
    assert torch.equal(mega, one[0]) and torch.equal(accum, one[1])


@pytest.mark.parametrize("prev", [False, True])
def test_dense_scatter_restores_the_deterministic_setting(prev):
    h, idx, g = _scatter_inputs(6)
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(prev)
    try:
        steps.dense_gradient_sum(h, _t(idx), _t(g))
        assert torch.are_deterministic_algorithms_enabled() == prev
    finally:
        torch.use_deterministic_algorithms(was)


def test_dense_mode_guards_and_the_builders_default():
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    assert inspect.signature(steps.build_dlrm_train_step).parameters[
        "sparse_apply"].default == "sparse"
    steps.build_dlrm_train_step(cfg, ebc, adagrad(0.01), sparse_apply="dense")
    psum = dataclasses.replace(cfg, lookup_impl="psum")
    with pytest.raises(NotImplementedError, match="multi-device"):
        steps.build_dlrm_train_step(psum, ebc, adagrad(0.01),
                                    sparse_apply="dense")
    with pytest.raises(ValueError, match="sparse_apply"):
        steps.build_dlrm_train_step(cfg, ebc, adagrad(0.01),
                                    sparse_apply="rows")
