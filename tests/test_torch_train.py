"""The port's training path against the reference, on the CPU: the sparse
planner, the fused sparse backward, the deduplicated lookup, the
interaction gradient, the dense optimizers, `dlrm_grads`, the train step,
the data pipeline and the launcher. Inputs come from numpy seeds;
parameters and optimizer state are copied across (`repro_torch.convert`).
Sizes: the smoke dlrm-m1 (6 tables, d=16) and a 10-table variant, so the
reference's lookup takes its scan-over-features branch (F > 8) as at full
width.

Tolerances, each with its reason:
  * plans and every other integer output: exactly equal;
  * per-row bag-gradient sums: bit-equal (both add a row's bags one by one
    in the planner's stable CSR order);
  * fused update vs the reference oracle: rtol 1e-6 / atol 1e-7 (mean(g^2)
    is reduced in another order than XLA's, and XLA's rsqrt is not
    torch's: measured differences are up to 2 ulp); vs the Pallas kernel in
    interpret mode: rtol 1e-5 / atol 1e-6 (the reference's own bound for
    its kernel body, which lane-pads D and rescales);
  * pooled lookups: rtol 1e-5 / atol 1e-6 against the reference (its jnp
    pooling sums in another order), bit-equal between the port's own
    plan-less and planned lookups;
  * gradients, losses, parameters and optimizer state after training
    steps: rtol/atol 1e-5 (fp32 matmuls and sums in other orders).
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import dlrm as jdlrm
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.data import pipeline as jpipeline
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sparse_plan as jsp
from repro.nn.params import init_params as jinit
from repro.optim import adagrad as jadagrad
from repro.optim import sgd as jsgd
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.core import dlrm
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.data import pipeline
from repro_torch.data.synthetic import make_dlrm_batch
from repro_torch.kernels import ops, ref, sparse_plan
from repro_torch.launch import train as train_cli
from repro_torch.optim import adagrad, sgd
from repro_torch.train import steps

ROOT = Path(__file__).resolve().parents[1]
STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
FUSED_TOL = {"rtol": 1e-6, "atol": 1e-7}
KERNEL_TOL = {"rtol": 1e-5, "atol": 1e-6}
BAG_TOL = {"rtol": 1e-5, "atol": 1e-6}

# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def _zipf_idx(rng, b, f, lk, h, a=1.1):
    """Duplicate-heavy (Zipf) multi-hot batch with ragged -1 padding."""
    idx = (rng.zipf(a, size=(b, f, lk)) - 1) % h
    lengths = rng.randint(0, lk + 1, size=(b, f))
    mask = np.arange(lk)[None, None, :] < lengths[..., None]
    return np.where(mask, idx, -1).astype(np.int32)


CASES = ["uniform", "zipf", "all_pad", "all_dup", "empty_bags", "single"]


def _corpus(case, seed=0, h=60, b=5, f=3, lk=6):
    """The reference's planner corpus (tests/test_sparse_fused.py)."""
    rng = np.random.RandomState(seed)
    uniform = rng.randint(-1, h, size=(b, f, lk)).astype(np.int32)
    if case == "uniform":
        return uniform
    if case == "zipf":
        return _zipf_idx(rng, b, f, lk, h)
    if case == "all_pad":
        return np.full((b, f, lk), -1, np.int32)
    if case == "all_dup":
        return np.full((b, f, lk), 7, np.int32)
    if case == "empty_bags":
        uniform[::2] = -1                      # whole examples empty
        return uniform
    if case == "long_runs":
        return _long_runs_idx(rng, h, 131, 1, 32)
    return np.full((1, 1, 1), h - 1, np.int32)   # single


def _long_runs_idx(rng, h, b, f, lk):
    """A batch whose plan has one row of ~4,000 bags (a Zipf head row, met
    many times in one bag) and rows of 31, 32, 33 and 65 bags: the lengths
    at which the port's fused kernel cuts a run into stages and 32-bag id
    groups. The other slots are pads."""
    slots = np.concatenate([np.full(n, r, np.int32) for r, n in
                            ((0, 4000), (1, 31), (2, 32), (3, 33), (4, 65))])
    assert slots.size <= b * f * lk and h > 4
    idx = np.full(b * f * lk, -1, np.int32)
    idx[:slots.size] = slots
    return rng.permutation(idx).reshape(b, f, lk)


def _np(plan):
    return [np.asarray(x) for x in plan]


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _wide(cfg):
    """Smoke dims but 10 tables (F > 8), as in tests/test_torch_dlrm.py."""
    return dataclasses.replace(
        cfg, n_sparse_features=10, hash_sizes=cfg.hash_sizes + (61,) * 4,
        mean_lookups=cfg.mean_lookups + (6,) * 4)


def _setup(wide, seed=3):
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    if wide:
        cfg, jcfg = _wide(cfg), _wide(jcfg)
    jebc = JEBC.build(jcfg, n_shards=1, strategy="replicated")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    jparams = jinit(jdlrm.dlrm_param_specs(jcfg, jebc),
                    jax.random.PRNGKey(seed))
    return cfg, jcfg, ebc, jebc, jparams


def _batches(cfg, ebc, n, plan, batch=8):
    """n raw batches made ready for both packages: idx offset to global
    rows, plus the sparse-plan hook's keys when `plan`."""
    hook = pipeline.sparse_plan_hook(ebc.plan.table_offsets)
    out = []
    for t in range(n):
        raw = make_dlrm_batch(cfg, batch, step=t, zipf_alpha=1.05)
        if plan:
            b = hook(raw)
        else:
            b = {**raw, "idx": ebc.offset_indices(raw["idx"])}
        out.append(b)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)

# ---------------------------------------------------------------------------
# planner: integers exactly equal to the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
def test_plan_device_and_host_equal_reference(case):
    idx = _corpus(case)
    want = _np(jsp.build_sparse_plan(jnp.asarray(idx)))
    for w, h in zip(want, jsp.build_sparse_plan_host(idx)):
        np.testing.assert_array_equal(w, h)        # reference's twins agree
    got = sparse_plan.build_sparse_plan(torch.from_numpy(idx))
    host = sparse_plan.build_sparse_plan_host(idx)
    for w, g, h in zip(want, got, host):
        assert g.dtype == torch.int32 and h.dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(h, w)


@pytest.mark.parametrize("case", ["uniform", "zipf", "all_dup"])
def test_plan_capacity_trim_and_flat_stream_equal_reference(case):
    idx = _corpus(case, seed=1)
    lk = idx.shape[2]
    n_unique = len(np.unique(idx[idx >= 0]))
    cap = max(n_unique, 1)
    want = _np(jsp.build_sparse_plan(jnp.asarray(idx), capacity=cap))
    got = sparse_plan.build_sparse_plan(torch.from_numpy(idx), capacity=cap)
    host = sparse_plan.build_sparse_plan_host(idx.reshape(-1),
                                              lookups_per_bag=lk,
                                              capacity=cap)
    assert len(want[0]) == cap and len(want[1]) == cap + 1
    for w, g, h in zip(want, got, host):
        np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(h, w)
    flat = sparse_plan.build_sparse_plan(torch.from_numpy(idx.reshape(-1)),
                                         lookups_per_bag=lk)
    for w, g in zip(_np(jsp.build_sparse_plan(jnp.asarray(idx))), flat):
        np.testing.assert_array_equal(g.numpy(), w)
    if n_unique > 1:
        with pytest.raises(ValueError, match="capacity overflow"):
            sparse_plan.build_sparse_plan_host(idx, capacity=n_unique - 1)


def test_plan_sort_is_stable_on_long_runs():
    """A row repeated across many bags keeps its slots in flat-batch order,
    which an unstable sort would not (the fused sum order depends on it)."""
    rng = np.random.RandomState(5)
    idx = rng.randint(0, 3, size=(64, 4, 16)).astype(np.int32)
    idx[rng.rand(*idx.shape) < 0.2] = -1
    got = sparse_plan.build_sparse_plan(torch.from_numpy(idx))
    want = _np(jsp.build_sparse_plan_host(idx))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


def test_plan_from_batch_and_to_batch_round_trip():
    idx = _corpus("zipf", seed=2)
    plan = sparse_plan.build_sparse_plan_host(idx)
    batch = plan.to_batch()
    assert set(batch) == {"plan_rows", "plan_offsets", "plan_bags"}
    back = sparse_plan.plan_from_batch(batch)
    for a, b in zip(plan, back):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), a)
    assert sparse_plan.plan_from_batch({"idx": idx}) is None

# ---------------------------------------------------------------------------
# fused sparse backward
# ---------------------------------------------------------------------------


def _fused_inputs(case, seed=0, h=60, d=12):
    idx = _corpus(case, seed=seed, h=h)
    rng = np.random.RandomState(seed + 100)
    b, f, _ = idx.shape
    table = rng.randn(h, d).astype(np.float32)
    accum = np.abs(rng.randn(h)).astype(np.float32)
    pooled = rng.randn(b, f, d).astype(np.float32)
    return idx, table, accum, pooled


@pytest.mark.parametrize("case", CASES + ["long_runs"])
def test_bag_grad_sums_bit_equal_to_reference(case):
    idx, _, _, pooled = _fused_inputs(case)
    plan = jsp.build_sparse_plan_host(idx)
    p2 = pooled.reshape(-1, pooled.shape[-1])
    want = np.asarray(jref.bag_grad_sums(*map(jnp.asarray, plan),
                                         jnp.asarray(p2)))
    got = ref.bag_grad_sums_abs(_t(plan.bag_offsets), _t(plan.bag_ids),
                                _t(p2))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", CASES)
def test_fused_sparse_backward_matches_reference_oracle(case):
    idx, table, accum, pooled = _fused_inputs(case)
    plan = jsp.build_sparse_plan_host(idx)
    wt, wa = jref.fused_bag_backward_adagrad_ref(
        jnp.asarray(table), jnp.asarray(accum), *map(jnp.asarray, plan),
        jnp.asarray(pooled.reshape(-1, pooled.shape[-1])), 0.05)
    t, a = _t(table), _t(accum)
    gt, ga = ops.fused_sparse_backward(t, a, _t(idx), _t(pooled), 0.05)
    assert gt is t and ga is a                     # in place
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **FUSED_TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **FUSED_TOL)
    touched = np.zeros(len(table), bool)
    touched[idx[idx >= 0]] = True
    np.testing.assert_array_equal(gt.numpy()[~touched], table[~touched])
    np.testing.assert_array_equal(ga.numpy()[~touched], accum[~touched])


@pytest.mark.parametrize("h,d,b,f,lk,corpus", [
    # lane-aligned d
    pytest.param(64, 128, 4, 2, 5, "uniform", id="64-128-4-2-5"),
    # the reference pads and rescales d
    pytest.param(97, 48, 6, 3, 7, "uniform", id="97-48-6-3-7"),
    # d > lane, truncation-sized lk
    pytest.param(33, 200, 2, 1, 32, "uniform", id="33-200-2-1-32"),
    # a ~4,000-bag run and runs at the kernel's stage and group lengths
    pytest.param(60, 64, 131, 1, 32, "long_runs", id="long_runs"),
])
def test_fused_sparse_backward_matches_pallas_interpret(h, d, b, f, lk,
                                                        corpus):
    rng = np.random.RandomState(h)
    if corpus == "long_runs":
        idx = _long_runs_idx(rng, h, b, f, lk)
    else:
        idx = rng.randint(-1, h, size=(b, f, lk)).astype(np.int32)
    table = rng.randn(h, d).astype(np.float32)
    accum = np.abs(rng.randn(h)).astype(np.float32)
    pooled = rng.randn(b, f, d).astype(np.float32)
    wt, wa = jops.fused_sparse_backward(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(idx),
        jnp.asarray(pooled), 0.05, use_kernel=None, interpret=True)
    gt, ga = ops.fused_sparse_backward(_t(table), _t(accum), _t(idx),
                                       _t(pooled), 0.05)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **KERNEL_TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **KERNEL_TOL)


def test_fused_sparse_backward_plan_equals_on_device_plan():
    idx, table, accum, pooled = _fused_inputs("zipf", seed=4)
    plan = sparse_plan.build_sparse_plan_host(idx)
    t1, a1 = ops.fused_sparse_backward(
        _t(table), _t(accum), None, _t(pooled), 0.05,
        plan=sparse_plan.SparsePlan(*(_t(x) for x in plan)))
    t2, a2 = ops.fused_sparse_backward(_t(table), _t(accum), _t(idx),
                                       _t(pooled), 0.05)
    assert torch.equal(t1, t2) and torch.equal(a1, a2)


def test_fused_sparse_backward_rejects_what_it_cannot_update():
    idx, table, accum, pooled = _fused_inputs("uniform")
    with pytest.raises(ValueError, match="require grad"):
        ops.fused_sparse_backward(_t(table).requires_grad_(), _t(accum),
                                  _t(idx), _t(pooled), 0.05)
    with pytest.raises(ValueError, match="idx or a plan"):
        ops.fused_sparse_backward(_t(table), _t(accum), None, _t(pooled),
                                  0.05)
    with pytest.raises(ValueError):
        ops.fused_sparse_backward(_t(table), _t(accum[:-1]), _t(idx),
                                  _t(pooled), 0.05)

# ---------------------------------------------------------------------------
# deduplicated lookup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("case", ["uniform", "zipf", "all_dup", "empty_bags"])
def test_dedup_embedding_bag_matches_reference(case, mode):
    idx3 = _corpus(case, seed=6)
    b, f, lk = idx3.shape
    idx = idx3.reshape(b * f, lk)
    table = np.random.RandomState(7).randn(60, 24).astype(np.float32)
    plan = jsp.build_sparse_plan_host(idx.reshape(-1), lookups_per_bag=lk)
    jplan = jsp.SparsePlan(*map(jnp.asarray, plan))
    got = ops.dedup_embedding_bag(_t(table), _t(idx),
                                  sparse_plan.SparsePlan(*map(_t, plan)),
                                  mode)
    for interpret in (False, True):
        want = jops.dedup_embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                        jplan, mode, None, interpret)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAG_TOL)
    # bit-equal to the port's plan-less lookup, with the plan built here,
    # on the fly, or capacity-trimmed to the unique count
    plain = ops.embedding_bag(_t(table), _t(idx), mode)
    assert torch.equal(got, plain)
    assert torch.equal(ops.dedup_embedding_bag(_t(table), _t(idx), None,
                                               mode), plain)
    cap = max(len(np.unique(idx[idx >= 0])), 1)
    trimmed = sparse_plan.build_sparse_plan(_t(idx), lookups_per_bag=lk,
                                            capacity=cap)
    assert torch.equal(ops.dedup_embedding_bag(_t(table), _t(idx), trimmed,
                                               mode), plain)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("case", ["no_tail", "trimmed", "all_pad"])
def test_dedup_embedding_bag_plan_shapes_match_reference(case, mode):
    """Plans whose live prefix fills them (U = the unique count, no -1
    tail), plans trimmed below the flat stream but still covering it, and a
    batch of pads only, through the port's lookup on the CPU: allclose to
    the reference's Pallas body in interpret mode (it adds in CSR order),
    bit-equal to the reference's jnp oracle and to the plan-less lookup."""
    rng = np.random.RandomState(11)
    b, lk, h = 24, 32, 90
    idx = _zipf_idx(rng, b, 1, lk, h).reshape(b, lk)
    if case == "all_pad":
        idx[:] = -1
    n_unique = len(np.unique(idx[idx >= 0]))
    capacity = {"no_tail": n_unique, "trimmed": n_unique + 5,
                "all_pad": None}[case]
    table = rng.randn(h, 40).astype(np.float32)
    plan = jsp.build_sparse_plan_host(idx.reshape(-1), lookups_per_bag=lk,
                                      capacity=capacity)
    rows = plan[0]
    assert (rows >= 0).sum() == n_unique
    assert rows.shape[0] == (capacity or b * lk)
    got = ops.dedup_embedding_bag(_t(table), _t(idx),
                                  sparse_plan.SparsePlan(*map(_t, plan)),
                                  mode)
    jplan = jsp.SparsePlan(*map(jnp.asarray, plan))
    body = jops.dedup_embedding_bag(jnp.asarray(table), jnp.asarray(idx),
                                    jplan, mode, None, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(body), **BAG_TOL)
    oracle = jref.dedup_embedding_bag_ref(jnp.asarray(table),
                                          jnp.asarray(idx),
                                          jnp.asarray(rows), mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(oracle))
    assert torch.equal(got, ops.embedding_bag(_t(table), _t(idx), mode))
    if case == "all_pad":
        assert not got.any()


def test_dedup_embedding_bag_rejects_bad_input():
    t = torch.zeros((4, 8))
    i = torch.zeros((2, 3), dtype=torch.int32)
    rows = torch.zeros((1,), dtype=torch.int32)
    from repro_torch.kernels import embedding_bag
    with pytest.raises(ValueError, match="mode"):
        embedding_bag.dedup_embedding_bag(t, i, rows, "max")
    with pytest.raises(ValueError):
        embedding_bag.dedup_embedding_bag(t, i.reshape(-1), rows)


@pytest.mark.parametrize("wide", [False, True])
def test_planned_lookup_bit_equal_and_matches_reference(wide):
    cfg, jcfg, ebc, jebc, jparams = _setup(wide)
    params = params_from_jax(_to_np(jparams), device="cpu")
    batch = _batches(cfg, ebc, 1, plan=True)[0]
    plan = sparse_plan.plan_from_batch(_tb(batch))
    got = ebc.lookup(params["emb"], _t(batch["idx"]), plan=plan)
    assert torch.equal(got, ebc.lookup(params["emb"], _t(batch["idx"])))
    want = jebc.lookup(jparams["emb"], jnp.asarray(batch["idx"]),
                       plan=jsp.plan_from_batch(_jb(batch)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BAG_TOL)

# ---------------------------------------------------------------------------
# interaction gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,f,d", [(6, 7, 16), (4, 11, 16), (3, 31, 64)])
def test_dot_interaction_gradient_matches_reference_vjp(b, f, d):
    rng = np.random.RandomState(f)
    z = rng.randn(b, f, d).astype(np.float32)
    g = rng.randn(b, f * (f - 1) // 2).astype(np.float32)
    out, vjp = jax.vjp(lambda x: jops.dot_interaction(x), jnp.asarray(z))
    (want,) = vjp(jnp.asarray(g))
    zt = _t(z).requires_grad_()
    got = ops.dot_interaction(zt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **STEP_TOL)
    got.backward(_t(g))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want), **STEP_TOL)


def test_dot_interaction_gradcheck_float64():
    z = torch.from_numpy(np.random.RandomState(0).randn(3, 5, 4)) \
        .requires_grad_()
    assert torch.autograd.gradcheck(ops.dot_interaction, (z,))


def test_interact_gradient_reaches_bottom_and_pooled():
    from repro_torch.core.interaction import interact
    rng = np.random.RandomState(1)
    bot = _t(rng.randn(4, 8).astype(np.float32)).requires_grad_()
    pooled = _t(rng.randn(4, 3, 8).astype(np.float32)).requires_grad_()
    interact(bot, pooled, "dot").sum().backward()
    assert pooled.grad is not None and pooled.grad.abs().sum() > 0
    assert bot.grad is not None and bot.grad.abs().sum() > 0

# ---------------------------------------------------------------------------
# dense optimizers
# ---------------------------------------------------------------------------


def _opt_trees(seed):
    rng = np.random.RandomState(seed)
    params = {"bottom": [{"w": rng.randn(5, 3), "b": rng.randn(3)}],
              "top": [{"w": rng.randn(3, 1), "b": rng.randn(1)}]}
    grads = [jax.tree.map(lambda x: rng.randn(*x.shape), params)
             for _ in range(3)]
    f32 = lambda t: jax.tree.map(lambda x: np.float32(x), t)  # noqa: E731
    return f32(params), [f32(g) for g in grads]


@pytest.mark.parametrize("make,jmake", [
    (lambda: adagrad(0.01), lambda: jadagrad(0.01)),
    (lambda: sgd(0.1), lambda: jsgd(0.1)),
    (lambda: sgd(0.1, momentum=0.9), lambda: jsgd(0.1, momentum=0.9)),
], ids=["adagrad", "sgd", "sgd_momentum"])
def test_dense_optimizer_matches_reference(make, jmake):
    params, grads = _opt_trees(0)
    opt, jopt = make(), jmake()
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    tp = jax.tree.map(_t, params)
    ts = opt.init(tp)
    for i, g in enumerate(grads):
        jp, js = jopt.apply(jp, jax.tree.map(jnp.asarray, g), js,
                            jnp.asarray(i))
        tp, ts = opt.apply(tp, jax.tree.map(_t, g), ts, i)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), tp))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-7)


def test_adagrad_is_not_torch_optim_adagrad():
    """The reference's rsqrt(s + eps) differs from torch.optim.Adagrad's
    1 / (sqrt(s) + eps) — visible once eps is not negligible."""
    p, g = torch.ones(3), torch.full((3,), 0.5)
    opt = adagrad(1.0, eps=0.25)
    new, _ = opt.apply(p, g, opt.init(p), 0)
    assert torch.allclose(new, p - g / torch.sqrt(g * g + 0.25))
    assert not torch.allclose(new, p - g / (g.abs() + 0.25))

# ---------------------------------------------------------------------------
# dlrm_grads and the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("plan", [False, True], ids=["no_plan", "plan"])
@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "wide"])
def test_dlrm_grads_match_reference(wide, plan):
    cfg, jcfg, ebc, jebc, jparams = _setup(wide)
    params = params_from_jax(_to_np(jparams), device="cpu")
    batch = _batches(cfg, ebc, 1, plan)[0]
    wl, wg, (widx, wp) = jdlrm.dlrm_grads(jparams, _jb(batch), jcfg, jebc)
    loss, g, (idx, gp) = dlrm.dlrm_grads(params, _tb(batch), cfg, ebc)
    np.testing.assert_allclose(float(loss), float(wl), **STEP_TOL)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), **STEP_TOL)
    for a, b in zip(jax.tree.leaves(wg), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), g))):
        np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL)
    assert not any(t.requires_grad for t in params["bottom"][0].values())
    ref_loss = dlrm.dlrm_loss(params, _tb(batch), cfg, ebc)
    np.testing.assert_allclose(float(ref_loss), float(loss), **STEP_TOL)


def _compare_state(params, state, jparams, jstate):
    np.testing.assert_allclose(params["emb"]["mega"].numpy(),
                               np.asarray(jparams["emb"]["mega"]), **STEP_TOL)
    np.testing.assert_allclose(state["accum"].numpy(),
                               np.asarray(jstate["accum"]), **STEP_TOL)
    for part in ("bottom", "top"):
        for a, b in zip(jax.tree.leaves(jparams[part]),
                        jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     params[part]))):
            np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL)
    for a, b in zip(jax.tree.leaves(jstate["dense"]),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 state["dense"]))):
        np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL)


@pytest.mark.parametrize("plan", [False, True], ids=["no_plan", "plan"])
@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "wide"])
def test_three_train_steps_match_reference(wide, plan):
    cfg, jcfg, ebc, jebc, jparams = _setup(wide)
    batches = _batches(cfg, ebc, 3, plan)
    jopt = jadagrad(0.01)
    jstate = jsteps.dlrm_init_state(jebc, jopt, jparams)
    jstep = jax.jit(jsteps.build_dlrm_train_step(jcfg, jebc, jopt,
                                                 sparse_apply="sparse"))
    opt = adagrad(0.01)
    params = params_from_jax(_to_np(jparams), device="cpu")
    state = steps.dlrm_init_state(ebc, opt, params)
    step = steps.build_dlrm_train_step(cfg, ebc, opt, sparse_apply="sparse")
    for t, batch in enumerate(batches):
        jparams, jstate, jm = jstep(jparams, jstate, _jb(batch),
                                    jnp.asarray(t, jnp.int32))
        params, state, m = step(params, state, _tb(batch), t)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **STEP_TOL)
        assert float(m["lookups"]) == float(jm["lookups"])
    _compare_state(params, state, jparams, jstate)


def test_step_continues_a_reference_run_from_carried_state():
    cfg, jcfg, ebc, jebc, jparams = _setup(False, seed=8)
    batches = _batches(cfg, ebc, 3, plan=True)
    jopt = jadagrad(0.01)
    jstate = jsteps.dlrm_init_state(jebc, jopt, jparams)
    jstep = jax.jit(jsteps.build_dlrm_train_step(jcfg, jebc, jopt,
                                                 sparse_apply="sparse"))
    for t in range(2):
        jparams, jstate, _ = jstep(jparams, jstate, _jb(batches[t]),
                                   jnp.asarray(t, jnp.int32))
    params = params_from_jax(_to_np(jparams), device="cpu")
    state = state_from_jax(_to_np(jstate), device="cpu")
    assert state["accum"].abs().sum() > 0          # carried, not fresh
    step = steps.build_dlrm_train_step(cfg, ebc, adagrad(0.01))
    params, state, m = step(params, state, _tb(batches[2]), 2)
    jparams, jstate, jm = jstep(jparams, jstate, _jb(batches[2]),
                                jnp.asarray(2, jnp.int32))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               **STEP_TOL)
    _compare_state(params, state, jparams, jstate)


def test_planned_and_unplanned_steps_are_bit_equal():
    cfg, _, ebc, _, jparams = _setup(True)
    runs = []
    for plan in (False, True):
        params = params_from_jax(_to_np(jparams), device="cpu")
        state = steps.dlrm_init_state(ebc, adagrad(0.01), params)
        step = steps.build_dlrm_train_step(cfg, ebc, adagrad(0.01))
        for t, batch in enumerate(_batches(cfg, ebc, 2, plan)):
            params, state, m = step(params, state, _tb(batch), t)
        runs.append((params["emb"]["mega"], state["accum"], m["loss"]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_only_sparse_apply_sparse_is_ported():
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    with pytest.raises(NotImplementedError, match="later slice"):
        steps.build_dlrm_train_step(cfg, ebc, adagrad(0.01),
                                    sparse_apply="dense")


def test_optimizer_specs_and_init_state_match_reference_layout():
    cfg, jcfg, ebc, jebc, jparams = _setup(False)
    spec, jspec = ebc.optimizer_specs(), jebc.optimizer_specs()
    assert spec["accum"].shape == jspec["accum"].shape
    assert spec["accum"].init == jspec["accum"].init == "zeros"
    params = params_from_jax(_to_np(jparams), device="cpu")
    state = steps.dlrm_init_state(ebc, adagrad(0.01), params)
    jstate = jsteps.dlrm_init_state(jebc, jadagrad(0.01), jparams)
    assert state["accum"].shape == jstate["accum"].shape
    assert not state["accum"].any()
    assert [tuple(t.shape) for t in jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), state["dense"]))] == \
        [tuple(x.shape) for x in jax.tree.leaves(jstate["dense"])]

# ---------------------------------------------------------------------------
# conversion: the card unless the CPU is asked for
# ---------------------------------------------------------------------------


def test_convert_defaults_to_the_card():
    _, _, _, _, jparams = _setup(False)
    tree = _to_np(jparams)
    state = {"dense": {"bottom": [], "top": []}, "accum": np.zeros(4)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax(tree)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            state_from_jax(state)
    p = params_from_jax(tree, device="cpu")
    assert p["emb"]["mega"].device.type == "cpu"
    assert state_from_jax(state, device="cpu")["accum"].dtype == torch.float32

# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_sparse_plan_hook_matches_reference_hook():
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    raw = make_dlrm_batch(cfg, 8, step=2)
    want = jpipeline.sparse_plan_hook(ebc.plan.table_offsets)(dict(raw))
    got = pipeline.sparse_plan_hook(ebc.plan.table_offsets)(dict(raw))
    assert set(got) == set(want)
    for k in got:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    dwant = jpipeline.dedup_indices_hook(ebc.plan.table_offsets)(dict(raw))
    dgot = pipeline.dedup_indices_hook(ebc.plan.table_offsets)(dict(raw))
    assert set(dgot) == set(dwant)
    for k in dwant:
        np.testing.assert_array_equal(dgot[k], np.asarray(dwant[k]))


def test_sparse_plan_hook_capacity_overflow_fails_the_consumer():
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    loader = pipeline.ShardedLoader(
        lambda step, seed: make_dlrm_batch(cfg, 8, step, seed), 8)
    pipe = loader.pipeline(transform=pipeline.sparse_plan_hook(
        ebc.plan.table_offsets, capacity=2))
    with pytest.raises(RuntimeError, match="step 0"):
        next(pipe)
    pipe.close()


def test_pipeline_prefetch_order_and_host_slices():
    pipe = pipeline.DataPipeline(lambda s: {"x": np.asarray([s])}, prefetch=2)
    assert [next(pipe)[0] for _ in range(5)] == [0, 1, 2, 3, 4]
    pipe.close()
    loaders = [pipeline.ShardedLoader(
        lambda step, seed: {"x": np.arange(16) + 100 * step}, 16,
        host_index=i, num_hosts=4) for i in range(4)]
    got = np.concatenate([ld.host_slice(2)["x"] for ld in loaders])
    np.testing.assert_array_equal(got, np.arange(16) + 200)
    pipe = loaders[1].pipeline(start_step=3)
    step, batch = next(pipe)
    assert step == 3 and list(batch["x"]) == [304, 305, 306, 307]
    pipe.close()
    with pytest.raises(ValueError):
        pipeline.ShardedLoader(lambda s, seed: {}, 10, num_hosts=4)


def test_pipeline_transform_error_surfaces_in_consumer():
    def bad_hook(batch):
        if int(batch["x"][0]) >= 2:
            raise ValueError("hook boom")
        return batch

    pipe = pipeline.DataPipeline(lambda s: {"x": np.asarray([s])},
                                 prefetch=1, transform=bad_hook)
    assert next(pipe)[1]["x"][0] == 0
    assert next(pipe)[1]["x"][0] == 1
    with pytest.raises(RuntimeError, match="step 2"):
        next(pipe)
    with pytest.raises(RuntimeError, match="step 2"):
        next(pipe)                                # sticky
    pipe.close()
    with pytest.raises(StopIteration):
        next(pipe)                                # explicit close wins


def test_pipeline_reader_kill_surfaces_within_one_step():
    def gen(step):
        if step >= 1:
            raise SystemExit("reader killed")
        return {"x": np.asarray([step])}

    pipe = pipeline.DataPipeline(gen, prefetch=1)
    assert next(pipe)[1]["x"][0] == 0
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="step 1"):
        next(pipe)
    assert time.monotonic() - t0 < 2.0
    pipe.close()


def test_pipeline_vanished_worker_detected_not_deadlocked():
    class _Dying(pipeline.DataPipeline):
        def _worker(self):
            return                                # vanishes silently

    pipe = _Dying(lambda s: {"x": np.asarray([s])}, prefetch=1)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="died"):
        next(pipe)
    assert time.monotonic() - t0 < 2.0
    with pytest.raises(RuntimeError, match="died"):
        next(pipe)
    pipe.close()


def test_pipeline_clean_shutdown_with_nonempty_queue():
    pipe = pipeline.DataPipeline(lambda s: {"x": np.zeros(4)}, prefetch=4)
    time.sleep(0.2)                               # let the queue fill
    t0 = time.monotonic()
    pipe.close()
    assert time.monotonic() - t0 < 2.0
    assert not pipe._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pipe)

# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


def test_launcher_trains_on_cpu_and_needs_cuda_otherwise(capsys):
    argv = ["--arch", "dlrm-m1", "--smoke", "--steps", "3", "--batch", "16",
            "--log-every", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_cli.main(argv)
    run = train_cli.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[:2] for ln in lines[:3]] == \
        [["step", "0"], ["step", "1"], ["step", "2"]]
    assert lines[-1].startswith("done at step 3; loss ")
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()
    assert run.params["emb"]["mega"].device.type == "cpu"
    assert run.state["accum"].abs().sum() > 0      # sparse rows moved


def test_launcher_module_runs_as_a_program():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "dlrm-m1", "--smoke", "--steps", "3", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "done at step 3; loss" in out.stdout
