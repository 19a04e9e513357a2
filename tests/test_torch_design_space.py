"""The port's section-V design space (`repro_torch.core.design_space`)
against the reference's `repro.core.design_space`, on the CPU: every sweep
point of Figs. 10-13 and `reduced(cfg, k)` of each, field by field (the
same dataclass arithmetic, so exactly equal); then one training step of
seven `reduced(cfg, 16)` suite points through the reference's
`build_dlrm_train_step(sparse_apply="sparse")` and the port's, on the
same numpy batch, with parameters copied across (`convert.params_from_jax`),
held within STEP_TOL of tests/test_torch_train.py (fp32 matmuls and sums
in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import design_space as jds
from repro.core import dlrm as jdlrm
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.nn.params import init_params as jinit
from repro.optim import adagrad as jadagrad
from repro.train import steps as jsteps
from repro_torch.convert import params_from_jax
from repro_torch.core import design_space as ds
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.data.synthetic import make_dlrm_batch
from repro_torch.optim import adagrad
from repro_torch.train import steps

STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
SWEEPS = ("sweep_fig10", "sweep_fig12_hash", "sweep_fig13_mlp")
#: every named point: the three config sweeps, the suite's default point
#: and its concat-interaction twin
POINTS = ([(s, name) for s in SWEEPS for name, _ in getattr(ds, s)()]
          + [("test_suite_config", "default"), ("test_suite_config", "cat")])


def _point(mod, sweep, name):
    if sweep == "test_suite_config":
        kw = {"interaction": "cat"} if name == "cat" else {}
        return mod.test_suite_config(**kw)
    return dict(getattr(mod, sweep)())[name]


def _assert_fields_equal(port, want):
    assert type(port).__name__ == type(want).__name__
    names = [f.name for f in dataclasses.fields(port)]
    assert names == [f.name for f in dataclasses.fields(want)]
    for n in names:
        assert getattr(port, n) == getattr(want, n), n
    assert port.table_bytes() == want.table_bytes()


@pytest.mark.parametrize("sweep", SWEEPS)
def test_sweep_names_and_order_equal(sweep):
    assert ([n for n, _ in getattr(ds, sweep)()]
            == [n for n, _ in getattr(jds, sweep)()])


def test_fig11_batches_equal():
    assert ds.sweep_fig11_batch() == jds.sweep_fig11_batch()


@pytest.mark.parametrize("sweep,name", POINTS,
                         ids=[f"{s}-{n}" for s, n in POINTS])
def test_sweep_point_fields_equal(sweep, name):
    _assert_fields_equal(_point(ds, sweep, name), _point(jds, sweep, name))


@pytest.mark.parametrize("factor", [4, 8, 16])
@pytest.mark.parametrize("sweep,name", POINTS,
                         ids=[f"{s}-{n}" for s, n in POINTS])
def test_reduced_fields_equal(sweep, name, factor):
    _assert_fields_equal(ds.reduced(_point(ds, sweep, name), factor),
                         jds.reduced(_point(jds, sweep, name), factor))


# ---------------------------------------------------------------------------
# one train step of reduced suite points against the reference's
# ---------------------------------------------------------------------------

STEP_POINTS = [("sweep_fig10", "dense64_sparse4"),
               ("sweep_fig10", "dense4096_sparse128"),
               ("sweep_fig12_hash", "hash10000"),
               ("sweep_fig12_hash", "hash10000000"),
               ("sweep_fig13_mlp", "mlp64x2"),
               ("sweep_fig13_mlp", "mlp2048x4"),
               ("test_suite_config", "cat")]


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("sweep,name", STEP_POINTS,
                         ids=[f"{s}-{n}" for s, n in STEP_POINTS])
def test_suite_step_matches_reference(sweep, name):
    cfg = ds.reduced(_point(ds, sweep, name), 16)
    jcfg = jds.reduced(_point(jds, sweep, name), 16)
    jebc = JEBC.build(jcfg, n_shards=1, strategy="replicated")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    assert ebc.plan.table_offsets == jebc.plan.table_offsets
    jparams = jinit(jdlrm.dlrm_param_specs(jcfg, jebc),
                    jax.random.PRNGKey(5))
    params = params_from_jax(_to_np(jparams), device="cpu")
    raw = make_dlrm_batch(cfg, 16, step=1)
    batch = {**raw, "idx": ebc.offset_indices(raw["idx"])}

    jopt = jadagrad(0.01)
    jstate = jsteps.dlrm_init_state(jebc, jopt, jparams)
    jstep = jsteps.build_dlrm_train_step(jcfg, jebc, jopt,
                                         sparse_apply="sparse")
    jparams, jstate, jm = jax.jit(jstep)(
        jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(0, jnp.int32))

    opt = adagrad(0.01)
    state = steps.dlrm_init_state(ebc, opt, params)
    step = steps.build_dlrm_train_step(cfg, ebc, opt, sparse_apply="sparse")
    params, state, m = step(
        params, state,
        {k: torch.from_numpy(np.array(v, copy=True))
         for k, v in batch.items()}, 0)

    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               **STEP_TOL)
    assert float(m["lookups"]) == float(jm["lookups"])
    np.testing.assert_allclose(params["emb"]["mega"].numpy(),
                               np.asarray(jparams["emb"]["mega"]), **STEP_TOL)
    np.testing.assert_allclose(state["accum"].numpy(),
                               np.asarray(jstate["accum"]), **STEP_TOL)
    assert float(state["accum"].abs().sum()) > 0      # the update ran
    for part in ("bottom", "top"):
        for a, b in zip(jax.tree.leaves(jparams[part]),
                        jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                     params[part]))):
            np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL)
    for a, b in zip(jax.tree.leaves(jstate["dense"]),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 state["dense"]))):
        np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL)
