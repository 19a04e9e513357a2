"""`build_lm_train_step(rules=FSDP_RULES, mesh=)` on a (data 2, model 2)
mesh of gloo CPU ranks, against the port's one-device step and, for
stablelm from the reference's parameters, the reference's jitted
one-device step: the four smoke archs, and stablelm with accum_steps 2.
The cases, helpers and tolerances are test_torch_lm_mesh.py's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.nn import sharding as jsharding
from repro.nn.params import init_params as jinit
from repro.optim import optimizers as jopt
from repro.train import steps as jsteps
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.lm import lm_param_specs
from repro_torch.nn.params import tree_leaves, tree_map
from repro_torch.train.sharded import lm_rank
from test_torch_lm_mesh import (ARCHS, LEAF_RTOL, LOSS_RTOL, MESH, _assemble,
                                _batches, _cfg, _np_tree, _rel_l2,
                                check_block_bytes, check_collectives,
                                check_gradients, check_losses,
                                check_parameters, one_device_runs, run_ids,
                                run_calls_on_ranks)

RUNS = [(a, "FSDP_RULES", {}, {}) for a in ARCHS]
RUNS += [("stablelm-1.6b", "FSDP_RULES", {"accum": 2}, {})]


@pytest.fixture(scope="module")
def jax_params():
    """The reference's smoke stablelm parameters (seed 2), as numpy."""
    return jax.tree.map(np.asarray, jinit(jlm.lm_param_specs(jget_smoke(
        "stablelm-1.6b")), jax.random.PRNGKey(2)))


@pytest.fixture(scope="module")
def world(jax_params):
    """out["runs"][i] RUNS[i]'s reports, out["ref"] the run from the
    reference's parameters, each a list in rank order."""
    cfg = _cfg("stablelm-1.6b")
    per = run_calls_on_ranks(RUNS, [(lm_rank, {
        "cfg": cfg, "rules": "FSDP_RULES", "mesh": MESH,
        "params": jax_params, "batches": _batches(cfg),
        "report_params": True})])
    return {"runs": per[:len(RUNS)], "ref": per[-1]}


@pytest.fixture(scope="module")
def oracles():
    return one_device_runs(RUNS)


@pytest.mark.parametrize("i", range(len(RUNS)), ids=run_ids(RUNS))
def test_sharded_losses_match_one_device(world, oracles, i):
    check_losses(world["runs"][i], oracles[i])


@pytest.mark.parametrize("i", range(len(RUNS)), ids=run_ids(RUNS))
def test_sharded_gradients_match_one_device(world, oracles, i):
    check_gradients(world["runs"][i], oracles[i], RUNS[i])


@pytest.mark.parametrize("i", range(len(RUNS)), ids=run_ids(RUNS))
def test_sharded_parameters_match_one_device(world, oracles, i):
    check_parameters(world["runs"][i], oracles[i], RUNS[i])


@pytest.mark.parametrize("i", range(len(RUNS)), ids=run_ids(RUNS))
def test_collective_counts_are_the_reckoning(world, i):
    check_collectives(world["runs"][i], RUNS[i])


def test_ranks_store_only_their_blocks(world):
    for reps, run in zip(world["runs"], RUNS):
        check_block_bytes(reps, run)


def test_ranks_load_no_jax(world):
    assert not any(r["foreign_modules"] for run in world["runs"] + [
        world["ref"]] for r in run)


def test_fsdp_matches_the_reference_step(world, jax_params):
    """stablelm under FSDP_RULES from the reference's parameters, against
    the reference's jitted one-device `build_lm_train_step(cfg, adamw,
    FSDP_RULES)` on the same batches."""
    jcfg = dataclasses.replace(jget_smoke("stablelm-1.6b"),
                               compute_dtype="float32", moe_groups=4)
    jstep = jax.jit(jsteps.build_lm_train_step(
        jcfg, jopt.adamw(3e-4), jsharding.FSDP_RULES))
    jp = jax.tree.map(jnp.asarray, jax_params)
    jstate = jopt.adamw(3e-4).init(jp)
    losses = []
    cfg = _cfg("stablelm-1.6b")
    for t, b in enumerate(_batches(cfg)):
        jp, jstate, m = jstep(jp, jstate, {k: jnp.asarray(v)
                                           for k, v in b.items()}, t)
        losses.append(float(m["loss"]))
    reps = world["ref"]
    np.testing.assert_allclose(reps[0]["losses"], losses, rtol=LOSS_RTOL)
    got = _assemble(reps, "params", cfg, "FSDP_RULES")
    want = tree_leaves(tree_map(lambda s, w: w, lm_param_specs(cfg),
                                _np_tree(lm_params_from_jax(
                                    jax.tree.map(np.asarray, jp),
                                    device="cpu"))))
    for g, w in zip(got, want):
        assert _rel_l2(g, w) <= LEAF_RTOL
