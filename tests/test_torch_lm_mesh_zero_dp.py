"""`build_lm_train_step(rules=ZERO_DP_RULES, mesh=)` on a (data 2, model
2) mesh of gloo CPU ranks, against the port's one-device step: the four
smoke archs, and granite-moe-1b-a400m with remat "full". The cases,
helpers and tolerances are test_torch_lm_mesh.py's."""
import pytest

from test_torch_lm_mesh import (ARCHS, check_block_bytes, check_collectives,
                                check_dry_mesh,
                                check_gradients, check_losses,
                                check_parameters, one_device_runs, run_ids,
                                run_calls_on_ranks)

RUNS = [(a, "ZERO_DP_RULES", {}, {}) for a in ARCHS]
RUNS += [("granite-moe-1b-a400m", "ZERO_DP_RULES", {}, {"remat": "full"})]


@pytest.fixture(scope="module")
def world():
    """out["runs"][i] RUNS[i]'s reports, a list in rank order."""
    return {"runs": run_calls_on_ranks(RUNS)}


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


@pytest.mark.parametrize("i", range(len(RUNS)), ids=run_ids(RUNS))
def test_dry_mesh_books_the_ranks_collectives(world, i):
    check_dry_mesh(world["runs"][i], RUNS[i])


def test_ranks_store_only_their_blocks(world):
    for reps, run in zip(world["runs"], RUNS):
        check_block_bytes(reps, run)


def test_ranks_load_no_jax(world):
    assert not any(r["foreign_modules"] for run in world["runs"]
                   for r in run)
