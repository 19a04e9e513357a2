"""The LM's multi-device half on gloo CPU ranks: `nn.sharding`'s
`gather_weight`, `replicate_weight` and `shard_activation`, and
`build_lm_train_step(rules=, mesh=)` on a (data 2, model 2) mesh against
the port's one-device step, under TRAIN_RULES here, FSDP_RULES in
test_torch_lm_mesh_fsdp.py (with the reference's one-device step) and
ZERO_DP_RULES in test_torch_lm_mesh_zero_dp.py, which take their helpers
from this file.

Each file spawns one world of 4 ranks (`launch.mesh.run_ranks` with
`train.sharded.run_calls`) that holds its rank-side cases one after
another: here the sharding moves (`sharding_rank`), then `lm_rank` on
the smoke configs of stablelm-1.6b, granite-moe-1b-a400m, mamba2-780m
and jamba-v0.1-52b under the file's table (2 steps of a global batch of
4 x 32, fp32 compute, moe_groups 4 so the groups split over the batch's
ranks), and each file's extra cases: here bf16 gradients, under FSDP
accum_steps 2 and the reference's parameters, under ZERO_DP remat
"full". Each rank reports its gradient blocks as the optimizer gets them
and its final parameter blocks; the test puts them together by
`NamedSharding` (every replica of a block must hold the same bits) and
holds them to the one-device run.

Tolerances, each with its reason:
  * the sharded step against the port's one-device step, fp32: each
    loss within 1e-5 relative; each gradient and parameter, put together,
    within 1e-4 relative L2 a leaf (the ranks add partial sums in other
    orders: tensor-parallel partials, gloo's sums over ranks, the
    vocab-parallel log-sum-exp; 16 layers of jamba carry that to 5e-5);
  * bf16 gradients (grad_dtype): the gradients and the parameters after
    each step within 1e-2 relative L2 (the one-device step rounds each
    whole gradient once, the sharded one each rank's partial and then the
    sum over ranks: a bf16 ulp, 2^-8, moves Adam's u = m / sqrt(v) by as
    much, and the smoke parameters' small leaves by 4e-3);
  * against the reference's jitted one-device FSDP step: the losses and
    parameters within the same 1e-5 / 1e-4 (XLA's fp32 sums differ too);
  * the moves, the collective counts, the refusals: exact.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.launch import mesh as tmesh
from repro_torch.models.lm import init_lm_params, lm_param_specs
from repro_torch.nn import moe as MOE
from repro_torch.nn import sharding
from repro_torch.nn.params import tree_leaves, tree_map
from repro_torch.nn.sharding import NamedSharding, resolve_sized
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.sharded import (lm_rank, run_calls, save_flat_params,
                                      sharding_rank)
from repro_torch.train.steps import (build_lm_train_step, lm_batch_block,
                                     lm_step_collectives)

ARCHS = ["stablelm-1.6b", "granite-moe-1b-a400m", "mamba2-780m",
         "jamba-v0.1-52b"]
TABLES = ["TRAIN_RULES", "FSDP_RULES", "ZERO_DP_RULES"]
MESH = ((2, 2), ("data", "model"))
NAMES = MESH[1]
BATCH, SEQ, STEPS = 4, 32, 2
LOSS_RTOL, LEAF_RTOL, BF16_GRAD_RTOL = 1e-5, 1e-4, 1e-2
SPAWN_TIMEOUT_S = 300
SEED = 5

#: the sharding moves: (kind, rules, logical axes, whole shape or the
#: per-rank block's shape, src spec, partial axes)
MOVES = {
    "fsdp_wq": ("gather", "FSDP_RULES", ("embed", "heads", "head_dim"),
                (8, 4, 3), None, ()),
    "zero_dp_expert": ("gather", "ZERO_DP_RULES", ("expert", "embed", "ff"),
                       (4, 8, 6), None, ()),
    "train_in_proj": ("replicate", "TRAIN_RULES", ("embed", "ssm_inner"),
                      (6, 10), None, ()),
    "fsdp_in_proj": ("replicate", "FSDP_RULES", ("embed", "ssm_inner"),
                     (6, 10), None, ()),
    "partial_to_replicated": ("activation", "TRAIN_RULES",
                              ("act_batch", "act_seq", "act_embed"),
                              (2, 3, 4), ("data",), ("model",)),
    "replicated_to_sharded": ("activation", "TRAIN_RULES",
                              ("act_batch", "act_seq", "act_vocab"),
                              (2, 3, 8), ("data",), ()),
    "partial_to_sharded": ("activation", "TRAIN_RULES",
                           ("act_batch", "act_seq", "act_vocab"),
                           (2, 3, 8), ("data",), ("model",)),
    "sharded_to_replicated": ("activation", "TRAIN_RULES",
                              ("act_batch", "act_seq", "act_embed"),
                              (2, 3, 4), ("data", None, "model"), ()),
}

#: this file's sharded runs: (arch, table, extra job keys, config changes)
RUNS = [(a, "TRAIN_RULES", {}, {}) for a in ARCHS]
RUNS += [("stablelm-1.6b", "TRAIN_RULES", {"grad_dtype": "bfloat16"}, {})]


def _cfg(arch, **over):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", moe_groups=4,
                               **over)


def _batches(cfg):
    return [make_lm_batch(cfg, BATCH, SEQ, t, 0) for t in range(STEPS)]


def _np_tree(tree):
    return tree_map(lambda t: t.detach().float().numpy(), tree)


def _mesh_ns(coords=None):
    return SimpleNamespace(axis_names=NAMES, shape=dict(zip(*MESH[::-1])),
                           coords=coords or {a: 0 for a in NAMES})


def _move_cases():
    rng = np.random.RandomState(SEED)
    cases = []
    for kind, rules, axes, shape, src, partial in MOVES.values():
        if kind == "activation":
            x = [rng.standard_normal(shape).astype(np.float32)
                 for _ in range(4)]
        else:
            x = rng.standard_normal(shape).astype(np.float32)
        cases.append({"kind": kind, "rules": rules, "axes": axes, "x": x,
                      "src": src, "partial": partial})
    return cases


def _params_of(arch):
    return _np_tree(init_lm_params(_cfg(arch), 0, "cpu"))


def run_calls_on_ranks(runs, extra=()):
    """One 4-rank world: the `lm_rank` calls of `runs` (each rank reports
    its gradients and final parameters), then the calls in `extra`.
    Returns each call's reports, a list in rank order."""
    calls = []
    for arch, table, more, over in runs:
        cfg = _cfg(arch, **over)
        calls.append((lm_rank, {"cfg": cfg, "rules": table, "mesh": MESH,
                                "params": _params_of(arch),
                                "batches": _batches(cfg),
                                "report_grads": True,
                                "report_params": True, **more}))
    calls += list(extra)
    res = tmesh.run_ranks(run_calls, 4, (calls,), backend="gloo",
                          device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return [[r[i] for r in res] for i in range(len(calls))]


def one_device_runs(runs):
    """The port's one-device run of each of `runs`."""
    out = []
    for arch, table, extra, over in runs:
        cfg = _cfg(arch, **over)
        out.append(_one_device(cfg, _params_of(arch), _batches(cfg),
                               extra.get("accum", 1),
                               extra.get("grad_dtype", "float32")))
    return out


@pytest.fixture(scope="module")
def world(oracles, tmp_path_factory):
    """This file's rank-side cases in one 4-rank world: out["moves"] the
    probe's reports, out["runs"][i] RUNS[i]'s, each a list in rank
    order. RUNS[0]'s ranks also hold their final blocks to the one-device
    run's parameters, written by `save_flat_params`."""
    flat = str(tmp_path_factory.mktemp("flat") / "params.f32")
    arch, table, extra, over = RUNS[0]
    save_flat_params(tree_map(torch.from_numpy, oracles[0]["params"]),
                     _cfg(arch, **over), flat)
    runs = [(arch, table, {**extra, "want_params": flat}, over)] + RUNS[1:]
    per = run_calls_on_ranks(runs, [(sharding_rank, {
        "mesh": MESH, "seed": SEED, "cases": _move_cases()})])
    return {"runs": per[:len(RUNS)], "moves": per[-1]}


def _one_device(cfg, params, batches, accum=1, grad_dtype="float32"):
    """The port's one-device step from numpy parameters: each step's
    loss and gradients (as the optimizer gets them), the final
    parameters."""
    p = tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    opt, seen = adamw(3e-4), []

    def apply(pp, g, s, t, **kw):
        seen.append(_np_tree(g))
        return opt.apply(pp, g, s, t, **kw)
    spy = Optimizer(opt.init, apply, "adamw")
    state = spy.init(p)
    step = build_lm_train_step(cfg, spy, accum_steps=accum,
                               grad_dtype=grad_dtype)
    losses = []
    for t, b in enumerate(batches):
        p, state, m = step(p, state, {k: torch.from_numpy(v)
                                      for k, v in b.items()}, t)
        losses.append(float(m["loss"]))
    return {"losses": losses, "grads": seen, "params": _np_tree(p)}


def _assemble(reps, key, cfg, table, index=None):
    """The whole leaves from every rank's blocks (reps[r][key], or its
    entry `index`), each block placed by its NamedSharding; every replica
    of a block must hold the same bits."""
    rules = getattr(sharding, table)
    specs = tree_leaves(lm_param_specs(cfg))
    out = []
    for i, s in enumerate(specs):
        whole = np.full(s.shape, np.nan, np.float32)
        for r in reps:
            tree = r[key] if index is None else r[key][index]
            block = tree_leaves(tree)[i]
            m = _mesh_ns(r["coords"])
            sl = NamedSharding(m, resolve_sized(s.logical_axes, rules, m,
                                                s.shape)).local_slice(s.shape)
            seen = whole[sl]
            if not np.isnan(seen).all():
                np.testing.assert_array_equal(seen, block)
            whole[sl] = block
        assert not np.isnan(whole).any()
        out.append(whole)
    return out


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def oracles():
    return one_device_runs(RUNS)


def run_ids(runs):
    return ["-".join([arch, table, *(f"{k}={v}" for k, v in
                                     {**extra, **over}.items())])
            for arch, table, extra, over in runs]


def check_losses(reps, want):
    """Every rank holds the same global losses, those of the one-device
    run within LOSS_RTOL."""
    for r in reps:
        assert r["losses"] == reps[0]["losses"]
    np.testing.assert_allclose(reps[0]["losses"], want["losses"],
                               rtol=LOSS_RTOL)


def _tol(run):
    return BF16_GRAD_RTOL if run[2].get("grad_dtype") == "bfloat16" \
        else LEAF_RTOL


def check_gradients(reps, want, run):
    """Each step's gradients, put together from the ranks' blocks, within
    the run's tolerance a leaf of the one-device run's."""
    arch, table, extra, over = run
    cfg = _cfg(arch, **over)
    for t in range(STEPS):
        got = _assemble(reps, "grads", cfg, table, t)
        for g, w in zip(got, tree_leaves(want["grads"][t])):
            assert _rel_l2(g, w) <= _tol(run)


def check_parameters(reps, want, run):
    """The final parameters, put together, as check_gradients."""
    arch, table, extra, over = run
    got = _assemble(reps, "params", _cfg(arch, **over), table)
    for g, w in zip(got, tree_leaves(want["params"])):
        assert _rel_l2(g, w) <= _tol(run)


def check_collectives(reps, run):
    """Every rank's `Mesh.stats` a step: the calls of each collective on
    each axis are `lm_step_collectives`' (remat "full" recomputes each
    unit's forward collectives but its trailing partial-sum all_reduce)."""
    arch, table, extra, over = run
    want = lm_step_collectives(_cfg(arch, **over), getattr(sharding, table),
                               _mesh_ns(), extra.get("accum", 1))
    for r in reps:
        for st in r["collectives"]:
            got = {k[:-len("_calls")]: v for k, v in st.items()
                   if "@" in k and k.endswith("_calls") and v}
            assert got == want
            assert st["all_to_all_calls"] == 0


def check_dry_mesh(reps, run):
    """Each rank's `Mesh.stats` a step, calls and bytes of every collective
    on every axis and the skipped calls, equal a `launch.mesh.DryMesh`'s
    at its rank for the same step on the meta device (`launch.dryrun.
    lm_train_job`)."""
    from repro_torch.launch import dryrun
    arch, table, extra, over = run
    cfg = _cfg(arch, **over)
    for r in reps:
        m = tmesh.DryMesh(*MESH, rank=r["rank"])
        dryrun.measure(dryrun.lm_train_job(
            cfg, getattr(sharding, table), m, BATCH, SEQ,
            extra.get("accum", 1), extra.get("grad_dtype", "float32")),
            m, memory=False)
        want = {k: v for k, v in m.stats.items() if not k.endswith("_ms")}
        for st in r["collectives"]:
            assert {k: st[k] for k in want} == want


def check_block_bytes(reps, run):
    """Each rank's parameter bytes are its blocks'; under ZERO_DP a
    quarter of stablelm's tree, where every leaf splits both ways."""
    arch, table, _, over = run
    cfg = _cfg(arch, **over)
    rules = getattr(sharding, table)
    m = _mesh_ns()
    want = sum(4 * int(np.prod(NamedSharding(m, resolve_sized(
        s.logical_axes, rules, m, s.shape)).local_shape(s.shape)))
        for s in tree_leaves(lm_param_specs(cfg)))
    assert all(r["param_bytes"] == want for r in reps)
    if table == "ZERO_DP_RULES" and arch == "stablelm-1.6b":
        whole = sum(4 * int(np.prod(s.shape))
                    for s in tree_leaves(lm_param_specs(cfg)))
        assert want * 4 == whole


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


def test_ranks_hold_their_final_blocks_to_a_flat_file(world, oracles):
    """`lm_rank(want_params=)` on `save_flat_params`' file: a leaf's
    squared errors and norms, summed over its blocks' first holders, are
    those of the parameters put together against the one-device run's."""
    arch, table, _, over = RUNS[0]
    reps = world["runs"][0]
    got = _assemble(reps, "params", _cfg(arch, **over), table)
    for i, (g, w) in enumerate(zip(got, tree_leaves(oracles[0]["params"]))):
        mine = [r["param_errors"][i] for r in reps
                if r["param_errors"][i]["owner"]]
        np.testing.assert_allclose(sum(e["err_sq"] for e in mine),
                                   np.square(g - w).sum(), rtol=1e-3,
                                   atol=1e-20)
        np.testing.assert_allclose(sum(e["ref_sq"] for e in mine),
                                   np.square(w).sum(), rtol=1e-5)


def test_ranks_store_only_their_blocks(world):
    for reps, run in zip(world["runs"], RUNS):
        check_block_bytes(reps, run)


def test_ranks_load_no_jax(world):
    assert not any(r["foreign_modules"] for run in world["runs"]
                   for r in run)
    assert not any(r["foreign_modules"] for r in world["moves"])


def _whole_block(case, coords, table):
    m = _mesh_ns(coords)
    rules = getattr(sharding, table)
    spec = resolve_sized(case["axes"], rules, m, case["x"].shape)
    return NamedSharding(m, spec), spec


def _line(reports, coords, axes):
    """The reports of the ranks that differ from `coords` only along
    `axes`."""
    return [r for r in reports if all(r["coords"][a] == coords[a]
                                      for a in NAMES if a not in axes)]


@pytest.mark.parametrize("name", list(MOVES))
def test_sharding_moves_forward_and_backward(world, name):
    """Each move's output blocks, and its gradient: a gather over the
    batch's axes sums the ranks' cotangents there (the slice of the
    summed gradient), over another axis keeps the rank's own; a partial
    sum's all_reduce passes the cotangent through; a take gathers the
    cotangent blocks."""
    i = list(MOVES).index(name)
    kind, table, axes, shape, src, partial = MOVES[name]
    case = _move_cases()[i]
    reps = [r["cases"][i] for r in world["moves"]]
    for r in reps:
        c = r["coords"]
        if kind in ("gather", "replicate"):
            sh, spec = _whole_block(case, c, table)
            rules = getattr(sharding, table)
            g = rules.get("_gather_axes", sharding.GATHERED_AXES)
            keep = None if kind == "replicate" else tuple(
                None if a in g else a for a in axes)
            dst = () if keep is None else resolve_sized(
                keep, rules, _mesh_ns(c), case["x"].shape)
            np.testing.assert_array_equal(
                r["y"], NamedSharding(_mesh_ns(c), dst).shard(case["x"]))
            dropped = [a for a in sharding.spec_axes(spec)
                       if a not in sharding.spec_axes(dst)]
            summed = [a for a in dropped if a in sharding.batch_axes(
                rules, _mesh_ns(c))]
            # the cotangent of the gathered weight, summed over the
            # batch's axes it was gathered over, then this rank's block
            total = np.zeros(case["x"].shape, np.float32)
            for q in _line(reps, c, summed):
                full = np.zeros(case["x"].shape, np.float32)
                full[NamedSharding(_mesh_ns(q["coords"]), dst).local_slice(
                    case["x"].shape)] = q["cot"]
                total += full
            np.testing.assert_allclose(r["grad"], sh.shard(total),
                                       rtol=1e-6, atol=1e-6)
            continue
        x = case["x"]
        model = _line(reps, c, ("model",))
        if partial:
            summed = sum(x[tmesh_rank(q["coords"])] for q in model)
        else:
            summed = x[tmesh_rank(c)]
        if name == "sharded_to_replicated":
            summed = np.concatenate([x[tmesh_rank(q["coords"])]
                                     for q in sorted(model, key=lambda q:
                                                     q["coords"]["model"])],
                                    axis=-1)
        if name in ("replicated_to_sharded", "partial_to_sharded"):
            w = summed.shape[-1] // 2
            k = c["model"]
            want_y = summed[..., k * w:(k + 1) * w]
            want_g = np.concatenate([q["cot"] for q in sorted(
                model, key=lambda q: q["coords"]["model"])], axis=-1)
        elif name == "sharded_to_replicated":
            w = x[0].shape[-1]
            want_y = summed
            want_g = r["cot"][..., c["model"] * w:(c["model"] + 1) * w]
        else:
            want_y, want_g = summed, r["cot"]
        np.testing.assert_allclose(r["y"], want_y, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r["grad"], want_g, rtol=1e-6, atol=1e-6)


def tmesh_rank(coords) -> int:
    """A coordinate's world rank, row-major as `launch.mesh.Mesh` lays
    ranks out."""
    return coords["data"] * MESH[0][1] + coords["model"]


def test_sharding_moves_count_their_collectives(world):
    """One all_gather a dropped axis (forward), its reduce_scatter over a
    batch axis (backward); one all_reduce a partial axis; takes move
    nothing."""
    want = {"fsdp_wq": {"all_gather@data": 1, "reduce_scatter@data": 1},
            "zero_dp_expert": {"all_gather@data": 1, "all_gather@model": 1,
                               "reduce_scatter@data": 1,
                               "reduce_scatter@model": 1},
            "train_in_proj": {"all_gather@model": 1},
            "fsdp_in_proj": {"all_gather@data": 1, "all_gather@model": 1,
                             "reduce_scatter@data": 1},
            "partial_to_replicated": {"all_reduce@model": 1},
            "replicated_to_sharded": {"all_gather@model": 1},
            "partial_to_sharded": {"reduce_scatter@model": 1,
                                   "all_gather@model": 1},
            "sharded_to_replicated": {"all_gather@model": 1}}
    for i, name in enumerate(MOVES):
        for r in world["moves"]:
            st = r["cases"][i]["stats"]
            got = {k[:-len("_calls")]: v for k, v in st.items()
                   if "@" in k and k.endswith("_calls") and v}
            assert got == want[name], name


def test_without_a_mesh_the_moves_are_the_identity():
    x = torch.randn(4, 6)
    for table in TABLES:
        rules = getattr(sharding, table)
        assert sharding.shard_activation(x, ("act_batch", "act_embed"),
                                         rules) is x
        assert sharding.gather_weight(x, ("embed", "ff"), rules) is x
    assert sharding.shard_activation(x, ("act_batch", "act_embed"), {},
                                     _mesh_ns()) is x


def test_moe_groups_must_split_over_the_batch_ranks():
    """moe_groups 1 cannot give each of 2 data ranks its own groups: the
    sharded MoE refuses before any collective."""
    cfg = dataclasses.replace(get_smoke_config("granite-moe-1b-a400m"),
                              moe_groups=1)
    p = init_lm_params(cfg, 0, "cpu")["blocks"]["b0"]["ffn"]
    unit = {k: v[0] for k, v in p.items()}
    with pytest.raises(ValueError, match="MoE groups"):
        MOE.moe(unit, torch.randn(2, 8, cfg.d_model), cfg,
                rules=sharding.FSDP_RULES, mesh=_mesh_ns())


def test_the_step_refuses_what_a_mesh_cannot_split():
    """A batch the batch's ranks do not divide, and parameters that are
    not this rank's blocks, are refused before any collective."""
    cfg = _cfg("stablelm-1.6b")
    batch = {k: torch.from_numpy(v) for k, v in make_lm_batch(
        cfg, 3, SEQ, 0, 0).items()}
    with pytest.raises(ValueError, match="does not split"):
        lm_batch_block(batch, sharding.FSDP_RULES, _mesh_ns())
    step = build_lm_train_step(cfg, adamw(3e-4), sharding.FSDP_RULES,
                               mesh=_mesh_ns())
    p = init_lm_params(cfg, 0, "cpu")
    with pytest.raises(ValueError, match="not this rank's blocks"):
        step(p, adamw(3e-4).init(p), batch, 0)
