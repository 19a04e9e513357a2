"""The port's sharded DLRM executors against the reference, on the CPU:
gloo ranks spawned by `repro_torch.launch.mesh.run_ranks` (a FileStore
rendezvous, a timeout on every spawn) run the rank drivers of
`repro_torch.train.sharded`; the reference and the port's single-device
oracles run in this process only. Two spawns hold every case: 8 ranks on
a (2, 4) mesh (the psum lookup and the psum dense update over the smoke
dlrm-m1 under `row_wise`, fp32 and bf16 reduce, and what a mesh refuses),
and 4 ranks holding a (1, 4) and a (2, 2) mesh (the psum lookup and the
table-wise step under `table_wise`, the next batch staged or not). Inputs
come from numpy seeds, parameters from the reference
(`repro_torch.convert.params_from_jax`), batches of 16.

The reference's own mesh tests fail on this tree (jax 0.9), so the
oracles are the port's single-device steps on the same layout, held to
the relations the reference's mesh tests state, and the reference's
single-device steps at the port's parity tolerance. Tolerances:
  * lookup_local against the reference's (Pallas kernel in interpret
    mode): 1e-5 abs, as tests/test_torch_kernels.py holds the bag kernel;
  * the psum lookup: table_wise bit-equal to the port's `lookup` (every
    bag lives on one owner, the others add +0.0); row_wise within 1e-5 of
    it and of the reference's gather lookup (a bag split between two
    shards sums two partials), tests/test_multidevice.py:47-48;
  * the psum update with an fp32 reduce, 2 steps: the loss rtol 1e-5, the
    table and accumulator rtol 1e-4 / atol 1e-5 against the port's
    single-device dense step (tests/test_multidevice.py:82-85), and the
    same or STEP_TOL, the looser, against the reference's gather step;
  * the psum update with a bf16 reduce, 1 step: the loss as above (it is
    computed before the update); the table against the fp32 reduce's
    within BF16_ATOL. Rounding a row's gradient sum to bf16 moves each
    element by up to 2^-9 of the largest of its partial sums (twice: each
    partial, then their sum), and the first AdaGrad step moves an element
    by lr * g_i / rms(g) <= lr * sqrt(d), so an element moves by at most
    about 2 * 2^-9 * lr * sqrt(d) * (|a| + |b|) / |a + b|: the bound is
    four times the no-cancellation value, 4 * 2^-8 * lr * sqrt(d) = 3.1e-3
    at lr 0.05, d 16. The reference tolerance (1e-4 relative) cannot hold
    an fp32 oracle to a bf16 sum; the bf16 run must also differ from the
    fp32 one, so the bf16 path ran;
  * the table-wise step on (1, 4): bit-equal to the port's single-device
    `build_dlrm_train_step(sparse_apply="sparse")` on the same layout (the
    reference's (1, 8) relation, tests/test_tablewise.py:371-373); on
    (2, 2): the data-parallel dense tower sums two slices' gradients, so
    the dense parameters drift by ulps: step 0's loss bit-equal, the later
    losses and every array within 1e-6 (tests/test_tablewise.py:375-377;
    measured up to 1.5e-7 on the losses); the two `data` replicas of
    every shard, and their dense parameters, bit-equal to each other;
  * every case against the reference's single-device step: STEP_TOL,
    rtol/atol 1e-5 (tests/test_torch_tablewise.py).
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core import dlrm as jdlrm
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.nn.params import init_params as jinit
from repro.optim import adagrad as jadagrad
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.data.synthetic import make_dlrm_batch
from repro_torch.launch import mesh as tmesh
from repro_torch.optim import adagrad
from repro_torch.train import build_dlrm_train_step, dlrm_init_state
from repro_torch.train.sharded import lookup_rank, run_calls, train_rank

STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
LOOKUP_TOL = {"rtol": 1e-5, "atol": 1e-5}
PSUM_LOSS_TOL = {"rtol": 1e-5}
PSUM_TABLE_TOL = {"rtol": 1e-4, "atol": 1e-5}
HYBRID_TOL = {"rtol": 1e-6, "atol": 1e-6}
SPARSE_LR, DENSE_LR, D = 0.05, 0.01, 16
BF16_ATOL = 4 * 2.0 ** -8 * SPARSE_LR * np.sqrt(D)
BATCH, N_STEPS, PSUM_STEPS = 16, 4, 2
POD_MESH = ((2, 1, 2), ("pod", "data", "model"))
SPAWN_TIMEOUT_S = 240


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jparams(jcfg, jebc, seed=0):
    return _np_tree(jinit(jdlrm.dlrm_param_specs(jcfg, jebc),
                          jax.random.PRNGKey(seed)))


def _batches(cfg, ebc, n=N_STEPS):
    out = []
    for t in range(n):
        raw = make_dlrm_batch(cfg, BATCH, step=t)
        out.append({**raw, "idx": ebc.offset_indices(raw["idx"])})
    return out


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _raw_idx(cfg, rng, b=8, lk=4):
    """(b, F, lk) per-table indices, each within its table, -1 pads."""
    return np.stack([rng.randint(-1, h, size=(b, lk))
                     for h in cfg.hash_sizes], axis=1).astype(np.int32)


def _dense(jparams):
    return {"bottom": jparams["bottom"], "top": jparams["top"]}


def _port_run(cfg, ebc, jparams, batches, sparse_apply):
    opt = adagrad(DENSE_LR)
    p = params_from_jax(jparams, device="cpu")
    s = dlrm_init_state(ebc, opt, p)
    step = build_dlrm_train_step(cfg, ebc, opt, SPARSE_LR,
                                 sparse_apply=sparse_apply)
    losses = []
    for t, b in enumerate(batches):
        p, s, m = step(p, s, _tb(b), t)
        losses.append(float(m["loss"]))
    return losses, p, s


def _ref_run(jcfg, jebc, jparams, batches, sparse_apply):
    opt = jadagrad(DENSE_LR)
    p = jax.tree.map(jnp.array, jparams)
    s = jsteps.dlrm_init_state(jebc, opt, p)
    step = jax.jit(jsteps.build_dlrm_train_step(
        jcfg, jebc, opt, SPARSE_LR, sparse_apply=sparse_apply))
    losses = []
    for t, b in enumerate(batches):
        p, s, m = step(p, s, _jb(b), jnp.asarray(t, jnp.int32))
        losses.append(float(m["loss"]))
    return losses, _np_tree(p), _np_tree(s)


def _whole(results, key):
    """The table (or accumulator) of `data` replica 0's shards, in row
    order."""
    shards = sorted((r for r in results if r["coords"]["data"] == 0),
                    key=lambda r: r["rows"][0])
    return np.concatenate([r[key] for r in shards])


def _dense_leaves(tree):
    return [x for part in ("bottom", "top") for layer in tree[part]
            for x in (layer["w"], layer["b"])]

# ---------------------------------------------------------------------------
# the spawns, shared by the tests below
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def row_wise():
    """8 ranks, (data 2, model 4), row_wise smoke dlrm-m1 with the psum
    lookup: the lookup, the dense update (fp32, 2 steps; bf16, 1 step),
    the refusals."""
    cfg = dataclasses.replace(get_smoke_config("dlrm-m1"),
                              placement="row_wise", lookup_impl="psum")
    jcfg = dataclasses.replace(jget_smoke("dlrm-m1"), placement="row_wise")
    ebc = EmbeddingBagCollection.build(cfg, n_shards=4)
    jebc = JEBC.build(jcfg, n_shards=4)
    assert ebc.plan.pspec == tuple(jebc.plan.pspec) == ("model", None)
    jparams = _jparams(jcfg, jebc)
    batches = _batches(cfg, ebc, PSUM_STEPS)
    rng = np.random.RandomState(0)
    idx = ebc.offset_indices(rng.randint(
        -1, 90, size=(8, cfg.n_sparse_features, 4)).astype(np.int32))
    base = {"cfg": cfg, "mesh": (2, 4), "strategy": "row_wise",
            "step": "dense_psum", "dense": _dense(jparams),
            "mega": jparams["emb"]["mega"], "dense_lr": DENSE_LR,
            "sparse_lr": SPARSE_LR, "report_arrays": True}
    bf16 = dataclasses.replace(cfg, grad_reduce_dtype="bfloat16")
    calls = [(lookup_rank, {"cfg": cfg, "mesh": (2, 4),
                            "strategy": "row_wise",
                            "mega": jparams["emb"]["mega"], "idx": idx}),
             (train_rank, {**base, "n_steps": PSUM_STEPS,
                           "batches": batches, "refusals": True}),
             (train_rank, {**base, "cfg": bf16, "n_steps": 1,
                           "batches": batches[:1]})]
    t0 = time.perf_counter()
    out = tmesh.run_ranks(run_calls, 8, (calls,), backend="gloo",
                          device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    return {"cfg": cfg, "jcfg": jcfg, "ebc": ebc, "jebc": jebc,
            "jparams": jparams, "batches": batches, "idx": idx,
            "lookup": [r[0] for r in out], "fp32": [r[1] for r in out],
            "bf16": [r[2] for r in out],
            "spawn_s": time.perf_counter() - t0}


@pytest.fixture(scope="module")
def table_wise():
    """4 ranks: the psum lookup on (1, 4), the table-wise step on (1, 4)
    and (2, 2), the next batch staged or not."""
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    runs, calls = {}, []
    for shape in ((1, 4), (2, 2)):
        ebc = EmbeddingBagCollection.build(cfg, n_shards=shape[1],
                                           strategy="table_wise")
        jebc = JEBC.build(jcfg, n_shards=shape[1], strategy="table_wise")
        assert ebc.plan.table_offsets == jebc.plan.table_offsets
        jparams = _jparams(jcfg, jebc)
        batches = _batches(cfg, ebc)
        runs[shape] = {"ebc": ebc, "jebc": jebc, "jparams": jparams,
                       "batches": batches}
        for staged in (False, True):
            calls.append((train_rank, {
                "cfg": cfg, "mesh": shape, "strategy": "table_wise",
                "step": "tablewise", "dense": _dense(jparams),
                "mega": jparams["emb"]["mega"], "n_steps": N_STEPS,
                "batches": batches, "staged": staged, "dense_lr": DENSE_LR,
                "sparse_lr": SPARSE_LR, "report_arrays": True}))
    ebc4 = runs[(1, 4)]["ebc"]
    idx = ebc4.offset_indices(_raw_idx(cfg, np.random.RandomState(1)))
    calls.append((lookup_rank, {"cfg": cfg, "mesh": (1, 4),
                                "strategy": "table_wise",
                                "mega": runs[(1, 4)]["jparams"]["emb"]["mega"],
                                "idx": idx}))
    # the psum dense update on a (pod 2, data 1, model 2) mesh
    pcfg = dataclasses.replace(cfg, placement="row_wise", lookup_impl="psum")
    pebc = EmbeddingBagCollection.build(pcfg, n_shards=2,
                                        strategy="row_wise")
    pjebc = JEBC.build(dataclasses.replace(jcfg, placement="row_wise"),
                       n_shards=2)
    pj = _jparams(jcfg, pjebc)
    pod = {"cfg": pcfg, "ebc": pebc, "jparams": pj,
           "batches": _batches(pcfg, pebc, PSUM_STEPS)}
    calls.append((train_rank, {
        "cfg": pcfg, "mesh": POD_MESH[0], "axes": POD_MESH[1],
        "strategy": "row_wise", "step": "dense_psum", "dense": _dense(pj),
        "mega": pj["emb"]["mega"], "n_steps": PSUM_STEPS,
        "batches": pod["batches"], "dense_lr": DENSE_LR,
        "sparse_lr": SPARSE_LR, "report_arrays": True}))
    out = tmesh.run_ranks(run_calls, 4, (calls,), backend="gloo",
                          device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    i = 0
    for shape in ((1, 4), (2, 2)):
        for staged in (False, True):
            runs[shape][staged] = [r[i] for r in out]
            i += 1
    pod["ranks"] = [r[i + 1] for r in out]
    return {"cfg": cfg, "jcfg": jcfg, "runs": runs, "idx": idx,
            "lookup": [r[i] for r in out], "pod": pod}

# ---------------------------------------------------------------------------
# lookup_local and the psum lookup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dedup", [False, True], ids=["bag", "dedup"])
def test_lookup_local_matches_reference(dedup):
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, n_shards=4, strategy="row_wise")
    jebc = JEBC.build(jcfg, n_shards=4, strategy="row_wise")
    rng = np.random.RandomState(2)
    rows = ebc.plan.total_rows // 4
    mega = rng.randn(ebc.plan.total_rows, cfg.embed_dim).astype(np.float32)
    idx = ebc.offset_indices(rng.randint(
        -1, 90, size=(8, cfg.n_sparse_features, 5)).astype(np.int32))
    parts = []
    for s in range(4):
        lo, hi = s * rows, (s + 1) * rows
        want = np.asarray(jebc.lookup_local(
            jnp.asarray(mega[lo:hi]), jnp.asarray(idx), lo, hi,
            interpret=True, dedup=dedup))
        got = ebc.lookup_local(torch.from_numpy(mega[lo:hi].copy()),
                               torch.from_numpy(idx), lo, hi, dedup=dedup)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        parts.append(got)
    # the partials add up to the whole table's lookup
    full = ebc.lookup({"mega": torch.from_numpy(mega)},
                      torch.from_numpy(idx))
    np.testing.assert_allclose(sum(parts).numpy(), full.numpy(),
                               **LOOKUP_TOL)


def test_psum_lookup_row_wise_matches_the_single_device_lookup(row_wise):
    rw = row_wise
    got = np.concatenate([r["pooled"] for r in rw["lookup"]
                          if r["coords"]["model"] == 0])
    # every model rank of one data slice holds the same sum
    for r in rw["lookup"]:
        d = r["coords"]["data"]
        np.testing.assert_array_equal(r["pooled"], got[d * 4:(d + 1) * 4])
    want = rw["ebc"].lookup(
        {"mega": torch.from_numpy(rw["jparams"]["emb"]["mega"].copy())},
        torch.from_numpy(rw["idx"])).numpy()
    np.testing.assert_allclose(got, want, **LOOKUP_TOL)
    jwant = np.asarray(rw["jebc"].lookup(
        {"mega": jnp.asarray(rw["jparams"]["emb"]["mega"])},
        jnp.asarray(rw["idx"])))
    np.testing.assert_allclose(got, jwant, **LOOKUP_TOL)
    assert rw["lookup"][0]["all_reduce"]["all_reduce_calls"] == 1
    assert rw["lookup"][0]["all_reduce"]["all_reduce_bytes"] == \
        4 * rw["cfg"].n_sparse_features * rw["cfg"].embed_dim * 4


def test_psum_lookup_table_wise_is_bit_equal(table_wise):
    tw = table_wise
    run = tw["runs"][(1, 4)]
    got = tw["lookup"][0]["pooled"]
    for r in tw["lookup"][1:]:
        np.testing.assert_array_equal(r["pooled"], got)
    want = run["ebc"].lookup(
        {"mega": torch.from_numpy(run["jparams"]["emb"]["mega"].copy())},
        torch.from_numpy(tw["idx"])).numpy()
    np.testing.assert_array_equal(got, want)
    jwant = np.asarray(run["jebc"].lookup(
        {"mega": jnp.asarray(run["jparams"]["emb"]["mega"])},
        jnp.asarray(tw["idx"])))
    np.testing.assert_allclose(got, jwant, **LOOKUP_TOL)

# ---------------------------------------------------------------------------
# the psum dense update (sparse_update_shardmap)
# ---------------------------------------------------------------------------


def _psum_oracles(rw, n_steps):
    port = _port_run(dataclasses.replace(rw["cfg"], lookup_impl="gather"),
                     rw["ebc"], rw["jparams"], rw["batches"][:n_steps],
                     "dense")
    ref = _ref_run(rw["jcfg"], rw["jebc"], rw["jparams"],
                   rw["batches"][:n_steps], "dense")
    return port, ref


def test_psum_update_matches_the_port_dense_step(row_wise):
    rw = row_wise
    (losses, p, s), _ = _psum_oracles(rw, PSUM_STEPS)
    for r in rw["fp32"]:
        np.testing.assert_allclose(r["losses"], losses, **PSUM_LOSS_TOL)
    np.testing.assert_allclose(_whole(rw["fp32"], "mega"),
                               p["emb"]["mega"].numpy(), **PSUM_TABLE_TOL)
    np.testing.assert_allclose(_whole(rw["fp32"], "accum"),
                               s["accum"].numpy(), **PSUM_TABLE_TOL)
    for a, b in zip(_dense_leaves(rw["fp32"][0]["dense"]),
                    _dense_leaves(p)):
        np.testing.assert_allclose(a, b.numpy(), **PSUM_TABLE_TOL)


def test_psum_update_matches_the_reference_step(row_wise):
    rw = row_wise
    _, (losses, jp, js) = _psum_oracles(rw, PSUM_STEPS)
    tol = {k: max(PSUM_TABLE_TOL[k], STEP_TOL[k]) for k in STEP_TOL}
    np.testing.assert_allclose(rw["fp32"][0]["losses"], losses, **tol)
    np.testing.assert_allclose(_whole(rw["fp32"], "mega"),
                               jp["emb"]["mega"], **tol)
    np.testing.assert_allclose(_whole(rw["fp32"], "accum"), js["accum"],
                               **tol)


def test_psum_update_bf16_reduce(row_wise):
    rw = row_wise
    (losses, _, _), (jlosses, _, _) = _psum_oracles(rw, 1)
    for r in rw["bf16"]:
        np.testing.assert_allclose(r["losses"], losses, **PSUM_LOSS_TOL)
        np.testing.assert_allclose(r["losses"], jlosses, **STEP_TOL)
    # the fp32 run's first step, replayed from its reported table after
    # one step is not kept: compare against the port's fp32 oracle
    (_, p1, s1), _ = _psum_oracles(rw, 1)
    got = _whole(rw["bf16"], "mega")
    np.testing.assert_allclose(got, p1["emb"]["mega"].numpy(), rtol=0,
                               atol=BF16_ATOL)
    assert not np.array_equal(got, p1["emb"]["mega"].numpy())
    acc = _whole(rw["bf16"], "accum")
    want = s1["accum"].numpy()
    np.testing.assert_allclose(acc, want, rtol=2 * 2.0 ** -8, atol=1e-7)
    # the reduce ran in bf16: half the bytes of the fp32 run's, per rank
    rows = rw["ebc"].plan.total_rows // 4
    fp32_bytes = rw["fp32"][0]["all_reduce"][0]["all_reduce_bytes"]
    bf16_bytes = rw["bf16"][0]["all_reduce"][0]["all_reduce_bytes"]
    assert fp32_bytes - bf16_bytes == rows * D * 2


def test_psum_update_all_reduces_once_per_axis(row_wise):
    """Per step and rank: the lookup's (B/2, F, d) sum over `model`, the
    dense gradients', the loss terms' and the (rows_local, d) gradient
    sum's over `data`: four calls."""
    rw = row_wise
    cfg = rw["cfg"]
    rows = rw["ebc"].plan.total_rows // 4
    n_dense = sum(x.size for x in _dense_leaves(rw["jparams"]))
    want = ((BATCH // 2) * cfg.n_sparse_features * D * 4 + n_dense * 4
            + BATCH * 4 + rows * D * 4)
    for r in rw["fp32"]:
        for st in r["all_reduce"]:
            assert st["all_reduce_calls"] == 4 and st["skipped_calls"] == 0
            assert st["all_reduce_bytes"] == want
        assert r["foreign_modules"] == []


def test_psum_update_on_a_pod_mesh_matches_the_port_dense_step(table_wise):
    """(pod 2, data 1, model 2): the batch splits over pod and data, the
    dense gradients, loss terms and row sums add over both (data's one
    rank skipped); the same relation to the one-device dense step as on
    (data, model)."""
    pod = table_wise["pod"]
    losses, p, s = _port_run(dataclasses.replace(pod["cfg"],
                                                 lookup_impl="gather"),
                             pod["ebc"], pod["jparams"], pod["batches"],
                             "dense")
    reps = pod["ranks"]
    first = sorted((r for r in reps if r["coords"]["pod"] == 0),
                   key=lambda r: r["rows"][0])
    for r in reps:
        np.testing.assert_allclose(r["losses"], losses, **PSUM_LOSS_TOL)
        assert r["foreign_modules"] == []
    for key, want in (("mega", p["emb"]["mega"]), ("accum", s["accum"])):
        np.testing.assert_allclose(np.concatenate([r[key] for r in first]),
                                   want.numpy(), **PSUM_TABLE_TOL)


def test_dry_mesh_books_the_pod_ranks_collectives(table_wise):
    """Each pod rank's `Mesh.stats` a step, calls and bytes of every
    collective on every axis and the skipped calls, equal a `DryMesh`'s at
    its rank for the same step on the meta device."""
    from repro_torch.core.dlrm import dlrm_param_specs
    from repro_torch.launch import dryrun
    pod = table_wise["pod"]
    cfg, ebc = pod["cfg"], pod["ebc"]
    shape = dataclasses.replace(dryrun.shapes_for("dlrm-m1")["train_b64k"],
                                global_batch=BATCH)
    cell = dryrun.Cell("dlrm-m1", shape, cfg, {},
                       dlrm_param_specs(cfg, ebc), {}, {}, ebc=ebc)
    for r in pod["ranks"]:
        m = tmesh.DryMesh(*POD_MESH, rank=r["rank"])
        dryrun.measure(cell.make(m), m, memory=False)
        want = {k: v for k, v in m.stats.items() if not k.endswith("_ms")}
        for st in r["all_reduce"]:
            assert {k: st[k] for k in want} == want
        assert want["all_reduce@pod_calls"] == 3


def test_psum_update_without_a_mesh_raises():
    cfg = dataclasses.replace(get_smoke_config("dlrm-m1"), lookup_impl="psum")
    ebc = EmbeddingBagCollection.build(cfg, n_shards=4, strategy="row_wise")
    with pytest.raises(ValueError, match="mesh"):
        build_dlrm_train_step(cfg, ebc, adagrad(0.01), sparse_apply="dense")
    # the fused update with a psum lookup and no mesh looks up as gather
    build_dlrm_train_step(cfg, ebc, adagrad(0.01), sparse_apply="sparse")


def test_what_a_mesh_refuses(row_wise):
    msgs = row_wise["fp32"][0]["refusals"]
    assert "lookup_impl='psum'" in msgs["gather_under_mesh"]
    assert "sparse_apply='dense'" in msgs["fused_under_mesh"]
    assert "the world has 8" in msgs["wrong_size"]


def test_mesh_constructors_need_a_world():
    assert not torch.distributed.is_initialized()
    for make in (lambda: tmesh.make_test_mesh((2, 4)),
                 lambda: tmesh.make_host_mesh(2),
                 lambda: tmesh.make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="initialized"):
            make()

# ---------------------------------------------------------------------------
# the table-wise step under a mesh
# ---------------------------------------------------------------------------


def _tablewise_oracle(cfg, run):
    key = "oracle"
    if key not in run:
        run[key] = _port_run(cfg, run["ebc"], run["jparams"], run["batches"],
                             "sparse")
    return run[key]


@pytest.mark.parametrize("staged", [False, True], ids=["sync", "staged"])
def test_tablewise_model_mesh_bit_equal_to_the_port_step(table_wise, staged):
    tw = table_wise
    run = tw["runs"][(1, 4)]
    res = run[staged]
    losses, p, s = _tablewise_oracle(tw["cfg"], run)
    for r in res:
        assert r["losses"] == losses
        assert r["foreign_modules"] == []
    np.testing.assert_array_equal(_whole(res, "mega"),
                                  p["emb"]["mega"].numpy())
    np.testing.assert_array_equal(_whole(res, "accum"), s["accum"].numpy())
    for r in res:
        for a, b in zip(_dense_leaves(r["dense"]), _dense_leaves(p)):
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("staged", [False, True], ids=["sync", "staged"])
def test_tablewise_hybrid_mesh_matches_the_port_step(table_wise, staged):
    tw = table_wise
    run = tw["runs"][(2, 2)]
    res = run[staged]
    losses, p, s = _tablewise_oracle(tw["cfg"], run)
    for r in res:
        assert r["losses"][0] == losses[0]
        np.testing.assert_allclose(r["losses"], losses, **HYBRID_TOL)
    np.testing.assert_allclose(_whole(res, "mega"), p["emb"]["mega"].numpy(),
                               **HYBRID_TOL)
    np.testing.assert_allclose(_whole(res, "accum"), s["accum"].numpy(),
                               **HYBRID_TOL)
    for a, b in zip(_dense_leaves(res[0]["dense"]), _dense_leaves(p)):
        np.testing.assert_allclose(a, b.numpy(), **HYBRID_TOL)


@pytest.mark.parametrize("staged", [False, True], ids=["sync", "staged"])
def test_tablewise_data_replicas_are_bit_equal(table_wise, staged):
    res = table_wise["runs"][(2, 2)][staged]
    for m in range(2):
        a, b = (r for r in res if r["coords"]["model"] == m)
        assert a["rows"] == b["rows"]
        np.testing.assert_array_equal(a["mega"], b["mega"])
        np.testing.assert_array_equal(a["accum"], b["accum"])
        assert a["losses"] == b["losses"]
        for x, y in zip(_dense_leaves(a["dense"]), _dense_leaves(b["dense"])):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_tablewise_mesh_matches_the_reference_step(table_wise, shape):
    tw = table_wise
    run = tw["runs"][shape]
    jopt = jadagrad(DENSE_LR)
    jp = jax.tree.map(jnp.array, run["jparams"])
    js = jsteps.dlrm_init_state(run["jebc"], jopt, jp)
    jstep = jsteps.build_tablewise_train_step(tw["jcfg"], run["jebc"], jopt,
                                              SPARSE_LR)
    want = []
    for t, b in enumerate(run["batches"]):
        jp, js, m = jstep(jp, js, {"dense": jnp.asarray(b["dense"]),
                                   "idx": b["idx"],
                                   "label": jnp.asarray(b["label"])},
                          jnp.asarray(t, jnp.int32))
        want.append(float(m["loss"]))
    for staged in (False, True):
        res = run[staged]
        np.testing.assert_allclose(res[0]["losses"], want, **STEP_TOL)
        np.testing.assert_allclose(_whole(res, "mega"),
                                   np.asarray(jp["emb"]["mega"]), **STEP_TOL)
        np.testing.assert_allclose(_whole(res, "accum"),
                                   np.asarray(js["accum"]), **STEP_TOL)
        ex = res[0]["exchange"]
        assert ex["exchange_pooled_fwd_bytes"] == \
            ex["exchange_pooled_bwd_bytes"] > 0


def test_tablewise_mesh_reduces_once_per_exchange(table_wise):
    """(2, 2), staged: from step 1 on a step's lookup is the one staged by
    the step before. A step all-reduces over `model` once per lookup (its
    own at step 0, the next batch's staged one before the last step) and
    over `data` three times: the dense gradients, the loss terms and the
    pooled gradients (the whole batch's, gathered)."""
    tw = table_wise
    f = tw["cfg"].n_sparse_features
    n_dense = sum(x.size for x in _dense_leaves(tw["runs"][(2, 2)]["jparams"]))
    lookup = BATCH // 2 * f * D * 4
    data = n_dense * 4 + BATCH * 4 + BATCH * f * D * 4
    want = [2 * lookup + data, lookup + data, lookup + data, data]
    for r in tw["runs"][(2, 2)][True]:
        assert [st["all_reduce_calls"] for st in r["all_reduce"]] == \
            [5, 4, 4, 3]
        assert [st["all_reduce_bytes"] for st in r["all_reduce"]] == want


# ---------------------------------------------------------------------------
# run_ranks: a failing rank and a timeout end the spawn
# ---------------------------------------------------------------------------


def test_run_ranks_raises_a_failing_rank():
    cfg = get_smoke_config("dlrm-m1")
    job = {"cfg": cfg, "mesh": (3, 3), "strategy": "table_wise",
           "step": "tablewise", "dense": {}, "mega": np.zeros((8, 16)),
           "n_steps": 1, "batches": []}
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="holds 9 ranks; the world has 2"):
        tmesh.run_ranks(train_rank, 2, (job,), backend="gloo",
                        device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    assert time.perf_counter() - t0 < 60


def test_run_ranks_times_out_and_kills_the_ranks():
    cfg = get_smoke_config("dlrm-m1")
    job = {"cfg": cfg, "mesh": (1, 2), "strategy": "table_wise",
           "step": "tablewise", "dense": {}, "mega": np.zeros((8, 16)),
           "n_steps": 1, "batches": []}
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="did not report within"):
        tmesh.run_ranks(train_rank, 2, (job,), backend="gloo",
                        device="cpu", timeout_s=0.5)
    assert time.perf_counter() - t0 < 30


def test_rank_world_runs_calls_on_one_spawn_and_ends_on_a_failure():
    cfg = get_smoke_config("dlrm-m1")
    bad = {"cfg": cfg, "mesh": (3, 3), "strategy": "table_wise",
           "step": "tablewise", "dense": {}, "mega": np.zeros((8, 16)),
           "n_steps": 1, "batches": []}
    with tmesh.RankWorld(2, backend="gloo", device="cpu",
                         timeout_s=SPAWN_TIMEOUT_S) as world:
        first, second = {}, {}
        assert world.run(run_calls, ([],), timings=first) == [[], []]
        assert world.run(run_calls, ([],), timings=second) == [[], []]
        # the second call's ranks are the first's: started before it
        assert all(r["imported"] < 0 < f["imported"]
                   for r, f in zip(second["ranks"], first["ranks"]))
        with pytest.raises(RuntimeError,
                           match="holds 9 ranks; the world has 2"):
            world.run(train_rank, (bad,))
        with pytest.raises(RuntimeError, match="has ended"):
            world.run(run_calls, ([],))


@pytest.mark.parametrize("shard", [0, 1, 2, 3])
def test_shard_gradient_sums_equal_the_reference_csr_sums(shard):
    """The psum update's local buffer: the port's slot-order scatter
    (`dense_gradient_sum` over the rows of one shard) is the reference's
    shard-local plan, `bag_grad_sums` and scatter, bit for bit: a row's
    slots all belong to one feature, so both add them in example order."""
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro_torch.train.steps import dense_gradient_sum
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, n_shards=4, strategy="row_wise")
    rows = ebc.plan.total_rows // 4
    lo = shard * rows
    rng = np.random.RandomState(shard)
    idx = ebc.offset_indices(_raw_idx(cfg, rng, b=8, lk=6))
    g = rng.randn(8, cfg.n_sparse_features, D).astype(np.float32)
    loc = np.where((idx >= lo) & (idx < lo + rows), idx - lo, -1)
    plan = jops.build_sparse_plan(jnp.asarray(loc))
    sums = jref.bag_grad_sums(plan.unique_rows, plan.bag_offsets,
                              plan.bag_ids, jnp.asarray(g.reshape(-1, D)))
    drop = jnp.where(plan.unique_rows >= 0, plan.unique_rows, rows)
    want = jnp.zeros((rows, D), jnp.float32).at[drop].set(sums, mode="drop")
    got = dense_gradient_sum(rows, torch.from_numpy(loc),
                             torch.from_numpy(g))[:rows]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
