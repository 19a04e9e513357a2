"""The DLRM multi-device remainder on gloo CPU ranks: the multi-host cached
step one rank a host (`build_cached_train_step(mesh=)`), the elastic
re-mesh restore (`CheckpointManager.restore(shardings=)`), `nn.sharding`'s
rule tables, resolvers and `NamedSharding`, EASGD over a pod axis and
error-feedback compression, against the reference and the port's
single-process forms.

Two spawns (`launch.mesh.run_ranks`, the rank callables of
`train.sharded`) hold every rank-side case: 4 ranks, then 2. Each runs
the mesh step at its H (4, then 2 hosts) with strict_sync on and off and
fetch_chunk 1 and 8, on the smoke dlrm-m1, N = 4 steps of B = 16 with one
hot row planted on every host (the reference's failing 8-device test);
the EASGD pod form at R = its size, and a row of signed zeros and a NaN
payload through `all_gather_rows` and `all_to_all_rows`. The 4-rank world
also trains the elastic run's first 2 steps and saves; the 2-rank world
restores that onto 2 hosts and trains steps 2-3. Parameters come from the
reference's init (`convert.params_from_jax`).

Tolerances, each with its reason:
  * the mesh step against the port's single-controller step (the same
    H, strict_sync and fetch_chunk) and against the port's uncached
    `build_dlrm_train_step(sparse_apply="sparse")`: losses, capacity and
    accumulator bit-equal (the ranks run the same ops on the same inputs;
    rows move by copy), CacheStats and RouteStats equal;
  * against the reference's `build_dlrm_train_step(sparse_apply=
    "sparse")`: STEP_TOL, rtol/atol 1e-5 (XLA's fp32 matmuls and sums run
    in other orders than torch's, as tests/test_torch_multihost.py holds);
  * the elastic run: bit-equal to the uninterrupted single-controller run
    (the caches are clean, so where a row is cached moves no bit);
  * rule tables, specs and blocks: exactly equal;
  * EASGD stacked against the reference: bit-equal (an fp32 mean over 2 or
    4 replicas, a power-of-two divisor); the pod form against the stacked
    one bit-equal at R = 2 (a two-term sum does not depend on its order)
    and within EASGD_TOL at R = 4 (gloo's ring sums in another order: a
    few fp32 ulps of the sum, carried through three rounds);
  * compression: bit-equal (fp32 scale, round half to even in both).
"""
import dataclasses
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_smoke_config as jget_smoke
from repro.core.dlrm import dlrm_param_specs as jspecs
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.nn import sharding as jsharding
from repro.nn.params import init_params as jinit
from repro.optim import adagrad as jadagrad
from repro.optim import compression as jcomp
from repro.optim import easgd as jeasgd
from repro.train import checkpoint as jckpt
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.cache import MultiHostCachedEmbeddingBagCollection
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.data.synthetic import make_dlrm_batch
from repro_torch.launch import mesh as tmesh
from repro_torch.nn import sharding
from repro_torch.nn.params import tree_map
from repro_torch.nn.sharding import NamedSharding
from repro_torch.optim import (adagrad, compress_decompress, easgd_init,
                               easgd_sync, error_feedback_compress,
                               init_residual, local_sgd_sync, replica_step)
from repro_torch.train import steps
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import FaultInjector, FaultSpec
from repro_torch.train.sharded import (add_checksums, bit_checksum,
                                       easgd_rounds, multihost_rank,
                                       pod_rank, run_calls)

STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
EASGD_TOL = {"rtol": 1e-6, "atol": 1e-6}
N_STEPS, BATCH, CACHE_ROWS, SPLIT = 4, 16, 512, 2
VARIANTS = [(strict, chunk) for strict in (False, True) for chunk in (1, 8)]
EASGD = {"rounds": 3, "seed": 11, "lr": 0.05, "alpha": 0.3, "beta": 0.3,
         "sync_every": 1}
SLICES = [((4,), ("data",), ("data", None), (1856, 16)),
          ((2, 2), ("pod", "data"), (("pod", "data"),), (8, 3)),
          ((2, 2), ("pod", "data"), (None, "data"), (3, 4, 2)),
          ((2, 2), ("pod", "data"), ("data", "pod"), (6, 2)),
          ((2,), ("pod",), ("pod", None), (10, 3))]
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    jebc = JEBC.build(jcfg, n_shards=1, strategy="replicated")
    host = jax.tree.map(np.asarray, jinit(jspecs(jcfg, jebc),
                                          jax.random.PRNGKey(0)))
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    batches = []
    for t in range(N_STEPS):
        raw = make_dlrm_batch(cfg, BATCH, step=t)
        idx = ebc.offset_indices(raw["idx"])
        idx[:, 0, 0] = int(idx[idx >= 0][0])       # cached on every host
        batches.append({"dense": raw["dense"], "idx": idx,
                        "label": raw["label"]})
    dense = {k: host[k] for k in ("bottom", "top")}
    return {"cfg": cfg, "jcfg": jcfg, "jebc": jebc, "host": host,
            "batches": batches, "dense": dense}


def _job(setup, n_hosts, strict, chunk, **kw):
    return {"cfg": setup["cfg"], "n_hosts": n_hosts,
            "cache_rows": CACHE_ROWS, "strict_sync": strict,
            "fetch_chunk": chunk, "dense": setup["dense"],
            "mega": setup["host"]["emb"]["mega"], "batches": setup["batches"],
            "report_arrays": True, **kw}


def _spawn(calls, n):
    return tmesh.run_ranks(run_calls, n, (calls,), backend="gloo",
                           device="cpu", timeout_s=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    """The 4-rank world, then the 2-rank world (which restores the first's
    checkpoint). out[H][i] is call i's reports in rank order: calls 0-3
    the mesh step's VARIANTS, 4 the EASGD pod form and the probes, 5 the
    elastic run's half."""
    ckdir = str(tmp_path_factory.mktemp("elastic"))
    saved_rows = MultiHostCachedEmbeddingBagCollection.build(
        setup["cfg"], n_hosts=4).ebc.plan.total_rows
    out = {}
    for n in (4, 2):
        calls = [(multihost_rank, _job(setup, n, strict, chunk))
                 for strict, chunk in VARIANTS]
        calls.append((pod_rank, {"params": setup["dense"], **EASGD,
                                 "slices": _slices_of(n)}))
        if n == 4:
            calls.append((multihost_rank, _job(
                setup, 4, False, 1, steps=(0, SPLIT), save={"dir": ckdir})))
        else:
            calls.append((multihost_rank, _job(
                setup, 2, False, 1, mega=None, steps=(SPLIT, N_STEPS),
                total_rows=saved_rows, restore={"dir": ckdir})))
        res = _spawn(calls, n)
        out[n] = [[r[i] for r in res] for i in range(len(calls))]
    out["ckdir"] = ckdir
    return out


def _slices_of(n):
    """The SLICES entries whose mesh holds n ranks."""
    return [s for s in SLICES if int(np.prod(s[0])) == n]


def _single_controller(setup, n_hosts, strict, chunk):
    params = params_from_jax(setup["host"], device="cpu")
    mc = MultiHostCachedEmbeddingBagCollection.build(
        setup["cfg"], n_hosts=n_hosts, cache_rows=CACHE_ROWS)
    opt = adagrad(0.01)
    dense = {"bottom": params["bottom"], "top": params["top"]}
    state = steps.cached_dlrm_init_state(mc, opt, params)
    ms = mc.init_state(params["emb"]["mega"])
    step = steps.build_cached_train_step(setup["cfg"], mc, opt,
                                         strict_sync=strict,
                                         fetch_chunk=chunk)
    losses, bs = [], setup["batches"]
    for t, b in enumerate(bs):
        nxt = bs[t + 1] if t + 1 < len(bs) else None
        dense, state, m = step(dense, state, ms, b, t, next_batch=nxt)
        losses.append(float(m["loss"]))
    return {"losses": losses, "mega": ms.capacity, "accum": ms.cap_accum,
            "dense": dense, "stats": dataclasses.asdict(ms.stats),
            "route": dataclasses.asdict(ms.route)}


@pytest.fixture(scope="module")
def uncached(setup):
    """The port's `build_dlrm_train_step(sparse_apply="sparse")` and the
    reference's, from the same parameters and batches."""
    cfg, host = setup["cfg"], setup["host"]
    params = params_from_jax(host, device="cpu")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    opt = adagrad(0.01)
    state = steps.dlrm_init_state(ebc, opt, params)
    step = steps.build_dlrm_train_step(cfg, ebc, opt, sparse_apply="sparse")
    losses = []
    for t, b in enumerate(setup["batches"]):
        tb = {k: torch.as_tensor(b[k]) for k in ("dense", "idx", "label")}
        params, state, m = step(params, state, tb, t)
        losses.append(float(m["loss"]))
    jp = jax.tree.map(jnp.asarray, host)
    jopt = jadagrad(0.01)
    jstate = jsteps.dlrm_init_state(setup["jebc"], jopt, jp)
    jstep = jax.jit(jsteps.build_dlrm_train_step(
        setup["jcfg"], setup["jebc"], jopt, sparse_apply="sparse"))
    jlosses = []
    for t, b in enumerate(setup["batches"]):
        jb = {k: jnp.asarray(b[k]) for k in ("dense", "idx", "label")}
        jp, jstate, m = jstep(jp, jstate, jb, jnp.asarray(t, jnp.int32))
        jlosses.append(float(m["loss"]))
    return {"losses": losses, "mega": params["emb"]["mega"],
            "accum": state["accum"], "ref_losses": jlosses,
            "ref_mega": np.asarray(jp["emb"]["mega"]),
            "ref_accum": np.asarray(jstate["accum"])}


def _whole(reports, key):
    return np.concatenate([r[key] for r in sorted(reports,
                                                  key=lambda r: r["host"])])

# ---------------------------------------------------------------------------
# the mesh step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strict,chunk", VARIANTS,
                         ids=[f"strict{int(s)}-chunk{c}" for s, c in VARIANTS])
@pytest.mark.parametrize("n_hosts", [2, 4])
def test_mesh_step_bit_equal_to_single_controller(setup, worlds, n_hosts,
                                                  strict, chunk):
    """Every rank's losses, the shards put together (capacity and
    accumulator) and the dense parameters equal the single-controller
    step's bit for bit; CacheStats and RouteStats equal on every rank;
    the hot row is in every host's working set each step and its remote
    gradients are routed."""
    res = worlds[n_hosts][VARIANTS.index((strict, chunk))]
    want = _single_controller(setup, n_hosts, strict, chunk)
    total = want["mega"].shape[0]
    assert [r["host"] for r in res] == list(range(n_hosts))
    assert [r["rows"] for r in res] == [
        (h * total // n_hosts, (h + 1) * total // n_hosts)
        for h in range(n_hosts)]
    for r in res:
        assert r["losses"] == want["losses"]
        assert r["stats"] == want["stats"] and r["route"] == want["route"]
        assert r["foreign_modules"] == []
        for a, b in zip(_leaves(r["dense"]), _leaves(tree_map(
                lambda t: t.numpy(), want["dense"])), strict=True):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_whole(res, "mega"), want["mega"].numpy())
    np.testing.assert_array_equal(_whole(res, "accum"),
                                  want["accum"].numpy())
    assert add_checksums(r["mega_sum"] for r in res) == \
        bit_checksum(want["mega"])
    route = want["route"]
    assert route["dup_rows"] >= N_STEPS and route["grad_pairs_remote"] > 0
    assert (want["stats"]["prefetched"] > 0) != strict
    if chunk > 1:
        assert route["fetch_chunks"] > 0


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("n_hosts", [2, 4])
def test_mesh_step_equals_the_uncached_steps(setup, worlds, uncached,
                                             n_hosts):
    """Every variant at both H: bit-equal to the port's uncached sparse
    step (the multi-host tier's numerics contract), within STEP_TOL of the
    reference's."""
    rows = uncached["mega"].shape[0]
    for res in worlds[n_hosts][:len(VARIANTS)]:
        mega, accum = _whole(res, "mega"), _whole(res, "accum")
        assert res[0]["losses"] == uncached["losses"]
        np.testing.assert_array_equal(mega[:rows], uncached["mega"].numpy())
        np.testing.assert_array_equal(accum[:rows],
                                      uncached["accum"].numpy())
        assert not mega[rows:].any() and not accum[rows:].any()
        np.testing.assert_allclose(res[0]["losses"], uncached["ref_losses"],
                                   **STEP_TOL)
        np.testing.assert_allclose(mega[:rows], uncached["ref_mega"],
                                   **STEP_TOL)
        np.testing.assert_allclose(accum[:rows], uncached["ref_accum"],
                                   **STEP_TOL)


@pytest.mark.parametrize("n_hosts", [2, 4])
def test_mesh_step_collectives_and_launches(worlds, n_hosts):
    """A step's collectives on every rank: one all_gather of the (B/H, F,
    d) pools, two or three all_to_all row exchanges (misses, working set,
    the prefetch unless strict), no all_reduce; on the CPU no kernel
    launches (the plain versions run)."""
    d = 16
    for (strict, _), res in zip(VARIANTS, worlds[n_hosts]):
        for r in res:
            for t, c in enumerate(r["collectives"]):
                assert c["all_reduce_calls"] == 0
                assert c["all_gather_calls"] == 1
                assert c["all_gather_bytes"] == BATCH // n_hosts * 6 * d * 4
                # misses and working set; a prefetch that admits rows
                assert c["all_to_all_calls"] in ((2,) if strict
                                                 or t == N_STEPS - 1
                                                 else (2, 3))
            assert all(not any(step.values()) for step in r["launches"])


@pytest.mark.parametrize("n", [2, 4])
def test_rows_move_by_copy_keeping_every_bit(worlds, n):
    """A row of -0.0, +0.0, -0.0 and a NaN with a payload comes through
    `all_gather_rows` and `all_to_all_rows` bit for bit (a zero-padded
    sum would turn -0.0 into +0.0)."""
    res = worlds[n][len(VARIANTS)]
    sent = np.concatenate([r["sent_bits"] for r in res])
    assert sent[0, 0] == np.int32(-2 ** 31)          # -0.0 really sent
    for r in res:
        np.testing.assert_array_equal(r["gathered_bits"], sent)
        np.testing.assert_array_equal(r["swapped_bits"], sent)
        assert r["foreign_modules"] == []


def test_mesh_form_validates_its_mesh(setup):
    """A host mesh whose axis size is not the tier's host count, and a
    capacity sharding that does not row-shard over the hosts, raise."""
    cfg = setup["cfg"]
    mc = MultiHostCachedEmbeddingBagCollection.build(cfg, n_hosts=2,
                                                     cache_rows=64)
    mesh = SimpleNamespace(shape={"data": 4}, axis_names=("data",),
                           coords={"data": 0}, size=lambda a: 4)
    with pytest.raises(ValueError, match="4 ranks"):
        steps.build_cached_train_step(cfg, mc, adagrad(0.01), mesh=mesh)
    with pytest.raises(ValueError, match="row-shard"):
        mc.init_state(torch.zeros(8, 16),
                      capacity_sharding=NamedSharding(mesh, ("data", None)))
    with pytest.raises(ValueError, match="row-shard"):
        mc.init_state(torch.zeros(8, 16),
                      capacity_sharding=NamedSharding(mesh, (None, "data")))

# ---------------------------------------------------------------------------
# restore(shardings=): the elastic re-mesh
# ---------------------------------------------------------------------------


def test_elastic_restore_from_4_hosts_onto_2_is_bit_equal(setup, worlds):
    """Steps 0-1 on 4 ranks, saved (gathered to rank 0, whole leaves);
    restored onto 2 ranks (each its block of the stored 1,856 rows) and
    steps 2-3 there: the losses and the final capacity, accumulator and
    dense parameters equal the uninterrupted 4-host run's bits; each
    restored block equals the saved rows."""
    first, second = worlds[4][-1], worlds[2][-1]
    want = _single_controller(setup, 4, False, 1)
    assert first[0]["losses"] + second[0]["losses"] == want["losses"]
    np.testing.assert_array_equal(_whole(second, "mega"),
                                  want["mega"].numpy())
    np.testing.assert_array_equal(_whole(second, "accum"),
                                  want["accum"].numpy())
    for a, b in zip(_leaves(second[0]["dense"]), _leaves(tree_map(
            lambda t: t.numpy(), want["dense"])), strict=True):
        np.testing.assert_array_equal(a, b)
    saved = CheckpointManager(worlds["ckdir"])
    assert saved.saved_steps() == [SPLIT]
    whole = saved.restore({"capacity": torch.zeros(1856, 16),
                           "cap_accum": torch.zeros(1856),
                           "dense": tree_map(torch.clone, want["dense"]),
                           "opt": adagrad(0.01).init(
                               tree_map(torch.clone, want["dense"]))})
    np.testing.assert_array_equal(_whole(first, "mega"),
                                  whole["capacity"].numpy())
    for r in second:
        lo, hi = r["rows"]
        assert (lo, hi) == (928 * r["host"], 928 * (r["host"] + 1))
        assert r["restored"]["step"] == SPLIT
        assert r["restored"]["mega_sum"] == bit_checksum(
            whole["capacity"][lo:hi])
        assert r["restored"]["accum_sum"] == bit_checksum(
            whole["cap_accum"][lo:hi])


def _mesh(shape, names, coords):
    return SimpleNamespace(shape=dict(zip(names, shape)), axis_names=names,
                           coords=dict(zip(names, coords)))


def _save_tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"rows": torch.from_numpy(rng.randn(8, 3).astype(np.float32)),
            "acc": torch.from_numpy(rng.rand(8).astype(np.float32)),
            "w": torch.from_numpy(rng.randn(4).astype(np.float32))
            .to(torch.bfloat16)}


def _shard_restore(mgr, n, **kw):
    """Every coordinate of an n-rank ("data",) mesh restoring its blocks:
    [(rows block, acc block, w), ...]."""
    out = []
    for c in range(n):
        sh = NamedSharding(_mesh((n,), ("data",), (c,)), ("data", None))
        ex = {"rows": torch.zeros(8 // n, 3), "acc": torch.zeros(8 // n),
              "w": torch.zeros(4, dtype=torch.bfloat16)}
        got = mgr.restore(ex, shardings={"rows": sh, "acc": NamedSharding(
            sh.mesh, ("data",)), "w": None}, **kw)
        assert got["rows"] is ex["rows"]              # in place
        out.append((got["rows"], got["acc"], got["w"]))
    return out


@pytest.mark.parametrize("n", [1, 2, 4])
def test_restore_shardings_loads_each_rank_its_block(tmp_path, n):
    tree = _save_tree()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    for c, (rows, acc, w) in enumerate(_shard_restore(mgr, n)):
        k = 8 // n
        assert torch.equal(rows, tree["rows"][c * k:(c + 1) * k])
        assert torch.equal(acc, tree["acc"][c * k:(c + 1) * k])
        assert torch.equal(w, tree["w"])
    bad = NamedSharding(_mesh((2,), ("data",), (0,)), ("data", None))
    with pytest.raises(ValueError, match="block"):
        mgr.restore({"rows": torch.zeros(8, 3), "acc": torch.zeros(8),
                     "w": torch.zeros(4, dtype=torch.bfloat16)},
                    shardings={"rows": bad, "acc": None, "w": None})


def test_restore_shardings_falls_back_past_a_torn_step(tmp_path):
    """The newest step's rows leaf torn in its last byte, outside rank 0's
    block: rank 0 too skips the step (the CRC covers the whole leaf) for
    the older one, and an explicit step stays strict."""
    mgr = CheckpointManager(str(tmp_path), injector=FaultInjector(
        [FaultSpec("checkpoint.write", 1, kind="torn", arg=1)]))
    first, second = _save_tree(0), _save_tree(1)
    mgr.save(1, first)
    mgr.save(2, second)
    for c, (rows, _, _) in enumerate(_shard_restore(mgr, 2)):
        assert torch.equal(rows, first["rows"][c * 4:(c + 1) * 4])
        assert mgr.last_restored_step == 1
    from repro_torch.train.checkpoint import CheckpointCorruptionError
    with pytest.raises(CheckpointCorruptionError, match="CRC"):
        _shard_restore(mgr, 2, step=2)


def test_restore_shardings_reads_the_reference_files(tmp_path):
    """The reference's CheckpointManager writes; each of 2 ranks restores
    its block of the rows and the whole bf16 leaf, bit for bit."""
    tree = _save_tree(3)
    jtree = {"rows": jnp.asarray(tree["rows"].numpy()),
             "acc": jnp.asarray(tree["acc"].numpy()),
             "w": jnp.asarray(tree["w"].float().numpy(), jnp.bfloat16)}
    jckpt.CheckpointManager(str(tmp_path)).save(5, jtree)
    mgr = CheckpointManager(str(tmp_path))
    for c, (rows, acc, w) in enumerate(_shard_restore(mgr, 2)):
        assert torch.equal(rows, tree["rows"][c * 4:(c + 1) * 4])
        assert torch.equal(acc, tree["acc"][c * 4:(c + 1) * 4])
        assert torch.equal(w, tree["w"])
    assert mgr.last_restored_step == 5

# ---------------------------------------------------------------------------
# nn/sharding
# ---------------------------------------------------------------------------


TABLES = ["TRAIN_RULES", "FSDP_RULES", "ZERO_DP_RULES", "SERVE_RULES",
          "LONG_SERVE_RULES"]
MESHES = [(("data", "model"), (16, 16)), (("pod", "data", "model"),
                                          (2, 16, 16)),
          (("data", "model"), (2, 4)), (("data",), (4,))]
AXES_SHAPES = [
    (("batch", "seq", "act_embed"), (256, 4096, 5120)),
    (("embed", "heads", "head_dim"), (5120, 40, 128)),      # qwen's wq
    (("embed", "kv_heads", "head_dim"), (5120, 40, 128)),
    (("heads", "head_dim", "embed"), (40, 128, 5120)),
    (("vocab", "embed"), (50280, 1536)),                     # mamba's vocab
    (("embed", "ff"), (2048, 8192)),
    (("expert", "embed", "ff"), (40, 1536, 512)),
    (("act_tokens", "act_expert", "moe_cap"), (64, 40, 32)),
    (("hash", None), (170361920, 64)),
    (("cache_seq", "cache_kv", "head_dim"), (8192, 8, 128)),
    ((None, "layer", "ssm_inner"), (3, 48, 3072)),
    (("batch", "act_seq", "act_vocab"), (1, 4096, 32000)),
]


@pytest.mark.parametrize("table", TABLES)
def test_rule_tables_and_resolvers_match_the_reference(table):
    rules, jrules = getattr(sharding, table), getattr(jsharding, table)
    assert rules == jrules
    for names, sizes in MESHES:
        mesh = SimpleNamespace(axis_names=names,
                               shape=dict(zip(names, sizes)))
        for axes, shape in AXES_SHAPES:
            assert sharding._resolve(axes, rules, names) == \
                tuple(jsharding._resolve(axes, jrules, names))
            assert sharding.logical_to_pspec(axes, rules, mesh) == \
                tuple(jsharding.logical_to_pspec(axes, jrules, mesh))
            assert sharding.resolve_sized(axes, rules, mesh, shape) == \
                tuple(jsharding.resolve_sized(axes, jrules, mesh, shape))


def test_qwen_heads_take_the_fallback():
    """40 heads do not split 16 ways: under SERVE_RULES the model axis
    migrates to head_dim, under TRAIN_RULES it is dropped."""
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 16, "model": 16})
    axes, shape = ("embed", "heads", "head_dim"), (5120, 40, 128)
    assert sharding.resolve_sized(axes, sharding.SERVE_RULES, mesh,
                                  shape) == (None, None, "model")
    assert sharding.resolve_sized(axes, sharding.TRAIN_RULES, mesh,
                                  shape) == ()
    assert sharding.resolve_sized(axes, sharding.FSDP_RULES, mesh,
                                  shape) == ("data",)


@pytest.mark.parametrize("case", range(len(SLICES)))
def test_local_slices_cover_every_index_once_across_ranks(worlds, case):
    """The blocks NamedSharding gives each rank of a spawned world (its
    real coordinates): together they cover every global index exactly
    once a replica (the ranks that differ only along axes the spec does
    not name hold the same block), and each block has local_shape's
    shape."""
    shape, names, spec, gshape = SLICES[case]
    n = int(np.prod(shape))
    res = worlds[n][len(VARIANTS)]
    i = _slices_of(n).index(SLICES[case])
    hits = np.zeros(gshape, np.int32)
    for r in res:
        block = tuple(slice(a, b) for a, b in r["slices"][i])
        hits[block] += 1
        mesh = _mesh(shape, names, np.unravel_index(r["rank"], shape))
        assert hits[block].shape == NamedSharding(mesh, spec).local_shape(
            gshape)
    used = {a for e in spec if e is not None
            for a in (e if isinstance(e, tuple) else (e,))}
    replicas = n // int(np.prod([dict(zip(names, shape))[a] for a in used]))
    assert (hits == replicas).all()


def test_named_sharding_refuses_what_does_not_split():
    mesh = _mesh((2, 2), ("pod", "data"), (1, 0))
    with pytest.raises(ValueError, match="does not split"):
        NamedSharding(mesh, ("data",)).local_shape((5, 3))
    with pytest.raises(ValueError, match="names axis"):
        NamedSharding(mesh, ("model",))
    assert NamedSharding(mesh, (("pod", "data"),)).local_slice((8,)) == \
        (slice(4, 6),)
    t = torch.arange(24).reshape(4, 6)
    assert torch.equal(NamedSharding(mesh, (None, "pod")).shard(t),
                       t[:, 3:])

# ---------------------------------------------------------------------------
# EASGD and compression
# ---------------------------------------------------------------------------


def _params():
    rng = np.random.RandomState(5)
    return {"w": rng.randn(3, 4).astype(np.float32),
            "b": [rng.randn(5).astype(np.float32),
                  rng.randn(2).astype(np.float32)]}


def _t(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _np(tree):
    return tree_map(lambda x: np.asarray(x), tree)


@pytest.mark.parametrize("r", [2, 4])
def test_easgd_stacked_form_equals_the_reference(r):
    p = _params()
    st, jst = easgd_init(_t(p), r), jeasgd.easgd_init(
        jax.tree.map(jnp.asarray, p), r)
    for k in range(3):
        rng = np.random.RandomState(k)
        g = tree_map(lambda x: rng.standard_normal((r,) + x.shape)
                     .astype(np.float32), p)
        st = replica_step(st, _t(g), 0.05)
        jst = jeasgd.replica_step(jst, jax.tree.map(jnp.asarray, g), 0.05)
        st, jst = easgd_sync(st, 0.3, 0.2), jeasgd.easgd_sync(jst, 0.3, 0.2)
    lo, jlo = local_sgd_sync(st), jeasgd.local_sgd_sync(jst)
    for got, want in ((st.replicas, jst.replicas), (st.center, jst.center),
                      (lo.replicas, jlo.replicas), (lo.center, jlo.center)):
        for a, b in zip(_leaves(_np(tree_map(lambda x: x.numpy(), got))),
                        jax.tree.leaves(want), strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("n", [2, 4])
def test_easgd_pod_form_equals_the_stacked_form(setup, worlds, n):
    params = _t(setup["dense"])
    elastic, local = easgd_rounds(params, n, EASGD["rounds"], EASGD["seed"],
                                  EASGD["lr"], EASGD["alpha"], EASGD["beta"],
                                  EASGD["sync_every"])
    want = {"elastic": (elastic.replicas, elastic.center),
            "local": (local.replicas, local.center)}
    for r in worlds[n][len(VARIANTS)]:
        assert r["collectives"]["all_reduce_calls"] > 0
        for key, (reps, center) in want.items():
            pairs = list(zip(_leaves(r[key]["replicas"]),
                             _leaves(reps), strict=True)) + list(zip(
                _leaves(r[key]["center"]), _leaves(center), strict=True))
            for a, b in pairs:
                b = b.numpy()
                if b.ndim == a.ndim and b.shape[0] == n and a.shape[0] == 1:
                    b = b[r["rank"]:r["rank"] + 1]
                if n == 2:
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a, b, **EASGD_TOL)


def test_compress_decompress_matches_the_reference():
    rng = np.random.RandomState(0)
    cases = [rng.randn(64).astype(np.float32) * 3,
             rng.randn(7, 5).astype(np.float32) * 1e-3,
             np.array([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 0.0],
                      np.float32),                    # exact .5 ties
             np.zeros(6, np.float32),                  # an all-zero leaf
             np.array([-0.0, 1e-30, -1e-30, 65504.0], np.float32)]
    for g in cases:
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                        (torch.int8, jnp.int8)):
            got = compress_decompress(torch.from_numpy(g), dt)
            want = np.asarray(jcomp.compress_decompress(jnp.asarray(g), jdt))
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy().view(np.int32),
                                          want.view(np.int32))
    ties = compress_decompress(torch.from_numpy(cases[2]), torch.int8)
    assert ties[1:8].tolist() == [0.0, 2.0, 2.0, -0.0, -2.0, -2.0, 4.0]


@pytest.mark.parametrize("dt,jdt", [(torch.bfloat16, jnp.bfloat16),
                                    (torch.int8, jnp.int8)])
def test_error_feedback_matches_the_reference(dt, jdt):
    rng = np.random.RandomState(1)
    g = {"a": rng.randn(5, 3).astype(np.float32) * 1e-3,
         "b": [rng.randn(4).astype(np.float32)]}
    res, jres = init_residual(_t(g)), jcomp.init_residual(
        jax.tree.map(jnp.asarray, g))
    for k in range(4):
        gk = tree_map(lambda x: x * (k + 1), g)
        comp, res = error_feedback_compress(_t(gk), res, dt)
        jc, jres = jcomp.error_feedback_compress(
            jax.tree.map(jnp.asarray, gk), jres, jdt)
        for a, b in zip(_leaves(tree_map(lambda x: x.numpy(), comp))
                        + _leaves(tree_map(lambda x: x.numpy(), res)),
                        jax.tree.leaves(jc) + jax.tree.leaves(jres),
                        strict=True):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_error_feedback_unbiased_over_time():
    """The reference's test: with error feedback the sum of compressed
    gradients tracks the sum of the true ones (the residual stays
    bounded)."""
    rng = np.random.RandomState(0)
    true_sum = np.zeros(64, np.float32)
    comp_sum = np.zeros(64, np.float32)
    residual = init_residual({"g": torch.zeros(64)})
    for _ in range(50):
        g = {"g": torch.from_numpy((rng.randn(64) * 1e-3)
                                   .astype(np.float32))}
        comp, residual = error_feedback_compress(g, residual)
        true_sum += g["g"].numpy()
        comp_sum += comp["g"].numpy()
    assert np.abs(true_sum - comp_sum).max() < 1e-4


def test_mesh_of_one_rank_in_this_process(setup, tmp_path):
    """A one-rank world in the test process: the mesh step on a 1-host
    mesh equals the single-controller step bit for bit, and every call
    over the one-rank axis is booked as skipped (no collective runs)."""
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp_path, "store"), 1), rank=0, world_size=1)
    try:
        mesh = tmesh.make_host_mesh(1)
        params = params_from_jax(setup["host"], device="cpu")
        mc = MultiHostCachedEmbeddingBagCollection.build(
            setup["cfg"], n_hosts=1, cache_rows=CACHE_ROWS)
        opt = adagrad(0.01)
        dense = {"bottom": params["bottom"], "top": params["top"]}
        state = steps.cached_dlrm_init_state(mc, opt, params)
        ms = mc.init_state(params["emb"]["mega"], capacity_sharding=(
            NamedSharding(mesh, ("data", None))))
        step = steps.build_cached_train_step(setup["cfg"], mc, opt,
                                             mesh=mesh)
        losses, bs = [], setup["batches"]
        for t, b in enumerate(bs):
            nxt = bs[t + 1] if t + 1 < len(bs) else None
            dense, state, m = step(dense, state, ms, b, t, next_batch=nxt)
            losses.append(float(m["loss"]))
        want = _single_controller(setup, 1, False, 1)
        assert losses == want["losses"]
        assert torch.equal(ms.capacity, want["mega"])
        assert torch.equal(ms.cap_accum, want["accum"])
        assert mesh.stats["skipped_calls"] > 0
        assert all(mesh.stats[f"{op}_calls"] == 0
                   for op in tmesh.COLLECTIVES)
        # the eval lookup under the mesh: the uncached collection's pools
        idx = bs[0]["idx"]
        want_pool = EmbeddingBagCollection.build(
            setup["cfg"], strategy="replicated").lookup(
            {"mega": want["mega"]}, torch.from_numpy(idx))
        assert torch.equal(mc.lookup(ms, idx), want_pool)
        other = tmesh.make_host_mesh(1)
        with pytest.raises(ValueError, match="mesh"):
            steps.build_cached_train_step(setup["cfg"], mc, opt,
                                          mesh=other)(dense, state, ms,
                                                      bs[0], 0)
    finally:
        dist.destroy_process_group()
