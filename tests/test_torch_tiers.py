"""The N-tier embedding memory (`repro_torch.core.tiers`) against the
reference's `repro.core.tiers` on the CPU, at the smoke dlrm-m1 (a table
of a few thousand rows, batch 8). Inputs come from numpy seeds, parameters
from the reference (`convert.params_from_jax`); both sides see the same
batches.

Tolerances, each with its reason:
  * every integer counter (`TierCacheStats`: dram and bulk hits,
    demotions, promotion and demotion bytes, block counts), the slot-space
    remaps and the residency masks: exactly equal to the reference's (the
    same host planner on the same accesses);
  * capacity and accumulators moved without training (lookups): bit-equal
    to the reference's; after training, inside the port, three tiers vs
    two tiers vs the dense oracle: bit-equal (the same update sees the
    same values in the same order); against the reference's trained
    values: STEP_TOL of tests/test_torch_train.py (fp32 sums in other
    orders);
  * the traffic models: equal to the reference's to 1e-12 relative (the
    same float64 arithmetic).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import HAS_HYPOTHESIS, requires_hypothesis

from repro.configs import get_smoke_config as jget_smoke
from repro.core import tiers as jtiers
from repro.core.cache import CachedEmbeddingBagCollection as JCached
from repro.core.dlrm import dlrm_param_specs as jspecs
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.kernels import ops as jops
from repro.launch import analysis as janalysis
from repro.nn.params import init_params as jinit
from repro.optim import adagrad as jadagrad
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.cache import (CachedEmbeddingBagCollection,
                                    CacheStats,
                                    MultiHostCachedEmbeddingBagCollection)
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.core.hostmem import is_page_locked
from repro_torch.core.tiers import (AsyncCachedTier, BulkCacheState,
                                    BulkCachedEmbeddingBagCollection,
                                    BulkStore, EmbeddingTier, TierCacheStats,
                                    tier_conformance)
from repro_torch.data.synthetic import make_dlrm_batch
from repro_torch.kernels import ops
from repro_torch.launch import analysis
from repro_torch.optim import adagrad
from repro_torch.train import steps

if HAS_HYPOTHESIS:
    from hypothesis import given, settings
    from hypothesis import strategies as st

STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
BATCH = 8
BULK = dict(cache_rows=256, dram_rows=300, bulk_chunk=16,
            bulk_latency_us=0.0)


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    jebc = JEBC.build(jcfg, n_shards=1, strategy="replicated")
    host = jax.tree.map(np.asarray, jinit(jspecs(jcfg, jebc),
                                          jax.random.PRNGKey(0)))
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    return cfg, jcfg, ebc, host


def _bulk(cfg, **kw):
    return BulkCachedEmbeddingBagCollection.build(cfg, **{**BULK, **kw})


def _jbulk(jcfg, **kw):
    return jtiers.BulkCachedEmbeddingBagCollection.build(jcfg,
                                                         **{**BULK, **kw})


def _batch(cfg, ebc, t):
    raw = make_dlrm_batch(cfg, BATCH, step=t)
    return {"dense": raw["dense"], "idx": ebc.offset_indices(raw["idx"]),
            "label": raw["label"]}


def _mega(host):
    return torch.from_numpy(np.array(host["emb"]["mega"], copy=True))


def _assert_same_tiers(bc, state, jbc, jstate):
    """Counters, residency masks and slot maps equal to the reference's."""
    assert dataclasses.asdict(state.stats) == \
        dataclasses.asdict(jstate.stats)
    mine, theirs = bc.tier_residency(state), jbc.tier_residency(jstate)
    for k in ("hbm", "dram", "bulk"):
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    np.testing.assert_array_equal(state.row_slot, jstate.row_slot)
    np.testing.assert_array_equal(state.dram_resident, jstate.dram_resident)


# ---------------------------------------------------------------------------
# the protocol and the counters
# ---------------------------------------------------------------------------


def test_every_tier_of_the_port_conforms(setup):
    cfg = setup[0]
    sync = CachedEmbeddingBagCollection.build(cfg, cache_rows=256)
    bulk = _bulk(cfg)
    multihost = MultiHostCachedEmbeddingBagCollection.build(
        cfg, n_hosts=2, cache_rows=256)
    for t in (sync, AsyncCachedTier(sync), multihost, bulk,
              AsyncCachedTier(bulk)):
        assert tier_conformance(t), type(t).__name__
        assert isinstance(t, EmbeddingTier)
        assert callable(steps.build_cached_train_step(cfg, t, adagrad(0.01)))
    assert not tier_conformance(object())
    assert not tier_conformance(sync.ebc)


def test_factory_rejects_a_non_tier_naming_the_protocol(setup):
    cfg, _, ebc, _ = setup
    with pytest.raises(TypeError, match="EmbeddingTier") as e:
        steps.build_cached_train_step(cfg, object(), adagrad(0.01))
    assert "tier_conformance" in str(e.value)
    with pytest.raises(TypeError, match="EmbeddingTier"):
        steps.build_cached_train_step(cfg, ebc, adagrad(0.01))
    assert callable(steps.build_cached_train_step(cfg, _bulk(cfg),
                                                  adagrad(0.01)))


def test_tier_stats_snapshot_and_reset_equal_the_reference():
    kw = dict(hits=5, misses=3, dram_hits=2, bulk_hits=1,
              promotion_bytes=640, bulk_sched_us=100, bulk_wait_us=25)
    s, js = TierCacheStats(**kw), jtiers.TierCacheStats(**kw)
    assert s.snapshot() == js.snapshot()
    assert s.snapshot()["tier_hit_dram"] == 2
    assert s.dram_hit_rate == pytest.approx(2 / 3)
    assert s.hidden_fraction == pytest.approx(0.75)
    assert [f.name for f in dataclasses.fields(s)] == \
        [f.name for f in dataclasses.fields(js)]
    s.reset()
    assert all(getattr(s, f.name) == 0 for f in dataclasses.fields(s))
    assert s.hidden_fraction == 1.0 and s.dram_hit_rate == 0.0
    b = CacheStats(hits=7, fetch_chunks=2)
    b.reset()
    assert b.hits == b.fetch_chunks == 0


def test_placement_equals_the_reference(setup):
    cfg, jcfg = setup[0], setup[1]
    for kw in ({}, {"dram_rows": 0}, {"bulk_path": "x.npy"}):
        bc, jbc = _bulk(cfg, **kw), _jbulk(jcfg, **kw)
        assert bc.placement() == jbc.placement()
        assert AsyncCachedTier(bc).placement() == \
            jtiers.AsyncCachedTier(jbc).placement()
    assert CachedEmbeddingBagCollection.build(cfg, cache_rows=256) \
        .placement()["levels"] == JCached.build(jcfg, cache_rows=256) \
        .placement()["levels"]


# ---------------------------------------------------------------------------
# placement of the capacity tier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sync", "async", "bulk"])
def test_pageable_host_capacity_under_a_cuda_device_tier_raises(setup, kind):
    """The kernels cannot reach pageable host memory: ValueError, raised
    before anything is allocated (a CUDA allocation here, where torch has
    no CUDA, would raise something else)."""
    cfg = setup[0]
    cc = (_bulk(cfg) if kind == "bulk" else
          CachedEmbeddingBagCollection.build(cfg, cache_rows=256))
    r, d = cc.ebc.plan.total_rows, cfg.embed_dim
    mega = torch.zeros((r, d))
    assert not is_page_locked(mega)
    init = cc.init_async_state if kind == "async" else cc.init_state
    with pytest.raises(ValueError, match="mega is pageable host memory"):
        init(mega, device=torch.device("cuda"))
    with pytest.raises(ValueError, match="mega is pageable host memory"):
        init(mega, torch.zeros((r,)), device="cuda")
    with pytest.raises(ValueError, match="under a device tier on cpu"):
        init(torch.zeros((r, d), device="meta"), device="cpu")


def test_device_none_keeps_every_tier_on_megas_device(setup):
    cfg = setup[0]
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=64)
    r = cc.ebc.plan.total_rows
    st = cc.init_state(torch.zeros((r, cfg.embed_dim)), device="cpu")
    assert st.cache.device.type == st.freq.device.type == "cpu"
    assert st.cap_accum.device.type == "cpu" and st.capacity_event is None
    with pytest.raises(ValueError, match="mega has"):
        cc.init_state(torch.zeros((r + 1, cfg.embed_dim)))


# ---------------------------------------------------------------------------
# bit-exactness: the dense oracle, two tiers, the reference
# ---------------------------------------------------------------------------


def test_three_tier_roundtrip_matches_dense_oracle_and_reference(setup):
    """Updates streamed through evictions, DRAM overflow demotions and
    bulk promotions materialize to the dense update's table bit for bit,
    with the reference's counters and residency at every step."""
    cfg, jcfg, ebc, host = setup
    lr, n = 0.05, 5
    kw = dict(cache_rows=160, dram_rows=100)     # DRAM overflows
    bc, jbc = _bulk(cfg, **kw), _jbulk(jcfg, **kw)
    state = bc.init_state(_mega(host))
    jstate = jbc.init_state(jnp.asarray(host["emb"]["mega"]))
    mega_ref = _mega(host)
    accum_ref = torch.zeros((ebc.plan.total_rows,))
    rng = np.random.RandomState(0)
    for t in range(n):
        idx = _batch(cfg, ebc, t)["idx"]
        g = rng.randn(*idx.shape[:2], cfg.embed_dim).astype(np.float32)
        local = bc.take(state, idx, train=True)
        fi, fg = ebc.per_lookup_grads(torch.as_tensor(local),
                                      torch.from_numpy(g))
        bc.mark_updated(state, *ops.rowwise_adagrad_update(
            state.cache, state.cache_accum, fi, fg, lr))
        fi, fg = ebc.per_lookup_grads(torch.as_tensor(idx),
                                      torch.from_numpy(g))
        mega_ref, accum_ref = ops.rowwise_adagrad_update(
            mega_ref, accum_ref, fi, fg, lr)
        jlocal = jbc.take(jstate, idx, train=True)
        jfi, jfg = jbc.ebc.per_lookup_grads(jnp.asarray(jlocal),
                                            jnp.asarray(g))
        jbc.mark_updated(jstate, *jops.rowwise_adagrad_update(
            jstate.cache, jstate.cache_accum, jfi, jfg, lr))
        np.testing.assert_array_equal(local, np.asarray(jlocal))
        _assert_same_tiers(bc, state, jbc, jstate)
    assert state.stats.bulk_hits > 0 and state.stats.demotions > 0
    mega_c, accum_c = bc.materialize(state)
    assert torch.equal(mega_c, mega_ref) and torch.equal(accum_c, accum_ref)
    jm, ja = jbc.materialize(jstate)
    _assert_same_tiers(bc, state, jbc, jstate)
    np.testing.assert_allclose(mega_c.numpy(), np.asarray(jm), **STEP_TOL)
    np.testing.assert_allclose(accum_c.numpy(), np.asarray(ja), **STEP_TOL)


def _train(cfg, ebc, host, col, mode, n=4, jax_side=False):
    """`n` steps of the factory's step over `col` (port or reference) in
    `mode`; returns (losses, mega, accum, tier state)."""
    is_async = mode != "sync"
    if jax_side:
        tier = jtiers.AsyncCachedTier(col) if is_async else col
        params = jax.tree.map(jnp.asarray, host)
        opt = jadagrad(0.01)
        cstate = jsteps.cached_dlrm_init_state(col, opt, params)
        build = jsteps.build_cached_train_step
    else:
        tier = AsyncCachedTier(col) if is_async else col
        params = params_from_jax(host, device="cpu")
        opt = adagrad(0.01)
        cstate = steps.cached_dlrm_init_state(col, opt, params)
        build = steps.build_cached_train_step
    dense = {"bottom": params["bottom"], "top": params["top"]}
    tstate = tier.init_state(params["emb"]["mega"])
    step = build(cfg, tier, opt, strict_sync=(mode == "strict"))

    def conv(b):
        if not jax_side:
            return b
        return {k: (v if k == "idx" else jnp.asarray(v)) for k, v in
                b.items()}

    losses = []
    for t in range(n):
        nxt = conv(_batch(cfg, ebc, t + 1)) if is_async and t + 1 < n \
            else None
        kw = {"next_batch": nxt} if is_async else {}
        dense, cstate, m = step(dense, cstate, tstate,
                                conv(_batch(cfg, ebc, t)),
                                jnp.asarray(t, jnp.int32) if jax_side else t,
                                **kw)
        losses.append(float(m["loss"]))
    mega, accum = tier.materialize(tstate)
    return losses, np.array(mega), np.array(accum), tstate


@pytest.mark.parametrize("mode", ["sync", "async", "strict"])
def test_three_tier_train_matches_two_tier_and_reference(setup, mode):
    """The factory's three-tier step (budgeted DRAM, live bulk traffic)
    is bit-equal to the two-tier step; with dram_rows=0 the bulk tier
    switches off and books no bulk traffic; the counters and residency
    equal the reference's three-tier run, its numbers within STEP_TOL."""
    cfg, jcfg, ebc, host = setup
    two_l, two_m, two_a, _ = _train(
        cfg, ebc, host,
        CachedEmbeddingBagCollection.build(cfg, cache_rows=256), mode)
    bc = _bulk(cfg)
    got_l, got_m, got_a, st = _train(cfg, ebc, host, bc, mode)
    assert got_l == two_l
    assert st.stats.bulk_hits > 0
    np.testing.assert_array_equal(got_m.view(np.int32), two_m.view(np.int32))
    np.testing.assert_array_equal(got_a.view(np.int32), two_a.view(np.int32))
    off_l, off_m, _, off = _train(cfg, ebc, host, _bulk(cfg, dram_rows=0),
                                  mode)
    assert off_l == two_l
    np.testing.assert_array_equal(off_m.view(np.int32), two_m.view(np.int32))
    s = off.stats
    assert s.bulk_hits == s.demotions == s.promotion_bytes == 0
    assert s.bulk_read_chunks == s.bulk_write_chunks == 0
    jbc = _jbulk(jcfg)
    j_l, j_m, j_a, jst = _train(jcfg, ebc, host, jbc, mode, jax_side=True)
    _assert_same_tiers(bc, st, jbc, jst)
    np.testing.assert_allclose(got_l, j_l, **STEP_TOL)
    np.testing.assert_allclose(got_m, j_m, **STEP_TOL)
    np.testing.assert_allclose(got_a, j_a, **STEP_TOL)


def test_mmap_backed_bulk_store_roundtrips(setup, tmp_path):
    """`bulk_path` puts the bulk payload in a memory-mapped .npy file with
    no change in numbers against the RAM store and the reference."""
    cfg, jcfg, ebc, host = setup
    mem, dsk = _bulk(cfg), _bulk(cfg, bulk_path=str(tmp_path / "bulk.npy"))
    s_mem, s_dsk = mem.init_state(_mega(host)), dsk.init_state(_mega(host))
    jbc = _jbulk(jcfg)
    jst = jbc.init_state(jnp.asarray(host["emb"]["mega"]))
    assert isinstance(s_dsk.bulk.values, np.memmap)
    assert (tmp_path / "bulk.npy").exists()
    assert (tmp_path / "bulk.npy.accum.npy").exists()
    for t in range(3):
        idx = _batch(cfg, ebc, t)["idx"]
        a = mem.lookup(s_mem, idx, train=False)
        b = dsk.lookup(s_dsk, idx, train=False)
        c = jbc.lookup(jst, idx, train=False)
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **STEP_TOL)
    assert s_dsk.stats.bulk_hits == s_mem.stats.bulk_hits > 0
    _assert_same_tiers(dsk, s_dsk, jbc, jst)
    # a second store over the same file reads what the first wrote
    back = np.load(tmp_path / "bulk.npy", mmap_mode="r")
    rows = np.flatnonzero(dsk.tier_residency(s_dsk)["bulk"])
    np.testing.assert_array_equal(back[rows], s_dsk.capacity.numpy()[rows])


def test_bulk_store_blocks_latency_and_seed():
    stats = TierCacheStats()
    bs = BulkStore.build(100, 4, chunk=8, latency_us=0.0)
    vals = np.arange(400, dtype=np.float32).reshape(100, 4)
    bs.seed(np.arange(100), vals, np.arange(100, dtype=np.float32))
    np.testing.assert_array_equal(bs.values, vals)
    got, acc = bs.read(np.array([0, 1, 2, 50, 99]), stats)
    np.testing.assert_array_equal(got, vals[[0, 1, 2, 50, 99]])
    jstats = jtiers.TierCacheStats()
    jbs = jtiers.BulkStore.build(100, 4, chunk=8, latency_us=0.0)
    jbs.read(np.array([0, 1, 2, 50, 99]), jstats)
    bs.write(np.array([3, 4, 60]), vals[:3], acc[:3], stats)
    jbs.write(np.array([3, 4, 60]), vals[:3], acc[:3], jstats)
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    np.testing.assert_array_equal(bs.values[[3, 4, 60]], vals[:3])
    assert bs.row_bytes == jbs.row_bytes == 20
    assert BulkStore.build(0, 4, 8, 1.0, path="unused").path is None


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flavour", ["sync", "async"])
def test_bulk_state_dict_roundtrip_reseeds_bit_equal(setup, flavour):
    cfg, _, ebc, host = setup
    bc = _bulk(cfg)
    tier = AsyncCachedTier(bc) if flavour == "async" else bc
    st = tier.init_state(_mega(host))
    for t in range(3):
        tier.take(st, _batch(cfg, ebc, t)["idx"], train=True)
        if flavour == "async":
            tier.stage(st, _batch(cfg, ebc, t + 1)["idx"], train=True)
    snap = tier.state_dict(st)
    assert set(snap) >= {"dram_resident", "capacity", "stats"}
    back = tier.load_state_dict(
        {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in snap.items()}, device="cpu")
    assert type(back).__name__ == type(st).__name__
    assert isinstance(back.stats, TierCacheStats) and back.stats == st.stats
    np.testing.assert_array_equal(back.dram_resident, st.dram_resident)
    rows = np.flatnonzero(bc.tier_residency(back)["bulk"])
    np.testing.assert_array_equal(back.bulk.values[rows],
                                  st.bulk.values[rows])
    np.testing.assert_array_equal(back.bulk.accum[rows], st.bulk.accum[rows])
    assert torch.equal(back.capacity, st.capacity)


# ---------------------------------------------------------------------------
# property: residency is exclusive under any interleaving
# ---------------------------------------------------------------------------


def _assert_residency_invariants(bc, state):
    masks = bc.tier_residency(state)
    hbm, dram, bulk = masks["hbm"], masks["dram"], masks["bulk"]
    assert not (hbm & dram).any() and not (hbm & bulk).any()
    assert not (dram & bulk).any()
    assert int(hbm.sum() + dram.sum() + bulk.sum()) == len(hbm)
    assert state.dram_occupancy <= bc._dram_cap()
    rows = np.flatnonzero(bulk)
    if len(rows):
        np.testing.assert_array_equal(state.bulk.values[rows],
                                      state.capacity.numpy()[rows])


def _residency_trip(setup, seed, dram_rows):
    cfg, jcfg, ebc, host = setup
    bc, jbc = _bulk(cfg, dram_rows=dram_rows), _jbulk(jcfg,
                                                      dram_rows=dram_rows)
    state = bc.init_state(_mega(host))
    jstate = jbc.init_state(jnp.asarray(host["emb"]["mega"]))
    assert isinstance(state, BulkCacheState)
    for t in range(4):
        idx = _batch(cfg, ebc, seed * 31 + t)["idx"]
        bc.lookup(state, idx, train=True)
        jbc.lookup(jstate, idx, train=True)
        _assert_residency_invariants(bc, state)
        _assert_same_tiers(bc, state, jbc, jstate)
    mega, accum = bc.materialize(state)
    jm, ja = jbc.materialize(jstate)
    # nothing trained: every bit moved through the tiers unchanged
    np.testing.assert_array_equal(mega.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(mega.numpy(), host["emb"]["mega"])
    np.testing.assert_array_equal(accum.numpy(), np.asarray(ja))
    _assert_residency_invariants(bc, state)


def test_residency_exclusive_after_promotion_demotion(setup):
    _residency_trip(setup, seed=1, dram_rows=300)


if HAS_HYPOTHESIS:

    @requires_hypothesis
    @settings(max_examples=6, deadline=None)
    @given(seed=st.integers(0, 10 ** 6),
           dram_rows=st.sampled_from([0, 200, 400, 1000]))
    def test_residency_property_under_any_interleaving(setup, seed,
                                                       dram_rows):
        """No row in two tiers, DRAM within budget, bulk bits equal to
        capacity, counters and masks equal to the reference's, whatever
        interleaving of promotions and demotions the traffic induces."""
        _residency_trip(setup, seed, dram_rows)


# ---------------------------------------------------------------------------
# the traffic models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(fetched_rows=45_000.0, embed_dim=64, dram_hit_rate=0.3),
    dict(fetched_rows=1000.0, embed_dim=128, dram_hit_rate=1.0,
         bulk_chunk=8, bulk_latency_us=10.0, chunk_density=0.25),
    dict(fetched_rows=777.0, embed_dim=5, dram_hit_rate=0.0,
         demotion_rows=12.0, dram_latency_us=2.0),
    dict(fetched_rows=0.0, embed_dim=64, dram_hit_rate=0.5)])
def test_tier_hierarchy_traffic_equals_the_reference(kw):
    got = analysis.tier_hierarchy_traffic(**kw)
    want = janalysis.tier_hierarchy_traffic(**kw)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


@pytest.mark.parametrize("kw", [
    dict(fetched_rows=45_000.0, embed_dim=64),
    dict(fetched_rows=45_000.0, embed_dim=64, fetch_chunks=5_000.0,
         overfetch_rows=3_000.0),
    dict(fetched_rows=0.0, embed_dim=8, fetch_chunks=0.0)])
def test_cache_admission_traffic_equals_the_reference(kw):
    got = analysis.cache_admission_traffic(**kw)
    want = janalysis.cache_admission_traffic(**kw)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
