"""The multi-host cached tier (`MultiHostCachedEmbeddingBagCollection`,
its routed train step, `split_plan_by_host`, the hooks' `n_hosts` and
`row_remap`, `multihost_exchange_traffic`) against the reference, on the
CPU, at the sizes of tests/test_cache_multihost.py and tests/test_tiers.py:
smoke dlrm-m1, batches of 8 and 16, 2 and 4 hosts, 32 to 512 slots a host.
Inputs come from numpy seeds; parameters from the reference
(`convert.params_from_jax`).

Tolerances, each with its reason:
  * plans, sub-plans, every MultiHostStepPlan array, the host maps (slot
    maps, LFU scores `freq`, the EMA and its ticks), CacheStats and
    RouteStats: exactly equal (integers, and fp32 host arithmetic in the
    reference's operand order);
  * lookups and slab installs: bit-equal (rows are copied and pooled in
    the same order);
  * losses, dense parameters, the materialized capacity tier and
    accumulator against the reference's step: STEP_TOL of
    tests/test_torch_train.py (fp32 matmuls and sums in other orders);
  * inside the port (against `build_dlrm_train_step(sparse_apply=
    "sparse")`, the sync cached step at one host, strict_sync against the
    prefetch, hook plans against none): bit-equal.
The reference's 8-device mesh test is tests/test_torch_multihost_mesh.py's
gloo-rank cases; its split-by-owner and segment tests are in
tests/test_torch_tablewise.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_smoke_config as jget_smoke
from repro.core import cache as jcache
from repro.core.dlrm import dlrm_param_specs as jspecs
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.data import pipeline as jpipeline
from repro.kernels import sparse_plan as jsp
from repro.launch import analysis as janalysis
from repro.nn.params import init_params as jinit
from repro.optim import adagrad as jadagrad
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.cache import (CachedEmbeddingBagCollection,
                                    MultiHostCachedEmbeddingBagCollection)
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.core.placement import frequency_reorder
from repro_torch.data import pipeline
from repro_torch.data.synthetic import make_dlrm_batch
from repro_torch.kernels import sparse_plan
from repro_torch.launch.analysis import multihost_exchange_traffic
from repro_torch.optim import adagrad
from repro_torch.train import steps

STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
MAPS = ("freq", "slot_row", "row_slot", "ema", "ema_tick")
PLAN_FIELDS = [f.name for f in dataclasses.fields(
    jcache.MultiHostStepPlan)]

# ---------------------------------------------------------------------------
# the reference's splitting corpus
# ---------------------------------------------------------------------------


def _corpus():
    rng = np.random.RandomState(0)
    out = {
        "random": rng.randint(-1, 40, size=(16, 3, 5)).astype(np.int32),
        "all_dup": np.full((8, 2, 4), 7, np.int32),
        "all_pads": np.full((8, 2, 4), -1, np.int32),
        "zipfish": np.where(rng.rand(16, 2, 6) < 0.7,
                            rng.zipf(1.5, (16, 2, 6)) % 30,
                            -1).astype(np.int32),
    }
    hot = rng.randint(-1, 64, size=(16, 2, 4)).astype(np.int32)
    hot[:, 0, 0] = 3                       # one row on every host
    out["hot_everywhere"] = hot
    return out


def _live(plan):
    rows = np.asarray(plan.unique_rows)
    n = int((rows >= 0).sum())
    offs = np.asarray(plan.bag_offsets).astype(np.int64)
    return rows[:n], offs[:n + 1], np.asarray(plan.bag_ids)


def _pairs(plan):
    """Multiset of (row, bag) pairs a plan encodes (live prefix only)."""
    rows, offs, bags = _live(plan)
    return sorted((int(r), int(bags[p])) for i, r in enumerate(rows)
                  for p in range(offs[i], offs[i + 1]))


def _split_checks(idx, n_hosts):
    """The port's per-host split equals the reference's array for array
    and `build_sparse_plan_host` on each sub-batch on its live prefix; the
    sub-plans partition the global plan's (row, bag) pairs, each live
    prefix strictly ascending."""
    b, f, _ = idx.shape
    bh = b // n_hosts
    plan = sparse_plan.build_sparse_plan_host(idx)
    subs = sparse_plan.split_plan_by_host(plan, n_hosts, bh * f)
    jsubs = jsp.split_plan_by_host(jsp.build_sparse_plan_host(idx), n_hosts,
                                   bh * f)
    got = []
    for h, (sub, jsub) in enumerate(zip(subs, jsubs, strict=True)):
        for a, w in zip(sub, jsub, strict=True):
            assert a.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(a, np.asarray(w))
        want = sparse_plan.build_sparse_plan_host(idx[h * bh:(h + 1) * bh])
        n_valid = int(_live(want)[1][-1])
        np.testing.assert_array_equal(sub.unique_rows, want.unique_rows)
        np.testing.assert_array_equal(sub.bag_offsets, want.bag_offsets)
        np.testing.assert_array_equal(sub.bag_ids[:n_valid],
                                      want.bag_ids[:n_valid])
        assert np.all(np.diff(_live(sub)[0]) > 0)
        got += [(r, bag + h * bh * f) for r, bag in _pairs(sub)]
    assert sorted(got) == _pairs(plan)


@pytest.mark.parametrize("n_hosts", [1, 2, 4])
@pytest.mark.parametrize("name", list(_corpus()))
def test_split_by_host_matches_reference_and_subbatch_plans(name, n_hosts):
    _split_checks(_corpus()[name], n_hosts)


@settings(max_examples=30, deadline=None)
@given(b=st.sampled_from([4, 8, 16]), f=st.integers(1, 3),
       lk=st.integers(1, 5), rows=st.integers(1, 50),
       n_hosts=st.sampled_from([1, 2, 4]), seed=st.integers(0, 2**31 - 1))
def test_split_by_host_property(b, f, lk, rows, n_hosts, seed):
    idx = np.random.RandomState(seed).randint(
        -1, rows, size=(b, f, lk)).astype(np.int32)
    _split_checks(idx, n_hosts)

# ---------------------------------------------------------------------------
# the hooks' n_hosts and row_remap
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remap", [False, True], ids=["ids", "remap"])
@pytest.mark.parametrize("n_hosts", [None, 1, 2, 4])
def test_hooks_match_reference(n_hosts, remap):
    """sparse_plan_hook(n_hosts=, row_remap=) and dedup_indices_hook(
    row_remap=) attach the reference's arrays key for key;
    host_plans_from_batch reads the sub-plans back."""
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    offs = ebc.plan.table_offsets
    row_remap = None
    if remap:
        counts = np.random.RandomState(4).zipf(1.3, ebc.plan.total_rows)
        row_remap, _ = frequency_reorder(offs, cfg.hash_sizes, counts,
                                         ebc.plan.total_rows)
    raw = make_dlrm_batch(cfg, 16, step=2)
    hooks = [(pipeline.sparse_plan_hook(offs, n_hosts=n_hosts,
                                        row_remap=row_remap),
              jpipeline.sparse_plan_hook(offs, n_hosts=n_hosts,
                                         row_remap=row_remap)),
             (pipeline.dedup_indices_hook(offs, row_remap=row_remap),
              jpipeline.dedup_indices_hook(offs, row_remap=row_remap))]
    for hook, jhook in hooks:
        got, want = hook(dict(raw)), jhook(dict(raw))
        assert got.keys() == want.keys()
        for k in got:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    hooked = hooks[0][0](dict(raw))
    subs = sparse_plan.host_plans_from_batch(hooked)
    assert (subs is None) == (n_hosts is None or n_hosts == 1)
    if subs is not None:
        for sub, jsub in zip(subs, jsp.host_plans_from_batch(hooked),
                             strict=True):
            for a, w in zip(sub, jsub, strict=True):
                np.testing.assert_array_equal(a, w)

# ---------------------------------------------------------------------------
# the collection: planning, admission, installs, lookups
# ---------------------------------------------------------------------------


def _pair(n_hosts, cache_rows, **kw):
    """(port collection, reference collection, port state, reference
    state) over one seeded capacity tier."""
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    mc = MultiHostCachedEmbeddingBagCollection.build(
        cfg, n_hosts=n_hosts, cache_rows=cache_rows, **kw)
    jmc = jcache.MultiHostCachedEmbeddingBagCollection.build(
        jcfg, n_hosts=n_hosts, cache_rows=cache_rows, **kw)
    mega = np.random.RandomState(0).randn(
        mc.ebc.plan.total_rows, cfg.embed_dim).astype(np.float32)
    return (mc, jmc, mc.init_state(torch.from_numpy(mega.copy())),
            jmc.init_state(jnp.asarray(mega)))


def _assert_state_equal(s, js):
    for k in MAPS:
        got, want = getattr(s, k), np.asarray(getattr(js, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert s.tick == js.tick
    assert dataclasses.asdict(s.stats) == dataclasses.asdict(js.stats)
    assert dataclasses.asdict(s.route) == dataclasses.asdict(js.route)
    np.testing.assert_array_equal(s.caches.numpy(), np.asarray(js.caches))


def _idx(cfg, rng, b, hi):
    return rng.randint(-1, hi, size=(b, cfg.n_sparse_features, 4)).astype(
        np.int32)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("fetch_chunk", [1, 4])
@pytest.mark.parametrize("hook", [False, True], ids=["no_plan", "plan"])
def test_plan_step_matches_reference(train, fetch_chunk, hook):
    """Six planned batches of 16 over 4 hosts and 96 slots a host (so
    admissions evict): every MultiHostStepPlan array, the host maps, the
    caches after each install, CacheStats and RouteStats equal the
    reference's after every step."""
    mc, jmc, s, js = _pair(4, 96, fetch_chunk=fetch_chunk)
    cfg = mc.ebc.cfg
    rng = np.random.RandomState(1)
    for t in range(6):
        idx = _idx(cfg, rng, 16, 300 + 60 * t)
        kw = {}
        if hook:
            plan = sparse_plan.build_sparse_plan_host(idx)
            kw = {"global_plan": plan, "host_plans":
                  sparse_plan.split_plan_by_host(plan, 4, 4 * idx.shape[1])}
        splan = mc.plan_step(s, idx, train=train, **kw)
        jplan = jmc.plan_step(js, idx, train=train, **kw)
        for name in PLAN_FIELDS:
            got, want = getattr(splan, name), np.asarray(getattr(jplan,
                                                                  name))
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)
        mc.install_misses(s, splan)
        jmc.install_misses(js, jplan)
        _assert_state_equal(s, js)
    assert s.stats.evictions > 0 and s.route.fetch_remote > 0
    if train:
        assert s.route.invalidations > 0
    if fetch_chunk > 1:
        assert s.route.fetch_chunks > 0 and s.stats.overfetch_rows > 0


def test_lookup_matches_uncached_and_reference():
    mc, jmc, s, js = _pair(2, 256)
    mega = s.capacity.clone()
    cfg = mc.ebc.cfg
    rng = np.random.RandomState(1)
    for _ in range(3):
        idx = _idx(cfg, rng, 8, 200)
        got = mc.lookup(s, idx)
        want = mc.ebc.lookup({"mega": mega}, torch.from_numpy(idx))
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jmc.lookup(js, idx)))
        _assert_state_equal(s, js)
    assert s.stats.hits > 0 and s.stats.misses > 0
    assert s.stats.writebacks == 0              # clean caches never flush
    assert s.route.snapshot() == js.route.snapshot()
    s.route.reset()
    assert not any(dataclasses.asdict(s.route).values())


def test_clean_eviction_keeps_maps_a_bijection():
    mc, jmc, s, js = _pair(2, 32)
    cfg = mc.ebc.cfg
    rng = np.random.RandomState(2)
    for t in range(6):                           # churn through 32 slots
        idx = rng.randint(t * 20, t * 20 + 24,
                          size=(4, cfg.n_sparse_features, 4)).astype(
                              np.int32)
        mc.lookup(s, idx)
        jmc.lookup(js, idx)
    _assert_state_equal(s, js)
    assert s.stats.evictions > 0 and s.stats.writebacks == 0
    for h in range(2):
        resident = np.flatnonzero(s.slot_row[h] >= 0)
        np.testing.assert_array_equal(s.row_slot[h, s.slot_row[h, resident]],
                                      resident)


def test_thrash_guard_and_batch_split_raise():
    mc, _, s, _ = _pair(2, 8)
    f = mc.ebc.cfg.n_sparse_features
    idx = np.arange(2 * f * 16).reshape(2, f, 16).astype(np.int32)
    with pytest.raises(ValueError, match="cache thrash|unique rows"):
        mc.plan_step(s, np.concatenate([idx, idx], axis=0))
    with pytest.raises(ValueError, match="does not split"):
        mc.plan_step(s, idx[:1])


@pytest.mark.parametrize("gate", [False, True])
def test_prefetch_admits_and_hits_like_the_reference(gate):
    mc, jmc, s, js = _pair(2, 96)
    cfg = mc.ebc.cfg
    rng = np.random.RandomState(3)
    for t in range(4):
        idx = _idx(cfg, rng, 8, 60 + 40 * t)
        n = mc.prefetch(s, idx, gate=gate)
        assert n == jmc.prefetch(js, idx, gate=gate)
        _assert_state_equal(s, js)
        m0 = s.stats.misses
        mc.plan_step(s, idx, train=False)
        jmc.plan_step(js, idx, train=False)
        if t == 0:
            assert n > 0 and s.stats.misses == m0   # all prefetched
        _assert_state_equal(s, js)
    assert s.stats.prefetched > 0 and s.stats.evictions > 0


def test_fill_slabs_drops_pads_like_the_reference():
    mc, jmc, s, js = _pair(2, 16)
    rows = np.asarray([[5, 9, 2, -1, -1], [7, -1, -1, -1, -1]], np.int32)
    slots = np.asarray([[3, 0, 15, -1, -1], [15, -1, -1, -1, -1]], np.int32)
    got = mc.fill_slabs(s.caches, s.capacity, rows, slots)
    want = jmc.fill_slabs(js.caches, js.capacity, rows, slots)
    assert got is s.caches                       # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 1].abs().sum() == 0            # an untouched slot


def test_init_state_takes_a_full_height_table_and_pads_a_short_one():
    cfg = get_smoke_config("dlrm-m1")
    mc = MultiHostCachedEmbeddingBagCollection.build(cfg, n_hosts=4,
                                                     cache_rows=64)
    total, d = mc.ebc.plan.total_rows, cfg.embed_dim
    mega = torch.randn(total, d)
    accum = torch.rand(total)
    s = mc.init_state(mega, accum)
    assert s.capacity is mega and s.cap_accum is accum
    r = EmbeddingBagCollection.build(cfg, strategy="replicated").plan.\
        total_rows
    assert r < total                             # the smoke layout pads
    s = mc.init_state(mega[:r].clone())
    assert s.capacity.shape == (total, d) and s.cap_accum.shape == (total,)
    assert torch.equal(s.capacity[:r], mega[:r])
    assert not s.capacity[r:].any() and not s.cap_accum.any()
    assert s.caches.shape == (4, 64, d) and s.row_slot.shape == (4, total)
    with pytest.raises(ValueError, match="rows"):
        mc.init_state(torch.zeros(total + 1, d))
    assert mc.placement()["stream"] == "multihost"
    assert mc.shard_rows * 4 == total

# ---------------------------------------------------------------------------
# the routed train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    jebc = JEBC.build(jcfg, n_shards=1, strategy="replicated")
    host = jax.tree.map(np.asarray, jinit(jspecs(jcfg, jebc),
                                          jax.random.PRNGKey(0)))
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    return cfg, jcfg, ebc, host


def _batches(cfg, ebc, n=4, b=16, plant_hot=True, n_hosts=None):
    """The reference's step corpus: n batches of b, one hot row planted in
    every host's slice when `plant_hot`; through
    `sparse_plan_hook(n_hosts=...)` when `n_hosts`."""
    out = []
    for t in range(n):
        raw = make_dlrm_batch(cfg, b, step=t)
        if n_hosts is not None:
            out.append(pipeline.sparse_plan_hook(ebc.plan.table_offsets,
                                                 n_hosts=n_hosts)(raw))
            continue
        idx = ebc.offset_indices(raw["idx"])
        if plant_hot:
            idx[:, 0, 0] = int(idx[idx >= 0][0])     # cached on every host
        out.append({"dense": raw["dense"], "idx": idx,
                    "label": raw["label"]})
    return out


def _run_port(cfg, host, batches, n_hosts, cache_rows=512,
              strict_sync=False, fetch_chunk=None):
    params = params_from_jax(host, device="cpu")
    mc = MultiHostCachedEmbeddingBagCollection.build(
        cfg, n_hosts=n_hosts, cache_rows=cache_rows)
    opt = adagrad(0.01)
    dense = {"bottom": params["bottom"], "top": params["top"]}
    state = steps.cached_dlrm_init_state(mc, opt, params)
    ms = mc.init_state(params["emb"]["mega"])
    step = steps.build_cached_train_step(cfg, mc, opt,
                                         strict_sync=strict_sync,
                                         fetch_chunk=fetch_chunk)
    losses, maps = [], []
    for t, b in enumerate(batches):
        nxt = batches[t + 1] if t + 1 < len(batches) else None
        dense, state, m = step(dense, state, ms, b, t, next_batch=nxt)
        losses.append(float(m["loss"]))
        maps.append({k: getattr(ms, k).copy() for k in MAPS})
        assert m["lookups"] == float(np.count_nonzero(b["idx"] >= 0))
        assert m["route_dup_rows"] == ms.route.dup_rows
    mega, accum = mc.materialize(ms)
    return losses, dense, mega, accum, ms, maps


def _run_ref(jcfg, host, batches, n_hosts, cache_rows=512,
             strict_sync=False, fetch_chunk=None):
    jp = jax.tree.map(jnp.asarray, host)
    jmc = jcache.MultiHostCachedEmbeddingBagCollection.build(
        jcfg, n_hosts=n_hosts, cache_rows=cache_rows)
    opt = jadagrad(0.01)
    dense = {"bottom": jp["bottom"], "top": jp["top"]}
    state = jsteps.cached_dlrm_init_state(jmc, opt, jp)
    ms = jmc.init_state(jp["emb"]["mega"])
    step = jsteps.build_cached_train_step(jcfg, jmc, opt,
                                          strict_sync=strict_sync,
                                          fetch_chunk=fetch_chunk)
    losses, maps = [], []
    for t, b in enumerate(batches):
        nxt = batches[t + 1] if t + 1 < len(batches) else None
        jb = {k: (jnp.asarray(v) if k in ("dense", "label") else v)
              for k, v in b.items()}
        dense, state, m = step(dense, state, ms, jb,
                               jnp.asarray(t, jnp.int32), next_batch=nxt)
        losses.append(float(m["loss"]))
        maps.append({k: np.asarray(getattr(ms, k)).copy() for k in MAPS})
    mega, accum = jmc.materialize(ms)
    return losses, dense, np.asarray(mega), np.asarray(accum), ms, maps


@pytest.mark.parametrize("case", ["hot", "hot_strict", "hook_plans",
                                  "chunked"])
def test_multihost_step_matches_reference(setup, case):
    """4 hosts, 4 steps of 16: host maps after every step, CacheStats and
    RouteStats exactly; losses, dense parameters, capacity and
    accumulator within STEP_TOL."""
    cfg, jcfg, ebc, host = setup
    batches = _batches(cfg, ebc, n_hosts=4 if case == "hook_plans" else None)
    kw = {"strict_sync": case == "hot_strict",
          "fetch_chunk": 4 if case == "chunked" else None}
    got = _run_port(cfg, host, batches, 4, **kw)
    want = _run_ref(jcfg, host, batches, 4, **kw)
    for m, jm in zip(got[5], want[5], strict=True):
        for k in MAPS:
            np.testing.assert_array_equal(m[k], jm[k], err_msg=k)
    assert dataclasses.asdict(got[4].stats) == \
        dataclasses.asdict(want[4].stats)
    assert dataclasses.asdict(got[4].route) == \
        dataclasses.asdict(want[4].route)
    np.testing.assert_allclose(got[0], want[0], **STEP_TOL)
    np.testing.assert_allclose(got[2].numpy(), want[2], **STEP_TOL)
    np.testing.assert_allclose(got[3].numpy(), want[3], **STEP_TOL)
    for part in ("bottom", "top"):
        for a, b in zip(jax.tree.leaves(want[1][part]), jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(), got[1][part]))):
            np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL)
    if case == "chunked":
        assert got[4].route.fetch_chunks > 0


def _uncached(cfg, host, batches):
    params = params_from_jax(host, device="cpu")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    opt = adagrad(0.01)
    state = steps.dlrm_init_state(ebc, opt, params)
    step = steps.build_dlrm_train_step(cfg, ebc, opt, sparse_apply="sparse")
    losses = []
    for t, b in enumerate(batches):
        tb = {k: torch.as_tensor(b[k]) for k in ("dense", "idx", "label")}
        params, state, m = step(params, state, tb, t)
        losses.append(float(m["loss"]))
    return losses, params, state["accum"]


def _assert_bit_equal(run, losses, dense, mega, accum):
    r = mega.shape[0]
    assert run[0] == losses
    assert torch.equal(run[2][:r], mega) and torch.equal(run[3][:r], accum)
    for part in ("bottom", "top"):
        for a, b in zip(run[1][part], dense[part]):
            assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("strict_sync", [False, True])
def test_multihost_step_bit_equal_to_the_uncached_step(setup, strict_sync):
    """The hot row cached on every host: its gradients reduce once at the
    owner and every stale copy is refreshed or invalidated in time, so the
    run equals `build_dlrm_train_step(sparse_apply="sparse")` bit for bit,
    with the prefetch and without it."""
    cfg, _, ebc, host = setup
    batches = _batches(cfg, ebc)
    losses, params, accum = _uncached(cfg, host, batches)
    run = _run_port(cfg, host, batches, 4, strict_sync=strict_sync)
    _assert_bit_equal(run, losses, params, params["emb"]["mega"], accum)
    route = run[4].route
    assert route.dup_rows > 0 and route.fetch_remote > 0
    assert route.grad_pairs_remote > 0
    assert (run[4].stats.prefetched > 0) != strict_sync


def test_hook_plans_bit_equal_to_planning_in_the_step(setup):
    cfg, _, ebc, host = setup
    hooked = _batches(cfg, ebc, n=3, n_hosts=4)
    assert sparse_plan.host_plans_from_batch(hooked[0]) is not None
    plain = [{k: b[k] for k in ("dense", "idx", "label")} for b in hooked]
    want = _run_port(cfg, host, plain, 4, strict_sync=True)
    got = _run_port(cfg, host, hooked, 4, strict_sync=True)
    assert got[0] == want[0]
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    for m, w in zip(got[5], want[5], strict=True):
        for k in MAPS:
            np.testing.assert_array_equal(m[k], w[k])


def test_one_host_bit_equal_to_the_sync_cached_step(setup):
    """On one host the tier is the single-host cached path: the same
    losses, dense parameters, capacity and accumulator bits, and no
    cross-host traffic."""
    cfg, _, ebc, host = setup
    batches = _batches(cfg, ebc, plant_hot=False)
    params = params_from_jax(host, device="cpu")
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=512)
    opt = adagrad(0.01)
    dense = {"bottom": params["bottom"], "top": params["top"]}
    state = steps.cached_dlrm_init_state(cc, opt, params)
    cs = cc.init_state(params["emb"]["mega"])
    step = steps.build_cached_train_step(cfg, cc, opt)
    losses = []
    for t, b in enumerate(batches):
        dense, state, m = step(dense, state, cs, b, t)
        losses.append(float(m["loss"]))
    mega, accum = cc.materialize(cs)
    run = _run_port(cfg, host, batches, 1, strict_sync=True)
    _assert_bit_equal(run, losses, dense, mega, accum)
    assert run[4].route.fetch_remote == run[4].route.refresh_remote == 0


def test_invalidation_keeps_copies_coherent(setup):
    """A row cached on host 1 but updated by host 0 alone is invalidated
    (counted) and re-fetched fresh on host 1's next touch; the capacity
    tier equals the uncached step's bit for bit."""
    cfg, _, _, host = setup
    f, lk, row = cfg.n_sparse_features, 4, 5
    rng = np.random.RandomState(0)
    dense_x = rng.randn(4, cfg.n_dense_features).astype(np.float32)
    label = (rng.rand(4) > 0.5).astype(np.float32)

    def batch(idx):
        return {"dense": dense_x, "idx": idx, "label": label}

    both = np.full((4, f, lk), -1, np.int32)
    both[:, 0, 0] = row                          # both hosts touch the row
    only0 = np.full((4, f, lk), -1, np.int32)
    only0[:2, 0, 0] = row                        # host 0 only
    only0[2:, 0, 1] = 8                          # host 1 touches another row
    params = params_from_jax(host, device="cpu")
    mc = MultiHostCachedEmbeddingBagCollection.build(cfg, n_hosts=2,
                                                     cache_rows=64)
    opt = adagrad(0.01)
    dense = {"bottom": params["bottom"], "top": params["top"]}
    state = steps.cached_dlrm_init_state(mc, opt, params)
    ms = mc.init_state(params["emb"]["mega"])
    step = steps.build_cached_train_step(cfg, mc, opt, strict_sync=True)
    dense, state, _ = step(dense, state, ms, batch(both), 0)
    assert ms.row_slot[1, row] >= 0              # host 1 caches the row
    inv0 = ms.route.invalidations
    dense, state, _ = step(dense, state, ms, batch(only0), 1)
    assert ms.route.invalidations == inv0 + 1
    assert ms.row_slot[1, row] < 0               # host 1's copy dropped
    m0 = ms.stats.misses
    dense, state, _ = step(dense, state, ms, batch(both), 2)
    assert ms.stats.misses > m0                  # re-fetched fresh
    slot = ms.row_slot[1, row]
    assert torch.equal(ms.caches[1, slot], ms.capacity[row])
    _, uparams, uaccum = _uncached(cfg, host,
                                   [batch(both), batch(only0), batch(both)])
    r = uaccum.shape[0]
    assert torch.equal(ms.capacity[:r], uparams["emb"]["mega"])
    assert torch.equal(ms.cap_accum[:r], uaccum)


def test_fetch_faults_leave_the_step_replayable(setup):
    """"cache.fetch" fires once per planned batch (plan_step) and once per
    prefetch, before any host map mutates: a transient fault absorbed by
    the retry policy, or propagated out of plan_step (calls 2 and 5 are
    the second and third steps' plans) and the step called again, leaves
    the run bit-equal to the fault-free one."""
    from repro_torch.train.fault_tolerance import (FaultInjector, FaultSpec,
                                                   RetryPolicy,
                                                   TransientFetchFault)
    cfg, _, ebc, host = setup
    batches = _batches(cfg, ebc)
    want = _run_port(cfg, host, batches, 4)
    for retry in (RetryPolicy(max_retries=2, backoff_s=1e-5), None):
        inj = FaultInjector([FaultSpec("cache.fetch", 2),
                             FaultSpec("cache.fetch", 5)])
        params = params_from_jax(host, device="cpu")
        mc = dataclasses.replace(
            MultiHostCachedEmbeddingBagCollection.build(
                cfg, n_hosts=4, cache_rows=512), injector=inj, retry=retry)
        opt = adagrad(0.01)
        dense = {"bottom": params["bottom"], "top": params["top"]}
        state = steps.cached_dlrm_init_state(mc, opt, params)
        ms = mc.init_state(params["emb"]["mega"])
        step = steps.build_cached_train_step(cfg, mc, opt)
        losses, raised = [], 0
        for t, b in enumerate(batches):
            nxt = batches[t + 1] if t + 1 < len(batches) else None
            while True:
                try:
                    dense, state, m = step(dense, state, ms, b, t,
                                           next_batch=nxt)
                    break
                except TransientFetchFault:
                    raised += 1
            losses.append(float(m["loss"]))
        assert [f[1] for f in inj.fired] == [2, 5]
        assert raised == (0 if retry else 2)
        assert losses == want[0]
        assert torch.equal(ms.capacity, want[2])
        assert torch.equal(ms.cap_accum, want[3])


def test_mesh_form_raises_not_implemented(setup):
    """The mesh form is ported (tests/test_torch_multihost_mesh.py runs it
    on gloo ranks): given a host mesh whose axis holds n_hosts ranks the
    builder returns the step, on any host axis name; a mesh of another
    size raises ValueError; the sync tier ignores `mesh`, as the
    reference's does."""
    from types import SimpleNamespace
    cfg = setup[0]
    mc = MultiHostCachedEmbeddingBagCollection.build(cfg, n_hosts=2,
                                                     cache_rows=64)

    def host_mesh(axis, n):
        return SimpleNamespace(axis_names=(axis,), shape={axis: n},
                               size=lambda a: {axis: n}[a])
    for axis in ("data", "pod"):
        step = steps.build_cached_train_step(
            cfg, mc, adagrad(0.01), mesh=host_mesh(axis, 2), host_axis=axis)
        assert callable(step)
    with pytest.raises(ValueError, match="2 hosts"):
        steps.build_cached_train_step(cfg, mc, adagrad(0.01),
                                      mesh=host_mesh("data", 4))
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=64)
    assert callable(steps.build_cached_train_step(
        cfg, cc, adagrad(0.01), mesh=host_mesh("data", 4)))
    step = steps.build_cached_train_step(cfg, mc, adagrad(0.01),
                                         fetch_chunk=8)
    assert callable(step)

# ---------------------------------------------------------------------------
# the exchange-traffic model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_hosts,hit_rate", [(1, 0.8), (4, 0.5), (8, 0.8),
                                              (8, 0.95)])
def test_multihost_exchange_traffic_equals_reference(n_hosts, hit_rate):
    kw = dict(batch=4096, n_features=16, truncation=8, embed_dim=64,
              n_hosts=n_hosts, unique_per_host=30000 / n_hosts + 1500,
              unique_global=30000, hit_rate=hit_rate)
    got = multihost_exchange_traffic(**kw)
    assert got == janalysis.multihost_exchange_traffic(**kw)
    legs = ("fetch_bytes", "grad_bytes", "refresh_bytes", "total_bytes")
    if n_hosts == 1:
        assert all(got[k] == 0.0 for k in legs)
    else:
        assert all(got[k] > 0.0 for k in legs)
        assert got["reduction"] > 1.0
        assert got["rowsum_reduction"] > got["reduction"]
