"""The cached tier's training half and its async stream, against the
reference, on the CPU: the fetch / chunked fetch / commit plain versions
(against the reference's oracles and its Pallas kernels in interpret mode),
the run coalescer and the chunked shadow fetch, the pipeline's lookahead,
and `build_cached_train_step` for the sync collection and `AsyncCachedTier`
at the smoke dlrm-m1 with a cache small enough to evict. Inputs come from
numpy seeds; parameters from the reference (`convert.params_from_jax`).

Tolerances, each with its reason:
  * fetch, chunked fetch and commit: bit-equal (values are copied);
  * starts, pos, src_pos, slot maps, dirty bits, epochs, every CacheStats
    counter and the relabelled plans: exactly equal;
  * losses, dense parameters, the materialized capacity tier and
    accumulator against the reference: STEP_TOL of
    tests/test_torch_train.py (fp32 matmuls and sums in other orders);
  * inside the port, async vs strict-sync vs sync vs the uncached step:
    bit-equal (the same kernels see the same values in the same order).
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
from repro.core.tiers import AsyncCachedTier as JAsyncTier
from repro.data import pipeline as jpipeline
from repro.kernels import cache_ops as jcache_ops
from repro.kernels import ref as jref
from repro.kernels import sparse_plan as jsp
from repro.nn.params import init_params as jinit
from repro.optim import adagrad as jadagrad
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import cache
from repro_torch.core.cache import CachedEmbeddingBagCollection
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.core.tiers import AsyncCachedTier
from repro_torch.data import pipeline
from repro_torch.data.synthetic import make_dlrm_batch
from repro_torch.kernels import cache_ops, sparse_plan
from repro_torch.optim import adagrad
from repro_torch.train import steps

STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
N_STEPS, BATCH, CACHE_ROWS = 6, 8, 256

# ---------------------------------------------------------------------------
# the three row movers: plain versions vs the reference
# ---------------------------------------------------------------------------


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t if dtype is None else t.to(dtype)


def _tiers(rng, r=40, c=8, d=48):
    return (rng.randn(r, d).astype(np.float32),
            rng.randn(c, d).astype(np.float32),
            rng.rand(r).astype(np.float32), rng.rand(c).astype(np.float32))


def _assert_bits(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("d", [48, 128, 5])
def test_fetch_plain_bit_equal_to_reference_and_interpret_kernel(d):
    rng = np.random.RandomState(d)
    capacity, _, cap_acc, _ = _tiers(rng, d=d)
    fetch = np.asarray([20, 39, -1, 0, -1, 7, 39], np.int32)
    want = jref.cache_fetch_ref(jnp.asarray(capacity), jnp.asarray(cap_acc),
                                jnp.asarray(fetch))
    kern = jcache_ops.cache_fetch(jnp.asarray(capacity), jnp.asarray(cap_acc),
                                  jnp.asarray(fetch), interpret=True)
    got = cache_ops.cache_fetch(_t(capacity), _t(cap_acc), _t(fetch))
    for g, w, k in zip(got, want, kern):
        _assert_bits(g, w)
        _assert_bits(g, k)
    assert not got[0][2].any() and float(got[1][4]) == 0.0   # pads are zero


@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_fetch_chunked_plain_bit_equal_to_reference_and_interpret_kernel(
        chunk):
    rng = np.random.RandomState(chunk)
    capacity, _, cap_acc, _ = _tiers(rng, r=40, d=48)
    # a pad start, a block clamped at R - chunk, one at row 0
    starts = np.asarray([3, -1, 40 - chunk, 0], np.int32)
    args = (jnp.asarray(capacity), jnp.asarray(cap_acc), jnp.asarray(starts))
    want = jref.cache_fetch_chunked_ref(*args, chunk)
    kern = jcache_ops.cache_fetch_chunked(*args, chunk, interpret=True)
    got = cache_ops.cache_fetch_chunked(_t(capacity), _t(cap_acc),
                                        _t(starts), chunk)
    assert got[0].shape == (4 * chunk, 48)
    for g, w, k in zip(got, want, kern):
        _assert_bits(g, w)
        _assert_bits(g, k)
    assert not got[0][chunk:2 * chunk].any()
    np.testing.assert_array_equal(got[0][2 * chunk:3 * chunk].numpy(),
                                  capacity[40 - chunk:])


def _commit_case(rng, src_remap):
    """Every entry kind: writeback + install, install only, pure writeback
    (fetch -1 keeps the slot), a pad slot. With `src_remap` the shadow is a
    taller chunk slab and src_pos reads rows out of it."""
    capacity, cache_, cap_acc, cache_acc = _tiers(rng)
    slots = np.asarray([0, 2, 3, -1, 5, 7], np.int32)
    evict = np.asarray([10, -1, 12, -1, -1, 13], np.int32)
    fetch = np.asarray([20, 21, -1, -1, 22, 23], np.int32)
    if src_remap:
        shadow = rng.randn(16, 48).astype(np.float32)
        shadow_acc = rng.rand(16).astype(np.float32)
        src_pos = np.asarray([9, 0, -1, -1, 15, 4], np.int32)
    else:
        shadow = rng.randn(6, 48).astype(np.float32)
        shadow_acc = rng.rand(6).astype(np.float32)
        src_pos = None
    return (capacity, cache_, cap_acc, cache_acc, shadow, shadow_acc, slots,
            evict, fetch, src_pos)


@pytest.mark.parametrize("src_remap", [False, True],
                         ids=["one_row_per_entry", "chunk_slab_src_pos"])
def test_commit_plain_bit_equal_to_reference_and_interpret_kernel(src_remap):
    case = _commit_case(np.random.RandomState(7), src_remap)
    *arrays, src_pos = case
    jargs = [jnp.asarray(a) for a in arrays]
    jpos = None if src_pos is None else jnp.asarray(src_pos)
    want = jref.cache_commit_ref(*jargs, src_pos=jpos)
    kern = jcache_ops.cache_commit(*[jnp.array(a, copy=True) for a in jargs],
                                   interpret=True, src_pos=jpos)
    got = [_t(a) for a in arrays]
    cache_ops.cache_commit(*got, src_pos=None if src_pos is None
                           else _t(src_pos))
    for g, w, k in zip(got[:4], want, kern):
        _assert_bits(g, w)
        _assert_bits(g, k)
    capacity, cache_ = arrays[0], arrays[1]
    # the pure writeback kept its slot and wrote it back
    np.testing.assert_array_equal(got[1][3].numpy(), cache_[3])
    np.testing.assert_array_equal(got[0][12].numpy(), cache_[3])
    cache_ops.check_commit_worklist(_t(arrays[6]), _t(arrays[8]),
                                    None if src_pos is None else _t(src_pos),
                                    arrays[4].shape[0])
    assert not np.array_equal(got[0].numpy(), capacity)


def test_fetch_then_commit_equals_fused_exchange():
    capacity, cache_, cap_acc, cache_acc = _tiers(np.random.RandomState(3))
    freq = np.random.RandomState(4).rand(8).astype(np.float32)
    slots = np.asarray([0, 2, 3, -1, 5, 7], np.int32)
    evict = np.asarray([10, -1, 12, -1, -1, 13], np.int32)
    fetch = np.asarray([20, 21, -1, -1, 22, 23], np.int32)
    counts = np.asarray([3, 1, 0, 0, 2, 5], np.float32)
    want = [_t(x) for x in (capacity, cache_, cap_acc, cache_acc, freq)]
    cache_ops.cache_exchange(*want, _t(slots), _t(evict), _t(fetch),
                             _t(counts))
    jwant = jref.cache_exchange_ref(*map(jnp.asarray, (
        capacity, cache_, cap_acc, cache_acc, freq, slots, evict, fetch,
        counts)))
    got = [_t(x) for x in (capacity, cache_, cap_acc, cache_acc)]
    shadow, shadow_acc = cache_ops.cache_fetch(got[0], got[2], _t(fetch))
    cache_ops.cache_commit(*got, shadow, shadow_acc, _t(slots), _t(evict),
                           _t(fetch))
    for g, w, j in zip(got, want, jwant):
        _assert_bits(g, w.numpy())
        _assert_bits(g, j)


def test_worklist_checks_and_device_dispatch_raise():
    slots = torch.tensor([1, 1, -1], dtype=torch.int32)
    fetch = torch.tensor([3, 4, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="repeats a cache slot"):
        cache_ops.check_commit_worklist(slots, fetch, None, 3)
    with pytest.raises(ValueError, match="outside"):
        cache_ops.check_commit_worklist(
            torch.tensor([0, 1], dtype=torch.int32), fetch[:2],
            torch.tensor([0, 4], dtype=torch.int32), 4)
    cache_ops.check_chunk_starts(torch.tensor([-1, 0, 12], dtype=torch.int32),
                                 4, 16)
    with pytest.raises(ValueError, match="past row"):
        cache_ops.check_chunk_starts(torch.tensor([13], dtype=torch.int32),
                                     4, 16)
    # a tensor off the CPU and off CUDA neither falls back nor launches
    cap, acc = torch.zeros((8, 4)), torch.zeros(8)
    meta = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cache_ops.cache_fetch(cap, acc, meta)
    with pytest.raises(ValueError, match="CUDA"):
        cache_ops.cache_fetch_chunked(cap, acc, meta, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cache_ops.cache_commit(cap, torch.zeros((2, 4)), acc, torch.zeros(2),
                               torch.zeros((2, 4)), torch.zeros(2), meta,
                               meta, meta)

# ---------------------------------------------------------------------------
# coalescer and chunked shadow fetch
# ---------------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), chunk=st.integers(2, 16),
       n=st.integers(0, 80), adaptive=st.booleans())
def test_coalesce_rows_equals_reference(seed, chunk, n, adaptive):
    rng = np.random.RandomState(seed)
    total = int(rng.randint(chunk, 400))
    rows = np.sort(rng.choice(total, size=min(n, total), replace=False))
    assert cache._chunk_min_fill(chunk) == jcache._chunk_min_fill(chunk)
    min_fill = cache._chunk_min_fill(chunk) if adaptive else 1
    want = jsp.coalesce_rows(rows, chunk, total, min_fill=min_fill)
    got = sparse_plan.coalesce_rows(rows, chunk, total, min_fill=min_fill)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    starts, pos = got
    assert (starts >= 0).all() and (starts + chunk <= total).all()
    live = pos >= 0
    np.testing.assert_array_equal(
        starts[pos[live] // chunk] + pos[live] % chunk, rows[live])


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), chunk=st.integers(2, 16))
def test_chunked_shadow_fetch_equals_reference(seed, chunk):
    rng = np.random.RandomState(seed)
    total, d = 300, 8
    capacity = rng.randn(total, d).astype(np.float32)
    cap_acc = rng.rand(total).astype(np.float32)
    # a dense head (coalesces) plus scattered rows (fall back per row)
    rows = np.unique(np.concatenate([np.arange(rng.randint(0, 40)),
                                     rng.choice(total, 30)]))
    jstats, stats = jcache.CacheStats(), cache.CacheStats()
    want = jcache._chunked_shadow_fetch(
        jnp.asarray(capacity), jnp.asarray(cap_acc), rows, chunk, jstats,
        None, False)
    got = cache._chunked_shadow_fetch(_t(capacity), _t(cap_acc), rows,
                                      chunk, stats)
    _assert_bits(got[0], want[0])
    _assert_bits(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert dataclasses.asdict(stats) == dataclasses.asdict(jstats)
    np.testing.assert_array_equal(got[0].numpy()[got[2]], capacity[rows])


def test_host_plan_from_batch_and_hook_keys_equal_reference():
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    raw = make_dlrm_batch(cfg, 8, step=3)
    batch = pipeline.sparse_plan_hook(ebc.plan.table_offsets)(dict(raw))
    for g, w in zip(sparse_plan.host_plan_from_batch(batch),
                    jsp.host_plan_from_batch(batch)):
        np.testing.assert_array_equal(g, w)
    assert sparse_plan.host_plan_from_batch(raw) is None
    jbatch = jpipeline.sparse_plan_hook(ebc.plan.table_offsets)(dict(raw))
    assert batch["uniq_rows"].dtype == jbatch["uniq_rows"].dtype
    np.testing.assert_array_equal(batch["uniq_rows"], jbatch["uniq_rows"])

# ---------------------------------------------------------------------------
# pipeline lookahead
# ---------------------------------------------------------------------------


def _gen(s):
    rng = np.random.RandomState(s)
    return {"uniq_rows": np.unique(rng.randint(-1, 50, 12)).astype(np.int64),
            "x": np.asarray([s])}


def test_peek_and_lookahead_rows_match_reference():
    pipes = [pipeline.DataPipeline(_gen, prefetch=2),
             jpipeline.DataPipeline(_gen, prefetch=2)]
    try:
        for step in range(4):
            got, want = (pipeline.lookahead_rows(p, 3) for p in pipes)
            np.testing.assert_array_equal(got, want)
            assert int(pipes[0].peek(1)["x"][0]) == step + 1
            assert [next(p)[0] for p in pipes] == [step, step]
        assert pipeline.lookahead_rows(pipes[0], 0).shape == (0,)
    finally:
        for p in pipes:
            p.close()


def test_peek_after_failure_returns_none_and_next_raises():
    def gen(s):
        if s == 2:
            raise ValueError("boom")
        return {"uniq_rows": np.asarray([s], np.int64)}

    pipe = pipeline.DataPipeline(gen, prefetch=1)
    try:
        assert pipe.peek(5) is None
        np.testing.assert_array_equal(pipeline.lookahead_rows(pipe, 4),
                                      [0, 1])
        assert [next(pipe)[0] for _ in range(2)] == [0, 1]
        with pytest.raises(RuntimeError, match="step 2"):
            next(pipe)
    finally:
        pipe.close()

# ---------------------------------------------------------------------------
# the cached train steps against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    jebc = JEBC.build(jcfg, n_shards=1, strategy="cached_host")
    jparams = jinit(jspecs(jcfg, jebc), jax.random.PRNGKey(5))
    host = jax.tree.map(np.asarray, jparams)
    ebc = EmbeddingBagCollection.build(cfg, strategy="cached_host")
    return cfg, jcfg, ebc, host


def _stream(cfg, ebc, plan, n=N_STEPS):
    """n training batches through the port's reader hooks: offset rows plus
    the unique-row set, and the sparse plan when `plan`."""
    hook = (pipeline.sparse_plan_hook if plan
            else pipeline.dedup_indices_hook)(ebc.plan.table_offsets)
    return [hook(make_dlrm_batch(cfg, BATCH, step=t, zipf_alpha=1.05))
            for t in range(n)]


def _host_state(st):
    out = {"slot_row": st.slot_row.copy(), "row_slot": st.row_slot.copy(),
           "dirty": st.dirty.copy(), "stats": dataclasses.asdict(st.stats)}
    if hasattr(st, "slot_epoch"):
        out.update(slot_epoch=st.slot_epoch.copy(), epoch=st.epoch)
    return out


def _run_port(cfg, host, batches, schedule, fetch_chunk, lookahead=False):
    """Train the port for len(batches) steps; returns (losses, dense, mega,
    accum, host-state per step, relabelled plans per step)."""
    params = params_from_jax(host, device="cpu")
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=CACHE_ROWS,
                                            fetch_chunk=fetch_chunk)
    opt = adagrad(0.01)
    state = steps.cached_dlrm_init_state(cc, opt, params)
    dense = {"bottom": params["bottom"], "top": params["top"]}
    tier = cc if schedule == "sync" else AsyncCachedTier(cc)
    cs = tier.init_state(params["emb"]["mega"])
    step = steps.build_cached_train_step(cfg, tier, opt,
                                         strict_sync=(schedule == "strict"))
    losses, hosts, plans = [], [], []
    for t, batch in enumerate(batches):
        nxt = batches[t + 1] if t + 1 < len(batches) else None
        kw = {"next_batch": nxt}
        if lookahead and schedule != "sync":
            kw["prefetch_rows"] = np.unique(np.concatenate(
                [b["uniq_rows"] for b in batches[t + 1:t + 3]] or
                [np.empty(0, np.int64)]))
        dense, state, m = step(dense, state, cs, batch, t, **kw)
        losses.append(float(m["loss"]))
        hosts.append(_host_state(cs))
        if "plan_rows" in batch and schedule != "sync":
            plans.append(tier.plan_to_slots(cs, batch))
    mega, accum = tier.materialize(cs)
    return losses, dense, mega.clone(), accum.clone(), hosts, plans, cs


def _run_ref(jcfg, host, batches, schedule, fetch_chunk, lookahead=False):
    jparams = jax.tree.map(jnp.asarray, host)
    cc = jcache.CachedEmbeddingBagCollection.build(
        jcfg, cache_rows=CACHE_ROWS, fetch_chunk=fetch_chunk)
    opt = jadagrad(0.01)
    state = jsteps.cached_dlrm_init_state(cc, opt, jparams)
    dense = {"bottom": jparams["bottom"], "top": jparams["top"]}
    tier = cc if schedule == "sync" else JAsyncTier(cc)
    cs = tier.init_state(jparams["emb"]["mega"])
    step = jsteps.build_cached_train_step(jcfg, tier, opt,
                                          strict_sync=(schedule == "strict"))
    losses, hosts, plans = [], [], []
    for t, batch in enumerate(batches):
        nxt = batches[t + 1] if t + 1 < len(batches) else None
        kw = {"next_batch": nxt}
        if lookahead and schedule != "sync":
            kw["prefetch_rows"] = np.unique(np.concatenate(
                [b["uniq_rows"] for b in batches[t + 1:t + 3]] or
                [np.empty(0, np.int64)]))
        jb = {k: (v if k in ("idx", "uniq_rows") or k.startswith("plan_")
                  else jnp.asarray(v)) for k, v in batch.items()}
        dense, state, m = step(dense, state, cs, jb,
                               jnp.asarray(t, jnp.int32), **kw)
        losses.append(float(m["loss"]))
        hosts.append(_host_state(cs))
        if "plan_rows" in batch and schedule != "sync":
            plans.append(tier.plan_to_slots(cs, batch))
    mega, accum = tier.materialize(cs)
    return losses, dense, np.asarray(mega), np.asarray(accum), hosts, plans


def _assert_matches_reference(got, want):
    losses, dense, mega, accum, hosts, plans, _ = got
    jlosses, jdense, jmega, jaccum, jhosts, jplans = want
    for h, jh in zip(hosts, jhosts):
        assert h.keys() == jh.keys()
        for k in h:
            np.testing.assert_array_equal(h[k], jh[k], err_msg=k)
    assert len(plans) == len(jplans)
    for p, jp in zip(plans, jplans):
        for k in p:
            np.testing.assert_array_equal(p[k], jp[k], err_msg=k)
    np.testing.assert_allclose(losses, jlosses, **STEP_TOL)
    np.testing.assert_allclose(mega.numpy(), jmega, **STEP_TOL)
    np.testing.assert_allclose(accum.numpy(), jaccum, **STEP_TOL)
    for part in ("bottom", "top"):
        for a, b in zip(jax.tree.leaves(jdense[part]), jax.tree.leaves(
                jax.tree.map(lambda t: t.numpy(), dense[part]))):
            np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL)


@pytest.mark.parametrize("plan", [False, True], ids=["no_plan", "plan"])
@pytest.mark.parametrize("fetch_chunk", [1, 4])
def test_sync_cached_step_matches_reference(setup, fetch_chunk, plan):
    cfg, jcfg, ebc, host = setup
    batches = _stream(cfg, ebc, plan)
    got = _run_port(cfg, host, batches, "sync", fetch_chunk)
    want = _run_ref(jcfg, host, batches, "sync", fetch_chunk)
    _assert_matches_reference(got, want)
    stats = got[-1].stats
    assert stats.evictions > 0 and stats.writebacks > 0 and stats.prefetched
    if fetch_chunk > 1:
        assert stats.fetch_chunks > 0 and stats.overfetch_rows > 0


@pytest.mark.parametrize("plan", [False, True], ids=["no_plan", "plan"])
@pytest.mark.parametrize("fetch_chunk", [1, 4])
def test_async_cached_step_matches_reference(setup, fetch_chunk, plan):
    cfg, jcfg, ebc, host = setup
    batches = _stream(cfg, ebc, plan)
    got = _run_port(cfg, host, batches, "async", fetch_chunk, lookahead=True)
    want = _run_ref(jcfg, host, batches, "async", fetch_chunk,
                    lookahead=True)
    _assert_matches_reference(got, want)
    stats = got[-1].stats
    assert stats.evictions > 0 and stats.writebacks > 0 and stats.prefetched

# ---------------------------------------------------------------------------
# inside the port: every schedule gives the same bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fetch_chunk", [1, 4])
def test_async_strict_and_sync_are_bit_equal(setup, fetch_chunk):
    cfg, _, ebc, host = setup
    batches = _stream(cfg, ebc, plan=True)
    runs = {s: _run_port(cfg, host, batches, s, fetch_chunk)
            for s in ("sync", "async", "strict")}
    assert runs["sync"][-1].stats.evictions > 0
    assert runs["strict"][-1].stats.prefetched == 0
    base = runs["sync"]
    for s in ("async", "strict"):
        r = runs[s]
        assert r[0] == base[0]
        assert torch.equal(r[2], base[2]) and torch.equal(r[3], base[3])
        for part in ("bottom", "top"):
            for a, b in zip(r[1][part], base[1][part]):
                assert all(torch.equal(a[k], b[k]) for k in a)
        assert r[-1].stats.steps == base[-1].stats.steps


@pytest.mark.parametrize("schedule", ["sync", "async"])
@pytest.mark.parametrize("plan", [False, True], ids=["no_plan", "plan"])
def test_cached_run_bit_equal_to_uncached_step(setup, schedule, plan):
    cfg, _, ebc, host = setup
    batches = _stream(cfg, ebc, plan)
    losses, dense, mega, accum, _, _, cs = _run_port(cfg, host, batches,
                                                     schedule, 4)
    assert cs.stats.evictions > 0
    params = params_from_jax(host, device="cpu")
    uebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    opt = adagrad(0.01)
    state = steps.dlrm_init_state(uebc, opt, params)
    step = steps.build_dlrm_train_step(cfg, uebc, opt)
    ulosses = []
    for t, batch in enumerate(batches):
        tb = {k: torch.as_tensor(v) for k, v in batch.items()
              if k != "uniq_rows"}
        params, state, m = step(params, state, tb, t)
        ulosses.append(float(m["loss"]))
    assert losses == ulosses
    assert torch.equal(mega, params["emb"]["mega"])
    assert torch.equal(accum, state["accum"])
    for part in ("bottom", "top"):
        for a, b in zip(dense[part], params[part]):
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_build_cached_train_step_rejects_other_tiers(setup):
    cfg, _, ebc, _ = setup
    with pytest.raises(TypeError, match="unsupported tier"):
        steps.build_cached_train_step(cfg, ebc, adagrad(0.01))
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=64,
                                            fetch_chunk=8)
    step = steps.build_cached_train_step(cfg, AsyncCachedTier(cc),
                                         adagrad(0.01))
    assert callable(step)
    assert AsyncCachedTier(cc).placement()["stream"] == "async"
    with pytest.raises(ValueError, match="fetch_chunk"):
        CachedEmbeddingBagCollection.build(cfg, fetch_chunk=0)

# ---------------------------------------------------------------------------
# the reference's planning invariants, ported
# ---------------------------------------------------------------------------


def _mega(cc, seed=0):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randn(cc.ebc.plan.total_rows,
                                      cc.ebc.cfg.embed_dim)
                            .astype(np.float32))


def _idx(cfg, ebc, step):
    return ebc.offset_indices(make_dlrm_batch(cfg, BATCH, step=step)["idx"])


def test_refetch_of_queued_dirty_victim_sees_fresh_value(setup):
    """A row whose dirty eviction is still queued is not re-fetched from
    the stale capacity tier (the planner drains first), and the drain
    keeps the staged batch's slots protected."""
    cfg = setup[0]
    tiny = dataclasses.replace(cfg, n_sparse_features=1, hash_sizes=(64,),
                               mean_lookups=(4,), bottom_mlp=(8, 16),
                               top_mlp=(8, 1))
    cc = CachedEmbeddingBagCollection.build(tiny, cache_rows=32)
    astate = cc.init_async_state(torch.zeros((cc.ebc.plan.total_rows,
                                              tiny.embed_dim)))

    def batch_of(rows, rep=1):
        return np.repeat(np.asarray(rows, np.int32), rep).reshape(1, 1, -1)

    local = cc.take_async(astate, batch_of(range(8)), train=True)
    cache_ = astate.cache.clone()
    cache_[torch.from_numpy(np.unique(local)).long()] = 1000.0
    cc.mark_updated(astate, cache_, astate.cache_accum)
    cc.take_async(astate, batch_of(range(8, 16), rep=4), train=True)
    cc.take_async(astate, batch_of(range(16, 24)), train=True)
    cc.stage_async(astate, batch_of(range(24, 40)), train=True)
    assert (astate.pending[-1].evict_rows >= 0).sum() == 8
    staged_slots = astate.row_slot[np.arange(24, 40)].copy()
    assert cc.stage_rows(astate, np.asarray([0])) == 1
    np.testing.assert_array_equal(astate.row_slot[np.arange(24, 40)],
                                  staged_slots)
    cc.take_async(astate, batch_of(range(24, 40)), train=True)
    slot = astate.row_slot[0]
    assert slot >= 0
    assert torch.all(astate.cache[slot] == 1000.0)
    assert torch.all(astate.capacity[1] == 1000.0)


def test_staged_victims_never_in_flight(setup):
    cfg, _, ebc, _ = setup
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=240)
    astate = cc.init_async_state(_mega(cc))
    cc.take_async(astate, _idx(cfg, ebc, 0), train=True)
    evicting, epochs = 0, []
    for k in range(1, 8):
        inflight = astate.inflight_mask.copy()
        cc.stage_async(astate, _idx(cfg, ebc, k), train=True)
        p = astate.pending[-1]
        evicting += len(p.victim_slots)
        assert not inflight[p.victim_slots].any()
        assert not inflight[p.slots].any()
        assert p.epoch == astate.epoch
        assert np.all(astate.slot_epoch[p.slots] == p.epoch)
        epochs.append(p.epoch)
        cc.take_async(astate, _idx(cfg, ebc, k), train=True)
    assert evicting > 0
    assert epochs == sorted(epochs)


def test_take_async_with_mismatched_staged_plan_recovers(setup):
    cfg, _, ebc, _ = setup
    uebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=320)
    mega = _mega(cc, 1)
    want_table = mega.clone()
    astate = cc.init_async_state(mega)
    cc.stage_async(astate, _idx(cfg, ebc, 5), train=False)
    actual = _idx(cfg, ebc, 6)
    local = cc.take_async(astate, actual, train=False)
    got = cc.lookup_cached(astate, local)
    want = uebc.lookup({"mega": want_table}, torch.from_numpy(actual))
    assert torch.equal(got, want)
    assert astate.staged is None and not astate.pending
    assert astate.stats.steps == 1
    assert astate.stats.misses <= len(np.unique(actual[actual >= 0]))
    assert astate.stats.prefetched > 0
    assert astate.stats.hits + astate.stats.misses == int((actual >= 0).sum())


def test_async_thrash_guards_name_their_cause(setup):
    cfg, _, ebc, _ = setup
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=8)
    with pytest.raises(ValueError, match="cache_rows"):
        cc.take_async(cc.init_async_state(_mega(cc)), _idx(cfg, ebc, 0))
    idx0, idx1 = _idx(cfg, ebc, 0), _idx(cfg, ebc, 1)
    ws = max(len(np.unique(i[i >= 0])) for i in (idx0, idx1))
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=ws + 8)
    astate = cc.init_async_state(_mega(cc))
    cc.take_async(astate, idx0, train=True)
    with pytest.raises(ValueError, match="in-flight"):
        cc.stage_async(astate, idx1, train=True)


def test_async_lookup_and_gated_lookahead_match_reference(setup):
    """lookup_async against the sync lookup, and gated stage_rows /
    prefetch admissions integer-equal to the reference's."""
    cfg, jcfg, ebc, _ = setup
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=200)
    jcc = jcache.CachedEmbeddingBagCollection.build(jcfg, cache_rows=200)
    mega = _mega(cc, 2)
    jmega = jnp.asarray(mega.numpy())
    astate = cc.init_async_state(mega.clone())
    sstate = cc.init_state(mega.clone())
    jastate, jsstate = jcc.init_async_state(jmega), jcc.init_state(jmega)
    for k in range(4):
        idx = _idx(cfg, ebc, k)
        got = cc.lookup_async(astate, idx, train=False)
        assert torch.equal(got, cc.lookup(sstate, idx, train=False))
        jcc.lookup_async(jastate, idx, train=False)
        jcc.lookup(jsstate, idx, train=False)
        ahead = np.unique(_idx(cfg, ebc, k + 1))
        assert cc.stage_rows(astate, ahead, gate=True) == \
            jcc.stage_rows(jastate, ahead, gate=True)
        # the lookahead's queued slots stay protected until committed
        assert cc.commit_async(astate) == jcc.commit_async(jastate)
        assert cc.prefetch(sstate, ahead, gate=True) == \
            jcc.prefetch(jsstate, ahead, gate=True)
        for st_, jst in ((astate, jastate), (sstate, jsstate)):
            for key, v in _host_state(st_).items():
                np.testing.assert_array_equal(v, _host_state(jst)[key])
    _assert_bits(astate.cache, jastate.cache)
    _assert_bits(sstate.cache, jsstate.cache)
    assert astate.stats.evictions > 0
