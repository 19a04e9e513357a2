"""Every `cache_exchange` worklist the port builds meets the exchange's
no-race contract, which its CUDA kernel relies on to issue an entry's loads
before its stores and to run entries in any order: live slots distinct,
and no capacity row both written back and fetched
(`kernels.cache_ops.check_worklist`). A spy wraps `cache_ops.cache_exchange`
and checks each worklist that the sync admit, the flush, `flush_async`, the
bulk tier's collection and the serving engine's admit hand it, on the CPU
at the smoke dlrm-m1 with caches small enough to evict, then lets the call
through. Each path must hand it at least one fetch and, where it trains,
at least one writeback; serving's read-only tier writes nothing back.
"""
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.core.cache import CachedEmbeddingBagCollection
from repro_torch.core.dlrm import init_dlrm_params
from repro_torch.core.tiers import (AsyncCachedTier,
                                    BulkCachedEmbeddingBagCollection)
from repro_torch.data import pipeline
from repro_torch.data.synthetic import make_dlrm_batch
from repro_torch.kernels import cache_ops
from repro_torch.optim import adagrad
from repro_torch.serve import DLRMServeEngine, ServeRequest
from repro_torch.train import steps

BATCH, STEPS, CACHE_ROWS = 8, 4, 256


@pytest.fixture
def worklists(monkeypatch):
    """The (fetches, writebacks) of each cache_exchange call, every
    worklist checked against the contract before the call runs."""
    seen = []
    real = cache_ops.cache_exchange

    def checked(capacity, cache, cap_accum, cache_accum, freq, slots,
                evict_rows, fetch_rows, counts):
        cache_ops.check_worklist(slots, evict_rows, fetch_rows)
        live = slots >= 0
        seen.append((int((live & (fetch_rows >= 0)).sum()),
                     int((live & (evict_rows >= 0)).sum())))
        real(capacity, cache, cap_accum, cache_accum, freq, slots,
             evict_rows, fetch_rows, counts)

    monkeypatch.setattr(cache_ops, "cache_exchange", checked)
    return seen


def _train(cfg, collection, schedule: str, seen: list) -> dict:
    """STEPS steps of `build_cached_train_step` over `collection` (sync, or
    wrapped in AsyncCachedTier), then its materialize; returns the
    exchange calls of the steps and of the materialize apart."""
    params = init_dlrm_params(cfg, collection.ebc, 0, "cpu")
    opt = adagrad(0.01)
    state = steps.cached_dlrm_init_state(collection, opt, params)
    dense = {"bottom": params["bottom"], "top": params["top"]}
    tier = collection if schedule == "sync" else AsyncCachedTier(collection)
    cs = tier.init_state(params["emb"]["mega"])
    step = steps.build_cached_train_step(cfg, tier, opt)
    hook = pipeline.dedup_indices_hook(collection.ebc.plan.table_offsets)
    batches = [hook(make_dlrm_batch(cfg, BATCH, step=t))
               for t in range(STEPS)]
    for t, batch in enumerate(batches):
        kw = {} if schedule == "sync" else {
            "next_batch": batches[t + 1] if t + 1 < STEPS else None}
        dense, state, _ = step(dense, state, cs, batch, t, **kw)
    in_steps = list(seen)
    del seen[:]
    tier.materialize(cs)
    return {"steps": in_steps, "materialize": list(seen)}


def _fetches(calls):
    return sum(f for f, _ in calls)


def _writebacks(calls):
    return sum(w for _, w in calls)


def test_sync_admit_and_flush_hand_the_exchange_contract_worklists(
        worklists):
    """The sync collection (one exchange per admission: its misses and
    their dirty victims), then materialize's flush (pure writebacks)."""
    cfg = get_smoke_config("dlrm-m1")
    got = _train(cfg, CachedEmbeddingBagCollection.build(
        cfg, cache_rows=CACHE_ROWS), "sync", worklists)
    assert _fetches(got["steps"]) > 0 and _writebacks(got["steps"]) > 0
    assert len(got["materialize"]) == 1
    assert _fetches(got["materialize"]) == 0
    assert _writebacks(got["materialize"]) > 0


def test_flush_async_hands_the_exchange_a_contract_worklist(worklists):
    """AsyncCachedTier fetches through cache_fetch and commits through
    cache_commit; its materialize's flush_async writes every dirty slot
    back through one exchange."""
    cfg = get_smoke_config("dlrm-m1")
    got = _train(cfg, CachedEmbeddingBagCollection.build(
        cfg, cache_rows=CACHE_ROWS), "async", worklists)
    assert got["steps"] == []
    assert len(got["materialize"]) == 1
    assert _writebacks(got["materialize"]) > 0


@pytest.mark.parametrize("schedule", ["sync", "async"])
def test_bulk_tier_hands_the_exchange_contract_worklists(worklists,
                                                         schedule):
    """The three-tier collection (a DRAM budget the run overflows, so rows
    come back from the bulk store): its admissions (sync) and its flush."""
    cfg = get_smoke_config("dlrm-m1")
    bc = BulkCachedEmbeddingBagCollection.build(
        cfg, cache_rows=CACHE_ROWS, dram_rows=300, bulk_chunk=16,
        bulk_latency_us=0.0)
    got = _train(cfg, bc, schedule, worklists)
    if schedule == "sync":
        assert _fetches(got["steps"]) > 0 and _writebacks(got["steps"]) > 0
    assert _writebacks(got["materialize"]) > 0


def test_serving_admit_hands_the_exchange_contract_worklists(worklists):
    """The serving engine's admissions over a cache small enough to evict:
    fetches only (its tier is read-only, never dirty)."""
    cfg = get_smoke_config("dlrm-m1")
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=160)
    engine = DLRMServeEngine(init_dlrm_params(cfg, cc.ebc, 0, "cpu"), cfg,
                             cc, max_batch=16)
    for uid in range(12):
        raw = make_dlrm_batch(cfg, 4, step=uid, zipf_alpha=1.05)
        engine.submit(ServeRequest(uid, raw["dense"],
                                   cc.ebc.offset_indices(raw["idx"])))
    engine.run()
    assert len(engine.results) == 12
    assert cc.stats(engine.state).evictions > 0
    assert _fetches(worklists) > 0 and _writebacks(worklists) == 0
