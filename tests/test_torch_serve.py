"""The port's serving engines replayed against the reference's on the same
requests, at the smoke size of dlrm-m1, on copied parameters.

Exact: slot_row / row_slot, CacheStats, the shed set and reasons, breaker
transitions, degraded flags and latencies (virtual clock). Bit-equal: the
LFU scores and the cache payload (values are moved, never computed).
Within 1e-5: probabilities (fp32 forward, different summation orders).
Inside the port: every non-degraded response is bit-equal to the port's
big-cache DLRMEngine on the same request.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jget_smoke
from repro.core.cache import CachedEmbeddingBagCollection as JCC
from repro.core.dlrm import dlrm_param_specs as jspecs
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.nn.params import init_params as jinit
from repro.serve import DLRMEngine as JEngine
from repro.serve import DLRMServeEngine as JServe
from repro.serve import Overloaded as JOverloaded
from repro.serve import ServeRequest as JRequest
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.cache import CachedEmbeddingBagCollection
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.data.synthetic import make_dlrm_batch
from repro_torch.serve import (DLRMEngine, DLRMServeEngine, Overloaded,
                               ServeRequest)

PROB_TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(scope="module")
def setup():
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    jebc = JEBC.build(jcfg, n_shards=1, strategy="replicated")
    jparams = jinit(jspecs(jcfg, jebc), jax.random.PRNGKey(2))
    host = jax.tree.map(np.asarray, jparams)
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    return cfg, jcfg, ebc, jparams, host


class VClock:
    """Deterministic virtual clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class Fault(Exception):
    transient = True


class DuckInjector:
    """Raises a transient fault at scheduled call counts of each site."""

    def __init__(self, schedule):
        self.schedule = schedule
        self.calls = {}

    def fire(self, site, **ctx):
        n = self.calls.get(site, 0)
        self.calls[site] = n + 1
        if n in self.schedule.get(site, ()):
            raise Fault(f"{site}#{n}")


def _request_arrays(cfg, ebc, step, flash=False):
    """Seeded drifting-Zipf request; `flash` collapses onto an 8-key hot
    set per table (a flash crowd)."""
    raw = make_dlrm_batch(cfg, 4, step=step, zipf_alpha=1.05)
    idx = raw["idx"].copy()
    for t, h in enumerate(cfg.hash_sizes):
        col = (idx[:, t, :] + 3 * step) % h
        if flash:
            col = (col % 8 + (step // 4) * 8) % h
        idx[:, t, :] = np.where(raw["idx"][:, t, :] >= 0, col, -1)
    return raw["dense"], ebc.offset_indices(idx)


def _assert_same_tier(st, jst):
    np.testing.assert_array_equal(st.slot_row, jst.slot_row)
    np.testing.assert_array_equal(st.row_slot, jst.row_slot)
    np.testing.assert_array_equal(st.ema, jst.ema)
    assert dataclasses.asdict(st.stats) == dataclasses.asdict(jst.stats)
    np.testing.assert_array_equal(st.freq.numpy(), np.asarray(jst.freq))
    np.testing.assert_array_equal(st.cache.numpy(), np.asarray(jst.cache))
    np.testing.assert_array_equal(st.cache_accum.numpy(),
                                  np.asarray(jst.cache_accum))


@pytest.mark.parametrize("cache_rows", [160, 2048])
def test_dlrm_engine_replay_matches_reference(setup, cache_rows):
    cfg, jcfg, ebc, jparams, host = setup
    eng = DLRMEngine(params_from_jax(host), cfg,
                     CachedEmbeddingBagCollection.build(
                         cfg, cache_rows=cache_rows))
    jeng = JEngine(jparams, jcfg, JCC.build(jcfg, cache_rows=cache_rows))
    for step in range(6):
        dense, idx = _request_arrays(cfg, ebc, step)
        dense, idx = np.tile(dense, (2, 1)), np.tile(idx, (2, 1, 1))
        batch = {"dense": dense, "idx": idx}
        np.testing.assert_allclose(eng.predict(batch), jeng.predict(batch),
                                   **PROB_TOL)
        _assert_same_tier(eng.state, jeng.state)
    assert eng.cache_stats.hits > 0
    if cache_rows == 160:
        assert eng.cache_stats.evictions > 0     # the LFU order was exercised


def _replay(engine, cfg, ebc, make_request, clock):
    """8 rounds x 8 flash-crowd requests with deadlines, one step per
    round (4x the engine's per-step service rate), then drain."""
    uid = 0
    for step in range(8):
        for _ in range(8):
            dense, idx = _request_arrays(cfg, ebc, step, flash=True)
            engine.submit(make_request(uid, dense, idx, clock() + 3.0))
            uid += 1
        engine.step()
        clock.t += 1.0
    engine.run(max_steps=200)
    return uid


SCHEDULES = [
    {"serve.fetch": {1, 2, 3}, "serve.admit": {5, 17}},
    {"serve.fetch": {0, 4, 5, 9}, "serve.admit": {30}},
    {},
]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_serve_engine_replay_matches_reference(setup, schedule):
    cfg, jcfg, ebc, jparams, host = setup
    kw = {"max_queue": 12, "max_batch": 16, "shed_slack": 0.5}
    clock, jclock = VClock(), VClock()
    eng = DLRMServeEngine(
        params_from_jax(host), cfg,
        CachedEmbeddingBagCollection.build(cfg, cache_rows=192),
        clock=clock, injector=DuckInjector(schedule), **kw)
    jeng = JServe(jparams, jcfg, JCC.build(jcfg, cache_rows=192),
                  clock=jclock, injector=DuckInjector(schedule), **kw)
    n = _replay(eng, cfg, ebc, ServeRequest, clock)
    _replay(jeng, cfg, ebc, JRequest, jclock)

    assert sorted(eng.results) == sorted(jeng.results) == list(range(n))
    for uid in range(n):
        got, want = eng.results[uid], jeng.results[uid]
        if isinstance(want, JOverloaded):
            assert isinstance(got, Overloaded)
            assert (got.reason, got.queue_depth, got.at) == \
                (want.reason, want.queue_depth, want.at)
        else:
            assert (got.degraded, got.latency) == (want.degraded,
                                                   want.latency)
            np.testing.assert_allclose(got.probs, want.probs, **PROB_TOL)
    assert eng.breaker.transitions == jeng.breaker.transitions
    assert eng.breaker.state == jeng.breaker.state
    assert eng.metrics.snapshot() == jeng.metrics.snapshot()
    _assert_same_tier(eng.state, jeng.state)
    np.testing.assert_array_equal(eng.snapshot.seen, jeng.snapshot.seen)
    if schedule:
        assert eng.metrics.stale_batches > 0     # the degraded path ran

    # the serving invariant inside the port: healthy == big-cache engine
    oracle = DLRMEngine(params_from_jax(host), cfg,
                        CachedEmbeddingBagCollection.build(cfg,
                                                           cache_rows=2048))
    healthy = 0
    for uid in range(n):
        res = eng.results[uid]
        if isinstance(res, Overloaded) or res.degraded:
            continue
        dense, idx = _request_arrays(cfg, ebc, uid // 8, flash=True)
        np.testing.assert_array_equal(
            res.probs, oracle.predict({"dense": dense, "idx": idx}))
        healthy += 1
    assert healthy > 0


def test_serve_engine_rejects_never_servable_requests(setup):
    cfg, jcfg, ebc, jparams, host = setup
    eng = DLRMServeEngine(params_from_jax(host), cfg,
                          CachedEmbeddingBagCollection.build(cfg,
                                                             cache_rows=8),
                          max_batch=4)
    dense, idx = _request_arrays(cfg, ebc, 0)
    with pytest.raises(ValueError, match="max_batch"):
        eng.submit(ServeRequest(0, np.tile(dense, (2, 1)),
                                np.tile(idx, (2, 1, 1))))
    with pytest.raises(ValueError, match="cache_rows"):
        eng.submit(ServeRequest(1, dense, idx))


def test_fetch_chunk_above_one_names_the_later_slice():
    with pytest.raises(NotImplementedError, match="later slice"):
        CachedEmbeddingBagCollection.build(get_smoke_config("dlrm-m1"),
                                           fetch_chunk=8)
