"""The port's chaos soak on the CPU (tests/test_chaos.py, ported): any
seeded fault schedule — a dead reader, transient-fetch bursts with
degradation to strict_sync, a preemption with a torn checkpoint leaf —
ends with losses, the materialized capacity tier, its accumulators and
the dense parameters BIT-EQUAL to the port's fault-free run. Recovery
restores the TrainState bundle (params, optimizer state, the cache tier's
`state_dict`, the pipeline cursor) from the newest intact checkpoint and
replays. The reference's bulk, multi-host and elastic cases wait for
their tiers.

Against the reference: `FaultInjector.from_seed` draws the reference's
schedules exactly, and a faulted run's losses and table match the
reference's fault-free run within STEP_TOL of tests/test_torch_train.py
(fp32 matmuls and sums in other orders). Smoke dlrm-m1, batch 8, a
256-slot cache, 8 steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import HAS_HYPOTHESIS, requires_hypothesis

from repro.configs import get_smoke_config as jget_smoke
from repro.core import cache as jcache
from repro.core.dlrm import dlrm_param_specs as jspecs
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.core.tiers import AsyncCachedTier as JAsyncTier
from repro.nn.params import init_params as jinit
from repro.optim import adagrad as jadagrad
from repro.train import fault_tolerance as jft
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.cache import CachedEmbeddingBagCollection
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.core.tiers import AsyncCachedTier
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import make_dlrm_batch
from repro_torch.kernels._build import KernelError
from repro_torch.nn.params import tree_leaves
from repro_torch.optim import adagrad
from repro_torch.train import fault_tolerance as ft
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.fault_tolerance import (DegradationManager,
                                               FaultInjector, FaultSpec,
                                               PreemptionHandler,
                                               RetryPolicy,
                                               StragglerDetector, TrainState,
                                               restore_train_state,
                                               run_chaos_loop,
                                               run_resilient_loop,
                                               save_train_state)
from repro_torch.train.steps import (build_cached_train_step,
                                     cached_dlrm_init_state)

if HAS_HYPOTHESIS:
    from hypothesis import given, settings
    from hypothesis import strategies as st

STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
N_STEPS, BATCH, CACHE_ROWS = 8, 8, 256


@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    jcfg = jget_smoke("dlrm-m1")
    jebc = JEBC.build(jcfg, n_shards=1, strategy="replicated")
    host = jax.tree.map(np.asarray, jinit(jspecs(jcfg, jebc),
                                          jax.random.PRNGKey(0)))
    return cfg, ebc, jcfg, host


def _batch(cfg, ebc, t):
    raw = make_dlrm_batch(cfg, BATCH, step=t)
    return {"dense": raw["dense"], "idx": ebc.offset_indices(raw["idx"]),
            "label": raw["label"]}


def _tools(cfg, host, tier="async", injector=None, retry=None):
    """(collection, step adapter, dense, cstate, tier state) of a fresh job
    from `host`'s parameters (the tier takes ownership of its table)."""
    opt = adagrad(0.01)
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=CACHE_ROWS)
    cc = dataclasses.replace(cc, injector=injector, retry=retry)
    params = params_from_jax(host, device="cpu")
    dense = {"bottom": params["bottom"], "top": params["top"]}
    cstate = cached_dlrm_init_state(cc, opt, params)
    if tier == "async":
        tstate = cc.init_async_state(params["emb"]["mega"])
        step = build_cached_train_step(cfg, AsyncCachedTier(cc), opt)
    else:
        tstate = cc.init_state(params["emb"]["mega"])
        sync = build_cached_train_step(cfg, cc, opt)

        def step(d, c, s, batch, t, next_batch=None):
            return sync(d, c, s, batch, t)
    return cc, step, dense, cstate, tstate


def _materialize(cc, tier, tstate):
    if tier == "async":
        return cc.materialize_async(tstate)
    return cc.materialize(tstate)


def _oracle(cfg, ebc, host, n_steps=N_STEPS):
    cc, step, dense, cstate, astate = _tools(cfg, host)
    losses = {}
    for t in range(n_steps):
        nxt = _batch(cfg, ebc, t + 1) if t + 1 < n_steps else None
        dense, cstate, m = step(dense, cstate, astate, _batch(cfg, ebc, t), t,
                                next_batch=nxt)
        losses[t] = float(m["loss"])
    mega, accum = cc.materialize_async(astate)
    return losses, mega, accum, dense


@pytest.fixture(scope="module")
def oracle(setup):
    cfg, ebc, _, host = setup
    return _oracle(cfg, ebc, host)


def _run_chaos(setup, ckpt_dir, injector, *, checkpoint_every=2, retry=None,
               degradation=None, max_restarts=10, keep=4):
    """`run_chaos_loop` over the whole stack: the DataPipeline (injector in
    the reader), the async cached tier (injector + retry on the fetch
    path), the CheckpointManager (torn leaves, CRC fallback) and the
    TrainState bundle."""
    cfg, ebc, _, host = setup
    mgr = CheckpointManager(str(ckpt_dir), keep=keep, injector=injector)
    losses: dict[int, float] = {}
    job: dict = {}

    def restore_cb():
        if job.get("pipe") is not None:
            job["pipe"].close()
        cc, step, dense, cstate, astate = _tools(cfg, host,
                                                 injector=injector,
                                                 retry=retry)
        example = TrainState(dense, cstate, cc.state_dict(astate), 0)
        try:
            ts = restore_train_state(mgr, example)
            astate = cc.load_state_dict(ts.cache)
            dense, cstate, start = ts.params, ts.opt_state, ts.step
        except FileNotFoundError:
            start = 0
        job.update(cc=cc, step=step, dense=dense, cstate=cstate,
                   astate=astate,
                   pipe=DataPipeline(lambda t: _batch(cfg, ebc, t),
                                     prefetch=2, start_step=start,
                                     injector=injector))
        return start

    def save_cb(step):
        save_train_state(mgr, TrainState(job["dense"], job["cstate"],
                                         job["cc"].state_dict(job["astate"]),
                                         step))

    def step_fn(step):
        t, batch = next(job["pipe"])
        assert t == step
        nxt = None
        if not (degradation is not None and degradation.degraded) \
                and step + 1 < N_STEPS:
            nxt = job["pipe"].peek(0)
        dense, cstate, m = job["step"](job["dense"], job["cstate"],
                                       job["astate"], batch, step,
                                       next_batch=nxt)
        job["dense"], job["cstate"] = dense, cstate
        losses[step] = float(m["loss"])

    rep = run_chaos_loop(step_fn, N_STEPS, save_cb=save_cb,
                         restore_cb=restore_cb,
                         checkpoint_every=checkpoint_every,
                         preemption=PreemptionHandler(signals=()),
                         injector=injector, degradation=degradation,
                         max_restarts=max_restarts)
    job["pipe"].close()
    mega, accum = job["cc"].materialize_async(job["astate"])
    return rep, mgr, (losses, mega, accum, job["dense"])


def _assert_matches_oracle(got, want):
    losses, mega, accum, dense = got
    want_l, want_m, want_a, want_d = want
    assert losses == want_l
    assert torch.equal(mega, want_m) and torch.equal(accum, want_a)
    for a, b in zip(tree_leaves(dense), tree_leaves(want_d), strict=True):
        assert torch.equal(a, b)

# ---------------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------------


def test_chaos_reader_death_resumes_bitexact(setup, oracle, tmp_path):
    inj = FaultInjector([FaultSpec("pipeline.batch", 4, "kill")])
    rep, _, got = _run_chaos(setup, tmp_path, inj)
    assert rep.restarts >= 1 and rep.last_step == N_STEPS
    assert ("pipeline.batch", 4, "kill") in inj.fired
    assert len(rep.recovery_s) == rep.restarts
    _assert_matches_oracle(got, oracle)


def test_chaos_fetch_fault_absorbed_by_retry(setup, oracle, tmp_path):
    inj = FaultInjector([FaultSpec("cache.fetch", 2, "error"),
                         FaultSpec("cache.fetch", 5, "latency", arg=1e-4)])
    rep, _, got = _run_chaos(setup, tmp_path, inj,
                             retry=RetryPolicy(max_retries=2, backoff_s=1e-5))
    assert rep.restarts == 0 and len(inj.fired) == 2
    _assert_matches_oracle(got, oracle)


def test_chaos_fetch_burst_degrades_then_promotes(setup, oracle, tmp_path):
    inj = FaultInjector([FaultSpec("cache.fetch", at, "error")
                         for at in range(3, 15)])
    deg = DegradationManager(demote_after=2, promote_after=2)
    rep, _, got = _run_chaos(setup, tmp_path, inj,
                             retry=RetryPolicy(max_retries=1, backoff_s=1e-5),
                             degradation=deg)
    assert rep.restarts >= 2
    assert deg.demotions >= 1 and deg.promotions >= 1
    assert rep.degraded_steps > 0 and deg.mode == "async"
    _assert_matches_oracle(got, oracle)


def test_chaos_preempt_with_torn_checkpoint_falls_back(setup, oracle,
                                                       tmp_path):
    """Saves at 2 (write 0) and 4 (write 1); the preemption save at 5
    (write 2) is torn after its publish, so the restart falls back to 4."""
    inj = FaultInjector([FaultSpec("loop.step", 4, "preempt"),
                         FaultSpec("checkpoint.write", 2, "torn", arg=1)])
    rep, mgr, got = _run_chaos(setup, tmp_path, inj)
    assert rep.restarts == 1 and mgr.last_restored_step == 4
    assert 8 in mgr.saved_steps()
    _assert_matches_oracle(got, oracle)


def test_byte_flip_on_disk_falls_back_to_previous_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": np.arange(8, dtype=np.float32), "b": np.ones(3, np.float32)}
    mgr.save(1, tree)
    mgr.save(2, {"w": tree["w"] * 2, "b": tree["b"] * 3})
    leaf = sorted((tmp_path / "step_000000002").glob("leaf_*.npy"))[0]
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    got = mgr.restore(tree)
    assert mgr.last_restored_step == 1
    np.testing.assert_array_equal(got["w"], tree["w"])


def test_a_faulted_run_matches_the_reference_fault_free_run(setup, tmp_path):
    cfg, ebc, jcfg, host = setup
    inj = FaultInjector([FaultSpec("pipeline.batch", 3, "error"),
                         FaultSpec("cache.fetch", 4, "error")])
    _, _, (losses, mega, accum, _) = _run_chaos(
        setup, tmp_path, inj, retry=RetryPolicy(max_retries=1,
                                                backoff_s=1e-5))
    opt = jadagrad(0.01)
    jparams = jax.tree.map(jnp.asarray, host)
    cc = jcache.CachedEmbeddingBagCollection.build(jcfg,
                                                   cache_rows=CACHE_ROWS)
    dense = {"bottom": jparams["bottom"], "top": jparams["top"]}
    cstate = jsteps.cached_dlrm_init_state(cc, opt, jparams)
    astate = cc.init_async_state(jparams["emb"]["mega"])
    step = jsteps.build_cached_train_step(jcfg, JAsyncTier(cc), opt)
    want = []
    for t in range(N_STEPS):
        jb = lambda b: {"dense": jnp.asarray(b["dense"]),  # noqa: E731
                        "idx": b["idx"], "label": jnp.asarray(b["label"])}
        nxt = (jb(_batch(cfg, ebc, t + 1)) if t + 1 < N_STEPS else None)
        dense, cstate, m = step(dense, cstate, astate, jb(_batch(cfg, ebc, t)),
                                jnp.asarray(t, jnp.int32), next_batch=nxt)
        want.append(float(m["loss"]))
    jmega, jaccum = cc.materialize_async(astate)
    np.testing.assert_allclose([losses[t] for t in range(N_STEPS)], want,
                               **STEP_TOL)
    np.testing.assert_allclose(mega.numpy(), np.asarray(jmega), **STEP_TOL)
    np.testing.assert_allclose(accum.numpy(), np.asarray(jaccum), **STEP_TOL)

# ---------------------------------------------------------------------------
# the fault schedule, retry, loops
# ---------------------------------------------------------------------------


SITE_SETS = [("pipeline.batch", "cache.fetch", "loop.step"),
             ("pipeline.batch", "checkpoint.write", "loop.step"),
             ("serve.fetch", "serve.admit"), ("cache.fetch",)]


@pytest.mark.parametrize("seed", range(21))
def test_from_seed_draws_the_reference_schedule(seed):
    for sites in SITE_SETS:
        for n_steps, n_faults in ((16, 3), (32, 2), (1, 1)):
            got = FaultInjector.from_seed(seed, n_steps, sites, n_faults)
            want = jft.FaultInjector.from_seed(seed, n_steps, sites,
                                               n_faults)
            assert [dataclasses.astuple(s) for s in got.schedule] == \
                [dataclasses.astuple(s) for s in want.schedule]


def test_chaos_seeded_schedule_is_deterministic():
    a, b = FaultInjector.from_seed(11, 16), FaultInjector.from_seed(11, 16)
    c = FaultInjector.from_seed(12, 16)
    assert [dataclasses.astuple(s) for s in a.schedule] == \
        [dataclasses.astuple(s) for s in b.schedule]
    assert [dataclasses.astuple(s) for s in a.schedule] != \
        [dataclasses.astuple(s) for s in c.schedule]


def test_fault_injector_kinds_and_unknown_names():
    with pytest.raises(ValueError, match="site"):
        FaultInjector([FaultSpec("no.such.site", 0, "error")])
    with pytest.raises(ValueError, match="kind"):
        FaultInjector([FaultSpec("loop.step", 0, "meteor")])
    inj = FaultInjector([FaultSpec("cache.fetch", 1, "error"),
                         FaultSpec("pipeline.batch", 0, "error"),
                         FaultSpec("pipeline.batch", 1, "kill"),
                         FaultSpec("checkpoint.write", 0, "torn", arg=2)])
    assert inj.fire("cache.fetch") is None
    with pytest.raises(ft.TransientFetchFault):
        inj.fire("cache.fetch")
    with pytest.raises(ft.InjectedFault) as e:
        inj.fire("pipeline.batch")
    assert not getattr(e.value, "transient", False)
    with pytest.raises(SystemExit):
        inj.fire("pipeline.batch")
    assert inj.fire("checkpoint.write").arg == 2
    assert [f[0] for f in inj.fired] == ["cache.fetch", "pipeline.batch",
                                         "pipeline.batch",
                                         "checkpoint.write"]


def _failing_loop(exc, restores):
    def restore_cb():
        restores.append(1)
        return 0

    def step_fn(step):
        raise exc

    return run_chaos_loop(step_fn, 4, save_cb=lambda s: None,
                          restore_cb=restore_cb)


@pytest.mark.parametrize("exc", [
    KernelError("CUDA kernel x failed to launch"),
    torch.OutOfMemoryError("CUDA out of memory"),
    ValueError("a caller's bug")], ids=["kernel", "oom", "value"])
def test_chaos_loop_raises_what_a_replay_cannot_cure(exc):
    restores = []
    with pytest.raises(type(exc)):
        _failing_loop(exc, restores)
    assert restores == [1]                 # the first restore only: 0 restarts
    assert not ft._recoverable(exc)
    assert isinstance(KernelError("x"), RuntimeError)


def test_chaos_loop_replays_injected_and_runtime_faults():
    for exc in (ft.InjectedFault("x"), ft.TransientFetchFault("x"),
                RuntimeError("data pipeline worker failed at step 3")):
        assert ft._recoverable(exc)
    restores = []
    with pytest.raises(ft.InjectedFault):
        _failing_loop(ft.InjectedFault("again and again"), restores)
    assert len(restores) == 1 + 8          # max_restarts replays, then raise


def test_retry_policy_backs_off_within_its_cap(monkeypatch):
    slept = []
    monkeypatch.setattr(ft.time, "sleep", slept.append)
    pol = RetryPolicy(max_retries=5, backoff_s=0.01, multiplier=3.0,
                      max_backoff_s=0.05)
    for attempt in (1, 2, 3):
        pol.sleep(attempt)
    assert slept == [0.01, pytest.approx(0.03), 0.05]


def test_preemption_checkpoints_and_stops():
    preempt = PreemptionHandler(signals=())
    saved = []

    def step_fn(step):
        if step == 4:
            preempt.trigger()

    assert run_resilient_loop(step_fn, 100, saved.append,
                              checkpoint_every=50, preemption=preempt) == 5
    assert saved == [5]


def test_preemption_at_checkpoint_boundary_saves_once():
    preempt = PreemptionHandler(signals=())
    saved = []

    def step_fn(step):
        if step == 4:
            preempt.trigger()

    assert run_resilient_loop(step_fn, 100, saved.append,
                              checkpoint_every=5, preemption=preempt) == 5
    assert saved == [5]


def test_loop_step_preempt_spec_stops_the_resilient_loop():
    preempt = PreemptionHandler(signals=())
    inj = FaultInjector([FaultSpec("loop.step", 2, "preempt")])
    saved = []
    assert run_resilient_loop(lambda s: None, 10, saved.append, 4, preempt,
                              injector=inj) == 3
    assert saved == [3]


def test_straggler_detection():
    det = StragglerDetector(window=20, z_threshold=3.0, warmup=5)
    for _ in range(19):
        det.record(0.10 + np.random.RandomState(1).rand() * 1e-3)
    assert det.record(0.50) is True
    assert det.flagged_steps

# ---------------------------------------------------------------------------
# snapshot / restore + faults == uninterrupted, on the sync and async tiers
# ---------------------------------------------------------------------------


def _check_resume_equivalence(setup, tier, seed):
    """state_dict -> load_state_dict -> 2 more steps in a FRESH collection
    whose fetch path has a seeded schedule of transient faults equals 4
    uninterrupted steps, bit for bit."""
    cfg, ebc, _, host = setup
    n1, n2 = 2, 2

    def segment(step, dense, cstate, tstate, t0, t1):
        losses = []
        for t in range(t0, t1):
            nxt = _batch(cfg, ebc, t + 1) if t + 1 < n1 + n2 else None
            dense, cstate, m = step(dense, cstate, tstate,
                                    _batch(cfg, ebc, t), t, next_batch=nxt)
            losses.append(float(m["loss"]))
        return dense, cstate, losses

    cc, step, dense, cstate, tstate = _tools(cfg, host, tier)
    _, _, want_l = segment(step, dense, cstate, tstate, 0, n1 + n2)
    want_m, want_a = _materialize(cc, tier, tstate)

    cc, step, dense, cstate, tstate = _tools(cfg, host, tier)
    dense, cstate, l1 = segment(step, dense, cstate, tstate, 0, n1)
    snap = cc.state_dict(tstate)
    inj = FaultInjector.from_seed(seed, 32, sites=("cache.fetch",),
                                  n_faults=2)
    cc2, step2, _, _, fresh = _tools(cfg, host, tier, injector=inj,
                                     retry=RetryPolicy(max_retries=3,
                                                       backoff_s=1e-5))
    del fresh
    tstate2 = cc2.load_state_dict(snap)
    _, _, l2 = segment(step2, dense, cstate, tstate2, n1, n1 + n2)
    got_m, got_a = _materialize(cc2, tier, tstate2)
    assert l1 + l2 == want_l
    assert torch.equal(got_m, want_m) and torch.equal(got_a, want_a)


@pytest.mark.parametrize("tier", ["sync", "async"])
def test_resume_under_faults_equals_uninterrupted(setup, tier):
    _check_resume_equivalence(setup, tier, seed=5)


def test_state_dict_drains_unwinds_and_owns_its_host_maps(setup):
    cfg, ebc, _, host = setup
    cc, step, dense, cstate, astate = _tools(cfg, host)
    dense, cstate, _ = step(dense, cstate, astate, _batch(cfg, ebc, 0), 0,
                            next_batch=_batch(cfg, ebc, 1))
    assert astate.staged is not None
    before = astate.stats.steps
    snap = cc.state_dict(astate)
    assert astate.staged is None and not astate.pending
    assert astate.stats.steps == before - 1          # unwound to a prefetch
    assert snap["capacity"] is astate.capacity       # the tier's own tensor
    snap["slot_row"][:] = -7                          # an owned copy
    assert (astate.slot_row != -7).any()
    assert set(snap) == {"capacity", "cap_accum", "cache", "cache_accum",
                         "freq", "slot_row", "row_slot", "dirty", "ema",
                         "ema_tick", "tick", "stats", "slot_epoch", "epoch"}
    back = AsyncCachedTier(cc).load_state_dict(
        {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
         for k, v in snap.items()}, device="cpu")
    assert torch.equal(back.cache, astate.cache)
    np.testing.assert_array_equal(back.row_slot, astate.row_slot)
    assert back.stats == astate.stats and back.epoch == astate.epoch


if HAS_HYPOTHESIS:

    @requires_hypothesis
    @settings(max_examples=3, deadline=None)
    @given(tier=st.sampled_from(["sync", "async"]),
           seed=st.integers(0, 10 ** 6))
    def test_resume_under_fuzzed_faults_equals_uninterrupted(setup, tier,
                                                             seed):
        _check_resume_equivalence(setup, tier, seed)
