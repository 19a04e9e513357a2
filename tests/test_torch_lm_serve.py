"""The port's LM slot engine (`serve.engine.ServeEngine`) and the LM mode of
its serving launcher, at the smoke size of stablelm-1.6b (and of the MoE,
SSM and hybrid archs where named) on the CPU.

The reference's five engine tests (tests/test_lm_behaviour.py) ported to
the port, on the port's own parameters: greedy tokens through the engine
are equal to the engine's own decode function fed the same positions, and
logits agree within the reference's bf16 tolerance (3e-2) where those
tests use it. Against the reference: the port's engine gives the JAX
engine's greedy tokens exactly, in fp32 compute on the reference's
parameters (the logits agree to ~1e-5, far from any argmax tie here).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.models.lm import lm_param_specs as jspecs
from repro.nn.params import init_params as jinit
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models.lm import (decode_step, init_caches, init_lm_params,
                                   lm_forward)
from repro_torch.serve import DrainTimeout, Request, ServeEngine
from repro_torch.serve.engine import _reset_recurrent, _slot_caches


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file's tests: the suite's workers share
    the machine's cores, and at torch's default count a smoke model's
    small ops spin on busy cores (one test ran 55 times slower in the
    suite than alone). Every comparison here is made under this count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "stablelm-1.6b"
#: the MoE, SSM and hybrid archs
ZOO = ["granite-moe-1b-a400m", "granite-moe-3b-a800m", "mamba2-780m",
       "jamba-v0.1-52b"]


def _engine(seed, **kw):
    cfg = get_smoke_config(ARCH)
    return cfg, ServeEngine(init_lm_params(cfg, seed, device="cpu"), cfg,
                            **kw)


def _tok(t: int) -> torch.Tensor:
    return torch.full((1, 1), int(t), dtype=torch.long)


def test_serve_engine_drains_requests():
    cfg, eng = _engine(0, batch_slots=2, max_len=64)
    rng = np.random.RandomState(0)
    for uid in range(5):
        eng.submit(Request(uid=uid,
                           prompt=rng.randint(0, cfg.vocab_size,
                                              size=(4,)).astype(np.int32),
                           max_new_tokens=6))
    done = eng.run_until_drained(max_steps=500)
    assert sorted(done) == [0, 1, 2, 3, 4]
    assert all(len(v) == 6 for v in done.values())


def test_serve_prefill_matches_one_shot_forward():
    """The first sampled token comes from the LAST prompt position: the
    last prompt token enters the KV cache once, via the first `step()` at
    position len-1, and the engine's slot-local prefill writes only its
    slot's rows."""
    cfg, eng = _engine(3, batch_slots=1, max_len=32)
    params = eng.params
    rngn = np.random.RandomState(11)
    pl, new = 6, 4
    prompt = rngn.randint(0, cfg.vocab_size, size=(pl,)).astype(np.int32)

    # greedy reference through the engine's own decode function, positions
    # as the engine feeds them (scalar in prefill, per-slot in step)
    caches = init_caches(cfg, 1, 32, device="cpu")
    for t in range(pl - 1):
        eng._decode(params, _tok(prompt[t]), caches, t)
    pos = np.asarray([pl - 1], np.int64)
    tok = int(prompt[-1])
    want, first_logits = [], None
    for _ in range(new):
        lg, caches = eng._decode(params, _tok(tok), caches,
                                 torch.from_numpy(pos))
        if first_logits is None:
            first_logits = lg[0].float().numpy()
        tok = int(np.argmax(lg.float().numpy()[0]))
        want.append(tok)
        pos = pos + 1

    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=new))
    done = eng.run_until_drained(max_steps=100)
    assert done[0] == want

    # ... and that sampling position is the one-shot forward's last prompt
    # position
    full_logits, _, _ = lm_forward(params,
                                   {"tokens": torch.from_numpy(prompt[None])},
                                   cfg, "train")
    np.testing.assert_allclose(first_logits,
                               full_logits[0, pl - 1].float().numpy(),
                               rtol=3e-2, atol=3e-2)


def test_per_slot_decode_positions_match_isolated():
    """Batched decode with per-slot positions equals each sequence decoded
    alone (continuous batching)."""
    cfg = get_smoke_config(ARCH)
    params = init_lm_params(cfg, 5, device="cpu")
    rngn = np.random.RandomState(3)
    max_len = 16
    lens = [3, 7]
    prompts = [rngn.randint(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in lens]

    iso_logits = []
    for prom in prompts:
        caches = init_caches(cfg, 1, max_len, device="cpu")
        for t, tok in enumerate(prom):
            lg, caches = decode_step(params, _tok(tok), caches, t, cfg)
        iso_logits.append(lg[0].float().numpy())

    caches = init_caches(cfg, 2, max_len, device="cpu")
    pos = np.zeros(2, np.int64)
    out = [None, None]
    for t in range(max(lens)):
        toks = np.stack([[prompts[s][min(t, lens[s] - 1)]]
                         for s in range(2)]).astype(np.int64)
        lg, caches = decode_step(params, torch.from_numpy(toks), caches,
                                 torch.from_numpy(pos), cfg)
        for s in range(2):
            if t == lens[s] - 1:
                out[s] = lg[s].float().numpy()
        pos = np.minimum(pos + 1, np.asarray(lens) - 1)

    for s in range(2):
        np.testing.assert_allclose(out[s], iso_logits[s],
                                   rtol=3e-2, atol=3e-2)


def test_admission_writes_only_its_slot():
    """Admitting a request into slot 1 while slot 0 decodes leaves slot 0's
    cache rows as they were (the reference keeps them by merging only the
    admitted slot's rows; the port writes that slot's rows in place)."""
    cfg, eng = _engine(6, batch_slots=2, max_len=24)
    rng = np.random.RandomState(8)
    eng.submit(Request(uid=0, prompt=rng.randint(0, 256, size=(5,))
                       .astype(np.int32), max_new_tokens=8))
    eng.step()
    eng.step()
    before = {k: t[:, 0].clone() for k, t in eng.caches["b0"].items()}
    eng.submit(Request(uid=1, prompt=rng.randint(0, 256, size=(9,))
                       .astype(np.int32), max_new_tokens=2))
    eng._admit()
    for k, t in eng.caches["b0"].items():
        assert torch.equal(t[:, 0], before[k]), k
    assert eng.caches["b0"]["k"][:, 1, :8].abs().sum() > 0


def test_serve_submit_rejects_oversized_prompt_and_clamps_budget():
    cfg, eng = _engine(0, batch_slots=1, max_len=16)
    rng = np.random.RandomState(2)
    big = rng.randint(0, cfg.vocab_size, size=(16,)).astype(np.int32)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(uid=0, prompt=big, max_new_tokens=1))
    # 10-token prompt in a 16-token window: at most 6 new tokens fit
    eng.submit(Request(uid=1, prompt=big[:10], max_new_tokens=50))
    done = eng.run_until_drained(max_steps=100)
    assert len(done[1]) == 6
    assert int(eng.slot_pos[0]) <= eng.max_len - 1


def test_run_until_drained_timeout_returns_partial_work():
    cfg, eng = _engine(0, batch_slots=1, max_len=64)
    rng = np.random.RandomState(4)
    for uid in range(3):
        eng.submit(Request(uid=uid,
                           prompt=rng.randint(0, cfg.vocab_size,
                                              size=(4,)).astype(np.int32),
                           max_new_tokens=8))
    with pytest.raises(DrainTimeout) as ei:
        eng.run_until_drained(max_steps=10)
    err = ei.value
    assert 0 in err.completed and len(err.completed[0]) == 8
    assert set(err.undrained) == {1, 2}
    assert set(err.completed) | set(err.undrained) == {0, 1, 2}
    done = eng.run_until_drained(max_steps=500)
    assert sorted(done) == [0, 1, 2]
    assert all(len(v) == 8 for v in done.values())
    eng.submit(Request(uid=3, prompt=np.asarray([1, 2, 3], np.int32),
                       max_new_tokens=2))
    assert eng.steps_run > 8
    done = eng.run_until_drained(max_steps=8)
    assert len(done[3]) == 2


@pytest.mark.parametrize("slots", [1, 3])
@pytest.mark.parametrize("arch", [ARCH] + ZOO)
def test_greedy_tokens_equal_the_reference_engine(arch, slots):
    """Same requests, the reference's parameters, fp32 compute: the port's
    engine samples the JAX engine's tokens, request by request. An arch
    with Mamba-2 mixers gets one request a slot: the reference engine
    carries a slot's recurrent state into the next request it admits
    there, which the port resets (`test_reused_slots_serve_as_isolated_
    requests`), so the two agree only while no slot is reused."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype="float32")
    jp = jinit(jspecs(jcfg), jax.random.PRNGKey(7))
    params = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ours = ServeEngine(params, cfg, batch_slots=slots, max_len=32)
    theirs = JEngine(jp, jcfg, batch_slots=slots, max_len=32, rules={})
    rng = np.random.RandomState(9)
    n_requests = slots if "m" in cfg.pattern else 5
    for uid in range(n_requests):
        prompt = rng.randint(0, 256, size=(rng.randint(3, 9),)).astype(
            np.int32)
        ours.submit(Request(uid=uid, prompt=prompt.copy(),
                            max_new_tokens=7))
        theirs.submit(JRequest(uid=uid, prompt=prompt.copy(),
                               max_new_tokens=7))
    got = ours.run_until_drained(max_steps=200)
    want = theirs.run_until_drained(max_steps=200)
    assert got == want
    assert ours.steps_run == theirs.steps_run


@pytest.mark.parametrize("arch", ZOO)
def test_reused_slots_serve_as_isolated_requests(arch):
    """2 slots, 5 requests of 3-12 prompt tokens and 4-7 new tokens, fp32:
    every slot is reused, and each request's greedy tokens equal the same
    request served alone by a fresh one-slot engine. Without the reset of
    a slot's Mamba-2 state at admission, a reused slot would start from
    the previous request's state."""
    cfg = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    params = init_lm_params(cfg, 11, device="cpu")
    rng = np.random.RandomState(10)
    reqs = [(rng.randint(0, 256, size=(rng.randint(3, 13),)).astype(
        np.int32), int(rng.randint(4, 8))) for _ in range(5)]
    eng = ServeEngine(params, cfg, batch_slots=2, max_len=32)
    for uid, (prompt, new) in enumerate(reqs):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    got = eng.run_until_drained(max_steps=200)
    for uid, (prompt, new) in enumerate(reqs):
        alone = ServeEngine(params, cfg, batch_slots=1, max_len=32)
        alone.submit(Request(uid=0, prompt=prompt, max_new_tokens=new))
        assert got[uid] == alone.run_until_drained(max_steps=100)[0], uid
        assert len(got[uid]) == new


def test_admission_zeroes_only_its_slots_recurrent_state():
    """Admitting into slot 1 zeroes that slot's conv inputs and SSM state
    in every mixer before its prefill, and leaves slot 0's as they were."""
    cfg = get_smoke_config("jamba-v0.1-52b")
    eng = ServeEngine(init_lm_params(cfg, 12, device="cpu"), cfg,
                      batch_slots=2, max_len=24)
    for unit in eng.caches.values():
        for t in unit.values():
            t.fill_(1)
    slot_caches = _slot_caches(eng.caches, 1)
    _reset_recurrent(slot_caches)
    for name, unit in eng.caches.items():
        for key, t in unit.items():
            if "ssm" in unit:
                assert not t[:, 1].any() and bool((t[:, 0] == 1).all()), \
                    (name, key)
            else:
                assert bool((t == 1).all()), (name, key)
    assert slot_caches.max_len == 24


def test_launcher_lm_mode_on_the_cpu(capsys):
    from repro_torch.launch import serve
    argv = ["--arch", ARCH, "--smoke", "--requests", "6", "--slots", "2",
            "--max-len", "32", "--new-tokens", "5"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.main(argv)
    engine = serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("served 6 requests, 30 tokens in ")
    assert out[0].endswith(f"{engine.steps_run} engine steps)")
    assert len(out) == 5 and out[1].startswith("  req 0: [")
    assert engine.caches["b0"]["k"].device.type == "cpu"
    assert all(len(v) == 5 for v in engine.completed.values())


@pytest.mark.parametrize("arch", ZOO)
def test_launcher_serves_the_zoo_with_reused_slots(arch, capsys):
    from repro_torch.launch import serve
    engine = serve.main(["--arch", arch, "--smoke", "--requests", "5",
                         "--slots", "2", "--max-len", "48", "--new-tokens",
                         "4", "--prompt-len", "16", "24", "--compute-dtype",
                         "float32", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("served 5 requests, 20 tokens in ")
    assert engine.cfg.compute_dtype == "float32"
    reqs = serve.lm_requests(engine.cfg, 5, (16, 24), 4)
    assert all(16 <= len(r.prompt) <= 24 for r in reqs)
    assert sorted(engine.completed) == list(range(5))
    assert any("ssm" in unit for unit in engine.caches.values()) == \
        ("m" in engine.cfg.pattern)
