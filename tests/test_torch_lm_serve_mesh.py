"""LM serving over a (data, model) mesh on gloo CPU ranks: `prefill_step`
and `decode_step(rules=, mesh=)`, `init_caches(rules=, mesh=)` and
`ServeEngine(rules=, mesh=)` against the port's one-device serving, and
in two cases the reference's; `cache_abstract` and `cache_pspecs`
against the reference's with no ranks.

One world of 4 ranks (`launch.mesh.run_ranks` with
`train.sharded.run_calls`) runs every case's `lm_serve_rank` in turn:
smoke configs, a prompt of BATCH x SEQ tokens, then DECODE greedy decode
steps (each step fed the argmax of the gathered logits), the caches of
SEQ + DECODE (+ 4 where rows step at their own positions) positions:
  * stablelm-1.6b under SERVE_RULES on (1, 4) and (2, 2), under
    LONG_SERVE_RULES on (1, 4) (the rows at their own positions), under
    the dry run's prefill override (`serve.sharded.prefill_rules`:
    weights FSDP-stored over `data` and gathered at each use, no
    `_fallback`) on (2, 2), and with 6 heads on (1, 4), which `model`
    does not divide (`_fallback` moves the axis to head_dim);
  * chatglm3-6b, whose 2 kv heads `model` does not divide (the cache is
    whole on every `model` rank);
  * qwen1.5-32b's int8 cache under LONG_SERVE_RULES, rows at their own
    positions;
  * granite-moe-1b-a400m, mamba2-780m, jamba-v0.1-52b, musicgen-large
    (K codebooks in and out) and internvl2-26b (a patch prefix) under
    SERVE_RULES on (1, 4);
  * stablelm-1.6b in bf16 compute on (1, 4), teacher-forced on the
    one-device run's tokens;
  * the engine: mamba2-780m's `ServeEngine` on (2, 2), 4 requests over 2
    slots (every slot serves two).
The (2, 2) stablelm case and the granite case run on the reference's
parameters (`convert.lm_params_from_jax`) and are also held to the
reference's own prefill_step / decode_step(rules=SERVE_RULES).

Tolerances, each with its reason:
  * fp32 logits against the one-device port: each step's within 1e-5
    relative L2 and 1e-4 absolute (the ranks add tensor-parallel partial
    sums, the flash-decoding merge and the gated norm's sum over ranks
    in other orders: <= 8.3e-7 relative and 3.3e-6 absolute, but for
    jamba, whose 16 layers and ~10^3 residual stream carry it to 7.4e-6
    and 3.0e-5 at |logit| 3.6);
  * bf16 logits: atol 0.125, rtol 3e-2, `test_torch_lm.py`'s whole-model
    bf16 bound (each rank rounds its partial sums to bf16 before the sum
    over ranks);
  * against the reference: `test_torch_lm.py`'s MODEL_TOL / DECODE_TOL;
  * the caches against their block of the one-device caches, a leaf's
    relative L2: bf16 K/V and conv inputs, and the fp32 state that
    decode feeds from those inputs, within 2^-8 (where the ranks' sums
    differ in the last fp32 bits, an element rounds to the other bf16
    neighbour: jamba's ~10^3 stream reads 6.0e-4 on its conv tail and
    8.8e-4 on its state, the rest <= 2.0e-4); int8 K/V within one
    quantization step an element, the scales within 1e-5; under bf16
    compute within 2e-2 (its own rounding: 6.2e-3);
  * tokens, collective counts, bytes, shapes and specs: exact.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.models import lm as jlm
from repro.nn import sharding as jsharding
from repro.nn.params import init_params as jinit
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.registry import ARCHS
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm
from repro_torch.nn import mamba2 as M
from repro_torch.nn import sharding
from repro_torch.nn.params import tree_leaves, tree_map
from repro_torch.nn.sharding import NamedSharding, resolve_sized
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.sharded import lm_serve_collectives, prefill_rules
from repro_torch.train.sharded import lm_serve_rank, run_calls, serve_steps

BATCH, SEQ, DECODE = 2, 32, 4
SPAWN_TIMEOUT_S = 300
LOGIT_REL_L2, LOGIT_ATOL = 1e-5, 1e-4
CACHE_REL_L2, CACHE_BF16_REL_L2 = 2 ** -8, 2e-2
BF16_TOL = {"rtol": 3e-2, "atol": 0.125}
MODEL_TOL = {"rtol": 1e-4, "atol": 1e-4}
DECODE_TOL = {"rtol": 1e-3, "atol": 1e-3}
M14, M22 = ((1, 4), ("data", "model")), ((2, 2), ("data", "model"))
TABLES = ["SERVE_RULES", "LONG_SERVE_RULES"]
MESHES = [(("data", "model"), (2, 4)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16))]

#: (name, arch, table, mesh, config changes, options): "rows" steps each
#: row at its own position, "jax" takes the reference's parameters,
#: "feed" teacher-forces the one-device tokens
CASES = [
    ("stablelm-serve-1x4", "stablelm-1.6b", "SERVE_RULES", M14, {}, {}),
    ("stablelm-serve-2x2", "stablelm-1.6b", "SERVE_RULES", M22, {},
     {"jax": True}),
    ("stablelm-long-1x4", "stablelm-1.6b", "LONG_SERVE_RULES", M14, {},
     {"rows": True}),
    ("stablelm-prefill-override-2x2", "stablelm-1.6b", "PREFILL", M22, {},
     {}),
    ("stablelm-6-heads-fallback-1x4", "stablelm-1.6b", "SERVE_RULES", M14,
     {"n_heads": 6, "n_kv_heads": 6}, {}),
    ("chatglm3-2-kv-heads-1x4", "chatglm3-6b", "SERVE_RULES", M14, {}, {}),
    ("qwen-int8-long-1x4", "qwen1.5-32b", "LONG_SERVE_RULES", M14, {},
     {"rows": True}),
    ("granite-moe-serve-1x4", "granite-moe-1b-a400m", "SERVE_RULES", M14,
     {}, {"jax": True}),
    ("mamba2-serve-1x4", "mamba2-780m", "SERVE_RULES", M14, {}, {}),
    ("jamba-serve-1x4", "jamba-v0.1-52b", "SERVE_RULES", M14, {}, {}),
    ("musicgen-serve-1x4", "musicgen-large", "SERVE_RULES", M14, {}, {}),
    ("internvl2-serve-1x4", "internvl2-26b", "SERVE_RULES", M14, {}, {}),
    ("stablelm-bf16-1x4", "stablelm-1.6b", "SERVE_RULES", M14,
     {"compute_dtype": "bfloat16"}, {"feed": True}),
]
IDS = [c[0] for c in CASES]
REF_CASES = [i for i, c in enumerate(CASES) if c[5].get("jax")]
#: the engine's run: arch, slots, max_len, requests (uid, prompt length,
#: new tokens)
ENGINE = ("mamba2-780m", 2, 48, [(0, 5, 6), (1, 9, 4), (2, 3, 7),
                                 (3, 7, 5)])


def _cfg(arch, over):
    return dataclasses.replace(get_smoke_config(arch),
                               **{"compute_dtype": "float32", **over})


def _jcfg(arch, over):
    return dataclasses.replace(jget_smoke(arch),
                               **{"compute_dtype": "float32", **over})


def _rules(table):
    return prefill_rules(sharding.SERVE_RULES) if table == "PREFILL" \
        else getattr(sharding, table)


def _mesh_ns(mesh, coords=None):
    shape, names = mesh
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)),
                           coords=coords or {a: 0 for a in names})


def _prompt(cfg):
    b = make_lm_batch(cfg, BATCH, SEQ, 0, 0)
    if cfg.frontend == "audio":
        return {"embeds": b["embeds"]}
    if cfg.frontend == "vision":
        return {"embeds": b["embeds"], "tokens": b["tokens"]}
    return b["tokens"]


def _length(cfg, prompt):
    if isinstance(prompt, dict):
        return sum(v.shape[1] for v in prompt.values())
    return prompt.shape[1]


def _positions(cfg, prompt, opts):
    """Each decode step's positions: shared, or row r at s + i + r."""
    s = _length(cfg, prompt)
    if not opts.get("rows"):
        return None, s + DECODE
    return ([np.arange(BATCH) + s + i for i in range(DECODE)],
            s + DECODE + BATCH + 2)


def _setup(case):
    """(cfg, numpy parameters, prompt, positions, max_len, reference
    parameters or None)."""
    name, arch, table, mesh, over, opts = case
    cfg = _cfg(arch, over)
    jp = None
    if opts.get("jax"):
        jp = jinit(jlm.lm_param_specs(_jcfg(arch, over)),
                   jax.random.PRNGKey(4))
        tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    else:
        tp = lm.init_lm_params(cfg, 1, "cpu")
    prompt = _prompt(cfg)
    positions, max_len = _positions(cfg, prompt, opts)
    return (cfg, tree_map(lambda t: t.numpy(), tp), prompt, positions,
            max_len, jp)


def _one_device(cfg, params, prompt, positions, max_len, feed=None):
    logits = []

    def run(fn):
        with torch.no_grad():
            lg = fn()[0].float()
        logits.append(lg.numpy())
        return lg
    caches, fed = serve_steps(tree_map(torch.from_numpy, params), cfg,
                              prompt, DECODE, max_len, feed, positions,
                              run=run)
    return {"logits": logits, "fed": fed, "caches": caches}


def _engine_requests(cfg):
    rng = np.random.RandomState(3)
    return [(uid, rng.randint(0, cfg.vocab_size, size=(n,)).astype(
        np.int32), budget) for uid, n, budget in ENGINE[3]]


@pytest.fixture(scope="module")
def oracles():
    out = []
    for case in CASES:
        cfg, params, prompt, positions, max_len, jp = _setup(case)
        out.append(_one_device(cfg, params, prompt, positions, max_len))
    return out


@pytest.fixture(scope="module")
def world(oracles):
    """Every case's `lm_serve_rank` reports (a list in rank order), then
    the engine's."""
    calls = []
    for case, want in zip(CASES, oracles):
        cfg, params, prompt, positions, max_len, _ = _setup(case)
        calls.append((lm_serve_rank, {
            "cfg": cfg, "rules": _rules(case[2]), "mesh": case[3],
            "params": params, "prompt": prompt, "decode": DECODE,
            "max_len": max_len, "positions": positions,
            "feed": want["fed"] if case[5].get("feed") else None,
            "report_caches": True}))
    arch, slots, max_len, _ = ENGINE
    cfg = _cfg(arch, {})
    calls.append((lm_serve_rank, {
        "cfg": cfg, "rules": "SERVE_RULES", "mesh": M22,
        "params": tree_map(lambda t: t.numpy(),
                           lm.init_lm_params(cfg, 2, "cpu")),
        "engine": {"slots": slots, "max_len": max_len,
                   "requests": _engine_requests(cfg)}}))
    res = tmesh.run_ranks(run_calls, 4, (calls,), backend="gloo",
                          device="cpu", timeout_s=SPAWN_TIMEOUT_S)
    per = [[r[i] for r in res] for i in range(len(calls))]
    return {"cases": per[:len(CASES)], "engine": per[-1]}


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_gathered_logits_match_one_device(world, oracles, i):
    """Every rank gets the same whole logits ((B, V), or (B, K, V) for the
    audio arch) a step, those of the one-device port; greedy runs feed
    the same tokens."""
    reps, want = world["cases"][i], oracles[i]
    cfg = _setup(CASES[i])[0]
    shape = (BATCH, cfg.n_codebooks, cfg.vocab_size) \
        if cfg.frontend == "audio" else (BATCH, cfg.vocab_size)
    for r in reps:
        assert r["logits_bits"] == reps[0]["logits_bits"]
        assert r["fed"] == want["fed"]
        assert len(r["logits"]) == DECODE + 1
        for got, w in zip(r["logits"], want["logits"]):
            assert got.shape == shape
            if cfg.compute_dtype == "bfloat16":
                np.testing.assert_allclose(got, w, **BF16_TOL)
            else:
                assert np.linalg.norm(got - w) <= LOGIT_REL_L2 * \
                    np.linalg.norm(w)
                np.testing.assert_allclose(got, w, rtol=0, atol=LOGIT_ATOL)


def _cache_blocks(cfg, table, mesh, coords, whole, max_len):
    """This rank's block of each one-device cache leaf (numpy)."""
    m = _mesh_ns(mesh, coords)
    rules = _rules(table)
    specs = lm.cache_pspecs(cfg, rules, m, BATCH, max_len)
    out = {}
    for name, leaves in whole.items():
        out[name] = {}
        for k, t in leaves.items():
            t = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
            if k == "conv":
                rows = NamedSharding(m, (None,) + tuple(specs[name][k][1:2])
                                     ).local_slice(t.shape[:2])
                chans = M.conv_channels(cfg, rules, m)
                t = np.concatenate([t[rows][..., lo:hi]
                                    for lo, hi in chans], axis=-1)
            else:
                t = t[NamedSharding(m, specs[name][k]).local_slice(t.shape)]
            out[name][k] = t
    return out


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_rank_caches_are_their_blocks(world, oracles, i):
    """Each rank's caches are its block of the one-device caches
    (`cache_pspecs`' blocks; a mixer's conv tail its channels by
    `nn.mamba2.conv_channels`)."""
    name, arch, table, mesh, over, opts = CASES[i]
    cfg, _, prompt, _, max_len, _ = _setup(CASES[i])
    for r in world["cases"][i]:
        want = _cache_blocks(cfg, table, mesh, r["coords"],
                             oracles[i]["caches"], max_len)
        for block, leaves in want.items():
            for k, w in leaves.items():
                got = r["caches"][block][k]
                assert got.shape == w.shape, (block, k)
                if got.dtype == np.int8:
                    assert np.abs(got.astype(np.int32)
                                  - w.astype(np.int32)).max() <= 1
                    continue
                tol = 1e-5 if k.endswith("_scale") else (
                    CACHE_BF16_REL_L2 if cfg.compute_dtype == "bfloat16"
                    else CACHE_REL_L2)
                assert np.linalg.norm(got - w) <= tol * np.linalg.norm(w), \
                    (block, k)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_collective_counts_are_the_reckoning(world, i):
    """Each rank's `Mesh.stats` calls of the prefill and of each decode
    step, per axis, are `lm_serve_collectives`'; no all_to_all."""
    name, arch, table, mesh, over, opts = CASES[i]
    cfg, _, _, _, max_len, _ = _setup(CASES[i])
    for r in world["cases"][i]:
        for t, st in enumerate(r["collectives"]):
            want = lm_serve_collectives(cfg, _rules(table), _mesh_ns(mesh),
                                        "prefill" if t == 0 else "decode",
                                        max_len)
            got = {k[:-len("_calls")]: v for k, v in st.items()
                   if "@" in k and k.endswith("_calls") and v}
            assert got == want, (t, got, want)
            assert st["all_to_all_calls"] == 0


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_ranks_hold_only_their_blocks(world, i):
    """A rank's parameter bytes are its `resolve_sized` blocks', its cache
    bytes those of `init_caches(rules=, mesh=)` on its coordinates."""
    name, arch, table, mesh, over, opts = CASES[i]
    cfg, _, _, _, max_len, _ = _setup(CASES[i])
    rules = _rules(table)
    for r in world["cases"][i]:
        m = _mesh_ns(mesh, r["coords"])
        want = sum(4 * int(np.prod(NamedSharding(m, resolve_sized(
            s.logical_axes, rules, m, s.shape)).local_shape(s.shape)))
            for s in tree_leaves(lm.lm_param_specs(cfg)))
        assert r["param_bytes"] == want
        caches = lm.init_caches(cfg, BATCH, max_len, "meta", rules, m)
        assert r["cache_bytes"] == sum(
            t.numel() * t.element_size() for c in caches.values()
            for t in c.values())
    if table == "SERVE_RULES" and mesh == M14 and arch == "stablelm-1.6b" \
            and not over:
        whole = sum(4 * int(np.prod(s.shape))
                    for s in tree_leaves(lm.lm_param_specs(cfg)))
        # the norms' scales alone are replicated
        assert want < whole / 3.9


@pytest.mark.parametrize("i", REF_CASES, ids=[IDS[i] for i in REF_CASES])
def test_sharded_serving_matches_the_reference(world, i):
    """The gathered logits against the reference's prefill_step and
    decode_step(rules=SERVE_RULES) (one device, jitted) on the same
    parameters and tokens."""
    name, arch, table, mesh, over, opts = CASES[i]
    cfg, _, prompt, positions, max_len, jp = _setup(CASES[i])
    jcfg = _jcfg(arch, over)
    rules = jsharding.SERVE_RULES
    pre = jax.jit(lambda p, b, c: jlm.prefill_step(p, b, c, jcfg, rules))
    dec = jax.jit(lambda p, t, c, i: jlm.decode_step(p, t, c, i, jcfg,
                                                     rules))
    caches = jlm.init_caches(jcfg, BATCH, max_len)
    want, caches = pre(jp, {"tokens": jnp.asarray(prompt)}, caches)
    reps = world["cases"][i]
    np.testing.assert_allclose(reps[0]["logits"][0], np.asarray(want),
                               **MODEL_TOL)
    for t, tok in enumerate(reps[0]["fed"]):
        want, caches = dec(jp, jnp.asarray(tok, jnp.int32)[:, None], caches,
                           jnp.asarray(SEQ + t, jnp.int32))
        np.testing.assert_allclose(reps[0]["logits"][t + 1],
                                   np.asarray(want), **DECODE_TOL)


def test_engine_over_a_mesh_gives_the_one_device_tokens(world):
    """`ServeEngine(rules=SERVE_RULES, mesh=)` on (2, 2), 4 requests over 2
    slots (one a `data` rank, each serving two): every rank completes
    every request with the one-device engine's greedy tokens (fp32)."""
    arch, slots, max_len, _ = ENGINE
    cfg = _cfg(arch, {})
    one = ServeEngine(lm.init_lm_params(cfg, 2, "cpu"), cfg, slots, max_len)
    for uid, prompt, budget in _engine_requests(cfg):
        one.submit(Request(uid=uid, prompt=prompt, max_new_tokens=budget))
    with torch.no_grad():
        want = one.run_until_drained()
    assert sorted(want) == [0, 1, 2, 3]
    for r in world["engine"]:
        assert r["engine"]["completed"] == want
        assert r["engine"]["steps"] == one.steps_run


def test_ranks_load_no_jax(world):
    assert not any(r["foreign_modules"] for run in world["cases"]
                   for r in run)
    assert not any(r["foreign_modules"] for r in world["engine"])


def test_prefill_launches_no_kernel_on_the_cpu(world):
    """CPU ranks take the kernels' plain versions: no launch anywhere."""
    for run in world["cases"]:
        for r in run:
            assert not any(v for st in r["launches"] for v in st.values())

# ---------------------------------------------------------------------------
# no ranks: the caches' shapes and specs against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_abstract_matches_the_reference(arch):
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (get_smoke_config(arch), jget_smoke(arch))):
        got = lm.cache_abstract(cfg, 8, 64)
        want = jlm.cache_abstract(jcfg, 8, 64)
        assert set(got) == set(want)
        for name in got:
            assert set(got[name]) == set(want[name])
            for k, t in got[name].items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[name][k].shape)
                assert str(t.dtype).split(".")[-1] == \
                    jnp.dtype(want[name][k].dtype).name


@pytest.mark.parametrize("table", TABLES)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_pspecs_match_the_reference(arch, table):
    """Every leaf's spec, over the production (16, 16) and (2, 16, 16)
    meshes and a (2, 4), at a batch and length each splits (32 x 32,768)
    and at ones neither does (3 x 1,001)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    rules, jrules = getattr(sharding, table), getattr(jsharding, table)
    for names, shape in MESHES:
        m = SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
        for batch, max_len in ((32, 32768), (3, 1001)):
            got = lm.cache_pspecs(cfg, rules, m, batch, max_len)
            want = jlm.cache_pspecs(jcfg, jrules, m, batch, max_len)
            assert set(got) == set(want)
            for name in got:
                assert set(got[name]) == set(want[name])
                for k in got[name]:
                    assert got[name][k] == tuple(want[name][k]), (name, k)


def test_init_caches_blocks_cover_the_caches():
    """Over every rank of a (2, 4) mesh, `init_caches(rules=, mesh=)`'s
    attention and state blocks are `cache_pspecs`' blocks; the conv
    tails hold each rank's channels, every channel on some `model`
    rank."""
    cfg = get_smoke_config("jamba-v0.1-52b")
    names, shape = ("data", "model"), (2, 4)
    for table in TABLES:
        rules = getattr(sharding, table)
        seen = set()
        for r in range(8):
            coords = dict(zip(names, np.unravel_index(r, shape)))
            m = SimpleNamespace(axis_names=names, shape=dict(zip(names,
                                                                 shape)),
                                coords={a: int(c) for a, c in
                                        coords.items()})
            caches = lm.init_caches(cfg, 4, 64, "meta", rules, m)
            specs = lm.cache_pspecs(cfg, rules, m, 4, 64)
            whole = lm.cache_abstract(cfg, 4, 64)
            for name, leaves in caches.items():
                for k, t in leaves.items():
                    if k == "conv":
                        for lo, hi in M.conv_channels(cfg, rules, m):
                            seen.update(range(lo, hi))
                        continue
                    want = NamedSharding(m, specs[name][k]).local_shape(
                        whole[name][k].shape)
                    assert tuple(t.shape) == want
        assert seen == set(range(M.mamba_dims(cfg)["conv_dim"]))
