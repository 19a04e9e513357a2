"""The port's vision and audio stub frontends (internvl2-26b,
musicgen-large) against the reference package, at smoke size on the CPU:
configs and parameter trees (the audio arch's (K, V, D) codebooks and
(D, V*K) head), `lm_params_from_jax`, `sinusoidal_positions`,
`make_lm_batch`, the forward, prefill then decode (the vision arch with its
patch prefix, the audio arch with K codebook tokens a step), `lm_loss`
and every gradient, `build_lm_train_step`, the remat modes, the
launchers, and the engine on the vision arch; on the same numpy inputs
and the reference's parameters copied across.

Tolerances. fp32 compute: logits within rtol/atol 1e-4 and decode logits
within 1e-3, as the zoo's serving tests (tests/test_torch_lm_zoo.py);
`sinusoidal_positions` within 2e-6 absolute below position 64 and 2e-3
at positions near 8,192 (an angle of ~8,192 carries ~1e-3 of fp32
rounding, and the two packages' pow and sin round differently); the loss
within 1e-5 and each gradient within a relative L2 error of 1e-4; train
steps' parameters within rtol/atol 1e-5 of the reference's after each of
three steps (bf16 gradients add 3 * lr * 2^-7, as in
tests/test_torch_lm_zoo_train.py). bf16 compute: no farther from the
reference's fp32 result than the reference's bf16 result, times 1.5,
plus 0.01 (logits, gradients), and the loss by the same rule plus 5e-3.
Batches are bit-identical, remat modes bit-equal, the engine's greedy
tokens equal the reference engine's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.data.synthetic import make_lm_batch as jmake_lm_batch
from repro.data.synthetic import vlm_prefix as jvlm_prefix
from repro.models import lm as jlm
from repro.nn import layers as JL
from repro.nn.params import init_params as jinit
from repro.nn.params import param_count as jparam_count
from repro.optim import optimizers as jopt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro.train import steps as jsteps
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.data.synthetic import make_lm_batch, vlm_prefix
from repro_torch.kernels import flash_attention as kflash
from repro_torch.models import lm
from repro_torch.nn import layers as L
from repro_torch.nn.params import param_count, tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.serve import Request, ServeEngine
from repro_torch.train.steps import build_lm_train_step

FRONTENDS = ["internvl2-26b", "musicgen-large"]
DTYPES = ["float32", "bfloat16"]
FP32 = {"rtol": 1e-4, "atol": 1e-4}
FP32_DECODE = {"rtol": 1e-3, "atol": 1e-3}
GRAD_RTOL = 1e-4


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _cfgs(name: str, dtype: str, **over):
    return (dataclasses.replace(get_smoke_config(name), compute_dtype=dtype,
                                **over),
            dataclasses.replace(jget_smoke(name), compute_dtype=dtype,
                                **over))


@functools.lru_cache(maxsize=None)
def _host_params(name: str, seed: int = 1):
    return jax.tree.map(np.asarray, jinit(jlm.lm_param_specs(jget_smoke(
        name)), jax.random.PRNGKey(seed)))


def _params(jcfg, seed: int = 1):
    host = _host_params(jcfg.name, seed)
    return (jax.tree.map(jnp.asarray, host),
            lm_params_from_jax(jax.tree.map(np.copy, host), device="cpu"))


def _held(got, want, want_fp32, dtype, tol):
    """fp32: `got` within `tol` of the reference. bf16: no farther from
    the reference's fp32 result than the reference's bf16 result, x1.5 +
    0.01."""
    got, want, want_fp32 = _np(got), _np(want), _np(want_fp32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **tol)
        return
    ours = np.abs(got - want_fp32).max()
    theirs = np.abs(want - want_fp32).max()
    assert ours <= 1.5 * theirs + 0.01, (ours, theirs)


def _batch(cfg, b: int, s: int, step: int = 0):
    """make_lm_batch's batch (the frontends' embeddings included) with a
    fifth of the loss mask's ones cleared."""
    batch = make_lm_batch(cfg, b, s, step, 5)
    rng = np.random.RandomState(step + 17)
    batch["loss_mask"] = batch["loss_mask"] * (rng.rand(b, s) > 0.2)
    return batch


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}

# ---------------------------------------------------------------------------
# configs, parameters, positions, batches
# ---------------------------------------------------------------------------


def test_registry_holds_every_reference_arch():
    from repro.configs.registry import ARCHS as JARCHS
    assert list(ARCHS) == list(JARCHS)
    for name in ARCHS:
        get_config(name)
        lm.lm_param_specs(get_config(name))
        lm.lm_param_specs(get_smoke_config(name))


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", FRONTENDS)
def test_frontend_config_fields_equal(name, smoke):
    port = get_smoke_config(name) if smoke else get_config(name)
    want = jget_smoke(name) if smoke else jget_config(name)
    for f in dataclasses.fields(want):
        assert getattr(port, f.name) == getattr(want, f.name), f.name
    assert (port.pattern, port.n_units) == (want.pattern, want.n_units)


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, path + (key,)).items()}
    return {path: (tuple(tree.shape), tree.init, tree.scale, tree.fan_axis)}


@pytest.mark.parametrize("name", FRONTENDS)
def test_frontend_param_specs_match_reference(name):
    """Full width and smoke: the same leaves, shapes and inits; the audio
    arch has (K, V, D) codebooks and no token table, and its untied head
    is (D, V*K). internvl2-26b has 19.86 B parameters, musicgen-large
    2.45 B."""
    cfg, jcfg = get_config(name), jget_config(name)
    assert _flat(lm.lm_param_specs(cfg)) == _flat(jlm.lm_param_specs(jcfg))
    assert param_count(lm.lm_param_specs(cfg)) == \
        jparam_count(jlm.lm_param_specs(jcfg))
    specs = lm.lm_param_specs(cfg)
    if cfg.frontend == "audio":
        assert list(specs["embed"]) == ["codebooks"]
        assert specs["embed"]["codebooks"].shape == (4, 2048, 2048)
        assert specs["head"]["w"].shape == (2048, 4 * 2048)
        assert cfg.param_count_estimate() == 2_450_362_368
    else:
        assert list(specs["embed"]) == ["tok"]
        assert specs["head"]["w"].shape == (6144, 92553)
        assert cfg.param_count_estimate() == 19_861_260_288
    assert _flat(lm.lm_param_specs(get_smoke_config(name))) == \
        _flat(jlm.lm_param_specs(jget_smoke(name)))


@pytest.mark.parametrize("name", FRONTENDS)
def test_lm_params_from_jax_carries_the_frontend_leaves(name):
    """The codebooks and the V*K head (audio), the token table and the
    untied head (vision) copy across bit for bit, in tree order."""
    jcfg = jget_smoke(name)
    jp, tp = _params(jcfg)
    flat_j = jax.tree.leaves(jp)
    assert [tuple(t.shape) for t in tree_leaves(tp)] == \
        [tuple(a.shape) for a in flat_j]
    for t, a in zip(tree_leaves(tp), flat_j):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    key = "codebooks" if jcfg.frontend == "audio" else "tok"
    np.testing.assert_array_equal(tp["embed"][key].numpy(),
                                  np.asarray(jp["embed"][key]))
    np.testing.assert_array_equal(tp["head"]["w"].numpy(),
                                  np.asarray(jp["head"]["w"]))


@pytest.mark.parametrize("d", [64, 2048])
def test_sinusoidal_positions_match_reference(d):
    pos = np.array([[0, 1, 2, 7, 31, 63], [8185, 8186, 8190, 8191, 8192,
                                           8207]], np.int32)
    got = L.sinusoidal_positions(torch.from_numpy(pos), d)
    want = np.asarray(JL.sinusoidal_positions(jnp.asarray(pos), d))
    assert got.dtype == torch.float32 and got.shape == (2, 6, d)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=2e-6)
    np.testing.assert_allclose(got[1].numpy(), want[1], rtol=0, atol=2e-3)
    assert float(got[0, 0, :d // 2].abs().max()) == 0.0
    assert bool((got[0, 0, d // 2:] == 1).all())


@pytest.mark.parametrize("seq", [17, 64, 4096])
@pytest.mark.parametrize("name", FRONTENDS)
def test_make_lm_batch_identical(name, seq):
    """The same keys, dtypes and bits as the reference's generator; the
    vision batch's loss mask is zero over its patch prefix."""
    cfg, jcfg = get_smoke_config(name), jget_smoke(name)
    assert vlm_prefix(seq) == jvlm_prefix(seq)
    for step, seed in ((0, 0), (3, 2)):
        a = make_lm_batch(cfg, 2, seq, step=step, seed=seed)
        b = jmake_lm_batch(jcfg, 2, seq, step=step, seed=seed)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
    if cfg.frontend == "vision":
        p = vlm_prefix(seq)
        assert a["embeds"].shape == (2, p, cfg.d_model)
        assert a["tokens"].shape == (2, seq - p)
        assert not a["loss_mask"][:, :p].any() and a["loss_mask"][:, p:].all()
    else:
        assert a["embeds"].shape == (2, seq, cfg.d_model)
        assert a["targets"].shape == (2, seq, cfg.n_codebooks)

# ---------------------------------------------------------------------------
# the forward, prefill and decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FRONTENDS)
def test_lm_forward_train_matches_reference(name, dtype):
    """32 positions (the flash branch): the vision arch's 4 patches and 28
    tokens; the audio arch's frames with sinusoidal positions, logits (B,
    S, K, V)."""
    cfg, jcfg = _cfgs(name, dtype)
    jp, tp = _params(jcfg)
    batch = make_lm_batch(cfg, 2, 32, 0, 1)
    del batch["targets"], batch["loss_mask"]
    got, aux, _ = lm.lm_forward(tp, _t(batch), cfg, "train")
    want = {dt: jlm.lm_forward(jp, _j(batch), dataclasses.replace(
        jcfg, compute_dtype=dt), "train", rules={})[0]
        for dt in {dtype, "float32"}}
    shape = (2, 32, 4, 256) if cfg.frontend == "audio" else (2, 32, 256)
    assert tuple(got.shape) == shape and float(aux) == 0.0
    _held(got, want[dtype], want["float32"], dtype, FP32)


def _prefill_decode(params, cfg, batch, feeds, max_len, jax_side):
    """Logits of a prefill over `batch`, then one decode step per (tokens,
    index) of `feeds`."""
    if jax_side:
        caches = jlm.init_caches(cfg, 2, max_len)
        lg, caches = jlm.prefill_step(params, _j(batch), caches, cfg, {})
    else:
        caches = lm.init_caches(cfg, 2, max_len, device="cpu")
        lg, caches = lm.prefill_step(params, _t(batch), caches, cfg)
    out = [lg]
    for tok, index in feeds:
        if jax_side:
            lg, caches = jlm.decode_step(params, jnp.asarray(tok), caches,
                                         jnp.asarray(index, jnp.int32),
                                         cfg, {})
        else:
            ti = index if isinstance(index, int) else torch.from_numpy(index)
            lg, caches = lm.decode_step(params, torch.from_numpy(tok),
                                        caches, ti, cfg)
        out.append(lg)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FRONTENDS)
def test_prefill_then_decode_match_reference(name, dtype):
    """prefill_step over 32 positions (the flash branch), then three
    decode steps, the last at per-row positions: the vision arch decodes
    text tokens (B, 1) with an empty patch prefix, the audio arch sums its
    K codebook embeddings of (B, 1, K) tokens and adds the sinusoidal
    position of the decode index."""
    cfg, jcfg = _cfgs(name, dtype)
    jp, tp = _params(jcfg, seed=2)
    batch = make_lm_batch(cfg, 2, 32, 0, 2)
    del batch["targets"], batch["loss_mask"]
    rng = np.random.RandomState(12)
    shape = (2, 1, cfg.n_codebooks) if cfg.frontend == "audio" else (2, 1)
    feeds = [(rng.randint(0, 256, size=shape), idx)
             for idx in (32, 33, np.asarray([34, 35]))]
    got = _prefill_decode(tp, cfg, batch, feeds, 40, False)
    want = {dt: _prefill_decode(jp, dataclasses.replace(
        jcfg, compute_dtype=dt), batch, feeds, 40, True)
        for dt in {dtype, "float32"}}
    last = (2, 4, 256) if cfg.frontend == "audio" else (2, 256)
    for i, g in enumerate(got):
        assert tuple(g.shape) == last
        _held(g, want[dtype][i], want["float32"][i], dtype,
              FP32 if i == 0 else FP32_DECODE)


def test_audio_decode_adds_the_position_of_its_index():
    """The same codebook tokens decoded at two positions give other
    logits (the sinusoidal embedding of the index is added), and the
    input is the sum of the K codebook rows."""
    cfg = dataclasses.replace(get_smoke_config("musicgen-large"),
                              compute_dtype="float32")
    tp = lm.init_lm_params(cfg, 0, device="cpu")
    tok = torch.tensor([[[1, 2, 3, 4]], [[1, 2, 3, 4]]])
    caches = lm.init_caches(cfg, 2, 8, device="cpu")
    logits, _ = lm.decode_step(tp, tok, caches, torch.tensor([0, 5]), cfg)
    assert logits.shape == (2, 4, 256)
    assert not torch.equal(logits[0], logits[1])
    seen = []
    real = lm.lm_forward

    def spy(params, batch, *a, **k):
        seen.append(batch["embeds"])
        return real(params, batch, *a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "lm_forward", spy)
        lm.decode_step(tp, tok, lm.init_caches(cfg, 2, 8, device="cpu"), 0,
                       cfg)
    emb = tp["embed"]["codebooks"]
    want = emb[0][1] + emb[1][2] + emb[2][3] + emb[3][4]
    torch.testing.assert_close(seen[0][0, 0], want, rtol=0, atol=1e-7)

# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _loss_and_grads(cfg, tp, batch):
    """The loss, its parts and every leaf's gradient; a leaf the loss does
    not reach (the audio arch's codebooks, read only by decode) gets
    zeros, as jax.grad gives."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), tp)
    loss, parts = lm.lm_loss(leaves, _t(batch), cfg)
    grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                materialize_grads=True)
    return loss.detach(), parts, list(grads)


def _ref_loss_and_grads(jcfg, jp, batch):
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, b, jcfg, rules={}), has_aux=True))(
            jp, _j(batch))
    return loss, parts, jax.tree.leaves(grads)


@pytest.mark.parametrize("s", [16, 32])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", FRONTENDS)
def test_lm_loss_and_grads_match_reference(name, dtype, s):
    """make_lm_batch's batches with a fifth of the mask cleared: the
    vision loss skips the patch prefix (its targets there are never
    read), the audio loss averages the K codebooks' cross entropies. s =
    32 takes the flash branch, s = 16 full attention. The frontends'
    embeddings are inputs: no gradient reaches them."""
    cfg, jcfg = _cfgs(name, dtype)
    jp, tp = _params(jcfg)
    batch = _batch(cfg, 2, s)
    loss, parts, grads = _loss_and_grads(cfg, tp, batch)
    jloss, jparts, jgrads = _ref_loss_and_grads(jcfg, jp, batch)
    assert float(parts["aux"]) == 0.0 and len(grads) == len(jgrads)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    if dtype == "float32":
        for got, want in ((loss, jloss), (parts["ce"], jparts["ce"])):
            np.testing.assert_allclose(float(got.detach()), float(want),
                                       rtol=1e-5, atol=1e-5)
        for g, jg in zip(grads, jgrads):
            assert g.shape == jg.shape
            assert _rel_l2(g, jg) < GRAD_RTOL, _rel_l2(g, jg)
        return
    cfg32, jcfg32 = _cfgs(name, "float32")
    loss32, _, grads32 = _loss_and_grads(cfg32, tp, batch)
    jloss32, _, jgrads32 = _ref_loss_and_grads(jcfg32, jp, batch)
    ours = abs(float(loss.detach()) - float(loss32.detach()))
    theirs = abs(float(jloss) - float(jloss32))
    assert ours <= 1.5 * theirs + 5e-3, (ours, theirs)
    for g, jg, g32, jg32 in zip(grads, jgrads, grads32, jgrads32):
        assert _rel_l2(g, g32) <= 1.5 * _rel_l2(jg, jg32) + 0.01


def test_vision_loss_ignores_the_patch_prefix():
    """Changing the targets over the patch prefix changes neither the loss
    nor a gradient."""
    cfg = get_smoke_config("internvl2-26b")
    tp = lm.init_lm_params(cfg, 0, device="cpu")
    batch = _batch(cfg, 2, 32)
    p = vlm_prefix(32)
    loss, _, grads = _loss_and_grads(cfg, tp, batch)
    batch["targets"][:, :p] = (batch["targets"][:, :p] + 7) % 256
    loss2, _, grads2 = _loss_and_grads(cfg, tp, batch)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.parametrize("name", FRONTENDS)
def test_remat_modes_give_the_same_bits(name):
    out = {}
    for remat in ("none", "full", "dots"):
        cfg, jcfg = _cfgs(name, "bfloat16", remat=remat)
        _, tp = _params(jcfg)
        calls = []
        real = kflash.flash_attention
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kflash, "flash_attention",
                       lambda *a, **k: calls.append(1) or real(*a, **k))
            loss, _, grads = _loss_and_grads(cfg, tp, _batch(cfg, 2, 32))
        out[remat] = (loss, grads, len(calls))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
    n = cfg.n_layers
    assert [out[r][2] for r in ("none", "full", "dots")] == [n, 2 * n, 2 * n]


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", FRONTENDS)
def test_lm_train_step_matches_reference(name, accum, grad_dtype):
    """fp32 compute, batch 4 of 32 positions, adamw(1e-3) with its clip,
    three steps: the loss and every parameter after each step."""
    cfg, jcfg = _cfgs(name, "float32")
    jp, tp = _params(jcfg)
    batches = [_batch(cfg, 4, 32, step=i) for i in range(3)]
    opt, jo = adamw(1e-3), jopt.adamw(1e-3)
    step = build_lm_train_step(cfg, opt, accum_steps=accum,
                               grad_dtype=grad_dtype)
    jstep = jax.jit(jsteps.build_lm_train_step(
        jcfg, jo, accum_steps=accum, grad_dtype=grad_dtype))
    atol = 1e-5 + (3 * 1e-3 * 2 ** -7 if grad_dtype == "bfloat16" else 0)
    state, jstate = opt.init(tp), jo.init(jp)
    for i, batch in enumerate(batches):
        tp, state, m = step(tp, state, _t(batch), i)
        jp, jstate, jm = jstep(jp, jstate, _j(batch),
                               jnp.asarray(i, jnp.int32))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5, atol=1e-5)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=atol)


@pytest.mark.parametrize("name", FRONTENDS)
def test_launcher_trains_the_frontend_on_the_cpu(name, tmp_path):
    """`launch.train --smoke --device cpu`: finite losses, bit-equal to
    build_lm_train_step driven by hand on make_lm_batch's batches."""
    from repro_torch.launch import train as train_cli
    steps, b, s = 3, 2, 32
    run = train_cli.main(["--arch", name, "--smoke", "--steps", str(steps),
                          "--batch", str(b), "--seq", str(s), "--device",
                          "cpu", "--ckpt-dir", str(tmp_path),
                          "--log-every", "100"])
    assert len(run.losses) == steps and np.isfinite(run.losses).all()
    cfg = get_smoke_config(name)
    params = lm.init_lm_params(cfg, train_cli.PARAM_SEED, device="cpu")
    opt = adamw(3e-4)
    state = opt.init(params)
    step = build_lm_train_step(cfg, opt)
    losses = []
    for i in range(steps):
        params, state, m = step(params, state,
                                _t(make_lm_batch(cfg, b, s, i, 0)), i)
        losses.append(float(m["loss"]))
    assert run.losses == losses

# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slots", [1, 3])
def test_engine_on_the_vision_arch_equals_the_reference_engine(slots):
    """The reference's engine accepts the vision arch (text in, text
    out); fp32 compute, the same requests and parameters: the same greedy
    tokens and engine steps."""
    cfg, jcfg = _cfgs("internvl2-26b", "float32")
    jp, tp = _params(jcfg, seed=7)
    ours = ServeEngine(tp, cfg, batch_slots=slots, max_len=32)
    theirs = JEngine(jp, jcfg, batch_slots=slots, max_len=32, rules={})
    rng = np.random.RandomState(9)
    for uid in range(5):
        prompt = rng.randint(0, 256, size=(rng.randint(3, 9),)).astype(
            np.int32)
        ours.submit(Request(uid=uid, prompt=prompt.copy(), max_new_tokens=7))
        theirs.submit(JRequest(uid=uid, prompt=prompt.copy(),
                               max_new_tokens=7))
    got = ours.run_until_drained(max_steps=200)
    assert got == theirs.run_until_drained(max_steps=200)
    assert ours.steps_run == theirs.steps_run


def test_engine_and_serve_launcher_refuse_what_the_reference_refuses():
    """The engine refuses the audio arch (the reference asserts); the
    serve launcher drives token-only archs, as the reference's demo."""
    from repro_torch.launch import serve as serve_cli
    cfg = get_smoke_config("musicgen-large")
    tp = lm.init_lm_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="token-in"):
        ServeEngine(tp, cfg, batch_slots=1, max_len=8)
    for name in FRONTENDS:
        with pytest.raises(ValueError, match="token-only"):
            serve_cli.main(["--arch", name, "--smoke", "--requests", "1",
                            "--device", "cpu"])
