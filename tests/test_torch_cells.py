"""The production shape cells on one card: `configs.list_cells`,
`launch.dryrun.fit_one_card`'s DLRM records and the dry jobs run on a
named device (`one_card_job(device=)`), held to the reference; the
decode-against-prefill consistency `chip_smoke.py` phase 22 gates on the
card, for each family at a smoke size; and the small helpers of the
reference's public surface (`resident`, `StaleRowSnapshot.coverage`,
`EmbeddingBagCollection.pspecs` / `optimizer_pspecs`).

Tolerances: fp32 compute against the reference 1e-4 (whole models, as
`tests/test_torch_lm.py`'s MODEL_TOL) and 1e-5 (the DLRM step,
`tests/test_torch_dense.py`'s STEP_TOL); a decode step against the prefill
at the same position in fp32 1e-2 relative L2: the caches hold bf16
whatever the compute dtype (the reference's), so the decode reads K, V
and the conv tail rounded to bf16 (2^-8 relative) where the prefill used
them in fp32; integers and records exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.configs.registry import list_cells as jlist_cells
from repro.core import cache as jcache
from repro.core import dlrm as jdlrm
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.data.synthetic import make_dlrm_batch as jmake_dlrm_batch
from repro.models import lm as jlm
from repro.nn.params import init_params as jinit
from repro.optim import adagrad as jadagrad
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch.configs import get_smoke_config, list_cells
from repro_torch.configs.base import Shape
from repro_torch.convert import lm_params_from_jax, params_from_jax
from repro_torch.core.cache import (CachedEmbeddingBagCollection,
                                    StaleRowSnapshot)
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.launch import dryrun
from repro_torch.models import lm
from repro_torch.nn.moe import dropless_config
from repro_torch.nn.params import tree_leaves

TOL = {"rtol": 1e-4, "atol": 1e-4}
STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
GATE_REL_L2 = 1e-2


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _fp32(name: str):
    """(port, reference) smoke configs of `name` in fp32 compute."""
    return (dataclasses.replace(get_smoke_config(name),
                                compute_dtype="float32"),
            dataclasses.replace(jget_smoke(name), compute_dtype="float32"))


def _lm_params(jcfg, seed: int = 1):
    jp = jinit(jlm.lm_param_specs(jcfg), jax.random.PRNGKey(seed))
    host = jax.tree.map(np.asarray, jp)
    return jp, lm_params_from_jax(jax.tree.map(np.copy, host), device="cpu")


def _rel_l2(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))

# ---------------------------------------------------------------------------
# the cells and their one-card records
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("include_dlrm", [True, False])
def test_list_cells_is_the_references_cell_for_cell(include_dlrm):
    got = [(a, dataclasses.astuple(s)) for a, s in list_cells(include_dlrm)]
    want = [(a, dataclasses.astuple(s))
            for a, s in jlist_cells(include_dlrm)]
    assert got == want
    assert len(got) == (38 if include_dlrm else 32)


def _dlrm_peak(cfg, shape, batch, sparse_apply=None) -> int:
    run = dryrun.one_card_job(cfg, shape, batch, sparse_apply=sparse_apply)
    return dryrun.measure(run)[0].peak_bytes


def _card(monkeypatch, hbm_bytes: float) -> None:
    """A made-up card of `hbm_bytes` for the dry run's one-card rules."""
    monkeypatch.setattr(dryrun, "HW", dataclasses.replace(
        dryrun.HW, hbm_bytes=hbm_bytes))


@pytest.mark.parametrize("kind", ["train_b64k", "infer_b8k"])
def test_fit_one_card_halves_a_dlrm_batch_until_it_fits(kind, monkeypatch):
    """At dlrm-m1's smoke config on a made-up card that holds the batch of
    an eighth of the global one: the batch halves three times, each peak
    tried over the limit but the last, which is the one-card job's
    measured peak; a card that holds nothing keeps halving down to 1."""
    cfg = get_smoke_config("dlrm-m1")
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    shape = dryrun.shapes_for("dlrm-m1")[kind]
    g = shape.global_batch
    sparse = "sparse" if kind == "train_b64k" else None
    limit = _dlrm_peak(cfg, shape, g // 8, sparse)
    _card(monkeypatch, limit)
    rec = dryrun.fit_one_card("dlrm-m1", shape)
    assert rec["ok"] and rec["fits"], rec.get("traceback")
    assert [b for b, _ in rec["tried"]] == [g, g // 2, g // 4, g // 8]
    peaks = [p for _, p in rec["tried"]]
    assert all(p > limit for p in peaks[:-1]) and peaks[-1] == limit
    assert rec["batch"] == g // 8 and rec["peak_per_device"] == limit
    assert rec.get("sparse_apply") == sparse   # the smoke card is tiny
    _card(monkeypatch, 1)
    none = dryrun.fit_one_card("dlrm-m1", shape)
    assert none["ok"] and not none["fits"] and none["batch"] == 1
    assert [b for b, _ in none["tried"]] == [g >> i for i in
                                              range(g.bit_length())]


def test_the_launchers_update_rule_picks_dense_where_its_buffer_fits(
        monkeypatch):
    """`dlrm_sparse_apply` is `launch.train.check_dense_fits`' rule: the
    (rows + 1, d) fp32 buffer and 4 GiB of headroom beside the table and
    its accumulator. The sparse job books one fused update, the dense
    one none."""
    cfg = get_smoke_config("dlrm-m1")
    ebc = dryrun.one_card_ebc(cfg)
    _card(monkeypatch, 1e12)
    assert dryrun.dlrm_sparse_apply(cfg, ebc) == "dense"
    _card(monkeypatch, 4e9)
    assert dryrun.dlrm_sparse_apply(cfg, ebc) == "sparse"
    shape = dryrun.shapes_for("dlrm-m1")["train_b64k"]
    for mode, calls in (("sparse", 1), ("dense", 0)):
        an, _ = dryrun.measure(dryrun.one_card_job(cfg, shape, 64,
                                                   sparse_apply=mode))
        got = an.kernels.get("fused_bag_backward_adagrad", {"calls": 0})
        assert got["calls"] == calls, mode
        assert an.kernels["embedding_bag"]["calls"] == 1


def test_fill_group_halves_the_group_until_its_prefill_fits(monkeypatch):
    """A decode cell's fill group: its prefill into a view of the whole
    batch's caches measured on the meta device, the group halved while
    that peak passes the card (down to 1), and never more than the
    batch."""
    cfg = get_smoke_config("stablelm-1.6b")
    peaks = []
    measure = dryrun.measure

    def spy(run, *a, **k):
        out = measure(run, *a, **k)
        peaks.append(out[0].peak_bytes)
        return out
    monkeypatch.setattr(dryrun, "measure", spy)
    _card(monkeypatch, 1)
    assert dryrun.fill_group(cfg, 8, 4, 64) == 1
    assert len(peaks) == 2 and peaks[0] > peaks[1]
    _card(monkeypatch, peaks[1])
    assert dryrun.fill_group(cfg, 8, 4, 64) == 2
    _card(monkeypatch, peaks[0])
    assert dryrun.fill_group(cfg, 8, 4, 64) == 4
    assert dryrun.fill_group(cfg, 2, 4, 64) == 2


def test_the_full_width_dlrm_records():
    """dlrm-m1 (43.6 GB) trains at 65,536 with the fused update and
    dlrm-m2 (24.3 GB) with the dense one, both serving 8,192; dlrm-m3's
    118.3 GB fit no batch."""
    recs = {(a, s): dryrun.fit_one_card(a, dryrun.shapes_for(a)[s])
            for a in ("dlrm-m1", "dlrm-m2", "dlrm-m3")
            for s in ("train_b64k", "infer_b8k")}
    assert all(r["ok"] for r in recs.values())
    for a, mode in (("dlrm-m1", "sparse"), ("dlrm-m2", "dense")):
        assert recs[(a, "train_b64k")]["sparse_apply"] == mode
        assert recs[(a, "train_b64k")]["batch"] == 65536
        assert recs[(a, "infer_b8k")]["batch"] == 8192
        assert recs[(a, "train_b64k")]["fits"]
    for s in ("train_b64k", "infer_b8k"):
        m3 = recs[("dlrm-m3", s)]
        assert not m3["fits"] and m3["batch"] == 1
        assert m3["peak_per_device"] > 118e9

# ---------------------------------------------------------------------------
# the dry jobs on a named device, held to the reference's steps
# ---------------------------------------------------------------------------


def test_a_job_on_a_device_never_falls_back_to_the_cpu():
    cfg = get_smoke_config("stablelm-1.6b")
    shape = Shape("prefill_32k", "prefill", 32, 2)
    meta = dryrun.one_card_job(cfg, shape, 2)
    assert tree_leaves(meta.tracked["parameters"][0])[0].is_meta
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            dryrun.one_card_job(cfg, shape, 2, device="cuda")


def test_train_job_on_the_cpu_is_the_references_step():
    """train_4k's one-card job cut to 4 x 32 at stablelm-1.6b's smoke
    config, on the reference's parameters: adamw(3e-4, weight decay 0.1)
    (the dry run's), the loss and every parameter after the step."""
    cfg, jcfg = _fp32("stablelm-1.6b")
    jp, tp = _lm_params(jcfg)
    shape = Shape("train_4k", "train", 32, 4)
    run = dryrun.one_card_job(cfg, shape, 4, device="cpu", params=tp)
    params, _, metrics = run.fn()
    assert [float(m["loss"]) for m in run.metrics] == [float(metrics["loss"])]
    batch = {k: jnp.asarray(v) for k, v in make_lm_batch(cfg, 4, 32).items()}
    opt = jadamw(3e-4, weight_decay=0.1)
    step = jax.jit(jsteps.build_lm_train_step(jcfg, opt))
    jparams, _, jm = step(jp, opt.init(jp), batch, jnp.asarray(0, jnp.int32))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               **TOL)
    for a, b in zip(dryrun.sorted_leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_prefill_and_decode_jobs_on_the_cpu_are_the_references_steps():
    """prefill_32k's and decode_32k's one-card jobs cut to 2 x 32 at
    stablelm-1.6b's smoke config, bf16 weights (the reference's cast the
    same way), fp32 compute: the prefill's last logits; the decode job's
    caches filled by the prefill, its one step at position 31 on the
    prompt's last token, its logits the reference decode's and, within
    the gate, the prefill's last."""
    cfg, jcfg = _fp32("stablelm-1.6b")
    jp, tp = _lm_params(jcfg)
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    pre = dryrun.one_card_job(cfg, Shape("prefill_32k", "prefill", 32, 2), 2,
                              device="cpu", params=tp)
    assert tree_leaves(pre.tracked["parameters"][0])[0].dtype \
        == torch.bfloat16
    prompt = pre.tracked["batch"][0]["prompt"]
    last, _ = pre.fn()
    jc = jlm.init_caches(jcfg, 2, 32)
    want, jc = jlm.prefill_step(jp16, {"tokens": jnp.asarray(
        prompt["tokens"].numpy())}, jc, jcfg, {})
    np.testing.assert_allclose(_np(last), _np(want), **TOL)

    dec = dryrun.one_card_job(cfg, Shape("decode_32k", "decode", 32, 2), 2,
                              device="cpu", params=tp)
    caches = dec.tracked["inputs"][0]
    assert caches.max_len == 32
    lm.prefill_step(dec.tracked["parameters"][0], prompt, caches, cfg)
    dec.tracked["batch"][0]["tokens"].copy_(prompt["tokens"][:, -1:])
    logits, _ = dec.fn()
    jwant, _ = jlm.decode_step(jp16, jnp.asarray(
        prompt["tokens"][:, -1:].numpy()), jc, jnp.asarray(31, jnp.int32),
        jcfg, {})
    np.testing.assert_allclose(_np(logits), _np(jwant), **TOL)
    assert _rel_l2(logits, last) <= GATE_REL_L2


@pytest.mark.parametrize("kind", ["dlrm_train", "dlrm_infer"])
def test_dlrm_jobs_on_the_cpu_are_the_references_steps(kind):
    """train_b64k's and infer_b8k's one-card jobs cut to 64 at dlrm-m1's
    smoke config on the reference's parameters: two dense steps (the
    loss each step, the table, the accumulator and the dense tower) or
    the forward's logits."""
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    jebc = JEBC.build(jcfg, n_shards=1, strategy="replicated")
    jparams = jinit(jdlrm.dlrm_param_specs(jcfg, jebc),
                    jax.random.PRNGKey(3))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    name = "train_b64k" if kind == "dlrm_train" else "infer_b8k"
    run = dryrun.one_card_job(cfg, dryrun.shapes_for("dlrm-m1")[name], 64,
                              device="cpu", params=params, steps=2,
                              sparse_apply="dense")
    raw = jmake_dlrm_batch(jcfg, 64)
    raw["idx"] = np.asarray(jebc.offset_indices(raw["idx"]))
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    for k, v in raw.items():
        assert np.array_equal(run.tracked["inputs"][0][k].numpy(), v), k
    out = run.fn()
    if kind == "dlrm_infer":
        want = jdlrm.dlrm_forward(jparams, jb, jcfg, jebc)
        np.testing.assert_allclose(_np(out), _np(want), **STEP_TOL)
        return
    opt = jadagrad(0.01)
    jstate = jsteps.dlrm_init_state(jebc, opt, jparams)
    jstep = jax.jit(jsteps.build_dlrm_train_step(jcfg, jebc, opt,
                                                 sparse_apply="dense"))
    for t, m in enumerate(run.metrics):
        jparams, jstate, jm = jstep(jparams, jstate, jb,
                                    jnp.asarray(t, jnp.int32))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **STEP_TOL)
    p, st, _ = out
    np.testing.assert_allclose(_np(p["emb"]["mega"]),
                               _np(jparams["emb"]["mega"]), **STEP_TOL)
    np.testing.assert_allclose(_np(st["accum"]), _np(jstate["accum"]),
                               **STEP_TOL)
    for part in ("bottom", "top"):
        for a, b in zip(tree_leaves(p[part]), jax.tree.leaves(jparams[part])):
            np.testing.assert_allclose(_np(a), _np(b), **STEP_TOL)

# ---------------------------------------------------------------------------
# the decode-against-prefill gate, family by family
# ---------------------------------------------------------------------------


FAMILIES = ["stablelm-1.6b", "granite-moe-1b-a400m", "mamba2-780m",
            "jamba-v0.1-52b", "internvl2-26b", "musicgen-large"]


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_at_the_last_position_is_the_prefills(name):
    """fp32, batch 2, S = 64 (a multiple of the smoke block of 16, so the
    prefill runs the flash-attention op): an attention-only model's decode
    step of each row's last token at S - 1 gives the prefill's last
    logits; a recurrent one (Mamba-2, the hybrid) prefilled to S -
    ssm_chunk and decoded token by token to S - 1 does too. The audio
    arch's last frame is the summed embedding of the codebook tokens the
    decode takes."""
    cfg = dataclasses.replace(get_smoke_config(name), compute_dtype="float32")
    gcfg = dropless_config(cfg)
    b, s = 2, 64
    assert s % cfg.attn_block_q == 0
    params = lm.init_lm_params(cfg, 0, device="cpu")
    prompt = {k: torch.from_numpy(v) for k, v in make_lm_batch(
        cfg, b, s).items() if k not in ("targets", "loss_mask")}
    if cfg.frontend == "audio":
        toks = torch.randint(0, cfg.vocab_size, (b, 1, cfg.n_codebooks),
                             generator=torch.Generator().manual_seed(0),
                             dtype=torch.int32)
        prompt["embeds"][:, -1] = lm._codebook_input(
            params, toks, cfg, {}, None)[:, 0].float()
    else:
        toks = prompt["tokens"][:, -1:]
    caches = lm.init_caches(cfg, b, s, "cpu")
    with torch.no_grad():
        want, _ = lm.prefill_step(params, prompt, caches, gcfg)
        if "m" in cfg.pattern:
            lo = s - cfg.ssm_chunk
            tail = lm.init_caches(cfg, b, s, "cpu")
            lm.prefill_step(params, {"tokens": prompt["tokens"][:, :lo]},
                            tail, gcfg)
            for i in range(lo, s):
                got, _ = lm.decode_step(params, prompt["tokens"][:, i:i + 1],
                                        tail, i, gcfg)
        else:
            got, _ = lm.decode_step(params, toks, caches, s - 1, gcfg)
    assert got.shape == want.shape
    for r in range(b):
        assert _rel_l2(got[r], want[r]) <= GATE_REL_L2, (name, r)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_decode_into_row_views_of_a_larger_cache_is_the_same():
    """The decode cells fill their caches by prefilling groups of rows
    into views of them: every cache leaf of a view's rows equals a
    prefill into caches of its own."""
    cfg = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"),
                              compute_dtype="float32")
    params = lm.init_lm_params(cfg, 0, device="cpu")
    prompt = {k: torch.from_numpy(v) for k, v in make_lm_batch(
        cfg, 2, 32).items() if k == "tokens"}
    own = lm.init_caches(cfg, 2, 32, "cpu")
    big = lm.init_caches(cfg, 4, 32, "cpu")
    view = lm.Caches({n: {k: t[:, 2:4] for k, t in c.items()}
                      for n, c in big.items()}, big.max_len)
    with torch.no_grad():
        lm.prefill_step(params, prompt, own, cfg)
        lm.prefill_step(params, prompt, view, cfg)
    for n, c in own.items():
        for k, t in c.items():
            assert torch.equal(big[n][k][:, 2:4], t), (n, k)
            assert not big[n][k][:, :2].any(), (n, k)

# ---------------------------------------------------------------------------
# small helpers of the reference's public surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_resident_counts_occupied_slots_as_the_references(kind):
    cfg = get_smoke_config("dlrm-m1")
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=64)
    mega = torch.zeros((cc.ebc.plan.total_rows, cfg.embed_dim))
    state = (cc.init_state(mega) if kind == "sync"
             else cc.init_async_state(mega))
    assert state.resident == 0
    state.slot_row[[3, 5, 40]] = [7, 11, 2]
    ref = jcache.CacheState if kind == "sync" else jcache.AsyncCacheState
    assert state.resident == ref.resident.fget(state) == 3


def test_stale_snapshot_coverage_is_the_references():
    snap = StaleRowSnapshot.empty(10, 4)
    assert snap.coverage == jcache.StaleRowSnapshot.coverage.fget(snap) == 0
    snap.record(np.array([1, 4, 4]), np.ones((3, 4), np.float32))
    assert snap.coverage == jcache.StaleRowSnapshot.coverage.fget(snap) \
        == 0.2
    empty = StaleRowSnapshot.empty(0, 4)
    assert empty.coverage == jcache.StaleRowSnapshot.coverage.fget(empty) \
        == 0.0


@pytest.mark.parametrize("strategy,n_shards", [
    ("replicated", 1), ("row_wise", 4), ("table_wise", 4),
    ("column_wise", 2)])
def test_collection_pspecs_are_the_references(strategy, n_shards):
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, n_shards, strategy=strategy)
    jebc = JEBC.build(jcfg, n_shards, strategy=strategy)
    assert ebc.pspecs() == {"mega": tuple(jebc.pspecs()["mega"])}
    assert ebc.optimizer_pspecs() == {
        "accum": tuple(jebc.optimizer_pspecs()["accum"])}


def test_prefill_returns_its_last_logits_without_the_rest():
    """prefill_step's last-position logits own their storage: a view of
    the (B, S, V) logits kept the whole buffer alive with them, which at
    mamba2-780m's prefill_32k batch (16 x 32,768 x 50,280 bf16) is 52.7 GB
    and left no room for the next prefill."""
    cfg = get_smoke_config("mamba2-780m")
    params = lm.init_lm_params(cfg, 0, device="cpu")
    b, s = 2, 64
    tokens = torch.from_numpy(make_lm_batch(cfg, b, s)["tokens"])
    last, _ = lm.prefill_step(params, {"tokens": tokens},
                              lm.init_caches(cfg, b, s, "cpu"), cfg)
    assert last.shape == (b, cfg.vocab_size)
    assert last.untyped_storage().nbytes() == last.numel() \
        * last.element_size()
