"""`launch.analysis.StepAnalysis` (a step's cost counted op by op on the
meta device) against the reference's `StableHloAnalysis` of the same
step's lowered program, the meta kernels' booked costs against the
formulas of `PERF.md`'s bound column, and the dry run's cut loops
against full ones.

The steps run on one device at smoke width, fp32, with a sequence at
`attn_block_q`, so that both sides run plain attention:
  * the LM train, prefill and decode steps of stablelm-1.6b and
    granite-moe-1b-a400m: product FLOPs and the count of products
    exactly equal (both count 2·m·n·k a product; the reference's target
    logit and MoE dispatch and combine are gathers, as the port's are);
  * the DLRM train step (dense update): equal but for one product, the
    interaction's forward, which the reference computes as the full
    (B, F, F) square Z Zᵀ (2·B·F²·d) where the port's kernel books the
    packed triangle it computes (2·B·F(F-1)/2·d): the difference is
    exactly 2·B·d·(F² - F(F-1)/2), nothing else.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke
from repro.core.dlrm import dlrm_param_specs as jdlrm_specs
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.data.synthetic import dlrm_batch_specs as jdlrm_batch
from repro.data.synthetic import lm_batch_specs as jlm_batch
from repro.launch.analysis import StableHloAnalysis
from repro.models import lm as jlm
from repro.nn.params import abstract_params as jabstract
from repro.optim.optimizers import adagrad as jadagrad
from repro.optim.optimizers import adamw as jadamw
from repro.train.steps import build_dlrm_train_step as jbuild_dlrm
from repro.train.steps import build_lm_train_step as jbuild_lm
from repro.train.steps import dlrm_init_state as jdlrm_state
from repro_torch.configs import get_smoke_config
from repro_torch.core.dlrm import dlrm_param_specs
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.data.synthetic import dlrm_batch_specs
from repro_torch.kernels import KERNELS
from repro_torch.kernels import dot_interaction as kd
from repro_torch.kernels import embedding_bag as kb
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import meta as kmeta
from repro_torch.launch import dryrun
from repro_torch.launch.analysis import StepAnalysis
from repro_torch.launch.mesh import DryMesh
from repro_torch.nn import sharding
from repro_torch.nn.params import abstract_params
from repro_torch.optim import adagrad
from repro_torch.train.steps import (build_dlrm_train_step, dense_row_pass,
                                     dlrm_init_state)

BATCH = 2
LM_ARCHS = ["stablelm-1.6b", "granite-moe-1b-a400m"]
MODES = ["train", "prefill", "decode"]


def _cfgs(arch):
    jc = dataclasses.replace(jget_smoke(arch), compute_dtype="float32")
    tc = dataclasses.replace(get_smoke_config(arch), compute_dtype="float32")
    assert jc.attn_block_q == tc.attn_block_q
    return jc, tc


def _reference_cost(jc, mode: str, seq: int):
    p = jabstract(jlm.lm_param_specs(jc))
    idx = jax.ShapeDtypeStruct((), jnp.int32)
    if mode == "train":
        opt = jadamw(3e-4)
        low = jax.jit(jbuild_lm(jc, opt)).lower(
            p, jax.eval_shape(opt.init, p), jlm_batch(jc, BATCH, seq), idx)
    else:
        caches = jlm.cache_abstract(jc, BATCH, seq)
        if mode == "prefill":
            batch = {"tokens": jax.ShapeDtypeStruct((BATCH, seq), jnp.int32)}
            low = jax.jit(lambda p, b, c: jlm.prefill_step(
                p, b, c, jc, {})).lower(p, batch, caches)
        else:
            tok = jax.ShapeDtypeStruct((BATCH, 1), jnp.int32)
            low = jax.jit(lambda p, t, c, i: jlm.decode_step(
                p, t, c, i, jc, {})).lower(p, tok, caches, idx)
    return StableHloAnalysis(low.as_text()).cost()


def _port_cost(tc, mode: str, seq: int) -> StepAnalysis:
    if mode == "train":
        run = dryrun.lm_train_job(tc, sharding.TRAIN_RULES, None, BATCH,
                                  seq)
    elif mode == "prefill":
        run = dryrun.lm_serve_job(tc, {}, None, BATCH, seq)
    else:
        run = dryrun.lm_serve_job(tc, {}, None, BATCH, seq, seq,
                                  prefill=False, n_decode=1)
    return dryrun.measure(run, memory=False)[0]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_product_flops_equal_the_reference(arch, mode):
    jc, tc = _cfgs(arch)
    seq = tc.attn_block_q
    want = _reference_cost(jc, mode, seq)
    got = _port_cost(tc, mode, seq)
    assert got.cost.mxu_flops == want.mxu_flops
    assert got.cost.dot_count == want.dot_count
    assert got.kernels == {}            # plain attention at this length


def test_dlrm_product_flops_equal_the_reference_but_the_square():
    jc, tc = jget_smoke("dlrm-m1"), get_smoke_config("dlrm-m1")
    jebc, tebc = JEBC.build(jc, 1), EmbeddingBagCollection.build(tc, 1)
    jp = jabstract(jdlrm_specs(jc, jebc))
    opt = jadagrad(0.01)
    state = jax.eval_shape(lambda p: jdlrm_state(jebc, opt, p), jp)
    low = jax.jit(jbuild_dlrm(jc, jebc, opt)).lower(
        jp, state, jdlrm_batch(jc, 16), jax.ShapeDtypeStruct((), jnp.int32))
    want = StableHloAnalysis(low.as_text()).cost()
    tp = abstract_params(dlrm_param_specs(tc, tebc))
    topt = adagrad(0.01)
    step = build_dlrm_train_step(tc, tebc, topt, sparse_apply="dense")
    an = StepAnalysis(memory=False)
    with an:
        step(tp, dlrm_init_state(tebc, topt, tp), dlrm_batch_specs(tc, 16), 0)
    b, f, d = 16, tc.n_sparse_features + 1, tc.embed_dim
    packed = f * (f - 1) // 2
    assert an.kernels["dot_interaction"]["flops"] == 2 * b * packed * d
    assert want.mxu_flops - an.cost.mxu_flops == 2 * b * d * (f * f - packed)
    assert an.cost.dot_count == want.dot_count


# ---------------------------------------------------------------------------
# the meta kernels' booked costs: PERF.md's bound formulas
# ---------------------------------------------------------------------------


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _booked(fn):
    an = StepAnalysis(memory=False)
    before = {k.name: k.launches for k in KERNELS}
    with an:
        out = fn()
    assert {k.name: k.launches for k in KERNELS} == before   # no launch
    return an, out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dh", [64, 80])
def test_flash_attention_books_the_bound_formula(dtype, dh):
    """Row 10: 4·b·h·dh·s(s+1)/2 FLOPs and q, k, v, o once; row 10b: 2.5x
    the forward's FLOPs, q, k, v, o, dO, dq, dk, dv once and the fp32
    lse. dh 80 pads to the kernel's 128 on the card: the padded copies
    are allocated, the cost is the unpadded work."""
    b, h, s = 2, 3, 256
    q, k, v = (_meta((b, h, s, dh), dtype) for _ in range(3))
    an, (o, lse) = _booked(lambda: kf.flash_attention(q, k, v,
                                                      with_lse=True))
    assert o.shape == q.shape and o.dtype == dtype and o.is_meta
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    item = torch.tensor([], dtype=dtype).element_size()
    fwd = 4 * b * h * dh * s * (s + 1) / 2
    assert an.kernels["flash_attention"] == {
        "calls": 1, "flops": fwd, "bytes": 4 * b * h * s * dh * item}
    an, grads = _booked(lambda: kf.flash_attention_bwd(q, k, v, o, o, lse))
    assert [g.shape for g in grads] == [q.shape] * 3
    assert an.kernels["flash_attention_bwd"] == {
        "calls": 1, "flops": 2.5 * fwd,
        "bytes": 8 * b * h * s * dh * item + 4 * b * h * s}
    assert an.cost.mxu_flops == 2.5 * fwd


def test_embedding_bag_and_dot_interaction_book_the_bound_formulas():
    """Row 1: every slot counted valid, its row read, the int32 indices
    read and the pooled rows written; row 3: z read and the packed
    triangle written, 2·d FLOPs a pair."""
    rows, d, n, length = 1000, 16, 48, 5
    table, idx = _meta((rows, d)), _meta((n, length), torch.int32)
    an, out = _booked(lambda: kb.embedding_bag(table, idx))
    assert out.shape == (n, d) and out.is_meta
    assert an.kernels["embedding_bag"] == {
        "calls": 1, "flops": n * length * d,
        "bytes": 4.0 * (n * length * d + n * length + n * d)}
    b, f = 8, 7
    an, out = _booked(lambda: kd.dot_interaction(_meta((b, f, d))))
    p = f * (f - 1) // 2
    assert out.shape == (b, p)
    assert an.kernels["dot_interaction"] == {
        "calls": 1, "flops": b * p * 2 * d, "bytes": 4.0 * (b * f * d + b * p)}


def test_meta_is_a_third_device_not_a_fallback():
    """A CPU tensor still takes the plain version; meta mixed with another
    device, and a dtype the card refuses, still raise."""
    table = torch.randn(10, 4)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    torch.testing.assert_close(kb.embedding_bag(table, idx),
                               table[0].expand(2, 4) * 3)
    with pytest.raises(ValueError):
        kb.embedding_bag(_meta((10, 4)), idx)
    with pytest.raises(TypeError):
        kd.dot_interaction(_meta((2, 3, 4), torch.float64))
    with pytest.raises(ValueError):
        kf.flash_attention(_meta((1, 1, 8, 16)), torch.empty(1, 1, 8, 16),
                           _meta((1, 1, 8, 16)))


# ---------------------------------------------------------------------------
# cut loops: two microbatches stand for all of them, one chunk for all
# ---------------------------------------------------------------------------


def _counts(an: StepAnalysis, mesh) -> dict:
    c = dataclasses.asdict(an.cost)
    c["kernels"] = an.kernels
    if mesh is not None:
        c["stats"] = {k: v for k, v in mesh.stats.items()
                      if not k.endswith("_ms")}
    return c


def test_accumulation_counted_two_microbatches_equals_all_four():
    """accum_steps 4 on a (2, 2) dry mesh under FSDP: the cut run (two
    microbatches, the second weighted 3) counts what the full run does,
    cost, kernels and collectives; the peak is the same too (a third
    microbatch frees what the second made)."""
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                              compute_dtype="float32", attn_block_q=8)
    out = []
    for full in (False, True):
        mesh = DryMesh((2, 2), ("data", "model"))
        run = dryrun.lm_train_job(cfg, sharding.FSDP_RULES, mesh, 8, 32,
                                  accum_steps=4)
        if full:
            with kmeta.full_loops():
                an, _ = dryrun.measure(run, mesh)
        else:
            an, _ = dryrun.measure(run, mesh)
        out.append((_counts(an, mesh), an.peak_bytes))
    (cut, cut_peak), (full, full_peak) = out
    assert cut["kernels"]["flash_attention"]["calls"] == 4 * cfg.n_layers
    assert cut == full
    assert cut_peak == full_peak


def test_dense_row_pass_one_chunk_counts_every_chunk():
    """The dense update's row pass over 100 rows in chunks of 7: one full
    chunk weighted for all 14 and the ragged last (2 rows) count what
    every chunk does."""
    out = []
    for full in (False, True):
        mega, gsum = _meta((100, 16)), _meta((101, 16))
        accum = _meta((100,))
        an = StepAnalysis(memory=False)
        with an, (kmeta.full_loops() if full else contextlib.nullcontext()):
            dense_row_pass(mega, accum, gsum[:100], 0.05, 1e-8, 7)
        out.append(_counts(an, None))
    assert out[0] == out[1]
    assert out[0]["vpu_flops"] > 0


def test_a_backward_scatter_counts_as_the_zeros_it_fills():
    """Under a dispatch mode gather's gradient runs zeros.scatter_add(...)
    out of place; a run without one scatters into the zeros in place.
    The peak of x, its gradient and the small rest counts the gradient
    once (without the fold it would count two (4096, 1000) buffers)."""
    n, m = 4096, 1000
    x = torch.empty((n, m), device="meta", requires_grad=True)
    idx = torch.empty((n, 1), dtype=torch.long, device="meta")
    an = StepAnalysis()
    an.track(x, "parameters")
    with an:
        torch.take_along_dim(x, idx, dim=1).sum().backward()
    big = n * m * 4
    assert x.grad.shape == x.shape
    assert 2 * big <= an.peak_bytes < 2 * big + (1 << 20)
