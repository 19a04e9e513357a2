"""`launch.mesh.DryMesh` (one rank of a mesh, no world) against the
counts the port's steps are held to, and the meta device's paths
against the CPU's.

A dry mesh's collectives move nothing and book their calls and bytes in
`stats` through `Mesh`'s own bookkeeping. At smoke width on a (2, 2)
mesh (every rank, all on the meta device), each step's calls per
collective and axis must be exactly:
  * `train.steps.lm_step_collectives` for `build_lm_train_step(mesh=)`
    under FSDP_RULES and ZERO_DP_RULES (stablelm-1.6b, granite-moe with
    4 MoE groups, mamba2-780m; stablelm with accum_steps 2);
  * `serve.sharded.lm_serve_collectives` for `prefill_step` and
    `decode_step` under SERVE_RULES (stablelm-1.6b, and granite-moe with
    one MoE group, fewer than the 2 data ranks: every rank gathers the
    batch and routes it whole);
and the DLRM psum step on a (pod 2, data 1, model 2) mesh issues the
all_reduces its docstring names. The same runs' calls and bytes are held
to real gloo ranks' `Mesh.stats` in the files that spawn those ranks
(`test_torch_lm_mesh*.py`, `test_torch_lm_serve_mesh.py`,
`test_torch_multidevice.py`).

Every meta path the dry run added returns the CPU path's shapes and
dtypes: the MoE's routed counts, the decode position, the dense update's
scatter and row pass, `init_params`, and each collective.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.dlrm import dlrm_param_specs
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.mesh import DryMesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.nn import moe as MOE
from repro_torch.nn import sharding
from repro_torch.nn.params import init_params
from repro_torch.serve.sharded import lm_serve_collectives
from repro_torch.train.steps import (dense_gradient_sum, dense_row_pass,
                                     lm_step_collectives)

NAMES = ("data", "model")
BATCH, SEQ = 4, 32


def _calls(stats) -> dict:
    return {k[:-len("_calls")]: v for k, v in stats.items()
            if "@" in k and k.endswith("_calls") and v}


def _cfg(arch, **over):
    return dataclasses.replace(get_smoke_config(arch),
                               compute_dtype="float32", **over)


def test_layout_is_the_mesh_s_row_major_one():
    m = DryMesh((2, 3, 4), ("pod", "data", "model"), rank=17)
    assert m.coords == {"pod": 1, "data": 1, "model": 1}
    assert m.size("model") == 4 and m["data"].size() == 3
    assert m.shape == {"pod": 2, "data": 3, "model": 4}
    p = make_production_mesh(multi_pod=True, dry=True, rank=511)
    assert p.coords == {"pod": 1, "data": 15, "model": 15}
    with pytest.raises(ValueError):
        DryMesh((2, 2), NAMES, rank=4)
    assert set(m.stats) == {"skipped_calls", "skipped_bytes"} | {
        f"{op}{a}_{f}" for op in tmesh.COLLECTIVES
        for a in ("", "@pod", "@data", "@model")
        for f in ("calls", "bytes", "ms")}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_collectives_return_the_real_shapes_and_book_their_bytes(device):
    m = DryMesh((2, 2), NAMES, rank=3)
    x = torch.zeros((4, 3), dtype=torch.bfloat16, device=device)
    assert m.all_reduce(x, "data") is x
    rs = m.reduce_scatter(x, "model")
    ag = m.all_gather_rows(x, "data")
    a2a = m.all_to_all_rows([x[:1], x[1:]], [2, 5], "model")
    g = m.gather_rows(x, "model")
    for t, shape in ((rs, (2, 3)), (ag, (8, 3)), (a2a[0], (2, 3)),
                     (a2a[1], (5, 3)), (g, (8, 3))):
        assert t.shape == shape and t.dtype == x.dtype
        assert t.device.type == device
    st = m.stats
    assert st["all_reduce@data_calls"] == 1
    assert st["all_reduce@model_calls"] == 1          # gather_rows' sum
    assert st["all_reduce@model_bytes"] == 8 * 3 * 2
    assert st["reduce_scatter@model_bytes"] == 24
    assert st["all_gather@data_bytes"] == 24
    assert st["all_to_all@model_bytes"] == 24
    assert m.log[0] == ("all_reduce", "data", 24, 1)
    one = DryMesh((1, 2), NAMES)
    assert one.all_gather_rows(x, "data").shape == x.shape
    assert one.stats["skipped_calls"] == 1


def test_autograd_collectives_run_both_ways_on_meta():
    m = DryMesh((2, 2), NAMES, rank=1)
    x = torch.empty((4, 6), device="meta", requires_grad=True)
    y = tmesh.all_gather(x, m, ("data", "model"), 0)
    z = tmesh.reduce_scatter(y, m, ("model",), 1)
    w = tmesh.take_block(tmesh.copy_to(z, m, ("data",)), m, ("data",), 0)
    out = tmesh.reduce_from(w, m, ("model",))
    assert y.shape == (16, 6) and z.shape == (16, 3) and w.shape == (8, 3)
    out.sum().backward()
    assert x.grad.shape == x.shape and x.grad.is_meta
    # forward: the gather over both axes, the scatter over model, the sum
    # over model; backward: reduce_from's identity, take_block's gather
    # over data, copy_to's sum over data, the scatter's gather over model,
    # the gather's partial cotangent scattered over both axes
    assert _calls(m.stats) == {"all_gather@data": 2, "all_gather@model": 2,
                               "reduce_scatter@model": 2,
                               "reduce_scatter@data": 1,
                               "all_reduce@model": 1, "all_reduce@data": 1}


TRAIN_RUNS = [("stablelm-1.6b", "FSDP_RULES", 1),
              ("granite-moe-1b-a400m", "FSDP_RULES", 1),
              ("mamba2-780m", "FSDP_RULES", 1),
              ("stablelm-1.6b", "FSDP_RULES", 2),
              ("stablelm-1.6b", "ZERO_DP_RULES", 1),
              ("granite-moe-1b-a400m", "ZERO_DP_RULES", 1)]


@pytest.mark.parametrize("arch,table,accum", TRAIN_RUNS,
                         ids=[f"{a}-{t}-{n}" for a, t, n in TRAIN_RUNS])
def test_train_step_books_lm_step_collectives(arch, table, accum):
    cfg = _cfg(arch, moe_groups=4)
    rules = getattr(sharding, table)
    want = lm_step_collectives(cfg, rules, DryMesh((2, 2), NAMES), accum)
    for rank in range(4):
        m = DryMesh((2, 2), NAMES, rank)
        an, _ = dryrun.measure(dryrun.lm_train_job(
            cfg, rules, m, BATCH, SEQ, accum), m, memory=False)
        assert _calls(m.stats) == want, rank
        assert m.stats["all_to_all_calls"] == 0


SERVE_RUNS = [("stablelm-1.6b", {}), ("granite-moe-1b-a400m",
                                       {"moe_groups": 1})]


@pytest.mark.parametrize("arch,over", SERVE_RUNS,
                         ids=[a for a, _ in SERVE_RUNS])
def test_serving_steps_book_lm_serve_collectives(arch, over):
    cfg = _cfg(arch, **over)
    rules = sharding.SERVE_RULES
    max_len = SEQ + 2
    for mode, prefill, n in (("prefill", True, 0), ("decode", False, 1)):
        want = lm_serve_collectives(cfg, rules, DryMesh((2, 2), NAMES),
                                    mode, max_len)
        for rank in range(4):
            m = DryMesh((2, 2), NAMES, rank)
            dryrun.measure(dryrun.lm_serve_job(
                cfg, rules, m, BATCH, SEQ, max_len, prefill=prefill,
                n_decode=n), m, memory=False)
            assert _calls(m.stats) == want, (mode, rank)
    if over:
        # the replicated MoE gathers the batch over `data` in each layer
        assert want["all_gather@data"] > 1


def test_dlrm_psum_step_on_a_pod_mesh():
    """(pod 2, data 1, model 2): the batch splits over pod and data; the
    lookup's partial pools sum over `model`, the dense gradients, the
    loss's per-example terms and the dense update's row sums over `pod`
    (`data`'s one rank is skipped)."""
    cfg = dataclasses.replace(get_smoke_config("dlrm-m1"),
                              placement="row_wise", lookup_impl="psum")
    for rank in range(4):
        m = DryMesh((2, 1, 2), ("pod", "data", "model"), rank)
        ebc = EmbeddingBagCollection.build(cfg, 2)
        cell = dryrun.Cell("dlrm-m1", dataclasses.replace(
            dryrun.shapes_for("dlrm-m1")["train_b64k"], global_batch=16),
            cfg, {}, dlrm_param_specs(cfg, ebc), {}, {}, ebc=ebc)
        dryrun.measure(cell.make(m), m, memory=False)
        assert _calls(m.stats) == {"all_reduce@model": 1,
                                   "all_reduce@pod": 3}
        # the dense gradients' and the row sums' all_reduce over data
        assert m.stats["skipped_calls"] == 2


# ---------------------------------------------------------------------------
# the meta paths return the CPU paths' shapes and dtypes
# ---------------------------------------------------------------------------


def _same(cpu, meta):
    assert meta.is_meta
    assert (tuple(cpu.shape), cpu.dtype) == (tuple(meta.shape), meta.dtype)


def test_moe_routing_counts_on_meta():
    cfg = _cfg("granite-moe-1b-a400m")
    router = torch.randn(cfg.d_model, cfg.n_experts)
    xg = torch.randn(2, 8, cfg.d_model)
    cpu = MOE.route(router, xg, cfg, 8, torch.float32)
    meta = MOE.route(router.to("meta"), xg.to("meta"), cfg, 8,
                     torch.float32)
    for k in cpu:
        _same(cpu[k], meta[k])


def test_decode_index_on_meta():
    vec = lm._decode_index(torch.tensor([3, 4]), 2, "cpu", 10)
    _same(vec, lm._decode_index(torch.empty(2, dtype=torch.int32,
                                            device="meta"), 2, "meta", 10))
    with pytest.raises(ValueError, match="meta"):
        lm._decode_index(torch.empty((), device="meta"), 2, "meta", 10)
    with pytest.raises(ValueError):
        lm._decode_index(torch.empty(3, device="meta"), 2, "meta", 10)


def test_dense_update_on_meta():
    rng = np.random.RandomState(0)
    idx = torch.from_numpy(rng.randint(-1, 30, size=(4, 3, 5)).astype(
        np.int32))
    g = torch.randn(4, 3, 8)
    cpu = dense_gradient_sum(30, idx, g)
    meta = dense_gradient_sum(30, idx.to("meta"), g.to("meta"))
    _same(cpu, meta)
    mega, acc = torch.randn(30, 8), torch.zeros(30)
    dense_row_pass(mega, acc, cpu[:30], 0.05, 1e-8, 7)
    mm, ma = mega.to("meta"), acc.to("meta")
    dense_row_pass(mm, ma, meta[:30], 0.05, 1e-8, 7)
    _same(mega, mm)
    _same(acc, ma)


def test_init_params_on_meta():
    specs = lm.lm_param_specs(_cfg("stablelm-1.6b"))
    cpu = init_params(specs, 0, "cpu")
    meta = init_params(specs, 0, "meta")
    for a, b in zip(_leaves(cpu), _leaves(meta), strict=True):
        _same(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]
