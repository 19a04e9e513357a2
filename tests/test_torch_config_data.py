"""The port's configs, synthetic batches and placement plans against the
reference package's: every DLRMConfig field equal, make_dlrm_batch arrays
identical (with and without zipf_alpha), plan offsets / total_rows /
cache_rows equal. All exact — the port copies the reference's numpy calls.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.core.placement import plan_placement as jplan
from repro.data.synthetic import make_dlrm_batch as jbatch
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.core.placement import plan_placement
from repro_torch.data.synthetic import make_dlrm_batch

NAMES = ["dlrm-m1", "dlrm-m2", "dlrm-m3"]
CASES = [(n, False) for n in NAMES] + [(n, True) for n in NAMES]


def _pair(name, smoke):
    return ((get_smoke_config(name), jget_smoke(name)) if smoke
            else (get_config(name), jget_config(name)))


@pytest.mark.parametrize("name,smoke", CASES)
def test_config_fields_equal(name, smoke):
    port, want = _pair(name, smoke)
    for f in dataclasses.fields(port):
        assert getattr(port, f.name) == getattr(want, f.name), f.name
    assert port.table_bytes() == want.table_bytes()


@pytest.mark.parametrize("name,smoke", CASES)
def test_make_dlrm_batch_identical(name, smoke):
    port, want = _pair(name, smoke)
    # the bounded-Zipf CDF spans every table row: at full width that is a
    # 170M-entry table of the chip run's, so full configs draw the
    # per-example Zipf here and the smoke configs both samplers
    alphas = (None, 1.05) if smoke else (None,)
    for alpha in alphas:
        for step in (0, 3):
            a = make_dlrm_batch(port, 5, step=step, seed=2, zipf_alpha=alpha)
            b = jbatch(want, 5, step=step, seed=2, zipf_alpha=alpha)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == np.asarray(b[k]).dtype, k
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))


@pytest.mark.parametrize("strategy", ["replicated", "cached_host"])
@pytest.mark.parametrize("name,smoke", CASES)
def test_plan_placement_equal(name, smoke, strategy):
    port, want = _pair(name, smoke)
    args = (port.hash_sizes, port.mean_lookups, port.embed_dim, 1)
    kw = {"hbm_budget_bytes": port.hbm_budget_gb * 1e9, "strategy": strategy}
    a, b = plan_placement(*args, **kw), jplan(*args, **kw)
    assert a.strategy == b.strategy
    assert a.table_offsets == b.table_offsets
    assert a.total_rows == b.total_rows
    assert a.cache_rows == b.cache_rows
    assert a.bytes_per_shard == b.bytes_per_shard


def test_m1_serving_plan_sizes():
    plan = EmbeddingBagCollection.build(get_config("dlrm-m1"),
                                        strategy="cached_host").plan
    assert plan.total_rows == 170_361_920
    assert plan.cache_rows == 22_727_272


def test_auto_resolves_like_the_reference_or_names_the_later_slice():
    smoke = get_smoke_config("dlrm-m1")
    args = (smoke.hash_sizes, smoke.mean_lookups, smoke.embed_dim, 1)
    a = plan_placement(*args, hbm_budget_bytes=smoke.hbm_budget_gb * 1e9)
    b = jplan(*args, hbm_budget_bytes=smoke.hbm_budget_gb * 1e9)
    assert (a.strategy, a.table_offsets) == (b.strategy, b.table_offsets)
    # the table-wise slice ported the planning of auto, table_wise and
    # row_wise, the multi-device slice column_wise (each raised
    # NotImplementedError before)
    full = get_config("dlrm-m1")
    args = (full.hash_sizes, full.mean_lookups, full.embed_dim, 4)
    kw = dict(hbm_budget_bytes=full.hbm_budget_gb * 1e9)
    for strategy in ("auto", "table_wise", "row_wise", "column_wise"):
        a = plan_placement(*args, **kw, strategy=strategy)
        b = jplan(*args, **kw, strategy=strategy)
        for field in ("strategy", "table_offsets", "total_rows",
                      "shard_of_table", "bytes_per_shard", "load_per_shard",
                      "shard_rows", "column_shards", "pspec"):
            assert getattr(a, field) == getattr(b, field), (strategy, field)


def test_offset_indices_equal_for_numpy_and_tensors():
    import torch

    from repro.core.embedding import EmbeddingBagCollection as JEBC
    cfg = get_smoke_config("dlrm-m1")
    raw = make_dlrm_batch(cfg, 6, zipf_alpha=1.05)["idx"]
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    want = np.asarray(JEBC.build(jget_smoke("dlrm-m1"), n_shards=1,
                                 strategy="replicated").offset_indices(raw))
    np.testing.assert_array_equal(ebc.offset_indices(raw), want)
    np.testing.assert_array_equal(
        ebc.offset_indices(torch.from_numpy(raw)).numpy(), want)


LM_NAMES = ["stablelm-1.6b", "starcoder2-3b", "chatglm3-6b", "qwen1.5-32b"]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("name", LM_NAMES)
def test_dense_lm_config_fields_equal(name, smoke):
    port, want = _pair(name, smoke)
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert getattr(port, f.name) == getattr(want, f.name), f.name
    assert (port.pattern, port.n_units) == (want.pattern, want.n_units)


def test_lm_registry_and_shapes_equal():
    from repro.configs.base import LM_SHAPES as JSHAPES
    from repro.configs.base import shapes_for as jshapes_for
    from repro.configs.registry import ARCHS as JARCHS
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import LM_SHAPES, shapes_for
    assert sorted(ARCHS) == sorted(n for n, c in JARCHS.items()
                                   if c.family in ("dense", "moe", "ssm",
                                                   "hybrid"))
    assert {k: dataclasses.astuple(v) for k, v in LM_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JSHAPES.items()}
    for name in LM_NAMES + ["mamba2-780m", "dlrm-m1"]:
        assert {k: dataclasses.astuple(v)
                for k, v in shapes_for(name).items()} == \
            {k: dataclasses.astuple(v) for k, v in jshapes_for(name).items()}


@pytest.mark.parametrize("name", ["stablelm-1.6b", "qwen1.5-32b"])
def test_make_lm_batch_identical(name):
    from repro.data.synthetic import make_lm_batch as jlm_batch
    from repro_torch.data.synthetic import make_lm_batch
    port, want = _pair(name, False)
    for step, seed in ((0, 0), (3, 2)):
        a = make_lm_batch(port, 3, 17, step=step, seed=seed)
        b = jlm_batch(want, 3, 17, step=step, seed=seed)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k])
