"""The port's traffic models (`repro_torch.launch.analysis`) and roofline
(`repro_torch.launch.roofline`) against the reference's, on the CPU.

Every model keeps the reference's float64 operands in the reference's
order, so its dicts are held exactly equal; `zipf_expected_unique` within
1e-12 relative. `recommend_placement` is held key for key (the plan field
by field, `per_table`, `tiering` and its traffic) at the suite's hash
sizes with the real Zipf sums, and at dlrm-m1/-m2/-m3's with one
closed-form stand-in for `zipf_expected_unique` patched into both
packages: their 30-127 tables of up to 20M rows would take minutes of
O(hash) sums a call, and the sums themselves are held on their own here.
"""
import dataclasses
import math

import pytest

from repro.configs import get_config as jget_config
from repro.core import design_space as jds
from repro.launch import analysis as janalysis
from repro.launch import roofline as jroofline
from repro_torch.launch import analysis, roofline

PLAN_FIELDS = ("strategy", "table_offsets", "total_rows", "shard_of_table",
               "n_shards", "bytes_per_shard", "load_per_shard", "cache_rows",
               "capacity_shards", "shard_rows", "column_shards",
               "load_imbalance", "pspec")


@pytest.mark.parametrize("kw", [
    dict(batch=512, n_features=30, truncation=32, embed_dim=64),
    dict(batch=8192, n_features=128, truncation=32, embed_dim=128),
    dict(batch=1, n_features=1, truncation=1, embed_dim=5, itemsize=2,
         index_itemsize=8)])
def test_sparse_backward_traffic_equals_the_reference(kw):
    assert (analysis.sparse_backward_traffic(**kw)
            == janalysis.sparse_backward_traffic(**kw))


@pytest.mark.parametrize("kw", [
    dict(batch=512, n_features=30, truncation=32, embed_dim=64,
         n_unique=123_456.0),
    dict(batch=256, n_features=4, truncation=32, embed_dim=64,
         n_unique=2_000.5, plan_shared=False),
    dict(batch=8192, n_features=32, truncation=20, embed_dim=16,
         n_unique=1.0, itemsize=2, index_itemsize=8)])
def test_embedding_forward_traffic_equals_the_reference(kw):
    assert (analysis.embedding_forward_traffic(**kw)
            == janalysis.embedding_forward_traffic(**kw))


@pytest.mark.parametrize("kw", [
    dict(requests=64, examples=4, n_features=30, truncation=32,
         embed_dim=64, hit_rate=0.9),
    dict(requests=1000.0, examples=16, n_features=13, truncation=17,
         embed_dim=64, hit_rate=0.5, shed_rate=0.1, degraded_fraction=0.2,
         itemsize=2, accum_itemsize=8, descriptor_bytes=16),
    dict(requests=32, examples=4, n_features=30, truncation=32,
         embed_dim=64, hit_rate=1.0)])
def test_serve_replay_traffic_equals_the_reference(kw):
    got = analysis.serve_replay_traffic(**kw)
    assert got == janalysis.serve_replay_traffic(**kw)
    if kw["hit_rate"] == 1.0:
        assert got["uncached_vs_cached"] == float("inf")


@pytest.mark.parametrize("alpha", [1.05, 1.3])
@pytest.mark.parametrize("hash_size", [64, 100_000, 2_500_000])
def test_zipf_expected_unique_equals_the_reference(hash_size, alpha):
    n_draws = 256 * 32.0
    got = analysis.zipf_expected_unique(n_draws, hash_size, alpha)
    want = janalysis.zipf_expected_unique(n_draws, hash_size, alpha)
    assert got == pytest.approx(want, rel=1e-12)
    assert 0.0 < got <= min(n_draws, hash_size)


def _uniform_unique(n_draws, hash_size, alpha=1.05, chunk=1_000_000):
    """Closed-form stand-in for the O(hash) Zipf sum: the expected distinct
    rows of n uniform draws, h (1 - exp(-n / h))."""
    return hash_size * -math.expm1(-n_draws / hash_size)


def _suite(sweep, name):
    return dict(getattr(jds, sweep)())[name]


#: (name, config, hbm budget a host, real Zipf sums): the suite's default
#: point fits one budget, its widest fig10 point does not; 2 GB makes the
#: production models' largest tables column_wise
PLACED = [("suite-default", jds.test_suite_config(), 6e9, True),
          ("suite-dense4096_sparse128",
           _suite("sweep_fig10", "dense4096_sparse128"), 1e9, True),
          ("dlrm-m1", jget_config("dlrm-m1"), 2e9, False),
          ("dlrm-m2", jget_config("dlrm-m2"), 2e9, False),
          ("dlrm-m3", jget_config("dlrm-m3"), 2e9, False)]


@pytest.mark.parametrize("dram", [False, True], ids=["hbm", "dram_tiered"])
@pytest.mark.parametrize("n_hosts", [1, 2, 4, 8])
@pytest.mark.parametrize("name,cfg,budget,real", PLACED,
                         ids=[p[0] for p in PLACED])
def test_recommend_placement_equals_the_reference(name, cfg, budget, real,
                                                  n_hosts, dram,
                                                  monkeypatch):
    if not real:
        for mod in (analysis, janalysis):
            monkeypatch.setattr(mod, "zipf_expected_unique",
                                _uniform_unique)
    total = sum(h * (cfg.embed_dim * 4 + 4) for h in cfg.hash_sizes)
    kw = dict(hash_sizes=cfg.hash_sizes, mean_lookups=cfg.mean_lookups,
              embed_dim=cfg.embed_dim, batch=512,
              truncation=cfg.truncation, n_hosts=n_hosts,
              hbm_budget_bytes=budget, hit_rate=0.25,
              dram_budget_bytes=total / 2 if dram else 0.0)
    got = analysis.recommend_placement(**kw)
    want = janalysis.recommend_placement(**kw)
    assert got.keys() == want.keys()
    for k in ("pick", "fits_one_host", "per_table", "tablewise",
              "rowshard"):
        assert got[k] == want[k], k
    for f in PLAN_FIELDS:
        assert getattr(got["plan"], f) == getattr(want["plan"], f), f
    if not dram:
        assert got["tiering"] is want["tiering"] is None
        return
    assert got["tiering"] == want["tiering"]
    assert got["tiering"]["bulk_tables"]            # half the bytes spill
    assert {t["tier"] for t in got["per_table"]} == {"dram", "bulk"}


def test_recommend_placement_sums_each_distinct_table_once(monkeypatch):
    calls = []

    def counted(n_draws, hash_size, alpha=1.05, chunk=1_000_000):
        calls.append((n_draws, hash_size))
        return _uniform_unique(n_draws, hash_size)

    monkeypatch.setattr(analysis, "zipf_expected_unique", counted)
    cfg = jds.test_suite_config()
    analysis.recommend_placement(cfg.hash_sizes, cfg.mean_lookups, 64, 512,
                                 32, 4, 6e9)
    # 32 equal tables: one sum for the whole batch, one for a host's slice
    assert sorted(calls) == [(128 * 32.0, 100_000), (512 * 32.0, 100_000)]


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------


def test_tpu_spec_is_the_reference_spec():
    assert dataclasses.asdict(roofline.TPU_V5E) == dataclasses.asdict(
        jroofline.HW)
    assert [f.name for f in dataclasses.fields(roofline.HWSpec)] == [
        f.name for f in dataclasses.fields(jroofline.HWSpec)]


def test_h100_spec_is_the_ports_and_the_smoke_bounds():
    h = roofline.H100
    assert roofline.HW is h
    assert (h.name, h.peak_flops_bf16, h.hbm_bw, h.hbm_bytes, h.ici_bw) == (
        "NVIDIA H100 80GB HBM3", 989e12, 3.35e12, 80e9, 450e9)
    assert roofline.HBM_BYTES_PER_S == h.hbm_bw
    assert roofline.BF16_FLOPS == h.peak_flops_bf16


@pytest.mark.parametrize("args", [
    (1e15, 1e12, 0.0, 1, 8e14),
    (3e12, 4e11, 5e9, 4, 3e12),
    (1e9, 1e9, 1e12, 8, 5e8),
    (0.0, 0.0, 0.0, 1, 0.0)])
def test_roofline_terms_with_the_tpu_spec_equal_the_reference(args):
    assert (roofline.roofline_terms(*args, hw=roofline.TPU_V5E)
            == jroofline.roofline_terms(*args))


def test_roofline_terms_with_the_h100_spec_by_hand():
    # one suite step: 1.2 TFLOP and 9.4 GB of HBM traffic on one card
    flops, n_bytes = 1.2e12, 9.4e9
    got = roofline.roofline_terms(flops, n_bytes, 0.0, 1, flops)
    assert got["compute_s"] == flops / 989e12          # 1.213 ms
    assert got["memory_s"] == n_bytes / 3.35e12        # 2.806 ms
    assert got["dominant"] == "memory_s"
    assert got["bound_s"] == got["memory_s"]
    assert got["roofline_fraction"] == pytest.approx(
        (flops / 989e12) / (n_bytes / 3.35e12), rel=1e-15)
