"""The port's table-wise slice against the reference, on the CPU: the
placement planner (each strategy it plans, with `table_costs`,
`second_axis_size` and `capacity_shards`), `frequency_reorder` and
`elastic_table_remap`, the per-owner / per-range / per-table plan splits,
the segmented fused sparse backward, the legacy two-pass update (dedup,
then row-wise AdaGrad), `build_tablewise_train_step` and the host-loss
re-pack (`elastic_tablewise_repack`, the reference's chaos scenario 4).
The step under a mesh is held in tests/test_torch_multidevice.py.
Inputs come from numpy seeds; parameters are copied across
(`repro_torch.convert`). Sizes: the smoke dlrm-m1 (6 tables, d=16) over 4
owners, batch 16; the planner also at full dlrm-m1 width (numpy only, no
table is built).

Tolerances, each with its reason (those of tests/test_torch_train.py):
  * plans, segments, placements and every other integer output: exactly
    equal;
  * per-row bag-gradient and dedup sums: bit-equal (both packages add a
    row's gradients one by one in sorted CSR order);
  * updates vs the reference's jnp oracle: rtol 1e-6 / atol 1e-7 (mean(g^2)
    is reduced in another order than XLA's, and XLA's rsqrt is not
    torch's); vs its Pallas kernel in interpret mode: rtol 1e-5 / atol
    1e-6 (the reference's own bound for its kernel body, which lane-pads D
    and rescales);
  * losses, parameters and optimizer state after training steps: rtol /
    atol 1e-5 (fp32 matmuls and sums in other orders);
  * inside the port, segmented vs unsegmented updates, the two-pass vs the
    fused update, and the table-wise step vs `build_dlrm_train_step` on the
    same layout: bit-equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke
from repro.core import dlrm as jdlrm
from repro.core import placement as jplacement
from repro.core.embedding import EmbeddingBagCollection as JEBC
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sparse_plan as jsp
from repro.launch import analysis as janalysis
from repro.nn.params import init_params as jinit
from repro.optim import adagrad as jadagrad
from repro.train import steps as jsteps
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core import placement
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.data.pipeline import sparse_plan_hook
from repro_torch.data.synthetic import make_dlrm_batch
from repro_torch.kernels import ops, ref, sparse_plan, sparse_update
from repro_torch.launch import analysis
from repro_torch.optim import adagrad
from repro_torch.train import (build_dlrm_train_step,
                               build_tablewise_train_step, dlrm_init_state)

STEP_TOL = {"rtol": 1e-5, "atol": 1e-5}
FUSED_TOL = {"rtol": 1e-6, "atol": 1e-7}
KERNEL_TOL = {"rtol": 1e-5, "atol": 1e-6}
PLAN_FIELDS = ("strategy", "table_offsets", "total_rows", "shard_of_table",
               "n_shards", "bytes_per_shard", "load_per_shard", "cache_rows",
               "capacity_shards", "shard_rows", "column_shards",
               "load_imbalance", "pspec")


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _same_plan(got, want):
    for name in PLAN_FIELDS:
        assert getattr(got, name) == getattr(want, name), name

# ---------------------------------------------------------------------------
# placement: every strategy, field by field
# ---------------------------------------------------------------------------


SIZES, LOADS = [1000, 500, 800, 300, 37], [4.0, 1.0, 3.0, 2.0, 9.0]
PLACEMENTS = {
    "replicated": dict(n_shards=1, budget=1e9, strategy="replicated"),
    "row_wise": dict(n_shards=4, budget=1e9, strategy="row_wise"),
    "row_wise_odd": dict(n_shards=3, budget=40_000, strategy="row_wise"),
    "table_wise": dict(n_shards=3, budget=1e9, strategy="table_wise"),
    "table_wise_full_owners": dict(n_shards=3, budget=60_000,
                                   strategy="table_wise"),
    "cached_host": dict(n_shards=1, budget=20_000, strategy="cached_host"),
    "host_offload_alias": dict(n_shards=2, budget=20_000,
                               strategy="host_offload"),
    "auto_replicated": dict(n_shards=2, budget=1e9, strategy="auto"),
    "auto_table_wise": dict(n_shards=4, budget=80_000, strategy="auto"),
    "auto_row_wise": dict(n_shards=2, budget=30_000, strategy="auto"),
    "column_wise": dict(n_shards=4, budget=1e9, strategy="column_wise"),
    "row_wise_second_axis": dict(n_shards=2, budget=20_000,
                                 strategy="row_wise", second_axis_size=4),
    "row_wise_second_axis_unused": dict(n_shards=2, budget=1e9,
                                        strategy="row_wise",
                                        second_axis_size=4),
    "cached_host_sharded": dict(n_shards=2, budget=20_000,
                                strategy="cached_host", capacity_shards=3),
    "table_wise_priced": dict(n_shards=2, budget=1e9, strategy="table_wise",
                              table_costs=[1.0, 9.0, 1.0, 8.0, 2.0]),
    "table_wise_named_axis": dict(n_shards=3, budget=1e9,
                                  strategy="table_wise", model_axis="owners"),
}


@pytest.mark.parametrize("case", list(PLACEMENTS))
def test_plan_placement_equals_reference(case):
    kw = dict(PLACEMENTS[case])
    n, budget = kw.pop("n_shards"), kw.pop("budget")
    want = jplacement.plan_placement(SIZES, LOADS, 16, n, budget, **kw)
    got = placement.plan_placement(SIZES, LOADS, 16, n, budget, **kw)
    _same_plan(got, want)


def test_table_wise_packs_by_load_like_reference():
    sizes, loads = [400, 400, 400, 400], [10.0, 10.0, 1.0, 1.0]
    want = jplacement.plan_placement(sizes, loads, 16, 2, 1e9,
                                     strategy="table_wise")
    got = placement.plan_placement(sizes, loads, 16, 2, 1e9,
                                   strategy="table_wise")
    _same_plan(got, want)
    owners = np.asarray(got.table_offsets) // got.shard_rows
    assert owners[0] != owners[1]          # the two busy tables split
    assert got.load_per_shard == (11.0, 11.0)


def test_table_wise_oversized_table_flagged_like_reference():
    d, budget = 16, 100 * 16 * 4           # one owner holds 100 rows
    want = jplacement.plan_placement([350, 40], [1.0, 1.0], d, 4, budget,
                                     strategy="table_wise")
    got = placement.plan_placement([350, 40], [1.0, 1.0], d, 4, budget,
                                   strategy="table_wise")
    _same_plan(got, want)
    assert got.column_shards == (4, 1)


def test_column_wise_names_the_later_slice():
    """column_wise plans as the reference's does (every table sliced over
    all shards, the dim split) and refuses a dim the shards do not divide,
    with the reference's message; an unknown strategy is refused."""
    want = jplacement.plan_placement([100, 50], [1.0, 1.0], 64, 4, 1e9,
                                     strategy="column_wise")
    got = placement.plan_placement([100, 50], [1.0, 1.0], 64, 4, 1e9,
                                   strategy="column_wise")
    _same_plan(got, want)
    assert got.column_shards == (4, 4) and got.pspec == (None, "model")
    msgs = []
    for mod in (jplacement, placement):
        with pytest.raises(ValueError, match="divisible") as e:
            mod.plan_placement([100, 50], [1.0, 1.0], 30, 4, 1e9,
                               strategy="column_wise")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="unknown placement"):
        placement.plan_placement([100], [1.0], 16, 1, 1e9, strategy="nope")


def test_table_wise_priced_costs_override_loads_like_reference():
    """The reference's case: costs that invert the load order split the
    tables the costs call heavy, and balance the summed cost."""
    sizes, loads = [400, 400, 400, 400], [10.0, 10.0, 1.0, 1.0]
    costs = [1.0, 1.0, 10.0, 10.0]
    want = jplacement.plan_placement(sizes, loads, 16, 2, 1e9,
                                     strategy="table_wise",
                                     table_costs=costs)
    got = placement.plan_placement(sizes, loads, 16, 2, 1e9,
                                   strategy="table_wise", table_costs=costs)
    _same_plan(got, want)
    owners = np.asarray(got.table_offsets) // got.shard_rows
    assert owners[2] != owners[3]
    assert got.load_per_shard[0] == got.load_per_shard[1]


@pytest.mark.parametrize("strategy,kw", [
    ("row_wise", dict(second_axis_size=2)),
    ("cached_host", dict(capacity_shards=4)),
    ("table_wise", dict()),
], ids=["row_wise_second_axis", "cached_host_sharded", "table_wise"])
def test_full_width_options_equal_reference(strategy, kw):
    """The options at full dlrm-m1 width through the collection's build,
    with the reference's 6 GB budget: row_wise over 4 x 2 shards, the
    capacity tier over 4 hosts, table_wise over 4 owners."""
    cfg, jcfg = get_config("dlrm-m1"), jget_config("dlrm-m1")
    got = EmbeddingBagCollection.build(cfg, n_shards=4, strategy=strategy,
                                       **kw).plan
    want = JEBC.build(jcfg, n_shards=4, strategy=strategy, **kw).plan
    _same_plan(got, want)


def test_frequency_reorder_equals_reference():
    """The reference's case (tests/test_cache_admission.py) and a random
    one over a smoke table's layout: integers equal."""
    offs, sizes = [0, 10], [10, 6]
    freq = np.zeros((16,))
    freq[[3, 7, 9]] = [5, 9, 2]
    freq[[12, 15]] = [4, 1]
    cases = [(offs, sizes, freq, 16)]
    cfg = get_smoke_config("dlrm-m1")
    plan = EmbeddingBagCollection.build(cfg, n_shards=3,
                                        strategy="table_wise").plan
    rng = np.random.RandomState(6)
    cases.append((plan.table_offsets, cfg.hash_sizes,
                  rng.randint(0, 5, plan.total_rows), plan.total_rows))
    for args in cases:
        want = jplacement.frequency_reorder(*args)
        got = placement.frequency_reorder(*args)
        for w, g in zip(want, got):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
    remap, inverse = placement.frequency_reorder(offs, sizes, freq, 16)
    assert remap[7] == 0 and remap[3] == 1 and remap[9] == 2
    assert (inverse[remap] == np.arange(16)).all()
    for mod in (jplacement, placement):
        with pytest.raises(ValueError, match="shape"):
            mod.frequency_reorder([0], [4], np.zeros((3,)), 4)


@pytest.mark.parametrize("owners", [(4, 3), (3, 4), (4, 1)])
def test_elastic_table_remap_equals_reference(owners):
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    old, new = (EmbeddingBagCollection.build(cfg, n_shards=n,
                                             strategy="table_wise").plan
                for n in owners)
    jold, jnew = (JEBC.build(jcfg, n_shards=n, strategy="table_wise").plan
                  for n in owners)
    want = jplacement.elastic_table_remap(jold, jnew, jcfg.hash_sizes)
    got = placement.elastic_table_remap(old, new, cfg.hash_sizes)
    for w, g in zip(want, got):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="same tables"):
        placement.elastic_table_remap(old, new, cfg.hash_sizes[:-1])


def test_auto_at_one_shard_plans_full_width_m1_like_reference():
    """The repair: full-width dlrm-m1 does not fit one 6 GB budget, so
    `auto` resolves to a one-shard row_wise plan whose layout is the
    replicated one. The port used to raise here."""
    cfg, jcfg = get_config("dlrm-m1"), jget_config("dlrm-m1")
    got = EmbeddingBagCollection.build(cfg, n_shards=1).plan
    want = JEBC.build(jcfg, n_shards=1).plan
    _same_plan(got, want)
    rep = EmbeddingBagCollection.build(cfg, strategy="replicated").plan
    assert got.strategy == "row_wise" and got.n_shards == 1
    assert got.total_rows == rep.total_rows == 170_361_920
    assert got.table_offsets == rep.table_offsets


@pytest.mark.parametrize("owners", [2, 4, 8])
def test_full_width_m1_table_wise_equals_reference(owners):
    cfg, jcfg = get_config("dlrm-m1"), jget_config("dlrm-m1")
    got = EmbeddingBagCollection.build(cfg, n_shards=owners,
                                       strategy="table_wise").plan
    want = JEBC.build(jcfg, n_shards=owners, strategy="table_wise").plan
    _same_plan(got, want)
    assert got.total_rows == got.shard_rows * owners < 2 ** 31
    if owners == 8:
        assert got.total_rows == 205_375_296
        assert got.shard_rows == 25_671_912
        assert set(got.column_shards) == {1}
        assert np.bincount(np.asarray(got.table_offsets)
                           // got.shard_rows).tolist() == [1, 3, 3, 5, 4, 5,
                                                           5, 4]


@pytest.mark.parametrize("strategy", ["auto", "replicated", "row_wise",
                                      "table_wise", "cached_host"])
def test_collection_build_plans_like_reference(strategy):
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    _same_plan(EmbeddingBagCollection.build(cfg, n_shards=2,
                                            strategy=strategy).plan,
               JEBC.build(jcfg, n_shards=2, strategy=strategy).plan)

# ---------------------------------------------------------------------------
# plan splits: integers equal to the reference's
# ---------------------------------------------------------------------------


def _corpus():
    """The reference's split corpus (tests/test_cache_multihost.py)."""
    rng = np.random.RandomState(0)
    out = {
        "random": rng.randint(-1, 40, size=(16, 3, 5)).astype(np.int32),
        "all_dup": np.full((8, 2, 4), 7, np.int32),
        "all_pads": np.full((8, 2, 4), -1, np.int32),
        "zipfish": np.where(rng.rand(16, 2, 6) < 0.7,
                            rng.zipf(1.5, (16, 2, 6)) % 30,
                            -1).astype(np.int32),
    }
    hot = rng.randint(-1, 48, size=(16, 2, 4)).astype(np.int32)
    hot[:, 0, 0] = 3                       # one row on every bag's list
    out["hot_everywhere"] = hot
    return out


CORPUS = list(_corpus())


@pytest.mark.parametrize("tight", [True, False], ids=["tight", "cap_U"])
@pytest.mark.parametrize("name", CORPUS)
def test_split_by_owner_equals_reference(name, tight):
    plan = jsp.build_sparse_plan_host(_corpus()[name])
    cap = None if tight else len(plan.unique_rows)
    want = jsp.split_plan_by_owner(plan, 12, 4, seg_cap=cap)
    got = sparse_plan.split_plan_by_owner(plan, 12, 4, seg_cap=cap)
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


def test_split_by_ranges_skips_gaps_like_reference():
    plan = jsp.build_sparse_plan_host(_corpus()["random"])
    want = jsp.split_plan_by_ranges(plan, [0, 20, 33], [10, 30, 33])
    got = sparse_plan.split_plan_by_ranges(plan, [0, 20, 33], [10, 30, 33])
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert (got[0][2] < 0).all()           # the empty range: an empty segment


def test_split_by_ranges_rejects_overlap_like_reference():
    plan = jsp.build_sparse_plan_host(np.zeros((2, 1, 1), np.int32))
    for mod in (jsp, sparse_plan):
        with pytest.raises(AssertionError, match="ascending and disjoint"):
            mod.split_plan_by_ranges(plan, [0, 5], [10, 15])


@pytest.mark.parametrize("name", CORPUS)
def test_split_by_table_equals_reference(name):
    """Tables at offsets out of row order (a table_wise layout's), with a
    gap between two: the segments in TABLE order, integers equal."""
    plan = jsp.build_sparse_plan_host(_corpus()[name])
    offs, rows = [24, 0, 40, 12], [12, 10, 8, 6]
    for cap in (None, len(plan.unique_rows)):
        want = jsp.split_plan_by_table(plan, offs, rows, seg_cap=cap)
        got = sparse_plan.split_plan_by_table(plan, offs, rows, seg_cap=cap)
        for w, g in zip(want, got):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[2], offs)


def test_split_by_table_recovers_per_table_footprints():
    """The reference's property on the smoke table_wise layout: each
    table's segment is the live rows in its span, as many as the batch's
    unique rows there."""
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, n_shards=2, strategy="table_wise")
    idx = ebc.offset_indices(make_dlrm_batch(cfg, 8, step=0)["idx"])
    plan = sparse_plan.build_sparse_plan_host(idx)
    offs = np.asarray(ebc.plan.table_offsets, np.int64)
    rows_of = np.asarray([-(-h // 8) * 8 for h in cfg.hash_sizes], np.int64)
    seg_rows, _, seg_base = sparse_plan.split_plan_by_table(plan, offs,
                                                            rows_of)
    np.testing.assert_array_equal(seg_base, offs.astype(np.int32))
    live = plan.unique_rows[plan.unique_rows >= 0]
    for t in range(len(offs)):
        mine = seg_rows[t][seg_rows[t] >= 0] + offs[t]
        span = (live >= offs[t]) & (live < offs[t] + rows_of[t])
        np.testing.assert_array_equal(mine, live[span])
        inside = idx[(idx >= offs[t]) & (idx < offs[t] + rows_of[t])]
        assert len(mine) == len(np.unique(inside))


def test_split_overflow_message_equals_reference():
    plan = jsp.build_sparse_plan_host(_corpus()["random"])
    msgs = []
    for mod in (jsp, sparse_plan):
        with pytest.raises(ValueError, match="segment overflow") as e:
            mod.split_plan_by_owner(plan, 40, 1, seg_cap=2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# the segmented fused sparse backward
# ---------------------------------------------------------------------------


def _segment_inputs(name, h=48, d=16, seed=2):
    """The reference's segmented-update inputs: rows within a 48-row table,
    4 owners of 12 rows."""
    rng = np.random.RandomState(seed)
    raw = _corpus()[name]
    idx = np.where(raw >= 0, raw % h, -1).astype(np.int32)
    b, f, _ = idx.shape
    table = rng.randn(h, d).astype(np.float32)
    accum = rng.rand(h).astype(np.float32)
    pooled = rng.randn(b * f, d).astype(np.float32)
    return idx, table, accum, pooled


@pytest.mark.parametrize("name", CORPUS)
def test_abs_offset_segment_sums_and_update_match_reference(name):
    """Per owner segment (absolute offsets, rows in table space): the bag
    sums bit-equal, the update within the jnp-oracle tolerance."""
    idx, table, accum, pooled = _segment_inputs(name)
    plan = jsp.build_sparse_plan_host(idx)
    seg_rows, seg_offs, seg_base = jsp.split_plan_by_owner(plan, 12, 4)
    bags = plan.bag_ids
    for rows, offs, base in zip(seg_rows, seg_offs, seg_base):
        want = np.asarray(jref.bag_grad_sums_abs(
            jnp.asarray(offs), jnp.asarray(bags), jnp.asarray(pooled)))
        got = ref.bag_grad_sums_abs(_t(offs), _t(bags), _t(pooled))
        np.testing.assert_array_equal(got.numpy(), want)
        rows = np.where(rows >= 0, rows + base, -1).astype(np.int32)
        wt, wa = jref.fused_bag_backward_adagrad_abs_ref(
            *map(jnp.asarray, (table, accum, rows, offs, bags, pooled)),
            0.05)
        gt, ga = ref.fused_bag_backward_adagrad_ref(
            *map(_t, (table, accum, rows, offs, bags, pooled)), 0.05)
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **FUSED_TOL)
        np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **FUSED_TOL)


def _port_segments(idx, table, accum, pooled, seg_cap=None, owners=4,
                   shard_rows=12):
    plan = sparse_plan.build_sparse_plan_host(idx)
    seg_rows, seg_offs, seg_base = sparse_plan.split_plan_by_owner(
        plan, shard_rows, owners, seg_cap=seg_cap)
    t, a = _t(table), _t(accum)
    out = ops.fused_sparse_backward_segments(
        t, a, _t(seg_rows), _t(seg_offs), _t(plan.bag_ids), _t(pooled),
        0.05, seg_base=_t(seg_base))
    assert out[0] is t and out[1] is a                 # in place
    return t, a


@pytest.mark.parametrize("name", ["random", "all_dup", "all_pads"])
def test_segments_match_reference_jnp(name):
    idx, table, accum, pooled = _segment_inputs(name)
    plan = jsp.build_sparse_plan_host(idx)
    seg_rows, seg_offs, seg_base = jsp.split_plan_by_owner(
        plan, 12, 4, seg_cap=len(plan.unique_rows))
    wt, wa = jops.fused_sparse_backward_segments(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(seg_rows),
        jnp.asarray(seg_offs), jnp.asarray(plan.bag_ids),
        jnp.asarray(pooled), 0.05, seg_base=jnp.asarray(seg_base))
    gt, ga = _port_segments(idx, table, accum, pooled)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **FUSED_TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **FUSED_TOL)
    touched = np.zeros(len(table), bool)
    touched[idx[idx >= 0]] = True
    np.testing.assert_array_equal(gt.numpy()[~touched], table[~touched])
    np.testing.assert_array_equal(ga.numpy()[~touched], accum[~touched])


@pytest.mark.parametrize("name", ["random", "all_dup", "all_pads"])
def test_segments_match_pallas_interpret(name):
    idx, table, accum, pooled = _segment_inputs(name)
    plan = jsp.build_sparse_plan_host(idx)
    seg_rows, seg_offs, seg_base = jsp.split_plan_by_owner(
        plan, 12, 4, seg_cap=len(plan.unique_rows))
    wt, wa = jops.fused_sparse_backward_segments(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(seg_rows),
        jnp.asarray(seg_offs), jnp.asarray(plan.bag_ids),
        jnp.asarray(pooled), 0.05, seg_base=jnp.asarray(seg_base),
        interpret=True)
    gt, ga = _port_segments(idx, table, accum, pooled)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **KERNEL_TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **KERNEL_TOL)


@pytest.mark.parametrize("tight", [True, False], ids=["tight", "cap_U"])
@pytest.mark.parametrize("name", CORPUS)
def test_segments_bit_equal_to_unsegmented(name, tight):
    idx, table, accum, pooled = _segment_inputs(name)
    cap = None if tight else idx.size
    gt, ga = _port_segments(idx, table, accum, pooled, seg_cap=cap)
    wt, wa = ops.fused_sparse_backward(_t(table), _t(accum), _t(idx),
                                       _t(pooled), 0.05)
    assert torch.equal(gt, wt) and torch.equal(ga, wa)


def test_segments_default_base_is_table_row_space():
    """seg_base None: one segment over the whole table is the one-plan
    update."""
    idx, table, accum, pooled = _segment_inputs("random")
    plan = sparse_plan.build_sparse_plan_host(idx)
    t, a = _t(table), _t(accum)
    ops.fused_sparse_backward_segments(
        t, a, _t(plan.unique_rows[None]), _t(plan.bag_offsets[None]),
        _t(plan.bag_ids), _t(pooled), 0.05)
    wt, wa = ops.fused_sparse_backward(_t(table), _t(accum), _t(idx),
                                       _t(pooled), 0.05)
    assert torch.equal(t, wt) and torch.equal(a, wa)


def test_segments_wrapper_rejects_what_it_cannot_update():
    idx, table, accum, pooled = _segment_inputs("random")
    plan = sparse_plan.build_sparse_plan_host(idx)
    rows, offs, base = (_t(x) for x in sparse_plan.split_plan_by_owner(
        plan, 12, 4))
    bags = _t(plan.bag_ids)
    upd = sparse_update.fused_bag_backward_adagrad_segments
    with pytest.raises(ValueError, match="seg_offsets"):
        upd(_t(table), _t(accum), rows, offs[:, :-1], bags, _t(pooled),
            base, 0.05)
    with pytest.raises(ValueError, match="seg_base"):
        upd(_t(table), _t(accum), rows, offs, bags, _t(pooled), base[:-1],
            0.05)
    with pytest.raises(ValueError, match="seg_rows"):
        upd(_t(table), _t(accum), rows[0], offs, bags, _t(pooled), base,
            0.05)
    with pytest.raises(ValueError, match="require grad"):
        upd(_t(table).requires_grad_(), _t(accum), rows, offs, bags,
            _t(pooled), base, 0.05)
    with pytest.raises(ValueError, match="pooled"):
        upd(_t(table), _t(accum), rows, offs, bags, _t(pooled)[:, :3], base,
            0.05)

# ---------------------------------------------------------------------------
# the legacy two-pass update: dedup, then row-wise AdaGrad
# ---------------------------------------------------------------------------


def _lookup_stream(case, seed=0, h=60, n=96, d=12):
    rng = np.random.RandomState(seed)
    idx = {"uniform": rng.randint(-1, h, size=n),
           "zipf": np.where(rng.rand(n) < 0.8, (rng.zipf(1.2, n) - 1) % h,
                            -1),
           "all_dup": np.full(n, 7),
           "all_pad": np.full(n, -1)}[case].astype(np.int32)
    grads = rng.randn(n, d).astype(np.float32)
    table = rng.randn(h, d).astype(np.float32)
    accum = np.abs(rng.randn(h)).astype(np.float32)
    return idx, grads, table, accum


LEGACY = ["uniform", "zipf", "all_dup", "all_pad"]


@pytest.mark.parametrize("case", LEGACY)
def test_dedup_grads_equal_reference(case):
    idx, grads, table, _ = _lookup_stream(case)
    wu, wg = jref.dedup_grads_ref(jnp.asarray(idx), jnp.asarray(grads),
                                  len(table))
    gu, gg = ref.dedup_grads_ref(_t(idx), _t(grads), len(table))
    assert gu.dtype == torch.int32
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
    np.testing.assert_array_equal(gg.numpy(), np.asarray(wg))


@pytest.mark.parametrize("case", LEGACY)
def test_rowwise_adagrad_update_matches_reference(case):
    idx, grads, table, accum = _lookup_stream(case, seed=1)
    wt, wa = jref.rowwise_adagrad_ref(jnp.asarray(table), jnp.asarray(accum),
                                      jnp.asarray(idx), jnp.asarray(grads),
                                      0.05, 1e-8)
    t, a = _t(table), _t(accum)
    gt, ga = ops.rowwise_adagrad_update(t, a, _t(idx), _t(grads), 0.05, 1e-8)
    assert gt is t and ga is a                         # in place
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **FUSED_TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **FUSED_TOL)
    untouched = ~np.isin(np.arange(len(table)), idx)
    np.testing.assert_array_equal(gt.numpy()[untouched], table[untouched])


@pytest.mark.parametrize("h,d,n", [(64, 8, 16), (97, 48, 23), (128, 64, 64)])
def test_rowwise_adagrad_update_matches_pallas_interpret(h, d, n):
    """The reference's kernel test shapes (tests/test_kernels.py)."""
    rng = np.random.RandomState(h)
    table = rng.randn(h, d).astype(np.float32)
    accum = np.abs(rng.randn(h)).astype(np.float32)
    idx = rng.randint(-1, h, size=(n,)).astype(np.int32)
    grads = rng.randn(n, d).astype(np.float32)
    wt, wa = jops.rowwise_adagrad_update(
        jnp.asarray(table), jnp.asarray(accum), jnp.asarray(idx),
        jnp.asarray(grads), 0.05, 1e-8, None, True)
    gt, ga = ops.rowwise_adagrad_update(_t(table), _t(accum), _t(idx),
                                        _t(grads), 0.05, 1e-8)
    np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **KERNEL_TOL)
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), **KERNEL_TOL)


def _bag_batch(case, seed=0, h=60, b=5, f=3, lk=6, d=12):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, h, size=(b, f, lk)).astype(np.int32)
    if case == "zipf":
        idx = np.where(idx >= 0, (rng.zipf(1.1, idx.shape) - 1) % h, -1)
    elif case == "all_dup":
        idx[:] = 7
    elif case == "all_pad":
        idx[:] = -1
    table = rng.randn(h, d).astype(np.float32)
    accum = np.abs(rng.randn(h)).astype(np.float32)
    pooled = rng.randn(b, f, d).astype(np.float32)
    return idx.astype(np.int32), table, accum, pooled


@pytest.mark.parametrize("case", LEGACY)
def test_two_pass_update_bit_equal_to_fused(case):
    """Per-lookup broadcast -> dedup -> row-wise AdaGrad gives the fused
    update's bits: each row's gradients are added in the same order."""
    idx, table, accum, pooled = _bag_batch(case, seed=3)
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    flat_idx, flat_g = ebc.per_lookup_grads(_t(idx), _t(pooled))
    t2, a2 = ops.rowwise_adagrad_update(_t(table), _t(accum), flat_idx,
                                        flat_g, 0.05)
    tf, af = ops.fused_sparse_backward(_t(table), _t(accum), _t(idx),
                                       _t(pooled), 0.05)
    assert torch.equal(t2, tf) and torch.equal(a2, af)


def test_per_lookup_grads_equal_reference():
    idx, _, _, pooled = _bag_batch("uniform", seed=4)
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    want = JEBC.build(jcfg, n_shards=1, strategy="replicated"
                      ).per_lookup_grads(jnp.asarray(idx),
                                         jnp.asarray(pooled))
    got = EmbeddingBagCollection.build(cfg, strategy="replicated"
                                       ).per_lookup_grads(_t(idx),
                                                          _t(pooled))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rowwise_wrapper_rejects_what_it_cannot_update():
    from repro_torch.kernels import rowwise_adagrad
    t, a = torch.zeros((8, 4)), torch.zeros(8)
    uniq = torch.tensor([1, -1, 3], dtype=torch.int32)
    with pytest.raises(ValueError, match="gsum"):
        rowwise_adagrad.rowwise_adagrad(t, a, uniq, torch.zeros((2, 4)), 0.1)
    with pytest.raises(ValueError, match="require grad"):
        rowwise_adagrad.rowwise_adagrad(t.requires_grad_(), a, uniq,
                                        torch.zeros((3, 4)), 0.1)
    with pytest.raises(ValueError, match="indices"):
        ref.dedup_grads_ref(uniq[:2], torch.zeros((3, 4)), 8)

# ---------------------------------------------------------------------------
# the table-wise train step
# ---------------------------------------------------------------------------

N_STEPS, BATCH, OWNERS = 4, 16, 4


def _setup(plan_hook=False):
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, n_shards=OWNERS,
                                       strategy="table_wise")
    jebc = JEBC.build(jcfg, n_shards=OWNERS, strategy="table_wise")
    assert ebc.plan.table_offsets == jebc.plan.table_offsets
    jparams = jinit(jdlrm.dlrm_param_specs(jcfg, jebc),
                    jax.random.PRNGKey(0))
    hook = sparse_plan_hook(ebc.plan.table_offsets)
    batches = []
    for t in range(N_STEPS):
        raw = make_dlrm_batch(cfg, BATCH, step=t)
        batches.append(hook(raw) if plan_hook else
                       {**raw, "idx": ebc.offset_indices(raw["idx"])})
    return cfg, jcfg, ebc, jebc, jparams, batches


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _run_port(cfg, ebc, jparams, batches, staged):
    opt = adagrad(0.01)
    params = params_from_jax(_np_tree(jparams), device="cpu")
    state = dlrm_init_state(ebc, opt, params)
    step = build_tablewise_train_step(cfg, ebc, opt)
    losses, metrics = [], []
    for t, batch in enumerate(batches):
        nxt = batches[t + 1] if staged and t + 1 < len(batches) else None
        params, state, m = step(params, state, batch, t, next_batch=nxt)
        losses.append(float(m["loss"]))
        metrics.append(m)
    return losses, params, state, metrics


@pytest.mark.parametrize("staged", [False, True])
def test_tablewise_step_matches_reference(staged):
    """`staged`: each call names the next batch (the reference's
    overlap=True), so the step stages its lookup."""
    cfg, jcfg, ebc, jebc, jparams, batches = _setup()
    jopt = jadagrad(0.01)
    jstate = jsteps.dlrm_init_state(jebc, jopt, jparams)
    jstep = jsteps.build_tablewise_train_step(jcfg, jebc, jopt,
                                              overlap=staged)
    # the reference's step donates the table: run it on a copy
    jp, want = jax.tree.map(jnp.array, jparams), []
    for t, batch in enumerate(batches):
        jb = {"dense": jnp.asarray(batch["dense"]), "idx": batch["idx"],
              "label": jnp.asarray(batch["label"])}
        nxt = batches[t + 1] if t + 1 < len(batches) else None
        jnxt = None if nxt is None else {"idx": nxt["idx"]}
        jp, jstate, jm = jstep(jp, jstate, jb, jnp.asarray(t, jnp.int32),
                               next_batch=jnxt)
        want.append(jm)
    losses, params, state, got = _run_port(cfg, ebc, jparams, batches,
                                           staged)
    np.testing.assert_allclose(losses, [float(m["loss"]) for m in want],
                               **STEP_TOL)
    np.testing.assert_allclose(params["emb"]["mega"].numpy(),
                               np.asarray(jp["emb"]["mega"]), **STEP_TOL)
    np.testing.assert_allclose(state["accum"].numpy(),
                               np.asarray(jstate["accum"]), **STEP_TOL)
    for a, b in zip(jax.tree.leaves({"bottom": jp["bottom"],
                                     "top": jp["top"]}),
                    jax.tree.leaves(jax.tree.map(
                        lambda x: x.numpy(), {"bottom": params["bottom"],
                                              "top": params["top"]}))):
        np.testing.assert_allclose(b, np.asarray(a), **STEP_TOL)
    owners = np.asarray(ebc.plan.table_offsets) // ebc.plan.shard_rows
    model_kw = dict(features_per_owner=np.bincount(owners,
                                                   minlength=OWNERS))
    lk = batches[0]["idx"].shape[2]
    models = [mod.tablewise_exchange_traffic(
        BATCH, cfg.n_sparse_features, lk, cfg.embed_dim, OWNERS, **model_kw)
        for mod in (analysis, janalysis)]
    assert models[0] == models[1]
    for m, jm in zip(got, want):
        assert m["lookups"] == float(jm["lookups"])
        for key, model_key in (("exchange_pooled_fwd_bytes", "fwd_bytes"),
                               ("exchange_pooled_bwd_bytes", "bwd_bytes"),
                               ("exchange_pair_leg_bytes",
                                "pair_leg_bytes")):
            assert m[key] == jm[key] == models[0][model_key] > 0


@pytest.mark.parametrize("plan_hook", [False, True], ids=["no_plan", "plan"])
@pytest.mark.parametrize("staged", [False, True])
def test_tablewise_step_bit_equal_to_dlrm_step(staged, plan_hook):
    """Same layout, same batches: the segmented update and the staged
    lookup change no bit against `build_dlrm_train_step`."""
    cfg, _, ebc, _, jparams, batches = _setup(plan_hook)
    losses, params, state, _ = _run_port(cfg, ebc, jparams, batches,
                                         staged)
    opt = adagrad(0.01)
    p = params_from_jax(_np_tree(jparams), device="cpu")
    s = dlrm_init_state(ebc, opt, p)
    step = build_dlrm_train_step(cfg, ebc, opt)
    want = []
    for t, batch in enumerate(batches):
        p, s, m = step(p, s, {k: _t(v) for k, v in batch.items()}, t)
        want.append(float(m["loss"]))
    assert losses == want
    assert torch.equal(params["emb"]["mega"], p["emb"]["mega"])
    assert torch.equal(state["accum"], s["accum"])
    for part in ("bottom", "top"):
        for a, b in zip(params[part], p[part]):
            assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


def test_tablewise_step_stages_only_for_the_named_batch():
    """A next_batch that is not the batch the following call gets is
    looked up afresh: the same bits as staging none."""
    cfg, _, ebc, _, jparams, batches = _setup()
    runs = []
    for decoy in (False, True):
        opt = adagrad(0.01)
        params = params_from_jax(_np_tree(jparams), device="cpu")
        state = dlrm_init_state(ebc, opt, params)
        step = build_tablewise_train_step(cfg, ebc, opt)
        for t, batch in enumerate(batches):
            nxt = batches[t + 1] if t + 1 < len(batches) else None
            if decoy and nxt is not None:
                nxt = dict(nxt)                # equal arrays, another object
            params, state, m = step(params, state, batch, t, next_batch=nxt)
        runs.append((params["emb"]["mega"], state["accum"], m["loss"]))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_tablewise_step_rejects_wrong_plans():
    cfg = get_smoke_config("dlrm-m1")
    replicated = EmbeddingBagCollection.build(cfg, strategy="replicated")
    with pytest.raises(ValueError, match="table_wise"):
        build_tablewise_train_step(cfg, replicated, adagrad(0.01))
    ebc = EmbeddingBagCollection.build(cfg, n_shards=OWNERS,
                                       strategy="table_wise")
    sliced = dataclasses.replace(ebc, plan=dataclasses.replace(
        ebc.plan, column_shards=(2,) + ebc.plan.column_shards[1:]))
    with pytest.raises(NotImplementedError, match="column_shards"):
        build_tablewise_train_step(cfg, sliced, adagrad(0.01))


def test_tablewise_exchange_traffic_equals_reference():
    b, f, lk, d, h = 8192, 16, 32, 64, 16
    for kw in ({}, {"features_per_owner": [f // 2] + [1] * (h - 1)}):
        assert analysis.tablewise_exchange_traffic(b, f, lk, d, h, **kw) == \
            janalysis.tablewise_exchange_traffic(b, f, lk, d, h, **kw)
    one = analysis.tablewise_exchange_traffic(b, f, lk, d, 1)
    assert one["total_bytes"] == 0.0 and one["pooling_reduction"] == 1.0


# ---------------------------------------------------------------------------
# host loss: the elastic table-wise re-pack (the reference's chaos scenario 4)
# ---------------------------------------------------------------------------


def _repack_batch(cfg, ebc, t):
    raw = make_dlrm_batch(cfg, BATCH, step=t)
    return {**raw, "idx": ebc.offset_indices(raw["idx"])}


def test_elastic_repack_equals_reference_repack():
    """A re-pack only moves rows: the port's new table and accumulator are
    the reference's repack of the same arrays, bit for bit, and so is the
    new plan."""
    from repro.train import fault_tolerance as jft
    from repro_torch.train import elastic_tablewise_repack
    cfg, jcfg = get_smoke_config("dlrm-m1"), jget_smoke("dlrm-m1")
    ebc4 = EmbeddingBagCollection.build(cfg, n_shards=4,
                                        strategy="table_wise")
    jebc4 = JEBC.build(jcfg, n_shards=4, strategy="table_wise")
    rng = np.random.RandomState(7)
    mega = rng.randn(ebc4.plan.total_rows, cfg.embed_dim).astype(np.float32)
    accum = rng.rand(ebc4.plan.total_rows).astype(np.float32)
    jnew, jmega, jaccum = jft.elastic_tablewise_repack(jcfg, jebc4, mega,
                                                       accum, 3)
    new, got_mega, got_accum = elastic_tablewise_repack(
        cfg, ebc4, _t(mega), _t(accum), 3, chunk_rows=37)
    _same_plan(new.plan, jnew.plan)
    np.testing.assert_array_equal(got_mega.numpy(), np.asarray(jmega))
    np.testing.assert_array_equal(got_accum.numpy(), np.asarray(jaccum))


def test_chaos_host_loss_elastic_repack_bitexact(tmp_path):
    """Losing one of 4 table-wise owners at step 3: checkpoint the bundle,
    restore it, re-pack the rows for 3 survivors and continue. Row
    renumbering changes neither per-bag pooling nor per-row AdaGrad, so the
    losses are bit-equal to the uninterrupted 4-owner run."""
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.train import (CheckpointManager, FaultInjector,
                                   FaultSpec, elastic_tablewise_repack)
    cfg = get_smoke_config("dlrm-m1")
    ebc4 = EmbeddingBagCollection.build(cfg, n_shards=4,
                                        strategy="table_wise")
    opt = adagrad(0.01)

    def fresh():
        p = init_dlrm_params(cfg, ebc4, 3, torch.device("cpu"))
        return p, dlrm_init_state(ebc4, opt, p)

    p, s = fresh()
    step = build_tablewise_train_step(cfg, ebc4, opt)
    want = []
    for t in range(6):
        p, s, m = step(p, s, _repack_batch(cfg, ebc4, t), t)
        want.append(float(m["loss"]))

    inj = FaultInjector([FaultSpec("loop.step", 3, "host_loss", arg=1)])
    mgr = CheckpointManager(str(tmp_path), injector=inj)
    e, (p, s) = ebc4, fresh()
    step = build_tablewise_train_step(cfg, ebc4, opt)
    got, repacked = [], 0
    for t in range(6):
        spec = inj.fire("loop.step", step=t)
        if spec is not None and spec.kind == "host_loss":
            mgr.save(t, {"params": p, "state": s})
            tree = mgr.restore({"params": p, "state": s})
            e, mega, accum = elastic_tablewise_repack(
                cfg, e, tree["params"]["emb"]["mega"],
                tree["state"]["accum"], 3)
            p = {"bottom": tree["params"]["bottom"],
                 "top": tree["params"]["top"], "emb": {"mega": mega}}
            s = {"dense": tree["state"]["dense"], "accum": accum}
            step = build_tablewise_train_step(cfg, e, opt)
            repacked += 1
        p, s, m = step(p, s, _repack_batch(cfg, e, t), t)
        got.append(float(m["loss"]))
    assert repacked == 1
    assert e.plan.strategy == "table_wise" and e.plan.capacity_shards == 3
    assert got == want
