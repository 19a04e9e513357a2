"""The port's CUDA kernels held against their plain PyTorch versions on an
NVIDIA GPU, at small shapes. Every test skips without a card; on the card
run them with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

(`--noconftest` because the suite's conftest imports jax, which the GPU
machine does not have; this file imports only torch, numpy and the port).
Tolerances: embedding_bag and dedup_embedding_bag walk each bag in the
plain version's order and the cached tier's row movers (cache_exchange,
cache_fetch, cache_fetch_chunked, cache_commit) only copy, so all of them
must be bit-equal; dot_interaction's fp32 FMA chain differs from cuBLAS's
order, so it (and its gradient) gets rtol/atol 1e-5; fused_bag_backward_adagrad sums
bags in the plain order but reduces mean(g^2) by warp shuffles, so touched
rows get rtol/atol 1e-6 and untouched rows must not move. The same holds
for its segmented form and for rowwise_adagrad against their plain
versions; between the port's kernels the row-wise AdaGrad arithmetic is
one sequence of operations, so the segmented kernel equals the one-plan
kernel, and the two-pass update (dedup, then rowwise_adagrad) the fused
one, bit for bit. flash_attention's fp32 kernel computes in fp32 with
__expf and an online softmax and gets the reference's own fp32 kernel
tolerance (2e-4) against ref.flash_attention_ref; its bf16 kernel (wgmma,
bf16 P) gets one bf16 ulp (2^-7 relative) plus 1e-3 against its tiled
plain version ref.flash_attention_tiled_ref, and 2^-9 max|V| more against
the fp32 oracle.
"""
import numpy as np
import pytest
import torch

from repro_torch import resolve_device
from repro_torch.kernels import (KERNELS, cache_ops, dot_interaction,
                                 embedding_bag, ops, ref, rowwise_adagrad,
                                 sparse_plan, sparse_update)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("h,d,b,lk", [(64, 16, 4, 3), (97, 48, 16, 7),
                                      (300, 64, 12, 32), (50, 128, 5, 40),
                                      (70, 200, 3, 9)])
def test_embedding_bag_kernel_bit_equal_to_plain(dev, h, d, b, lk, mode):
    rng = np.random.RandomState(h)
    table = torch.from_numpy(rng.randn(h, d).astype(np.float32)).to(dev)
    idx = rng.randint(-1, h, size=(b, lk)).astype(np.int32)
    idx[0] = -1
    idx = torch.from_numpy(idx).to(dev)
    before = embedding_bag.KERNEL.launches
    got = embedding_bag.embedding_bag(table, idx, mode)
    assert embedding_bag.KERNEL.launches == before + 1
    assert torch.equal(got, ref.embedding_bag_ref(table, idx, mode))


@pytest.mark.parametrize("b,f,d", [(8, 7, 16), (16, 31, 64), (3, 2, 5)])
def test_dot_interaction_kernel_matches_plain(dev, b, f, d):
    z = torch.from_numpy(np.random.RandomState(f).randn(b, f, d)
                         .astype(np.float32)).to(dev)
    got = dot_interaction.dot_interaction(z)
    torch.testing.assert_close(got, ref.dot_interaction_ref(z),
                               rtol=1e-5, atol=1e-5)


# embedding_bag takes a bag's slots in stages of 32 (16 at VEC 4), all of
# a stage's row loads before its adds: L = 32 fills a stage, 33 and 64
# cross stage edges; D = 5 and 40 take the scalar lanes (40 in two column
# chunks), 64 float2 and 128 float4
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("pads", ["none", "interleaved", "random"])
@pytest.mark.parametrize("lk", [32, 33, 64])
@pytest.mark.parametrize("d", [5, 40, 64, 128])
def test_embedding_bag_stages_bit_equal_to_plain(dev, d, lk, pads, mode):
    rng = np.random.RandomState(d * 1000 + lk)
    h, b = 1000, 37
    table = torch.from_numpy(rng.randn(h, d).astype(np.float32)).to(dev)
    idx = rng.randint(0, h, size=(b, lk)).astype(np.int32)
    if pads == "interleaved":
        idx[:, 1::2] = -1
    elif pads == "random":
        idx[rng.rand(b, lk) < 0.5] = -1
    idx[0] = -1                                     # an all-pad bag
    idx[1, 3:] = idx[1, 2]                          # a row repeated
    idx = torch.from_numpy(idx).to(dev)
    before = embedding_bag.KERNEL.launches
    got = embedding_bag.embedding_bag(table, idx, mode)
    assert embedding_bag.KERNEL.launches == before + 1
    assert torch.equal(got, ref.embedding_bag_ref(table, idx, mode))
    assert not got[0].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_at_the_serving_shape(dev, mode):
    """480 bags (16 examples x 30 tables) of L = 32, about half valid, over
    a 100,000-row table."""
    rng = np.random.RandomState(480)
    table = torch.from_numpy(rng.randn(100_000, 64).astype(np.float32)
                             ).to(dev)
    idx = rng.randint(0, 100_000, size=(480, 32)).astype(np.int32)
    idx[np.arange(32)[None, :] >= rng.randint(0, 33, size=(480, 1))] = -1
    idx = torch.from_numpy(idx).to(dev)
    assert torch.equal(embedding_bag.embedding_bag(table, idx, mode),
                       ref.embedding_bag_ref(table, idx, mode))


@pytest.mark.parametrize("d", [5, 64, 128])
def test_embedding_bag_async_and_register_stages_agree(dev, d):
    """A launch of at most 32 bags an SM takes the asynchronous stage
    (cp.async into shared memory), a larger one the register stage: the
    first 480 bags of a 6,000-bag call are bit-equal to the same bags sent
    alone, and both to the plain version."""
    rng = np.random.RandomState(d)
    table = torch.from_numpy(rng.randn(5000, d).astype(np.float32)).to(dev)
    idx = rng.randint(0, 5000, size=(6000, 33)).astype(np.int32)
    idx[rng.rand(6000, 33) < 0.4] = -1
    idx[3] = -1
    idx = torch.from_numpy(idx).to(dev)
    for mode in ("sum", "mean"):
        many = embedding_bag.embedding_bag(table, idx, mode)
        few = embedding_bag.embedding_bag(table, idx[:480], mode)
        assert torch.equal(many[:480], few)
        assert torch.equal(many, ref.embedding_bag_ref(table, idx, mode))


@pytest.mark.parametrize("d", [16, 64])
def test_embedding_bag_reaches_rows_past_2_pow_24(dev, d):
    """A (2^24 + 1024, D) table (1.1 and 4.3 GB): rows past 2^24 and the
    last row, whose byte offsets pass 2^32 at D = 64."""
    h = (1 << 24) + 1024
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn((h, d), generator=g, device=dev)
    rng = np.random.RandomState(6)
    idx = rng.randint(-1, h, size=(40, 33)).astype(np.int32)
    idx[0, :5] = h - 1
    idx[1, ::2] = 1 << 24
    idx[2, 1] = (1 << 24) - 1
    idx = torch.from_numpy(idx).to(dev)
    for mode in ("sum", "mean"):
        assert torch.equal(embedding_bag.embedding_bag(table, idx, mode),
                           ref.embedding_bag_ref(table, idx, mode))


# dot_interaction tiles each example's pair triangle (4 x 4 pairs a thread
# when the batch fills the card, else 2 x 2) and splits or packs examples
# over blocks by B: F = 2, 14, 31 and 128 are dlrm-m2's, m1's and m3's
# F + 1 and the smallest; rtol/atol 1e-5 against the plain version
@pytest.mark.parametrize("b", [1, 16, 512])
@pytest.mark.parametrize("d", [5, 40, 64])
@pytest.mark.parametrize("f", [2, 14, 31, 128])
def test_dot_interaction_at_every_tiling_matches_plain(dev, f, d, b):
    z = torch.from_numpy(np.random.RandomState(f * d + b).randn(b, f, d)
                         .astype(np.float32)).to(dev)
    before = dot_interaction.KERNEL.launches
    got = dot_interaction.dot_interaction(z)
    assert dot_interaction.KERNEL.launches == before + 1
    assert got.shape == (b, f * (f - 1) // 2)
    torch.testing.assert_close(got, ref.dot_interaction_ref(z),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("f,d", [(31, 64), (128, 64), (14, 40), (31, 5)])
def test_dot_interaction_does_not_depend_on_the_tiling(dev, f, d):
    """Each pair is one fmaf chain over d from 0.f whatever tile, block or
    staging path computes it: a B = 512 call's rows are bit-equal to the
    same examples sent 16 and 1 at a time, and to a copy of z off a
    16-byte boundary (the 4-byte staging path)."""
    z = torch.from_numpy(np.random.RandomState(f).randn(512, f, d)
                         .astype(np.float32)).to(dev)
    full = dot_interaction.dot_interaction(z)
    for s in range(0, 512, 16):
        assert torch.equal(full[s:s + 16],
                           dot_interaction.dot_interaction(z[s:s + 16]))
    for s in range(0, 512, 37):
        assert torch.equal(full[s:s + 1],
                           dot_interaction.dot_interaction(z[s:s + 1]))
    buf = torch.empty(z.numel() + 1, device=dev)
    shifted = buf[1:].view(z.shape)
    shifted.copy_(z)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(full, dot_interaction.dot_interaction(shifted))


def test_bag_and_dot_guards_raise_as_before(dev):
    """Both wrappers check directly; each failure still raises the
    exception and message it raised before, and launches nothing."""
    t = torch.zeros((4, 8), device=dev)
    i = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    bad = [
        (ValueError, "one CUDA device", (t, i.cpu())),
        (ValueError, "one CUDA device", (t.cpu(), i)),
        (TypeError, "fp32 table and int32 indices", (t.double(), i)),
        (TypeError, "fp32 table and int32 indices", (t, i.long())),
        (ValueError, "contiguous", (torch.zeros((4, 16), device=dev)[:, ::2],
                                    i)),
        (ValueError, "contiguous", (t, torch.zeros(
            (2, 6), dtype=torch.int32, device=dev)[:, ::2])),
    ]
    before = embedding_bag.KERNEL.launches
    for exc, msg, args in bad:
        with pytest.raises(exc, match=msg):
            embedding_bag.embedding_bag(*args)
    assert embedding_bag.KERNEL.launches == before
    z = torch.zeros((2, 5, 8), device=dev)
    bad = [
        (TypeError, "takes fp32", z.double()),
        (ValueError, "contiguous", z.transpose(1, 2)),
        (ValueError, "exceeds", torch.zeros((2, 400, 64), device=dev)),
    ]
    before = dot_interaction.KERNEL.launches
    for exc, msg, arg in bad:
        with pytest.raises(exc, match=msg):
            dot_interaction.dot_interaction(arg)
    assert dot_interaction.KERNEL.launches == before


@pytest.mark.parametrize("name,entries", [("embedding_bag", 6),
                                          ("dot_interaction", 4)])
def test_bag_and_dot_build_without_spills(dev, tmp_path, name, entries):
    """embedding_bag's three lane widths times two stages and
    dot_interaction's two tile sizes times two staging paths compile for
    sm_90a with no spills."""
    import subprocess
    kernel = {"embedding_bag": embedding_bag.KERNEL,
              "dot_interaction": dot_interaction.KERNEL}[name]
    run = subprocess.run(kernel._command(tmp_path / f"{name}.so"),
                         capture_output=True, text=True)
    log = run.stdout + run.stderr
    assert run.returncode == 0, log
    assert sum("Compiling entry function" in line
               for line in log.splitlines()) == entries, log
    spills = [line for line in log.splitlines() if "spill" in line]
    assert len(spills) == entries, log
    assert all("0 bytes spill stores, 0 bytes spill loads" in line
               for line in spills), log


@pytest.mark.parametrize("d", [16, 64, 128, 40])
def test_cache_exchange_kernel_bit_equal_to_plain(dev, d):
    rng = np.random.RandomState(d)
    r, c, n = 500, 60, 40
    tiers = [rng.randn(r, d), rng.randn(c, d), rng.rand(r), rng.rand(c),
             rng.rand(c)]
    slots = rng.permutation(c)[:n]
    rows = rng.permutation(r)[:2 * n]
    fetch, evict = rows[:n].copy(), rows[n:].copy()
    evict[::3] = -1
    fetch[::5] = -1
    slots[7] = -1
    work = [slots, evict, fetch, rng.rand(n) * 4]
    dtypes = [torch.int32] * 3 + [torch.float32]

    def fresh():
        t = [torch.tensor(x, dtype=torch.float32, device=dev) for x in tiers]
        w = [torch.tensor(x, dtype=dt, device=dev)
             for x, dt in zip(work, dtypes)]
        return t, w

    got, w = fresh()
    cache_ops.check_worklist(*w[:3])
    cache_ops.cache_exchange(*got, *w)
    want, w = fresh()
    ref.cache_exchange_ref(*want, *w)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    t = torch.zeros((4, 8), device=dev)
    with pytest.raises(TypeError):
        embedding_bag.embedding_bag(t, torch.zeros((2, 3), device=dev))
    with pytest.raises(ValueError):
        embedding_bag.embedding_bag(
            t, torch.zeros((2, 3), dtype=torch.int32))      # mixed devices
    with pytest.raises(ValueError):
        dot_interaction.dot_interaction(torch.zeros((2, 400, 64),
                                                    device=dev))
    with pytest.raises(TypeError):
        dot_interaction.dot_interaction(torch.zeros((2, 3, 4), device=dev,
                                                    dtype=torch.float64))


def _plan_inputs(dev, h, d, b, f, lk, seed):
    rng = np.random.RandomState(seed)
    idx = rng.randint(-1, h, size=(b, f, lk)).astype(np.int32)
    idx[0, 0] = -1                                  # an all-pad bag
    idx[1, 0, :] = h - 1                            # a row repeated in a bag
    idx[-1, -1, ::2] = 0                            # a row across bags
    table = rng.randn(h, d).astype(np.float32)
    accum = np.abs(rng.randn(h)).astype(np.float32)
    pooled = rng.randn(b * f, d).astype(np.float32)
    return [torch.from_numpy(x).to(dev) for x in (idx, table, accum, pooled)]


@pytest.mark.parametrize("h,d,b,f,lk", [(60, 12, 5, 3, 6), (300, 64, 16, 4, 32),
                                        (97, 128, 6, 3, 7),
                                        (50, 200, 3, 2, 40)])
def test_fused_bag_backward_adagrad_kernel_matches_plain(dev, h, d, b, f, lk):
    """Bag sums are added in the plain version's order, so the only
    difference is mean(g^2)'s reduction order (and rsqrtf): rtol/atol 1e-6
    on touched rows; untouched rows and accumulators must not move."""
    idx, table, accum, pooled = _plan_inputs(dev, h, d, b, f, lk, h + d)
    plan = sparse_plan.build_sparse_plan(idx)
    t_k, a_k = table.clone(), accum.clone()
    before = sparse_update.KERNEL.launches
    sparse_update.fused_bag_backward_adagrad(t_k, a_k, *plan, pooled, 0.05)
    assert sparse_update.KERNEL.launches == before + 1
    t_p, a_p = table.clone(), accum.clone()
    ref.fused_bag_backward_adagrad_ref(t_p, a_p, *plan, pooled, 0.05)
    torch.cuda.synchronize()
    touched = torch.zeros(h, dtype=torch.bool, device=dev)
    touched[idx[idx >= 0].long()] = True
    assert torch.equal(t_k[~touched], table[~touched])
    assert torch.equal(a_k[~touched], accum[~touched])
    torch.testing.assert_close(t_k, t_p, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a_k, a_p, rtol=1e-6, atol=1e-6)
    assert not torch.equal(t_k[touched], table[touched])


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("h,d,b,f,lk", [(60, 12, 5, 3, 6), (300, 64, 16, 4, 32),
                                        (97, 128, 6, 3, 7),
                                        (50, 200, 3, 2, 40)])
def test_dedup_embedding_bag_kernel_bit_equal_to_plain(dev, h, d, b, f, lk,
                                                       mode):
    idx, table, _, _ = _plan_inputs(dev, h, d, b, f, lk, h + lk)
    flat = idx.reshape(b * f, lk)
    plan = sparse_plan.build_sparse_plan(flat.reshape(-1), lookups_per_bag=lk)
    before = embedding_bag.DEDUP_KERNEL.launches
    got = embedding_bag.dedup_embedding_bag(table, flat, plan.unique_rows,
                                            mode)
    assert embedding_bag.DEDUP_KERNEL.launches == before + 1
    assert torch.equal(got, ref.dedup_embedding_bag_ref(
        table, flat, plan.unique_rows, mode))
    assert torch.equal(got, embedding_bag.embedding_bag(table, flat, mode))


def _dedup_bit_equal(table, flat, unique_rows, mode="sum"):
    """One dedup launch, bit-equal to its plain version and to the
    plan-less kernel; returns the result."""
    before = embedding_bag.DEDUP_KERNEL.launches
    got = embedding_bag.dedup_embedding_bag(table, flat, unique_rows, mode)
    assert embedding_bag.DEDUP_KERNEL.launches == before + 1
    assert torch.equal(got, ref.dedup_embedding_bag_ref(table, flat,
                                                        unique_rows, mode))
    assert torch.equal(got, embedding_bag.embedding_bag(table, flat, mode))
    return got


def _live_batch(dev, h, d, n_live, b=24, lk=9, seed=0):
    """A batch whose plan has exactly n_live unique rows (pads between)."""
    rng = np.random.RandomState(seed)
    rows = rng.choice(h, size=n_live, replace=False)
    idx = rows[rng.randint(0, n_live, size=(b, lk))].astype(np.int32)
    idx[rng.rand(b, lk) < 0.2] = -1
    idx = idx.reshape(-1)
    idx[:n_live] = rows                       # every row appears
    table = torch.from_numpy(rng.randn(h, d).astype(np.float32)).to(dev)
    return table, torch.from_numpy(idx.reshape(b, lk)).to(dev)


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("plan", ["no_tail", "trimmed", "full"])
def test_dedup_embedding_bag_plans_with_and_without_a_tail(dev, plan, mode):
    """U = the live count (no -1 tail), a capacity below N that still
    covers, and the planner's full N-entry plan."""
    table, flat = _live_batch(dev, 500, 64, 77)
    n = flat.numel()
    cap = {"no_tail": 77, "trimmed": 77 + 40, "full": None}[plan]
    p = sparse_plan.build_sparse_plan(flat.reshape(-1),
                                      lookups_per_bag=flat.shape[1],
                                      capacity=cap)
    assert p.unique_rows.numel() == (cap or n)
    assert int((p.unique_rows >= 0).sum()) == 77
    _dedup_bit_equal(table, flat, p.unique_rows, mode)


@pytest.mark.parametrize("d", [64, 12, 5, 200])
@pytest.mark.parametrize("n_live", [1, 3, 8, 43, 64, 81, 700])
def test_dedup_embedding_bag_live_prefix_ends_anywhere(dev, n_live, d):
    """The gather's warps take groups of plan entries (8 at D=64) and its
    blocks 8 warps; the live prefix ends inside a group, on a group's or a
    block's edge, and inside a later block."""
    table, flat = _live_batch(dev, 4000, d, n_live, b=96, lk=11,
                              seed=n_live)
    p = sparse_plan.build_sparse_plan(flat.reshape(-1),
                                      lookups_per_bag=flat.shape[1])
    assert int((p.unique_rows >= 0).sum()) == n_live
    _dedup_bit_equal(table, flat, p.unique_rows)
    _dedup_bit_equal(table, flat, p.unique_rows[:n_live].contiguous())


def test_dedup_embedding_bag_of_pads_only_is_zero(dev):
    table = torch.randn((50, 64), device=dev)
    flat = torch.full((16, 7), -1, dtype=torch.int32, device=dev)
    p = sparse_plan.build_sparse_plan(flat.reshape(-1), lookups_per_bag=7)
    assert not (p.unique_rows >= 0).any()
    for mode in ("sum", "mean"):
        got = _dedup_bit_equal(table, flat, p.unique_rows, mode)
        assert not got.any()


def test_dedup_embedding_bag_reaches_rows_past_2_pow_24(dev):
    """A (2^24 + 1024, 16) table (1.1 GB): rows past 2^24 and the table's
    last row, the map 4 bytes a row."""
    h, d = (1 << 24) + 1024, 16
    g = torch.Generator(device=dev).manual_seed(2)
    table = torch.randn((h, d), generator=g, device=dev)
    rng = np.random.RandomState(5)
    idx = rng.randint(-1, h, size=(32, 10)).astype(np.int32)
    idx[0, :4] = h - 1
    idx[1, ::2] = 1 << 24
    idx[2, 1] = (1 << 24) - 1
    flat = torch.from_numpy(idx).to(dev)
    p = sparse_plan.build_sparse_plan(flat.reshape(-1), lookups_per_bag=10)
    assert int(p.unique_rows.max()) == h - 1
    _dedup_bit_equal(table, flat, p.unique_rows)


def test_dedup_embedding_bag_twice_on_other_tables_and_plans(dev):
    """The position map is taken uncleared on every call: a call after one
    on another table and plan (other H, other rows) reads only what its own
    gather wrote, in both orders."""
    big, flat_big = _live_batch(dev, 9000, 64, 600, b=64, lk=13, seed=1)
    small, flat_small = _live_batch(dev, 700, 64, 90, b=40, lk=5, seed=2)
    plans = [sparse_plan.build_sparse_plan(f.reshape(-1),
                                           lookups_per_bag=f.shape[1])
             for f in (flat_big, flat_small)]
    for _ in range(2):
        _dedup_bit_equal(big, flat_big, plans[0].unique_rows)
        _dedup_bit_equal(small, flat_small, plans[1].unique_rows)
    # the same rows at other plan positions: the map must follow the plan
    _dedup_bit_equal(big, flat_big, plans[0].unique_rows)
    _dedup_bit_equal(big, flat_big[:7], sparse_plan.build_sparse_plan(
        flat_big[:7].reshape(-1), lookups_per_bag=13).unique_rows)


def test_dedup_embedding_bag_on_a_side_stream(dev):
    table, flat = _live_batch(dev, 800, 64, 150, b=48, lk=8, seed=3)
    p = sparse_plan.build_sparse_plan(flat.reshape(-1), lookups_per_bag=8)
    want = ref.dedup_embedding_bag_ref(table, flat, p.unique_rows)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = embedding_bag.dedup_embedding_bag(table, flat, p.unique_rows)
    side.synchronize()
    assert torch.equal(got, want)


def test_stream_handle_is_the_current_stream(dev):
    from repro_torch.kernels._build import stream_handle
    assert stream_handle(dev) == torch.cuda.current_stream(dev).cuda_stream
    assert stream_handle(torch.cuda.current_device()) == \
        torch.cuda.current_stream(dev).cuda_stream
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert stream_handle(dev) == side.cuda_stream
        assert stream_handle(dev) == \
            torch.cuda.current_stream(dev).cuda_stream
    assert stream_handle(dev) != side.cuda_stream


def test_sparse_plan_on_the_card_equals_the_host_plan(dev):
    rng = np.random.RandomState(3)
    idx = rng.randint(-1, 9, size=(64, 5, 16)).astype(np.int32)
    got = sparse_plan.build_sparse_plan(torch.from_numpy(idx).to(dev))
    for a, b in zip(got, sparse_plan.build_sparse_plan_host(idx)):
        np.testing.assert_array_equal(a.cpu().numpy(), b)


def test_dot_interaction_gradient_on_the_card_matches_plain(dev):
    """The kernel's output has no autograd graph of its own; the op's
    backward must still carry the gradient into z."""
    rng = np.random.RandomState(4)
    z = rng.randn(8, 31, 64).astype(np.float32)
    g = rng.randn(8, 465).astype(np.float32)
    zk = torch.from_numpy(z).to(dev).requires_grad_()
    ops.dot_interaction(zk).backward(torch.from_numpy(g).to(dev))
    zp = torch.from_numpy(z).to(dev).requires_grad_()
    ref.dot_interaction_ref(zp).backward(torch.from_numpy(g).to(dev))
    assert zk.grad.abs().sum() > 0
    torch.testing.assert_close(zk.grad, zp.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("plan", [False, True])
def test_train_step_on_the_card_matches_the_cpu(dev, plan):
    """Two steps of the smoke dlrm-m1 on the card and on the CPU from the
    same parameters and batches: rtol/atol 1e-5 (kernels and cuBLAS sum
    in other orders than the CPU)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.data.pipeline import sparse_plan_hook
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.nn.params import tree_map
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_dlrm_train_step, dlrm_init_state
    resolve_device("cuda")
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    hook = sparse_plan_hook(ebc.plan.table_offsets)
    runs = {}
    for d in (torch.device("cpu"), dev):
        params = tree_map(lambda x: x.to(d), init_dlrm_params(
            cfg, ebc, 0, torch.device("cpu")))
        state = dlrm_init_state(ebc, adagrad(0.01), params)
        step = build_dlrm_train_step(cfg, ebc, adagrad(0.01))
        losses = []
        for t in range(2):
            raw = hook(make_dlrm_batch(cfg, 16, step=t))
            if not plan:
                raw = {k: v for k, v in raw.items()
                       if not k.startswith("plan_")}
            batch = {k: torch.as_tensor(v).to(d) for k, v in raw.items()}
            params, state, m = step(params, state, batch, t)
            losses.append(float(m["loss"]))
        runs[d.type] = (losses, params["emb"]["mega"].cpu(),
                        state["accum"].cpu(), params["top"][0]["w"].cpu())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(runs["cuda"][1:], runs["cpu"][1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_new_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    t = torch.zeros((4, 8), device=dev)
    rows = torch.zeros((1,), dtype=torch.int32, device=dev)
    idx = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        embedding_bag.dedup_embedding_bag(t, idx, rows.long())
    with pytest.raises(ValueError):
        embedding_bag.dedup_embedding_bag(t, idx, rows[:0])
    offs = torch.zeros((2,), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        sparse_update.fused_bag_backward_adagrad(
            t, torch.zeros(4, device=dev), rows, offs, rows,
            torch.zeros((1, 8), device=dev, dtype=torch.float64), 0.1)
    # 4 warps x D fp32 sums: D=16384 needs 256 KB of shared memory, past
    # the card's 227 KB; the launch refuses it
    with pytest.raises(RuntimeError, match="invalid argument"):
        sparse_update.fused_bag_backward_adagrad(
            torch.zeros((4, 16384), device=dev), torch.zeros(4, device=dev),
            rows, offs, rows, torch.zeros((1, 16384), device=dev), 0.1)


def test_fused_backward_opts_in_to_shared_memory_past_48kb(dev):
    """D=4096 keeps 64 KB of sums per block: the launch opts in and the
    update matches the plain version (tol 1e-6 abs + rel)."""
    g = torch.Generator().manual_seed(7)
    d = 4096
    table = torch.randn((16, d), generator=g)
    accum = torch.rand((16,), generator=g)
    pooled = torch.randn((6, d), generator=g) * 0.01
    rows = torch.tensor([2, 9, 15, -1], dtype=torch.int32)
    offs = torch.tensor([0, 3, 4, 6, 6], dtype=torch.int32)
    bags = torch.tensor([0, 2, 5, 1, 3, 4], dtype=torch.int32)
    want_t, want_a = table.clone(), accum.clone()
    ref.fused_bag_backward_adagrad_ref(want_t, want_a, rows, offs, bags,
                                       pooled, 0.05, 1e-8)
    got_t, got_a = table.to(dev), accum.to(dev)
    sparse_update.fused_bag_backward_adagrad(
        got_t, got_a, rows.to(dev), offs.to(dev), bags.to(dev),
        pooled.to(dev), 0.05, 1e-8)
    torch.testing.assert_close(got_t.cpu(), want_t, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got_a.cpu(), want_a, rtol=1e-6, atol=1e-6)


# The fused update walks each CSR run in stages of K bag rows (K = 32 at
# D = 32 and 64, 16 at 96 and 128; D = 12 and 200 take the shared-memory
# body) and reads bag ids 32 at a time: runs of 1, K-1, K, K+1, 31, 32, 33
# and 2K+1 bags for K = 8, 16 and 32, and one of 4,000 (a Zipf head row's
# length at the training batch)
RUN_LENGTHS = sorted({n for k in (8, 16, 32)
                      for n in (1, k - 1, k, k + 1, 31, 32, 33, 2 * k + 1)})


def _runs_plan(h, d, lengths, pads, seed):
    """A plan whose live runs have the given lengths (random distinct rows,
    random bags), `pads` -1 entries after them; the table, accumulators and
    pooled gradients; numpy."""
    rng = np.random.RandomState(seed)
    n_bags = 97
    rows = np.sort(rng.choice(h, size=len(lengths), replace=False))
    offs = np.concatenate([[0], np.cumsum(lengths)])
    unique_rows = np.concatenate([rows, np.full(pads, -1)]).astype(np.int32)
    bag_offsets = np.concatenate(
        [offs, np.full(pads, offs[-1])]).astype(np.int32)
    bag_ids = rng.randint(0, n_bags, size=int(offs[-1])).astype(np.int32)
    table = rng.randn(h, d).astype(np.float32)
    accum = rng.rand(h).astype(np.float32)
    pooled = (rng.randn(n_bags, d) * 0.1).astype(np.float32)
    return unique_rows, bag_offsets, bag_ids, table, accum, pooled


def _fused_held(dev, unique_rows, bag_offsets, bag_ids, table, accum,
                pooled):
    """Runs the fused update on the card and holds it bit-equal to the
    two-pass update (the CSR pairs as per-lookup gradients, in CSR order,
    then the unchanged rowwise_adagrad kernel) and within 1e-6 of the plain
    version; untouched rows must not move. Returns (table, accum)."""
    plan = [torch.tensor(x, device=dev)
            for x in (unique_rows, bag_offsets, bag_ids)]
    t0, a0, pg = (torch.tensor(x, device=dev) for x in (table, accum, pooled))
    t_k, a_k = t0.clone(), a0.clone()
    before = sparse_update.KERNEL.launches
    sparse_update.fused_bag_backward_adagrad(t_k, a_k, *plan, pg, 0.05)
    assert sparse_update.KERNEL.launches == before + 1
    live = unique_rows >= 0
    lengths = np.diff(bag_offsets)[live]
    flat_idx = torch.from_numpy(
        np.repeat(unique_rows[live], lengths).astype(np.int32)).to(dev)
    flat_g = pg[plan[2][:int(lengths.sum())].long()]
    t_2, a_2 = ops.rowwise_adagrad_update(t0.clone(), a0.clone(), flat_idx,
                                          flat_g, 0.05)
    t_p, a_p = t0.clone(), a0.clone()
    ref.fused_bag_backward_adagrad_ref(t_p, a_p, *plan, pg, 0.05)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_2) and torch.equal(a_k, a_2)
    torch.testing.assert_close(t_k, t_p, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a_k, a_p, rtol=1e-6, atol=1e-6)
    touched = torch.zeros(t0.shape[0], dtype=torch.bool, device=dev)
    touched[torch.from_numpy(unique_rows[live]).long().to(dev)] = True
    assert torch.equal(t_k[~touched], t0[~touched])
    assert torch.equal(a_k[~touched], a0[~touched])
    assert bool((t_k[touched] != t0[touched]).any(1).all())
    return t_k, a_k


@pytest.mark.parametrize("d", [32, 64, 96, 128, 12, 200])
def test_fused_update_bit_equal_at_every_pipeline_cut(dev, d):
    lengths = list(np.random.RandomState(d).permutation(
        RUN_LENGTHS + [4000]))
    _fused_held(dev, *_runs_plan(6000, d, lengths, 50, seed=d))


def test_fused_update_of_pads_only_and_of_an_empty_plan(dev):
    for pads in (0, 70):
        rows, offs, bags, table, accum, pooled = _runs_plan(300, 64, [],
                                                            pads, seed=1)
        t, a = (torch.tensor(x, device=dev) for x in (table, accum))
        plan = [torch.tensor(x, device=dev) for x in (rows, offs, bags)]
        before = sparse_update.KERNEL.launches
        sparse_update.fused_bag_backward_adagrad(
            t, a, *plan, torch.tensor(pooled, device=dev), 0.05)
        assert sparse_update.KERNEL.launches == before + 1
        assert torch.equal(t.cpu(), torch.from_numpy(table))
        assert torch.equal(a.cpu(), torch.from_numpy(accum))


@pytest.mark.parametrize("n_live", [1, 31, 32, 33, 45, 64, 300, 2000])
def test_fused_update_live_prefix_ends_anywhere(dev, n_live):
    """A warp reads 32 plan entries a round, dealt one by one across the
    grid's warps, and stops at its first round without a live entry: the
    live prefix ends before, at and past a multiple of 32, and past the
    first round of every warp."""
    lengths = list(np.random.RandomState(n_live).randint(1, 12, n_live))
    _fused_held(dev, *_runs_plan(9000, 64, lengths, 90, seed=n_live))


@pytest.mark.parametrize("d", [64, 12])
def test_fused_segments_with_empty_and_group_edge_segments(dev, d):
    """Five owners of 100 rows each, C = 64 (or 96) entries a segment:
    owner 0 has no rows, owner 1's live prefix ends on a 32-entry group's
    edge, owner 3 fills its segment and holds a 1,333-bag run, owner 4's
    prefix ends inside a group. Bit-equal to the one-plan kernel (whose
    bits the two-pass update holds) at the tight and a wider capacity."""
    owners, shard = 5, 100
    rng = np.random.RandomState(d)
    per = [0, 32, 45, 64, 7]
    rows = np.concatenate([np.sort(rng.choice(shard, n, replace=False))
                           + s * shard for s, n in enumerate(per)])
    lengths = rng.randint(1, 40, size=rows.size)
    lengths[per[1] + per[2] + 5] = 1333
    _, offs, bags, table, accum, pooled = _runs_plan(owners * shard, d,
                                                     list(lengths), 17,
                                                     seed=d)
    plan = sparse_plan.SparsePlan(
        np.concatenate([rows, np.full(17, -1)]).astype(np.int32), offs, bags)
    t_1, a_1 = _fused_held(dev, *plan, table, accum, pooled)
    for cap in (None, 96):
        seg_rows, seg_offs, seg_base = (
            torch.tensor(x, device=dev) for x in
            sparse_plan.split_plan_by_owner(plan, shard, owners,
                                            seg_cap=cap))
        assert not (seg_rows[0] >= 0).any()
        assert (seg_rows >= 0).sum(1).tolist() == per
        t, a = (torch.tensor(x, device=dev) for x in (table, accum))
        before = sparse_update.SEGMENTS_KERNEL.launches
        sparse_update.fused_bag_backward_adagrad_segments(
            t, a, seg_rows, seg_offs, torch.tensor(bags, device=dev),
            torch.tensor(pooled, device=dev), seg_base, 0.05)
        assert sparse_update.SEGMENTS_KERNEL.launches == before + 1
        assert torch.equal(t, t_1) and torch.equal(a, a_1)


def test_fused_update_on_a_side_stream(dev):
    rows, offs, bags, table, accum, pooled = _runs_plan(
        3000, 64, list(np.random.RandomState(4).randint(1, 300, 150)), 40,
        seed=4)
    plan = [torch.tensor(x, device=dev) for x in (rows, offs, bags)]
    pg = torch.tensor(pooled, device=dev)
    want = [torch.tensor(x, device=dev) for x in (table, accum)]
    sparse_update.fused_bag_backward_adagrad(*want, *plan, pg, 0.05)
    got = [torch.tensor(x, device=dev) for x in (table, accum)]
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        sparse_update.fused_bag_backward_adagrad(*got, *plan, pg, 0.05)
    side.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("d", [64, 128])
def test_fused_update_of_tensors_off_an_8_byte_boundary(dev, d):
    """D = 64 and 128 load float2 pairs; a pooled tensor that starts one
    float into its storage takes the shared-memory body, and agrees."""
    rows, offs, bags, table, accum, pooled = _runs_plan(
        500, d, [1, 40, 17, 300, 3], 9, seed=d + 1)
    plan = [torch.tensor(x, device=dev) for x in (rows, offs, bags)]
    buf = torch.zeros(pooled.size + 1, device=dev)
    shifted = buf[1:].view(pooled.shape)
    shifted.copy_(torch.tensor(pooled))
    assert shifted.data_ptr() % 8 != 0 and shifted.is_contiguous()
    want = [torch.tensor(x, device=dev) for x in (table, accum)]
    sparse_update.fused_bag_backward_adagrad(
        *want, *plan, torch.tensor(pooled, device=dev), 0.05)
    got = [torch.tensor(x, device=dev) for x in (table, accum)]
    sparse_update.fused_bag_backward_adagrad(*got, *plan, shifted, 0.05)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_fused_update_builds_without_spills(dev, tmp_path):
    """Both entry kernels at every NC (1-4: sums in registers) and the
    shared-memory body (0) compile for sm_90a with no spill stores or
    loads."""
    import subprocess
    cmd = sparse_update.KERNEL._command(tmp_path / "fused.so")
    run = subprocess.run(cmd, capture_output=True, text=True)
    log = run.stdout + run.stderr
    assert run.returncode == 0, log
    entries = [line for line in log.splitlines()
               if "Compiling entry function" in line]
    assert len(entries) == 10, log
    assert sum("segments_kernel" in e for e in entries) == 5, log
    spills = [line for line in log.splitlines() if "spill" in line]
    assert len(spills) == 10, log
    assert all("0 bytes spill stores, 0 bytes spill loads" in line
               for line in spills), log


def test_fused_update_guards_raise_as_before(dev):
    """Both wrappers check directly, and each failure still raises
    `_check_cuda`'s exception type and message."""
    t, a = torch.zeros((8, 4), device=dev), torch.zeros(8, device=dev)
    rows = torch.zeros((2,), dtype=torch.int32, device=dev)
    offs = torch.zeros((3,), dtype=torch.int32, device=dev)
    bags = torch.zeros((5,), dtype=torch.int32, device=dev)
    pooled = torch.zeros((5, 4), device=dev)
    one = "fused_bag_backward_adagrad"
    bad = [
        (ValueError, f"{one} needs every tensor on one CUDA device",
         (t, a.cpu(), rows, offs, bags, pooled)),
        (ValueError, "one CUDA device", (t, a, rows, offs, bags.cpu(),
                                         pooled)),
        (TypeError, f"{one} kernel takes fp32",
         (t, a, rows, offs, bags, pooled.double())),
        (TypeError, "int32 plan arrays", (t, a, rows.long(), offs, bags,
                                          pooled)),
        (TypeError, "int32 plan arrays", (t, a, rows, offs.long(), bags,
                                          pooled)),
        (ValueError, f"{one} kernel needs contiguous",
         (torch.zeros((8, 8), device=dev)[:, :4], a, rows, offs, bags,
          pooled)),
        (ValueError, "contiguous", (t, a, rows, offs,
                                    torch.zeros(10, dtype=torch.int32,
                                                device=dev)[::2], pooled)),
    ]
    before = sparse_update.KERNEL.launches
    for exc, msg, args in bad:
        with pytest.raises(exc, match=msg):
            sparse_update.fused_bag_backward_adagrad(*args, 0.1)
    assert sparse_update.KERNEL.launches == before
    seg = "fused_bag_backward_adagrad_segments"
    base = torch.zeros((1,), dtype=torch.int32, device=dev)
    strided = torch.zeros((1, 4), dtype=torch.int32, device=dev)[:, ::2]
    bad = [
        (ValueError, f"{seg} needs every tensor on one CUDA device",
         (t, a, rows[None], offs[None], bags, pooled, base.cpu())),
        (TypeError, f"{seg} kernel takes fp32",
         (t, a, rows[None], offs[None], bags, pooled, base.long())),
        (TypeError, f"{seg} kernel takes fp32",
         (t.double(), a, rows[None], offs[None], bags, pooled, base)),
        (ValueError, f"{seg} kernel needs contiguous",
         (t, a, strided, offs[None], bags, pooled, base)),
    ]
    before = sparse_update.SEGMENTS_KERNEL.launches
    for exc, msg, args in bad:
        with pytest.raises(exc, match=msg):
            sparse_update.fused_bag_backward_adagrad_segments(*args, 0.1)
    assert sparse_update.SEGMENTS_KERNEL.launches == before


def _mover_inputs(dev, r, c, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((r, d), generator=g, device=dev),
            torch.randn((c, d), generator=g, device=dev),
            torch.rand((r,), generator=g, device=dev),
            torch.rand((c,), generator=g, device=dev))


@pytest.mark.parametrize("d", [64, 6, 5, 128])
def test_cache_fetch_kernel_bit_equal_to_plain(dev, d):
    capacity, _, cap_accum, _ = _mover_inputs(dev, 300, 1, d, d)
    rows = torch.tensor([5, -1, 299, 0, -1, 17, 5], dtype=torch.int32,
                        device=dev)
    before = cache_ops.FETCH_KERNEL.launches
    got = cache_ops.cache_fetch(capacity, cap_accum, rows)
    assert cache_ops.FETCH_KERNEL.launches == before + 1
    want = ref.cache_fetch_ref(capacity, cap_accum, rows)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not got[0][1].any() and float(got[1][4]) == 0.0


@pytest.mark.parametrize("chunk,d", [(1, 64), (8, 64), (16, 5), (3, 6)])
def test_cache_fetch_chunked_kernel_bit_equal_to_plain(dev, chunk, d):
    r = 200
    capacity, _, cap_accum, _ = _mover_inputs(dev, r, 1, d, chunk)
    starts = torch.tensor([0, -1, r - chunk, 41], dtype=torch.int32,
                          device=dev)
    cache_ops.check_chunk_starts(starts, chunk, r)
    before = cache_ops.FETCH_CHUNKED_KERNEL.launches
    got = cache_ops.cache_fetch_chunked(capacity, cap_accum, starts, chunk)
    assert cache_ops.FETCH_CHUNKED_KERNEL.launches == before + 1
    want = ref.cache_fetch_chunked_ref(capacity, cap_accum, starts, chunk)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(got[0][2 * chunk:3 * chunk], capacity[r - chunk:])


@pytest.mark.parametrize("remap", [False, True])
@pytest.mark.parametrize("d", [64, 5])
def test_cache_commit_kernel_bit_equal_to_plain(dev, d, remap):
    tiers = _mover_inputs(dev, 300, 40, d, d + remap)
    g = torch.Generator(device=dev).manual_seed(9)
    m = 64 if remap else 12
    shadow = torch.randn((m, d), generator=g, device=dev)
    shadow_accum = torch.rand((m,), generator=g, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    slots = torch.tensor([0, 3, 7, -1, 9, 39, 12, 13, 20, 21, 22, 30], **i32)
    evict = torch.tensor([100, -1, 102, 5, -1, 299, -1, 7, 8, -1, 9, 10],
                         **i32)
    fetch = torch.tensor([200, 201, -1, -1, 202, 203, 204, 205, -1, 206,
                          207, 208], **i32)
    src_pos = torch.randperm(m, generator=g, device=dev)[:12].int() \
        if remap else None
    cache_ops.check_commit_worklist(slots, fetch, src_pos, m)
    got = [t.clone() for t in tiers]
    before = cache_ops.COMMIT_KERNEL.launches
    cache_ops.cache_commit(*got, shadow, shadow_accum, slots, evict, fetch,
                           src_pos)
    assert cache_ops.COMMIT_KERNEL.launches == before + 1
    want = [t.clone() for t in tiers]
    ref.cache_commit_ref(*want, shadow, shadow_accum, slots, evict, fetch,
                         src_pos)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _commit_case(dev, n, d, offset=0, seed=0):
    """A contract worklist of n entries (distinct slots and writeback rows,
    src_pos remapping a larger slab) over tiers that start `offset` floats
    into their buffers: ~40% of the entries write a victim back, ~15% are
    pure writebacks, ~10% are pad slots (their other fields left >= 0),
    ~5% are live slots with nothing to do; the last cache slot and the
    last capacity row are in it. Returns (tiers, work)."""
    r, c, m = 2 * n + 1000, n + 500, n + 300
    g = torch.Generator(device=dev).manual_seed(seed)

    def at_offset(shape, fill):
        numel = int(np.prod(shape))
        buf = torch.empty(numel + offset, device=dev)
        t = buf[offset:].view(shape)
        t.copy_(fill(shape))
        return t

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev)

    def rand(shape):
        return torch.rand(shape, generator=g, device=dev)

    tiers = (at_offset((r, d), randn), at_offset((c, d), randn),
             rand((r,)), rand((c,)))
    shadow, shadow_accum = at_offset((m, d), randn), rand((m,))
    # entry 0 takes the last slot and writes back to the last row
    slots = torch.randperm(c - 1, generator=g, device=dev)[:n].int()
    evict = torch.randperm(r - 1, generator=g, device=dev)[:n].int()
    slots[0], evict[0] = c - 1, r - 1
    fetch = torch.randint(0, r, (n,), generator=g, device=dev,
                          dtype=torch.int32)
    src_pos = torch.randperm(m, generator=g, device=dev)[:n].int()
    u = rand((n,))
    u[0] = 0.7
    evict[u < 0.6] = -1                             # no victim
    fetch[u > 0.85] = -1                            # pure writebacks
    slots[(u > 0.2) & (u < 0.3)] = -1               # pads
    evict[(u > 0.4) & (u < 0.45)] = -1              # live, nothing to do
    fetch[(u > 0.4) & (u < 0.45)] = -1
    cache_ops.check_commit_worklist(slots, fetch, src_pos, m)
    return tiers, (shadow, shadow_accum, slots, evict, fetch, src_pos)


def _commit_held(tiers, work):
    """The kernel's commit, bit-equal to the plain version's, one launch."""
    got = [t.clone() for t in tiers]
    before = cache_ops.COMMIT_KERNEL.launches
    cache_ops.cache_commit(*tiers, *work)
    assert cache_ops.COMMIT_KERNEL.launches == before + 1
    ref.cache_commit_ref(*got, *work)
    for a, b in zip(tiers, got):
        assert torch.equal(a, b)


# The commit walks its worklist in rounds of 8 entries on a persistent
# grid: at D = 64 half a warp moves each of two rows a step (float4), at
# D = 128 a warp one row (float4); D = 5 and 6, and tiers 4 or 8 bytes off
# a 16-byte boundary, take the column loop in 1 or 2 floats
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("d", [64, 128, 5, 6])
def test_cache_commit_rounds_bit_equal_to_plain(dev, d, offset):
    tiers, work = _commit_case(dev, 5003, d, offset, seed=d + offset)
    assert tiers[0].data_ptr() % 16 == 4 * offset
    _commit_held(tiers, work)


@pytest.mark.parametrize("d", [64, 128])
def test_cache_commit_past_one_grid_of_rounds(dev, d):
    """2^22 + 17 entries: more than 32 entries for each warp of four
    waves of the most 4-warp blocks an H100 holds at once (132 SMs x 16),
    so every warp of the persistent grid walks several rounds."""
    tiers, work = _commit_case(dev, (1 << 22) + 17, d, seed=d)
    _commit_held(tiers, work)


def test_cache_commit_of_an_all_pad_worklist(dev):
    tiers, work = _commit_case(dev, 77, 64, seed=5)
    work[2].fill_(-1)
    want = [t.clone() for t in tiers]
    _commit_held(tiers, work)
    for a, b in zip(tiers, want):
        assert torch.equal(a, b)


def test_cache_commit_guard_raises_as_before(dev):
    """The wrapper checks directly, and each failure still raises
    `_check_cuda`'s exception type and message, before any launch."""
    tiers, (sh, sa, sl, ev, ft, sp) = _commit_case(dev, 40, 8)
    cap, cch, ca, cc = tiers
    bad = [
        (ValueError, "cache_commit needs every tensor on one CUDA device",
         (cap, cch, ca, cc, sh, sa, sl, ev, ft.cpu(), sp)),
        (ValueError, "cache_commit needs every tensor on one CUDA device",
         (cap, cch, ca, cc, sh, sa, sl, ev, ft, sp.cpu())),
        (ValueError, r"cache_commit: cache has shape \(540, 4\)",
         (cap, cch[:, :4].contiguous(), ca, cc, sh, sa, sl, ev, ft, sp)),
        (ValueError, "cache_commit: shadow_accum has shape",
         (cap, cch, ca, cc, sh, sa[:-1], sl, ev, ft, sp)),
        (ValueError, "cache_commit: src_pos has shape",
         (cap, cch, ca, cc, sh, sa, sl, ev, ft, sp[:-1])),
        (TypeError, "cache_commit: slots must be torch.int32",
         (cap, cch, ca, cc, sh, sa, sl.long(), ev, ft, sp)),
        (TypeError, "cache_commit: capacity must be torch.float32",
         (cap.double(), cch, ca, cc, sh, sa, sl, ev, ft, sp)),
        (ValueError, "cache_commit: cache must be contiguous",
         (cap, cch.t().contiguous().t(), ca, cc, sh, sa, sl, ev, ft, sp)),
        (ValueError, "cache_commit: evict_rows must be contiguous",
         (cap, cch, ca, cc, sh, sa, sl,
          torch.stack([ev, ev], 1)[:, 0], ft, sp)),
    ]
    before = cache_ops.COMMIT_KERNEL.launches
    for exc, msg, args in bad:
        with pytest.raises(exc, match=msg):
            cache_ops.cache_commit(*args)
    assert cache_ops.COMMIT_KERNEL.launches == before


def test_row_movers_reach_rows_past_2_pow_24(dev):
    """A capacity tier of 2^24 + 1024 rows at D=64 (4.3 GB): row indices
    past 2^24 and byte offsets past 2^32 in all three movers."""
    r, d = (1 << 24) + 1024, 64
    capacity, cache, cap_accum, cache_accum = _mover_inputs(dev, r, 64, d, 1)
    i32 = dict(dtype=torch.int32, device=dev)
    rows = torch.tensor([r - 1, -1, 1 << 24, 3], **i32)
    for a, b in zip(cache_ops.cache_fetch(capacity, cap_accum, rows),
                    ref.cache_fetch_ref(capacity, cap_accum, rows)):
        assert torch.equal(a, b)
    starts = torch.tensor([r - 8, (1 << 24) - 3, -1], **i32)
    shadow, shadow_accum = cache_ops.cache_fetch_chunked(
        capacity, cap_accum, starts, 8)
    want = ref.cache_fetch_chunked_ref(capacity, cap_accum, starts, 8)
    assert torch.equal(shadow, want[0]) and torch.equal(shadow_accum, want[1])
    slots = torch.tensor([0, 5, 63], **i32)
    evict = torch.tensor([r - 2, (1 << 24) + 7, -1], **i32)
    fetch = torch.tensor([r - 1, 11, (1 << 24) - 1], **i32)
    src_pos = torch.tensor([7, 3, 5], **i32)
    touched = torch.tensor([r - 2, (1 << 24) + 7], device=dev)
    saved = capacity[touched].clone(), cap_accum[touched].clone()
    got_cache, got_acc = cache.clone(), cache_accum.clone()
    cache_ops.cache_commit(capacity, got_cache, cap_accum, got_acc, shadow,
                           shadow_accum, slots, evict, fetch, src_pos)
    got_rows = capacity[touched].clone(), cap_accum[touched].clone()
    capacity[touched], cap_accum[touched] = saved
    ref.cache_commit_ref(capacity, cache, cap_accum, cache_accum, shadow,
                         shadow_accum, slots, evict, fetch, src_pos)
    assert torch.equal(got_cache, cache) and torch.equal(got_acc, cache_accum)
    assert torch.equal(got_rows[0], capacity[touched])
    assert torch.equal(got_rows[1], cap_accum[touched])


def test_row_mover_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    cap, acc = torch.zeros((8, 4), device=dev), torch.zeros(8, device=dev)
    rows = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        cache_ops.cache_fetch(cap, acc, rows.long())
    with pytest.raises(ValueError):
        cache_ops.cache_fetch(cap.t(), acc, rows)          # not contiguous
    with pytest.raises(ValueError):
        cache_ops.cache_fetch_chunked(cap, acc, rows, 9)   # taller than R
    with pytest.raises(ValueError):
        cache_ops.cache_commit(cap, cap[:2], acc, acc[:2], cap[:1], acc[:1],
                               rows, rows, rows, rows[:1])


def test_cache_fetch_chunked_guards_raise_as_before(dev):
    """The chunked fetch checks directly, and each failure still raises
    `_check_cuda`'s exception type and message."""
    cap, acc = torch.zeros((8, 4), device=dev), torch.zeros(8, device=dev)
    starts = torch.zeros(2, dtype=torch.int32, device=dev)
    wide = torch.zeros((8, 8), device=dev)
    bad = [
        (ValueError, "chunk must be >= 1", (cap, acc, starts, 0)),
        (ValueError, "taller than the 8-row table", (cap, acc, starts, 9)),
        (ValueError, "one CUDA device", (cap, acc.cpu(), starts, 2)),
        (ValueError, "one CUDA device", (cap, acc, starts.cpu(), 2)),
        (ValueError, "cap_accum has shape", (cap, acc[:7], starts, 2)),
        (ValueError, "chunk_starts has shape",
         (cap, acc, starts.reshape(2, 1), 2)),
        (TypeError, "capacity must be", (cap.double(), acc, starts, 2)),
        (TypeError, "cap_accum must be", (cap, acc.double(), starts, 2)),
        (TypeError, "chunk_starts must be", (cap, acc, starts.long(), 2)),
        (ValueError, "capacity must be contiguous",
         (wide[:, :4], acc, starts, 2)),
        (ValueError, "cap_accum must be contiguous",
         (cap, torch.zeros(16, device=dev)[::2], starts, 2)),
        (ValueError, "chunk_starts must be contiguous",
         (cap, acc, torch.zeros(4, dtype=torch.int32, device=dev)[::2], 2)),
    ]
    before = cache_ops.FETCH_CHUNKED_KERNEL.launches
    for exc, msg, args in bad:
        with pytest.raises(exc, match=msg):
            cache_ops.cache_fetch_chunked(*args)
    assert cache_ops.FETCH_CHUNKED_KERNEL.launches == before
    shadow, shadow_accum = cache_ops.cache_fetch_chunked(cap, acc, starts, 2)
    assert shadow.shape == (4, 4) and shadow_accum.shape == (4,)
    assert shadow.dtype == shadow_accum.dtype == torch.float32


def test_cache_fetch_guards_raise_as_before(dev):
    """The row fetch checks directly, and each failure still raises
    `_check_cuda`'s exception type and message."""
    cap, acc = torch.zeros((8, 4), device=dev), torch.zeros(8, device=dev)
    rows = torch.zeros(3, dtype=torch.int32, device=dev)
    wide = torch.zeros((8, 8), device=dev)
    bad = [
        (ValueError, "cache_fetch needs every tensor on one CUDA device",
         (cap, acc.cpu(), rows)),
        (ValueError, "one CUDA device", (cap, acc, rows.cpu())),
        (ValueError, "one CUDA device", (cap.cpu(), acc, rows)),
        (ValueError, "cap_accum has shape", (cap, acc[:7], rows)),
        (ValueError, "fetch_rows has shape", (cap, acc, rows.reshape(3, 1))),
        (TypeError, "capacity must be", (cap.double(), acc, rows)),
        (TypeError, "cap_accum must be", (cap, acc.double(), rows)),
        (TypeError, "fetch_rows must be", (cap, acc, rows.long())),
        (ValueError, "capacity must be contiguous", (wide[:, :4], acc, rows)),
        (ValueError, "cap_accum must be contiguous",
         (cap, torch.zeros(16, device=dev)[::2], rows)),
        (ValueError, "fetch_rows must be contiguous",
         (cap, acc, torch.zeros(6, dtype=torch.int32, device=dev)[::2])),
    ]
    before = cache_ops.FETCH_KERNEL.launches
    for exc, msg, args in bad:
        with pytest.raises(exc, match=msg):
            cache_ops.cache_fetch(*args)
        with pytest.raises(exc, match=msg):
            cache_ops.check_fetch(*args)
    assert cache_ops.FETCH_KERNEL.launches == before
    shadow, shadow_accum = cache_ops.cache_fetch(cap, acc, rows)
    assert shadow.shape == (3, 4) and shadow_accum.shape == (3,)
    assert shadow.dtype == shadow_accum.dtype == torch.float32
    assert shadow.device == cap.device


@pytest.mark.parametrize("schedule,fetch_chunk", [("sync", 1), ("sync", 4),
                                                  ("async", 1),
                                                  ("async", 4)])
def test_cached_train_step_on_the_card_matches_the_cpu(dev, schedule,
                                                       fetch_chunk):
    """Four cached steps of the smoke dlrm-m1 through a 200-slot cache on
    the card and on the CPU: the host state exactly equal, floats within
    rtol/atol 1e-5 (cuBLAS sums in other orders); every row mover of the
    schedule launched."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cache import CachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.tiers import AsyncCachedTier
    from repro_torch.data.pipeline import sparse_plan_hook
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.nn.params import tree_map
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import (build_cached_train_step,
                                         cached_dlrm_init_state)
    resolve_device("cuda")
    cfg = get_smoke_config("dlrm-m1")
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=200,
                                            fetch_chunk=fetch_chunk)
    hook = sparse_plan_hook(cc.ebc.plan.table_offsets)
    batches = [hook(make_dlrm_batch(cfg, 8, step=t, zipf_alpha=1.05))
               for t in range(5)]
    for k in KERNELS:
        k.launches = 0
    runs = {}
    for d in (torch.device("cpu"), dev):
        params = tree_map(lambda x: x.to(d), init_dlrm_params(
            cfg, cc.ebc, 0, torch.device("cpu")))
        tier = cc if schedule == "sync" else AsyncCachedTier(cc)
        cs = tier.init_state(params["emb"]["mega"])
        opt = adagrad(0.01)
        state = cached_dlrm_init_state(cc, opt, params)
        dense = {"bottom": params["bottom"], "top": params["top"]}
        step = build_cached_train_step(cfg, tier, opt)
        losses = []
        for t in range(4):
            dense, state, m = step(dense, state, cs, batches[t], t,
                                   next_batch=batches[t + 1])
            losses.append(float(m["loss"]))
        mega, accum = tier.materialize(cs)
        runs[d.type] = (losses, mega.cpu(), accum.cpu(),
                        dense["top"][0]["w"].cpu(), cs)
    cpu, card = runs["cpu"], runs["cuda"]
    np.testing.assert_array_equal(card[4].slot_row, cpu[4].slot_row)
    assert card[4].stats == cpu[4].stats and cpu[4].stats.evictions > 0
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(card[1:4], cpu[1:4]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # every schedule flushes through the exchange; the async one fetches
    # and commits, and fetch_chunk > 1 fetches blocks and commits
    movers = [cache_ops.KERNEL]
    if schedule == "async" or fetch_chunk > 1:
        movers.append(cache_ops.COMMIT_KERNEL)
    movers.append(cache_ops.FETCH_CHUNKED_KERNEL if fetch_chunk > 1
                  else cache_ops.FETCH_KERNEL if schedule == "async"
                  else cache_ops.KERNEL)
    assert all(k.launches > 0 for k in movers), \
        {k.name: k.launches for k in KERNELS}


def _segments(dev, idx, shard_rows, owners, seg_cap=None):
    plan = sparse_plan.build_sparse_plan_host(idx.cpu().numpy())
    segs = sparse_plan.split_plan_by_owner(plan, shard_rows, owners,
                                           seg_cap=seg_cap)
    return plan, [torch.from_numpy(x).to(dev) for x in
                  (*segs[:2], plan.bag_ids, segs[2])]


@pytest.mark.parametrize("h,d,b,f,lk,owners", [(60, 12, 5, 3, 6, 4),
                                               (300, 64, 16, 4, 32, 8),
                                               (97, 128, 6, 3, 7, 3)])
def test_fused_segments_kernel_matches_plain_and_one_plan_kernel(
        dev, h, d, b, f, lk, owners):
    """Against the plain version: rtol/atol 1e-6 on touched rows, untouched
    rows unmoved; against the one-plan kernel on the same batch: bit-equal,
    at the tight capacity and at the reference's seg_cap = U. The last
    owner is left without rows: an empty segment."""
    shard_rows = -(-h // owners)
    idx, table, accum, pooled = _plan_inputs(dev, h, d, b, f, lk, h + owners)
    idx = torch.where(idx >= (owners - 1) * shard_rows, -1, idx)
    plan, (rows, offs, bags, base) = _segments(dev, idx, shard_rows, owners)
    assert (rows[-1] < 0).all()
    t_k, a_k = table.clone(), accum.clone()
    before = sparse_update.SEGMENTS_KERNEL.launches
    sparse_update.fused_bag_backward_adagrad_segments(
        t_k, a_k, rows, offs, bags, pooled, base, 0.05)
    assert sparse_update.SEGMENTS_KERNEL.launches == before + 1
    t_p, a_p = table.clone(), accum.clone()
    ref.fused_bag_backward_adagrad_segments_ref(t_p, a_p, rows, offs, bags,
                                                pooled, base, 0.05)
    torch.cuda.synchronize()
    touched = torch.zeros(h, dtype=torch.bool, device=dev)
    touched[idx[idx >= 0].long()] = True
    assert torch.equal(t_k[~touched], table[~touched])
    assert torch.equal(a_k[~touched], accum[~touched])
    torch.testing.assert_close(t_k, t_p, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a_k, a_p, rtol=1e-6, atol=1e-6)
    t_1, a_1 = table.clone(), accum.clone()
    sparse_update.fused_bag_backward_adagrad(
        t_1, a_1, *(torch.from_numpy(x).to(dev) for x in plan), pooled, 0.05)
    assert torch.equal(t_k, t_1) and torch.equal(a_k, a_1)
    _, (rows_u, offs_u, bags_u, base_u) = _segments(
        dev, idx, shard_rows, owners, seg_cap=idx.numel())
    t_u, a_u = table.clone(), accum.clone()
    sparse_update.fused_bag_backward_adagrad_segments(
        t_u, a_u, rows_u, offs_u, bags_u, pooled, base_u, 0.05)
    assert torch.equal(t_k, t_u) and torch.equal(a_k, a_u)


def test_fused_segments_kernel_with_one_segment_is_the_one_plan_kernel(dev):
    idx, table, accum, pooled = _plan_inputs(dev, 300, 64, 16, 4, 32, 11)
    plan = sparse_plan.build_sparse_plan(idx)
    t_s, a_s = table.clone(), accum.clone()
    ops.fused_sparse_backward_segments(
        t_s, a_s, plan.unique_rows[None], plan.bag_offsets[None],
        plan.bag_ids, pooled, 0.05)
    t_1, a_1 = table.clone(), accum.clone()
    sparse_update.fused_bag_backward_adagrad(t_1, a_1, *plan, pooled, 0.05)
    assert torch.equal(t_s, t_1) and torch.equal(a_s, a_1)


@pytest.mark.parametrize("h,d,n", [(64, 8, 16), (97, 48, 23), (128, 64, 64),
                                   (50, 200, 300)])
def test_rowwise_adagrad_kernel_matches_plain(dev, h, d, n):
    g = torch.Generator(device=dev).manual_seed(h + n)
    table = torch.randn((h, d), generator=g, device=dev)
    accum = torch.rand((h,), generator=g, device=dev)
    idx = torch.randint(-1, h, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    grads = torch.randn((n, d), generator=g, device=dev)
    uniq, gsum = ref.dedup_grads_ref(idx, grads, h)
    t_k, a_k = table.clone(), accum.clone()
    before = rowwise_adagrad.KERNEL.launches
    rowwise_adagrad.rowwise_adagrad(t_k, a_k, uniq, gsum, 0.05)
    assert rowwise_adagrad.KERNEL.launches == before + 1
    t_p, a_p = table.clone(), accum.clone()
    ref.rowwise_adagrad_ref(t_p, a_p, uniq, gsum, 0.05)
    torch.cuda.synchronize()
    touched = torch.zeros(h, dtype=torch.bool, device=dev)
    touched[idx[idx >= 0].long()] = True
    assert torch.equal(t_k[~touched], table[~touched])
    assert torch.equal(a_k[~touched], accum[~touched])
    torch.testing.assert_close(t_k, t_p, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(a_k, a_p, rtol=1e-6, atol=1e-6)


# rowwise_adagrad's register body runs at D = 32, 64, 96 and 128 (float2
# pairs at 64 and 128), its scalar body at any other D (48)
@pytest.mark.parametrize("d", [32, 64, 96, 128, 48])
def test_two_pass_update_on_the_card_is_the_fused_update(dev, d):
    """The dedup sums each row's gradients in the fused kernel's order, and
    rowwise_adagrad applies them with its arithmetic: bit-equal."""
    idx, table, accum, pooled = _plan_inputs(dev, 300, d, 16, 4, 32, 12)
    b, f, lk = idx.shape
    g = pooled.reshape(b, f, 1, -1).expand(b, f, lk, -1)
    t_2, a_2 = ops.rowwise_adagrad_update(
        table.clone(), accum.clone(), idx.reshape(-1),
        g.reshape(b * f * lk, -1), 0.05)
    t_f, a_f = ops.fused_sparse_backward(table.clone(), accum.clone(), idx,
                                         pooled, 0.05)
    assert torch.equal(t_2, t_f) and torch.equal(a_2, a_f)


def test_two_pass_update_past_one_grid_of_rounds_is_the_fused_update(dev):
    """2^22 lookups, so 2^22 dedup entries: more rounds of 32 than four
    waves of the most 4-warp blocks an H100 holds at once, so every warp
    of rowwise_adagrad's persistent grid walks several rounds, its
    read-ahead crossing their edges; every live row moves."""
    idx, table, accum, pooled = _plan_inputs(dev, 300_000, 64, 2048, 16,
                                             128, 21)
    b, f, lk = idx.shape
    g = pooled.reshape(b, f, 1, -1).expand(b, f, lk, -1)
    before = rowwise_adagrad.KERNEL.launches
    t_2, a_2 = ops.rowwise_adagrad_update(
        table.clone(), accum.clone(), idx.reshape(-1),
        g.reshape(b * f * lk, -1), 0.05)
    assert rowwise_adagrad.KERNEL.launches == before + 1
    del g
    t_f, a_f = ops.fused_sparse_backward(table.clone(), accum.clone(), idx,
                                         pooled, 0.05)
    assert torch.equal(t_2, t_f) and torch.equal(a_2, a_f)
    touched = torch.zeros(table.shape[0], dtype=torch.bool, device=dev)
    touched[idx[idx >= 0].long()] = True
    assert torch.equal((t_2 != table).any(1), touched)


def test_rowwise_adagrad_of_an_all_dead_uniq(dev):
    g = torch.Generator(device=dev).manual_seed(2)
    table = torch.randn((100, 64), generator=g, device=dev)
    accum = torch.rand((100,), generator=g, device=dev)
    uniq = torch.full((1000,), -1, dtype=torch.int32, device=dev)
    gsum = torch.randn((1000, 64), generator=g, device=dev)
    t, a = table.clone(), accum.clone()
    before = rowwise_adagrad.KERNEL.launches
    rowwise_adagrad.rowwise_adagrad(t, a, uniq, gsum, 0.05)
    assert rowwise_adagrad.KERNEL.launches == before + 1
    assert torch.equal(t, table) and torch.equal(a, accum)


@pytest.mark.parametrize("shifted", ["table", "gsum"])
@pytest.mark.parametrize("d", [64, 128])
def test_rowwise_adagrad_off_an_8_byte_boundary(dev, d, shifted):
    """D = 64 and 128 load float2 pairs; a table or gsum that starts one
    float into its storage takes the scalar body, with the same bits."""
    idx, table, accum, pooled = _plan_inputs(dev, 500, d, 16, 4, 32, d)
    grads = torch.randn((idx.numel(), d), device=dev)
    uniq, gsum = ref.dedup_grads_ref(idx.reshape(-1), grads, 500)
    want = table.clone(), accum.clone()
    rowwise_adagrad.rowwise_adagrad(*want, uniq, gsum, 0.05)
    src = table if shifted == "table" else gsum
    buf = torch.zeros(src.numel() + 1, device=dev)
    moved = buf[1:].view(src.shape)
    moved.copy_(src)
    assert moved.data_ptr() % 8 != 0 and moved.is_contiguous()
    got = (moved if shifted == "table" else table.clone()), accum.clone()
    rowwise_adagrad.rowwise_adagrad(
        *got, uniq, moved if shifted == "gsum" else gsum, 0.05)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool((want[0] != table).any())


@pytest.mark.parametrize("module,entries", [("cache_commit", 5),
                                            ("rowwise_adagrad", 5)])
def test_commit_and_rowwise_kernels_build_without_spills(dev, tmp_path,
                                                         module, entries):
    """cache_commit's five bodies (float4 pairs at D = 64, float4 rows at
    128, the column loop at VEC 4, 2, 1) and rowwise_adagrad's (register
    bodies at NC 1-4, the scalar body) compile for sm_90a with no spill
    stores or loads."""
    import subprocess
    kernel = (cache_ops.COMMIT_KERNEL if module == "cache_commit"
              else rowwise_adagrad.KERNEL)
    run = subprocess.run(kernel._command(tmp_path / f"{module}.so"),
                         capture_output=True, text=True)
    log = run.stdout + run.stderr
    assert run.returncode == 0, log
    assert sum("Compiling entry function" in line
               for line in log.splitlines()) == entries, log
    spills = [line for line in log.splitlines() if "spill" in line]
    assert len(spills) == entries, log
    assert all("0 bytes spill stores, 0 bytes spill loads" in line
               for line in spills), log


def test_segmented_and_rowwise_kernels_reach_rows_past_2_pow_24(dev):
    """A table of 2^24 + 1024 rows at D=64 (4.3 GB), two owners: rows past
    2^24 (the table's last among them) and byte offsets past 2^32."""
    r, d = (1 << 24) + 1024, 64
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn((r, d), generator=g, device=dev)
    accum = torch.rand((r,), generator=g, device=dev)
    idx = torch.tensor([[[r - 1, 5, r - 1, -1]], [[1 << 24, r - 1, 7, 9]]],
                       dtype=torch.int32, device=dev)
    pooled = torch.randn((2, d), generator=g, device=dev)
    _, (rows, offs, bags, base) = _segments(dev, idx, r // 2, 2)
    hit = idx[idx >= 0].long().unique()
    saved = table[hit].clone(), accum[hit].clone()
    sparse_update.fused_bag_backward_adagrad_segments(
        table, accum, rows, offs, bags, pooled, base, 0.05)
    got = table[hit].clone(), accum[hit].clone()
    table[hit], accum[hit] = saved
    ref.fused_bag_backward_adagrad_segments_ref(table, accum, rows, offs,
                                                bags, pooled, base, 0.05)
    torch.testing.assert_close(got[0], table[hit], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], accum[hit], rtol=1e-6, atol=1e-6)
    assert not torch.equal(got[0], saved[0])
    table[hit], accum[hit] = saved
    uniq = torch.tensor([r - 1, -1, 1 << 24], dtype=torch.int32, device=dev)
    gsum = torch.randn((3, d), generator=g, device=dev)
    rowwise_adagrad.rowwise_adagrad(table, accum, uniq, gsum, 0.05)
    got = table[hit].clone(), accum[hit].clone()
    table[hit], accum[hit] = saved
    ref.rowwise_adagrad_ref(table, accum, uniq, gsum, 0.05)
    torch.testing.assert_close(got[0], table[hit], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], accum[hit], rtol=1e-6, atol=1e-6)


def test_tablewise_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    t, a = torch.zeros((8, 4), device=dev), torch.zeros(8, device=dev)
    rows = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    offs = torch.zeros((2, 4), dtype=torch.int32, device=dev)
    bags = torch.zeros((5,), dtype=torch.int32, device=dev)
    base = torch.zeros((2,), dtype=torch.int32, device=dev)
    pooled = torch.zeros((5, 4), device=dev)
    upd = sparse_update.fused_bag_backward_adagrad_segments
    with pytest.raises(TypeError):
        upd(t, a, rows, offs, bags, pooled, base.long(), 0.1)
    with pytest.raises(TypeError):
        upd(t, a, rows, offs, bags, pooled.double(), base, 0.1)
    with pytest.raises(ValueError):
        upd(t, a, rows, offs, bags, pooled, base.cpu(), 0.1)
    with pytest.raises(ValueError):
        upd(t, a, rows.t().contiguous().t(), offs, bags, pooled, base, 0.1)
    uniq = torch.zeros((3,), dtype=torch.int32, device=dev)
    gsum = torch.zeros((3, 4), device=dev)
    with pytest.raises(TypeError):
        rowwise_adagrad.rowwise_adagrad(t, a, uniq.long(), gsum, 0.1)
    with pytest.raises(ValueError):
        rowwise_adagrad.rowwise_adagrad(t, a, uniq, gsum.cpu(), 0.1)
    with pytest.raises(ValueError):
        rowwise_adagrad.rowwise_adagrad(t.t(), a[:4], uniq,
                                        torch.zeros((3, 8), device=dev), 0.1)


@pytest.mark.parametrize("staged", [False, True])
def test_tablewise_step_on_the_card_matches_the_cpu(dev, staged):
    """Three table-wise steps of the smoke dlrm-m1 over 4 owners on the
    card and on the CPU: rtol/atol 1e-5 (kernels and cuBLAS sum in other
    orders than the CPU); the segmented kernel launched once a step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.data.pipeline import sparse_plan_hook
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.nn.params import tree_map
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import (build_tablewise_train_step,
                                         dlrm_init_state)
    resolve_device("cuda")
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, n_shards=4,
                                       strategy="table_wise")
    hook = sparse_plan_hook(ebc.plan.table_offsets)
    batches = [hook(make_dlrm_batch(cfg, 16, step=t)) for t in range(3)]
    runs = {}
    for d in (torch.device("cpu"), dev):
        params = tree_map(lambda x: x.to(d), init_dlrm_params(
            cfg, ebc, 0, torch.device("cpu")))
        state = dlrm_init_state(ebc, adagrad(0.01), params)
        step = build_tablewise_train_step(cfg, ebc, adagrad(0.01))
        before = sparse_update.SEGMENTS_KERNEL.launches
        losses = []
        for t, batch in enumerate(batches):
            nxt = (batches[t + 1] if staged and t + 1 < len(batches)
                   else None)
            params, state, m = step(params, state, batch, t, next_batch=nxt)
            losses.append(float(m["loss"]))
        launched = sparse_update.SEGMENTS_KERNEL.launches - before
        assert launched == (len(batches) if d.type == "cuda" else 0)
        runs[d.type] = (losses, params["emb"]["mega"].cpu(),
                        state["accum"].cpu(), params["top"][0]["w"].cpu())
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(runs["cuda"][1:], runs["cpu"][1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_every_kernel_builds_for_hopper(dev):
    from repro_torch.kernels import build_all
    build_all(list(KERNELS))
    for k in KERNELS:
        assert k.library.exists()
    sources = {k.source.name for k in KERNELS}
    assert {"fused_bag_backward_adagrad.cu", "rowwise_adagrad.cu",
            "flash_attention.cu"} <= sources
    assert len(KERNELS) == 11


# flash attention: fp32 within the reference's own fp32 kernel tolerance
# (2e-4; __expf and the online softmax's order against cuBLAS's fp32
# products) of ref.flash_attention_ref; bf16 within one bf16 ulp of the
# output (2^-7 relative) plus 1e-3 absolute of ref.flash_attention_tiled_ref,
# which rounds P where the kernel does, since both round an fp32 result once
# to bf16
FLASH_TOL = {torch.float32: {"rtol": 2e-4, "atol": 2e-4},
             torch.bfloat16: {"rtol": 2 ** -7, "atol": 1e-3}}
#: bf16 against the fp32 oracle: the kernel rounds each P to bf16 (2^-9
#: relative) and divides by the unrounded sum, so O, a convex combination
#: of V's rows, may move by 2^-9 max|V| more
FLASH_ORACLE_V = 2 ** -9


def _qkv_on(dev, shape, dtype, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,dh", [(2, 3, 64, 16), (1, 4, 256, 64),
                                      (2, 2, 192, 128), (1, 3, 203, 64),
                                      (1, 2, 37, 40), (3, 1, 1, 128),
                                      # one 128-query tile, one row past it,
                                      # one short of two, eight
                                      (1, 2, 128, 64), (1, 2, 129, 64),
                                      (1, 2, 255, 128), (1, 2, 1024, 64),
                                      # b*h > 1: heavy and light tiles
                                      (2, 3, 1000, 128)])
def test_flash_attention_kernel_matches_plain(dev, b, h, s, dh, dtype):
    from repro_torch.kernels import flash_attention
    q, k, v = _qkv_on(dev, (b, h, s, dh), dtype, s + dh)
    before = flash_attention.KERNEL.launches
    got = flash_attention.flash_attention(q, k, v)
    assert flash_attention.KERNEL.launches == before + 1
    oracle = ref.flash_attention_ref(q, k, v)
    assert got.dtype == dtype and got.shape == (b, h, s, dh)
    if dtype == torch.float32:
        torch.testing.assert_close(got, oracle, **FLASH_TOL[dtype])
        return
    plain = ref.flash_attention_tiled_ref(q, k, v, flash_attention.block_k(dh))
    torch.testing.assert_close(got, plain, **FLASH_TOL[dtype])
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(
        got, oracle, rtol=tol["rtol"],
        atol=tol["atol"] + FLASH_ORACLE_V * float(v.float().abs().max()))


@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_kernel_is_causal(dev, dh):
    from repro_torch.kernels import flash_attention
    q, k, v = _qkv_on(dev, (1, 2, 300, dh), torch.bfloat16, dh)
    base = flash_attention.flash_attention(q, k, v)
    for p in (64, 128, 150):   # mid-tile, tile-aligned, mid-tile
        k2, v2 = k.clone(), v.clone()
        k2[:, :, p:], v2[:, :, p:] = 7.0, -5.0
        out = flash_attention.flash_attention(q, k2, v2)
        assert torch.equal(out[:, :, :p], base[:, :, :p])
        assert not torch.equal(out[:, :, p:], base[:, :, p:])


def test_flash_attention_builds_for_sm90a_without_spills(dev, tmp_path):
    """The source compiles for sm_90a with the library's flags, and ptxas
    reports no spill stores or loads for any entry function: the bf16
    tensor-core kernel at dh 64 and 128 and the fp32 kernel at both."""
    import subprocess

    from repro_torch.kernels import flash_attention
    cmd = flash_attention.KERNEL._command(tmp_path / "flash_attention.so")
    run = subprocess.run(cmd, capture_output=True, text=True)
    log = run.stdout + run.stderr
    assert run.returncode == 0, log
    entries = [line for line in log.splitlines()
               if "Compiling entry function" in line]
    assert len(entries) == 4, log
    assert all("flash_attention_kernel" in e and "sm_90a" in e
               for e in entries), log
    assert sum("flash_attention_kernel_sm90" in e for e in entries) == 2
    spills = [line for line in log.splitlines() if "spill" in line]
    assert len(spills) == 4, log
    assert all("0 bytes spill stores, 0 bytes spill loads" in line
               for line in spills), log


def test_flash_attention_tma_encode_failure_raises_the_driver_error(dev):
    """A bf16 call whose TMA descriptor cannot be encoded (a base address
    that is not 16-byte aligned) raises with the driver's error; nothing
    falls back to the fp32 kernel or the plain version."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels._build import stream_handle
    q = torch.zeros((1, 1, 130, 64), device=dev, dtype=torch.bfloat16)
    ptr = q.data_ptr() + 2
    with pytest.raises(RuntimeError, match="driver error"):
        flash_attention.KERNEL.launch(ptr, ptr, ptr, q.data_ptr(), 1, 128,
                                      64, 1, 0.125, stream_handle(dev))


def test_flash_attention_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    from repro_torch.kernels import flash_attention
    q = torch.zeros((1, 2, 8, 64), device=dev)
    with pytest.raises(ValueError):                 # a CPU tensor with CUDA
        flash_attention.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError, match="causal"):
        flash_attention.flash_attention(q, q, q, causal=False)
    with pytest.raises(TypeError):
        h = q.half()
        flash_attention.flash_attention(h, h, h)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2)
        flash_attention.flash_attention(t, t, t)
    with pytest.raises(ValueError, match="dh"):
        w = torch.zeros((1, 1, 8, 256), device=dev)
        flash_attention.flash_attention(w, w, w)


def test_two_layer_prefill_on_the_card_matches_the_cpu(dev):
    """stablelm-1.6b's smoke config (2 layers, dh 16 padded to 64), fp32
    compute: a 32-token prompt (> attn_block_q 16) launches the kernel
    once per layer; the card's logits equal the CPU's (plain attention)
    within 1e-4 and a decode step after it, which reads the bf16 cache,
    within 1e-3."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import lm
    from repro_torch.nn.params import tree_map
    resolve_device("cuda")
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                              compute_dtype="float32")
    params = lm.init_lm_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, size=(2, 32)))
    out = {}
    for d in (torch.device("cpu"), dev):
        p = tree_map(lambda x: x.to(d), params)
        caches = lm.init_caches(cfg, 2, 40, device=d)
        flash_attention.KERNEL.launches = 0
        first, caches = lm.prefill_step(p, {"tokens": tokens.to(d)}, caches,
                                        cfg)
        assert flash_attention.KERNEL.launches == \
            (cfg.n_layers if d.type == "cuda" else 0)
        nxt, _ = lm.decode_step(p, tokens[:, :1].to(d), caches, 32, cfg)
        out[d.type] = (first.cpu(), nxt.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                               atol=1e-4)
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-3,
                               atol=1e-3)

# ---------------------------------------------------------------------------
# the dense update, checkpoints and the cached tier's recovery on the card
# ---------------------------------------------------------------------------


def _dense_run(dev, n_steps=2, seed=0):
    """n_steps of the launcher's dense step at the smoke dlrm-m2 (batch 32)
    from seeded parameters made on the CPU; returns (losses, mega, accum)
    on the host."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.nn.params import tree_map
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_dlrm_train_step, dlrm_init_state
    cfg = get_smoke_config("dlrm-m2")
    ebc = EmbeddingBagCollection.build(cfg, strategy="replicated")
    params = tree_map(lambda t: t.to(dev),
                      init_dlrm_params(cfg, ebc, seed, torch.device("cpu")))
    opt = adagrad(0.01)
    state = dlrm_init_state(ebc, opt, params)
    step = build_dlrm_train_step(cfg, ebc, opt, sparse_apply="dense")
    losses = []
    for t in range(n_steps):
        raw = make_dlrm_batch(cfg, 32, step=t)
        raw["idx"] = ebc.offset_indices(raw["idx"])
        batch = {k: torch.as_tensor(v).to(dev) for k, v in raw.items()}
        params, state, m = step(params, state, batch, t)
        losses.append(float(m["loss"]))
    return losses, params["emb"]["mega"].cpu(), state["accum"].cpu()


def test_dense_steps_are_bit_equal_run_to_run(dev):
    """The scatter adds through index_put_ under deterministic algorithms:
    two runs give the same bits (index_add_'s atomics would not)."""
    resolve_device("cuda")
    a, b = _dense_run(dev), _dense_run(dev)
    assert a[0] == b[0]
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_dense_steps_on_the_card_match_the_cpu(dev):
    """Within rtol/atol 1e-5: fp32 matmuls (TF32 off), the dot kernel's
    FMA chain and mean(g^2) reduce in other orders than the CPU's."""
    resolve_device("cuda")
    card, cpu = _dense_run(dev, 3), _dense_run(torch.device("cpu"), 3)
    np.testing.assert_allclose(card[0], cpu[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(card[1], cpu[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(card[2], cpu[2], rtol=1e-5, atol=1e-5)


def test_checkpoint_round_trip_of_card_tensors_in_place(dev, tmp_path):
    from repro_torch.train.checkpoint import CheckpointManager
    g = torch.Generator(device=dev).manual_seed(0)
    tree = {"mega": torch.randn(1000, 64, generator=g, device=dev),
            "half": torch.randn(33, generator=g, device=dev).to(
                torch.bfloat16),
            "n": torch.arange(5, dtype=torch.int64, device=dev)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree, async_=True)
    mgr.wait()
    example = {k: torch.zeros_like(v) for k, v in tree.items()}
    out = mgr.restore(example)
    for k in tree:
        assert out[k] is example[k] and out[k].device == tree[k].device
        assert torch.equal(out[k], tree[k])


def _cached_tools(dev, injector=None, retry=None):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cache import CachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.tiers import AsyncCachedTier
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import (build_cached_train_step,
                                         cached_dlrm_init_state)
    cfg = get_smoke_config("dlrm-m1")
    cc = dataclasses.replace(
        CachedEmbeddingBagCollection.build(cfg, cache_rows=256),
        injector=injector, retry=retry)
    params = init_dlrm_params(cfg, cc.ebc, 0, dev)
    opt = adagrad(0.01)
    dense = {"bottom": params["bottom"], "top": params["top"]}
    return (cfg, cc, build_cached_train_step(cfg, AsyncCachedTier(cc), opt),
            dense, cached_dlrm_init_state(cc, opt, params),
            cc.init_async_state(params["emb"]["mega"]))


def _cached_segment(cfg, cc, step, dense, cstate, astate, t0, t1, n):
    from repro_torch.data.synthetic import make_dlrm_batch

    def batch(t):
        raw = make_dlrm_batch(cfg, 8, step=t)
        return {**raw, "idx": cc.ebc.offset_indices(raw["idx"])}

    losses = []
    for t in range(t0, t1):
        dense, cstate, m = step(dense, cstate, astate, batch(t), t,
                                next_batch=batch(t + 1) if t + 1 < n
                                else None)
        losses.append(float(m["loss"]))
    return dense, cstate, losses


def test_async_tier_state_dict_resumes_bit_equal_on_the_card(dev):
    resolve_device("cuda")
    cfg, cc, step, dense, cstate, astate = _cached_tools(dev)
    _, _, want = _cached_segment(cfg, cc, step, dense, cstate, astate, 0, 4,
                                 4)
    want_m, want_a = (t.clone() for t in cc.materialize_async(astate))
    cfg, cc, step, dense, cstate, astate = _cached_tools(dev)
    dense, cstate, got = _cached_segment(cfg, cc, step, dense, cstate,
                                         astate, 0, 2, 4)
    snap = cc.state_dict(astate)
    assert snap["cache"].device.type == "cuda"
    _, cc2, step2, *_ = _cached_tools(dev)
    astate2 = cc2.load_state_dict(snap)
    _, _, more = _cached_segment(cfg, cc2, step2, dense, cstate, astate2, 2,
                                 4, 4)
    got_m, got_a = cc2.materialize_async(astate2)
    assert got + more == want
    assert torch.equal(got_m, want_m) and torch.equal(got_a, want_a)


def test_transient_cache_fetch_fault_is_absorbed_on_the_card(dev):
    from repro_torch.train.fault_tolerance import (FaultInjector, FaultSpec,
                                                   RetryPolicy)
    resolve_device("cuda")
    cfg, cc, step, dense, cstate, astate = _cached_tools(dev)
    _, _, want = _cached_segment(cfg, cc, step, dense, cstate, astate, 0, 3,
                                 3)
    inj = FaultInjector([FaultSpec("cache.fetch", 1, "error")])
    cfg, cc, step, dense, cstate, astate = _cached_tools(
        dev, inj, RetryPolicy(max_retries=1, backoff_s=1e-5))
    before = cache_ops.FETCH_KERNEL.launches
    _, _, got = _cached_segment(cfg, cc, step, dense, cstate, astate, 0, 3,
                                3)
    assert inj.fired == [("cache.fetch", 1, "error")]
    assert got == want and cache_ops.FETCH_KERNEL.launches > before
