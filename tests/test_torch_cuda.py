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
the fp32 oracle. Its log-sum-exp (stored for training) is within 1e-4 of
the plain one's. flash_attention_bwd rounds where its plain version
ref.flash_attention_bwd_ref does (bf16: P and dS to bf16 before the
tensor-core products that take them; fp32: nowhere) and sums in fp32 in
other orders, with ex2.approx or exp2f: fp32 gradients within 1e-4 of the
largest plain value, bf16 ones within 2^-7 of it (one bf16 ulp there; both
round one fp32 sum to bf16, and a dS element whose fp32 value lands the
other side of a bf16 rounding boundary moves its products by one bf16 ulp
of that element), and two launches give the same bits. The multi-host
cached step launches those kernels and torch index ops (its slab
installs), so with the kernels it is bit-equal to the uncached step on the
card, and within 1e-5 of its plain run.
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


# the last three are the section-V suite's: F = 129 (128 tables, 35,904 B
# of shared memory an example, not a multiple of the 4-row tile), F = 5
# (4 tables) and Fig. 11's largest batch at the default point's F = 33
@pytest.mark.parametrize("b,f,d", [(8, 7, 16), (16, 31, 64), (3, 2, 5),
                                   (256, 129, 64), (256, 5, 64),
                                   (8192, 33, 64)])
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
                                          ("dot_interaction", 4),
                                          ("cache_exchange", 7),
                                          ("cache_fetch", 10)])
def test_bag_and_dot_build_without_spills(dev, tmp_path, name, entries):
    """embedding_bag's three lane widths times two stages,
    dot_interaction's two tile sizes times two staging paths,
    cache_exchange's bodies (the register ring at D = 64 and 128, each at
    the ring depth of either placement of the capacity tier, and the
    column loop at VEC 4, 2, 1) and cache_fetch's row fetch (the same
    seven) compile for sm_90a with no spills. cache_fetch.cu also holds
    the chunk fetch's three lane widths, counted among its entry
    functions; its body is the first design's, whose float4 instance
    spills 16 bytes."""
    import subprocess
    kernel = {"embedding_bag": embedding_bag.KERNEL,
              "dot_interaction": dot_interaction.KERNEL,
              "cache_exchange": cache_ops.KERNEL,
              "cache_fetch": cache_ops.FETCH_KERNEL}[name]
    run = subprocess.run(kernel._command(tmp_path / f"{name}.so"),
                         capture_output=True, text=True)
    log = run.stdout + run.stderr
    assert run.returncode == 0, log
    spills, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill" in line:
            spills[fn] = line
    assert len(spills) == entries, log
    assert all("0 bytes spill stores, 0 bytes spill loads" in line
               for fn, line in spills.items()
               if "cache_fetch_chunked_kernel" not in fn), log


def _at_offset(dev, shape, fill, offset):
    """fill(shape) in a view `offset` floats into a fresh card buffer."""
    numel = int(np.prod(shape))
    t = torch.empty(numel + offset, device=dev)[offset:].view(shape)
    t.copy_(fill(shape))
    return t


def _exchange_case(dev, n, d, offset=0, seed=0, cut="mixed"):
    """An exchange worklist of n entries that meets its contract (distinct
    slots, writeback and fetch rows disjoint) over tiers `offset` floats
    into their buffers: ~40% of the entries write a victim back, ~15% are
    pure writebacks, ~10% are pad slots (their other fields left >= 0),
    ~5% are live slots with nothing to do, and entry 0 takes the last slot
    and writes back to the last row. `cut` "fetch_only" drops every
    writeback, "writeback_only" every fetch, "pads" every slot. Returns
    (tiers, work)."""
    r, c = 2 * n + 1000, n + 500
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev)

    def rand(shape):
        return torch.rand(shape, generator=g, device=dev)

    tiers = (_at_offset(dev, (r, d), randn, offset),
             _at_offset(dev, (c, d), randn, offset), rand((r,)), rand((c,)),
             rand((c,)))
    slots = torch.randperm(c - 1, generator=g, device=dev)[:n].int()
    rows = torch.randperm(r - 1, generator=g, device=dev)[:2 * n].int()
    evict, fetch = rows[:n].clone(), rows[n:].clone()
    slots[0], evict[0] = c - 1, r - 1
    counts = rand((n,)) * 8
    u = rand((n,))
    u[0] = 0.7
    evict[u < 0.6] = -1                             # no victim
    fetch[u > 0.85] = -1                            # pure writebacks
    slots[(u > 0.2) & (u < 0.3)] = -1               # pads
    evict[(u > 0.4) & (u < 0.45)] = -1              # live, nothing to do
    fetch[(u > 0.4) & (u < 0.45)] = -1
    if cut == "fetch_only":
        evict.fill_(-1)
    elif cut == "writeback_only":
        fetch.fill_(-1)
    elif cut == "pads":
        slots.fill_(-1)
    cache_ops.check_worklist(slots, evict, fetch)
    return tiers, (slots, evict, fetch, counts)


def _exchange_held(tiers, work):
    """One launch of the exchange, bit-equal to the plain version on copies
    of the tiers."""
    want = [t.clone() for t in tiers]
    before = cache_ops.KERNEL.launches
    cache_ops.cache_exchange(*tiers, *work)
    assert cache_ops.KERNEL.launches == before + 1
    ref.cache_exchange_ref(*want, *work)
    for a, b in zip(tiers, want):
        assert torch.equal(a, b)


# The exchange walks its worklist in rounds of 8 entries on a persistent
# grid: at D = 64 half a warp moves each of two rows a step (float4), at
# D = 128 a warp one row; D = 16 and 40, and tiers 4 or 8 bytes off a
# 16-byte boundary, take the column loop. n 1, 7, 8, 9 and 17 cut the
# first rounds at their edges; 2^22 + 17 entries are more than 8 for each
# warp of the largest grid an H100 takes (four waves of 132 SMs x 16
# four-warp blocks), so every warp walks several rounds.
_EXCHANGE_CASES = (
    [(n, d, 0, "mixed") for n in (1, 7, 8, 9, 17, 5003)
     for d in (16, 40, 64, 128)]
    + [(5003, d, 0, cut) for cut in ("pads", "writeback_only", "fetch_only")
       for d in (40, 64, 128)]
    + [(5003, d, offset, "mixed") for offset in (1, 2) for d in (64, 128)]
    + [((1 << 22) + 17, d, 0, "mixed") for d in (64, 128)])


@pytest.mark.parametrize("n,d,offset,cut", _EXCHANGE_CASES)
def test_cache_exchange_kernel_bit_equal_to_plain(dev, n, d, offset, cut):
    tiers, work = _exchange_case(dev, n, d, offset, seed=n + d + offset,
                                 cut=cut)
    assert tiers[0].data_ptr() % 16 == 4 * offset
    _exchange_held(tiers, work)


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


@pytest.mark.parametrize("point", ["hash10000", "cat"])
def test_suite_step_zero_on_the_card_matches_plain(dev, point):
    """Step 0 of a section-V suite point at full width (Fig. 12's
    10,000-row tables, whose hot rows make long CSR runs; the default point
    with the concat interaction) through the kernels, held by
    `chip_smoke.checked_step` to the plain versions on the card within
    TOL_STEP: the loss, the touched rows and accumulators, the dense
    parameters and state; one launch of each of the path's kernels."""
    import sys
    from pathlib import Path

    from repro_torch.core import design_space as ds
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.launch.train import batch_to_device
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_dlrm_train_step, dlrm_init_state
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    resolve_device("cuda")
    cfg = (ds.test_suite_config(interaction="cat") if point == "cat"
           else dict(ds.sweep_fig12_hash())[point])
    ebc = EmbeddingBagCollection.build(cfg, n_shards=1,
                                       strategy="replicated")
    params = init_dlrm_params(cfg, ebc, 0, dev)
    opt = adagrad(0.01)
    state = dlrm_init_state(ebc, opt, params)
    step = build_dlrm_train_step(cfg, ebc, opt, sparse_apply="sparse")
    raw = make_dlrm_batch(cfg, 128, 0)
    batch = batch_to_device({**raw, "idx": ebc.offset_indices(raw["idx"])},
                            dev)
    before = {k.name: k.launches for k in KERNELS}
    _, _, metrics, _, n_unique = chip_smoke.checked_step(
        torch, step, params, state, batch, opt, cfg.interaction)
    launched = {k.name: k.launches - before[k.name] for k in KERNELS}
    want = {k.name: 0 for k in KERNELS}
    want.update(embedding_bag=1, fused_bag_backward_adagrad=1,
                dot_interaction=int(cfg.interaction == "dot"))
    assert launched == want
    assert np.isfinite(float(metrics["loss"])) and n_unique > 0


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


def _fetch_case(dev, n, d, offset=0, seed=0, pads=0.1):
    """A fetch worklist of n rows (repeats allowed, row 0 the table's last)
    over a capacity tier `offset` floats into its buffer, a share `pads`
    of the entries -1 (1.0: all). Returns (capacity, cap_accum, rows)."""
    r = 2 * n + 1000
    g = torch.Generator(device=dev).manual_seed(seed)
    capacity = _at_offset(
        dev, (r, d), lambda s: torch.randn(s, generator=g, device=dev),
        offset)
    cap_accum = torch.rand((r,), generator=g, device=dev)
    rows = torch.randint(0, r, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    rows[0] = r - 1
    rows[torch.rand((n,), generator=g, device=dev) < pads] = -1
    return capacity, cap_accum, rows


# The row fetch's schedule is the exchange's (rounds of 8 on a persistent
# grid; float4 pairs at D = 64, float4 rows at 128; the column loop at any
# other D or off a 16-byte boundary), every entry live: a pad stores a zero
# row and a zero accumulator.
_FETCH_CASES = (
    [(n, d, 0, 0.1) for n in (1, 7, 8, 9, 17, 5003)
     for d in (5, 6, 16, 40, 64, 128)]
    + [(5003, d, 0, 1.0) for d in (40, 64, 128)]
    + [(5003, d, offset, 0.1) for offset in (1, 2) for d in (64, 128)]
    + [((1 << 22) + 17, d, 0, 0.1) for d in (64, 128)])


@pytest.mark.parametrize("n,d,offset,pads", _FETCH_CASES)
def test_cache_fetch_kernel_bit_equal_to_plain(dev, n, d, offset, pads):
    capacity, cap_accum, rows = _fetch_case(dev, n, d, offset,
                                            seed=n + d + offset, pads=pads)
    assert capacity.data_ptr() % 16 == 4 * offset
    before = cache_ops.FETCH_KERNEL.launches
    got = cache_ops.cache_fetch(capacity, cap_accum, rows)
    assert cache_ops.FETCH_KERNEL.launches == before + 1
    want = ref.cache_fetch_ref(capacity, cap_accum, rows)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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
    assert len(KERNELS) == 12


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
    tensor-core kernel at dh 64 and 128 and the fp32 kernel at both, with
    and without the log-sum-exp store."""
    import subprocess

    from repro_torch.kernels import flash_attention
    cmd = flash_attention.KERNEL._command(tmp_path / "flash_attention.so")
    run = subprocess.run(cmd, capture_output=True, text=True)
    log = run.stdout + run.stderr
    assert run.returncode == 0, log
    entries = [line for line in log.splitlines()
               if "Compiling entry function" in line]
    assert len(entries) == 6, log
    assert all("flash_attention_kernel" in e and "sm_90a" in e
               for e in entries), log
    assert sum("flash_attention_kernel_sm90" in e for e in entries) == 2
    spills = [line for line in log.splitlines() if "spill" in line]
    assert len(spills) == 6, log
    assert all("0 bytes spill stores, 0 bytes spill loads" in line
               for line in spills), log


def test_flash_attention_bwd_builds_for_sm90a_without_spills(dev, tmp_path):
    """The backward's kernels compile for sm_90a with no spill stores or
    loads: delta at bf16 and fp32, the bf16 tensor-core dK/dV and dQ
    passes and the fp32 SIMT ones, each at dh 64 and 128. In the SASS of
    the built library both bf16 passes run on the tensor cores (HGMMA),
    and no function holds an atomic or a reduction to memory (ATOM, ATOMS,
    ATOMG, RED.; REDUX is a warp-level reduction)."""
    import os
    import re
    import subprocess

    from repro_torch.kernels import flash_attention
    from repro_torch.kernels._build import _nvcc
    lib = tmp_path / "bwd.so"
    run = subprocess.run(flash_attention.BWD_KERNEL._command(lib),
                         capture_output=True, text=True)
    log = run.stdout + run.stderr
    assert run.returncode == 0, log
    entries = [line for line in log.splitlines()
               if "Compiling entry function" in line]
    assert len(entries) == 12 and all("sm_90a" in e for e in entries), log
    for name, count in (("flash_bwd_delta_kernel", 4),
                        ("flash_bwd_dkdv_kernel_sm90", 2),
                        ("flash_bwd_dq_kernel_sm90", 2),
                        ("flash_bwd_dkdv_kernelIf", 2),
                        ("flash_bwd_dq_kernelIf", 2)):
        assert sum(name in e for e in entries) == count, (name, log)
    spills = [line for line in log.splitlines() if "spill" in line]
    assert len(spills) == 12 and all(
        "0 bytes spill stores, 0 bytes spill loads" in line
        for line in spills), log
    cuobjdump = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    code: dict[str, list[str]] = {}
    fn = None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            fn = found.group(1)
            code[fn] = []
        elif fn and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            code[fn].append(line)
    assert len(code) == 12, sorted(code)
    for fn, lines in code.items():
        atomics = [x for x in lines
                   if re.search(r"\b(ATOM|ATOMS|ATOMG)\b|\bRED\.", x)]
        assert not atomics, (fn, atomics[:4])
        hgmma = sum("HGMMA" in x for x in lines)
        if "_sm90" in fn:
            assert hgmma > 0, fn
        else:
            assert hgmma == 0, fn


def test_flash_attention_tma_encode_failure_raises_the_driver_error(dev):
    """A bf16 call whose TMA descriptor cannot be encoded (a base address
    that is not 16-byte aligned) raises with the driver's error; nothing
    falls back to the fp32 kernel or the plain version."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels._build import stream_handle
    q = torch.zeros((1, 1, 130, 64), device=dev, dtype=torch.bfloat16)
    ptr = q.data_ptr() + 2
    with pytest.raises(RuntimeError, match="driver error"):
        flash_attention.KERNEL.launch(ptr, ptr, ptr, q.data_ptr(), 0, 1,
                                      128, 64, 1, 0.125, stream_handle(dev))


def test_flash_attention_bwd_tma_encode_failure_raises_the_driver_error(
        dev):
    """The backward's twin: a bf16 call whose Q, K, V and dO cannot be
    described to TMA (base addresses 2 bytes off a 16-byte boundary)
    raises with the driver's error before anything is launched, so the
    gradients stay as they were; nothing falls back to the fp32 kernels
    or the plain version."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels._build import stream_handle
    shape = (1, 1, 130, 64)
    q = torch.zeros(shape, device=dev, dtype=torch.bfloat16)
    lse, delta = (torch.zeros((1, 1, 130), device=dev) for _ in range(2))
    grads = [torch.full(shape, 7.0, device=dev, dtype=torch.bfloat16)
             for _ in range(3)]
    ptr = q.data_ptr() + 2
    with pytest.raises(RuntimeError, match="driver error"):
        flash_attention.BWD_KERNEL.launch(
            ptr, ptr, ptr, q.data_ptr(), ptr, lse.data_ptr(),
            *(g.data_ptr() for g in grads), delta.data_ptr(), 1, 128, 64, 1,
            0.125, stream_handle(dev))
    torch.cuda.synchronize()
    assert all(bool((g == 7.0).all()) for g in grads)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,dh", [(2, 3, 64, 16), (1, 4, 256, 64),
                                      (1, 3, 203, 64), (1, 2, 37, 40),
                                      (2, 2, 130, 128), (3, 1, 1, 128)])
def test_flash_attention_lse_matches_plain(dev, b, h, s, dh, dtype):
    from repro_torch.kernels import flash_attention
    q, k, v = _qkv_on(dev, (b, h, s, dh), dtype, s + dh + 1)
    out, lse = flash_attention.flash_attention(q, k, v, with_lse=True)
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert torch.equal(out, flash_attention.flash_attention(q, k, v))
    if dtype == torch.bfloat16:
        _, want = ref.flash_attention_tiled_ref(
            q, k, v, flash_attention.block_k(dh), with_lse=True)
    else:
        _, want = ref.flash_attention_ref(q, k, v, with_lse=True)
    torch.testing.assert_close(lse, want.float(), rtol=1e-5, atol=1e-4)


#: the backward kernel against ref.flash_attention_bwd_ref, each gradient
#: as a share of its own largest plain value: fp32 1e-4, bf16 2^-7 (one
#: bf16 ulp there); and each gradient's relative L2 error within 1e-2
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}
FLASH_BWD_REL_L2 = 1e-2
#: at s = 1 dq and dk are 0 up to the fp32 rounding of dP - delta, which
#: reaches ~1e-6 of the largest of the three gradients, so their own size
#: is no scale: no gradient's scale (largest value, L2 norm) is taken
#: below this share of the largest of the three (at s > 1 each gradient's
#: own largest value is several tenths of it, so the floor does not bind)
FLASH_BWD_FLOOR = 0.1


def _assert_bwd_close(got, want, dtype):
    top = max(float(w.float().abs().max()) for w in want)
    top_norm = max(float(w.float().norm()) for w in want)
    for name, a, w in zip("qkv", got, want):
        a, w = a.float(), w.float()
        scale = max(float(w.abs().max()), FLASH_BWD_FLOOR * top)
        torch.testing.assert_close(a, w, rtol=0,
                                   atol=FLASH_BWD_TOL[dtype] * scale,
                                   msg=f"d{name}")
        norm = max(float(w.norm()), FLASH_BWD_FLOOR * top_norm)
        assert float((a - w).norm()) <= FLASH_BWD_REL_L2 * norm, f"d{name}"


def _flash_bwd_case(dev, shape, dtype, seed):
    from repro_torch.kernels import flash_attention
    q, k, v = _qkv_on(dev, shape, dtype, seed)
    out, lse = flash_attention.flash_attention(q, k, v, with_lse=True)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    do = torch.randn(shape, generator=g, device=dev).to(dtype)
    return q, k, v, out, do, lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,s,dh", [(2, 3, 64, 16), (1, 4, 256, 64),
                                      (1, 3, 203, 64), (1, 2, 37, 40),
                                      (2, 2, 130, 128), (1, 2, 65, 128),
                                      (3, 1, 1, 64), (1, 2, 300, 16),
                                      (1, 2, 333, 128), (1, 1, 1100, 128)])
def test_flash_attention_bwd_kernel_matches_plain(dev, b, h, s, dh, dtype):
    from repro_torch.kernels import flash_attention
    args = _flash_bwd_case(dev, (b, h, s, dh), dtype, s + dh)
    before = flash_attention.BWD_KERNEL.launches
    got = flash_attention.flash_attention_bwd(*args)
    assert flash_attention.BWD_KERNEL.launches == before + 1
    want = ref.flash_attention_bwd_ref(*args)
    for name, a in zip("qkv", got):
        assert a.dtype == dtype and a.shape == (b, h, s, dh), name
    _assert_bwd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_is_deterministic(dev, dtype):
    from repro_torch.kernels import flash_attention
    args = _flash_bwd_case(dev, (2, 4, 517, 64), dtype, 3)
    first = flash_attention.flash_attention_bwd(*args)
    for _ in range(3):
        again = flash_attention.flash_attention_bwd(*args)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_attention_bwd_is_causal(dev):
    """dK and dV of a key see only the queries at or after it: changing
    the queries and output gradients before position p leaves dK, dV at
    and after p as they were."""
    from repro_torch.kernels import flash_attention
    q, k, v, out, do, lse = _flash_bwd_case(dev, (1, 2, 300, 64),
                                            torch.bfloat16, 5)
    _, dk, dv = flash_attention.flash_attention_bwd(q, k, v, out, do, lse)
    p = 150
    q2, do2 = q.clone(), do.clone()
    q2[:, :, :p], do2[:, :, :p] = 3.0, -2.0
    out2, lse2 = flash_attention.flash_attention(q2, k, v, with_lse=True)
    _, dk2, dv2 = flash_attention.flash_attention_bwd(q2, k, v, out2, do2,
                                                      lse2)
    assert torch.equal(dk2[:, :, p:], dk[:, :, p:])
    assert torch.equal(dv2[:, :, p:], dv[:, :, p:])
    assert not torch.equal(dv2[:, :, :p], dv[:, :, :p])


def test_flash_attention_bwd_wrapper_raises_on_what_the_kernel_does_not_take(
        dev):
    from repro_torch.kernels import flash_attention
    q = torch.zeros((1, 2, 8, 64), device=dev)
    lse = torch.zeros((1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="causal"):
        flash_attention.flash_attention_bwd(q, q, q, q, q, lse, causal=False)
    with pytest.raises(ValueError, match="lse"):
        flash_attention.flash_attention_bwd(q, q, q, q, q, lse.double())
    with pytest.raises(ValueError):
        flash_attention.flash_attention_bwd(q, q, q, q, q.cpu(), lse)
    with pytest.raises(TypeError):
        h = q.half()
        flash_attention.flash_attention_bwd(h, h, h, h, h, lse)


def test_flash_attention_function_launches_both_kernels(dev):
    """FlashAttention on the card: one forward launch (with the
    log-sum-exp) and one backward launch, whose gradients are the bare
    backward's."""
    from repro_torch.kernels import flash_attention
    q, k, v = (t.requires_grad_() for t in _qkv_on(
        dev, (1, 4, 200, 64), torch.bfloat16, 9))
    f0, b0 = (flash_attention.KERNEL.launches,
              flash_attention.BWD_KERNEL.launches)
    out = flash_attention.FlashAttention.apply(q, k, v, True)
    do = torch.randn_like(out)
    out.backward(do)
    assert (flash_attention.KERNEL.launches - f0,
            flash_attention.BWD_KERNEL.launches - b0) == (1, 1)
    o2, lse = flash_attention.flash_attention(q.detach(), k.detach(),
                                              v.detach(), with_lse=True)
    want = flash_attention.flash_attention_bwd(
        q.detach(), k.detach(), v.detach(), o2, do, lse)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad, w)


def test_lm_gradients_reach_wq_wk_wv_on_the_card(dev):
    """The fault the backward repairs: through the forward kernel alone no
    gradient reached wq, wk or wv. Smoke stablelm-1.6b in fp32 at 32
    tokens (the flash branch, dh 16 padded to 64): every parameter's
    gradient on the card is within a relative L2 error of 1e-4 of the
    CPU's (plain attention), wq's, wk's and wv's are not zero, and a step
    launches the forward kernel twice a layer (remat="full" recomputes it)
    and the backward once."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import lm
    from repro_torch.nn.params import tree_leaves, tree_map
    resolve_device("cuda")
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                              compute_dtype="float32", remat="full")
    params = lm.init_lm_params(cfg, 0, device="cpu")
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1),
             "loss_mask": np.ones((2, 32), np.float32)}
    grads = {}
    for d in (torch.device("cpu"), dev):
        leaves = tree_map(lambda x: x.detach().to(d).requires_grad_(),
                          params)
        flash_attention.KERNEL.launches = 0
        flash_attention.BWD_KERNEL.launches = 0
        loss, _ = lm.lm_loss(leaves, batch, cfg)
        loss.backward()
        want = (2 * cfg.n_layers, cfg.n_layers) if d.type == "cuda" \
            else (0, 0)
        assert (flash_attention.KERNEL.launches,
                flash_attention.BWD_KERNEL.launches) == want
        grads[d.type] = (tree_map(lambda x: x.grad.cpu(), leaves),
                         float(loss.detach()))
    attn = grads["cuda"][0]["blocks"]["b0"]["attn"]
    for name in ("wq", "wk", "wv"):
        assert attn[name].abs().max() > 0, name
    assert abs(grads["cuda"][1] - grads["cpu"][1]) < 1e-4
    for a, b in zip(tree_leaves(grads["cuda"][0]),
                    tree_leaves(grads["cpu"][0])):
        assert float((a - b).norm() / b.norm()) < 1e-4


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


# ---------------------------------------------------------------------------
# the capacity tier in page-locked host memory, read over PCIe (UVA)
# ---------------------------------------------------------------------------


def _host_tier(capacity, cap_accum):
    """Page-locked host copies of a capacity tier."""
    from repro_torch.core import hostmem
    cap = hostmem.pinned_zeros(capacity.shape)
    acc = hostmem.pinned_zeros(cap_accum.shape)
    cap.copy_(capacity)
    acc.copy_(cap_accum)
    return cap, acc


def test_pinned_zeros_is_exact_mapped_and_released(dev):
    import gc

    from repro_torch.core import hostmem
    before = hostmem.page_locked_bytes()
    t = hostmem.pinned_zeros((1000, 64))
    assert t.shape == (1000, 64) and t.dtype == torch.float32
    assert not t.any() and t.is_pinned() and hostmem.is_page_locked(t)
    assert hostmem.is_page_locked(t[500:])
    # exactly the tensor's bytes, rounded up to one page: no power of two
    assert hostmem.page_locked_bytes() - before == 258_048
    assert not hostmem.is_page_locked(torch.zeros(4))
    assert hostmem.is_page_locked(torch.zeros(4).pin_memory())
    del t
    gc.collect()
    assert hostmem.page_locked_bytes() == before


@pytest.mark.parametrize("acc", ["host", "card"])
@pytest.mark.parametrize("d", [64, 5])
@pytest.mark.parametrize("op", ["fetch", "fetch_chunked", "commit",
                                "exchange"])
def test_cache_movers_over_a_page_locked_capacity_tier(dev, op, d, acc):
    """Each row mover with its capacity tier in page-locked host memory,
    read and written by the kernel across PCIe (cap_accum there too, or on
    the card): bit-equal to its plain version and to the same call with
    the tier on the card, and one launch."""
    r, c = 300, 40
    capacity, cache, cap_accum, cache_accum = _mover_inputs(dev, r, c, d,
                                                            d + 1)
    i32 = dict(dtype=torch.int32, device=dev)
    slots = torch.tensor([0, 3, 7, -1, 9, 39, 12, 13], **i32)
    evict = torch.tensor([100, -1, 102, 5, -1, 299, -1, 7], **i32)
    fetch = torch.tensor([200, 201, -1, -1, 202, 203, 204, 205], **i32)
    starts = torch.tensor([0, -1, r - 8, 41], **i32)
    g = torch.Generator(device=dev).manual_seed(5)
    shadow = torch.randn((8, d), generator=g, device=dev)
    shadow_accum = torch.rand((8,), generator=g, device=dev)
    freq = torch.arange(c, dtype=torch.float32, device=dev)
    seeds = torch.full((8,), 2.0, device=dev)

    def call(cap, acc, plain=False):
        cch, cch_acc = cache.clone(), cache_accum.clone()
        if op == "fetch":
            f = ref.cache_fetch_ref if plain else cache_ops.cache_fetch
            return list(f(cap, acc, fetch))
        if op == "fetch_chunked":
            f = (ref.cache_fetch_chunked_ref if plain
                 else cache_ops.cache_fetch_chunked)
            return list(f(cap, acc, starts, 8))
        if op == "commit":
            f = ref.cache_commit_ref if plain else cache_ops.cache_commit
            f(cap, cch, acc, cch_acc, shadow, shadow_accum, slots, evict,
              fetch)
        else:
            f = ref.cache_exchange_ref if plain else cache_ops.cache_exchange
            f(cap, cch, acc, cch_acc, freq.clone(), slots, evict, fetch,
              seeds)
        return [cap, cch, acc, cch_acc]

    kernel = {"fetch": cache_ops.FETCH_KERNEL,
              "fetch_chunked": cache_ops.FETCH_CHUNKED_KERNEL,
              "commit": cache_ops.COMMIT_KERNEL,
              "exchange": cache_ops.KERNEL}[op]
    host_cap, host_acc = _host_tier(capacity, cap_accum)
    if acc == "card":
        host_acc = cap_accum.clone()
    before = kernel.launches
    on_host = call(host_cap, host_acc)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    on_card = call(capacity.clone(), cap_accum.clone())
    plain = call(capacity.clone(), cap_accum.clone(), plain=True)
    for a, b, p in zip(on_host, on_card, plain):
        assert torch.equal(a.cpu(), b.cpu()) and torch.equal(a.cpu(), p.cpu())
    if op in ("fetch", "fetch_chunked"):
        assert on_host[0].is_cuda            # the slab is on the card
    else:
        assert on_host[0] is host_cap        # written in place on the host


def _pinned_copy(t, offset=0):
    """A page-locked host copy of t, `offset` floats into its buffer."""
    from repro_torch.core import hostmem
    h = hostmem.pinned_zeros((t.numel() + offset,))[offset:].view(t.shape)
    h.copy_(t)
    return h


@pytest.mark.parametrize("acc", ["host", "card"])
@pytest.mark.parametrize("n,d,offset,cut", [
    (1, 64, 0, "mixed"), (9, 64, 0, "mixed"), (17, 128, 0, "mixed"),
    (5003, 64, 0, "mixed"), (5003, 64, 0, "writeback_only"),
    (5003, 64, 0, "fetch_only"), (5003, 64, 0, "pads"),
    (5003, 40, 0, "mixed"), (5003, 64, 1, "mixed"), (20011, 64, 0, "mixed")])
@pytest.mark.parametrize("op", ["exchange", "fetch"])
def test_exchange_and_fetch_over_a_page_locked_tier_at_the_edges(
        dev, op, n, d, offset, cut, acc):
    """The exchange and the row fetch over a capacity tier in page-locked
    host memory (cap_accum there too, or on the card): worklists cut at
    the first rounds' edges, pure writebacks, pure fetches and all pads,
    D 40 and a tier off a 16-byte boundary (the column loop), and 20,011
    entries, above the host grid's warps times a round (132 SMs x 4
    blocks x 4 warps x 8 entries for the exchange, a quarter of that for
    the fetch), so that each warp takes several rounds; each one launch,
    bit-equal to the plain version on the card."""
    if op == "fetch":
        capacity, cap_accum, rows = _fetch_case(
            dev, n, d, offset, seed=n + d,
            pads={"pads": 1.0}.get(cut, 0.1))
        h_cap = _pinned_copy(capacity, offset)
        h_acc = _pinned_copy(cap_accum) if acc == "host" else cap_accum
        before = cache_ops.FETCH_KERNEL.launches
        got = cache_ops.cache_fetch(h_cap, h_acc, rows)
        torch.cuda.synchronize()
        assert cache_ops.FETCH_KERNEL.launches == before + 1
        want = ref.cache_fetch_ref(capacity, cap_accum, rows)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        return
    tiers, work = _exchange_case(dev, n, d, offset, seed=n + d, cut=cut)
    h_cap = _pinned_copy(tiers[0], offset)
    h_acc = _pinned_copy(tiers[2]) if acc == "host" else tiers[2].clone()
    on_host = [h_cap, tiers[1].clone(), h_acc, tiers[3].clone(),
               tiers[4].clone()]
    before = cache_ops.KERNEL.launches
    cache_ops.cache_exchange(*on_host, *work)
    torch.cuda.synchronize()
    assert cache_ops.KERNEL.launches == before + 1
    ref.cache_exchange_ref(*tiers, *work)
    for a, b in zip(on_host, tiers):
        assert torch.equal(a.to(b.device), b)


def test_cache_movers_refuse_pageable_host_capacity(dev):
    cap, acc = torch.zeros((8, 4)), torch.zeros(8)
    rows = torch.zeros(2, dtype=torch.int32, device=dev)
    before = cache_ops.FETCH_KERNEL.launches
    with pytest.raises(ValueError, match="page-locked host memory instead"):
        cache_ops.cache_fetch(cap, acc, rows)
    with pytest.raises(ValueError, match="one CUDA device"):
        cache_ops.cache_fetch_chunked(cap, acc, rows, 2)
    pinned_cap, pinned_acc = _host_tier(cap, acc)
    with pytest.raises(ValueError, match="one CUDA device"):
        cache_ops.cache_fetch(pinned_cap, acc, rows)      # accum pageable
    assert cache_ops.FETCH_KERNEL.launches == before
    shadow, _ = cache_ops.cache_fetch(pinned_cap, pinned_acc, rows)
    assert shadow.device == rows.device
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cache import CachedEmbeddingBagCollection
    cc = CachedEmbeddingBagCollection.build(get_smoke_config("dlrm-m1"),
                                            cache_rows=64)
    r, d = cc.ebc.plan.total_rows, cc.ebc.cfg.embed_dim
    with pytest.raises(ValueError, match="pageable"):
        cc.init_state(torch.zeros((r, d)), device=dev)
    mega, accum = _host_tier(torch.zeros((r, d)), torch.zeros(r))
    with pytest.raises(ValueError, match="accum is pageable"):
        cc.init_state(mega, torch.zeros(r), device=dev)
    st = cc.init_state(mega, device=dev)
    assert st.cache.is_cuda and st.freq.is_cuda and st.capacity is mega
    from repro_torch.core.hostmem import is_page_locked
    assert is_page_locked(st.cap_accum)


@pytest.mark.parametrize("tier_kind", ["sync", "async", "bulk_sync",
                                       "bulk_async"])
def test_cached_train_step_with_host_capacity_equals_on_card(dev,
                                                             tier_kind):
    """Four cached steps of the smoke dlrm-m1 with the capacity tier in
    page-locked host memory, against the same run with it on the card:
    losses, materialized table and accumulator, host maps and counters
    bit-equal (the movers copy; the rest runs on the card either way)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cache import CachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.tiers import (AsyncCachedTier,
                                        BulkCachedEmbeddingBagCollection)
    from repro_torch.data.pipeline import dedup_indices_hook
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import (build_cached_train_step,
                                         cached_dlrm_init_state)
    resolve_device("cuda")
    cfg = get_smoke_config("dlrm-m1")
    if tier_kind.startswith("bulk"):
        cc = BulkCachedEmbeddingBagCollection.build(
            cfg, cache_rows=256, fetch_chunk=4, dram_rows=32, bulk_chunk=16,
            bulk_latency_us=0.0)
    else:
        cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=256,
                                                fetch_chunk=4)
    hook = dedup_indices_hook(cc.ebc.plan.table_offsets)
    batches = [hook(make_dlrm_batch(cfg, 8, step=t)) for t in range(5)]
    runs = []
    for on_host in (False, True):
        params = init_dlrm_params(cfg, cc.ebc, 0, dev)
        tier = AsyncCachedTier(cc) if tier_kind.endswith("async") else cc
        mega = params.pop("emb")["mega"]
        if on_host:
            mega, _ = _host_tier(mega, torch.zeros(1, device=dev))
        cs = tier.init_state(mega, device=dev)
        opt = adagrad(0.01)
        state = cached_dlrm_init_state(cc, opt, params)
        dense = {"bottom": params["bottom"], "top": params["top"]}
        step = build_cached_train_step(cfg, tier, opt)
        losses = []
        for t in range(4):
            dense, state, m = step(dense, state, cs, batches[t], t,
                                   next_batch=batches[t + 1])
            losses.append(float(m["loss"]))
        got = tier.materialize(cs)
        assert got[0].device.type == ("cpu" if on_host else "cuda")
        runs.append((losses, got[0].cpu(), got[1].cpu(), cs))
    (l0, m0, a0, s0), (l1, m1, a1, s1) = runs
    assert l0 == l1 and torch.equal(m0, m1) and torch.equal(a0, a1)
    np.testing.assert_array_equal(s0.slot_row, s1.slot_row)
    assert s0.stats == s1.stats and s0.stats.evictions > 0
    if tier_kind.startswith("bulk"):
        assert s1.stats.bulk_hits > 0 and s1.stats.demotions > 0


def test_host_demotion_after_a_queued_writeback_reads_the_written_bits(
        dev, monkeypatch):
    """The host/device race of a host capacity tier: a demotion that must
    first queue a pending commit (its writeback hits a demotion victim)
    reads capacity on the host right after the launch. Restaging a batch
    whose rows are all resident admits nothing, so its demotion's drained
    commit is the last kernel queued before the read (no worklist upload
    in between waits for it). Each commit here waits behind ~10 ms of
    device sleep, so without `capacity_fence` the host would read the bits
    from before the writeback. The bulk store, the residency and the table
    must equal the same sequence run on the CPU, where nothing is
    asynchronous."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import hostmem
    from repro_torch.core.tiers import (AsyncCachedTier,
                                        BulkCachedEmbeddingBagCollection)
    from repro_torch.data.synthetic import make_dlrm_batch
    cfg = get_smoke_config("dlrm-m1")
    bc = BulkCachedEmbeddingBagCollection.build(
        cfg, cache_rows=256, dram_rows=4, bulk_chunk=16, bulk_latency_us=0.0)
    tier = AsyncCachedTier(bc)
    r, d = bc.ebc.plan.total_rows, cfg.embed_dim
    idx = [bc.ebc.offset_indices(make_dlrm_batch(cfg, 8, step=t)["idx"])
           for t in range(10)]
    mega = torch.from_numpy(np.random.RandomState(0).randn(r, d)
                            .astype(np.float32))
    real_commit = cache_ops.cache_commit
    real_demote = BulkCachedEmbeddingBagCollection._demote_overflow
    drained = {"in": False, "n": 0}

    def slow_commit(*args, **kw):
        drained["n"] += drained["in"]
        if args[1].is_cuda:
            torch.cuda._sleep(20_000_000)
        return real_commit(*args, **kw)

    def demote(self, *args):
        drained["in"] = True
        try:
            return real_demote(self, *args)
        finally:
            drained["in"] = False

    monkeypatch.setattr(cache_ops, "cache_commit", slow_commit)
    monkeypatch.setattr(BulkCachedEmbeddingBagCollection, "_demote_overflow",
                        demote)
    runs = []
    for on_card in (True, False):
        rng = np.random.RandomState(1)
        if on_card:
            cap = hostmem.pinned_zeros((r, d))
            cap.copy_(mega)
            st = tier.init_state(cap, device=dev)
        else:
            st = tier.init_state(mega.clone(), device="cpu")
        drained["n"] = 0
        for t in range(8):
            tier.take(st, idx[t], train=True)
            st.cache.add_(0.5)
            tier.stage(st, idx[t + 1], train=True)
            tier.stage(st, idx[t + 1], train=True)     # all resident now
            tier.prefetch_rows(st, rng.choice(r, 64, replace=False))
        runs.append((st, drained["n"]))
    (card, n_card), (cpu, n_cpu) = runs
    assert n_card == n_cpu > 0                 # the race's setting occurred
    assert card.stats == cpu.stats and card.stats.demotions > 0
    np.testing.assert_array_equal(card.dram_resident, cpu.dram_resident)
    bulk_rows = np.flatnonzero(bc.tier_residency(cpu)["bulk"])
    np.testing.assert_array_equal(card.bulk.values[bulk_rows],
                                  cpu.bulk.values[bulk_rows])
    np.testing.assert_array_equal(card.bulk.accum[bulk_rows],
                                  cpu.bulk.accum[bulk_rows])
    got, want = tier.materialize(card), tier.materialize(cpu)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    np.testing.assert_array_equal(card.bulk.values[bulk_rows],
                                  got[0].numpy()[bulk_rows])


def test_sharded_steps_on_the_card_match_the_one_device_steps(dev):
    """The mesh executors on the card: 4 gloo ranks spawned on it, each
    table handed over as a CUDA IPC view. The table-wise step on (1, 4)
    bit-equal to the one-device sparse step (the parent's table updated in
    place through the views); on (2, 2) the data replicas bit-equal and
    the whole within 1e-6; the psum dense update on (1, 4) row_wise within
    the reference's 1e-5 / 1e-4 of the one-device dense step."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.optim import adagrad
    from repro_torch.train import build_dlrm_train_step, dlrm_init_state
    from repro_torch.train.sharded import (pipeline_batches, run_calls,
                                           train_rank)
    cfg = get_smoke_config("dlrm-m1")
    runs = {"tw14": ((1, 4), "table_wise", "tablewise", cfg),
            "tw22": ((2, 2), "table_wise", "tablewise", cfg),
            "psum14": ((1, 4), "row_wise", "dense_psum",
                       dataclasses.replace(cfg, lookup_impl="psum"))}
    calls, want = [], {}
    for name, (shape, strategy, kind, c) in runs.items():
        ebc = EmbeddingBagCollection.build(c, n_shards=shape[1],
                                           strategy=strategy)
        batches = pipeline_batches(c, ebc, 4, 16, "offset")
        opt = adagrad(0.01)
        p = init_dlrm_params(c, ebc, 0, dev)
        dense = {k: [{n: t.cpu().numpy() for n, t in layer.items()}
                     for layer in p[k]] for k in ("bottom", "top")}
        table = p["emb"]["mega"].clone()
        s = dlrm_init_state(ebc, opt, p)
        step = build_dlrm_train_step(
            dataclasses.replace(c, lookup_impl="gather"), ebc, opt,
            sparse_apply="dense" if kind == "dense_psum" else "sparse")
        losses = []
        for t, b in enumerate(batches):
            p, s, m = step(p, s, {k: torch.as_tensor(v).to(dev)
                                  for k, v in b.items()}, t)
            losses.append(float(m["loss"]))
        want[name] = (losses, p["emb"]["mega"], s["accum"], table)
        calls.append((train_rank, {
            "cfg": c, "mesh": shape, "strategy": strategy, "step": kind,
            "dense": dense, "mega": table,
            "accum": torch.zeros_like(s["accum"]), "n_steps": 4,
            "batches": batches, "staged": True}))
    out = run_ranks(run_calls, 4, (calls,), backend="gloo",
                    device=f"cuda:{torch.cuda.current_device()}",
                    timeout_s=240)
    torch.cuda.synchronize()
    for i, name in enumerate(runs):
        losses, mega, accum, table = want[name]
        res = [r[i] for r in out]
        got = calls[i][1]["accum"]
        assert all(r["launches"]["embedding_bag"] == 4 for r in res)
        if name == "tw14":
            assert all(r["losses"] == losses for r in res)
            assert torch.equal(table, mega) and torch.equal(got, accum)
            assert all(r["launches"]["fused_bag_backward_adagrad_segments"]
                       == 4 for r in res)
        elif name == "tw22":
            assert all(r["replica_equal"] for r in res
                       if r["coords"]["data"] == 1)
            assert len({tuple(r["dense_sums"]) for r in res}) == 1
            np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-6)
            torch.testing.assert_close(table, mega, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(got, accum, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(res[0]["losses"], losses, rtol=1e-5)
            torch.testing.assert_close(table, mega, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(got, accum, rtol=1e-4, atol=1e-5)


def _multihost_run(cfg, batches, d, n_hosts=4, cache_rows=512, **kw):
    """The multi-host step over `batches` on device `d` from seed-0
    parameters: (losses, capacity, accumulator, dense top weights, state,
    launches a step)."""
    from repro_torch.core.cache import MultiHostCachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.nn.params import tree_map
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import (build_cached_train_step,
                                         cached_dlrm_init_state)
    mc = MultiHostCachedEmbeddingBagCollection.build(
        cfg, n_hosts=n_hosts, cache_rows=cache_rows)
    params = tree_map(lambda x: x.to(d), init_dlrm_params(
        cfg, mc.ebc, 0, torch.device("cpu")))
    opt = adagrad(0.01)
    state = cached_dlrm_init_state(mc, opt, params)
    dense = {"bottom": params["bottom"], "top": params["top"]}
    ms = mc.init_state(params["emb"]["mega"])
    step = build_cached_train_step(cfg, mc, opt, **kw)
    losses, launches = [], []
    for t, batch in enumerate(batches):
        nxt = batches[t + 1] if t + 1 < len(batches) else None
        before = {k.name: k.launches for k in KERNELS}
        dense, state, m = step(dense, state, ms, batch, t, next_batch=nxt)
        losses.append(float(m["loss"]))
        launches.append({k.name: k.launches - before[k.name]
                         for k in KERNELS if k.launches != before[k.name]})
    mega, accum = mc.materialize(ms)
    return (losses, mega.cpu(), accum.cpu(), dense["top"][0]["w"].cpu(), ms,
            launches)


@pytest.mark.parametrize("cache_rows,hook", [(512, True), (96, False)])
def test_multihost_step_on_the_card(dev, monkeypatch, cache_rows, hook):
    """Three multi-host steps of the smoke dlrm-m1 (4 hosts, batch 16; 96
    slots a host evict): with the kernels, each step launches exactly 4
    embedding_bag, 1 dot_interaction and 1 segmented update and nothing
    else, and the run is bit-equal to the uncached step on the card
    (`build_dlrm_train_step(sparse_apply="sparse")`, the same kernels);
    with the three kernels' plain versions on the card, and on the CPU,
    within rtol/atol 1e-5 (dot_interaction's FMA chain and the update's
    warp-shuffled mean(g^2) differ from the plain order by ulps, as their
    own tests allow), with the same host maps and counters."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.data.pipeline import (dedup_indices_hook,
                                           sparse_plan_hook)
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.nn.params import tree_map
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_dlrm_train_step, dlrm_init_state
    resolve_device("cuda")
    cfg = get_smoke_config("dlrm-m1")
    ebc = EmbeddingBagCollection.build(cfg, n_shards=4,
                                       strategy="cached_host",
                                       capacity_shards=4)
    offs = ebc.plan.table_offsets
    hook_fn = (sparse_plan_hook(offs, n_hosts=4) if hook
               else dedup_indices_hook(offs))
    batches = [hook_fn(make_dlrm_batch(cfg, 16, step=t)) for t in range(3)]
    kern = _multihost_run(cfg, batches, dev, cache_rows=cache_rows)
    assert kern[5] == [{"embedding_bag": 4, "dot_interaction": 1,
                        "fused_bag_backward_adagrad_segments": 1}] * 3
    if cache_rows < 512:
        assert kern[4].stats.evictions > 0
    params = tree_map(lambda x: x.to(dev), init_dlrm_params(
        cfg, ebc, 0, torch.device("cpu")))
    state = dlrm_init_state(ebc, adagrad(0.01), params)
    step = build_dlrm_train_step(cfg, ebc, adagrad(0.01),
                                 sparse_apply="sparse")
    losses = []
    for t, b in enumerate(batches):
        tb = {k: torch.as_tensor(b[k]).to(dev)
              for k in ("dense", "idx", "label")}
        params, state, m = step(params, state, tb, t)
        losses.append(float(m["loss"]))
    assert kern[0] == losses
    assert torch.equal(kern[1], params["emb"]["mega"].cpu())
    assert torch.equal(kern[2], state["accum"].cpu())
    assert torch.equal(kern[3], params["top"][0]["w"].cpu())
    cpu = _multihost_run(cfg, batches, torch.device("cpu"),
                         cache_rows=cache_rows)
    monkeypatch.setattr(ops._bag, "embedding_bag", ref.embedding_bag_ref)
    monkeypatch.setattr(ops._dot, "dot_interaction", ref.dot_interaction_ref)
    monkeypatch.setattr(ops._upd, "fused_bag_backward_adagrad_segments",
                        ref.fused_bag_backward_adagrad_segments_ref)
    plain = _multihost_run(cfg, batches, dev, cache_rows=cache_rows)
    assert plain[5] == [{}] * 3
    for other in (plain, cpu):
        np.testing.assert_allclose(other[0], kern[0], rtol=1e-5, atol=1e-5)
        for a, b in zip(other[1:4], kern[1:4]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        for k in ("freq", "slot_row", "row_slot", "ema", "ema_tick"):
            np.testing.assert_array_equal(getattr(other[4], k),
                                          getattr(kern[4], k))
        assert other[4].stats == kern[4].stats
        assert other[4].route == kern[4].route


def test_multihost_fill_slabs_on_the_card_equals_the_cpu(dev):
    """`fill_slabs` on the card (one pinned upload of the live entries,
    index_select / index_copy_ on each host's slab) equals its CPU
    result bit for bit; -1 slots are dropped; the mesh form raises."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.cache import MultiHostCachedEmbeddingBagCollection
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_cached_train_step
    resolve_device("cuda")
    cfg = get_smoke_config("dlrm-m1")
    mc = MultiHostCachedEmbeddingBagCollection.build(cfg, n_hosts=4,
                                                     cache_rows=64)
    rng = np.random.RandomState(7)
    total = mc.ebc.plan.total_rows
    source = torch.from_numpy(rng.randn(total, 16).astype(np.float32))
    rows = np.full((4, 40), -1, np.int32)
    slots = np.full((4, 40), -1, np.int32)
    for h, n in enumerate((40, 17, 0, 1)):
        rows[h, :n] = rng.choice(total, n, replace=False)
        slots[h, :n] = rng.choice(64, n, replace=False)
    base = torch.from_numpy(rng.randn(4, 64, 16).astype(np.float32))
    want = mc.fill_slabs(base.clone(), source, rows, slots)
    got = mc.fill_slabs(base.to(dev), source.to(dev), rows, slots)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want[2], base[2])       # a host with no entries
    with pytest.raises(NotImplementedError, match="later slice"):
        build_cached_train_step(cfg, mc, adagrad(0.01), mesh=object())


def _zoo_cfg(name, **kw):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(name), **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_prefill_through_the_kernel_matches_plain_attention(dev, dtype):
    """granite-moe-3b-a800m's smoke config widened to dh 64 with GQA 8/4
    (4 real and 8 padded experts), 512 tokens: prefill_step through the
    flash-attention kernel (one launch a layer) against the same prefill
    with attn_block_q = 512 (full_attention, no launch), and against the
    CPU's. Last logits: fp32 within a relative L2 error of 1e-4 (the
    kernel's fp32 attention differs from the scores' softmax in summation
    order only); bf16 within 5e-2, chip_smoke's 9c bound (the two paths
    round at other places), and the same argmax."""
    from repro_torch.kernels import flash_attention
    from repro_torch.models import lm
    cfg = _zoo_cfg("granite-moe-3b-a800m", compute_dtype=dtype, d_model=512,
                   n_heads=8, n_kv_heads=4, d_head=64, attn_block_q=128,
                   attn_block_k=128)
    plain_cfg = _zoo_cfg("granite-moe-3b-a800m", compute_dtype=dtype,
                         d_model=512, n_heads=8, n_kv_heads=4, d_head=64,
                         attn_block_q=512, attn_block_k=512)
    params = lm.init_lm_params(cfg, 0, device=dev)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, size=(1, 512))).to(dev)
    out = {}
    for name, c, d in (("kernel", cfg, dev), ("plain", plain_cfg, dev),
                       ("cpu", plain_cfg, torch.device("cpu"))):
        p = params if d == dev else _tree_to(params, d)
        caches = lm.init_caches(c, 1, 520, device=d)
        flash_attention.KERNEL.launches = 0
        last, _ = lm.prefill_step(p, {"tokens": toks.to(d)}, caches, c)
        want = cfg.n_layers if name == "kernel" else 0
        assert flash_attention.KERNEL.launches == want, name
        out[name] = last.float().cpu()
    tol = 1e-4 if dtype == "float32" else 5e-2
    for other in ("plain", "cpu"):
        rel = float((out["kernel"] - out[other]).norm() / out[other].norm())
        assert rel < tol, (other, rel)
        assert int(out["kernel"].argmax()) == int(out[other].argmax())


def _tree_to(tree, device):
    from repro_torch.nn.params import tree_map
    return tree_map(lambda t: t.to(device), tree)


def _fp32_conv(caches):
    """`caches` with each mixer's bf16 conv cache swapped for fp32 zeros of
    its shape (the decode rounds each conv input to the cache's dtype)."""
    for c in caches.values():
        if "conv" in c:
            c["conv"] = torch.zeros_like(c["conv"], dtype=torch.float32)
    return caches


def test_mamba2_recurrence_matches_the_chunked_scan_on_the_card(dev):
    """mamba2-780m's smoke config widened to d_model 256, state 64, chunk
    64 and 8 layers, fp32 compute with an fp32 conv cache: prefill 448
    tokens, then decode 64 one at a time; the last logits against the
    one-shot 512-token prefill's within a relative L2 error of 1e-4 (the
    same sums in another order; 48 layers of the bf16 conv cache would
    move them by tenths), and the card's one-shot against the CPU's within
    1e-4. No kernel is launched."""
    from repro_torch.kernels import KERNELS
    from repro_torch.models import lm
    cfg = _zoo_cfg("mamba2-780m", compute_dtype="float32", d_model=256,
                   ssm_state=64, ssm_chunk=64, n_layers=8)
    params = lm.init_lm_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, size=(1, 512)))
    for k in KERNELS:
        k.launches = 0
    one = {}
    for d in (torch.device("cpu"), dev):
        caches = _fp32_conv(lm.init_caches(cfg, 1, 520, device=d))
        one[d.type], _ = lm.prefill_step(_tree_to(params, d),
                                         {"tokens": toks.to(d)}, caches, cfg)
    p = _tree_to(params, dev)
    caches = _fp32_conv(lm.init_caches(cfg, 1, 520, device=dev))
    lm.prefill_step(p, {"tokens": toks[:, :448].to(dev)}, caches, cfg)
    for t in range(448, 512):
        last, _ = lm.decode_step(p, toks[:, t:t + 1].to(dev), caches, t, cfg)
    assert all(k.launches == 0 for k in KERNELS)
    want = one["cuda"].cpu()
    assert float((last.cpu() - want).norm() / want.norm()) < 1e-4
    assert float((want - one["cpu"]).norm() / one["cpu"].norm()) < 1e-4


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b"])
def test_engine_resets_a_reused_slots_state_on_the_card(dev, arch):
    """2 slots, 5 requests, fp32 compute on the card: every slot is reused
    and each request's greedy tokens equal the same request served alone
    by a fresh one-slot engine (the reset of a slot's Mamba-2 state when
    a request takes it)."""
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeEngine
    cfg = _zoo_cfg(arch, compute_dtype="float32")
    params = lm.init_lm_params(cfg, 11, device=dev)
    rng = np.random.RandomState(10)
    reqs = [(rng.randint(0, 256, size=(rng.randint(3, 13),)).astype(
        np.int32), int(rng.randint(4, 8))) for _ in range(5)]
    eng = ServeEngine(params, cfg, batch_slots=2, max_len=32)
    assert eng.caches["b0"]["ssm"].device.type == "cuda"
    for uid, (prompt, new) in enumerate(reqs):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=new))
    got = eng.run_until_drained(max_steps=200)
    for uid, (prompt, new) in enumerate(reqs):
        alone = ServeEngine(params, cfg, batch_slots=1, max_len=32)
        alone.submit(Request(uid=0, prompt=prompt, max_new_tokens=new))
        assert got[uid] == alone.run_until_drained(max_steps=100)[0], uid


ZOO_TRAIN = ["granite-moe-1b-a400m", "mamba2-780m", "jamba-v0.1-52b",
             "musicgen-large", "internvl2-26b"]


def _zoo_train(arch, dev, cfg, steps: int):
    """`steps` steps of build_lm_train_step (adamw(1e-3), clip 1.0) from
    init_lm_params(seed 0) on make_lm_batch's batches of 2 x 256 on `dev`.
    Returns the (loss, aux) of each step, the parameters after them and
    the attention kernels' launches."""
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.kernels import flash_attention
    from repro_torch.models import lm
    from repro_torch.nn.params import tree_leaves
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_lm_train_step
    params = lm.init_lm_params(cfg, 0, device=dev)
    opt = adamw(1e-3)
    state = opt.init(params)
    step = build_lm_train_step(cfg, opt)
    flash_attention.KERNEL.launches = flash_attention.BWD_KERNEL.launches = 0
    metrics = []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in make_lm_batch(cfg, 2, 256, i, 0).items()}
        params, state, m = step(params, state, batch, i)
        metrics.append((float(m["loss"]), float(m["aux"])))
    return metrics, tree_leaves(params), (flash_attention.KERNEL.launches,
                                          flash_attention.BWD_KERNEL.launches)


@pytest.mark.parametrize("arch", ZOO_TRAIN)
def test_zoo_train_steps_are_bit_repeatable_on_the_card(dev, arch):
    """The smoke config at 256 positions (past attn_block_q 128: both
    attention kernels), bf16 compute, two adamw steps: run twice under
    remat "full" and once under "none", the losses, aux losses and every
    parameter after the steps are the same bits (no float atomics in the
    MoE's count and combine, the dispatch's gradient, the SSD scan or the
    kernels). The attention layers launch the forward kernel twice a
    layer a step under "full" (the recompute), once under "none"."""
    runs = {}
    for name, remat in (("full", "full"), ("again", "full"),
                        ("none", "none")):
        cfg = _zoo_cfg(arch, remat=remat, attn_block_q=128,
                       attn_block_k=128)
        runs[name] = _zoo_train(arch, dev, cfg, 2)
    n = cfg.pattern.count("a") * cfg.n_units
    assert runs["full"][2] == (2 * 2 * n, 2 * n)
    assert runs["none"][2] == (2 * n, 2 * n)
    assert all(np.isfinite(m).all() for m in runs["full"][0])
    for name in ("again", "none"):
        assert runs[name][0] == runs["full"][0], name
        for a, b in zip(runs[name][1], runs["full"][1]):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("arch", ZOO_TRAIN)
def test_zoo_step0_on_the_card_matches_the_cpu(dev, arch):
    """fp32 compute, the smoke config at 256 positions: step 0's loss, aux
    loss and every gradient through the kernels on the card against the
    plain versions on the CPU, from the same parameters: the loss within
    1e-5 and each gradient within a relative L2 error of 1e-4 (the same
    fp32 arithmetic in other orders, as the CPU parity tests hold the
    port to the reference)."""
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models import lm
    from repro_torch.nn.params import tree_leaves, tree_map
    cfg = _zoo_cfg(arch, compute_dtype="float32", remat="full",
                   attn_block_q=128, attn_block_k=128)
    params = lm.init_lm_params(cfg, 0, device="cpu")
    raw = make_lm_batch(cfg, 2, 256, 0, 0)
    out = []
    for d in (torch.device("cpu"), dev):
        leaves = tree_map(lambda t: t.to(d).requires_grad_(), params)
        loss, parts = lm.lm_loss(leaves, {k: torch.from_numpy(v).to(d)
                                          for k, v in raw.items()}, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(leaves),
                                    materialize_grads=True)
        out.append((float(loss), float(parts["aux"]),
                    [g.cpu() for g in grads]))
    (cpu_loss, cpu_aux, cpu_grads), (loss, aux, grads) = out
    np.testing.assert_allclose([loss, aux], [cpu_loss, cpu_aux], rtol=1e-5,
                               atol=1e-5)
    for g, w in zip(grads, cpu_grads):
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert rel < 1e-4, rel
