"""The port's CUDA kernels held against their plain PyTorch versions on an
NVIDIA GPU, at small shapes. Every test skips without a card; on the card
run them with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda.py

(`--noconftest` because the suite's conftest imports jax, which the GPU
machine does not have; this file imports only torch, numpy and the port).
Tolerances: embedding_bag walks each bag in the plain version's order and
cache_exchange only copies, so both must be bit-equal; dot_interaction's
fp32 FMA chain differs from cuBLAS's order, so it gets rtol/atol 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import (KERNELS, cache_ops, dot_interaction,
                                 embedding_bag, ref)

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


def test_every_kernel_builds_for_hopper(dev):
    from repro_torch.kernels import build_all
    build_all(list(KERNELS))
    for k in KERNELS:
        assert k.library.exists()
