"""Parity of the port's plain kernel versions (repro_torch.kernels.ref and
the CPU dispatch of its wrappers) with the reference package: its jnp
oracles (repro.kernels.ref) and its Pallas kernel bodies run in interpret
mode, as the reference's own tests run them on the CPU.

Tolerances: pooled sums and dot products agree within rtol 1e-5 / atol
1e-6 (fp32, different summation order); the cache exchange only moves
values and lfu_touch is one multiply and one add per slot, so both must be
bit-equal. The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cache_ops as jcache_ops
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import cache_ops, ops, ref
from repro_torch.kernels._build import NVCC_FLAGS

TOL = {"rtol": 1e-5, "atol": 1e-6}


def _bag_inputs(seed, h, d, b, lk):
    rng = np.random.RandomState(seed)
    table = rng.randn(h, d).astype(np.float32)
    idx = rng.randint(-1, h, size=(b, lk)).astype(np.int32)
    idx[0] = -1                                  # an all-pad bag
    idx[-1, lk // 2:] = -1                       # trailing pads
    return table, idx


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("h,d,b,lk", [(64, 8, 4, 3), (97, 48, 16, 7),
                                      (300, 64, 12, 32), (200, 64, 9, 40)])
def test_embedding_bag_plain_matches_reference(h, d, b, lk, mode):
    table, idx = _bag_inputs(h + lk, h, d, b, lk)
    got = ref.embedding_bag_ref(torch.from_numpy(table),
                                torch.from_numpy(idx), mode).numpy()
    want = np.asarray(jref.embedding_bag_ref(jnp.asarray(table),
                                             jnp.asarray(idx), mode))
    np.testing.assert_allclose(got, want, **TOL)
    kern = np.asarray(jops.embedding_bag(jnp.asarray(table),
                                         jnp.asarray(idx), mode, None, True))
    np.testing.assert_allclose(got, kern, **TOL)
    assert not got[0].any()                      # all-pad bag pools to 0


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_cpu_dispatch_is_the_plain_version(mode):
    table, idx = _bag_inputs(3, 50, 16, 6, 5)
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    assert torch.equal(ops.embedding_bag(t, i, mode),
                       ref.embedding_bag_ref(t, i, mode))


def test_embedding_bag_wrapper_rejects_bad_input():
    t = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        ops.embedding_bag(t, torch.zeros((2, 3), dtype=torch.int32), "max")
    with pytest.raises(ValueError):
        ops.embedding_bag(t, torch.zeros((6,), dtype=torch.int32))


@pytest.mark.parametrize("b,f,d", [(8, 7, 16), (16, 31, 64), (4, 14, 64),
                                   (2, 128, 64)])
def test_dot_interaction_plain_matches_reference(b, f, d):
    z = np.random.RandomState(f).randn(b, f, d).astype(np.float32)
    got = ops.dot_interaction(torch.from_numpy(z)).numpy()
    assert got.shape == (b, f * (f - 1) // 2)
    want = np.asarray(jref.dot_interaction_ref(jnp.asarray(z)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    kern = np.asarray(jops.dot_interaction(jnp.asarray(z), 4, None, True))
    np.testing.assert_allclose(got, kern, rtol=1e-5, atol=1e-5)


def test_dot_interaction_packs_in_tril_order():
    z = torch.from_numpy(np.random.RandomState(0).randn(2, 5, 3)
                         .astype(np.float32))
    out = ref.dot_interaction_ref(z)
    rows, cols = np.tril_indices(5, -1)
    for p, (i, j) in enumerate(zip(rows, cols)):
        assert torch.allclose(out[:, p], (z[:, i] * z[:, j]).sum(-1),
                              rtol=1e-6, atol=1e-6)


def test_dot_interaction_backward_reuses_its_tril_indices():
    """The backward's scatter indices are built once per (F, device) and
    are np.tril_indices(F, -1); the gradient is the plain version's."""
    z = torch.from_numpy(np.random.RandomState(9).randn(3, 6, 4)
                         .astype(np.float32))
    rows, cols = np.tril_indices(6, -1)
    first = ops._tril(6, z.device)
    assert ops._tril(6, z.device) is first
    np.testing.assert_array_equal(first.numpy(), np.stack([rows, cols]))
    g = torch.from_numpy(np.random.RandomState(10).randn(3, 15)
                         .astype(np.float32))
    zk = z.clone().requires_grad_()
    ops.dot_interaction(zk).backward(g)
    zp = z.clone().requires_grad_()
    ref.dot_interaction_ref(zp).backward(g)
    torch.testing.assert_close(zk.grad, zp.grad, rtol=1e-6, atol=1e-6)


def test_lfu_touch_bit_equal_to_reference():
    rng = np.random.RandomState(7)
    c = 257
    freq = (rng.rand(c) * 50).astype(np.float32)
    slots = rng.permutation(c)[:90].astype(np.int32)
    slots[::7] = -1                               # dropped entries
    counts = rng.randint(1, 9, size=90).astype(np.float32)
    for decay in (0.98, 0.8):
        want = np.asarray(jcache_ops.lfu_touch(
            jnp.asarray(freq), jnp.asarray(slots), jnp.asarray(counts),
            decay=decay))
        got = cache_ops.lfu_touch(torch.from_numpy(freq.copy()),
                                  torch.from_numpy(slots),
                                  torch.from_numpy(counts), decay=decay)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jref.lfu_touch_ref(
                jnp.asarray(freq), jnp.asarray(slots), jnp.asarray(counts),
                decay)))


def _exchange_inputs(seed, r=60, c=12, d=48, n=8):
    rng = np.random.RandomState(seed)
    tiers = [rng.randn(r, d).astype(np.float32),
             rng.randn(c, d).astype(np.float32),
             rng.rand(r).astype(np.float32), rng.rand(c).astype(np.float32),
             rng.rand(c).astype(np.float32)]
    slots = rng.permutation(c)[:n].astype(np.int32)
    rows = rng.permutation(r)[:2 * n].astype(np.int32)
    fetch, evict = rows[:n].copy(), rows[n:].copy()
    evict[::2] = -1                               # clean victims
    fetch[3] = -1                                 # a pure writeback
    slots[5] = evict[5] = fetch[5] = -1           # a pad entry
    counts = rng.randint(0, 6, size=n).astype(np.float32)
    return tiers, [slots, evict, fetch, counts]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cache_exchange_plain_bit_equal_to_reference(seed):
    tiers, work = _exchange_inputs(seed)
    want = jref.cache_exchange_ref(*map(jnp.asarray, tiers + work))
    kern = jcache_ops.cache_exchange(*map(jnp.asarray, tiers + work),
                                     interpret=True)
    t_tiers = [torch.from_numpy(x.copy()) for x in tiers]
    t_work = [torch.from_numpy(x) for x in work]
    cache_ops.check_worklist(*t_work[:3])
    cache_ops.cache_exchange(*t_tiers, *t_work)   # CPU -> plain, in place
    for got, w, k in zip(t_tiers, want, kern):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(k))


def test_check_worklist_rejects_racing_entries():
    s = torch.tensor([0, 1, 1], dtype=torch.int32)
    none = torch.full((3,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="repeats a cache slot"):
        cache_ops.check_worklist(s, none, none)
    s = torch.tensor([0, 1, 2], dtype=torch.int32)
    ev = torch.tensor([5, -1, -1], dtype=torch.int32)
    ft = torch.tensor([-1, 5, -1], dtype=torch.int32)
    with pytest.raises(ValueError, match="same capacity row"):
        cache_ops.check_worklist(s, ev, ft)
    cache_ops.check_worklist(s, ev, torch.tensor([-1, 6, 7],
                                                 dtype=torch.int32))


def test_kernels_target_hopper_and_build_lazily():
    from repro_torch.kernels import KERNELS
    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    for k in KERNELS:
        assert k.source.exists(), k.source
        assert k._fn is None                      # nothing built at import
        assert k.library.parent.name == "kernels"
        text = k.source.read_text()
        # the attention backward is the one kernel without a TPU
        # counterpart (the reference differentiates by XLA autodiff), and
        # its note says so
        note = ("Replaces no TPU kernel" if k.name == "flash_attention_bwd"
                else "Replaces the TPU kernel")
        assert note in text and "Bound on the H100" in text


@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_bwd"])
def test_library_path_follows_the_shared_headers(tmp_path, name):
    """Both attention sources include `csrc/sm90.cuh`: a library's path
    hashes the headers beside its source as well as the source, so an
    edited header gives a new path (a rebuild) rather than a stale
    library, and the same bytes give the same path wherever they lie."""
    import shutil

    from repro_torch.kernels import KERNELS
    from repro_torch.kernels._build import CSRC
    kernel = next(k for k in KERNELS if k.name == name)
    assert '#include "sm90.cuh"' in kernel.source.read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    copy = type(kernel)(kernel.name, kernel.symbol, kernel.argtypes)
    copy.source = csrc / kernel.source.name
    assert copy.library == kernel.library
    header = csrc / "sm90.cuh"
    text = header.read_bytes()
    header.write_bytes(text + b"// edited\n")
    edited = copy.library
    assert edited != kernel.library and edited.parent == kernel.library.parent
    header.write_bytes(text)
    assert copy.library == kernel.library
    (csrc / "extra.cuh").write_text("// a second header\n")
    assert copy.library != kernel.library
