"""The port's CheckpointManager on the CPU: the reference's checkpoint
tests (tests/test_train_runtime.py) on trees of torch tensors, restore in
place, bf16 stored as its uint16 bits, and bundles written by either
package restored bit-equal by the other. Everything here is exact: a
checkpoint moves bits, CRC-32s are integers.
"""
import json
import os
import shutil
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as jckpt
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.checkpoint import (CheckpointCorruptionError,
                                          CheckpointManager,
                                          flatten_with_paths)
from repro_torch.train.fault_tolerance import FaultInjector, FaultSpec


def _tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": torch.from_numpy(rng.randn(4, 3).astype(np.float32)),
            "b": {"c": torch.from_numpy(rng.randn(7).astype(np.float32))
                  .to(torch.bfloat16),
                  "d": torch.tensor(5, dtype=torch.int32)}}


def _zeros_like(tree):
    return {"a": torch.zeros_like(tree["a"]),
            "b": {"c": torch.zeros_like(tree["b"]["c"]),
                  "d": torch.zeros_like(tree["b"]["d"])}}


def _leaves(tree):
    return flatten_with_paths(tree)[1]


def _assert_equal(got, want):
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(3, tree)
    example = _zeros_like(tree)
    out = mgr.restore(example)
    _assert_equal(out, tree)
    assert out["a"] is example["a"]                 # restored in place
    assert mgr.latest_step() == 3 and mgr.last_restored_step == 3


def test_checkpoint_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for step in (1, 2, 3, 4):
        mgr.save(step, tree, async_=True)
    mgr.wait()
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_000000003", "step_000000004"]
    assert mgr.latest_step() == 4


def test_async_save_snapshots_before_returning(tmp_path):
    """The step updates the table in place: what is saved is the table as
    it was when save() returned, even for a CPU tensor."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = {"a": tree["a"].clone(), "b": tree["b"]}
    mgr.save(1, tree, async_=True)
    tree["a"].add_(1.0)
    mgr.wait()
    _assert_equal(mgr.restore(_zeros_like(tree)), want)


def test_checkpoint_gc_keep_zero_deletes_everything(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=0)
    for step in (1, 2):
        mgr.save(step, _tree())
    assert [d for d in os.listdir(tmp_path) if d.startswith("step_")] == []
    assert mgr.latest_step() is None


def test_checkpoint_latest_survives_gced_pointer(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for step in (1, 2, 3):
        mgr.save(step, tree)
    assert mgr.latest_step() == 3
    shutil.rmtree(tmp_path / "step_000000003")   # an external GC
    assert mgr.latest_step() == 2
    _assert_equal(mgr.restore(_zeros_like(tree), step=mgr.latest_step()),
                  tree)


def test_checkpoint_no_partial_visibility(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.zeros(2)})
    os.makedirs(tmp_path / "step_000000007.tmp")   # a save cut short
    assert mgr.latest_step() is None and mgr.saved_steps() == []
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": torch.zeros(2)})


def test_checkpoint_resave_same_step_overwrites(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    ones = {"a": torch.ones_like(tree["a"]),
            "b": {"c": torch.ones_like(tree["b"]["c"]),
                  "d": torch.ones_like(tree["b"]["d"])}}
    mgr.save(1, ones)
    _assert_equal(mgr.restore(_zeros_like(tree), step=1), ones)


def test_checkpoint_async_save_error_surfaces_on_wait(tmp_path):
    inj = FaultInjector([FaultSpec("checkpoint.write", 0, "error")])
    mgr = CheckpointManager(str(tmp_path), injector=inj)
    mgr.save(1, _tree(), async_=True)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    mgr.save(2, _tree())
    assert mgr.latest_step() == 2


def test_checkpoint_async_save_error_surfaces_on_next_save(tmp_path):
    inj = FaultInjector([FaultSpec("checkpoint.write", 0, "error")])
    mgr = CheckpointManager(str(tmp_path), injector=inj)
    mgr.save(1, _tree(), async_=True)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.save(2, _tree())


def test_torn_leaf_falls_back_and_an_explicit_step_is_strict(tmp_path):
    inj = FaultInjector([FaultSpec("checkpoint.write", 1, "torn", arg=1)])
    mgr = CheckpointManager(str(tmp_path), injector=inj)
    first, second = _tree(0), _tree(1)
    mgr.save(1, first)
    mgr.save(2, second)                              # leaf 1 torn
    assert mgr.latest_step() == 2
    _assert_equal(mgr.restore(_zeros_like(first)), first)
    assert mgr.last_restored_step == 1
    with pytest.raises(CheckpointCorruptionError, match="CRC"):
        mgr.restore(_zeros_like(first), step=2)
    shutil.rmtree(tmp_path / "step_000000001")
    with pytest.raises(CheckpointCorruptionError, match="no intact"):
        mgr.restore(_zeros_like(first))


def test_structure_shape_and_dtype_mismatches_raise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    with pytest.raises(ValueError, match="structure mismatch"):
        mgr.restore({"a": torch.zeros(4, 3)})
    bad = _zeros_like(tree)
    bad["a"] = torch.zeros(3, 4)
    with pytest.raises(ValueError, match=r"\(4, 3\)"):
        mgr.restore(bad)
    bad = _zeros_like(tree)
    bad["b"]["c"] = torch.zeros(7)
    with pytest.raises(ValueError, match="bfloat16"):
        mgr.restore(bad)
    with pytest.raises(NotImplementedError, match="multi-device"):
        mgr.restore(_zeros_like(tree), shardings={"a": None})


def test_bf16_is_stored_as_its_uint16_bits(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    d = tmp_path / "step_000000001"
    manifest = json.loads((d / "manifest.json").read_text())
    entry = next(e for e in manifest["leaves"] if e["path"] == "b/c")
    assert entry["dtype"] == "bfloat16" and entry["shape"] == [7]
    stored = np.load(d / entry["file"])
    assert stored.dtype == np.uint16
    np.testing.assert_array_equal(
        stored.view(np.int16), tree["b"]["c"].view(torch.int16).numpy())
    assert entry["crc32"] == zlib.crc32(stored.tobytes())


def test_chunked_restore_and_crc_across_many_chunks(tmp_path, monkeypatch):
    """A leaf is verified and copied chunk by chunk: with 64-byte chunks a
    (37, 5) table and a bf16 vector take many, and the CRC equals the
    reference's whole-array CRC."""
    monkeypatch.setattr(ckpt, "_CHUNK_BYTES", 64)
    rng = np.random.RandomState(4)
    tree = {"t": torch.from_numpy(rng.randn(37, 5).astype(np.float32)),
            "h": torch.from_numpy(rng.randn(61).astype(np.float32))
            .to(torch.bfloat16),
            "n": np.arange(23, dtype=np.int64)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(2, tree)
    example = {"t": torch.zeros(37, 5), "h": torch.zeros(61,
                                                         dtype=torch.bfloat16),
               "n": np.zeros(23, np.int64)}
    out = mgr.restore(example)
    assert torch.equal(out["t"], tree["t"]) and torch.equal(out["h"],
                                                            tree["h"])
    np.testing.assert_array_equal(out["n"], tree["n"])
    for arr in (tree["t"].numpy(), tree["n"], np.ones((0, 3), np.float32),
                np.asarray(True), np.arange(5, dtype=np.int32)[::2]):
        assert ckpt._crc32(arr) == jckpt._crc32(arr)


def test_leaf_paths_follow_the_reference_flatten_order():
    tree = {"z": [np.zeros(1), (np.ones(2), None)],
            "a": {"y": np.ones(3), "b": np.int64(4)}, "m": None, "k": []}
    paths, leaves = flatten_with_paths(tree)
    jpaths, jleaves, _ = jckpt._flatten_with_paths(tree)
    assert paths == jpaths
    assert all(a is b for a, b in zip(leaves, jleaves, strict=True))

# ---------------------------------------------------------------------------
# cross-restore: a bundle written by either package restores in the other
# ---------------------------------------------------------------------------


def _bundle_np(seed=7):
    """A launcher-shaped bundle of numpy leaves: DLRM params and optimizer
    state, a bf16 leaf (uint16 bits), an int cursor."""
    rng = np.random.RandomState(seed)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {"params": {"bottom": [{"w": f32(5, 4), "b": f32(4)}],
                       "top": [{"w": f32(7, 1), "b": f32(1)}],
                       "emb": {"mega": f32(40, 4)}},
            "state": {"dense": {"bottom": [{"w": f32(5, 4), "b": f32(4)}],
                                "top": [{"w": f32(7, 1), "b": f32(1)}]},
                      "accum": np.abs(f32(40))},
            "half": rng.randint(0, 2 ** 15, size=(9,)).astype(np.uint16),
            "cursor": np.int64(12)}


def _as_jax(tree):
    out = jax.tree.map(jnp.asarray, {k: v for k, v in tree.items()
                                     if k not in ("half", "cursor")})
    import ml_dtypes
    out["half"] = jnp.asarray(tree["half"].view(ml_dtypes.bfloat16))
    out["cursor"] = tree["cursor"]
    return out


def _as_torch(tree):
    out = jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                       {k: v for k, v in tree.items()
                        if k not in ("half", "cursor")})
    out["half"] = torch.from_numpy(tree["half"].view(np.int16)).view(
        torch.bfloat16)
    out["cursor"] = tree["cursor"]
    return out


def _manifest(d):
    return json.loads((d / "step_000000005" / "manifest.json").read_text())


def test_a_reference_checkpoint_restores_bit_equal_in_the_port(tmp_path):
    want = _bundle_np()
    jckpt.CheckpointManager(str(tmp_path / "j")).save(5, _as_jax(want))
    example = jax.tree.map(lambda x: torch.zeros(np.shape(x), dtype=torch.float32),
                           {k: v for k, v in want.items()
                            if k not in ("half", "cursor")})
    example["half"] = torch.zeros(9, dtype=torch.bfloat16)
    example["cursor"] = np.int64(0)
    out = CheckpointManager(str(tmp_path / "j")).restore(example)
    assert int(out["cursor"]) == 12
    np.testing.assert_array_equal(out["half"].view(torch.int16).numpy(),
                                  want["half"].view(np.int16))
    for a, b in zip(_leaves({k: v for k, v in out.items()
                             if k not in ("half", "cursor")}),
                    _leaves({k: v for k, v in want.items()
                             if k not in ("half", "cursor")}), strict=True):
        np.testing.assert_array_equal(a.numpy(), b)
    CheckpointManager(str(tmp_path / "t")).save(5, _as_torch(want))
    assert _manifest(tmp_path / "t") == _manifest(tmp_path / "j")


def test_a_port_checkpoint_restores_bit_equal_in_the_reference(tmp_path):
    want = _bundle_np(8)
    CheckpointManager(str(tmp_path)).save(5, _as_torch(want))
    jt = _as_jax(want)
    out = jckpt.CheckpointManager(str(tmp_path)).restore(
        jax.tree.map(jnp.zeros_like, jt))
    assert int(out.pop("cursor")) == int(jt.pop("cursor")) == 12
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(jt), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
