"""Manifest-based checkpoints with per-leaf CRCs, atomic publish, async
writes and newest-intact restore, in the reference's on-disk format.

Layout:  <dir>/step_000123/
            manifest.json     {"step", "leaves": [{path, file, shape,
                              dtype, crc32}, ...]}
            leaf_00000.npy    one file per leaf
         <dir>/LATEST         pointer to the newest published step

Leaves are named and ordered as the reference's `tree_flatten_with_path`
orders them (dict keys sorted, sequence indices, None dropped), and bf16
is stored as its uint16 bits with "bfloat16" in the manifest, so a
checkpoint written by either package restores in the other, bit for bit.

Contract, as the reference's:
  * save() is atomic: a step directory becomes visible only after every
    leaf and the manifest are on disk, through `os.replace`; LATEST is
    replaced the same way after it;
  * every leaf carries a CRC-32 of its stored bytes, and restore()
    verifies it, so a torn or bit-flipped leaf raises
    CheckpointCorruptionError rather than loading garbage;
  * `async_=True` writes in a background thread; `wait()` joins it and
    re-raises its failure;
  * restore(step=None) walks back through the saved steps to the newest
    one that verifies (`last_restored_step` says which);
  * an injector fires "checkpoint.write" once per save: "error" fails the
    write, "torn" flips one byte of a leaf after the publish.

The port's leaves are torch tensors (on any device), numpy arrays or
numpy scalars. Save copies each tensor to the host synchronously before
the write starts, since the train step updates the table and its
accumulator in place; restore copies each leaf into the example tree's
tensor of that path, on its device, reading the file through a memory
map in row chunks, so the host never holds a table twice. There is no
`shardings`: the sharded restore comes with the multi-device slice.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch


class CheckpointCorruptionError(RuntimeError):
    """A saved leaf failed CRC verification (torn write or bit rot)."""


#: bytes per CRC and copy chunk: a leaf is never copied whole on the host
_CHUNK_BYTES = 1 << 26

#: numpy has no bf16 or fp8: the stored bits, the manifest's logical dtype
_BITCAST = {"bfloat16": (torch.bfloat16, np.uint16),
            "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
            "float8_e5m2": (torch.float8_e5m2, np.uint8)}
#: stored dtype -> the (numpy, torch) dtypes of one width that both
#: packages take, through which the bits pass unchanged
_CARRIER = {np.uint16: (np.int16, torch.int16), np.uint8: (np.uint8,
                                                           torch.uint8)}


def _crc32(arr: np.ndarray) -> int:
    """CRC-32 (zlib, IEEE polynomial) of the array's stored bytes, fed in
    chunks, so a memory-mapped or 24 GB leaf is never copied whole. Equal
    to the reference's `zlib.crc32(arr.tobytes())`."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    crc = 0
    for lo in range(0, flat.size, _CHUNK_BYTES):
        crc = zlib.crc32(flat[lo:lo + _CHUNK_BYTES], crc)
    return crc & 0xFFFFFFFF


def flatten_with_paths(tree: Any) -> tuple[list[str], list[Any]]:
    """(paths, leaves) in the reference's `tree_flatten_with_path` order:
    dict keys sorted, list and tuple entries by index, None dropped, any
    other object a leaf. Paths join the keys with "/"."""
    paths: list[str] = []
    leaves: list[Any] = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + [str(k)])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, prefix + [str(i)])
        else:
            paths.append("/".join(prefix))
            leaves.append(node)

    walk(tree, [])
    return paths, leaves


def _unflatten(tree: Any, values: dict[str, Any], prefix=()) -> Any:
    """A copy of `tree`'s structure with each leaf replaced by
    values[path]."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, values, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return values["/".join(prefix)]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(stored array, logical dtype) of one leaf, copied to the host."""
    if isinstance(leaf, torch.Tensor):
        # a copy even of a CPU tensor: the step updates tables in place
        t = leaf.detach().to("cpu", copy=True)
        logical = str(t.dtype).removeprefix("torch.")
        if logical in _BITCAST:
            store = _BITCAST[logical][1]
            return t.view(_CARRIER[store][1]).numpy().view(store), logical
        return t.numpy(), logical
    arr = np.array(leaf)
    return arr, str(arr.dtype)


class CheckpointManager:
    """Atomic, CRC-verified checkpoints of a tree, `keep` steps retained
    (0 keeps none). Each save writes leaves and a manifest into a tmp
    directory and publishes it with `os.replace`, so a crash leaves the
    old checkpoint or the new one, never a torn one."""

    def __init__(self, directory: str, keep: int = 3, injector=None):
        self.directory = directory
        self.keep = keep
        self.injector = injector           # FaultInjector ("checkpoint.write")
        self.last_restored_step: int | None = None
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, async_: bool = False) -> None:
        """Checkpoint `tree` at `step`. Every leaf is copied to the host
        before this returns; `async_=True` leaves the write to a thread."""
        self.wait()                 # re-raises a failed previous async save
        paths, leaves = flatten_with_paths(tree)
        host = [_to_host(x) for x in leaves]
        if async_:
            self._thread = threading.Thread(
                target=self._write_captured, args=(step, paths, host),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, paths, host)

    def _write_captured(self, step: int, paths, host):
        """Async writer: park any failure for wait() to re-raise."""
        try:
            self._write(step, paths, host)
        except BaseException as e:  # noqa: BLE001 — surfaced by wait()
            self._error = e

    def _write(self, step: int, paths, host):
        spec = None
        if self.injector is not None:       # "error" kind raises right here
            spec = self.injector.fire("checkpoint.write", step=step)
        final = os.path.join(self.directory, f"step_{step:09d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "leaves": []}
        for i, (path, (arr, logical)) in enumerate(zip(paths, host)):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append({
                "path": path, "file": fname,
                "shape": list(arr.shape), "dtype": logical,
                "crc32": _crc32(arr)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):
            # re-saving a step already on disk (a replay after restore fell
            # back past a corrupt copy): os.replace cannot overwrite a
            # non-empty directory; LATEST never points into the window
            shutil.rmtree(final)
        os.replace(tmp, final)
        latest_tmp = os.path.join(self.directory, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.replace(latest_tmp, os.path.join(self.directory, "LATEST"))
        if spec is not None and getattr(spec, "kind", None) == "torn":
            # a storage-level tear after a successful publish: only the
            # CRC check can catch it
            leaf = int(spec.arg or 0) % max(len(manifest["leaves"]), 1)
            self._flip_byte(os.path.join(
                final, manifest["leaves"][leaf]["file"]))
        self._gc()

    @staticmethod
    def _flip_byte(path: str):
        """Corrupt the last byte of `path` in place (a deterministic tear)."""
        with open(path, "r+b") as f:
            f.seek(-1, os.SEEK_END)
            b = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([b[0] ^ 0xFF]))

    def wait(self):
        """Join any in-flight async save, re-raising its failure."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"async checkpoint save failed: {err!r}") from err

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        # keep=0 keeps none (steps[:-0] would be the empty slice)
        drop = steps[:-self.keep] if self.keep > 0 else steps
        for d in drop:
            shutil.rmtree(os.path.join(self.directory, d),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def latest_step(self) -> int | None:
        """Newest published step on disk (None when nothing is saved); a
        LATEST pointing at a removed directory falls back to a scan."""
        latest = os.path.join(self.directory, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                name = f.read().strip()
            if os.path.isdir(os.path.join(self.directory, name)):
                return int(name.split("_")[1])
        steps = self.saved_steps()
        return steps[-1] if steps else None

    def saved_steps(self) -> list[int]:
        """All fully published step numbers on disk, ascending."""
        return sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))

    def restore(self, example_tree: Any, step: int | None = None,
                shardings: Any | None = None) -> Any:
        """Restore into `example_tree`'s structure: each tensor leaf is
        overwritten IN PLACE (same shape and dtype, on its device) and
        returned; a numpy leaf comes back as an owned array.

        With `step=None` the saved steps are tried newest first, and one
        whose leaves fail their CRC (or whose files cannot be read) is
        skipped; `last_restored_step` records which step loaded. Leaves
        are verified and copied chunk by chunk, so when a step is skipped
        the example's tensors may hold part of it until an older step
        overwrites them. An explicit `step` is strict. A structure
        mismatch always raises ValueError."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...) re-places leaves on a new mesh; it "
                "comes with the multi-device slice of the port")
        if step is not None:
            tree = self._restore_step(step, example_tree)
            self.last_restored_step = step
            return tree
        candidates = self.saved_steps()[::-1]
        if not candidates:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        errors: list[tuple[int, Exception]] = []
        for cand in candidates:
            try:
                tree = self._restore_step(cand, example_tree)
            except (CheckpointCorruptionError, OSError,
                    json.JSONDecodeError) as e:
                errors.append((cand, e))
                continue
            self.last_restored_step = cand
            return tree
        raise CheckpointCorruptionError(
            f"no intact checkpoint in {self.directory}: " +
            "; ".join(f"step {s}: {e}" for s, e in errors))

    def _restore_step(self, step: int, example_tree: Any) -> Any:
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        paths, leaves = flatten_with_paths(example_tree)
        missing = [p for p in paths if p not in by_path]
        extra = [p for p in by_path if p not in set(paths)]
        if missing or extra:
            raise ValueError(
                f"checkpoint structure mismatch at step {step}: example "
                f"tree leaves absent from the manifest: {missing or 'none'};"
                f" manifest leaves absent from the example tree: "
                f"{extra or 'none'} (did the model/optimizer/cache layout "
                "change between save and restore?)")
        values = {}
        for path, leaf in zip(paths, leaves):
            entry = by_path[path]
            arr = np.load(os.path.join(d, entry["file"]), mmap_mode="r")
            values[path] = _load_leaf(arr, entry, leaf, step)
        return _unflatten(example_tree, values)


def _load_leaf(arr: np.ndarray, entry: dict, leaf, step: int):
    """Verify one stored leaf's CRC and load it: into `leaf` in place when
    it is a tensor, else as an owned numpy array."""
    logical = entry["dtype"]
    want_crc = entry.get("crc32")
    if isinstance(leaf, torch.Tensor):
        tdtype = (_BITCAST[logical][0] if logical in _BITCAST
                  else getattr(torch, logical, None))
        if tuple(leaf.shape) != tuple(arr.shape) or leaf.dtype != tdtype:
            raise ValueError(
                f"step {step} leaf {entry['path']!r} is {logical} "
                f"{tuple(arr.shape)}; the example tree's is {leaf.dtype} "
                f"{tuple(leaf.shape)}")
        flat = np.ascontiguousarray(arr).reshape(-1)
        dst = leaf.view(-1)
        per = max(1, _CHUNK_BYTES // max(flat.itemsize, 1))
        crc = 0
        with torch.no_grad():
            for lo in range(0, flat.size, per):
                part = np.array(flat[lo:lo + per])
                crc = zlib.crc32(part.view(np.uint8), crc)
                src = torch.from_numpy(
                    part.view(_CARRIER[part.dtype.type][0])
                    if logical in _BITCAST else part)
                dst[lo:lo + per].copy_(src.view(leaf.dtype))
        got = crc & 0xFFFFFFFF
        out = leaf
    else:
        out = np.array(arr)
        got = _crc32(out)
    if want_crc is not None and got != want_crc:
        raise CheckpointCorruptionError(
            f"step {step} leaf {entry['path']!r} ({entry['file']}) failed "
            "CRC verification — torn write or bit rot")
    return out
