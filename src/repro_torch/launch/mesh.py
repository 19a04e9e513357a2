"""Device meshes over `torch.distributed` ranks, and a helper that runs a
callable on N spawned ranks.

The reference builds `jax.make_mesh` meshes (`launch/mesh.py`): `data` is
the paper's trainer axis, `model` its sparse-parameter-server axis, `pod`
the pod-level data axis. Here a `Mesh` lays the world's ranks out in
row-major order over the same axes (rank r sits at
`np.unravel_index(r, shape)`, as the reference's devices do in
`np.array(devices).reshape(shape)`) and holds one process group per axis:
the ranks that differ from this one only along that axis. A `psum` over an
axis is `Mesh.all_reduce(t, axis)`; rows move between the ranks of an
axis by copy, never by a sum: `all_gather_rows` (every rank's rows, in
coordinate order) and `all_to_all_rows` (each rank its own list from
each other rank, the lengths known to every rank in advance). Under gloo
a CUDA tensor is staged through page-locked host memory for these two:
the copies keep every bit (-0.0 included).

The constructors are functions, and touch no distributed state until they
are called: they need an initialized default group (`run_ranks` makes
one) whose world size is the product of the shape, and raise otherwise.
`torch.distributed.device_mesh.init_device_mesh` is not used: on a CUDA
device it picks each rank's card from its local rank, where the ranks
here may share one card (gloo), and the executors need nothing from it
but the per-axis groups.

`run_ranks(fn, n, backend=..., device=...)` spawns n processes, joins them
through a `FileStore` under a fresh temporary directory (no TCP port, so
concurrent test workers never collide), runs `fn(device, *args)` on each
and returns their results in rank order. A rank that raises, or a run that
outlasts its timeout, kills every rank and raises: a hung collective never
hangs the caller. `fn` must be importable by module path (the children
unpickle it), so it lives in this package, never in a test file.
"""
from __future__ import annotations

import gc
import math
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


#: the collectives a Mesh counts in `stats`
COLLECTIVES = ("all_reduce", "all_gather", "all_to_all")


class MeshAxis:
    """One axis of a mesh as seen from this rank (DeviceMesh's
    `mesh["model"]` idiom): its size and the process group of the ranks
    along it."""

    def __init__(self, size: int, group):
        self._size, self._group = size, group

    def size(self) -> int:
        return self._size

    def get_group(self):
        return self._group


class Mesh:
    """The world's ranks laid out row-major over named axes, with one
    process group per axis and a count of the sums it ran.

    `shape` maps each axis to its size (as `jax.sharding.Mesh.shape`),
    `coords` this rank's coordinate on each. `stats` counts, per process
    and per collective (`all_reduce`, `all_gather`, `all_to_all`), the
    calls, the bytes this rank handed over, and their host ms (the device
    synchronized first, so a call's ms is the collective's own: staging,
    the transfer and the wait for the slowest rank); and the calls over a
    one-rank axis, which move nothing and are skipped."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} for axes {axis_names}")
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "a Mesh needs an initialized torch.distributed default "
                "group (run_ranks makes one); none is initialized")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(
                f"mesh shape {tuple(shape)} holds {math.prod(shape)} ranks; "
                f"the world has {world}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, (int(x) for x in shape)))
        self.rank = dist.get_rank()
        coords = np.unravel_index(self.rank, tuple(shape))
        self.coords = {a: int(c) for a, c in zip(axis_names, coords)}
        grid = np.arange(world).reshape(tuple(shape))
        self._axes = {}
        for i, name in enumerate(axis_names):
            mine = None
            # every rank creates every group, in the same order
            for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    mine = g
            self._axes[name] = MeshAxis(int(shape[i]), mine)
        self.reset_stats()

    def __getitem__(self, axis: str) -> MeshAxis:
        return self._axes[axis]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def reset_stats(self) -> None:
        self.stats = {"skipped_calls": 0, "skipped_bytes": 0}
        for op in COLLECTIVES:
            self.stats.update({f"{op}_calls": 0, f"{op}_bytes": 0,
                               f"{op}_ms": 0.0})

    def _skip(self, axis: str, nbytes: int) -> bool:
        """Book a call over a one-rank axis as skipped; True if it was."""
        if self.shape[axis] > 1:
            return False
        self.stats["skipped_calls"] += 1
        self.stats["skipped_bytes"] += nbytes
        return True

    def _book(self, op: str, nbytes: int, t0: float) -> None:
        self.stats[f"{op}_ms"] += (time.perf_counter() - t0) * 1e3
        self.stats[f"{op}_calls"] += 1
        self.stats[f"{op}_bytes"] += nbytes

    def _staged(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """`t` as the axis's backend takes it: a page-locked host copy of a
        CUDA tensor under gloo, else `t`."""
        if t.is_cuda and dist.get_backend(self._axes[axis].get_group()) \
                == "gloo":
            return torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t)
        return t

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum `t` IN PLACE over the ranks along `axis` (the reference's
        `jax.lax.psum`); returns `t`. Over a one-rank axis the sum is `t`
        itself, and no collective runs."""
        nbytes = t.numel() * t.element_size()
        if self._skip(axis, nbytes):
            return t
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        dist.all_reduce(t, op=dist.ReduceOp.SUM,
                        group=self._axes[axis].get_group())
        self._book("all_reduce", nbytes, t0)
        return t

    def all_gather_rows(self, local: torch.Tensor, axis: str
                        ) -> torch.Tensor:
        """Every rank's `local` along `axis` stacked on dim 0 in coordinate
        order, by copy (all ranks' `local` of one shape); a new tensor on
        local's device."""
        nbytes = local.numel() * local.element_size()
        if self._skip(axis, nbytes):
            return local.clone()
        if local.is_cuda:
            torch.cuda.synchronize(local.device)
        t0 = time.perf_counter()
        src = self._staged(local.contiguous(), axis)
        parts = [torch.empty_like(src) for _ in range(self.shape[axis])]
        dist.all_gather(parts, src, group=self._axes[axis].get_group())
        out = torch.cat(parts).to(local.device)
        self._book("all_gather", nbytes, t0)
        return out

    def all_to_all_rows(self, send: list[torch.Tensor], recv_rows: list[int],
                        axis: str) -> list[torch.Tensor]:
        """Personalized exchange along `axis`, by copy: send[j] (rows of one
        trailing shape and dtype) goes to the rank at coordinate j, and the
        result's entry j is what that rank sent here, recv_rows[j] rows of
        it (every rank knows every length in advance: both sides compute
        them from the same plan). Tensors on send's device."""
        n = self.shape[axis]
        if len(send) != n or len(recv_rows) != n:
            raise ValueError(f"all_to_all_rows over {axis!r} ({n} ranks) "
                             f"takes {n} send blocks and {n} lengths")
        flat = torch.cat(send)
        nbytes = flat.numel() * flat.element_size()
        if self._skip(axis, nbytes):
            return [flat]
        dev = flat.device
        if flat.is_cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        src = self._staged(flat.contiguous(), axis)
        out = src.new_empty((sum(recv_rows),) + tuple(flat.shape[1:]))
        dist.all_to_all_single(out, src, [int(r) for r in recv_rows],
                               [int(t.shape[0]) for t in send],
                               group=self._axes[axis].get_group())
        out = out.to(dev)
        self._book("all_to_all", nbytes, t0)
        return list(out.split([int(r) for r in recv_rows]))

    def gather_rows(self, local: torch.Tensor, axis: str) -> torch.Tensor:
        """The rows of every rank along `axis` stacked in coordinate order:
        a zero buffer of size(axis) * len(local) rows with this rank's rows
        at its coordinate, summed over the axis. Adding zeros is exact but
        for the sign of a zero (-0.0 + 0.0 is +0.0), so every rank gets the
        same bits; `all_gather_rows` moves rows by copy."""
        n = self.shape[axis]
        if n == 1:
            return local
        out = local.new_zeros((n * local.shape[0],) + tuple(local.shape[1:]))
        c = self.coords[axis]
        out[c * local.shape[0]:(c + 1) * local.shape[0]] = local
        return self.all_reduce(out, axis)


def make_test_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """A small mesh for the CPU tests and the card's smoke run."""
    return Mesh(tuple(shape), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layout: (data 16, model 16), or (pod 2,
    data 16, model 16)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)


def make_host_mesh(n_hosts: int, axis: str = "data") -> Mesh:
    """A 1-D mesh over the data-parallel hosts."""
    return Mesh((n_hosts,), (axis,))

# ---------------------------------------------------------------------------
# running a callable on N spawned ranks
# ---------------------------------------------------------------------------


def _process_started() -> float:
    """This process's start, wall clock (Linux /proc), or now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


#: when this module finished importing (torch included): a spawned rank's
#: timings split its start into imports and unpickling its arguments
IMPORTED_AT = time.time()


def _rank_main(rank: int, world: int, store_path: str, backend: str,
               device: str, pg_timeout_s: float, inbox, results) -> None:
    stamps = {"started": _process_started(), "imported": IMPORTED_AT}
    try:
        # the callable and its arguments come through the inbox once every
        # rank has started, so no rank waits on another's imports; they
        # die when fn returns: a CUDA IPC view releases the caller's block
        # only when its last reference here goes
        fn, args = inbox.get()
        stamps["entered"] = time.time()
        dev = torch.device(device)
        if dev.type == "cuda":
            from repro_torch import resolve_device
            torch.cuda.set_device(resolve_device(dev))
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world), rank=rank,
            world_size=world, timeout=timedelta(seconds=pg_timeout_s))
        stamps["joined"] = time.time()
        out = fn(dev, *args)
        del args
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stamps["returned"] = time.time()
        results.put((rank, True, out, stamps))
    except Exception:
        results.put((rank, False, traceback.format_exc(), stamps))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n: int, args: tuple = (), *, backend: str, device: str,
              timeout_s: float = 300.0, timings: dict | None = None) -> list:
    """Run `fn(torch.device(device), *args)` on `n` spawned ranks of one
    `torch.distributed` world (`backend` "gloo" or "nccl", rendezvous
    through a FileStore in a fresh temporary directory) and return the n
    results in rank order. CUDA tensors in `args` reach the ranks as CUDA
    IPC views of the caller's memory (torch.multiprocessing), so the
    caller keeps them alive and reads them only after this returns.

    Raises RuntimeError with the failing ranks' tracebacks if any rank
    raises, and TimeoutError if the ranks have not all reported within
    `timeout_s`; either way every rank is killed first. A `timings` dict
    receives each rank's seconds from the spawn to its process's start, to
    this module's import (torch's), to receiving its arguments, to joining
    the world and to its report, and the seconds until every rank has
    exited."""
    import torch.multiprocessing as tmp
    if n < 1:
        raise ValueError(f"run_ranks needs at least one rank, got {n}")
    ctx = tmp.get_context("spawn")
    results = ctx.Queue()
    tmpdir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    store = os.path.join(tmpdir, "store")
    inboxes = [ctx.Queue() for _ in range(n)]
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n, store, backend, device, timeout_s,
                               inboxes[r], results))
             for r in range(n)]
    got, failed, stamps = {}, {}, {}
    t_spawn = time.time()
    try:
        for p in procs:
            p.start()
        for q in inboxes:
            q.put((fn, args))          # pickled by the queue's own thread
        deadline = time.monotonic() + timeout_s
        while len(got) + len(failed) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"run_ranks: {n - len(got) - len(failed)} of {n} ranks "
                    f"did not report within {timeout_s:.0f} s "
                    f"(reported: {sorted(got)}; failed: {sorted(failed)})")
            try:
                rank, ok, out, stamps[rank] = results.get(
                    timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and r not in failed
                        and p.exitcode is not None and p.exitcode != 0]
                if dead:
                    failed.update({r: f"rank {r} exited with code "
                                      f"{procs[r].exitcode} without a "
                                      "report" for r in dead})
                continue
            (got if ok else failed)[rank] = out
            if failed:
                break
        if failed:
            raise RuntimeError("run_ranks: rank(s) failed:\n" + "\n".join(
                f"--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items())))
        for p in procs:
            p.join(timeout=30)
        if timings is not None:
            timings["ranks"] = [{k: v - t_spawn for k, v in stamps[r].items()}
                                for r in range(n)]
            timings["all_exited_s"] = time.time() - t_spawn
        return [got[r] for r in range(n)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        for q in inboxes + [results]:
            q.cancel_join_thread()        # a dead rank never drains its inbox
            q.close()
        shutil.rmtree(tmpdir, ignore_errors=True)
