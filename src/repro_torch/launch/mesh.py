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
each other rank, the lengths known to every rank in advance);
`reduce_scatter` sums over an axis and keeps this rank's block. Under
gloo a CUDA tensor is staged through page-locked host memory for these
three: the copies keep every bit (-0.0 included).

The LM's sharded step differentiates through its collectives. The
`torch.autograd.Function`s at the end of this module take a Mesh and a
tuple of its axes, book every call in `Mesh.stats` as the methods do, and
pair each collective with its conjugate as the gradient: `all_gather`
(along a dim; backward a reduce-scatter, or with `partial_grad=False` the
rank's slice), `reduce_scatter` (backward an all_gather), `take_block`
(backward an all_gather), and Megatron's pair `copy_to` (identity
forward, all_reduce backward: a replicated input to a tensor-parallel
region) and `reduce_from` (all_reduce forward, identity backward: the
region's partial sums). Autograd runs a rank's backward in the same order
on every rank (one device a rank, the same graph), so the ranks issue the
backward's collectives in one order, inside a checkpoint's recompute
too.

The constructors are functions, and touch no distributed state until they
are called: they need an initialized default group (`run_ranks` makes
one) whose world size is the product of the shape, and raise otherwise.
`torch.distributed.device_mesh.init_device_mesh` is not used: on a CUDA
device it picks each rank's card from its local rank, where the ranks
here may share one card (gloo), and the executors need nothing from it
but the per-axis groups. Nor is `torch.distributed.tensor` (DTensor):
its redistributions would issue collectives that `Mesh.stats` does not
see, where every executor here counts each one it runs.

`run_ranks(fn, n, backend=..., device=...)` spawns n processes, joins them
through a `FileStore` under a fresh temporary directory (no TCP port, so
concurrent test workers never collide), runs `fn(device, *args)` on each
and returns their results in rank order. A rank that raises, or a run that
outlasts its timeout, kills every rank and raises: a hung collective never
hangs the caller. A `RankWorld` keeps such a world for several calls, one
after another, and `run_ranks` is one of one call. `fn` must be
importable by module path (the children unpickle it), so it lives in this
package, never in a test file.
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
COLLECTIVES = ("all_reduce", "all_gather", "all_to_all", "reduce_scatter")


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
    and per collective (`all_reduce`, `all_gather`, `all_to_all`,
    `reduce_scatter`), the calls, the bytes this rank handed over, and
    their host ms (the device synchronized first, so a call's ms is the
    collective's own: staging, the transfer and the wait for the slowest
    rank), and the same three again per axis as f"{op}@{axis}_calls" and
    so on; and the calls over a one-rank axis, which move nothing and are
    skipped."""

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
        # two page-locked staging regions, grown as needed and reused by
        # every staged collective (its input, its output): a fresh
        # page-locked allocation a call stalls the host
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
        self._regions: list[torch.Tensor | None] = [None, None]
        self.reset_stats()

    def __getitem__(self, axis: str) -> MeshAxis:
        return self._axes[axis]

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def reset_stats(self) -> None:
        self.stats = {"skipped_calls": 0, "skipped_bytes": 0}
        for op in COLLECTIVES:
            for key in (op, *(f"{op}@{a}" for a in self.axis_names)):
                self.stats.update({f"{key}_calls": 0, f"{key}_bytes": 0,
                                   f"{key}_ms": 0.0})

    def _skip(self, axis: str, nbytes: int) -> bool:
        """Book a call over a one-rank axis as skipped; True if it was."""
        if self.shape[axis] > 1:
            return False
        self.stats["skipped_calls"] += 1
        self.stats["skipped_bytes"] += nbytes
        return True

    def _book(self, op: str, nbytes: int, t0: float, axis: str) -> None:
        ms = (time.perf_counter() - t0) * 1e3
        for key in (op, f"{op}@{axis}"):
            self.stats[f"{key}_ms"] += ms
            self.stats[f"{key}_calls"] += 1
            self.stats[f"{key}_bytes"] += nbytes

    def _gloo_cuda(self, t: torch.Tensor, axis: str) -> bool:
        return t.is_cuda and dist.get_backend(
            self._axes[axis].get_group()) == "gloo"

    def _pinned(self, region: int, shape, dtype: torch.dtype
                ) -> torch.Tensor:
        """A page-locked host tensor of `shape` in staging region 0 or 1,
        valid until the next staged collective of this Mesh."""
        nbytes = math.prod(shape) * dtype.itemsize
        buf = self._regions[region]
        if buf is None or buf.numel() < nbytes:
            grown = 0 if buf is None else buf.numel() * 3 // 2
            self._regions[region] = buf = torch.empty(
                max(nbytes, grown), dtype=torch.uint8, pin_memory=True)
        return buf[:nbytes].view(dtype).view(shape)

    def _staged(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """`t` as the axis's backend takes it: a page-locked host copy of a
        CUDA tensor under gloo (staging region 0), else `t`."""
        if self._gloo_cuda(t, axis):
            return self._pinned(0, t.shape, t.dtype).copy_(t)
        return t

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum",
                   staged: bool = False) -> torch.Tensor:
        """Sum `t` IN PLACE over the ranks along `axis` (the reference's
        `jax.lax.psum`), or with op="max" take the largest; returns `t`.
        Over a one-rank axis the result is `t` itself, and no collective
        runs. With `staged`, a CUDA tensor goes through page-locked host
        memory under gloo (`_staged`), where gloo's own CUDA path is
        slower: 72 against 55 ms for 33.5 MB of bf16 between two of four
        ranks sharing an H100."""
        nbytes = t.numel() * t.element_size()
        if self._skip(axis, nbytes):
            return t
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        buf = self._staged(t, axis) if staged else t
        dist.all_reduce(buf, op={"sum": dist.ReduceOp.SUM,
                                 "max": dist.ReduceOp.MAX}[op],
                        group=self._axes[axis].get_group())
        if buf is not t:
            t.copy_(buf)
        self._book("all_reduce", nbytes, t0, axis)
        return t

    def reduce_scatter(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of `t` over the ranks along `axis`, cut into size(axis)
        equal blocks along dim 0: this rank's block (its coordinate's), a
        new tensor on t's device. Over a one-rank axis, a copy of `t`.

        Each rank sends block j to the rank at coordinate j by one
        personalized exchange (`all_to_all_single`, staged through
        page-locked memory for a CUDA tensor under gloo), then sums the
        blocks it received on t's device in coordinate order (`sum` over
        a leading dim; a bf16 block accumulates in fp32 and rounds once).
        gloo's own reduce_scatter sums on the host: 7.4 of an FSDP step's
        collective seconds on an H100 shared by four ranks, where the
        same bytes gathered by exchange took 2.5."""
        n = self.shape[axis]
        nbytes = t.numel() * t.element_size()
        if t.shape[0] % n:
            raise ValueError(f"reduce_scatter over {axis!r} ({n} ranks): "
                             f"{t.shape[0]} rows do not split evenly")
        if self._skip(axis, nbytes):
            return t.clone()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        src = self._staged(t.contiguous(), axis)
        out = self._pinned(1, t.shape, t.dtype) if src is not t else \
            t.new_empty(t.shape)
        dist.all_to_all_single(out, src, group=self._axes[axis].get_group())
        parts = out.to(t.device).view((n, t.shape[0] // n)
                                      + tuple(t.shape[1:]))
        out = parts.sum(0, dtype=torch.float32).to(t.dtype) \
            if t.dtype in (torch.bfloat16, torch.float16) else parts.sum(0)
        self._book("reduce_scatter", nbytes, t0, axis)
        return out

    def all_gather_rows(self, local: torch.Tensor, axis: str
                        ) -> torch.Tensor:
        """Every rank's `local` along `axis` stacked on dim 0 in coordinate
        order, by copy (all ranks' `local` of one shape); a new tensor on
        local's device. It runs as a personalized exchange of `local` to
        every rank of the axis (`all_to_all_single`) into one buffer,
        page-locked for a CUDA tensor under gloo: gloo's all_gather took
        149 ms where this takes 64 for 33.5 MB of bf16 between two of four
        ranks sharing an H100."""
        n = self.shape[axis]
        nbytes = local.numel() * local.element_size()
        if self._skip(axis, nbytes):
            return local.clone()
        if local.is_cuda:
            torch.cuda.synchronize(local.device)
        t0 = time.perf_counter()
        shape = (n * local.shape[0],) + tuple(local.shape[1:])
        if self._gloo_cuda(local, axis):
            src = self._pinned(0, shape, local.dtype)
            out = self._pinned(1, shape, local.dtype)
        else:
            src = local.new_empty(shape)
            out = local.new_empty(shape)
        for part in src.chunk(n):
            part.copy_(local)
        dist.all_to_all_single(out, src,
                               group=self._axes[axis].get_group())
        out = out.to(local.device)
        self._book("all_gather", nbytes, t0, axis)
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
        self._book("all_to_all", nbytes, t0, axis)
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


# ---------------------------------------------------------------------------
# collectives with gradients (over a tuple of axes: a dimension sharded
# over (a0, a1) holds block c0 * size(a1) + c1, as `nn.sharding` lays
# blocks out, so a gather runs over the minor axis first and a scatter
# over the major axis first)
# ---------------------------------------------------------------------------


def _gather(mesh: Mesh, x: torch.Tensor, axes: tuple, dim: int
            ) -> torch.Tensor:
    for a in reversed(axes):
        x = mesh.all_gather_rows(x.movedim(dim, 0).contiguous(),
                                 a).movedim(0, dim)
    return x.contiguous()


def _scatter(mesh: Mesh, x: torch.Tensor, axes: tuple, dim: int
             ) -> torch.Tensor:
    for a in axes:
        x = mesh.reduce_scatter(x.movedim(dim, 0).contiguous(),
                                a).movedim(0, dim)
    return x.contiguous()


def _block(mesh: Mesh, x: torch.Tensor, axes: tuple, dim: int
           ) -> torch.Tensor:
    n, k = 1, 0
    for a in axes:
        n, k = n * mesh.shape[a], k * mesh.shape[a] + mesh.coords[a]
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                         f"split into {n} blocks over {axes}")
    size = x.shape[dim] // n
    return x.narrow(dim, k * size, size).contiguous()


def _sum(mesh: Mesh, x: torch.Tensor, axes: tuple) -> torch.Tensor:
    x = x.clone()
    for a in axes:
        mesh.all_reduce(x, a, staged=True)
    return x


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, partial_grad):
        ctx.args = (mesh, axes, dim, partial_grad)
        return _gather(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, partial_grad = ctx.args
        if partial_grad:
            return _scatter(mesh, g, axes, dim), None, None, None, None
        return _block(mesh, g, axes, dim), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _scatter(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return _gather(mesh, g, axes, dim), None, None, None


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _block(mesh, x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return _gather(mesh, g, axes, dim), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return _sum(mesh, g, axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _sum(mesh, x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axes: tuple, dim: int,
               partial_grad: bool = True) -> torch.Tensor:
    """The blocks of every rank along `axes` put together along `dim`.
    Backward: the cotangent reduce-scattered over `axes` (each rank's
    cotangent a partial sum: a weight gathered over the axes its batch
    splits over), or with partial_grad=False this rank's block of it (the
    ranks' cotangents whole and equal: a computation replicated over
    `axes`)."""
    return _AllGather.apply(x, mesh, tuple(axes), dim, partial_grad)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes: tuple,
                   dim: int) -> torch.Tensor:
    """The sum over `axes`, this rank's block of it along `dim`. Backward:
    the cotangent's blocks all-gathered."""
    return _ReduceScatter.apply(x, mesh, tuple(axes), dim)


def take_block(x: torch.Tensor, mesh: Mesh, axes: tuple,
               dim: int) -> torch.Tensor:
    """This rank's block along `dim` of a tensor replicated over `axes`.
    Backward: the cotangent's blocks all-gathered."""
    return _TakeBlock.apply(x, mesh, tuple(axes), dim)


def copy_to(x: torch.Tensor, mesh: Mesh, axes: tuple) -> torch.Tensor:
    """Megatron's f: `x`, replicated over `axes`, enters a region whose
    ranks each compute part of a sum. Identity forward; backward, the
    ranks' partial cotangents summed over `axes`."""
    return _CopyTo.apply(x, mesh, tuple(axes))


def reduce_from(x: torch.Tensor, mesh: Mesh, axes: tuple) -> torch.Tensor:
    """Megatron's g: the sum over `axes` of the ranks' partial results (a
    new tensor). Backward: the identity (the sum's cotangent is whole on
    every rank)."""
    return _ReduceFrom.apply(x, mesh, tuple(axes))


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
    first = {"started": _process_started(), "imported": IMPORTED_AT}
    dev = torch.device(device)
    stamps = dict(first)
    try:
        # each call's callable and arguments come through the inbox (the
        # first once every rank has started, so no rank waits on another's
        # imports); None ends the rank. A CUDA IPC view releases the
        # caller's block only when its last reference here goes, so every
        # call's arguments and results are dropped before its report
        while (item := inbox.get()) is not None:
            fn, args = item
            del item
            stamps["entered"] = time.time()
            if not dist.is_initialized():
                if dev.type == "cuda":
                    from repro_torch import resolve_device
                    torch.cuda.set_device(resolve_device(dev))
                dist.init_process_group(
                    backend, store=dist.FileStore(store_path, world),
                    rank=rank, world_size=world,
                    timeout=timedelta(seconds=pg_timeout_s))
            stamps["joined"] = time.time()
            out = fn(dev, *args)
            del fn, args
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                torch.cuda.empty_cache()
            stamps["returned"] = time.time()
            results.put((rank, True, out, stamps))
            del out
            stamps = dict(first)
    except Exception:
        results.put((rank, False, traceback.format_exc(), stamps))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class RankWorld:
    """`n` spawned ranks of one `torch.distributed` world (`backend` "gloo"
    or "nccl", rendezvous through a FileStore in a fresh temporary
    directory) that run calls one after another: `run(fn, args)` runs
    `fn(torch.device(device), *args)` on every rank and returns the n
    results in rank order. Between calls the ranks wait, keeping their
    imports, device and process group, so one spawn serves several calls,
    and a world made before the caller's own work imports meanwhile.
    CUDA tensors in `args` reach the ranks as CUDA IPC views of the
    caller's memory (torch.multiprocessing): the caller keeps them alive
    and reads them only after `run` returns; each rank drops them, and
    empties its allocator's cache, before it reports.

    `run` raises RuntimeError with the failing ranks' tracebacks if any
    rank raises, and TimeoutError if the ranks have not all reported
    within `timeout_s`; either way the world ends, every rank killed.
    `close()` (or leaving a `with` block) ends it: each rank's loop
    returns, and a rank still alive after 30 s is killed."""

    def __init__(self, n: int, *, backend: str, device: str,
                 timeout_s: float = 300.0):
        import torch.multiprocessing as tmp
        if n < 1:
            raise ValueError(f"a rank world needs at least one rank, got {n}")
        self.n, self.timeout_s, self.calls = n, timeout_s, 0
        ctx = tmp.get_context("spawn")
        self._results = ctx.Queue()
        self._tmpdir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
        store = os.path.join(self._tmpdir, "store")
        self._inboxes = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, n, store, backend, device,
                                         timeout_s, self._inboxes[r],
                                         self._results))
                       for r in range(n)]
        self.t_spawn = time.time()
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.close()
            raise

    def __enter__(self) -> "RankWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def run(self, fn, args: tuple = (), *, timeout_s: float | None = None,
            timings: dict | None = None) -> list:
        """The n results of `fn(device, *args)`, one a rank. A `timings`
        dict receives each rank's seconds from the call's start (the
        spawn, for the first call) to its process's start, to this
        module's import (torch's), to receiving its arguments, to joining
        the world and to its report, and the seconds until every rank had
        reported."""
        if self._procs is None:
            raise RuntimeError("this rank world has ended")
        t_call = self.t_spawn if self.calls == 0 else time.time()
        self.calls += 1
        n, got, failed, stamps = self.n, {}, {}, {}
        try:
            for q in self._inboxes:
                q.put((fn, args))      # pickled by the queue's own thread
            deadline = time.monotonic() + (timeout_s or self.timeout_s)
            while len(got) + len(failed) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"run_ranks: {n - len(got) - len(failed)} of {n} "
                        f"ranks did not report within "
                        f"{timeout_s or self.timeout_s:.0f} s (reported: "
                        f"{sorted(got)}; failed: {sorted(failed)})")
                try:
                    rank, ok, out, stamps[rank] = self._results.get(
                        timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(self._procs)
                            if r not in got and r not in failed
                            and p.exitcode is not None and p.exitcode != 0]
                    failed.update({r: f"rank {r} exited with code "
                                      f"{self._procs[r].exitcode} without "
                                      "a report" for r in dead})
                    continue
                (got if ok else failed)[rank] = out
                if failed:
                    break
            if failed:
                raise RuntimeError("run_ranks: rank(s) failed:\n" + "\n".join(
                    f"--- rank {r} ---\n{tb}"
                    for r, tb in sorted(failed.items())))
        except BaseException:
            self.close(kill=True)
            raise
        if timings is not None:
            timings["ranks"] = [{k: v - t_call for k, v in stamps[r].items()}
                                for r in range(n)]
            timings["all_reported_s"] = time.time() - t_call
        return [got[r] for r in range(n)]

    def close(self, kill: bool = False) -> None:
        """End the world: each rank's loop returns (at once with `kill`),
        a rank alive 30 s later is killed; the queues and the store go."""
        if self._procs is None:
            return
        procs, self._procs = self._procs, None
        try:
            if not kill:
                for q, p in zip(self._inboxes, procs):
                    if p.is_alive():
                        q.put(None)
                for p in procs:
                    p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                if p.pid is not None:
                    p.join(timeout=10)
            for q in self._inboxes + [self._results]:
                q.cancel_join_thread()    # a dead rank never drains its inbox
                q.close()
            shutil.rmtree(self._tmpdir, ignore_errors=True)


def run_ranks(fn, n: int, args: tuple = (), *, backend: str, device: str,
              timeout_s: float = 300.0, timings: dict | None = None) -> list:
    """Run `fn(torch.device(device), *args)` on `n` spawned ranks of one
    `torch.distributed` world and return the n results in rank order: a
    `RankWorld` of one call, its errors and CUDA IPC views as there. A
    `timings` dict receives each rank's seconds from the spawn to its
    process's start, to this module's import (torch's), to receiving its
    arguments, to joining the world and to its report, and the seconds
    until every rank has exited."""
    with RankWorld(n, backend=backend, device=device,
                   timeout_s=timeout_s) as world:
        out = world.run(fn, args, timings=timings)
        world.close()
    if timings is not None:
        timings["all_exited_s"] = time.time() - world.t_spawn
    return out
