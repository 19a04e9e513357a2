"""What one rank runs when the sharded DLRM steps train over a mesh.

`multihost_rank` runs the multi-host cached tier one rank a host
(`build_cached_train_step(mesh=)`, optionally restoring from or saving to
a checkpoint under `shardings=`), `pod_rank` the EASGD pod form
(`easgd_rounds`) and reports where `nn.sharding.NamedSharding` puts a
rank's blocks; the rest of this docstring is `train_rank`'s.

`train_rank(device, job)` is the callable `launch.mesh.run_ranks` spawns
for the table-wise step and the psum dense update (`train.steps`), on the
CPU (the parity tests, gloo) or on a card (`chip_smoke.py` phases
12a-12c). It builds the job's (data, model) mesh over the world, takes
this rank's `model` shard of the table the caller handed over, trains the
job's batches and reports what the caller holds against its oracle: the
losses, the shard's bit checksums, the kernels' launches, the host and
device ms a step and the all_reduce calls, bytes and ms a step, and on
request the shard and dense parameters themselves.

The table reaches the rank whole: a numpy array (each rank copies its
rows), or a tensor on the rank's device, which `run_ranks` hands over as a
CUDA IPC view of the caller's memory. Then `data` replica 0 of each owner
trains on a view of the caller's rows (its updates land in the caller's
table) and every other replica on its own copy; at the end each replica
compares its rows with replica 0's, bit for bit.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

#: the job keys `train_rank` reads, with their defaults where optional
JOB_DEFAULTS = {"accum": None, "staged": False, "dense_lr": 0.01,
                "sparse_lr": 0.05, "sparse_eps": 1e-8, "report_arrays": False,
                "report_dense": False, "profile_steps": 0,
                "refusals": False, "axes": ("data", "model")}


def bit_checksum(t: torch.Tensor) -> int:
    """The sum of t's 64-bit words mod 2**64 (plus a last odd 32-bit word):
    an exact fingerprint of its bits that does not depend on the order, so
    the shards' sums add up (`add_checksums`) to the table's."""
    w = t.reshape(-1).view(torch.int32)
    n = w.numel() & ~1
    return int(w[:n].view(torch.int64).sum()) + int(w[n:].sum())


def add_checksums(sums) -> int:
    """Shard checksums summed as the whole table's: mod 2**64, signed."""
    return (sum(sums) + (1 << 63)) % (1 << 64) - (1 << 63)


def shard_of(full, lo: int, hi: int, replica: int,
             device: torch.device) -> torch.Tensor:
    """Rows [lo, hi) of `full` on `device`: a view of a tensor already
    there for replica 0, a copy otherwise."""
    if isinstance(full, torch.Tensor):
        rows = full[lo:hi]
        if rows.device != device:
            return rows.to(device)
        return rows if replica == 0 else rows.clone()
    return torch.from_numpy(np.array(full[lo:hi])).to(device)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_to(v, device) for v in tree]
    return torch.as_tensor(np.asarray(tree) if not isinstance(
        tree, torch.Tensor) else tree).to(device).clone()


def _tree_numpy(tree):
    if isinstance(tree, dict):
        return {k: _tree_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def pipeline_batches(cfg, ebc, n_steps: int, batch_size: int, hook: str,
                     seed: int = 0) -> list:
    """`n_steps` global batches of the launcher's synthetic stream
    (`make_dlrm_batch`, step-seeded) through a prefetching `ShardedLoader`
    pipeline, offset by `ebc`, with the batch's plan attached (`hook`
    "plan", `sparse_plan_hook`) or not ("offset"): what a sharded run's
    caller draws once and hands to the oracle and to every rank."""
    from repro_torch.data.pipeline import ShardedLoader, sparse_plan_hook
    from repro_torch.data.synthetic import make_dlrm_batch
    if hook == "plan":
        def gen(step, s):
            return make_dlrm_batch(cfg, batch_size, step, s)
        transform = sparse_plan_hook(ebc.plan.table_offsets)
    elif hook == "offset":
        def gen(step, s):
            raw = make_dlrm_batch(cfg, batch_size, step, s)
            return {**raw, "idx": ebc.offset_indices(raw["idx"])}
        transform = None
    else:
        raise ValueError(f"hook {hook!r}; expected 'plan' or 'offset'")
    keep = ("dense", "idx", "label", "plan_rows", "plan_offsets",
            "plan_bags")
    pipe = ShardedLoader(gen, batch_size, seed=seed).pipeline(
        prefetch=2, transform=transform)
    try:
        return [{k: v for k, v in next(pipe)[1].items() if k in keep}
                for _ in range(n_steps)]
    finally:
        pipe.close()


def _refusals(cfg, mesh) -> dict:
    """The messages of what a mesh refuses: the gather path under a mesh,
    a mesh of the wrong size."""
    import dataclasses

    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_dlrm_train_step
    out = {}
    ebc = EmbeddingBagCollection.build(cfg, n_shards=mesh.size("model"),
                                       strategy="row_wise")
    for name, c, mode in (
            ("gather_under_mesh",
             dataclasses.replace(cfg, lookup_impl="gather"), "dense"),
            ("fused_under_mesh",
             dataclasses.replace(cfg, lookup_impl="psum"), "sparse")):
        try:
            build_dlrm_train_step(c, ebc, adagrad(0.01), sparse_apply=mode,
                                  mesh=mesh)
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    try:
        make_test_mesh((dist.get_world_size() + 1, 1))
        out["wrong_size"] = None
    except ValueError as e:
        out["wrong_size"] = str(e)
    return out


def train_rank(device: torch.device, job: dict) -> dict:
    """One rank of a sharded DLRM run (see the module docstring). job:
      cfg           DLRMConfig
      mesh          (data, model) shape; the world must hold its product
      axes          the mesh's axis names (default ("data", "model"); the
                    psum step also takes ("pod", "data", "model"))
      strategy      "table_wise" | "row_wise" (model-size shards)
      step          "tablewise" (`build_tablewise_train_step`) or
                    "dense_psum" (`build_dlrm_train_step`, dense update,
                    the psum lookup)
      dense         {"bottom", "top"} parameters, numpy or tensors
      mega, accum   the whole table and accumulator (accum None: zeros)
      batches       the global batches (host arrays, offset rows), the
                    same list on every rank; n_steps of them run
      n_steps, staged (each step names the next batch),
      dense_lr, sparse_lr, sparse_eps, report_arrays (the shard and the
      dense parameters), report_dense (the dense parameters alone),
      profile_steps (the last steps under torch.profiler, on a card),
      refusals (report what a mesh refuses).
    Returns a dict of plain values (numpy arrays with report_arrays)."""
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import (build_dlrm_train_step,
                                         build_tablewise_train_step)
    t_in = time.perf_counter()
    job = {**JOB_DEFAULTS, **job}
    cfg = job["cfg"]
    mesh = make_test_mesh(job["mesh"], job["axes"])
    setup = {"mesh_s": time.perf_counter() - t_in}
    ebc = EmbeddingBagCollection.build(cfg, n_shards=mesh.size("model"),
                                       strategy=job["strategy"])
    lo, hi = ebc.shard_range(mesh)
    replica = 0
    for a in mesh.axis_names:
        if a != "model":
            replica = replica * mesh.size(a) + mesh.coords[a]
    mega = shard_of(job["mega"], lo, hi, replica, device)
    accum = (torch.zeros((hi - lo,), dtype=torch.float32, device=device)
             if job["accum"] is None
             else shard_of(job["accum"], lo, hi, replica, device))
    dense = _tree_to(job["dense"], device)
    opt = adagrad(job["dense_lr"])
    params = {**dense, "emb": {"mega": mega}}
    state = {"dense": opt.init(dense), "accum": accum}
    if job["step"] == "tablewise":
        step_fn = build_tablewise_train_step(
            cfg, ebc, opt, job["sparse_lr"], job["sparse_eps"], mesh=mesh)
    elif job["step"] == "dense_psum":
        step_fn = build_dlrm_train_step(
            cfg, ebc, opt, job["sparse_lr"], job["sparse_eps"],
            sparse_apply="dense", mesh=mesh)
    else:
        raise ValueError(f"unknown step {job['step']!r}")
    setup["state_s"] = time.perf_counter() - t_in - setup["mesh_s"]
    t_loop = time.perf_counter()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    losses, host_ms, span_ms, reduces, metrics0 = [], [], [], [], None
    prof, n_prof = None, job["profile_steps"]
    for k in KERNELS:
        k.launches = 0
    batches = job["batches"][:job["n_steps"]]
    for t, batch in enumerate(batches):
        nxt = batches[t + 1] if t + 1 < len(batches) else None
        if cuda and n_prof and t == job["n_steps"] - n_prof:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize(device)
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        mesh.reset_stats()
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t0 = time.perf_counter()
        if job["step"] == "tablewise":
            params, state, m = step_fn(params, state, batch, t,
                                       next_batch=nxt if job["staged"]
                                       else None)
        else:
            dev_batch = {k: torch.as_tensor(v).to(device)
                         for k, v in batch.items()
                         if k in ("dense", "idx", "label")}
            params, state, m = step_fn(params, state, dev_batch, t)
        losses.append(float(m["loss"]))            # syncs the step
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            ev1.record()
            ev1.synchronize()
            span_ms.append(ev0.elapsed_time(ev1))
        reduces.append(dict(mesh.stats))
        if metrics0 is None:
            metrics0 = {k: float(v) for k, v in m.items()
                        if k.startswith("exchange_")}
    setup["loop_s"] = time.perf_counter() - t_loop
    device_busy_ms = _profiled_busy_ms(prof, device, n_prof)
    launches = {k.name: k.launches for k in KERNELS}
    mega, accum = params["emb"]["mega"], state["accum"]
    if cuda:
        torch.cuda.synchronize(device)
    dist.barrier()             # every replica 0 has written its rows
    replica_equal = None
    if replica > 0 and isinstance(job["mega"], torch.Tensor) \
            and job["mega"].device == device:
        replica_equal = (torch.equal(mega, job["mega"][lo:hi])
                         and torch.equal(accum, job["accum"][lo:hi]
                                         if job["accum"] is not None
                                         else accum))
    out = {"rank": mesh.rank, "coords": dict(mesh.coords),
           "rows": (lo, hi), "losses": losses,
           "exchange": metrics0, "mega_sum": bit_checksum(mega),
           "accum_sum": bit_checksum(accum),
           "dense_sums": [bit_checksum(x) for x in _leaves(
               {"bottom": params["bottom"], "top": params["top"]})],
           "replica_equal": replica_equal, "launches": launches,
           "host_ms": host_ms, "device_span_ms": span_ms, "setup": setup,
           "device_busy_ms_per_step": device_busy_ms,
           "all_reduce": reduces,
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if cuda else None),
           "foreign_modules": _foreign_modules()}
    if job["report_arrays"]:
        out["mega"] = mega.cpu().numpy()
        out["accum"] = accum.cpu().numpy()
    if job["report_arrays"] or job["report_dense"]:
        out["dense"] = _tree_numpy({"bottom": params["bottom"],
                                    "top": params["top"]})
    if job["refusals"]:
        out["refusals"] = _refusals(cfg, mesh)
    del params, state, mega, accum
    return out


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def lookup_rank(device: torch.device, job: dict) -> dict:
    """One rank of the psum lookup alone: job {"cfg", "mesh", "strategy",
    "mega" (whole table), "idx" (global (B, F, L) rows)}. Returns this
    rank's `lookup_pooled_psum` of its `data` slice, as numpy."""
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh(job["mesh"])
    ebc = EmbeddingBagCollection.build(job["cfg"],
                                       n_shards=mesh.size("model"),
                                       strategy=job["strategy"])
    lo, hi = ebc.shard_range(mesh)
    mega = shard_of(job["mega"], lo, hi, 1, device)
    idx = torch.as_tensor(np.asarray(job["idx"])).to(device)
    n, c = mesh.size("data"), mesh.coords["data"]
    bl = idx.shape[0] // n
    with torch.no_grad():
        out = ebc.lookup_pooled_psum({"mega": mega},
                                     idx[c * bl:(c + 1) * bl], mesh)
    return {"coords": dict(mesh.coords), "pooled": out.cpu().numpy(),
            "all_reduce": dict(mesh.stats)}


def run_calls(device: torch.device, calls: list) -> list:
    """Several rank callables, one after another, in one spawned world:
    [fn(device, job) for fn, job in calls] (each builds its own mesh)."""
    return [fn(device, job) for fn, job in calls]


# ---------------------------------------------------------------------------
# the multi-host cached tier, one rank a host
# ---------------------------------------------------------------------------

#: the job keys `multihost_rank` reads, with their defaults where optional
MULTIHOST_DEFAULTS = {"mesh": None, "cache_rows": None,
                      "strict_sync": False, "fetch_chunk": None, "accum": None, "mega": None,
                      "steps": None, "total_rows": None, "save": None,
                      "restore": None, "dense_lr": 0.01, "sparse_lr": 0.05,
                      "sparse_eps": 1e-8, "profile_steps": 0,
                      "report_arrays": False}


def multihost_rank(device: torch.device, job: dict) -> dict:
    """One host of the multi-host cached tier over the host axis "data" of
    a mesh of the whole world: job["mesh"] (shape, axis names), by default
    the 1-D host mesh (`launch.mesh.make_host_mesh`); on a larger mesh
    each coordinate of the other axes runs a replica of the tier. job:
      cfg, n_hosts, cache_rows (per host; None: the plan's), strict_sync,
      fetch_chunk (None: the tier's), total_rows (the tier's capacity
      height, `MultiHostCachedEmbeddingBagCollection.build`)
      dense         {"bottom", "top"} parameters, numpy or tensors
      mega, accum   the whole table and accumulator (accum None: zeros):
                    numpy, or tensors on the rank's device (CUDA IPC views
                    of the caller's: this rank's rows update them in place)
      batches       the global batches (host arrays, offset rows, plans
                    optional), the same list on every rank
      steps         (start, stop): the steps run (default all batches)
      restore       {"dir"}: start from the newest step there
                    (`CheckpointManager.restore(shardings=)`: this rank's
                    capacity rows, the dense parameters and their
                    optimizer state), mega unused
      save          {"dir"}: save the same tree after the last step
      dense_lr, sparse_lr, sparse_eps, profile_steps (the last steps under
      torch.profiler, on a card), report_arrays (the shard, numpy).
    Returns plain values: the losses, the shard's rows and bit checksums,
    the dense parameters' checksums, CacheStats and RouteStats, the kernel
    launches of each step, host ms and device span ms a step, device-busy
    ms a profiled step, `Mesh.stats` of each step, the peak, and the
    modules of jax or the reference this process loaded."""
    from repro_torch.core.cache import MultiHostCachedEmbeddingBagCollection
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.mesh import Mesh
    from repro_torch.nn.sharding import NamedSharding
    from repro_torch.optim import adagrad
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.steps import build_cached_train_step
    t_in = time.perf_counter()
    job = {**MULTIHOST_DEFAULTS, **job}
    cfg = job["cfg"]
    mesh = Mesh(*(job["mesh"] or ((job["n_hosts"],), ("data",))))
    mc = MultiHostCachedEmbeddingBagCollection.build(
        cfg, n_hosts=job["n_hosts"], cache_rows=job["cache_rows"],
        total_rows=job["total_rows"])
    rows_sh = NamedSharding(mesh, mc.ebc.plan.pspec)
    setup = {"mesh_s": time.perf_counter() - t_in}
    opt = adagrad(job["dense_lr"])
    dense = _tree_to(job["dense"], device)
    state = {"dense": opt.init(dense)}
    restored = None
    if job["restore"] is not None:
        ms = mc.init_state(None, device=device, capacity_sharding=rows_sh)
        tree = {"capacity": ms.capacity, "cap_accum": ms.cap_accum,
                "dense": dense, "opt": state["dense"]}
        mgr = CheckpointManager(job["restore"]["dir"])
        tree = mgr.restore(tree, shardings=_ckpt_shardings(mesh, rows_sh))
        dense, state["dense"] = tree["dense"], tree["opt"]
        restored = {"step": mgr.last_restored_step,
                    "mega_sum": bit_checksum(ms.capacity),
                    "accum_sum": bit_checksum(ms.cap_accum)}
    else:
        def on_device(x):            # a copy of a host array: the update
            return x if x is None or isinstance(x, torch.Tensor) \
                else torch.from_numpy(np.array(x)).to(device)  # is in place
        ms = mc.init_state(on_device(job["mega"]), on_device(job["accum"]),
                           device=device, capacity_sharding=rows_sh)
    step_fn = build_cached_train_step(
        cfg, mc, opt, job["sparse_lr"], job["sparse_eps"],
        strict_sync=job["strict_sync"], mesh=mesh,
        fetch_chunk=job["fetch_chunk"])
    setup["state_s"] = time.perf_counter() - t_in - setup["mesh_s"]
    batches = job["batches"]
    start, stop = job["steps"] or (0, len(batches))
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    losses, host_ms, span_ms, coll, launches = [], [], [], [], []
    prof, n_prof = None, job["profile_steps"]
    t_loop = time.perf_counter()
    for t in range(start, stop):
        nxt = batches[t + 1] if t + 1 < stop else None
        if cuda and n_prof and t == stop - n_prof:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize(device)
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        mesh.reset_stats()
        before = {k.name: k.launches for k in KERNELS}
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t0 = time.perf_counter()
        dense, state, m = step_fn(dense, state, ms, batches[t], t,
                                  next_batch=nxt)
        losses.append(float(m["loss"]))            # syncs the step
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            ev1.record()
            ev1.synchronize()
            span_ms.append(ev0.elapsed_time(ev1))
        launches.append({k.name: k.launches - before[k.name]
                         for k in KERNELS})
        coll.append(dict(mesh.stats))
    setup["loop_s"] = time.perf_counter() - t_loop
    busy = _profiled_busy_ms(prof, device, n_prof)
    if job["save"] is not None:
        t0 = time.perf_counter()
        CheckpointManager(job["save"]["dir"]).save(
            stop, {"capacity": ms.capacity, "cap_accum": ms.cap_accum,
                   "dense": dense, "opt": state["dense"]},
            shardings=_ckpt_shardings(mesh, rows_sh))
        setup["save_s"] = time.perf_counter() - t0
    if cuda:
        torch.cuda.synchronize(device)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords), "host": ms.host,
           "rows": ms.rows,
           "restored": restored, "losses": losses, "mega_sum": bit_checksum(ms.capacity),
           "accum_sum": bit_checksum(ms.cap_accum),
           "dense_sums": [bit_checksum(x) for x in _leaves(dense)],
           "stats": dataclasses.asdict(ms.stats),
           "route": dataclasses.asdict(ms.route), "launches": launches,
           "host_ms": host_ms, "device_span_ms": span_ms, "setup": setup,
           "device_busy_ms_per_step": busy, "collectives": coll,
           "peak_bytes": (torch.cuda.max_memory_allocated(device)
                          if cuda else None),
           "host_map_bytes": sum(getattr(ms, k).nbytes for k in (
               "freq", "slot_row", "row_slot", "ema", "ema_tick")),
           "foreign_modules": _foreign_modules()}
    if job["report_arrays"]:
        out["mega"] = ms.capacity.cpu().numpy()
        out["accum"] = ms.cap_accum.cpu().numpy()
        out["dense"] = _tree_numpy(dense)
    del ms, dense, state
    return out


def _ckpt_shardings(mesh, rows_sh) -> dict:
    """The shardings of `multihost_rank`'s checkpoint tree: the capacity
    and its accumulator by rows over the host axis, the rest whole."""
    from repro_torch.nn.sharding import NamedSharding
    return {"capacity": rows_sh,
            "cap_accum": NamedSharding(mesh, rows_sh.spec[:1]),
            "dense": None, "opt": None}


def _profiled_busy_ms(prof, device, n_prof: int) -> float | None:
    """Device-busy ms a profiled step, from an open profiler (None: none,
    or a trace without device time)."""
    if prof is None:
        return None
    torch.cuda.synchronize(device)
    prof.__exit__(None, None, None)
    from torch.autograd import DeviceType
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if e.device_type != DeviceType.CPU)
    return busy / 1e3 / n_prof if busy else None


def _foreign_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "repro"))

# ---------------------------------------------------------------------------
# EASGD over the pod axis, and where NamedSharding puts a rank's blocks
# ---------------------------------------------------------------------------


def easgd_rounds(params, n_replicas: int, rounds: int, seed: int,
                 lr: float, alpha: float, beta: float, sync_every: int = 2,
                 mesh=None, axis: str = "pod"):
    """The schedule both EASGD forms run: `rounds` `replica_step`s on
    gradients drawn from numpy (round r: RandomState(seed + r), one
    standard normal (R, ...) array a leaf in tree order), an `easgd_sync`
    every `sync_every` rounds, then one `local_sgd_sync`. Stacked with
    mesh None; under `mesh`, this rank's replica over `axis` (its block of
    the same stacked gradients). Returns (the state after the last elastic
    round, the state after the local-SGD sync)."""
    from repro_torch.nn.params import tree_map
    from repro_torch.nn.sharding import NamedSharding
    from repro_torch.optim import (easgd_init, easgd_sync, local_sgd_sync,
                                   replica_step)
    sh = None if mesh is None else NamedSharding(mesh, (axis,))
    state = easgd_init(params, n_replicas, sharding=sh)
    for r in range(rounds):
        rng = np.random.RandomState(seed + r)

        def draw(p, rng=rng):
            g = torch.from_numpy(rng.standard_normal(
                (n_replicas,) + tuple(p.shape)).astype(np.float32))
            return (g if sh is None else sh.shard(g)).to(p.device)
        state = replica_step(state, tree_map(draw, params), lr)
        if r % sync_every == sync_every - 1:
            state = easgd_sync(state, alpha, beta, mesh=mesh, axis=axis)
    return state, local_sgd_sync(state, mesh=mesh, axis=axis)


def pod_rank(device: torch.device, job: dict) -> dict:
    """The EASGD pod form over the "pod" axis of job["mesh"] ((shape, axis
    names); by default a 1-D ("pod",) mesh of the whole world): job
    {"params" (a numpy tree), "rounds", "seed", "lr", "alpha", "beta",
    "sync_every"}, R = the pod axis's size. Also, for each entry of
    job["slices"] ((mesh shape, axis names, spec, global shape)), the
    block `NamedSharding.local_slice` gives this rank, as (start, stop)
    pairs. Returns numpy trees of this rank's replica and the center after
    the last elastic round and after the local-SGD sync, `Mesh.stats`,
    the bits a row of signed zeros and NaN payloads keeps through
    `Mesh.all_gather_rows` and `Mesh.all_to_all_rows` over the pod axis
    (each rank sends every rank its row, its world rank in the last
    element), and
    the modules of jax or the reference this process loaded."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.nn.sharding import NamedSharding
    mesh = Mesh(*(job.get("mesh") or ((dist.get_world_size(),), ("pod",))))
    pods = mesh.size("pod")
    params = _tree_to(job["params"], device)
    elastic, local = easgd_rounds(
        params, pods, job["rounds"], job["seed"], job["lr"], job["alpha"],
        job["beta"], job.get("sync_every", 2), mesh=mesh)
    slices = []
    for shape, names, spec, gshape in job.get("slices", ()):
        sl = NamedSharding(Mesh(shape, names), spec).local_slice(gshape)
        slices.append([(s.start, s.stop) for s in sl])
    row = torch.tensor([-0.0, 0.0, -0.0, float(mesh.rank)], device=device)
    row = row.view(torch.int32).clone()
    row[1] = -0x3FFFFF                   # 0xFFC00001: a NaN with a payload
    row = row.view(torch.float32).reshape(1, 4)
    gathered = mesh.all_gather_rows(row, "pod")
    swapped = torch.cat(mesh.all_to_all_rows([row] * pods, [1] * pods,
                                             "pod"))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {"rank": mesh.rank, "coords": dict(mesh.coords),
            "sent_bits": row.view(torch.int32).cpu().numpy(),
            "gathered_bits": gathered.view(torch.int32).cpu().numpy(),
            "swapped_bits": swapped.view(torch.int32).cpu().numpy(),
            "elastic": _tree_numpy({"replicas": elastic.replicas,
                                    "center": elastic.center}),
            "local": _tree_numpy({"replicas": local.replicas,
                                  "center": local.center}),
            "slices": slices, "collectives": dict(mesh.stats),
            "foreign_modules": _foreign_modules()}

# ---------------------------------------------------------------------------
# the LM's sharded step
# ---------------------------------------------------------------------------

#: the job keys `lm_rank` reads, with their defaults where optional
LM_DEFAULTS = {"mesh": ((2, 2), ("data", "model")), "params": None,
               "seed": None, "init_cfg": None, "lr": 3e-4,
               "accum": 1, "grad_dtype": "float32", "steps": None,
               "want_grads": None, "want_params": None,
               "report_grads": False,
               "report_params": False, "profile_steps": 0,
               "log_steps": False}


def save_flat_params(params: dict, cfg, path: str) -> None:
    """Write a whole LM parameter tree to `path` as one flat fp32 array,
    its leaves in `lm_param_specs(cfg)` order."""
    from repro_torch.models.lm import lm_param_specs
    from repro_torch.nn.params import tree_leaves, tree_map
    with open(path, "wb") as f:
        for t in tree_leaves(tree_map(lambda s, w: w, lm_param_specs(cfg),
                                      params)):
            t.detach().float().cpu().numpy().tofile(f)


def load_flat_params(path: str, cfg) -> dict:
    """`save_flat_params`' tree, memory-mapped copy-on-write: a rank that
    takes its blocks reads only their pages."""
    from repro_torch.models.lm import lm_param_specs
    from repro_torch.nn.params import tree_map
    flat, off = np.memmap(path, np.float32, "c"), 0

    def view(spec):
        nonlocal off
        n = int(np.prod(spec.shape))
        off += n
        return flat[off - n:off].reshape(spec.shape)
    return tree_map(view, lm_param_specs(cfg))


def _owns(sh) -> bool:
    """Whether this rank is the first holder of its block: coordinate 0
    on every axis the spec does not shard (its replicas count once)."""
    from repro_torch.nn.sharding import spec_axes
    named = spec_axes(sh.spec)
    return all(c == 0 for a, c in sh.mesh.coords.items() if a not in named)


def lm_rank(device: torch.device, job: dict) -> dict:
    """One rank of `build_lm_train_step(cfg, adamw(lr), rules, accum,
    grad_dtype, mesh=)` over job["mesh"] ((shape, axis names), default
    (data 2, model 2)). job:
      cfg           the ModelConfig (its moe_groups must split over the
                    batch's axes)
      rules         the name of an `nn.sharding` table ("FSDP_RULES", ...)
      params        the whole initial parameters: numpy, or tensors on the
                    rank's device (CUDA IPC views of the caller's); the
                    rank copies its blocks (`models.lm.shard_lm_params`)
      seed          instead of params: the rank draws the whole tree of
                    init_cfg (default cfg) on its device
                    (`init_lm_params`, the caller's bits on the same kind
                    of device), keeps cfg's first units and copies its
                    blocks
      batches       the GLOBAL batches (numpy dicts), one a step
      steps         how many to run (default all); 0 runs none
      want_grads    whole gradients (numpy or tensors on the device) to
                    hold step 0's against (the gradients its optimizer
                    got): the rank reports, a leaf, the squared error and
                    squared norm of its block, and whether it is the
                    block's first holder (`_owns`)
      want_params   whole parameters to hold the final ones against, as
                    want_grads, or the path of `save_flat_params`' file
      lr, accum, grad_dtype, profile_steps (the last steps under
      torch.profiler, on a card), report_grads (each step's gradient
      blocks as the optimizer gets them, numpy), report_params (the final
      blocks, numpy), log_steps (rank 0 prints a line a step).
    Returns plain values: coordinates, the losses, ce and aux of each
    step, host ms and device span ms a step, `Mesh.stats` of each step,
    the kernel launches of each step, the peak, device-busy ms a
    profiled step, this rank's parameter bytes, and the modules of jax or
    the reference this process loaded."""
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.mesh import COLLECTIVES, Mesh
    from repro_torch.models.lm import init_lm_params, lm_param_shardings
    from repro_torch.nn import sharding
    from repro_torch.nn.params import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import Optimizer
    from repro_torch.train.steps import build_lm_train_step
    job = {**LM_DEFAULTS, **job}
    if device.type == "cpu":
        # the ranks share the host's cores: one thread each, where torch's
        # default (every core, a rank) would oversubscribe them
        torch.set_num_threads(1)
    cfg, rules = job["cfg"], getattr(sharding, job["rules"])
    mesh = Mesh(*job["mesh"])
    shardings = lm_param_shardings(cfg, rules, mesh)
    whole = job["params"]
    if whole is None:
        whole = init_lm_params(job["init_cfg"] or cfg, job["seed"], device)
        whole["blocks"] = tree_map(lambda t: t[:cfg.n_units],
                                   whole["blocks"])
    elif not isinstance(tree_leaves(whole)[0], torch.Tensor):
        whole = tree_map(torch.from_numpy, whole)
    # mapped over the shardings: the blocks keep the specs' leaf order
    params = tree_map(lambda sh, t: sh.shard(t).to(device, copy=True),
                      shardings, whole)
    del whole
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    opt = adamw(job["lr"])
    seen = []

    def apply(p, g, s, t, **kw):
        seen.append(g)
        return opt.apply(p, g, s, t, **kw)
    spy = Optimizer(opt.init, apply, opt.name)
    state = spy.init(params)
    step = build_lm_train_step(cfg, spy, rules, job["accum"],
                               job["grad_dtype"], mesh=mesh)
    batches = [{k: torch.from_numpy(np.asarray(v)).to(device)
                for k, v in b.items()} for b in job["batches"]]
    out = {"rank": mesh.rank, "coords": dict(mesh.coords),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params))}
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    n_steps = len(batches) if job["steps"] is None else job["steps"]
    losses, parts, host_ms, span_ms, coll, launches = [], [], [], [], [], []
    prof, n_prof = None, job["profile_steps"]
    step0_grads = None
    for t in range(n_steps):
        if cuda and n_prof and t == n_steps - n_prof:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize(device)
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        mesh.reset_stats()
        before = {k.name: k.launches for k in KERNELS}
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[t], t)
        losses.append(float(m["loss"]))            # syncs the step
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if cuda:
            ev1.record()
            ev1.synchronize()
            span_ms.append(ev0.elapsed_time(ev1))
        parts.append({k: float(m[k]) for k in ("ce", "aux")})
        if job["log_steps"] and mesh.rank == 0:
            print(f"  lm_rank {job['rules']} step {t}: loss {losses[-1]}, "
                  f"{host_ms[-1]:.1f} host ms, collectives "
                  f"{sum(mesh.stats[f'{op}_ms'] for op in COLLECTIVES):.1f}"
                  " ms", flush=True)
        launches.append({k.name: k.launches - before[k.name]
                         for k in KERNELS})
        coll.append(dict(mesh.stats))
        if t == 0:
            step0_grads = seen[0]
        if not job["report_grads"]:
            seen.clear()
    busy = _profiled_busy_ms(prof, device, n_prof)

    def block_errors(got, whole):
        """A leaf each: the squared error of this rank's block of `got`
        against its block of `whole`, the block's squared norm there, and
        whether this rank is its first holder."""
        want = tree_map(lambda sh, w: w, shardings, whole)
        errs = []
        for g, w, sh in zip(tree_leaves(got), tree_leaves(want),
                            tree_leaves(shardings)):
            w = sh.shard(torch.as_tensor(w)).to(device, torch.float32)
            errs.append({"err_sq": float((g.float() - w).square().sum()),
                         "ref_sq": float(w.square().sum()),
                         "owner": _owns(sh)})
        return errs
    if job["want_grads"] is not None:
        if step0_grads is None:
            raise ValueError("want_grads needs at least one step")
        out["grad_errors"] = block_errors(step0_grads, job["want_grads"])
    if job["want_params"] is not None:
        whole = job["want_params"]
        if isinstance(whole, str):
            whole = load_flat_params(whole, cfg)
        out["param_errors"] = block_errors(params, whole)
    out.update(losses=losses, parts=parts, host_ms=host_ms,
               device_span_ms=span_ms, collectives=coll, launches=launches,
               device_busy_ms_per_step=busy,
               peak_bytes=(torch.cuda.max_memory_allocated(device)
                           if cuda else None),
               foreign_modules=_foreign_modules())
    if job["report_grads"]:
        out["grads"] = [_tree_numpy(tree_map(lambda g: g.float(), g))
                        for g in seen]
    if job["report_params"]:
        out["params"] = _tree_numpy(params)
    del params, state, seen, batches, step0_grads
    if cuda:
        # the next call in this world starts from an empty cache
        gc.collect()
        torch.cuda.empty_cache()
    return out


#: the job keys `lm_serve_rank` reads, with their defaults where optional
LM_SERVE_DEFAULTS = {"mesh": ((1, 4), ("data", "model")), "params": None,
                     "seed": None, "init_cfg": None, "prompt": None,
                     "max_len": None, "decode": 0, "feed": None,
                     "positions": None, "report_logits": True,
                     "report_caches": False, "engine": None}


def _rank_params(job: dict, cfg, shardings, device: torch.device) -> dict:
    """This rank's blocks of job["params"] (numpy, or tensors on the
    device: CUDA IPC views of the caller's), or of the tree job["seed"]
    draws on the device for job["init_cfg"] (default cfg), cut to cfg's
    units: the ranks draw one at a time, so the device holds one whole
    tree at once."""
    from repro_torch.models.lm import init_lm_params
    from repro_torch.nn.params import tree_leaves, tree_map

    def blocks(whole):
        # mapped over the shardings: the blocks keep the specs' leaf order
        return tree_map(lambda sh, t: sh.shard(t).to(device, copy=True),
                        shardings, whole)
    whole = job["params"]
    if whole is not None:
        if not isinstance(tree_leaves(whole)[0], torch.Tensor):
            whole = tree_map(torch.from_numpy, whole)
        return blocks(whole)
    out = None
    for turn in range(dist.get_world_size()):
        if turn == dist.get_rank():
            whole = init_lm_params(job["init_cfg"] or cfg, job["seed"],
                                   device)
            whole["blocks"] = tree_map(lambda t: t[:cfg.n_units],
                                       whole["blocks"])
            out = blocks(whole)
            del whole
            if device.type == "cuda":
                torch.cuda.synchronize(device)
                torch.cuda.empty_cache()
        dist.barrier()
    return out


def serve_steps(params: dict, cfg, prompt, n_decode: int,
                max_len: int | None = None, feed=None, positions=None,
                rules=None, mesh=None, run=None):
    """`prefill_step` on `prompt` (tokens (B, S) or a dict of the
    frontends' leaves, numpy) into fresh caches of `max_len` positions
    (default S + n_decode; this rank's blocks with a mesh), then n_decode
    `decode_step`s, step i at positions[i] (an int, or (B,) per row;
    default S + i), fed feed[i] ((B,), or (B, K) codebook tokens) or the
    argmax of the step before. `run(fn)` runs each step's call and
    returns its logits (default: the logits as fp32). Returns (the
    caches, the tokens fed)."""
    from repro_torch.models.lm import decode_step, init_caches, prefill_step
    from repro_torch.nn.sharding import SERVE_RULES
    rules = SERVE_RULES if rules is None else rules
    if run is None:
        def run(fn):
            with torch.no_grad():
                return fn()[0].float()
    dev = next(iter(params["embed"].values())).device
    batch = prompt if isinstance(prompt, dict) else {"tokens": prompt}
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in batch.items()}
    n = len(next(iter(batch.values())))
    s = sum(batch[k].shape[1] for k in ("embeds", "tokens") if k in batch)
    caches = init_caches(cfg, n, max_len or s + n_decode, dev, rules, mesh)
    last = run(lambda: prefill_step(params, batch, caches, cfg, rules,
                                    mesh))
    fed = []
    for i in range(n_decode):
        tok = last.argmax(-1) if feed is None else torch.as_tensor(
            np.asarray(feed[i]), device=dev).long()
        pos = s + i if positions is None else positions[i]
        if np.ndim(pos):
            pos = torch.as_tensor(np.asarray(pos), device=dev).long()
        fed.append(tok.cpu().numpy().tolist())
        last = run(lambda: decode_step(params, tok[:, None], caches, pos,
                                       cfg, rules, mesh))
    return caches, fed


def lm_serve_rank(device: torch.device, job: dict) -> dict:
    """One rank of LM serving over job["mesh"] ((shape, axis names),
    default (data 1, model 4)): `prefill_step` and `decode_step(rules=,
    mesh=)` on the rank's parameter and cache blocks. job:
      cfg           the ModelConfig
      rules         the name of an `nn.sharding` table, or a table
      params, seed, init_cfg   as `lm_rank`'s
      prompt        the whole batch's prompt: tokens (B, S) numpy, or a
                    dict of numpy leaves (the frontends' embeddings)
      max_len       the caches' positions (default S + decode)
      decode        decode steps after the prefill, at positions S, S+1..
                    or positions[i] (an int or (B,) a step)
      feed          (decode, B) tokens fed at each step (teacher-forced);
                    None feeds each step's argmax of the gathered logits
      report_logits every step's gathered logits (numpy fp32; "first":
                    rank 0's alone; else only their bit checksums),
                    report_caches the rank's cache blocks at the end
      engine        instead of the steps, {"slots", "max_len",
                    "requests": [(uid, prompt, max_new_tokens)], "alone"}:
                    `ServeEngine(rules=, mesh=)` drains them; with
                    "alone", each again in a fresh engine by itself.
    Returns plain values: coordinates, the rank's parameter and cache
    bytes, each step's (prefill, then the decodes) logits or checksums,
    the tokens fed, host ms, `Mesh.stats` and kernel launches, the peak,
    the engine's completed requests, and the modules of jax or the
    reference this process loaded."""
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.lm import lm_param_shardings
    from repro_torch.nn import sharding
    from repro_torch.nn.params import tree_leaves, tree_map
    from repro_torch.serve.engine import Request, ServeEngine
    job = {**LM_SERVE_DEFAULTS, **job}
    if device.type == "cpu":
        torch.set_num_threads(1)
    cfg = job["cfg"]
    rules = job["rules"] if isinstance(job["rules"], dict) \
        else getattr(sharding, job["rules"])
    mesh = Mesh(*job["mesh"])
    params = _rank_params(job, cfg, lm_param_shardings(cfg, rules, mesh),
                          device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    out = {"rank": mesh.rank, "coords": dict(mesh.coords),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(params)),
           "foreign_modules": None}
    logits, bits, fed, host_ms, coll, launches = [], [], None, [], [], []
    report = job["report_logits"] is True or (
        job["report_logits"] == "first" and mesh.rank == 0)

    def run(fn):
        mesh.reset_stats()
        before = {k.name: k.launches for k in KERNELS}
        t0 = time.perf_counter()
        with torch.no_grad():
            lg, _ = fn()
        lg = lg.float()
        if cuda:
            torch.cuda.synchronize(device)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({k.name: k.launches - before[k.name]
                         for k in KERNELS})
        coll.append(dict(mesh.stats))
        bits.append(bit_checksum(lg))
        if report:
            logits.append(lg.cpu().numpy())
        return lg

    if job["engine"] is not None:
        e = job["engine"]

        def drain(requests):
            engine = ServeEngine(params, cfg, e["slots"], e["max_len"],
                                 rules, mesh=mesh)
            for uid, prompt, budget in requests:
                engine.submit(Request(uid=uid, prompt=np.asarray(prompt),
                                      max_new_tokens=budget))
            t0 = time.perf_counter()
            with torch.no_grad():
                done = engine.run_until_drained()
            return engine, {"completed": {u: list(v)
                                          for u, v in done.items()},
                            "steps": engine.steps_run,
                            "host_s": time.perf_counter() - t0}
        mesh.reset_stats()
        before = {k.name: k.launches for k in KERNELS}
        engine, out["engine"] = drain(e["requests"])
        if e.get("alone"):
            out["engine"]["alone"] = {}
            for r in e["requests"]:
                engine = None            # one engine's caches at a time
                engine, got = drain([r])
                out["engine"]["alone"].update(got["completed"])
        caches = engine.caches
        launches.append({k.name: k.launches - before[k.name]
                         for k in KERNELS})
        coll.append(dict(mesh.stats))
    else:
        caches, fed = serve_steps(params, cfg, job["prompt"], job["decode"],
                                  job["max_len"], job["feed"],
                                  job["positions"], rules, mesh, run)
    out.update(logits=logits if report else None,
               logits_bits=bits, fed=fed, host_ms=host_ms,
               collectives=coll, launches=launches,
               cache_bytes=sum(t.numel() * t.element_size()
                               for c in caches.values()
                               for t in c.values()),
               peak_bytes=(torch.cuda.max_memory_allocated(device)
                           if cuda else None),
               foreign_modules=_foreign_modules())
    if job["report_caches"]:
        out["caches"] = {name: {k: (t.float() if t.dtype == torch.bfloat16
                                    else t).cpu().numpy()
                                for k, t in c.items()}
                         for name, c in caches.items()}
    del params, caches
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sharding_rank(device: torch.device, job: dict) -> dict:
    """`nn.sharding`'s moves on this rank of job["mesh"] ((shape, axis
    names)), forward and backward. Each of job["cases"]:
      {"kind": "gather" | "replicate", "rules", "axes", "x"}: this rank's
          storage block of the whole weight x (numpy) through
          `gather_weight` or `replicate_weight`;
      {"kind": "activation", "rules", "axes", "src", "partial", "x"}:
          x[rank] (numpy, this rank's block) through `shard_activation`.
    The output's cotangent is a standard normal draw of
    RandomState(job["seed"] + rank). Returns, a case, the output, the
    cotangent and the input's gradient (numpy), with this rank's
    coordinates and `Mesh.stats`."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.nn import sharding as S
    mesh = Mesh(*job["mesh"])
    out = []
    for case in job["cases"]:
        rules = getattr(S, case["rules"])
        mesh.reset_stats()
        if case["kind"] == "activation":
            x = torch.from_numpy(np.array(case["x"][mesh.rank])).to(device)
            x.requires_grad_()
            y = S.shard_activation(x, case["axes"], rules, mesh,
                                   case["src"], case["partial"])
        else:
            whole = torch.from_numpy(np.array(case["x"])).to(device)
            spec = S.resolve_sized(case["axes"], rules, mesh, whole.shape)
            x = S.NamedSharding(mesh, spec).shard(whole).clone()
            x.requires_grad_()
            fn = S.gather_weight if case["kind"] == "gather" \
                else S.replicate_weight
            y = fn(x, case["axes"], rules, mesh, tuple(whole.shape))
        cot = torch.from_numpy(np.random.RandomState(
            job["seed"] + mesh.rank).standard_normal(tuple(y.shape)).astype(
                np.float32)).to(device)
        (y * cot).sum().backward()
        out.append({"y": y.detach().cpu().numpy(),
                    "cot": cot.cpu().numpy(),
                    "grad": x.grad.cpu().numpy(),
                    "coords": dict(mesh.coords), "stats": dict(mesh.stats)})
    return {"cases": out, "foreign_modules": _foreign_modules()}
