"""What one rank runs when the sharded DLRM steps train over a mesh.

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

import sys
import time

import numpy as np
import torch
import torch.distributed as dist

#: the job keys `train_rank` reads, with their defaults where optional
JOB_DEFAULTS = {"accum": None, "staged": False, "dense_lr": 0.01,
                "sparse_lr": 0.05, "sparse_eps": 1e-8, "report_arrays": False,
                "report_dense": False, "profile_steps": 0,
                "refusals": False}


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
    mesh = make_test_mesh(job["mesh"])
    setup = {"mesh_s": time.perf_counter() - t_in}
    ebc = EmbeddingBagCollection.build(cfg, n_shards=mesh.size("model"),
                                       strategy=job["strategy"])
    lo, hi = ebc.shard_range(mesh)
    replica = mesh.coords["data"]
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
    device_busy_ms = None
    if prof is not None:
        torch.cuda.synchronize(device)
        prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        busy = sum(getattr(e, "self_device_time_total", 0)
                   for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU)
        device_busy_ms = busy / 1e3 / n_prof if busy else None
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
           "foreign_modules": sorted(
               m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro"))}
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
