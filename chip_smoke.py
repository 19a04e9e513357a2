#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. print the card's name and power limit (nvidia-smi);
2. build the three CUDA kernels of the serving path with nvcc (sm_90a),
   one process per source, all at once;
3. hold each kernel against its plain PyTorch version on the card at the
   serving path's dlrm-m1 shapes (pads, an all-pad bag, mean mode,
   writeback entries, rows above 2**24 and byte offsets above 2**32), and
   time it beside the plain version and, where one PyTorch call computes
   the same function, that call;
4. serve dlrm-m1 at full width through `repro_torch.launch.serve` (random
   weights from a seeded torch.Generator, 64 Zipf-1.05 requests), count
   each kernel's launches in that run, and recompute one batch with the
   plain versions on the card;
5. print one JSON line of per-kernel numbers, then the result line.

Without CUDA, or without the rest of the checkout, it exits non-zero
before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: the serving path's shapes at full dlrm-m1 width
ARCH = "dlrm-m1"
REQUESTS, BATCH, MAX_BATCH = 64, 4, 16
TOL_BAG = 1e-5        # abs; the kernel walks L in the plain version's order
TOL_DOT = 1e-5        # abs + rel*|plain|: fp32 FMA chain vs cuBLAS fp32
TOL_PROBS = 1e-5      # abs, served vs plain-recomputed probabilities


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    """Least time for the work on the card, and which side bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of fn over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernel_ms(torch, fn, iters: int, name: str) -> float | None:
    """Mean device time per launch of the CUDA kernels whose name holds
    `name`, from torch.profiler; None when the trace has no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = count = 0
    for evt in prof.key_averages():
        if name in evt.key:
            total += getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0))
            count += evt.count
    return total / count / 1e3 if count and total else None


def check_embedding_bag(torch, dev, c_rows: int, d: int, n_bags: int,
                        length: int) -> dict:
    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    table = torch.randn((c_rows, d), generator=g, device=dev)
    idx = torch.randint(0, c_rows, (n_bags, length), generator=g,
                        device=dev, dtype=torch.int32)
    lens = torch.randint(0, length + 1, (n_bags,), generator=g, device=dev)
    idx[torch.arange(length, device=dev)[None, :] >= lens[:, None]] = -1
    idx[0] = -1                                     # an all-pad bag
    idx[1] = c_rows - 1 - torch.arange(length, device=dev,
                                       dtype=torch.int32)  # rows > 2**24
    idx[2, ::2] = -1                                 # interleaved pads
    n_valid = int((idx >= 0).sum())
    err = 0.0
    for mode in ("sum", "mean"):
        got = kb.embedding_bag(table, idx, mode)
        want = ref.embedding_bag_ref(table, idx, mode)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        log(f"  embedding_bag[{mode}] max_abs_err={e:.3e} (tol {TOL_BAG})")
        if not e <= TOL_BAG or not torch.isfinite(got).all():
            raise AssertionError(f"embedding_bag[{mode}] disagrees: {e}")
        err = max(err, e)
    if float(got[0].abs().max()) != 0.0:
        raise AssertionError("all-pad bag did not pool to zero")
    valid = idx >= 0
    flat = idx[valid].long()
    offsets = torch.cumsum(valid.sum(1), 0) - valid.sum(1)
    lib = torch.nn.functional.embedding_bag
    out = {
        "ms": time_ms(torch, lambda: kb.embedding_bag(table, idx), 200),
        "device_ms": device_kernel_ms(
            torch, lambda: kb.embedding_bag(table, idx), 50,
            "embedding_bag_kernel"),
        "plain_ms": time_ms(
            torch, lambda: ref.embedding_bag_ref(table, idx), 20),
        "library_ms": time_ms(
            torch, lambda: lib(flat, table, offsets, mode="sum"), 200),
        "max_abs_err": err,
    }
    out["bound_ms"], out["bound_by"] = bound_ms(
        n_valid * d * 4 + n_bags * length * 4 + n_bags * d * 4,
        n_valid * d)
    log(f"  embedding_bag H={c_rows} bags={n_bags} L={length} D={d} "
        f"valid={n_valid}: {out}")
    del table
    return out


def check_dot_interaction(torch, dev, b: int, f: int, d: int) -> dict:
    from repro_torch.kernels import dot_interaction as kd
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    z = torch.randn((b, f, d), generator=g, device=dev)
    got = kd.dot_interaction(z)
    want = ref.dot_interaction_ref(z)
    torch.cuda.synchronize()
    if got.shape != (b, f * (f - 1) // 2):
        raise AssertionError(f"dot_interaction shape {tuple(got.shape)}")
    diff = (got - want).abs()
    err = float(diff.max())
    ok = bool((diff <= TOL_DOT + TOL_DOT * want.abs()).all())
    log(f"  dot_interaction max_abs_err={err:.3e} "
        f"(tol {TOL_DOT} abs + {TOL_DOT} rel)")
    if not ok:
        raise AssertionError(f"dot_interaction disagrees: {err}")
    p = f * (f - 1) // 2
    out = {
        "ms": time_ms(torch, lambda: kd.dot_interaction(z), 200),
        "device_ms": device_kernel_ms(
            torch, lambda: kd.dot_interaction(z), 50,
            "dot_interaction_kernel"),
        "plain_ms": time_ms(torch, lambda: ref.dot_interaction_ref(z), 200),
        "library_ms": None,
        "max_abs_err": err,
        # informative only: torch.bmm gives the full unpacked Z Z^T
        "bmm_unpacked_ms": time_ms(
            torch, lambda: torch.bmm(z, z.transpose(1, 2)), 200),
    }
    out["bound_ms"], out["bound_by"] = bound_ms(
        b * f * d * 4 + b * p * 4, b * p * 2 * d)
    log(f"  dot_interaction B={b} F={f} D={d}: {out}")
    return out


def check_cache_exchange(torch, dev, r_rows: int, c_rows: int, d: int,
                         n: int) -> dict:
    from repro_torch.kernels import cache_ops as kc
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    capacity = torch.empty((r_rows, d), device=dev).normal_(generator=g)
    cache = torch.empty((c_rows, d), device=dev).normal_(generator=g)
    cap_accum = torch.rand((r_rows,), generator=g, device=dev)
    cache_accum = torch.rand((c_rows,), generator=g, device=dev)
    freq = torch.rand((c_rows,), generator=g, device=dev)
    slots = torch.randperm(c_rows, generator=g, device=dev)[:n].int()
    rows = torch.randperm(r_rows, generator=g, device=dev)[:2 * n].int()
    fetch, evict = rows[:n].clone(), rows[n:].clone()
    del rows
    fetch[0], evict[0] = r_rows - 1, r_rows - 2      # byte offsets > 2**35
    u = torch.rand((n,), generator=g, device=dev)
    evict[u < 0.5] = -1                              # half write back
    fetch[(u > 0.9)] = -1                            # pure writebacks
    slots[(u > 0.45) & (u < 0.5)] = -1               # pads
    counts = torch.rand((n,), generator=g, device=dev) * 10
    kc.check_worklist(slots, evict, fetch)
    live = slots >= 0
    n_wb = int((live & (evict >= 0)).sum())
    n_ft = int((live & (fetch >= 0)).sum())
    cap_rows = torch.cat([evict[live & (evict >= 0)],
                          fetch[live & (fetch >= 0)]]).long()
    s_rows = slots[live].long()
    tiers = (capacity, cache, cap_accum, cache_accum, freq)
    views = ((capacity, cap_rows), (cache, s_rows), (cap_accum, cap_rows),
             (cache_accum, s_rows), (freq, s_rows))

    def touched():
        return [t[i].clone() for t, i in views]

    def restore(vals):
        for (t, i), v in zip(views, vals):
            t[i] = v

    def checksum():
        # fp32 sums: deterministic for equal inputs, and no 87 GB upcast
        return [float(t.sum()) for t in tiers]

    before, sums = touched(), checksum()
    kc.cache_exchange(*tiers, slots, evict, fetch, counts)
    torch.cuda.synchronize()
    got = touched()
    restore(before)
    if checksum() != sums:
        raise AssertionError("cache_exchange wrote outside its worklist")
    ref.cache_exchange_ref(*tiers, slots, evict, fetch, counts)
    want = touched()
    err = max(float((a - b).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    equal = all(torch.equal(a, b) for a, b in zip(got, want))
    log(f"  cache_exchange bit-equal={equal} max_abs_err={err:.3e} "
        f"(tol 0: values are copied)")
    if not equal:
        raise AssertionError("cache_exchange is not bit-equal to plain")
    work = (slots, evict, fetch, counts)
    out = {
        "ms": time_ms(torch, lambda: kc.cache_exchange(*tiers, *work), 100),
        "device_ms": device_kernel_ms(
            torch, lambda: kc.cache_exchange(*tiers, *work), 20,
            "cache_exchange_kernel"),
        "plain_ms": time_ms(
            torch, lambda: ref.cache_exchange_ref(*tiers, *work), 10),
        "library_ms": None,
        "max_abs_err": err,
    }
    row = d * 4
    out["bound_ms"], out["bound_by"] = bound_ms(
        n * 16 + n_wb * 2 * (row + 4) + n_ft * 2 * (row + 4) + n_ft * 4,
        0)
    log(f"  cache_exchange R={r_rows} C={c_rows} entries={n} "
        f"writebacks={n_wb} fetches={n_ft}: {out}")
    del capacity, cache, cap_accum, cache_accum, freq
    return out


def plain_probs(torch, engine, cfg, req_dense, req_idx):
    """One request's probabilities from the plain versions on the card,
    against the capacity tier (the full mega table, never written)."""
    from repro_torch.kernels import ref
    from repro_torch.nn.layers import linear
    dev = engine.state.capacity.device
    b, f, lk = req_idx.shape
    idx = torch.as_tensor(req_idx, dtype=torch.int32, device=dev)
    pooled = ref.embedding_bag_ref(engine.state.capacity,
                                   idx.reshape(b * f, lk)).reshape(b, f, -1)
    x = torch.as_tensor(req_dense, device=dev)
    for i, p in enumerate(engine.dense["bottom"]):
        x = linear(p, x)
        if i < len(engine.dense["bottom"]) - 1:
            x = torch.relu(x)
    z = torch.cat([x[:, None, :], pooled], dim=1)
    y = torch.cat([x, ref.dot_interaction_ref(z)], dim=-1)
    for i, p in enumerate(engine.dense["top"]):
        y = linear(p, y)
        if i < len(engine.dense["top"]) - 1:
            y = torch.relu(y)
    return torch.sigmoid(y[:, 0]).cpu().numpy()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.core.cache import CachedEmbeddingBagCollection
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.kernels import KERNELS, build_all
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import ServeRequest, ServeResponse

    dev = resolve_device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log("gpu (nvidia-smi name, power.limit):")
    log(smi)

    # 2. build
    t0 = time.perf_counter()
    built = build_all(list(KERNELS))
    log(f"build: {len(built)} kernels compiled in "
        f"{time.perf_counter() - t0:.1f}s ({', '.join(built) or 'cached'})")
    for k in KERNELS:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")

    # 3. each kernel against its plain version at the path's shapes
    cfg = get_config(ARCH)
    cc = CachedEmbeddingBagCollection.build(cfg)
    c_rows, r_rows = cc.cache_rows, cc.ebc.plan.total_rows
    d, f = cfg.embed_dim, cfg.n_sparse_features
    log(f"phase 3: kernels vs plain at {ARCH} shapes "
        f"(R={r_rows}, C={c_rows}, D={d})")
    numbers = {
        "embedding_bag": check_embedding_bag(
            torch, dev, c_rows, d, MAX_BATCH * f, cfg.truncation),
        "dot_interaction": check_dot_interaction(
            torch, dev, MAX_BATCH, f + 1, d),
        "cache_exchange": check_cache_exchange(
            torch, dev, r_rows, c_rows, d, MAX_BATCH * f * cfg.truncation),
    }
    torch.cuda.empty_cache()

    # 4. serve dlrm-m1 at full width through the launcher
    argv = ["--arch", ARCH, "--cache-rows", str(c_rows), "--batch",
            str(BATCH), "--max-batch", str(MAX_BATCH), "--requests",
            str(REQUESTS), "--zipf-alpha", "1.05"]
    log(f"phase 4: python -m repro_torch.launch.serve {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    engine = serve_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    log(f"launches in the serving run: {launches} "
        f"over {engine.metrics.batches} batches")
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated()} bytes")
    served = [engine.results.get(u) for u in range(REQUESTS)]
    if not all(isinstance(s, ServeResponse) and not s.degraded
               and s.probs.shape == (BATCH,) and np.isfinite(s.probs).all()
               for s in served):
        raise AssertionError("not every request was served healthy with "
                             f"{BATCH} finite probabilities")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched: {launches}")
    nb = engine.metrics.batches
    phases = {k: v / nb * 1e3 for k, v in engine.metrics.phase_s.items()}
    log(f"host ms per batch by phase: "
        f"{json.dumps({k: round(v, 3) for k, v in phases.items()})} "
        f"(run wall {wall:.2f}s incl. init)")
    st = engine.cache_stats
    log(f"cache: hits={st.hits} misses={st.misses} fetches={st.fetches} "
        f"evictions={st.evictions} writebacks={st.writebacks}")

    # one batch recomputed with the plain versions on the card
    raw = make_dlrm_batch(cfg, BATCH, step=0, zipf_alpha=1.05)
    req_idx = cc.ebc.offset_indices(raw["idx"])
    want = plain_probs(torch, engine, cfg, raw["dense"], req_idx)
    err = float(np.abs(served[0].probs - want).max())
    log(f"request 0: served {served[0].probs.tolist()} plain "
        f"{want.tolist()} max_abs_err={err:.3e} (tol {TOL_PROBS})")
    if not err <= TOL_PROBS:
        raise AssertionError(f"served probabilities disagree: {err}")

    # device vs host time per serve step, on a few more requests
    from torch.profiler import ProfilerActivity, profile
    extra = range(REQUESTS, REQUESTS + 4 * (MAX_BATCH // BATCH))
    for uid in extra:
        raw = make_dlrm_batch(cfg, BATCH, step=uid, zipf_alpha=1.05)
        engine.submit(ServeRequest(uid, raw["dense"],
                                   cc.ebc.offset_indices(raw["idx"])))
    torch.cuda.synchronize()
    b0 = engine.metrics.batches
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run()
        torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / (engine.metrics.batches - b0)
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages())
    per_step = dev_us / 1e3 / (engine.metrics.batches - b0)
    log(f"profiled serve steps: host {host * 1e3:.3f} ms/step, device busy "
        f"{per_step:.3f} ms/step (profiler on)" if dev_us else
        f"profiled serve steps: host {host * 1e3:.3f} ms/step, device time "
        "not measured (trace holds no device time)")
    log(prof.key_averages().table(sort_by="self_cpu_time_total",
                                  row_limit=12))

    # 5. the numbers, then the result
    replaces = {"embedding_bag": "src/repro/kernels/embedding_bag.py:88",
                "dot_interaction": "src/repro/kernels/dot_interaction.py:37",
                "cache_exchange": "src/repro/kernels/cache_ops.py:114"}
    rows = []
    for k in KERNELS:
        nums = numbers[k.name]
        rows.append({
            "name": k.name, "route": "cuda",
            "source": os.path.relpath(k.source, ROOT),
            "replaces": replaces[k.name], "launches": launches[k.name],
            **{key: nums[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms")}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
