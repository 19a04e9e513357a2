#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. print the card's name and power limit (nvidia-smi);
2. build the eleven CUDA kernels of the serving and training paths (nine
   sources) with nvcc (sm_90a), one process per source, all at once;
3. hold each serving kernel against its plain PyTorch version on the card
   at the serving path's dlrm-m1 shapes (pads, an all-pad bag, mean mode,
   writeback entries, rows above 2**24 and byte offsets above 2**32), and
   time it beside the plain version and, where one PyTorch call computes
   the same function, that call; split embedding_bag's and
   dot_interaction's host µs per call into guard, allocation, stream
   handle, bare launch, wrapper and one PyTorch call;
4. serve dlrm-m1 at full width through `repro_torch.launch.serve` (random
   weights from a seeded torch.Generator, 64 Zipf-1.05 requests), count
   each kernel's launches in that run, and recompute one batch with the
   plain versions on the card; then free the serving state;
5. hold the two training kernels (the plan-driven dedup embedding bag and
   the fused sparse backward with row-wise AdaGrad) against their plain
   versions on a full-width dlrm-m1 mega table at a batch of 512 (rows
   above 2**24, a row repeated inside a bag, an all-pad bag), the dedup
   kernel again on a second table of another height and a second plan,
   then on the first (each bit-equal: no call reads a position an earlier
   call left in its uncleared row map), the fused update in place with its
   untouched rows checked, and time them; log the plan's longest CSR runs;
   time the plan-less embedding_bag on the same batch (bit-equal to plain)
   and dot_interaction at (512, 31, 64), the two kernels' training shapes;
5b. hold the cached tier's fetch, chunked fetch and commit against their
   plain versions on a full-width capacity tier and the plan's cache, at
   the worklist of one batch's misses (pads, writebacks, pure writebacks,
   a chunk at the table's end, installs remapped out of a chunk slab), and
   time them, with each fetch's host µs per call split into its guard,
   allocations, stream handle, bare launch, whole wrapper and the
   index_select of the same rows; check that the raw
   stream handle the wrappers launch on is PyTorch's current stream, also
   inside torch.cuda.stream(side);
5c. hold the segmented fused backward and the legacy row-wise AdaGrad
   against their plain versions on the full-width 8-owner table_wise mega
   table (205,375,296 rows, 52.6 GB) at one batch of 512 split by owner
   (rows above 2**24, an empty segment, pads, the table's last row,
   untouched rows by bit checksums), the segmented kernel bit-equal to the
   one-plan kernel (8 segments, one segment, the reference's seg_cap = U)
   and the two-pass pipeline bit-equal to the fused update, and time them;
6. train full-width dlrm-m1 at a batch of 512: 8 steps through
   `repro_torch.launch.train` (no plans), keeping the bit checksums of the
   initial and final table and accumulator, then 8 steps from the same
   seed through `ShardedLoader.pipeline(transform=sparse_plan_hook(...))`
   and `build_dlrm_train_step` (planned lookups), the launcher's final
   checksums equal to the ones recorded before the fused update's
   redesign; count each kernel's
   launches in each run, recompute the planned run's first step with the
   plain versions on the card, and profile its last steps;
7. train the same 8 batches from the same table through
   `build_cached_train_step`: (7a) `AsyncCachedTier` over the plan's cache
   with plans and the pipeline's lookahead, (7b) `AsyncCachedTier` and
   (7c) the sync collection over a small cache with chunked transfers;
   each must evict where asked, give the launcher's losses and, once
   materialized, its table and accumulator checksums;
8. train full-width dlrm-m1 under the 8-owner table_wise placement: (8a)
   TRAIN_STEPS steps through `build_tablewise_train_step` with the plan
   hook's batches and the next batch staged, one segmented update a step
   and the step's exchange metrics equal to the analytic traffic model,
   profiled; (8b) the oracle,
   `build_dlrm_train_step` on the same layout, seed and batches; 8a's
   losses and final table and accumulator checksums must equal 8b's bit
   for bit, and the checksums the recorded ones;
9. serve stablelm-1.6b at full width (random weights from a seeded
   torch.Generator, bf16 compute): (9a) hold the flash-attention kernel
   against its plain version at the prefill's (1, 32, 8192, 64) in bf16
   and fp32, the prefill_32k length on two heads, starcoder2-3b's dh 128
   and a ragged length (each bf16 shape against both the tiled plain
   version of the tensor-core kernel and the fp32 oracle), print the bf16
   kernel's ptxas registers and spills, probe its causality, and time it
   beside its plain version and SDPA (timed only); (9b) `prefill_step` on 8,192 tokens of
   `make_lm_batch` (exactly one kernel launch a layer), 16 greedy
   `decode_step`s, one profiled prefill; (9c) the same last position
   through an 8,191-token prefill (full attention, no kernel) and one
   decode step, held to 9b's logits; (9d) the LM launcher at the
   reference's defaults (8 requests, 4 slots, max_len 128, 16 new
   tokens), every request served in full, no kernel launched;
10. run the reference trainer at its defaults on full-width dlrm-m2
   (24.3 GB table): hold embedding_bag and dot_interaction against their
   plain versions at its training shapes; (10a) 8 steps through
   `repro_torch.launch.train` with the dense update (exactly one lookup
   and one interaction a step, no fused update, finite losses, the final
   checksums M2_FINAL_SUMS), then the dense update alone timed beside its
   bound; (10b) the same run cut at
   step 4 by a checkpoint and resumed by a second launcher call, bit-equal
   to 10a (losses and final checksums), with the save and restore seconds
   and bytes; (10c) `--sparse-apply sparse` for 4 steps from the same
   seed, held to 10a's losses and the dense table saved at step 4 within
   TOL_M2_SPARSE; (10d) `--chaos` on the smoke config for three seeds,
   each bit-equal to its fault-free run, a fault fired; (10e) full-width
   dlrm-m1 served under `--chaos`, all 32 requests served or shed;
11. print one JSON line of per-kernel numbers, then the result line.

Without CUDA, or without the rest of the checkout, it exits non-zero
before printing any result.

    python3 chip_smoke.py --evict-search

builds the kernels and bisects for the smallest cache (in steps of
EVICT_SEARCH_GRAIN rows) at which run 7b's TRAIN_STEPS async steps keep the
thrash guard, checks the sync schedule (7c) at that size, and prints the
trials as one JSON line.
"""
from __future__ import annotations

import gc
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
#: the training path's shapes: batch 512 -> 15,360 bags, 491,520 slots
TRAIN_BATCH, TRAIN_STEPS, PROFILED_STEPS = 512, 8, 4
SPARSE_LR, SPARSE_EPS = 0.05, 1e-8  # build_dlrm_train_step's defaults
TOL_FUSED = 1e-6      # abs + rel: bag sums in plain order, mean(g^2) by
#                       warp shuffles and rsqrtf
TOL_STEP = 1e-5       # abs + rel: one train step, kernels vs plain on card
#: bag rows a stage of the fused update's register body at D = 64
#: (csrc/fused_bag_backward_adagrad.cu, Depth<2>::K): phase 5 counts the
#: CSR runs longer than one stage
FUSED_STAGE_BAGS = 32
#: the final (mega, accum) bit checksums that the port's earlier chip runs
#: recorded for phase 6a's launcher run and for phases 8a/8b (H100 80GB
#: HBM3), before the fused update's redesign; the redesign keeps every bit
LAUNCHER_FINAL_SUMS = (4241575280325291242, -3422734398129733286)
TABLEWISE_FINAL_SUMS = (-6725920379925815923, -2627766141846941821)
#: host-clock loops of phase 5b's informative host_us breakdown
HOST_ITERS = 200
#: the cached eviction runs: 8-row chunked transfers over the smallest
#: cache at which the async run's thrash guard holds (it protects the
#: 87,271 rows two consecutive batches touch); `--evict-search` checks it
#: by bisection between EVICT_SEARCH_LO and EVICT_CACHE_ROWS in steps of
#: EVICT_SEARCH_GRAIN rows (87,040 fails at step 2)
EVICT_CACHE_ROWS, EVICT_CHUNK = 88_064, 8
EVICT_SEARCH_LO, EVICT_SEARCH_GRAIN = 65_536, 1_024
#: the table-wise runs: the 8 owners of a Zion / Big Basin box
TABLEWISE_OWNERS = 8
#: the LM serving path (phases 9a-9d): stablelm-1.6b at full width, the
#: prefill_32k cell cut to batch 1 and 8,192 tokens (its 32 x 32,768
#: positions of 100,352 bf16 logits alone would take 210 GB), then
#: LM_DECODE greedy decode steps; the caches hold LM_MAX_LEN positions
LM_ARCH = "stablelm-1.6b"
LM_PROMPT, LM_DECODE = 8192, 16
LM_MAX_LEN = LM_PROMPT + LM_DECODE
LM_PARAM_SEED = 0
#: the LM launcher at the reference launcher's defaults
LM_SERVE_ARGV = ["--arch", LM_ARCH, "--requests", "8", "--slots", "4",
                 "--max-len", "128", "--new-tokens", "16"]
#: phases 10a-10e: the reference trainer at its defaults on full-width
#: dlrm-m2 (94,900,001 rows x 64, 24.3 GB; the dense update's buffer is
#: as large again, and both fit one card, where dlrm-m1's would not):
#: M2_STEPS steps, cut at M2_RESUME_AT and resumed
M2_ARCH = "dlrm-m2"
M2_STEPS, M2_RESUME_AT = 8, 4
#: 10a's final (mega, accum) bit checksums, as this script's first run of
#: phase 10a recorded them (H100 80GB HBM3); the deterministic scatter
#: makes them a gate on the dense path's bits
M2_FINAL_SUMS = (-3071726836737484320, 7712813785258312859)
#: calls of the dense update alone that 10a times, then profiles
DENSE_TIMED = 3
#: 10c, the sparse update against the dense one, abs + rel on the losses,
#: the table and the accumulator: both add a row's slots in example order
#: (a row belongs to one table), and at full widths with tables cut 2,000x
#: the CPU gives the same bits; on the card mean(g^2) (warp shuffles vs
#: torch.mean) and rsqrt may differ by ulps, and 4 steps of the 1024-wide
#: MLP, whose loss leaps from ~0.6 to hundreds, amplify them; a wrong row
#: moves by its whole update, lr * g * rsqrt(acc) ~ 0.05
TOL_M2_SPARSE = 1e-3
#: 10d: the launcher's chaos on the card, cut to the smoke config (full
#: width would write a 24.7 GB bundle every two steps): seeds whose
#: schedules hold a torn bundle and a reader error (0), a preemption and
#: a killed reader (2), and all three kinds (3)
CHAOS_SEEDS = (0, 2, 3)
CHAOS_ARGV = ["--arch", M2_ARCH, "--smoke", "--steps", "16", "--ckpt-every",
              "2", "--log-every", "100"]
#: 10e: requests served under the serving tier's chaos
CHAOS_REQUESTS = 32
#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet)
BF16_FLOPS = 989e12
#: 9a: the kernel against its plain version at the prefill's shape (bf16
#: and fp32), the prefill_32k length on two heads (the plain version at 32
#: heads would need 137 GB of scores), starcoder2-3b's head dim, a ragged
#: length; (b, h, s, dh)
FLASH_SHAPES = (("stablelm", (1, 32, 8192, 64), "bfloat16"),
                ("stablelm_fp32", (1, 32, 8192, 64), "float32"),
                ("prefill_32k_2_heads", (1, 2, 32768, 64), "bfloat16"),
                ("starcoder2_dh128", (1, 24, 4096, 128), "bfloat16"),
                ("ragged", (1, 32, 8155, 64), "bfloat16"))
#: (rtol, atol) of the kernel against its plain version: fp32 gets the
#: reference's own fp32 kernel tolerance against ref.flash_attention_ref;
#: bf16 runs the tensor-core kernel against ref.flash_attention_tiled_ref,
#: which rounds where it does, and both round one fp32 result to bf16, so
#: they may differ by one bf16 ulp (2^-7 relative)
TOL_FLASH = {"float32": (2e-4, 2e-4), "bfloat16": (2 ** -7, 1e-3)}
#: bf16 against the fp32 oracle ref.flash_attention_ref: the kernel rounds
#: each P to bf16 (2^-9 relative) and divides by the unrounded sum, so O, a
#: convex combination of V's rows, moves by at most 2^-9 max|V| more
TOL_FLASH_ORACLE_V = 2 ** -9
#: 9c: the prefill's last logits (kernel path) against a decode step after
#: an 8,191-token prefill (full attention, no kernel), bf16 through 24
#: layers. Each bf16 rounding is 2^-9 relative and the two paths round at
#: other places (fp32 vs bf16 P.V, one GEMM over 8,192 rows vs one row);
#: at the smoke size (2 layers) on the CPU the same comparison gives a
#: relative L2 error of 1.2% and a largest difference of 0.039. Held: the
#: relative L2 error of the logits within 5e-2 and the largest difference
#: within 0.5 (logits are ~N(0, 1) from random weights); a wrong mask,
#: scale or tile would move them by tens of percent
TOL_LM_REL_L2, TOL_LM_ABS = 5e-2, 0.5


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
    """Mean device time per call of fn of the CUDA kernels whose name holds
    `name` (all of a call's launches of them), from torch.profiler's
    device-side events; None when the trace has no device time. A trace
    now and then comes back without device events, so an empty one is
    taken again, up to 3 times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(t for key, t in device_events(prof) if name in key)
        if total:
            return total / iters / 1e3
    return None


def device_events(prof) -> list[tuple[str, float]]:
    """(name, self device us) of a trace's device-side events, kernels and
    copies. A CPU op's self device time repeats the time of the kernels it
    launched, so a sum over every event would count that time twice."""
    from torch.autograd import DeviceType
    return [(e.key, getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)))
            for e in prof.key_averages() if e.device_type != DeviceType.CPU]


def kernel_ms_per_step(events, name: str) -> float:
    """Device ms per profiled step of the kernels whose name holds
    `name` (both of the dedup lookup's kernels for "dedup_")."""
    return sum(t for key, t in events if name in key) / 1e3 / PROFILED_STEPS


def reset_launches(kernels) -> None:
    for k in kernels:
        k.launches = 0


def read_launches(kernels, path: str, needed: tuple[str, ...]) -> dict:
    """The launch counts of one path's run; raises if a kernel of the
    path never launched."""
    counts = {k.name: k.launches for k in kernels}
    log(f"launches in the {path} run: {counts}")
    missing = [n for n in needed if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched: {missing}")
    return counts


def log_peak(torch, phase: str) -> None:
    log(f"max_memory_allocated [{phase}]: "
        f"{torch.cuda.max_memory_allocated()} bytes")


def free_device(torch) -> None:
    """Drop cached blocks after a phase; fail if a phase left tensors."""
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    log(f"memory_allocated after free: {held} bytes")
    if held > 1 << 30:
        raise AssertionError(f"{held} bytes still allocated between phases")
    torch.cuda.reset_peak_memory_stats()


def bit_checksum(torch, t) -> int:
    """Exact fingerprint of t's bits: the sum of its 64-bit words mod 2**64
    (plus a last odd 32-bit word). Integer sums do not depend on the order,
    any change of one word changes it, and it needs no upcast copy of a
    44 GB table."""
    w = t.reshape(-1).view(torch.int32)
    n = w.numel() & ~1
    return int(w[:n].view(torch.int64).sum()) + int(w[n:].sum())


def ptxas_report(build_log: str) -> dict[str, list[str]]:
    """{entry function: its registers and spill lines} from the
    `-Xptxas=-v` output of one nvcc run."""
    out, fn = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            out[fn] = []
        elif fn and ("registers" in line or "spill" in line):
            out[fn].append(line.strip())
    return out


def log_ptxas(kernel, name: str) -> None:
    """Log the registers and spills ptxas gave each entry function of
    `kernel`'s source whose name holds `name`."""
    report = ptxas_report(kernel.build_log)
    for fn, lines in report.items():
        if name in fn:
            log(f"  ptxas {fn}: {'; '.join(lines)}")
    if not report:
        log("  ptxas: no build log (the library was built by an earlier "
            "run)")


def close(a, b, tol: float) -> tuple[bool, float]:
    """|a - b| <= tol + tol * |b| everywhere, and the max abs difference."""
    diff = (a - b).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    return bool((diff <= tol + tol * b.abs()).all()), err


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
    res = kb.embedding_bag(table, idx)
    out["host_us"] = wrapper_host_us(
        torch, "embedding_bag", kb.KERNEL,
        lambda: kb.check_bag(table, idx),
        lambda: table.new_empty((n_bags, d)), table.get_device(),
        (table.data_ptr(), idx.data_ptr(), res.data_ptr(), n_bags, length,
         d, 0),
        lambda: kb.embedding_bag(table, idx),
        lambda: lib(flat, table, offsets, mode="sum"), "F.embedding_bag")
    del res
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
        "shape": [b, f, d],
        "library_ms": None,
        "max_abs_err": err,
        # informative only: torch.bmm gives the full unpacked Z Z^T
        "bmm_unpacked_ms": time_ms(
            torch, lambda: torch.bmm(z, z.transpose(1, 2)), 200),
    }
    out["bound_ms"], out["bound_by"] = bound_ms(
        b * f * d * 4 + b * p * 4, b * p * 2 * d)
    res = kd.dot_interaction(z)
    out["host_us"] = wrapper_host_us(
        torch, f"dot_interaction B={b}", kd.KERNEL, lambda: kd.check_dot(z),
        lambda: z.new_empty((b, p)), z.get_device(),
        (z.data_ptr(), res.data_ptr(), b, f, d),
        lambda: kd.dot_interaction(z),
        lambda: torch.bmm(z, z.transpose(1, 2)), "bmm_unpacked")
    del res
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
        return [bit_checksum(torch, t) for t in tiers]

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


def train_batch(cfg, ebc, step: int):
    """The training batch of `step` (numpy), idx offset to mega rows, with
    corner cases planted: an all-pad bag, a row above 2**24 repeated inside
    one bag and shared with another bag."""
    from repro_torch.data.synthetic import make_dlrm_batch
    raw = make_dlrm_batch(cfg, TRAIN_BATCH, step)
    idx = ebc.offset_indices(raw["idx"])
    top = ebc.plan.total_rows - 1
    idx[0, 0, :] = -1                        # an all-pad bag
    idx[1, 2, :6] = top                      # repeated inside one bag
    idx[3, 4, 0] = top                       # ... and shared with another
    idx[5, -1, ::3] = top - 1
    return idx


def dedup_twice(torch, kb, ref, ebc, cfg, table, flat, plan) -> float:
    """The dedup kernel on a second table and plan right after the first
    (the leading half of the rows and 7 more: 85,180,967 at full width,
    past 2**24; batch 1 folded into them), then on
    the first again: each result bit-equal to its plain version and to
    embedding_bag, so no call reads a map entry that an earlier call wrote.
    Returns the largest difference."""
    import numpy as np
    from repro_torch.kernels.sparse_plan import build_sparse_plan
    h2 = table.shape[0] // 2 + 7
    table2 = table[:h2]
    idx2 = train_batch(cfg, ebc, 1)
    idx2 = torch.as_tensor(np.where(idx2 >= 0, idx2 % h2, -1),
                           device=table.device)
    flat2 = idx2.reshape(flat.shape)
    plan2 = build_sparse_plan(idx2)
    err = 0.0
    for what, (t, x, p) in (("second table", (table2, flat2, plan2)),
                            ("first table again", (table, flat, plan))):
        got = kb.dedup_embedding_bag(t, x, p.unique_rows)
        want = ref.dedup_embedding_bag_ref(t, x, p.unique_rows)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        if not (torch.equal(got, want)
                and torch.equal(got, kb.embedding_bag(t, x))):
            raise AssertionError(f"dedup_embedding_bag on the {what} is "
                                 f"not bit-equal: {err}")
    n2 = int((plan2.unique_rows >= 0).sum())
    log(f"  dedup_embedding_bag twice in a row: H={table.shape[0]}, then "
        f"H={h2} ({n2} unique rows, max row "
        f"{int(plan2.unique_rows.max())}), then H={table.shape[0]} again: "
        f"each bit-equal to plain and to embedding_bag")
    return err


def check_training_kernels(torch, dev, cfg, ebc) -> dict:
    """Phase 5: the dedup embedding bag and the fused sparse backward on a
    full-width mega table, each against its plain version."""
    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_update as ku
    from repro_torch.kernels.sparse_plan import (build_sparse_plan,
                                                 build_sparse_plan_host)
    r_rows, d = ebc.plan.total_rows, cfg.embed_dim
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    table = torch.empty((r_rows, d), device=dev).normal_(generator=g)
    accum = torch.rand((r_rows,), generator=g, device=dev)
    idx_np = train_batch(cfg, ebc, 0)
    b, f, lk = idx_np.shape
    idx = torch.as_tensor(idx_np, device=dev)
    flat = idx.reshape(b * f, lk)
    plan = build_sparse_plan(idx)
    for name, got, want in zip(("rows", "offsets", "bags"), plan,
                               build_sparse_plan_host(idx_np)):
        if not (got.cpu().numpy() == want).all():
            raise AssertionError(f"device plan {name} != host plan")
    live = plan.unique_rows >= 0
    rows = plan.unique_rows[live].long()
    n_live, n_valid = rows.numel(), int((idx >= 0).sum())
    u = plan.unique_rows.numel()
    runs = (plan.bag_offsets[1:] - plan.bag_offsets[:-1])[live]
    log(f"  plan: {b * f} bags x L={lk}, {n_valid} valid slots, {n_live} "
        f"unique rows of U={u} plan entries (max row {int(rows.max())}); "
        f"bags per unique row: mean {n_valid / n_live:.2f}, longest run "
        f"{int(runs.max())}; device plan == host plan")
    log(f"  CSR runs: the five longest {sorted(runs.tolist())[-5:]}; "
        f"{int((runs > FUSED_STAGE_BAGS).sum())} of {n_live} longer than a "
        f"stage of the fused update ({FUSED_STAGE_BAGS} bags)")

    # -- dedup embedding bag: bit-equal to its plain version and to the
    #    plan-less kernel, sum and mean
    err = 0.0
    for mode in ("sum", "mean"):
        got = kb.dedup_embedding_bag(table, flat, plan.unique_rows, mode)
        want = ref.dedup_embedding_bag_ref(table, flat, plan.unique_rows,
                                           mode)
        plain_bag = kb.embedding_bag(table, flat, mode)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        if not (torch.equal(got, want) and torch.equal(got, plain_bag)):
            raise AssertionError(f"dedup_embedding_bag[{mode}] is not "
                                 f"bit-equal: {err}")
        log(f"  dedup_embedding_bag[{mode}] bit-equal to plain and to "
            f"embedding_bag (tol 0)")
    if float(got[0].abs().max()) != 0.0:
        raise AssertionError("all-pad bag did not pool to zero")
    err = max(err, dedup_twice(torch, kb, ref, ebc, cfg, table, flat, plan))
    valid = flat >= 0
    lib_idx = flat[valid].long()
    offsets = torch.cumsum(valid.sum(1), 0) - valid.sum(1)
    lib = torch.nn.functional.embedding_bag
    ur = plan.unique_rows

    def dedup():
        return kb.dedup_embedding_bag(table, flat, ur)

    bag = {
        "ms": time_ms(torch, dedup, 100),
        "device_ms": device_kernel_ms(torch, dedup, 20, "dedup_"),
        "plain_ms": time_ms(
            torch, lambda: ref.dedup_embedding_bag_ref(table, flat, ur), 5),
        "library_ms": time_ms(
            torch, lambda: lib(lib_idx, table, offsets, mode="sum"), 100),
        "max_abs_err": err,
        # informative only: the dedup kernel's two phases
        "gather_device_ms": device_kernel_ms(torch, dedup, 20,
                                             "dedup_gather_kernel"),
        "pool_device_ms": device_kernel_ms(torch, dedup, 20,
                                           "dedup_embedding_bag_kernel"),
    }
    bag["bound_ms"], bag["bound_by"] = bound_ms(
        n_live * d * 4 + b * f * lk * 4 + n_live * 4 + b * f * d * 4,
        n_valid * d)
    log(f"  dedup_embedding_bag: {bag}")

    # -- the plan-less embedding_bag on the same batch: the kernels line's
    #    second shape of that row. Its bound reads each unique row once,
    #    the dedup lookup's yardstick
    plain_bag = ref.embedding_bag_ref(table, flat)
    got_bag = kb.embedding_bag(table, flat)
    torch.cuda.synchronize()
    bag_err = float((got_bag - plain_bag).abs().max())
    if not torch.equal(got_bag, plain_bag):
        raise AssertionError(f"embedding_bag at the training batch is not "
                             f"bit-equal to plain: {bag_err}")
    del got_bag, plain_bag
    eb = {
        "shape": f"{b * f} bags x L={lk}, D={d}, {n_valid} lookups of "
                 f"{n_live} unique rows (batch {b})",
        "ms": time_ms(torch, lambda: kb.embedding_bag(table, flat), 100),
        "device_ms": device_kernel_ms(
            torch, lambda: kb.embedding_bag(table, flat), 20,
            "embedding_bag_kernel"),
        "plain_ms": time_ms(
            torch, lambda: ref.embedding_bag_ref(table, flat), 5),
        "library_ms": bag["library_ms"],
        "max_abs_err": bag_err,
    }
    eb["bound_ms"], eb["bound_by"] = bound_ms(
        n_live * d * 4 + b * f * lk * 4 + b * f * d * 4, n_valid * d)
    log(f"  embedding_bag (no plan), the same batch, bit-equal to plain: "
        f"{eb}")

    # -- fused sparse backward: in place, so save the touched rows, run the
    #    kernel, restore, show nothing else moved, run the plain version
    pooled = torch.randn((b * f, d), generator=g, device=dev) * 0.01
    near = torch.cat([rows - 1, rows + 1]).clamp(0, r_rows - 1)
    near = near[~torch.isin(near, rows)][:4096]
    before = (table[rows].clone(), accum[rows].clone())
    near_before = (table[near].clone(), accum[near].clone())

    def checksum():
        return bit_checksum(torch, table), bit_checksum(torch, accum)

    sums = checksum()
    ku.fused_bag_backward_adagrad(table, accum, *plan, pooled, SPARSE_LR,
                                  SPARSE_EPS)
    torch.cuda.synchronize()
    got = (table[rows].clone(), accum[rows].clone())
    if not (torch.equal(table[near], near_before[0])
            and torch.equal(accum[near], near_before[1])):
        raise AssertionError("fused update moved an untouched neighbour row")
    table[rows], accum[rows] = before
    if checksum() != sums:
        raise AssertionError("fused update wrote outside the plan's rows")
    ref.fused_bag_backward_adagrad_ref(table, accum, *plan, pooled,
                                       SPARSE_LR, SPARSE_EPS)
    want = (table[rows].clone(), accum[rows].clone())
    ok_t, err_t = close(got[0], want[0], TOL_FUSED)
    ok_a, err_a = close(got[1], want[1], TOL_FUSED)
    moved = float((got[0] - before[0]).abs().max())
    log(f"  fused_bag_backward_adagrad: table max_abs_err={err_t:.3e} "
        f"accum max_abs_err={err_a:.3e} (tol {TOL_FUSED} abs + rel), "
        f"largest row change {moved:.3e}; {near.numel()} untouched "
        f"neighbour rows bit-equal, bit checksums of table and accum "
        f"equal after restore")
    if not (ok_t and ok_a) or moved == 0.0:
        raise AssertionError("fused_bag_backward_adagrad disagrees with "
                             f"plain: {err_t}, {err_a}")

    def fused():
        ku.fused_bag_backward_adagrad(table, accum, *plan, pooled,
                                      SPARSE_LR, SPARSE_EPS)

    upd = {
        "ms": time_ms(torch, fused, 100),
        "device_ms": device_kernel_ms(torch, fused, 20,
                                      "fused_bag_backward_adagrad"),
        "plain_ms": time_ms(
            torch, lambda: ref.fused_bag_backward_adagrad_ref(
                table, accum, *plan, pooled, SPARSE_LR, SPARSE_EPS), 2, 1),
        # no single PyTorch call sums pooled bag gradients per unique row
        # and applies row-wise AdaGrad (torch.optim.Adagrad is dense and
        # per element)
        "library_ms": None,
        "max_abs_err": max(err_t, err_a),
    }
    upd["bound_ms"], upd["bound_by"] = bound_ms(
        n_live * 4 + (n_live + 1) * 4 + n_valid * 4 + b * f * d * 4
        + 2 * n_live * (d * 4 + 4),
        n_valid * d + n_live * 5 * d)
    upd.update(fused_parts_ms(torch, ku, table, accum, plan, pooled))
    log(f"  fused_bag_backward_adagrad: {upd}")
    del table, accum
    return {"dedup_embedding_bag": bag, "fused_bag_backward_adagrad": upd,
            "embedding_bag_train": eb}


def fused_parts_ms(torch, ku, table, accum, plan, pooled) -> dict:
    """Informative: the fused update's device ms on two parts of the plan,
    to show where its time goes: the longest CSR run alone (one warp walks
    it), and every run cut to its first 32 bags (the rest of the work
    without the long runs)."""
    import numpy as np
    rows = plan.unique_rows.cpu().numpy()
    offs = plan.bag_offsets.cpu().numpy()
    bags = plan.bag_ids.cpu().numpy()
    live = rows >= 0
    lens = np.where(live, np.diff(offs), 0)
    top = int(np.argmax(lens))
    cut = np.minimum(lens, 32)
    keep = np.concatenate([np.arange(o, o + c) for o, c in
                           zip(offs[:-1][live], cut[live])])
    dev = table.device
    parts = {
        "longest_run": (rows[top:top + 1], np.array([0, lens[top]]),
                        bags[offs[top]:offs[top + 1]]),
        "runs_cut_to_32": (rows, np.concatenate([[0], np.cumsum(cut)]),
                           bags[keep]),
    }
    out = {}
    for name, arrays in parts.items():
        r, o, g = (torch.as_tensor(np.asarray(x, np.int32), device=dev)
                   for x in arrays)
        out[f"{name}_device_ms"] = device_kernel_ms(
            torch, lambda: ku.fused_bag_backward_adagrad(
                table, accum, r, o, g, pooled, SPARSE_LR, SPARSE_EPS),
            20, "fused_bag_backward_adagrad")
    out["longest_run_bags"] = int(lens[top])
    return out


def host_us(torch, fn, iters: int = HOST_ITERS) -> float:
    """Mean host µs per call of fn on the host's clock (no synchronise
    inside the loop: what the caller's thread spends issuing it)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / iters * 1e6


def wrapper_host_us(torch, name, kernel, guard, alloc, device, args,
                    wrapper, library, library_name) -> dict:
    """Informative: where a wrapper's host time goes, each part timed in its
    own loop: the guard, the output allocations, the raw stream handle, the
    bare ctypes launch of `kernel` with `args` (the stream handle
    appended), the whole wrapper and one PyTorch call over the same inputs
    (`library_name`), on the same clock. The launch loops enqueue kernels
    of a few µs, so they read no less than the device's rate."""
    from repro_torch.kernels._build import stream_handle
    launch_args = (*args, stream_handle(device))
    out = {
        "guard": host_us(torch, guard),
        "alloc": host_us(torch, alloc),
        "stream_handle": host_us(torch, lambda: stream_handle(device)),
        "launch": host_us(torch, lambda: kernel._fn(*launch_args)),
        "wrapper": host_us(torch, wrapper),
        library_name: host_us(torch, library),
    }
    log(f"  {name} host µs per call: {out}")
    return out


def fetch_host_us(torch, name, kernel, guard, wrapper, n, capacity,
                  args, index_select) -> dict:
    """`wrapper_host_us` of a fetch: its allocations are the (n, D) slab
    and its accumulators, its PyTorch call `index_select` of the same
    rows."""
    d = capacity.shape[1]
    return wrapper_host_us(
        torch, name, kernel, guard,
        lambda: (capacity.new_empty((n, d)), capacity.new_empty((n,))),
        capacity.get_device(), args, wrapper, index_select, "index_select")


def check_stream_handle(torch, dev) -> None:
    """The raw handle the wrappers launch on is PyTorch's current stream,
    on the default stream and inside torch.cuda.stream(side)."""
    from repro_torch.kernels._build import stream_handle
    side = torch.cuda.Stream(dev)
    seen = [(stream_handle(dev), torch.cuda.current_stream(dev).cuda_stream)]
    with torch.cuda.stream(side):
        seen.append((stream_handle(dev),
                     torch.cuda.current_stream(dev).cuda_stream))
    if any(a != b for a, b in seen) or seen[1][0] != side.cuda_stream:
        raise AssertionError(f"stream_handle is not the current stream: "
                             f"{seen}, side {side.cuda_stream}")
    log(f"  stream_handle == current_stream(dev).cuda_stream on the default "
        f"and a side stream: {seen}")


def check_cache_movers(torch, dev, cfg, cc) -> dict:
    """Phase 5b: the cached tier's fetch, chunked fetch and commit against
    their plain versions on a full-width capacity tier and the plan's
    deployment cache, at the worklist of one training batch's misses."""
    from repro_torch.core.cache import _chunk_min_fill
    from repro_torch.kernels import cache_ops as kc
    from repro_torch.kernels import ref
    from repro_torch.kernels.sparse_plan import coalesce_rows
    import numpy as np
    check_stream_handle(torch, dev)
    r_rows, c_rows, d = cc.ebc.plan.total_rows, cc.cache_rows, cfg.embed_dim
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    capacity = torch.empty((r_rows, d), device=dev).normal_(generator=g)
    cap_accum = torch.rand((r_rows,), generator=g, device=dev)
    cache = torch.empty((c_rows, d), device=dev).normal_(generator=g)
    cache_accum = torch.rand((c_rows,), generator=g, device=dev)
    idx = train_batch(cfg, cc.ebc, 0)
    rows_np = np.unique(idx[idx >= 0]).astype(np.int64)   # the cold misses
    n = len(rows_np)
    i32 = dict(dtype=torch.int32, device=dev)

    def compare(name, got, want):
        """Bit-equality and the largest difference, from the same tensors."""
        err = max(float((a - b).abs().max()) if a.numel() else 0.0
                  for a, b in zip(got, want))
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"  {name} bit-equal={equal} max_abs_err={err:.3e} "
            f"(tol 0: values are copied)")
        if not equal:
            raise AssertionError(f"{name} is not bit-equal to plain")
        return err

    # -- row fetch: every 97th entry a pad, the table's last row included
    fetch = torch.as_tensor(rows_np, **i32)
    fetch[::97] = -1
    got = kc.cache_fetch(capacity, cap_accum, fetch)
    want = ref.cache_fetch_ref(capacity, cap_accum, fetch)
    torch.cuda.synchronize()
    fetch_err = compare("cache_fetch", got, want)
    n_ft = int((fetch >= 0).sum())
    lib_rows = fetch[fetch >= 0].long()
    fetch_out = {
        "ms": time_ms(torch, lambda: kc.cache_fetch(capacity, cap_accum,
                                                    fetch), 100),
        "device_ms": device_kernel_ms(
            torch, lambda: kc.cache_fetch(capacity, cap_accum, fetch), 20,
            "cache_fetch_kernel"),
        "plain_ms": time_ms(torch, lambda: ref.cache_fetch_ref(
            capacity, cap_accum, fetch), 20),
        # the one call that gathers the same rows (no pads, no accumulator)
        "library_ms": time_ms(
            torch, lambda: capacity.index_select(0, lib_rows), 100),
        "max_abs_err": fetch_err,
    }
    fetch_out["bound_ms"], fetch_out["bound_by"] = bound_ms(
        n * 4 + n_ft * (d * 4 + 4) + n * (d * 4 + 4), 0)
    shadow, shadow_accum = got
    fetch_out["host_us"] = fetch_host_us(
        torch, "cache_fetch", kc.FETCH_KERNEL,
        lambda: kc.check_fetch(capacity, cap_accum, fetch),
        lambda: kc.cache_fetch(capacity, cap_accum, fetch), n, capacity,
        (capacity.data_ptr(), cap_accum.data_ptr(), fetch.data_ptr(),
         shadow.data_ptr(), shadow_accum.data_ptr(), n, d),
        lambda: capacity.index_select(0, lib_rows))
    del shadow, shadow_accum
    log(f"  cache_fetch entries={n} "
        f"pads={n - n_ft} (max row {int(fetch.max())}): {fetch_out}")

    # -- chunked fetch: the coalescer's blocks of these rows, a block
    #    clamped at the table's end and a pad block
    chunk = 8
    starts_np, pos = coalesce_rows(rows_np, chunk, r_rows,
                                   min_fill=_chunk_min_fill(chunk))
    starts = torch.as_tensor(np.concatenate(
        [starts_np, [r_rows - chunk, -1]]).astype(np.int32), device=dev)
    kc.check_chunk_starts(starts, chunk, r_rows)
    got = kc.cache_fetch_chunked(capacity, cap_accum, starts, chunk)
    want = ref.cache_fetch_chunked_ref(capacity, cap_accum, starts, chunk)
    torch.cuda.synchronize()
    chunked_err = compare("cache_fetch_chunked", got, want)
    if not torch.equal(got[0][-2 * chunk:-chunk], capacity[r_rows - chunk:]):
        raise AssertionError("cache_fetch_chunked: the block at R-chunk is "
                             "not the table's last rows")
    k = starts.numel()
    k_live = int((starts >= 0).sum())
    live_starts = starts[starts >= 0].long()
    block_rows = (live_starts[:, None] + torch.arange(chunk, device=dev)
                  ).reshape(-1)
    chunked_out = {
        "ms": time_ms(torch, lambda: kc.cache_fetch_chunked(
            capacity, cap_accum, starts, chunk), 100),
        "device_ms": device_kernel_ms(
            torch, lambda: kc.cache_fetch_chunked(capacity, cap_accum,
                                                  starts, chunk), 20,
            "cache_fetch_chunked_kernel"),
        "plain_ms": time_ms(torch, lambda: ref.cache_fetch_chunked_ref(
            capacity, cap_accum, starts, chunk), 20),
        "library_ms": time_ms(
            torch, lambda: capacity.index_select(0, block_rows), 100),
        "max_abs_err": chunked_err,
    }
    chunked_out["bound_ms"], chunked_out["bound_by"] = bound_ms(
        k * 4 + k_live * chunk * (d * 4 + 4) + k * chunk * (d * 4 + 4), 0)
    shadow, shadow_accum = got
    chunked_out["host_us"] = fetch_host_us(
        torch, "cache_fetch_chunked", kc.FETCH_CHUNKED_KERNEL,
        lambda: kc.check_fetch_chunked(capacity, cap_accum, starts),
        lambda: kc.cache_fetch_chunked(capacity, cap_accum, starts, chunk),
        k * chunk, capacity,
        (capacity.data_ptr(), cap_accum.data_ptr(), starts.data_ptr(),
         shadow.data_ptr(), shadow_accum.data_ptr(), k, chunk, d),
        lambda: capacity.index_select(0, block_rows))
    del shadow, shadow_accum
    covered = int((pos >= 0).sum())
    log(f"  cache_fetch_chunked chunk={chunk}: {k} "
        f"blocks ({k_live} live, one at R-{chunk}, one pad) cover "
        f"{covered} of the {n} rows, {n - covered} left to the row fetch: "
        f"{chunked_out}")

    # -- commit: the chunked slab installed through src_pos, half the
    #    entries write a dirty victim back, a tenth are pure writebacks,
    #    a twentieth are pad slots
    log_ptxas(kc.COMMIT_KERNEL, "cache_commit_kernel")
    single = np.flatnonzero(pos < 0)
    src_np = pos.copy()
    src_np[single] = len(starts_np) * chunk + np.arange(len(single))
    blocks = kc.cache_fetch_chunked(capacity, cap_accum,
                                    torch.as_tensor(starts_np, **i32), chunk)
    rest = kc.cache_fetch(capacity, cap_accum,
                          torch.as_tensor(rows_np[single], **i32))
    shadow = torch.cat([blocks[0], rest[0]])
    shadow_accum = torch.cat([blocks[1], rest[1]])
    del blocks, rest
    slots = torch.randperm(c_rows, generator=g, device=dev)[:n].int()
    evict = torch.randperm(r_rows, generator=g, device=dev)[:n].int()
    ins = torch.as_tensor(rows_np, **i32)
    src_pos = torch.as_tensor(src_np.astype(np.int32), device=dev)
    u = torch.rand((n,), generator=g, device=dev)
    evict[u < 0.5] = -1
    ins[u > 0.9] = -1                                 # pure writebacks
    slots[(u > 0.45) & (u < 0.5)] = -1                # pads
    evict[0], slots[0] = r_rows - 1, c_rows - 1       # the last rows
    kc.check_commit_worklist(slots, ins, src_pos, shadow.shape[0])
    live = slots >= 0
    n_wb = int((live & (evict >= 0)).sum())
    n_in = int((live & (ins >= 0)).sum())
    cap_rows = evict[live & (evict >= 0)].long()
    s_rows = slots[live].long()
    tiers = (capacity, cache, cap_accum, cache_accum)
    views = ((capacity, cap_rows), (cache, s_rows), (cap_accum, cap_rows),
             (cache_accum, s_rows))
    work = (shadow, shadow_accum, slots, evict, ins, src_pos)

    def touched():
        return [t[i].clone() for t, i in views]

    def checksum():
        return [bit_checksum(torch, t) for t in tiers]

    before, sums = touched(), checksum()
    kc.cache_commit(*tiers, *work)
    torch.cuda.synchronize()
    got = touched()
    for (t, i), v in zip(views, before):
        t[i] = v
    if checksum() != sums:
        raise AssertionError("cache_commit wrote outside its worklist")
    ref.cache_commit_ref(*tiers, *work)
    commit_err = compare("cache_commit", got, touched())
    commit_out = {
        "ms": time_ms(torch, lambda: kc.cache_commit(*tiers, *work), 100),
        "device_ms": device_kernel_ms(
            torch, lambda: kc.cache_commit(*tiers, *work), 20,
            "cache_commit_kernel"),
        "plain_ms": time_ms(torch, lambda: ref.cache_commit_ref(
            *tiers, *work), 20),
        # no single PyTorch call writes the victims back and then installs
        # the shadow rows in the same pass
        "library_ms": None,
        "max_abs_err": commit_err,
    }
    commit_out["bound_ms"], commit_out["bound_by"] = bound_ms(
        n * 16 + n_wb * 2 * (d * 4 + 4) + n_in * 2 * (d * 4 + 4), 0)
    log(f"  cache_commit entries={n} writebacks={n_wb} "
        f"installs={n_in} from a {shadow.shape[0]}-row slab; bit checksums "
        f"of the four tiers equal after restore: {commit_out}")
    del capacity, cap_accum, cache, cache_accum, shadow, shadow_accum
    return {"cache_fetch": fetch_out, "cache_fetch_chunked": chunked_out,
            "cache_commit": commit_out}


def tablewise_batch(cfg, ebc, step: int, plant: bool):
    """The training batch of `step` (numpy) under the table-wise layout,
    idx offset to mega rows. `plant` adds the corner cases: an all-pad bag,
    the table's last row repeated inside one bag and shared with another,
    and owner 0's features left empty, so its segment has no rows."""
    import numpy as np

    from repro_torch.data.synthetic import make_dlrm_batch
    idx = ebc.offset_indices(make_dlrm_batch(cfg, TRAIN_BATCH, step)["idx"])
    if plant:
        plan = ebc.plan
        owner = np.asarray(plan.table_offsets) // plan.shard_rows
        idx[:, owner == 0, :] = -1               # an empty segment
        top = plan.total_rows - 1
        idx[0, -1, :] = -1                       # an all-pad bag
        idx[1, -1, :6] = top                     # repeated inside one bag
        idx[3, -2, 0] = top                      # ... and shared with another
    return idx


def check_tablewise_kernels(torch, dev, cfg, ebc) -> dict:
    """Phase 5c: the segmented fused backward and the legacy row-wise
    AdaGrad on the full-width table-wise mega table, each against its plain
    version; the segmented kernel against the one-plan kernel (8 segments,
    one segment, and the reference's seg_cap = U: the same bits), and the
    two-pass pipeline (per-lookup grads, dedup, row-wise kernel) against
    the fused update."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rowwise_adagrad as kr
    from repro_torch.kernels import sparse_update as ku
    from repro_torch.kernels.sparse_plan import (build_sparse_plan_host,
                                                 split_plan_by_owner)
    plan_p = ebc.plan
    r_rows, d = plan_p.total_rows, cfg.embed_dim
    n_seg, shard_rows = plan_p.capacity_shards, plan_p.shard_rows
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    table = torch.empty((r_rows, d), device=dev).normal_(generator=g)
    accum = torch.rand((r_rows,), generator=g, device=dev)

    def upload(*xs):
        return [torch.as_tensor(x, device=dev) for x in xs]

    def segments(idx_np, seg_cap=None):
        plan = build_sparse_plan_host(idx_np)
        seg_rows, seg_offs, seg_base = split_plan_by_owner(
            plan, shard_rows, n_seg, seg_cap=seg_cap)
        return (upload(*plan), upload(seg_rows, seg_offs, plan.bag_ids,
                                      seg_base))

    idx_np = tablewise_batch(cfg, ebc, 0, plant=True)
    b, f, lk = idx_np.shape
    plan, segs = segments(idx_np)
    live_per_seg = (segs[0] >= 0).sum(1).tolist()
    if live_per_seg[0] != 0 or min(live_per_seg[1:]) == 0:
        raise AssertionError(f"planted batch: live rows per segment "
                             f"{live_per_seg}, want owner 0 alone empty")
    rows = plan[0][plan[0] >= 0].long()
    n_live = rows.numel()
    pooled = torch.randn((b * f, d), generator=g, device=dev) * 0.01
    near = torch.cat([rows - 1, rows + 1]).clamp(0, r_rows - 1)
    near = near[~torch.isin(near, rows)][:4096]
    before = (table[rows].clone(), accum[rows].clone())
    near_before = (table[near].clone(), accum[near].clone())

    def checksum():
        return bit_checksum(torch, table), bit_checksum(torch, accum)

    sums = checksum()

    def run(update, what):
        """Apply one update in place, keep its touched rows, restore, and
        show nothing else moved."""
        update()
        torch.cuda.synchronize()
        got = (table[rows].clone(), accum[rows].clone())
        if not (torch.equal(table[near], near_before[0])
                and torch.equal(accum[near], near_before[1])):
            raise AssertionError(f"{what} moved an untouched neighbour row")
        table[rows], accum[rows] = before
        if checksum() != sums:
            raise AssertionError(f"{what} wrote outside the plan's rows")
        return got

    def bit_equal(a, b_, what):
        if not (torch.equal(a[0], b_[0]) and torch.equal(a[1], b_[1])):
            raise AssertionError(f"{what}: not bit-equal")
        log(f"  {what}: bit-equal")

    seg = run(lambda: ku.fused_bag_backward_adagrad_segments(
        table, accum, *segs[:3], pooled, segs[3], SPARSE_LR, SPARSE_EPS),
        "fused_bag_backward_adagrad_segments")
    one = run(lambda: ku.fused_bag_backward_adagrad(
        table, accum, *plan, pooled, SPARSE_LR, SPARSE_EPS),
        "fused_bag_backward_adagrad")
    bit_equal(seg, one, f"{n_seg} segments (live rows {live_per_seg}) vs "
              "the one-plan kernel")
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    bit_equal(run(lambda: ku.fused_bag_backward_adagrad_segments(
        table, accum, plan[0][None], plan[1][None], plan[2], pooled, zero,
        SPARSE_LR, SPARSE_EPS), "S=1 segments"), one,
        "the segmented kernel at S=1, seg_base 0, vs the one-plan kernel")
    _, segs_u = segments(idx_np, seg_cap=plan[0].numel())
    bit_equal(run(lambda: ku.fused_bag_backward_adagrad_segments(
        table, accum, *segs_u[:3], pooled, segs_u[3], SPARSE_LR,
        SPARSE_EPS), "seg_cap=U segments"), seg,
        f"seg_cap=U ({segs_u[0].shape[1]}) vs the tight cap "
        f"({segs[0].shape[1]})")
    del segs_u
    # the legacy two-pass pipeline: per-lookup grads, dedup, row-wise kernel
    log_ptxas(kr.KERNEL, "rowwise_adagrad_kernel")
    flat_idx, flat_g = ebc.per_lookup_grads(
        torch.as_tensor(idx_np, device=dev), pooled.reshape(b, f, d))
    uniq, gsum = ref.dedup_grads_ref(flat_idx, flat_g, r_rows)
    del flat_g
    two = run(lambda: kr.rowwise_adagrad(table, accum, uniq, gsum,
                                         SPARSE_LR, SPARSE_EPS),
              "rowwise_adagrad")
    bit_equal(two, seg, "two-pass (per-lookup grads, dedup, rowwise_adagrad)"
              " vs the segmented fused kernel")
    # against the plain versions on the same inputs
    ref.fused_bag_backward_adagrad_segments_ref(
        table, accum, *segs[:3], pooled, segs[3], SPARSE_LR, SPARSE_EPS)
    want = (table[rows].clone(), accum[rows].clone())
    table[rows], accum[rows] = before
    ok_t, err_t = close(seg[0], want[0], TOL_FUSED)
    ok_a, err_a = close(seg[1], want[1], TOL_FUSED)
    ref.rowwise_adagrad_ref(table, accum, uniq, gsum, SPARSE_LR, SPARSE_EPS)
    want_rw = (table[rows].clone(), accum[rows].clone())
    table[rows], accum[rows] = before
    ok_rt, err_rt = close(two[0], want_rw[0], TOL_FUSED)
    ok_ra, err_ra = close(two[1], want_rw[1], TOL_FUSED)
    moved = float((seg[0] - before[0]).abs().max())
    log(f"  vs plain: segments table/accum max_abs_err {err_t:.3e}/"
        f"{err_a:.3e}, rowwise_adagrad {err_rt:.3e}/{err_ra:.3e} (tol "
        f"{TOL_FUSED} abs + rel); largest row change {moved:.3e}; "
        f"{n_live} rows (max {int(rows.max())} of R={r_rows}), "
        f"{near.numel()} untouched neighbours bit-equal and bit checksums "
        f"of table and accum equal after every restore")
    if not (ok_t and ok_a and ok_rt and ok_ra) or moved == 0.0:
        raise AssertionError("a table-wise kernel disagrees with plain: "
                             f"{err_t}, {err_a}, {err_rt}, {err_ra}")
    del seg, one, two, want, want_rw, uniq, gsum, flat_idx

    # timing at the main path's inputs: batch 0 unplanted, tight segments
    idx_np = tablewise_batch(cfg, ebc, 0, plant=False)
    plan, segs = segments(idx_np)
    n_live = int((plan[0] >= 0).sum())
    n_valid = int((idx_np >= 0).sum())
    c = segs[0].shape[1]

    def seg_update():
        ku.fused_bag_backward_adagrad_segments(
            table, accum, *segs[:3], pooled, segs[3], SPARSE_LR, SPARSE_EPS)

    upd = {
        "ms": time_ms(torch, seg_update, 100),
        "device_ms": device_kernel_ms(torch, seg_update, 20,
                                      "fused_bag_backward_adagrad_segments"),
        "plain_ms": time_ms(
            torch, lambda: ref.fused_bag_backward_adagrad_segments_ref(
                table, accum, *segs[:3], pooled, segs[3], SPARSE_LR,
                SPARSE_EPS), 2, 1),
        # no single PyTorch call sums pooled bag gradients per unique row
        # and applies row-wise AdaGrad (torch.optim.Adagrad is dense and
        # per element)
        "library_ms": None,
        "max_abs_err": max(err_t, err_a),
        "segments": n_seg, "seg_cap": c,
        "live_rows_per_segment": (segs[0] >= 0).sum(1).tolist(),
    }
    upd["bound_ms"], upd["bound_by"] = bound_ms(
        n_seg * c * 4 + n_seg * (c + 1) * 4 + n_seg * 4 + n_valid * 4
        + b * f * d * 4 + 2 * n_live * (d * 4 + 4),
        n_valid * d + n_live * 5 * d)
    log(f"  fused_bag_backward_adagrad_segments: {upd}")
    flat_idx, flat_g = ebc.per_lookup_grads(
        torch.as_tensor(idx_np, device=dev), pooled.reshape(b, f, d))
    uniq, gsum = ref.dedup_grads_ref(flat_idx, flat_g, r_rows)
    del flat_g, flat_idx
    n_uniq = uniq.numel()

    def rowwise():
        kr.rowwise_adagrad(table, accum, uniq, gsum, SPARSE_LR, SPARSE_EPS)

    rw = {
        "ms": time_ms(torch, rowwise, 100),
        "device_ms": device_kernel_ms(torch, rowwise, 20,
                                      "rowwise_adagrad_kernel"),
        "plain_ms": time_ms(torch, lambda: ref.rowwise_adagrad_ref(
            table, accum, uniq, gsum, SPARSE_LR, SPARSE_EPS), 20),
        # no single PyTorch call applies row-wise AdaGrad to the rows of a
        # deduplicated gradient (torch.optim.Adagrad is dense, per element)
        "library_ms": None,
        "max_abs_err": max(err_rt, err_ra),
        "entries": n_uniq, "live_rows": n_live,
    }
    rw["bound_ms"], rw["bound_by"] = bound_ms(
        n_uniq * 4 + n_live * d * 4 + 2 * n_live * (d * 4 + 4),
        n_live * 5 * d)
    log(f"  rowwise_adagrad: {rw}")
    del table, accum, uniq, gsum
    return {"fused_bag_backward_adagrad_segments": upd,
            "rowwise_adagrad": rw}


def plain_logits(torch, dense, dense_x, pooled):
    """Logits from the plain versions: MLPs, plain dot interaction."""
    from repro_torch.kernels import ref
    from repro_torch.nn.layers import linear
    x = dense_x
    for i, p in enumerate(dense["bottom"]):
        x = linear(p, x)
        if i < len(dense["bottom"]) - 1:
            x = torch.relu(x)
    z = torch.cat([x[:, None, :], pooled], dim=1)
    y = torch.cat([x, ref.dot_interaction_ref(z)], dim=-1)
    for i, p in enumerate(dense["top"]):
        y = linear(p, y)
        if i < len(dense["top"]) - 1:
            y = torch.relu(y)
    return y[:, 0]


def plain_probs(torch, engine, cfg, req_dense, req_idx):
    """One request's probabilities from the plain versions on the card,
    against the capacity tier (the full mega table, never written)."""
    from repro_torch.kernels import ref
    dev = engine.state.capacity.device
    b, f, lk = req_idx.shape
    idx = torch.as_tensor(req_idx, dtype=torch.int32, device=dev)
    pooled = ref.embedding_bag_ref(engine.state.capacity,
                                   idx.reshape(b * f, lk)).reshape(b, f, -1)
    x = torch.as_tensor(req_dense, device=dev)
    return torch.sigmoid(plain_logits(torch, engine.dense, x,
                                      pooled)).cpu().numpy()


def plain_train_step(torch, params, state, batch, opt):
    """One train step from the plain versions on the card: planned lookup,
    dense tower, autograd, dense AdaGrad, fused sparse update (in place on
    the mega table and accumulator). Returns (loss, dense, dense_state)."""
    from repro_torch.core.dlrm import _bce
    from repro_torch.kernels import ref
    from repro_torch.kernels.sparse_plan import plan_from_batch
    from repro_torch.nn.params import tree_leaves, tree_map
    mega = params["emb"]["mega"]
    idx = batch["idx"]
    b, f, lk = idx.shape
    plan = plan_from_batch(batch)
    pooled = ref.dedup_embedding_bag_ref(
        mega, idx.reshape(b * f, lk), plan.unique_rows).reshape(b, f, -1)
    pooled.requires_grad_()
    dense = {"bottom": params["bottom"], "top": params["top"]}
    leaves = tree_map(lambda t: t.detach().requires_grad_(), dense)
    loss = _bce(plain_logits(torch, leaves, batch["dense"], pooled),
                batch["label"])
    grads = torch.autograd.grad(loss, tree_leaves(leaves) + [pooled])
    it = iter(grads[:-1])
    new_dense, new_state = opt.apply(dense, tree_map(lambda _: next(it),
                                                     leaves),
                                     state["dense"], 0)
    with torch.no_grad():
        ref.fused_bag_backward_adagrad_ref(
            mega, state["accum"], *plan, grads[-1].reshape(b * f, -1),
            SPARSE_LR, SPARSE_EPS)
    return float(loss.detach()), new_dense, new_state


def train_planned(torch, dev, cfg, ebc, want_losses) -> dict:
    """Phase 6b: TRAIN_STEPS full-width steps fed by the port's pipeline
    with the sparse-plan hook, from the launcher's seed. Step 0 is
    recomputed with the plain versions; the last PROFILED_STEPS steps run
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.data.pipeline import ShardedLoader, sparse_plan_hook
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.kernels.sparse_plan import plan_from_batch
    from repro_torch.launch.train import PARAM_SEED, batch_to_device
    from repro_torch.nn.params import tree_leaves, tree_map
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_dlrm_train_step, dlrm_init_state

    params = init_dlrm_params(cfg, ebc, PARAM_SEED, dev)
    opt = adagrad(0.01)
    state = dlrm_init_state(ebc, opt, params)
    step_fn = build_dlrm_train_step(cfg, ebc, opt, SPARSE_LR, SPARSE_EPS,
                                    sparse_apply="sparse")
    loader = ShardedLoader(
        lambda step, seed: make_dlrm_batch(cfg, TRAIN_BATCH, step, seed),
        TRAIN_BATCH)
    pipe = loader.pipeline(prefetch=2, transform=sparse_plan_hook(
        ebc.plan.table_offsets))
    losses, host_s, wait_s, h2d_s, out = [], [], [], [], {}
    prof = None
    try:
        for step in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            _, raw = next(pipe)                  # blocked on the reader
            t1 = time.perf_counter()
            batch = batch_to_device(raw, dev)    # pageable copies: blocking
            wait_s.append(t1 - t0)
            h2d_s.append(time.perf_counter() - t1)
            if step == 0:
                mega, accum = params["emb"]["mega"], state["accum"]
                plan = plan_from_batch(batch)
                rows = plan.unique_rows[plan.unique_rows >= 0].long()
                saved = (mega[rows].clone(), accum[rows].clone())
                dense0 = tree_map(torch.clone, {"bottom": params["bottom"],
                                                "top": params["top"]})
                state0 = {"dense": tree_map(torch.clone, state["dense"]),
                          "accum": accum}
                sums = (bit_checksum(torch, mega), bit_checksum(torch, accum))
            if step == TRAIN_STEPS - PROFILED_STEPS:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            params, state, metrics = step_fn(params, state, batch, step)
            losses.append(float(metrics["loss"]))        # syncs the step
            host_s.append(time.perf_counter() - t0)
            if step == 0:
                kern = (mega[rows].clone(), accum[rows].clone())
                mega[rows], accum[rows] = saved
                if (bit_checksum(torch, mega),
                        bit_checksum(torch, accum)) != sums:
                    raise AssertionError("train step wrote outside the "
                                         "batch's rows")
                p_loss, p_dense, p_state = plain_train_step(
                    torch, {**dense0, "emb": {"mega": mega}}, state0, batch,
                    opt)

                def flat(tree):
                    return torch.cat([t.reshape(-1)
                                      for t in tree_leaves(tree)])

                errs = {"loss": abs(p_loss - losses[0])}
                ok = errs["loss"] <= TOL_STEP + TOL_STEP * abs(p_loss)
                for name, a, b in (
                        ("mega rows", kern[0], mega[rows]),
                        ("accum rows", kern[1], accum[rows]),
                        ("dense", flat({"bottom": params["bottom"],
                                        "top": params["top"]}),
                         flat(p_dense)),
                        ("dense state", flat(state["dense"]),
                         flat(p_state))):
                    good, errs[name] = close(a, b, TOL_STEP)
                    ok = ok and good
                shown = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                log(f"step 0 vs plain recompute on the card: max_abs_err "
                    f"{shown} (tol {TOL_STEP} abs + rel); bit checksums "
                    f"of mega and accum equal after restore")
                if not ok:
                    raise AssertionError(f"train step disagrees with the "
                                         f"plain recompute: {errs}")
                mega[rows], accum[rows] = kern
                del saved, kern, dense0, state0, p_dense, p_state
            log(f"step {step:5d} loss {losses[-1]:.6f} "
                f"host {host_s[-1] * 1e3:.3f} ms")
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    finally:
        pipe.close()
    if not all(map(lambda v: v == v and abs(v) < float("inf"), losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    diff = max(abs(a - b) for a, b in zip(losses, want_losses))
    log(f"planned run losses vs the launcher's (same seed, same batches): "
        f"max_abs_diff={diff:.3e} bit-equal={losses == want_losses}")
    if diff > TOL_STEP:
        raise AssertionError(f"planned and plan-less runs diverge: {diff}")
    def mean_ms(xs):
        return sum(xs) / len(xs) * 1e3

    dev = device_events(prof)
    dev_us = sum(t for _, t in dev)
    plain = slice(1, TRAIN_STEPS - PROFILED_STEPS)   # after the check step
    out["host_ms_per_step"] = mean_ms(host_s[plain])
    out["pipeline_wait_ms_per_step"] = mean_ms(wait_s[plain])
    out["h2d_ms_per_step"] = mean_ms(h2d_s[plain])
    wall = out["host_ms_per_step"] + out["pipeline_wait_ms_per_step"] \
        + out["h2d_ms_per_step"]
    out["examples_per_s"] = TRAIN_BATCH / wall * 1e3
    out["profiled_host_ms_per_step"] = mean_ms(host_s[-PROFILED_STEPS:])
    out["device_busy_ms_per_step"] = (dev_us / 1e3 / PROFILED_STEPS
                                      if dev_us else None)
    log(f"planned training, steps {plain.start}-{plain.stop - 1} (profiler "
        f"off): step {out['host_ms_per_step']:.3f} ms, waiting on the "
        f"reader {out['pipeline_wait_ms_per_step']:.3f} ms, batch to the "
        f"card {out['h2d_ms_per_step']:.3f} ms per step -> "
        f"{out['examples_per_s']:.1f} examples/s; profiled steps: step "
        f"{out['profiled_host_ms_per_step']:.3f} ms, device busy "
        + (f"{out['device_busy_ms_per_step']:.3f} ms per step" if dev_us
           else "not measured (trace holds no device time)"))
    out["dedup_device_ms_per_step"] = kernel_ms_per_step(dev, "dedup_")
    out["update_device_ms_per_step"] = kernel_ms_per_step(
        dev, "fused_bag_backward_adagrad")
    top = sorted(dev, key=lambda e: e[1], reverse=True)[:10]
    out["top_device_ms_per_step"] = {
        name[:60]: t / 1e3 / PROFILED_STEPS for name, t in top if t}
    log("device ms per step by kernel (profiled steps): "
        + json.dumps(out["top_device_ms_per_step"]))
    log(prof.key_averages().table(sort_by="self_cpu_time_total",
                                  row_limit=15))
    del params, state
    return out


def train_cached(torch, dev, cfg, run: dict, want: dict) -> dict:
    """Phase 7: TRAIN_STEPS full-width steps through
    `build_cached_train_step` from the launcher's seed and batches. `run`
    names the tier ("async" or "sync"), `cache_rows` (None: the plan's),
    `fetch_chunk`, the reader hook ("plan" or "dedup") and whether the
    k-step lookahead feeds `prefetch_rows`. `want` holds the launcher's
    losses and the initial and final bit checksums. The last PROFILED_STEPS
    steps run under torch.profiler. Returns the run's numbers; the launch
    counts are reset just before the first step and hold the run's
    launches, materialize included, when it returns."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cache import CachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.tiers import AsyncCachedTier
    from repro_torch.data.pipeline import (ShardedLoader, dedup_indices_hook,
                                           lookahead_rows, sparse_plan_hook)
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.train import PARAM_SEED
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import (build_cached_train_step,
                                         cached_dlrm_init_state)

    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=run["cache_rows"],
                                            fetch_chunk=run["fetch_chunk"])
    tier = AsyncCachedTier(cc) if run["tier"] == "async" else cc
    params = init_dlrm_params(cfg, cc.ebc, PARAM_SEED, dev)
    if bit_checksum(torch, params["emb"]["mega"]) != want["init_sum"]:
        raise AssertionError("the cached run's initial table differs from "
                             "the launcher's")
    opt = adagrad(0.01)
    state = cached_dlrm_init_state(cc, opt, params)
    dense = {"bottom": params["bottom"], "top": params["top"]}
    cs = tier.init_state(params.pop("emb")["mega"])   # owned, no copy
    step_fn = build_cached_train_step(cfg, tier, opt, SPARSE_LR, SPARSE_EPS)
    hook = (sparse_plan_hook if run["hook"] == "plan"
            else dedup_indices_hook)(cc.ebc.plan.table_offsets)
    pipe = ShardedLoader(
        lambda step, seed: make_dlrm_batch(cfg, TRAIN_BATCH, step, seed),
        TRAIN_BATCH).pipeline(prefetch=2, transform=hook)
    log(f"  tier {type(tier).__name__} cache_rows={cc.cache_rows} "
        f"fetch_chunk={cc.fetch_chunk} hook={run['hook']} "
        f"lookahead={run['lookahead']}")
    torch.cuda.reset_peak_memory_stats()
    losses, host_s, widest = [], [], 0
    prof, prev = None, None
    reset_launches(KERNELS)
    try:
        for step in range(TRAIN_STEPS):
            _, batch = next(pipe)
            rows = batch["uniq_rows"]
            if prev is not None:
                widest = max(widest, len(np.union1d(prev, rows)))
            prev = rows
            last = step == TRAIN_STEPS - 1
            kw = {"next_batch": None if last else pipe.peek(0)}
            if run["tier"] == "async" and run["lookahead"] and not last:
                kw["prefetch_rows"] = lookahead_rows(pipe, 2)
            if step == TRAIN_STEPS - PROFILED_STEPS:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            dense, state, m = step_fn(dense, state, cs, batch, step, **kw)
            losses.append(float(m["loss"]))              # syncs the step
            host_s.append(time.perf_counter() - t0)
            log(f"  step {step} loss {losses[-1]:.6f} host "
                f"{host_s[-1] * 1e3:.3f} ms hit_rate "
                f"{m['cache_hit_rate']:.4f}")
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    finally:
        pipe.close()
    t0 = time.perf_counter()
    mega, accum = tier.materialize(cs)
    sums = (bit_checksum(torch, mega), bit_checksum(torch, accum))
    materialize_ms = (time.perf_counter() - t0) * 1e3
    st = tier.stats(cs)
    log(f"  cache: hits={st.hits} misses={st.misses} fetches={st.fetches} "
        f"evictions={st.evictions} writebacks={st.writebacks} "
        f"prefetched={st.prefetched} fetch_chunks={st.fetch_chunks} "
        f"overfetch_rows={st.overfetch_rows} hit_rate={st.hit_rate:.4f}; "
        f"largest two-batch working set {widest} rows vs cache_rows "
        f"{cc.cache_rows}")
    log_peak(torch, run["name"])
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"{run['name']}: losses not finite: {losses}")
    diff = max(abs(a - b) for a, b in zip(losses, want["losses"]))
    equal = losses == want["losses"]
    log(f"  losses vs the launcher's: bit-equal={equal} max_abs_diff="
        f"{diff:.3e}; materialized checksums (mega, accum) {sums} vs the "
        f"launcher's {want['final_sums']}: equal={sums == want['final_sums']}"
        f" (materialize {materialize_ms:.3f} ms)")
    if not equal:
        first = next(i for i, (a, b) in enumerate(zip(losses,
                                                      want["losses"]))
                     if a != b)
        log(f"  first differing step: {first}")
        if diff > TOL_STEP:
            raise AssertionError(f"{run['name']}: losses diverge from the "
                                 f"launcher's: {diff}")
    if sums != want["final_sums"] and equal:
        raise AssertionError(f"{run['name']}: losses bit-equal but the "
                             "materialized tables differ")
    if run["evicts"] and not (st.evictions > 0 and st.writebacks > 0):
        raise AssertionError(f"{run['name']}: no eviction or writeback")

    events = device_events(prof)
    dev_us = sum(t for _, t in events)
    plain = slice(1, TRAIN_STEPS - PROFILED_STEPS)
    out = {"losses_bit_equal": equal, "checksums_equal":
           sums == want["final_sums"],
           "host_ms_per_step": sum(host_s[plain]) / len(host_s[plain]) * 1e3,
           "profiled_host_ms_per_step":
               sum(host_s[-PROFILED_STEPS:]) / PROFILED_STEPS * 1e3,
           "device_busy_ms_per_step": (dev_us / 1e3 / PROFILED_STEPS
                                       if dev_us else None),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "stats": {k: getattr(st, k) for k in (
               "hits", "misses", "fetches", "evictions", "writebacks",
               "prefetched", "fetch_chunks", "overfetch_rows")},
           "widest_two_batch_working_set": widest}
    # the worklist uploads are pageable host-to-device copies, each of
    # which waits for the work queued before it
    h2d = [(e.count, getattr(e, "self_device_time_total", 0))
           for e in prof.key_averages() if "Memcpy HtoD" in e.key]
    copy_cpu = [e.self_cpu_time_total for e in prof.key_averages()
                if e.key == "aten::copy_"]
    out["h2d_copies_per_step"] = sum(c for c, _ in h2d) / PROFILED_STEPS
    out["h2d_device_ms_per_step"] = (sum(t for _, t in h2d) / 1e3
                                     / PROFILED_STEPS)
    out["copy_host_ms_per_step"] = (sum(copy_cpu) / 1e3 / PROFILED_STEPS)
    out["dedup_device_ms_per_step"] = kernel_ms_per_step(events, "dedup_")
    out["update_device_ms_per_step"] = kernel_ms_per_step(
        events, "fused_bag_backward_adagrad")
    # the step-boundary commits of the shadow rows in the profiled steps
    out["commit_device_ms_per_step"] = kernel_ms_per_step(
        events, "cache_commit_kernel")
    top = sorted(events, key=lambda e: e[1], reverse=True)[:10]
    out["top_device_ms_per_step"] = {
        name[:60]: t / 1e3 / PROFILED_STEPS for name, t in top if t}
    log(f"  {run['name']}: steps {plain.start}-{plain.stop - 1} host "
        f"{out['host_ms_per_step']:.3f} ms per step (profiler off); "
        f"profiled: host {out['profiled_host_ms_per_step']:.3f} ms, device "
        "busy " + (f"{out['device_busy_ms_per_step']:.3f} ms per step"
                   if dev_us else "not measured (trace holds no device time)")
        + f"; {out['h2d_copies_per_step']:.1f} host-to-device copies per "
        f"step ({out['h2d_device_ms_per_step']:.3f} device ms, "
        f"{out['copy_host_ms_per_step']:.3f} host ms in aten::copy_)")
    log("  device ms per step by kernel (profiled steps): "
        + json.dumps(out["top_device_ms_per_step"]))
    log(prof.key_averages().table(sort_by="self_cpu_time_total",
                                  row_limit=12))
    del cs, mega, accum, dense, state
    return out


def train_tablewise(torch, dev, cfg, ebc, oracle: bool) -> dict:
    """Phase 8a (oracle False): TRAIN_STEPS full-width steps through
    `build_tablewise_train_step` on the 8-owner table-wise layout, batches
    from the plan hook, `next_batch` peeked from the pipeline (so each
    step stages the next one's lookup); every step's exchange metrics,
    counted by the step, are held to the analytic model
    `launch.analysis.tablewise_exchange_traffic`, and the last
    PROFILED_STEPS steps run under torch.profiler. Phase 8b (oracle True):
    the same seed and batches through `build_dlrm_train_step`. The launch
    counts are reset just before the first step and hold the run's
    launches when it returns. Returns the losses, the final bit checksums
    of the table and accumulator, and the run's numbers."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.data.pipeline import ShardedLoader, sparse_plan_hook
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.analysis import tablewise_exchange_traffic
    from repro_torch.launch.train import PARAM_SEED, batch_to_device
    from repro_torch.optim import adagrad
    from repro_torch.train import (build_dlrm_train_step,
                                   build_tablewise_train_step,
                                   dlrm_init_state)

    plan = ebc.plan
    params = init_dlrm_params(cfg, ebc, PARAM_SEED, dev)
    init_sum = bit_checksum(torch, params["emb"]["mega"])
    opt = adagrad(0.01)
    state = dlrm_init_state(ebc, opt, params)
    if oracle:
        step_fn = build_dlrm_train_step(cfg, ebc, opt, SPARSE_LR, SPARSE_EPS)
    else:
        step_fn = build_tablewise_train_step(cfg, ebc, opt, SPARSE_LR,
                                             SPARSE_EPS)
    owners = np.asarray(plan.table_offsets) // plan.shard_rows
    model = tablewise_exchange_traffic(
        TRAIN_BATCH, cfg.n_sparse_features, cfg.truncation, cfg.embed_dim,
        plan.capacity_shards,
        features_per_owner=np.bincount(owners,
                                       minlength=plan.capacity_shards))
    pipe = ShardedLoader(
        lambda step, seed: make_dlrm_batch(cfg, TRAIN_BATCH, step, seed),
        TRAIN_BATCH).pipeline(prefetch=2, transform=sparse_plan_hook(
            plan.table_offsets))
    torch.cuda.reset_peak_memory_stats()
    losses, host_s, wait_s, prof = [], [], [], None
    reset_launches(KERNELS)
    try:
        for step in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            _, batch = next(pipe)                # blocked on the reader
            last = step == TRAIN_STEPS - 1
            nxt = None if oracle or last else pipe.peek(0)
            wait_s.append(time.perf_counter() - t0)
            if step == TRAIN_STEPS - PROFILED_STEPS:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            if oracle:
                params, state, m = step_fn(
                    params, state, batch_to_device(batch, dev), step)
            else:
                params, state, m = step_fn(params, state, batch, step,
                                           next_batch=nxt)
            losses.append(float(m["loss"]))              # syncs the step
            host_s.append(time.perf_counter() - t0)
            log(f"  step {step} loss {losses[-1]:.6f} host "
                f"{host_s[-1] * 1e3:.3f} ms, reader wait "
                f"{wait_s[-1] * 1e3:.3f} ms")
            if not oracle:
                got = (m["exchange_pooled_fwd_bytes"],
                       m["exchange_pooled_bwd_bytes"],
                       m["exchange_pair_leg_bytes"])
                if got != (model["fwd_bytes"], model["bwd_bytes"],
                           model["pair_leg_bytes"]):
                    raise AssertionError(f"exchange metrics {got} differ "
                                         f"from the model {model}")
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    finally:
        pipe.close()
    sums = (bit_checksum(torch, params["emb"]["mega"]),
            bit_checksum(torch, state["accum"]))
    peak = torch.cuda.max_memory_allocated()
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"losses not finite: {losses}")
    events = device_events(prof)
    dev_us = sum(t for _, t in events)
    plain = slice(1, TRAIN_STEPS - PROFILED_STEPS)
    seg_us = sum(t for name, t in events
                 if "fused_bag_backward_adagrad" in name)
    out = {"losses": losses, "init_sum": init_sum, "final_sums": sums,
           "host_ms_per_step": sum(host_s[plain]) / len(host_s[plain]) * 1e3,
           "reader_wait_ms_per_step":
               sum(wait_s[plain]) / len(wait_s[plain]) * 1e3,
           "profiled_host_ms_per_step":
               sum(host_s[-PROFILED_STEPS:]) / PROFILED_STEPS * 1e3,
           "device_busy_ms_per_step": (dev_us / 1e3 / PROFILED_STEPS
                                       if dev_us else None),
           "update_device_ms_per_step": (seg_us / 1e3 / PROFILED_STEPS
                                         if dev_us else None),
           "peak_bytes": peak}
    out["examples_per_s"] = TRAIN_BATCH / (
        out["host_ms_per_step"] + out["reader_wait_ms_per_step"]) * 1e3
    if not oracle:
        out["exchange_model"] = model
    out["dedup_device_ms_per_step"] = kernel_ms_per_step(events, "dedup_")
    top = sorted(events, key=lambda e: e[1], reverse=True)[:10]
    out["top_device_ms_per_step"] = {
        name[:60]: t / 1e3 / PROFILED_STEPS for name, t in top if t}
    log(f"  steps {plain.start}-{plain.stop - 1} (profiler off): step "
        f"{out['host_ms_per_step']:.3f} ms, waiting on the reader "
        f"{out['reader_wait_ms_per_step']:.3f} ms per step -> "
        f"{out['examples_per_s']:.1f} examples/s; "
        f"profiled: host {out['profiled_host_ms_per_step']:.3f} ms, device "
        "busy " + (f"{out['device_busy_ms_per_step']:.3f} ms per step, the "
                   f"sparse update {out['update_device_ms_per_step']:.4f} ms"
                   if dev_us else "not measured (trace holds no device "
                   "time)") + f"; peak {peak} bytes; final checksums (mega, "
        f"accum) {sums}")
    log("  device ms per step by kernel (profiled steps): "
        + json.dumps(out["top_device_ms_per_step"]))
    log(prof.key_averages().table(sort_by="self_cpu_time_total",
                                  row_limit=12))
    del params, state
    return out


def check_flash_attention(torch, dev) -> dict:
    """Phase 9a: the flash-attention kernel against its plain version at
    each of FLASH_SHAPES (bf16 also against the fp32 oracle), a causality
    probe at the prefill's shape, and the times of the kernel, its plain
    version and SDPA (timed only, as the yardstick). Returns the numbers by
    shape name."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref
    log_ptxas(kf.KERNEL, "flash_attention_kernel_sm90")
    out = {}
    for name, shape, dt in FLASH_SHAPES:
        b, h, s, dh = shape
        g = torch.Generator(device=dev)
        g.manual_seed(s + dh)
        q, k, v = (torch.randn(shape, generator=g, device=dev)
                   .to(getattr(torch, dt)) for _ in range(3))
        got = kf.flash_attention(q, k, v)
        rtol, atol = TOL_FLASH[dt]

        def oracle():
            return ref.flash_attention_ref(q, k, v)

        def tiled():
            return ref.flash_attention_tiled_ref(q, k, v, kf.block_k(dh))

        plain = tiled if dt == "bfloat16" else oracle
        checks = [("plain", plain, atol)]
        if plain is tiled:
            checks.append(("fp32 oracle", oracle, atol + TOL_FLASH_ORACLE_V
                           * float(v.float().abs().max())))
        errs = {}
        for what, fn, at in checks:
            want = fn()
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            errs[what] = float(diff.max())
            ok = bool((diff <= at + rtol * want.float().abs()).all()
                      and torch.isfinite(got).all())
            log(f"  flash_attention[{name}] {shape} {dt} vs {what}: "
                f"max_abs_err={errs[what]:.3e} (tol {at:.4g} abs + "
                f"{rtol:.4g} rel)")
            if not ok:
                raise AssertionError(f"flash_attention[{name}] disagrees "
                                     f"with its {what}: {errs[what]}")
            del want, diff
        err = errs["plain"]
        if name == "stablelm":
            p = 5000                                  # mid-tile
            k2, v2 = k.clone(), v.clone()
            k2[:, :, p:], v2[:, :, p:] = 7.0, -5.0
            probe = kf.flash_attention(q, k2, v2)
            causal = bool(torch.equal(probe[:, :, :p], got[:, :, :p]))
            moved = not torch.equal(probe[:, :, p:], got[:, :, p:])
            log(f"  causality: K, V past {p} perturbed -> outputs before it "
                f"bit-equal={causal}, after it changed={moved}")
            if not (causal and moved):
                raise AssertionError("flash_attention is not causal")
            del k2, v2, probe
        flops = 4 * b * h * dh * s * (s + 1) / 2
        t_bytes = 4 * q.numel() * q.element_size() / HBM_BYTES_PER_S
        t_ops = flops / (BF16_FLOPS if dt == "bfloat16" else FP32_FLOPS)
        nums = {
            "shape": list(shape), "dtype": dt, "max_abs_err": err,
            "max_abs_err_vs_fp32_oracle": errs.get("fp32 oracle"),
            "ms": time_ms(torch, lambda: kf.flash_attention(q, k, v), 10,
                          warmup=2),
            "device_ms": device_kernel_ms(
                torch, lambda: kf.flash_attention(q, k, v), 3,
                "flash_attention_kernel"),
            "plain_ms": time_ms(torch, plain, 2, warmup=1),
            "library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), 10, warmup=2),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops,
            "bound_bf16_989T_ms": flops / BF16_FLOPS * 1e3,
            "bound_fp32_67T_ms": flops / FP32_FLOPS * 1e3}
        log(f"  flash_attention[{name}]: {json.dumps(nums)}")
        out[name] = nums
        del q, k, v, got
        gc.collect()
        torch.cuda.empty_cache()
    return out


def lm_prefill(torch, dev, cfg) -> dict:
    """Phase 9b: prefill_step on LM_PROMPT tokens of make_lm_batch at full
    width, then LM_DECODE greedy decode steps; one more prefill under
    torch.profiler. Returns the numbers, the prefill's last logits (fp32,
    host), the parameters and the tokens (9c reuses both)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.kernels import KERNELS
    from repro_torch.models.lm import (decode_step, init_caches,
                                       init_lm_params, prefill_step)
    from repro_torch.nn.params import tree_leaves

    t0 = time.perf_counter()
    params = init_lm_params(cfg, LM_PARAM_SEED, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  {LM_ARCH}: {n_params} parameters (fp32) drawn in "
        f"{time.perf_counter() - t0:.2f}s")
    if n_params != cfg.param_count_estimate():
        raise AssertionError(f"{n_params} parameters, want "
                             f"{cfg.param_count_estimate()}")
    tokens = torch.from_numpy(
        make_lm_batch(cfg, 1, LM_PROMPT)["tokens"]).to(dev)
    caches = init_caches(cfg, 1, LM_MAX_LEN, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    t0 = time.perf_counter()
    last, caches = prefill_step(params, {"tokens": tokens}, caches, cfg)
    last = last.float()
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    tok = last.argmax(-1)
    generated, decode_ms = [], []
    for i in range(LM_DECODE):
        t0 = time.perf_counter()
        logits, caches = decode_step(params, tok[:, None], caches,
                                     LM_PROMPT + i, cfg)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"decode step {i}: logits not finite")
        tok = logits.float().argmax(-1)
        generated.append(int(tok))
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_launches(KERNELS, "lm_prefill", ("flash_attention",))
    others = {n: c for n, c in counts.items()
              if c and n != "flash_attention"}
    if counts["flash_attention"] != cfg.n_layers or others:
        raise AssertionError(f"want {cfg.n_layers} flash_attention launches "
                             f"(one a layer) and no other kernel: {counts}")
    if last.shape != (1, cfg.vocab_size) or not bool(
            torch.isfinite(last).all()):
        raise AssertionError(f"prefill logits {tuple(last.shape)} not "
                             "finite or of the wrong shape")
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prefill_step(params, {"tokens": tokens}, caches, cfg)
        torch.cuda.synchronize()
    prof_host_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof)
    dev_ms = sum(t for _, t in events) / 1e3
    flash_ms = sum(t for n, t in events if "flash_attention" in n) / 1e3
    top = sorted(events, key=lambda e: -e[1])[:10]
    nums = {"prompt": LM_PROMPT, "max_len": LM_MAX_LEN,
            "prefill_host_ms": prefill_ms,
            "decode_host_ms": decode_ms,
            "profiled_prefill_host_ms": prof_host_ms,
            "prefill_device_busy_ms": dev_ms if dev_ms else None,
            "prefill_flash_device_ms": flash_ms if dev_ms else None,
            "prefill_flash_launch_device_ms":
                flash_ms / cfg.n_layers if dev_ms else None,
            "peak_bytes": peak, "generated": generated,
            "top_device_events_ms": [(n, t / 1e3) for n, t in top]}
    log(f"9b numbers: {json.dumps(nums)}")
    del caches
    return {"numbers": nums, "last": last.cpu(), "params": params,
            "tokens": tokens, "launches": counts}


def lm_prefill_plain(torch, cfg, run: dict) -> dict:
    """Phase 9c: prefill_step on the first LM_PROMPT - 1 tokens (not a
    multiple of attn_block_q: full attention, no kernel), then decode_step
    on the last token, whose logits are for 9b's last position; held to
    9b's within TOL_LM_REL_L2 and TOL_LM_ABS."""
    from repro_torch.kernels import KERNELS
    from repro_torch.models.lm import decode_step, init_caches, prefill_step

    params, tokens = run["params"], run["tokens"]
    dev = tokens.device
    caches = init_caches(cfg, 1, LM_MAX_LEN, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    t0 = time.perf_counter()
    _, caches = prefill_step(params, {"tokens": tokens[:, :LM_PROMPT - 1]},
                             caches, cfg)
    logits, caches = decode_step(params, tokens[:, LM_PROMPT - 1:], caches,
                                 LM_PROMPT - 1, cfg)
    got = logits.float().cpu()
    host_ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches(KERNELS, "lm_prefill_plain", ())
    if any(counts.values()):
        raise AssertionError(f"9c launched kernels: {counts}")
    want = run["last"]
    err = float((got - want).abs().max())
    rel = float((got - want).norm() / want.norm())
    agree = int(got.argmax()) == int(want.argmax())
    nums = {"prompt": LM_PROMPT - 1, "host_ms": host_ms,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "max_abs_err": err, "rel_l2_err": rel, "argmax_agrees": agree,
            "argmax": [int(got.argmax()), int(want.argmax())],
            "max_abs_logit": float(want.abs().max())}
    log(f"9c vs 9b: max_abs_err={err:.4g} (tol {TOL_LM_ABS}) rel_l2_err="
        f"{rel:.4g} (tol {TOL_LM_REL_L2}) argmax agrees={agree}; "
        f"{json.dumps(nums)}")
    if not (err <= TOL_LM_ABS and rel <= TOL_LM_REL_L2
            and bool(torch.isfinite(got).all())):
        raise AssertionError("the kernel prefill and the full-attention "
                             "path disagree")
    del caches
    return {"numbers": nums, "launches": counts}


def lm_serve(torch, cfg) -> dict:
    """Phase 9d: the LM launcher at full width (LM_SERVE_ARGV): every
    request served within its budget, no kernel launched (the engine only
    decodes); then four more requests under torch.profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import KERNELS
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import Request

    log(f"phase 9d: python -m repro_torch.launch.serve "
        f"{' '.join(LM_SERVE_ARGV)}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    t0 = time.perf_counter()
    engine = serve_cli.main(LM_SERVE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches(KERNELS, "lm_serve", ())
    if any(counts.values()):
        raise AssertionError(f"the LM engine launched kernels: {counts}")
    done = engine.completed
    n_req = int(LM_SERVE_ARGV[LM_SERVE_ARGV.index("--requests") + 1])
    budget = int(LM_SERVE_ARGV[LM_SERVE_ARGV.index("--new-tokens") + 1])
    if sorted(done) != list(range(n_req)) or not all(
            len(v) == budget and all(0 <= t < cfg.vocab_size for t in v)
            for v in done.values()):
        raise AssertionError(f"not every request got {budget} tokens: "
                             f"{ {u: len(v) for u, v in done.items()} }")
    steps = engine.steps_run
    peak = torch.cuda.max_memory_allocated()
    rng = np.random.RandomState(1)
    for uid in range(n_req, n_req + engine.batch_slots):
        engine.submit(Request(uid=uid, prompt=rng.randint(
            0, cfg.vocab_size, size=(8,)).astype(np.int32),
            max_new_tokens=budget))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.run_until_drained()
        torch.cuda.synchronize()
    prof_steps = engine.steps_run - steps
    host = (time.perf_counter() - t0) * 1e3 / prof_steps
    dev_ms = sum(t for _, t in device_events(prof)) / 1e3 / prof_steps
    tokens = sum(len(v) for u, v in done.items() if u < n_req)
    nums = {"requests": n_req, "tokens": tokens, "engine_steps": steps,
            "wall_s": wall, "tok_per_s": tokens / wall, "peak_bytes": peak,
            "profiled_steps": prof_steps,
            "profiled_host_ms_per_step": host,
            "profiled_device_busy_ms_per_step": dev_ms if dev_ms else None}
    log(f"9d numbers (profiled steps include their admissions' slot-local "
        f"prefill): {json.dumps(nums)}")
    del engine
    return {"numbers": nums, "launches": counts}


class Tee:
    """A stdout that also keeps what was written (a launcher's lines)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text: str) -> int:
        self.parts.append(text)
        return self.out.write(text)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def run_cli(main, argv: list[str]):
    """main(argv) with its stdout also captured: (result, printed text)."""
    import contextlib
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        res = main(argv)
    return res, tee.text()


def m2_argv(*extra: str) -> list[str]:
    """The launcher at its defaults on full-width dlrm-m2, batch 512."""
    return ["--arch", M2_ARCH, "--batch", str(TRAIN_BATCH), "--log-every",
            "1", *extra]


def rss_bytes() -> tuple[int, int]:
    """(current, peak) resident set of this process, from /proc."""
    import resource
    with open("/proc/self/status") as f:
        cur = next(int(ln.split()[1]) for ln in f if ln.startswith("VmRSS"))
    return cur * 1024, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss \
        * 1024


def time_dense_update(torch, dev, cfg, ebc, mega, accum) -> dict:
    """The dense update alone (`dense_sparse_update`) on the trained
    full-width table and one batch's rows: ms per call by CUDA events and
    device ms from torch.profiler, beside its bound: the buffer zeroed
    ((h + 1) * d * 4 bytes written), the row pass (gsum and mega read,
    mega written, accum read and written) and the scatter's reads of idx,
    the bag gradients and each touched row; ~7 fp32 operations per
    element of the row pass."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.train.steps import dense_sparse_update
    raw = make_dlrm_batch(cfg, TRAIN_BATCH, step=0)
    idx = torch.as_tensor(ebc.offset_indices(raw["idx"])).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    grad = torch.randn((TRAIN_BATCH, cfg.n_sparse_features, cfg.embed_dim),
                       generator=g, device=dev).mul_(1e-3)

    def update():
        dense_sparse_update(mega, accum, idx, grad, SPARSE_LR, SPARSE_EPS)

    ms = time_ms(torch, update, DENSE_TIMED, warmup=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DENSE_TIMED):
            update()
        torch.cuda.synchronize()
    events = device_events(prof)
    dev_us = sum(t for _, t in events)
    h, d = mega.shape
    touched = int(torch.unique(idx[idx >= 0]).numel())
    slots = idx.numel()
    n_bytes = ((h + 1) * d * 4 + 3 * h * d * 4 + 2 * h * 4
               + slots * 4 + grad.numel() * 4 + 2 * touched * d * 4)
    out = {"ms": ms, "device_ms": dev_us / 1e3 / DENSE_TIMED if dev_us
           else None, "rows": h, "touched_rows": touched}
    out["bound_ms"], out["bound_by"] = bound_ms(n_bytes, 7 * h * d)
    by_name: dict[str, float] = {}
    for name, t in events:
        by_name[name[:100]] = by_name.get(name[:100], 0.0) + t
    out["device_ms_by_kernel"] = {
        name: t / 1e3 / DENSE_TIMED for name, t in
        sorted(by_name.items(), key=lambda e: -e[1])[:10] if t}
    return out


def launcher_m2(torch, dev, cfg, ebc, ckdir: str) -> dict:
    """Phase 10a: the launcher at the reference's defaults on full-width
    dlrm-m2 (the dense update, async checkpoints every 50 steps, so none
    in M2_STEPS): exactly one plan-less lookup and one interaction a step
    and no fused update; then the dense update timed alone."""
    import numpy as np

    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train as train_cli
    argv = m2_argv("--steps", str(M2_STEPS), "--ckpt-dir", ckdir)
    log(f"phase 10a: python -m repro_torch.launch.train {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    t0 = time.perf_counter()
    run, _ = run_cli(train_cli.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches(KERNELS, "train_m2",
                           ("embedding_bag", "dot_interaction"))
    if counts["embedding_bag"] != M2_STEPS \
            or counts["dot_interaction"] != M2_STEPS \
            or counts["fused_bag_backward_adagrad"] != 0:
        raise AssertionError(f"10a: want {M2_STEPS} lookups and "
                             f"interactions and no fused update: {counts}")
    losses = run.losses
    if len(losses) != M2_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"10a losses not finite: {losses}")
    sums = (bit_checksum(torch, run.params["emb"]["mega"]),
            bit_checksum(torch, run.state["accum"]))
    step_ms = [s * 1e3 for s in run.times["step_s"]]
    nums = {"wall_s_incl_init": wall, "host_ms_per_step": step_ms,
            "host_ms_per_step_after_first": sum(step_ms[1:])
            / max(len(step_ms) - 1, 1),
            "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"10a: losses {losses}; final (mega, accum) bit checksums {sums} "
        f"(recorded {M2_FINAL_SUMS}: equal={sums == M2_FINAL_SUMS}); "
        f"{json.dumps(nums)}")
    if sums != M2_FINAL_SUMS:
        raise AssertionError(f"10a's final checksums {sums} differ from the "
                             f"recorded {M2_FINAL_SUMS}")
    nums["dense_update"] = time_dense_update(
        torch, dev, cfg, ebc, run.params["emb"]["mega"], run.state["accum"])
    log(f"10a dense update alone: {json.dumps(nums['dense_update'])}")
    del run
    return {"losses": losses, "final_sums": sums, "launches": counts,
            "numbers": nums}


def resume_m2(torch, want: dict, ckdir: str) -> dict:
    """Phase 10b: the 10a run cut at M2_RESUME_AT (a checkpoint there),
    then resumed to M2_STEPS in a new launcher call: its losses and final
    checksums must equal 10a's bit for bit."""
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train as train_cli
    first = m2_argv("--steps", str(M2_RESUME_AT), "--ckpt-every",
                    str(M2_RESUME_AT), "--ckpt-dir", ckdir)
    second = m2_argv("--steps", str(M2_STEPS), "--resume", "--ckpt-dir",
                     ckdir)
    log(f"phase 10b: python -m repro_torch.launch.train {' '.join(first)}; "
        f"then {' '.join(second)}")
    rss_before = rss_bytes()
    run, _ = run_cli(train_cli.main, first)
    if run.losses != want["losses"][:M2_RESUME_AT]:
        raise AssertionError(f"10b's first half {run.losses} is not 10a's")
    saved = {k: v for k, v in run.times.items() if k != "step_s"}
    del run
    rss_saved = rss_bytes()
    free_device(torch)
    step_dir = os.path.join(ckdir, M2_ARCH, f"step_{M2_RESUME_AT:09d}")
    disk = sum(os.path.getsize(os.path.join(step_dir, f))
               for f in os.listdir(step_dir))
    reset_launches(KERNELS)
    run, text = run_cli(train_cli.main, second)
    torch.cuda.synchronize()
    counts = read_launches(KERNELS, "train_m2_resume",
                           ("embedding_bag", "dot_interaction"))
    rss_restored = rss_bytes()
    sums = (bit_checksum(torch, run.params["emb"]["mega"]),
            bit_checksum(torch, run.state["accum"]))
    resumed = f"resumed from step {M2_RESUME_AT}" in text
    equal = (run.losses == want["losses"][M2_RESUME_AT:]
             and sums == want["final_sums"])
    save_s = saved["save_snapshot_s"] + saved["save_wait_s"]
    nums = {"disk_bytes": disk, **saved, "save_s": save_s,
            "save_gb_per_s": disk / save_s / 1e9,
            "restore_s": run.times["restore_s"],
            "restore_gb_per_s": disk / run.times["restore_s"] / 1e9,
            "rss_bytes_before": rss_before[0],
            "rss_bytes_after_save": rss_saved[0],
            "rss_bytes_after_restore": rss_restored[0],
            "rss_peak_bytes": rss_restored[1]}
    log(f"10b: 'resumed from step {M2_RESUME_AT}' printed: {resumed}; "
        f"steps {M2_RESUME_AT}-{M2_STEPS - 1} losses {run.losses} vs 10a "
        f"{want['losses'][M2_RESUME_AT:]}; final checksums {sums} vs "
        f"{want['final_sums']}: bit-equal={equal}; {json.dumps(nums)}")
    del run
    if not resumed or not equal:
        raise AssertionError("the resumed run is not 10a's continuation")
    if counts["embedding_bag"] != M2_STEPS - M2_RESUME_AT:
        raise AssertionError(f"10b: want {M2_STEPS - M2_RESUME_AT} lookups "
                             f"in the resumed run: {counts}")
    return {"numbers": nums, "launches": counts}


def sparse_m2(torch, dev, want: dict, ckdir: str) -> dict:
    """Phase 10c: `--sparse-apply sparse` from the same seed for
    M2_RESUME_AT steps, held to 10a's losses and to the dense table and
    accumulator that 10b saved at that step, within TOL_M2_SPARSE."""
    import numpy as np

    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train as train_cli
    argv = m2_argv("--steps", str(M2_RESUME_AT), "--sparse-apply", "sparse",
                   "--ckpt-dir", os.path.join(ckdir, "sparse"))
    log(f"phase 10c: python -m repro_torch.launch.train {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    run, _ = run_cli(train_cli.main, argv)
    torch.cuda.synchronize()
    counts = read_launches(KERNELS, "train_m2_sparse",
                           ("embedding_bag", "dot_interaction",
                            "fused_bag_backward_adagrad"))
    dense_losses = np.asarray(want["losses"][:M2_RESUME_AT])
    loss_err = np.abs(np.asarray(run.losses) - dense_losses)
    ok = bool((loss_err <= TOL_M2_SPARSE
               + TOL_M2_SPARSE * np.abs(dense_losses)).all())
    step_dir = os.path.join(ckdir, M2_ARCH, f"step_{M2_RESUME_AT:09d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        files = {e["path"]: e["file"] for e in json.load(f)["leaves"]}
    errs = {}
    for path, got in (("params/emb/mega", run.params["emb"]["mega"]),
                      ("state/accum", run.state["accum"])):
        saved = np.load(os.path.join(step_dir, files[path]), mmap_mode="r")
        err = 0.0
        for lo in range(0, saved.shape[0], 1 << 20):
            part = torch.from_numpy(np.array(saved[lo:lo + (1 << 20)])).to(
                dev)
            good, e = close(got[lo:lo + (1 << 20)], part, TOL_M2_SPARSE)
            ok, err = ok and good, max(err, e)
        errs[path] = err
    nums = {"loss_max_abs_err": float(loss_err.max()),
            "mega_max_abs_err": errs["params/emb/mega"],
            "accum_max_abs_err": errs["state/accum"],
            "host_ms_per_step": [s * 1e3 for s in run.times["step_s"]],
            "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"10c: sparse losses {run.losses} vs dense {dense_losses.tolist()}; "
        f"{json.dumps(nums)} (tol {TOL_M2_SPARSE} abs + rel)")
    del run
    if not ok:
        raise AssertionError("the sparse update disagrees with the dense")
    return {"numbers": nums, "launches": counts}


def chaos_smoke(torch, base: str) -> dict:
    """Phase 10d: the launcher under `--chaos` for each of CHAOS_SEEDS on
    the card (smoke dlrm-m2, CHAOS_ARGV), each held bit for bit to the
    same run without faults; at least one fault must fire. The chaos
    runs' launches are counted."""
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train as train_cli
    counts = {k.name: 0 for k in KERNELS}
    fired, rows = 0, []
    for seed in CHAOS_SEEDS:
        clean, _ = run_cli(train_cli.main, CHAOS_ARGV + [
            "--ckpt-dir", os.path.join(base, f"clean_{seed}")])
        argv = CHAOS_ARGV + ["--ckpt-dir", os.path.join(base, f"chaos_{seed}"),
                             "--chaos", "--chaos-seed", str(seed)]
        log(f"phase 10d: python -m repro_torch.launch.train {' '.join(argv)}")
        reset_launches(KERNELS)
        run, text = run_cli(train_cli.main, argv)
        torch.cuda.synchronize()
        for k in KERNELS:
            counts[k.name] += k.launches
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("chaos: fired "))
        n = 0 if line.endswith(" nothing") else line.count("]=")
        fired += n
        equal = (run.losses == clean.losses
                 and bit_checksum(torch, run.params["emb"]["mega"])
                 == bit_checksum(torch, clean.params["emb"]["mega"])
                 and bit_checksum(torch, run.state["accum"])
                 == bit_checksum(torch, clean.state["accum"]))
        rows.append({"seed": seed, "fired": n, "bit_equal": equal})
        log(f"10d seed {seed}: {line}; losses bit-equal to the fault-free "
            f"run: {equal}")
        if not equal:
            raise AssertionError(f"10d seed {seed}: the chaos run is not the "
                                 "fault-free run")
        del clean, run
    log(f"launches in the train_m2_chaos runs: {counts}")
    if fired < 1:
        raise AssertionError("10d: no fault fired over the chaos runs")
    for name in ("embedding_bag", "dot_interaction"):
        if counts[name] <= 0:
            raise AssertionError(f"10d: {name} never launched")
    return {"numbers": rows, "launches": counts}


def serve_chaos(torch, cc) -> dict:
    """Phase 10e: full-width dlrm-m1 served through the launcher with
    `--chaos` (a seeded FaultInjector on serve.fetch and serve.admit, one
    retry): every request is served or shed, and a fault fires."""
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import serve as serve_cli
    argv = ["--arch", ARCH, "--cache-rows", str(cc.cache_rows), "--requests",
            str(CHAOS_REQUESTS), "--chaos", "--chaos-seed", "13"]
    log(f"phase 10e: python -m repro_torch.launch.serve {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    engine, text = run_cli(serve_cli.main, argv)
    torch.cuda.synchronize()
    counts = read_launches(KERNELS, "serve_chaos",
                           ("embedding_bag", "dot_interaction",
                            "cache_exchange"))
    summary = next(ln for ln in text.splitlines()
                   if ln.startswith("serve[dlrm]:"))
    kv = dict(part.split("=", 1) for part in summary.split()[1:])
    fired = engine.injector.fired
    nums = {"served": int(kv["served"]), "shed": int(kv["shed"]),
            "degraded": int(kv["degraded"]), "fired": fired,
            "transitions": engine.breaker.transitions,
            "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"10e: {json.dumps(nums, default=str)}")
    del engine
    if nums["served"] + nums["shed"] != CHAOS_REQUESTS or not fired \
            or "chaos: fired=" not in text:
        raise AssertionError(f"10e: want all {CHAOS_REQUESTS} requests "
                             f"resolved and a fault fired: {nums}")
    return {"numbers": nums, "launches": counts}


def evict_search(torch, dev, cfg) -> dict:
    """The smallest cache at which run 7b (AsyncCachedTier, fetch_chunk
    EVICT_CHUNK, the dedup reader, the launcher's TRAIN_STEPS batches)
    keeps its thrash guard: bisection over [EVICT_SEARCH_LO,
    EVICT_CACHE_ROWS], assuming the guard holds at every size above one at
    which it holds. Every trial trains on the same table, since the guard
    reads only the batches' rows and the tier's host state."""
    from repro_torch.core.cache import CachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.tiers import AsyncCachedTier
    from repro_torch.data.pipeline import ShardedLoader, dedup_indices_hook
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.launch.train import PARAM_SEED
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import (build_cached_train_step,
                                         cached_dlrm_init_state)

    probe = CachedEmbeddingBagCollection.build(cfg, cache_rows=EVICT_SEARCH_LO)
    params = init_dlrm_params(cfg, probe.ebc, PARAM_SEED, dev)
    mega = params.pop("emb")["mega"]
    trials = []

    def holds(rows: int, schedule: str) -> bool:
        cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=rows,
                                                fetch_chunk=EVICT_CHUNK)
        tier = AsyncCachedTier(cc) if schedule == "async" else cc
        opt = adagrad(0.01)
        state = cached_dlrm_init_state(cc, opt, params)
        dense = {"bottom": params["bottom"], "top": params["top"]}
        cs = tier.init_state(mega)                   # owned, no copy
        step_fn = build_cached_train_step(cfg, tier, opt, SPARSE_LR,
                                          SPARSE_EPS)
        pipe = ShardedLoader(
            lambda step, seed: make_dlrm_batch(cfg, TRAIN_BATCH, step, seed),
            TRAIN_BATCH).pipeline(
                prefetch=2,
                transform=dedup_indices_hook(cc.ebc.plan.table_offsets))
        t0 = time.perf_counter()
        trial = {"cache_rows": rows, "schedule": schedule}
        try:
            for step in range(TRAIN_STEPS):
                _, batch = next(pipe)
                last = step == TRAIN_STEPS - 1
                dense, state, _ = step_fn(
                    dense, state, cs, batch, step,
                    next_batch=None if last else pipe.peek(0))
            torch.cuda.synchronize()
            st = tier.stats(cs)
            trial.update(holds=True, evictions=st.evictions,
                         writebacks=st.writebacks)
        except ValueError as e:       # the thrash or working-set guard
            if "cache thrash" not in str(e) and "> cache_rows" not in str(e):
                raise
            trial.update(holds=False, at_step=step, error=str(e))
        finally:
            pipe.close()
        trial["seconds"] = time.perf_counter() - t0
        trials.append(trial)
        log(f"  {json.dumps(trial)}")
        del cs, state, dense
        return trial["holds"]

    lo, hi = EVICT_SEARCH_LO, EVICT_CACHE_ROWS
    if not holds(hi, "async"):
        raise AssertionError(f"the thrash guard fails at {hi} rows")
    if holds(lo, "async"):
        hi = lo
    while hi - lo > EVICT_SEARCH_GRAIN:
        mid = (lo + hi) // 2 // EVICT_SEARCH_GRAIN * EVICT_SEARCH_GRAIN
        if holds(mid, "async"):
            hi = mid
        else:
            lo = mid
    out = {"smallest_async": hi, "sync_holds_there": holds(hi, "sync"),
           "trials": trials}
    del mega, params
    return out


def search_main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this search "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNELS, build_all
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(f"gpu (nvidia-smi name, power.limit): {smi}")
    build_all(list(KERNELS))
    log(f"evict search: {ARCH} batch {TRAIN_BATCH}, {TRAIN_STEPS} steps, "
        f"fetch_chunk {EVICT_CHUNK}, cache rows in [{EVICT_SEARCH_LO}, "
        f"{EVICT_CACHE_ROWS}] by {EVICT_SEARCH_GRAIN}")
    out = evict_search(torch, resolve_device("cuda"), get_config(ARCH))
    print(json.dumps({"evict_search": out}), flush=True)
    return 0


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
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.kernels import KERNELS, build_all
    from repro_torch.launch import train as train_cli

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
    for src in dict.fromkeys(k.source.stem for k in KERNELS):
        k = next(k for k in KERNELS if k.source.stem == src)
        for line in k.build_log.splitlines():
            if ("Function properties" in line or "registers" in line
                    or "spill" in line):
                log(f"  {src}: {line.strip()}")

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
    log_peak(torch, "phase 3")
    free_device(torch)

    # 4. serve dlrm-m1 at full width through the launcher
    serve_launches = serve_phase(torch, cfg, cc)
    free_device(torch)

    # 5. the training kernels against their plain versions at full width
    ebc = EmbeddingBagCollection.build(cfg, n_shards=1,
                                       strategy="replicated")
    log(f"phase 5: training kernels vs plain at {ARCH} shapes "
        f"(R={ebc.plan.total_rows}, D={d}, batch {TRAIN_BATCH})")
    trained = check_training_kernels(torch, dev, cfg, ebc)
    numbers["embedding_bag"]["train_shape"] = trained.pop(
        "embedding_bag_train")
    numbers.update(trained)
    numbers["dot_interaction"]["train_shape"] = check_dot_interaction(
        torch, dev, TRAIN_BATCH, f + 1, d)
    log_peak(torch, "phase 5")
    free_device(torch)

    # 5b. the cached tier's training row movers at full width
    log(f"phase 5b: cached-tier fetch, chunked fetch and commit vs plain "
        f"(R={r_rows}, C={c_rows}, D={d}, the misses of one batch of "
        f"{TRAIN_BATCH})")
    numbers.update(check_cache_movers(torch, dev, cfg, cc))
    log_peak(torch, "phase 5b")
    free_device(torch)

    # 5c. the table-wise kernels at full width on the 8-owner layout
    ebc_tw = EmbeddingBagCollection.build(cfg, n_shards=TABLEWISE_OWNERS,
                                          strategy="table_wise")
    log(f"phase 5c: segmented fused backward and row-wise AdaGrad vs plain "
        f"on the {TABLEWISE_OWNERS}-owner table_wise layout "
        f"(R={ebc_tw.plan.total_rows}, shard_rows={ebc_tw.plan.shard_rows}, "
        f"D={d}, batch {TRAIN_BATCH})")
    numbers.update(check_tablewise_kernels(torch, dev, cfg, ebc_tw))
    log_peak(torch, "phase 5c")
    free_device(torch)

    # 6a. train through the launcher (plan-less lookups, on-device plans)
    from repro_torch.core.dlrm import init_dlrm_params
    init = init_dlrm_params(cfg, ebc, train_cli.PARAM_SEED, dev)
    init_sum = bit_checksum(torch, init["emb"]["mega"])
    del init
    free_device(torch)
    argv = ["--arch", ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--log-every", "1", "--sparse-apply", "sparse"]
    log(f"phase 6a: python -m repro_torch.launch.train {' '.join(argv)}")
    reset_launches(KERNELS)
    t0 = time.perf_counter()
    run = train_cli.main(argv)
    torch.cuda.synchronize()
    launcher_launches = read_launches(
        KERNELS, "launcher training",
        ("embedding_bag", "dot_interaction", "fused_bag_backward_adagrad"))
    losses = run.losses
    final_sums = (bit_checksum(torch, run.params["emb"]["mega"]),
                  bit_checksum(torch, run.state["accum"]))
    del run
    log(f"launcher run: {TRAIN_STEPS} steps in "
        f"{time.perf_counter() - t0:.2f}s incl. init; losses {losses}; "
        f"bit checksums: initial mega {init_sum}, final (mega, accum) "
        f"{final_sums}")
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"launcher losses not finite: {losses}")
    log(f"launcher final checksums equal the recorded "
        f"{LAUNCHER_FINAL_SUMS}: {final_sums == LAUNCHER_FINAL_SUMS}")
    if final_sums != LAUNCHER_FINAL_SUMS:
        raise AssertionError(f"launcher final checksums {final_sums} differ "
                             f"from the recorded {LAUNCHER_FINAL_SUMS}")
    log_peak(torch, "phase 6a")
    free_device(torch)

    # 6b. train through the plan hook (dedup lookups, reader-thread plans)
    log("phase 6b: ShardedLoader.pipeline(transform=sparse_plan_hook(...)) "
        f"-> build_dlrm_train_step, {TRAIN_STEPS} steps from the same seed")
    reset_launches(KERNELS)
    train_numbers = train_planned(torch, dev, cfg, ebc, losses)
    planned_launches = read_launches(
        KERNELS, "planned training",
        ("dedup_embedding_bag", "dot_interaction",
         "fused_bag_backward_adagrad"))
    log_peak(torch, "phase 6b")
    log(f"training numbers: {json.dumps(train_numbers)}")
    free_device(torch)

    # 7. train through the cached tier: the deployment (async stream, the
    #    plan's cache, plans and lookahead as examples/train_cached.py),
    #    then an eviction run on each schedule with chunked transfers
    want = {"losses": losses, "init_sum": init_sum, "final_sums": final_sums}
    step_kernels = ("dot_interaction", "fused_bag_backward_adagrad",
                    "cache_exchange", "cache_commit")
    runs = [
        {"name": "7a", "path": "train_cached_async", "tier": "async",
         "cache_rows": None, "fetch_chunk": 1, "hook": "plan",
         "lookahead": True, "evicts": False,
         "needs": step_kernels + ("dedup_embedding_bag", "cache_fetch")},
        {"name": "7b", "path": "train_cached_async_evict", "tier": "async",
         "cache_rows": EVICT_CACHE_ROWS, "fetch_chunk": EVICT_CHUNK,
         "hook": "dedup", "lookahead": False, "evicts": True,
         "needs": step_kernels + ("embedding_bag", "cache_fetch",
                                  "cache_fetch_chunked")},
        {"name": "7c", "path": "train_cached_sync_evict", "tier": "sync",
         "cache_rows": EVICT_CACHE_ROWS, "fetch_chunk": EVICT_CHUNK,
         "hook": "dedup", "lookahead": False, "evicts": True,
         "needs": step_kernels + ("embedding_bag", "cache_fetch",
                                  "cache_fetch_chunked")},
    ]
    paths = {"serve": serve_launches, "train_launcher": launcher_launches,
             "train_planned": planned_launches}
    for r in runs:
        log(f"phase {r['name']}: build_cached_train_step, {TRAIN_STEPS} "
            f"steps from the launcher's seed and batches")
        res = train_cached(torch, dev, cfg, r, want)
        paths[r["path"]] = read_launches(KERNELS, r["path"], r["needs"])
        log(f"{r['name']} numbers: {json.dumps(res)}")
        free_device(torch)

    # 8. train under the table-wise placement (8a), then the oracle on the
    #    same layout from the same seed and batches (8b): bit-equal
    log(f"phase 8a: ShardedLoader.pipeline(transform=sparse_plan_hook(...)) "
        f"-> build_tablewise_train_step(next_batch staged), {TRAIN_STEPS} "
        f"steps, {TABLEWISE_OWNERS} owners")
    tw = train_tablewise(torch, dev, cfg, ebc_tw, oracle=False)
    paths["train_tablewise"] = read_launches(
        KERNELS, "train_tablewise",
        ("embedding_bag", "dot_interaction",
         "fused_bag_backward_adagrad_segments"))
    counts = paths["train_tablewise"]
    if counts["fused_bag_backward_adagrad_segments"] != TRAIN_STEPS \
            or counts["embedding_bag"] != TRAIN_STEPS \
            or counts["fused_bag_backward_adagrad"] != 0:
        raise AssertionError(
            f"8a: want one segmented update and one pooled lookup (staged "
            f"from step 1 on) per step, no one-plan update: {counts}")
    free_device(torch)
    log("phase 8b: the oracle, build_dlrm_train_step on the same layout, "
        "seed and batches")
    tw_oracle = train_tablewise(torch, dev, cfg, ebc_tw, oracle=True)
    paths["train_tablewise_oracle"] = read_launches(
        KERNELS, "train_tablewise_oracle",
        ("dedup_embedding_bag", "dot_interaction",
         "fused_bag_backward_adagrad"))
    free_device(torch)
    equal = (tw["losses"] == tw_oracle["losses"]
             and tw["final_sums"] == tw_oracle["final_sums"]
             and tw["init_sum"] == tw_oracle["init_sum"])
    log(f"8a vs 8b: losses {tw['losses']} vs {tw_oracle['losses']}; final "
        f"checksums {tw['final_sums']} vs {tw_oracle['final_sums']}: "
        f"bit-equal={equal}")
    if not equal:
        raise AssertionError("the table-wise run is not bit-equal to the "
                             "oracle")
    log(f"8a and 8b final checksums equal the recorded "
        f"{TABLEWISE_FINAL_SUMS}: "
        f"{tw['final_sums'] == tw_oracle['final_sums'] == TABLEWISE_FINAL_SUMS}")
    if tw["final_sums"] != TABLEWISE_FINAL_SUMS:
        raise AssertionError(f"table-wise final checksums {tw['final_sums']} "
                             f"differ from the recorded "
                             f"{TABLEWISE_FINAL_SUMS}")
    for name, res in (("8a", tw), ("8b", tw_oracle)):
        log(f"{name} numbers: " + json.dumps(
            {k: v for k, v in res.items() if k != "losses"}))

    # 9. serve stablelm-1.6b at full width: the flash-attention kernel
    #    against its plain version (9a), the prefill through the kernel and
    #    greedy decode (9b), the same position through the full-attention
    #    path (9c), the LM launcher's engine (9d)
    lm_cfg = get_config(LM_ARCH)
    log("phase 9a: flash_attention vs plain at " + ", ".join(
        f"{n} {shape} {dt}" for n, shape, dt in FLASH_SHAPES))
    flash = check_flash_attention(torch, dev)
    numbers["flash_attention"] = flash["stablelm"]
    log_peak(torch, "phase 9a")
    free_device(torch)
    log(f"phase 9b: {LM_ARCH} prefill_step on make_lm_batch(cfg, 1, "
        f"{LM_PROMPT}) into caches of max_len {LM_MAX_LEN}, then "
        f"{LM_DECODE} greedy decode_steps")
    run = lm_prefill(torch, dev, lm_cfg)
    paths["lm_prefill"] = run["launches"]
    # the prefill's 24 launches are the stablelm shape's, and 9b's short
    # trace records them all, where 9a's per-kernel read late in this
    # process comes back empty or partial (PERF.md section 7): the kernels
    # line takes 9b's device ms and keeps 9a's beside it
    fa = numbers["flash_attention"]
    fa["device_ms_9a_profiler"] = fa["device_ms"]
    fa["device_ms"] = run["numbers"]["prefill_flash_launch_device_ms"]
    fa["device_ms_from"] = "9b prefill trace, per launch"
    log(f"phase 9c: prefill_step on the first {LM_PROMPT - 1} tokens (full "
        f"attention), decode_step on token {LM_PROMPT - 1}")
    paths["lm_prefill_plain"] = lm_prefill_plain(torch, lm_cfg, run)[
        "launches"]
    del run
    free_device(torch)
    paths["lm_serve"] = lm_serve(torch, lm_cfg)["launches"]
    free_device(torch)

    # 10. the reference trainer at its defaults on full-width dlrm-m2: the
    #     launcher (10a), the same run cut and resumed (10b), the sparse
    #     update from the same seed (10c); then the launcher's chaos on the
    #     smoke config (10d) and the serving tier's on full-width dlrm-m1
    #     (10e)
    import shutil
    import tempfile
    m2 = get_config(M2_ARCH)
    ebc_m2 = EmbeddingBagCollection.build(m2, n_shards=1,
                                          strategy="replicated")
    log(f"phase 10a: embedding_bag and dot_interaction vs plain at "
        f"{M2_ARCH}'s training shapes (R={ebc_m2.plan.total_rows}, "
        f"D={m2.embed_dim}, batch {TRAIN_BATCH})")
    numbers["embedding_bag"]["m2_train_shape"] = check_embedding_bag(
        torch, dev, ebc_m2.plan.total_rows, m2.embed_dim,
        TRAIN_BATCH * m2.n_sparse_features, m2.truncation)
    numbers["dot_interaction"]["m2_train_shape"] = check_dot_interaction(
        torch, dev, TRAIN_BATCH, m2.n_sparse_features + 1, m2.embed_dim)
    free_device(torch)
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_m2_",
                             dir=os.path.join(ROOT, "runs"))
    try:
        m2_run = launcher_m2(torch, dev, m2, ebc_m2,
                             os.path.join(ckdir, "10a"))
        paths["train_m2"] = m2_run["launches"]
        log_peak(torch, "phase 10a")
        free_device(torch)
        paths["train_m2_resume"] = resume_m2(
            torch, m2_run, os.path.join(ckdir, "10b"))["launches"]
        log_peak(torch, "phase 10b")
        free_device(torch)
        paths["train_m2_sparse"] = sparse_m2(
            torch, dev, m2_run, os.path.join(ckdir, "10b"))["launches"]
        log_peak(torch, "phase 10c")
        free_device(torch)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_chaos_",
                             dir=os.path.join(ROOT, "runs"))
    try:
        paths["train_m2_chaos"] = chaos_smoke(torch, ckdir)["launches"]
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    free_device(torch)
    paths["serve_chaos"] = serve_chaos(torch, cc)["launches"]
    log_peak(torch, "phase 10e")
    free_device(torch)

    # 11. the numbers, then the result
    replaces = {
        "embedding_bag": "src/repro/kernels/embedding_bag.py:88",
        "dedup_embedding_bag": "src/repro/kernels/embedding_bag.py:191",
        "dot_interaction": "src/repro/kernels/dot_interaction.py:37",
        "cache_exchange": "src/repro/kernels/cache_ops.py:114",
        "cache_fetch": "src/repro/kernels/cache_ops.py:226",
        "cache_fetch_chunked": "src/repro/kernels/cache_ops.py:302",
        "cache_commit": "src/repro/kernels/cache_ops.py:401",
        "fused_bag_backward_adagrad": "src/repro/kernels/sparse_update.py:174",
        "fused_bag_backward_adagrad_segments":
            "src/repro/kernels/sparse_update.py:126",
        "rowwise_adagrad": "src/repro/kernels/rowwise_adagrad.py:73",
        "flash_attention": "src/repro/kernels/flash_attention.py:100"}
    rows = []
    for k in KERNELS:
        nums = numbers[k.name]
        rows.append({
            "name": k.name, "route": "cuda",
            "source": os.path.relpath(k.source, ROOT),
            "replaces": replaces[k.name],
            "launches": sum(p[k.name] for p in paths.values()),
            "launches_by_path": {n: p[k.name] for n, p in paths.items()},
            **{key: nums[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms")},
            **{key: nums[key] for key in (
                "device_ms_from", "device_ms_9a_profiler",
                "max_abs_err_vs_fp32_oracle", "train_shape",
                "m2_train_shape", "host_us")
                if key in nums}})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def serve_phase(torch, cfg, cc) -> dict:
    """Phase 4: serve through the launcher, check the responses and one
    plain recompute, profile a few more steps. Returns the launch counts;
    the engine (50 GB of tiers) is dropped on return."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import ServeRequest, ServeResponse

    argv = ["--arch", ARCH, "--cache-rows", str(cc.cache_rows), "--batch",
            str(BATCH), "--max-batch", str(MAX_BATCH), "--requests",
            str(REQUESTS), "--zipf-alpha", "1.05"]
    log(f"phase 4: python -m repro_torch.launch.serve {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    t0 = time.perf_counter()
    engine = serve_cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(
        KERNELS, f"serving ({engine.metrics.batches} batches)",
        ("embedding_bag", "dot_interaction", "cache_exchange"))
    log_peak(torch, "phase 4")
    served = [engine.results.get(u) for u in range(REQUESTS)]
    if not all(isinstance(s, ServeResponse) and not s.degraded
               and s.probs.shape == (BATCH,) and np.isfinite(s.probs).all()
               for s in served):
        raise AssertionError("not every request was served healthy with "
                             f"{BATCH} finite probabilities")
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
    dev_us = sum(t for _, t in device_events(prof))
    per_step = dev_us / 1e3 / (engine.metrics.batches - b0)
    log(f"profiled serve steps: host {host * 1e3:.3f} ms/step, device busy "
        f"{per_step:.3f} ms/step (profiler on)" if dev_us else
        f"profiled serve steps: host {host * 1e3:.3f} ms/step, device time "
        "not measured (trace holds no device time)")
    log(prof.key_averages().table(sort_by="self_cpu_time_total",
                                  row_limit=12))
    return launches


if __name__ == "__main__":
    sys.exit(search_main() if sys.argv[1:] == ["--evict-search"]
             else main())
