"""Training launcher of the port: the reference launcher's DLRM and LM
modes.

    python -m repro_torch.launch.train --arch dlrm-m1 --smoke --steps 20 \\
        --device cpu
    python -m repro_torch.launch.train --arch stablelm-1.6b --smoke \\
        --steps 30 --device cpu
    python -m repro_torch.launch.train --arch stablelm-1.6b --seq 4096 \\
        --batch 4 --steps 4
    python -m repro_torch.launch.train --arch dlrm-m2 --steps 8 --batch 512
    python -m repro_torch.launch.train --arch dlrm-m2 --steps 8 --resume
    python -m repro_torch.launch.train --arch dlrm-m1 --steps 8 --batch 512 \\
        --sparse-apply sparse
    python -m repro_torch.launch.train --arch dlrm-m2 --smoke --chaos \\
        --chaos-seed 3 --steps 16 --ckpt-every 2 --device cpu

DLRM: seeded parameters (`init_dlrm_params`, seed 0) with the whole mega
table on the device, dense `adagrad(0.01)`, `make_dlrm_batch` batches and
`build_dlrm_train_step` with the reference launcher's defaults: the dense
update (`--sparse-apply dense`). LM (any family: dense, MoE, SSM,
hybrid, and the vision and audio frontends, whose batches carry the stub
frontend's embeddings): seeded parameters (`init_lm_params`, seed 0),
`adamw(--lr)` with its global-norm clip at 1.0, `make_lm_batch` batches
of `--seq` positions and `build_lm_train_step`. Both: synthetic batches
through a prefetching `ShardedLoader` pipeline, an async
CRC-verified checkpoint of {"params", "state"} every `--ckpt-every` steps
into `<ckpt-dir>/<arch>`, `--resume` from its newest intact step, and
`run_resilient_loop` with SIGTERM preemption and straggler flags.
`--chaos` runs under a seeded fault schedule (a dead reader, a torn
checkpoint leaf, a preemption) through `run_chaos_loop`, restoring the
TrainState bundle and replaying.

`--sparse-apply` is the one flag the reference lacks: its dense buffer is
a second table, and full-width dlrm-m1 (43.6 GB) does not fit twice on an
80 GB card, so `--sparse-apply sparse` trains it with the fused update. A
dense run whose buffer does not fit fails before its first step, naming
that flag; the mode is never switched quietly. Two departures from the
reference, both so that a resumed run continues the interrupted one
batch for batch: the pipeline starts at the resumed step, and the step
resumed from is the one that loaded (`last_restored_step`).

Runs on the card unless `--device cpu` is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import DLRMConfig, get_config, get_smoke_config

#: seed of the torch.Generator the parameters are drawn from
PARAM_SEED = 0
#: device memory the dense update needs beside its buffer: the row pass's
#: chunk temporaries and the step's activations
DENSE_HEADROOM_BYTES = 4 << 30


class TrainRun(NamedTuple):
    """What a launcher run leaves behind: the trained parameters and
    optimizer state (on the run's device), the loss of every step it ran
    (steps `start_step` on), and its host seconds: "step_s" per step
    (through the loss's read, so the device's work included), and those of
    the checkpoints it made ("restore_s", "save_snapshot_s" to copy to
    the host, "save_wait_s" for the writes still running at the end)."""
    params: dict
    state: dict
    losses: list[float]
    start_step: int = 0
    times: dict | None = None


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The pipeline's numpy batch as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def check_dense_fits(total_rows: int, d: int, device: torch.device) -> None:
    """Fail before the first dense step when its (total_rows + 1, d) fp32
    buffer and headroom exceed the card's free memory (what
    `mem_get_info` reports free, plus blocks PyTorch's allocator holds
    unused)."""
    if device.type != "cuda":
        return
    need = (total_rows + 1) * d * 4 + DENSE_HEADROOM_BYTES
    free = (torch.cuda.mem_get_info(device)[0]
            + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))
    if need > free:
        raise RuntimeError(
            f"the dense update needs {need / 1e9:.1f} GB for its "
            f"({total_rows + 1}, {d}) fp32 buffer, and {free / 1e9:.1f} GB "
            "of the card is free beside the table; train this arch with "
            "--sparse-apply sparse")


def _dlrm_job(cfg, args, device):
    """(fresh, gen, step_fn) of the DLRM mode."""
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_dlrm_train_step, dlrm_init_state

    ebc = EmbeddingBagCollection.build(cfg, n_shards=1,
                                       strategy="replicated")
    opt = adagrad(0.01)
    step_fn = build_dlrm_train_step(cfg, ebc, opt,
                                    sparse_apply=args.sparse_apply)

    def fresh():
        params = init_dlrm_params(cfg, ebc, PARAM_SEED, device)
        state = dlrm_init_state(ebc, opt, params)
        if args.sparse_apply == "dense":
            check_dense_fits(ebc.plan.total_rows, cfg.embed_dim, device)
        return params, state

    def gen(step, seed):
        raw = make_dlrm_batch(cfg, args.batch, step, seed)
        raw["idx"] = ebc.offset_indices(raw["idx"])
        return raw

    return fresh, gen, step_fn


def _lm_job(cfg, args, device):
    """(fresh, gen, step_fn) of the LM mode."""
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models.lm import init_lm_params
    from repro_torch.nn.sharding import TRAIN_RULES
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_lm_train_step

    opt = adamw(args.lr)
    # the reference launcher's rules; with no mesh they change no bit
    step_fn = build_lm_train_step(cfg, opt, TRAIN_RULES)

    def fresh():
        params = init_lm_params(cfg, PARAM_SEED, device)
        return params, opt.init(params)

    def gen(step, seed):
        return make_lm_batch(cfg, args.batch, args.seq, step, seed)

    return fresh, gen, step_fn


def train(cfg, args) -> TrainRun:
    """Train `cfg` (a DLRM or an LM of any family) for `args.steps` steps
    on `args.device`."""
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.fault_tolerance import (FaultInjector,
                                                   PreemptionHandler,
                                                   StragglerDetector,
                                                   run_resilient_loop)

    device = resolve_device(args.device)
    inj = None
    if args.chaos:
        # cache.fetch is left out: this launcher drives the uncached step
        inj = FaultInjector.from_seed(
            args.chaos_seed, args.steps, n_faults=args.chaos_faults,
            sites=("pipeline.batch", "checkpoint.write", "loop.step"))
        print("chaos schedule: " + ", ".join(
            f"{s.site}[{s.at}]={s.kind}" for s in inj.schedule), flush=True)
    ckpt = CheckpointManager(f"{args.ckpt_dir}/{args.arch}", injector=inj)
    job = _dlrm_job if isinstance(cfg, DLRMConfig) else _lm_job
    fresh, gen, step_fn = job(cfg, args, device)
    loader = ShardedLoader(gen, args.batch)
    preempt = PreemptionHandler()
    try:
        if args.chaos:
            return _chaos_main(args, device, inj, ckpt, preempt, loader,
                               fresh, step_fn)
        params, state = fresh()
        times: dict = {"step_s": []}
        start = 0
        if args.resume and ckpt.latest_step() is not None:
            t0 = time.perf_counter()
            blob = ckpt.restore({"params": params, "state": state})
            params, state = blob["params"], blob["state"]
            start = ckpt.last_restored_step
            times["restore_s"] = time.perf_counter() - t0
            print(f"resumed from step {start}", flush=True)
        pipeline = loader.pipeline(prefetch=2, start_step=start)
        straggler = StragglerDetector()
        losses = []

        def one_step(step):
            nonlocal params, state
            t0 = time.perf_counter()
            _, batch = next(pipeline)
            params, state, metrics = step_fn(
                params, state, batch_to_device(batch, device), step)
            losses.append(float(metrics["loss"]))
            times["step_s"].append(time.perf_counter() - t0)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {losses[-1]:.4f}", flush=True)

        def save(step):
            t0 = time.perf_counter()
            ckpt.save(step, {"params": params, "state": state}, async_=True)
            times["save_snapshot_s"] = (times.get("save_snapshot_s", 0.0)
                                        + time.perf_counter() - t0)

        try:
            last = run_resilient_loop(one_step, args.steps, save,
                                      args.ckpt_every, preempt, straggler,
                                      start_step=start)
            t0 = time.perf_counter()
            ckpt.wait()
            if "save_snapshot_s" in times:
                times["save_wait_s"] = time.perf_counter() - t0
        finally:
            pipeline.close()
        if losses:
            print(f"done at step {last}; loss {losses[0]:.4f} -> "
                  f"{losses[-1]:.4f}; stragglers flagged: "
                  f"{len(straggler.flagged_steps)}", flush=True)
        return TrainRun(params, state, losses, start, times)
    finally:
        preempt.restore()


def _chaos_main(args, device, inj, ckpt, preempt, loader, fresh,
                step_fn) -> TrainRun:
    """--chaos: a seeded fault schedule with crash-consistent recovery.
    Every failure rebuilds the job from the newest intact TrainState
    bundle (params, optimizer state, pipeline cursor) and replays, so the
    losses equal a fault-free run's bit for bit."""
    from repro_torch.train.fault_tolerance import (TrainState,
                                                   restore_train_state,
                                                   run_chaos_loop,
                                                   save_train_state)
    job: dict = {"pipe": None, "params": None, "state": None}
    losses: dict[int, float] = {}

    def restore_cb():
        if job["pipe"] is not None:
            job["pipe"].close()
        job.update(params=None, state=None)     # free the old table first
        params, state = fresh()
        start = 0
        try:
            ts = restore_train_state(ckpt, TrainState(params, state, None, 0))
            params, state, start = ts.params, ts.opt_state, ts.step
            print(f"chaos: restored step {ts.step} "
                  f"(intact checkpoint: {ckpt.last_restored_step})",
                  flush=True)
        except FileNotFoundError:
            pass
        job.update(params=params, state=state,
                   pipe=loader.pipeline(prefetch=2, start_step=start,
                                        injector=inj))
        return start

    def save_cb(step):
        save_train_state(ckpt, TrainState(job["params"], job["state"],
                                          None, step))

    def one_step(step):
        t, batch = next(job["pipe"])
        if t != step:
            raise AssertionError(f"pipeline at step {t}, loop at {step}")
        params, state, metrics = step_fn(job["params"], job["state"],
                                         batch_to_device(batch, device),
                                         step)
        job.update(params=params, state=state)
        losses[step] = float(metrics["loss"])
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {losses[step]:.4f}", flush=True)

    try:
        rep = run_chaos_loop(one_step, args.steps, save_cb=save_cb,
                             restore_cb=restore_cb,
                             checkpoint_every=args.ckpt_every,
                             preemption=preempt, injector=inj)
    finally:
        if job["pipe"] is not None:
            job["pipe"].close()
    fired = ", ".join(f"{s}[{at}]={k}" for s, at, k in inj.fired)
    print(f"chaos: fired {fired or 'nothing'}", flush=True)
    print(f"chaos done at step {rep.last_step}: {rep.restarts} restarts; "
          f"loss {losses[0]:.4f} -> {losses[max(losses)]:.4f}", flush=True)
    return TrainRun(job["params"], job["state"],
                    [losses[k] for k in sorted(losses)])


def parse_args(argv=None) -> argparse.Namespace:
    """The reference launcher's flags, plus `--sparse-apply` (DLRM mode)
    and `--device`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64,
                    help="LM mode: tokens a sequence")
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="LM mode: AdamW's learning rate")
    ap.add_argument("--ckpt-dir", default="runs/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--sparse-apply", choices=("dense", "sparse"),
                    default="dense",
                    help="embedding update: the reference's dense scatter "
                         "over the full row space (a second table-sized "
                         "buffer), or the fused sparse backward on the "
                         "touched rows")
    ap.add_argument("--chaos", action="store_true",
                    help="run under a seeded fault schedule (reader death, "
                         "torn checkpoints, preemption) with crash-"
                         "consistent recovery")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="seed of the fault schedule (same seed, same "
                         "schedule)")
    ap.add_argument("--chaos-faults", type=int, default=3,
                    help="number of scheduled faults over the run")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    return ap.parse_args(argv)


def main(argv=None) -> TrainRun:
    """Entry point: train the named DLRM or LM. Returns the run."""
    args = parse_args(argv)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    return train(cfg, args)


if __name__ == "__main__":
    main()
