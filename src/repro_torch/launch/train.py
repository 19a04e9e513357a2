"""Training launcher of the port: the DLRM mode of the reference launcher.

    python -m repro_torch.launch.train --arch dlrm-m1 --smoke --steps 20 \\
        --device cpu
    python -m repro_torch.launch.train --arch dlrm-m1 --steps 8 --batch 512

Seeded parameters (`init_dlrm_params`, seed 0) with the whole mega table on
the device, dense `adagrad(0.01)`, synthetic batches through a prefetching
`ShardedLoader` pipeline, and `build_dlrm_train_step(...,
sparse_apply="sparse")` in a plain loop that prints the loss. Runs on the
card unless `--device cpu` is given; without a card it raises.

The reference launcher's `--resume`, `--ckpt-*` and `--chaos` need the
checkpoint and fault-tolerance slice; its LM mode (`--seq`, `--lr`) comes
with the LM-training slice and raises until then.
"""
from __future__ import annotations

import argparse
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs import DLRMConfig, get_config, get_smoke_config

#: seed of the torch.Generator the parameters are drawn from
PARAM_SEED = 0


class TrainRun(NamedTuple):
    """What a launcher run leaves behind: the trained parameters and
    optimizer state (on the run's device) and the loss of every step."""
    params: dict
    state: dict
    losses: list[float]


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The pipeline's numpy batch as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_dlrm(cfg, args) -> TrainRun:
    """Train `cfg` for `args.steps` steps on `args.device`."""
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.data.pipeline import ShardedLoader
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_dlrm_train_step, dlrm_init_state

    device = resolve_device(args.device)
    ebc = EmbeddingBagCollection.build(cfg, n_shards=1,
                                       strategy="replicated")
    params = init_dlrm_params(cfg, ebc, PARAM_SEED, device)
    opt = adagrad(0.01)
    state = dlrm_init_state(ebc, opt, params)
    step_fn = build_dlrm_train_step(cfg, ebc, opt, sparse_apply="sparse")

    def gen(step, seed):
        raw = make_dlrm_batch(cfg, args.batch, step, seed)
        raw["idx"] = ebc.offset_indices(raw["idx"])
        return raw

    pipeline = ShardedLoader(gen, args.batch).pipeline(prefetch=2)
    losses = []
    try:
        for step in range(args.steps):
            _, batch = next(pipeline)
            params, state, metrics = step_fn(
                params, state, batch_to_device(batch, device), step)
            losses.append(float(metrics["loss"]))
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {losses[-1]:.4f}", flush=True)
    finally:
        pipeline.close()
    if losses:
        print(f"done at step {args.steps}; loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}", flush=True)
    return TrainRun(params, state, losses)


def parse_args(argv=None) -> argparse.Namespace:
    """The reference launcher's DLRM flags, plus `--device`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    return ap.parse_args(argv)


def main(argv=None) -> TrainRun:
    """Entry point: train the named DLRM. Returns the run."""
    args = parse_args(argv)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if not isinstance(cfg, DLRMConfig):
        raise NotImplementedError(
            f"{args.arch}: the LM mode of the training launcher comes with "
            "the LM-training slice (lm_loss, adamw, build_lm_train_step)")
    return train_dlrm(cfg, args)


if __name__ == "__main__":
    main()
