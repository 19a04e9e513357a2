"""Serving launcher of the port: the LM slot engine or the overload-robust
DLRM tier, by the arch's config type.

    python -m repro_torch.launch.serve --arch stablelm-1.6b --smoke \\
        --requests 8 --device cpu
    python -m repro_torch.launch.serve --arch stablelm-1.6b
    python -m repro_torch.launch.serve --arch mamba2-780m --requests 8 \
        --prompt-len 16 64
    python -m repro_torch.launch.serve --arch dlrm-m1 --smoke --requests 32 \\
        --device cpu
    python -m repro_torch.launch.serve --arch dlrm-m1 --cache-rows 22727272

The LM mode (any token-only arch: dense, MoE, SSM or hybrid; the
frontend archs raise ValueError, as the reference's demo asserts) drives
`ServeEngine`
with seeded random prompts, of 4 to 11 tokens as the reference's unless
`--prompt-len` says otherwise, and prints the reference's `served N
requests, T tokens in ...` line. The DLRM mode
replays seeded Zipf traffic through `DLRMServeEngine` and prints the same
parseable SLO summary as the reference (`serve[dlrm]: key=value ...`).
`--chaos` arms a seeded `FaultInjector` on the engine's `serve.fetch`
and `serve.admit` sites with one retry, as the reference does, and
prints what fired. Runs on the card unless `--device cpu` is given;
without a card it raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import DLRMConfig, get_config, get_smoke_config

#: seed of the torch.Generator the parameters are drawn from
PARAM_SEED = 0


def lm_requests(cfg, n: int, prompt_len: tuple[int, int],
                new_tokens: int) -> list:
    """The LM mode's `n` requests: seeded random prompts of lo..hi tokens
    (numpy seed 0, the reference launcher's draws), `new_tokens` each."""
    from repro_torch.serve.engine import Request

    rng = np.random.RandomState(0)
    lo, hi = prompt_len
    out = []
    for uid in range(n):
        prompt = rng.randint(0, cfg.vocab_size,
                             size=(rng.randint(lo, hi + 1),)).astype(np.int32)
        out.append(Request(uid=uid, prompt=prompt,
                           max_new_tokens=new_tokens))
    return out


def serve_lm(cfg, args):
    """Build the LM engine on `args.device` with seeded parameters, submit
    the `lm_requests`, drain, print the summary line. Returns the
    engine."""
    from repro_torch.models.lm import init_lm_params
    from repro_torch.serve.engine import ServeEngine

    if cfg.frontend is not None:
        raise ValueError(f"{cfg.name}: the serve launcher drives token-only "
                         f"archs, not the {cfg.frontend} frontend")
    if args.compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.compute_dtype)
    params = init_lm_params(cfg, PARAM_SEED, resolve_device(args.device))
    engine = ServeEngine(params, cfg, batch_slots=args.slots,
                         max_len=args.max_len)
    t0 = time.time()
    for req in lm_requests(cfg, args.requests, args.prompt_len,
                           args.new_tokens):
        engine.submit(req)
    done = engine.run_until_drained()
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in done.values())
    print(f"served {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s, {engine.steps_run} engine steps)",
          flush=True)
    for uid in sorted(done)[:4]:
        print(f"  req {uid}: {done[uid][:8]}...", flush=True)
    return engine


def serve_dlrm(cfg, args):
    """Build the engine on `args.device`, replay `args.requests` seeded
    Zipf requests through it, print the summary line. Returns the engine."""
    from repro_torch.core.cache import CachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.serve import DLRMServeEngine, ServeRequest

    device = resolve_device(args.device)
    ebc = EmbeddingBagCollection.build(cfg, n_shards=1,
                                       strategy="replicated")
    params = init_dlrm_params(cfg, ebc, PARAM_SEED, device)
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=args.cache_rows)
    injector = retry = None
    if args.chaos:
        from repro_torch.train.fault_tolerance import (FaultInjector,
                                                       RetryPolicy)
        injector = FaultInjector.from_seed(
            args.chaos_seed, args.requests,
            sites=("serve.fetch", "serve.admit"), n_faults=3)
        retry = RetryPolicy(max_retries=1, backoff_s=1e-4)
    engine = DLRMServeEngine(params, cfg, cc, max_queue=args.max_queue,
                             max_batch=args.max_batch, injector=injector,
                             retry=retry)

    t0 = time.time()
    for uid in range(args.requests):
        raw = make_dlrm_batch(cfg, args.batch, step=uid,
                              zipf_alpha=args.zipf_alpha)
        idx = ebc.offset_indices(raw["idx"])
        engine.submit(ServeRequest(uid, raw["dense"], idx))
        # offered load: submit a burst, then let the engine catch up
        if (uid + 1) % args.burst == 0:
            engine.step()
    engine.run()
    dt = time.time() - t0
    m = engine.metrics.snapshot()
    print(f"serve[dlrm]: served={int(m['served'])} shed={int(m['shed'])} "
          f"degraded={int(m['degraded'])} "
          f"hit_rate={engine.cache_stats.hit_rate:.4f} "
          f"shed_rate={m['shed_rate']:.4f} "
          f"degraded_fraction={m['degraded_fraction']:.4f} "
          f"p50_ms={m['p50_latency'] * 1e3:.3f} "
          f"p99_ms={m['p99_latency'] * 1e3:.3f} "
          f"batches={int(m['batches'])} breaker={engine.breaker.state} "
          f"wall_s={dt:.2f}", flush=True)
    if args.chaos:
        print(f"  chaos: fired={injector.fired} "
              f"transitions={engine.breaker.transitions}", flush=True)
    return engine


def parse_args(argv=None) -> argparse.Namespace:
    """The reference launcher's flags, plus `--device`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    # LM knobs
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, nargs=2, default=(4, 11),
                    metavar=("LO", "HI"),
                    help="LM mode: prompt tokens, drawn from lo..hi")
    ap.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                    default=None,
                    help="LM mode: compute dtype; default the config's")
    # DLRM knobs
    ap.add_argument("--batch", type=int, default=4,
                    help="examples per DLRM request")
    ap.add_argument("--max-batch", type=int, default=16,
                    help="engine batch slots (examples per dispatch)")
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--cache-rows", type=int, default=256)
    ap.add_argument("--burst", type=int, default=4,
                    help="requests submitted per engine step (offered load)")
    ap.add_argument("--zipf-alpha", type=float, default=1.05)
    ap.add_argument("--chaos", action="store_true",
                    help="arm a seeded fault injector on the serving "
                         "tier's fetch and admission paths")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    return ap.parse_args(argv)


def main(argv=None):
    """Entry point: dispatch on the arch's config type (LM vs DLRM).
    Returns the engine."""
    args = parse_args(argv)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if isinstance(cfg, DLRMConfig):
        return serve_dlrm(cfg, args)
    return serve_lm(cfg, args)


if __name__ == "__main__":
    main()
