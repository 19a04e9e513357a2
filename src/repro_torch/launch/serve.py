"""Serving launcher of the port: the overload-robust DLRM tier.

    python -m repro_torch.launch.serve --arch dlrm-m1 --smoke --requests 32 \\
        --device cpu
    python -m repro_torch.launch.serve --arch dlrm-m1 --cache-rows 22727272

Replays seeded Zipf traffic through `DLRMServeEngine` and prints the same
parseable SLO summary as the reference (`serve[dlrm]: key=value ...`).
Runs on the card unless `--device cpu` is given; without a card it raises.
The LM mode arrives with the LM-zoo slice, `--chaos` with the port of the
fault injector.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config

#: seed of the torch.Generator the parameters are drawn from
PARAM_SEED = 0


def serve_dlrm(cfg, args):
    """Build the engine on `args.device`, replay `args.requests` seeded
    Zipf requests through it, print the summary line. Returns the engine."""
    from repro_torch.core.cache import CachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.serve import DLRMServeEngine, ServeRequest

    if args.chaos:
        raise NotImplementedError(
            "--chaos arms the FaultInjector, which is ported with the "
            "fault-tolerance slice")
    device = resolve_device(args.device)
    ebc = EmbeddingBagCollection.build(cfg, n_shards=1,
                                       strategy="replicated")
    params = init_dlrm_params(cfg, ebc, PARAM_SEED, device)
    cc = CachedEmbeddingBagCollection.build(cfg, cache_rows=args.cache_rows)
    engine = DLRMServeEngine(params, cfg, cc, max_queue=args.max_queue,
                             max_batch=args.max_batch)

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
    return engine


def parse_args(argv=None) -> argparse.Namespace:
    """The reference launcher's DLRM flags, plus `--device`."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
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
                    help="arm a seeded fault injector (later slice)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    return ap.parse_args(argv)


def main(argv=None):
    """Entry point: serve the named DLRM. Returns the engine."""
    args = parse_args(argv)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    return serve_dlrm(cfg, args)


if __name__ == "__main__":
    main()
