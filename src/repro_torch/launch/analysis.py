"""Analytic traffic models of the port's placements.

Ported from `repro.launch.analysis`: so far only the table-wise pooled
exchange, which `train.steps.build_tablewise_train_step`'s metrics must
equal. The reference's compiled-program analyzers and its other traffic
models come with the port's `launch/` slice.
"""
from __future__ import annotations


def tablewise_exchange_traffic(batch: int, n_features: int, truncation: int,
                               embed_dim: int, n_hosts: int,
                               itemsize: int = 4,
                               features_per_owner=None) -> dict[str, float]:
    """Cross-owner bytes per step of the TABLE-WISE placement: whole tables
    live on owners and only the POOLED (B, F, d) activations cross —
    pooled outputs forward, pooled bag gradients back, each with a remote
    fraction of (H-1)/H. Per-lookup rows never move, so the exchange does
    not depend on the bag length L or the batch's unique rows:

        fwd = bwd = (H-1)/H * B * F * d * itemsize.

    The per-(host, owner) pair leg carries only the owner's own tables for
    the destination's batch slice: ceil(B/H) * max_t F_t * d * itemsize,
    with max_t F_t from `features_per_owner` (a bincount of the plan's
    owners) or the uniform ceil(F/H). `rowshard_bytes` is the row-sharded
    naive gather, which ships the un-pooled (B, F, L, d) rows both ways;
    `pooling_reduction` = rowshard / total."""
    remote = (n_hosts - 1) / max(n_hosts, 1)
    act_bytes = float(embed_dim * itemsize)
    fwd = remote * batch * n_features * act_bytes
    if features_per_owner is not None and len(features_per_owner):
        max_f = max(int(f) for f in features_per_owner)
    else:
        max_f = -(-n_features // max(n_hosts, 1))
    pair_leg = -(-batch // max(n_hosts, 1)) * max_f * act_bytes
    pairs = float(batch * n_features * truncation)
    rowshard = 2.0 * pairs * remote * act_bytes
    total = 2.0 * fwd
    return {"fwd_bytes": fwd,
            "bwd_bytes": fwd,
            "total_bytes": total,
            "pair_leg_bytes": pair_leg,
            "rowshard_bytes": rowshard,
            "pooling_reduction": rowshard / total if total else 1.0}
