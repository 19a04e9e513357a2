"""The dry run: for every (architecture x input shape x production mesh)
cell, one rank's fit, cost and collectives, measured by running the
port's real step for that rank on the meta device.

    python -m repro_torch.launch.dryrun --arch all --mesh both
    python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
        --shape train_4k --mesh single --out runs/dryrun
    python -m repro_torch.launch.dryrun --arch lm --mesh one

The reference lowers and compiles each cell's jitted step over 512
placeholder devices and reads XLA's program text. The port has no such
program, so it runs the step itself: a `launch.mesh.DryMesh` stands for
rank `rank` of the 16x16 or 2x16x16 mesh (no world, no bytes moved, every
collective booked), the rank's parameter, optimizer-state and cache
blocks and its batch lie on the meta device (no memory), and the step
runs once under `launch.analysis.StepAnalysis`, which counts every op's
FLOPs and bytes, the meta kernels' booked costs and the peak of live
bytes. The steps are the port's own: `build_lm_train_step(rules=,
mesh=)`, `prefill_step` / `decode_step(rules=, mesh=)`, and the DLRM psum
step (`build_dlrm_train_step(sparse_apply="dense", mesh=)`) and forward.
Nothing here imports jax, needs a card or spawns a process.

`build_cell` is the reference's, field for field and in its operand
order (`_rules_for`, `_auto_accum`, `_sharded_gb`, `_hbm_estimate_lm`,
the rule rewrites, `moe_groups`, bf16 serving specs, `model_flops`), so
the analytic fields come out equal; `hbm_estimate_gb` is the reference's
analytic TPU estimate, kept under its name, and the port's own fit is
the measured peak. Per cell `run_cell` writes the reference's record:

  memory        the rank's argument / output / temp / alias bytes and
                `peak_per_device` (the highest live bytes of the step),
                the peak split by kind; `fits` against the H100's 80 GB
  flops, vpu_flops, major_bytes, gather_bytes, scatter_bytes
                GLOBAL: the same step on a one-rank dry mesh at the
                global batch
  per_chip_dot_flops, compute_s_per_chip, collectives_per_chip,
  collective_bytes_per_chip, top_collectives
                the rank's (its products with any replication; its
                collectives' wire bytes, `launch.analysis.
                CollectiveAnalysis`)
  roofline terms under `launch.roofline.H100`, model_flops, params,
  active_params, accum_steps, hbm_estimate_gb; placement, lookup_bytes,
  load_imbalance for the DLRM cells.

A step that loops over accumulation microbatches runs two and counts the
second for the rest (`kernels.meta.trips`); the dense update's row pass
runs one chunk for all (`kernels.meta.chunk_trips`). `resolve_sized`
drops a mesh axis that does not divide its dimension, so every rank's
blocks are the same size and rank 0 stands for all of them (`rank=`
picks another; where blocks split unevenly the rank holding the
largest runs too, `largest_rank`). `lm_train_job`, `lm_serve_job` and
`measure` run any LM step this way, on a mesh or one device (the card
smoke run holds them to its own runs). The port's DLRM mesh path is the psum lookup with the
dense update, so the DLRM cells run under the reference's `pooled_psum`
overrides (`POOLED_PSUM`), named in each record's `config_overrides`.
A failure is recorded with `ok: False`, its error and traceback.
`--mesh one` records each LM cell's largest batch one card holds
(`fit_one_card`).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from collections.abc import Callable
from typing import Any

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import DLRMConfig, Shape, shapes_for
from repro_torch.configs.registry import ARCHS, DLRMS
from repro_torch.launch.analysis import CollectiveAnalysis, StepAnalysis
from repro_torch.launch.mesh import DryMesh, make_production_mesh
from repro_torch.launch.roofline import HW, roofline_terms
from repro_torch.nn.params import (abstract_params, cast_specs, param_count,
                                   specs_to_pspecs, specs_to_shardings,
                                   tree_leaves, tree_map)
from repro_torch.nn.sharding import (FSDP_RULES, LONG_SERVE_RULES,
                                     SERVE_RULES, TRAIN_RULES)

#: the reference's `pooled_psum` variant (`launch/perf.py`): the port's
#: DLRM mesh path (psum lookup, dense update over row_wise shards)
POOLED_PSUM = {"placement": "row_wise", "lookup_impl": "psum",
               "hbm_budget_gb": 8.0}

# ---------------------------------------------------------------------------
# cell construction: the reference's arithmetic
# ---------------------------------------------------------------------------


def _rules_for(cfg, shape: Shape, overrides: dict | None = None) -> dict:
    if shape.kind in ("dlrm_train", "dlrm_infer"):
        rules = dict(TRAIN_RULES)        # DLRM: paper-faithful DP+PS mapping
    elif shape.kind == "train":
        # FSDP + sequence parallelism is the fit-first default for every LM
        rules = dict(FSDP_RULES)
    elif shape.name.startswith("long"):
        rules = dict(LONG_SERVE_RULES)
    else:
        rules = dict(SERVE_RULES)
    if overrides:
        rules.update(overrides)
    return rules


def _dp_size(mesh, rules) -> int:
    """Effective data-parallel degree = product of mesh axes carrying the
    batch dim (zero_dp maps batch over model too)."""
    axes = rules.get("batch") or ("pod", "data")
    if isinstance(axes, str):
        axes = (axes,)
    out = 1
    for a in axes:
        out *= mesh.shape.get(a, 1)
    return out


def _auto_accum(cfg, shape: Shape, mesh, rules) -> int:
    """The reference's gradient-accumulation factor: halve the microbatch
    until saved activations + the CE region fit a 6e9-byte budget.

    saves  = tokens_per_datashard x d x 2B x n_layers   (scan carry, bf16)
    ce     = tokens_per_datashard x vocab/TP x 12B      (logits fp32 region)
    """
    dp = _dp_size(mesh, rules)
    tp = mesh.shape.get("model", 1) if "model" not in (
        rules.get("batch") or ()) else 1
    tokens = shape.global_batch * shape.seq_len / dp
    saves = tokens * cfg.d_model * 2 * cfg.n_layers
    if cfg.family == "ssm" or cfg.layer_pattern:
        saves *= 2.2                       # conv/ssd intermediates
    if cfg.n_experts:
        saves += tokens * cfg.d_model * cfg.top_k * cfg.capacity_factor * 10
    vocab_eff = cfg.vocab_size * (cfg.n_codebooks
                                  if cfg.frontend == "audio" else 1)
    ce = tokens * (vocab_eff / tp) * 12
    if cfg.frontend == "audio":
        ce += tokens * cfg.d_model * 8     # fp32 frame-embedding inputs
    budget = 6e9
    accum = 1
    max_accum = max(1, shape.global_batch // dp)
    while (saves + ce) / accum > budget and accum < max_accum:
        accum *= 2
    return min(accum, max_accum)


def sorted_leaves(tree) -> list:
    """A tree's leaves with every dict walked in sorted key order, as
    `jax.tree.leaves` walks them (the reference's summation order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not _is_pspec(tree):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


def _is_pspec(x) -> bool:
    """A resolved spec: a tuple of None, axis names or tuples of them."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def _sharded_gb(specs, pspecs, mesh) -> float:
    """Analytic per-chip GB of a ParamSpec tree under its specs."""
    total = 0.0
    for s, sp in zip(sorted_leaves(specs), sorted_leaves(pspecs)):
        shards = 1
        for e in sp:
            for a in (e if isinstance(e, tuple) else ((e,) if e else ())):
                shards *= mesh.shape[a]
        total += math.prod(s.shape) * s.dtype.itemsize / shards
    return total / 1e9


def _hbm_estimate_lm(cfg, shape, mesh, specs, pspecs, accum) -> float:
    """The reference's analytic per-chip HBM estimate for a TPU (GB):
    params (+grads/opt for train) + saved activations + CE region +
    caches. Kept as the reference computes it; the port's fit is the
    measured peak."""
    from repro_torch.models.lm import cache_abstract
    dp = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
    tp = mesh.shape.get("model", 1)
    p_gb = _sharded_gb(specs, pspecs, mesh)
    gb = p_gb
    if shape.kind == "train":
        gb += 3 * p_gb                       # grads + adam m,v (fp32 = p)
        tokens = shape.global_batch * shape.seq_len / dp / max(accum, 1)
        ssd = 2.2 if (cfg.family == "ssm" or cfg.layer_pattern) else 1.0
        gb += tokens * cfg.d_model * 2 * cfg.n_layers * ssd / 1e9
        vocab_eff = cfg.vocab_size * (cfg.n_codebooks
                                      if cfg.frontend == "audio" else 1)
        gb += tokens * (vocab_eff / tp) * 12 / 1e9
        if cfg.n_experts:
            gb += tokens * cfg.d_model * cfg.top_k * 6 / 1e9
    else:
        caches = cache_abstract(cfg, shape.global_batch, shape.seq_len)
        cache_bytes = sum(c.numel() * c.element_size()
                          for c in tree_leaves(caches))
        gb += cache_bytes / (dp * tp) / 1e9  # batch x (kv|seq) sharded
        if shape.kind == "prefill":
            tokens = shape.global_batch * shape.seq_len / dp
            gb += tokens * cfg.d_model * 2 * 4 / 1e9   # transient acts
    return gb


@dataclasses.dataclass
class Cell:
    """One cell, built without running anything: its config and final
    rules, the parameter specs and their specs on the mesh (the caches'
    too when serving), the DLRM collection, and `meta`: the reference's
    analytic fields. `make(mesh)` lays out a rank's step on the meta
    device (`_make_lm`, `_make_dlrm`)."""
    arch: str
    shape: Shape
    cfg: Any
    rules: dict
    specs: dict
    pspecs: dict
    meta: dict
    cache_pspecs: dict | None = None
    ebc: Any = None

    def make(self, mesh) -> "Run":
        if isinstance(self.cfg, DLRMConfig):
            return _make_dlrm(self, mesh)
        return _make_lm(self, mesh)


def build_cell(arch: str, shape: Shape, mesh,
               rules_overrides: dict | None = None,
               config_overrides: dict | None = None) -> Cell:
    """The cell's config, rules, specs and analytic fields, as the
    reference's `build_cell` makes them (nothing runs)."""
    cfg = get_config(arch)
    if config_overrides:
        cfg = dataclasses.replace(cfg, **config_overrides)
    rules = _rules_for(cfg, shape, rules_overrides)
    if isinstance(cfg, DLRMConfig):
        return _build_dlrm_cell(arch, cfg, shape, mesh, rules)
    return _build_lm_cell(arch, cfg, shape, mesh, rules)


def _build_lm_cell(arch: str, cfg, shape: Shape, mesh, rules) -> Cell:
    from repro_torch.models.lm import cache_pspecs, lm_param_specs
    from repro_torch.serve.sharded import prefill_rules
    tp = mesh.shape.get("model", 1)
    dp = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
    if cfg.n_experts > 0 and shape.kind != "decode":
        # GShard grouped dispatch: one group per data shard
        dpe = _dp_size(mesh, rules) if shape.kind == "train" else dp
        tokens = shape.global_batch * max(shape.seq_len, 1)
        g = dpe if tokens % dpe == 0 else 1
        cfg = dataclasses.replace(cfg, moe_groups=g)
    if shape.kind in ("prefill", "decode") and cfg.n_kv_heads % tp != 0:
        # kv heads can't shard over the TP axis -> shard the cache seq dim
        rules = dict(rules, cache_seq="model", cache_kv=None)
    if shape.kind == "prefill":
        # weights FSDP-stored over `data`, gathered per layer; no head_dim
        # fallback (it would all-reduce 32k-seq score matrices)
        rules = prefill_rules(rules)
    specs = lm_param_specs(cfg)
    if shape.kind in ("prefill", "decode"):
        specs = cast_specs(specs, torch.bfloat16)   # bf16 serving weights
    pspecs = specs_to_pspecs(specs, rules, mesh=mesh)
    n_params = param_count(specs)
    n_active = cfg.active_param_count_estimate()
    accum = _auto_accum(cfg, shape, mesh, rules) if shape.kind == "train" \
        else 1
    meta: dict[str, Any] = {"hbm_estimate_gb": round(
        _hbm_estimate_lm(cfg, shape, mesh, specs, pspecs, accum), 2)}
    c_specs = None
    if shape.kind == "train":
        model_flops = 6.0 * n_active * shape.global_batch * shape.seq_len
        meta["accum_steps"] = accum
    else:
        c_specs = cache_pspecs(cfg, rules, mesh, shape.global_batch,
                               shape.seq_len)
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind == "prefill" else 1)
        model_flops = 2.0 * n_active * tokens
    meta.update(model_flops=model_flops, params=n_params,
                active_params=n_active)
    return Cell(arch, shape, cfg, rules, specs, pspecs, meta, c_specs)


def _build_dlrm_cell(arch: str, cfg: DLRMConfig, shape: Shape, mesh,
                     rules) -> Cell:
    from repro_torch.core.dlrm import dlrm_param_specs
    from repro_torch.core.embedding import EmbeddingBagCollection
    n_shards = mesh.shape.get("model", 1)
    dp = mesh.shape.get("pod", 1) * mesh.shape.get("data", 1)
    ebc = EmbeddingBagCollection.build(cfg, n_shards, second_axis_size=dp)
    specs = dlrm_param_specs(cfg, ebc)
    pspecs = specs_to_pspecs(specs, rules, mesh=mesh)
    pspecs["emb"]["mega"] = ebc.plan.pspec     # planner overrides rules
    dense_params = sum(math.prod(s.shape) for s in sorted_leaves(
        {"bottom": specs["bottom"], "top": specs["top"]}))
    model_flops = (6.0 if shape.kind == "dlrm_train" else 2.0) \
        * dense_params * shape.global_batch
    lookup_bytes = (shape.global_batch * ebc.lookups_per_example()
                    * cfg.embed_dim * 4)
    # analytic per-chip HBM: table + gradient-aggregation copy + accumulator
    # + dense stack (params/grads/adagrad) + batch transients
    table_gb = max(ebc.plan.bytes_per_shard) / 1e9
    est = (2 * table_gb
           + table_gb / cfg.embed_dim
           + dense_params * 12 / 1e9
           + shape.global_batch / dp * cfg.n_sparse_features
           * (cfg.truncation * 4 + cfg.embed_dim * 8) / 1e9)
    meta = {"hbm_estimate_gb": round(est, 2), "model_flops": model_flops,
            "params": param_count(specs), "active_params": param_count(specs),
            "placement": ebc.plan.strategy, "lookup_bytes": lookup_bytes,
            "load_imbalance": ebc.plan.load_imbalance}
    return Cell(arch, shape, cfg, rules, specs, pspecs, meta, ebc=ebc)

# ---------------------------------------------------------------------------
# a rank's step on the meta device
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """A rank's step laid out on the meta device: `fn()` runs it once and
    returns its outputs; `tracked` maps a kind ("parameters",
    "optimizer_state", "inputs") to (tree, the bytes of a leaf's storage
    or None) for `StepAnalysis.track`."""
    fn: Callable[[], Any]
    tracked: dict


def rank_params(specs, rules, mesh) -> dict:
    """A rank's blocks of a ParamSpec tree on the meta device (the whole
    tree without a mesh)."""
    if mesh is None:
        return abstract_params(specs)
    return tree_map(lambda s, sh: torch.empty(
        sh.local_shape(s.shape), dtype=s.dtype, device="meta"),
        specs, specs_to_shardings(specs, rules, mesh))


def _block_bytes(view_of: Callable) -> Callable:
    """A tracked leaf's bytes: those of its block (the rank holds the
    global batch's rows it takes, `view_of(t)`)."""
    return lambda t: (lambda v: v.numel() * v.element_size())(view_of(t))


def lm_train_job(cfg, rules, mesh, batch: int, seq: int,
                 accum_steps: int = 1, grad_dtype: str = "float32",
                 opt=None, steps: int = 1) -> Run:
    """`steps` steps of `build_lm_train_step(cfg, opt, rules,
    accum_steps, grad_dtype, mesh=)` (opt default adamw(3e-4, weight
    decay 0.1), the reference dry run's) on the rank's fp32 parameter
    blocks and AdamW state, a global batch of `batch` x `seq`, of which
    the rank holds its block."""
    from repro_torch.data.synthetic import lm_batch_specs
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_lm_train_step, lm_batch_block
    from repro_torch.models.lm import lm_param_specs
    params = rank_params(lm_param_specs(cfg), rules, mesh)
    opt = opt or adamw(3e-4, weight_decay=0.1)
    opt_state = opt.init(params)
    data = lm_batch_specs(cfg, batch, seq)
    step = build_lm_train_step(cfg, opt, rules, accum_steps=accum_steps,
                               grad_dtype=grad_dtype, mesh=mesh)
    if mesh is None:
        nbytes = None
    else:
        blocks = {id(v): w for v, w in zip(
            data.values(), lm_batch_block(data, rules, mesh).values())}
        nbytes = _block_bytes(lambda t: blocks[id(t)])

    def fn():
        p, st, m = params, opt_state, None
        for t in range(steps):
            p, st, m = step(p, st, data, t)
        return p, st, m
    return Run(fn, {"parameters": (params, None),
                    "optimizer_state": (opt_state, None),
                    "inputs": (data, nbytes)})


def lm_serve_job(cfg, rules, mesh, batch: int, seq: int,
                 max_len: int | None = None, prefill: bool = True,
                 n_decode: int = 0, dtype: torch.dtype | None = None
                 ) -> Run:
    """A serving rank's steps, no gradients: with `prefill`, `prefill_step`
    on a prompt of `batch` x `seq` (the frontends' leaves as
    `make_lm_batch` makes them) into fresh caches of `max_len` (default
    seq + n_decode) positions, then n_decode `decode_step`s at positions
    seq, seq + 1, ...; without it, n_decode decode steps ending at the
    caches' last position. Parameter blocks in `dtype` (default the
    specs', fp32), cache blocks by `init_caches(rules=, mesh=)`."""
    from repro_torch.data.synthetic import lm_batch_specs
    from repro_torch.models.lm import (_rows, decode_step, init_caches,
                                       lm_param_specs, prefill_step)
    specs = lm_param_specs(cfg)
    if dtype is not None:
        specs = cast_specs(specs, dtype)
    params = rank_params(specs, rules, mesh)
    max_len = max_len or seq + n_decode
    caches = init_caches(cfg, batch, max_len, "meta", rules, mesh)
    prompt = lm_batch_specs(cfg, batch, seq)
    for k in ("targets", "loss_mask"):
        prompt.pop(k)
    k = (cfg.n_codebooks,) if cfg.frontend == "audio" else ()
    tokens = torch.empty((batch, 1) + k, dtype=torch.int32, device="meta")
    start = seq if prefill else max_len - n_decode

    def fn():
        out = None
        with torch.no_grad():
            if prefill:
                out = prefill_step(params, prompt, caches, cfg, rules, mesh)
            for i in range(n_decode):
                out = decode_step(params, tokens, caches, start + i, cfg,
                                  rules, mesh)
        return out
    data = {"prompt": prompt if prefill else {}, "tokens": tokens}
    return Run(fn, {"parameters": (params, None), "inputs": (caches, None),
                    "batch": (data, None if mesh is None else _block_bytes(
                        lambda t: _rows(t, batch, rules, mesh)))})


def _make_lm(cell: Cell, mesh) -> Run:
    cfg, shape = cell.cfg, cell.shape
    b = shape.global_batch
    if shape.kind == "train":
        return lm_train_job(cfg, cell.rules, mesh, b, shape.seq_len,
                            cell.meta["accum_steps"], cfg.grad_reduce_dtype)
    if shape.kind == "prefill":
        return lm_serve_job(cfg, cell.rules, mesh, b, shape.seq_len,
                            dtype=torch.bfloat16)
    return lm_serve_job(cfg, cell.rules, mesh, b, shape.seq_len,
                        shape.seq_len, prefill=False, n_decode=1,
                        dtype=torch.bfloat16)


def _make_dlrm(cell: Cell, mesh) -> Run:
    from repro_torch.core.dlrm import dlrm_forward
    from repro_torch.data.synthetic import dlrm_batch_specs
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import (_data_slice, build_dlrm_train_step,
                                         dlrm_init_state)
    cfg, ebc = cell.cfg, cell.ebc
    lo, hi = ebc.shard_range(mesh)
    dense = abstract_params({"bottom": cell.specs["bottom"],
                             "top": cell.specs["top"]})
    mega = torch.empty((hi - lo, cfg.embed_dim),
                       dtype=cell.specs["emb"]["mega"].dtype, device="meta")
    params = {**dense, "emb": {"mega": mega}}
    batch = dlrm_batch_specs(cfg, cell.shape.global_batch)
    rows = _data_slice(batch, mesh)
    blocks = {id(v): rows[k] for k, v in batch.items()}
    inputs = (batch, _block_bytes(lambda t: blocks[id(t)]))
    if cell.shape.kind == "dlrm_train":
        opt = adagrad(0.01)
        state = dlrm_init_state(ebc, opt, params)
        state["accum"] = torch.empty((hi - lo,), dtype=torch.float32,
                                     device="meta")
        step = build_dlrm_train_step(cfg, ebc, opt, sparse_apply="dense",
                                     mesh=mesh)
        return Run(lambda: step(params, state, batch, 0),
                   {"parameters": (params, None),
                    "optimizer_state": (state, None), "inputs": inputs})

    def fn():
        with torch.no_grad():
            return dlrm_forward(params, _data_slice(batch, mesh,
                                                    ("dense", "idx")),
                                cfg, ebc, mesh)
    return Run(fn, {"parameters": (params, None), "inputs": inputs})


def measure(run: Run, mesh=None, memory: bool = True
            ) -> tuple[StepAnalysis, Any]:
    """Run `run` once on the meta device under a `StepAnalysis` (its
    collectives booked on `mesh`, reset first). Returns the analysis and
    the step's outputs."""
    if mesh is not None:
        mesh.reset_stats()
    an = StepAnalysis(memory=memory)
    for kind, (tree, nbytes) in run.tracked.items():
        an.track(tree, "inputs" if kind == "batch" else kind, nbytes)
    with an:
        out = run.fn()
    return an, out


def analyse(cell: Cell, mesh, memory: bool = True
            ) -> tuple[StepAnalysis, Any]:
    """The cell's step for `mesh`'s rank, measured (`measure`)."""
    return measure(cell.make(mesh), mesh, memory)


def largest_rank(cell: Cell, mesh) -> int:
    """The first rank whose parameter blocks take the most bytes (rank 0
    wherever every rank's blocks are the same size: `resolve_sized`
    drops an axis that does not divide its dimension, and a DLRM psum
    shard is a whole share of the rows)."""
    if isinstance(cell.cfg, DLRMConfig):
        return 0
    even = all(s.shape[i] % math.prod(
        mesh.shape[a] for a in (e if isinstance(e, tuple) else (e,)) if a)
        == 0 for s, sp in zip(sorted_leaves(cell.specs),
                              sorted_leaves(cell.pspecs))
        for i, e in enumerate(sp))
    if even:
        return 0
    best, arg = -1, 0
    for r in range(math.prod(mesh.shape.values())):
        m = DryMesh(tuple(mesh.shape.values()), mesh.axis_names, r)
        got = sum(math.prod(sh.local_shape(s.shape)) * s.dtype.itemsize
                  for s, sh in zip(tree_leaves(cell.specs), tree_leaves(
                      specs_to_shardings(cell.specs, cell.rules, m))))
        if got > best:
            best, arg = got, r
    return arg


def one_rank_mesh(mesh) -> DryMesh:
    """A one-rank dry mesh over `mesh`'s axes: the step at the global
    batch, every collective skipped (the reference's pre-partition
    program)."""
    return DryMesh((1,) * len(mesh.axis_names), mesh.axis_names)

# ---------------------------------------------------------------------------
# run one cell
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape: Shape, multi_pod: bool,
             rules_overrides=None, config_overrides=None,
             skip_collectives: bool = False, rank: int = 0
             ) -> dict[str, Any]:
    """The cell's record (the module docstring); DLRM archs take
    `POOLED_PSUM` when `config_overrides` is None."""
    mesh = make_production_mesh(multi_pod=multi_pod, dry=True, rank=rank)
    n_chips = math.prod(mesh.shape.values())
    if config_overrides is None and arch in DLRMS:
        config_overrides = dict(POOLED_PSUM)
    rec: dict[str, Any] = {
        "arch": arch, "shape": shape.name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": n_chips,
        "rank": rank, "ok": False, "device": "meta",
    }
    if config_overrides:
        rec["config_overrides"] = config_overrides
    if rules_overrides:
        rec["rules_overrides"] = {k: v for k, v in rules_overrides.items()}
    t0 = time.time()
    try:
        cell = build_cell(arch, shape, mesh, rules_overrides,
                          config_overrides)
        rec["lower_s"] = round(time.time() - t0, 1)
        t1 = time.time()
        an, out = analyse(cell, mesh)
        big = largest_rank(cell, mesh)
        if big != rank:
            # uneven blocks: the rank holding the largest runs too, and
            # the record keeps the larger peak
            other = make_production_mesh(multi_pod=multi_pod, dry=True,
                                         rank=big)
            an2, out2 = analyse(cell, other)
            if an2.peak_bytes > an.peak_bytes:
                an, out, mesh, rec["rank"] = an2, out2, other, big
        rec["compile_s"] = round(time.time() - t1, 1)
        glob, _ = analyse(cell, one_rank_mesh(mesh), memory=False)
        cost = glob.cost
        mem = an.memory(out)
        rec["memory"] = mem
        rec["fits"] = mem["peak_per_device"] <= HW.hbm_bytes
        rec["hbm_bytes"] = HW.hbm_bytes
        rec["xla_flops_uncorrected"] = glob.unscaled_mxu_flops
        rec["per_chip_dot_flops"] = an.cost.mxu_flops
        rec["compute_s_per_chip"] = an.cost.mxu_flops / HW.peak_flops_bf16
        rec["kernels"] = an.kernels
        rec["collective_calls_per_chip"] = {
            k[:-len("_calls")]: v for k, v in mesh.stats.items()
            if "@" in k and k.endswith("_calls") and v}
        if skip_collectives:
            coll_by_type, coll_total = {}, 0.0
        else:
            ca = CollectiveAnalysis(mesh, an.cost.mxu_flops)
            coll_by_type, coll_total = ca.by_type, ca.total_bytes
            rec["collective_warnings"] = ca.warnings[:5]
            top = sorted(ca.op_log, key=lambda t: -t[1] * t[2])[:8]
            rec["top_collectives"] = [
                {"op": o, "bytes_per_call": b, "mult": m} for o, b, m in top]
        rec.update({
            "flops": cost.mxu_flops,
            "vpu_flops": cost.vpu_flops,
            "major_bytes": cost.major_bytes,
            "gather_bytes": cost.gather_bytes,
            "scatter_bytes": cost.scatter_bytes,
            "collectives_per_chip": coll_by_type,
            "collective_bytes_per_chip": coll_total,
            "model_flops": cell.meta["model_flops"],
            "params": cell.meta["params"],
            "active_params": cell.meta["active_params"],
            # no program text is parsed, so nothing to warn of
            "stablehlo_warnings": [],
        })
        for k in ("placement", "lookup_bytes", "load_imbalance",
                  "accum_steps", "hbm_estimate_gb"):
            if k in cell.meta:
                rec[k] = cell.meta[k]
        rec["hbm_estimate_kind"] = "the reference's analytic TPU estimate"
        rec.update(roofline_terms(
            flops=cost.mxu_flops, bytes_hbm=cost.major_bytes,
            collective_bytes_per_chip=coll_total, chips=n_chips,
            model_flops=cell.meta["model_flops"], hw=HW))
        rec["hw"] = HW.name
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec

def fit_one_card(arch: str, shape: Shape) -> dict[str, Any]:
    """The largest batch of an LM cell that one card holds: the cell's
    step on one device (no mesh, no accumulation; serving in bf16
    weights), its global batch halved until the peak fits `HW.hbm_bytes`
    (down to 1). The record: that batch, its peak, and each batch tried
    with its peak."""
    cfg = get_config(arch)
    rec: dict[str, Any] = {"arch": arch, "shape": shape.name,
                           "mesh": "one card", "ok": False, "device": "meta",
                           "hbm_bytes": HW.hbm_bytes, "tried": []}
    t0 = time.time()
    try:
        b = shape.global_batch
        while True:
            if shape.kind == "train":
                job = lm_train_job(cfg, TRAIN_RULES, None, b, shape.seq_len)
            else:
                decode = shape.kind == "decode"
                job = lm_serve_job(cfg, {}, None, b, shape.seq_len,
                                   prefill=not decode, n_decode=int(decode),
                                   dtype=torch.bfloat16)
            peak = measure(job)[0].peak_bytes
            rec["tried"].append([b, peak])
            if peak <= HW.hbm_bytes or b == 1:
                break
            b //= 2
        rec.update(batch=b, peak_per_device=peak,
                   fits=peak <= HW.hbm_bytes, ok=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return rec

# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, or 'all' / 'lm' / 'dlrm'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "one"],
                    help="16x16, 2x16x16, both, or one card (the LM "
                    "cells' largest batch that fits, `fit_one_card`)")
    ap.add_argument("--out", default="runs/dryrun")
    ap.add_argument("--skip-collectives", action="store_true",
                    help="leave the collectives' wire bytes out")
    ap.add_argument("--force", action="store_true",
                    help="rerun cells that already have a result file")
    args = ap.parse_args(argv)

    if args.arch == "all":
        archs = list(ARCHS) + list(DLRMS)
    elif args.arch == "lm":
        archs = list(ARCHS)
    elif args.arch == "dlrm":
        archs = list(DLRMS)
    else:
        archs = args.arch.split(",")

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"], "one": ["one"]}[args.mesh]
    for arch in archs:
        shapes = shapes_for(arch)
        names = (list(shapes) if args.shape == "all"
                 else [s for s in args.shape.split(",") if s in shapes])
        for sname in names:
            for mesh in meshes:
                tag = f"{arch}__{sname}__{mesh}"
                path = os.path.join(args.out, tag + ".json")
                if (os.path.exists(path) and not args.force) or (
                        mesh == "one" and arch in DLRMS):
                    print(f"[skip] {tag}")
                    continue
                print(f"[run ] {tag}", flush=True)
                rec = fit_one_card(arch, shapes[sname]) if mesh == "one" \
                    else run_cell(arch, shapes[sname], mesh == "multi",
                                  skip_collectives=args.skip_collectives)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = "OK" if rec["ok"] else "FAIL " + rec.get("error", "")
                print(f"[done] {tag}: {status} ({rec['total_s']}s)",
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
