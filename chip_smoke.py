#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero when it fails:

1. print the card's name and power limit (nvidia-smi);
2. build the twelve CUDA kernels of the serving and training paths (ten
   sources) with nvcc (sm_90a), one process per source, all at once;
3. hold each serving kernel against its plain PyTorch version on the card
   at the serving path's dlrm-m1 shapes (pads, an all-pad bag, mean mode,
   writeback entries, rows above 2**24 and byte offsets above 2**32), and
   time it beside the plain version and, where one PyTorch call computes
   the same function, that call; split embedding_bag's and
   dot_interaction's host µs per call into guard, allocation, stream
   handle, bare launch, wrapper and one PyTorch call; time cache_exchange
   also from a CUDA graph of 20 launches (graph_ms) and with the L2
   emptied before each launch (cold_device_ms);
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
   index_select of the same rows, and the row fetch as phase 3's
   exchange; check that the raw
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
   materialized, its table and accumulator checksums; the materialize's
   flush (one pure-writeback cache_exchange) logs its rows and events ms;
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
   `decode_step`s (the first 8 phase 20a's and 20b's oracle), one
   profiled prefill; (9c) the same last position
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
11. put the capacity tier (the table and its accumulator) in page-locked
   host memory that the card addresses directly, time a 1 GiB copy each
   way, and (11a) train 7a's, 7b's and 7c's runs over it, each bit-equal
   to the launcher (losses and final checksums) with a device peak under
   HOST_PEAK_LIMIT, then hold the four row movers over it against their
   plain versions and the same call on the card, timed against their
   bound at the measured rates, and attribute the exchange's time over
   PCIe: its worklist cut to its fetches and to its writebacks, with
   cap_accum on the host and on the card, each bit-equal to plain and
   timed (`host_mover_variants`); (11b) train the three-tier
   `BulkCachedEmbeddingBagCollection` over it (a memory-mapped bulk store
   seeded cold with every row, a DRAM budget of BULK_DRAM_ROWS) with every
   table cut to 1 / BULK_ROW_DIV of its rows, sync and async, bit-equal to
   the launcher's step at that size, with promotions, demotions and an
   exclusive residency; dlrm-m3's 118.3 GB of rows do not fit the host
   memory of the card's machine, so no phase 11c;
12. run the sharded executors on `torch.distributed`, every rank a process
   spawned on this card (a `launch.mesh.RankWorld`: 12a and 12c share
   one world of 8, 12b's two runs one of 4 spawned before 12c's oracle;
   gloo: NCCL refuses two ranks on one device) that loads the kernels built in phase 2 and takes
   CUDA IPC views of the parent's table: (12a) 8a's run on a (1, 8) mesh,
   one rank per owner (the psum lookup, each owner's segmented update on
   its own shard), every rank's losses equal to 8a's and the shards'
   checksums adding up to TABLEWISE_FINAL_SUMS; (12b) the psum dense update
   on full-width dlrm-m2 under row_wise, mesh (1, 4), held to the
   one-device dense step within TOL_PSUM_LOSS / TOL_PSUM_TABLE, and again
   with a bf16 reduce, held to the fp32 run within TOL_PSUM_BF16; (12c) the
   hybrid table-wise step on dlrm-m2, 4 owners on a (2, 4) mesh, the two
   data replicas of every shard bit-equal to each other and the whole
   within TOL_HYBRID (the dense parameters TOL_HYBRID_DENSE) of the
   one-device step; each rank's launches exact,
   its host and device ms and all_reduce calls, bytes and ms a step;
13. train full-width dlrm-m1 through the multi-host cached tier, 4 hosts'
   caches over one row-sharded capacity tier (`build_cached_train_step` on
   `MultiHostCachedEmbeddingBagCollection`): (13a) the plan's cache a
   host, batches from `sparse_plan_hook(n_hosts=4)`, the next batch
   prefetched; (13b) strict_sync, no hook plans, 8-row fetch chunks and
   MULTIHOST_EVICT_CACHE_ROWS slots a host, which evict and invalidate;
   each step exactly 4 embedding_bag, 1 dot_interaction and 1 segmented
   update launches, the losses the launcher's bit for bit and the
   materialized checksums LAUNCHER_FINAL_SUMS, every lookup a hit or a
   miss; RouteStats logged beside `multihost_exchange_traffic`;
14. train stablelm-1.6b at full width at train_4k's 4,096 tokens, its
   batch cut to 4: (14a) hold the forward's o and log-sum-exp and the
   flash-attention backward kernel against their plain versions (the
   plain backward fed the plain forward's o and lse) at the train shape
   (4, 32, 4096, 64) in bf16, at (1, 32, 4096, 64) in fp32 and at
   (1, 24, 4096, 128) in bf16, two backward launches bit-equal, and time
   it beside its bound, its plain version and SDPA's backward (timed
   only), with the forward with and without its log-sum-exp store. The
   bf16 backward is two tensor-core passes with no atomics (wgmma with
   bf16 operands and fp32 sums, TMA rings, a producer warpgroup and two
   consumer warpgroups): dK/dV per 128-key tile, computed transposed
   (S^T = K Q^T, dP^T = V dO^T, P^T and dS^T rounded to bf16 in
   registers as the A operand of dV += P^T dO and dK += dS^T Q), and dQ
   per 128-query tile (S, dP, then dQ += dS K); fp32 keeps the SIMT
   kernels; (14b) 4 steps of
   `repro_torch.launch.train` at its defaults (adamw, remat="full"):
   finite losses, 48 forward and 24 backward launches a step and no other
   kernel, the peak beside the reckoning, host ms a step, tokens/s, and
   one more step profiled for device-busy ms; (14c) step 0 at batch 1
   through the kernels (twice, bit-equal) and through full_attention under
   autograd, in bf16 and fp32 compute, the loss and every gradient within
   TOL_LM_TRAIN and every unit's wq, wk, wv gradient non-zero; (14d)
   `build_lm_train_step(accum_steps=2)` on a batch of 8: a finite loss,
   twice 14b's launches, the peak beside the reckoning plus a gradient
   sum; (14e) the smoke LM launcher's plain, resumed and chaos runs on the
   card, bit-equal;
15. train the paper's section-V design space (`core.design_space`) at full
   suite width through `build_dlrm_train_step(sparse_apply="sparse")` on
   the replicated layout, 3 steps a point, each point once: (15a) Fig.
   10's 16 dense x sparse points at a batch of 256, (15b) the suite's
   default point at each batch of Fig. 11 (128 to 8,192), (15c) Fig. 12's
   hash sizes at 256, after printing `launch.analysis.recommend_placement`'s
   pick for each (the card's memory less 8 GB a host, one host): the points
   it says fit are trained, the rest only printed, (15d) Fig. 13's MLPs at
   256, then the default point with the concat interaction. Each point:
   finite losses; embedding_bag, the fused update and (dot) dot_interaction
   launched once a step and no plain version called; step 0 held to the
   plain versions on the card (loss, touched rows and accumulators, dense
   parameters and state) within TOL_STEP; examples/s over steps 1-2, host
   and device-busy ms a step, the peak, and `launch.roofline.roofline_terms`
   on the H100 spec;
16. serve the MoE, SSM and hybrid LM families at full width, bf16
   compute, ZOO_PROMPT-token prefills of make_lm_batch and ZOO_DECODE
   greedy decode steps, no plain version called: (16a) the kernel at
   granite-moe-3b-a800m's prefill shape (1, 24, 8192, 64) bf16 against
   its plain version, timed, then the model (32 layers, 40 + 8 padded
   experts top-8), the prefill through the kernel (exactly one launch a
   layer) and again through full_attention (attn_block_q = ZOO_PROMPT, no
   launch), the last logits held within TOL_LM_REL_L2 / TOL_LM_ABS with
   the same argmax;
   (16b) mamba2-780m (48 layers, no launch), in fp32 compute the same
   prefill and LM_SERVE_MESH_DECODE steps fed its tokens (phase 20d's
   oracle) and again on weights perturbed by SSM_PERTURB (20d's witness,
   printed), and at SSM_RECUR_LAYERS layers the fp32 one-shot prefill's
   last logits against SSM_RECUR_PREFIX tokens prefilled and the rest
   decoded one at a time, with an fp32 conv cache held within
   TOL_SSM_RECUR (the reference's bf16 conv cache printed);
   (16c) the kernel at jamba's prefill shape (1, 32, 8192, 128) bf16
   against its plain version, timed, then jamba-v0.1-52b cut from 32
   layers to one 8-layer unit, int8 KV cache, fp32 parameters: the
   prefill through the kernel (one launch) and through full_attention,
   held as 16a, and the attention layer's own output within
   TOL_ZOO_ATTN_REL_L2, its decode through the int8 cache within
   TOL_INT8_REL_L2 of a bf16 cache's; (16d) the LM launcher on
   mamba2-780m, 4 requests over 2 slots in fp32, each request's greedy
   tokens equal to the same request served alone by a fresh engine of as
   many slots. Each prints its peak
   beside `zoo_reckoning_bytes`, and its host ms;
17. train the MoE, SSM and hybrid LM families and serve and train the
   vision and audio frontends, bf16 compute, no plain version called:
   (17a) the forward with its log-sum-exp and the backward kernel at this
   slice's training shapes (granite-moe-1b-a400m's (4, 16, 4096, 64),
   musicgen-large's (2, 32, 4096, 64), internvl2-26b's (2, 48, 4096, 128),
   jamba's (1, 32, 4096, 128)) held as 14a, timed beside SDPA's forward
   and backward and their bounds; (17b) the launcher on full-width
   granite-moe-1b-a400m at 4,096 x 4, 4 steps (exactly 48 forward and 24
   backward launches a step), with the share of (token, slot) pairs
   capacity drops; (17c) its step 0 at batch 1 through the kernels and
   through full_attention (14c's check and tolerances), and remat "none"
   bit-equal to "full"; (17d) the launcher on full-width mamba2-780m at
   4,096 x 4, 4 steps (no kernel launch), step 0 twice and under remat
   "none" bit-equal; (17e) jamba-v0.1-52b's launcher at --smoke, 256
   positions (the kernels' branch), 8 steps with exact launches, and the
   full-width reckoning that rules out a larger run; (17f) musicgen-large
   at full width: the launcher at 4,096 x 2 for 3 steps, then a prefill
   of 8,192 frames and 16 greedy decode steps of 4 codebooks held against
   a full_attention arm (the last logits within TOL_LM_REL_L2 /
   TOL_LM_ABS, every attention layer's output against full_attention on
   its own input within TOL_ZOO_ATTN_REL_L2); internvl2-26b at full width
   cut to 12 of its 48 layers served the same way over 8,192 positions
   (256 patches), then through ServeEngine (text in and out), and cut to
   2 layers trained by the launcher at 4,096 x 2 for 3 steps. Each
   launcher run prints tokens/s, host and device-busy ms and its peak
   beside `lm_reckoning_bytes`;
18. train the multi-host cached tier one rank a host: MULTIHOST_HOSTS
   gloo ranks spawned on this card (one world for 18a-18d), each taking a CUDA IPC view of the
   capacity rows it owns of the parent's full-width dlrm-m1 table
   (`train.sharded.multihost_rank`, `build_cached_train_step(mesh=)`):
   every rank plans the global batch, installs its misses from their
   owners by copy (`Mesh.all_to_all_rows`), pools its quarter of the
   batch on its own slab, gathers the pools (`Mesh.all_gather_rows`),
   runs the dense tower on the global batch and updates its own rows:
   (18a) 13a's run, (18b) 13b's (strict_sync, evicting), each with every
   rank's losses the launcher's, the shards' checksums adding up to
   LAUNCHER_FINAL_SUMS, CacheStats and RouteStats 13a's (13b's), exactly
   one embedding_bag, one dot_interaction and one segmented update a rank
   a step, no jax or reference module in a rank; (18c) the elastic re-mesh
   on dlrm-m1 with every table cut to 1 / ELASTIC_ROW_DIV of its rows:
   ELASTIC_SPLIT steps on 4 ranks, saved (`CheckpointManager.save(
   shardings=)`), restored onto ELASTIC_HOSTS hosts (`restore(
   shardings=)`, each its block) and finished there, bit-equal to the
   uninterrupted `build_dlrm_train_step(sparse_apply="sparse")` run;
   (18d) EASGD over the pod axis of POD_MESH, a replica of the dense tower
   a rank, bit-equal to the stacked form on the card, a row of signed zeros
   and a NaN payload through both row collectives bit for bit, and
   compression (bf16, int8, error feedback) on the card bit-equal to the
   CPU; each world's start, each rank's host and device-busy ms, the
   collectives' calls, bytes and ms a step and the ranks' peaks printed;
19. train the LM over a (data 2, model 2) mesh: 4 gloo ranks on this
   card in one world (`train.sharded.lm_rank`, `build_lm_train_step(
   rules=, mesh=)`), each holding only its `resolve_sized` blocks of the
   parameters and AdamW moments (copied from CUDA IPC views of the
   parent's) and its rows of each batch: full-width stablelm-1.6b cut to
   LM_MESH_LAYERS layers under (19a) FSDP_RULES, (19b) ZERO_DP_RULES and
   (19c) TRAIN_RULES, LM_MESH_STEPS steps of 14b's batches from 14b's
   initial parameters, each loss within TOL_LM_MESH_LOSS of the
   one-device run's at that depth; (19d) LM_MESH_GRAD_STEPS steps at
   LM_MESH_GRAD_LAYERS layers and fp32 under each table, step 0's loss
   and every gradient within TOL_LM_TRAIN["float32"] of the one-device
   step's; 19a-19d's final parameters, a leaf, within TOL_LM_MESH_PARAMS
   of the one-device run's last update from that run's; (19e) one unit of
   granite-moe-1b-a400m and of mamba2-780m at full width under FSDP_RULES,
   bf16 and fp32, against their one-device steps. Gates on every run:
   finite losses, each rank's flash-attention launches a step (two
   forward and one backward an attention layer), each
   step's `Mesh.stats` calls of every collective on every axis equal to
   `train.steps.lm_step_collectives`, each rank's peak under its
   reckoning from `NamedSharding.local_shape`, no jax or reference module
   in a rank; the attention kernels timed at a rank's shapes; tokens/s,
   collective ms and device-busy ms a step printed (gloo, four ranks
   time-sliced on one card: no four-card number);
20. serve the LM over a mesh in phase 19's world (`train.sharded.
   lm_serve_rank`: `prefill_step` / `decode_step(rules=, mesh=)`, each
   rank drawing the seeded parameters on the card in turn and keeping its
   `resolve_sized` blocks and its blocks of the caches): (20a)
   stablelm-1.6b under SERVE_RULES and (20b) under LONG_SERVE_RULES (the
   cache split by positions, flash-decoding), (20c) granite-moe-3b-a800m
   and (20d) mamba2-780m under SERVE_RULES, each on (data 1, model 4) at
   full width and depth, bf16 (20d fp32), 9b's / 16a's / 16b's prompt
   and LM_SERVE_MESH_DECODE decode steps fed that run's tokens, each
   step's logits within
   TOL_LM_SERVE_MESH_REL_L2 of that run's, exactly one flash-attention
   launch a layer in the prefill on each rank, each step's `Mesh.stats`
   calls equal to `serve.sharded.lm_serve_collectives`, each rank's
   parameter and cache bytes exactly its blocks and its peak under
   `lm_serve_reckoning`; (20e) mamba2-780m's `ServeEngine(rules=
   SERVE_RULES, mesh=)` on (data 2, model 2), cut to
   LM_SERVE_ENGINE_LAYERS layers, with 16d's requests over 2 slots, each
   request's tokens equal to the same request served alone on the mesh;
   the kernel timed at a rank's prefill shape beside SDPA;
21. the dry run (`launch.dryrun`) on the host, on the meta device, held to
   what this run measured on the card: (21a) 20a's serving rank
   (`DryMesh` (1, 4), SERVE_RULES, fp32 parameter blocks, the prompt
   then LM_SERVE_MESH_DECODE decode steps), its parameter and cache
   blocks exactly 20a's bytes; (21b) 19a's FSDP rank at its cut depth
   and steps (the optimizer keeping step 0's gradients, as `lm_rank`
   does), its collectives' calls and bytes a step exactly 19a's
   `Mesh.stats`; (21c) 14b's one-device step; each rank's or step's
   peak within DRY_PEAK_BAND of the card's `max_memory_allocated`, the
   kernel calls it books equal to the launches counted on the card, and
   printed beside the reckoning; (21d) `run_cell` of one production cell
   each, stablelm-1.6b/train_4k and dlrm-m3/train_b64k on 16 x 16,
   printed;
22. print one JSON line of per-kernel numbers, then the result line.

Without CUDA, or without the rest of the checkout, it exits non-zero
before printing any result.

    python3 chip_smoke.py --evict-search

builds the kernels and bisects for the smallest cache (in steps of
EVICT_SEARCH_GRAIN rows) at which run 7b's TRAIN_STEPS async steps keep the
thrash guard, checks the sync schedule (7c) at that size, and prints the
trials as one JSON line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and dense bf16
#: tensor-core FLOP/s from the port's roofline spec, and the fp32 FLOP/s
#: outside the tensor cores, which the spec has no field for
from repro_torch.launch.roofline import BF16_FLOPS, HBM_BYTES_PER_S  # noqa: E402

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
#: phases 13a-13b: the multi-host tier's hosts (batch 512 -> 128 examples
#: a host), and 13b's per-host cache: the largest per-host one-batch
#: working set over the launcher's TRAIN_STEPS batches (17,814 rows, host
#: 2 at step 3), rounded up to a multiple of 8, so the caches evict and
#: `_admit_host`'s guard cannot fire
MULTIHOST_HOSTS = 4
MULTIHOST_EVICT_CACHE_ROWS = 17_816
#: phase 11b's three tiers: the reference's bulk block and latency, and a
#: DRAM budget that TRAIN_STEPS steps overflow (a quarter of the table
#: never fills in 8 steps, which evict ~1e5 rows, so no demotion would
#: run)
BULK_DRAM_ROWS, BULK_CHUNK, BULK_LATENCY_US = 32_768, 32, 50.0
#: 11b cuts every dlrm-m1 table to 1 / BULK_ROW_DIV of its rows (2.66M
#: rows, a 0.69 GB bulk store): each run seeds its store on disk with
#: every row before its first step, which took 55 s a run at full size
#: (43.6 GB) on the card's machine
BULK_ROW_DIV = 64
#: bytes of each timed copy between the page-locked tier and the card
PCIE_PROBE_BYTES = 1 << 30
#: phase 11's device peak from step 0, with the capacity tier on the host
HOST_PEAK_LIMIT = 10 * 10 ** 9
EVICT_SEARCH_LO, EVICT_SEARCH_GRAIN = 65_536, 1_024
#: floats of the buffer read between launches to empty the L2 (50 MB on
#: the H100) before an L2-cold timing: 256 MB
L2_FLUSH_FLOATS = 64 << 20
#: the script's start, for the wall clock on each phase line
T_START = time.perf_counter()
#: wall seconds of the movers' added measurements, by part (`clocked`)
MEASURE_S: dict = {}
#: the table-wise runs: the 8 owners of a Zion / Big Basin box
TABLEWISE_OWNERS = 8
#: phases 12a-12c: the sharded executors' meshes (data, model): 8a's 8
#: owners; dlrm-m2's table in 4 row_wise shards (each rank's dense-update
#: buffer is its shard's size again: 4 x 6.07 GB beside the 24.3 GB
#: table); dlrm-m2 on 4 table_wise owners with 2 data replicas each (the
#: second replica's copies: 28.4 GB beside the 28.4 GB table)
MESH_PSUM_SHAPE, MESH_HYBRID_SHAPE = (1, 4), (2, 4)
#: steps of 12b's runs and 12c's (the reference's psum test takes one
#: step, its table-wise mesh test 4); 12a takes TRAIN_STEPS, as 8a
MESH_PSUM_STEPS, MESH_HYBRID_STEPS = 2, 4
#: steps each rank runs under torch.profiler (its last ones)
MESH_PROFILED_STEPS = 1
#: phase 18: 18c's elastic run cuts every dlrm-m1 table to 1 /
#: ELASTIC_ROW_DIV of its rows (2.66M rows, 0.68 GB: a full-width save at
#: the measured 0.7 GB/s would take ~62 s each way), saves after
#: ELASTIC_SPLIT steps on MULTIHOST_HOSTS ranks and finishes on
#: ELASTIC_HOSTS hosts; the second world's MULTIHOST_HOSTS ranks hold
#: them as a (pod, data) mesh of POD_RANKS replicas of that tier (one
#: spawn fewer), and 18d's EASGD runs over its pod axis, a replica of
#: the dense tower a rank, through EASGD_ROUNDS (`train.sharded.
#: easgd_rounds`)
ELASTIC_ROW_DIV, ELASTIC_SPLIT, ELASTIC_HOSTS = 64, 4, 2
POD_RANKS = MULTIHOST_HOSTS // ELASTIC_HOSTS
POD_MESH = ((POD_RANKS, ELASTIC_HOSTS), ("pod", "data"))
EASGD_ROUNDS = {"rounds": 4, "seed": 7, "lr": 0.01, "alpha": 0.3,
                "beta": 0.3, "sync_every": 2}
#: a rank's launches in each multi-host mesh step, and no other kernel
MULTIHOST_RANK_STEP = {"embedding_bag": 1, "dot_interaction": 1,
                       "fused_bag_backward_adagrad_segments": 1}
#: seconds a world of ranks may take, from spawn to its last report,
#: before every rank is killed and the phase fails
MESH_TIMEOUT_S = 300
#: 12b against the one-device dense step, the reference's own bounds
#: (tests/test_multidevice.py:82-85): the losses relative; the table and
#: accumulator (rtol, atol). A bag split between two row_wise shards sums
#: two partials, so its pool moves by an ulp
TOL_PSUM_LOSS, TOL_PSUM_TABLE = 1e-5, (1e-4, 1e-5)
#: 12b's bf16 reduce against its fp32 run: the first loss bit-equal (it is
#: computed before any update); the second relative. Each gradient sum is
#: rounded to bf16 (2^-9 relative), which moves a row's AdaGrad update by
#: up to about 2^-8 of itself; the step-1 loss moves by at most that share
#: of what the embeddings add to it
TOL_PSUM_BF16 = 2 ** -8
#: 12c against the one-device step (tests/test_tablewise.py:377): rtol =
#: atol on the losses, table and accumulator. The data replicas sum two
#: slices' dense gradients, so the dense parameters drift by ulps; the
#: replicas themselves are held bit-equal
TOL_HYBRID = 1e-6
#: 12c's dense parameters (atol; rtol TOL_HYBRID): two 256-example sums of
#: a gradient differ from one 512-example sum by rounding, up to 2^-24 of
#: the summed |per-example gradients|, and dense AdaGrad's step moves a
#: parameter by up to lr / sqrt(eps) = 100 times its gradient's change
#: where |g| ~ sqrt(eps); at dlrm-m2's losses (1 -> 350 -> 28 -> 5.6) that
#: is a few 1e-6 a step in the elements whose gradient nearly cancels
#: (3.8e-6 after 4 steps on an H100 80GB HBM3 at 700 W)
TOL_HYBRID_DENSE = 1e-5
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
#: phases 14a-14e: LM training on full-width stablelm-1.6b at train_4k's
#: 4,096 tokens with its global batch of 256 cut to LM_TRAIN_BATCH (the
#: fp32 parameters, gradients and AdamW moments take 26.3 GB, and the
#: step about 50 GB by `lm_reckoning_bytes`; batch 8 would need about
#: 75 GB), LM_TRAIN_STEPS steps of the launcher at its defaults
#: (adamw(3e-4), clip 1.0, remat="full", bf16 compute)
LM_TRAIN_SEQ, LM_TRAIN_BATCH, LM_TRAIN_STEPS = 4096, 4, 4
LM_TRAIN_ARGV = ["--arch", LM_ARCH, "--seq", str(LM_TRAIN_SEQ), "--batch",
                 str(LM_TRAIN_BATCH), "--steps", str(LM_TRAIN_STEPS),
                 "--log-every", "1"]
#: 14e: steps of the smoke LM launcher's plain, resumed and chaos runs
LM_SMOKE_STEPS = 16
#: 14a: the backward kernel at 14b's attention shape in bf16, in fp32 at
#: batch 1, and in bf16 at dh 128 with starcoder2-3b's heads (d_model
#: 3072 / 24 heads) at the same 4,096 tokens; (b, h, s, dh)
FLASH_BWD_SHAPES = (("train_4k", (4, 32, 4096, 64), "bfloat16"),
                    ("train_4k_fp32", (1, 32, 4096, 64), "float32"),
                    ("train_4k_dh128", (1, 24, 4096, 128), "bfloat16"))
#: 14a: the forward's log-sum-exp at the train shape against its plain
#: version's (the tiled one in bf16, the fp32 oracle in fp32), (rtol,
#: atol) in log2 units: both are fp32 m + log2(l) over the same tiles;
#: a row off by 1e-2 scales its P in the backward by 0.7%
TOL_FLASH_LSE = (1e-5, 1e-4)
#: 14a: the backward kernel against ref.flash_attention_bwd_ref fed the
#: plain forward's o and lse (so a wrong forward cannot cancel out), its
#: largest error as a share of the largest plain value: fp32 1e-4 (the
#: same fp32 arithmetic in other summation orders, exp2f against
#: torch.exp2); bf16 2^-7 (both round P and dS to bf16 before the products
#: that take them and an fp32 sum to bf16 once, one ulp at the largest
#: value); and the relative L2 error within 1e-2 either way
TOL_FLASH_BWD = {"float32": 1e-4, "bfloat16": 2 ** -7}
TOL_FLASH_BWD_REL_L2 = 1e-2
#: 14c: step 0 at batch 1 through the kernels against the plain attention
#: (full_attention, autograd), (loss relative error, largest relative L2
#: error of a parameter's gradient). fp32: the two paths differ only in
#: the attention's fp32 summation order (on the CPU at 24 layers of the
#: smoke config the gap is 9e-7); bf16: the paths round at other places
#: (bf16 P in P V and fp32 dP in the kernels, bf16 probabilities and
#: products in full_attention) and 24 layers amplify it: on the CPU the
#: smoke config at 24 layers, through the kernels' plain versions, gives a
#: loss gap of 1.6e-4 and gradient gaps of 0.16 (median) to 0.20 (worst);
#: on the H100 at full width the bf16 gaps are 5.0e-5 (loss) and 1.8e-3
#: to 8.5e-2 (gradients), held at 1.5x the worst; a wrong scale, mask or
#: tile moves the fp32 gradients by O(1)
TOL_LM_TRAIN = {"float32": (1e-4, 1e-3), "bfloat16": (2e-3, 0.125)}
#: phase 15: the paper's section-V design space at full suite width; each
#: point trains SUITE_STEPS steps at SUITE_BATCH (Fig. 11's points at its
#: batches), and Fig. 12's planner leaves SUITE_HEADROOM_BYTES of the card
#: to everything but the tables and their accumulators
SUITE_STEPS, SUITE_BATCH = 3, 256
SUITE_HEADROOM_BYTES = 8 * 10 ** 9
#: what each of phase 15's sweeps drives
SUITE_PHASES = {
    "15a": "Fig. 10, dense x sparse features, batch 256",
    "15b": "Fig. 11, the default point at batches 128 to 8,192",
    "15c": "Fig. 12, hash sizes, batch 256, the points the planner fits",
    "15d": "Fig. 13, MLP width^layers, batch 256, then the concat "
           "interaction"}
#: phase 16: the MoE, SSM and hybrid LM families served at full width,
#: bf16 compute: a ZOO_PROMPT-token prefill of make_lm_batch at batch 1,
#: then ZOO_DECODE greedy decode steps; caches of ZOO_MAX_LEN positions
ZOO_PROMPT, ZOO_DECODE = 8192, 32
ZOO_MAX_LEN = ZOO_PROMPT + ZOO_DECODE
ZOO_PARAM_SEED = 0
MOE_ARCH, SSM_ARCH, HYBRID_ARCH = ("granite-moe-3b-a800m", "mamba2-780m",
                                   "jamba-v0.1-52b")
#: 16c: jamba-v0.1-52b's 32 layers cut to one 8-layer unit (m m m a m m m
#: m, MoE on the odd layers): 13.27 B fp32 parameters, 53.1 GB
HYBRID_LAYERS = 8
#: 16b: the recurrence against the chunked scan, fp32 compute: a prefill
#: of SSM_RECUR_PREFIX tokens (31 chunks of 256), then the last
#: ZOO_PROMPT - SSM_RECUR_PREFIX tokens decoded one at a time, against the
#: one-shot prefill's last logits. With an fp32 conv cache the two are the
#: same sums in other orders: the scan takes each decay as exp of a
#: difference of fp32 running sums over a 256-step chunk (up to ~256 in
#: magnitude, so ~1.5e-5 absolute in the exponent), the recurrence as a
#: product of per-step factors, and 48 layers of random weights amplify
#: such differences ~45-fold (a 2^-9 rounding of the conv inputs becomes
#: 0.089). Relative L2 of the last logits: 7.7e-4 on an H100 80GB HBM3 at
#: 700 W (the first run of this phase), 8.8e-5 on the CPU at width 256;
#: held within TOL_SSM_RECUR, which a wrong state or decay (an O(1) change)
#: cannot meet. With the reference's bf16 conv cache: printed, not held.
#: Both arms and their one-shot prefill run mamba2-780m cut to
#: SSM_RECUR_LAYERS of its 48 layers, for the run's length (the 512
#: one-token steps took ~35 s at full depth)
SSM_RECUR_PREFIX = 7936
SSM_RECUR_LAYERS = 6
TOL_SSM_RECUR = 5e-3
#: 16b: the fp32 run again on weights times (1 + SSM_PERTURB x N(0, 1)),
#: drawn from SSM_PERTURB_SEED, its distance a step printed beside 20d's
#: (what a rounding-sized change of the weights alone does to the logits)
SSM_PERTURB, SSM_PERTURB_SEED = 1e-7, 7
#: 16c: jamba's one attention layer on its own (its inputs and outputs
#: recorded in the model's runs). At one unit the reference's init (its
#: stacked in_proj and MLP weights draw with fan = n_units = 1) puts the
#: residual stream near 3,000, where one bf16 ulp is 16, and the attention
#: layer's output near 0.08: the logits cannot see attention, so the
#: layer's output is held. Relative L2: the kernel prefill against
#: full_attention's (3.9e-3 on the CPU at width 512, dh 128), and the
#: decode through the int8 KV cache against a bf16 cache's (6.6e-3 there;
#: int8 rounds each K and V element by up to 1/254 of its row's largest)
TOL_ZOO_ATTN_REL_L2 = 2e-2
TOL_INT8_REL_L2 = 3e-2
#: 16d: the LM launcher on mamba2-780m, 4 requests over 2 slots (8 over 4
#: before the run's length was cut), so every slot serves two;
#: fp32 compute. Each request's greedy tokens must equal
#: the same request served alone by a fresh engine of as many slots (the
#: same product shapes, so the same bits; a state carried over from the
#: slot's last request moves the logits by O(1))
ZOO_SERVE_ARGV = ["--arch", SSM_ARCH, "--requests", "4", "--slots", "2",
                  "--max-len", "96", "--new-tokens", "16", "--prompt-len",
                  "16", "64", "--compute-dtype", "float32"]
#: 16a and 16c: the bf16 kernel at granite-moe-3b-a800m's and jamba's
#: prefill shapes (dh 64 at 24 heads, dh 128); (b, h, s, dh)
FLASH_GRANITE_SHAPE = (1, 24, 8192, 64)
FLASH_DH128_SHAPE = (1, 32, 8192, 128)
#: phase 17: the LM zoo trained, and the vision and audio frontends served
#: and trained, at full width on one card, bf16 compute; the launcher at
#: its defaults (adamw(3e-4), clip 1.0, remat="full") on ZOO_TRAIN_SEQ
#: positions. 17a: the two attention kernels at this slice's training
#: shapes (granite-moe-1b-a400m, musicgen-large, internvl2-26b, jamba's
#: dh 128); (b, h, s, dh)
ZOO_TRAIN_SEQ = 4096
FLASH_ZOO_TRAIN_SHAPES = (
    ("granite_moe_1b_train", (4, 16, 4096, 64), "bfloat16"),
    ("musicgen_train", (2, 32, 4096, 64), "bfloat16"),
    ("internvl2_train_dh128", (2, 48, 4096, 128), "bfloat16"),
    ("jamba_train_dh128", (1, 32, 4096, 128), "bfloat16"))
#: 17b-17d: granite-moe-1b-a400m and mamba2-780m at 4,096 x 4 (train_4k's
#: global batch of 256 cut to 4: about 45 and 37 GB by lm_reckoning_bytes)
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
ZOO_TRAIN_BATCH, ZOO_TRAIN_STEPS = 4, 4
#: 17e: jamba-v0.1-52b's launcher at --smoke on the card, at a sequence
#: past its smoke attn_block_q of 16 (the kernels' branch)
HYBRID_SMOKE_ARGV = ["--arch", HYBRID_ARCH, "--smoke", "--seq", "256",
                     "--batch", "4", "--steps", "8", "--log-every", "100"]
HYBRID_SMOKE_STEPS = 8
#: 17f: musicgen-large trained at 4,096 x 2 for FRONTEND_TRAIN_STEPS steps
#: and served (8,192 frames, FRONTEND_DECODE greedy steps of 4 codebooks);
#: internvl2-26b served cut to VLM_SERVE_LAYERS of its 48 layers (24,
#: then 12, before the run's length was cut; 24 layers are 10.5 B fp32
#: parameters, 42.0 GB; all 48 take 79.4 GB) over 8,192 positions
#: (256 patches) and trained cut to VLM_TRAIN_LAYERS at 4,096 x 2; depth
#: is the only cut
AUDIO_ARCH, VLM_ARCH = "musicgen-large", "internvl2-26b"
FRONTEND_TRAIN_BATCH, FRONTEND_TRAIN_STEPS = 2, 3
FRONTEND_DECODE = 16
VLM_SERVE_LAYERS, VLM_TRAIN_LAYERS = 6, 2
#: 17f: the full_attention arm computes the layer's attention this many
#: heads at a time (the heads are independent): at internvl2's 48 heads
#: all at once its fp32 scores would take 32 GB beside 42 GB of weights
PLAIN_HEAD_CHUNK = 8
#: 17f: ServeEngine on the cut internvl2-26b, text in and out as the
#: reference's engine takes the vision arch: requests, slots, max_len
VLM_ENGINE_REQUESTS, VLM_ENGINE_SLOTS, VLM_ENGINE_MAX_LEN = 4, 2, 64
#: phase 19: the LM step over a (data 2, model 2) mesh of gloo ranks on
#: the card (`train.sharded.lm_rank`), from 14b's initial parameters
#: (LM_PARAM_SEED) and batches (LM_TRAIN_BATCH x LM_TRAIN_SEQ, so 2
#: sequences a data rank, 1 a rank under ZERO_DP); 19a, 19b and 19c
#: train LM_MESH_STEPS steps with stablelm-1.6b cut to LM_MESH_LAYERS of
#: its 24 layers, for the run's length (TRAIN_RULES replicate the weights
#: over `data`: at full depth 13.2 GB of state a rank, beside three other
#: ranks), against one one-device run at that depth; 19d trains
#: LM_MESH_GRAD_STEPS steps at LM_MESH_GRAD_LAYERS layers,
#: LM_MESH_GRAD_SEQ positions and fp32 compute under each table, holding
#: step 0's loss and every gradient to the one-device step's within
#: TOL_LM_TRAIN["float32"]; 19e does so for one unit of
#: granite-moe-1b-a400m and mamba2-780m at full width under FSDP_RULES,
#: in bf16 and fp32
LM_MESH = ((2, 2), ("data", "model"))
LM_MESH_STEPS, LM_MESH_GRAD_STEPS = 2, 1
LM_MESH_LAYERS = 4
LM_MESH_GRAD_LAYERS, LM_MESH_GRAD_SEQ = 2, 1024
LM_MESH_TABLES = ("FSDP_RULES", "ZERO_DP_RULES", "TRAIN_RULES")
LM_MESH_TIMEOUT_S = 900
#: 19e: the MoE groups split over the batch's ranks (2 under FSDP), as
#: the sharded MoE requires; the one-device step runs the same config;
#: LM_TRAIN_BATCH sequences of LM_MESH_ZOO_SEQ positions
LM_MESH_MOE_GROUPS = 4
LM_MESH_ZOO_SEQ = 1024
#: 19e's fp32 bound on a gradient the batch's split moves (see
#: `lm_mesh_phase`): this many times the one-device split's own distance
LM_MESH_SPLIT_FACTOR = 4
#: 19a-19c: each step's loss against the one-device run's at the cut
#: depth (the same parameters and batches, one card), relative: both are
#: bf16 runs whose partial sums round in other places (a rank's heads and
#: rows, sums over ranks in bf16), the tolerance of 14c's bf16 loss
#: (kernels against the plain attention)
TOL_LM_MESH_LOSS = 2e-3
#: 19a-19d's parameters after the last step against the one-device
#: run's: their distance, put together from every rank's blocks, over the
#: one-device run's last update (a skipped last update reads 1).
#: fp32 (19d) holds each leaf: the runs differ by summation order only
#: (farthest leaf 1.2e-4 on an H100 80GB HBM3 at 700 W, 7e-5 on the CPU).
#: bf16 (19a-19c) holds the whole tree (0.28 / 0.13 / 0.08 on that card):
#: where rounding flips the sign of a gradient larger than sqrt(eps),
#: Adam's first steps move the element by a whole lr either way, so a
#: small leaf (a norm's bias) reads up to 0.55 of its update from that
#: alone
TOL_LM_MESH_PARAMS = {"float32": 1e-2, "bfloat16": 0.5}
#: phase 20: LM serving over a mesh of 4 gloo ranks on the card, in
#: phase 19's world (no second spawn; `train.sharded.lm_serve_rank`), each
#: rank drawing the seeded parameters on the card in turn and keeping its
#: `resolve_sized` blocks, its blocks of the caches by `init_caches(rules=,
#: mesh=)`: (20a-20d) at full width and depth, batch 1, the
#: LM_PROMPT-token prompt of 9b / 16a / 16b, then LM_SERVE_MESH_DECODE
#: decode steps teacher-forced on that one-device run's greedy tokens,
#: into caches of LM_SERVE_MESH_MAX_LEN positions (a multiple of `model`,
#: as LONG_SERVE_RULES' position blocks need): (name, arch, rules, the
#: oracle's phase, its parameter seed, compute dtype). The decode steps
#: are cut from 32 to 8 for the run's length: four ranks time-slicing one
#: card wait ~8 ms on each collective (PERF.md section 5), 0.52-0.91 s a
#: decode step at stablelm's 49 and granite's 64 a step. 20d computes in
#: fp32 against 16b's fp32 run: at bf16, mamba2-780m's 48 layers carry
#: the ranks' other rounding of partial sums to 0.20-0.30 relative L2,
#: as far as 16b's own bf16 run lies from its fp32 one
LM_SERVE_MESH = ((1, 4), ("data", "model"))
LM_SERVE_MESH_DECODE = 8
LM_SERVE_MESH_MAX_LEN = LM_PROMPT + LM_DECODE
LM_SERVE_RUNS = (
    ("20a", LM_ARCH, "SERVE_RULES", "9b", LM_PARAM_SEED, "bfloat16"),
    ("20b", LM_ARCH, "LONG_SERVE_RULES", "9b", LM_PARAM_SEED, "bfloat16"),
    ("20c", MOE_ARCH, "SERVE_RULES", "16a", ZOO_PARAM_SEED, "bfloat16"),
    ("20d", SSM_ARCH, "SERVE_RULES", "16b_fp32", ZOO_PARAM_SEED,
     "float32"))
#: 20e: mamba2-780m's ServeEngine on (data 2, model 2), 16d's requests
#: (ZOO_SERVE_ARGV) over 2 slots, held to each request served alone on the
#: mesh; cut to LM_SERVE_ENGINE_LAYERS of its 48 layers for the run's
#: length (at full depth 20e took ~150 s of 4 ranks' collectives)
LM_SERVE_ENGINE_MESH = ((2, 2), ("data", "model"))
LM_SERVE_ENGINE_LAYERS = 2
#: 20a-20d: each step's logits against the one-device run's, relative L2
#: (the ranks round their partial sums to bf16 before the sum over ranks,
#: and LONG_SERVE_RULES' flash-decoding merge keeps fp32 where the one-
#: device decode rounds its probabilities to bf16; no looser than
#: TOL_LM_REL_L2); where the one-device top-2 margin exceeds twice the
#: step's largest logit difference, the argmax must agree
TOL_LM_SERVE_MESH_REL_L2 = TOL_LM_REL_L2
#: phase 21: how far (relative) a dry run's peak may lie from the card's
#: `max_memory_allocated` for the same run
DRY_PEAK_BAND = 0.15
#: 21d: the production cells `launch.dryrun.run_cell` runs on 16 x 16
DRY_CELLS = (("stablelm-1.6b", "train_4k"), ("dlrm-m3", "train_b64k"))
#: 20a: a rank's prefill attention shape, (b, h, s, dh) bf16
FLASH_SERVE_RANK_SHAPE = (1, 8, LM_PROMPT, 64)
#: the card's `nvidia-smi --query-gpu=name,power.limit` line, set in main
CARD = ""


def log(msg: str) -> None:
    """Print a line; a phase's first line ends with the wall seconds since
    the script started."""
    if msg.startswith("phase "):
        msg += f" [at {time.perf_counter() - T_START:.1f} s]"
    print(msg, flush=True)


@contextlib.contextmanager
def clocked(part: str):
    """Adds the wall seconds of the block to MEASURE_S[part]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        MEASURE_S[part] = (MEASURE_S.get(part, 0.0)
                           + time.perf_counter() - t0)


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


def cold_device_ms(torch, fn, iters: int, name: str) -> float | None:
    """As `device_kernel_ms`, with the L2 emptied before each call by a read
    of L2_FLUSH_FLOATS floats: the kernel finds none of its inputs in the
    L2, as a step's first touch of its rows does (its writes may still
    end in the L2)."""
    from torch.profiler import ProfilerActivity, profile
    flush = torch.zeros((L2_FLUSH_FLOATS,), device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                flush.sum()
                fn()
            torch.cuda.synchronize()
        total = sum(t for key, t in device_events(prof) if name in key)
        if total:
            return total / iters / 1e3
    return None


def graph_ms(torch, fn, launches: int = 20, replays: int = 5) -> float:
    """Mean ms per call of fn replayed from one CUDA graph of `launches`
    calls, by CUDA events: the device's time with no host work between
    the launches (a kernel launched through ctypes on PyTorch's current
    stream is captured like any other)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (launches * replays)


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
    with clocked("graph and L2-cold timings"):
        out["graph_ms"] = graph_ms(
            torch, lambda: kc.cache_exchange(*tiers, *work))
        out["cold_device_ms"] = cold_device_ms(
            torch, lambda: kc.cache_exchange(*tiers, *work), 20,
            "cache_exchange_kernel")
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
    upd = check_fused_update(torch, table, accum, plan, pooled, n_valid)
    del table, accum
    return {"dedup_embedding_bag": bag, "fused_bag_backward_adagrad": upd,
            "embedding_bag_train": eb}


def check_fused_update(torch, table, accum, plan, pooled,
                       n_valid: int) -> dict:
    """The fused sparse backward (one plan) on `table` and `accum` against
    its plain version, in place: the touched rows saved, the kernel run,
    its untouched neighbour rows held bit-equal and the bit checksums of
    both tensors equal once the touched rows are put back, then the plain
    version from the same start within TOL_FUSED; then timed beside its
    plain version and bound (`n_valid` lookups pooled into the plan's
    bags). `pooled` holds the (B*F, D) bag gradients."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_update as ku
    r_rows, d = table.shape
    rows = plan.unique_rows[plan.unique_rows >= 0].long()
    n_live, n_bags = rows.numel(), pooled.shape[0]
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
        n_live * 4 + (n_live + 1) * 4 + n_valid * 4 + n_bags * d * 4
        + 2 * n_live * (d * 4 + 4),
        n_valid * d + n_live * 5 * d)
    upd.update(fused_parts_ms(torch, ku, table, accum, plan, pooled))
    log(f"  fused_bag_backward_adagrad: {upd}")
    return upd


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
    with clocked("graph and L2-cold timings"):
        fetch_out["graph_ms"] = graph_ms(
            torch, lambda: kc.cache_fetch(capacity, cap_accum, fetch))
        fetch_out["cold_device_ms"] = cold_device_ms(
            torch, lambda: kc.cache_fetch(capacity, cap_accum, fetch), 20,
            "cache_fetch_kernel")
    shadow, shadow_accum = got
    fetch_out["host_us"] = fetch_host_us(
        torch, "cache_fetch", kc.FETCH_KERNEL,
        lambda: kc.check_fetch(capacity, cap_accum, fetch),
        lambda: kc.cache_fetch(capacity, cap_accum, fetch), n, capacity,
        (capacity.data_ptr(), cap_accum.data_ptr(), fetch.data_ptr(),
         shadow.data_ptr(), shadow_accum.data_ptr(), n, d, 0),
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


def pcie_rates(torch, dev, host: dict) -> dict:
    """Phase 11a: host<->device bytes/s of a timed PCIE_PROBE_BYTES copy
    each way between the page-locked capacity tier and the card (the
    host-to-device copy first, so the copy back writes the same bytes)."""
    src = host["mega"].view(-1).view(torch.uint8)[:PCIE_PROBE_BYTES]
    card = torch.empty((PCIE_PROBE_BYTES,), dtype=torch.uint8, device=dev)
    h2d = time_ms(torch, lambda: card.copy_(src, non_blocking=True), 5)
    d2h = time_ms(torch, lambda: src.copy_(card, non_blocking=True), 5)
    out = {"h2d_bytes_per_s": PCIE_PROBE_BYTES / (h2d * 1e-3),
           "d2h_bytes_per_s": PCIE_PROBE_BYTES / (d2h * 1e-3),
           "h2d_ms": h2d, "d2h_ms": d2h}
    log(f"  host<->device over {PCIE_PROBE_BYTES} bytes of page-locked "
        f"memory: {json.dumps(out)}")
    del card
    return out


def host_bound_ms(rates: dict, h2d: float, d2h: float,
                  hbm: float) -> tuple[float, str]:
    """Least time with the capacity tier on the host: the bytes read from
    it over the measured host-to-device rate, the bytes written to it over
    the device-to-host rate (the link is full duplex) and the card's own
    bytes over its HBM rate, whichever is longest."""
    return max(h2d / rates["h2d_bytes_per_s"], d2h / rates["d2h_bytes_per_s"],
               hbm / HBM_BYTES_PER_S) * 1e3, "bytes"


def check_host_movers(torch, dev, cfg, ebc, host: dict,
                      rates: dict) -> dict:
    """Phase 11a: the four row movers with the full-width capacity tier
    page-locked on the host, at the worklists of one training batch's
    misses over EVICT_CACHE_ROWS slots: each bit-equal to its plain version
    and to the same call with the tier on the card (a copy there), and
    timed, with its bound at the measured PCIe rates."""
    import numpy as np
    from repro_torch.core.cache import _chunk_min_fill
    from repro_torch.kernels import cache_ops as kc
    from repro_torch.kernels import ref
    from repro_torch.kernels.sparse_plan import coalesce_rows
    r_rows, d, c_rows = ebc.plan.total_rows, cfg.embed_dim, EVICT_CACHE_ROWS
    row = d * 4 + 4
    h_cap, h_acc = host["mega"], host["accum"]
    c_cap, c_acc = h_cap.to(dev), h_acc.to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    cache = torch.empty((c_rows, d), device=dev).normal_(generator=g)
    cache_accum = torch.rand((c_rows,), generator=g, device=dev)
    freq = torch.rand((c_rows,), generator=g, device=dev)
    idx = train_batch(cfg, ebc, 0)
    rows_np = np.unique(idx[idx >= 0]).astype(np.int64)
    n = len(rows_np)
    i32 = dict(dtype=torch.int32, device=dev)
    fetch = torch.as_tensor(rows_np, **i32)
    fetch[::97] = -1
    chunk = EVICT_CHUNK
    starts_np, _ = coalesce_rows(rows_np, chunk, r_rows,
                                 min_fill=_chunk_min_fill(chunk))
    starts = torch.as_tensor(np.concatenate(
        [starts_np, [r_rows - chunk, -1]]).astype(np.int32), device=dev)
    slots = torch.randperm(c_rows, generator=g, device=dev)[:n].int()
    evict = torch.randperm(r_rows, generator=g, device=dev)[:n].int()
    u = torch.rand((n,), generator=g, device=dev)
    evict[u < 0.5] = -1                               # half write back
    ins = fetch.clone()
    ins[u > 0.9] = -1                                 # pure writebacks
    slots[(u > 0.45) & (u < 0.5)] = -1                # pads
    # no row both written back and fetched (the exchange's contract)
    evict[torch.isin(evict, ins)] = -1
    kc.check_worklist(slots, evict, ins)
    shadow, shadow_accum = kc.cache_fetch(c_cap, c_acc, fetch)
    counts = torch.rand((n,), generator=g, device=dev) * 10
    live = slots >= 0
    n_wb = int((live & (evict >= 0)).sum())
    n_in = int((live & (ins >= 0)).sum())
    n_ft = int((fetch >= 0).sum())
    k_live = int((starts >= 0).sum())
    wb_rows = evict[live & (evict >= 0)].long()
    out = {}

    def compare(name, host_out, card_out, plain_out):
        equal = all(torch.equal(a.to(dev), b) and torch.equal(b, p)
                    for a, b, p in zip(host_out, card_out, plain_out))
        err = max(float((a.to(dev) - p).abs().max()) if p.numel() else 0.0
                  for a, p in zip(host_out, plain_out))
        log(f"  {name} over the host tier: bit-equal to plain and to the "
            f"card={equal} max_abs_err={err:.3e} (tol 0: values are "
            "copied)")
        if not equal:
            raise AssertionError(f"{name} over the host tier differs")
        return err

    def timed(name, fn, bound):
        res = {"ms": time_ms(torch, fn, 50),
               "device_ms": device_kernel_ms(torch, fn, 10,
                                             f"{name}_kernel"),
               "max_abs_err": errs[name]}
        res["bound_ms"], res["bound_by"] = bound
        res["bound_rates"] = {k: rates[k] for k in ("h2d_bytes_per_s",
                                                    "d2h_bytes_per_s")}
        log(f"  {name} over the host tier: {json.dumps(res)}")
        out[name] = res

    errs = {}
    # the two fetches only read the tiers
    errs["cache_fetch"] = compare(
        "cache_fetch", kc.cache_fetch(h_cap, h_acc, fetch),
        kc.cache_fetch(c_cap, c_acc, fetch),
        ref.cache_fetch_ref(c_cap, c_acc, fetch))
    errs["cache_fetch_chunked"] = compare(
        "cache_fetch_chunked",
        kc.cache_fetch_chunked(h_cap, h_acc, starts, chunk),
        kc.cache_fetch_chunked(c_cap, c_acc, starts, chunk),
        ref.cache_fetch_chunked_ref(c_cap, c_acc, starts, chunk))

    # the commit and the exchange write both tiers in place: each runs on
    # fresh copies of the device tier, and the host tier's written rows
    # are held against the card's and restored after
    def in_place(name, call):
        saved = h_cap[wb_rows.cpu()].clone(), h_acc[wb_rows.cpu()].clone()
        on_host = call(h_cap, h_acc)
        torch.cuda.synchronize()
        got = [h_cap[wb_rows.cpu()], h_acc[wb_rows.cpu()], *on_host]
        h_cap[wb_rows.cpu()], h_acc[wb_rows.cpu()] = saved
        c_saved = c_cap[wb_rows].clone(), c_acc[wb_rows].clone()
        on_card = call(c_cap, c_acc)
        card = [c_cap[wb_rows], c_acc[wb_rows], *on_card]
        c_cap[wb_rows], c_acc[wb_rows] = c_saved
        plain = call(c_cap, c_acc, plain=True)
        want = [c_cap[wb_rows], c_acc[wb_rows], *plain]
        c_cap[wb_rows], c_acc[wb_rows] = c_saved
        errs[name] = compare(name, got, card, want)

    def commit(cap, acc, plain=False):
        cch, cch_acc = cache.clone(), cache_accum.clone()
        (ref.cache_commit_ref if plain else kc.cache_commit)(
            cap, cch, acc, cch_acc, shadow, shadow_accum, slots, evict, ins)
        return [cch, cch_acc]

    def exchange(cap, acc, plain=False):
        cch, cch_acc, fq = cache.clone(), cache_accum.clone(), freq.clone()
        (ref.cache_exchange_ref if plain else kc.cache_exchange)(
            cap, cch, acc, cch_acc, fq, slots, evict, ins, counts)
        return [cch, cch_acc, fq]

    in_place("cache_commit", commit)
    in_place("cache_exchange", exchange)
    timed("cache_fetch",
          lambda: kc.cache_fetch(h_cap, h_acc, fetch),
          host_bound_ms(rates, n_ft * row, 0, n * 4 + n * row))
    timed("cache_fetch_chunked",
          lambda: kc.cache_fetch_chunked(h_cap, h_acc, starts, chunk),
          host_bound_ms(rates, k_live * chunk * row, 0,
                        starts.numel() * (4 + chunk * row)))
    cch, cch_acc, fq = cache.clone(), cache_accum.clone(), freq.clone()
    saved = h_cap[wb_rows.cpu()].clone(), h_acc[wb_rows.cpu()].clone()
    timed("cache_commit",
          lambda: kc.cache_commit(h_cap, cch, h_acc, cch_acc, shadow,
                                  shadow_accum, slots, evict, ins),
          host_bound_ms(rates, 0, n_wb * row,
                        n * 16 + n_wb * row + 2 * n_in * row))
    timed("cache_exchange",
          lambda: kc.cache_exchange(h_cap, cch, h_acc, cch_acc, fq, slots,
                                    evict, ins, counts),
          host_bound_ms(rates, n_in * row, n_wb * row,
                        n * 16 + n_wb * row + n_in * (row + 4)))
    torch.cuda.synchronize()
    h_cap[wb_rows.cpu()], h_acc[wb_rows.cpu()] = saved
    with clocked("11a's attribution"):
        out["variants"] = host_mover_variants(
            torch, dev, rates, (h_cap, h_acc, c_cap, c_acc),
            (cache, cache_accum, freq), (slots, evict, ins, counts))
    log(f"  worklists: {n} entries, {n_ft} row fetches, {k_live} live "
        f"{chunk}-row blocks, {n_wb} writebacks, {n_in} installs")
    del c_cap, c_acc, cache, cache_accum, freq, shadow, shadow_accum, cch
    del cch_acc, fq
    return out


def host_mover_variants(torch, dev, rates: dict, tiers, device_tier,
                        work) -> dict:
    """Phase 11a's attribution of the exchange's time over PCIe: its
    worklist cut to its installs (fetch_only) and to its writebacks
    (writeback_only, a flush's shape), each with cap_accum on the host and
    again on the card while the rows stay on the host (which takes the
    4-byte accumulator traffic off PCIe). Each is bit-equal to its plain
    version on the card and timed by CUDA events over 50 launches; its
    bound is at the measured rates for its placement."""
    from repro_torch.kernels import cache_ops as kc
    from repro_torch.kernels import ref
    h_cap, h_acc, c_cap, c_acc = tiers
    cache, cache_accum, freq = device_tier
    slots, evict, ins, counts = work
    n, d = slots.shape[0], h_cap.shape[1]
    none = torch.full_like(evict, -1)
    row = d * 4

    def exchange(fn, wl):
        return lambda cap, acc, t: fn(cap, t[0], acc, t[1], t[2], *wl)

    def run(call, cap, acc, wl, timed: bool):
        """call on fresh copies of the device tier; the rows it writes back
        (the worklist's live writeback rows) restored in cap and acc after.
        Returns what it wrote, or its ms."""
        wb = wl[1][(wl[0] >= 0) & (wl[1] >= 0)].long()
        r_cap = wb if cap.is_cuda else wb.cpu()
        r_acc = wb if acc.is_cuda else wb.cpu()
        saved = cap[r_cap].clone(), acc[r_acc].clone()
        t = (cache.clone(), cache_accum.clone(), freq.clone())
        if timed:
            got = time_ms(torch, lambda: call(cap, acc, t), 50)
        else:
            call(cap, acc, t)
        torch.cuda.synchronize()
        if not timed:
            got = [cap[r_cap].to(dev), acc[r_acc].to(dev), *t]
        cap[r_cap], acc[r_acc] = saved
        return got

    out = {}
    live = slots >= 0
    for acc_on, acc in (("host", h_acc), ("card", c_acc)):
        for cut, ev, ft in (("fetch_only", none, ins),
                            ("writeback_only", evict, none)):
            key = f"cache_exchange {cut}, cap_accum on the {acc_on}"
            wl = (slots, ev, ft, counts)
            want = run(exchange(ref.cache_exchange_ref, wl), c_cap, c_acc, wl,
                       False)
            got = run(exchange(kc.cache_exchange, wl), h_cap, acc, wl, False)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{key} differs from plain")
            n_rd = int((live & (ft >= 0)).sum())
            n_wr = int((live & (ev >= 0)).sum())
            res = {"ms": run(exchange(kc.cache_exchange, wl), h_cap, acc, wl,
                             True), "reads": n_rd, "writebacks": n_wr}
            # a row or accumulator on the host crosses PCIe, on the card
            # it is HBM traffic
            on_host = row + (4 if acc.is_cpu else 0)
            on_card = row + 4 - on_host
            res["bound_ms"], res["bound_by"] = host_bound_ms(
                rates, n_rd * on_host, n_wr * on_host,
                n * 16 + n_wr * (row + 4) + (n_wr + n_rd) * on_card
                + n_rd * (row + 8))
            res["share_of_bound"] = res["bound_ms"] / res["ms"]
            log(f"  11a attribution, {key}: {json.dumps(res)}")
            out[key] = res
    return out


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


def plain_logits(torch, dense, dense_x, pooled, interaction: str = "dot"):
    """Logits from the plain versions: MLPs, then the plain dot interaction
    or the concatenation."""
    from repro_torch.kernels import ref
    from repro_torch.nn.layers import linear
    x = dense_x
    for i, p in enumerate(dense["bottom"]):
        x = linear(p, x)
        if i < len(dense["bottom"]) - 1:
            x = torch.relu(x)
    if interaction == "cat":
        y = torch.cat([x, pooled.reshape(pooled.shape[0], -1)], dim=-1)
    else:
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


def plain_train_step(torch, params, state, batch, opt, plan,
                     interaction: str = "dot"):
    """One train step from the plain versions on the card: the lookup
    driven by `plan` (the batch's sparse plan), dense tower, autograd,
    dense AdaGrad, fused sparse update (in place on the mega table and
    accumulator). Returns (loss, dense, dense_state)."""
    from repro_torch.core.dlrm import _bce
    from repro_torch.kernels import ref
    from repro_torch.nn.params import tree_leaves, tree_map
    mega = params["emb"]["mega"]
    idx = batch["idx"]
    b, f, lk = idx.shape
    pooled = ref.dedup_embedding_bag_ref(
        mega, idx.reshape(b * f, lk), plan.unique_rows).reshape(b, f, -1)
    pooled.requires_grad_()
    dense = {"bottom": params["bottom"], "top": params["top"]}
    leaves = tree_map(lambda t: t.detach().requires_grad_(), dense)
    loss = _bce(plain_logits(torch, leaves, batch["dense"], pooled,
                             interaction), batch["label"])
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


def checked_step(torch, step_fn, params, state, batch, opt,
                 interaction: str = "dot"):
    """Step 0 through `step_fn` (the kernels), held to the same step from
    the same start through the plain versions on the card: the loss, the
    touched mega rows and accumulators, the dense parameters and state
    within TOL_STEP, and the bit checksums of the mega table and the
    accumulator equal once the touched rows are put back (the step wrote
    nothing else). The batch's sparse plan, or one built on the card, says
    which rows the step touches. Returns (params, state, metrics, the
    errors, the plan's live rows)."""
    from repro_torch.kernels.sparse_plan import (build_sparse_plan,
                                                 plan_from_batch)
    from repro_torch.nn.params import tree_leaves, tree_map
    mega, accum = params["emb"]["mega"], state["accum"]
    plan = plan_from_batch(batch) or build_sparse_plan(batch["idx"])
    rows = plan.unique_rows[plan.unique_rows >= 0].long()
    saved = (mega[rows].clone(), accum[rows].clone())
    dense0 = tree_map(torch.clone, {"bottom": params["bottom"],
                                    "top": params["top"]})
    state0 = {"dense": tree_map(torch.clone, state["dense"]),
              "accum": accum}
    sums = (bit_checksum(torch, mega), bit_checksum(torch, accum))
    params, state, metrics = step_fn(params, state, batch, 0)
    loss = float(metrics["loss"])
    kern = (mega[rows].clone(), accum[rows].clone())
    mega[rows], accum[rows] = saved
    if (bit_checksum(torch, mega), bit_checksum(torch, accum)) != sums:
        raise AssertionError("train step wrote outside the batch's rows")
    p_loss, p_dense, p_state = plain_train_step(
        torch, {**dense0, "emb": {"mega": mega}}, state0, batch, opt, plan,
        interaction)

    def flat(tree):
        return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])

    errs = {"loss": abs(p_loss - loss)}
    ok = errs["loss"] <= TOL_STEP + TOL_STEP * abs(p_loss)
    for name, a, b in (
            ("mega rows", kern[0], mega[rows]),
            ("accum rows", kern[1], accum[rows]),
            ("dense", flat({"bottom": params["bottom"],
                            "top": params["top"]}), flat(p_dense)),
            ("dense state", flat(state["dense"]), flat(p_state))):
        good, errs[name] = close(a, b, TOL_STEP)
        ok = ok and good
    shown = ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    log(f"step 0 vs plain recompute on the card: max_abs_err {shown} (tol "
        f"{TOL_STEP} abs + rel); bit checksums of mega and accum equal "
        f"after restore")
    if not ok:
        raise AssertionError(f"train step disagrees with the plain "
                             f"recompute: {errs}")
    mega[rows], accum[rows] = kern
    return params, state, metrics, errs, rows.numel()


def train_planned(torch, dev, cfg, ebc, want_losses) -> dict:
    """Phase 6b: TRAIN_STEPS full-width steps fed by the port's pipeline
    with the sparse-plan hook, from the launcher's seed. Step 0 is
    recomputed with the plain versions; the last PROFILED_STEPS steps run
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.data.pipeline import ShardedLoader, sparse_plan_hook
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.launch.train import PARAM_SEED, batch_to_device
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
            if step == TRAIN_STEPS - PROFILED_STEPS:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            t0 = time.perf_counter()
            if step == 0:                # held to the plain versions
                params, state, metrics = checked_step(
                    torch, step_fn, params, state, batch, opt)[:3]
            else:
                params, state, metrics = step_fn(params, state, batch, step)
            losses.append(float(metrics["loss"]))        # syncs the step
            host_s.append(time.perf_counter() - t0)
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


def train_cached(torch, dev, cfg, run: dict, want: dict,
                 host: dict | None = None) -> dict:
    """Phases 7 and 11: TRAIN_STEPS full-width steps through
    `build_cached_train_step` from the launcher's seed and batches. `run`
    names the tier ("async" or "sync"), `cache_rows` (None: the plan's),
    `fetch_chunk`, the reader hook ("plan" or "dedup"), whether the k-step
    lookahead feeds `prefetch_rows`, and, in phase 11, `bulk` (the
    three-tier collection's knobs, or None). `host` (phase 11) holds the
    page-locked `mega` and `accum` the capacity tier moves into: the table
    is made on the card, copied there and freed on the card. `want` holds
    the launcher's losses and the initial and final bit checksums. The
    last PROFILED_STEPS steps run under torch.profiler. Returns the run's
    numbers; the launch counts are reset just before the first step and
    hold the run's launches, materialize included, when it returns."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cache import CachedEmbeddingBagCollection
    from repro_torch.core.tiers import BulkCachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.tiers import AsyncCachedTier
    from repro_torch.data.pipeline import (ShardedLoader, dedup_indices_hook,
                                           lookahead_rows, sparse_plan_hook)
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.kernels import KERNELS, build_all
    from repro_torch.launch.train import PARAM_SEED
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import (build_cached_train_step,
                                         cached_dlrm_init_state)

    if run.get("bulk"):
        cc = BulkCachedEmbeddingBagCollection.build(
            cfg, cache_rows=run["cache_rows"],
            fetch_chunk=run["fetch_chunk"], **run["bulk"])
    else:
        cc = CachedEmbeddingBagCollection.build(
            cfg, cache_rows=run["cache_rows"],
            fetch_chunk=run["fetch_chunk"])
    tier = AsyncCachedTier(cc) if run["tier"] == "async" else cc
    params = init_dlrm_params(cfg, cc.ebc, PARAM_SEED, dev)
    if bit_checksum(torch, params["emb"]["mega"]) != want["init_sum"]:
        raise AssertionError("the cached run's initial table differs from "
                             "the launcher's")
    opt = adagrad(0.01)
    state = cached_dlrm_init_state(cc, opt, params)
    dense = {"bottom": params["bottom"], "top": params["top"]}
    mega, accum = params.pop("emb")["mega"], None
    out = {}
    if host is not None:
        t0 = time.perf_counter()
        host["mega"].copy_(mega)
        host["accum"].zero_()
        torch.cuda.synchronize()
        out["copy_to_host_s"] = time.perf_counter() - t0
        del mega
        gc.collect()
        torch.cuda.empty_cache()
        mega, accum = host["mega"], host["accum"]
        if torch.cuda.memory_allocated() > 1 << 30:
            raise AssertionError("the table is still on the card")
    t0 = time.perf_counter()
    cs = tier.init_state(mega, accum, device=dev)     # owned, no copy
    out["init_state_s"] = time.perf_counter() - t0
    del mega, accum
    log(f"  capacity tier on {cs.capacity.device}"
        + (f" (page-locked; copied there in {out['copy_to_host_s']:.2f} s)"
           if host is not None else "")
        + f", device tier on {cs.cache.device}; init_state "
        f"{out['init_state_s']:.2f} s")
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
    flushes = []
    with exchange_spy(flushes):
        mega, accum = tier.materialize(cs)
    sums = (bit_checksum(torch, mega), bit_checksum(torch, accum))
    materialize_ms = (time.perf_counter() - t0) * 1e3
    out["flush"] = flush_numbers(torch, flushes)
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

    if run.get("strict") and not (equal and sums == want["final_sums"]):
        raise AssertionError(f"{run['name']}: losses or final checksums "
                             "differ from the launcher's")
    peak = torch.cuda.max_memory_allocated()
    if host is not None and peak >= HOST_PEAK_LIMIT:
        raise AssertionError(f"{run['name']}: device peak {peak} bytes with "
                             f"the capacity tier on the host")
    if run.get("bulk"):
        out["tiers"] = check_tiers(cc, cs, st)
    events = device_events(prof)
    dev_us = sum(t for _, t in events)
    plain = slice(1, TRAIN_STEPS - PROFILED_STEPS)
    out.update({
        "losses_bit_equal": equal,
        "checksums_equal": sums == want["final_sums"],
        "host_ms_per_step": sum(host_s[plain]) / len(host_s[plain]) * 1e3,
        "profiled_host_ms_per_step":
            sum(host_s[-PROFILED_STEPS:]) / PROFILED_STEPS * 1e3,
        "device_busy_ms_per_step": (dev_us / 1e3 / PROFILED_STEPS
                                    if dev_us else None),
        "peak_bytes": peak,
        "stats": {k: getattr(st, k) for k in (
            "hits", "misses", "fetches", "evictions", "writebacks",
            "prefetched", "fetch_chunks", "overfetch_rows")},
        "widest_two_batch_working_set": widest})
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


@contextlib.contextmanager
def exchange_spy(seen: list):
    """While open, every `cache_ops.cache_exchange` call (the flush inside
    a tier's materialize) appends (its arguments, its CUDA events ms) to
    `seen`; the call itself is unchanged."""
    import torch

    from repro_torch.kernels import cache_ops as kc
    real = kc.cache_exchange

    def spy(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real(*args)
        end.record()
        end.synchronize()
        seen.append((args, start.elapsed_time(end)))

    kc.cache_exchange = spy
    try:
        yield
    finally:
        kc.cache_exchange = real


def flush_numbers(torch, flushes: list) -> dict | None:
    """A materialize's flush: its rows and events ms."""
    if not flushes:
        return None
    args, ms = flushes[-1]
    res = {"rows": int((args[6] >= 0).sum()), "ms": ms,
           "capacity_on": str(args[0].device)}
    log(f"  flush (materialize's cache_exchange): {json.dumps(res)}")
    return res


def train_multihost(torch, dev, cfg, run: dict, want: dict) -> dict:
    """Phases 13a-13b: TRAIN_STEPS full-width steps through
    `build_cached_train_step` on `MultiHostCachedEmbeddingBagCollection`
    (MULTIHOST_HOSTS hosts) from the launcher's seed and batches. `run`
    names the per-host `cache_rows` (None: the plan's), the reader hook
    ("plan": `sparse_plan_hook(n_hosts=...)`, whose sub-plans the step
    reads; "dedup": none, `plan_step` plans), `strict_sync` and
    `fetch_chunk`. Gates: each step's launches exactly 4 embedding_bag, 1
    dot_interaction and 1 segmented update; the losses and the
    materialized checksums the launcher's; hits + misses the batches'
    valid lookups; with `evicts`, evictions and invalidations. The last
    PROFILED_STEPS steps run under torch.profiler. Returns the run's
    numbers, "launches" the run's counts (reset before its first step)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cache import MultiHostCachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.data.pipeline import (ShardedLoader, dedup_indices_hook,
                                           sparse_plan_hook)
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.kernels import KERNELS, build_all
    from repro_torch.launch.analysis import multihost_exchange_traffic
    from repro_torch.launch.train import PARAM_SEED
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import (build_cached_train_step,
                                         cached_dlrm_init_state)

    hn = MULTIHOST_HOSTS
    mc = MultiHostCachedEmbeddingBagCollection.build(
        cfg, n_hosts=hn, cache_rows=run["cache_rows"])
    r_rows, d = mc.ebc.plan.total_rows, cfg.embed_dim
    params = init_dlrm_params(cfg, mc.ebc, PARAM_SEED, dev)
    if bit_checksum(torch, params["emb"]["mega"]) != want["init_sum"]:
        raise AssertionError("the multi-host run's initial table differs "
                             "from the launcher's")
    opt = adagrad(0.01)
    state = cached_dlrm_init_state(mc, opt, params)
    dense = {"bottom": params["bottom"], "top": params["top"]}
    mega = params.pop("emb")["mega"]
    out = {}
    t0 = time.perf_counter()
    ms = mc.init_state(mega)                   # owned, no copy
    out["init_state_s"] = time.perf_counter() - t0
    del mega
    reckoning = {"capacity": r_rows * d * 4, "accum": r_rows * 4,
                 "caches": hn * mc.cache_rows * d * 4}
    reckoning["total"] = sum(reckoning.values())
    host_maps = sum(getattr(ms, k).nbytes for k in (
        "freq", "slot_row", "row_slot", "ema", "ema_tick"))
    log(f"  {hn} hosts x {mc.cache_rows} slots, shard_rows "
        f"{mc.shard_rows}, capacity {tuple(ms.capacity.shape)} on "
        f"{ms.capacity.device}; device bytes by the reckoning "
        f"{json.dumps(reckoning)}, allocated "
        f"{torch.cuda.memory_allocated()}; host maps {host_maps} bytes; "
        f"init_state {out['init_state_s']:.2f} s")
    step_fn = build_cached_train_step(cfg, mc, opt, SPARSE_LR, SPARSE_EPS,
                                      strict_sync=run["strict_sync"],
                                      fetch_chunk=run["fetch_chunk"])
    offsets = mc.ebc.plan.table_offsets
    hook = (sparse_plan_hook(offsets, n_hosts=hn) if run["hook"] == "plan"
            else dedup_indices_hook(offsets))
    pipe = ShardedLoader(
        lambda step, seed: make_dlrm_batch(cfg, TRAIN_BATCH, step, seed),
        TRAIN_BATCH).pipeline(prefetch=2, transform=hook)
    want_step = {"embedding_bag": hn, "dot_interaction": 1,
                 "fused_bag_backward_adagrad_segments": 1}
    torch.cuda.reset_peak_memory_stats()
    losses, host_s, lookups, model, widest = [], [], 0, [], 0
    prof = None
    reset_launches(KERNELS)
    try:
        for step in range(TRAIN_STEPS):
            _, batch = next(pipe)
            idx = batch["idx"]
            bh = idx.shape[0] // hn
            ws = [len(np.unique(s[s >= 0])) for s in
                  (idx[h * bh:(h + 1) * bh] for h in range(hn))]
            widest = max(widest, max(ws))
            lookups += int(np.count_nonzero(idx >= 0))
            nxt = None if step == TRAIN_STEPS - 1 else pipe.peek(0)
            if step == TRAIN_STEPS - PROFILED_STEPS:
                torch.cuda.synchronize()
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
            before = {k.name: k.launches for k in KERNELS}
            fetches = ms.stats.fetches
            t0 = time.perf_counter()
            dense, state, m = step_fn(dense, state, ms, batch, step,
                                      next_batch=nxt)
            losses.append(float(m["loss"]))              # syncs the step
            host_s.append(time.perf_counter() - t0)
            got = {k.name: k.launches - before[k.name] for k in KERNELS}
            if got != {**dict.fromkeys(got, 0), **want_step}:
                raise AssertionError(f"{run['name']} step {step}: launches "
                                     f"{got}, want {want_step} and no other")
            # the traffic model at this step's counted unique rows and
            # admissions (plan and prefetch): a row hit rate over U_h
            u_h = sum(ws) / hn
            fetched = ms.stats.fetches - fetches
            model.append(multihost_exchange_traffic(
                TRAIN_BATCH, cfg.n_sparse_features, cfg.truncation, d, hn,
                u_h, len(np.unique(idx[idx >= 0])),
                1.0 - fetched / (hn * u_h)))
            log(f"  step {step} loss {losses[-1]:.6f} host "
                f"{host_s[-1] * 1e3:.3f} ms hit_rate "
                f"{m['cache_hit_rate']:.4f} route_fetch_remote "
                f"{m['route_fetch_remote']:.0f} route_invalidations "
                f"{m['route_invalidations']:.0f}")
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    finally:
        pipe.close()
    launches = read_launches(KERNELS, run["path"], tuple(want_step))
    mega, accum = mc.materialize(ms)
    sums = (bit_checksum(torch, mega), bit_checksum(torch, accum))
    st, route = mc.stats(ms), ms.route
    peak = torch.cuda.max_memory_allocated()
    log(f"  cache: hits={st.hits} misses={st.misses} fetches={st.fetches} "
        f"evictions={st.evictions} prefetched={st.prefetched} "
        f"fetch_chunks={st.fetch_chunks} overfetch_rows={st.overfetch_rows}"
        f" hit_rate={st.hit_rate:.4f}; valid lookups {lookups}; largest "
        f"per-host one-batch working set {widest} vs cache_rows "
        f"{mc.cache_rows}")
    log(f"  route: {json.dumps(route.snapshot())}")
    log_peak(torch, run["name"])
    log(f"  peak {peak} bytes vs the reckoning's {reckoning['total']}")
    equal = losses == want["losses"]
    log(f"  losses vs the launcher's: bit-equal={equal}; materialized "
        f"checksums (mega, accum) {sums} vs LAUNCHER_FINAL_SUMS "
        f"{LAUNCHER_FINAL_SUMS}: equal={sums == LAUNCHER_FINAL_SUMS}")
    if not equal:
        raise AssertionError(f"{run['name']}: losses {losses} differ from "
                             f"the launcher's {want['losses']}")
    if sums != LAUNCHER_FINAL_SUMS:
        raise AssertionError(f"{run['name']}: final checksums {sums} differ "
                             f"from {LAUNCHER_FINAL_SUMS}")
    if st.hits + st.misses != lookups:
        raise AssertionError(f"{run['name']}: hits {st.hits} + misses "
                             f"{st.misses} != {lookups} valid lookups")
    if run["evicts"] and not (st.evictions > 0 and route.invalidations > 0):
        raise AssertionError(f"{run['name']}: no eviction or invalidation")
    row = d * 4
    counted = {"fetch_bytes": route.fetch_remote * (row + 4),
               "grad_bytes": route.grad_pairs_remote * (row + 4),
               "refresh_bytes": route.refresh_remote * row,
               "dup_rows": route.dup_rows}
    counted["total_bytes"] = (counted["fetch_bytes"] + counted["grad_bytes"]
                              + counted["refresh_bytes"])
    modelled = {k: sum(m_[k] for m_ in model) for k in counted}
    log(f"  exchange bytes over the run, counted from RouteStats "
        f"{json.dumps(counted)} vs multihost_exchange_traffic at each "
        f"step's counted unique rows and row hit rate "
        f"{json.dumps(modelled)}")
    events = device_events(prof)
    dev_us = sum(t for _, t in events)
    plain = slice(1, TRAIN_STEPS - PROFILED_STEPS)
    top = sorted(events, key=lambda e: e[1], reverse=True)[:10]
    out.update({
        "losses_bit_equal": equal, "checksums_equal": True,
        "host_ms_per_step": sum(host_s[plain]) / len(host_s[plain]) * 1e3,
        "profiled_host_ms_per_step":
            sum(host_s[-PROFILED_STEPS:]) / PROFILED_STEPS * 1e3,
        "device_busy_ms_per_step": (dev_us / 1e3 / PROFILED_STEPS
                                    if dev_us else None),
        "peak_bytes": peak, "reckoning_bytes": reckoning,
        "host_map_bytes": host_maps,
        "stats": {k: getattr(st, k) for k in (
            "hits", "misses", "fetches", "evictions", "prefetched",
            "fetch_chunks", "overfetch_rows")},
        "route": dataclasses.asdict(route),
        "exchange_counted": counted, "exchange_model": modelled,
        "widest_host_working_set": widest,
        "update_device_ms_per_step": kernel_ms_per_step(
            events, "fused_bag_backward_adagrad"),
        "lookup_device_ms_per_step": kernel_ms_per_step(
            events, "embedding_bag"),
        "top_device_ms_per_step": {
            name[:60]: t / 1e3 / PROFILED_STEPS for name, t in top if t},
        "launches": launches})
    log(f"  {run['name']}: steps {plain.start}-{plain.stop - 1} host "
        f"{out['host_ms_per_step']:.3f} ms per step (profiler off); "
        f"profiled: host {out['profiled_host_ms_per_step']:.3f} ms, device "
        "busy " + (f"{out['device_busy_ms_per_step']:.3f} ms per step"
                   if dev_us else "not measured (trace holds no device time)"))
    log("  device ms per step by kernel (profiled steps): "
        + json.dumps(out["top_device_ms_per_step"]))
    log(prof.key_averages().table(sort_by="self_cpu_time_total",
                                  row_limit=12))
    del ms, mega, accum, dense, state
    return out


def check_tiers(cc, cs, st) -> dict:
    """Phase 11b's gates on a three-tier run: bulk promotions and
    demotions happened, and device, DRAM and bulk partition the rows. Logs
    the TierCacheStats snapshot, the DRAM occupancy (which may pass the
    budget by the last admission's evictions: they never demote in the
    same breath), the hidden share of the injected bulk latency and the
    traffic model at the run's measured DRAM hit rate beside the counted
    bytes and blocks."""
    from repro_torch.launch.analysis import tier_hierarchy_traffic
    masks = cc.tier_residency(cs)
    hbm, dram, bulk = masks["hbm"], masks["dram"], masks["bulk"]
    exclusive = (not (hbm & dram).any() and not (hbm & bulk).any()
                 and not (dram & bulk).any()
                 and int(hbm.sum() + dram.sum() + bulk.sum()) == len(hbm))
    occupancy = cs.dram_occupancy
    out = {"snapshot": st.snapshot(),
           "residency_rows": {k: int(m.sum()) for k, m in masks.items()},
           "residency_exclusive": exclusive, "dram_occupancy": occupancy,
           "dram_budget": cc._dram_cap(),
           "bulk_sched_us": st.bulk_sched_us,
           "bulk_wait_us": st.bulk_wait_us,
           "hidden_fraction": st.hidden_fraction,
           "dram_hit_rate": st.dram_hit_rate}
    model = tier_hierarchy_traffic(
        st.dram_hits + st.bulk_hits, cc.ebc.cfg.embed_dim, st.dram_hit_rate,
        bulk_chunk=cc.bulk_chunk, bulk_latency_us=cc.bulk_latency_us,
        demotion_rows=st.demotions)
    out["model"] = model
    # the model's blocks assume dense bulk_chunk-row blocks; the run's
    # promotions are scattered rows: the model again at the measured
    # rows per block
    density = st.bulk_hits / max(st.bulk_read_chunks * cc.bulk_chunk, 1)
    out["model_at_measured_density"] = {"chunk_density": density, **{
        k: v for k, v in tier_hierarchy_traffic(
            st.dram_hits + st.bulk_hits, cc.ebc.cfg.embed_dim,
            st.dram_hit_rate, bulk_chunk=cc.bulk_chunk,
            bulk_latency_us=cc.bulk_latency_us, chunk_density=density,
            demotion_rows=st.demotions).items()
        if k in ("bulk_read_blocks", "bulk_write_blocks",
                 "bulk_latency_us", "total_bytes")}}
    out["counted"] = {"bulk_rows": st.bulk_hits,
                      "bulk_read_blocks": st.bulk_read_chunks,
                      "bulk_write_blocks": st.bulk_write_chunks,
                      "promotion_bytes": st.promotion_bytes,
                      "demotion_bytes": st.demotion_bytes,
                      "bulk_latency_us": st.bulk_sched_us}
    log(f"  tiers: {json.dumps(out)}")
    if not (st.bulk_hits > 0 and st.demotions > 0):
        raise AssertionError(f"no bulk promotion or demotion: {out}")
    if not exclusive:
        raise AssertionError(f"residency is not an exclusive partition: "
                             f"{out}")
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
    from repro_torch.kernels import KERNELS, build_all
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


def rank_device(dev) -> str:
    """The device string each spawned rank runs on: the parent's card."""
    import torch
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.current_device()}"
    return str(dev)


def host_dense(params) -> dict:
    """The dense parameters as numpy arrays, the way a rank takes them."""
    return {part: [{k: v.detach().cpu().numpy() for k, v in layer.items()}
                   for layer in params[part]] for part in ("bottom", "top")}


def mesh_run(torch, dev, name: str, job: dict, n_ranks: int,
             per_rank: dict, world=None) -> tuple[list, dict]:
    """Run `train.sharded.train_rank` on `n_ranks` gloo ranks on the card
    (NCCL refuses two ranks on one device): `world`'s, or a world spawned
    for it; each rank loads the kernels the parent built; hold every
    rank's launches to `per_rank` (kernel -> exact count) and its modules
    clear of jax and the reference. Returns
    the ranks' reports and the phase's numbers: host ms a step (steps 1
    on), each rank's device span and busy ms a step, the all_reduce calls,
    bytes and ms a step (the bytes of calls over a one-rank axis, which
    run no collective, apart), examples/s and the ranks' summed peaks."""
    import numpy as np

    from repro_torch.train.sharded import train_rank
    (res,), world = rank_world(torch, dev, name, [(train_rank, job)],
                               n_ranks, world=world)
    for r in res:
        log(f"  {name} rank {r['rank']} {r['coords']} rows {r['rows']}: "
            f"losses {r['losses']}; launches {r['launches']}; host ms "
            f"{[round(x, 3) for x in r['host_ms']]}; device span ms "
            f"{[round(x, 3) for x in r['device_span_ms']]}; busy ms a "
            f"profiled step {r['device_busy_ms_per_step']}; peak "
            f"{r['peak_bytes']} bytes")
        bad = {k: (r["launches"][k], want) for k, want in per_rank.items()
               if r["launches"][k] != want}
        if bad:
            raise AssertionError(f"{name} rank {r['rank']}: launches "
                                 f"(got, want) {bad}")
        if r["foreign_modules"]:
            raise AssertionError(f"{name} rank {r['rank']} loaded "
                                 f"{r['foreign_modules']}")
    n = len(res[0]["host_ms"])
    later = slice(1, n) if n > 1 else slice(0, n)

    def per_step(key):
        return float(np.mean([st[key] for r in res
                              for st in r["all_reduce"][later]]))

    host_ms = float(np.mean([np.mean(r["host_ms"][later]) for r in res]))
    busy = [r["device_busy_ms_per_step"] for r in res]
    nums = {**world,
            "rank_setup_s": {k: float(max(r["setup"][k] for r in res))
                             for k in res[0]["setup"]},
            "host_ms_per_step": host_ms,
            "max_rank_host_ms_per_step": float(max(
                np.mean(r["host_ms"][later]) for r in res)),
            "device_span_ms_per_step": float(np.mean(
                [np.mean(r["device_span_ms"][later]) for r in res]))
            if res[0]["device_span_ms"] else None,
            "device_busy_ms_per_step_by_rank": busy,
            "all_reduce_calls_per_step": per_step("all_reduce_calls"),
            "all_reduce_bytes_per_step": per_step("all_reduce_bytes"),
            "all_reduce_ms_per_step": per_step("all_reduce_ms"),
            "one_rank_axis_bytes_per_step": per_step("skipped_bytes"),
            "ranks_peak_bytes": sum(r["peak_bytes"] or 0 for r in res),
            "examples_per_s": TRAIN_BATCH / host_ms * 1e3,
            "launches": {k: sum(r["launches"][k] for r in res)
                         for k in res[0]["launches"]},
            "launches_per_rank": [r["launches"] for r in res]}
    log(f"  {name}: " + json.dumps({k: v for k, v in nums.items()
                                     if k != "launches_per_rank"}))
    return res, nums


def release_shared(torch, dev) -> None:
    """Free the blocks the ranks held by CUDA IPC: PyTorch keeps a shared
    block after its last local reference until every rank has let go of
    it, and frees it only when asked."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.ipc_collect()


def chunked_close(torch, dev, got, want_host, rtol: float, atol: float,
                  chunk: int = 1 << 24) -> tuple[bool, float]:
    """|got - want| <= atol + rtol * |want| over a table on the card and
    its oracle in host memory, a chunk of rows at a time; (all within,
    the largest difference)."""
    ok, worst = True, 0.0
    for lo in range(0, got.shape[0], chunk):
        g = got[lo:lo + chunk]
        w = want_host[lo:lo + chunk].to(dev)
        err = (g - w).abs()
        ok = ok and not bool((err > atol + rtol * w.abs()).any())
        worst = max(worst, float(err.max()))
        del w, err
    return ok, worst


def mesh_reckoning(name: str, table_bytes: int, extra_bytes: int,
                   parent_peak: int, nums: dict) -> None:
    log(f"  {name} memory: reckoned {table_bytes} bytes of table and "
        f"accumulator in the parent's memory + {extra_bytes} bytes the "
        f"ranks allocate (contexts aside); measured max_memory_allocated: "
        f"parent {parent_peak}, ranks summed {nums['ranks_peak_bytes']}")


def mesh_tablewise_m1(torch, dev, cfg, ebc, want: dict, world=None) -> dict:
    """Phase 12a: 8a's run on a (1, 8) mesh, one rank per owner: each rank
    views its owner's 25.7M rows of the parent's table (CUDA IPC), draws
    8a's batches from the same pipeline, stages the next one, pools with
    the psum lookup and updates its own shard. Gates: every rank's losses
    equal 8a's, the ranks' shard checksums add up to the parent's table,
    and that to TABLEWISE_FINAL_SUMS, bit for bit; each rank one pooled
    lookup, one interaction and one segmented update a step; the
    exchange metrics equal the traffic model."""
    import numpy as np

    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.launch.analysis import tablewise_exchange_traffic
    from repro_torch.launch.train import PARAM_SEED
    from repro_torch.train.sharded import add_checksums

    plan = ebc.plan
    torch.cuda.reset_peak_memory_stats()
    params = init_dlrm_params(cfg, ebc, PARAM_SEED, dev)
    mega = params["emb"]["mega"]
    accum = torch.zeros((plan.total_rows,), dtype=torch.float32, device=dev)
    job = {"cfg": cfg, "mesh": (1, TABLEWISE_OWNERS),
           "strategy": "table_wise", "step": "tablewise",
           "dense": host_dense(params), "mega": mega, "accum": accum,
           "n_steps": TRAIN_STEPS,
           "batches": mesh_batches(cfg, ebc, TRAIN_STEPS, "plan"),
           "staged": True, "sparse_lr": SPARSE_LR, "sparse_eps": SPARSE_EPS,
           "profile_steps": MESH_PROFILED_STEPS}
    per_rank = {"embedding_bag": TRAIN_STEPS,
                "dot_interaction": TRAIN_STEPS,
                "fused_bag_backward_adagrad_segments": TRAIN_STEPS,
                "fused_bag_backward_adagrad": 0,
                "dedup_embedding_bag": 0}
    res, nums = mesh_run(torch, dev, "12a", job, TABLEWISE_OWNERS, per_rank,
                         world)
    del job
    sums = (bit_checksum(torch, mega), bit_checksum(torch, accum))
    shard_sums = (add_checksums(r["mega_sum"] for r in res),
                  add_checksums(r["accum_sum"] for r in res))
    owners = np.asarray(plan.table_offsets) // plan.shard_rows
    model = tablewise_exchange_traffic(
        TRAIN_BATCH, cfg.n_sparse_features, cfg.truncation, cfg.embed_dim,
        plan.capacity_shards,
        features_per_owner=np.bincount(owners,
                                       minlength=plan.capacity_shards))
    log(f"12a: losses {res[0]['losses']} (8a {want['losses']}); final "
        f"checksums: parent {sums}, ranks added {shard_sums}, recorded "
        f"{TABLEWISE_FINAL_SUMS}; exchange metrics {res[0]['exchange']} "
        f"vs the model {model}; all_reduce bytes a step "
        f"{nums['all_reduce_bytes_per_step']} (one (B, F, d) fp32 pool: "
        f"{TRAIN_BATCH * cfg.n_sparse_features * cfg.embed_dim * 4}; the "
        f"model's all-to-all wire bytes each way {model['fwd_bytes']})")
    mesh_reckoning("12a", (mega.numel() + accum.numel()) * 4, 0,
                   torch.cuda.max_memory_allocated(), nums)
    for r in res:
        if r["losses"] != want["losses"]:
            raise AssertionError(f"12a rank {r['rank']} losses "
                                 f"{r['losses']} differ from 8a's")
        if r["exchange"] != {"exchange_pooled_fwd_bytes": model["fwd_bytes"],
                             "exchange_pooled_bwd_bytes": model["bwd_bytes"],
                             "exchange_pair_leg_bytes":
                                 model["pair_leg_bytes"]}:
            raise AssertionError(f"12a exchange metrics {r['exchange']} "
                                 f"differ from the model {model}")
    if not sums == shard_sums == TABLEWISE_FINAL_SUMS:
        raise AssertionError(f"12a checksums: parent {sums}, ranks "
                             f"{shard_sums}, recorded {TABLEWISE_FINAL_SUMS}")
    del params, mega, accum
    release_shared(torch, dev)
    return nums


def mesh_batches(cfg, ebc, n_steps: int, hook: str) -> list:
    """A mesh phase's batches, drawn once here through the training
    pipeline (`train.sharded.pipeline_batches`, seed 0) and handed to the
    oracle and to every rank, so the ranks do not each run the reader."""
    from repro_torch.train.sharded import pipeline_batches
    return pipeline_batches(cfg, ebc, n_steps, TRAIN_BATCH, hook)


def oracle_m2(torch, dev, cfg, ebc, batches: list, sparse_apply: str
              ) -> dict:
    """The single-device oracle of 12b / 12c: `build_dlrm_train_step` on
    the same layout, seed and batches as the mesh run; its final table,
    accumulator and dense parameters go to host memory."""
    import numpy as np

    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.launch.train import PARAM_SEED, batch_to_device
    from repro_torch.optim import adagrad
    from repro_torch.train import build_dlrm_train_step, dlrm_init_state
    params = init_dlrm_params(cfg, ebc, PARAM_SEED, dev)
    opt = adagrad(0.01)
    state = dlrm_init_state(ebc, opt, params)
    step = build_dlrm_train_step(cfg, ebc, opt, SPARSE_LR, SPARSE_EPS,
                                 sparse_apply=sparse_apply)
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for t, batch in enumerate(batches):
        params, state, m = step(params, state, batch_to_device(batch, dev),
                                t)
        losses.append(float(m["loss"]))
    if not np.isfinite(losses).all():
        raise AssertionError(f"oracle losses not finite: {losses}")
    out = {"losses": losses, "mega": params["emb"]["mega"].cpu(),
           "accum": state["accum"].cpu(), "dense": host_dense(params),
           "peak_bytes": torch.cuda.max_memory_allocated()}
    log(f"  oracle ({sparse_apply} update, one device): losses {losses}; "
        f"peak {out['peak_bytes']} bytes")
    del params, state
    return out


def close_dense(got: dict, want: dict, rtol: float, atol: float
                ) -> tuple[bool, float]:
    """(every element within atol + rtol * |want|, the largest difference)
    between two dense parameter trees."""
    import numpy as np
    ok, worst = True, 0.0
    for part in ("bottom", "top"):
        for a, b in zip(got[part], want[part]):
            for k in a:
                err = np.abs(a[k] - b[k])
                ok = ok and bool((err <= atol + rtol * np.abs(b[k])).all())
                worst = max(worst, float(err.max()))
    return ok, worst


def mesh_psum_m2(torch, dev, m2, world=None) -> dict:
    """Phase 12b: the psum dense update on full-width dlrm-m2 under
    row_wise, mesh (1, 4): the single-device dense step first (the
    oracle, same layout, seed and batches), then MESH_PSUM_STEPS steps on
    4 ranks, each on a view of its quarter of the parent's table with its
    own (rows_local, d) gradient buffer; then the same with a bf16 reduce
    from a fresh table. Gates: losses within TOL_PSUM_LOSS, table and
    accumulator within TOL_PSUM_TABLE of the oracle; the bf16 run's first
    loss bit-equal to the fp32 run's, its second within TOL_PSUM_BF16;
    each step's gradient sum handed to the (one-rank) data axis is
    rows_local * d * 4 bytes (2 in bf16)."""
    import dataclasses

    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.launch.train import PARAM_SEED
    cfg = dataclasses.replace(m2, lookup_impl="psum")
    ebc = EmbeddingBagCollection.build(cfg, n_shards=MESH_PSUM_SHAPE[1],
                                       strategy="row_wise")
    rows, d = ebc.plan.total_rows, cfg.embed_dim
    rows_local = rows // MESH_PSUM_SHAPE[1]
    log(f"phase 12b: the oracle, build_dlrm_train_step(sparse_apply="
        f"'dense') on one device, R={rows}, {MESH_PSUM_STEPS} steps")
    batches = mesh_batches(cfg, ebc, MESH_PSUM_STEPS, "offset")
    oracle = oracle_m2(torch, dev, m2, ebc, batches, "dense")
    free_device(torch)
    out, fp32_losses = {}, None
    per_rank = {"embedding_bag": MESH_PSUM_STEPS,
                "dot_interaction": MESH_PSUM_STEPS,
                "fused_bag_backward_adagrad": 0,
                "fused_bag_backward_adagrad_segments": 0}
    for dtype in ("float32", "bfloat16"):
        name = "12b" if dtype == "float32" else "12b-bf16"
        log(f"phase {name}: {MESH_PSUM_SHAPE[1]} ranks, mesh "
            f"{MESH_PSUM_SHAPE}, the psum update with a {dtype} reduce, "
            f"rows_local {rows_local}")
        torch.cuda.reset_peak_memory_stats()
        params = init_dlrm_params(cfg, ebc, PARAM_SEED, dev)
        mega = params["emb"]["mega"]
        accum = torch.zeros((rows,), dtype=torch.float32, device=dev)
        job = {"cfg": dataclasses.replace(cfg, grad_reduce_dtype=dtype),
               "mesh": MESH_PSUM_SHAPE, "strategy": "row_wise",
               "step": "dense_psum", "dense": host_dense(params),
               "mega": mega, "accum": accum, "n_steps": MESH_PSUM_STEPS,
               "batches": batches,
               "sparse_lr": SPARSE_LR, "sparse_eps": SPARSE_EPS,
               "report_dense": True,
               "profile_steps": MESH_PROFILED_STEPS}
        res, nums = mesh_run(torch, dev, name, job, MESH_PSUM_SHAPE[1],
                             per_rank, world)
        del job
        buf = rows_local * d * (4 if dtype == "float32" else 2)
        mesh_reckoning(name, (mega.numel() + accum.numel()) * 4,
                       MESH_PSUM_SHAPE[1] * (rows_local + 1) * d * 4
                       + (0 if dtype == "float32"
                          else MESH_PSUM_SHAPE[1] * buf),
                       torch.cuda.max_memory_allocated(), nums)
        for r in res:
            steps_bytes = [st["skipped_bytes"] for st in r["all_reduce"]]
            if steps_bytes != [buf] * MESH_PSUM_STEPS:
                raise AssertionError(f"{name}: the data axis took "
                                     f"{steps_bytes} bytes a step, not "
                                     f"rows_local * d * itemsize = {buf}")
        losses = res[0]["losses"]
        if any(r["losses"] != losses for r in res):
            raise AssertionError(f"{name}: the ranks' losses differ")
        if dtype == "float32":
            fp32_losses = losses
            ok_t, err_t = chunked_close(torch, dev, mega, oracle["mega"],
                                        *TOL_PSUM_TABLE)
            ok_a, err_a = chunked_close(torch, dev, accum, oracle["accum"],
                                        *TOL_PSUM_TABLE)
            ok_d, err_d = close_dense(res[0]["dense"], oracle["dense"],
                                      *TOL_PSUM_TABLE)
            err_l = max(abs(a - b) / abs(b)
                        for a, b in zip(losses, oracle["losses"]))
            log(f"12b vs the oracle: losses {losses} vs "
                f"{oracle['losses']} (largest relative difference "
                f"{err_l:.3e}, tol {TOL_PSUM_LOSS}); table max |diff| "
                f"{err_t:.3e}, accumulator {err_a:.3e}, dense {err_d:.3e} "
                f"(rtol, atol {TOL_PSUM_TABLE})")
            if not (ok_t and ok_a and ok_d and err_l <= TOL_PSUM_LOSS):
                raise AssertionError("12b is not within its tolerance of "
                                     "the one-device dense step")
            nums.update(loss_rel_err=err_l, table_err=err_t,
                        accum_err=err_a, dense_err=err_d)
        else:
            rel = abs(losses[1] - fp32_losses[1]) / abs(fp32_losses[1])
            log(f"12b-bf16 vs fp32: losses {losses} vs {fp32_losses}: "
                f"step 0 equal {losses[0] == fp32_losses[0]}, step 1 "
                f"relative difference {rel:.3e} (tol {TOL_PSUM_BF16})")
            if losses[0] != fp32_losses[0] or not rel <= TOL_PSUM_BF16:
                raise AssertionError("12b-bf16 is not within its tolerance "
                                     "of the fp32 run")
            nums["step1_loss_rel_diff"] = rel
        out[name] = nums
        del params, mega, accum
        release_shared(torch, dev)
        free_device(torch)
    del oracle
    return out


def mesh_hybrid_m2(torch, dev, m2, world=None) -> dict:
    """Phase 12c: the hybrid table-wise step on full-width dlrm-m2, 4
    owners on a (2, 4) mesh: data replica 0 of each owner views the
    parent's rows (CUDA IPC), replica 1 trains its own copy; the oracle,
    `build_dlrm_train_step(sparse_apply="sparse")` on one device with the
    same layout, seed and batches, runs first. Gates: the two replicas of
    every shard bit-equal to each other (rows, accumulator, dense
    parameters, losses); table, accumulator and losses within TOL_HYBRID
    of the oracle, the dense parameters within TOL_HYBRID_DENSE; the
    exchange metrics equal to the traffic model."""
    import numpy as np

    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.launch.analysis import tablewise_exchange_traffic
    from repro_torch.launch.train import PARAM_SEED
    data, owners = MESH_HYBRID_SHAPE
    ebc = EmbeddingBagCollection.build(m2, n_shards=owners,
                                       strategy="table_wise")
    plan = ebc.plan
    log(f"phase 12c: the oracle, build_dlrm_train_step(sparse_apply="
        f"'sparse') on one device, {owners} owners of {plan.shard_rows} "
        f"rows, {MESH_HYBRID_STEPS} steps")
    batches = mesh_batches(m2, ebc, MESH_HYBRID_STEPS, "offset")
    oracle = oracle_m2(torch, dev, m2, ebc, batches, "sparse")
    free_device(torch)
    log(f"phase 12c: {data * owners} ranks, mesh {MESH_HYBRID_SHAPE}, the "
        f"table-wise step with the next batch staged")
    torch.cuda.reset_peak_memory_stats()
    params = init_dlrm_params(m2, ebc, PARAM_SEED, dev)
    mega = params["emb"]["mega"]
    accum = torch.zeros((plan.total_rows,), dtype=torch.float32, device=dev)
    job = {"cfg": m2, "mesh": MESH_HYBRID_SHAPE, "strategy": "table_wise",
           "step": "tablewise", "dense": host_dense(params), "mega": mega,
           "accum": accum, "n_steps": MESH_HYBRID_STEPS,
           "batches": batches,
           "staged": True, "sparse_lr": SPARSE_LR, "sparse_eps": SPARSE_EPS,
           "report_dense": True, "profile_steps": MESH_PROFILED_STEPS}
    per_rank = {"embedding_bag": MESH_HYBRID_STEPS,
                "dot_interaction": MESH_HYBRID_STEPS,
                "fused_bag_backward_adagrad_segments": MESH_HYBRID_STEPS,
                "fused_bag_backward_adagrad": 0}
    res, nums = mesh_run(torch, dev, "12c", job, data * owners, per_rank,
                         world)
    del job
    mesh_reckoning("12c", (mega.numel() + accum.numel()) * 4,
                   (data - 1) * (mega.numel() + accum.numel()) * 4,
                   torch.cuda.max_memory_allocated(), nums)
    model = tablewise_exchange_traffic(
        TRAIN_BATCH, m2.n_sparse_features, m2.truncation, m2.embed_dim,
        owners, features_per_owner=np.bincount(
            np.asarray(plan.table_offsets) // plan.shard_rows,
            minlength=owners))
    pairs = []
    for m in range(owners):
        reps = [r for r in res if r["coords"]["model"] == m]
        pairs.append({"rows": reps[0]["rows"],
                      "replica_equal": [r["replica_equal"] for r in reps[1:]],
                      "sums_equal": len({(r["mega_sum"], r["accum_sum"])
                                         for r in reps}) == 1})
    same = (all(p["sums_equal"] and all(p["replica_equal"]) for p in pairs)
            and len({tuple(r["dense_sums"]) for r in res}) == 1
            and len({tuple(r["losses"]) for r in res}) == 1)
    ok_t, err_t = chunked_close(torch, dev, mega, oracle["mega"], TOL_HYBRID,
                                TOL_HYBRID)
    ok_a, err_a = chunked_close(torch, dev, accum, oracle["accum"],
                                TOL_HYBRID, TOL_HYBRID)
    ok_d, err_d = close_dense(res[0]["dense"], oracle["dense"], TOL_HYBRID,
                              TOL_HYBRID_DENSE)
    losses = res[0]["losses"]
    err_l = max(abs(a - b) for a, b in zip(losses, oracle["losses"]))
    ok_l = all(abs(a - b) <= TOL_HYBRID * (1 + abs(b))
               for a, b in zip(losses, oracle["losses"]))
    log(f"12c: replicas {pairs}; every replica's dense parameters and "
        f"losses equal: {same}; losses {losses} vs the oracle's "
        f"{oracle['losses']} (largest difference {err_l:.3e}, within "
        f"{TOL_HYBRID} * (1 + |loss|): {ok_l}); table max |diff| "
        f"{err_t:.3e}, accumulator {err_a:.3e} (rtol = atol = {TOL_HYBRID}: "
        f"{ok_t and ok_a}); dense {err_d:.3e} (rtol {TOL_HYBRID}, atol "
        f"{TOL_HYBRID_DENSE}: {ok_d}); exchange {res[0]['exchange']} vs "
        f"the model {model}; all_reduce bytes a step "
        f"{nums['all_reduce_bytes_per_step']}")
    if not same:
        raise AssertionError("12c: the data replicas drifted apart")
    if not (ok_t and ok_a and ok_d and ok_l):
        raise AssertionError("12c is not within its tolerance of the "
                             "one-device step")
    if res[0]["exchange"] != {"exchange_pooled_fwd_bytes": model["fwd_bytes"],
                              "exchange_pooled_bwd_bytes": model["bwd_bytes"],
                              "exchange_pair_leg_bytes":
                                  model["pair_leg_bytes"]}:
        raise AssertionError(f"12c exchange metrics {res[0]['exchange']} "
                             f"differ from the model {model}")
    nums.update(loss_err=err_l, table_err=err_t, accum_err=err_a,
                dense_err=err_d)
    del params, mega, accum, oracle
    release_shared(torch, dev)
    return nums


def check_flash_attention(torch, dev) -> dict:
    """Phase 9a: the flash-attention kernel against its plain version at
    each of FLASH_SHAPES (bf16 also against the fp32 oracle), a causality
    probe at the prefill's shape, and the times of the kernel, its plain
    version and SDPA (timed only, as the yardstick). Returns the numbers by
    shape name."""
    from repro_torch.kernels import flash_attention as kf
    log_ptxas(kf.KERNEL, "flash_attention_kernel_sm90")
    return {name: check_flash_shape(torch, dev, name, shape, dt)
            for name, shape, dt in FLASH_SHAPES}


def check_flash_shape(torch, dev, name: str, shape: tuple, dt: str) -> dict:
    """The flash-attention kernel at one (b, h, s, dh) shape and dtype
    against its plain version (bf16 also against the fp32 oracle), the
    causality probe at the "stablelm" shape, and the times of the kernel,
    its plain version and SDPA. Returns the numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref
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
    del q, k, v, got
    gc.collect()
    torch.cuda.empty_cache()
    return nums


def lm_prefill(torch, dev, cfg) -> dict:
    """Phase 9b: prefill_step on LM_PROMPT tokens of make_lm_batch at full
    width, then LM_DECODE greedy decode steps; one more prefill under
    torch.profiler. Returns the numbers, the prefill's last logits (fp32,
    host), the parameters and the tokens (9c reuses both), and phase
    20's oracle: the last logits, each decode step's and the tokens fed
    (host)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.kernels import KERNELS, build_all
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
    generated, decode_ms, fed, step_logits = [], [], [], []
    for i in range(LM_DECODE):
        t0 = time.perf_counter()
        fed.append(int(tok))
        logits, caches = decode_step(params, tok[:, None], caches,
                                     LM_PROMPT + i, cfg)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"decode step {i}: logits not finite")
        tok = logits.float().argmax(-1)
        generated.append(int(tok))
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        step_logits.append(logits.float().cpu())
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
            "tokens": tokens, "launches": counts,
            "oracle": {"last": last.cpu(), "logits": step_logits,
                       "fed": fed}}


def lm_prefill_plain(torch, cfg, run: dict) -> dict:
    """Phase 9c: prefill_step on the first LM_PROMPT - 1 tokens (not a
    multiple of attn_block_q: full attention, no kernel), then decode_step
    on the last token, whose logits are for 9b's last position; held to
    9b's within TOL_LM_REL_L2 and TOL_LM_ABS."""
    from repro_torch.kernels import KERNELS, build_all
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
    decodes); then four more requests of half the budget under
    torch.profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import KERNELS, build_all
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
    # half the budget under the profiler, for the run's length: its
    # trace's key_averages cost ~1 s a profiled step
    for uid in range(n_req, n_req + engine.batch_slots):
        engine.submit(Request(uid=uid, prompt=rng.randint(
            0, cfg.vocab_size, size=(8,)).astype(np.int32),
            max_new_tokens=budget // 2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the device's activity alone: with the CPU's too, key_averages over
    # these engine steps' ops took ~58 s on the card, for a device sum
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def tree_checksums(torch, tree) -> list[int]:
    """bit_checksum of every leaf of a parameter tree, in tree order."""
    from repro_torch.nn.params import tree_leaves
    return [bit_checksum(torch, t) for t in tree_leaves(tree)]


def layer_train_bytes(cfg, kind: str, is_moe: bool, tokens: int) -> int:
    """One layer's activations while the backward recomputes it, saved
    and as gradients (twice the forward's): its bf16 input and norm;
    attention's q, k, v, the repeated K/V and the kernel's output and
    log-sum-exp; a Mamba-2 mixer's in_proj output, three conv-width
    tensors and the chunk products' fp32 and bf16 (heads, tokens, chunk)
    tensors; an MLP's four (tokens, d_ff) products; an MoE layer's expert
    slots (inputs, four (e_pad, cap, f) products, outputs) and the
    routing's (tokens * k, e) counts."""
    from repro_torch.nn.mamba2 import mamba_dims
    from repro_torch.nn.moe import _capacity
    d = cfg.d_model
    n = 2 * tokens * d * 2
    if kind == "a":
        h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        n += tokens * dh * 2 * (3 * h + 2 * kv) + 4 * h * tokens
    else:
        m = mamba_dims(cfg)
        chunk = min(cfg.ssm_chunk, tokens)
        n += (2 * tokens * (m["d_in_proj"] + 3 * m["conv_dim"])
              + 6 * m["n_heads"] * tokens * chunk)
    if cfg.d_ff and is_moe:
        e_pad = cfg.n_experts + cfg.expert_pad
        cap = _capacity(tokens // max(1, cfg.moe_groups), cfg.n_experts,
                        cfg.top_k, cfg.capacity_factor) * max(
                            1, cfg.moe_groups)
        n += 2 * e_pad * cap * (2 * d + 4 * cfg.d_ff) \
            + 8 * tokens * cfg.top_k * cfg.n_experts
    elif cfg.d_ff:
        n += 2 * tokens * 4 * cfg.d_ff
    return 2 * n


def lm_reckoning_bytes(cfg, batch: int, seq: int) -> dict:
    """The LM step's device memory by the reckoning, part by part, and
    their sum: fp32 parameters, gradients and both AdamW moments (every
    leaf of `lm_param_specs`: experts with their pads, mixers, codebooks,
    the V*K head); `clip_by_global_norm`'s scaled copy of the gradients
    (fp32); `adamw`'s three fp32 temporaries on the largest leaf; each
    unit's bf16 input, which remat="full" keeps; the logits in bf16 and
    fp32 and as much again for their gradient (V*K wide for the audio
    arch); one unit's recompute (`layer_train_bytes` over its layers).
    The parts do not all live at once (the optimizer's run after the
    activations are freed), so the sum bounds the peak from above."""
    from repro_torch.models.lm import _pattern_moe_flags, lm_param_specs
    from repro_torch.nn.params import tree_leaves
    specs = tree_leaves(lm_param_specs(cfg))
    n = sum(math.prod(sp.shape) for sp in specs)
    largest = max(math.prod(sp.shape) for sp in specs)
    tokens = batch * seq
    width = cfg.vocab_size * (cfg.n_codebooks if cfg.frontend == "audio"
                              else 1)
    flags = _pattern_moe_flags(cfg)
    parts = {"params_grads_moments": 4 * 4 * n,
             "clip_scaled_copy": 4 * n,
             "adamw_temporaries_largest_leaf": 3 * 4 * largest,
             "unit_inputs": cfg.n_units * tokens * cfg.d_model * 2,
             "logits_and_grad": 2 * tokens * width * (2 + 4),
             "unit_recompute": sum(
                 layer_train_bytes(cfg, kind, flags[i], tokens)
                 for i, kind in enumerate(cfg.pattern))}
    parts["total"] = sum(parts.values())
    return parts


def check_flash_attention_bwd(torch, dev, shapes=FLASH_BWD_SHAPES) -> dict:
    """Phase 14a (and 17a at FLASH_ZOO_TRAIN_SHAPES): at each of
    `shapes`, the forward's o and
    log-sum-exp against the plain forward's (TOL_FLASH, TOL_FLASH_LSE),
    and the backward kernel (fed the kernel's o and lse) against its plain
    version fed the plain forward's, so a fault in the forward's store
    cannot cancel out (the plain versions one batch element at a time: at
    batch 4 its (4, 32, 4096, 4096) fp32 scores alone would take 8.6 GB a
    tensor; its time is the sum of those calls, each once), two launches
    bit-equal, and the times of the kernel, its plain version and SDPA's
    backward (timed only), with the forward's time with and without the
    log-sum-exp store at the same shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as kf
    from repro_torch.kernels import ref
    log_ptxas(kf.BWD_KERNEL, "flash_bwd")
    out = {}
    for name, shape, dt in shapes:
        b, h, s, dh = shape
        dtype = getattr(torch, dt)
        g = torch.Generator(device=dev)
        g.manual_seed(s + dh + 1)
        q, k, v, do = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for _ in range(4))
        o, lse = kf.flash_attention(q, k, v, with_lse=True)
        got = kf.flash_attention_bwd(q, k, v, o, do, lse)
        again = kf.flash_attention_bwd(q, k, v, o, do, lse)
        torch.cuda.synchronize()
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        del again
        errs, abs_errs, rels = [0.0] * 3, [0.0] * 3, [0.0] * 3
        o_err, lse_err, fwd_ok = 0.0, 0.0, True
        rtol, atol = TOL_FLASH[dt]
        plain_ms = 0.0
        for i in range(b):
            qi, ki, vi = (t[i:i + 1] for t in (q, k, v))
            if dt == "bfloat16":
                o_p, lse_p = ref.flash_attention_tiled_ref(
                    qi, ki, vi, kf.block_k(dh), with_lse=True)
            else:
                o_p, lse_p = ref.flash_attention_ref(qi, ki, vi,
                                                     with_lse=True)
            d_o = (o[i:i + 1].float() - o_p.float()).abs()
            d_lse = (lse[i:i + 1] - lse_p.float()).abs()
            o_err = max(o_err, float(d_o.max()))
            lse_err = max(lse_err, float(d_lse.max()))
            fwd_ok &= bool((d_o <= atol + rtol * o_p.float().abs()).all()
                           and (d_lse <= TOL_FLASH_LSE[1] + TOL_FLASH_LSE[0]
                                * lse_p.float().abs()).all())
            del d_o, d_lse
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want = ref.flash_attention_bwd_ref(qi, ki, vi, o_p, do[i:i + 1],
                                               lse_p)
            torch.cuda.synchronize()
            plain_ms += (time.perf_counter() - t0) * 1e3
            for j, (a, w) in enumerate(zip(got, want)):
                a, w = a[i:i + 1].float(), w.float()
                top = float(w.abs().max())
                err = float((a - w).abs().max())
                errs[j] = max(errs[j], err / top)
                abs_errs[j] = max(abs_errs[j], err)
                rels[j] = max(rels[j], float((a - w).norm() / w.norm()))
            del want, o_p, lse_p
        log(f"  flash_attention[{name}] {shape} {dt} forward vs plain: o "
            f"max_abs_err={o_err:.3e} (tol {atol:.4g} abs + {rtol:.4g} "
            f"rel), lse max_abs_err={lse_err:.3e} (tol {TOL_FLASH_LSE[1]} "
            f"abs + {TOL_FLASH_LSE[0]} rel)")
        if not fwd_ok:
            raise AssertionError(f"flash_attention[{name}]: o or lse "
                                 "disagrees with its plain version")
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        log(f"  flash_attention_bwd[{name}] {shape} {dt} vs plain: max abs "
            f"err / max |plain| (dq, dk, dv) {errs} (tol "
            f"{TOL_FLASH_BWD[dt]}), rel L2 {rels} (tol "
            f"{TOL_FLASH_BWD_REL_L2}); two launches bit-equal={same}")
        if not (finite and same and max(errs) <= TOL_FLASH_BWD[dt]
                and max(rels) <= TOL_FLASH_BWD_REL_L2):
            raise AssertionError(f"flash_attention_bwd[{name}] disagrees "
                                 f"with its plain version or itself")
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        fwd_flops = 4 * b * h * dh * s * (s + 1) / 2
        flops = 2.5 * fwd_flops
        n_bytes = 8 * q.numel() * q.element_size() + lse.numel() * 4
        t_ops = flops / (BF16_FLOPS if dt == "bfloat16" else FP32_FLOPS)
        t_bytes = n_bytes / HBM_BYTES_PER_S
        nums = {
            "shape": list(shape), "dtype": dt,
            "max_abs_err": max(abs_errs),
            "max_err_share_of_max_plain": max(errs),
            "rel_l2_err": max(rels),
            "forward_o_max_abs_err": o_err,
            "forward_lse_max_abs_err": lse_err,
            "bit_equal_twice": same,
            "ms": time_ms(torch, lambda: kf.flash_attention_bwd(
                q, k, v, o, do, lse), 5, warmup=1),
            "device_ms": device_kernel_ms(
                torch, lambda: kf.flash_attention_bwd(q, k, v, o, do, lse),
                2, "flash_bwd"),
            "plain_ms": plain_ms,
            "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                sdpa, (qg, kg, vg), do, retain_graph=True), 5, warmup=1),
            "library": "scaled_dot_product_attention backward",
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops,
            "forward_ms": time_ms(torch, lambda: kf.flash_attention(q, k, v),
                                  10, warmup=2),
            "forward_with_lse_ms": time_ms(
                torch, lambda: kf.flash_attention(q, k, v, with_lse=True),
                10, warmup=2),
            "forward_library_ms": time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True), 10, warmup=2),
            "forward_bound_ms": max(
                fwd_flops / (BF16_FLOPS if dt == "bfloat16" else FP32_FLOPS),
                4 * q.numel() * q.element_size() / HBM_BYTES_PER_S) * 1e3}
        log(f"  flash_attention_bwd[{name}]: {json.dumps(nums)}")
        out[name] = nums
        del q, k, v, do, o, lse, got, qg, kg, vg, sdpa
        gc.collect()
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def moe_drop_spy(shares: list):
    """While open, every MoE routing appends the share of its (token,
    slot) pairs that capacity drops (a 0-d tensor on the card, read after
    the run); the routing itself is unchanged."""
    from repro_torch.nn import moe as MOE
    real = MOE.route

    def spy(*args, **kwargs):
        r = real(*args, **kwargs)
        shares.append(1.0 - r["keep"].float().mean())
        return r

    MOE.route = spy
    try:
        yield
    finally:
        MOE.route = real


def lm_train_launcher(torch, dev, cfg, argv: list[str], label: str,
                      entry=None, profiled: bool = False) -> dict:
    """Phases 14b and 17b-17f: the LM training launcher on `argv`
    (`entry(cfg, args)`, the launcher's `train`, for a depth-cut cfg;
    `main(argv)` otherwise): finite losses, exactly one forward launch a
    attention layer a step (two under remat "full" or "dots": the
    recompute) and one backward launch, no other kernel, no plain version
    called; host ms a step, tokens/s over steps 1 on, the peak beside
    `lm_reckoning_bytes`, the share of (token, slot) pairs capacity
    dropped (MoE); with `profiled`, one more step under torch.profiler
    for the device-busy ms a step. Returns the numbers, the launch counts
    and the run (its parameters and AdamW state)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train as train_cli
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_lm_train_step

    args = train_cli.parse_args(argv)
    cut = "" if entry is None else f" (depth cut to {cfg.n_layers} layers)"
    log(f"phase {label}: python -m repro_torch.launch.train "
        f"{' '.join(argv)}{cut}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    plain, shares = {}, []
    t0 = time.perf_counter()
    with plain_version_spy(plain), moe_drop_spy(shares):
        if entry is None:
            run, _ = run_cli(train_cli.main, argv)
        else:
            run, _ = run_cli(lambda a: entry(cfg, train_cli.parse_args(a)),
                             argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_attn = cfg.pattern.count("a") * cfg.n_units
    again = 2 if cfg.remat in ("full", "dots") else 1
    want = {"flash_attention": again * n_attn * args.steps,
            "flash_attention_bwd": n_attn * args.steps}
    counts = read_launches(KERNELS, label, tuple(n for n, c in want.items()
                                                 if c))
    others = {n: c for n, c in counts.items() if c and n not in want}
    losses = run.losses
    if others or plain or any(counts[n] != c for n, c in want.items()):
        raise AssertionError(f"{label}: want {want} launches, no other "
                             f"kernel and no plain version: {counts}, plain "
                             f"{plain}")
    if len(losses) != args.steps or not np.isfinite(losses).all():
        raise AssertionError(f"{label} losses not finite: {losses}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = [t * 1e3 for t in run.times["step_s"]]
    tokens = args.batch * args.seq
    drop = float(torch.stack(shares).mean()) if shares else None
    reckon = lm_reckoning_bytes(cfg, args.batch, args.seq)
    nums = {"card": CARD, "arch": cfg.name, "layers": cfg.n_layers,
            "batch": args.batch, "seq": args.seq, "losses": losses,
            "wall_s_incl_init": wall,
            "host_ms_per_step": step_ms,
            "tokens_per_s_steps_1_on": (args.steps - 1) * tokens
            / sum(step_ms[1:]) * 1e3,
            "launches_per_step": {n: c // args.steps
                                  for n, c in want.items()},
            "moe_dropped_pair_share": drop,
            "peak_bytes": peak, "reckoning_bytes": reckon,
            "peak_over_reckoning": peak / reckon["total"]}
    if profiled:
        step = build_lm_train_step(cfg, adamw(args.lr))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(
            cfg, args.batch, args.seq, args.steps, 0).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, m = step(run.params, run.state, batch, args.steps)
            nums["aux_step_profiled"] = float(m["aux"])
            torch.cuda.synchronize()
        nums["profiled_step_host_ms"] = (time.perf_counter() - t0) * 1e3
        events = device_events(prof)
        busy = sum(t for _, t in events) / 1e3
        top = sorted(events, key=lambda e: -e[1])[:8]
        nums.update(
            profiled_step_device_busy_ms=busy or None,
            profiled_step_flash_fwd_device_ms=sum(
                t for n, t in events if "flash_attention_kernel" in n) / 1e3,
            profiled_step_flash_bwd_device_ms=sum(
                t for n, t in events if "flash_bwd" in n) / 1e3,
            top_device_events_ms=[(n[:96], t / 1e3) for n, t in top])
        del batch, step, prof
    log(f"{label} numbers: {json.dumps(nums)}")
    return {"numbers": nums, "launches": counts, "run": run}


def lm_grads(torch, params, batch, cfg, plain: bool):
    """(loss, gradient leaves) of lm_loss at `params`; `plain` puts the
    layers' full_attention (torch ops, differentiated by autograd) in
    place of the flash-attention op, under the same remat."""
    from repro_torch.kernels import ops
    from repro_torch.models.lm import lm_loss
    from repro_torch.nn import layers as L
    from repro_torch.nn.params import tree_leaves, tree_map
    real = ops.flash_attention
    if plain:
        ops.flash_attention = lambda q, k, v, causal=True: \
            L.full_attention(q, k, v)
    try:
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, _ = lm_loss(leaves, batch, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    finally:
        ops.flash_attention = real
    return float(loss.detach()), grads


def lm_train_plain(torch, dev, cfg, label: str = "14c") -> dict:
    """Phase 14c (and 17c): step 0's loss and gradients at batch 1 through the
    kernels, twice, and through the plain attention, in the config's bf16
    compute and again in fp32 (TOL_LM_TRAIN); every unit's wq, wk and wv
    gradient non-zero; the two kernel runs bit-equal; the plain runs
    launch no kernel."""
    import dataclasses

    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.kernels import KERNELS, build_all
    from repro_torch.launch import train as train_cli
    from repro_torch.models.lm import init_lm_params

    params = init_lm_params(cfg, train_cli.PARAM_SEED, dev)
    names = ["/".join(p) for p in leaf_paths(params)]
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(
        cfg, 1, LM_TRAIN_SEQ, 0, 0).items()}
    out = {}
    reset_launches(KERNELS)
    for dt in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, compute_dtype=dt)
        t0 = time.perf_counter()
        loss, grads = lm_grads(torch, params, batch, c, plain=False)
        torch.cuda.synchronize()
        kernel_ms = (time.perf_counter() - t0) * 1e3
        unit_zero = {n: int((g.flatten(1).abs().amax(1) == 0).sum())
                     for n, g in zip(names, grads)
                     if n.split("/")[-1] in ("wq", "wk", "wv")}
        before = {k.name: k.launches for k in KERNELS}
        t0 = time.perf_counter()
        p_loss, p_grads = lm_grads(torch, params, batch, c, plain=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if any(k.launches != before[k.name] for k in KERNELS):
            raise AssertionError(f"{label}: the plain path launched a kernel")
        rel = {n: float((a.float() - b.float()).norm()
                        / b.float().norm().clamp_min(1e-30))
               for n, a, b in zip(names, grads, p_grads)}
        del p_grads
        loss2, grads2 = lm_grads(torch, params, batch, c, plain=False)
        same = loss2 == loss and all(
            torch.equal(a, b) for a, b in zip(grads, grads2))
        del grads2
        tol_loss, tol_grad = TOL_LM_TRAIN[dt]
        loss_rel = abs(loss - p_loss) / abs(p_loss)
        worst = max(rel, key=rel.get)
        nums = {"dtype": dt, "loss": loss, "plain_loss": p_loss,
                "loss_rel_err": loss_rel, "grad_rel_l2": rel,
                "worst_leaf": worst, "attn_units_with_zero_grad": unit_zero,
                "kernel_runs_bit_equal": same, "kernel_host_ms": kernel_ms,
                "plain_host_ms": plain_ms,
                "finite": all(bool(torch.isfinite(g).all()) for g in grads)}
        log(f"{label} [{dt}]: loss {loss} vs plain {p_loss} (rel "
            f"{loss_rel:.3e},"
            f" tol {tol_loss}); worst gradient {worst} rel L2 "
            f"{rel[worst]:.3e} (tol {tol_grad}); {json.dumps(nums)}")
        if not (nums["finite"] and same and loss_rel <= tol_loss
                and rel[worst] <= tol_grad and not any(unit_zero.values())):
            raise AssertionError(f"{label} [{dt}]: the kernel path and the "
                                 "plain attention disagree, a kernel run "
                                 "is not repeatable, or an attention "
                                 "weight got no gradient")
        out[dt] = nums
        del grads
    counts = read_launches(KERNELS, "lm_train_plain_check",
                           ("flash_attention", "flash_attention_bwd"))
    want = {"flash_attention": 2 * 2 * 2 * cfg.n_layers,
            "flash_attention_bwd": 2 * 2 * cfg.n_layers}
    if any(counts[n] != c for n, c in want.items()):
        raise AssertionError(f"{label}: want {want} launches (two kernel runs "
                             f"in each dtype), got {counts}")
    del params
    return {"numbers": out, "launches": counts}


def leaf_paths(tree, path=()):
    """The key paths of a tree's leaves, in tree order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaf_paths(v, path + (k,))]
    return [path]


def lm_train_accum(torch, dev, cfg, run) -> dict:
    """Phase 14d: build_lm_train_step(accum_steps=2) on a batch of
    2 * LM_TRAIN_BATCH from 14b's parameters and state: a finite loss,
    twice 14b's launches, the peak beside 14b's reckoning plus one fp32
    gradient sum."""
    import math

    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.kernels import KERNELS, build_all
    from repro_torch.optim import adamw
    from repro_torch.train.steps import build_lm_train_step

    step = build_lm_train_step(cfg, adamw(3e-4), accum_steps=2)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(
        cfg, 2 * LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS + 1, 0).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    t0 = time.perf_counter()
    _, _, m = step(run.params, run.state, batch, LM_TRAIN_STEPS + 1)
    loss = float(m["loss"])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches(KERNELS, "lm_train_accum",
                           ("flash_attention", "flash_attention_bwd"))
    want = {"flash_attention": 4 * cfg.n_layers,
            "flash_attention_bwd": 2 * cfg.n_layers}
    if any(counts[n] != c for n, c in want.items()) or not math.isfinite(
            loss):
        raise AssertionError(f"14d: loss {loss}, launches {counts}, want "
                             f"{want}")
    reckon = lm_reckoning_bytes(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ)
    grad_sum = 4 * cfg.param_count_estimate()
    nums = {"loss": loss, "host_ms": host_ms,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "reckoning_bytes": reckon["total"] + grad_sum,
            "grad_sum_bytes": grad_sum,
            "tokens_per_s": 2 * LM_TRAIN_BATCH * LM_TRAIN_SEQ / host_ms * 1e3}
    log(f"14d numbers: {json.dumps(nums)}")
    return {"numbers": nums, "launches": counts}


def lm_train_resilience(torch, base: str) -> dict:
    """Phase 14e: the LM launcher at --smoke on the card, LM_SMOKE_STEPS
    steps: a plain run; the same run cut by a checkpoint at half way and
    resumed by a second call; --chaos for each of CHAOS_SEEDS. Each must
    give the plain run's losses and final parameter and moment bits."""
    from repro_torch.kernels import KERNELS, build_all
    from repro_torch.launch import train as train_cli

    def argv(name, *extra):
        return ["--arch", LM_ARCH, "--smoke", "--log-every", "100",
                "--ckpt-dir", os.path.join(base, name), *extra]

    reset_launches(KERNELS)
    steps = str(LM_SMOKE_STEPS)
    log(f"phase 14e: python -m repro_torch.launch.train "
        f"{' '.join(argv('plain', '--steps', steps))}")
    plain = train_cli.main(argv("plain", "--steps", steps))
    want = (plain.losses, tree_checksums(torch, plain.params),
            tree_checksums(torch, plain.state))
    half = str(LM_SMOKE_STEPS // 2)
    first = train_cli.main(argv("resume", "--steps", half, "--ckpt-every",
                                half))
    resumed = train_cli.main(argv("resume", "--steps", steps, "--resume"))
    runs = {"resume": (first.losses + resumed.losses,
                       tree_checksums(torch, resumed.params),
                       tree_checksums(torch, resumed.state))}
    for seed in CHAOS_SEEDS:
        res, text = run_cli(train_cli.main, argv(
            f"chaos{seed}", "--steps", steps, "--ckpt-every", "2",
            "--chaos", "--chaos-seed", str(seed)))
        fired = next((ln for ln in text.splitlines()
                      if ln.startswith("chaos: fired ")), "")
        if fired in ("", "chaos: fired nothing"):
            raise AssertionError(f"14e chaos seed {seed}: no fault fired")
        runs[f"chaos{seed}"] = (res.losses, tree_checksums(torch, res.params),
                                tree_checksums(torch, res.state))
    counts = read_launches(KERNELS, "lm_train_smoke",
                           ("flash_attention", "flash_attention_bwd"))
    equal = {name: r == want for name, r in runs.items()}
    log(f"14e: plain losses {plain.losses}; bit-equal to the plain run "
        f"(losses, parameters, moments): {equal}")
    if not all(equal.values()):
        raise AssertionError("14e: a resumed or chaos run differs from the "
                             "plain run")
    return {"launches": counts, "equal": equal}


def lm_train_phases(torch, dev, cfg) -> dict:
    """Phases 14a-14e (LM training on full-width stablelm-1.6b). Returns
    the backward kernel's numbers, the forward's at the train shape and
    each path's launches."""
    import shutil
    import tempfile
    log("phase 14a: flash_attention_bwd vs plain at " + ", ".join(
        f"{n} {shape} {dt}" for n, shape, dt in FLASH_BWD_SHAPES))
    bwd = check_flash_attention_bwd(torch, dev)
    log_peak(torch, "phase 14a")
    free_device(torch)
    paths = {}
    res = lm_train_launcher(torch, dev, cfg, LM_TRAIN_ARGV, "14b",
                            profiled=True)
    paths["lm_train"] = res["launches"]
    losses_14b = res["numbers"]["losses"]
    peak_14b = res["numbers"]["peak_bytes"]
    # 14a's per-kernel trace, late in this process, can come back partial
    # (as 9a's does): the kernels line takes 14b's profiled step, whose 24
    # launches run at 14a's bf16 shape, and keeps 14a's beside it
    nb = bwd["train_4k"]
    step_ms = res["numbers"]["profiled_step_flash_bwd_device_ms"]
    if step_ms:
        nb["device_ms_14a_profiler"] = nb["device_ms"]
        nb["device_ms"] = step_ms / cfg.n_layers
        nb["device_ms_from"] = "14b profiled step, per launch"
    log_peak(torch, "phase 14b")
    log("phase 14c: step 0 at batch 1 through the kernels (twice) and "
        "through full_attention, bf16 and fp32 compute")
    paths["lm_train_plain_check"] = lm_train_plain(torch, dev, cfg)[
        "launches"]
    log_peak(torch, "phase 14c")
    log(f"phase 14d: build_lm_train_step(accum_steps=2) on a batch of "
        f"{2 * LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} from 14b's state")
    paths["lm_train_accum"] = lm_train_accum(torch, dev, cfg, res["run"])[
        "launches"]
    del res
    free_device(torch)
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    base = tempfile.mkdtemp(prefix="chip_smoke_lm_",
                            dir=os.path.join(ROOT, "runs"))
    try:
        paths["lm_train_smoke"] = lm_train_resilience(torch, base)["launches"]
    finally:
        shutil.rmtree(base, ignore_errors=True)
    free_device(torch)
    return {"bwd": bwd, "paths": paths, "losses_14b": losses_14b,
            "peak_14b": peak_14b}


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

    from repro_torch.kernels import KERNELS, build_all
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
    from repro_torch.kernels import KERNELS, build_all
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

    from repro_torch.kernels import KERNELS, build_all
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
    from repro_torch.kernels import KERNELS, build_all
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
    from repro_torch.kernels import KERNELS, build_all
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


@contextlib.contextmanager
def plain_version_spy(calls: dict):
    """While open, every call of the lookups', the interaction's, the
    update's or attention's plain version (what a wrapper runs for a CPU
    tensor) adds one to calls[its name]; the calls themselves are
    unchanged."""
    from repro_torch.kernels import ref
    names = ("embedding_bag_ref", "dedup_embedding_bag_ref",
             "dot_interaction_ref", "fused_bag_backward_adagrad_ref",
             "flash_attention_ref", "flash_attention_tiled_ref",
             "flash_attention_bwd_ref")
    real = {n: getattr(ref, n) for n in names}

    def spy(name):
        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return real[name](*args, **kwargs)
        return call

    for n in names:
        setattr(ref, n, spy(n))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(ref, n, fn)


def suite_points() -> list:
    """Phase 15's (phase, name, config, batch) in order, each point once:
    Fig. 10 (15a), the default point at each of Fig. 11's batches (15b),
    Fig. 12 (15c) and Fig. 13 (15d) at SUITE_BATCH, then the default point
    with the concat interaction (15d). A point an earlier sweep holds (the
    default point at SUITE_BATCH, in 15b) is not trained again."""
    from repro_torch.core import design_space as ds
    default = ds.test_suite_config()
    points = ([("15a", n, c, SUITE_BATCH) for n, c in ds.sweep_fig10()]
              + [("15b", f"batch{b}", default, b)
                 for b in ds.sweep_fig11_batch()]
              + [("15c", n, c, SUITE_BATCH)
                 for n, c in ds.sweep_fig12_hash()]
              + [("15d", n, c, SUITE_BATCH)
                 for n, c in ds.sweep_fig13_mlp()]
              + [("15d", "cat", ds.test_suite_config(interaction="cat"),
                  SUITE_BATCH)])
    seen, out = set(), []
    for phase, name, cfg, batch in points:
        if (cfg, batch) not in seen:
            seen.add((cfg, batch))
            out.append((phase, name, cfg, batch))
    return out


def suite_placements(torch) -> dict:
    """Phase 15c's planner: `recommend_placement` for each Fig. 12 point on
    one host, its budget the card's memory less SUITE_HEADROOM_BYTES.
    Returns {point: whether its rows and accumulators fit the card}."""
    from repro_torch.core import design_space as ds
    from repro_torch.launch.analysis import recommend_placement
    budget = torch.cuda.mem_get_info()[1] - SUITE_HEADROOM_BYTES
    fits = {}
    for name, cfg in ds.sweep_fig12_hash():
        rec = recommend_placement(cfg.hash_sizes, cfg.mean_lookups,
                                  cfg.embed_dim, SUITE_BATCH, cfg.truncation,
                                  1, budget)
        fits[name] = rec["fits_one_host"]
        log(f"  {name}: recommend_placement pick {rec['pick']}, "
            f"fits_one_host {rec['fits_one_host']}, "
            f"{sum(t['bytes'] for t in rec['per_table']):.0f} bytes of rows "
            f"and accumulators, budget {budget} bytes (the card's "
            f"{budget + SUITE_HEADROOM_BYTES} less {SUITE_HEADROOM_BYTES})")
    return fits


def suite_kernel_shapes(torch, dev) -> dict:
    """Phase 15: the path's kernels against their plain versions, timed, at
    shapes only the suite reaches: dot_interaction at F = 129 (Fig. 10's
    128 tables, B = 256) and at Fig. 11's largest batch (8,192, F = 33),
    embedding_bag over 128 tables of 100,000 rows, and the fused update on
    Fig. 12's 10,000-row tables, whose hot rows make its longest runs."""
    from repro_torch.core import design_space as ds
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.kernels.sparse_plan import build_sparse_plan
    wide = dict(ds.sweep_fig10())["dense64_sparse128"]
    d, lk = wide.embed_dim, wide.truncation
    default_f = ds.test_suite_config().n_sparse_features
    out = {"dot_interaction": {
        "f129": check_dot_interaction(torch, dev, SUITE_BATCH,
                                      wide.n_sparse_features + 1, d),
        "b8192": check_dot_interaction(torch, dev,
                                       ds.sweep_fig11_batch()[-1],
                                       default_f + 1, d)}}
    rows = EmbeddingBagCollection.build(
        wide, n_shards=1, strategy="replicated").plan.total_rows
    out["embedding_bag"] = {"128_tables": check_embedding_bag(
        torch, dev, rows, d, SUITE_BATCH * wide.n_sparse_features, lk)}
    free_device(torch)
    cfg = dict(ds.sweep_fig12_hash())["hash10000"]
    ebc = EmbeddingBagCollection.build(cfg, n_shards=1,
                                       strategy="replicated")
    g = torch.Generator(device=dev)
    g.manual_seed(19)
    r_rows = ebc.plan.total_rows
    table = torch.empty((r_rows, d), device=dev).normal_(generator=g)
    accum = torch.rand((r_rows,), generator=g, device=dev)
    raw = make_dlrm_batch(cfg, SUITE_BATCH, 0)
    idx = torch.as_tensor(ebc.offset_indices(raw["idx"]), device=dev)
    b, f, _ = idx.shape
    plan = build_sparse_plan(idx)
    pooled = torch.randn((b * f, d), generator=g, device=dev) * 0.01
    log(f"  the fused update on {cfg.name} (R={r_rows}, batch {b})")
    out["fused_bag_backward_adagrad"] = {"hash10000": check_fused_update(
        torch, table, accum, plan, pooled, int((idx >= 0).sum()))}
    del table, accum
    return out


def train_suite_point(torch, dev, cfg, batch_size: int) -> dict:
    """One point of phase 15: `cfg` at full width on the replicated layout,
    parameters from the launcher's seed, SUITE_STEPS steps of
    `build_dlrm_train_step(sparse_apply="sparse")` on batches of
    `make_dlrm_batch` made before the first step. Step 0 runs under
    FlopCounterMode and torch.profiler and is held to the plain versions
    on the card (`checked_step`); steps 1 on are timed by the host clock.
    Every step must launch embedding_bag, the fused update and (dot)
    dot_interaction once, no other kernel, and call no plain version; the
    losses must be finite. Returns the point's numbers and launches."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.data.synthetic import make_dlrm_batch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch.analysis import (embedding_forward_traffic,
                                             sparse_backward_traffic)
    from repro_torch.launch.roofline import H100, roofline_terms
    from repro_torch.launch.train import PARAM_SEED, batch_to_device
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_dlrm_train_step, dlrm_init_state

    t0 = time.perf_counter()
    ebc = EmbeddingBagCollection.build(cfg, n_shards=1,
                                       strategy="replicated")
    batches = []
    for step in range(SUITE_STEPS):
        raw = make_dlrm_batch(cfg, batch_size, step)
        batches.append(batch_to_device(
            {**raw, "idx": ebc.offset_indices(raw["idx"])}, dev))
    batch_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    params = init_dlrm_params(cfg, ebc, PARAM_SEED, dev)
    opt = adagrad(0.01)
    state = dlrm_init_state(ebc, opt, params)
    step_fn = build_dlrm_train_step(cfg, ebc, opt, SPARSE_LR, SPARSE_EPS,
                                    sparse_apply="sparse")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    want = {k.name: 0 for k in KERNELS}
    want.update(embedding_bag=1, fused_bag_backward_adagrad=1,
                dot_interaction=int(cfg.interaction == "dot"))
    plain, counted, launches = {}, {}, {k.name: 0 for k in KERNELS}

    def kernel_step(params, state, batch, step):
        reset_launches(KERNELS)
        with plain_version_spy(plain):
            out = step_fn(params, state, batch, step)
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in KERNELS}
        if got != want or plain:
            raise AssertionError(f"{cfg.name} step {step}: launches {got}, "
                                 f"want {want}; plain versions {plain}")
        for k, v in got.items():
            launches[k] += v
        return out

    def counted_step(*args):
        with FlopCounterMode(display=False) as fc, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            out = kernel_step(*args)
        counted["flops"] = fc.get_total_flops()
        counted["device_us"] = sum(t for _, t in device_events(prof))
        return out

    params, state, metrics, errs, n_unique = checked_step(
        torch, counted_step, params, state, batches[0], opt,
        cfg.interaction)
    losses, host_s = [float(metrics["loss"])], []
    for step in range(1, SUITE_STEPS):
        t1 = time.perf_counter()
        params, state, metrics = kernel_step(params, state, batches[step],
                                             step)
        losses.append(float(metrics["loss"]))
        host_s.append(time.perf_counter() - t1)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{cfg.name}: non-finite loss {losses}")
    f, lk, d = cfg.n_sparse_features, cfg.truncation, cfg.embed_dim
    hbm = (embedding_forward_traffic(batch_size, f, lk, d,
                                     n_unique)["legacy_bytes"]
           + sparse_backward_traffic(batch_size, f, lk, d)["fused_bytes"])
    flops = counted["flops"]
    out = {"config": cfg.name, "batch": batch_size, "losses": losses,
           "examples_per_s": batch_size * len(host_s) / sum(host_s),
           "host_ms_per_step": sum(host_s) / len(host_s) * 1e3,
           "device_busy_ms_step0": (counted["device_us"] / 1e3
                                    if counted["device_us"] else None),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "unique_rows_step0": n_unique, "step0_max_abs_err": errs,
           "flops_step0": flops,
           "roofline": roofline_terms(flops, hbm, 0.0, 1, flops, hw=H100),
           "batches_s": batch_s, "setup_s": setup_s,
           "wall_s": time.perf_counter() - t0, "launches": launches}
    out["roofline"]["bytes_hbm"] = hbm
    return out


def suite_phase(torch, dev) -> dict:
    """Phases 15a-15d: every point of `suite_points` trained by
    `train_suite_point`, but for a Fig. 12 point `recommend_placement`
    says does not fit the card, which is only printed. Logs each point's
    numbers and each phase's wall seconds; returns each phase's launch
    counts, summed over its points."""
    from repro_torch.kernels import KERNELS
    paths, current, t_phase, fits = {}, None, 0.0, {}

    def phase_done():
        if current is not None:
            log(f"phase {current} wall: "
                f"{time.perf_counter() - t_phase:.1f} s")

    for phase, name, cfg, batch in suite_points():
        if phase != current:
            phase_done()
            current, t_phase = phase, time.perf_counter()
            log(f"phase {phase}: {SUITE_PHASES[phase]}, {SUITE_STEPS} "
                f"steps a point")
            paths[f"suite_{phase}"] = {k.name: 0 for k in KERNELS}
            if phase == "15c":
                fits = suite_placements(torch)
        if phase == "15c" and not fits[name]:
            log(f"  {name}: planned only; recommend_placement says its rows "
                f"and accumulators do not fit the card")
            continue
        res = train_suite_point(torch, dev, cfg, batch)
        for k, v in res.pop("launches").items():
            paths[f"suite_{phase}"][k] += v
        log(f"  {phase} {name}: {json.dumps(res)}")
        free_device(torch)
    phase_done()
    return paths


def zoo_reckoning_bytes(cfg, seq: int, plain_attention: bool = False
                        ) -> dict:
    """Phase 16's device memory by the reckoning (bytes): the fp32
    parameters; the largest layer's weights cast to bf16 at use; the
    caches; the bf16 logits of every position; the largest layer's
    transient activations (attention: q, k, v, the repeated K/V, the
    kernel's transposed copies and its output; a Mamba-2 mixer: in_proj's
    output, three conv-width tensors and the chunk products' fp32 and bf16
    (h, seq, chunk) tensors; MoE: the expert slots' inputs and three (e_pad,
    cap, f) products, and the routing's (seq * k, e) counts; MLP: three
    (seq, f) products); with `plain_attention`, full_attention's fp32
    scores and softmax and bf16 probabilities."""
    from repro_torch.models.lm import (_block_specs, _pattern_moe_flags,
                                       lm_param_specs)
    from repro_torch.nn.mamba2 import mamba_dims
    from repro_torch.nn.moe import _capacity
    from repro_torch.nn.params import param_count
    flags = _pattern_moe_flags(cfg)
    kinds = set(zip(cfg.pattern, flags))
    layer = max(param_count(_block_specs(cfg, kind, moe)) for kind, moe in
                kinds)
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    trans = []
    caches = 0
    n_attn = cfg.pattern.count("a") * cfg.n_units
    if n_attn:
        trans.append(seq * dh * 2 * (h + 2 * kv + 6 * h))
        per = 1 + 4 / dh if cfg.kv_cache_dtype == "int8" else 2
        caches += int(n_attn * 2 * (seq + ZOO_DECODE) * kv * dh * per)
    if "m" in cfg.pattern:
        m = mamba_dims(cfg)
        chunk = min(cfg.ssm_chunk, seq)
        trans.append(2 * seq * (m["d_in_proj"] + 3 * m["conv_dim"])
                     + 12 * m["n_heads"] * seq * chunk)
        caches += cfg.pattern.count("m") * cfg.n_units * (
            2 * (m["d_conv"] - 1) * m["conv_dim"]
            + 4 * m["n_heads"] * m["headdim"] * m["d_state"])
    if cfg.n_experts:
        e_pad = cfg.n_experts + cfg.expert_pad
        cap = _capacity(seq, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
        trans.append(2 * e_pad * cap * (cfg.d_model + 3 * cfg.d_ff)
                     + 16 * seq * cfg.top_k * cfg.n_experts)
    if cfg.d_ff and not all(flags):
        trans.append(6 * seq * cfg.d_ff)
    parts = {"params_fp32": 4 * param_count(lm_param_specs(cfg)),
             "largest_layer_bf16_casts": 2 * layer,
             "caches": caches,
             "logits_bf16": 2 * seq * cfg.vocab_size,
             "largest_layer_transient": max(trans)}
    if plain_attention:
        parts["full_attention_scores"] = 10 * h * seq * seq
    parts["total"] = sum(parts.values())
    return parts


@contextlib.contextmanager
def attention_spy(records: list):
    """While open, every call of the LM's attention layer appends (mode,
    its input, its output) to `records`; the calls are unchanged."""
    from repro_torch.nn import layers
    real = layers.attention

    def spy(p, x, cfg, positions, **kw):
        y, cache = real(p, x, cfg, positions, **kw)
        records.append((kw.get("mode", "train"), x.detach(), y.detach()))
        return y, cache

    layers.attention = spy
    try:
        yield
    finally:
        layers.attention = real


def zoo_params(torch, dev, cfg) -> dict:
    """The arch's fp32 parameters from a torch.Generator seeded
    ZOO_PARAM_SEED on the card, their count checked."""
    from repro_torch.models.lm import init_lm_params
    from repro_torch.nn.params import tree_leaves
    t0 = time.perf_counter()
    params = init_lm_params(cfg, ZOO_PARAM_SEED, dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    log(f"  {cfg.name}: {n} parameters (fp32, {4 * n / 1e9:.2f} GB) drawn "
        f"in {time.perf_counter() - t0:.2f}s")
    if n != cfg.param_count_estimate():
        raise AssertionError(f"{n} parameters, want "
                             f"{cfg.param_count_estimate()}")
    return params


def zoo_generate(torch, cfg, params, tokens, n_decode: int, *,
                 want_flash: int, label: str, feed=None, conv_dtype=None,
                 profiled: bool = False) -> dict:
    """prefill_step on `tokens` (1, S), or on a batch dict of S positions
    (the frontends' embeddings), into fresh caches of S + n_decode
    positions (with `conv_dtype`, each mixer's bf16 conv cache swapped for
    zeros of that dtype), then `n_decode` decode_steps, each fed the
    previous step's argmax (greedy; the audio arch's K codebooks each
    take their own) or, with `feed`, feed[i] (teacher-forced). Exactly
    `want_flash` flash_attention launches and no other kernel, no plain
    version called, finite logits of the right shape. With `profiled`, one
    more prefill under torch.profiler (the caches are rewritten). Returns
    the prefill's last logits and each decode step's (fp32, on the card),
    the tokens fed, host ms, the peak and the launch counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import KERNELS
    from repro_torch.models.lm import decode_step, init_caches, prefill_step
    batch = tokens if isinstance(tokens, dict) else {"tokens": tokens}
    s = sum(batch[k].shape[1] for k in ("embeds", "tokens") if k in batch)
    dev = next(iter(batch.values())).device
    shape = (1, cfg.n_codebooks, cfg.vocab_size) if cfg.frontend == "audio" \
        else (1, cfg.vocab_size)
    caches = init_caches(cfg, 1, s + n_decode + 1, dev)
    if conv_dtype is not None:
        for c in caches.values():
            if "conv" in c:
                c["conv"] = torch.zeros_like(c["conv"], dtype=conv_dtype)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    plain: dict = {}
    with plain_version_spy(plain):
        t0 = time.perf_counter()
        last, _ = prefill_step(params, batch, caches, cfg)
        last = last.float()
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        tok, fed, logits, decode_ms = last.argmax(-1), [], [], []
        for i in range(n_decode):
            if feed is not None:
                tok = feed[i].reshape(1)
            t0 = time.perf_counter()
            lg, _ = decode_step(params, tok[:, None], caches, s + i, cfg)
            lg = lg.float()
            fed.append(int(tok) if tok.numel() == 1 else tok[0].tolist())
            tok = lg.argmax(-1)
            tok.tolist()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg)
    counts = read_launches(KERNELS, label,
                           ("flash_attention",) if want_flash else ())
    others = {n: c for n, c in counts.items()
              if c and n != "flash_attention"}
    if counts["flash_attention"] != want_flash or others or plain:
        raise AssertionError(f"{label}: want {want_flash} flash_attention "
                             f"launches and no other kernel or plain "
                             f"version: {counts}, plain {plain}")
    for i, lg in enumerate([last] + logits):
        if lg.shape != shape or not bool(
                torch.isfinite(lg).all()):
            raise AssertionError(f"{label}: logits {i} of shape "
                                 f"{tuple(lg.shape)} not finite")
    out = {"last": last, "logits": logits, "fed": fed,
           "prefill_host_ms": prefill_ms, "decode_host_ms": decode_ms,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": counts}
    if profiled:
        # one more decode step at the next position, then the prefill
        # again (rewriting the caches), each under the profiler
        for what, fn in (
                ("decode", lambda: decode_step(params, tok[:, None], caches,
                                               s + n_decode, cfg)),
                ("prefill", lambda: prefill_step(params, batch, caches,
                                                 cfg))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            host = (time.perf_counter() - t0) * 1e3
            events = device_events(prof)
            busy = sum(t for _, t in events) / 1e3
            out[f"{what}_profiled_host_ms"] = host
            out[f"{what}_device_busy_ms"] = busy or None
            out[f"{what}_device_launches"] = sum(
                e.count for e in prof.key_averages()
                if e.device_type != DeviceType.CPU) or None
            out[f"{what}_top_device_events_ms"] = [
                (n[:96], t / 1e3)
                for n, t in sorted(events, key=lambda e: -e[1])[:6]]
        flash = sum(t for n, t in events if "flash_attention" in n) / 1e3
        out["prefill_flash_device_ms"] = flash if busy else None
    del caches
    return out


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def logits_held(got, want, label: str) -> dict:
    """`got` against `want` (1, V): relative L2 error within TOL_LM_REL_L2,
    largest difference within TOL_LM_ABS, the same argmax."""
    err = float((got - want).abs().max())
    rel = rel_l2(got, want)
    agree = int(got.argmax()) == int(want.argmax())
    log(f"  {label}: rel_l2_err={rel:.4g} (tol {TOL_LM_REL_L2}) "
        f"max_abs_err={err:.4g} (tol {TOL_LM_ABS}) argmax agrees={agree} "
        f"(max |logit| {float(want.abs().max()):.4g})")
    if not (rel <= TOL_LM_REL_L2 and err <= TOL_LM_ABS and agree):
        raise AssertionError(f"{label}: the two paths disagree")
    return {"rel_l2_err": rel, "max_abs_err": err, "argmax_agrees": agree}


def zoo_summary(run: dict) -> dict:
    """The numbers of a `zoo_generate` run worth a log line."""
    ms = run["decode_host_ms"]
    out = {k: run[k] for k in ("prefill_host_ms", "peak_bytes")}
    if ms:
        out["decode_host_ms_per_token"] = sum(ms[1:]) / max(len(ms) - 1, 1)
        out["decode_first_host_ms"] = ms[0]
        out["generated"] = run["fed"]
    for what in ("prefill", "decode"):
        for k in ("profiled_host_ms", "device_busy_ms", "device_launches",
                  "top_device_events_ms"):
            if f"{what}_{k}" in run:
                out[f"{what}_{k}"] = run[f"{what}_{k}"]
    if "prefill_flash_device_ms" in run:
        out["prefill_flash_device_ms"] = run["prefill_flash_device_ms"]
    return out


def zoo_moe(torch, dev) -> dict:
    """Phase 16a: the bf16 kernel at granite-moe-3b-a800m's prefill shape
    against its plain version, timed; then the model at full width, bf16:
    the prefill through the kernel (one launch a layer) and ZOO_DECODE
    greedy decode steps, then the same prefill through full_attention
    (attn_block_q = ZOO_PROMPT, no launch), its last logits held to the
    kernel's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    log(f"phase 16a: flash_attention vs plain at {MOE_ARCH}'s prefill "
        f"shape {FLASH_GRANITE_SHAPE} bfloat16")
    flash = check_flash_shape(torch, dev, "granite_moe", FLASH_GRANITE_SHAPE,
                              "bfloat16")
    cfg = get_config(MOE_ARCH)
    log(f"phase 16a: {MOE_ARCH} at full width ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_experts} (+{cfg.expert_pad} padded) experts "
        f"top-{cfg.top_k}, GQA {cfg.n_heads}/{cfg.n_kv_heads}, dh "
        f"{cfg.d_head}), bf16: prefill_step on make_lm_batch(cfg, 1, "
        f"{ZOO_PROMPT}) through the kernel, {ZOO_DECODE} greedy "
        f"decode_steps, then the prefill through full_attention")
    params = zoo_params(torch, dev, cfg)
    tokens = torch.from_numpy(
        make_lm_batch(cfg, 1, ZOO_PROMPT)["tokens"]).to(dev)
    run = zoo_generate(torch, cfg, params, tokens, ZOO_DECODE,
                       want_flash=cfg.n_layers, label="16a kernel prefill",
                       profiled=True)
    plain = zoo_generate(torch, dataclasses.replace(
        cfg, attn_block_q=ZOO_PROMPT), params, tokens, 0, want_flash=0,
        label="16a full_attention prefill")
    held = logits_held(run["last"], plain["last"],
                       "16a kernel vs full_attention, last logits")
    nums = {"card": CARD, **zoo_summary(run), **held,
            "plain_prefill_host_ms": plain["prefill_host_ms"],
            "plain_peak_bytes": plain["peak_bytes"],
            "reckoning_bytes": zoo_reckoning_bytes(cfg, ZOO_PROMPT),
            "plain_reckoning_bytes": zoo_reckoning_bytes(
                cfg, ZOO_PROMPT, plain_attention=True)}
    log(f"16a numbers: {json.dumps(nums)}")
    return {"numbers": nums, "flash": flash, "oracle": zoo_oracle(run),
            "paths": {"zoo_moe_prefill": run["launches"],
                      "zoo_moe_plain": plain["launches"]}}


def zoo_oracle(run: dict) -> dict:
    """Phase 20's oracle from a `zoo_generate` run: the prefill's last
    logits, each decode step's and the tokens fed, on the host."""
    return {"last": run["last"].cpu(),
            "logits": [lg.cpu() for lg in run["logits"]],
            "fed": list(run["fed"])}


def zoo_ssm(torch, dev) -> dict:
    """Phase 16b: mamba2-780m at full width, bf16: prefill and ZOO_DECODE
    greedy decode steps, no kernel launch; then, in fp32 compute, the
    prefill and LM_SERVE_MESH_DECODE decode steps fed the bf16 run's
    tokens (phase 20d's oracle, returned), and the same on weights
    perturbed by SSM_PERTURB (its distance a step printed: 20d's
    witness); at SSM_RECUR_LAYERS layers the
    one-shot prefill's last logits against a SSM_RECUR_PREFIX-token
    prefill and the rest decoded one token at a time, with an fp32 conv
    cache (held within TOL_SSM_RECUR, the same argmax) and with the
    reference's bf16 one (printed)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.nn.params import tree_map
    cfg = get_config(SSM_ARCH)
    log(f"phase 16b: {SSM_ARCH} at full width ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, state {cfg.ssm_state}, chunk {cfg.ssm_chunk}), bf16: "
        f"prefill_step on make_lm_batch(cfg, 1, {ZOO_PROMPT}), {ZOO_DECODE} "
        f"greedy decode_steps; then fp32: the prefill and "
        f"{LM_SERVE_MESH_DECODE} decode steps fed the same tokens; at "
        f"{SSM_RECUR_LAYERS} layers the one-shot prefill against "
        f"{SSM_RECUR_PREFIX} tokens prefilled and "
        f"{ZOO_PROMPT - SSM_RECUR_PREFIX} decoded")
    params = zoo_params(torch, dev, cfg)
    tokens = torch.from_numpy(
        make_lm_batch(cfg, 1, ZOO_PROMPT)["tokens"]).to(dev)
    run = zoo_generate(torch, cfg, params, tokens, ZOO_DECODE, want_flash=0,
                       label="16b prefill and decode", profiled=True)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    # the fp32 prefill, then LM_SERVE_MESH_DECODE steps fed the bf16 run's
    # tokens: phase 20d's oracle
    one = zoo_generate(torch, f32, params, tokens, LM_SERVE_MESH_DECODE,
                       want_flash=0, feed=torch.tensor(
                           run["fed"][:LM_SERVE_MESH_DECODE], device=dev),
                       label="16b one-shot fp32 prefill")
    bf16_vs_fp32 = [rel_l2(a, b) for a, b in zip(
        [run["last"]] + run["logits"], [one["last"]] + one["logits"])]
    log(f"  16b: the bf16 run's logits against the fp32 run's, relative "
        f"L2 a step: {[float('%.4g' % x) for x in bf16_vs_fp32]}")
    # the witness for 20d's distance: the same fp32 run on weights moved
    # by SSM_PERTURB relative noise (seeded), against the fp32 run
    gen = torch.Generator(device=dev).manual_seed(SSM_PERTURB_SEED)
    moved = tree_map(lambda t: t * (1 + SSM_PERTURB * torch.randn(
        t.shape, generator=gen, device=dev)) if t.is_floating_point()
        else t, params)
    nudged = zoo_generate(torch, f32, moved, tokens, LM_SERVE_MESH_DECODE,
                          want_flash=0, feed=torch.tensor(
                              run["fed"][:LM_SERVE_MESH_DECODE], device=dev),
                          label="16b fp32 prefill, weights perturbed")
    del moved
    perturbed = [rel_l2(a, b) for a, b in zip(
        [nudged["last"]] + nudged["logits"], [one["last"]] + one["logits"])]
    del nudged
    log(f"  16b: the fp32 run on weights perturbed by {SSM_PERTURB} "
        f"(relative) against the fp32 run, relative L2 a step (20d's "
        f"witness): {[float('%.4g' % x) for x in perturbed]}")
    rest = tokens[0, SSM_RECUR_PREFIX:]
    recur = {}
    cut = dataclasses.replace(f32, n_layers=SSM_RECUR_LAYERS)
    cut_params = cut_units(params, cut.n_units)
    shot = zoo_generate(torch, cut, cut_params, tokens, 0, want_flash=0,
                        label=f"16b one-shot fp32 prefill at {cut.n_layers} "
                        "layers")
    for name, conv in (("fp32_conv_cache", torch.float32),
                       ("bf16_conv_cache", torch.bfloat16)):
        t0 = time.perf_counter()
        rec = zoo_generate(torch, cut, cut_params,
                           tokens[:, :SSM_RECUR_PREFIX], len(rest),
                           want_flash=0, feed=rest, conv_dtype=conv,
                           label=f"16b recurrence, {name}")
        got, want = rec["logits"][-1], shot["last"]
        recur[name] = {"rel_l2_err": rel_l2(got, want),
                       "max_abs_err": float((got - want).abs().max()),
                       "argmax_agrees": int(got.argmax()) == int(
                           want.argmax()),
                       "wall_s": time.perf_counter() - t0,
                       "decode_host_ms_per_token": sum(
                           rec["decode_host_ms"]) / len(rest)}
        log(f"  16b recurrence ({name}) vs one-shot, last logits: "
            f"{json.dumps(recur[name])}")
    held = recur["fp32_conv_cache"]
    if not (held["rel_l2_err"] <= TOL_SSM_RECUR and held["argmax_agrees"]):
        raise AssertionError(f"16b: the recurrence disagrees with the "
                             f"chunked scan: {held} (tol {TOL_SSM_RECUR})")
    nums = {"card": CARD, **zoo_summary(run), "recurrence": recur,
            "tol_rel_l2": TOL_SSM_RECUR,
            "bf16_vs_fp32_rel_l2_by_step": bf16_vs_fp32,
            "fp32_perturbed_rel_l2_by_step": perturbed,
            "perturbation": SSM_PERTURB,
            "fp32_one_shot_prefill_host_ms": one["prefill_host_ms"],
            "fp32_peak_bytes": one["peak_bytes"],
            "reckoning_bytes": zoo_reckoning_bytes(cfg, ZOO_PROMPT)}
    log(f"16b numbers: {json.dumps(nums)}")
    return {"numbers": nums, "oracle": zoo_oracle(one),
            "paths": {"zoo_ssm": run["launches"]}}


def zoo_hybrid(torch, dev) -> dict:
    """Phase 16c: the bf16 kernel at jamba's prefill shape (dh 128) against
    its plain version, timed; then jamba-v0.1-52b at full width cut to one
    8-layer unit, bf16 compute, fp32 parameters, int8 KV cache: the
    prefill through the kernel (one launch) and ZOO_DECODE greedy decode
    steps through the int8 cache; the prefill through full_attention; the
    same decode through a bf16 cache. The last logits of the two prefills
    are held as in 16a; the attention layer's output, recorded in each
    run, is held against the other path's: the prefill within
    TOL_ZOO_ATTN_REL_L2, every int8 decode step within TOL_INT8_REL_L2."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    log(f"phase 16c: flash_attention vs plain at jamba's prefill shape "
        f"{FLASH_DH128_SHAPE} bfloat16")
    flash = check_flash_shape(torch, dev, "jamba_dh128", FLASH_DH128_SHAPE,
                              "bfloat16")
    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              n_layers=HYBRID_LAYERS)
    moe_layers = [i for i in range(HYBRID_LAYERS) if cfg.is_moe_layer(i)]
    log(f"phase 16c: {HYBRID_ARCH} at full width, depth cut from 32 layers "
        f"to one unit of {HYBRID_LAYERS} ({' '.join(cfg.pattern)}, MoE of "
        f"{cfg.n_experts} experts top-{cfg.top_k} on layers {moe_layers}), "
        f"d {cfg.d_model}, GQA {cfg.n_heads}/{cfg.n_kv_heads}, dh "
        f"{cfg.d_head}, {cfg.kv_cache_dtype} KV cache, bf16 compute: "
        f"prefill_step on make_lm_batch(cfg, 1, {ZOO_PROMPT}) through the "
        f"kernel, {ZOO_DECODE} greedy decode_steps; the prefill through "
        f"full_attention; the decode through a bf16 cache")
    params = zoo_params(torch, dev, cfg)
    tokens = torch.from_numpy(
        make_lm_batch(cfg, 1, ZOO_PROMPT)["tokens"]).to(dev)
    rec_kernel, rec_plain, rec_bf16 = [], [], []
    with attention_spy(rec_kernel):
        run = zoo_generate(torch, cfg, params, tokens, ZOO_DECODE,
                           want_flash=1, label="16c kernel prefill, int8 "
                           "decode", profiled=True)
    with attention_spy(rec_plain):
        plain = zoo_generate(torch, dataclasses.replace(
            cfg, attn_block_q=ZOO_PROMPT), params, tokens, 0, want_flash=0,
            label="16c full_attention prefill")
    held = logits_held(run["last"], plain["last"],
                       "16c kernel vs full_attention, last logits")
    layer = {"prefill_input_rel_l2": rel_l2(rec_kernel[0][1],
                                            rec_plain[0][1]),
             "prefill_output_rel_l2": rel_l2(rec_kernel[0][2],
                                             rec_plain[0][2]),
             "input_mean_abs": float(rec_kernel[0][1].float().abs()
                                     .mean()),
             "output_mean_abs": float(rec_kernel[0][2].float().abs().mean())}
    with attention_spy(rec_bf16):
        bf16 = zoo_generate(torch, dataclasses.replace(
            cfg, kv_cache_dtype="bfloat16"), params, tokens, ZOO_DECODE,
            want_flash=1, feed=torch.tensor(run["fed"], device=dev),
            label="16c kernel prefill, bf16-cache decode")
    # rec_*[0] is the prefill, [1:1 + ZOO_DECODE] the decode steps (fed
    # the same tokens in both runs); the kernel run's profiled prefill
    # comes last
    steps = [rel_l2(a[2], b[2]) for a, b in zip(
        rec_kernel[1:1 + ZOO_DECODE], rec_bf16[1:1 + ZOO_DECODE])]
    logit_steps = [rel_l2(a, b) for a, b in zip(run["logits"],
                                                 bf16["logits"])]
    agree = sum(int(a.argmax()) == int(b.argmax())
                for a, b in zip(run["logits"], bf16["logits"]))
    layer.update(int8_decode_output_rel_l2_max=max(steps),
                 int8_decode_output_rel_l2_median=sorted(steps)[
                     len(steps) // 2],
                 int8_decode_logits_rel_l2_max=max(logit_steps),
                 int8_decode_argmax_agree=agree)
    log(f"  16c attention layer: {json.dumps(layer)} (tol prefill "
        f"{TOL_ZOO_ATTN_REL_L2}, int8 decode {TOL_INT8_REL_L2})")
    if len(steps) != ZOO_DECODE or not (
            layer["prefill_output_rel_l2"] <= TOL_ZOO_ATTN_REL_L2
            and max(steps) <= TOL_INT8_REL_L2):
        raise AssertionError(f"16c: the attention layer disagrees: {layer}")
    nums = {"card": CARD, "depth_cut": f"32 -> {HYBRID_LAYERS} layers",
            **zoo_summary(run), **held, "attention_layer": layer,
            "plain_prefill_host_ms": plain["prefill_host_ms"],
            "plain_peak_bytes": plain["peak_bytes"],
            "bf16_cache_decode_host_ms_per_token": sum(
                bf16["decode_host_ms"][1:]) / max(ZOO_DECODE - 1, 1),
            "reckoning_bytes": zoo_reckoning_bytes(cfg, ZOO_PROMPT),
            "plain_reckoning_bytes": zoo_reckoning_bytes(
                cfg, ZOO_PROMPT, plain_attention=True)}
    log(f"16c numbers: {json.dumps(nums)}")
    del rec_kernel, rec_plain, rec_bf16
    return {"numbers": nums, "flash": flash,
            "paths": {"zoo_hybrid_prefill": run["launches"],
                      "zoo_hybrid_plain": plain["launches"],
                      "zoo_hybrid_bf16_cache": bf16["launches"]}}


def zoo_serve(torch) -> dict:
    """Phase 16d: the LM launcher on mamba2-780m (ZOO_SERVE_ARGV: 8
    requests over 4 slots, fp32 compute): every request gets its budget,
    no kernel launched; each request's greedy tokens equal the same
    request served alone by a fresh engine of as many slots."""
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import Request, ServeEngine

    log(f"phase 16d: python -m repro_torch.launch.serve "
        f"{' '.join(ZOO_SERVE_ARGV)}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches(KERNELS)
    t0 = time.perf_counter()
    engine, text = run_cli(serve_cli.main, ZOO_SERVE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches(KERNELS, "16d serve", ())
    if any(counts.values()):
        raise AssertionError(f"the LM engine launched kernels: {counts}")
    args = serve_cli.parse_args(ZOO_SERVE_ARGV)
    reqs = serve_cli.lm_requests(engine.cfg, args.requests, args.prompt_len,
                                 args.new_tokens)
    done = engine.completed
    if sorted(done) != [r.uid for r in reqs] or not all(
            len(v) == args.new_tokens for v in done.values()):
        raise AssertionError(f"not every request got {args.new_tokens} "
                             f"tokens: { {u: len(v) for u, v in done.items()} }")
    if args.requests <= args.slots:
        raise AssertionError("16d must reuse its slots")

    def alone(req) -> list:
        eng = ServeEngine(engine.params, engine.cfg, batch_slots=args.slots,
                          max_len=args.max_len)
        eng.submit(Request(uid=req.uid, prompt=req.prompt,
                           max_new_tokens=args.new_tokens))
        return eng.run_until_drained()[req.uid]

    t0 = time.perf_counter()
    differ = [r.uid for r in reqs if alone(r) != done[r.uid]]
    alone_s = time.perf_counter() - t0
    line = text.strip().splitlines()[0]
    tok_s = float(line.split("(")[1].split(" tok/s")[0])
    nums = {"card": CARD, "requests": args.requests, "slots": args.slots,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "tokens": sum(len(v) for v in done.values()),
            "launcher_tok_per_s": tok_s, "wall_s": wall,
            "engine_steps": engine.steps_run,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "differ_from_alone": differ, "alone_s": alone_s}
    log(f"16d numbers: {json.dumps(nums)}")
    if differ:
        raise AssertionError(f"16d: requests served in reused slots differ "
                             f"from the same requests alone: {differ}")
    del engine
    return {"numbers": nums, "paths": {"zoo_serve": counts}}


def chunked_full_attention(q, k, v, causal: bool = True):
    """full_attention on PLAIN_HEAD_CHUNK heads at a time, the chunks
    concatenated: the same function (the heads are independent), with a
    fraction of its fp32 scores alive at once."""
    import torch

    from repro_torch.nn import layers as L
    h = q.shape[2]
    return torch.cat([L.full_attention(q[:, :, i:i + PLAIN_HEAD_CHUNK],
                                       k[:, :, i:i + PLAIN_HEAD_CHUNK],
                                       v[:, :, i:i + PLAIN_HEAD_CHUNK],
                                       causal)
                      for i in range(0, h, PLAIN_HEAD_CHUNK)], dim=2)


@contextlib.contextmanager
def plain_attention():
    """While open, the layers' attention op is `chunked_full_attention`
    (torch ops, no kernel launch) in place of the flash-attention kernel."""
    from repro_torch.kernels import ops
    real = ops.flash_attention
    ops.flash_attention = chunked_full_attention
    try:
        yield
    finally:
        ops.flash_attention = real


def attention_layers_held(torch, cfg, params, batch) -> dict:
    """One more prefill_step on `batch` (fresh caches) in which every
    attention layer's output through the kernel is held against the same
    layer's output through `chunked_full_attention` on the same input
    (relative L2 within TOL_ZOO_ATTN_REL_L2). Returns the worst and
    median errors, and the layers' count."""
    from repro_torch.models.lm import init_caches, prefill_step
    from repro_torch.nn import layers
    real = layers.attention
    errs = []

    def spy(p, x, c, positions, **kw):
        y, cache = real(p, x, c, positions, **kw)
        with plain_attention():
            want, _ = real(p, x, c, positions, mode="train")
        errs.append(rel_l2(y, want))
        return y, cache

    s = sum(batch[k].shape[1] for k in ("embeds", "tokens") if k in batch)
    caches = init_caches(cfg, 1, s, next(iter(batch.values())).device)
    layers.attention = spy
    try:
        prefill_step(params, batch, caches, cfg)
    finally:
        layers.attention = real
    del caches
    worst = max(errs)
    out = {"attention_layers": len(errs), "layer_output_rel_l2_max": worst,
           "layer_output_rel_l2_median": sorted(errs)[len(errs) // 2],
           "tol": TOL_ZOO_ATTN_REL_L2}
    log(f"  each attention layer, kernel vs full_attention on the same "
        f"input: {json.dumps(out)}")
    if len(errs) != cfg.pattern.count("a") * cfg.n_units or \
            worst > TOL_ZOO_ATTN_REL_L2:
        raise AssertionError(f"an attention layer disagrees: {out}")
    return out


def step0_bits(torch, dev, cfg, label: str, twice: bool) -> dict:
    """Step 0's loss and every gradient at batch 1 of ZOO_TRAIN_SEQ
    through the kernels under remat "full" (twice with `twice`) and
    "none": every run gives the same bits. Returns the numbers and the
    launch counts."""
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import train as train_cli
    from repro_torch.models.lm import init_lm_params
    params = init_lm_params(cfg, train_cli.PARAM_SEED, dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_lm_batch(
        cfg, 1, ZOO_TRAIN_SEQ, 0, 0).items()}
    reset_launches(KERNELS)
    runs = [("full", "full")] + ([("full again", "full")] if twice else []) \
        + [("none", "none")]
    first, equal, host_ms = None, {}, {}
    for name, remat in runs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = lm_grads(torch, params, batch, dataclasses.replace(
            cfg, remat=remat), plain=False)
        torch.cuda.synchronize()
        host_ms[name] = (time.perf_counter() - t0) * 1e3
        if first is None:
            first = (loss, grads)
            continue
        equal[name] = loss == first[0] and all(
            torch.equal(a, b) for a, b in zip(grads, first[1]))
        del grads
    counts = {k.name: k.launches for k in KERNELS}
    nums = {"loss": first[0], "bit_equal_to_remat_full": equal,
            "host_ms": host_ms,
            "finite": all(bool(torch.isfinite(g).all()) for g in first[1])}
    log(f"{label}: step 0 at batch 1: {json.dumps(nums)}; launches "
        f"{counts}")
    if not (nums["finite"] and all(equal.values())):
        raise AssertionError(f"{label}: step 0 is not repeatable bit for "
                             f"bit across runs and remat modes: {equal}")
    del params, first
    return {"numbers": nums, "launches": counts}


def zoo_train_phases(torch, dev) -> dict:
    """Phases 17a-17e: the attention kernels at this slice's training
    shapes (17a); granite-moe-1b-a400m (17b, 17c) and mamba2-780m (17d)
    trained at full width; jamba-v0.1-52b's hybrid path trained at the
    smoke config (17e). Returns 17a's numbers and each path's launches."""
    from repro_torch.configs import get_config, get_smoke_config
    log("phase 17a: flash_attention and flash_attention_bwd vs plain at "
        + ", ".join(f"{n} {shape} {dt}" for n, shape, dt in
                    FLASH_ZOO_TRAIN_SHAPES))
    flash = check_flash_attention_bwd(torch, dev, FLASH_ZOO_TRAIN_SHAPES)
    free_device(torch)
    paths = {}
    moe = get_config(MOE_TRAIN_ARCH)
    argv = ["--arch", MOE_TRAIN_ARCH, "--seq", str(ZOO_TRAIN_SEQ),
            "--batch", str(ZOO_TRAIN_BATCH), "--steps",
            str(ZOO_TRAIN_STEPS), "--log-every", "1"]
    paths["zoo_train_moe"] = lm_train_launcher(torch, dev, moe, argv,
                                                "17b", profiled=True)[
                                                    "launches"]
    log_peak(torch, "phase 17b")
    free_device(torch)
    log(f"phase 17c: {MOE_TRAIN_ARCH} step 0 at batch 1 through the kernels "
        "(twice) and through full_attention, bf16 and fp32; then remat "
        "none against full")
    paths["zoo_train_moe_plain_check"] = lm_train_plain(
        torch, dev, moe, label="17c")["launches"]
    paths["zoo_train_moe_bits"] = step0_bits(torch, dev, moe, "17c",
                                             twice=False)["launches"]
    log_peak(torch, "phase 17c")
    free_device(torch)
    ssm = get_config(SSM_ARCH)
    argv = ["--arch", SSM_ARCH, "--seq", str(ZOO_TRAIN_SEQ), "--batch",
            str(ZOO_TRAIN_BATCH), "--steps", str(ZOO_TRAIN_STEPS),
            "--log-every", "1"]
    paths["zoo_train_ssm"] = lm_train_launcher(torch, dev, ssm, argv,
                                                "17d")["launches"]
    paths["zoo_train_ssm_bits"] = step0_bits(torch, dev, ssm, "17d",
                                             twice=True)["launches"]
    log_peak(torch, "phase 17d")
    free_device(torch)
    paths["zoo_train_hybrid_smoke"] = lm_train_launcher(
        torch, dev, get_smoke_config(HYBRID_ARCH), HYBRID_SMOKE_ARGV,
        "17e")["launches"]
    full = get_config(HYBRID_ARCH)
    unit = dataclasses.replace(full, n_layers=len(full.pattern))
    log("17e: jamba-v0.1-52b full-width training reckoning at 4,096 x 1 "
        "(bytes): " + json.dumps(
            {"32_layers": lm_reckoning_bytes(full, 1, ZOO_TRAIN_SEQ),
             "one_unit_of_8": lm_reckoning_bytes(unit, 1, ZOO_TRAIN_SEQ),
             "card_bytes": torch.cuda.get_device_properties(0).total_memory}))
    free_device(torch)
    return {"flash": flash, "paths": paths}


def frontend_serve(torch, dev, cfg, label: str, engine: bool) -> dict:
    """`cfg` at full width (depth as given), bf16: prefill_step on
    make_lm_batch(cfg, 1, ZOO_PROMPT)'s inputs through the kernel (one
    launch a layer) and FRONTEND_DECODE greedy decode_steps, profiled; the
    same prefill with the layers' attention through
    `chunked_full_attention`, its last logits held to the kernel's
    (`logits_held`); every attention layer held on the same input
    (`attention_layers_held`); with `engine`, ServeEngine on the model
    (text in and out): every request gets its tokens, and each request
    served in a reused slot equals the same request alone in a fresh
    engine. Returns the numbers and the launch counts."""
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.kernels import KERNELS
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import Request, ServeEngine
    params = zoo_params(torch, dev, cfg)
    raw = make_lm_batch(cfg, 1, ZOO_PROMPT)
    batch = {k: torch.from_numpy(raw[k]).to(dev)
             for k in ("embeds", "tokens") if k in raw}
    run = zoo_generate(torch, cfg, params, batch, FRONTEND_DECODE,
                       want_flash=cfg.n_layers, label=f"{label} kernel "
                       "prefill", profiled=True)
    with plain_attention():
        plain = zoo_generate(torch, cfg, params, batch, 0, want_flash=0,
                             label=f"{label} full_attention prefill")
    held = logits_held(run["last"], plain["last"],
                       f"{label} kernel vs full_attention, last logits")
    layers = attention_layers_held(torch, cfg, params, batch)
    paths = {"prefill": run["launches"], "plain": plain["launches"]}
    nums = {"card": CARD, "arch": cfg.name, "layers": cfg.n_layers,
            "positions": ZOO_PROMPT, **zoo_summary(run), **held,
            "attention_layers_held": layers,
            "plain_prefill_host_ms": plain["prefill_host_ms"],
            "plain_peak_bytes": plain["peak_bytes"],
            "reckoning_bytes": zoo_reckoning_bytes(cfg, ZOO_PROMPT)}
    del run, plain
    if engine:
        reqs = serve_cli.lm_requests(cfg, VLM_ENGINE_REQUESTS, (16, 32),
                                     FRONTEND_DECODE)
        reset_launches(KERNELS)
        t0 = time.perf_counter()
        eng = ServeEngine(params, cfg, batch_slots=VLM_ENGINE_SLOTS,
                          max_len=VLM_ENGINE_MAX_LEN)
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_launches(KERNELS, f"{label} engine", ())
        if sorted(done) != [r.uid for r in reqs] or any(
                len(v) != FRONTEND_DECODE for v in done.values()) or any(
                counts.values()):
            raise AssertionError(f"{label} engine: not every request got "
                                 f"{FRONTEND_DECODE} tokens, or a kernel "
                                 f"launched: {counts}")
        differ = []
        for r in reqs[VLM_ENGINE_SLOTS:]:
            alone = ServeEngine(params, cfg, batch_slots=VLM_ENGINE_SLOTS,
                                max_len=VLM_ENGINE_MAX_LEN)
            alone.submit(Request(uid=r.uid, prompt=r.prompt,
                                 max_new_tokens=FRONTEND_DECODE))
            if alone.run_until_drained()[r.uid] != done[r.uid]:
                differ.append(r.uid)
            del alone
        tokens = sum(len(v) for v in done.values())
        nums["engine"] = {"requests": len(reqs), "slots": VLM_ENGINE_SLOTS,
                          "prompt_lens": [len(r.prompt) for r in reqs],
                          "tokens": tokens, "wall_s": wall,
                          "tok_per_s": tokens / wall,
                          "engine_steps": eng.steps_run,
                          "reused_slot_requests_differ_from_alone": differ}
        paths["engine"] = counts
        del eng
        if differ:
            raise AssertionError(f"{label} engine: requests in reused slots "
                                 f"differ from the same requests alone: "
                                 f"{differ}")
    log(f"{label} numbers: {json.dumps(nums)}")
    del params
    return {"numbers": nums, "paths": paths}


def frontend_phases(torch, dev) -> dict:
    """Phase 17f: musicgen-large trained at full width (the launcher,
    4,096 x 2) and served (8,192 frames, 16 greedy decode steps of 4
    codebooks); internvl2-26b served at full width cut to
    VLM_SERVE_LAYERS layers (8,192 positions with 256 patches, 16 greedy
    decodes, then the engine) and trained cut to VLM_TRAIN_LAYERS layers.
    Returns each path's launches."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import vlm_prefix
    from repro_torch.launch import train as train_cli
    paths = {}
    audio = get_config(AUDIO_ARCH)
    argv = ["--arch", AUDIO_ARCH, "--seq", str(ZOO_TRAIN_SEQ), "--batch",
            str(FRONTEND_TRAIN_BATCH), "--steps", str(FRONTEND_TRAIN_STEPS),
            "--log-every", "1"]
    paths["frontend_train_audio"] = lm_train_launcher(
        torch, dev, audio, argv, "17f", profiled=True)["launches"]
    log_peak(torch, "phase 17f audio training")
    free_device(torch)
    log(f"phase 17f: {AUDIO_ARCH} at full width ({audio.n_layers} layers, d "
        f"{audio.d_model}, MHA {audio.n_heads}, {audio.n_codebooks} "
        f"codebooks, sinusoidal positions), bf16: prefill_step on "
        f"{ZOO_PROMPT} frames through the kernel, {FRONTEND_DECODE} greedy "
        f"decode_steps, then the prefill through full_attention")
    res = frontend_serve(torch, dev, audio, "17f audio", engine=False)
    paths.update({f"frontend_serve_audio_{k}": v
                  for k, v in res["paths"].items()})
    log_peak(torch, "phase 17f audio serving")
    del res
    free_device(torch)
    vlm = get_config(VLM_ARCH)
    cut = dataclasses.replace(vlm, n_layers=VLM_SERVE_LAYERS)
    log(f"phase 17f: {VLM_ARCH} at full width, depth cut from "
        f"{vlm.n_layers} to {VLM_SERVE_LAYERS} layers (d {vlm.d_model}, GQA "
        f"{vlm.n_heads}/{vlm.n_kv_heads}, dh {vlm.d_head}), bf16: "
        f"prefill_step on {ZOO_PROMPT} positions ({vlm_prefix(ZOO_PROMPT)} "
        f"patches) through the kernel, {FRONTEND_DECODE} greedy "
        f"decode_steps, the prefill through full_attention, then "
        f"ServeEngine ({VLM_ENGINE_REQUESTS} requests over "
        f"{VLM_ENGINE_SLOTS} slots)")
    res = frontend_serve(torch, dev, cut, "17f vision", engine=True)
    paths.update({f"frontend_serve_vision_{k}": v
                  for k, v in res["paths"].items()})
    log_peak(torch, "phase 17f vision serving")
    del res
    free_device(torch)
    argv = ["--arch", VLM_ARCH, "--seq", str(ZOO_TRAIN_SEQ), "--batch",
            str(FRONTEND_TRAIN_BATCH), "--steps", str(FRONTEND_TRAIN_STEPS),
            "--log-every", "1"]
    paths["frontend_train_vision"] = lm_train_launcher(
        torch, dev, dataclasses.replace(vlm, n_layers=VLM_TRAIN_LAYERS),
        argv, "17f", entry=train_cli.train)["launches"]
    log_peak(torch, "phase 17f vision training")
    free_device(torch)
    return {"paths": paths}


def spawn_world(dev, n_ranks: int, timeout_s: float = MESH_TIMEOUT_S,
                alloc_conf: str | None = None):
    """A `launch.mesh.RankWorld` of `n_ranks` gloo ranks on the card,
    spawned now, so the ranks import torch while the parent prepares
    their first call; with `alloc_conf`, the ranks' (not the parent's)
    PYTORCH_CUDA_ALLOC_CONF. Close it (a `with` block) to stop them."""
    from repro_torch.launch.mesh import RankWorld
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    if alloc_conf is not None:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    try:
        return RankWorld(n_ranks, backend="gloo", device=rank_device(dev),
                         timeout_s=timeout_s)
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc


def rank_world(torch, dev, name: str, calls: list, n_ranks: int,
               timeout_s: float = MESH_TIMEOUT_S,
               world=None) -> tuple[list, dict]:
    """Run `calls` one after another (`train.sharded.run_calls`) on the
    `n_ranks` gloo ranks of `world` (`spawn_world`), or of a world spawned
    for them alone. Returns each call's reports in rank order and the
    call's start: seconds from the call (from the spawn, for a world's
    first call) until the last rank had started, had imported torch, had
    its arguments, had joined, had reported (a rank of an earlier call
    started and imported before the call: negative)."""
    from repro_torch.train.sharded import run_calls
    t0 = time.perf_counter()
    timings: dict = {}
    own = world is None
    if own:
        world = spawn_world(dev, n_ranks, timeout_s)
    try:
        if world.n != n_ranks:
            raise ValueError(f"{name} wants {n_ranks} ranks, the world has "
                             f"{world.n}")
        res = world.run(run_calls, (calls,), timeout_s=timeout_s,
                        timings=timings)
    finally:
        if own:
            world.close()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = {"ranks": n_ranks, "world_call": world.calls,
           "spawn_and_run_s": time.perf_counter() - t0,
           **{f"last_rank_{label}_s": max(t[key] for t in timings["ranks"])
              for key, label in (("started", "started"),
                                 ("imported", "imported"),
                                 ("entered", "entered"),
                                 ("joined", "joined"),
                                 ("returned", "reported"))},
           "all_reported_s": timings["all_reported_s"]}
    log(f"  {name} world: {json.dumps(out)}")
    return [[r[i] for r in res] for i in range(len(calls))], out


def multihost_rank_numbers(name: str, res: list) -> dict:
    """Phase 18's gates on one multi-host rank run (each rank's launches a
    step exactly MULTIHOST_RANK_STEP, no jax or reference module) and its
    numbers: host ms and device span ms a step (steps 1 on) and
    device-busy ms a profiled step by rank, each collective's calls, bytes
    and ms a step (means over ranks), the peaks, examples/s."""
    import numpy as np

    from repro_torch.launch.mesh import COLLECTIVES
    for r in res:
        log(f"  {name} host {r['host']} rows {r['rows']}: losses "
            f"{r['losses']}; host ms "
            f"{[round(x, 3) for x in r['host_ms']]}; device span ms "
            f"{[round(x, 3) for x in r['device_span_ms']]}; busy ms a "
            f"profiled step {r['device_busy_ms_per_step']}; peak "
            f"{r['peak_bytes']} bytes; host maps {r['host_map_bytes']} "
            f"bytes; setup s {json.dumps(r['setup'])}")
        for t, counts in enumerate(r["launches"]):
            got = {k: v for k, v in counts.items() if v}
            if got != MULTIHOST_RANK_STEP:
                raise AssertionError(f"{name} host {r['host']} step {t}: "
                                     f"launches {got}, want "
                                     f"{MULTIHOST_RANK_STEP}")
        if r["foreign_modules"]:
            raise AssertionError(f"{name} host {r['host']} loaded "
                                 f"{r['foreign_modules']}")
    n = len(res[0]["host_ms"])
    later = slice(1, n) if n > 1 else slice(0, n)
    by_rank = [float(np.mean(r["host_ms"][later])) for r in res]

    def per_step(key):
        return float(np.mean([c[key] for r in res
                              for c in r["collectives"][later]]))
    totals = [{k: sum(c[k] for c in r["launches"]) for k in r["launches"][0]}
              for r in res]
    nums = {"host_ms_per_step": float(np.mean(by_rank)),
            "host_ms_per_step_by_rank": by_rank,
            "device_span_ms_per_step_by_rank": [
                float(np.mean(r["device_span_ms"][later])) if
                r["device_span_ms"] else None for r in res],
            "device_busy_ms_per_step_by_rank": [
                r["device_busy_ms_per_step"] for r in res],
            "collectives_per_step": {
                op: {"calls": per_step(f"{op}_calls"),
                     "bytes": per_step(f"{op}_bytes"),
                     "ms": per_step(f"{op}_ms")} for op in COLLECTIVES},
            "peak_bytes_by_rank": [r["peak_bytes"] for r in res],
            "ranks_peak_bytes": sum(r["peak_bytes"] or 0 for r in res),
            "rank_setup_s": {k: float(max(r["setup"][k] for r in res))
                             for k in res[0]["setup"]},
            "examples_per_s": TRAIN_BATCH / float(np.mean(by_rank)) * 1e3,
            "launches": {k: sum(t[k] for t in totals) for k in totals[0]},
            "launches_per_rank": totals}
    log(f"  {name}: " + json.dumps({k: v for k, v in nums.items()
                                     if k != "launches_per_rank"}))
    return nums


def bulk_oracle(torch, dev, cfg) -> tuple:
    """Phase 11b's run to hold to: dlrm-m1 with every table cut to 1 /
    BULK_ROW_DIV of its rows, from the launcher's seed, trained
    TRAIN_STEPS steps on the launcher's batches by the launcher's step
    (`build_dlrm_train_step(sparse_apply="sparse")`). Returns the cut
    config and `train_cached`'s `want`: the losses, the initial and final
    checksums, and the rows."""
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.core.embedding import EmbeddingBagCollection
    from repro_torch.launch.train import PARAM_SEED
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_dlrm_train_step, dlrm_init_state
    small = dataclasses.replace(cfg, hash_sizes=tuple(
        max(1, h // BULK_ROW_DIV) for h in cfg.hash_sizes))
    ebc = EmbeddingBagCollection.build(small, n_shards=1,
                                       strategy="replicated")
    log(f"phase 11b: dlrm-m1 with each table cut to 1/{BULK_ROW_DIV} of its "
        f"rows ({ebc.plan.total_rows}): build_dlrm_train_step("
        f"sparse_apply='sparse'), {TRAIN_STEPS} steps from the launcher's "
        f"seed")
    params = init_dlrm_params(small, ebc, PARAM_SEED, dev)
    want = {"rows": ebc.plan.total_rows,
            "init_sum": bit_checksum(torch, params["emb"]["mega"])}
    opt = adagrad(0.01)
    state = dlrm_init_state(ebc, opt, params)
    step = build_dlrm_train_step(small, ebc, opt, SPARSE_LR, SPARSE_EPS,
                                 sparse_apply="sparse")
    losses = []
    for t, b in enumerate(mesh_batches(small, ebc, TRAIN_STEPS, "plan")):
        params, state, m = step(params, state, {
            k: torch.as_tensor(b[k]).to(dev) for k in ("dense", "idx",
                                                       "label")}, t)
        losses.append(float(m["loss"]))
    want["losses"] = losses
    want["final_sums"] = (bit_checksum(torch, params["emb"]["mega"]),
                          bit_checksum(torch, state["accum"]))
    log(f"  11b's uncached run: losses {losses}, checksums initial "
        f"{want['init_sum']}, final {want['final_sums']}")
    return small, want


def elastic_setup(torch, dev, cfg) -> dict:
    """Phase 18c's table and the uninterrupted run it is held to: dlrm-m1
    with every table cut to 1 / ELASTIC_ROW_DIV of its rows on the
    4-host cached layout, from the launcher's seed, its batches drawn
    once; `build_dlrm_train_step(sparse_apply="sparse")` (the launcher's
    step) trains a copy for TRAIN_STEPS steps. Returns the table and
    accumulator the first half's ranks update through IPC views, the
    batches, the dense parameters, the run's losses and final checksums."""
    from repro_torch.core.cache import MultiHostCachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.launch.train import PARAM_SEED
    from repro_torch.optim import adagrad
    from repro_torch.train.steps import build_dlrm_train_step, dlrm_init_state
    small = dataclasses.replace(cfg, hash_sizes=tuple(
        max(1, h // ELASTIC_ROW_DIV) for h in cfg.hash_sizes))
    ebc = MultiHostCachedEmbeddingBagCollection.build(
        small, n_hosts=MULTIHOST_HOSTS).ebc
    params = init_dlrm_params(small, ebc, PARAM_SEED, dev)
    out = {"cfg": small, "total_rows": ebc.plan.total_rows,
           "dense": host_dense(params),
           "mega": params["emb"]["mega"].clone(),
           "accum": torch.zeros((ebc.plan.total_rows,), dtype=torch.float32,
                                device=dev),
           "batches": mesh_batches(small, ebc, TRAIN_STEPS, "plan")}
    opt = adagrad(0.01)
    state = dlrm_init_state(ebc, opt, params)
    step = build_dlrm_train_step(small, ebc, opt, SPARSE_LR, SPARSE_EPS,
                                 sparse_apply="sparse")
    losses = []
    for t, b in enumerate(out["batches"]):
        params, state, m = step(params, state, {
            k: torch.as_tensor(b[k]).to(dev) for k in ("dense", "idx",
                                                       "label")}, t)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    out["final_sums"] = (bit_checksum(torch, params["emb"]["mega"]),
                         bit_checksum(torch, state["accum"]))
    log(f"  18c: {ebc.plan.total_rows} rows ({sum(small.hash_sizes)} "
        f"logical), the uninterrupted run's losses {losses}, final "
        f"checksums {out['final_sums']}")
    return out


def mesh_multihost(torch, dev, cfg, want: dict, ref: dict, run: dict,
                   extra: tuple = (), world=None) -> tuple[dict, list]:
    """Phases 18a-18b: `run` names the per-host cache, strict_sync,
    fetch_chunk and whether the batches carry the plan hook's plan, as
    13a's or 13b's. The parent draws the launcher's table on the card from
    its seed (its initial checksum the launcher's) and MULTIHOST_HOSTS
    ranks train TRAIN_STEPS steps of the launcher's batches over IPC views
    of their rows (`train.sharded.multihost_rank`), the last
    MESH_PROFILED_STEPS profiled. Gates: every rank's losses the
    launcher's; the table's checksums and the shards' added
    LAUNCHER_FINAL_SUMS; every rank's CacheStats and RouteStats `ref`'s
    (the single-controller run's); MULTIHOST_RANK_STEP launches a rank a
    step. `extra` calls run after it in the same call of `world` (a world
    of its own without); returns the run's numbers and their reports."""
    from repro_torch.core.cache import MultiHostCachedEmbeddingBagCollection
    from repro_torch.core.dlrm import init_dlrm_params
    from repro_torch.launch.train import PARAM_SEED
    from repro_torch.train.sharded import add_checksums, multihost_rank
    hn, name = MULTIHOST_HOSTS, run["name"]
    mc = MultiHostCachedEmbeddingBagCollection.build(
        cfg, n_hosts=hn, cache_rows=run["cache_rows"])
    torch.cuda.reset_peak_memory_stats()
    params = init_dlrm_params(cfg, mc.ebc, PARAM_SEED, dev)
    mega = params["emb"]["mega"]
    if bit_checksum(torch, mega) != want["init_sum"]:
        raise AssertionError(f"{name}: the initial table differs from the "
                             "launcher's")
    accum = torch.zeros((mc.ebc.plan.total_rows,), dtype=torch.float32,
                        device=dev)
    job = {"cfg": cfg, "n_hosts": hn, "cache_rows": run["cache_rows"],
           "strict_sync": run["strict_sync"],
           "fetch_chunk": run["fetch_chunk"], "dense": host_dense(params),
           "mega": mega, "accum": accum,
           "batches": mesh_batches(cfg, mc.ebc, TRAIN_STEPS, run["hook"]),
           "sparse_lr": SPARSE_LR, "sparse_eps": SPARSE_EPS,
           "profile_steps": MESH_PROFILED_STEPS}
    del params
    log(f"  {name}: {hn} ranks x {mc.cache_rows} slots, shard_rows "
        f"{mc.shard_rows}; the parent holds the table and accumulator "
        f"({(mega.numel() + accum.numel()) * 4} bytes), each rank its slab "
        f"({mc.cache_rows * cfg.embed_dim * 4} bytes)")
    (res, *more), world = rank_world(torch, dev, name,
                                     [(multihost_rank, job)] + list(extra),
                                     hn, world=world)
    del job
    nums = multihost_rank_numbers(name, res)
    sums = (bit_checksum(torch, mega), bit_checksum(torch, accum))
    shard_sums = (add_checksums(r["mega_sum"] for r in res),
                  add_checksums(r["accum_sum"] for r in res))
    stats_keys = tuple(ref["stats"])
    log(f"{name}: losses {res[0]['losses']} (the launcher's "
        f"{want['losses']}); final checksums: parent {sums}, ranks added "
        f"{shard_sums}, LAUNCHER_FINAL_SUMS {LAUNCHER_FINAL_SUMS}; route "
        f"{json.dumps(res[0]['route'])} (single controller "
        f"{json.dumps(ref['route'])}); examples/s "
        f"{nums['examples_per_s']:.1f} vs the single controller's "
        f"{TRAIN_BATCH / ref['host_ms_per_step'] * 1e3:.1f} (host ms a step "
        f"{nums['host_ms_per_step']:.3f} vs {ref['host_ms_per_step']:.3f})")
    for r in res:
        if r["losses"] != want["losses"]:
            raise AssertionError(f"{name} host {r['host']}: losses "
                                 f"{r['losses']} differ from the launcher's")
        if r["route"] != ref["route"] or {
                k: r["stats"][k] for k in stats_keys} != ref["stats"]:
            raise AssertionError(
                f"{name} host {r['host']}: RouteStats {r['route']} / "
                f"CacheStats {r['stats']} differ from the single "
                f"controller's {ref['route']} / {ref['stats']}")
    if not sums == shard_sums == LAUNCHER_FINAL_SUMS:
        raise AssertionError(f"{name}: checksums parent {sums}, ranks "
                             f"{shard_sums}, recorded {LAUNCHER_FINAL_SUMS}")
    nums.update(world=world, parent_peak_bytes=torch.cuda
                .max_memory_allocated(),
                single_controller_host_ms_per_step=ref["host_ms_per_step"],
                single_controller_examples_per_s=TRAIN_BATCH
                / ref["host_ms_per_step"] * 1e3)
    log(f"  {name} memory: parent {nums['parent_peak_bytes']}, ranks "
        f"{nums['peak_bytes_by_rank']} (summed {nums['ranks_peak_bytes']})")
    del mega, accum
    release_shared(torch, dev)
    return nums, more


def elastic_jobs(el: dict, ckdir: str) -> tuple[dict, dict]:
    """Phase 18c's two halves as `multihost_rank` jobs: steps
    [0, ELASTIC_SPLIT) on MULTIHOST_HOSTS hosts over IPC views of el's
    table, then saved; the rest from the restore on ELASTIC_HOSTS hosts
    (each pod of POD_MESH a replica), the tier as tall as the saved
    one."""
    base = {"cfg": el["cfg"], "dense": el["dense"], "batches": el["batches"],
            "sparse_lr": SPARSE_LR, "sparse_eps": SPARSE_EPS}
    first = {**base, "n_hosts": MULTIHOST_HOSTS, "mega": el["mega"],
             "accum": el["accum"], "steps": (0, ELASTIC_SPLIT),
             "save": {"dir": ckdir}}
    second = {**base, "n_hosts": ELASTIC_HOSTS, "mesh": POD_MESH,
              "total_rows": el["total_rows"],
              "steps": (ELASTIC_SPLIT, TRAIN_STEPS),
              "restore": {"dir": ckdir}}
    return first, second


def check_elastic(el: dict, first: list, second: list) -> dict:
    """Phase 18c's gates: the two halves' losses the uninterrupted run's;
    the restored blocks of each pod add up to what the first half's ranks
    saved; each pod's shards to the uninterrupted run's final checksums;
    launches exact, no foreign module."""
    from repro_torch.train.sharded import add_checksums
    nums = {"first": multihost_rank_numbers("18c-4", first),
            "second": multihost_rank_numbers("18c-2", second)}
    saved = (add_checksums(r["mega_sum"] for r in first),
             add_checksums(r["accum_sum"] for r in first))
    pods = [[r for r in second if r["coords"]["pod"] == p]
            for p in range(POD_RANKS)]
    restored = {(add_checksums(r["restored"]["mega_sum"] for r in pod),
                 add_checksums(r["restored"]["accum_sum"] for r in pod))
                for pod in pods}
    final = {(add_checksums(r["mega_sum"] for r in pod),
              add_checksums(r["accum_sum"] for r in pod)) for pod in pods}
    losses = first[0]["losses"] + second[0]["losses"]
    log(f"18c: losses {losses} (uninterrupted {el['losses']}); saved "
        f"{saved}, restored {restored}; final {final} (uninterrupted "
        f"{el['final_sums']}); save s {first[0]['setup'].get('save_s')}")
    if any(r["losses"] != first[0]["losses"] for r in first) \
            or any(r["losses"] != second[0]["losses"] for r in second) \
            or losses != el["losses"]:
        raise AssertionError("18c: the elastic run's losses differ from the "
                             "uninterrupted run's")
    if restored != {saved} or final != {el["final_sums"]}:
        raise AssertionError(f"18c: saved {saved}, restored {restored}, "
                             f"final {final}, want {el['final_sums']}")
    if any(r["restored"]["step"] != ELASTIC_SPLIT for r in second):
        raise AssertionError("18c: a rank restored another step")
    return nums


def pod_checks(torch, dev, el: dict, pods: list) -> dict:
    """Phase 18d's gates: each pod rank's replica and the center after the
    elastic rounds and after the local-SGD sync bit-equal to the stacked
    form on the card (`train.sharded.easgd_rounds`, mesh None); the probe
    row's bits through both row collectives over the pod axis;
    compression on the card (bf16, int8, three rounds of error feedback on
    the dense tower's shapes) bit-equal to the CPU's."""
    import numpy as np

    from repro_torch.nn.params import tree_leaves, tree_map
    from repro_torch.optim import (compress_decompress,
                                   error_feedback_compress, init_residual)
    from repro_torch.train.sharded import easgd_rounds
    params = tree_map(lambda x: torch.from_numpy(x).to(dev), el["dense"])
    t0 = time.perf_counter()
    stacked = easgd_rounds(params, POD_RANKS, **EASGD_ROUNDS)
    stacked_ms = (time.perf_counter() - t0) * 1e3
    for r in pods:
        sent = np.concatenate([q["sent_bits"] for q in sorted(
            (q for q in pods if q["coords"]["data"] == r["coords"]["data"]),
            key=lambda q: q["coords"]["pod"])])
        if r["foreign_modules"]:
            raise AssertionError(f"18d pod {r['rank']} loaded "
                                 f"{r['foreign_modules']}")
        if not (np.array_equal(r["gathered_bits"], sent)
                and np.array_equal(r["swapped_bits"], sent)):
            raise AssertionError(f"18d pod {r['rank']}: the probe row's "
                                 "bits changed in a row collective")
        for key, st in zip(("elastic", "local"), stacked):
            p = r["coords"]["pod"]
            want = tree_leaves(tree_map(
                lambda x, p=p: x[p:p + 1].cpu().numpy(),
                st.replicas)) + [x.cpu().numpy()
                                 for x in tree_leaves(st.center)]
            got = tree_leaves(r[key]["replicas"]) + tree_leaves(
                r[key]["center"])
            if not all(np.array_equal(a, b) for a, b in zip(got, want,
                                                             strict=True)):
                raise AssertionError(f"18d pod {r['rank']}: {key} differs "
                                     "from the stacked form on the card")
    rng = np.random.RandomState(3)
    grads = tree_map(lambda x: torch.from_numpy(
        (rng.standard_normal(x.shape) * 1e-3).astype(np.float32)),
        el["dense"])
    ok = {}
    for name, dt in (("bfloat16", torch.bfloat16), ("int8", torch.int8)):
        ok[name] = all(torch.equal(
            compress_decompress(g.to(dev), dt).cpu().view(torch.int32),
            compress_decompress(g, dt).view(torch.int32))
            for g in tree_leaves(grads))
        card, cpu = init_residual(tree_map(lambda g: g.to(dev), grads)), \
            init_residual(grads)
        for k in range(3):
            gk = tree_map(lambda g: g * (k + 1), grads)
            cc, card = error_feedback_compress(
                tree_map(lambda g: g.to(dev), gk), card, dt)
            cp, cpu = error_feedback_compress(gk, cpu, dt)
            ok[f"{name}_error_feedback"] = ok.get(
                f"{name}_error_feedback", True) and all(
                torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
                for a, b in zip(tree_leaves(cc) + tree_leaves(card),
                                tree_leaves(cp) + tree_leaves(cpu)))
    nums = {"pod_collectives": pods[0]["collectives"],
            "stacked_ms": stacked_ms,
            "replica_floats": sum(x.numel() for x in tree_leaves(params)),
            "compression_bit_equal": ok}
    log(f"18d: EASGD on {POD_RANKS} pod ranks bit-equal to the stacked form "
        f"on the card; the probe row's bits kept; {json.dumps(nums)}")
    if not all(ok.values()):
        raise AssertionError(f"18d: compression on the card differs from "
                             f"the CPU: {ok}")
    return nums


def multihost_mesh_phases(torch, dev, cfg, want: dict, ref: dict) -> dict:
    """Phase 18 (see the module docstring): one world of MULTIHOST_HOSTS
    ranks runs 18a, then in a second call 18b, 18c's halves and 18d
    (18c's second half and 18d on POD_MESH). `ref` holds 13a's and 13b's
    numbers. Returns each part's numbers."""
    import shutil
    import tempfile

    from repro_torch.train.sharded import multihost_rank, pod_rank
    t_phase = time.perf_counter()
    runs = {"18a": {"name": "18a", "cache_rows": None, "hook": "plan",
                    "strict_sync": False, "fetch_chunk": None},
            "18b": {"name": "18b", "cache_rows": MULTIHOST_EVICT_CACHE_ROWS,
                    "hook": "offset", "strict_sync": True,
                    "fetch_chunk": EVICT_CHUNK}}
    out = {}
    with spawn_world(dev, MULTIHOST_HOSTS) as world:
        log(f"phase 18a: {MULTIHOST_HOSTS} gloo ranks on this card, "
            f"build_cached_train_step(mesh=make_host_mesh("
            f"{MULTIHOST_HOSTS})), 13a's cache and batches, {TRAIN_STEPS} "
            f"steps")
        out["18a"], _ = mesh_multihost(torch, dev, cfg, want, ref["13a"],
                                       runs["18a"], world=world)
        free_device(torch)
        os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
        ckdir = tempfile.mkdtemp(prefix="chip_smoke_elastic_",
                                 dir=os.path.join(ROOT, "runs"))
        try:
            log(f"phase 18c: dlrm-m1 with each table cut to "
                f"1/{ELASTIC_ROW_DIV} of its rows: the uninterrupted run")
            el = elastic_setup(torch, dev, cfg)
            first, second = elastic_jobs(el, ckdir)
            log(f"phase 18b: 13b's run on {MULTIHOST_HOSTS} ranks "
                f"(strict_sync, {MULTIHOST_EVICT_CACHE_ROWS} slots, "
                f"fetch_chunk {EVICT_CHUNK}), then in the same call 18c's "
                f"first {ELASTIC_SPLIT} steps, saved, restored onto "
                f"{ELASTIC_HOSTS} hosts (restore(shardings=), {POD_RANKS} "
                f"pods of the mesh {POD_MESH}) and finished; 18d's EASGD "
                f"{json.dumps(EASGD_ROUNDS)} over its pod axis")
            out["18b"], (first_res, second_res, pods) = mesh_multihost(
                torch, dev, cfg, want, ref["13b"], runs["18b"],
                extra=((multihost_rank, first), (multihost_rank, second),
                       (pod_rank, {"params": el["dense"], "mesh": POD_MESH,
                                   **EASGD_ROUNDS})),
                world=world)
            out["18c"] = check_elastic(el, first_res, second_res)
            out["18d"] = pod_checks(torch, dev, el, pods)
            del el, first, second
            release_shared(torch, dev)
        finally:
            shutil.rmtree(ckdir, ignore_errors=True)
        free_device(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 18 took {out['phase_s']:.1f} s")
    return out


def lm_mesh_reckoning(cfg, rules: dict, batch: int, seq: int) -> dict:
    """A rank's step memory on LM_MESH by the reckoning, part by part: its
    fp32 parameter blocks (`NamedSharding.local_shape` of each leaf's
    `resolve_sized` spec), gradients and AdamW moments, the clip's scaled
    copy and adamw's temporaries on its largest block; its rows' unit
    inputs (remat "full"), its logits (its vocabulary block) in bf16 and
    fp32 and as much again for their gradient, one unit's recompute
    (`layer_train_bytes` on its rows, heads and ff whole: an upper
    bound); the loss's fp32 temporary of the same width (exp of the
    shifted logits); and what a use gathers: one unit's weights whole in
    bf16 with their gradient, the token table's vocabulary block in fp32
    with its gradient. The parts do not all live at once."""
    from types import SimpleNamespace

    from repro_torch.models.lm import (_pattern_moe_flags, _vocab_axes,
                                       lm_param_specs)
    from repro_torch.nn.params import tree_leaves
    from repro_torch.nn.sharding import (NamedSharding, batch_axes,
                                         resolve_sized)
    shape, names = LM_MESH
    mesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)),
                           coords={a: 0 for a in names})
    specs = tree_leaves(lm_param_specs(cfg))
    local = [math.prod(NamedSharding(mesh, resolve_sized(
        s.logical_axes, rules, mesh, s.shape)).local_shape(s.shape))
        for s in specs]
    n = sum(local)
    rows = batch // math.prod(mesh.shape[a] for a in batch_axes(rules, mesh))
    tokens = rows * seq
    v_loc = cfg.vocab_size // math.prod(
        mesh.shape[a] for a in _vocab_axes(cfg, rules, mesh))
    unit = sum(math.prod(s.shape) for s in specs
               if s.logical_axes[:1] == ("layer",)) // cfg.n_units
    flags = _pattern_moe_flags(cfg)
    parts = {"params_grads_moments": 16 * n,
             "clip_scaled_copy": 4 * n,
             "adamw_temporaries_largest_block": 12 * max(local),
             "unit_inputs": cfg.n_units * tokens * cfg.d_model * 2,
             "logits_and_grad": 2 * tokens * v_loc * (2 + 4),
             "loss_temporary": 4 * tokens * v_loc,
             "unit_recompute": sum(
                 layer_train_bytes(cfg, kind, flags[i], tokens)
                 for i, kind in enumerate(cfg.pattern)),
             "gathered": 2 * 2 * unit + 2 * 4 * v_loc * cfg.d_model}
    parts["total"] = sum(parts.values())
    return parts


def cut_units(params: dict, n_units: int) -> dict:
    """The parameter tree of the first `n_units` units: views of the
    stacked blocks, the embedding, final norm and head as they are."""
    from repro_torch.nn.params import tree_map
    return {**params, "blocks": tree_map(lambda t: t[:n_units],
                                         params["blocks"])}


def lm_mesh_run(name: str, res: list, cfg, rules_name: str, seq: int,
                want_losses, tol: float) -> dict:
    """Phase 19's gates on one `lm_rank` run of LM_TRAIN_BATCH x `seq`
    batches (19a-19c, and 19d's and 19e's step 0): every
    rank's losses finite and equal, each within `tol` (relative) of
    `want_losses` where given; each rank's flash-attention launches a step
    (two forward launches an attention layer under remat "full", one
    backward) and no other kernel; each step's `Mesh.stats` calls equal to
    `lm_step_collectives`; each rank's peak under `lm_mesh_reckoning`; no
    jax or reference module. Returns its numbers: tokens/s over steps 1 on
    (the slowest rank's host ms a step), host, collective, device span and
    device-busy ms a step by rank, each collective's calls, bytes and ms a
    step, the peaks beside the reckoning, the launches."""
    import numpy as np
    from types import SimpleNamespace

    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.nn import sharding
    from repro_torch.train.steps import lm_step_collectives
    rules = getattr(sharding, rules_name)
    shape, names = LM_MESH
    mesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    want_calls = lm_step_collectives(cfg, rules, mesh)
    n_attn = cfg.pattern.count("a") * cfg.n_units
    again = 2 if cfg.remat == "full" else 1
    want_launch = {"flash_attention": again * n_attn,
                   "flash_attention_bwd": n_attn}
    reckon = lm_mesh_reckoning(cfg, rules, LM_TRAIN_BATCH, seq)
    losses = res[0]["losses"]
    for r in res:
        if r["losses"] != losses or not np.isfinite(losses).all():
            raise AssertionError(f"{name}: rank {r['rank']} losses "
                                 f"{r['losses']} against rank 0's {losses}")
        for t, counts in enumerate(r["launches"]):
            got = {k: v for k, v in counts.items() if v}
            if got != {k: v for k, v in want_launch.items() if v}:
                raise AssertionError(f"{name} rank {r['rank']} step {t}: "
                                     f"launches {got}, want {want_launch}")
        for t, st in enumerate(r["collectives"]):
            got = {k[:-len("_calls")]: v for k, v in st.items()
                   if "@" in k and k.endswith("_calls") and v}
            if got != want_calls:
                raise AssertionError(f"{name} rank {r['rank']} step {t}: "
                                     f"collectives {got}, want {want_calls}")
        if r["peak_bytes"] is None or r["peak_bytes"] > reckon["total"]:
            raise AssertionError(f"{name} rank {r['rank']}: peak "
                                 f"{r['peak_bytes']} over the reckoning "
                                 f"{reckon}")
        if r["foreign_modules"]:
            raise AssertionError(f"{name} rank {r['rank']} loaded "
                                 f"{r['foreign_modules']}")
    rel = None
    if want_losses is not None:
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
        if max(rel) > tol:
            raise AssertionError(f"{name}: losses {losses} against "
                                 f"{want_losses[:len(losses)]}: relative "
                                 f"{rel}, tolerance {tol}")
    n = len(losses)
    later = slice(1, n) if n > 1 else slice(0, n)
    slowest = [max(r["host_ms"][t] for r in res) for t in range(n)]
    tokens = LM_TRAIN_BATCH * seq

    def per_step(key):
        return float(np.mean([c[key] for r in res
                              for c in r["collectives"][later]]))
    nums = {"card": CARD, "rules": rules_name, "layers": cfg.n_layers,
            "compute_dtype": cfg.compute_dtype, "losses": losses,
            "want_losses": want_losses, "loss_rel_err": rel,
            "tokens_per_s_steps_1_on": tokens * len(slowest[later])
            / sum(slowest[later]) * 1e3,
            "host_ms_per_step_by_rank": [r["host_ms"] for r in res],
            "device_span_ms_per_step_by_rank": [r["device_span_ms"]
                                                for r in res],
            "device_busy_ms_per_step_by_rank": [
                r["device_busy_ms_per_step"] for r in res],
            "collective_ms_per_step": per_step("all_reduce_ms")
            + per_step("all_gather_ms") + per_step("reduce_scatter_ms"),
            "collectives_per_step": {
                op: {"calls": per_step(f"{op}_calls"),
                     "bytes": per_step(f"{op}_bytes"),
                     "ms": per_step(f"{op}_ms")} for op in COLLECTIVES},
            "calls_by_axis_per_step": want_calls,
            "param_block_bytes_by_rank": [r["param_bytes"] for r in res],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in res],
            "reckoning_bytes": reckon,
            "launches_per_step": want_launch,
            "launches": {k: sum(c[k] for r in res for c in r["launches"])
                         for k in res[0]["launches"][0]},
            "launches_per_rank": [{k: sum(c[k] for c in r["launches"])
                                   for k in r["launches"][0]} for r in res]}
    log(f"  {name} ({rules_name}): " + json.dumps(
        {k: v for k, v in nums.items() if k != "launches_per_rank"}))
    return nums


def lm_mesh_grads(name: str, res: list, want_loss: float, loss_tol: float,
                  paths: list[str], limits: list[float],
                  faults: dict | None = None) -> dict:
    """19d's and 19e's gradient gate: step 0's loss on every rank within
    loss_tol (relative) of the one-device step's, and each leaf's
    gradient, put together from every rank's blocks (each block once,
    from its first holder), within limits[i] relative L2 of the gradient
    the ranks were given (the one-device step's; for a bf16 arm the fp32
    one's). `faults` holds, by name, what a fault reads on each leaf (the
    one-device step's own): printed beside the limits, the farthest leaf
    over its limit. Returns the errors and those readings."""
    import numpy as np
    losses = [r["losses"][0] for r in res]
    loss_rel = max(abs(x - want_loss) / abs(want_loss) for x in losses)
    err, ref = np.zeros(len(paths)), np.zeros(len(paths))
    for r in res:
        for i, e in enumerate(r["grad_errors"]):
            if e["owner"]:
                err[i] += e["err_sq"]
                ref[i] += e["ref_sq"]
    rel = np.sqrt(err) / np.maximum(np.sqrt(ref), 1e-30)
    over = rel / np.asarray(limits)
    worst = int(np.argmax(over))
    nums = {"loss": losses[0], "want_loss": want_loss,
            "loss_rel_err": loss_rel, "grad_rel_l2_worst": float(rel[worst]),
            "worst_leaf": paths[worst], "worst_leaf_limit": limits[worst],
            "grad_rel_l2": {p: float(x) for p, x in zip(paths, rel)},
            "loss_tolerance": loss_tol, "faults": {}}
    for fault, reading in (faults or {}).items():
        ratio = np.asarray(reading) / np.asarray(limits)
        k = int(np.argmax(ratio))
        nums["faults"][fault] = {"leaf": paths[k], "reading": reading[k],
                                 "over_limit": float(ratio[k]),
                                 "least_over_limit": float(ratio.min())}
        log(f"  {name}: {fault} would read {reading[k]:.3e} on {paths[k]}, "
            f"{ratio[k]:.3g} times its limit {limits[k]:.3e} (the farthest "
            f"leaf); the sound run's farthest, {rel[worst]:.3e}, "
            f"{over[worst]:.3g} times")
    log(f"  {name}: loss {losses[0]} vs one-device {want_loss} (rel "
        f"{loss_rel:.3e}, tolerance {loss_tol}); gradient {paths[worst]} "
        f"rel L2 {rel[worst]:.3e} against its limit {limits[worst]:.3e}, "
        f"the nearest any leaf comes")
    if not (np.isfinite(losses).all() and loss_rel <= loss_tol
            and over[worst] <= 1.0):
        raise AssertionError(f"{name}: the sharded step's loss or a "
                             f"gradient is off the one-device step's: "
                             f"{json.dumps(nums)}")
    return nums


def lm_mesh_params(name: str, res: list, cfg, want: dict) -> dict:
    """19a-19d's parameter gate: the final parameters, put together from
    every rank's blocks (each block once, from its first holder), no
    farther from the one-device run's (`want`, `lm_mesh_phase`'s oracle)
    than TOL_LM_MESH_PARAMS of the compute dtype times that run's last
    update: each leaf's in fp32, the whole tree's in bf16. Returns the
    readings: each leaf's distance over its last update, and the whole
    tree's."""
    import numpy as np

    from repro_torch.models.lm import lm_param_specs
    paths = ["/".join(p) for p in leaf_paths(lm_param_specs(cfg))]
    tol = TOL_LM_MESH_PARAMS[cfg.compute_dtype]
    err = np.zeros(len(paths))
    for r in res:
        for i, e in enumerate(r["param_errors"]):
            if e["owner"]:
                err[i] += e["err_sq"]
    err, last = np.sqrt(err), np.asarray(want["last_update"])
    share = np.where(last > 0, err / np.maximum(last, 1e-30),
                     np.where(err > 0, np.inf, 0.0))
    worst = int(np.argmax(share))
    nums = {"worst_leaf": paths[worst],
            "dist_over_last_update_worst": float(share[worst]),
            "dist_over_last_update_tree": float(
                np.linalg.norm(err) / np.linalg.norm(last)),
            "tolerance": tol,
            "dist_over_last_update": {p: float(x)
                                      for p, x in zip(paths, share)}}
    held = ("leaf" if cfg.compute_dtype == "float32" else "tree")
    nums["held"] = held
    reading = (share[worst] if held == "leaf"
               else nums["dist_over_last_update_tree"])
    log(f"  {name} parameters after {len(want['losses'])} steps vs one "
        f"device: {paths[worst]} at {share[worst]:.3e} of its last update, "
        f"the farthest leaf; the whole tree at "
        f"{nums['dist_over_last_update_tree']:.3e} (the {held} held to "
        f"{tol})")
    if not reading <= tol:
        raise AssertionError(f"{name}: the sharded run's parameters are "
                             f"off the one-device run's: {json.dumps(nums)}")
    return nums


def lm_mesh_phase(torch, dev, cfg, losses_14b: list, world,
                  serve: dict | None = None) -> dict:
    """Phase 19 (the module docstring): the attention kernels at a rank's
    shapes; the one-device oracles (19a-19d's runs, their final parameters
    in files the ranks read; 19d's and 19e's step-0 gradients); `world`'s
    4 ranks (`spawn_world`, spawned before this phase, so they import
    while it checks the kernels and runs the oracles) running 19a-19e in
    one call over CUDA IPC views of the parent's parameters and oracle
    gradients, then, with `serve` (phase 20's one-device oracles by phase:
    "9b", "16a", "16b"), phase 20's runs in the same call. Returns each
    run's numbers and the flash numbers."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch import train as train_cli
    from repro_torch.models.lm import init_lm_params, lm_param_specs
    from repro_torch.nn.params import tree_leaves, tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.sharded import lm_rank, save_flat_params
    from repro_torch.train.steps import build_lm_train_step
    t_phase = time.perf_counter()
    out = {}
    shapes = (("rank_19a_19c", (LM_TRAIN_BATCH // 2, cfg.n_heads // 2,
                                 LM_TRAIN_SEQ, cfg.d_head), "bfloat16"),
              ("rank_19b", (LM_TRAIN_BATCH // 4, cfg.n_heads, LM_TRAIN_SEQ,
                            cfg.d_head), "bfloat16"))
    log("phase 19: flash_attention and flash_attention_bwd vs plain at a "
        "rank's shapes: " + ", ".join(f"{n} {s}" for n, s, _ in shapes))
    out["flash"] = check_flash_attention_bwd(torch, dev, shapes=shapes)
    free_device(torch)
    if serve is not None:
        log(f"phase 20: flash_attention vs plain at a serving rank's prefill "
            f"shape {FLASH_SERVE_RANK_SHAPE} bfloat16")
        out["flash_serve"] = check_flash_shape(
            torch, dev, "rank_20a", FLASH_SERVE_RANK_SHAPE, "bfloat16")
        free_device(torch)

    def on_dev(batch):
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def one_device(c, params, batch):
        """The one-device step's (loss, gradients) at step 0."""
        step = build_lm_train_step(c, adamw(3e-4))
        loss, _, grads = step.value_and_grads(params, on_dev(batch))
        return float(loss), grads

    def oracle(c, params, batches, name):
        """The one-device run of `batches` from `params` (updated in
        place): its losses, its final parameters written to a file under
        runs/ (`save_flat_params`: the ranks read their blocks) and, a
        leaf in `lm_param_specs` order, the norm of its last update."""
        opt = adamw(3e-4)
        state, step = opt.init(params), build_lm_train_step(c, opt)
        losses, prev = [], None
        for t, b in enumerate(batches):
            if t == len(batches) - 1:
                prev = tree_map(lambda x: x.clone(), params)
            params, state, m = step(params, state, on_dev(b), t)
            losses.append(float(m["loss"]))
        specs = lm_param_specs(c)
        last = [float((x - y).norm()) for x, y in zip(
            tree_leaves(tree_map(lambda s, x: x, specs, params)),
            tree_leaves(tree_map(lambda s, x: x, specs, prev)))]
        path = os.path.join(flat_dir, f"{name}.f32")
        save_flat_params(params, c, path)
        del params, state, step, m, prev
        gc.collect()
        torch.cuda.empty_cache()
        return {"losses": losses, "last_update": last, "path": path}

    # the ranks draw 14b's parameters themselves (`lm_rank`'s seed): the
    # parent holds only what 19d and 19e compare against while they train
    full = init_lm_params(cfg, train_cli.PARAM_SEED, dev)
    batches = [make_lm_batch(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, t, 0)
               for t in range(LM_MESH_STEPS)]
    cut = dataclasses.replace(cfg, n_layers=LM_MESH_LAYERS)
    grad_cfg = dataclasses.replace(cfg, n_layers=LM_MESH_GRAD_LAYERS,
                                   compute_dtype="float32")
    grad_params = tree_map(lambda t: t.clone(),
                           cut_units(full, grad_cfg.n_units))
    grad_batches = [make_lm_batch(grad_cfg, LM_TRAIN_BATCH,
                                  LM_MESH_GRAD_SEQ, t, 0)
                    for t in range(LM_MESH_GRAD_STEPS)]
    # the oracles the ranks' final parameters are held to: 19a-19c's at
    # the cut depth and 19d's, each on copies
    log(f"phase 19's oracles: build_lm_train_step on one device, "
        f"{cfg.name} at {cut.n_layers} layers ({LM_MESH_STEPS} steps), at "
        f"{grad_cfg.n_layers} in fp32 ({LM_MESH_GRAD_STEPS} steps)")
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    flat_dir = tempfile.mkdtemp(prefix="chip_smoke_lm_mesh_",
                                dir=os.path.join(ROOT, "runs"))
    want = {"cut": oracle(cut, tree_map(lambda t: t.clone(), cut_units(
                full, cut.n_units)), batches, "cut"),
            "19d": oracle(grad_cfg, tree_map(lambda t: t.clone(),
                                             grad_params),
                          grad_batches, "19d")}
    del full
    gc.collect()
    torch.cuda.empty_cache()
    losses_c = want["cut"]["losses"]
    # 19d's and 19e's gradient oracles: step 0's loss and gradients
    grad_loss, grad_want = one_device(grad_cfg, grad_params,
                                      grad_batches[0])
    # 19e: the fp32 arm is held to the one-device fp32 step, each gradient
    # within TOL_LM_TRAIN["float32"] or LM_MESH_SPLIT_FACTOR times the
    # one-device step's own distance from the mean of its two batch
    # halves' gradients (what the data ranks sum), whichever is larger: on
    # the card a half batch's products round otherwise, and mamba2's
    # A_log gradient, a sum that cancels to 1e-3 of its terms, moves by
    # 1e-3 with them; the bf16 arm's loss to the one-device bf16 loss and
    # its gradients to the fp32 ones, no farther than the one-device bf16
    # gradients are, x1.5 + 0.01 (the CPU tests' bf16 bound: at init a
    # unit's bf16 gradients sit ~20% from fp32)
    zoo = []
    for arch in (MOE_TRAIN_ARCH, SSM_ARCH):
        base = get_config(arch)
        c = dataclasses.replace(base, n_layers=len(base.pattern),
                                moe_groups=LM_MESH_MOE_GROUPS)
        p = init_lm_params(c, ZOO_PARAM_SEED, dev)
        b = make_lm_batch(c, LM_TRAIN_BATCH, LM_MESH_ZOO_SEQ, 0, 0)
        c16, c32 = (dataclasses.replace(c, compute_dtype=dt)
                    for dt in ("bfloat16", "float32"))
        loss16, g16 = one_device(c16, p, b)
        loss32, g32 = one_device(c32, p, b)
        base16 = [rel_l2(a.float(), w) for a, w in zip(tree_leaves(g16),
                                                       tree_leaves(g32))]
        half = LM_TRAIN_BATCH // 2
        # the split's rounding alone: without the aux loss, whose means over
        # half a batch are another function, and each half with half the
        # MoE groups, the same groups as the whole batch's
        c0 = dataclasses.replace(c32, aux_loss_coef=0.0)
        ch = dataclasses.replace(c0, moe_groups=max(1, c0.moe_groups // 2))
        _, g0 = one_device(c0, p, b)
        _, h0 = one_device(ch, p, {k: v[:half] for k, v in b.items()})
        _, h1 = one_device(ch, p, {k: v[half:] for k, v in b.items()})
        split = [rel_l2((x + y) / 2, w) for x, y, w in zip(
            tree_leaves(h0), tree_leaves(h1), tree_leaves(g0))]
        # what a fault reads against the limits: one data rank's half
        # alone (a lost sum over `data`), and bf16 compute for fp32
        lost = [rel_l2(x, w) for x, w in zip(tree_leaves(h0),
                                             tree_leaves(g0))]
        del g16, g0, h0, h1
        zoo.append((f"19e {arch} bfloat16", c16, p, b, loss16, g32,
                    TOL_LM_TRAIN["bfloat16"][0],
                    [1.5 * x + 0.01 for x in base16],
                    {"lost_data_sum": lost}))
        zoo.append((f"19e {arch} float32", c32, p, b, loss32, g32,
                    TOL_LM_TRAIN["float32"][0],
                    [max(TOL_LM_TRAIN["float32"][1],
                         LM_MESH_SPLIT_FACTOR * x) for x in split],
                    {"lost_data_sum": lost, "bf16_compute": base16}))
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()         # the oracles' cached blocks
    log(f"  oracles: 19a-19c losses {losses_c}; 19d loss {grad_loss}; 19e "
        + ", ".join(f"{z[0]} {z[4]}" for z in zoo)
        + f"; parent allocated {torch.cuda.memory_allocated()} bytes, "
        f"reserved {torch.cuda.memory_reserved()}")
    # one world: 19a-19d train and are held to their oracles' final
    # parameters, 19d and 19e to step 0's gradients
    seed = {"seed": train_cli.PARAM_SEED, "init_cfg": cfg,
            "log_steps": True}
    calls = [(lm_rank, {"cfg": cut, "rules": r, "batches": batches,
                        "profile_steps": int(r != "TRAIN_RULES"),
                        "want_params": want["cut"]["path"], **seed})
             for r in LM_MESH_TABLES]
    calls += [(lm_rank, {"cfg": grad_cfg, "rules": r, "params": grad_params,
                         "batches": grad_batches, "want_grads": grad_want,
                         "want_params": want["19d"]["path"]})
              for r in LM_MESH_TABLES]
    calls += [(lm_rank, {"cfg": cd, "rules": "FSDP_RULES", "params": p,
                         "batches": [b], "want_grads": grads})
              for _, cd, p, b, _, grads, _, _, _ in zoo]
    n19 = len(calls)
    if serve is not None:
        calls += lm_serve_calls(serve)
    log(f"phase 19a-19e: 4 gloo ranks on this card, mesh {LM_MESH}: "
        f"19a FSDP_RULES, 19b ZERO_DP_RULES and 19c TRAIN_RULES at "
        f"{cut.n_layers} layers ({LM_MESH_STEPS} steps of "
        f"{LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}); 19d at "
        f"{LM_MESH_GRAD_LAYERS} layers, {LM_MESH_GRAD_SEQ} positions, fp32, "
        f"{LM_MESH_GRAD_STEPS} steps under {LM_MESH_TABLES}; 19e "
        f"{MOE_TRAIN_ARCH} and {SSM_ARCH} at one unit under FSDP_RULES, "
        f"bf16 and fp32" + ("" if serve is None else
                            "; then phase 20 in the same world"))
    try:
        res, out["world"] = rank_world(torch, dev, "phase 19", calls, 4,
                                       timeout_s=LM_MESH_TIMEOUT_S,
                                       world=world)
    finally:
        shutil.rmtree(flat_dir, ignore_errors=True)
    log(f"  19a-19c's oracle (one device, {cut.n_layers} layers) losses "
        f"{losses_c}; 14b's at full depth {losses_14b}")
    for i, name in enumerate(("19a", "19b", "19c")):
        out[name] = lm_mesh_run(name, res[i], cut, LM_MESH_TABLES[i],
                                LM_TRAIN_SEQ, losses_c, TOL_LM_MESH_LOSS)
        out[name]["params"] = lm_mesh_params(name, res[i], cut, want["cut"])
    paths = ["/".join(p) for p in leaf_paths(grad_want)]
    for i, r in enumerate(LM_MESH_TABLES):
        out[f"19d {r}"] = lm_mesh_grads(
            f"19d {r}", res[3 + i], grad_loss, TOL_LM_TRAIN["float32"][0],
            paths, [TOL_LM_TRAIN["float32"][1]] * len(paths))
        out[f"19d {r}"]["run"] = lm_mesh_run(
            "19d", res[3 + i], grad_cfg, r, LM_MESH_GRAD_SEQ,
            want["19d"]["losses"], TOL_LM_TRAIN["float32"][0])
        out[f"19d {r}"]["params"] = lm_mesh_params(
            f"19d {r}", res[3 + i], grad_cfg, want["19d"])
    for i, (name, cd, p, _, loss, grads, loss_tol, limits,
            faults) in enumerate(zoo):
        res_e = res[3 + len(LM_MESH_TABLES) + i]
        out[name] = lm_mesh_grads(name, res_e, loss, loss_tol,
                                  ["/".join(q) for q in leaf_paths(grads)],
                                  limits, faults)
        out[name]["run"] = lm_mesh_run("19e", res_e, cd, "FSDP_RULES",
                                       LM_MESH_ZOO_SEQ,
                                       None, 0.0)
    if serve is not None:
        out.update(lm_serve_results(res[n19:], serve))
    del grad_params, grad_want, zoo, calls, res
    release_shared(torch, dev)
    free_device(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phases 19 and 20 took {out['phase_s']:.1f} s")
    return out


def lm_serve_reckoning(cfg, rules: dict, mesh_spec, batch: int, seq: int,
                       max_len: int) -> dict:
    """A serving rank's device memory by the reckoning (bytes): its fp32
    parameter blocks (`NamedSharding.local_shape` of each leaf's
    `resolve_sized` spec), its blocks of the caches (`init_caches(rules=,
    mesh=)` on the meta device, `cache_pspecs`' blocks but a mixer's conv
    tail), the one-device path's transients at batch x seq tokens
    (`zoo_reckoning_bytes`' largest layer's bf16 casts, logits and
    largest layer transient, each an upper bound for a rank's share), and
    the collectives' device buffers: four (tokens, d) partial-sum copies
    and, where the cache splits by positions, the prompt's K and V
    gathered whole twice over."""
    from types import SimpleNamespace

    from repro_torch.models.lm import init_caches, lm_param_specs
    from repro_torch.nn.layers import kv_cache_spec
    from repro_torch.nn.params import tree_leaves
    from repro_torch.nn.sharding import NamedSharding, dim_axes, resolve_sized
    shape, names = mesh_spec
    mesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)),
                           coords={a: 0 for a in names})
    blocks = sum(4 * math.prod(NamedSharding(mesh, resolve_sized(
        s.logical_axes, rules, mesh, s.shape)).local_shape(s.shape))
        for s in tree_leaves(lm_param_specs(cfg)))
    caches = init_caches(cfg, batch, max_len, "meta", rules, mesh)
    tokens = batch * seq
    one = zoo_reckoning_bytes(cfg, tokens)
    coll = 4 * tokens * cfg.d_model * 2
    if "a" in cfg.pattern and dim_axes(kv_cache_spec(
            rules, mesh, batch, max_len, cfg.n_kv_heads, cfg.d_head), 1):
        coll += 4 * tokens * cfg.n_kv_heads * cfg.d_head * 2
    parts = {"param_blocks_fp32": blocks,
             "cache_blocks": sum(t.numel() * t.element_size()
                                 for c in caches.values()
                                 for t in c.values()),
             **{k: one[k] for k in ("largest_layer_bf16_casts",
                                    "logits_bf16",
                                    "largest_layer_transient")},
             "collective_buffers": coll}
    parts["total"] = sum(parts.values())
    return parts


def lm_serve_calls(oracles: dict) -> list:
    """Phase 20's `lm_serve_rank` jobs: 20a-20d (LM_SERVE_RUNS) fed the
    one-device run's tokens, then 20e's engine."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.launch import serve as serve_cli
    from repro_torch.train.sharded import lm_serve_rank
    calls = []
    for name, arch, rules, phase, seed, dtype in LM_SERVE_RUNS:
        cfg = dataclasses.replace(get_config(arch), compute_dtype=dtype)
        calls.append((lm_serve_rank, {
            "cfg": cfg, "rules": rules, "mesh": LM_SERVE_MESH,
            "seed": seed, "prompt": make_lm_batch(cfg, 1, LM_PROMPT)[
                "tokens"],
            "max_len": LM_SERVE_MESH_MAX_LEN,
            "decode": LM_SERVE_MESH_DECODE,
            "feed": [[t] for t in
                     oracles[phase]["fed"][:LM_SERVE_MESH_DECODE]],
            "report_logits": "first"}))
    cfg, reqs, slots, max_len = lm_serve_engine_setup()
    calls.append((lm_serve_rank, {
        "cfg": cfg, "rules": "SERVE_RULES", "mesh": LM_SERVE_ENGINE_MESH,
        "seed": serve_cli.PARAM_SEED, "init_cfg": get_config(SSM_ARCH),
        "report_logits": False,
        "engine": {"slots": slots, "max_len": max_len, "alone": True,
                   "requests": reqs}}))
    return calls


def lm_serve_engine_setup():
    """20e's config (fp32 compute, LM_SERVE_ENGINE_LAYERS layers),
    requests (uid, prompt, budget), slots and max_len: ZOO_SERVE_ARGV's,
    as 16d serves them."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_cli
    argv = ZOO_SERVE_ARGV

    def arg(flag, n=1):
        i = argv.index(flag)
        vals = [int(v) if v.isdigit() else v for v in argv[i + 1:i + 1 + n]]
        return vals if n > 1 else vals[0]
    cfg = dataclasses.replace(get_config(arg("--arch")),
                              compute_dtype=arg("--compute-dtype"),
                              n_layers=LM_SERVE_ENGINE_LAYERS)
    reqs = [(r.uid, r.prompt, r.max_new_tokens) for r in
            serve_cli.lm_requests(cfg, arg("--requests"),
                                  tuple(arg("--prompt-len", 2)),
                                  arg("--new-tokens"))]
    return cfg, reqs, arg("--slots"), arg("--max-len")


def lm_serve_results(res: list, oracles: dict) -> dict:
    """Phase 20's gates and numbers on the world's reports (the module
    docstring): 20a-20d by `lm_serve_mesh_run`, 20e by
    `lm_serve_engine_run`."""
    from repro_torch.configs import get_config
    out = {}
    for i, (name, arch, rules, phase, _, dtype) in enumerate(LM_SERVE_RUNS):
        out[name] = lm_serve_mesh_run(
            name, res[i], dataclasses.replace(get_config(arch),
                                              compute_dtype=dtype),
            rules, oracles[phase])
    out["20e"] = lm_serve_engine_run(res[len(LM_SERVE_RUNS)])
    return out


def _launch_totals(res: list) -> tuple[dict, list]:
    """Each kernel's launches over every rank and step, and by rank."""
    per_rank = [{k: sum(c[k] for c in r["launches"]) for k in
                 r["launches"][0]} for r in res]
    return {k: sum(p[k] for p in per_rank) for k in per_rank[0]}, per_rank


def blocks_held(name: str, r: dict, reckon: dict) -> None:
    """A serving rank holds its blocks and nothing more: its parameter
    bytes exactly the reckoning's fp32 parameter blocks, its cache bytes
    exactly the reckoning's cache blocks (`lm_serve_reckoning`, from the
    same specs)."""
    got = {"param_blocks_fp32": r["param_bytes"],
           "cache_blocks": r["cache_bytes"]}
    want = {k: reckon[k] for k in got}
    if got != want:
        raise AssertionError(f"{name} rank {r['rank']} holds {got} bytes, "
                             f"its blocks {want}")


def lm_serve_mesh_run(name: str, res: list, cfg, rules_name: str,
                      oracle: dict) -> dict:
    """Phase 20's gates on one serving run (20a-20d): every rank's logits
    bit-equal to rank 0's; rank 0's, each step, within
    TOL_LM_SERVE_MESH_REL_L2 of the one-device run's (relative L2,
    printed), and its argmax the oracle's wherever the oracle's top-2
    margin exceeds twice the step's largest difference; each rank's
    flash-attention launches exactly one a layer in the prefill and none
    in decode, no other kernel; each step's `Mesh.stats` calls equal to
    `serve.sharded.lm_serve_collectives`; each rank's parameter and cache
    bytes exactly its blocks (`blocks_held`) and its peak under
    `lm_serve_reckoning`; no jax or reference module. Returns its
    numbers."""
    import numpy as np
    import torch
    from types import SimpleNamespace

    from repro_torch.launch.mesh import COLLECTIVES
    from repro_torch.nn import sharding
    from repro_torch.serve.sharded import lm_serve_collectives
    rules = getattr(sharding, rules_name)
    shape, names = LM_SERVE_MESH
    mesh = SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    n_attn = cfg.pattern.count("a") * cfg.n_units
    reckon = lm_serve_reckoning(cfg, rules, LM_SERVE_MESH, 1, LM_PROMPT,
                                LM_SERVE_MESH_MAX_LEN)
    first = next(r for r in res if r["rank"] == 0)
    want_calls = {mode: lm_serve_collectives(cfg, rules, mesh, mode,
                                             LM_SERVE_MESH_MAX_LEN)
                  for mode in ("prefill", "decode")}
    for r in res:
        if r["logits_bits"] != first["logits_bits"]:
            raise AssertionError(f"{name}: rank {r['rank']}'s logits differ "
                                 "from rank 0's")
        for t, counts in enumerate(r["launches"]):
            got = {k: v for k, v in counts.items() if v}
            want = {"flash_attention": n_attn} if t == 0 and n_attn else {}
            if got != want:
                raise AssertionError(f"{name} rank {r['rank']} step {t}: "
                                     f"launches {got}, want {want}")
        for t, st in enumerate(r["collectives"]):
            got = {k[:-len("_calls")]: v for k, v in st.items()
                   if "@" in k and k.endswith("_calls") and v}
            want = want_calls["prefill" if t == 0 else "decode"]
            if got != want:
                raise AssertionError(f"{name} rank {r['rank']} step {t}: "
                                     f"collectives {got}, want {want}")
        blocks_held(name, r, reckon)
        if r["peak_bytes"] is None or r["peak_bytes"] > reckon["total"]:
            raise AssertionError(f"{name} rank {r['rank']}: peak "
                                 f"{r['peak_bytes']} over the reckoning "
                                 f"{reckon}")
        if r["foreign_modules"]:
            raise AssertionError(f"{name} rank {r['rank']} loaded "
                                 f"{r['foreign_modules']}")
    want_logits = [oracle["last"]] + list(
        oracle["logits"][:LM_SERVE_MESH_DECODE])
    rel, err, margins = [], [], []
    for t, (g, w) in enumerate(zip(first["logits"], want_logits)):
        g, w = torch.from_numpy(g).float(), w.float()
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{name} step {t}: logits {tuple(g.shape)} "
                                 f"not finite or not {tuple(w.shape)}")
        rel.append(rel_l2(g, w))
        err.append(float((g - w).abs().max()))
        top = w.topk(2, dim=-1).values
        margin = float((top[..., 0] - top[..., 1]).min())
        margins.append(margin)
        if margin > 2 * err[-1] and not torch.equal(g.argmax(-1),
                                                    w.argmax(-1)):
            raise AssertionError(f"{name} step {t}: argmax "
                                 f"{g.argmax(-1).tolist()} against "
                                 f"{w.argmax(-1).tolist()} at a margin of "
                                 f"{margin} > 2 x {err[-1]}")
    log(f"  {name}: each step's logits against the one-device run's, "
        f"relative L2 (tol {TOL_LM_SERVE_MESH_REL_L2}): "
        f"{[float('%.4g' % x) for x in rel]}")
    if len(rel) != LM_SERVE_MESH_DECODE + 1 or \
            max(rel) > TOL_LM_SERVE_MESH_REL_L2:
        raise AssertionError(f"{name}: the mesh's logits disagree with the "
                             f"one-device run's: {rel}")
    launches, per_rank = _launch_totals(res)

    def mean(key, steps):
        return float(np.mean([r["collectives"][t][key] for r in res
                              for t in steps]))
    dec = range(1, LM_SERVE_MESH_DECODE + 1)
    nums = {"card": CARD, "rules": rules_name, "mesh": LM_SERVE_MESH[0],
            "layers": cfg.n_layers, "compute_dtype": cfg.compute_dtype,
            "prompt": LM_PROMPT, "decode_steps": LM_SERVE_MESH_DECODE,
            "max_len": LM_SERVE_MESH_MAX_LEN,
            "rel_l2_by_step": rel, "max_abs_err_by_step": err,
            "oracle_top2_margin_by_step": margins,
            "argmax_agrees_by_step": [
                int(np.argmax(g)) == int(w.argmax())
                for g, w in zip(first["logits"], want_logits)],
            "prefill_host_ms_by_rank": [r["host_ms"][0] for r in res],
            "decode_host_ms_per_token_slowest_rank": float(np.mean(
                [max(r["host_ms"][t] for r in res) for t in dec])),
            "prefill_collectives": {op: {
                "calls": mean(f"{op}_calls", [0]),
                "bytes": mean(f"{op}_bytes", [0]),
                "ms": mean(f"{op}_ms", [0])} for op in COLLECTIVES},
            "decode_collectives_per_step": {op: {
                "calls": mean(f"{op}_calls", dec),
                "bytes": mean(f"{op}_bytes", dec),
                "ms": mean(f"{op}_ms", dec)} for op in COLLECTIVES},
            "calls_by_axis": want_calls,
            "param_block_bytes_by_rank": [r["param_bytes"] for r in res],
            "cache_block_bytes_by_rank": [r["cache_bytes"] for r in res],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in res],
            "reckoning_bytes": reckon, "launches": launches,
            "launches_per_rank": per_rank}
    log(f"  {name} numbers: " + json.dumps(
        {k: v for k, v in nums.items() if k not in (
            "launches_per_rank", "max_abs_err_by_step",
            "oracle_top2_margin_by_step", "argmax_agrees_by_step")}))
    return nums


def lm_serve_engine_run(res: list) -> dict:
    """Phase 20e's gates: every rank completes every request with its
    full budget, rank 0's tokens on every rank, each request's tokens
    those of the same request served alone by a fresh engine on the mesh
    (the same product shapes, so the same bits; a state carried over from
    a slot's last request moves them), no kernel launched, each rank's
    parameter and cache bytes exactly its blocks (`blocks_held`: the
    caches of its slots' rows) and its peak under `lm_serve_reckoning`,
    no jax or reference module."""
    from repro_torch.nn import sharding
    cfg, reqs, slots, max_len = lm_serve_engine_setup()
    reckon = lm_serve_reckoning(cfg, sharding.SERVE_RULES,
                                LM_SERVE_ENGINE_MESH, slots, max_len,
                                max_len)
    first = next(r for r in res if r["rank"] == 0)["engine"]
    done = first["completed"]
    budget = {uid: min(b, max_len - len(p)) for uid, p, b in reqs}
    if sorted(done) != sorted(budget) or any(
            len(done[u]) != budget[u] for u in budget):
        raise AssertionError(f"20e: not every request got its tokens: "
                             f"{ {u: len(v) for u, v in done.items()} }")
    for r in res:
        e = r["engine"]
        if e["completed"] != done or e["alone"] != done:
            raise AssertionError(f"20e rank {r['rank']}: tokens differ "
                                 f"from rank 0's or from the requests "
                                 f"served alone: {e}")
        blocks_held("20e", r, reckon)
        if r["peak_bytes"] is None or r["peak_bytes"] > reckon["total"]:
            raise AssertionError(f"20e rank {r['rank']}: peak "
                                 f"{r['peak_bytes']} over {reckon}")
        if r["foreign_modules"]:
            raise AssertionError(f"20e rank {r['rank']} loaded "
                                 f"{r['foreign_modules']}")
    launches, per_rank = _launch_totals(res)
    if any(launches.values()):
        raise AssertionError(f"20e launched kernels: {launches}")
    tokens = sum(len(v) for v in done.values())
    nums = {"card": CARD, "mesh": LM_SERVE_ENGINE_MESH[0], "slots": slots,
            "requests": len(reqs), "tokens": tokens,
            "engine_steps": first["steps"], "host_s": first["host_s"],
            "tok_per_s": tokens / first["host_s"],
            "param_block_bytes_by_rank": [r["param_bytes"] for r in res],
            "cache_block_bytes_by_rank": [r["cache_bytes"] for r in res],
            "peak_bytes_by_rank": [r["peak_bytes"] for r in res],
            "reckoning_bytes": reckon, "launches": launches,
            "launches_per_rank": per_rank, "generated": done}
    log("  20e numbers: " + json.dumps(
        {k: v for k, v in nums.items() if k != "launches_per_rank"}))
    return nums


def dry_held(name: str, dry: int, card: int, reckoned: int) -> dict:
    """Phase 21's peak gate: the dry run's peak within DRY_PEAK_BAND of
    the card's (relative); both printed beside the reckoning."""
    rel = (dry - card) / card
    nums = {"dry_peak_bytes": dry, "card_peak_bytes": card,
            "dry_over_card": dry / card, "reckoning_bytes": reckoned,
            "band": DRY_PEAK_BAND}
    log(f"  {name}: dry-run peak {dry / 1e9:.3f} GB, card "
        f"{card / 1e9:.3f} GB ({rel:+.1%}, band {DRY_PEAK_BAND:.0%}); "
        f"the reckoning {reckoned / 1e9:.3f} GB")
    if abs(rel) > DRY_PEAK_BAND:
        raise AssertionError(f"{name}: the dry run's peak {dry} is off the "
                             f"card's {card}: {json.dumps(nums)}")
    return nums


def dry_kernels_held(name: str, an, want: dict) -> None:
    """The kernel calls a dry run booked equal the launches the card
    counted for the same run."""
    got = {k: v["calls"] for k, v in an.kernels.items()}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{name}: the dry run booked {got} kernel "
                             f"calls; the card launched {want}")


def dry_collectives_held(name: str, stats: dict, want: dict) -> dict:
    """A dry rank's collectives over its run, calls and bytes, equal to
    the real rank's `Mesh.stats` over the same run (`want`: {op:
    {"calls", "bytes"}})."""
    from repro_torch.launch.mesh import COLLECTIVES
    got = {op: {k: stats[f"{op}_{k}"] for k in ("calls", "bytes")}
           for op in COLLECTIVES}
    if got != {op: {k: want[op][k] for k in ("calls", "bytes")}
               for op in COLLECTIVES}:
        raise AssertionError(f"{name}: the dry rank's collectives {got}, "
                             f"the real ranks' {want}")
    return got


def dry_serving_rank(cfg, run: dict) -> dict:
    """21a: 20a's rank on the meta device (see the module docstring).
    Every rank's blocks are the same size (`resolve_sized`), so rank 0's
    dry run stands for each rank: its blocks, kernel calls and
    collectives equal each rank's, and its peak is held to each rank's."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import DryMesh
    from repro_torch.nn.params import tree_leaves
    from repro_torch.nn.sharding import SERVE_RULES
    shape, names = LM_SERVE_MESH
    reckoned = lm_serve_reckoning(cfg, SERVE_RULES, LM_SERVE_MESH, 1,
                                  LM_PROMPT, LM_SERVE_MESH_MAX_LEN)["total"]
    mesh = DryMesh(shape, names, 0)
    job = dryrun.lm_serve_job(cfg, SERVE_RULES, mesh, 1, LM_PROMPT,
                              LM_SERVE_MESH_MAX_LEN,
                              n_decode=LM_SERVE_MESH_DECODE)
    an, _ = dryrun.measure(job, mesh)
    params, _ = job.tracked["parameters"]
    caches, _ = job.tracked["inputs"]
    blocks = {"param_blocks": sum(t.numel() * t.element_size()
                                  for t in tree_leaves(params)),
              "cache_blocks": sum(t.numel() * t.element_size()
                                  for c in caches.values()
                                  for t in c.values())}
    total = {op: {k: run["prefill_collectives"][op][k]
                  + LM_SERVE_MESH_DECODE
                  * run["decode_collectives_per_step"][op][k]
                  for k in ("calls", "bytes")}
             for op in run["prefill_collectives"]}
    out = {**blocks, "collectives": dry_collectives_held(
        "21a", mesh.stats, total),
           "peak_by_kind": an.memory()["peak_by_kind"], "ranks": []}
    for r, card in enumerate(run["peak_bytes_by_rank"]):
        want = {"param_blocks": run["param_block_bytes_by_rank"][r],
                "cache_blocks": run["cache_block_bytes_by_rank"][r]}
        if blocks != want:
            raise AssertionError(f"21a rank {r}: the dry run's blocks "
                                 f"{blocks}, 20a's {want}")
        dry_kernels_held(f"21a rank {r}", an, run["launches_per_rank"][r])
        out["ranks"].append(dry_held(f"21a rank {r}", an.peak_bytes, card,
                                     reckoned))
    return out


def dry_train_rank(cfg, run: dict) -> dict:
    """21b: 19a's FSDP rank at its cut depth, LM_MESH_STEPS steps of
    LM_TRAIN_BATCH x LM_TRAIN_SEQ, the optimizer keeping step 0's
    gradients past the step (`lm_rank` does); rank 0's dry run stands
    for each rank, as in 21a."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import DryMesh
    from repro_torch.nn.sharding import FSDP_RULES
    from repro_torch.optim import adamw
    from repro_torch.optim.optimizers import Optimizer
    shape, names = LM_MESH
    reckoned = lm_mesh_reckoning(cfg, FSDP_RULES, LM_TRAIN_BATCH,
                                 LM_TRAIN_SEQ)["total"]
    opt, kept = adamw(3e-4), []

    def apply(p, g, s, t, **kw):
        if not kept:
            kept.append(g)
        return opt.apply(p, g, s, t, **kw)
    mesh = DryMesh(shape, names, 0)
    job = dryrun.lm_train_job(cfg, FSDP_RULES, mesh, LM_TRAIN_BATCH,
                              LM_TRAIN_SEQ,
                              opt=Optimizer(opt.init, apply, opt.name),
                              steps=LM_MESH_STEPS)
    an, _ = dryrun.measure(job, mesh)
    total = {op: {k: LM_MESH_STEPS * v[k] for k in ("calls", "bytes")}
             for op, v in run["collectives_per_step"].items()}
    out = {"collectives": dry_collectives_held("21b", mesh.stats, total),
           "peak_by_kind": an.memory()["peak_by_kind"], "ranks": []}
    for r, card in enumerate(run["peak_bytes_by_rank"]):
        dry_kernels_held(f"21b rank {r}", an, run["launches_per_rank"][r])
        out["ranks"].append(dry_held(f"21b rank {r}", an.peak_bytes, card,
                                     reckoned))
    return out


def dry_one_device(cfg, card: int, launches: dict) -> dict:
    """21c: 14b's step on one device (the launcher's adamw and rules, its
    batch), from its fp32 parameters and AdamW state."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as train_cli
    from repro_torch.nn.sharding import TRAIN_RULES
    from repro_torch.optim import adamw
    args = train_cli.parse_args(LM_TRAIN_ARGV)
    job = dryrun.lm_train_job(cfg, TRAIN_RULES, None, args.batch, args.seq,
                              opt=adamw(args.lr))
    an, _ = dryrun.measure(job)
    dry_kernels_held("21c", an, {k: v // args.steps
                                 for k, v in launches.items()})
    nums = dry_held("21c", an.peak_bytes, card, lm_reckoning_bytes(
        cfg, args.batch, args.seq)["total"])
    nums["peak_by_kind"] = an.memory()["peak_by_kind"]
    return nums


def dry_run_phase(lm_cfg, mesh: dict, peak_14b: int,
                  launches_14b: dict) -> dict:
    """Phase 21 (the module docstring). Returns its numbers."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import shapes_for
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    cfg20 = dataclasses.replace(get_config(LM_ARCH),
                                compute_dtype=LM_SERVE_RUNS[0][5])
    log("phase 21: the dry run on the meta device against this run's card "
        f"numbers (band {DRY_PEAK_BAND:.0%}): 20a's serving rank, 19a's "
        "FSDP rank, 14b's step; then one production cell each")
    out = {"21a": dry_serving_rank(cfg20, mesh["20a"]),
           "21b": dry_train_rank(dataclasses.replace(
               lm_cfg, n_layers=LM_MESH_LAYERS), mesh["19a"]),
           "21c": dry_one_device(lm_cfg, peak_14b, launches_14b)}
    for arch, shape in DRY_CELLS:
        rec = dryrun.run_cell(arch, shapes_for(arch)[shape], False)
        if not rec["ok"]:
            raise AssertionError(f"21d {arch}/{shape}: {rec['error']}\n"
                                 f"{rec['traceback']}")
        keep = {k: rec.get(k) for k in (
            "memory", "fits", "accum_steps", "hbm_estimate_gb", "flops",
            "per_chip_dot_flops", "collective_bytes_per_chip",
            "collective_calls_per_chip", "kernels", "compute_s",
            "memory_s", "collective_s", "dominant", "bound_s",
            "placement", "load_imbalance", "config_overrides", "total_s")
            if k in rec}
        log(f"  21d {arch}/{shape} on 16x16: {json.dumps(keep)}")
        out[f"21d {arch}/{shape}"] = keep
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 21 took {out['phase_s']:.1f} s")
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
    global CARD
    CARD = smi

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
    # phase 20's oracles, kept on the host: 9b's, 16a's and 16b's logits
    serve_oracles = {"9b": run["oracle"]}
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

    # 11. the capacity tier page-locked in host memory, read and written
    #     by the row movers over PCIe: 7a-7c's runs over it (11a), the
    #     four movers over it against their plain versions and the card,
    #     then three tiers with a memory-mapped bulk store (11b). dlrm-m3
    #     (11c, 118.3 GB of rows) does not fit this machine's host memory
    import mmap

    from repro_torch.core import hostmem
    with open("/proc/meminfo") as f:
        mem = {k: v.strip() for k, v in (
            line.split(":", 1) for line in f if ":" in line)}
    os.makedirs(os.path.join(ROOT, "runs"), exist_ok=True)
    disk = shutil.disk_usage(os.path.join(ROOT, "runs"))
    log(f"phase 11: host MemTotal {mem.get('MemTotal')}, MemAvailable "
        f"{mem.get('MemAvailable')}; disk under runs/: {disk.free} bytes "
        f"free of {disk.total}")
    r_rows = ebc.plan.total_rows
    t0 = time.perf_counter()
    host = {"mega": hostmem.pinned_zeros((r_rows, d)),
            "accum": hostmem.pinned_zeros((r_rows,))}
    pin_s = time.perf_counter() - t0
    locked = hostmem.page_locked_bytes()
    exact = sum(-(-b // mmap.PAGESIZE) * mmap.PAGESIZE
                for b in (r_rows * d * 4, r_rows * 4))
    log(f"phase 11: {locked} bytes page-locked and mapped in {pin_s:.1f} s "
        f"(table {r_rows * d * 4} + accumulator {r_rows * 4}, in whole "
        f"pages {exact})")
    if locked != exact:
        raise AssertionError(f"{locked} bytes page-locked, not {exact}")
    rates = pcie_rates(torch, dev, host)
    for r in runs:
        hr = dict(r, name="11a-" + r["name"], path="host_" + r["path"],
                  strict=True)
        log(f"phase {hr['name']}: build_cached_train_step, {TRAIN_STEPS} "
            f"steps from the launcher's seed and batches, the capacity "
            f"tier page-locked on the host")
        res = train_cached(torch, dev, cfg, hr, want, host)
        paths[hr["path"]] = read_launches(KERNELS, hr["path"], hr["needs"])
        log(f"{hr['name']} numbers: {json.dumps(res)}")
        free_device(torch)
    log(f"phase 11a: the four row movers over the host tier vs plain and "
        f"the card (R={r_rows}, C={EVICT_CACHE_ROWS}, D={d})")
    host_movers = check_host_movers(torch, dev, cfg, ebc, host, rates)
    free_device(torch)
    small, bulk_want = bulk_oracle(torch, dev, cfg)
    free_device(torch)
    r_small = bulk_want["rows"]
    bulk_host = {k: v[:r_small] for k, v in host.items()}
    bulk_dir = tempfile.mkdtemp(prefix="chip_smoke_bulk_",
                                dir=os.path.join(ROOT, "runs"))
    try:
        for kind in ("sync", "async"):
            br = {"name": f"11b-{kind}", "path": f"host_bulk_{kind}",
                  "tier": kind, "cache_rows": EVICT_CACHE_ROWS,
                  "fetch_chunk": EVICT_CHUNK, "hook": "dedup",
                  "lookahead": False, "evicts": True, "strict": True,
                  "bulk": {"dram_rows": BULK_DRAM_ROWS,
                           "bulk_chunk": BULK_CHUNK,
                           "bulk_latency_us": BULK_LATENCY_US,
                           "bulk_path": os.path.join(bulk_dir,
                                                     f"{kind}.npy")},
                  "needs": step_kernels + ("embedding_bag", "cache_fetch",
                                           "cache_fetch_chunked")}
            log(f"phase {br['name']}: BulkCachedEmbeddingBagCollection "
                f"over the host tier, every table cut to 1/{BULK_ROW_DIV} "
                f"({r_small} rows), {TRAIN_STEPS} steps: {br['bulk']}")
            res = train_cached(torch, dev, small, br, bulk_want, bulk_host)
            paths[br["path"]] = read_launches(KERNELS, br["path"],
                                              br["needs"])
            log(f"{br['name']} numbers: {json.dumps(res)}")
            free_device(torch)
            for f in os.listdir(bulk_dir):
                os.remove(os.path.join(bulk_dir, f))
    finally:
        shutil.rmtree(bulk_dir, ignore_errors=True)
    del bulk_host
    t0 = time.perf_counter()
    del host
    gc.collect()
    log(f"phase 11: host tier unregistered and unmapped in "
        f"{time.perf_counter() - t0:.1f} s; page-locked bytes left "
        f"{hostmem.page_locked_bytes()}")

    # 12. the sharded executors on torch.distributed: spawned ranks on this
    #     card through gloo, CUDA IPC views of the parent's tables; the
    #     table-wise step over 8a's 8 owners (12a), the psum dense update
    #     on dlrm-m2 (12b), the hybrid (data, model) step on dlrm-m2 (12c)
    log(f"phase 12: ranks spawned on this card, gloo, the parent's tables "
        f"shared by CUDA IPC (PYTORCH_CUDA_ALLOC_CONF="
        f"{os.environ.get('PYTORCH_CUDA_ALLOC_CONF')!r})")
    log(f"phase 12a: build_tablewise_train_step(mesh=(1, "
        f"{TABLEWISE_OWNERS})), 8a's seed and batches, next batch staged")
    # 12a and 12c share one world of 8 ranks; 12b's 4 ranks are spawned
    # before 12c's oracle and import meanwhile
    with spawn_world(dev, TABLEWISE_OWNERS) as w8:
        mesh = {"12a": mesh_tablewise_m1(torch, dev, cfg, ebc_tw, tw, w8)}
        free_device(torch)
        with spawn_world(dev, MESH_PSUM_SHAPE[1]) as w4:
            mesh["12c"] = mesh_hybrid_m2(torch, dev, m2, w8)
            w8.close()
            free_device(torch)
            mesh.update(mesh_psum_m2(torch, dev, m2, w4))
    free_device(torch)
    for name, nums in mesh.items():
        paths[f"mesh_{name}"] = nums["launches"]
        log(f"{name} numbers: " + json.dumps(
            {k: v for k, v in nums.items() if k != "launches_per_rank"}))

    # 13. the multi-host cached tier: 4 hosts' caches over one row-sharded
    #     capacity tier, at the plan's cache (13a) and at a cache that
    #     evicts, strict and without hook plans (13b)
    multihost = {}
    for r in (
            {"name": "13a", "path": "train_multihost", "cache_rows": None,
             "hook": "plan", "strict_sync": False, "fetch_chunk": None,
             "evicts": False},
            {"name": "13b", "path": "train_multihost_evict",
             "cache_rows": MULTIHOST_EVICT_CACHE_ROWS, "hook": "dedup",
             "strict_sync": True, "fetch_chunk": EVICT_CHUNK,
             "evicts": True}):
        log(f"phase {r['name']}: build_cached_train_step("
            f"MultiHostCachedEmbeddingBagCollection(n_hosts="
            f"{MULTIHOST_HOSTS}, cache_rows={r['cache_rows']}), "
            f"strict_sync={r['strict_sync']}, fetch_chunk="
            f"{r['fetch_chunk']}), hook {r['hook']}, {TRAIN_STEPS} steps "
            f"from the launcher's seed and batches")
        res = train_multihost(torch, dev, cfg, r, want)
        paths[r["path"]] = res.pop("launches")
        log(f"{r['name']} numbers: {json.dumps(res)}")
        multihost[r["name"]] = res
        free_device(torch)

    # 14. LM training on full-width stablelm-1.6b: the backward kernel
    #     against its plain version (14a), the launcher at train_4k's 4,096
    #     tokens (14b), step 0 through the kernels and the plain attention
    #     (14c), gradient accumulation (14d), resume and chaos at --smoke
    #     (14e)
    lm_train = lm_train_phases(torch, dev, lm_cfg)
    paths.update(lm_train["paths"])
    numbers["flash_attention_bwd"] = dict(
        lm_train["bwd"]["train_4k"], fp32=lm_train["bwd"]["train_4k_fp32"],
        dh128=lm_train["bwd"]["train_4k_dh128"])
    fa = numbers["flash_attention"]
    fa["train_shape"] = {k: lm_train["bwd"]["train_4k"][k] for k in (
        "shape", "forward_ms", "forward_with_lse_ms")}

    # 15. the paper's section-V design space at full suite width: the
    #     path's kernels at the shapes only the suite reaches, then every
    #     point of Figs. 10-13 trained (15a-15d)
    log("phase 15: dot_interaction, embedding_bag and the fused update vs "
        "plain at the suite's shapes")
    for name, res in suite_kernel_shapes(torch, dev).items():
        numbers[name]["suite_shapes"] = res
    free_device(torch)
    paths.update(suite_phase(torch, dev))
    free_device(torch)

    # 16. the MoE, SSM and hybrid LM families served at full width:
    #     granite-moe-3b-a800m (16a), mamba2-780m (16b), jamba-v0.1-52b cut
    #     to one unit (16c), the LM launcher on mamba2-780m with its slots
    #     reused (16d)
    zoo = {}
    for key, phase in (("16a", zoo_moe), ("16b", zoo_ssm),
                       ("16c", zoo_hybrid)):
        res = phase(torch, dev)
        paths.update(res["paths"])
        zoo[key] = res
        log_peak(torch, f"phase {key}")
        del res
        free_device(torch)
    serve_oracles.update({"16a": zoo["16a"].pop("oracle"),
                          "16b_fp32": zoo["16b"].pop("oracle")})
    numbers["flash_attention"]["granite_moe"] = zoo["16a"]["flash"]
    numbers["flash_attention"]["jamba_dh128"] = zoo["16c"]["flash"]
    per_launch = {}
    for key, n in (("16a", get_config(MOE_ARCH).n_layers), ("16c", 1)):
        ms = zoo[key]["numbers"].get("prefill_flash_device_ms")
        per_launch[key] = ms / n if ms else None
    numbers["flash_attention"]["zoo_prefill_device_ms_per_launch"] = \
        per_launch
    paths.update(zoo_serve(torch)["paths"])
    free_device(torch)

    # 17. the LM zoo trained, the frontends served and trained: the
    #     attention kernels at this slice's training shapes (17a),
    #     granite-moe-1b-a400m's launcher at full width (17b) and its step
    #     0 against full_attention and across remat modes (17c),
    #     mamba2-780m's (17d), jamba's hybrid path at --smoke (17e), the
    #     vision and audio frontends (17f)
    zoo_train = zoo_train_phases(torch, dev)
    paths.update(zoo_train["paths"])
    paths.update(frontend_phases(torch, dev)["paths"])
    numbers["flash_attention"]["zoo_train_shapes"] = {
        name: {k: nums[k] for k in ("shape", "forward_ms",
                                    "forward_with_lse_ms",
                                    "forward_library_ms", "forward_bound_ms",
                                    "forward_o_max_abs_err")}
        for name, nums in zoo_train["flash"].items()}
    numbers["flash_attention_bwd"]["zoo_train_shapes"] = {
        name: {k: v for k, v in nums.items() if not k.startswith("forward")}
        for name, nums in zoo_train["flash"].items()}

    # 18. the multi-host cached tier one rank a host: 13a's run (18a) and
    #     13b's (18b) on MULTIHOST_HOSTS gloo ranks, the elastic re-mesh
    #     from 4 ranks to 2 (18c), EASGD over a pod axis and compression
    #     (18d)
    ranks = multihost_mesh_phases(torch, dev, cfg, want, multihost)
    for name, nums in (("18a", ranks["18a"]), ("18b", ranks["18b"]),
                       ("18c-4", ranks["18c"]["first"]),
                       ("18c-2", ranks["18c"]["second"])):
        mesh[name] = nums
        paths[f"mesh_{name}"] = nums["launches"]
        log(f"{name} numbers: " + json.dumps(
            {k: v for k, v in nums.items() if k != "launches_per_rank"}))
    log(f"18d numbers: {json.dumps(ranks['18d'])}")

    # 19. the LM step over a (data 2, model 2) mesh of gloo ranks: FSDP
    #     (19a), ZERO_DP (19b) and TRAIN (19c) at full width cut in depth,
    #     step 0's gradients under each table (19d), one unit of the MoE
    #     and SSM families (19e)
    # 20. LM serving over a mesh, in phase 19's world: stablelm-1.6b under
    #     SERVE_RULES (20a) and LONG_SERVE_RULES (20b), granite-moe-3b-a800m
    #     (20c) and mamba2-780m (20d) on (1, 4), mamba2-780m's engine on
    #     (2, 2) (20e)
    # four ranks' allocators share the card: expandable segments keep
    # what one rank freed usable by another's larger blocks
    with spawn_world(dev, 4, LM_MESH_TIMEOUT_S,
                     alloc_conf="expandable_segments:True") as world:
        lm_mesh = lm_mesh_phase(torch, dev, lm_cfg, lm_train["losses_14b"],
                                world, serve_oracles)
    del serve_oracles
    for name in ("19a", "19b", "19c", "20a", "20b", "20c", "20d", "20e"):
        mesh[name] = lm_mesh[name]
        paths[f"mesh_{name}"] = lm_mesh[name]["launches"]
    fl = lm_mesh["flash_serve"]
    numbers["flash_attention"].setdefault("mesh_rank_shapes", {})[
        "rank_20a"] = {k: fl[k] for k in (
            "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by")}
    for name, nums in lm_mesh.items():
        if name.startswith(("19d", "19e")):
            paths[f"mesh_{name}"] = nums["run"]["launches"]
    for name in ("rank_19a_19c", "rank_19b"):
        fl = lm_mesh["flash"][name]
        numbers["flash_attention"].setdefault("mesh_rank_shapes", {})[
            name] = {k: fl[k] for k in ("shape", "forward_ms",
                                        "forward_with_lse_ms",
                                        "forward_library_ms",
                                        "forward_bound_ms")}
        numbers["flash_attention_bwd"].setdefault("mesh_rank_shapes", {})[
            name] = {k: v for k, v in fl.items()
                     if not k.startswith("forward")}

    # 21. the dry run on the host, held to what this run measured: 20a's
    #     serving rank, 19a's FSDP rank, 14b's step; two production cells
    dry_run_phase(lm_cfg, mesh, lm_train["peak_14b"],
                  lm_train["paths"]["lm_train"])

    # 22. the numbers, then the result
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
        "flash_attention": "src/repro/kernels/flash_attention.py:100",
        # no TPU kernel: the gradient the reference takes by XLA autodiff
        # of its blockwise attention
        "flash_attention_bwd": "src/repro/nn/layers.py:196"}
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
                "device_ms_from", "device_ms_9a_profiler", "graph_ms",
                "cold_device_ms",
                "max_abs_err_vs_fp32_oracle", "train_shape",
                "m2_train_shape", "suite_shapes", "host_us", "fp32",
                "dh128", "library",
                "max_err_share_of_max_plain", "rel_l2_err",
                "device_ms_14a_profiler", "granite_moe", "jamba_dh128",
                "zoo_prefill_device_ms_per_launch", "zoo_train_shapes",
                "mesh_rank_shapes")
                if key in nums}})
        rows[-1]["launches_per_rank"] = {
            name: [c[k.name] for c in nums["launches_per_rank"]]
            for name, nums in mesh.items()}
        if k.name == "flash_attention_bwd":
            rows[-1]["replaces_note"] = (
                "no TPU kernel: the reference trains through XLA's autodiff "
                "of nn/layers.py::blockwise_attention")
        if k.name in host_movers:
            rows[-1]["host_capacity"] = {
                **host_movers[k.name], "launches": sum(
                    p[k.name] for n, p in paths.items()
                    if n.startswith("host_"))}
    log(f"the movers' added measurements, wall seconds by part: "
        f"{json.dumps(MEASURE_S)}; the whole run "
        f"{time.perf_counter() - T_START:.1f} s")
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
    from repro_torch.kernels import KERNELS, build_all
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
