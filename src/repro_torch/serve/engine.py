"""Serving engines: the LM slot engine (continuous batching over fixed
decode slots) and batched CTR inference over the read-only cached
embedding tier.

The LM engine keeps fixed-batch caches, admits queued requests into free
slots, decodes all active slots each step, and retires sequences that hit
EOS or their token budget, as the reference's. It runs eagerly (the
reference jits its decode step); the caches are written in place.

A slot's recurrent state (each Mamba-2 mixer's conv inputs and SSM state)
is zeroed when a request takes the slot. The reference does not: a
request admitted into a reused slot starts from the previous request's
state, advanced by the padding tokens fed to the slot while it sat idle.
A KV cache needs no reset: its rows are written before they are read.

Over a mesh (`mesh=`, one engine a rank, the same requests submitted on
every rank), a rank holds its blocks of the slots' caches (the slots
split over the batch's axes, `data` under SERVE_RULES). Every rank runs
the same admission and retirement; a slot's prompt goes through decode
steps on the ranks that hold its rows only (`models.lm.decode_rows`),
and each step decodes every slot on every rank and samples from the
logits gathered whole, so all ranks pick the same tokens.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dlrm import dlrm_forward_dense
from repro_torch.models.lm import (Caches, decode_rows, decode_step,
                                   init_caches)
from repro_torch.nn.sharding import (SERVE_RULES, LogicalRules, batch_axes,
                                     block_range)


@dataclasses.dataclass
class Request:
    """One LM generation request: prompt tokens + a new-token budget."""

    uid: int
    prompt: np.ndarray                    # (prompt_len,) int32
    max_new_tokens: int = 32
    generated: list[int] | None = None


class DrainTimeout(RuntimeError):
    """`run_until_drained` exceeded its step budget.

    Carries the work that did finish (`completed`, uid -> tokens) plus the
    uids still in flight (`undrained`: occupied slots and queued requests),
    so a stalled drain loses nothing."""

    def __init__(self, completed: dict[int, list[int]],
                 undrained: list[int], steps: int):
        super().__init__(
            f"serve loop did not drain within {steps} steps; "
            f"{len(completed)} completed, {len(undrained)} in flight")
        self.completed = completed
        self.undrained = undrained


class ServeEngine:
    """Slot-based continuous-batching LM engine (see module docstring).

    It runs where `params` lie: the caches are made on the device of the
    token embedding (the card for `init_lm_params`' default). It drives
    token-in, token-out archs: the vision arch decodes text (an empty
    patch prefix, as its `decode_step` does); the audio arch, whose steps
    take and give K codebook tokens, raises ValueError, where the
    reference asserts. With a `mesh`, `params` are this rank's blocks
    under `rules` (the module docstring); without one `rules` go
    unused."""

    def __init__(self, params, cfg: ModelConfig, batch_slots: int,
                 max_len: int, rules: LogicalRules = SERVE_RULES,
                 eos_id: int = -1, mesh=None):
        if cfg.frontend not in (None, "vision"):
            raise ValueError(f"{cfg.name}: the engine drives token-in / "
                             f"token-out archs, not the {cfg.frontend} "
                             "frontend")
        self.params = params
        self.cfg = cfg
        self.batch_slots = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params["embed"]["tok"].device
        self.rules, self.mesh = rules, mesh
        self.caches = init_caches(cfg, batch_slots, max_len, self.device,
                                  rules, mesh)
        # the slots whose cache rows this rank holds
        self.rows = (0, batch_slots) if mesh is None else block_range(
            batch_slots, batch_axes(rules, mesh), mesh)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)
        self.slot_budget = np.zeros(batch_slots, np.int32)
        self.queue: collections.deque[Request] = collections.deque()
        self.completed: dict[int, list[int]] = {}
        self._decode = lambda p, t, c, i: decode_step(p, t, c, i, cfg,
                                                      rules, mesh)
        self._decode_rows = lambda p, t, c, i: decode_rows(p, t, c, i, cfg,
                                                           rules, mesh)
        self.steps_run = 0

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request):
        """Enqueue `req`, validating it can ever fit the cache window.

        A prompt of `max_len` or more tokens would overflow `slot_pos` past
        the cache before the retire check could fire, so it is rejected
        here. The new-token budget is clamped at admission (`_admit`), so a
        request asking for more tokens than the window allows still runs
        and retires at the window edge."""
        if len(req.prompt) >= self.max_len:
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens cannot fit max_len="
                f"{self.max_len} with room to generate; truncate the prompt "
                "or build the engine with a larger max_len")
        req.generated = []
        self.queue.append(req)

    def _admit(self):
        for slot in range(self.batch_slots):
            if self.slot_req[slot] is not None or not self.queue:
                continue
            req = self.queue.popleft()
            # a fresh recurrent state, then the slot-local prefill: the
            # prompt through decode steps on the slot's own cache rows,
            # written in place, so the other slots' caches are never
            # touched. The LAST prompt token is left to the first
            # `step()`, which feeds it at position len-1 and samples the
            # first generated token from its logits. Over a mesh only the
            # ranks holding the slot's rows run it.
            lo, hi = self.rows
            if lo <= slot < hi:
                caches = _slot_caches(self.caches, slot - lo)
                _reset_recurrent(caches)
                for t, tok in enumerate(req.prompt[:-1]):
                    tok_arr = torch.full((1, 1), int(tok), dtype=torch.long,
                                         device=self.device)
                    self._decode_rows(self.params, tok_arr, caches, t)
            self.slot_req[slot] = req
            self.slot_pos[slot] = len(req.prompt) - 1
            # the budget clamped to the cache window: after g generated
            # tokens slot_pos is len(prompt)-1+g, and the slot retires at
            # max_len-1, so at most max_len - len(prompt) tokens fit
            self.slot_budget[slot] = min(req.max_new_tokens,
                                         self.max_len - len(req.prompt))

    # -- decode --------------------------------------------------------------

    def _sample(self, logits: np.ndarray) -> np.ndarray:
        return np.argmax(logits, axis=-1).astype(np.int32)

    def step(self):
        """One engine step: admit, decode all active slots, retire."""
        self._admit()
        active = [s for s in range(self.batch_slots)
                  if self.slot_req[s] is not None]
        if not active:
            return
        # the current last token per slot (inactive slots feed 0)
        toks = np.zeros((self.batch_slots, 1), np.int64)
        for s in active:
            req = self.slot_req[s]
            toks[s, 0] = (req.generated[-1] if req.generated
                          else int(req.prompt[-1]))
        # per-slot positions: each sequence writes its cache at its own
        # depth and attends over its own valid prefix
        logits, _ = self._decode(
            self.params, torch.from_numpy(toks).to(self.device), self.caches,
            torch.from_numpy(self.slot_pos.astype(np.int64)))
        nxt = self._sample(logits.float().cpu().numpy())
        self.steps_run += 1
        for s in active:
            req = self.slot_req[s]
            req.generated.append(int(nxt[s]))
            self.slot_pos[s] += 1
            done = (len(req.generated) >= self.slot_budget[s]
                    or int(nxt[s]) == self.eos_id
                    or self.slot_pos[s] >= self.max_len - 1)
            if done:
                self.completed[req.uid] = req.generated
                self.slot_req[s] = None

    def run_until_drained(self, max_steps: int = 10_000):
        """Step until queue and slots are empty; returns `completed`.

        `max_steps` bounds this call's decode steps (not the engine's
        lifetime `steps_run`). On timeout raises `DrainTimeout` carrying
        the partial `completed` dict and the undrained uids."""
        start = self.steps_run
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
            if self.steps_run - start > max_steps:
                undrained = [r.uid for r in self.slot_req if r is not None]
                undrained += [r.uid for r in self.queue]
                raise DrainTimeout(dict(self.completed), undrained,
                                   self.steps_run - start)
        return self.completed


def _slot_caches(caches: Caches, slot: int) -> Caches:
    """Views of `slot`'s rows of the stacked caches (batch is axis 1): a
    decode step on them writes that slot's cache in place and nothing
    else. The reference decodes every slot and keeps `slot`'s rows of the
    result (its `_merge_slot`); here there is nothing to merge."""
    return Caches({name: {k: t[:, slot:slot + 1] for k, t in unit.items()}
                   for name, unit in caches.items()}, caches.max_len)


def _reset_recurrent(caches: dict) -> None:
    """Zero every Mamba-2 mixer's conv inputs and SSM state in `caches`."""
    for unit in caches.values():
        if "ssm" in unit:
            unit["conv"].zero_()
            unit["ssm"].zero_()


def dlrm_probs(dense_params: dict, cfg, cc, table: torch.Tensor,
               dense_x: np.ndarray, local_idx: np.ndarray) -> np.ndarray:
    """The serving forward: pooled lookup of `local_idx` (slot indices into
    `table`) through the embedding-bag kernel, the dense tower, sigmoid.
    Returns (B,) fp32 click probabilities on the host."""
    dev = table.device
    with torch.inference_mode():
        pooled = cc.lookup_cached(_TableView(table), local_idx)
        dense = torch.from_numpy(np.ascontiguousarray(dense_x,
                                                      np.float32)).to(dev)
        logits = dlrm_forward_dense(dense_params, dense, pooled, cfg)
        return torch.sigmoid(logits).cpu().numpy()


class DLRMEngine:
    """Batched CTR inference with the cached embedding tier in READ-ONLY
    mode: the mega table stays in the capacity tier, hot rows are served
    from the device cache, misses fetch on demand, and eviction never
    writes back (no row is ever dirtied).

    The engine's cache state takes ownership of `params["emb"]["mega"]`
    (see `CachedEmbeddingBagCollection.init_state`); serving never writes
    the capacity tier, so read-only engines may share one mega tensor."""

    def __init__(self, params, cfg, cc):
        self.cfg = cfg
        self.cc = cc
        self.dense = {"bottom": params["bottom"], "top": params["top"]}
        self.state = cc.init_state(params["emb"]["mega"])
        self.requests_served = 0

    def _split_spans(self, idx: np.ndarray) -> list[tuple[int, int]]:
        """Greedy prefix packing: contiguous example spans whose cumulative
        unique-row working set fits the device cache, computed before any
        dispatch. A single example whose own working set exceeds the cache
        raises with the actual sizes."""
        b = idx.shape[0]
        c = self.cc.cache_rows
        mark = np.zeros((self.cc.ebc.plan.total_rows,), bool)
        touched: list[np.ndarray] = []
        spans: list[tuple[int, int]] = []
        start, count, e = 0, 0, 0
        while e < b:
            rows = np.unique(idx[e][idx[e] >= 0])
            new = rows[~mark[rows]]
            if count + len(new) > c:
                if e == start:
                    raise ValueError(
                        f"single example touches {len(rows)} unique rows > "
                        f"cache_rows={c}; it cannot be split further — "
                        "raise the HBM budget or shorten the example's "
                        "multi-hot lists")
                spans.append((start, e))
                for t in touched:
                    mark[t] = False
                touched.clear()
                start, count = e, 0
                continue        # re-evaluate e against the fresh span
            mark[new] = True
            touched.append(new)
            count += len(new)
            e += 1
        if b:
            spans.append((start, b))
        return spans

    def predict(self, batch: dict) -> np.ndarray:
        """batch: {"dense" (B, n_dense), "idx" (B, F, L) OFFSET global
        rows}. Returns (B,) click probabilities. A batch whose working set
        exceeds the cache is split into spans that fit; the tier is
        read-only, so splitting is exact."""
        idx = np.asarray(batch["idx"])
        dense_x = np.asarray(batch["dense"])
        if idx.shape[0] == 0:
            return np.zeros((0,), np.float32)
        outs = []
        for s, e in self._split_spans(idx):
            local = self.cc.take(self.state, idx[s:e], train=False)
            outs.append(dlrm_probs(self.dense, self.cfg, self.cc,
                                   self.state.cache, dense_x[s:e], local))
        self.requests_served += int(idx.shape[0])
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    @property
    def cache_stats(self):
        """Live `CacheStats` of the serving cache state."""
        return self.state.stats


class _TableView:
    """Duck-typed CacheState carrying only what lookup_cached reads."""

    def __init__(self, cache: torch.Tensor):
        self.cache = cache
