"""Plain PyTorch versions of the port's kernels.

Each function computes what its CUDA kernel computes, in the same
accumulation order where the kernel has one, on any device. The kernel
wrappers (`kernels/embedding_bag.py`, `dot_interaction.py`,
`cache_ops.py`, `sparse_update.py`, `rowwise_adagrad.py`,
`flash_attention.py`) call these only for tensors on the CPU;
`chip_smoke.py` holds each kernel against its plain version on the card,
and the tests hold the plain versions against the reference package's
`repro.kernels.ref` oracles.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.sparse_plan import build_sparse_plan


def embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                      mode: str = "sum") -> torch.Tensor:
    """Multi-hot lookup + pooling. table: (H, D); indices: (B, L) int,
    -1 = padding slot. Returns (B, D): the sum (or mean over valid slots,
    divided by max(count, 1)) of the bag's rows.

    The L slots are added one after another in fp32, pads contributing
    nothing — the CUDA kernel's order, so the two agree bit for bit."""
    b, length = indices.shape
    valid = indices >= 0
    safe = indices.clamp(min=0).long()
    out = torch.zeros((b, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for j in range(length):
        rows = table[safe[:, j]].float()
        out = torch.where(valid[:, j, None], out + rows, out)
    if mode == "mean":
        cnt = valid.sum(dim=1, keepdim=True).clamp(min=1).float()
        out = out / cnt
    elif mode != "sum":
        raise ValueError(f"unknown pooling mode {mode!r}")
    return out.to(table.dtype)


def dedup_embedding_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                            unique_rows: torch.Tensor,
                            mode: str = "sum") -> torch.Tensor:
    """Plan-shared pooled lookup: the table is gathered once per plan entry
    into a compact (U, D) slab, and every lookup slot reads its row from
    that slab through a searchsorted remap into the plan's ascending live
    prefix (the reference oracle's remap; the CUDA kernel finds the same
    slab row through a row-indexed position map written by its gather).
    The pooling is `embedding_bag_ref` itself, so the result is bit-equal
    to it whenever `unique_rows` covers every valid index (the planner's
    contract).

    table: (H, D); indices: (B, L) int32, -1 pads; unique_rows: (U,) int32,
    live prefix strictly ascending, -1 past the unique count."""
    sent = unique_rows.masked_fill(unique_rows < 0, np.iinfo(np.int32).max)
    compact = table[unique_rows.clamp(min=0).long()]
    pos = torch.searchsorted(sent, indices.clamp(min=0).contiguous())
    pos = pos.clamp(max=max(unique_rows.numel() - 1, 0))
    return embedding_bag_ref(compact, torch.where(indices >= 0, pos, -1),
                             mode)


def _csr_sums(lo: torch.Tensor, hi: torch.Tensor, bag_ids: torch.Tensor,
              pooled: torch.Tensor) -> torch.Tensor:
    """Per entry e, the fp32 sum of pooled[bag_ids[j]] for j in
    [lo[e], hi[e]), added one after another from zero — the fused kernels'
    order. lo, hi: (E,) absolute positions into bag_ids. Returns (E, D).

    Vectorised across entries: step k adds every entry's k-th bag, over the
    entries whose slice is longer than k (a prefix once sorted by length),
    so the loop runs as many times as the longest slice. Each step's prefix
    length is found before the loop, so a step costs its own prefix, not
    the plan's length (a Zipf head row of a large batch has tens of
    thousands of bags in a plan of millions of entries)."""
    e, d = lo.numel(), pooled.shape[-1]
    lo = lo.long()
    lens = (hi.long() - lo).clamp(min=0)
    by_len = torch.argsort(lens, descending=True)
    lens_h = lens[by_len].cpu().numpy()
    lo_sorted = lo[by_len]
    gsum = torch.zeros((e, d), dtype=torch.float32, device=pooled.device)
    steps = int(lens_h[0]) if e else 0
    # the count of slices longer than k, for every k
    prefix = np.searchsorted(-lens_h, -np.arange(steps), side="left")
    for k in range(steps):
        m = int(prefix[k])
        gsum[:m] += pooled[bag_ids[lo_sorted[:m] + k].long()].float()
    out = torch.empty_like(gsum)
    out[by_len] = gsum
    return out


def bag_grad_sums_abs(bag_offsets: torch.Tensor, bag_ids: torch.Tensor,
                      pooled: torch.Tensor) -> torch.Tensor:
    """Per entry i of a plan or segment with ABSOLUTE offsets into the
    shared bag_ids, the sum of its pooled bag gradients over
    [bag_offsets[i], bag_offsets[i+1]), in CSR order; pairs of other
    segments are never read and pad entries (empty slices) sum to zero.
    Returns (U, D) fp32. Bit-equal to the reference's `bag_grad_sums_abs`,
    whose segment sum also adds a row's pairs in ascending position."""
    return _csr_sums(bag_offsets[:-1], bag_offsets[1:], bag_ids, pooled)


def _rowwise_apply(table: torch.Tensor, accum: torch.Tensor,
                   rows: torch.Tensor, gsum: torch.Tensor, lr: float,
                   eps: float) -> None:
    """Row-wise AdaGrad IN PLACE for each entry with rows[e] >= 0:
    acc = accum[row] + mean(g^2), w = w - lr * g * rsqrt(acc + eps), with
    g = gsum[e]. Every update in this module goes through here, on the
    live entries in the order given, so two callers that hand it the same
    rows and sums produce the same bits."""
    live = rows >= 0
    r = rows[live].long()
    g = gsum[live]
    acc = accum[r] + torch.mean(torch.square(g), dim=-1)
    upd = lr * g * torch.rsqrt(acc[:, None] + eps)
    accum[r] = acc
    table[r] = table[r] - upd.to(table.dtype)


def fused_bag_backward_adagrad_ref(table: torch.Tensor, accum: torch.Tensor,
                                   unique_rows: torch.Tensor,
                                   bag_offsets: torch.Tensor,
                                   bag_ids: torch.Tensor,
                                   pooled: torch.Tensor, lr: float,
                                   eps: float = 1e-8):
    """Fused sparse backward + row-wise AdaGrad, IN PLACE on `table` (H, D)
    and `accum` (H,) (the reference returns new arrays; the TPU kernel
    aliases them). For each live plan entry: g = its bag-gradient sum
    (`bag_grad_sums_abs`), acc = accum[row] + mean(g^2), then
    w = w - lr * g * rsqrt(acc + eps); rows the entries do not name are
    untouched. Offsets are absolute positions into bag_ids, so this is
    also the update over one segment of a split plan. pooled: (B*F, D).
    Returns (table, accum)."""
    gsum = bag_grad_sums_abs(bag_offsets, bag_ids, pooled)
    _rowwise_apply(table, accum, unique_rows, gsum, lr, eps)
    return table, accum


def fused_bag_backward_adagrad_segments_ref(
        table: torch.Tensor, accum: torch.Tensor, seg_rows: torch.Tensor,
        seg_offsets: torch.Tensor, bag_ids: torch.Tensor,
        pooled: torch.Tensor, seg_base: torch.Tensor, lr: float,
        eps: float = 1e-8):
    """The fused update over S per-owner SEGMENTS of one plan, IN PLACE:
    entry (s, i) updates row seg_base[s] + seg_rows[s, i] (skipped when
    seg_rows[s, i] < 0) from the bag slice [seg_offsets[s, i],
    seg_offsets[s, i+1]) of the shared bag_ids — the segmented kernel's
    grid, entry by entry. Segments are disjoint row ranges of one plan
    (`sparse_plan.split_plan_by_owner`), so each row updates with the bits
    the unsegmented update gives it. seg_rows: (S, C), seg_offsets:
    (S, C+1), seg_base: (S,) int32. Returns (table, accum)."""
    rows = torch.where(seg_rows >= 0,
                       seg_rows.long() + seg_base.long()[:, None], -1)
    gsum = _csr_sums(seg_offsets[:, :-1].reshape(-1),
                     seg_offsets[:, 1:].reshape(-1), bag_ids, pooled)
    _rowwise_apply(table, accum, rows.reshape(-1), gsum, lr, eps)
    return table, accum


def dedup_grads_ref(indices: torch.Tensor, grads: torch.Tensor,
                    num_rows: int):
    """Aggregate per-lookup grads (N, D) into unique-row grads: the first
    pass of the legacy two-pass update. indices: (N,) int32 rows in
    [0, num_rows), -1 pads.

    The stable sort and run detection are the port's planner over a
    one-slot-per-bag stream (`sparse_plan.build_sparse_plan`); each run's
    grads are added one after another in sorted-slot order, so every sum
    carries the bits of the reference's segment sum and, fed the legacy
    broadcast layout (`EmbeddingBagCollection.per_lookup_grads`), of the
    fused update's bag sums. Returns (uniq (N,) int32, gsum (N, D) fp32):
    each unique row once, at its run head in sorted order; every other
    slot -1 / zeros — the layout `rowwise_adagrad` consumes."""
    n, d = grads.shape
    if indices.shape != (n,):
        raise ValueError(f"need indices ({n},), got {tuple(indices.shape)}")
    plan = build_sparse_plan(indices.to(torch.int32), lookups_per_bag=1)
    live = plan.unique_rows >= 0
    heads = plan.bag_offsets[:-1][live].long()
    sums = bag_grad_sums_abs(plan.bag_offsets, plan.bag_ids, grads)
    uniq = torch.full((n,), -1, dtype=torch.int32, device=grads.device)
    gsum = torch.zeros((n, d), dtype=torch.float32, device=grads.device)
    uniq[heads] = plan.unique_rows[live]
    gsum[heads] = sums[live]
    return uniq, gsum


def rowwise_adagrad_ref(table: torch.Tensor, accum: torch.Tensor,
                        uniq: torch.Tensor, gsum: torch.Tensor, lr: float,
                        eps: float = 1e-8):
    """The legacy row-wise AdaGrad kernel's plain version, IN PLACE: for
    each entry with uniq[i] >= 0 (distinct rows, `dedup_grads_ref`'s
    layout), acc = accum[row] + mean(gsum[i]^2) and w = w - lr * gsum[i]
    * rsqrt(acc + eps). The reference's `rowwise_adagrad_ref`, which takes
    per-lookup grads, is `dedup_grads_ref` followed by this. Returns
    (table, accum)."""
    _rowwise_apply(table, accum, uniq, gsum, lr, eps)
    return table, accum


def dot_interaction_ref(z: torch.Tensor) -> torch.Tensor:
    """Pairwise dot-product interaction. z: (B, F, D). Returns
    (B, F*(F-1)//2): the strict lower triangle of z @ z^T per example, in
    np.tril_indices(F, -1) order, accumulated in fp32 (fp64 for fp64
    input, which the float64 gradient check uses)."""
    f = z.shape[1]
    zf = z.to(torch.promote_types(z.dtype, torch.float32))
    s = torch.einsum("bfd,bgd->bfg", zf, zf)
    rows, cols = np.tril_indices(f, -1)
    return s[:, torch.as_tensor(rows, device=z.device),
             torch.as_tensor(cols, device=z.device)].to(z.dtype)


def cache_exchange_ref(capacity: torch.Tensor, cache: torch.Tensor,
                       cap_accum: torch.Tensor, cache_accum: torch.Tensor,
                       freq: torch.Tensor, slots: torch.Tensor,
                       evict_rows: torch.Tensor, fetch_rows: torch.Tensor,
                       counts: torch.Tensor) -> None:
    """One batched swap between the capacity tier and the device cache,
    IN PLACE on the five tier tensors (the reference returns new arrays).

    capacity: (R, D); cache: (C, D); cap_accum: (R,), cache_accum: (C,),
    freq: (C,) fp32. Entry i with slots[i] >= 0 first writes the slot back
    to capacity row evict_rows[i] if that is >= 0, then fills the slot from
    capacity row fetch_rows[i] if that is >= 0, seeding freq[slot] with
    counts[i]. Entries with slots[i] < 0 are skipped (the TPU kernel's
    rule). Slots must be distinct and the evict/fetch row sets disjoint."""
    live = slots >= 0
    wb = live & (evict_rows >= 0)
    s_wb, r_wb = slots[wb].long(), evict_rows[wb].long()
    capacity[r_wb] = cache[s_wb]
    cap_accum[r_wb] = cache_accum[s_wb]
    ft = live & (fetch_rows >= 0)
    s_ft, r_ft = slots[ft].long(), fetch_rows[ft].long()
    cache[s_ft] = capacity[r_ft]
    cache_accum[s_ft] = cap_accum[r_ft]
    freq[s_ft] = counts[ft].to(freq.dtype)


def cache_fetch_ref(capacity: torch.Tensor, cap_accum: torch.Tensor,
                    fetch_rows: torch.Tensor):
    """FETCH half of the split exchange: gather capacity rows `fetch_rows`
    (N,) and their accumulators into a fresh shadow slab, reading the tiers
    only. A -1 entry gives a zero row and a zero accumulator. Returns
    (shadow (N, D), shadow_accum (N,))."""
    valid = fetch_rows >= 0
    take = fetch_rows.clamp(min=0).long()
    shadow = capacity.index_select(0, take)
    shadow_accum = cap_accum.index_select(0, take)
    shadow.masked_fill_(~valid[:, None], 0)
    shadow_accum.masked_fill_(~valid, 0)
    return shadow, shadow_accum


def cache_fetch_chunked_ref(capacity: torch.Tensor, cap_accum: torch.Tensor,
                            chunk_starts: torch.Tensor, chunk: int):
    """Chunk-granular fetch: block k of the (K*chunk, D) slab is capacity
    rows [chunk_starts[k], chunk_starts[k] + chunk) (starts clamped by the
    caller so the block ends inside the table; `kernels.sparse_plan.
    coalesce_rows`), and a -1 start gives a zero block. Row i of block k is
    slab row k*chunk + i. Returns (shadow (K*chunk, D),
    shadow_accum (K*chunk,))."""
    valid = chunk_starts >= 0
    rows = (chunk_starts.clamp(min=0).long()[:, None]
            + torch.arange(chunk, device=chunk_starts.device)[None, :])
    shadow, shadow_accum = cache_fetch_ref(
        capacity, cap_accum, rows.reshape(-1))
    keep = valid.repeat_interleave(chunk)
    shadow.masked_fill_(~keep[:, None], 0)
    shadow_accum.masked_fill_(~keep, 0)
    return shadow, shadow_accum


def cache_commit_ref(capacity: torch.Tensor, cache: torch.Tensor,
                     cap_accum: torch.Tensor, cache_accum: torch.Tensor,
                     shadow: torch.Tensor, shadow_accum: torch.Tensor,
                     slots: torch.Tensor, evict_rows: torch.Tensor,
                     fetch_rows: torch.Tensor,
                     src_pos: torch.Tensor | None = None) -> None:
    """COMMIT half of the split exchange, IN PLACE on the four tier tensors
    (the reference returns new arrays). Entry i with slots[i] >= 0 first
    writes the slot and its accumulator back to capacity row evict_rows[i]
    if that is >= 0, then, if fetch_rows[i] >= 0, installs shadow row
    src_pos[i] (default i) and its accumulator into the slot; fetch -1 is a
    pure writeback that keeps the slot. Slots must be distinct."""
    live = slots >= 0
    wb = live & (evict_rows >= 0)
    s_wb = slots[wb].long()
    capacity.index_copy_(0, evict_rows[wb].long(),
                         cache.index_select(0, s_wb))
    cap_accum.index_copy_(0, evict_rows[wb].long(),
                          cache_accum.index_select(0, s_wb))
    if src_pos is None:
        src_pos = torch.arange(slots.numel(), device=slots.device)
    ft = live & (fetch_rows >= 0)
    s_ft, p_ft = slots[ft].long(), src_pos[ft].long()
    cache.index_copy_(0, s_ft, shadow.index_select(0, p_ft))
    cache_accum.index_copy_(0, s_ft, shadow_accum.index_select(0, p_ft))


def lfu_touch_ref(freq: torch.Tensor, slots: torch.Tensor,
                  counts: torch.Tensor, decay: float) -> torch.Tensor:
    """Decay-then-bump LFU update, IN PLACE: freq *= decay, then
    freq[slots[i]] += counts[i] for every valid (>= 0) slot. Returns freq.
    One multiply and, for distinct slots, one add per slot — the
    reference's arithmetic, so the scores (and the eviction order they
    decide) come out bit-equal."""
    keep = slots >= 0
    freq.mul_(decay)
    freq.index_add_(0, slots[keep].long(), counts[keep].to(freq.dtype))
    return freq


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """fp32, or the input's dtype where it is wider (float64 for gradcheck)."""
    return torch.promote_types(t.dtype, torch.float32)


def _above_diagonal(sq: int, sk: int, device) -> torch.Tensor:
    return (torch.arange(sk, device=device)[None, :]
            > torch.arange(sq, device=device)[:, None])


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, with_lse: bool = False):
    """Attention on (b, h, s, dh): fp32 scores scaled by 1/sqrt(dh), -1e30
    above the diagonal when causal, softmax, times V in fp32; the result
    in q's dtype. The flash-attention kernel computes the same function
    with an online softmax over key tiles: this is its plain version in
    fp32, the fp32 oracle of the bf16 kernel and the function the TPU
    kernel computes. float64 inputs compute in float64.

    with_lse: also return each row's log-sum-exp of the scaled scores in
    log2 units, (b, h, s) in the compute dtype, as the kernels store it
    for the backward (`flash_attention_bwd_ref`)."""
    dh = q.shape[-1]
    acc = _acc_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc))
    s.div_(math.sqrt(dh))
    if causal:
        s.masked_fill_(_above_diagonal(q.shape[2], k.shape[2], q.device),
                       -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(acc)).to(q.dtype)
    if not with_lse:
        return out
    return out, torch.logsumexp(s, dim=-1).mul_(LOG2E)


#: log2(e): the bf16 flash-attention kernel folds it into the scale
LOG2E = 1.4426950408889634


def _scale_log2(dh: int) -> float:
    """1/sqrt(dh) * log2(e) as the kernels form it: both factors rounded to
    fp32, their product rounded to fp32."""
    return float(np.float32(np.float32(1.0 / math.sqrt(dh))
                            * np.float32(LOG2E)))


def flash_attention_tiled_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, block_k: int,
                              causal: bool = True, with_lse: bool = False):
    """The bf16 flash-attention kernel's arithmetic as torch ops on
    (b, h, s, dh): a loop over key tiles of `block_k` keys, each folded
    into an online softmax over all query rows at once. Scores are fp32
    products of the inputs, times scale * log2(e) (both fp32, their product
    rounded to fp32), -1e30 above the diagonal; then per tile the running
    max m' = max(m, rowmax x), p = exp2(x - m') in fp32, l' = l 2^(m-m') +
    sum p (the unrounded fp32 p), acc' = acc 2^(m-m') + P V with P rounded
    to v's dtype (bf16 for the kernel's inputs; fp32 inputs keep P in fp32)
    and fp32 products and sums; the result acc / max(l, 1e-30) in q's
    dtype. A tile wholly above a row's diagonal is all -1e30 there and
    changes nothing (2^0 = 1, exp2(-1e30 - m) = 0), so the loop needs no
    causal bound of its own. with_lse: also return m + log2(l) (fp32,
    (b, h, s)), the log-sum-exp in log2 units that the kernel stores."""
    sq, sk, dh = q.shape[2], k.shape[2], q.shape[-1]
    scale = _scale_log2(dh)
    qf = q.float()
    m = torch.full(q.shape[:3], -math.inf, device=q.device)
    l = torch.zeros(q.shape[:3], device=q.device)
    acc = torch.zeros(q.shape[:3] + (v.shape[-1],), device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None]
    for k0 in range(0, sk, block_k):
        x = torch.einsum("bhqd,bhkd->bhqk", qf,
                         k[:, :, k0:k0 + block_k].float()).mul_(scale)
        if causal:
            cols = torch.arange(k0, min(k0 + block_k, sk),
                                device=q.device)[None, :]
            x.masked_fill_(cols > rows, -1e30)
        m_new = torch.maximum(m, x.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(),
                          v[:, :, k0:k0 + block_k].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    if not with_lse:
        return out
    return out, m + torch.log2(l)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor,
                            causal: bool = True):
    """dQ, dK, dV of attention on (b, h, s, dh), the backward kernel's
    arithmetic (`csrc/flash_attention_bwd.cu`) as torch ops: from the
    forward's output o and its log-sum-exp `lse` in log2 units,
    x = (Q K^T) * scale * log2(e) (the kernels' fp32 product of the two
    factors), P = 2^(x - lse) with 0 above the diagonal when causal,
    dP = dO V^T, delta = rowsum(dO o O), dS = P o (dP - delta),
    dV = P^T dO, dK = dS^T Q scale and dQ = dS K scale, with P and dS
    rounded to v's dtype before the products that take them (bf16 for the
    bf16 kernels' inputs, whose tensor cores take bf16 operands: the
    forward rounds P before P V the same way; fp32 and float64 inputs round
    nothing), every product and sum in fp32 (float64 for float64 inputs);
    the results in q's dtype. Materialises (b, h, s, s) scores: a check of
    the kernel, not a way to train at length."""
    dh = q.shape[-1]
    acc = _acc_dtype(q)
    if acc == torch.float32:
        scale, scale_log2 = float(np.float32(1.0 / math.sqrt(dh))), \
            _scale_log2(dh)
    else:
        scale = 1.0 / math.sqrt(dh)
        scale_log2 = scale * LOG2E
    qa, ka, va, oa, da = (t.to(acc) for t in (q, k, v, o, do))
    p = torch.einsum("bhqd,bhkd->bhqk", qa, ka).mul_(scale_log2)
    p = torch.exp2(p.sub_(lse.to(acc)[..., None]))
    if causal:
        p.masked_fill_(_above_diagonal(q.shape[2], k.shape[2], q.device),
                       0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", da, va)
    delta = (da * oa).sum(-1)
    ds = (p * dp.sub_(delta[..., None])).to(v.dtype).to(acc)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).to(acc), da)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qa).mul_(scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, ka).mul_(scale)
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)
