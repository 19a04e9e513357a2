"""Public kernel ops of the port, named after `repro.kernels.ops`.

Dispatch is by the tensor's device, not by a flag: a CPU tensor takes the
plain PyTorch version, a CUDA tensor the hand-written kernel (or an error).
The TPU-only layout work of the reference wrappers — padding D to the
128-lane width and F to the 8-row sublane, `_pad_scale_lr`'s `sqrt(Dp/d)`
learning-rate rescale and `flash_attention`'s `sqrt(padded/dh)` query
rescale that compensate for it, and padding the sequence to the attention
block — has no counterpart.

Gradients: `dot_interaction` is a `torch.autograd.Function` whose backward
is the reference's `_dot_bwd` in torch ops (the reference computes it
outside any Pallas kernel too); `flash_attention`'s is the backward
kernel (`kernels.flash_attention.FlashAttention`). The lookups are never
differentiated on the training path: `core.dlrm.dlrm_grads` makes the
pooled embeddings an autograd leaf and hands their gradient to
`fused_sparse_backward`, so `embedding_bag`'s scatter-add backward has no
caller and is not ported.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import dot_interaction as _dot
from repro_torch.kernels import embedding_bag as _bag
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import rowwise_adagrad as _rw
from repro_torch.kernels import sparse_update as _upd
from repro_torch.kernels.sparse_plan import SparsePlan, build_sparse_plan


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """Pooled multi-hot lookup. table: (H, D); indices: (B, L) int32, -1
    pads. Returns (B, D)."""
    return _bag.embedding_bag(table, indices, mode)


def dedup_embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                        plan: SparsePlan | None = None,
                        mode: str = "sum") -> torch.Tensor:
    """Deduplicated pooled lookup: each unique row of `plan` is read from
    the table once. indices: (B, L) int32, -1 pads; plan: a `SparsePlan`
    over indices' flat stream (bag = slot // L), e.g. the one
    `data.pipeline.sparse_plan_hook` attaches; built on the device when
    None. Returns (B, D), bit-equal to `embedding_bag`."""
    if plan is None:
        plan = build_sparse_plan(indices.reshape(-1),
                                 lookups_per_bag=indices.shape[1])
    return _bag.dedup_embedding_bag(table, indices, plan.unique_rows, mode)


@functools.lru_cache(maxsize=None)
def _tril(f: int, device: torch.device) -> torch.Tensor:
    """(2, F*(F-1)//2) strict-lower-triangle indices on `device`, built once
    per (F, device): a training step's backward reuses them instead of
    allocating and filling them on the device every time."""
    return torch.tril_indices(f, f, offset=-1, device=device)


class _DotInteraction(torch.autograd.Function):
    """Forward: the dot-interaction kernel (plain version on the CPU).
    Backward: the reference's `_dot_bwd` — scatter the packed gradient into
    s_bar, add its transpose (d(zi.zj) reaches both rows), then s_bar @ z."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return _dot.dot_interaction(z)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        b, f, _ = z.shape
        dt = torch.promote_types(z.dtype, torch.float32)
        rows, cols = _tril(f, z.device)
        s_bar = torch.zeros((b, f, f), dtype=dt, device=z.device)
        s_bar[:, rows, cols] = g.to(dt)
        s_bar = s_bar + s_bar.transpose(1, 2)
        return torch.bmm(s_bar, z.to(dt)).to(z.dtype)


def dot_interaction(z: torch.Tensor) -> torch.Tensor:
    """z: (B, F, D) -> (B, F*(F-1)//2) strict-lower-triangle pairwise dots;
    differentiable with respect to z."""
    return _DotInteraction.apply(z)


def fused_sparse_backward(table: torch.Tensor, accum: torch.Tensor,
                          idx: torch.Tensor | None,
                          pooled_grad: torch.Tensor, lr: float,
                          eps: float = 1e-8, plan: SparsePlan | None = None):
    """One-pass sparse backward + row-wise AdaGrad from POOLED gradients,
    IN PLACE on table (H, D) and accum (H,) (the reference returns new
    arrays; at full width a second 43.6 GB table would not fit the card).

    idx: (B, F, L) int32 rows, -1 pads (may be None when `plan` is given);
    pooled_grad: (B, F, D) or (B*F, D) bag gradients; plan: built on the
    device from idx when None. Returns (table, accum)."""
    d = table.shape[1]
    if plan is None:
        if idx is None:
            raise ValueError("fused_sparse_backward needs idx or a plan")
        plan = build_sparse_plan(idx)
    pooled2 = pooled_grad.reshape(-1, d).to(torch.float32).contiguous()
    return _upd.fused_bag_backward_adagrad(
        table, accum, plan.unique_rows, plan.bag_offsets, plan.bag_ids,
        pooled2, lr, eps)


def fused_sparse_backward_segments(table: torch.Tensor, accum: torch.Tensor,
                                   seg_rows: torch.Tensor,
                                   seg_offsets: torch.Tensor,
                                   bag_ids: torch.Tensor,
                                   pooled_grad: torch.Tensor, lr: float,
                                   seg_base: torch.Tensor | None = None,
                                   eps: float = 1e-8):
    """`fused_sparse_backward` over S per-owner SEGMENTS of one plan, IN
    PLACE: segment s covers the rows owner s holds, with segment-local row
    ids rebased by seg_base[s] (`sparse_plan.split_plan_by_owner`).

    seg_rows: (S, C) int32 -1-padded; seg_offsets: (S, C+1) int32 ABSOLUTE
    into bag_ids (N,); pooled_grad: (B, F, D) or (B*F, D); seg_base (S,)
    defaults to zeros (segments already in table row space). Each covered
    row updates with the bits the unsegmented `fused_sparse_backward`
    gives it. Returns (table, accum)."""
    d = table.shape[1]
    if seg_base is None:
        seg_base = torch.zeros((seg_rows.shape[0],), dtype=torch.int32,
                               device=seg_rows.device)
    pooled2 = pooled_grad.reshape(-1, d).to(torch.float32).contiguous()
    return _upd.fused_bag_backward_adagrad_segments(
        table, accum, seg_rows, seg_offsets, bag_ids, pooled2, seg_base, lr,
        eps)


def rowwise_adagrad_update(table: torch.Tensor, accum: torch.Tensor,
                           indices: torch.Tensor, grads: torch.Tensor,
                           lr: float, eps: float = 1e-8):
    """Deduplicated row-wise AdaGrad from PER-LOOKUP gradients (the legacy
    two-pass layout), IN PLACE (the reference returns new arrays).

    indices: (N,) int32 rows, -1 pads; grads: (N, D) per-lookup gradients
    (`EmbeddingBagCollection.per_lookup_grads`). Pass one sums each row's
    gradients in sorted-slot order (`ref.dedup_grads_ref`, torch ops on the
    tensors' device); pass two is the `rowwise_adagrad` kernel. Fed the
    broadcast of a batch's pooled gradients, the result is bit-equal to
    `fused_sparse_backward` on the same batch, which avoids the (N, D)
    intermediates. Returns (table, accum)."""
    uniq, gsum = ref.dedup_grads_ref(indices, grads, table.shape[0])
    return _rw.rowwise_adagrad(table, accum, uniq, gsum, lr, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention on the layer layout: q, k, v (b, s, h, dh) -> (b, s, h,
    dh). Transposes to (b, h, s, dh) for the causal flash-attention kernel
    (the plain version, causal or not, on the CPU) and back. Where autograd
    records (grad mode on, an input that requires a gradient) it goes
    through `FlashAttention`: the forward kernel stores the log-sum-exp and
    the backward kernel differentiates it; otherwise (the prefill) the
    forward kernel runs alone and stores nothing more."""
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _flash.FlashAttention.apply(q, k, v, causal)
    else:
        out = _flash.flash_attention(q, k, v, causal)
    return out.transpose(1, 2)
