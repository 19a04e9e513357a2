"""The DLRM model (paper Fig. 3): bottom MLP over dense features ->
EmbeddingBagCollection over sparse features -> feature interaction -> top
MLP -> logit, and the split dense / sparse gradients of the paper's
training step (Fig. 4): autograd over the dense tower, with the pooled
embeddings as a leaf whose gradient feeds the fused sparse backward.

Under a (data, model) mesh (`launch.mesh`), or a (pod, data, model) one,
the dense tower is data parallel, as pjit makes the reference's: each
rank runs its slice of the batch over every axis but `model`, its BCE is
its examples' sum over the GLOBAL batch size, the dense gradients are
summed over those axes, and the reported loss is the mean of every
example's term gathered over them (so it is the single-device
loss whenever the per-example terms are). `cfg.lookup_impl == "psum"`
then pools through `EmbeddingBagCollection.lookup_pooled_psum`.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.core.interaction import interact, interaction_dim
from repro_torch.kernels.sparse_plan import plan_from_batch
from repro_torch.nn.layers import linear, linear_specs
from repro_torch.nn.params import init_params, tree_leaves, tree_map


def _mlp_specs(dims, in_dim: int, in_ax: str | None, out_ax: str | None):
    specs, d = [], in_dim
    for i, width in enumerate(dims):
        # the reference alternates the logical axes, so consecutive layers
        # shard on opposite sides (Megatron's f / g pairing)
        a_in, a_out = (in_ax, out_ax) if i % 2 == 0 else (out_ax, in_ax)
        specs.append(linear_specs(d, width, a_in, a_out, bias=True))
        d = width
    return specs, d


def dlrm_param_specs(cfg: DLRMConfig, ebc: EmbeddingBagCollection) -> dict:
    """ParamSpec tree for the full DLRM — the reference's layout: bottom /
    top MLP layer lists of {w (in, out), b} + the collection's mega table."""
    bottom, bot_out = _mlp_specs(cfg.bottom_mlp, cfg.n_dense_features,
                                 None, "dense_ff")
    if bot_out != cfg.embed_dim:
        raise ValueError(f"bottom MLP must end at embed_dim: {bot_out} != "
                         f"{cfg.embed_dim}")
    top_in = interaction_dim(cfg.n_sparse_features, cfg.embed_dim,
                             cfg.interaction)
    top, top_out = _mlp_specs(cfg.top_mlp, top_in, None, "dense_ff")
    if top_out != 1:
        raise ValueError(f"top MLP must end at 1, got {top_out}")
    return {"bottom": bottom, "top": top, "emb": ebc.param_specs()}


def init_dlrm_params(cfg: DLRMConfig, ebc: EmbeddingBagCollection,
                     seed: int, device: torch.device) -> dict:
    """Random DLRM parameters on `device` from a generator seeded `seed`."""
    return init_params(dlrm_param_specs(cfg, ebc), seed, device)


def _compute_dtype(cfg: DLRMConfig) -> torch.dtype:
    return torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16


def _mlp_apply(layers, x, dtype):
    for i, p in enumerate(layers):
        x = linear(p, x, dtype)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def dlrm_forward_dense(params: dict, dense_x: torch.Tensor,
                       pooled: torch.Tensor, cfg: DLRMConfig) -> torch.Tensor:
    """Everything downstream of the embedding lookup.

    dense_x: (B, n_dense); pooled: (B, F, d). Returns (B,) fp32 logits."""
    dtype = _compute_dtype(cfg)
    bot = _mlp_apply(params["bottom"], dense_x.to(dtype), dtype)
    top_in = interact(bot, pooled.to(dtype), cfg.interaction)
    logit = _mlp_apply(params["top"], top_in, dtype)
    return logit[..., 0].float()


def _lookup(params: dict, batch: dict, cfg: DLRMConfig,
            ebc: EmbeddingBagCollection, mesh=None) -> torch.Tensor:
    if cfg.lookup_impl == "psum" and mesh is not None:
        return ebc.lookup_pooled_psum(params["emb"], batch["idx"], mesh)
    # a batch-attached plan (data.pipeline.sparse_plan_hook) dedups the
    # forward gather; the fused sparse backward reuses the same plan
    return ebc.lookup(params["emb"], batch["idx"],
                      plan=plan_from_batch(batch))


def dlrm_forward(params: dict, batch: dict, cfg: DLRMConfig,
                 ebc: EmbeddingBagCollection, mesh=None) -> torch.Tensor:
    """Full forward: embedding lookup + dense tower -> (B,) logits.
    batch: {"dense" (B, n_dense), "idx" (B, F, L) int32 offset rows}, and
    optionally a plan's "plan_rows"/"plan_offsets"/"plan_bags". With a
    mesh and `lookup_impl="psum"`, batch is this rank's slice, params["emb"]
    its `model` shard, and the logits its slice's."""
    pooled = _lookup(params, batch, cfg, ebc, mesh)
    return dlrm_forward_dense(params, batch["dense"], pooled, cfg)


def dlrm_loss(params: dict, batch: dict, cfg: DLRMConfig,
              ebc: EmbeddingBagCollection) -> torch.Tensor:
    """Binary cross-entropy (CTR); the paper's NE is normalized BCE."""
    return _bce(dlrm_forward(params, batch, cfg, ebc), batch["label"])


def dlrm_grads(params: dict, batch: dict, cfg: DLRMConfig,
               ebc: EmbeddingBagCollection, mesh=None):
    """Returns (loss, dense_grads, (idx (B,F,L), pooled_grads (B,F,d) fp32)).

    The mega table only ever sees sparse gradients: the lookup runs without
    autograd and its pooled output becomes a leaf, so the backward stops
    there and every valid lookup slot inherits its bag's gradient
    (`kernels.ops.fused_sparse_backward`). The dense parameters are taken
    as detached leaves, so the caller's tensors never require grad.

    Under `mesh`, batch is this rank's `data` slice and params["emb"] its
    `model` shard (see the module docstring)."""
    with torch.no_grad():
        pooled = _lookup(params, batch, cfg, ebc, mesh)
    loss, g_dense, g_pooled = dense_grads(params, batch, pooled, cfg, mesh)
    return loss, g_dense, (batch["idx"], g_pooled)


def dense_grads(params: dict, batch: dict, pooled: torch.Tensor,
                cfg: DLRMConfig, mesh=None):
    """The dense half of `dlrm_grads`, from pooled embeddings looked up
    elsewhere (the table-wise step's exchanged or staged activations):
    BCE of `dlrm_forward_dense`, differentiated with `pooled` (B, F, d) as
    a leaf. Returns (loss, dense_grads, pooled_grads (B, F, d) fp32).

    With a mesh whose batch axes (every axis but `model`: `data`, and
    `pod` on a pod mesh) hold more than one rank, batch and pooled are
    this rank's slice: the dense gradients come back summed over those
    axes (the same bits on every rank), the pooled gradients stay this
    slice's, and the loss is the global batch's mean."""
    axes = () if mesh is None else tuple(
        a for a in mesh.axis_names if a != "model")
    n_data = 1
    for a in axes:
        n_data *= mesh.size(a)
    pooled = pooled.detach().requires_grad_()
    dense = tree_map(lambda t: t.detach().requires_grad_(),
                     {"bottom": params["bottom"], "top": params["top"]})
    with torch.enable_grad():
        logits = dlrm_forward_dense(dense, batch["dense"], pooled, cfg)
        if n_data == 1:
            loss = _bce(logits, batch["label"])
        else:
            # the gradient of the global mean: each example's term over
            # the global batch size, as the single-device mean gives it
            terms = _bce_terms(logits, batch["label"])
            loss = terms.sum() / (terms.shape[0] * n_data)
        leaves = tree_leaves(dense)
        grads = torch.autograd.grad(loss, leaves + [pooled])
    g_dense = grads[:-1]
    if n_data > 1:
        # one all_reduce of every dense gradient, flattened
        flat = torch.cat([g.reshape(-1) for g in g_dense])
        for a in axes:
            mesh.all_reduce(flat, a)
        g_dense = [x.view_as(g) for x, g in zip(
            torch.split(flat, [g.numel() for g in g_dense]), g_dense)]
        terms = terms.detach()
        for a in reversed(axes):
            terms = mesh.gather_rows(terms, a)
        loss = torch.mean(terms)
    it = iter(g_dense)
    return loss.detach(), tree_map(lambda _: next(it), dense), \
        grads[-1].float()


def _bce_terms(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(_bce_terms(logits, labels))


def normalized_entropy(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """The paper's model-quality metric (section VI-C): BCE normalized by
    the entropy of the base CTR."""
    bce = _bce(logits, labels)
    p = torch.clamp(torch.mean(labels), 1e-6, 1 - 1e-6)
    base = -(p * torch.log(p) + (1 - p) * torch.log(1 - p))
    return bce / base
