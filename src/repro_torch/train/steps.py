"""The DLRM train step (the paper's split, Fig. 4): dense parameters with a
dense optimizer, the embedding mega table with row-wise AdaGrad applied by
the fused sparse backward to the rows the batch touched — no dense
gradient of the table is ever built.

The reference's `sparse_apply="dense"` mode scatter-adds into a
(total_rows + 1, d) fp32 buffer: 43.6 GB at full dlrm-m1 width beside a
43.6 GB table, which does not fit one 80 GB card. Both modes compute the
same update (the reference pins them within 1e-6), so the port trains with
`"sparse"`; `"dense"` is queued for a later slice, as are the cached, LM
and table-wise steps.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.configs.base import DLRMConfig
from repro_torch.core.dlrm import dlrm_grads
from repro_torch.core.embedding import EmbeddingBagCollection
from repro_torch.kernels import ops
from repro_torch.kernels.sparse_plan import plan_from_batch
from repro_torch.nn.params import init_params
from repro_torch.optim.optimizers import Optimizer


def build_dlrm_train_step(cfg: DLRMConfig, ebc: EmbeddingBagCollection,
                          dense_opt: Optimizer, sparse_lr: float = 0.05,
                          sparse_eps: float = 1e-8,
                          sparse_apply: str = "sparse") -> Callable:
    """Returns step(params, state, batch, step_idx) -> (params, state,
    metrics), state = {"dense": dense_opt state, "accum": (rows,) fp32},
    metrics = {"loss", "lookups"} (0-dim tensors on the batch's device).

    batch holds tensors on the parameters' device: "dense", "idx" (offset
    rows, -1 pads), "label", and optionally a `sparse_plan_hook` plan,
    which then drives both the deduplicated lookup and the sparse update;
    without one the update plans on the device.

    The mega table and the accumulator are updated IN PLACE (the returned
    params["emb"]["mega"] and state["accum"] are the tensors passed in);
    the dense parameters and their state are new tensors each step."""
    if sparse_apply != "sparse":
        raise NotImplementedError(
            f"sparse_apply={sparse_apply!r}: only 'sparse' is ported; the "
            "full-row-space 'dense' scatter comes with a later slice of the "
            "port (it needs a second table-sized buffer)")

    def step(params, state, batch, step_idx):
        loss, g_dense, (idx, g_pooled) = dlrm_grads(params, batch, cfg, ebc)
        new_dense, new_dense_state = dense_opt.apply(
            {"bottom": params["bottom"], "top": params["top"]}, g_dense,
            state["dense"], step_idx)
        with torch.no_grad():
            mega, accum = ops.fused_sparse_backward(
                params["emb"]["mega"], state["accum"], idx, g_pooled,
                sparse_lr, sparse_eps, plan=plan_from_batch(batch))
        lookups = (batch["idx"] >= 0).sum().to(torch.float32)
        return ({**new_dense, "emb": {"mega": mega}},
                {"dense": new_dense_state, "accum": accum},
                {"loss": loss, "lookups": lookups})

    return step


def dlrm_init_state(ebc: EmbeddingBagCollection, dense_opt: Optimizer,
                    params: dict) -> dict:
    """Optimizer state for the DLRM step: the dense optimizer's, and the
    row-wise accumulator (`ebc.optimizer_specs`) on the table's device."""
    dev = params["emb"]["mega"].device
    return {"dense": dense_opt.init({"bottom": params["bottom"],
                                     "top": params["top"]}),
            "accum": init_params(ebc.optimizer_specs(), 0, dev)["accum"]}
