"""Roofline model for the target hardware.

  compute term    = FLOPs / (chips x peak_FLOP/s)
  memory term     = HBM bytes / (chips x HBM_bw)
  collective term = per-chip collective bytes / link_bw
                    (equivalently global collective bytes / (chips x link_bw))

FLOPs and bytes are GLOBAL; collective bytes are PER-CHIP. The dominant
term is the step-time lower bound; roofline_fraction = model_flops /
(dominant_s x chips x peak) is "useful-FLOP utilization at the bound" (an
MFU upper bound estimate).

Two specs: `TPU_V5E`, the reference package's target, kept under its own
name, and `H100`, the port's (`HW`). The H100's numbers are NVIDIA's
data-sheet figures for the SXM5 part (dense bf16 tensor-core rate without
sparsity, HBM3 rate and capacity, NVLink 4 in one direction), not
measurements; a card set below its 700 W power limit runs slower.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HWSpec:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12      # per chip
    hbm_bw: float = 819e9                # bytes/s per chip
    ici_bw: float = 50e9                 # bytes/s per link
    hbm_bytes: float = 16e9              # capacity per chip


TPU_V5E = HWSpec()
H100 = HWSpec(name="NVIDIA H100 80GB HBM3", peak_flops_bf16=989e12,
              hbm_bw=3.35e12, ici_bw=450e9, hbm_bytes=80e9)
HW = H100

#: the H100's HBM bytes/s and dense bf16 FLOP/s, the bounds of the kernels
#: line of `chip_smoke.py`
HBM_BYTES_PER_S = H100.hbm_bw
BF16_FLOPS = H100.peak_flops_bf16


def roofline_terms(flops: float, bytes_hbm: float,
                   collective_bytes_per_chip: float, chips: int,
                   model_flops: float, hw: HWSpec = HW) -> dict:
    compute_s = flops / (chips * hw.peak_flops_bf16)
    memory_s = bytes_hbm / (chips * hw.hbm_bw)
    collective_s = collective_bytes_per_chip / hw.ici_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    util = (model_flops / (bound_s * chips * hw.peak_flops_bf16)
            if bound_s > 0 else 0.0)
    return {
        **terms,
        "dominant": dominant,
        "bound_s": bound_s,
        "model_flops_ratio": (model_flops / flops) if flops else 0.0,
        "roofline_fraction": util,
    }
