"""PyTorch + CUDA port of the DLRM system for NVIDIA Hopper (H100).

The JAX package `repro` is the reference; this package mirrors its module
names so each counterpart is easy to find, and never imports it (nor jax).
Entry points run on the card unless the caller asks for the CPU with
`device="cpu"`; every kernel on the serving and training paths is a
hand-written CUDA C++ kernel under `repro_torch/kernels/csrc/`.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) but absent —
    there is no silent CPU fallback. DLRM computes in fp32, so TF32 is
    switched off for both matmul and cuDNN whenever CUDA is selected."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) "
                "to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
