"""Optimizers of the port (`repro.optim` counterpart)."""
from repro_torch.optim.optimizers import (Optimizer, adagrad, adamw,
                                          clip_by_global_norm, sgd)

__all__ = ["Optimizer", "adagrad", "adamw", "clip_by_global_norm", "sgd"]
