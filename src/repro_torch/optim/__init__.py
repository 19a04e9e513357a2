"""Optimizers of the port (`repro.optim` counterpart)."""
from repro_torch.optim.optimizers import Optimizer, adagrad, sgd

__all__ = ["Optimizer", "adagrad", "sgd"]
