"""Optimizers of the port (`repro.optim` counterpart)."""
from repro_torch.optim.compression import (compress_decompress,
                                           error_feedback_compress,
                                           init_residual)
from repro_torch.optim.easgd import (EASGDState, easgd_init, easgd_sync,
                                     local_sgd_sync, replica_step)
from repro_torch.optim.optimizers import (Optimizer, adagrad, adamw,
                                          clip_by_global_norm, sgd)

__all__ = ["EASGDState", "Optimizer", "adagrad", "adamw",
           "clip_by_global_norm", "compress_decompress", "easgd_init",
           "easgd_sync", "error_feedback_compress", "init_residual",
           "local_sgd_sync", "replica_step", "sgd"]
