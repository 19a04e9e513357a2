"""Training steps of the port (`repro.train` counterpart)."""
from repro_torch.train.steps import (build_cached_train_step,
                                     build_dlrm_train_step,
                                     build_tablewise_train_step,
                                     cached_dlrm_init_state, dlrm_init_state)

__all__ = ["build_cached_train_step", "build_dlrm_train_step",
           "build_tablewise_train_step", "cached_dlrm_init_state",
           "dlrm_init_state"]
