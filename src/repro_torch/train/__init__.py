"""Training side of the port (`repro.train` counterpart): the steps,
checkpointing and the resilience stack."""
from repro_torch.train.checkpoint import (CheckpointCorruptionError,
                                          CheckpointManager)
from repro_torch.train.fault_tolerance import (ChaosReport,
                                               DegradationManager,
                                               FaultInjector, FaultSpec,
                                               InjectedFault,
                                               PreemptionHandler,
                                               RetryPolicy,
                                               StragglerDetector, TrainState,
                                               TransientFetchFault,
                                               restore_train_state,
                                               run_chaos_loop,
                                               run_resilient_loop,
                                               save_train_state)
from repro_torch.train.steps import (build_cached_train_step,
                                     build_dlrm_train_step,
                                     build_tablewise_train_step,
                                     cached_dlrm_init_state, dlrm_init_state)

__all__ = ["ChaosReport", "CheckpointCorruptionError", "CheckpointManager",
           "DegradationManager", "FaultInjector", "FaultSpec",
           "InjectedFault", "PreemptionHandler", "RetryPolicy",
           "StragglerDetector", "TrainState", "TransientFetchFault",
           "build_cached_train_step", "build_dlrm_train_step",
           "build_tablewise_train_step", "cached_dlrm_init_state",
           "dlrm_init_state", "restore_train_state", "run_chaos_loop",
           "run_resilient_loop", "save_train_state"]
