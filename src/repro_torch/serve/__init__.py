"""Serving engines of the port: overload-robust DLRM CTR serving."""
from repro_torch.serve.dlrm_engine import (  # noqa: F401
    DLRMServeEngine,
    Overloaded,
    ServeCircuitBreaker,
    ServeMetrics,
    ServeRequest,
    ServeResponse,
)
from repro_torch.serve.engine import DLRMEngine  # noqa: F401
