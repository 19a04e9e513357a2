"""Serving engines of the port: the LM slot engine and overload-robust
DLRM CTR serving."""
from repro_torch.serve.dlrm_engine import (  # noqa: F401
    DLRMServeEngine,
    Overloaded,
    ServeCircuitBreaker,
    ServeMetrics,
    ServeRequest,
    ServeResponse,
)
from repro_torch.serve.engine import (  # noqa: F401
    DLRMEngine,
    DrainTimeout,
    Request,
    ServeEngine,
)
