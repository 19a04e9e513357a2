"""Model configs of the port."""
from repro_torch.configs.base import DLRMConfig  # noqa: F401
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_NAMES,
    get_config,
    get_smoke_config,
)
