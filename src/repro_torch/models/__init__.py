"""Models of the port: the LM zoo (every family of the reference)."""
from repro_torch.models.lm import (  # noqa: F401
    decode_step,
    init_caches,
    init_lm_params,
    lm_forward,
    lm_param_specs,
    prefill_step,
)
