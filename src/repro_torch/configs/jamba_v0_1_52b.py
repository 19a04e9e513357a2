"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16
experts top-2 on every other layer, int8 KV cache. [arXiv:2403.19887; hf]

fsdp=True is kept for equality with the reference config; the port runs
on one device."""
from repro_torch.configs.base import ModelConfig

_PATTERN = ("m", "m", "m", "a", "m", "m", "m", "m")  # attention 1:7

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=65536,
    n_experts=16, top_k=2, moe_every=2, moe_offset=1,
    layer_pattern=_PATTERN, ssm_state=16, ssm_headdim=64,
    ssm_expand=2, ssm_conv=4, ssm_ngroups=1,
    mlp_type="swiglu", norm_type="rmsnorm", rope_style="none",
    tie_embeddings=False, fsdp=True, kv_cache_dtype="int8")
