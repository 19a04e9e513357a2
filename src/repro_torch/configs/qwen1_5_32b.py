"""qwen1.5-32b [dense] — QKV bias, assigned kv=40 (MHA). [hf:Qwen; hf]

int8 KV cache: per-token-head scales halve the cache against bf16.
fsdp=True is kept for equality with the reference config; the port runs
on one device."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=27392, vocab_size=152064,
    mlp_type="swiglu", norm_type="rmsnorm", qkv_bias=True,
    rope_style="neox", tie_embeddings=False, fsdp=True,
    kv_cache_dtype="int8")
