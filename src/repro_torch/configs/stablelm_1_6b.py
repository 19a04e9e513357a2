"""stablelm-1.6b [dense] — MHA, partial rotary 25%.
[hf:stabilityai/stablelm-2-1_6b; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=5632, vocab_size=100352,
    mlp_type="swiglu", norm_type="layernorm", rotary_pct=0.25,
    rope_style="neox", tie_embeddings=False)
