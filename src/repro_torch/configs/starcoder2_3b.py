"""starcoder2-3b [dense] — GQA kv=2, RoPE, LN+GELU, bias. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense", n_layers=30, d_model=3072,
    n_heads=24, n_kv_heads=2, d_ff=12288, vocab_size=49152,
    mlp_type="gelu", norm_type="layernorm", qkv_bias=True,
    rope_style="neox", rope_theta=1e5, tie_embeddings=True)
