"""chatglm3-6b [dense] — 2D RoPE (glm style), GQA kv=2. [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab_size=65024,
    mlp_type="swiglu", norm_type="rmsnorm", rope_style="glm",
    qkv_bias=True, tie_embeddings=False)
