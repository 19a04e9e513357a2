"""internvl2-26b [vlm] — InternViT frontend STUBBED
(`data.synthetic.make_lm_batch` supplies patch embeddings); an
InternLM2-20B-style backbone. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=16384, vocab_size=92553,
    mlp_type="swiglu", norm_type="rmsnorm", rope_style="neox",
    frontend="vision", tie_embeddings=False, fsdp=True)
