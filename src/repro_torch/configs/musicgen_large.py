"""musicgen-large [audio] — decoder-only over EnCodec tokens, 4 parallel
codebooks; the EnCodec frontend STUBBED (`data.synthetic.make_lm_batch`
supplies frame embeddings). [arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048,
    mlp_type="gelu", norm_type="layernorm", rope_style="none",
    sinusoidal_pos=True, frontend="audio", n_codebooks=4,
    tie_embeddings=False)
