"""mamba2-780m [ssm] — SSD, attention-free, state=128.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536,
    vocab_size=50280, d_ff=0, ssm_state=128, ssm_headdim=64,
    ssm_expand=2, ssm_conv=4, ssm_ngroups=1, rope_style="none",
    norm_type="rmsnorm", tie_embeddings=True)
