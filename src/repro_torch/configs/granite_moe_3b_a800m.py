"""granite-moe-3b-a800m [moe] — 40 experts top-8. [hf:ibm-granite; hf]

expert_pad=8: the reference pads the 40 experts' weight tables to 48 so
that a 16-way expert-parallel axis shards them evenly. The 8 dummy
experts are never routed (the router scores the 40 real ones only); the
port keeps them so that the parameter trees stay equal."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=512, vocab_size=49155,
    n_experts=40, top_k=8, expert_pad=8, moe_every=1, mlp_type="swiglu",
    norm_type="rmsnorm", rope_style="neox", tie_embeddings=True)
