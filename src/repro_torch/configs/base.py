"""Config dataclasses of the port: the LM family, DLRM, and the shape
registry, copied field for field from the reference's `configs/base.py`."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config covers the whole LM family (dense / ssm / moe / vlm /
    audio / hybrid). Unused knobs stay at their neutral defaults."""
    name: str
    family: str                      # dense|ssm|moe|vlm|audio|hybrid
    n_layers: int
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0                  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_style: str = "neox"         # neox|glm|none
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0
    sinusoidal_pos: bool = False     # musicgen-style absolute positions
    attn_block_q: int = 512
    attn_block_k: int = 1024
    causal_skip: bool = False        # static causal block skipping
    # mlp
    d_ff: int = 0
    mlp_type: str = "swiglu"         # swiglu|gelu
    norm_type: str = "rmsnorm"       # rmsnorm|layernorm
    # moe
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    expert_pad: int = 0
    moe_groups: int = 1
    # mamba / ssd
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    # hybrid layout: per-layer kind over one repeating period ("a"/"m")
    layer_pattern: tuple[str, ...] | None = None
    # embeddings / head
    tie_embeddings: bool = True
    # modality frontend stub: None | "vision" | "audio"
    frontend: str | None = None
    n_codebooks: int = 1
    # numerics & memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    grad_reduce_dtype: str = "float32"
    remat: str = "full"              # none|dots|full
    kv_cache_dtype: str = "bfloat16"  # bfloat16|int8
    # distribution policy
    fsdp: bool = False
    notes: str = ""

    def __post_init__(self):
        if self.n_heads and not self.d_head:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    @property
    def pattern(self) -> tuple[str, ...]:
        """Per-period layer kinds; homogeneous models use a period of 1."""
        if self.layer_pattern is not None:
            return self.layer_pattern
        return ("m",) if self.family == "ssm" else ("a",)

    @property
    def n_units(self) -> int:
        """Number of stacked units (layers / pattern period)."""
        period = len(self.pattern)
        if self.n_layers % period:
            raise ValueError(f"{self.name}: {self.n_layers} layers do not "
                             f"split into periods of {period}")
        return self.n_layers // period

    def is_moe_layer(self, global_idx: int) -> bool:
        """Whether layer `global_idx` is a MoE layer."""
        if self.n_experts <= 0:
            return False
        return global_idx % self.moe_every == self.moe_offset

    def param_count_estimate(self) -> int:
        """Analytic parameter count (the specs' scalars)."""
        from repro_torch.models.lm import lm_param_specs
        from repro_torch.nn.params import param_count
        return param_count(lm_param_specs(self))

    def active_param_count_estimate(self) -> int:
        """FLOP-active params per token for MODEL_FLOPS = 6*N*D, as the
        reference counts them: the input embedding's rows do no product
        (left out; a tied head's product is counted back), and a MoE
        layer counts only its top_k experts."""
        total = self.param_count_estimate()
        if self.frontend == "audio":
            total -= self.n_codebooks * self.vocab_size * self.d_model
        else:
            total -= self.vocab_size * self.d_model
        if self.tie_embeddings and self.frontend != "audio":
            total += self.vocab_size * self.d_model
        if self.n_experts > 0:
            n_moe_layers = sum(self.is_moe_layer(i)
                               for i in range(self.n_layers))
            per_expert = 3 * self.d_model * self.d_ff
            total -= n_moe_layers * (self.n_experts
                                     - self.top_k) * per_expert
        return total


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """The paper's model (Fig. 3 / Table II)."""
    name: str
    family: str = "dlrm"
    n_dense_features: int = 512
    n_sparse_features: int = 32
    embed_dim: int = 64                       # d in the paper
    hash_sizes: tuple[int, ...] = ()          # per-table; len == n_sparse
    mean_lookups: tuple[int, ...] = ()        # per-table pooling lengths
    truncation: int = 32                      # paper section V lookup cap
    bottom_mlp: tuple[int, ...] = (512, 256, 64)
    top_mlp: tuple[int, ...] = (512, 512, 256, 1)
    interaction: str = "dot"                  # dot|cat (paper section III-A.3)
    # numerics / placement
    param_dtype: str = "float32"
    compute_dtype: str = "float32"            # paper trains fp32
    placement: str = "auto"                   # auto|table_wise|row_wise|replicated|cached_host
    lookup_impl: str = "gather"               # gather | psum (under a mesh)
    grad_reduce_dtype: str = "float32"
    hbm_budget_gb: float = 6.0                # per-chip EMB budget
    notes: str = ""

    def __post_init__(self):
        if len(self.hash_sizes) != self.n_sparse_features or \
                len(self.mean_lookups) != self.n_sparse_features:
            raise ValueError(
                f"{self.name}: hash_sizes/mean_lookups need one entry per "
                f"sparse feature ({self.n_sparse_features})")

    def table_bytes(self) -> tuple[int, ...]:
        """Bytes of each embedding table at the param dtype."""
        item = 4 if self.param_dtype == "float32" else 2
        return tuple(h * self.embed_dim * item for h in self.hash_sizes)


@dataclasses.dataclass(frozen=True)
class Shape:
    """One (sequence length, global batch) cell of an arch."""
    name: str
    kind: str          # train|prefill|decode|dlrm_train|dlrm_infer
    seq_len: int = 0
    global_batch: int = 0


LM_SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": Shape("prefill_32k", "prefill", seq_len=32768,
                         global_batch=32),
    "decode_32k": Shape("decode_32k", "decode", seq_len=32768,
                        global_batch=128),
    "long_500k": Shape("long_500k", "decode", seq_len=524288, global_batch=1),
}

DLRM_SHAPES: dict[str, Shape] = {
    "train_b64k": Shape("train_b64k", "dlrm_train", global_batch=65536),
    "infer_b8k": Shape("infer_b8k", "dlrm_infer", global_batch=8192),
}

#: archs with sub-quadratic sequence mixing get long_500k
SUBQUADRATIC = ("mamba2-780m", "jamba-v0.1-52b")


def shapes_for(arch: str) -> dict[str, Shape]:
    """The reference's shape cells of one arch."""
    if arch.startswith("dlrm"):
        return dict(DLRM_SHAPES)
    out = dict(LM_SHAPES)
    if arch not in SUBQUADRATIC:
        del out["long_500k"]
    return out
