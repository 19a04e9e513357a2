"""DLRM config dataclass (the LM configs come with the LM slice)."""
from __future__ import annotations

import dataclasses


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
    lookup_impl: str = "gather"               # gather | psum (multi-device slice)
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
