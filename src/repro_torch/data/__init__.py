"""Synthetic data and the reader pipeline of the port."""
from repro_torch.data.synthetic import make_dlrm_batch  # noqa: F401
