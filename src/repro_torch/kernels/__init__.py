"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Importing this package builds and loads nothing: each kernel is compiled
with nvcc at its first launch (or by `build_all`) on the machine with the
card.
"""
from repro_torch.kernels import (cache_ops, dot_interaction, embedding_bag,
                                 flash_attention, rowwise_adagrad,
                                 sparse_plan, sparse_update)
from repro_torch.kernels._build import Kernel, build_all

#: every kernel of the serving and training paths, in path order: the
#: lookups and the interaction, the cached tier's row movers (serving's
#: exchange, then training's fetch, chunked fetch and commit), the updates
#: (one plan, then the table-wise step's owner segments), the legacy
#: row-wise AdaGrad that the fused updates are held to, the LM prefill's
#: causal flash attention and, for LM training, its backward
KERNELS: tuple[Kernel, ...] = (embedding_bag.KERNEL,
                               embedding_bag.DEDUP_KERNEL,
                               dot_interaction.KERNEL, cache_ops.KERNEL,
                               cache_ops.FETCH_KERNEL,
                               cache_ops.FETCH_CHUNKED_KERNEL,
                               cache_ops.COMMIT_KERNEL,
                               sparse_update.KERNEL,
                               sparse_update.SEGMENTS_KERNEL,
                               rowwise_adagrad.KERNEL,
                               flash_attention.KERNEL,
                               flash_attention.BWD_KERNEL)

__all__ = ["KERNELS", "Kernel", "build_all", "cache_ops", "dot_interaction",
           "embedding_bag", "flash_attention", "rowwise_adagrad",
           "sparse_plan", "sparse_update"]
