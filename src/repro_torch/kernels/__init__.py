"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

Importing this package builds and loads nothing: each kernel is compiled
with nvcc at its first launch (or by `build_all`) on the machine with the
card.
"""
from repro_torch.kernels import cache_ops, dot_interaction, embedding_bag
from repro_torch.kernels._build import Kernel, build_all

#: every kernel of the serving path, in path order
KERNELS: tuple[Kernel, ...] = (embedding_bag.KERNEL, dot_interaction.KERNEL,
                               cache_ops.KERNEL)

__all__ = ["KERNELS", "Kernel", "build_all", "cache_ops", "dot_interaction",
           "embedding_bag"]
