"""PyTorch/CUDA port of srgan_st_tpu (serving slice).

Mirrors the JAX package's module tree; the hand-written Hopper kernels
live in `kernels/` (wrappers) and `csrc/` (CUDA sources). Imports torch,
numpy and scipy only.
"""

from srgan_st_tpu_torch.core.config import Config  # noqa: F401
