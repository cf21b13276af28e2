"""PyTorch/CUDA port of srgan_st_tpu: serving, training (warmup, GAN, the
structure-tensor study's jobs, one or several GPUs), the data pipeline,
the figure tools and the utilities.

Mirrors the JAX package's module tree; the hand-written Hopper kernels
live in `kernels/` (wrappers) and `csrc/` (CUDA sources). Imports torch,
numpy and scipy; PIL, matplotlib and TensorBoard only inside the functions
that decode images or draw figures.
"""

from srgan_st_tpu_torch.core.config import Config  # noqa: F401
