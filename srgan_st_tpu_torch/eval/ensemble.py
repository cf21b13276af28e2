"""Geometric x8 self-ensemble (port of srgan_st_tpu/eval/ensemble.py).

The standard SISR test-time augmentation (EDSR): the applier runs on all
8 dihedral transforms of the input, each output is transformed back, and
the 8 are averaged. Worth ~0.1-0.2 dB PSNR at 8x the inference cost; the
reference has no counterpart (its eval is one forward, validate.py:61-113).

Composes with any applier `fn(lr_nhwc) -> sr_nhwc`: the whole-image
generator, the halo-tiled applier (eval/tiled.py) or an exported artifact
(eval/export.py). A non-square input reaches the applier as (H, W) and as
(W, H). The transforms and the float64 average run on the host, as in the
JAX package; the result is a float32 numpy batch.
"""

from __future__ import annotations

import numpy as np

from srgan_st_tpu_torch.eval.tiled import to_numpy


def dihedral(x: np.ndarray, k: int, flip: bool) -> np.ndarray:
    """rot90^k over (H, W), then an optional horizontal flip, of an NHWC
    batch."""
    x = np.rot90(x, k, axes=(1, 2))
    return x[:, :, ::-1] if flip else x


def dihedral_inverse(y: np.ndarray, k: int, flip: bool) -> np.ndarray:
    if flip:
        y = y[:, :, ::-1]
    return np.rot90(y, -k, axes=(1, 2))


def self_ensemble(apply_fn):
    """`apply_fn` wrapped into its x8 self-ensembled version."""

    def run(lr):
        lr = to_numpy(lr)
        acc = None
        for k in range(4):
            for flip in (False, True):
                sr = to_numpy(apply_fn(np.ascontiguousarray(dihedral(lr, k, flip))))
                sr = dihedral_inverse(sr, k, flip).astype(np.float64)
                acc = sr if acc is None else acc + sr
        return (acc / 8.0).astype(np.float32)

    return run
