"""Batched pairwise distances (port of srgan_st_tpu/ops/pairwise.py;
reference utils.py:157-191)."""

from __future__ import annotations

import torch

from srgan_st_tpu_torch.ops.resize import full_f32_matmul


def batch_pairwise_distance(x: torch.Tensor, y: torch.Tensor | None = None,
                            dist_norm: str = "l1") -> torch.Tensor:
    """x: (B, N, d); y: optional (B, M, d) -> (B, N, M).

    dist[b, i, j] = ||x[b,i] - y[b,j]||^2 for "l2" (clamped to >= 0, exact
    zeros on the diagonal when y is None, utils.py:186), the sum of
    absolute differences for "l1". The l2 cross term is a full-f32 product
    with TF32 off, as the JAX package's precision="highest" asks."""
    if dist_norm == "l1":
        yy = x if y is None else y
        return (x[:, :, None, :] - yy[:, None, :, :]).abs().sum(3)
    if dist_norm == "l2":
        x_norm = (x * x).sum(2)[:, :, None]
        yy = x if y is None else y
        y_norm = x_norm.transpose(1, 2) if y is None else (y * y).sum(2)[:, None, :]
        with full_f32_matmul():
            cross = torch.bmm(x, yy.transpose(1, 2))
        dist = x_norm + y_norm - 2.0 * cross
        if y is None:
            n = dist.shape[1]
            dist = dist * (1.0 - torch.eye(n, dtype=dist.dtype, device=dist.device))[None]
        return torch.clamp(dist, min=0.0)
    raise NotImplementedError(f"{dist_norm} norm has not been supported.")
