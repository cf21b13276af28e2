"""Shared model building blocks (port of srgan_st_tpu/models/common.py).

Modules keep torch's state_dict conventions (conv `weight` OIHW + `bias`,
BatchNorm `weight`/`bias`/`running_mean`/`running_var`, PReLU `weight` of
shape (1,)), so reference checkpoints load unchanged. Only eval mode is
ported in this slice.
"""

from __future__ import annotations

import torch
import torch.nn as nn


class BatchNorm(nn.BatchNorm2d):
    """Eval-mode BatchNorm over NCHW, computed in the input's dtype with
    the running statistics cast to it, as the JAX BatchNorm does
    (common.py:102-106): (x - mean) * rsqrt(var + eps) * scale + bias.
    Train-mode batch statistics wait for the training slice."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        shape = (1, -1, 1, 1)
        mean = self.running_mean.to(dt).view(shape)
        var = self.running_var.to(dt).view(shape)
        y = (x - mean) * torch.rsqrt(var + torch.tensor(self.eps, dtype=dt))
        return y * self.weight.to(dt).view(shape) + self.bias.to(dt).view(shape)


class PReLU(nn.Module):
    """Parametric ReLU with a single shared slope, init 0.25 (torch
    nn.PReLU defaults; state_dict key `weight`, shape (1,))."""

    def __init__(self) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class TapConv(nn.Module):
    """SAME conv specialised for tiny channel counts — the generator's 9x9
    stem (3 -> 64) and reconstruction conv (64 -> 3). NHWC in and out;
    parameters are nn.Conv2d's (weight OIHW, bias), so checkpoints are
    interchangeable with a plain conv.

    mode None runs the space-to-depth-factored formulation with
    `subpixel_factor`, "xla" the direct conv. pre_shuffle_factor > 0: the
    input is the PRE-shuffle activation of an elided pixel_shuffle; the
    coarse conv runs directly on it with `inner_factor` (see
    ops/subpixel_conv.py conv2d_subpixel_pre_shuffled)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 mode: str | None = None, pre_shuffle_factor: int = 0,
                 inner_factor: int | str | None = 1, subpixel_factor: int = 2):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.kaiming_normal_(self.weight, mode="fan_in", nonlinearity="relu")
        self.mode = mode
        self.pre_shuffle_factor = pre_shuffle_factor
        self.inner_factor = inner_factor
        self.subpixel_factor = subpixel_factor

    def hwio(self, dtype: torch.dtype) -> torch.Tensor:
        return self.weight.permute(2, 3, 1, 0).to(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from srgan_st_tpu_torch.ops.subpixel_conv import (
            conv2d_subpixel,
            conv2d_subpixel_pre_shuffled,
        )

        w, b = self.hwio(x.dtype), self.bias.to(x.dtype)
        f = self.pre_shuffle_factor
        if f:
            return conv2d_subpixel_pre_shuffled(
                x, w, b, factor=f, inner_factor=self.inner_factor)
        factor = 1 if self.mode == "xla" else self.subpixel_factor
        return conv2d_subpixel(x, w, b, factor=factor)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space on NHWC, matching torch nn.PixelShuffle semantics:
    out[h*r+i, w*r+j, c] = in[h, w, c*r^2 + i*r + j]."""
    b, h, w, c = x.shape
    r = factor
    x = x.reshape(b, h, w, c // (r * r), r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # b, h, r, w, r, c'
    return x.reshape(b, h * r, w * r, c // (r * r))
