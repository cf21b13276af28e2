"""Shared model building blocks (port of srgan_st_tpu/models/common.py).

Modules keep torch's state_dict conventions (conv `weight` OIHW + `bias`,
BatchNorm `weight`/`bias`/`running_mean`/`running_var`, PReLU `weight` of
shape (1,)), so reference checkpoints load unchanged. Parameters and
buffers are float32, as the flax modules' are; each module casts them to
its input's dtype at use, explicitly, as the flax modules do with `dtype=`
(no autocast, whose per-op rules differ from those casts).
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose float32 weight and bias are cast to the input's
    dtype at use. The bias is added after the conv, in that dtype, as
    flax's nn.Conv adds it."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)
        if self.bias is None:
            return out
        return out + self.bias.to(x.dtype).view(1, -1, 1, 1)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW with the JAX BatchNorm's numerics
    (common.py:58-106). Eval: the running statistics cast to the input's
    dtype. Train: f32 batch moments, var = max(E[x^2] - m^2, 0), the
    normalize in the input's dtype with the f32 moments cast to it, and the
    running-stat EMA (momentum 0.1) of the UNBIASED variance updated in
    place on the f32 buffers. Both: (x - m) * rsqrt(var + eps) * w + b.

    Across processes (`group`, a parallel/mesh.py DataParallel of more than
    one rank), the JAX BatchNorm's `axis_name` and `stats_sync`:
      * "full" (sync-BN): the f32 moments (mean, E[x^2]) are averaged over
        the ranks on the differentiated path, so normalization and EMA both
        see the global batch, and n counts the whole world's elements;
      * "ema" (TPU.LOCAL_BN): each rank normalizes with its own moments,
        and the EMA takes the global ones (averaged off the differentiated
        path), so the running statistics stay identical on every rank."""

    group = None
    stats_sync = "full"

    def forward(self, x: torch.Tensor, train: bool = False,
                update: bool = True) -> torch.Tensor:
        """`update` False leaves the running statistics alone (a remat
        recomputation of a train-mode forward)."""
        dt = x.dtype
        shape = (1, -1, 1, 1)
        if train:
            xf = x.float()
            mean, mean2 = xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))
            n = x.numel() // x.shape[1]
            g_mean, g_mean2, g_n = mean, mean2, n
            g = self.group
            if g is not None and g.active:
                c = mean.shape[0]
                if self.stats_sync == "full":
                    mean, mean2 = g.pmean_differentiable(torch.cat([mean, mean2])).split(c)
                    g_mean, g_mean2 = mean.detach(), mean2.detach()
                else:
                    g_mean, g_mean2 = g.pmean([torch.cat([mean, mean2])])[0].split(c)
                g_n = n * g.world_size
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            g_var = var if g_mean is mean else torch.clamp(g_mean2 - g_mean * g_mean, min=0.0)
            if update:
                self.update_running(g_mean, g_var, g_n)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.to(dt).view(shape)) * torch.rsqrt(
            var.to(dt).view(shape) + torch.tensor(self.eps, dtype=dt))
        return y * self.weight.to(dt).view(shape) + self.bias.to(dt).view(shape)

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        """EMA of the batch mean and of the unbiased batch variance of n
        elements (biased `var` times n/(n-1)), in place."""
        self.running_mean.mul_(0.9).add_(0.1 * mean)
        self.running_var.mul_(0.9).add_(0.1 * var * (n / max(n - 1, 1)))


def set_data_parallel(module: nn.Module, group, local_bn: bool = False) -> None:
    """Every BatchNorm of `module` reduces its moments over `group` (a
    parallel/mesh.py DataParallel, or None for none): sync-BN, or under
    `local_bn` per-rank normalization with a global-moment EMA."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
            m.stats_sync = "ema" if local_bn else "full"


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
        # the coarse conv kernel's layout of the weight, rebuilt only when
        # the weight changes
        from srgan_st_tpu_torch.kernels.coarse_conv import KernelWeights

        self._kernel_weights = KernelWeights()

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
                x, w, b, factor=f, inner_factor=self.inner_factor,
                kernel_weights=functools.partial(
                    self._kernel_weights.get, self.weight, x.dtype))
        factor = 1 if self.mode == "xla" else self.subpixel_factor
        return conv2d_subpixel(x, w, b, factor=factor)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """The JAX package's initializers on every conv and dense layer of
    `module` (reference model.py:130-136): kaiming-normal conv kernels
    (fan_in, gain sqrt 2), flax's lecun-normal dense kernels (a normal of
    variance 1/fan_in truncated at 2 std), zero biases. BatchNorm and
    PReLU keep their constructor values (scale 1, bias 0; slope 0.25)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, TapConv)):
            nn.init.kaiming_normal_(m.weight, mode="fan_in", nonlinearity="relu",
                                    generator=generator)
        elif isinstance(m, nn.Linear):
            std = (1.0 / m.in_features) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
        else:
            continue
        if m.bias is not None:
            nn.init.zeros_(m.bias)


def pixel_shuffle(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Depth-to-space on NHWC, matching torch nn.PixelShuffle semantics:
    out[h*r+i, w*r+j, c] = in[h, w, c*r^2 + i*r + j]."""
    b, h, w, c = x.shape
    r = factor
    x = x.reshape(b, h, w, c // (r * r), r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # b, h, r, w, r, c'
    return x.reshape(b, h * r, w * r, c // (r * r))
