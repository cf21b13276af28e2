"""SRResNet generator (port of srgan_st_tpu/models/generator.py, eval mode).

Architecture parity with reference model.py:74-184: 9x9 conv + PReLU head,
`num_rcb` residual conv blocks (conv3x3-BN-PReLU-conv3x3-BN + identity), a
3x3 conv + BN fusion layer, global skip-add back to the head activations,
sub-pixel upsample blocks (conv3x3 to channels*r^2 + PReLU + pixel-shuffle),
a 9x9 reconstruction conv and a clamp to [0, 1].

Input and output are NHWC, as in the JAX package. Inside, the NCHW modules
run in `torch.channels_last` memory format, so the pre-shuffle activation
that reaches a kernel is already NHWC in memory. The state_dict keys are
the reference's (`conv1.0.weight`, `trunk.{i}.rcb.{0..4}`,
`upsampling.{i}.upsample_block.{0,2}`, `conv3.*`; see
tests/reference_impls.py TorchSRResNet).

The last upsample block's shuffle is elided and the reconstruction conv
runs on its pre-shuffle activation (conv2d_subpixel_pre_shuffled), through
the hand-written coarse conv kernel by default; TAIL_MODE="fused" runs the
last up-conv, PReLU and conv3 as one kernel (kernels/serving_tail.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from srgan_st_tpu_torch.models.common import BatchNorm, PReLU, TapConv, pixel_shuffle

_TRAIN_TODO = ("train mode waits for the training slice (ROADMAP.md Queue A, "
               "item 1: the warmup/GAN training path)")


class ResidualConvBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.rcb = nn.Sequential(
            nn.Conv2d(channels, channels, 3, 1, 1, bias=False),
            BatchNorm(channels),
            PReLU(),
            nn.Conv2d(channels, channels, 3, 1, 1, bias=False),
            BatchNorm(channels),
        )

    def forward(self, x):
        return self.rcb(x) + x


class UpsampleBlock(nn.Module):
    """conv3x3 to channels*r^2 + PReLU + pixel-shuffle. PReLU runs before
    the shuffle: its single shared slope commutes with it. With
    `fuse_shuffle` the block returns the PRE-shuffle activation (the
    consumer elides the matching space-to-depth)."""

    def __init__(self, channels: int, upscale_factor: int,
                 fuse_shuffle: bool = False):
        super().__init__()
        r = upscale_factor
        self.upscale_factor = r
        self.fuse_shuffle = fuse_shuffle
        self.upsample_block = nn.Sequential(
            nn.Conv2d(channels, channels * r * r, 3, 1, 1),
            nn.PixelShuffle(r),
            PReLU(),
        )

    def forward(self, x):
        """x: NCHW (channels_last)."""
        x = self.upsample_block[2](self.upsample_block[0](x))
        if self.fuse_shuffle:
            return x
        x = pixel_shuffle(x.permute(0, 2, 3, 1), self.upscale_factor)
        return x.permute(0, 3, 1, 2)


class Generator(nn.Module):
    """SRResNet. Input NHWC in [0, 1]; output NHWC float32 in [0, 1].

    The parameters are held in the compute dtype `dtype`; loading a float32
    state_dict casts, as the JAX package casts its float32 parameters at
    use."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 channels: int = 64, num_rcb: int = 16, upscale: int = 4,
                 dtype: torch.dtype = torch.float32,
                 trunk_mode: str | None = None, stem_mode: str | None = None,
                 conv3_mode: str | None = None,
                 conv3_inner: int | str | None = None,
                 tail_mode: str | None = None):
        super().__init__()
        self.channels = channels
        self.out_channels = out_channels
        self.upscale = upscale
        self.dtype = dtype
        self.trunk_mode = trunk_mode
        self.tail_mode = tail_mode
        factors = self._up_factors()
        # conv3_mode None: the last block's pixel-shuffle and the
        # reconstruction conv's space-to-depth are exact inverses, so both
        # are elided (ops/subpixel_conv.py conv2d_subpixel_pre_shuffled)
        self.fuse = conv3_mode is None

        if stem_mode == "s2d":
            stem = TapConv(in_channels, channels, 9, subpixel_factor=4)
        else:
            stem = TapConv(in_channels, channels, 9, mode="xla")
        self.conv1 = nn.Sequential(stem, PReLU())
        self.trunk = nn.Sequential(*[ResidualConvBlock(channels) for _ in range(num_rcb)])
        self.conv2 = nn.Sequential(
            nn.Conv2d(channels, channels, 3, 1, 1, bias=False), BatchNorm(channels))
        self.upsampling = nn.Sequential(*[
            UpsampleBlock(channels, r, fuse_shuffle=self.fuse and i == len(factors) - 1)
            for i, r in enumerate(factors)
        ])
        self.conv3 = TapConv(
            channels, out_channels, 9, mode=conv3_mode,
            pre_shuffle_factor=factors[-1] if self.fuse else 0,
            inner_factor=conv3_inner)
        self.to(dtype=dtype, memory_format=torch.channels_last)

    @classmethod
    def from_config(cls, config, dtype: torch.dtype | None = None) -> "Generator":
        from srgan_st_tpu_torch.core.device import compute_dtype

        return cls(
            in_channels=config.MODEL.G_IN_CHANNEL,
            out_channels=config.MODEL.G_OUT_CHANNEL,
            channels=config.MODEL.G_N_CHANNEL,
            num_rcb=config.MODEL.G_N_RCB,
            upscale=config.DATA.UPSCALE_FACTOR,
            dtype=dtype or compute_dtype(config.TPU.COMPUTE_DTYPE),
            trunk_mode=config.TPU.get("TRUNK_MODE"),
            stem_mode=config.TPU.get("STEM_MODE"),
            conv3_inner=config.TPU.get("CONV3_INNER"),
            tail_mode=config.TPU.get("TAIL_MODE"),
        )

    def _up_factors(self):
        if self.upscale in (2, 4, 8):
            return [2] * int(math.log2(self.upscale))
        if self.upscale == 3:
            return [3]
        raise ValueError(f"unsupported upscale factor {self.upscale}")

    def _use_fused_tail(self, x, r: int) -> bool:
        """Dispatch gate of the fused serving tail: explicit opt-in
        (tail_mode="fused"), the conv3 fusion active, a x2 last block, and
        the kernel's shape gate (serving_tail.fits_budget). x: NCHW."""
        if self.tail_mode != "fused" or not self.fuse or r != 2:
            return False
        from srgan_st_tpu_torch.kernels.serving_tail import fits_budget

        _, c, h, w = x.shape
        return fits_budget(h, w, c, self.channels * 4, self.out_channels)

    def _fused_tail(self, x, i: int):
        """The fused tail kernel on the composed path's own parameters.
        x: NCHW (channels_last) input of the last upsample block."""
        from srgan_st_tpu_torch.kernels.serving_tail import serving_tail

        up = self.upsampling[i].upsample_block
        dt = x.dtype
        out = serving_tail(
            x.permute(0, 2, 3, 1), up[0].weight.permute(2, 3, 1, 0).to(dt),
            up[0].bias, up[2].weight, self.conv3.hwio(dt), self.conv3.bias)
        return torch.clamp(out.float(), 0.0, 1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            raise NotImplementedError(_TRAIN_TODO)
        if self.trunk_mode is not None and self.trunk_mode.startswith("xpack"):
            raise NotImplementedError(
                "trunk_mode='xpack' (the BN-folded eval trunk) is not ported "
                "yet (ROADMAP.md Queue A, item 1: xpack_trunk as torch "
                "functions)")
        x = x.to(self.dtype)

        # Low-frequency information extraction layer (model.py:100-103)
        conv1 = self.conv1[1](self.conv1[0](x)).permute(0, 3, 1, 2)

        # High-frequency trunk + linear fusion layer + global skip
        h = self.trunk(conv1)
        h = self.conv2(h) + conv1

        # Sub-pixel zoom blocks (model.py:118-124)
        factors = self._up_factors()
        for i, r in enumerate(factors):
            if i == len(factors) - 1 and self._use_fused_tail(h, r):
                return self._fused_tail(h, i)
            h = self.upsampling[i](h)

        # Reconstruction (model.py:127) + clamp (model.py:150)
        out = self.conv3(h.permute(0, 2, 3, 1))
        return torch.clamp(out.float(), 0.0, 1.0)


def random_variables(seed: int, channels: int = 64, num_rcb: int = 16,
                     upscale: int = 4, in_channels: int = 3,
                     out_channels: int = 3) -> dict:
    """Seeded random generator weights as a JAX-format variables tree of
    float32 numpy arrays ({"params", "batch_stats"}; load with
    train/checkpoint.py generator_state_dict_from_variables).

    Kernels are drawn N(0, 1/fan_in), BN statistics and affine terms near
    identity, and conv3 is halved with a 0.5 bias, so that most of the
    output of an image in [0, 1] lies inside (0, 1) and the final clamp
    hides little: weights for parity tests and smoke runs, not a trained
    model."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def conv(k, cin, cout, bias=True, scale=1.0):
        std = scale / np.sqrt(k * k * cin)
        tree = {"kernel": (rng.standard_normal((k, k, cin, cout)) * std).astype(f32)}
        if bias:
            tree["bias"] = (0.1 * rng.standard_normal(cout)).astype(f32)
        return tree

    def prelu():
        return {"alpha": f32(rng.uniform(0.1, 0.3))}

    def bn():
        return ({"scale": rng.uniform(0.5, 1.0, channels).astype(f32),
                 "bias": (0.1 * rng.standard_normal(channels)).astype(f32)},
                {"mean": (0.1 * rng.standard_normal(channels)).astype(f32),
                 "var": rng.uniform(0.5, 1.5, channels).astype(f32)})

    params = {"conv1": conv(9, in_channels, channels), "prelu1": prelu()}
    stats = {}
    for i in range(num_rcb):
        (p1, s1), (p2, s2) = bn(), bn()
        params[f"rcb{i}"] = {"conv1": conv(3, channels, channels, bias=False),
                             "bn1": p1, "prelu": prelu(),
                             "conv2": conv(3, channels, channels, bias=False),
                             "bn2": p2}
        stats[f"rcb{i}"] = {"bn1": s1, "bn2": s2}
    params["conv2"] = conv(3, channels, channels, bias=False)
    params["bn2"], stats["bn2"] = bn()
    factors = [3] if upscale == 3 else [2] * int(math.log2(upscale))
    for i, r in enumerate(factors):
        params[f"up{i}"] = {"conv": conv(3, channels, channels * r * r),
                            "prelu": prelu()}
    params["conv3"] = conv(9, channels, out_channels, scale=0.5)
    params["conv3"]["bias"] = np.full(out_channels, 0.5, f32)
    return {"params": params, "batch_stats": stats}
