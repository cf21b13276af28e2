"""SRGAN discriminator (port of srgan_st_tpu/models/discriminator.py).

Architecture parity with reference model.py:7-71: eight 3x3 conv layers
(64-64-128-128-256-256-512-512 channels, alternating stride 1/2, BatchNorm
+ LeakyReLU(0.2) on all but the first), then flatten -> Linear(512*6*6 ->
1024) -> LeakyReLU(0.2) -> Linear(1024 -> 1), logits out. Hard-wired to
96x96 inputs. Parameter count at the default config: 23,563,649.

Input NHWC, as in the JAX package; the modules are the reference's, with
its state_dict keys (`features.{0, 3i-1, 3i}`, `classifier.{0, 2}`), and
the flatten before `classifier.0` is torch's (C, H, W) order — the JAX
package flattens (H, W, C), a fixed permutation of fc1's input rows that
train/checkpoint.py applies when weights are carried across. The JAX
package's packed-GEMM stem backward (ops/fastgrad.py StemConv3x3) is a TPU
scheduling device: here the stem is a plain conv and autograd computes the
same gradient. With `taps` (torch node names "features.{3i+1}", the
LeakyReLU outputs) the forward returns those activations, NHWC, and stops
after the deepest: ContentDiscriminator's feature taps (reference
loss.py:259-266).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from srgan_st_tpu_torch.models.common import BatchNorm, Conv2d, init_weights, set_data_parallel
from srgan_st_tpu_torch.utils.profiling import span


class Linear(nn.Linear):
    """nn.Linear whose float32 weight and bias are cast to the input's
    dtype at use, the bias added after the product (flax nn.Dense)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class LeakyReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, 0.2)


class Discriminator(nn.Module):
    """Input NHWC (B, 96, 96, C_in); output float32 logits (B, out)."""

    def __init__(self, in_channels: int = 3, channels: int = 64,
                 out_channels: int = 1, dtype: torch.dtype = torch.float32,
                 group=None, local_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        c = channels
        layers = [Conv2d(in_channels, c, 3, 1, 1), LeakyReLU()]
        cin = c
        for feat, stride in ((c, 2), (2 * c, 1), (2 * c, 2), (4 * c, 1),
                             (4 * c, 2), (8 * c, 1), (8 * c, 2)):
            layers += [Conv2d(cin, feat, 3, stride, 1, bias=False), BatchNorm(feat),
                       LeakyReLU()]
            cin = feat
        self.features = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            Linear(8 * c * 6 * 6, 1024), LeakyReLU(), Linear(1024, out_channels))
        init_weights(self)
        self.to(memory_format=torch.channels_last)
        # across processes: sync-BN, or per-rank normalization (TPU.LOCAL_BN;
        # the JAX Discriminator's axis_name and local_bn)
        set_data_parallel(self, group, local_bn)

    @classmethod
    def from_config(cls, config, dtype: torch.dtype | None = None,
                    group=None) -> "Discriminator":
        from srgan_st_tpu_torch.core.device import compute_dtype

        return cls(
            in_channels=config.MODEL.D_IN_CHANNEL,
            channels=config.MODEL.D_N_CHANNEL,
            out_channels=config.MODEL.D_OUT_CHANNEL,
            dtype=dtype or compute_dtype(config.TPU.COMPUTE_DTYPE),
            group=group,
            local_bn=bool(config.TPU.get("LOCAL_BN")),
        )

    def forward(self, x: torch.Tensor, train: bool = False, taps: tuple[str, ...] = ()):
        """train=True: batch statistics, running statistics updated in place.
        With `taps`: {tap: NHWC activation} instead of the logits. The
        span `d.forward` holds it."""
        with span("d.forward"):
            h = x.to(self.dtype).permute(0, 3, 1, 2)
            deepest = max((int(t.split(".")[1]) for t in taps), default=-1)
            tap_out = {}
            for i, layer in enumerate(self.features):
                h = layer(h, train) if isinstance(layer, BatchNorm) else layer(h)
                if f"features.{i}" in taps:
                    tap_out[f"features.{i}"] = h.permute(0, 2, 3, 1)
                if taps and i >= deepest:
                    return tap_out
            h = h.reshape(h.shape[0], -1)  # torch's (C, H, W) flatten
            return self.classifier(h).float()
