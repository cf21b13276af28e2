"""Parameter-free baseline "generators" for evaluation (port of
srgan_st_tpu/models/baselines.py).

`infer` and `validate` substitute these when EXP.NAME is "bicubic" /
"nearest" (reference validate.py:48-51): known scores that check the
metric pipeline itself. Each takes an NHWC float batch in [0, 1] (numpy or
a tensor) and returns the upscaled batch as a float32 tensor on its
device, the CUDA device unless the caller asks for another.
"""

from __future__ import annotations

import torch

from srgan_st_tpu_torch.core.device import resolve_device
from srgan_st_tpu_torch.ops.resize import nearest_upscale, resize_bicubic


class BicubicUpscaler:
    """MATLAB-compatible bicubic x`scale` upscaler with its
    round(255x)/255 quantization (reference bicubic.py:15-106)."""

    def __init__(self, scale: int = 4, device=None):
        self.scale = float(scale)
        self.device = resolve_device(device)

    def __call__(self, lr) -> torch.Tensor:
        x = torch.as_tensor(lr, device=self.device, dtype=torch.float32)
        return resize_bicubic(x, self.scale, method="matlab")


class NearestNeighbourUpscaler:
    """Nearest-neighbour x`scale` upscaler (reference bicubic.py:5-12)."""

    def __init__(self, scale: int = 4, device=None):
        self.scale = int(scale)
        self.device = resolve_device(device)

    def __call__(self, lr) -> torch.Tensor:
        return nearest_upscale(torch.as_tensor(lr, device=self.device, dtype=torch.float32),
                               self.scale)


def baseline(config, device=None):
    """The baseline EXP.NAME selects ("bicubic" / "nearest") at
    DATA.UPSCALE_FACTOR."""
    cls = {"bicubic": BicubicUpscaler, "nearest": NearestNeighbourUpscaler}[config.EXP.NAME]
    return cls(config.DATA.UPSCALE_FACTOR, device=device)
