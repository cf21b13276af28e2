"""The reference's eval forward (validate.py): running BN statistics, no
gradient, float32 with TF32 off."""

from __future__ import annotations

import torch

from benchmark.reference.models import generator
from benchmark.reference.train import full_float32


@torch.no_grad()
def upscale(g_sd: dict, lr: torch.Tensor, quant=None) -> torch.Tensor:
    """(B, h, w, 3) LR in [0, 1] -> (B, 4h, 4w, 3) SR, float32."""
    p = {k: v.float() for k, v in g_sd.items() if v.is_floating_point()}
    with full_float32():
        return generator(p, lr.float(), False, quant)
