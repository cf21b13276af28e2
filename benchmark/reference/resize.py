"""MATLAB `imresize` bicubic (Keys a = -0.5, antialiased when shrinking,
edge samples repeated), the reference's training degradation
(bicubic.py:15-106): the GT patch /255, shrunk by the scale, then
quantized to round(255 x) / 255. Weights and products in float64."""

from __future__ import annotations

import math

import torch


def _cubic(x):
    a = x.abs()
    a2, a3 = a * a, a * a * a
    return ((1.5 * a3 - 2.5 * a2 + 1) * (a <= 1)
            + (-0.5 * a3 + 2.5 * a2 - 4 * a + 2) * ((a > 1) & (a <= 2)))


def resize_weights(in_len: int, out_len: int, scale: float, device) -> torch.Tensor:
    """(out_len, in_len) float64: row o holds the weights of output sample
    o over the input samples."""
    width = 4.0 / scale if scale < 1 else 4.0
    x = torch.arange(1, out_len + 1, dtype=torch.float64, device=device)
    u = x / scale + 0.5 * (1 - 1 / scale)  # output centre in 1-based input coordinates
    left = torch.floor(u - width / 2)
    taps = int(math.ceil(width)) + 2
    idx = left[:, None] + torch.arange(taps, dtype=torch.float64, device=device)[None]
    dist = u[:, None] - idx
    w = scale * _cubic(dist * scale) if scale < 1 else _cubic(dist)
    w = w / w.sum(1, keepdim=True)
    idx = idx.clamp(1, in_len).long() - 1
    out = torch.zeros(out_len, in_len, dtype=torch.float64, device=device)
    return out.scatter_add_(1, idx, w)


def degrade(gt_u8: torch.Tensor, upscale: int) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC GT -> (gt, lr), float32 NHWC in [0, 1]."""
    gt = gt_u8.double() / 255.0
    _, h, w, _ = gt.shape
    s = 1.0 / upscale
    mh = resize_weights(h, h // upscale, s, gt.device)
    mw = resize_weights(w, w // upscale, s, gt.device)
    lr = torch.einsum("oh,bhwc->bowc", mh, gt)
    lr = torch.einsum("pw,bowc->bopc", mw, lr)
    lr = torch.round(255.0 * lr) / 255.0
    return gt.float(), lr.float()
