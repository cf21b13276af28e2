"""Real-ESRGAN x4plus's generator, RRDBNet (ESRGAN, arXiv:1809.00219;
Real-ESRGAN, arXiv:2107.10833; basicsr's basicsr/archs/rrdbnet_arch.py),
as plain functions of a parameter dict keyed by basicsr's state-dict names
(`conv_first`, `body.{i}.rdb{1,2,3}.conv{1..5}`, `conv_body`, `conv_up1`,
`conv_up2`, `conv_hr`, `conv_last`, each `.weight` OIHW and `.bias`).
Float32 with TF32 off; every convolution 3x3, SAME padding, with bias;
LeakyReLU slope 0.2; residuals scaled by 0.2.

Departures from basicsr: input and output are NHWC (basicsr's are NCHW),
and the output is clamped to [0, 1], as Real-ESRGAN's inference clamps it
(basicsr's forward returns it unclamped). Only scale 4 (basicsr's scales 1
and 2 first pixel-unshuffle the input)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.train import full_float32

SLOPE = 0.2
RES_SCALE = 0.2


def conv(x, p, name, quant=None):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if quant is not None:
        x, w = quant(x, "act"), quant(w, "weight")
    return F.conv2d(x, w, None, 1, 1) + b.view(1, -1, 1, 1)


def lrelu(x):
    return F.leaky_relu(x, SLOPE)


def rdb(x, p, name, quant=None):
    """x + 0.2 c5([x, x1..x4]), x_k = lrelu(c_k([x, x1..x_{k-1}])). NCHW."""
    feats = [x]
    for k in range(1, 5):
        feats.append(lrelu(conv(torch.cat(feats, 1), p, f"{name}.conv{k}", quant)))
    return x + RES_SCALE * conv(torch.cat(feats, 1), p, f"{name}.conv5", quant)


def rrdb(x, p, name, quant=None):
    h = x
    for j in (1, 2, 3):
        h = rdb(h, p, f"{name}.rdb{j}", quant)
    return x + RES_SCALE * h


def num_blocks(p) -> int:
    n = 0
    while f"body.{n}.rdb1.conv1.weight" in p:
        n += 1
    return n


def generator(p, lr, quant=None):
    """(B, h, w, 3) LR in [0, 1] -> (B, 4h, 4w, 3) SR in [0, 1]."""
    x = lr.permute(0, 3, 1, 2)
    feat = conv(x, p, "conv_first", quant)
    h = feat
    for i in range(num_blocks(p)):
        h = rrdb(h, p, f"body.{i}", quant)
    feat = feat + conv(h, p, "conv_body", quant)
    feat = lrelu(conv(F.interpolate(feat, scale_factor=2, mode="nearest"), p, "conv_up1", quant))
    feat = lrelu(conv(F.interpolate(feat, scale_factor=2, mode="nearest"), p, "conv_up2", quant))
    out = conv(lrelu(conv(feat, p, "conv_hr", quant)), p, "conv_last", quant)
    return torch.clamp(out, 0.0, 1.0).permute(0, 2, 3, 1)


@torch.no_grad()
def upscale(sd: dict, lr: torch.Tensor, quant=None) -> torch.Tensor:
    """The reference's frame: float32 parameters and input, TF32 off."""
    p = {k: v.float() for k, v in sd.items()}
    with full_float32():
        return generator(p, lr.float(), quant)
