"""SRResNet generator and SRGAN discriminator as plain functions of a
parameter dict keyed by the reference code's state-dict names
(model.py:7-184). Images are NHWC float32 in [0, 1]; inside, NCHW."""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LEAKY_SLOPE = 0.2
# (out-channel multiple of the base width, stride) of D's layers 2..8
D_LAYERS = ((1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (8, 1), (8, 2))


def conv(x, w, b=None, stride=1, quant=None):
    """SAME-padded cross-correlation (odd kernel), NCHW."""
    if quant is not None:
        x, w = quant(x, "act"), quant(w, "weight")
    y = F.conv2d(x, w, None, stride, w.shape[-1] // 2)
    return y if b is None else y + b.view(1, -1, 1, 1)


def linear(x, w, b, quant=None):
    if quant is not None:
        x, w = quant(x, "act"), quant(w, "weight")
    return F.linear(x, w) + b


def batch_norm(x, p, name, train):
    """Train: the batch's mean and biased variance, and the running
    statistics move toward the mean and the unbiased variance (momentum
    0.1), in place. Eval: the running statistics."""
    if train:
        mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            p[f"{name}.running_mean"].mul_(0.9).add_(0.1 * mean)
            p[f"{name}.running_var"].mul_(0.9).add_(0.1 * var * (n / (n - 1)))
    else:
        mean, var = p[f"{name}.running_mean"], p[f"{name}.running_var"]
    shape = (1, -1, 1, 1)
    return ((x - mean.view(shape)) / torch.sqrt(var.view(shape) + BN_EPS)
            * p[f"{name}.weight"].view(shape) + p[f"{name}.bias"].view(shape))


def prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def generator(p, lr, train, quant=None):
    """SRResNet: 9x9 conv + PReLU, residual blocks (conv-BN-PReLU-conv-BN
    + identity), conv-BN + the head's activation, x2 sub-pixel stages
    (conv, pixel shuffle, PReLU), 9x9 conv, clamp to [0, 1]."""
    x = lr.permute(0, 3, 1, 2)
    head = prelu(conv(x, p["conv1.0.weight"], p["conv1.0.bias"], quant=quant),
                 p["conv1.1.weight"])
    h = head
    i = 0
    while f"trunk.{i}.rcb.0.weight" in p:
        base = f"trunk.{i}.rcb"
        t = batch_norm(conv(h, p[f"{base}.0.weight"], quant=quant), p, f"{base}.1", train)
        t = prelu(t, p[f"{base}.2.weight"])
        h = batch_norm(conv(t, p[f"{base}.3.weight"], quant=quant), p, f"{base}.4", train) + h
        i += 1
    h = batch_norm(conv(h, p["conv2.0.weight"], quant=quant), p, "conv2.1", train) + head
    i = 0
    while f"upsampling.{i}.upsample_block.0.weight" in p:
        base = f"upsampling.{i}.upsample_block"
        h = conv(h, p[f"{base}.0.weight"], p[f"{base}.0.bias"], quant=quant)
        h = prelu(F.pixel_shuffle(h, 2), p[f"{base}.2.weight"])
        i += 1
    out = conv(h, p["conv3.weight"], p["conv3.bias"], quant=quant)
    return torch.clamp(out, 0.0, 1.0).permute(0, 2, 3, 1)


def discriminator(p, img, train, taps=(), quant=None):
    """The SRGAN discriminator's logits (B, 1), or with `taps` the
    activations after the named LeakyReLUs ("features.{i}"), NCHW, up to
    the deepest one."""
    h = img.permute(0, 3, 1, 2)
    h = F.leaky_relu(conv(h, p["features.0.weight"], p["features.0.bias"], quant=quant),
                     LEAKY_SLOPE)
    out = {}
    if "features.1" in taps:
        out["features.1"] = h
    for j, (_, stride) in enumerate(D_LAYERS):
        i = 2 + 3 * j
        h = conv(h, p[f"features.{i}.weight"], stride=stride, quant=quant)
        h = F.leaky_relu(batch_norm(h, p, f"features.{i + 1}", train), LEAKY_SLOPE)
        if f"features.{i + 2}" in taps:
            out[f"features.{i + 2}"] = h
            if len(out) == len(taps):
                return out
    h = h.reshape(h.shape[0], -1)
    h = F.leaky_relu(linear(h, p["classifier.0.weight"], p["classifier.0.bias"], quant),
                     LEAKY_SLOPE)
    return linear(h, p["classifier.2.weight"], p["classifier.2.bias"], quant)
