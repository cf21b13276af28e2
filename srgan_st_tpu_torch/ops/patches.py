"""Patch extraction (port of srgan_st_tpu/ops/patches.py).

The reference's F.unfold / tensor.unfold patches (reference loss.py:116-130
and loss.py:186-201) for NHWC images. Features inside a flattened patch are
ordered (C, kh, kw), channel-major, as torch.nn.functional.unfold orders
them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def extract_patches(x: torch.Tensor, ksize: int, stride: int,
                    padding: int = 0) -> torch.Tensor:
    """NHWC images -> (B, N, C*ksize*ksize) flattened patches."""
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    b, h, w, c = x.shape
    if stride == ksize and h % ksize == 0 and w % ksize == 0:
        # non-overlapping: a reshape and a transpose
        nh, nw = h // ksize, w // ksize
        p = x.reshape(b, nh, ksize, nw, ksize, c).permute(0, 1, 3, 5, 2, 4)
        return p.reshape(b, nh * nw, c * ksize * ksize)
    p = F.unfold(x.permute(0, 3, 1, 2), ksize, stride=stride)  # (B, C*k*k, L)
    return p.transpose(1, 2)


def extract_patch_grids(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """NHWC images -> (B, N, C, ksize, ksize) non-overlapping patch grids
    (reference loss.py:186-201 `compute_patches`). H and W must be
    multiples of ksize."""
    b, h, w, c = x.shape
    if h % ksize or w % ksize:
        raise ValueError(f"image size {h}x{w} not divisible by ksize={ksize}")
    nh, nw = h // ksize, w // ksize
    p = x.reshape(b, nh, ksize, nw, ksize, c).permute(0, 1, 3, 5, 2, 4)
    return p.reshape(b, nh * nw, c, ksize, ksize)
