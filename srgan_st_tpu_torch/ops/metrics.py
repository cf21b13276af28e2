"""Evaluation metrics: PSNR / SSIM and the uint8 image round-trip
(port of srgan_st_tpu/ops/metrics.py).

Host-side numpy/float64 by design, with the exact uint8 round-trip recipe:

    tensor2img uint8 round-trip (reference utils.py:62-87)
    -> RGB->BGR swap -> /255 float32
    -> bgr2ycbcr Y (BT.601, reference utils.py:132-154)
    -> x255 -> float64 PSNR (utils.py:90-102) / SSIM (utils.py:105-129).

The SSIM window filter is scipy's `ndimage.correlate` with the mirror
border, which is OpenCV's default BORDER_REFLECT_101.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage


def tensor2img(img, out_type=np.uint8, min_max=(0.0, 1.0)) -> np.ndarray:
    """NHWC (or HWC/HW) float array -> uint8 BGR HWC image, matching
    reference utils.py:62-87."""
    if hasattr(img, "detach"):  # a torch tensor
        img = img.detach().float().cpu().numpy()
    img = np.asarray(img, dtype=np.float32)
    img = np.squeeze(img)
    img = np.clip(img, min_max[0], min_max[1])
    img = (img - min_max[0]) / (min_max[1] - min_max[0])
    if img.ndim == 3:
        img = img[..., ::-1]  # RGB -> BGR (channel-last already)
    elif img.ndim != 2:
        raise TypeError(f"Only 3D (HWC) and 2D tensors supported, got ndim={img.ndim}")
    if out_type == np.uint8:
        img = (img * 255.0).round()
    return img.astype(out_type)


def psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR on [0, 255]-range arrays, float64 (reference utils.py:90-102)."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _filter2d(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    return ndimage.correlate(img, window, mode="mirror")


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    kernel = np.exp(-(x**2) / (2 * sigma**2))
    kernel = (kernel / kernel.sum())[:, None]
    return np.outer(kernel, kernel.T)


def ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """SSIM on [0, 255]-range arrays: 11x11 Gaussian window sigma=1.5,
    C1=(0.01*255)^2, C2=(0.03*255)^2, 5-px border crop (reference
    utils.py:105-129)."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window(11, 1.5)

    mu1 = _filter2d(img1, window)[5:-5, 5:-5]
    mu2 = _filter2d(img2, window)[5:-5, 5:-5]
    mu1_sq = mu1**2
    mu2_sq = mu2**2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _filter2d(img1**2, window)[5:-5, 5:-5] - mu1_sq
    sigma2_sq = _filter2d(img2**2, window)[5:-5, 5:-5] - mu2_sq
    sigma12 = _filter2d(img1 * img2, window)[5:-5, 5:-5] - mu1_mu2

    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())
