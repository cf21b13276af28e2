"""Color-space helpers (port of srgan_st_tpu/ops/color.py).

`bgr2ycbcr` reproduces the reference's BT.601 conversion bit-for-bit
(reference utils.py:132-154) — PSNR/SSIM are evaluated on this Y channel.
`rgb_to_grayscale` matches torchvision's Grayscale() (ITU-R 601 luma on
RGB) used by the ST losses (reference loss.py:330-334, 399-401).
"""

from __future__ import annotations

import numpy as np
import torch

from srgan_st_tpu_torch.core.device import device_constant

# torchvision.transforms.Grayscale coefficients (rgb_to_grayscale)
_GRAY_RGB = (0.2989, 0.587, 0.114)

# ImageNet statistics (reference loss.py:52)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def rgb_to_grayscale(x: torch.Tensor, channel_axis: int = -1) -> torch.Tensor:
    """Luma of RGB images; keeps a singleton channel axis."""
    r, g, b = torch.split(x, 1, dim=channel_axis)
    return _GRAY_RGB[0] * r + _GRAY_RGB[1] * g + _GRAY_RGB[2] * b


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std per RGB channel, NHWC (reference loss.py:52,62-63)."""
    mean = device_constant("imagenet_mean", lambda: IMAGENET_MEAN, x.device, x.dtype)
    std = device_constant("imagenet_std", lambda: IMAGENET_STD, x.device, x.dtype)
    return (x - mean) / std


def bgr2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """Host-side BGR -> YCbCr, exact reference recipe (utils.py:132-154).

    uint8 input in [0,255] or float input in [0,1]; returns same dtype.
    """
    in_img_type = img.dtype
    if in_img_type != np.uint8:
        # the reference scales in the input float dtype before the float64
        # dot (utils.py:141-143); keep that order for bit parity
        img = img * np.asarray(255.0, dtype=in_img_type)
    if only_y:
        rlt = np.dot(img, [24.966, 128.553, 65.481]) / 255.0 + 16.0
    else:
        rlt = (
            np.matmul(
                img,
                [
                    [24.966, 112.0, -18.214],
                    [128.553, -74.203, -93.786],
                    [65.481, -37.797, 112.0],
                ],
            )
            / 255.0
            + [16, 128, 128]
        )
    if in_img_type == np.uint8:
        rlt = rlt.round()
    else:
        rlt = rlt / 255.0
    return rlt.astype(in_img_type)
