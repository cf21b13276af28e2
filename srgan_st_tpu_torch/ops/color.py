"""Color-space helpers (port of srgan_st_tpu/ops/color.py, eval part).

`bgr2ycbcr` reproduces the reference's BT.601 conversion bit-for-bit
(reference utils.py:132-154) — PSNR/SSIM are evaluated on this Y channel.
"""

from __future__ import annotations

import numpy as np


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
