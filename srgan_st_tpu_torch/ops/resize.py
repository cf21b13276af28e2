"""Bicubic resampling as dense separable matmuls (port of
srgan_st_tpu/ops/resize.py).

* ``method="matlab"`` — MATLAB `imresize`-compatible bicubic (Keys a=-0.5,
  antialiasing when downscaling, edge clamping and the final
  ``round(255*x)/255`` quantization): the reference's training-data
  degradation (reference bicubic.py:15-106, dataset.py:28).
* ``method="torch"`` — `F.interpolate(mode="bicubic", align_corners=False)`
  weights (a=-0.75, no antialiasing, half-pixel centers).

The resampling weights are small dense (out, in) matrices built once per
size on the host; the resize is two float32 contractions.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from srgan_st_tpu_torch.core.device import device_constant


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    """Keys cubic convolution kernel with parameter ``a``."""
    absx = np.abs(x)
    absx2 = absx * absx
    absx3 = absx2 * absx
    f = ((a + 2) * absx3 - (a + 3) * absx2 + 1) * (absx <= 1) + (
        a * absx3 - 5 * a * absx2 + 8 * a * absx - 4 * a
    ) * ((1 < absx) & (absx <= 2))
    return f


@functools.lru_cache(maxsize=256)
def matlab_resize_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """Dense (out_size, in_size) row-resampling matrix, MATLAB imresize
    convention (reference bicubic.py:38-81: `contribute`).

    For scale<1 the kernel is widened to 4/scale and scaled (antialiasing);
    out-of-range taps are clamped to the edge samples, accumulating their
    weights there.
    """
    kernel_width = 4.0
    if scale < 1:
        kernel_width = 4.0 / scale
    x = np.arange(1, out_size + 1, dtype=np.float64)
    # Output sample center in input coordinates (1-based).
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(np.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]
    mid = u[:, None] - indices
    if scale < 1:
        weight = scale * _cubic(mid * scale, a=-0.5)
    else:
        weight = _cubic(mid, a=-0.5)
    weight = weight / weight.sum(axis=1, keepdims=True)
    indices = np.clip(indices, 1, in_size).astype(np.int64) - 1  # to 0-based

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), p), indices.reshape(-1)), weight.reshape(-1))
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=256)
def torch_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) matrix matching torch's
    ``F.interpolate(mode="bicubic", align_corners=False)`` (cubic convolution
    a=-0.75, half-pixel centers, no antialiasing, edge-clamped taps)."""
    scale = in_size / out_size  # torch uses the reciprocal "area" scale
    i = np.arange(out_size, dtype=np.float64)
    center = (i + 0.5) * scale - 0.5
    isrc = np.floor(center)
    frac = center - isrc
    # Four taps at isrc-1 .. isrc+2 with Keys a=-0.75 weights.
    offsets = np.arange(-1, 3, dtype=np.float64)
    taps = isrc[:, None] + offsets[None, :]
    weight = _cubic(frac[:, None] - offsets[None, :], a=-0.75)
    taps = np.clip(taps, 0, in_size - 1).astype(np.int64)

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    np.add.at(mat, (np.repeat(np.arange(out_size), 4), taps.reshape(-1)), weight.reshape(-1))
    return mat.astype(np.float32)


def _resize_matrices(in_h, in_w, out_h, out_w, scale, method):
    if method == "matlab":
        mh = matlab_resize_matrix(in_h, out_h, scale)
        mw = matlab_resize_matrix(in_w, out_w, scale) if (in_w, out_w) != (in_h, out_h) else mh
    elif method == "torch":
        mh = torch_resize_matrix(in_h, out_h)
        mw = torch_resize_matrix(in_w, out_w) if (in_w, out_w) != (in_h, out_h) else mh
    else:
        raise NotImplementedError(f"{method} resize has not been supported.")
    return mh, mw


@contextlib.contextmanager
def full_f32_matmul():
    """Full float32 matmuls on the card: TF32 (the JAX package's default
    bf16 passes on the TPU) flips the round(255x)/255 quantization of many
    pixels (the JAX package measured ~15%), so the flag is cleared around
    the contractions and restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def resize_bicubic(x: torch.Tensor, scale: float, method: str = "matlab",
                   quantize: bool | None = None) -> torch.Tensor:
    """Separable bicubic resize of NHWC float images by ``scale``;
    quantize=None resolves to True for "matlab", False for "torch"."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC input, got shape {tuple(x.shape)}")
    _, h, w, _ = x.shape
    out_h, out_w = int(h * scale), int(w * scale)
    if quantize is None:
        quantize = method == "matlab"
    mh, mw = (device_constant(("resize", h, w, out_h, out_w, scale, method, i),
                              lambda i=i: _resize_matrices(h, w, out_h, out_w, scale,
                                                           method)[i],
                              x.device, x.dtype) for i in (0, 1))
    # rows then cols, the reference's order (bicubic.py:94-104)
    with full_f32_matmul():
        out = torch.einsum("oh,bhwc->bowc", mh, x)
        out = torch.einsum("pw,bowc->bopc", mw, out)
    if quantize:
        out = torch.round(255.0 * out) / 255.0
    return out


def nearest_upscale(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour NHWC upscale (reference bicubic.py:5-12)."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
