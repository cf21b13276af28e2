"""Structure-tensor numerics (port of srgan_st_tpu/ops/structure_tensor.py).

The reference's ST math (reference utils.py:194-280): separable Gaussian /
Gaussian-derivative filtering to the smoothed structure tensor
S = (Jxx, Jyy, Jxy), determinant normalization, the closed-form inv(S1)*S2
of symmetric 2x2 fields, closed-form eigenvalues, and the Riemannian
log-eigenvalue distance with the reference's clamp at 1 (utils.py:272-275).

Whole images filter with 1-D SAME zero-padded convolutions (torch
`conv2d(padding='same')`); small patches (PatchwiseST, reference
loss.py:336-350) with banded (k x k) matrices, so each patch's six
convolutions are batched products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from srgan_st_tpu_torch.core.device import device_constant


def gaussian_kernel(sigma: float, also_dg: bool = False, radius: int | None = None):
    """1-D Gaussian (and optionally its derivative) taps as numpy arrays
    (reference utils.py:194-208): radius max(int(4 sigma + 0.5), 1), the
    normalized Gaussian phi, derivative phi * (-x) / sigma^2."""
    if radius is None:
        radius = max(int(4 * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    sigma2 = sigma * sigma + 1e-12
    phi = np.exp(-0.5 / sigma2 * x**2).astype(np.float32)
    phi = phi / phi.sum()
    if also_dg:
        return phi, (phi * -x / sigma2).astype(np.float32)
    return phi


def _conv1d_same(x: torch.Tensor, taps: np.ndarray, axis: str) -> torch.Tensor:
    """SAME zero-padded 1-D cross-correlation of (B, 1, H, W) along H or W."""
    k = len(taps)
    shape = (1, 1, k, 1) if axis == "h" else (1, 1, 1, k)
    kernel = device_constant(("taps", tuple(np.asarray(taps, np.float32).tolist())),
                             lambda: taps, x.device, x.dtype).reshape(shape)
    return F.conv2d(x, kernel, padding="same")


def structure_tensor(im: torch.Tensor, sigma: float = 1.0, rho: float = 10.0) -> torch.Tensor:
    """Smoothed structure tensor of grayscale images (reference
    utils.py:212-233, batched): (B, 1, H, W) -> (B, 3, H, W) (Jxx, Jyy, Jxy)."""
    g, dg = gaussian_kernel(sigma, also_dg=True)
    ix = _conv1d_same(_conv1d_same(im, dg, "h"), g, "w")
    iy = _conv1d_same(_conv1d_same(im, g, "h"), dg, "w")
    k = gaussian_kernel(rho)

    def smooth(z):
        return _conv1d_same(_conv1d_same(z, k, "h"), k, "w")

    return torch.cat([smooth(ix * ix), smooth(iy * iy), smooth(ix * iy)], dim=1)


@functools.lru_cache(maxsize=64)
def _banded_same_matrix(size: int, taps_key) -> np.ndarray:
    """(size, size) M with M @ x the SAME zero-padded cross-correlation of
    x with the odd-length taps."""
    taps = np.asarray(taps_key, dtype=np.float32)
    r = (len(taps) - 1) // 2
    mat = np.zeros((size, size), dtype=np.float32)
    for i in range(size):
        for j in range(size):
            t = j - i + r
            if 0 <= t < len(taps):
                mat[i, j] = taps[t]
    return mat


def _banded(size: int, taps: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    key = tuple(np.asarray(taps, np.float32).tolist())
    return device_constant(("banded", size, key), lambda: _banded_same_matrix(size, key),
                           like.device, like.dtype)


def structure_tensor_patches(patches: torch.Tensor, sigma: float = 0.5,
                             rho: float = 2.0) -> torch.Tensor:
    """Structure tensor of a batch of small grayscale patches, (..., K, K)
    -> (..., 3, K, K) (Jxx, Jyy, Jxy): `structure_tensor` mapped over the
    patches (reference loss.py:347), each SAME 1-D convolution a banded
    (K, K) product, conv_h(x) = M @ x and conv_w(x) = x @ M^T."""
    k = patches.shape[-1]
    g, dg = gaussian_kernel(sigma, also_dg=True)
    mg, mdg = _banded(k, g, patches), _banded(k, dg, patches)
    mr = _banded(k, gaussian_kernel(rho), patches)

    def conv_hw(x, mh, mw):
        return torch.einsum("ij,...jl,kl->...ik", mh, x, mw)

    ix = conv_hw(patches, mdg, mg)
    iy = conv_hw(patches, mg, mdg)
    return torch.stack([conv_hw(ix * ix, mr, mr), conv_hw(iy * iy, mr, mr),
                        conv_hw(ix * iy, mr, mr)], dim=-3)


def st_normalize(s: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Determinant-normalize a stacked symmetric 2x2 field (reference
    utils.py:236-239); s: (..., 3, H, W) (Jxx, Jyy, Jxy)."""
    d = s[..., 0, :, :] * s[..., 1, :, :] - s[..., 2, :, :] ** 2
    return s / torch.sqrt(d + eps)[..., None, :, :]


def inv_s1_x_s2(s1: torch.Tensor, s2: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Pixelwise inv(S1) @ S2 of symmetric 2x2 fields in closed form
    (reference utils.py:242-254), (..., 4, H, W) (M11, M22, M12, M21),
    without the 1/det(S1) factor, as the reference (det(S1) = 1 after
    normalization)."""
    if normalize:
        s1, s2 = st_normalize(s1), st_normalize(s2)
    a = s1[..., 1, :, :] * s2[..., 0, :, :] - s1[..., 2, :, :] * s2[..., 2, :, :]
    b = s1[..., 0, :, :] * s2[..., 1, :, :] - s1[..., 2, :, :] * s2[..., 2, :, :]
    c = s1[..., 1, :, :] * s2[..., 2, :, :] - s1[..., 2, :, :] * s2[..., 1, :, :]
    d = s1[..., 0, :, :] * s2[..., 2, :, :] - s1[..., 2, :, :] * s2[..., 0, :, :]
    return torch.stack([a, b, c, d], dim=-3)


def eigenvalues_2x2(m: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Pixelwise eigenvalues of (..., 4, H, W) 2x2 fields (reference
    utils.py:257-266), the discriminant clamped to >= eps."""
    apb = m[..., 0, :, :] + m[..., 1, :, :]
    disc = apb**2 - 4 * (m[..., 0, :, :] * m[..., 1, :, :] - m[..., 2, :, :] * m[..., 3, :, :])
    r = torch.sqrt(torch.clamp(disc, min=eps))
    return torch.stack([0.5 * (apb - r), 0.5 * (apb + r)], dim=-3)


def riemannian_distance(lam: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Pixelwise sqrt(sum_i log^2 lambda_i + eps) with the eigenvalues
    clamped to >= 1 (the reference's numerical hack, utils.py:269-280);
    (..., 2, H, W) -> (..., H, W)."""
    logs = torch.log(torch.clamp(lam, min=1.0)) ** 2
    return torch.sqrt(logs.sum(dim=-3) + eps)


def st_distance(s1: torch.Tensor, s2: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """(..., 3, H, W) structure tensors -> pixelwise distance (..., H, W)."""
    return riemannian_distance(eigenvalues_2x2(inv_s1_x_s2(s1, s2, normalize)))
