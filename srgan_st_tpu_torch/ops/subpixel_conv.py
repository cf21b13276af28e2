"""Space-to-depth-factored convolution for tiny output channels.

Port of srgan_st_tpu/ops/subpixel_conv.py. A kxk conv at resolution H equals

    depth_to_space_f( conv_kc( space_to_depth_f(x), W2 ) )

where kc = 2*ceil(r/f)+1 and W2[(qy,qx), (c,ry,rx), (n,py,px)] repacks the
original taps by phase: dy = f*qy + ry - py + r (zero where out of range).
Exact: the same dot products, reassociated.

Every public function takes NHWC activations and HWIO kernels, as the JAX
package's do. The plain formulations go through `F.conv2d`; the generator's
fused reconstruction conv goes through the hand-written coarse conv kernel
(kernels/coarse_conv.py) wherever its shape gate holds.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from srgan_st_tpu_torch.core.device import device_constant


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
              ) -> torch.Tensor:
    """SAME conv (odd kernel) of NHWC `x` with an HWIO kernel, as NHWC.
    The NCHW view of contiguous NHWC is channels_last, so no copy is made."""
    k = w.shape[0]
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                   padding=k // 2)
    return out.permute(0, 2, 3, 1)


def space_to_depth(x: torch.Tensor, f: int) -> torch.Tensor:
    """NHWC s2d with channel layout c' = c*f^2 + ry*f + rx (the inverse of
    models.common.pixel_shuffle's torch-compatible layout)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // f, f, w // f, f, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # b, h', w', c, ry, rx
    return x.reshape(b, h // f, w // f, c * f * f)


def depth_to_space(x: torch.Tensor, f: int) -> torch.Tensor:
    b, h, w, cf = x.shape
    c = cf // (f * f)
    x = x.reshape(b, h, w, c, f, f)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * f, w * f, c)


@functools.lru_cache(maxsize=16)
def _repack_indices(k: int, f: int):
    """Gather indices + validity mask to build the coarse kernel W2 from w.

    Returns (dy_idx, mask, kc) with index/mask shapes (kc, f, f) over
    (q, r_phase, p_phase)."""
    r = k // 2
    q_half = math.ceil(r / f)
    kc = 2 * q_half + 1
    dy = np.zeros((kc, f, f), np.int64)
    ok = np.zeros((kc, f, f), bool)
    for qi, q in enumerate(range(-q_half, q_half + 1)):
        for rp in range(f):  # source phase
            for pp in range(f):  # output phase
                d = f * q + rp - pp + r
                if 0 <= d < k:
                    dy[qi, rp, pp] = d
                    ok[qi, rp, pp] = True
    return dy, ok, kc


def _coarse_kernel(w: torch.Tensor, f: int) -> torch.Tensor:
    """w: (k, k, C, N) -> W2: (kc, kc, C*f*f, N*f*f)."""
    k, _, c, n = w.shape
    dy, ok, kc = _repack_indices(k, f)
    dyt = device_constant(("coarse_dy", k, f), lambda: dy, w.device)
    okt = device_constant(("coarse_ok", k, f), lambda: ok, w.device, w.dtype)
    # W2[qy, qx, c, ry, rx, n, py, px] = w[dy(qy,ry,py), dx(qx,rx,px), c, n] * valid
    wg = w[dyt[:, None, :, None, :, None], dyt[None, :, None, :, None, :]]
    # shape: (kcy, kcx, ry, rx, py, px, C, N)
    mask = okt[:, None, :, None, :, None] * okt[None, :, None, :, None, :]
    wg = wg * mask[..., None, None]
    # -> (kcy, kcx, C, ry, rx, N, py, px) -> (kc, kc, C*f*f, N*f*f)
    wg = wg.permute(0, 1, 6, 2, 3, 7, 4, 5)
    return wg.reshape(kc, kc, c * f * f, n * f * f)


_KERNEL_INNER = (None, "pallas", "pallas-tiled")


def conv2d_subpixel_pre_shuffled(
    y: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
    factor: int = 2, inner_factor: int | str | None = 1, kernel_weights=None,
) -> torch.Tensor:
    """conv2d_subpixel(pixel_shuffle(y, f), w, b, factor=f) WITHOUT
    materializing the shuffle: s2d(pixel_shuffle(y)) == y, so the coarse
    conv runs directly on the pre-shuffle activation.

    `inner_factor` None / "pallas" / "pallas-tiled" run the hand-written
    coarse conv kernel (kernels/coarse_conv.py) where its shape gate
    holds: factor 2, even H and W, a 9x9 conv to 3 channels
    (coarse_conv.fits). Other shapes take the plain path, as in the JAX
    package. 1 forces the plain coarse conv, 2 the plain inner
    space-to-depth factoring of it. The kernel path is differentiable: its
    backward is autograd of the plain composition (`_PreShuffledF2`).
    `kernel_weights`, where given, returns the kernel's layout of w
    (coarse_conv.KernelWeights.get)."""
    from srgan_st_tpu_torch.kernels import coarse_conv

    w2 = _coarse_kernel(w, factor)
    if inner_factor in _KERNEL_INNER:
        if factor == 2 and coarse_conv.fits(y.shape, w2.shape, y.dtype):
            if b is None:
                b = torch.zeros(w.shape[-1], dtype=y.dtype, device=y.device)
            return _PreShuffledF2.apply(y, w, b, kernel_weights)
        inner_factor = 1
    if inner_factor > 1:
        out = conv2d_subpixel(y, w2, None, factor=inner_factor)
    else:
        out = conv_nhwc(y, w2)
    out = depth_to_space(out, factor)
    return out if b is None else out + b


def _pre_shuffled_f2_reference(y, w, b):
    w2 = _coarse_kernel(w, 2)
    return depth_to_space(conv_nhwc(y, w2), 2) + b


def _pre_shuffled_f2_kernel(y, w2, b, wt=None):
    """conv2d_subpixel_pre_shuffled(f=2) through the coarse conv kernel,
    given the coarse kernel w2 (and, optionally, the kernel's layout of
    it): quarter-resolution (n2, ry, rx) output, rounded to the compute
    dtype, then both depth-to-spaces and the bias."""
    from srgan_st_tpu_torch.kernels.coarse_conv import coarse_conv_s2d

    z = coarse_conv_s2d(y, w2) if wt is None else coarse_conv_s2d(y, w2, wt)
    z = z.to(y.dtype)  # (B, H/2, W/2, 4*N2)
    out = depth_to_space(z, 2)   # inner factor undone -> (B, H, W, N2)
    out = depth_to_space(out, 2)  # outer factor -> (B, 2H, 2W, n)
    return out if b is None else out + b


class _PreShuffledF2(torch.autograd.Function):
    """Kernel forward, plain backward: the gradient of (y, w, b) is
    autograd of `_pre_shuffled_f2_reference` on the saved inputs, as the
    JAX package's `_pre_shuffled_f2_pallas` custom_vjp does
    (srgan_st_tpu/ops/subpixel_conv.py:183-206)."""

    @staticmethod
    def forward(ctx, y, w, b, kernel_weights):
        ctx.save_for_backward(y, w, b)
        wt = kernel_weights() if kernel_weights is not None and y.is_cuda else None
        return _pre_shuffled_f2_kernel(y, _coarse_kernel(w, 2), b, wt)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = _pre_shuffled_f2_reference(*inputs)
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None)


def conv2d_subpixel(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor | None = None, factor: int = 4
                    ) -> torch.Tensor:
    """SAME-padded NHWC conv via space-to-depth factoring. Requires H, W
    divisible by `factor`; falls back to a direct conv otherwise."""
    _, h, wd, _ = x.shape
    f = factor
    if f <= 1 or h % f or wd % f:
        return conv_nhwc(x, w, b)
    xs = space_to_depth(x, f)
    w2 = _coarse_kernel(w, f)
    out = depth_to_space(conv_nhwc(xs, w2), f)
    return out if b is None else out + b
