"""Coarse reconstruction conv, space-to-depth(2) factored (port of
srgan_st_tpu/kernels/coarse_conv.py).

`coarse_conv_s2d(x, w2)` computes the 5x5 SAME conv of the coarse kernel
w2 (5, 5, C, N2) over x (B, H, W, C), followed by space_to_depth(2): a
(B, H/2, W/2, 4*N2) f32 tensor in `_coarse_kernel` channel order
(n2, ry, rx). On a CUDA tensor it launches the hand-written kernel
`csrc/coarse_conv.cu` (one kernel for both Pallas kernels, `_kernel` and
`_kernel_tiled`), or raises if the kernel does not take the input; on a
CPU tensor it runs the plain version, `coarse_conv_s2d_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from srgan_st_tpu_torch.kernels import _build

# launches of the CUDA kernel since import (or the last reset)
launches = 0

N2 = 12  # coarse output channels the kernel is built for: 4 * N2 = 48
_FN = {torch.bfloat16: "coarse_conv_s2d_bf16", torch.float32: "coarse_conv_s2d_f32"}
_K_CHUNK = {torch.bfloat16: 32, torch.float32: 16}  # csrc/coarse_conv.cu Chunk<T>::KC
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SIGNATURES = {fn: _ARGS for fn in _FN.values()}


def _w3_blocks(w2: torch.Tensor) -> torch.Tensor:
    """(kc, kc, C, N2) coarse kernel -> (3, 2, 3, 2C, 4*N2) blocks with
    K-layout (rx, c) per (qy, ry, qx), via the f=2 coarse-kernel identity."""
    from srgan_st_tpu_torch.ops.subpixel_conv import _coarse_kernel

    w3 = _coarse_kernel(w2, 2)  # (3, 3, C*4, N2*4), K-layout (c, ry, rx)
    kc3, _, c4, n3 = w3.shape
    assert kc3 == 3, kc3
    c = c4 // 4
    w3 = w3.reshape(3, 3, c, 2, 2, n3)          # (qy, qx, c, ry, rx, n3)
    w3 = w3.permute(0, 3, 1, 4, 2, 5)           # (qy, ry, qx, rx, c, n3)
    return w3.reshape(3, 2, 3, 2 * c, n3)


def _kernel_weights(w2: torch.Tensor, device, dtype) -> torch.Tensor:
    """(5, 5, C, N2) coarse kernel -> the stage-2 weights both CUDA kernels
    read: (18, 4*N2, 2C) [tap][n][k], tap (qy, ry, qx), k in (rx, c) order."""
    wt = _w3_blocks(w2.to(device=device, dtype=dtype))
    return wt.reshape(18, wt.shape[-2], wt.shape[-1]).transpose(1, 2).contiguous()


def coarse_conv_s2d_reference(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The plain version: `F.conv2d` of the coarse kernel, then
    space_to_depth(2), in f32."""
    from srgan_st_tpu_torch.ops.subpixel_conv import conv_nhwc, space_to_depth

    return space_to_depth(conv_nhwc(x.float(), w2.float()), 2)


def coarse_conv_s2d(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), w2 (5, 5, C, N2) -> (B, H/2, W/2, 4*N2) f32.
    A CPU tensor takes the plain version; a CUDA tensor the kernel."""
    if x.device.type == "cpu":
        return coarse_conv_s2d_reference(x, w2)
    return _launch(x, w2)


def fits(x_shape, w2_shape, dtype) -> bool:
    """Shape gate of the kernel: NHWC x with even H and W, bf16 or f32,
    C a multiple of 16 (bf16) or 8 (f32), and a (5, 5, C, 12) coarse
    kernel (that of a 9x9 conv with 3 outputs)."""
    if len(x_shape) != 4 or dtype not in _FN:
        return False
    _, h, w, c = x_shape
    return (h > 0 and w > 0 and h % 2 == 0 and w % 2 == 0
            and (2 * c) % _K_CHUNK[dtype] == 0 and tuple(w2_shape) == (5, 5, c, N2))


def _launch(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"coarse_conv_s2d: no kernel for device {x.device}")
    if not fits(x.shape, w2.shape, x.dtype):
        raise ValueError(
            f"coarse_conv_s2d: the kernel takes NHWC bf16/f32 x with even H, W "
            f"and C a multiple of {_K_CHUNK[torch.bfloat16] // 2} (bf16) or "
            f"{_K_CHUNK[torch.float32] // 2} (f32), and w2 (5, 5, C, {N2}); got x "
            f"{tuple(x.shape)} {x.dtype}, w2 {tuple(w2.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("coarse_conv_s2d: x must be contiguous NHWC, 16-byte aligned")
    b, h, w, c = x.shape
    wt = _kernel_weights(w2, x.device, x.dtype)
    out = torch.empty((b, h // 2, w // 2, 4 * N2), device=x.device,
                      dtype=torch.float32)
    lib = _build.load("coarse_conv", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FN[x.dtype])(
            x.data_ptr(), wt.data_ptr(), out.data_ptr(), b, h, w, c, stream)
    _build.check(err, "coarse_conv_s2d")
    launches += 1
    return out
