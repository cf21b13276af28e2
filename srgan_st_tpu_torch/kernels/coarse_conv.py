"""Coarse reconstruction conv, space-to-depth(2) factored (port of
srgan_st_tpu/kernels/coarse_conv.py).

`coarse_conv_s2d(x, w2)` computes the 5x5 SAME conv of the coarse kernel
w2 (5, 5, C, N2) over x (B, H, W, C), followed by space_to_depth(2): a
(B, H/2, W/2, 4*N2) f32 tensor in `_coarse_kernel` channel order
(n2, ry, rx). On a CUDA tensor it launches the hand-written kernel
`csrc/coarse_conv.cu` (one kernel for both Pallas kernels, `_kernel` and
`_kernel_tiled`: wgmma with a cp.async / bulk-copy ring in bf16, the SIMT
tile code in f32), or raises if the kernel does not take the input; on a
CPU tensor it runs the plain version, `coarse_conv_s2d_reference`.
"""

from __future__ import annotations

import ctypes

import torch

from srgan_st_tpu_torch.kernels import _build
from srgan_st_tpu_torch.utils.profiling import span

# launches of the CUDA kernel since import (or the last reset)
launches = 0

N2 = 12  # coarse output channels the kernel is built for: 4 * N2 = 48
_FN = {torch.bfloat16: "coarse_conv_s2d_bf16", torch.float32: "coarse_conv_s2d_f32"}
# the K chunk each kernel walks K = 2C in (csrc/coarse_conv.cu wg::KC, KC)
_K_CHUNK = {torch.bfloat16: 16, torch.float32: 16}
TILE = (8, 64)   # quarter rows x columns of a bf16 block (wg::TH, wg::TW)
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


def _stream_weights(wt: torch.Tensor) -> torch.Tensor:
    """(18, 48, K) [tap][n][k] -> the bf16 kernel's weight stream
    (K/16, 18, 2, 48, 8): per K chunk of 16, the ring stage's image
    [tap][k group][n][8], copied by one bulk copy per chunk."""
    taps, n3, k = wt.shape
    kc = _K_CHUNK[torch.bfloat16]
    return (wt.reshape(taps, n3, k // kc, kc // 8, 8)
            .permute(2, 0, 3, 1, 4).contiguous())


def _layout_shape(c: int, dtype) -> tuple:
    """Shape of `_layout` for C input channels."""
    if dtype == torch.bfloat16:
        return (2 * c // _K_CHUNK[dtype], 18, _K_CHUNK[dtype] // 8, 4 * N2, 8)
    return (18, 4 * N2, 2 * c)


def _layout(w2: torch.Tensor, device, dtype) -> torch.Tensor:
    """The weights the kernel of `dtype` reads: the weight stream in bf16,
    `_kernel_weights` in f32."""
    wt = _kernel_weights(w2, device, dtype)
    return _stream_weights(wt) if dtype == torch.bfloat16 else wt


class KernelWeights:
    """`_layout` of one conv's weight (an OIHW parameter of a 9x9 conv to
    3 channels) in a compute dtype, made again only when the weight's
    storage or version changes, or a CUDA graph was replayed (the
    `kernels.generation` count: a replay updates parameters without
    bumping their version): once per parameter version, not once per call.
    Under a graph capture the layout is made inside the graph and not
    kept."""

    def __init__(self) -> None:
        self._key = None
        self._wt = None

    def get(self, weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        from srgan_st_tpu_torch import kernels
        from srgan_st_tpu_torch.ops.subpixel_conv import _coarse_kernel

        capturing = weight.is_cuda and torch.cuda.is_current_stream_capturing()
        key = (weight.data_ptr(), weight._version, weight.device, dtype, kernels.generation)
        if capturing or key != self._key:
            with torch.no_grad():
                w2 = _coarse_kernel(weight.detach().permute(2, 3, 1, 0).to(dtype), 2)
                wt = _layout(w2, weight.device, dtype)
            if capturing:
                self._key = self._wt = None
                return wt
            self._key, self._wt = key, wt
        return self._wt


def coarse_conv_s2d_reference(x: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The plain version: `F.conv2d` of the coarse kernel, then
    space_to_depth(2), in f32."""
    from srgan_st_tpu_torch.ops.subpixel_conv import conv_nhwc, space_to_depth

    return space_to_depth(conv_nhwc(x.float(), w2.float()), 2)


def coarse_conv_s2d(x: torch.Tensor, w2: torch.Tensor,
                    wt: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, H, W, C), w2 (5, 5, C, N2) -> (B, H/2, W/2, 4*N2) f32.
    A CPU tensor takes the plain version; a CUDA tensor the kernel, with
    `wt` the kernel's layout of w2 where the caller has it
    (`KernelWeights`)."""
    if x.device.type == "cpu":
        return coarse_conv_s2d_reference(x, w2)
    return _launch(x, w2, wt)


def fits(x_shape, w2_shape, dtype) -> bool:
    """Shape gate of the kernel: NHWC x with even H and W, bf16 or f32,
    C a multiple of 8, and a (5, 5, C, 12) coarse kernel (that of a 9x9
    conv with 3 outputs)."""
    if len(x_shape) != 4 or dtype not in _FN:
        return False
    _, h, w, c = x_shape
    return (h > 0 and w > 0 and h % 2 == 0 and w % 2 == 0
            and (2 * c) % _K_CHUNK[dtype] == 0 and tuple(w2_shape) == (5, 5, c, N2))


def _launch(x: torch.Tensor, w2: torch.Tensor, wt: torch.Tensor | None = None
            ) -> torch.Tensor:
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"coarse_conv_s2d: no kernel for device {x.device}")
    if not fits(x.shape, w2.shape, x.dtype):
        raise ValueError(
            f"coarse_conv_s2d: the kernel takes NHWC bf16/f32 x with even H, W "
            f"and C a multiple of {_K_CHUNK.get(x.dtype, 16) // 2}, "
            f"and w2 (5, 5, C, {N2}); got x {tuple(x.shape)} {x.dtype}, "
            f"w2 {tuple(w2.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("coarse_conv_s2d: x must be contiguous NHWC, 16-byte aligned")
    b, h, w, c = x.shape
    if wt is None:
        wt = _layout(w2, x.device, x.dtype)
    elif (tuple(wt.shape) != _layout_shape(c, x.dtype) or wt.dtype != x.dtype
          or wt.device != x.device or not wt.is_contiguous()):
        raise ValueError(
            f"coarse_conv_s2d: wt must be the kernel's layout of w2, "
            f"{_layout_shape(c, x.dtype)} {x.dtype} on {x.device}; got "
            f"{tuple(wt.shape)} {wt.dtype} on {wt.device}")
    out = torch.empty((b, h // 2, w // 2, 4 * N2), device=x.device,
                      dtype=torch.float32)
    lib = _build.load("coarse_conv", _SIGNATURES)
    with torch.cuda.device(x.device), span("kernel.coarse_conv_s2d"):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FN[x.dtype])(
            x.data_ptr(), wt.data_ptr(), out.data_ptr(), b, h, w, c, stream)
    _build.check(err, "coarse_conv_s2d")
    launches += 1
    return out
