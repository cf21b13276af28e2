"""Fused serving tail (port of srgan_st_tpu/kernels/serving_tail.py).

`serving_tail` computes pixel_shuffle(2) . PReLU . conv3x3(w_up, b_up)
followed by the 9x9 fine reconstruction conv (w3, b3), returning the fine
HR (B, 2H, 2W, n) tensor before the clamp. On a CUDA tensor the up-conv,
PReLU and the doubly coarse conv3 run in the hand-written kernel
`csrc/serving_tail.cu`, whose 256-channel activation never reaches device
memory; the wrapper then undoes the inner factoring and the elided shuffle
in one permutation and adds b3. On a CPU tensor it runs the plain version,
`serving_tail_reference`.

The TPU lane packing of the JAX kernel's weights (`pack_conv_blocks`) has
no counterpart: the wrapper lays the weights out as the CUDA kernel reads
them (`_layouts`: one weight stream in bf16, per-stage tensors in f32), and
`TailWeights` keeps them per parameter version, so a served frame lays out
nothing.
"""

from __future__ import annotations

import ctypes

import torch

from srgan_st_tpu_torch.kernels import _build

# launches of the CUDA kernel since import (or the last reset)
launches = 0

C_IN, N_UP, N_OUT = 64, 256, 3  # the shapes csrc/serving_tail.cu is built for
_FN = {torch.bfloat16: "serving_tail_bf16", torch.float32: "serving_tail_f32"}
_CCW = 32  # up-conv channels per chunk of the bf16 kernel (csrc wg::CCW)
TILE = (4, 30)  # quarter rows x columns of a bf16 block (wg::TH, wg::TW)
_SIGNATURES = {
    "serving_tail_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "serving_tail_f32": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
}


def fits_budget(h: int, w: int, c_in: int, n_up: int, n_out: int) -> bool:
    """Dispatch gate of the fused tail: even dims and the channel counts
    the kernel is built for (64 in, 256 pre-shuffle, 3 out)."""
    return (h % 2 == 0 and w % 2 == 0 and h >= 2 and w >= 2
            and (c_in, n_up, n_out) == (C_IN, N_UP, N_OUT))


def serving_tail_reference(y, w_up, b_up, alpha, w3, b3) -> torch.Tensor:
    """The plain version: the composed eval tail in the compute dtype —
    up-conv + bias, PReLU, then the plain fused reconstruction conv."""
    from srgan_st_tpu_torch.ops.subpixel_conv import (
        conv2d_subpixel_pre_shuffled, conv_nhwc,
    )

    cdt = y.dtype
    t = conv_nhwc(y, w_up.to(cdt), b_up.to(cdt))
    a = torch.as_tensor(alpha, device=y.device).to(cdt)
    t = torch.where(t >= 0, t, a * t)
    return conv2d_subpixel_pre_shuffled(t, w3.to(cdt), b3.to(cdt), factor=2,
                                        inner_factor=1)


def _stream_weights(w1: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """w1 (9, 64, 256) [tap][c_in][n] and wt (18, 48, 512) -> the bf16
    kernel's weight stream: per chunk of 32 up-conv channels, 8 units of
    9,216 values in the ring slot's image: w1 for input channels 0-31 and
    32-63 ([tap][k group][n][8]), then w2 for taps 3u..3u+2 ([tap][k
    group][48][8], k = (rx, c) over the chunk's 2 x 32 channels)."""
    ch = N_UP // _CCW
    w1 = w1.reshape(9, 2, 4, 8, ch, _CCW).permute(4, 1, 0, 2, 5, 3)  # c, h, tap, g, n, e
    w2 = wt.reshape(6, 3, 48, 2, ch, _CCW).permute(4, 0, 1, 3, 5, 2)  # c, u, tap, rx, cc, n
    w2 = w2.reshape(ch, 6, 3, 8, 8, 48).permute(0, 1, 2, 3, 5, 4)    # c, u, tap, g, n, e
    return torch.cat([w1.reshape(ch, -1), w2.reshape(ch, -1)], 1).contiguous()


def _layouts(w_up, b_up, alpha, w3, dev, cdt) -> dict:
    """The weights the kernel of `cdt` reads: "ba", the 256 up-conv biases
    and the slope as 257 f32; bf16 "stream" (`_stream_weights`); f32 "w1t"
    (9, 256, 64) [tap][n][c_in] and "wt" (18, 48, 512), the coarse conv
    kernel's layout."""
    from srgan_st_tpu_torch.kernels.coarse_conv import _kernel_weights
    from srgan_st_tpu_torch.ops.subpixel_conv import _coarse_kernel

    with torch.no_grad():
        a = torch.as_tensor(alpha, dtype=torch.float32, device=dev).reshape(-1)[:1]
        out = {"ba": torch.cat([b_up.to(device=dev, dtype=torch.float32).reshape(-1), a])}
        w1 = w_up.to(device=dev, dtype=cdt).reshape(9, C_IN, N_UP)
        wt = _kernel_weights(_coarse_kernel(w3.to(device=dev, dtype=cdt), 2), dev, cdt)
        if cdt == torch.bfloat16:
            out["stream"] = _stream_weights(w1, wt)
        else:
            out["w1t"], out["wt"] = w1.transpose(1, 2).contiguous(), wt
    return out


class TailWeights:
    """`_layouts` of one generator's tail parameters in a compute dtype,
    made again only when a parameter's storage or version changes, or a
    CUDA graph was replayed (`kernels.generation`); under a graph capture
    made inside the graph and not kept (as coarse_conv.KernelWeights)."""

    def __init__(self) -> None:
        self._key = None
        self._layouts = None

    def get(self, w_up, b_up, alpha, w3, dev, cdt) -> dict:
        from srgan_st_tpu_torch import kernels

        capturing = torch.device(dev).type == "cuda" and torch.cuda.is_current_stream_capturing()
        key = tuple((t.data_ptr(), t._version) if torch.is_tensor(t) else float(t)
                    for t in (w_up, b_up, alpha, w3)) + (str(dev), cdt, kernels.generation)
        if capturing:
            self._key = self._layouts = None
            return _layouts(w_up, b_up, alpha, w3, dev, cdt)
        if key != self._key:
            self._layouts = _layouts(w_up, b_up, alpha, w3, dev, cdt)
            self._key = key
        return self._layouts


def serving_tail(y: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
                 alpha, w3: torch.Tensor, b3: torch.Tensor,
                 weights: TailWeights | None = None) -> torch.Tensor:
    """y (B, H, W, 64) input of the LAST upsample block; w_up (3, 3, 64,
    256), b_up (256,), alpha the PReLU slope (scalar); w3 (9, 9, 64, 3),
    b3 (3,). Returns (B, 2H, 2W, 3) in y's dtype. `weights`, where given,
    keeps the kernel's layouts across calls."""
    if y.device.type == "cpu":
        return serving_tail_reference(y, w_up, b_up, alpha, w3, b3)
    b, h, w, _ = y.shape
    z = _launch(y, w_up, b_up, alpha, w3, weights)
    # lanes are (n, py, px, ry, rx): HR row = 4*i + 2*ry + py,
    # col = 4*j + 2*rx + px — one composite permutation
    n = w3.shape[-1]
    zc = z.reshape(b, h // 2, w // 2, n, 2, 2, 2, 2)
    zc = zc.permute(0, 1, 6, 4, 2, 7, 5, 3)  # b, hc, ry, py, wc, rx, px, n
    return zc.reshape(b, 2 * h, 2 * w, n) + b3.to(y.dtype)


def _launch(y, w_up, b_up, alpha, w3, weights: TailWeights | None = None) -> torch.Tensor:
    global launches
    if y.device.type != "cuda":
        raise ValueError(f"serving_tail: no kernel for device {y.device}")
    if y.dtype not in _FN:
        raise TypeError(f"serving_tail: kernel takes bf16 or f32, got {y.dtype}")
    if y.dim() != 4:
        raise ValueError(f"serving_tail: y must be NHWC, got shape {tuple(y.shape)}")
    b, h, w, c = y.shape
    if not (fits_budget(h, w, c, w_up.shape[-1], w3.shape[-1])
            and tuple(w_up.shape) == (3, 3, C_IN, N_UP)
            and tuple(w3.shape) == (9, 9, C_IN, N_OUT)):
        raise ValueError(
            f"serving_tail: the kernel takes y with even H, W and {C_IN} channels, "
            f"w_up (3, 3, {C_IN}, {N_UP}) and w3 (9, 9, {C_IN}, {N_OUT}); got y "
            f"{tuple(y.shape)}, w_up {tuple(w_up.shape)}, w3 {tuple(w3.shape)}")
    if not y.is_contiguous() or y.data_ptr() % 16:
        raise ValueError("serving_tail: y must be contiguous NHWC, 16-byte aligned")
    dev, cdt = y.device, y.dtype
    lay = (weights or TailWeights()).get(w_up, b_up, alpha, w3, dev, cdt)
    z = torch.empty((b, h // 2, w // 2, 16 * N_OUT), device=dev, dtype=cdt)
    lib = _build.load("serving_tail", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if cdt == torch.bfloat16:
            err = lib.serving_tail_bf16(y.data_ptr(), lay["stream"].data_ptr(),
                                        lay["ba"].data_ptr(), z.data_ptr(), b, h, w, stream)
        else:
            err = lib.serving_tail_f32(y.data_ptr(), lay["w1t"].data_ptr(),
                                       lay["ba"].data_ptr(), lay["wt"].data_ptr(),
                                       z.data_ptr(), b, h, w, stream)
    _build.check(err, "serving_tail")
    launches += 1
    return z
