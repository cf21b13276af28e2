"""Real-ESRGAN's HR stage as one hand-written kernel (kernel H,
`csrc/rrdb_hr.cu`; it replaces no TPU kernel: the JAX package has no RRDB
generator).

The stage of models/rrdb.py's `g.upsample` and `g.tail` regions, from the
trunk's output x (B, H, W, nf) NHWC, every conv 3x3 SAME with bias, lrelu
LeakyReLU(slope):

    u1 = lrelu(conv_up1(nearest2x(x)))       (B, 2H, 2W, nf)
    u2 = lrelu(conv_up2(nearest2x(u1)))      (B, 4H, 4W, nf)
    y  = clamp(conv_last(lrelu(conv_hr(u2))), 0, 1)   (B, 4H, 4W, 3) float32

in two calls: `rrdb_hr_upsample` (u1 and u2, the `g.upsample` region) and
`rrdb_hr_tail` (the `g.tail` region). Operands: ws the four HWIO kernels
(conv_up1, conv_up2, conv_hr, conv_last), bs their biases.

A nearest x2 followed by a 3x3 conv is computed as four phases' 2x2 convs
of the LR input (`phase_weights`): output (2y + py, 2x + px) reads LR rows
y + py - 1 + i and columns x + px - 1 + j (i, j in {0, 1}) with the 3x3
taps that fall on them summed, in f32, then rounded once to the compute
dtype. Each conv accumulates in f32 from the compute dtype's operands;
the bias (f32), then the LeakyReLU (or conv_last's clamp) run on the f32
accumulator, and the result is rounded once: to the compute dtype, or
not at all for the float32 frame. `rrdb_hr_reference` is that arithmetic
in torch (`upsample_reference`, `tail_reference`: the two calls' parts).

The wrappers run the plain version on a CPU tensor and launch the kernel
on a CUDA one (bf16, nf = 64, 3 outputs, any B, H, W; one call each,
counted in `launches`) or raise; the kernel has no backward. On CUDA the
upsample call returns u2 in the kernel's layout (`Planes`), which the
tail call reads.

`gate` is the RRDB generator's choice of this path, a pure function of
what its forward observes; `RRDBHRWeights` keeps the kernel's layout of
the stage's ten parameters, made again only when one of them changes.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from srgan_st_tpu_torch.kernels import _build
from srgan_st_tpu_torch.kernels.packed_trunk import _conv
from srgan_st_tpu_torch.kernels.rrdb_dense import RRDBDenseWeights
from srgan_st_tpu_torch.utils.profiling import span

# calls of the CUDA kernel since import (or the last reset): two a frame
launches = 0

CHANNELS = 64  # nf, the kernel's width (csrc/rrdb_hr.cu NF)
OUT = 3        # the frame's channels (csrc/rrdb_hr.cu COUT)
NOUT = 8       # conv_last's outputs padded to a wgmma width (csrc/rrdb_hr.cu NOUT)
PL = 8         # channels of a plane of the kernel's maps
# the rows (or columns) of a 3x3 kernel that phase p's tap i sums: row 2y +
# p of a nearest x2 reads LR rows y - 1 + p + i, i in {0, 1}
_PHASE_TAPS = (((0,), (1, 2)), ((0, 1), (2,)))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"rrdb_hr_upsample_bf16": [_P] * 7 + [_I] * 3 + [_F, _P],
               "rrdb_hr_tail_bf16": [_P] * 6 + [_I] * 3 + [_F, _P],
               "rrdb_hr_planes": [_I] * 3 + [ctypes.POINTER(ctypes.c_longlong)]}


def gate(train: bool, grad_enabled: bool, device_type: str, dtype: torch.dtype,
         channels: int, out_channels: int) -> bool:
    """Whether the RRDB generator's HR stage runs this kernel: eval, no
    gradient (the kernel has no backward), a CUDA bf16 activation, nf =
    CHANNELS and OUT output channels."""
    return (not train and not grad_enabled and device_type == "cuda"
            and dtype == torch.bfloat16 and channels == CHANNELS and out_channels == OUT)


def phase_weights(w: torch.Tensor) -> torch.Tensor:
    """The four phases' 2x2 kernels of a nearest x2 followed by the 3x3
    HWIO kernel w: (2, 2, 2, 2, cin, cout) [py][px][i][j], the taps that
    fall on one LR pixel summed in f32 (float64 stays float64; rows, then
    columns: the same sums on every device)."""
    w = w.to(torch.promote_types(w.dtype, torch.float32))
    out = []
    for rows in _PHASE_TAPS:
        r = torch.stack([w[list(ks)].sum(0) for ks in rows])  # (i, kx, cin, cout)
        out.append(torch.stack([torch.stack([r[:, list(ks)].sum(1) for ks in cols], 1)
                                for cols in _PHASE_TAPS]))
    return torch.stack(out)


def upsample_conv(x, w, b, slope: float):
    """lrelu(conv(nearest2x(x)) + b) as four phases' 2x2 convs of x: x (B,
    H, W, cin) NHWC in the compute dtype, w the 3x3 HWIO kernel; (B, 2H,
    2W, cout) in x's dtype."""
    cdt = x.dtype
    bsz, h, wd, _ = x.shape
    pw = phase_weights(w).to(cdt)
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    a = torch.empty((bsz, 2 * h, 2 * wd, w.shape[-1]), dtype=torch.float32, device=x.device)
    for py in range(2):
        for px in range(2):
            k = pw[py, px].float().permute(3, 2, 0, 1)  # (cout, cin, i, j)
            a[:, py::2, px::2] = F.conv2d(xp[:, :, py:py + h + 1, px:px + wd + 1],
                                          k).permute(0, 2, 3, 1)
    a = a + b.float()
    return torch.where(a >= 0, a, slope * a).to(cdt)


def upsample_reference(x, ws, bs, slope: float):
    """The `g.upsample` part of the plain version: u2 (B, 4H, 4W, nf) NHWC
    in x's dtype."""
    return upsample_conv(upsample_conv(x, ws[0], bs[0], slope), ws[1], bs[1], slope)


def tail_reference(u, ws, bs, slope: float):
    """The `g.tail` part of the plain version: u (B, H, W, nf) NHWC in the
    compute dtype -> the clamped frame (B, H, W, 3) float32."""
    cdt = u.dtype
    a = _conv(u, ws[2].to(cdt)) + bs[2].float()
    h = torch.where(a >= 0, a, slope * a).to(cdt)
    return torch.clamp(_conv(h, ws[3].to(cdt)) + bs[3].float(), 0.0, 1.0)


def rrdb_hr_reference(x, ws, bs, slope: float):
    """The plain version: the kernel's arithmetic in torch ops. x (B, H, W,
    nf) NHWC in the compute dtype -> (B, 4H, 4W, 3) float32 NHWC."""
    return tail_reference(upsample_reference(x, ws, bs, slope), ws, bs, slope)


def _image(w):
    """[..][k group][out][8 in] bf16 of a (.., cin, cout) kernel."""
    *lead, cin, cout = w.shape
    return w.reshape(*lead, cin // PL, PL, cout).transpose(-1, -2).reshape(-1).to(torch.bfloat16)


def layout(ws, bs):
    """The kernel's operands on ws' device: the up convs' phase images
    [py][px][i][j][k group][out][8 in], conv_hr's [tap][k group][out][8
    in], conv_last's the same with its outputs padded to NOUT (bf16, each
    rounded once), and the f32 biases [up1][up2][hr][last, padded]."""
    up = [_image(phase_weights(w)) for w in ws[:2]]
    hr = _image(ws[2])
    last = _image(F.pad(ws[3], (0, NOUT - ws[3].shape[-1])))
    bias = torch.cat([*bs[:3], F.pad(bs[3], (0, NOUT - bs[3].shape[-1]))]).float().contiguous()
    return (*up, hr, last, bias)


class RRDBHRWeights(RRDBDenseWeights):
    """The HR stage's operands as HWIO kernels and biases and laid out for
    the kernel (`layout`), kept as `RRDBDenseWeights` keeps the dense
    blocks': `get` takes the four convs' (weight OIHW, bias), conv_up1,
    conv_up2, conv_hr, conv_last, and lays them out again only when one of
    the ten parameters changes."""

    layout = staticmethod(layout)


def padded_width(w: int) -> int:
    """The pixels of a stored row of a map of width w (csrc/rrdb_hr.cu
    `padded_width`): one unused, the zero border, w pixels from index 2,
    the zero border, one unused where w is odd."""
    return (w + 4) & ~1


class Planes(NamedTuple):
    """A bf16 map of CHANNELS channels in the kernel's layout: 8 planes of
    8 channels over the zero-bordered grid B x (H+2) x `padded_width`(W),
    then the pixels the kernel's last bands read past it; shape (B, H, W,
    C)."""

    buf: torch.Tensor
    shape: tuple

    def grid(self) -> torch.Tensor:
        """The planes as (C / 8, B, H + 2, padded_width(W), 8)."""
        b, h, w, c = self.shape
        wp = padded_width(w)
        return self.buf[:c * b * (h + 2) * wp].view(c // PL, b, h + 2, wp, PL)

    def nhwc(self) -> torch.Tensor:
        b, h, w, c = self.shape
        return self.grid()[:, :, 1:-1, 2:w + 2].permute(1, 2, 3, 0, 4).reshape(b, h, w, c)


def _planes(lib, b: int, h: int, w: int, dev) -> Planes:
    elems = ctypes.c_longlong()
    _build.check(lib.rrdb_hr_planes(b, h, w, ctypes.byref(elems)), "rrdb_hr")
    return Planes(torch.empty(elems.value, device=dev, dtype=torch.bfloat16), (b, h, w, CHANNELS))


def _laid(ws, bs, laid, dev):
    """The kernel's operands: `laid` where the caller has them
    (`RRDBHRWeights`), else laid out here; raises on other shapes."""
    shapes = [tuple(w.shape) for w in ws]
    want = [(3, 3, CHANNELS, CHANNELS)] * 3 + [(3, 3, CHANNELS, OUT)]
    if shapes != want or [tuple(b.shape) for b in bs] != [(CHANNELS,)] * 3 + [(OUT,)]:
        raise ValueError(f"rrdb_hr: the kernel takes the HWIO kernels {want} and their "
                         f"biases; got {shapes}")
    if laid is not None:
        return laid
    return layout([w.to(dev) for w in ws], [b.to(dev) for b in bs])


def rrdb_hr_upsample(x, ws, bs, slope: float, laid=None):
    """x (B, H, W, nf) NHWC -> u2 (B, 4H, 4W, nf): on the CPU the plain
    version (NHWC); on CUDA the kernel (bf16, nf = CHANNELS; `Planes`),
    `laid` the kernel's layout of the operands where the caller has it
    (`RRDBHRWeights`). Raises on anything else."""
    global launches
    if x.device.type == "cpu":
        return upsample_reference(x, ws, bs, slope)
    if x.device.type != "cuda":
        raise ValueError(f"rrdb_hr: no kernel for device {x.device}")
    if x.dim() != 4 or x.dtype != torch.bfloat16 or x.shape[-1] != CHANNELS or min(x.shape) == 0:
        raise ValueError(f"rrdb_hr: the kernel takes NHWC bf16 x of {CHANNELS} channels; "
                         f"got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("rrdb_hr: x must be contiguous NHWC, 16-byte aligned")
    w1, w2, _, _, bias = _laid(ws, bs, laid, x.device)
    b, h, w, _ = x.shape
    lib = _build.load("rrdb_hr", _SIGNATURES)
    lr, mid = _planes(lib, b, h, w, x.device), _planes(lib, b, 2 * h, 2 * w, x.device)
    up = _planes(lib, b, 4 * h, 4 * w, x.device)
    with torch.cuda.device(x.device), span("kernel.rrdb_hr"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rrdb_hr_upsample_bf16(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                                        bias.data_ptr(), lr.buf.data_ptr(), mid.buf.data_ptr(),
                                        up.buf.data_ptr(), b, h, w, slope, stream)
    _build.check(err, "rrdb_hr")
    launches += 1
    return up


def rrdb_hr_tail(u, ws, bs, slope: float, laid=None):
    """u2 -> the clamped frame (B, H, W, 3) float32 NHWC: on the CPU (u an
    NHWC tensor) the plain version; on CUDA (u the `Planes` of
    `rrdb_hr_upsample`) the kernel. Raises on anything else."""
    global launches
    if isinstance(u, torch.Tensor):
        if u.device.type == "cpu":
            return tail_reference(u, ws, bs, slope)
        raise ValueError(f"rrdb_hr: the kernel reads the Planes of rrdb_hr_upsample; got a "
                         f"tensor on {u.device}")
    if not isinstance(u, Planes) or u.buf.device.type != "cuda" or u.shape[-1] != CHANNELS:
        raise ValueError(f"rrdb_hr: no kernel for {type(u).__name__}")
    _, _, w_hr, w_last, bias = _laid(ws, bs, laid, u.buf.device)
    b, h, w, _ = u.shape
    lib = _build.load("rrdb_hr", _SIGNATURES)
    hr = _planes(lib, b, h, w, u.buf.device)
    if hr.buf.numel() != u.buf.numel():
        raise ValueError(f"rrdb_hr: planes of {u.buf.numel()} elements for a map {u.shape}")
    y = torch.empty((b, h, w, OUT), device=u.buf.device, dtype=torch.float32)
    with torch.cuda.device(u.buf.device), span("kernel.rrdb_hr"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rrdb_hr_tail_bf16(u.buf.data_ptr(), w_hr.data_ptr(), w_last.data_ptr(),
                                    bias.data_ptr(), hr.buf.data_ptr(), y.data_ptr(), b, h, w,
                                    slope, stream)
    _build.check(err, "rrdb_hr")
    launches += 1
    return y
