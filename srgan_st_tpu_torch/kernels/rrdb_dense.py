"""Real-ESRGAN's dense trunk as one hand-written kernel (kernel R,
`csrc/rrdb_dense.cu`; it replaces no TPU kernel: the JAX package has no
RRDB generator).

`rrdb_dense(x, ws, bs)` runs the RRDBs of models/rrdb.py's `g.trunk`
region, from the stem output x (B, H, W, nf) NHWC: n RRDBs of three
residual dense blocks, each block five 3x3 convs with bias, c1..c4 writing
gc channels from nf, nf + gc, .., nf + 3 gc, c5 writing nf from nf + 4 gc:

    x_k = lrelu(c_k([x, x_1 .. x_{k-1}]))        k = 1..4
    block(x) = x + s c_5([x, x_1 .. x_4])
    RRDB(x)  = x + s block3(block2(block1(x)))

Operands, in the blocks' order (RRDB i, dense block j, conv k): ws the 15 n
HWIO kernels (3, 3, cin, cout), bs their (cout,) biases.

Each conv accumulates in f32 from the compute dtype's operands; the bias
(f32), then the LeakyReLU (c1..c4, f32 slope) or the residuals (c5: x + s
(acc + b), and in a third block x_rrdb + s (x + s (acc + b)), the
residuals read in the compute dtype) run on the f32 accumulator, and the
result is rounded once to the compute dtype: the blocks' function at the
configuration's precision, with one rounding a conv where the torch
blocks round the conv, the bias add and each residual. `rrdb_dense_reference`
is that arithmetic in torch, and what the CPU runs. The wrapper launches
the kernel (a CUDA tensor, bf16, nf = 64, gc = 32, any B, H, W: 1 + 15 n
launches in one call) or raises. The kernel has no backward.

`gate` is the RRDB generator's choice of this path, a pure function of
what its forward observes; `RRDBDenseWeights` keeps the kernel's layout of
the blocks' parameters, made again only when one of them changes.
"""

from __future__ import annotations

import ctypes

import torch

from srgan_st_tpu_torch.kernels import _build
from srgan_st_tpu_torch.kernels.packed_trunk import _conv
from srgan_st_tpu_torch.utils.profiling import span

# calls of the CUDA kernel since import (or the last reset); each call
# makes 1 + 15 n launches
launches = 0

CHANNELS = 64  # nf, the kernel's width (csrc/rrdb_dense.cu NF)
GROWTH = 32    # gc (csrc/rrdb_dense.cu GC)
CHUNK = 32     # the channels of a K chunk of the weight images
CONVS = 5      # convs of a dense block
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"rrdb_dense_bf16": [_P] * 5 + [_I] * 4 + [_F, _F, _P],
               "rrdb_dense_workspace": [_I] * 3 + [ctypes.POINTER(ctypes.c_longlong)]}


def gate(train: bool, grad_enabled: bool, device_type: str, dtype: torch.dtype,
         channels: int, growth: int) -> bool:
    """Whether the RRDB generator's trunk runs this kernel: eval, no
    gradient (the kernel has no backward), a CUDA bf16 activation, and the
    published widths nf = CHANNELS, gc = GROWTH."""
    return (not train and not grad_enabled and device_type == "cuda"
            and dtype == torch.bfloat16 and channels == CHANNELS and growth == GROWTH)


def conv_channels(nf: int, gc: int) -> list[tuple[int, int]]:
    """(cin, cout) of a dense block's five convs."""
    return [(nf + k * gc, gc) for k in range(4)] + [(nf + 4 * gc, nf)]


def dense_features(h, ws, bs, slope: float):
    """One dense block's buffer, as the kernel keeps it: (B, H, W, nf + 4
    gc) NHWC in h's dtype, channels 0..nf-1 h, channels nf + gc (k-1) ..
    nf + gc k - 1 x_k = lrelu(c_k(prefix) + b_k), each conv reading the
    channel prefix before its own slice. ws, bs: the block's five kernels
    and biases (c5's unused)."""
    cdt = h.dtype
    nf = h.shape[-1]
    buf = torch.empty((*h.shape[:-1], nf + 4 * ws[0].shape[-1]), dtype=cdt, device=h.device)
    buf[..., :nf] = h
    for k in range(CONVS - 1):
        cin, cout = ws[k].shape[2:]
        a = _conv(buf[..., :cin], ws[k].to(cdt)) + bs[k].float()
        buf[..., cin:cin + cout] = torch.where(a >= 0, a, slope * a).to(cdt)
    return buf


def rrdb_dense_reference(x, ws, bs, slope: float, scale: float):
    """The plain version: the kernel's arithmetic in torch ops. x (B, H, W,
    nf) NHWC in the compute dtype; NHWC out."""
    cdt = x.dtype
    h = x
    for i in range(len(ws) // (3 * CONVS)):
        x_rrdb = h
        for j in range(3):
            k0 = (3 * i + j) * CONVS
            buf = dense_features(h, ws[k0:k0 + CONVS], bs[k0:k0 + CONVS], slope)
            v = h.float() + scale * (_conv(buf, ws[k0 + 4].to(cdt)) + bs[k0 + 4].float())
            if j == 2:
                v = x_rrdb.float() + scale * v
            h = v.to(cdt)
    return h


def layout(ws, bs):
    """The kernel's operands on ws' device: the weight images, bf16, each
    conv [chunk][tap][k group][out][8 in] (ci = 32 chunk + 8 k group + j),
    every conv of every block in order; the biases, f32, in order."""
    parts = []
    for w in ws:
        kh, kw, cin, cout = w.shape
        parts.append(w.reshape(kh, kw, cin // CHUNK, CHUNK // 8, 8, cout)
                     .permute(2, 0, 1, 3, 5, 4).reshape(-1))
    wimg = torch.cat(parts).to(torch.bfloat16)
    return wimg, torch.cat([b.reshape(-1) for b in bs]).float().contiguous()


class RRDBDenseWeights:
    """The dense blocks' operands as HWIO kernels and biases (`operands`)
    and laid out for the kernel (`layout`), made again only when a
    parameter changes storage or version, or a CUDA graph was replayed
    (`kernels.generation`): once per parameter version, not once per
    frame."""

    layout = staticmethod(layout)

    def __init__(self) -> None:
        self._key = None
        self._ops = None

    def get(self, convs) -> tuple:
        """convs: the 15 n dense convs' (weight OIHW, bias) in order.
        Returns (ws, bs, laid out): laid out is `layout`'s, or None off
        CUDA."""
        from srgan_st_tpu_torch import kernels

        tensors = [t for pair in convs for t in pair]
        key = (kernels.generation, *[t.data_ptr() for t in tensors],
               *[t._version for t in tensors])
        if key != self._key:
            with torch.no_grad():
                ws, bs = self.operands(convs)
                laid = self.layout(ws, bs) if ws[0].is_cuda else None
            self._ops = (ws, bs, laid)
            self._key = key
        return self._ops

    def operands(self, convs) -> tuple[list, list]:
        """The HWIO kernels and the f32 biases of convs' (weight, bias)."""
        return ([w.detach().permute(2, 3, 1, 0) for w, _ in convs],
                [b.detach().float() for _, b in convs])


def rrdb_dense(x, ws, bs, slope: float, scale: float, laid=None):
    """x (B, H, W, nf) NHWC bf16 on CUDA -> (B, H, W, nf), the last RRDB's
    output, by the kernel; `laid` is the kernel's layout of the operands
    where the caller has it (`RRDBDenseWeights`). Raises on anything else."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"rrdb_dense: no kernel for device {x.device}")
    blocks = len(ws) // CONVS
    shapes = [tuple(w.shape) for w in ws]
    want = [(3, 3, cin, cout) for cin, cout in conv_channels(CHANNELS, GROWTH)] * blocks
    if (x.dim() != 4 or x.dtype != torch.bfloat16 or x.shape[-1] != CHANNELS
            or min(x.shape) == 0 or blocks == 0 or blocks % 3 or len(ws) != CONVS * blocks
            or shapes != want or len(bs) != len(ws)):
        raise ValueError(
            f"rrdb_dense: the kernel takes NHWC bf16 x of {CHANNELS} channels and 15 n HWIO "
            f"kernels of a dense block of growth {GROWTH}; got x {tuple(x.shape)} {x.dtype}, "
            f"{len(ws)} kernels {sorted(set(shapes))}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("rrdb_dense: x must be contiguous NHWC, 16-byte aligned")
    wimg, bias = laid if laid is not None else layout([w.to(x.device) for w in ws],
                                                      [b.to(x.device) for b in bs])
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    lib = _build.load("rrdb_dense", _SIGNATURES)
    # three buffers of the blocks' features, 8-channel planes of a padded grid
    elems = ctypes.c_longlong()
    _build.check(lib.rrdb_dense_workspace(b, h, w, ctypes.byref(elems)), "rrdb_dense")
    bufs = torch.empty(elems.value, device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device), span("kernel.rrdb_dense"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.rrdb_dense_bf16(x.data_ptr(), wimg.data_ptr(), bias.data_ptr(), y.data_ptr(),
                                  bufs.data_ptr(), blocks // 3, b, h, w, slope, scale, stream)
    _build.check(err, "rrdb_dense")
    launches += 1
    return y
