"""The generator's eval trunk as one hand-written kernel (kernel E,
`csrc/eval_trunk.cu`; it replaces no TPU kernel: the JAX package's eval
trunk is plain XLA).

`eval_trunk(x, ws, scale, shift, alphas)` runs what the generator's
`g.trunk` region computes in eval, from the stem output x (B, H, W, C)
NHWC: n residual blocks h = PReLU(BN1(conv1(x))), x <- x + BN2(conv2(h)),
then the fusion conv with its BatchNorm and the global skip, y = BN(conv(x))
+ x_stem. Every BatchNorm uses its running statistics as the channel's
affine y = a * s + t, s = gamma rsqrt(var + eps), t = beta - mean s
(`affine`, f32). Operands, stacked over the 2n + 1 convs in order (conv1_0,
conv2_0, ..., conv2_{n-1}, the fusion conv): ws (2n + 1, 3, 3, C, C) HWIO,
scale and shift (2n + 1, C) f32; alphas (n,) the PReLU slopes.

Each conv accumulates in f32 from the compute dtype's operands; the affine,
the PReLU (f32 slope) and the residual add (the residual read in the
compute dtype) run on the f32 accumulator, and the result is rounded once
to the compute dtype: the blocks' function at the configuration's
precision, with one rounding a conv where the blocks round at every step.
`eval_trunk_reference` is that arithmetic in torch. On a CUDA tensor the
wrapper launches the kernel (bf16, C = 64, any B, H, W: 2n + 1 launches in
one call) or raises; on a CPU tensor it runs the plain version. The kernel
has no backward.

`gate` is the generator's choice of this path, a pure function of what
its forward observes; `EvalTrunkWeights` keeps the kernel's layout of a
generator's trunk parameters, made again only when one of them changes.
"""

from __future__ import annotations

import ctypes

import torch

from srgan_st_tpu_torch.kernels import _build
from srgan_st_tpu_torch.kernels.packed_trunk import _conv, weight_image
from srgan_st_tpu_torch.utils.profiling import span

# calls of the CUDA kernel since import (or the last reset); each call
# makes 2n + 1 launches
launches = 0

CHANNELS = 64  # the kernel's width (csrc/eval_trunk.cu C64)
# trunk modes whose eval path is this kernel (None is the auto)
MODES = (None, "packed", "hybrid", "fused")
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"eval_trunk_bf16": [_P] * 7 + [_I] * 4 + [_P]}


def gate(train: bool, grad_enabled: bool, device_type: str, dtype: torch.dtype,
         channels: int, trunk_mode: str | None) -> bool:
    """Whether the generator's trunk runs this kernel: eval, no gradient
    (the kernel has no backward), a CUDA bf16 activation of CHANNELS
    channels, and a trunk mode in MODES. Explicit "unfused" keeps the
    blocks and "xpack" / "xpack_eval" the BatchNorm-folded trunk."""
    return (not train and not grad_enabled and device_type == "cuda"
            and dtype == torch.bfloat16 and channels == CHANNELS and trunk_mode in MODES)


def affine(gamma, beta, mean, var, eps):
    """A running-statistics BatchNorm as the channel's (scale, shift), f32:
    s = gamma rsqrt(var + eps), t = beta - mean s."""
    s = gamma.float() * torch.rsqrt(var.float() + eps)
    return s, beta.float() - mean.float() * s


def eval_trunk_reference(x, ws, scale, shift, alphas):
    """The plain version: the kernel's arithmetic in torch ops."""
    cdt = x.dtype
    n = alphas.shape[0]

    def conv(h, i):
        return _conv(h, ws[i].to(cdt)) * scale[i].float() + shift[i].float()

    h = x
    for j in range(n):
        a = conv(h, 2 * j)
        a = torch.where(a >= 0, a, alphas[j].float() * a).to(cdt)
        h = (conv(a, 2 * j + 1) + h.float()).to(cdt)
    return (conv(h, 2 * n) + x.float()).to(cdt)


def layout(ws, scale, shift, alphas):
    """The kernel's operands on ws's device: the bf16 ring images of the
    2n + 1 convs, (2n + 1, 2, C) f32 [scale, shift] and (n,) f32 slopes."""
    st = torch.stack([scale.float(), shift.float()], 1).contiguous()
    return (weight_image(ws, torch.bfloat16), st,
            alphas.to(device=ws.device, dtype=torch.float32).reshape(-1).contiguous())


class EvalTrunkWeights:
    """The operands of a generator's eval trunk, stacked (`operands`) and
    laid out for the kernel (`layout`), made again only when a parameter
    or running statistic changes storage or version, or a CUDA graph was
    replayed (`kernels.generation`: a replay updates them without bumping
    their version): once per parameter version, not once per frame."""

    def __init__(self) -> None:
        self._key = None
        self._ops = None

    def get(self, convs, bns, prelus, eps: float) -> tuple:
        """convs: the 2n + 1 OIHW conv weights in order; bns: their
        BatchNorms' (weight, bias, running_mean, running_var); prelus: the
        n slopes. Returns (ws, scale, shift, alphas, laid out): laid out is
        `layout`'s, or None off CUDA."""
        from srgan_st_tpu_torch import kernels

        tensors = [*convs, *(t for bn in bns for t in bn), *prelus]
        key = (kernels.generation, eps, *[t.data_ptr() for t in tensors],
               *[t._version for t in tensors])
        if key != self._key:
            with torch.no_grad():
                ws = torch.stack([w.detach().permute(2, 3, 1, 0) for w in convs])
                pairs = [affine(*(t.detach() for t in bn), eps) for bn in bns]
                scale = torch.stack([s for s, _ in pairs])
                shift = torch.stack([t for _, t in pairs])
                alphas = torch.cat([a.detach().reshape(-1) for a in prelus]).float()
                laid = layout(ws, scale, shift, alphas) if ws.is_cuda else None
            self._ops = (ws, scale, shift, alphas, laid)
            self._key = key
        return self._ops


def eval_trunk(x, ws, scale, shift, alphas, laid=None):
    """x (B, H, W, C) NHWC in the compute dtype -> y (B, H, W, C). A CPU
    tensor takes the plain version; a CUDA tensor the kernel, with `laid`
    the kernel's layout of the operands where the caller has it
    (`EvalTrunkWeights`)."""
    if x.device.type == "cpu":
        return eval_trunk_reference(x, ws, scale, shift, alphas)
    return _launch(x, ws, scale, shift, alphas, laid)


def _launch(x, ws, scale, shift, alphas, laid=None):
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"eval_trunk: no kernel for device {x.device}")
    n = alphas.numel()
    if (x.dim() != 4 or x.dtype != torch.bfloat16 or x.shape[-1] != CHANNELS
            or min(x.shape) == 0 or tuple(ws.shape) != (2 * n + 1, 3, 3, CHANNELS, CHANNELS)):
        raise ValueError(
            f"eval_trunk: the kernel takes NHWC bf16 x of {CHANNELS} channels and "
            f"(2n + 1, 3, 3, {CHANNELS}, {CHANNELS}) kernels; got x {tuple(x.shape)} "
            f"{x.dtype}, ws {tuple(ws.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("eval_trunk: x must be contiguous NHWC, 16-byte aligned")
    wimg, st, al = laid if laid is not None else layout(ws.to(x.device), scale.to(x.device),
                                                        shift.to(x.device), alphas)
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    pads = torch.empty((2, b, h + 2, w + 2, c), device=x.device, dtype=x.dtype)
    lib = _build.load("eval_trunk", _SIGNATURES)
    with torch.cuda.device(x.device), span("kernel.eval_trunk"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.eval_trunk_bf16(x.data_ptr(), wimg.data_ptr(), st.data_ptr(), al.data_ptr(),
                                  y.data_ptr(), pads[0].data_ptr(), pads[1].data_ptr(),
                                  n, b, h, w, stream)
    _build.check(err, "eval_trunk")
    launches += 1
    return y
