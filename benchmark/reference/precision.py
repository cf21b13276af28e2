"""The control's precision: float8, the step below bfloat16, in the
hybrid form fp8 training uses. Operands of every convolution and matrix
product are rounded to e4m3 in the forward; the gradient that flows back
into an activation operand is rounded to e5m2 in the backward; weight
gradients stay in float32, as fp8 recipes accumulate them. Each tensor
has one scale, its largest magnitude mapped to the format's largest
finite value; products still accumulate in float32.

`quant(x, role)` is what the reference's convolutions call, role "act" or
"weight"."""

from __future__ import annotations

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, backward_rounding: bool):
        ctx.backward_rounding = backward_rounding
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward_rounding:
            g = _round(g, torch.float8_e5m2, E5M2_MAX)
        return g, None


def fp8(x: torch.Tensor, role: str) -> torch.Tensor:
    return _Fp8.apply(x, role == "act")


def bf16(x: torch.Tensor, role: str) -> torch.Tensor:
    """A witness, not a control: operands rounded to bfloat16, the
    configuration's own precision, gradients straight through."""
    return x + (x.detach().to(torch.bfloat16).to(x.dtype) - x.detach())
