"""Whole residual trunk, forward in one launch (port of
srgan_st_tpu/kernels/fused_trunk.py: K6 `_kernel`, and its backward
`_bwd_xla`).

`fused_trunk(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps)` runs the n residual
blocks x <- x + BN2(conv2(PReLU(BN1(conv1(x))))) with batch-stat BatchNorm
over NHWC `x` and the stacked block parameters (as `packed_trunk` takes
them) and returns (y, stats): stats (n, 4, C) f32 [m1, v1, m2, v2] feed the
running-stat EMA and carry no gradient. It is an autograd Function: on a
CUDA tensor its forward is the persistent cooperative kernel K6
(csrc/fused_trunk.cu: in bf16 K4's wgmma conv tile, csrc/trunk_conv_tile.cuh,
with 2n grid barriers; in f32 a SIMT tile with 6n - 1), on a CPU tensor
the plain forward; both save the residuals (block inputs, both
preactivations, stats). Its backward, on both, is the JAX package's
`_bwd_xla` in torch ops, with that function's own
roundings, which are not K5's: the PReLU input is recomputed with a
compute-dtype rsqrt of the compute-dtype variance (`_recompute_h`), the
BN backward uses the unrounded f32 inv, and each dgrad is rounded to the
compute dtype before it is used or added.

The forward's function and roundings are K4's, so the plain version is
`packed_trunk._reference_forward` (the CPU tests hold it to JAX's K6 in
interpret mode); in bf16 K6 runs K4's tile and sums K4's partials in K4's
order, so its five outputs have the bits of K4's. Its weights are laid out
as K4's (`packed_trunk._layout_fwd`: the bf16 ring images).
"""

from __future__ import annotations

import ctypes

import torch

from srgan_st_tpu_torch.kernels import _build
from srgan_st_tpu_torch.kernels.packed_trunk import (
    _bn_backward,
    _conv,
    _dgrad_weights,
    _f32,
    _layout_fwd,
    _reference_forward,
    _wgrad,
)

# launches of the CUDA kernel since import (or the last reset), and the
# number of blocks the last one ran
launches = 0
last_grid = 0

_FWD = {torch.bfloat16: "fused_trunk_fwd_bf16", torch.float32: "fused_trunk_fwd_f32"}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGS = ([_P] * 14 + [_LL] + [_I] * 5 + [ctypes.c_float, _P, ctypes.POINTER(_I)]
         + [_P, _LL])  # and the probe
_SIGNATURES = {
    "fused_trunk_fwd_bf16": _ARGS,
    "fused_trunk_fwd_f32": _ARGS,
    "fused_trunk_ws_bytes": [_I] * 6 + [ctypes.POINTER(_LL)],
}

fused_trunk_reference = _reference_forward


def fits(x_shape, dtype) -> bool:
    """Shape gate of the CUDA kernel: NHWC bf16/f32 x with C a multiple of
    64, at most 1024 (any H and W)."""
    if len(x_shape) != 4 or dtype not in _FWD:
        return False
    b, h, w, c = x_shape
    return min(b, h, w) > 0 and c % 64 == 0 and 64 <= c <= 1024


def probe_words(x_shape, n: int) -> int:
    """int64 words of a probe that fits any K6 launch on x of `x_shape`:
    the barrier count, then (blocks, 2n, 4) stamps for at most as many
    blocks as the bf16 kernel has tiles (the padded grid's 64-position
    tiles times C / 64)."""
    b, h, w, c = x_shape
    return 1 + -(-b * (h + 2) * (w + 2) // 64) * (c // 64) * 2 * n * 4


def probe_syncs(probe) -> int:
    """Grid barriers that each block of the probed launch passed."""
    total = int(probe.view(-1)[0])
    if last_grid <= 0 or total % last_grid:
        raise ValueError(f"fused_trunk: {total} barriers do not divide among {last_grid} blocks")
    return total // last_grid


def _launch_fwd(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps, weights=None, probe=None):
    """K6 on CUDA tensors; `weights`: the conv weights already laid out by
    `packed_trunk._layout_fwd` (else laid out here). `probe`: a zeroed,
    contiguous int64 tensor on x's device, of `probe_words` words, into
    which the launch counts each block's grid barriers (word 0, read by
    `probe_syncs`) and, in bf16, writes after it each block's ns stamps
    per conv (blocks, 2n, 4): its first tile starts; its last epilogue
    ends; the conv's grid barrier releases it; the moments and the next
    BatchNorm's gamma and beta are in shared memory."""
    global launches, last_grid
    if x.device.type != "cuda":
        raise ValueError(f"fused_trunk: no kernel for device {x.device}")
    if not fits(x.shape, x.dtype):
        raise ValueError(f"fused_trunk: the kernel takes NHWC bf16/f32 x with C a "
                         f"multiple of 64 (at most 1024); got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_trunk: x must be contiguous NHWC, 16-byte aligned")
    n = w1s.shape[0]
    b, h, w, c = x.shape
    dev, cdt = x.device, x.dtype
    w1t, w2t = weights if weights is not None else _layout_fwd(w1s, w2s, dev, cdt)
    vecs = [_f32(t, dev) for t in (g1s, b1s, g2s, b2s, als.reshape(n))]
    y = torch.empty_like(x)
    xs, a1s, a2s = (torch.empty((n, b, h, w, c), device=dev, dtype=cdt) for _ in range(3))
    stats = torch.empty((n, 4, c), device=dev, dtype=torch.float32)
    lib = _build.load("fused_trunk", _SIGNATURES)
    nbytes = ctypes.c_longlong(0)
    _build.check(lib.fused_trunk_ws_bytes(n, b, h, w, c, torch.finfo(cdt).bits // 8,
                                          ctypes.byref(nbytes)), "fused_trunk workspace")
    ws = torch.empty(nbytes.value, device=dev, dtype=torch.uint8)
    grid = ctypes.c_int(0)
    if probe is not None and (probe.dtype != torch.int64 or probe.device != dev
                              or not probe.is_contiguous() or probe.numel() == 0):
        raise ValueError(f"fused_trunk: the probe must be a non-empty contiguous int64 "
                         f"tensor on {dev}; got {probe.dtype} {tuple(probe.shape)} on "
                         f"{probe.device}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FWD[cdt])(
            x.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), *(v.data_ptr() for v in vecs),
            y.data_ptr(), xs.data_ptr(), a1s.data_ptr(), a2s.data_ptr(), stats.data_ptr(),
            ws.data_ptr(), ws.numel(), n, b, h, w, c, eps, stream, ctypes.byref(grid),
            None if probe is None else probe.data_ptr(),
            0 if probe is None else probe.numel())
    _build.check(err, "fused_trunk forward")
    launches += 1
    last_grid = grid.value
    return y, xs, a1s, a2s, stats


# ---------------------------------------------------------------------------
# the backward: `_bwd_xla` (fused_trunk.py:176-267) in torch ops

def _recompute_h(a1, m1, v1, g1, b1, alpha, eps):
    """(PReLU input, conv2 input) from the residuals in the compute dtype,
    the inv a compute-dtype rsqrt of the compute-dtype v + eps (:219-227)."""
    cdt = a1.dtype
    inv = torch.rsqrt(v1.to(cdt) + torch.full((), eps, dtype=cdt, device=a1.device))
    pre = (a1 - m1.to(cdt)) * inv
    pre = pre * g1.to(cdt) + b1.to(cdt)
    return pre, torch.where(pre >= 0, pre, alpha.to(cdt) * pre)


def fused_trunk_backward(dy, xs, a1s, a2s, stats, w1s, w2s, g1s, b1s, g2s, als, eps):
    """-> (dx, dw1, dw2, dg1, db1, dg2, db2, dal), blocks in reverse, the
    running cotangent in the compute dtype."""
    cdt = xs.dtype
    n, b, h, w, _ = xs.shape
    nelem = b * h * w
    g = dy.to(cdt)
    grads = [[None] * n for _ in range(7)]
    for i in reversed(range(n)):
        m1, v1, m2, v2 = stats[i]
        pre, hval = _recompute_h(a1s[i], m1, v1, g1s[i], b1s[i], als[i], eps)
        da2, dg2, db2 = _bn_backward(g.float(), a2s[i], m2, torch.rsqrt(v2 + eps), g2s[i],
                                     nelem)
        dh = _conv(da2, _dgrad_weights(w2s[i], cdt)).to(cdt)
        neg = pre < 0
        dal = torch.where(neg, dh.float() * pre.float(), 0.0).sum()
        dpre = torch.where(neg, dh * als[i].to(cdt), dh)
        da1, dg1, db1 = _bn_backward(dpre.float(), a1s[i], m1, torch.rsqrt(v1 + eps),
                                     g1s[i], nelem)
        for k, val in enumerate((_wgrad(xs[i], da1), _wgrad(hval, da2),
                                 dg1, db1, dg2, db2, dal)):
            grads[k][i] = val
        g = g + _conv(da1, _dgrad_weights(w1s[i], cdt)).to(cdt)
    return (g, *(torch.stack(gk) for gk in grads))


class _Trunk(torch.autograd.Function):
    """K6 (CUDA) or the plain forward (CPU); the torch `_bwd_xla` backward."""

    @staticmethod
    def forward(ctx, x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps):
        args = (x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps)
        if x.device.type == "cpu":
            y, xs, a1s, a2s, stats = fused_trunk_reference(*args)
        else:
            y, xs, a1s, a2s, stats = _launch_fwd(*args)
        ctx.save_for_backward(xs, a1s, a2s, stats, w1s, w2s, g1s, b1s, g2s, als)
        ctx.eps = eps
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        return (*fused_trunk_backward(dy, *ctx.saved_tensors, ctx.eps), None)


def fused_trunk(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps=1e-5):
    """x (B, H, W, C) in the compute dtype; w1s, w2s (n, 3, 3, C, C) HWIO;
    g1s, b1s, g2s, b2s (n, C); als (n,). Returns (y, stats)."""
    return _Trunk.apply(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps)
