"""Residual trunk with batch-stat BatchNorm, forward and backward (port of
srgan_st_tpu/kernels/packed_trunk.py: K4 `_fwd_kernel`, K5 `_bwd_kernel`).

`packed_trunk(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps)` runs n residual
blocks x <- x + BN2(conv2(PReLU(BN1(conv1(x))))) over NHWC `x` with the
stacked per-block parameters (HWIO conv kernels (n, 3, 3, C, C), BN scale
and bias (n, C), PReLU slopes (n,)) and returns (y, stats): stats (n, 4, C)
f32 are the biased batch moments [m1, v1, m2, v2] of every BatchNorm, side
state for the running-stat EMA with no gradient. It is an autograd
Function: on a CUDA tensor its forward launches K4 and saves the residuals
(block inputs and both preactivations), its backward launches K5, both from
`csrc/packed_trunk.cu`; on a CPU tensor both directions run the plain
version. `hybrid_trunk` runs the plain forward and the same backward, as
the JAX package's `hybrid_trunk` does.

The plain version, `packed_trunk_reference`, is an autograd Function of its
own whose forward and backward are written out step by step with the
kernels' roundings (csrc/packed_trunk.cu lists them). It follows the Pallas
kernel, not `fused_trunk.trunk_reference`, which rounds v before the rsqrt.
The W-parity lane packing of the TPU kernels has no counterpart: the CUDA
kernels take the fine NHWC layout. The bf16 kernels (wgmma tiles over the
zero-padded flattened grid, csrc/trunk_wgmma.cuh) take their conv weights
as ring images (`weight_image`), laid out on every call: a train step's
optimizer changes them between calls, so a cache per parameter version
would be rebuilt every step all the same. tests/test_torch_trunk_tiles.py
emulates their tiles on the CPU.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from srgan_st_tpu_torch.kernels import _build

# launches of the CUDA forward (K4) and backward (K5) since import (or the
# last reset)
fwd_launches = 0
bwd_launches = 0

_FWD = {torch.bfloat16: "packed_trunk_fwd_bf16", torch.float32: "packed_trunk_fwd_f32"}
_BWD = {torch.bfloat16: "packed_trunk_bwd_bf16", torch.float32: "packed_trunk_bwd_f32"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 14 + [ctypes.c_longlong] + [_I] * 5 + [ctypes.c_float, _P]
_BWD_ARGS = [_P] * 20 + [ctypes.c_longlong] + [_I] * 5 + [ctypes.c_float, _P]
_SIGNATURES = {
    **{fn: _FWD_ARGS for fn in _FWD.values()},
    **{fn: _BWD_ARGS for fn in _BWD.values()},
    "packed_trunk_ws_bytes": [_I] * 7 + [ctypes.POINTER(ctypes.c_longlong)],
    "packed_trunk_launches": [_I] * 3 + [ctypes.POINTER(ctypes.c_longlong)],
}
# channels of the bf16 kernels' N tiles and K chunks (csrc/trunk_wgmma.cuh)
CK = 64


# ---------------------------------------------------------------------------
# the plain version

def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 SAME conv of NHWC x with HWIO w, accumulated in f32 from the
    operands' own (compute dtype) values, as the kernels' MMA does."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   padding=1)
    return out.permute(0, 2, 3, 1)


def _moments(a: torch.Tensor):
    """f32 biased batch moments over (B, H, W): m, max(E[a^2] - m^2, 0)."""
    af = a.float()
    m = af.mean((0, 1, 2))
    return m, torch.clamp((af * af).mean((0, 1, 2)) - m * m, min=0.0)


def _bn_affine(a, m, v, gamma, beta, eps):
    """The kernels' normalize in the compute dtype of `a`: f32 rsqrt of the
    f32 variance rounded to it, then every step rounded."""
    cdt = a.dtype
    inv = torch.rsqrt(v + eps).to(cdt)
    out = (a - m.to(cdt)) * inv
    return out * gamma.to(cdt) + beta.to(cdt)


def _bn_backward(dyf, a, m, inv, gamma, nelem):
    """f32 train-mode BN backward with the unrounded inv; da rounded to the
    compute dtype of `a`. Returns (da, dgamma, dbeta)."""
    xhat = (a.float() - m) * inv
    dbeta = dyf.sum((0, 1, 2))
    dgamma = (dyf * xhat).sum((0, 1, 2))
    da = (gamma * inv) * (dyf - dbeta / nelem - xhat * (dgamma / nelem))
    return da.to(a.dtype), dgamma, dbeta


def _dgrad_weights(w: torch.Tensor, cdt) -> torch.Tensor:
    """HWIO w (or a stack of them) -> the flipped, transposed kernel whose
    SAME conv is dgrad."""
    return w.flip((-4, -3)).transpose(-2, -1).to(cdt)


def _wgrad(src: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW[ky, kx, ci, co] = sum_p src[p + (ky-1, kx-1), ci] dy[p, co] in f32."""
    _, h, w, _ = src.shape
    sp = F.pad(src.float(), (0, 0, 1, 1, 1, 1))
    dyf = dy.float()
    return torch.stack([
        torch.stack([torch.einsum("bhwi,bhwo->io", sp[:, ky:ky + h, kx:kx + w], dyf)
                     for kx in range(3)])
        for ky in range(3)])


def _reference_forward(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps):
    """-> (y, xs, a1s, a2s, stats), the residuals stacked over the blocks."""
    cdt = x.dtype
    xs, a1s, a2s, stats = [], [], [], []
    for i in range(w1s.shape[0]):
        xs.append(x)
        a1 = _conv(x, w1s[i].to(cdt)).to(cdt)
        m1, v1 = _moments(a1)
        hval = _bn_affine(a1, m1, v1, g1s[i], b1s[i], eps)
        hval = torch.where(hval >= 0, hval, als[i].to(cdt) * hval)
        a2 = _conv(hval, w2s[i].to(cdt)).to(cdt)
        m2, v2 = _moments(a2)
        x = x + _bn_affine(a2, m2, v2, g2s[i], b2s[i], eps)
        a1s.append(a1)
        a2s.append(a2)
        stats.append(torch.stack([m1, v1, m2, v2]))
    return x, torch.stack(xs), torch.stack(a1s), torch.stack(a2s), torch.stack(stats)


def _reference_backward(dy, xs, a1s, a2s, stats, w1s, w2s, g1s, b1s, g2s, als, eps):
    """-> (dx, dw1, dw2, dg1, db1, dg2, db2, dal), blocks in reverse with the
    running cotangent held in the compute dtype between them."""
    cdt = xs.dtype
    n, b, h, w, _ = xs.shape
    nelem = b * h * w
    g = dy.to(cdt)
    grads = [[None] * n for _ in range(7)]
    for j in reversed(range(n)):
        m1, v1, m2, v2 = stats[j]
        inv1, inv2 = torch.rsqrt(v1 + eps), torch.rsqrt(v2 + eps)
        da2, dg2, db2 = _bn_backward(g.float(), a2s[j], m2, inv2, g2s[j], nelem)
        dh = _conv(da2, _dgrad_weights(w2s[j], cdt))
        pre_c = _bn_affine(a1s[j], m1, v1, g1s[j], b1s[j], eps)
        pre = pre_c.float()
        neg = pre < 0
        hval = torch.where(neg, als[j].to(cdt) * pre_c, pre_c)
        dal = torch.where(neg, dh * pre, 0.0).sum()
        dpre = torch.where(neg, dh * als[j], dh)
        da1, dg1, db1 = _bn_backward(dpre, a1s[j], m1, inv1, g1s[j], nelem)
        g = (g.float() + _conv(da1, _dgrad_weights(w1s[j], cdt))).to(cdt)
        for k, val in enumerate((_wgrad(xs[j], da1), _wgrad(hval, da2),
                                 dg1, db1, dg2, db2, dal)):
            grads[k][j] = val
    return (g, *(torch.stack(gk) for gk in grads))


class _TrunkReference(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps):
        y, xs, a1s, a2s, stats = _reference_forward(x, w1s, w2s, g1s, b1s, g2s, b2s,
                                                    als, eps)
        ctx.save_for_backward(xs, a1s, a2s, stats, w1s, w2s, g1s, b1s, g2s, als)
        ctx.eps = eps
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        return (*_reference_backward(dy, *ctx.saved_tensors, ctx.eps), None)


def packed_trunk_reference(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps=1e-5):
    """The plain version of `packed_trunk`, both directions in torch ops."""
    return _TrunkReference.apply(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps)


# ---------------------------------------------------------------------------
# the kernels

def fits(x_shape, dtype) -> bool:
    """Shape gate of the CUDA kernels: NHWC bf16/f32 x with an even W (the
    JAX package's gate) and C a multiple of 64, at most 1024."""
    if len(x_shape) != 4 or dtype not in _FWD:
        return False
    b, h, w, c = x_shape
    return min(b, h, w) > 0 and w % 2 == 0 and c % 64 == 0 and 64 <= c <= 1024


def _check(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"packed_trunk: no kernel for device {x.device}")
    if not fits(x.shape, x.dtype):
        raise ValueError(
            f"packed_trunk: the kernels take NHWC bf16/f32 x with an even W and C "
            f"a multiple of 64 (at most 1024); got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("packed_trunk: x must be contiguous NHWC, 16-byte aligned")


def _ws_bytes(lib, n, x_shape, dtype, backward: bool) -> int:
    out = ctypes.c_longlong(0)
    esize = torch.finfo(dtype).bits // 8
    _build.check(lib.packed_trunk_ws_bytes(n, *x_shape, esize, int(backward),
                                           ctypes.byref(out)), "packed_trunk workspace")
    return out.value


def _f32(t: torch.Tensor, dev) -> torch.Tensor:
    return t.to(device=dev, dtype=torch.float32).contiguous()


def weight_image(ws: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """HWIO conv kernels (n, 3, 3, C, C) -> the bf16 kernels' weight blocks
    (n, C/64 N tiles, C/64 K chunks, 9 taps, 8 k groups, 64 outputs, 8): one
    73.7 KB block per (N tile, K chunk), the image of the ring's stage that
    a bulk copy fills. In `dtype` (ws's own by default), cast and laid out
    by one copy."""
    n, c = ws.shape[0], ws.shape[-1]
    t = c // CK
    # [n, tap, kc, kg, j, nt, co] with ci = 64 kc + 8 kg + j, co = 64 nt + co
    src = ws.reshape(n, 9, t, CK // 8, 8, t, CK).permute(0, 5, 2, 1, 3, 6, 4)
    return torch.empty(src.shape, dtype=dtype or ws.dtype, device=ws.device).copy_(src)


def _layout_fwd(w1s, w2s, dev, cdt):
    """The forward's conv weights as the kernels take them: bf16, the ring
    images; f32, [block][tap][out][in]."""
    if cdt == torch.bfloat16:
        return tuple(weight_image(w.to(dev), cdt) for w in (w1s, w2s))
    n, c = w1s.shape[0], w1s.shape[-1]
    return tuple(w.to(device=dev, dtype=cdt).permute(0, 1, 2, 4, 3).reshape(n, 9, c, c)
                 .contiguous() for w in (w1s, w2s))


def _layout_bwd(w1s, w2s, dev, cdt):
    """The dgrad kernels (flipped, transposed) in the forward's layout."""
    # flipped in the weights' own dtype, cast by the layout's copy
    ws = (_dgrad_weights(w.to(dev), w.dtype) for w in (w1s, w2s))
    if cdt == torch.bfloat16:
        return tuple(weight_image(w, cdt) for w in ws)
    n, c = w1s.shape[0], w1s.shape[-1]
    return tuple(w.to(cdt).transpose(-2, -1).reshape(n, 9, c, c).contiguous() for w in ws)


def launches_per_call(n: int, dtype, backward: bool) -> int:
    """Kernel launches of one K4 (or K5) call, as the library counts them."""
    out = ctypes.c_longlong(0)
    lib = _build.load("packed_trunk", _SIGNATURES)
    _build.check(lib.packed_trunk_launches(n, torch.finfo(dtype).bits // 8, int(backward),
                                           ctypes.byref(out)), "packed_trunk launches")
    return out.value


def _launch_fwd(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps, weights=None):
    """K4 on CUDA tensors; `weights`: the conv weights already laid out by
    `_layout_fwd` (else laid out here)."""
    global fwd_launches
    _check(x)
    n = w1s.shape[0]
    b, h, w, c = x.shape
    dev, cdt = x.device, x.dtype
    w1t, w2t = weights if weights is not None else _layout_fwd(w1s, w2s, dev, cdt)
    vecs = [_f32(t, dev) for t in (g1s, b1s, g2s, b2s, als.reshape(n))]
    y = torch.empty_like(x)
    xs, a1s, a2s = (torch.empty((n, b, h, w, c), device=dev, dtype=cdt) for _ in range(3))
    stats = torch.empty((n, 4, c), device=dev, dtype=torch.float32)
    lib = _build.load("packed_trunk", _SIGNATURES)
    ws = torch.empty(_ws_bytes(lib, n, x.shape, cdt, False), device=dev,
                     dtype=torch.uint8)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _FWD[cdt])(
            x.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), *(v.data_ptr() for v in vecs),
            y.data_ptr(), xs.data_ptr(), a1s.data_ptr(), a2s.data_ptr(),
            stats.data_ptr(), ws.data_ptr(), ws.numel(), n, b, h, w, c, eps, stream)
    _build.check(err, "packed_trunk forward")
    fwd_launches += 1
    return y, xs, a1s, a2s, stats


def _launch_bwd(dy, xs, a1s, a2s, stats, w1s, w2s, g1s, b1s, g2s, als, eps, weights=None):
    """K5 on CUDA tensors; `weights`: the dgrad weights already laid out by
    `_layout_bwd` (else laid out here)."""
    global bwd_launches
    n, b, h, w, c = xs.shape
    dev, cdt = xs.device, xs.dtype
    dy = dy.to(cdt).contiguous()
    _check(dy)
    w1d, w2d = weights if weights is not None else _layout_bwd(w1s, w2s, dev, cdt)
    vecs = [_f32(t, dev) for t in (g1s, b1s, g2s, als.reshape(n))]
    dx = torch.empty_like(dy)
    dw1, dw2 = (torch.empty((n, 3, 3, c, c), device=dev, dtype=torch.float32)
                for _ in range(2))
    dg1, db1, dg2, db2 = (torch.empty((n, c), device=dev, dtype=torch.float32)
                          for _ in range(4))
    dal = torch.empty((n,), device=dev, dtype=torch.float32)
    lib = _build.load("packed_trunk", _SIGNATURES)
    ws = torch.empty(_ws_bytes(lib, n, dy.shape, cdt, True), device=dev,
                     dtype=torch.uint8)
    outs = (dx, dw1, dw2, dg1, db1, dg2, db2, dal)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, _BWD[cdt])(
            dy.data_ptr(), xs.data_ptr(), a1s.data_ptr(), a2s.data_ptr(),
            stats.data_ptr(), w1d.data_ptr(), w2d.data_ptr(),
            *(v.data_ptr() for v in vecs), *(o.data_ptr() for o in outs),
            ws.data_ptr(), ws.numel(), n, b, h, w, c, eps, stream)
    _build.check(err, "packed_trunk backward")
    bwd_launches += 1
    return outs


class _Trunk(torch.autograd.Function):
    """K4 forward (or the plain forward, with `plain_forward`) and K5
    backward on CUDA tensors; the plain version both ways on CPU ones."""

    @staticmethod
    def forward(ctx, x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps, plain_forward):
        args = (x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps)
        if plain_forward or x.device.type == "cpu":
            y, xs, a1s, a2s, stats = _reference_forward(*args)
        else:
            y, xs, a1s, a2s, stats = _launch_fwd(*args)
        ctx.save_for_backward(xs, a1s, a2s, stats, w1s, w2s, g1s, b1s, g2s, als)
        ctx.eps = eps
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, dy, _dstats):
        saved = ctx.saved_tensors
        if dy.device.type == "cpu":
            grads = _reference_backward(dy, *saved, ctx.eps)
        else:
            grads = _launch_bwd(dy, *saved, ctx.eps)
        return (*grads, None, None)


def _even_width(x: torch.Tensor, name: str) -> None:
    if x.shape[2] % 2:
        raise ValueError(f"{name} needs an even fine width, got {x.shape[2]}")


def packed_trunk(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps=1e-5):
    """x (B, H, W, C) in the compute dtype; w1s, w2s (n, 3, 3, C, C) HWIO;
    g1s, b1s, g2s, b2s (n, C); als (n,). Returns (y, stats)."""
    _even_width(x, "packed_trunk")
    return _Trunk.apply(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps, False)


def hybrid_trunk(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps=1e-5):
    """`packed_trunk` with the plain forward and the same backward."""
    _even_width(x, "hybrid_trunk")
    return _Trunk.apply(x, w1s, w2s, g1s, b1s, g2s, b2s, als, eps, True)
