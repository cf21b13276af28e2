"""The BatchNorm-folded eval trunk as plain PyTorch (port of
srgan_st_tpu/kernels/xpack_trunk.py, by its function).

The JAX module lays the trunk out in W-parity lane packing, ((B, H, W, C)
as (B, H, W/2 + 1, 2C), with masks and packed conv blocks), so that its
convs fill the TPU's 128 lanes at C = 64; it has no Pallas kernel. That
layout is the TPU's and has no counterpart here. The training trunk,
`xpack_trunk`, is the function of the K4/K5 trunk with xpack's roundings
(each conv accumulated in f32 and rounded once to the compute dtype, f32
batch moments, a compute-dtype rsqrt(v + eps), (a - m) * inv * gamma +
beta rounded at each step, PReLU on the sign), so the Generator runs
kernels/packed_trunk.py for trunk_mode="xpack" in a train step. This
module holds the eval trunk, on the fine NHWC layout:

  * `xpack_trunk_eval(x, ..., m1s, v1s, m2s, v2s, eps)` -> y: eval mode
    with every BatchNorm folded into its conv from the running statistics,
    once per call: s = gamma * rsqrt(v + eps) in f32, w' = w * s over the
    output channels, b' = beta - mu * s, both cast to the compute dtype;
    each block is then conv + bias -> PReLU -> conv + bias -> residual add.
    The bias is the conv's own (one rounding of conv + bias where JAX
    rounds the conv, then the sum: within the compute dtype's rounding).

Parameters are stacked per block as the trunk kernels take them: HWIO conv
kernels (n, 3, 3, C, C), BatchNorm scales, biases and statistics (n, C),
PReLU slopes (n,).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def fold_batchnorm(ws, gs, bs, ms, vs, eps, dtype):
    """Each eval BatchNorm folded into the conv before it: HWIO kernels
    (n, 3, 3, C, C) -> OIHW (n, C, C, 3, 3) scaled per output channel, and
    the shift as a bias (n, C), folded in f32 and cast to `dtype`."""
    s = gs.float() * torch.rsqrt(vs.float() + eps)
    wf = ws.float() * s[:, None, None, None, :]
    bf = bs.float() - ms.float() * s
    return wf.permute(0, 4, 3, 1, 2).to(dtype), bf.to(dtype)


def xpack_trunk_eval(x, w1s, w2s, g1s, b1s, g2s, b2s, als, m1s, v1s, m2s, v2s,
                     eps=1e-5):
    """NHWC x -> NHWC y of the eval trunk with running-statistic BatchNorm."""
    cdt = x.dtype
    wq1, bq1 = fold_batchnorm(w1s, g1s, b1s, m1s, v1s, eps, cdt)
    wq2, bq2 = fold_batchnorm(w2s, g2s, b2s, m2s, v2s, eps, cdt)
    h = x.permute(0, 3, 1, 2)  # channels_last NCHW view of NHWC
    for i in range(w1s.shape[0]):
        a = F.conv2d(h, wq1[i], bq1[i], padding=1)
        a = torch.where(a >= 0, a, als[i].to(cdt) * a)
        h = h + F.conv2d(a, wq2[i], bq2[i], padding=1)
    return h.permute(0, 2, 3, 1)
