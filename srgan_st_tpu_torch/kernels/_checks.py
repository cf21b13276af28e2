"""Checks of a buddy selection (kernels/buddy_select.py) against float64
ground truth: the one copy of the gate rules, and of the near-tie bank,
that the CPU tests, the GPU tests and chip_smoke.py hold the selection to.
Nothing on the training path calls them.
"""

from __future__ import annotations

import numpy as np
import torch

from srgan_st_tpu_torch.ops.pairwise import batch_pairwise_distance


@torch.no_grad()
def f64_scores(p1, p2, bank, alpha: float = 1.0, beta: float = 1.0,
               dist_norm: str = "l2") -> torch.Tensor:
    """The (B, N, M) selection scores in float64."""
    bank = bank.double()
    return (alpha * batch_pairwise_distance(p1.double(), bank, dist_norm)
            + beta * batch_pairwise_distance(p2.double(), bank, dist_norm))


def near_tie_agrees(idx, ref, scores, rtol: float = 1e-6) -> torch.Tensor:
    """Per row: idx equals ref, or its f64 score is within rtol of the f64
    minimum (a near tie that f32 rounding may split either way)."""
    idx, ref = idx.long(), ref.long()
    chosen = torch.gather(scores, 2, idx[..., None])[..., 0]
    best = scores.min(-1).values
    return (idx == ref) | (chosen - best <= rtol * best.abs().clamp(min=1e-30))


def first_occurrence_holds(idx, scores, m_half: int, rtol: float = 1e-6) -> bool:
    """On a bank whose rows m_half.. copy rows 0..: no index points into the
    copy (equal scores go to the first occurrence), and every row whose f64
    minimum over the distinct rows is not a near tie (the runner-up more
    than rtol above it) selects the f64 argmin."""
    if not bool((idx < m_half).all()):
        return False
    top2 = torch.topk(scores[..., :m_half], 2, dim=-1, largest=False)
    best, second = top2.values[..., 0], top2.values[..., 1]
    clear = second - best > rtol * best.abs().clamp(min=1e-30)
    return bool((idx.long() == top2.indices[..., 0])[clear].all())


def near_tie_bank(rng: np.random.Generator, b: int, n: int, d: int = 27,
                  dtype=torch.bfloat16):
    """Patches p (p1 = p2) and a bank of 2n rows holding, for each patch,
    two rows whose exact scores differ by 2 * 2^-18 while |p|^2 is ~1,300:
    the first d - 7 features 4 or 8, six of the rest 1 and the last 0.25
    (all exact in bf16); one row adds 2^-7 to feature d - 7, the other 2^-7
    to feature d - 6 and 2^-9 to the last. The f32 expansion's rounding
    (~eps * 2 |p|^2), not the data, orders the two; every other row is at
    least 2 * 16 away. Returns (p1, p2, bank, the f64-best row per patch)."""
    p = torch.ones(b, n, d)
    p[..., : d - 7] = torch.from_numpy(rng.choice([4.0, 8.0], (b, n, d - 7)).astype(np.float32))
    p[..., -1] = 0.25
    near, nearer = p.clone(), p.clone()
    nearer[..., d - 7] += 2.0 ** -7
    near[..., d - 6] += 2.0 ** -7
    near[..., -1] += 2.0 ** -9
    perm = torch.from_numpy(rng.permutation(2 * n))
    bank = torch.cat([nearer, near], dim=1)[:, perm]
    best = torch.argsort(perm)[:n]  # where each patch's `nearer` row went
    return p.to(dtype), p.to(dtype), bank.to(dtype), best.expand(b, n).contiguous()


@torch.no_grad()
def trunk_backward_f64(dy, xs, a1s, a2s, stats, w1s, w2s, g1s, b1s, g2s, als, eps):
    """The packed trunk's backward (packed_trunk._reference_backward) on the
    same residuals, evaluated in float64 with no intermediate rounding: the
    yardstick against which a kernel and the plain version each have an
    error. Returns (dx, dw1, dw2, dg1, db1, dg2, db2, dal) in f64 and, last,
    each block's sum of |dh * pre| over the PReLU's negative side: the scale
    of the rounding error of dal, a signed sum that can cancel."""
    import torch.nn.functional as F

    def conv(x, w):
        return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1)

    def wgrad(src, d):
        _, h, w, _ = src.shape
        sp = F.pad(src, (0, 0, 1, 1, 1, 1))
        return torch.stack([torch.stack([
            torch.einsum("bhwi,bhwo->io", sp[:, ky:ky + h, kx:kx + w], d)
            for kx in range(3)]) for ky in range(3)])

    def bn_bwd(d, a, m, inv, gamma, nelem):
        xhat = (a - m) * inv
        dbeta, dgamma = d.sum((0, 1, 2)), (d * xhat).sum((0, 1, 2))
        return (gamma * inv) * (d - dbeta / nelem - xhat * (dgamma / nelem)), dgamma, dbeta

    f = lambda t: t.double()  # noqa: E731
    xs, a1s, a2s, stats = f(xs), f(a1s), f(a2s), f(stats)
    w1s, w2s, g1s, b1s, g2s, als = map(f, (w1s, w2s, g1s, b1s, g2s, als))
    n, b, h, w, _ = xs.shape
    nelem = b * h * w
    flip = lambda wt: wt.flip((0, 1)).transpose(2, 3)  # noqa: E731
    g = f(dy)
    grads = [[None] * n for _ in range(8)]
    for j in reversed(range(n)):
        m1, v1, m2, v2 = stats[j]
        inv1, inv2 = torch.rsqrt(v1 + eps), torch.rsqrt(v2 + eps)
        da2, dg2, db2 = bn_bwd(g, a2s[j], m2, inv2, g2s[j], nelem)
        dh = conv(da2, flip(w2s[j]))
        pre = (a1s[j] - m1) * inv1 * g1s[j] + b1s[j]
        neg = pre < 0
        hval = torch.where(neg, als[j] * pre, pre)
        dal = torch.where(neg, dh * pre, 0.0).sum()
        dpre = torch.where(neg, dh * als[j], dh)
        da1, dg1, db1 = bn_bwd(dpre, a1s[j], m1, inv1, g1s[j], nelem)
        g = g + conv(da1, flip(w1s[j]))
        dal_abs = torch.where(neg, (dh * pre).abs(), 0.0).sum()
        for k, val in enumerate((wgrad(xs[j], da1), wgrad(hval, da2), dg1, db1, dg2, db2,
                                 dal, dal_abs)):
            grads[k][j] = val
    return (g, *(torch.stack(gk) for gk in grads))


def dal_gate_ratio(kernel_dal, plain_dal, dal64, dal_abs) -> float:
    """The slope gradients' gate, as a ratio that holds at <= 1: each
    block's |kernel - f64| within 2x the plain version's worst error rate
    over the call's blocks, the rate being |plain - f64| over the block's
    sum of |terms| (trunk_backward_f64). A rate, not an error over
    max|dal|: dal sums ~B*H*W*C signed products, and where that sum cancels
    one draw's plain error can be far below its rounding's scale."""
    k, p = kernel_dal.double(), plain_dal.double()
    scale = dal_abs.clamp(min=1e-300)
    rate = float(((p - dal64).abs() / scale).max())
    return float(((k - dal64).abs() / scale).max()) / (2 * rate) if rate > 0 else float("inf")
