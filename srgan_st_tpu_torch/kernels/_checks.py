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
