"""Checks of a buddy selection (kernels/buddy_select.py) against float64
ground truth: the one copy of the gate rules that the CPU tests, the GPU
tests and chip_smoke.py hold the selection to. Nothing on the training
path calls them.
"""

from __future__ import annotations

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
