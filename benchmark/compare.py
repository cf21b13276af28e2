"""The numbers that decide `correct`, each a gap between what the timed
path produced and what `benchmark/reference` computes from the same
inputs. A cell compares those its workload file gives a limit.

Training (the first three steps of the state the window then drives):
  loss_gap           the largest |L_prog - L_ref| / |L_ref| over each step's
                     G loss and the D loss of the D update;
  loss_gap_first     the same of the first step alone, whose losses both
                     sides compute from the same weights;
  grad_gap_median    for the first gradient as the optimizer got it (its
                     first moment after one step over 1 - beta1), each
                     leaf's | |g_prog| - |g_ref| | over the larger of |g_ref|
                     and the median leaf's |g_ref|, the median over the
                     leaves (G and D each, the larger);
  change_gap_median  the same of the parameters' change over the three
                     steps, leaving out leaves whose first reference
                     gradient is under a thousandth of the median leaf's
                     (they move by round-off);
  stats_err          |dv_prog - dv_ref| / |dv_ref| of the change of every
                     BatchNorm's running variance over the three steps, all
                     layers of a network together (G and D each, the larger):
                     the second moments of the activations the forwards saw;
  stats_err_first    the same after the first step alone: its forwards
                     only, from the same weights on both sides.
  grad_gap_tensor, change_gap_tensor   the worst leaf instead of the median
                     one, over the leaves of more than one element: a fault
                     in a few leaves (one kernel's weight gradients) shows
                     here and not in the median;
  grad_gap, change_gap   the worst leaf of all; reported, not compared: the
                     worst is a PReLU slope, one number summed over a whole
                     activation, which reads at rounding alone what it reads
                     here (PERF.md, section 2).
Serving (sampled frames of the window):
  frame_rms_gap, frame_max_gap  the root-mean-square and the largest
                     |sr_prog - sr_ref| over the pixels of a frame, the worst
                     frame.
"""

from __future__ import annotations

import statistics

import torch

NOUGHT = 1e-3


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """{leaf: |prog - ref| / max(ref, median ref)} over `leaves` (default
    all of ref's)."""
    leaves = list(ref) if leaves is None else list(leaves)
    med = statistics.median(ref[k] for k in ref)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves}


def relative_error(prog: dict, ref: dict, leaves) -> float:
    """|prog - ref| / |ref| over the named leaves taken together."""
    num = sum(float((prog[k].double() - ref[k].double()).pow(2).sum()) for k in leaves)
    den = sum(float(ref[k].double().pow(2).sum()) for k in leaves)
    return (num / max(den, 1e-300)) ** 0.5


def train_readings(prog: dict, ref: dict, init: dict) -> tuple[dict, dict]:
    """prog and ref: {"loss": [{"G", "D"?}...], "g_grad", "g_params",
    "g_stats", and "d_..." in "gan"}; init: the parameters ("g", "d") and
    running statistics ("g_stats", "d_stats") both started from. Returns
    (readings, where: the worst leaf of each)."""
    readings = dict.fromkeys(("loss_gap", "grad_gap", "grad_gap_median", "grad_gap_tensor",
                              "change_gap", "change_gap_median", "change_gap_tensor",
                              "stats_err", "loss_gap_first", "stats_err_first"), 0.0)
    where = {}
    for step, (p, r) in enumerate(zip(prog["loss"], ref["loss"], strict=True)):
        for key, value in r.items():
            gap = abs(p[key] - value) / max(abs(value), 1e-30)
            readings["loss_gap"] = max(readings["loss_gap"], gap)
            if step == 0:
                readings["loss_gap_first"] = max(readings["loss_gap_first"], gap)

    def worst(name, gaps, net, sizes):
        for key, subset in ((name, gaps), (f"{name}_tensor",
                                           {k: v for k, v in gaps.items() if sizes[k] > 1})):
            leaf = max(subset, key=subset.get)
            if subset[leaf] >= readings[key]:
                readings[key], where[key] = subset[leaf], f"{net}:{leaf}"
        readings[f"{name}_median"] = max(readings[f"{name}_median"],
                                         statistics.median(gaps.values()))

    for net in ("g", "d"):
        if f"{net}_grad" not in ref:
            continue
        rg = _norms(ref[f"{net}_grad"])
        sizes = {k: v.numel() for k, v in ref[f"{net}_grad"].items()}
        worst("grad_gap", leaf_gaps(_norms(prog[f"{net}_grad"]), rg), net, sizes)
        med = statistics.median(rg.values())
        moving = [k for k in rg if rg[k] >= NOUGHT * med]
        start = init[net]
        change = {side: _norms({k: out[f"{net}_params"][k] - start[k] for k in rg})
                  for side, out in (("prog", prog), ("ref", ref))}
        worst("change_gap", leaf_gaps(change["prog"], change["ref"], moving), net, sizes)
        where[f"{net}_left_out"] = sorted(set(rg) - set(moving))
        s0 = init[f"{net}_stats"]
        var = [k for k in s0 if k.endswith("running_var")]
        for name, stats in (("stats_err", f"{net}_stats"), ("stats_err_first",
                                                           f"{net}_stats_first")):
            readings[name] = max(readings[name], relative_error(
                {k: prog[stats][k] - s0[k] for k in var},
                {k: ref[stats][k] - s0[k] for k in var}, var))
    return readings, where


@torch.no_grad()
def frame_gaps(sr_prog: torch.Tensor, sr_ref: torch.Tensor) -> tuple[float, float]:
    d = (sr_prog.double() - sr_ref.double()).abs()
    return float(d.pow(2).mean().sqrt()), float(d.max())
