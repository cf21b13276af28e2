"""What the full-width trajectory window (srgan_st_tpu_torch/tools/trajectory.py
`--full`) can see: its run-to-run spread, and faults planted in the kernels
it holds.

    python -m srgan_st_tpu_torch.tools.trajectory_probe [--recipes st flagship gram-vgg]
        [--faults] [--goldens DIR] [--device cuda|cpu]

Spread: per recipe, in one process, the f32 plain reference (TF32 off,
eager steps) and the shipping bf16 chunk run twice each under torch's
default cuDNN switches, then twice each with cuDNN deterministic (and its
benchmark off), the switches of trajectory.py's reference (`reference_run`).
Each second run is compared with its first (the window's five max
rel-errs, whether the traces are equal bit for bit, and the warmup-update
cosines of trajectory.py's `update_cos`), and each shipping run with the
first reference run. The shipping runs all start their GAN window from the
first reference run's post-warmup G.

--faults: flagship's shipping run (a) with K5's outputs changed after its
launch, and its fused run (b) with K6 given the wrong weights, each held
to `reference_run` at trajectory.py's bf16 gates and its UPDATE_COS_GATE:
  k5-dx-zero     K5's input gradient zeroed (nothing flows past the trunk
                 into the head conv but the global skip);
  k5-dx-half     K5's input gradient halved;
  k5-wgrad-x4    K5's conv weight gradients times 4 (a rescale, which
                 Adam's update divides out but for its eps);
  k5-wgrad-zero  every parameter gradient of K5 zeroed (the trunk frozen);
  k6-swapped     K6 run with each block's two conv weights swapped.
The patch wraps the module's launch function at run time, so graph
captures take it in too; each record gives the calls that went through the
patch, and the gates that caught the fault.

Prints one JSON line per comparison, each with the card's name and power
limit. Runs on CUDA unless `--device cpu`; without a GPU it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys

import numpy as np
import torch

from srgan_st_tpu_torch.eval.export import deterministic_cudnn
from srgan_st_tpu_torch.tools import trajectory


def _equal(a: trajectory.Run, b: trajectory.Run) -> bool:
    return all(np.array_equal(a.losses[k], b.losses[k], equal_nan=True) for k in a.losses)


def _reference(data, recipe, dev) -> trajectory.Run:
    """The reference run under the cuDNN switches in force (trajectory.py's
    own, `reference_run`, makes them deterministic)."""
    with trajectory._tf32_off():
        return trajectory.replay(data, recipe, dev, "float32", "step", plain=True)


def _cos(run, ref, data) -> dict:
    return trajectory.update_cos(run, ref, trajectory.unpack(data, "g0"))


def _shipping(data, recipe, dev, trunk=None) -> trajectory.Run:
    return trajectory.replay(data, recipe, dev, "bfloat16", "chunk", trunk=trunk)


def spread(recipes, dev, golden_dir: str, card: dict) -> list[dict]:
    """The spread records (module docstring)."""
    base, out = trajectory.full_data(golden_dir), []
    for recipe in recipes:
        data = dict(base)
        ref0 = _reference(data, recipe, dev)
        data.update({f"g_warm/{k}": v.numpy() for k, v in ref0.g_warm.items()})
        for det in (False, True):
            with deterministic_cudnn() if det else contextlib.nullcontext():
                first = _reference(data, recipe, dev) if det else ref0
                refs = (first, _reference(data, recipe, dev))
                ships = (_shipping(data, recipe, dev), _shipping(data, recipe, dev))
            out.append({
                "probe": "spread", "recipe": recipe, "cudnn_deterministic": det,
                "device": card,
                "reference_vs_reference": trajectory.rel_errors(refs[1].losses, refs[0].losses),
                "reference_repeats_bits": _equal(*refs),
                "shipping_vs_shipping": trajectory.rel_errors(ships[1].losses, ships[0].losses),
                "shipping_repeats_bits": _equal(*ships),
                "shipping_vs_reference": [trajectory.rel_errors(s.losses, ref0.losses)
                                          for s in ships],
                "warm_update_cos": {
                    "reference_vs_reference": _cos(refs[1], refs[0], data),
                    "shipping_vs_reference": [_cos(s, ref0, data) for s in ships]}})
            del refs, ships
        del ref0
    return out


def _k5(change):
    """A fault of K5: packed_trunk._launch_bwd launches it, then `change`
    alters its outputs (dx, dw1, dw2, dg1, db1, dg2, db2, dal) in place."""
    def wrap(orig):
        def launch(*args, **kwargs):
            outs = orig(*args, **kwargs)
            change(outs)
            return outs
        return launch
    return None, "packed_trunk", "_launch_bwd", wrap


def _k6_swapped(orig):
    """fused_trunk._launch_fwd with each block's two conv weights swapped."""
    return lambda x, w1s, w2s, *args, **kwargs: orig(x, w2s, w1s, *args, **kwargs)


# name: (TRUNK_MODE of the run (None: auto), kernels module, its launch
# function, the wrapper that plants the fault)
FAULTS = {
    "k5-dx-zero": _k5(lambda outs: outs[0].zero_()),
    "k5-dx-half": _k5(lambda outs: outs[0].mul_(0.5)),
    "k5-wgrad-x4": _k5(lambda outs: [t.mul_(4.0) for t in outs[1:3]]),
    "k5-wgrad-zero": _k5(lambda outs: [t.zero_() for t in outs[1:]]),
    "k6-swapped": ("fused", "fused_trunk", "_launch_fwd", _k6_swapped),
}


def faults(dev, golden_dir: str, card: dict) -> list[dict]:
    """The planted-fault records (module docstring), on flagship."""
    data = trajectory.full_data(golden_dir)
    ref = trajectory.reference_run(data, "flagship", dev)
    data.update({f"g_warm/{k}": v.numpy() for k, v in ref.g_warm.items()})
    gates, out = trajectory.GATES["bfloat16"], []
    for name, (trunk, modname, attr, wrap) in FAULTS.items():
        module = importlib.import_module("srgan_st_tpu_torch.kernels." + modname)
        orig, calls = getattr(module, attr), [0]

        def counted(*a, _f=wrap(orig), **k):
            calls[0] += 1
            return _f(*a, **k)

        setattr(module, attr, counted)
        try:
            run = _shipping(data, "flagship", dev, trunk)
        finally:
            setattr(module, attr, orig)
        if dev.type == "cuda" and not calls[0]:
            raise RuntimeError(f"{name}: the planted fault never ran")
        rels, cos = trajectory.rel_errors(run.losses, ref.losses), _cos(run, ref, data)
        out.append({"probe": "fault", "fault": name, "recipe": "flagship",
                    "trunk": trunk or "auto", "device": card, "patched_calls": calls[0],
                    "launches": run.launches, "detail": rels, "gates": gates,
                    "caught_by": [k for k, g in gates.items() if not rels[k] < g],
                    "warm_update_cos": cos,
                    "caught_by_update_cos": [k for k, c in cos.items()
                                             if not c >= trajectory.UPDATE_COS_GATE],
                    "finite": bool(np.isfinite(run.losses["warm_losses"]).all()
                                   and np.isfinite(run.losses["gan_g_losses"]).all())})
        del run
    return out


def main(argv=None) -> int:
    from srgan_st_tpu_torch.core.device import resolve_device
    from srgan_st_tpu_torch.utils.profiling import device_record

    p = argparse.ArgumentParser(prog="python -m srgan_st_tpu_torch.tools.trajectory_probe",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--recipes", nargs="*", default=["st", "flagship", "gram-vgg"],
                   choices=list(trajectory.RECIPES))
    p.add_argument("--faults", action="store_true", help="also plant the faults")
    p.add_argument("--goldens", default=os.path.join("tests", "goldens"), metavar="DIR",
                   help="the directory of the training_trajectory*.npz goldens")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="the default is the GPU; without one the probe raises")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    card = device_record(dev)
    records = spread(args.recipes, dev, args.goldens, card)
    if args.faults:
        records += faults(dev, args.goldens, card)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
