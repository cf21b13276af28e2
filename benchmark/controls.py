"""The readings that set a cell's limits (not run by the benchmark's own
runs): for each seed, the program's sound reading and those of the
control and of the planted faults, at the cell's own size, in one process.

    python3 benchmark/controls.py --workload CELL --seeds 1,2,3 [--what W,...]

Training cells (no window: the first steps are what is compared):
  program     the program's first steps against the reference (the lower reading);
  control     the reference in float8 (reference/precision.py: e4m3
              operands, e5m2 gradients) in the program's place, against the
              float32 reference;
  half_batch  the reference on the first half of each batch in the
              program's place (half the batch left out, the mean over the rest);
  unchanged   a step that leaves the state as it was: the reference's losses
              at the initial weights, no first moment, no change;
  bf16        a witness, not a control: the reference with its operands
              rounded to bfloat16, the configuration's own precision;
  wgrad_x4    a fault confined to a few leaves: the reference with the
              weight gradient of every 64 x 64 3 x 3 convolution (the
              trunk's, K5's wgrad tiles, and their like) times 4.
Serving cells (a short window of `--frames` frames at the cell's load):
  program     the program's sampled frames against the reference;
  control     the float8 (e4m3) reference on the same inputs;
  altered     the program's frames with a 64 x 64 block of each output set
              to 0 where it is produced.
One JSON line a seed and reading, then the largest and the smallest of
each number by reading. Runs on the card (or with --device cpu, at whatever size the
configuration gives).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import compare, harness  # noqa: E402
from benchmark.reference.precision import bf16, fp8  # noqa: E402

TRAIN_WHAT = ("program", "control", "half_batch", "unchanged", "wgrad_x4", "bf16")


def wgrad_x4(x, role: str):
    """A `quant` that leaves the forward as it is and multiplies the
    gradient of each 64 x 64 3 x 3 convolution's weight by 4."""
    import torch

    class _Times4(torch.autograd.Function):
        @staticmethod
        def forward(ctx, w):
            return w.view_as(w)

        @staticmethod
        def backward(ctx, g):
            return 4 * g

    if role == "weight" and tuple(x.shape) == (64, 64, 3, 3):
        return _Times4.apply(x)
    return x
SERVE_WHAT = ("program", "control", "altered")


def train_readings(ctx, what) -> dict:
    """{reading: (numbers, where)} of one seed."""
    drv = harness.driver(ctx)
    s = drv.Session(ctx)
    prog = s.first_steps()
    first = s.free()
    ref = s.reference(first)
    out = {}
    if "program" in what:
        out["program"] = compare.train_readings(prog, ref, s.init)
    if "control" in what:
        out["control"] = compare.train_readings(s.reference(first, fp8), ref, s.init)
    if "wgrad_x4" in what:
        out["wgrad_x4"] = compare.train_readings(s.reference(first, wgrad_x4), ref, s.init)
    if "bf16" in what:
        out["bf16"] = compare.train_readings(s.reference(first, bf16), ref, s.init)
    if "half_batch" in what:
        half = s.reference([b[: len(b) // 2] for b in first])
        out["half_batch"] = compare.train_readings(half, ref, s.init)
    if "unchanged" in what:
        frozen = dict(s.cfg, g_adam=dict(s.cfg["g_adam"], lr=0.0),
                      d_adam=dict(s.cfg["d_adam"], lr=0.0))
        s.cfg, cfg = frozen, s.cfg
        still = s.reference(first)
        s.cfg = cfg
        for net in ("g", "d"):
            if f"{net}_grad" in still:
                still[f"{net}_grad"] = {k: 0 * v for k, v in still[f"{net}_grad"].items()}
                still[f"{net}_params"] = s.init[net]
        still["loss"] = [{k: v for k, v in loss.items() if k != "D" or i == 0}
                         for i, loss in enumerate(still["loss"])]
        out["unchanged"] = compare.train_readings(still, ref, s.init)
    return out


def serve_readings(ctx, what, frames: int) -> dict:
    import torch

    drv = harness.driver(ctx)
    ctx.traffic = dict(ctx.traffic, sample_below=ctx.traffic["warm_frames"] + frames)
    s = drv.Session(ctx)
    kept: dict = {}
    with torch.inference_mode():
        for _ in range(s.mix["warm_frames"]):
            s.frame()
        for _ in range(frames):
            s.frame(kept)
    s.free()
    out = {}
    if "program" in what:
        out["program"] = (drv.frame_readings(s.g_sd, kept, s.dev), {})
    if "control" in what:
        control = {i: (x, drv_upscale(s, x, fp8)) for i, (x, _) in kept.items()}
        out["control"] = (drv.frame_readings(s.g_sd, control, s.dev), {})
    if "altered" in what:
        altered = {}
        for i, (x, sr) in kept.items():
            sr = sr.clone()
            sr[:, :64, :64] = 0.0
            altered[i] = (x, sr)
        out["altered"] = (drv.frame_readings(s.g_sd, altered, s.dev), {})
    return out


def drv_upscale(s, x, quant):
    from benchmark.reference.serve import upscale

    return upscale({k: v.to(s.dev) for k, v in s.g_sd.items()}, x.to(s.dev), quant)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--what", default=None, help="comma-separated readings (default: all)")
    p.add_argument("--frames", type=int, default=40, help="frames of a serving cell's window")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[], metavar="KEY=JSON",
                   help="override a configuration key (a second witness, e.g. trunk_mode)")
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    largest: dict = {}
    smallest: dict = {}
    for seed in (int(x) for x in args.seeds.split(",")):
        ctx = harness.load_ctx(args.workload, seed, 0.0, False, args.device, time.perf_counter())
        for kv in args.set:
            key, value = kv.split("=", 1)
            ctx.config = dict(ctx.config, **{key: json.loads(value)})
        serving = ctx.traffic["driver"] == "serve_frames"
        what = args.what.split(",") if args.what else (SERVE_WHAT if serving else TRAIN_WHAT)
        if ctx.device == "cuda":
            harness.require_cards(ctx.workload["chips"])
        t = time.perf_counter()
        res = serve_readings(ctx, what, args.frames) if serving else train_readings(ctx, what)
        for name, (numbers, where) in res.items():
            print(json.dumps({"seed": seed, "reading": name, **numbers, "where": where,
                              "seconds": time.perf_counter() - t}), flush=True)
            for k, v in numbers.items():
                big, small = largest.setdefault(name, {}), smallest.setdefault(name, {})
                big[k], small[k] = max(v, big.get(k, v)), min(v, small.get(k, v))
    print(json.dumps({"workload": args.workload, "largest": largest, "smallest": smallest,
                      "card": harness.card_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
