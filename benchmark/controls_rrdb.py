"""The readings that set the RRDB cell's limits (not run by the
benchmark's own runs): for each seed, at the cell's own size, in one
process, a short window of `--frames` frames of the cell's chain, and
  program   the program's frames against the reference (the lower reading);
  control   the float8 (e4m3) reference on the same inputs;
  altered   the program's frames with a 64 x 64 block of each output set
            to 0 where it is produced.
The clamped share of the program's frames comes with "program". A fault
planted in a scratch copy of the program reads as that copy's "program".
One JSON line a seed and reading, then the largest and the smallest of
each number by reading.

    python3 benchmark/controls_rrdb.py --workload CELL --seeds 1,2,3 [--what W,...]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import compare, harness  # noqa: E402
from benchmark.reference.precision import fp8  # noqa: E402

WHAT = ("program", "control", "altered")


def readings(ctx, what, frames: int) -> dict:
    import torch

    drv = harness.driver(ctx)
    ctx.traffic = dict(ctx.traffic, sample_below=ctx.traffic["warm_frames"] + frames,
                       sample_frames=frames)
    s = drv.Session(ctx)
    kept: dict = {}
    with torch.inference_mode():
        for _ in range(s.mix["warm_frames"]):
            s.frame()
        for _ in range(frames):
            s.frame(kept)
    s.free()
    sd = {k: v.to(s.dev) for k, v in s.g_sd.items()}
    worst: dict = {}
    for x, sr in kept.values():
        ref = drv.upscale(sd, x.to(s.dev))
        got = {}
        if "program" in what:
            got["program"] = sr.to(s.dev)
        if "control" in what:
            got["control"] = drv.upscale(sd, x.to(s.dev), fp8)
        if "altered" in what:
            got["altered"] = sr.to(s.dev).clone()
            got["altered"][:, :64, :64] = 0.0
        for name, out in got.items():
            rms, big = compare.frame_gaps(out, ref)
            w = worst.setdefault(name, {"frame_rms_gap": 0.0, "frame_max_gap": 0.0})
            w["frame_rms_gap"], w["frame_max_gap"] = (max(w["frame_rms_gap"], rms),
                                                      max(w["frame_max_gap"], big))
        del ref, got
    if "program" in worst:
        worst["program"]["clamped_share"] = drv.clamped_share(kept)
    return worst


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--what", default=",".join(WHAT), help="comma-separated readings")
    p.add_argument("--frames", type=int, default=8, help="frames compared a seed")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    largest: dict = {}
    smallest: dict = {}
    for seed in (int(x) for x in args.seeds.split(",")):
        ctx = harness.load_ctx(args.workload, seed, 0.0, False, args.device, time.perf_counter())
        if ctx.device == "cuda":
            harness.require_cards(ctx.workload["chips"])
        t = time.perf_counter()
        for name, numbers in readings(ctx, args.what.split(","), args.frames).items():
            print(json.dumps({"seed": seed, "reading": name, **numbers,
                              "seconds": time.perf_counter() - t}), flush=True)
            for k, v in numbers.items():
                big, small = largest.setdefault(name, {}), smallest.setdefault(name, {})
                big[k], small[k] = max(v, big.get(k, v)), min(v, small.get(k, v))
    print(json.dumps({"workload": args.workload, "largest": largest, "smallest": smallest,
                      "card": harness.card_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
