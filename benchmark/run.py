"""Benchmark of the PyTorch/CUDA port (srgan_st_tpu_torch) on one card.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs cell CELL (benchmark/workloads/CELL.json) from the root of a
checkout: set-up from the seed, a window of S seconds, the check of what
the window produced against benchmark/reference, then one JSON line on
stdout: correct, attempted, failed, metrics (the end-to-end metrics, or
with --trace 1 the per-layer ones), device, with --trace 1 breakdown,
and last the checks, each number beside its limit (also the last lines of
stderr). Without the CUDA devices the cell asks for it exits 4 and prints
no result; with JAX or the JAX package loaded, 5.
"""

import time

T0 = time.perf_counter()  # noqa: E402 -- set-up is timed from here

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    harness.set_cache_dirs()
    ctx = harness.load_ctx(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    harness.require_cards(ctx.workload["chips"])
    import torch

    out = harness.driver(ctx).run(ctx)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": ctx.workload["chips"], "memory_peak_bytes": out["peak"]}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"]}
    if args.trace:
        record = out["record"]
        result["metrics"] = harness.per_layer(record)
        device.update(busy_s=record["busy_s"], window_s=record["window_s"])
        result["breakdown"] = {"device_ops": record["device_ops"],
                               "idle_gaps": record["idle_gaps"]}
    else:
        result["metrics"] = out["metrics"]
    result["device"] = device
    result["card"] = harness.card_record()
    result["detail"] = out["detail"]
    result["checks"] = out["checks"]
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main())
