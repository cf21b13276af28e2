"""Per-op device profile of one chunk of a bench row (the port's counterpart
of tools/profile_step.py).

    python -m srgan_st_tpu_torch.tools.profile_step [config] [top_n] [with_d]
      config: headline | flagship-st | flagship-st-xla | gram-vgg
              | infer-4k (the eval forward, 960x540 -> 3840x2160, batch 1)
      with_d: "1" to run the chunk's first batch as a G + D step

Builds the row as `tools/bench.py` does (BENCH_DTYPE, BENCH_TRUNK,
BENCH_CONV3 alike), runs two chunks of k = 8 batches of 16 (the graph
captures fall inside them; for infer-4k, 14 frames of the feedback chain),
then profiles one more chunk (k frames) with torch.profiler
(`utils/profiling.py` `profile_once`): the device's busy and window ms and
idle share, its kernels and copies, and the top ops by span and
start-to-start time. Beside them, the launches of the hand-written kernels
in that chunk (`kernels.launch_counts()`, the replayed part
`graph_launch_counts()`), and the card with its power limit. Prints a
table, then one JSON line. Runs on the card only (the profile reads CUDA
activity); without a GPU it raises.
"""

from __future__ import annotations

import json
import sys

import torch


def _profiled(one_chunk, k: int, top: int, dev) -> dict:
    """profile_once over one_chunk() with the kernel counts of the profiled
    call alone (profile_once runs it once before)."""
    from srgan_st_tpu_torch import kernels
    from srgan_st_tpu_torch.utils.profiling import device_record, profile_once

    def counted():
        kernels.reset_launch_counts()
        one_chunk()

    prof = profile_once(counted, top=top)
    return {"k": k, "profile": prof, "ms_per_step": prof["device_busy_ms"] / k,
            "launches": kernels.launch_counts(),
            "graph_launches": kernels.graph_launch_counts(), "device": device_record(dev)}


def run_and_trace(name: str, k: int = 8, with_d: bool = False, top: int = 30,
                  device=None) -> dict:
    """One chunk of k batches of a training row, replayed, profiled."""
    from srgan_st_tpu_torch.tools.bench import (
        apply_bench_knobs, bench_chunk, build_gan, make_config,
    )
    from srgan_st_tpu_torch.train.utils import setup_run

    config = make_config(name)
    apply_bench_knobs(config)
    config.DATA.BATCH_SIZE = 16
    dev, mesh = setup_run(config, device)
    state, chunk_step, _ = build_gan(config, dev, mesh)
    chunk = bench_chunk(config, dev, mesh, k)
    for _ in range(2):
        chunk_step(state, chunk, with_d)
    rec = _profiled(lambda: chunk_step(state, chunk, with_d), k, top, dev)
    return {"config": name, "with_d": with_d, **rec}


def run_and_trace_infer(k: int = 8, top: int = 30, device=None) -> dict:
    """k frames of bench.py's infer-4k chain, profiled."""
    from srgan_st_tpu_torch.tools.bench import infer_setup

    step, lr, _, dev, _ = infer_setup(device)
    frame = {"x": lr, "n": 0}

    def frames(count: int) -> None:
        for _ in range(count):
            frame["x"] = step(frame["x"], frame["n"])
            frame["n"] += 1

    with torch.inference_mode():
        frames(14)
        rec = _profiled(lambda: frames(k), k, top, dev)
    return {"config": "infer-4k", "with_d": False, **rec}


def main(argv=None) -> dict:
    from srgan_st_tpu_torch.core.device import resolve_device

    argv = sys.argv[1:] if argv is None else argv
    name = argv[0] if argv else "headline"
    top = int(argv[1]) if len(argv) > 1 else 30
    with_d = len(argv) > 2 and argv[2] == "1"
    resolve_device(None)  # the card, or raise
    rec = run_and_trace_infer(top=top) if name == "infer-4k" else \
        run_and_trace(name, with_d=with_d, top=top)
    prof, k = rec["profile"], rec["k"]
    dev = rec["device"]
    print(f"config={name} with_d={with_d}  {dev['name']}, {dev['power_limit_w']} W")
    print(f"device busy {prof['device_busy_ms']:.3f} ms of a {prof['device_window_ms']:.3f} ms "
          f"window ({rec['ms_per_step']:.3f} ms/step x {k}), idle share "
          f"{prof['idle_share']:.4f}; {prof['kernels']} kernels, {prof['copies']} copies\n")
    print(f"{'span ms/step':>12}  {'s2s ms/step':>11}  {'count':>5}  op")
    for op, span, s2s, count in prof["top_ms"]:
        print(f"{span / k:12.4f}  {s2s / k:11.4f}  {count:5d}  {op}")
    launched = {n: c for n, c in rec["launches"].items() if c}
    print(f"\nhand-written kernel launches: {launched} "
          f"(replayed: { {n: c for n, c in rec['graph_launches'].items() if c} })")
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
