"""Per-op device profile of one chunk of a row of the JAX package's bench.py
(the port's counterpart of tools/profile_step.py), and the program's regions
in it.

    python -m srgan_st_tpu_torch.tools.profile_step [config] [top_n] [with_d]
        [--k K] [--trace-dir DIR] [--spans-cost]
      config: headline | flagship-st | flagship-st-xla | gram-vgg
              | warmup (headline's G on its warmup criteria, the warmup
                chunk step)
              | infer-4k (the eval forward, 960x540 -> 3840x2160, batch 1)
      with_d: "1" to run the chunk's first batch as a G + D step
      --k: batches a chunk (frames for infer-4k), default 8
      --trace-dir: profile the chunk through `trace_context` instead, write
              its Chrome trace to DIR/trace.json (the program's spans in it),
              and print besides the device ms under each region, the idle
              time by the span the host was in, the host ms of `train.batch`
              (`serve.frame`) and of the spans it holds, and the readings
      --spans-cost: instead of the profiles, the seconds of traced chunks
              with the program's spans and without them (`spans_off`), 3
              of each, alternating

Builds the row with bench.py's criteria (`make_config`), BENCH_DTYPE
(default bfloat16), BENCH_TRUNK (TPU.TRUNK_MODE; unset: the port's auto),
BENCH_CONV3 (TPU.CONV3_INNER) and, for gram-vgg, BENCH_VGG_PAIR (0|1, the
frozen pair), on bench.py's seeded uint8 chunk, runs two chunks of k
batches of 16 (the graph captures fall inside them; for infer-4k, 14
frames of the feedback chain), then
profiles one more chunk (k frames) with torch.profiler
(`utils/profiling.py` `profile_once`, or `device_summary` of the
--trace-dir profile): the device's busy and window ms and
idle share, its kernels and copies, and the top ops by span and
start-to-start time. Beside them, the launches of the hand-written kernels
in that chunk (`kernels.launch_counts()`, the replayed part
`graph_launch_counts()`), and the card with its power limit. Prints a
table, then one JSON line (with --trace-dir, the regions' record in it).
Runs on the card only (the profile reads CUDA activity); without a GPU it
raises. `headline 30 1 --k 100`, `warmup 30 0 --k 100` and
`infer-4k 30 0 --k 16` are the benchmark's three cells' units. One profile
a process: a later profile in the same process loses device events
(Kineto), which leaves replays short of their graphs' nodes.

The regions: `program_trace` labels each device op with the region path
of the program span that launched it (an eager op, by the correlation of
the op with its launch call), or with its replay's launch span and its
graph node's region from the capture (`StepGraphs.node_regions()`, in
launch order). A batch is a replay (`StepGraphs.graph_counts()`), a frame
a `serve.frame` span. The readings:

  host_ms_per_batch      host time of `train.batch` a batch
  optimizer_ms_per_batch device time under `optim.*` a batch
  losses_ms_per_batch    device time under `loss.*` and not under
                         `d.forward` a batch (the adversarial term's D
                         forward is D's, read apart as
                         loss_d_forward_ms_per_batch)
  k4_ms_per_launch, k5_ms_per_launch
                         device time under `kernel.packed_trunk_fwd` /
                         `_bwd` per launch of it: the trunk's bound over
                         it is its roofline
  host_ms_per_frame      host time of `serve.frame` a frame
  trunk_ms_per_frame     device time under `g.trunk` a frame
  eval_trunk_ms_per_launch
                         device time under `kernel.eval_trunk` per call of
                         kernel E (the eval trunk, one call a frame)
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from srgan_st_tpu_torch.utils.profiling import covered, union

# The first words of the program's span names: what a trace's other user
# annotations (torch's "Optimizer.step#...", a caller's own) do not start with.
SPAN_PREFIXES = ("train.", "graph.", "step.", "g.", "loss.", "optim.", "d.", "kernel.",
                 "serve.")
OUTSIDE = "(outside the program)"
INFER_LR = (540, 960)


def make_config(name: str):
    """The Config of a training row, with bench.py's criteria, specs and
    weights (bench.py:77-101)."""
    from srgan_st_tpu_torch.core.config import Config

    config = Config()
    config.add_g_criterion("Pixel", {"kind": "pixel"}, 1.0)
    if name in ("flagship-st", "flagship-st-xla"):
        config.add_g_criterion(
            "PatchwiseST", {"kind": "patchwise_st", "pallas": name == "flagship-st"}, 100.0)
        config.add_g_criterion("ContentDiscriminator", {"kind": "content_disc"}, 2000.0)
    elif name == "gram-vgg":
        config.add_g_criterion("Gram", {"kind": "gram"}, 500.0)
        spec = {"kind": "content_vgg", "allow_random_init": True}
        if os.environ.get("BENCH_VGG_PAIR"):
            spec["pair"] = os.environ["BENCH_VGG_PAIR"] == "1"
        config.add_g_criterion("ContentVGG", spec, 1.0)
    elif name != "headline":
        raise ValueError(name)
    return config


def apply_bench_knobs(config) -> str:
    """BENCH_DTYPE, BENCH_TRUNK and BENCH_CONV3 into `config`; returns the
    compute dtype's name."""
    dtype = os.environ.get("BENCH_DTYPE", "bfloat16")
    config.TPU.COMPUTE_DTYPE = dtype
    config.TPU.TRUNK_MODE = os.environ.get("BENCH_TRUNK") or None
    c3 = os.environ.get("BENCH_CONV3")
    if c3:
        config.TPU.CONV3_INNER = int(c3) if c3.isdigit() else c3
    return dtype


def build_gan(config, dev, mesh):
    """(state, chunk_step, graphs): the seeded GAN state of `config` on
    `dev` and its chunk step, replaying CUDA graphs where the run takes
    them (train/graphs.py step_graphs; None on the CPU)."""
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.graphs import step_graphs
    from srgan_st_tpu_torch.train.steps import create_gan_state, make_gan_chunk_step

    state = create_gan_state(config, Generator.from_config(config, group=mesh),
                             Discriminator.from_config(config, group=mesh), 1000, dev)
    graphs = step_graphs(config, dev, mesh)
    return state, make_gan_chunk_step(config, build_criterions(config), mesh, graphs), graphs


def bench_chunk(config, dev, mesh, k: int | None = None) -> torch.Tensor:
    """This process's share of bench.py's seeded uint8 chunk (k batches of
    DATA.BATCH_SIZE, default k = D_UPDATE_INTERVAL) on `dev`, copied there
    once: the chunk step takes its batches as views of it."""
    k = k or config.SOLVER.D_UPDATE_INTERVAL
    s = config.DATA.GT_IMAGE_SIZE
    chunk = np.random.default_rng(0).integers(0, 256, (k, config.DATA.BATCH_SIZE, s, s, 3),
                                              np.uint8)
    local = np.ascontiguousarray(chunk[:, mesh.batch_slice(config.DATA.BATCH_SIZE)])
    return torch.from_numpy(local).to(dev)


def next_lr(sr: torch.Tensor, x: torch.Tensor, z: torch.Tensor, i: int, s: int) -> torch.Tensor:
    """bench.py's feedback chain (bench.py:346-356): the next LR frame is
    the s x s average pool of this SR frame (every HR pixel is consumed),
    mixed with a noise frame, plus 1e-7 i (i the frame's index, in f32 as
    JAX computes it), in x's dtype."""
    b, hh, ww, c = sr.shape
    pooled = sr.reshape(b, hh // s, s, ww // s, s, c).mean((2, 4))
    return (0.5 * pooled + 0.5 * z + float(np.float32(1e-7) * np.float32(i))).to(x.dtype)


def infer_setup(device=None, lr_shape: tuple[int, int] = INFER_LR):
    """(step, lr, noise, dev, s): the eval generator of the headline config
    in BENCH_DTYPE (seeded random weights), bench.py's seeded LR frame and
    its 8 noise frames on the device, and step(x, n) -> the next frame."""
    from srgan_st_tpu_torch.core.device import resolve_device
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.models.generator import random_variables

    config = make_config("headline")
    config.TPU.COMPUTE_DTYPE = os.environ.get("BENCH_DTYPE", "bfloat16")
    dev = resolve_device(device)
    s = config.DATA.UPSCALE_FACTOR
    rng = np.random.default_rng(0)
    lr = torch.from_numpy(rng.random((1, *lr_shape, 3), np.float32)).to(dev)
    noise = torch.from_numpy(rng.random((8, 1, *lr_shape, 3), np.float32)).to(dev)
    variables = random_variables(0, channels=config.MODEL.G_N_CHANNEL,
                                 num_rcb=config.MODEL.G_N_RCB, upscale=s)
    apply_fn = make_generator_apply(config, variables, dev)

    def step(x, n: int):
        return next_lr(apply_fn(x), x, noise[n % 8], n, s)

    return step, lr, noise, dev, s


def trace_events(prof) -> tuple[list, list, list]:
    """A finished profile's device ops (start s, end s, name, correlation
    id; annotation ranges on the device timeline left out, as the
    benchmark's record does), its CUDA API calls (the same fields) and the
    program's spans (start s, end s, name, thread)."""
    from torch.autograd import DeviceType

    ops, calls, spans = [], [], []
    for e in prof.events():
        start, end, name = e.time_range.start / 1e6, e.time_range.end / 1e6, e.name
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                ops.append((start, end, name, e.id))
        elif name.startswith(SPAN_PREFIXES) and getattr(e, "is_user_annotation", True):
            spans.append((start, end, name, e.thread))
        elif name.startswith("cu"):
            calls.append((start, end, name, e.id))
    return ops, calls, spans


def _tree(spans: list) -> tuple[list, list[int], list[str]]:
    """The spans sorted by start (the longer first), each one's parent
    (the innermost span that holds it, on any thread; -1 for none) and
    region path."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    parent, path, stack = [-1] * len(spans), [""] * len(spans), []
    for j, (start, end, name, *_rest) in enumerate(spans):
        while stack and spans[stack[-1]][1] < end:  # ended, or does not hold it
            stack.pop()
        if stack:
            parent[j] = stack[-1]
            path[j] = f"{path[stack[-1]]}/{name}"
        else:
            path[j] = name
        stack.append(j)
    return spans, parent, path


def _innermost(spans: list, times: list[float]) -> list[int]:
    """For each time, the index of the innermost of `spans` (sorted as
    `_tree` sorts them) that holds it; -1 where none does."""
    out, stack, j = [-1] * len(times), [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(spans) and spans[j][0] <= t:
            while stack and spans[stack[-1]][1] < spans[j][1]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def _is_graph_launch(name: str) -> bool:
    return name.startswith(("cudaGraphLaunch", "cuGraphLaunch"))


def program_trace(ops: list, calls: list, spans: list, node_regions: dict | None = None
                  ) -> dict:
    """Device ops labelled by the program's regions (`trace_events`' three
    lists; `node_regions` {kind: the region of each activity node of its
    graph, in capture order}, `StepGraphs.node_regions()`). Returns:

      spans:     the program's spans, {name, start, end, thread, parent
                 (index or -1)}, sorted by start
      labels:    per op of `sorted(ops)`: the region path of the innermost
                 span running when its launch was called (an eager op), or
                 its replay's launch span's path and its node's region (a
                 replayed op); None where no span held the launch
      replays:   [{kind, ops, nodes}] in launch order; a replay whose op
                 count is not its graph's activity nodes' keeps only its
                 launch's path
      labelled_share: the labelled ops' busy time over all ops' busy time
      idle_by_span:   each idle gap of the window put down to the innermost
                 span on the host at its midpoint, else OUTSIDE; seconds by
                 name, summing to window - busy
      regions:   device seconds under each span name, the union of the
                 spans of the ops whose label holds it"""
    ops = sorted(ops)
    spans, parent, path = _tree(spans)
    node_regions = node_regions or {}
    launch = {c[3]: c for c in calls}
    labels: list[str | None] = [None] * len(ops)
    eager, replayed = [], {}
    for i, op in enumerate(ops):
        call = launch.get(op[3])
        if call is None:
            continue
        if _is_graph_launch(call[2]):
            replayed.setdefault(op[3], []).append(i)
        else:
            eager.append(i)
    at = _innermost(spans, [launch[ops[i][3]][0] for i in eager])
    for i, j in zip(eager, at):
        labels[i] = path[j] if j >= 0 else None
    order = sorted(replayed, key=lambda corr: launch[corr][0])
    at = _innermost(spans, [launch[corr][0] for corr in order])
    replays = []
    for corr, j in zip(order, at):
        members = replayed[corr]
        kind = spans[j][2].split(".", 2)[2] if j >= 0 and spans[j][2].startswith(
            "graph.launch.") else None
        nodes = node_regions.get(kind)
        replays.append({"kind": kind, "ops": len(members),
                        "nodes": None if nodes is None else len(nodes)})
        if j < 0:
            continue
        if nodes is not None and len(nodes) == len(members):
            for i, region in zip(members, nodes):
                labels[i] = f"{path[j]}/{region}" if region else path[j]
        else:
            for i in members:
                labels[i] = path[j]

    busy = union((s, e) for s, e, *_ in ops)
    busy_s = sum(b - a for a, b in busy)
    labelled = covered((op[0], op[1]) for op, lab in zip(ops, labels) if lab is not None)
    mids = [0.5 * (end + nxt) for (_, end), (nxt, _) in zip(busy, busy[1:])]
    idle: dict[str, float] = {}
    for (_, end), (nxt, _), j in zip(busy, busy[1:], _innermost(spans, mids)):
        name = spans[j][2] if j >= 0 else OUTSIDE
        idle[name] = idle.get(name, 0.0) + (nxt - end)
    by_name: dict[str, list] = {}
    for op, lab in zip(ops, labels):
        if lab is not None:
            for name in set(lab.split("/")):
                by_name.setdefault(name, []).append((op[0], op[1]))
    return {"spans": [{"name": s[2], "start": s[0], "end": s[1], "thread": s[3],
                       "parent": parent[j]} for j, s in enumerate(spans)],
            "labels": labels, "replays": replays,
            "labelled_share": labelled / busy_s if busy_s else None,
            "idle_by_span": idle,
            "regions": {name: covered(iv) for name, iv in sorted(by_name.items())}}


def host_children(spans: list[dict], parent: str) -> dict[str, tuple[float, float]]:
    """{name: (host seconds, self seconds)} of the spans whose parent is
    named `parent` (`program_trace`'s spans), and under `parent` itself
    that span's own: self time leaves out the spans it holds."""
    inner = [0.0] * len(spans)
    for s in spans:
        if s["parent"] >= 0:
            inner[s["parent"]] += s["end"] - s["start"]
    out: dict[str, list[float]] = {}
    for j, s in enumerate(spans):
        name = s["name"] if s["parent"] >= 0 and spans[s["parent"]]["name"] == parent else (
            parent if s["name"] == parent else None)
        if name is not None:
            total = out.setdefault(name, [0.0, 0.0])
            total[0] += s["end"] - s["start"]
            total[1] += s["end"] - s["start"] - inner[j]
    return {name: (t, own) for name, (t, own) in out.items()}


def readings(ops: list, rec: dict, units: int, launches: dict) -> dict:
    """The module docstring's readings of one profiled chunk: `ops` and
    `rec` as `program_trace` took and gave them, `units` the batches (the
    replays) or frames in it, `launches` the hand-written kernels' launches
    in it. A reading with nothing to read is left out."""
    ops = sorted(ops)
    parts = [set(lab.split("/")) if lab else set() for lab in rec["labels"]]

    def device_ms(keep) -> float | None:
        iv = [(op[0], op[1]) for op, p in zip(ops, parts) if keep(p)]
        return 1e3 * covered(iv) if iv else None

    def under(prefix: str):
        return lambda p: any(n.startswith(prefix) for n in p)

    def host_ms(name: str) -> float | None:
        t = [s["end"] - s["start"] for s in rec["spans"] if s["name"] == name]
        return 1e3 * sum(t) if t else None

    out = {}
    if any(s["name"] == "serve.frame" for s in rec["spans"]):
        out["host_ms_per_frame"] = host_ms("serve.frame")
        out["trunk_ms_per_frame"] = device_ms(lambda p: "g.trunk" in p)
    else:
        out["host_ms_per_batch"] = host_ms("train.batch")
        out["optimizer_ms_per_batch"] = device_ms(under("optim."))
        out["losses_ms_per_batch"] = device_ms(
            lambda p: under("loss.")(p) and "d.forward" not in p)
        out["loss_d_forward_ms_per_batch"] = device_ms(
            lambda p: under("loss.")(p) and "d.forward" in p)
    out = {name: v / units for name, v in out.items() if v is not None}
    for key, counter in (("k4", "packed_trunk_fwd"), ("k5", "packed_trunk_bwd"),
                         ("eval_trunk", "eval_trunk")):
        ms = device_ms(lambda p, c=counter: f"kernel.{c}" in p)
        if ms is not None and launches.get(counter):
            out[f"{key}_ms_per_launch"] = ms / launches[counter]
            out[f"{key}_launches_per_batch"] = launches[counter] / units
    return out


def _profiled(one_chunk, k: int, top: int, dev) -> dict:
    """profile_once over one_chunk() with the kernel counts of the profiled
    call alone (profile_once runs it once before)."""
    from srgan_st_tpu_torch import kernels
    from srgan_st_tpu_torch.utils.profiling import profile_once

    def counted():
        kernels.reset_launch_counts()
        one_chunk()

    return _record(profile_once(counted, top=top), k, dev)


def _record(prof: dict, k: int, dev) -> dict:
    """A profile's record with the kernel counts since the last reset."""
    from srgan_st_tpu_torch import kernels
    from srgan_st_tpu_torch.utils.profiling import device_record

    return {"k": k, "profile": prof, "ms_per_step": prof["device_busy_ms"] / k,
            "launches": kernels.launch_counts(),
            "graph_launches": kernels.graph_launch_counts(), "device": device_record(dev)}


def _replays(graphs) -> int:
    return sum(c["replays"] for c in graphs.graph_counts().values()) if graphs else 0


def _traced(one_chunk, k: int, top: int, dev, trace_dir: str, graphs) -> dict:
    """`_profiled`'s record of one chunk under `trace_context`, and its
    regions: device ms a batch (frame) under each span name, idle ms a
    batch by the span the host was in, host ms a batch of the unit span and
    of the spans it holds, each as [total, self], and the readings. A batch
    is a replay of `graphs` (None for serving: a `serve.frame` span)."""
    from srgan_st_tpu_torch import kernels
    from srgan_st_tpu_torch.utils.profiling import device_summary, trace_context

    before = _replays(graphs)
    with trace_context(trace_dir) as prof:
        kernels.reset_launch_counts()
        one_chunk()
        torch.cuda.synchronize()
    rec = _record(device_summary(prof, top), k, dev)
    ops, calls, spans = trace_events(prof)
    lab = program_trace(ops, calls, spans, graphs.node_regions() if graphs else {})
    if graphs is None:
        unit = "serve.frame"
        units = sum(s["name"] == unit for s in lab["spans"])
    else:
        unit, units = "train.batch", _replays(graphs) - before
    per = 1e3 / units
    rec["regions"] = {
        "trace": f"{trace_dir}/trace.json", "labelled_share": lab["labelled_share"],
        "units": units, "replays": len(lab["replays"]),
        "replay_op_mismatches": sum(r["ops"] != r["nodes"] for r in lab["replays"]),
        "device_ms": {n: t * per for n, t in lab["regions"].items()},
        "idle_ms": {n: t * per for n, t in lab["idle_by_span"].items()},
        "host_ms": {n: [t * per, own * per]
                    for n, (t, own) in host_children(lab["spans"], unit).items()},
        "readings": readings(ops, lab, units, rec["launches"])}
    return rec


def spans_cost(one_chunk, reps: int = 3) -> dict:
    """Host seconds of one chunk, synchronized, under torch.profiler with
    the program's spans and without them (`spans_off`), `reps` of each,
    alternating: what the spans add to a traced run."""
    from torch.profiler import ProfilerActivity, profile

    from srgan_st_tpu_torch.utils.profiling import spans_off

    seconds: dict[str, list[float]] = {"on": [], "off": []}
    for _ in range(reps):
        for key in seconds:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                with spans_off() if key == "off" else contextlib.nullcontext():
                    t = time.perf_counter()
                    one_chunk()
                    torch.cuda.synchronize()
                    seconds[key].append(time.perf_counter() - t)
    on, off = statistics.median(seconds["on"]), statistics.median(seconds["off"])
    return {"seconds": seconds, "on_s": on, "off_s": off, "cost": on / off - 1}


def _measure(one_chunk, k: int, top: int, dev, trace_dir, graphs, cost: bool) -> dict:
    if cost:
        from srgan_st_tpu_torch.utils.profiling import device_record

        return {"k": k, "spans_cost": spans_cost(one_chunk), "device": device_record(dev)}
    if trace_dir is not None:
        return _traced(one_chunk, k, top, dev, trace_dir, graphs)
    return _profiled(one_chunk, k, top, dev)


def run_and_trace(name: str, k: int = 8, with_d: bool = False, top: int = 30,
                  device=None, trace_dir: str | None = None, cost: bool = False) -> dict:
    """One chunk of k batches of a training row, replayed, profiled."""
    from srgan_st_tpu_torch.train.utils import setup_run

    config = make_config("headline" if name == "warmup" else name)
    apply_bench_knobs(config)
    config.DATA.BATCH_SIZE = 16
    dev, mesh = setup_run(config, device)
    if name == "warmup":
        from srgan_st_tpu_torch.losses.registry import build_warmup_criterions
        from srgan_st_tpu_torch.models.generator import Generator
        from srgan_st_tpu_torch.train.graphs import step_graphs
        from srgan_st_tpu_torch.train.steps import (
            create_generator_state, make_warmup_chunk_step,
        )

        state = create_generator_state(config, Generator.from_config(config, group=mesh),
                                       1000, dev)
        graphs = step_graphs(config, dev, mesh)
        warmup_step = make_warmup_chunk_step(config, build_warmup_criterions(config), mesh,
                                             graphs)
        chunk_step = lambda state, chunk, with_d: warmup_step(state, chunk)  # noqa: E731
    else:
        state, chunk_step, graphs = build_gan(config, dev, mesh)
    chunk = bench_chunk(config, dev, mesh, k)
    for _ in range(2):
        chunk_step(state, chunk, with_d)
    rec = _measure(lambda: chunk_step(state, chunk, with_d), k, top, dev, trace_dir, graphs,
                   cost)
    return {"config": name, "with_d": with_d, **rec}


def run_and_trace_infer(k: int = 8, top: int = 30, device=None,
                        trace_dir: str | None = None, cost: bool = False) -> dict:
    """k frames of bench.py's infer-4k chain, profiled."""
    step, lr, _, dev, _ = infer_setup(device)
    frame = {"x": lr, "n": 0}

    def frames(count: int) -> None:
        for _ in range(count):
            frame["x"] = step(frame["x"], frame["n"])
            frame["n"] += 1

    with torch.inference_mode():
        frames(14)
        rec = _measure(lambda: frames(k), k, top, dev, trace_dir, None, cost)
    return {"config": "infer-4k", "with_d": False, **rec}


def _option(argv: list, flag: str):
    if flag not in argv:
        return None
    i = argv.index(flag)
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def main(argv=None) -> dict:
    from srgan_st_tpu_torch.core.device import resolve_device

    argv = list(sys.argv[1:] if argv is None else argv)
    trace_dir = _option(argv, "--trace-dir")
    k = int(_option(argv, "--k") or 8)
    cost = "--spans-cost" in argv
    if cost:
        argv.remove("--spans-cost")
    name = argv[0] if argv else "headline"
    top = int(argv[1]) if len(argv) > 1 else 30
    with_d = len(argv) > 2 and argv[2] == "1"
    resolve_device(None)  # the card, or raise
    rec = run_and_trace_infer(k, top=top, trace_dir=trace_dir, cost=cost) \
        if name == "infer-4k" else \
        run_and_trace(name, k, with_d=with_d, top=top, trace_dir=trace_dir, cost=cost)
    dev = rec["device"]
    print(f"config={name} with_d={with_d} k={k}  {dev['name']}, {dev['power_limit_w']} W")
    if cost:
        c = rec["spans_cost"]
        print(f"traced chunk: spans on {c['on_s']:.4f} s, off {c['off_s']:.4f} s (medians of "
              f"{c['seconds']['on']} and {c['seconds']['off']}): cost {100 * c['cost']:+.2f}%")
        print(json.dumps(rec), flush=True)
        return rec
    prof = rec["profile"]
    print(f"device busy {prof['device_busy_ms']:.3f} ms of a {prof['device_window_ms']:.3f} ms "
          f"window ({rec['ms_per_step']:.3f} ms/step x {k}), idle share "
          f"{prof['idle_share']:.4f}; {prof['kernels']} kernels, {prof['copies']} copies\n")
    print(f"{'span ms/step':>12}  {'s2s ms/step':>11}  {'count':>5}  op")
    for op, span, s2s, count in prof["top_ms"]:
        print(f"{span / k:12.4f}  {s2s / k:11.4f}  {count:5d}  {op}")
    launched = {n: c for n, c in rec["launches"].items() if c}
    print(f"\nhand-written kernel launches: {launched} "
          f"(replayed: { {n: c for n, c in rec['graph_launches'].items() if c} })")
    if "regions" in rec:
        reg = rec["regions"]
        print(f"\nregions ({reg['trace']}): labelled share {reg['labelled_share']:.4f}, "
              f"{reg['units']} units, {reg['replays']} replays, "
              f"{reg['replay_op_mismatches']} off their graphs")
        print(f"{'device ms/unit':>14}  region")
        for region, ms in sorted(reg["device_ms"].items(), key=lambda kv: -kv[1]):
            print(f"{ms:14.4f}  {region}")
        print(f"{'idle ms/unit':>14}  host span")
        for region, ms in sorted(reg["idle_ms"].items(), key=lambda kv: -kv[1]):
            print(f"{ms:14.4f}  {region}")
        print(f"{'host ms/unit':>14}  {'self':>8}  span")
        for region, (ms, own) in sorted(reg["host_ms"].items(), key=lambda kv: -kv[1][0]):
            print(f"{ms:14.4f}  {own:8.4f}  {region}")
        print("\nreadings: " + ", ".join(f"{n} {v:.4f}" for n, v in reg["readings"].items()))
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
